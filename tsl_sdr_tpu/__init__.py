"""tsl_sdr_tpu — a JAX software-defined-radio framework.

A from-scratch re-design (not a port) of the capability surface of
pvachon/tsl-sdr (CPU, C11, fixed point) for accelerators via JAX/XLA:

* ``ops``      — DSP kernels: Q.14 fixed-point math, direct-FIR channelizer,
                 polyphase rational resampler, FM discriminator, Costas loop,
                 DC blocker, Mueller-Muller timing recovery.
* ``models``   — signal-chain "models": multifm channelizer, resampler,
                 POCSAG / FLEX / AIS protocol decoders, BCH(31,21) codec.
* ``parallel`` — device-mesh sharding: channel + time-block sharding with
                 overlap-save halo exchange over device collectives.
* ``runtime``  — host streaming executor and native (C++) IO runtime.
* ``utils``    — config (reference-JSON compatible), IQ file formats,
                 filter design, counters.

Two numeric tiers run through every kernel:

* ``exact=True``  — integer arithmetic replicating the reference C pipeline
  bit-for-bit (Q.14 "Q.15" quirk included) for decode-parity work.
* ``exact=False`` — float32/int16 matmul paths with analytic (drift-free)
  oscillators: the production tier, faster and *more* accurate than the
  reference.
"""

def __getattr__(name):
    """Lazy top-level exports (avoid importing jax until first use).

    ``__version__`` is resolved lazily too: the git-describe subprocess
    (reference parity: build-stamp from ``CMakeLists.txt:37-47``) must not
    tax every ``import tsl_sdr_tpu`` on hot paths.
    """
    if name == "__version__":
        from tsl_sdr_tpu._version import __version__ as v

        return v
    lazy = {
        "MultifmChain": ("tsl_sdr_tpu.models.channelizer", "MultifmChain"),
        "ResamplerChain": ("tsl_sdr_tpu.models.resampler", "ResamplerChain"),
        "ReceivePipeline": ("tsl_sdr_tpu.models.pipeline", "ReceivePipeline"),
        "ChannelSpec": ("tsl_sdr_tpu.models.pipeline", "ChannelSpec"),
        "PocsagDecoder": ("tsl_sdr_tpu.models.pocsag", "PocsagDecoder"),
        "FlexDecoder": ("tsl_sdr_tpu.models.flex", "FlexDecoder"),
        "AisDecoder": ("tsl_sdr_tpu.models.ais", "AisDecoder"),
        "CostasChannelizer": (
            "tsl_sdr_tpu.models.costas_channel", "CostasChannelizer",
        ),
        "MultifmConfig": ("tsl_sdr_tpu.utils.config", "MultifmConfig"),
    }
    if name in lazy:
        import importlib

        mod, attr = lazy[name]
        return getattr(importlib.import_module(mod), attr)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
