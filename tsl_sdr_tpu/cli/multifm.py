"""multifm-tpu: N-channel NBFM channelizer (reference ``multifm/multifm.c``).

Usage: ``multifm-tpu config.json [more-config.json ...]`` — configs deep-merge
left to right like the reference (``multifm.c:105-111``) and use the same
vocabulary (device/sampleRateHz/centerFreqHz/decimationFactor/lpfTaps/
channels). The ``file`` device streams an IQ capture through the device
channelizer and writes each channel's 16-bit PCM to its ``outFifo`` path
(FIFO or regular file). Hardware devices (rtlsdr/airspy/usrp) require a
radio attached to the host; this build gates them behind ``--iq-file``
(stream a raw capture using the device config's format conventions).
"""

from __future__ import annotations

import argparse
import sys
from collections import deque

import numpy as np

# blocks of the packed exact tier kept in flight by the CLI runtimes
# (models/pipeline.py exposes the same knob as inflight_depth)
EXACT_INFLIGHT_DEPTH = 2


class _ExactPipeliner:
    """Begin/end pipelining of the packed bit-exact tier for the CLI
    block loops: up to ``depth`` matmul FIR dispatches stay in flight (their
    async plane fetches overlap the following blocks' device compute) and
    the host halves run in dispatch order with the FM carry threaded —
    shared by the python and native runtimes."""

    def __init__(self, chain, emit, depth: int = EXACT_INFLIGHT_DEPTH):
        self._chain = chain
        self._emit = emit
        self._depth = depth
        self._infl: deque = deque()
        self._fm_last = None

    def feed(self, state, blk):
        """Dispatch one block; emits the oldest block when over depth.
        Returns the advanced (carry/rotator) chain state."""
        if self._fm_last is None:
            self._fm_last = state.fm_last
        state, pend = self._chain.step_exact_packed_begin(state, blk)
        self._infl.append(pend)
        if len(self._infl) > self._depth:
            self._end_one()
        return state

    def _end_one(self):
        self._fm_last, pcm = self._chain.step_exact_packed_end(
            self._fm_last, self._infl.popleft())
        self._emit(pcm)

    def drain(self):
        """Finish every in-flight block (EOF / Ctrl-C path)."""
        while self._infl:
            self._end_one()


def build_argparser():
    from tsl_sdr_tpu.cli import cli_version

    p = argparse.ArgumentParser(prog="multifm-tpu", description=__doc__)
    p.add_argument("configs", nargs="+", help="JSON config file(s), merged")
    p.add_argument("--exact", action="store_true", default=False,
                   help="bit-exact integer tier (default: fast float tier)")
    p.add_argument("--iq-file", default=None,
                   help="override: stream this IQ capture instead of hardware")
    p.add_argument("--iq-format", default=None,
                   choices=["cs16", "cs8", "cu8", "rtl_u8"],
                   help="sample format of --iq-file")
    p.add_argument("--block-size", type=int, default=262144)
    p.add_argument("--realtime", action="store_true",
                   help="pace file playback at sampleRateHz (file_if.c:160-203)")
    p.add_argument("--runtime", default="native", choices=["native", "python"],
                   help="IO runtime: native C++ reader/writer threads "
                        "(frame pool + drop counters) or pure-Python loops")
    p.add_argument("--iq-dump", default=None,
                   help="dump ingested wideband IQ (int16 values) to this "
                        "file — the reference's iqDumpFile tap "
                        "(rtl_sdr_if.c:132-136)")
    p.add_argument("--test-samples", type=int, default=1_048_576,
                   help="samples to synthesize when sdrTestMode is set")
    p.add_argument("--inflight-depth", type=int, default=EXACT_INFLIGHT_DEPTH,
                   help="exact tier: blocks kept in flight on the device "
                        "(latency-hiding depth; adds depth blocks of "
                        "output latency)")
    p.add_argument("--stats", type=float, default=0.0, metavar="SECS",
                   help="print a live counters line to stderr every SECS "
                        "seconds (0 = only the exit summary, like the "
                        "reference's thread-exit counters)")
    p.add_argument("-V", "--version", action="version",
                   version=f"%(prog)s {cli_version()}")
    return p


def _pairs(block_iter):
    """Carry odd trailing int16 values across hardware blocks: truncating
    them would swap I and Q for the rest of the run (same failure the
    ``unit_items=2`` residue carry fixes for file/FIFO reads)."""
    residue = np.zeros((0,), np.int16)
    for b in block_iter:
        flat = np.concatenate([residue, np.asarray(b, np.int16).reshape(-1)])
        usable = flat.size // 2 * 2
        residue = flat[usable:]
        if usable:
            yield flat[:usable].reshape(-1, 2)


def _iq_block_iter(path, fmt, block_samples):
    from tsl_sdr_tpu.utils import iq as iqio
    from tsl_sdr_tpu.runtime.stream import iter_file_blocks

    if fmt == "cs16":
        for flat in iter_file_blocks(path, dtype=np.int16, unit_items=2):
            yield flat.reshape(-1, 2)
    else:
        for raw in iter_file_blocks(path, dtype=np.uint8, unit_items=2):
            yield iqio.widen_iq_bytes(raw, fmt).reshape(-1, 2)


def make_hw_source(cfg, dev_type: str):
    """Construct (not yet started) the dlopen-gated hardware ingest source
    for ``dev_type`` (rtlsdr/airspy/usrp), or None for other types. Raises
    ``HwLibraryMissing`` when the driver library is absent. Shared by
    multifm-tpu and pipeline-tpu --follow."""
    if dev_type == "rtlsdr":
        from tsl_sdr_tpu.sources.hw import RtlSdrSource
        from tsl_sdr_tpu.sources.rtl_sdr import RtlSdrConfig

        rtl = RtlSdrConfig.from_dict(
            cfg.device.params, {"sdrTestMode": cfg.raw.get("sdrTestMode")}
        )
        return RtlSdrSource(rtl, depth=max(2, cfg.nr_samp_bufs))
    if dev_type == "airspy":
        from tsl_sdr_tpu.sources.airspy import AirspyConfig
        from tsl_sdr_tpu.sources.hw import AirspySource

        return AirspySource(AirspyConfig.from_dict(cfg.device.params),
                            depth=max(2, cfg.nr_samp_bufs))
    if dev_type == "usrp":
        from tsl_sdr_tpu.sources.hw import UhdSource
        from tsl_sdr_tpu.sources.uhd import UhdConfig

        return UhdSource(UhdConfig.from_dict(cfg.device.params),
                         depth=max(2, cfg.nr_samp_bufs))
    return None


def main(argv=None):
    args = build_argparser().parse_args(argv)

    import time

    from tsl_sdr_tpu.utils.device import enable_compile_cache

    enable_compile_cache()

    from tsl_sdr_tpu.models.channelizer import MultifmChain
    from tsl_sdr_tpu.runtime.stream import (
        StreamCounters,
        install_sigterm_as_interrupt,
    )
    from tsl_sdr_tpu.utils.config import MultifmConfig

    install_sigterm_as_interrupt()

    from tsl_sdr_tpu.utils.config import ConfigError

    try:
        cfg = MultifmConfig.load(*args.configs)
    except ConfigError as e:
        print(f"multifm-tpu: {e}", file=sys.stderr)
        return 2
    missing = [k for k, ch in enumerate(cfg.channels) if ch.out_fifo is None]
    if missing:
        print(f"multifm-tpu: channels {missing} have no outFifo "
              "(required here; only pipeline-tpu protocol channels may "
              "omit it)", file=sys.stderr)
        return 2
    chain = MultifmChain.from_config(cfg, exact=args.exact)

    dev_type = cfg.device.type
    iq_path = args.iq_file
    iq_fmt = args.iq_format
    if dev_type == "file" and iq_path is None:
        iq_path = cfg.device.params["filename"]
        iq_fmt = iq_fmt or cfg.device.params.get("fileFormat", "cs16")
    if iq_path is None and dev_type == "rtlsdr":
        # validate + plan gains like the reference driver would, then either
        # synthesize the test-mode counter stream or gate on hardware
        from tsl_sdr_tpu.sources.rtl_sdr import (
            RtlSdrConfig, e4000_if_gain_plan, test_mode_pattern,
        )
        from tsl_sdr_tpu.utils import iq as iqio
        import tempfile

        rtl = RtlSdrConfig.from_dict(
            cfg.device.params, {"sdrTestMode": cfg.raw.get("sdrTestMode")}
        )
        if rtl.db_gain_if is not None:
            stages, total = e4000_if_gain_plan(int(rtl.db_gain_if * 10))
            print(f"multifm-tpu: E4000 IF gain plan {stages} "
                  f"(total {total / 10:.1f} dB)", file=sys.stderr)
        if rtl.test_mode:
            # with librtlsdr present, test mode runs on the device itself
            # (the hw path below); synthesize only when no library exists
            from tsl_sdr_tpu.sources import hw as hwmod

            try:
                hwmod._dlopen("TSL_RTLSDR_LIB", "rtlsdr", "rtlsdr")
            except hwmod.HwLibraryMissing:
                raw = test_mode_pattern(2 * args.test_samples)
                tmp = tempfile.NamedTemporaryFile(suffix=".cs16", delete=False)
                iqio.rtl_u8_to_q14(raw).astype(np.int16).tofile(tmp)
                tmp.close()
                iq_path, iq_fmt = tmp.name, "cs16"
    hw_source = None
    if iq_path is None:
        # real hardware: dlopen-gated ctypes ingest (sources/hw.py). The
        # gated error below only fires when no library exists.
        from tsl_sdr_tpu.sources.hw import HwLibraryMissing

        try:
            hw_source = make_hw_source(cfg, dev_type)
        except HwLibraryMissing as e:
            print(f"multifm-tpu: {e}", file=sys.stderr)
            return 2
    if iq_path is None and hw_source is None:
        print(
            f"multifm-tpu: device type '{dev_type}' needs attached hardware; "
            "use a 'file' device or --iq-file to stream a capture",
            file=sys.stderr,
        )
        return 2

    block = args.block_size - (args.block_size % chain.block_quantum)
    if block <= 0:
        block = chain.block_quantum
    counters = StreamCounters()

    debug_iq = any(ch.signal_debug_file for ch in cfg.channels)
    if args.runtime == "native" and not debug_iq and hw_source is None:
        return _run_native(args, cfg, chain, iq_path, iq_fmt or "cs16",
                           block, counters)
    if hw_source is not None:
        # reference order: unmute, then start the receiver (multifm.c:158)
        hw_source.open(cfg.sample_rate_hz, cfg.center_freq_hz)
        hw_source.set_mute(False)
        hw_source.start()

    mute_left = cfg.sample_rate_hz * cfg.mute_startup_ms // 1000
    sinks = [open(ch.out_fifo, "wb") for ch in cfg.channels]
    iq_dump = open(args.iq_dump, "wb") if args.iq_dump else None
    dbg_sinks = [
        open(ch.signal_debug_file, "wb") if ch.signal_debug_file else None
        for ch in cfg.channels
    ]
    state = None
    t0 = time.monotonic()
    from tsl_sdr_tpu.runtime.stream import StatsTicker

    ticker = StatsTicker(args.stats, counters, "multifm-tpu")
    prefix_holder: list = []

    def _produce():
        # host-side staging runs in the feeder's thread: file reads, 8-bit
        # widening, mute gate, carry peel and block cutting all overlap the
        # device compute of the previous block (SURVEY hard-part #4)
        nonlocal mute_left
        pending = np.zeros((0, 2), np.int16)
        carry_done = chain.carry_len == 0
        if hw_source is not None:
            raw_iter = _pairs(hw_source.blocks())
        else:
            raw_iter = _iq_block_iter(iq_path, iq_fmt or "cs16", block)
        for iq in raw_iter:
            if mute_left > 0:
                # startup mute gate (receiver.h:98, multifm/multifm.c:158)
                drop = min(mute_left, len(iq))
                iq = iq[drop:]
                mute_left -= drop
                if not len(iq):
                    continue
            if iq_dump is not None:
                iq.astype(np.int16).tofile(iq_dump)
            pending = np.concatenate([pending, iq])
            if not carry_done:
                if len(pending) < chain.carry_len:
                    continue
                prefix_holder.append(pending[: chain.carry_len].copy())
                pending = pending[chain.carry_len:]
                carry_done = True
            while len(pending) >= block:
                yield np.ascontiguousarray(pending[:block])
                pending = pending[block:]

    from tsl_sdr_tpu.runtime.feeder import AsyncFeeder

    # the packed exact tier's step starts with host-side staging (native
    # rotator), so eager device_put would only force a bulk device->host
    # fetch straight back
    stage_on_device = not (chain.exact and chain.exact_tier == "packed")
    feeder = AsyncFeeder(_produce(), depth=3, device_put=stage_on_device)
    # the fast tier's PCM stays a device array: start its device->host copy
    # asynchronously and drain it on the NEXT iteration so the transfer
    # latency overlaps the following block's compute (same pattern as
    # models/pipeline.py). The exact-packed tier pipelines via
    # _ExactPipeliner (begin/end split, in-flight FIR plane fetches).
    pending_pcm = None
    exact_pipe = (chain.exact
                  and getattr(chain, "exact_tier", None) == "packed"
                  and not debug_iq)

    def _emit(pcm):
        counters.samples_out += pcm.shape[1]
        for c, sink in enumerate(sinks):
            pcm[c].astype(np.int16).tofile(sink)

    xp = (_ExactPipeliner(chain, _emit, depth=args.inflight_depth)
          if exact_pipe else None)
    try:
        for blk in feeder:
            if state is None:
                state = chain.init_state(
                    prefix=prefix_holder[0] if prefix_holder else None)
            if debug_iq:
                state, pcm, ch_iq = chain.step_debug(state, blk)
                ch_iq = np.asarray(ch_iq)
                for c, dbg in enumerate(dbg_sinks):
                    if dbg is not None:
                        ch_iq[c].astype(np.int16).tofile(dbg)
            elif exact_pipe:
                state = xp.feed(state, blk)
                pcm = None
            else:
                state, pcm = chain.step(state, blk)
            counters.samples_in += block
            if exact_pipe:
                pass  # xp.feed emitted any over-depth block already
            elif isinstance(pcm, np.ndarray):
                _emit(pcm)
            else:
                pcm.copy_to_host_async()
                if pending_pcm is not None:
                    _emit(np.asarray(pending_pcm))
                pending_pcm = pcm
            ticker.tick()
            if args.realtime:
                target = counters.samples_in / cfg.sample_rate_hz
                lag = target - (time.monotonic() - t0)
                if lag > 0:
                    time.sleep(lag)
    except (KeyboardInterrupt, BrokenPipeError):
        pass
    finally:
        # drain the deferred PCM blocks HERE: Ctrl-C is the normal way to
        # stop a live hw run and must not drop the last computed blocks
        if pending_pcm is not None:
            try:
                _emit(np.asarray(pending_pcm))
            except (BrokenPipeError, ValueError):
                pass
            pending_pcm = None
        if xp is not None:
            try:
                xp.drain()
            except (BrokenPipeError, ValueError):
                pass
        feeder.close()
        if hw_source is not None:
            hw_source.stop()
            print(f"multifm-tpu: hw source {hw_source.stats}",
                  file=sys.stderr)
        for s in sinks:
            s.close()
        if iq_dump is not None:
            iq_dump.close()
        for d in dbg_sinks:
            if d is not None:
                d.close()
        print(f"multifm-tpu: {counters.summary()}", file=sys.stderr)
    return 0


def _run_native(args, cfg, chain, iq_path, iq_fmt, block, counters):
    """Production IO path: C++ reader/writer threads around the device chain.

    The native source keeps the FIFO drained into a frame pool while the device
    computes (the reference's receiver-thread role, multifm/receiver.c:78-98);
    native sinks absorb EPIPE with drop counters (multifm/demod.c:93-110).
    """
    from tsl_sdr_tpu.runtime.native import NativeSink, NativeSource

    pace = cfg.sample_rate_hz if args.realtime else 0.0
    # Pool sized from the config's nrSampBufs (multifm/receiver.c:154-157);
    # realtime delivery drops-and-counts on pool exhaustion like a live
    # source (multifm/receiver.c:56-62), offline files apply backpressure.
    src = NativeSource(iq_path, iq_fmt, frame_samples=block,
                       pool_frames=max(2, cfg.nr_samp_bufs),
                       pace_sps=pace, drop_on_full=bool(args.realtime))
    sinks = [NativeSink(ch.out_fifo) for ch in cfg.channels]
    from tsl_sdr_tpu.runtime.stream import StatsTicker

    ticker = StatsTicker(args.stats, counters, "multifm-tpu[native]")
    state = None
    pending = np.zeros(0, np.int16)  # flat interleaved values
    quantum2 = 2 * chain.block_quantum
    iq_dump = open(args.iq_dump, "wb") if args.iq_dump else None
    # latency hiding (same pattern as the python runtime): fast-tier PCM
    # drains one block late behind an async copy; the exact-packed tier
    # keeps FIR dispatches in flight via _ExactPipeliner
    pending_pcm = None
    exact_pipe = (chain.exact
                  and getattr(chain, "exact_tier", None) == "packed")

    def _emit(pcm_np):
        counters.samples_out += pcm_np.shape[1]
        for c, sink in enumerate(sinks):
            sink.write(pcm_np[c])

    xp = (_ExactPipeliner(chain, _emit, depth=args.inflight_depth)
          if exact_pipe else None)
    try:
        eof = False
        mute_vals = 2 * (cfg.sample_rate_hz * cfg.mute_startup_ms // 1000)
        while not eof:
            vals = src.read(block)  # flat interleaved int16 values
            eof = vals.size < 2 * block
            if mute_vals > 0:
                drop = min(mute_vals, vals.size)
                vals = vals[drop:]
                mute_vals -= drop
                if not vals.size and not eof:
                    continue
            if iq_dump is not None:
                vals.tofile(iq_dump)
            pending = np.concatenate([pending, vals])
            if state is None:
                c_need = 2 * chain.carry_len
                if pending.size < c_need + quantum2:
                    if eof:
                        break
                    continue
                state = chain.init_state(prefix=pending[:c_need].reshape(-1, 2))
                pending = pending[c_need:]
            n = pending.size // quantum2 * quantum2
            if n == 0:
                continue
            blk = pending[:n].reshape(-1, 2)
            pending = pending[n:]
            counters.samples_in += n // 2
            if exact_pipe:
                state = xp.feed(state, blk)
            else:
                state, pcm = chain.step(state, blk)
                if isinstance(pcm, np.ndarray):
                    _emit(pcm)
                else:
                    pcm.copy_to_host_async()
                    if pending_pcm is not None:
                        _emit(np.asarray(pending_pcm))
                    pending_pcm = pcm
            ticker.tick()
    except KeyboardInterrupt:
        pass
    finally:
        # drain the deferred blocks (Ctrl-C must not drop computed PCM);
        # guarded so a second Ctrl-C mid-fetch still reaches the closes
        try:
            if pending_pcm is not None:
                _emit(np.asarray(pending_pcm))
            if xp is not None:
                xp.drain()
        except (KeyboardInterrupt, BrokenPipeError, ValueError):
            pass
        dropped = src.stats["dropped_frames"] + sum(
            s.stats["dropped_writes"] for s in sinks
        )
        counters.dropped += int(dropped)
        src.close()
        for s in sinks:
            s.close()
        if iq_dump is not None:
            iq_dump.close()
        print(f"multifm-tpu[native]: {counters.summary()}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
