"""Tier-against-reference checks at real widths, shared by ``chip_smoke.py``
and the CPU tests.

Two contracts, each checked the way the CPU tests check it:

* the bit-exact tier (``MultifmChain.process_array_exact_packed``, the
  resampler's ``exact=True`` tier) must equal a host reference **bit for
  bit**; the reference is the same tier run on the process's CPU backend,
  whose equality with the compiled C the CPU parity tests establish;
* the production tier must track a float64 reference of the same filter
  (the reference's Q.14 quantized taps, analytic derotation, exact
  ``atan2`` discriminator) within max |Δ| <= 2 PCM LSB and >= 99.9 % of
  outputs within 1 LSB (``tests/test_packed_fir.py``). The production
  resampler is held to the same bound against the exact resampler.

The production channelizer is not compared with the exact tier: the exact
tier reproduces the reference C's ``fast_atan2f`` approximation, which
sits tens of LSB away from a true ``atan2`` on FM audio.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from tsl_sdr_tpu.testing.pager_capture import (MULTIFM_8CH_CONFIG,
                                               PAGER_CONFIG)

MAX_LSB = 2
MIN_WITHIN_1 = 0.999


@dataclass(frozen=True)
class Width:
    """One channel-bank shape: ``source`` is "flagship" (firdes taps,
    seeded offsets at 1 Msps, the ``bench.py`` shape) or a config file."""

    name: str
    nr_channels: int
    taps: int
    decimation: int
    source: str = "flagship"


WIDTHS = (
    Width("8ch/128 taps/D40", 8, 128, 40),
    Width("8ch/365 taps/D40", 8, 365, 40, str(MULTIFM_8CH_CONFIG)),
    Width("64ch/128 taps/D40", 64, 128, 40),
    Width("256ch/128 taps/D40", 256, 128, 40),
    Width("3ch/577 taps/D32", 3, 577, 32, str(PAGER_CONFIG)),
)

RESAMPLER = (16, 25)  # 821-tap Kaiser design of the FLEX 25.6k -> 16k step


def bank(width: Width, seed: int = 0):
    """``(lpf_taps, offsets_hz, sample_rate, decimation, gains)``."""
    if width.source == "flagship":
        from tsl_sdr_tpu.utils.filter_design import firdes_low_pass

        fs = 1_000_000
        lpf = firdes_low_pass(1.0, fs, 12_500, 9_000)[: width.taps]
        rng = np.random.default_rng(seed + width.nr_channels)
        offsets = rng.integers(-fs // 3, fs // 3, size=width.nr_channels)
        return lpf, offsets, fs, width.decimation, None
    from tsl_sdr_tpu.utils.config import MultifmConfig

    cfg = MultifmConfig.load(width.source)
    assert len(cfg.lpf_taps) == width.taps, (width, len(cfg.lpf_taps))
    assert len(cfg.channels) == width.nr_channels, width
    assert cfg.decimation_factor == width.decimation, width
    return (cfg.lpf_taps, cfg.channel_offsets_hz, cfg.sample_rate_hz,
            cfg.decimation_factor, cfg.channel_gains)


def wideband(n: int, seed: int) -> np.ndarray:
    """Seeded full-band int16 noise, [n, 2] (the CPU oracle tests' input)."""
    rng = np.random.default_rng(seed)
    return rng.integers(-9000, 9000, size=(n, 2), dtype=np.int64).astype(
        np.int16)


def float64_pcm(x, lpf, offsets, fs, d, gains=None, chunk: int = 16_384):
    """float64 reference of the production channelizer: windowed FIR with
    the Q.14 quantized bandpass taps -> analytic rotate -> atan2 FM ->
    truncating Q.14 scale. Returns [C, K] int16, output k = window
    ``x[k*d : k*d + T]``."""
    from tsl_sdr_tpu.ops import fir, q14

    x = np.asarray(x, np.float64)
    t = len(lpf)
    k0 = (len(x) - t) // d + 1
    c = len(offsets)
    gains = np.ones(c) if gains is None else np.broadcast_to(gains, (c,))
    tre = np.empty((t, c))
    tim = np.empty((t, c))
    omega = np.empty(c)
    for ci in range(c):
        taps, f_offs = fir.design_channel_taps(lpf, offsets[ci], fs,
                                               gains[ci])
        tre[:, ci] = q14.quantize_q14(taps.real)
        tim[:, ci] = q14.quantize_q14(taps.imag)
        omega[ci] = f_offs * d
    yr = np.empty((k0, c))
    yi = np.empty((k0, c))
    for k_start in range(0, k0, chunk):
        k = np.arange(k_start, min(k0, k_start + chunk))
        idx = k[:, None] * d + np.arange(t)[None, :]
        xr = x[idx, 0]
        xi = x[idx, 1]
        ar = xr @ tre - xi @ tim
        ai = xi @ tre + xr @ tim
        th = omega[None, :] * k[:, None]
        yr[k] = ar * np.cos(th) - ai * np.sin(th)
        yi[k] = ar * np.sin(th) + ai * np.cos(th)
    pr = np.concatenate([np.zeros((1, c)), yr[:-1]])
    pi_ = np.concatenate([np.zeros((1, c)), yi[:-1]])
    phi = np.arctan2(yi * pr - yr * pi_, yr * pr + yi * pi_)
    return np.trunc(phi / np.pi * 16384).astype(np.int16).T


def lsb_agreement(got, want, skip: int = 1, wrap: bool = True) -> dict:
    """max |Δ| and the share within 1 LSB over the common span; with
    ``wrap`` (FM PCM) a ±pi wrap counts as adjacent. The first ``skip``
    outputs carry the cold discriminator history and are left out."""
    m = min(got.shape[-1], want.shape[-1])
    a = np.asarray(got)[..., skip:m].astype(np.float64)
    b = np.asarray(want)[..., skip:m].astype(np.float64)
    diff = np.abs(a - b)
    if wrap:
        diff = np.minimum(diff, 32768 - diff)
    return {"n": int(diff.size), "max_lsb": float(diff.max()),
            "within_1": float((diff <= 1).mean())}


def lsb_ok(agreement: dict) -> bool:
    return (agreement["max_lsb"] <= MAX_LSB
            and agreement["within_1"] >= MIN_WITHIN_1)


def _on_host(fn, *args, **kwargs):
    """``fn`` run on JAX's CPU backend (the exact tier's reference)."""
    import jax

    with jax.default_device(jax.devices("cpu")[0]):
        return fn(*args, **kwargs)


def check_channelizer(width: Width, n_samples: int, seed: int = 0) -> dict:
    """Both channelizer contracts at one width on JAX's default device.

    Returns the agreement figures plus ``exact_equal``,
    ``production_ok``, ``step_memory`` (``memory_analysis()`` of the
    compiled production step) and ``peak_bytes_in_use`` (None where the
    backend keeps no statistics)."""
    import jax

    from tsl_sdr_tpu.models.channelizer import MultifmChain

    lpf, offsets, fs, d, gains = bank(width, seed)
    x = wideband(n_samples, seed)
    exact_chain = MultifmChain(lpf, offsets, fs, d, gains=gains, exact=True)
    got_exact = exact_chain.process_array_exact_packed(x)
    ref_exact = _on_host(exact_chain.process_array_exact_packed, x)
    exact_equal = (got_exact.shape == ref_exact.shape
                   and bool(np.array_equal(got_exact, ref_exact)))

    chain = MultifmChain(lpf, offsets, fs, d, gains=gains, exact=False)
    got = chain.process_array(x)
    agreement = lsb_agreement(got, float64_pcm(x, lpf, offsets, fs, d,
                                               gains))

    q = chain.block_quantum
    block = min(4_194_304 - 4_194_304 % q,
                (n_samples - chain.carry_len) // q * q)
    state = chain.init_state()
    blk = jax.ShapeDtypeStruct((2 * block,), np.int16)
    mem = jax.jit(chain._step_raw).lower(state, blk).compile(
    ).memory_analysis()
    stats = jax.devices()[0].memory_stats() or {}
    return {"width": width.name, "samples": n_samples,
            "outputs": int(got_exact.size), "exact_equal": exact_equal,
            "production_ok": lsb_ok(agreement), **agreement,
            "step_memory": mem,
            "peak_bytes_in_use": stats.get("peak_bytes_in_use")}


def check_resampler(n_samples: int, seed: int = 0) -> dict:
    """The resampler's packed-row tier at 16/25 (821 taps): exact tier
    bit-for-bit against the CPU backend, production tier within the LSB
    bound of the exact tier."""
    import jax

    from tsl_sdr_tpu.models.resampler import ResamplerChain
    from tsl_sdr_tpu.utils.filter_design import (
        design_rational_resampler_filter)

    interp, decim = RESAMPLER
    coeffs = design_rational_resampler_filter(interp, decim, 0.4)
    rng = np.random.default_rng(seed)
    pcm = rng.integers(-12000, 12000, size=n_samples,
                       dtype=np.int64).astype(np.int16)
    exact = ResamplerChain(coeffs, interp, decim, exact=True,
                           block_out=65_536)
    fast = ResamplerChain(coeffs, interp, decim, exact=False,
                          block_out=65_536)
    assert exact.plan.k_row and fast.plan.k_row, "packed-row tier expected"
    got_exact = exact.process_array(pcm)
    ref_exact = _on_host(exact.process_array, pcm)
    exact_equal = (got_exact.shape == ref_exact.shape
                   and bool(np.array_equal(got_exact, ref_exact)))
    got = fast.process_array(pcm)
    agreement = lsb_agreement(got, got_exact, skip=0, wrap=False)
    stats = jax.devices()[0].memory_stats() or {}
    return {"width": f"resampler {interp}/{decim} {len(coeffs)} taps",
            "samples": n_samples, "outputs": int(got_exact.size),
            "exact_equal": exact_equal, "production_ok": lsb_ok(agreement),
            **agreement, "peak_bytes_in_use": stats.get("peak_bytes_in_use")}


def check_sharded_multifm(nr_channels: int, time_shards: int,
                          ch_shards: int, *, taps: int, decimation: int,
                          fs: float, segment: int, seed: int) -> dict:
    """``parallel.channelizer.make_sharded_multifm`` on a (time, channels)
    mesh against the primed single-device chain over the same stream.

    Both index outputs globally (output k = input samples ``[k*D,
    k*D+T)``); the FM cold-start edges (2 outputs each side) are left out.
    ``equal_ok`` is the documented element-for-element contract: at least
    99.9 % within 1 LSB and 98 % identical (the FM discriminator's f32
    sums may reassociate across shards). ``segment`` is each time shard's
    length in samples."""
    import jax

    from tsl_sdr_tpu.models.channelizer import MultifmChain
    from tsl_sdr_tpu.parallel.channelizer import make_sharded_multifm
    from tsl_sdr_tpu.parallel.mesh import make_mesh
    from tsl_sdr_tpu.utils.filter_design import firdes_low_pass

    lpf = firdes_low_pass(1.0, fs, 12_000, 8_000)[:taps]
    rng = np.random.default_rng(seed)
    offsets = rng.integers(-int(fs) // 3, int(fs) // 3, size=nr_channels)
    chain = MultifmChain(lpf, offsets, fs, decimation, exact=False)
    s = segment * time_shards
    iq = rng.integers(-12000, 12000, size=(s, 2),
                      dtype=np.int64).astype(np.int16)
    c_len = chain.carry_len
    q = chain.block_quantum
    state = chain.init_state(prefix=iq[:c_len])
    _, single = chain.step(state, iq[c_len:][: (s - c_len) // q * q])
    single = np.asarray(single)

    mesh = make_mesh(time=time_shards, channels=ch_shards,
                     devices=jax.devices()[: time_shards * ch_shards])
    sharded = np.asarray(make_sharded_multifm(chain.packed_plan, mesh)(iq))
    m1 = single.shape[1] - 2
    diff = np.abs(single[:, 2:m1].astype(np.int32)
                  - sharded[:, 2:m1].astype(np.int32))
    within_1 = float((diff <= 1).mean())
    identical = float((diff == 0).mean())
    return {"channels": nr_channels, "mesh": (time_shards, ch_shards),
            "samples": s, "max_lsb": int(diff.max()), "within_1": within_1,
            "identical": identical,
            "equal_ok": within_1 > 0.999 and identical > 0.98}
