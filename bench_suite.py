#!/usr/bin/env python3
"""Benchmark suite: the five BASELINE.json configs on the GPU.

Writes BENCH_SUITE.md (human table) and BENCH_SUITE.json (regression-grade
record: every individual trial, best/median/spread per metric, and a
comparison against the previously committed snapshot that flags >30%
median drops).

Methodology upgrades over round 2 (VERDICT r2 "what's weak" #3):

* trials are INTERLEAVED across configs — noise from other work on the
  host arrives in bursts, so consecutive trials of one config correlate; a
  round-robin decorrelates them;
* per-trial rates are recorded, not just the best scalar, so a real
  regression is distinguishable from one lucky/unlucky trial;
* the suite diffs its own previous committed JSON and reports any metric
  whose median dropped >30% (the r1->r2 headline swing would have been
  flagged by this).

Device timing uses the honest harness (state-threaded on-device rep scan,
differential long/short runs — see bench.py); host decoders are timed
directly. Device benches consume results on-device via checksums, so no
bulk device->host transfer enters a device row. The device must be a GPU
in the peak table of utils/roofline.py; every output names the card and
its power limit.
"""

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
DEVICE_TRIALS = 6
HOST_TRIALS = 3
DROP_FLAG_PCT = 30.0

# calibration facts (rep counts, window sizes, rejected trials) collected
# per device bench for the JSON record
CALIBRATION = {}
# the card's published peaks (utils/roofline.PEAKS), set by main()
PEAKS = None


def _device_trial_fn(step_fn, state0, blocks, samples_per_pass,
                     bound_msps=None, name=None):
    """Auto-calibrated differential trial callable (utils/benchtime.py):
    rep count scaled until the differential window is >= ~0.5 s of device
    compute, above-roofline trials rejected as artifacts."""
    from tsl_sdr_tpu.utils.benchtime import make_calibrated_bench

    bench = make_calibrated_bench(
        step_fn, state0, blocks, samples_per_pass, bound_msps=bound_msps
    )
    if name:
        CALIBRATION[name] = bench
    return bench


def prep_multifm(nr_channels):
    import jax
    import jax.numpy as jnp
    from tsl_sdr_tpu.models.channelizer import MultifmChain
    from tsl_sdr_tpu.utils import roofline
    from tsl_sdr_tpu.utils.filter_design import firdes_low_pass

    fs, d, t = 1_000_000, 40, 128
    lpf = firdes_low_pass(1.0, fs, 12_500, 9_000)[:t]
    rng = np.random.default_rng(0)
    offsets = rng.integers(-fs // 3, fs // 3, size=nr_channels)
    block = 16_711_680  # 52224 whole 640-value rows
    chain = MultifmChain(lpf, offsets, fs, d, exact=False)
    iq = rng.integers(-8000, 8000, size=(chain.carry_len + block, 2),
                      dtype=np.int64).astype(np.int16)
    st0 = chain.init_state(prefix=iq[: chain.carry_len])
    blocks = jax.device_put(
        jnp.asarray(iq[chain.carry_len:].reshape(1, 2 * block))
    )
    return _device_trial_fn(
        chain._step_raw, st0, blocks, block,
        bound_msps=roofline.channelizer(nr_channels, t, d, PEAKS).sol_msps,
    )


def prep_exact_fir():
    import jax
    import jax.numpy as jnp
    from tsl_sdr_tpu.models.channelizer import MultifmChain
    from tsl_sdr_tpu.ops import packed_fir
    from tsl_sdr_tpu.utils.filter_design import firdes_low_pass

    fs, d, t, c = 1_000_000, 40, 128, 8
    lpf = firdes_low_pass(1.0, fs, 12_500, 9_000)[:t]
    rng = np.random.default_rng(0)
    offsets = rng.integers(-fs // 3, fs // 3, size=c)
    chain = MultifmChain(lpf, offsets, fs, d, exact=True)
    plan = chain.packed_plan
    block = 16_711_680  # 52224 whole 640-value rows
    iq = rng.integers(-8000, 8000, size=(plan.carry_len + block, 2),
                      dtype=np.int64).astype(np.int16)
    carry = packed_fir.init_packed_carry(plan, iq[: plan.carry_len])
    blocks = jax.device_put(
        jnp.asarray(iq[plan.carry_len:].reshape(1, 2 * block))
    )

    def step(cv, bv):
        cv, a_re, a_im = packed_fir.packed_fir_step_exact(plan, cv, bv)
        return cv, (a_re.astype(jnp.int32) + a_im.astype(jnp.int32))

    from tsl_sdr_tpu.utils import roofline

    return _device_trial_fn(
        step, carry, blocks, block,
        bound_msps=roofline.channelizer(c, t, d, PEAKS).sol_msps,
    )


def prep_resampler():
    import jax
    import jax.numpy as jnp
    from tsl_sdr_tpu.ops import polyphase, q14
    from tsl_sdr_tpu.utils.filter_design import design_rational_resampler_filter

    coeffs = design_rational_resampler_filter(16, 25, 0.4)
    plan = polyphase.make_resampler_plan(
        q14.quantize_q14(coeffs), 16, 25, block_out_target=1 << 20
    )
    rng = np.random.default_rng(0)
    nb = 8
    x = rng.integers(-12000, 12000,
                     size=(plan.carry_len + nb * plan.block_in,),
                     dtype=np.int64).astype(np.int16)
    blocks = jax.device_put(
        jnp.asarray(x[plan.carry_len:].reshape(nb, plan.block_in))
    )
    st0 = polyphase.init_resampler_state(plan, prefix=x[: plan.carry_len])

    def step(st, blk):
        st2, out = polyphase.resample_step(plan, st, blk, exact=False)
        return st2, out.astype(jnp.int32)

    from tsl_sdr_tpu.utils import roofline

    return _device_trial_fn(
        step, st0, blocks, nb * plan.block_in,
        bound_msps=roofline.resampler(821, 16, 25, PEAKS).sol_msps,
    )


def prep_pocsag_chain():
    """Wideband -> channelize+demod (device) -> POCSAG scan (host)."""
    from tsl_sdr_tpu.models.channelizer import MultifmChain
    from tsl_sdr_tpu.models.pocsag import PocsagDecoder
    from tsl_sdr_tpu.testing import pocsag_gen
    from tsl_sdr_tpu.utils.filter_design import firdes_low_pass

    decim = 32
    fs = 38400 * decim
    offset = 250_000
    bursts = [pocsag_gen.PocsagBurst(capcode=1234567, function=1,
                                     kind="alpha", content="BENCH MSG")]
    bb = pocsag_gen.generate(bursts, baud=1200, amplitude=4096, tail_bits=256)
    dev = bb.astype(np.float64) / 16384.0 * (38400 / 2)
    ph = np.cumsum(np.repeat(2 * np.pi * (offset + dev) / fs, decim))
    sig = (np.stack([np.cos(ph), np.sin(ph)], -1) * 9000).astype(np.int16)
    rng = np.random.default_rng(1)
    pad = rng.integers(-500, 500, size=(4_000_000, 2),
                       dtype=np.int64).astype(np.int16)
    iq = np.concatenate([pad, sig, pad])

    lpf = firdes_low_pass(1.0, fs, 9_600, 7_000)
    chain = MultifmChain(lpf, [offset], fs, decim, exact=False)
    # warm compile with the SAME block shape the measurement uses — a
    # different shape recompiles and the measurement becomes compile time
    # (this exact bug made round 1 record 0.8 Msps for this row)
    chain.process_array(iq, block_size=4_000_000)

    def trial():
        t0 = time.perf_counter()
        pcm = chain.process_array(iq, block_size=4_000_000)[0]
        msgs = PocsagDecoder().scan(pcm)
        dt = time.perf_counter() - t0
        assert any(m.capcode == 1234567 for m in msgs), "decode failed"
        return len(iq) / dt / 1e6

    return trial


def prep_pipeline_8ch():
    """The reference's flagship deployment shape, end-to-end in one call:
    1.2288 Msps wideband -> 8 POCSAG channels channelized on the device ->
    device-side sign bit-pack -> 8 host decoders."""
    from tsl_sdr_tpu.models.pipeline import ChannelSpec, ReceivePipeline
    from tsl_sdr_tpu.testing import pocsag_gen
    from tsl_sdr_tpu.utils.filter_design import firdes_low_pass

    decim = 32
    fs = 38400 * decim
    center = 929_500_000
    offsets = [-450_000, -320_000, -190_000, -60_000,
               60_000, 190_000, 320_000, 450_000]
    rng = np.random.default_rng(6)
    parts = None
    for k, off in enumerate(offsets):
        bb = pocsag_gen.generate(
            [pocsag_gen.PocsagBurst(capcode=100000 + k, function=1,
                                    kind="alpha", content=f"CH{k} MSG")],
            baud=1200, tail_bits=256)
        dev = bb.astype(np.float64) / 16384.0 * 19200
        ph = np.cumsum(np.repeat(2 * np.pi * (off + dev) / fs, decim))
        sig = np.stack([np.cos(ph), np.sin(ph)], -1) * 4000
        if parts is None:
            parts = np.zeros((len(sig) + 2_000_000, 2))
        parts[200_000:200_000 + len(sig)] += sig
    iq = (parts + rng.normal(scale=80, size=parts.shape)).astype(np.int16)
    # tile to ~23M samples so the streaming engine reaches steady state
    # (several full blocks in flight) instead of measuring one block's
    # dispatch+fetch latency
    iq = np.concatenate([iq] * 8)

    pipe = ReceivePipeline(
        firdes_low_pass(1.0, fs, 9_600, 7_000), center, fs, decim,
        [ChannelSpec(center + o, "pocsag") for o in offsets], exact=False,
        inflight_depth=4, drain_async=True)  # the deployment CLI default
    pipe.process_capture(iq)  # warm the exact measurement shape

    def trial():
        t0 = time.perf_counter()
        res = pipe.process_capture(iq)
        rate = len(iq) / (time.perf_counter() - t0) / 1e6
        caps = sorted(set(m.capcode for msgs in res for m in msgs))
        assert caps == [100000 + k for k in range(8)], caps
        return rate

    return trial


def prep_pipeline_8ch_u8():
    """The flagship deployment on the 8-BIT WIRE ingest path (VERDICT r4
    #2): raw rtl_u8 bytes upload at 2 B/sample and widen in the fused
    device program's first stage (reference wire format of the RTL path,
    multifm/rtl_sdr_if.c:118-147) — the host-link-bound ingest ceiling
    doubles vs cs16."""
    from tsl_sdr_tpu.models.pipeline import ChannelSpec, ReceivePipeline
    from tsl_sdr_tpu.testing import pocsag_gen
    from tsl_sdr_tpu.utils.filter_design import firdes_low_pass

    decim = 32
    fs = 38400 * decim
    center = 929_500_000
    offsets = [-450_000, -320_000, -190_000, -60_000,
               60_000, 190_000, 320_000, 450_000]
    rng = np.random.default_rng(6)
    parts = None
    for k, off in enumerate(offsets):
        bb = pocsag_gen.generate(
            [pocsag_gen.PocsagBurst(capcode=200000 + k, function=1,
                                    kind="alpha", content=f"U8{k} MSG")],
            baud=1200, tail_bits=256)
        dev = bb.astype(np.float64) / 16384.0 * 19200
        ph = np.cumsum(np.repeat(2 * np.pi * (off + dev) / fs, decim))
        sig = np.stack([np.cos(ph), np.sin(ph)], -1) * 4000
        if parts is None:
            parts = np.zeros((len(sig) + 2_000_000, 2))
        parts[200_000:200_000 + len(sig)] += sig
    x = parts + rng.normal(scale=80, size=parts.shape)
    raw = np.clip(np.round(x / 128.0) + 127, 0, 255) \
        .astype(np.uint8).reshape(-1)
    raw = np.concatenate([raw] * 8)
    n_samples = raw.size // 2

    pipe = ReceivePipeline(
        firdes_low_pass(1.0, fs, 9_600, 7_000), center, fs, decim,
        [ChannelSpec(center + o, "pocsag") for o in offsets], exact=False,
        inflight_depth=4, wire_fmt="rtl_u8", drain_async=True)
    pipe.process_capture(raw)  # warm the exact measurement shape

    def trial():
        t0 = time.perf_counter()
        res = pipe.process_capture(raw)
        rate = n_samples / (time.perf_counter() - t0) / 1e6
        caps = sorted(set(m.capcode for msgs in res for m in msgs))
        assert caps == [200000 + k for k in range(8)], caps
        return rate

    return trial


def prep_exact_pipeline():
    """The same 8-channel deployment on the BIT-EXACT tier: pipelined matmul
    FIR (begin/end split, async plane fetches, 2 blocks in flight), host
    derotate/LUT-FM, one vmapped exact resampler scan per ratio group."""
    from tsl_sdr_tpu.models.pipeline import ChannelSpec, ReceivePipeline
    from tsl_sdr_tpu.testing import pocsag_gen
    from tsl_sdr_tpu.utils.filter_design import firdes_low_pass

    decim = 32
    fs = 38400 * decim
    center = 929_500_000
    offsets = [-450_000, -320_000, -190_000, -60_000,
               60_000, 190_000, 320_000, 450_000]
    rng = np.random.default_rng(7)
    parts = None
    for k, off in enumerate(offsets):
        bb = pocsag_gen.generate(
            [pocsag_gen.PocsagBurst(capcode=300000 + k, function=1,
                                    kind="alpha", content=f"EX{k}")],
            baud=1200, tail_bits=256)
        dev = bb.astype(np.float64) / 16384.0 * 19200
        ph = np.cumsum(np.repeat(2 * np.pi * (off + dev) / fs, decim))
        sig = np.stack([np.cos(ph), np.sin(ph)], -1) * 4000
        if parts is None:
            parts = np.zeros((len(sig) + 2_000_000, 2))
        parts[200_000:200_000 + len(sig)] += sig
    iq = (parts + rng.normal(scale=80, size=parts.shape)).astype(np.int16)
    iq = np.concatenate([iq] * 4)

    pipe = ReceivePipeline(
        firdes_low_pass(1.0, fs, 9_600, 7_000), center, fs, decim,
        [ChannelSpec(center + o, "pocsag") for o in offsets], exact=True,
        block_size=4_194_304, inflight_depth=2,
        drain_async=True)  # the deployment CLI default (END half overlaps
                           # the next block's upload + matmul dispatch)
    got = pipe.push(iq)
    for c, part in enumerate(pipe.flush()):
        got[c].extend(part)
    caps = sorted(set(m.capcode for msgs in got for m in msgs))
    assert caps == [300000 + k for k in range(8)], caps

    def trial():
        t0 = time.perf_counter()
        pipe.push(iq)
        pipe.flush()
        return len(iq) / (time.perf_counter() - t0) / 1e6

    return trial


def prep_exact_pipeline_u8():
    """The BIT-EXACT deployment on the 8-BIT WIRE: raw rtl_u8 bytes ship
    at 2 B/sample and widen `(s-127)<<7` in the jitted matmul FIR dispatch's
    first stage (channelizer._exact_packed_fir_wire) — integer widening
    is bit-identical on-device, so the tier's == C contract holds while
    the h2d ceiling doubles (reference wire format of the RTL path,
    multifm/rtl_sdr_if.c:118-147)."""
    from tsl_sdr_tpu.models.pipeline import ChannelSpec, ReceivePipeline
    from tsl_sdr_tpu.testing import pocsag_gen
    from tsl_sdr_tpu.utils.filter_design import firdes_low_pass

    decim = 32
    fs = 38400 * decim
    center = 929_500_000
    offsets = [-450_000, -320_000, -190_000, -60_000,
               60_000, 190_000, 320_000, 450_000]
    rng = np.random.default_rng(9)
    parts = None
    for k, off in enumerate(offsets):
        bb = pocsag_gen.generate(
            [pocsag_gen.PocsagBurst(capcode=400000 + k, function=1,
                                    kind="alpha", content=f"XU{k}")],
            baud=1200, tail_bits=256)
        dev = bb.astype(np.float64) / 16384.0 * 19200
        ph = np.cumsum(np.repeat(2 * np.pi * (off + dev) / fs, decim))
        sig = np.stack([np.cos(ph), np.sin(ph)], -1) * 4000
        if parts is None:
            parts = np.zeros((len(sig) + 2_000_000, 2))
        parts[200_000:200_000 + len(sig)] += sig
    x = parts + rng.normal(scale=80, size=parts.shape)
    raw = np.clip(np.round(x / 128.0) + 127, 0, 255) \
        .astype(np.uint8).reshape(-1)
    raw = np.concatenate([raw] * 4)
    n_samples = raw.size // 2

    pipe = ReceivePipeline(
        firdes_low_pass(1.0, fs, 9_600, 7_000), center, fs, decim,
        [ChannelSpec(center + o, "pocsag") for o in offsets], exact=True,
        block_size=4_194_304, inflight_depth=2,
        wire_fmt="rtl_u8", drain_async=True)
    got = pipe.push(raw)
    for c, part in enumerate(pipe.flush()):
        got[c].extend(part)
    caps = sorted(set(m.capcode for msgs in got for m in msgs))
    assert caps == [400000 + k for k in range(8)], caps

    def trial():
        t0 = time.perf_counter()
        pipe.push(raw)
        pipe.flush()
        return n_samples / (time.perf_counter() - t0) / 1e6

    return trial


def prep_decoder_scans():
    from tsl_sdr_tpu.models.ais import AisDecoder
    from tsl_sdr_tpu.models.flex import FlexDecoder
    from tsl_sdr_tpu.models.pocsag import PocsagDecoder

    rng = np.random.default_rng(2)
    pcm = rng.integers(-8000, 8000, size=8_000_000,
                       dtype=np.int64).astype(np.int16)
    decs = {"pocsag": PocsagDecoder, "flex": FlexDecoder, "ais": AisDecoder}

    def trial():
        out = {}
        for name, cls in decs.items():
            t0 = time.perf_counter()
            cls().scan(pcm)
            out[name] = len(pcm) / (time.perf_counter() - t0) / 1e6
        return out

    return trial


def prep_decoder_dense():
    """100%-duty burst traffic (VERDICT r1 item 9's >= 20 Msps target)."""
    from tsl_sdr_tpu.models.ais import AisDemodulator
    from tsl_sdr_tpu.models.flex import FlexDecoder
    from tsl_sdr_tpu.models.pocsag import PocsagDecoder
    from tsl_sdr_tpu.testing import ais_gen, flex_gen, pocsag_gen

    bursts = [pocsag_gen.PocsagBurst(capcode=1000 + k, function=1,
                                     kind="alpha",
                                     content="DENSE TRAFFIC %03d " % k * 3)
              for k in range(40)]
    ppcm = pocsag_gen.generate(bursts, baud=2400, tail_bits=16)

    fmsgs = [flex_gen.FlexBurstMessage(capcode=10000 + k, kind="alnum",
                                       content="DENSE FLEX %03d" % k)
             for k in range(4)]
    frames = [flex_gen.generate(fmsgs, baud=6400, fsk_levels=4,
                                tail_bits=16)[0] for _ in range(6)]
    fpcm = np.concatenate(frames)

    pkts = [ais_gen.make_position_report(366000000 + k) for k in range(600)]
    sig = ais_gen.generate(pkts)

    def trial():
        out = {}
        d = PocsagDecoder()
        t0 = time.perf_counter()
        msgs = d.scan(ppcm)
        out["pocsag"] = len(ppcm) / (time.perf_counter() - t0) / 1e6
        assert len(msgs) == 40

        f = FlexDecoder()
        t0 = time.perf_counter()
        fout = f.on_pcm(fpcm)  # streaming API -> native FSM
        out["flex"] = len(fpcm) / (time.perf_counter() - t0) / 1e6
        assert len(fout) == 24

        a = AisDemodulator()
        t0 = time.perf_counter()
        a.on_pcm(sig)
        out["ais"] = len(sig) / (time.perf_counter() - t0) / 1e6
        assert len(a.packets) == 600
        return out

    return trial


def prep_costas_device():
    """Full 8-channel coherent chain ON DEVICE: packed FIR bank + integer
    NCO + chunk-parallel Costas loops (ops/costas.py costas_block_planes)."""
    import jax
    import jax.numpy as jnp
    from tsl_sdr_tpu.models.costas_channel import CostasChannelizer
    from tsl_sdr_tpu.utils.filter_design import firdes_low_pass

    fs, d, c = 1_000_000, 8, 8
    lpf = firdes_low_pass(1.0, fs, 40_000, 20_000)[:64]
    rng = np.random.default_rng(0)
    offsets = rng.integers(-fs // 3, fs // 3, size=c)
    chain = CostasChannelizer(lpf, offsets, fs, d,
                              alpha=0.05, beta=0.002, e_max_q14=8192)
    q = chain.block_quantum
    block = (2_000_000 // q) * q
    iq = rng.integers(-8000, 8000, size=(chain.carry_len + block, 2),
                      dtype=np.int64).astype(np.int16)
    st0 = chain.init_state(prefix=iq[: chain.carry_len])
    blocks = jax.device_put(
        jnp.asarray(iq[chain.carry_len:].reshape(1, 2 * block))
    )

    def step(st, bv):
        st, out = chain.step(st, bv.reshape(-1, 2))
        return st, jnp.sum(out.astype(jnp.int32))

    return _device_trial_fn(step, st0, blocks, block)


def prep_costas():
    from tsl_sdr_tpu.ops import costas
    from tsl_sdr_tpu.runtime.native import costas_native

    rng = np.random.default_rng(3)
    n = 8_000_000
    t = np.arange(n)
    ph = 2 * np.pi * 0.001 * t
    iq = (np.stack([np.cos(ph), np.sin(ph)], -1) * 9000).astype(np.int16)
    params = costas.make_costas_params(0.0, alpha=0.05, beta=0.002,
                                       e_max_q14=8192)
    costas_native(iq[:100_000], params)  # warm

    def trial():
        t0 = time.perf_counter()
        costas_native(iq, params)
        return n / (time.perf_counter() - t0) / 1e6

    return trial


def measure_ingest_bound_msps() -> float:
    """Measured host->device streaming bandwidth -> the hard Msps ceiling
    for any end-to-end row that ingests int16 IQ (4 B/sample).

    Every e2e deployment row is capped at bw/4 Msps REGARDLESS of device
    speed, so the suite reports e2e rows as a fraction of this ceiling,
    measured in the same run."""
    import jax
    import jax.numpy as jnp

    nbytes = 16 << 20
    host = np.zeros(nbytes // 2, np.int16)
    rates = []
    for _ in range(3):
        t0 = time.perf_counter()
        a = jax.device_put(host)
        float(jnp.sum(a[:4].astype(jnp.int32)))  # ensure it landed
        rates.append(nbytes / (time.perf_counter() - t0))
    bw = statistics.median(rates)
    return bw / 4.0 / 1e6


def cpu_baseline(nr_channels, taps, decim) -> float:
    exe = REPO / "bench" / "cpu_baseline"
    src = REPO / "bench" / "cpu_baseline.c"
    if not exe.exists() or exe.stat().st_mtime < src.stat().st_mtime:
        subprocess.run(["gcc", "-O2", "-march=native", "-o", str(exe),
                        str(src), "-lm"], check=True)
    out = subprocess.run(
        [str(exe), str(nr_channels), str(taps), str(decim), "2000000"],
        check=True, capture_output=True, text=True,
    )
    return float(out.stdout.strip())


def _collect(benches, n_trials):
    """Round-robin the benches so co-tenant noise bursts decorrelate
    across configs instead of poisoning one config's whole trial set."""
    trials = {key: [] for key in benches}
    for _ in range(n_trials):
        for key, fn in benches.items():
            r = fn()
            if r is not None:
                trials[key].append(r)
    return trials


def _summarize(samples):
    """[float] or [dict] trial lists -> {metric: {best, median, min, max}}"""
    if samples and isinstance(samples[0], dict):
        keys = samples[0].keys()
        return {
            k: _summarize([s[k] for s in samples])[""] for k in keys
        }
    vals = [float(v) for v in samples]
    return {"": {
        "best": max(vals),
        "median": statistics.median(vals),
        "min": min(vals),
        "max": max(vals),
        "trials": vals,
    }}


def _flatten_summary(summary):
    """{config: {metric: stats}} -> {"config[/metric]": stats}"""
    flat = {}
    for cfg, metrics in summary.items():
        for m, st in metrics.items():
            flat[f"{cfg}/{m}" if m else cfg] = st
    return flat


def compare_with_previous(flat, prev_path):
    """Flag metrics whose median dropped more than DROP_FLAG_PCT percent
    vs the previously COMMITTED BENCH_SUITE.json (``git show HEAD:...``,
    not the working tree — an earlier same-day run overwriting the
    working-tree file silently defeated this gate in round 4)."""
    try:
        committed = subprocess.run(
            ["git", "-C", str(REPO), "show", f"HEAD:{prev_path.name}"],
            capture_output=True, text=True, check=True,
        ).stdout
        prev = json.loads(committed)
        prev_flat = prev.get("flat_summary", {})
    except Exception:
        # not a git checkout / file never committed: fall back to disk
        if not prev_path.exists():
            return []
        try:
            prev = json.loads(prev_path.read_text())
            prev_flat = prev.get("flat_summary", {})
        except Exception:
            return []
    regressions = []
    for key, st in flat.items():
        p = prev_flat.get(key)
        if not p or not p.get("median"):
            continue
        # e2e rows swing with the host link's bandwidth, not with code:
        # gate them on the fraction of the SAME-RUN measured ingest
        # ceiling; device rows gate on the raw median
        if p.get("pct_of_ingest") and st.get("pct_of_ingest"):
            drop = ((p["pct_of_ingest"] - st["pct_of_ingest"])
                    / p["pct_of_ingest"] * 100.0)
            basis = "pct_of_ingest"
            prev_v, cur_v = p["pct_of_ingest"], st["pct_of_ingest"]
        else:
            drop = (p["median"] - st["median"]) / p["median"] * 100.0
            basis = "median_msps"
            prev_v, cur_v = p["median"], st["median"]
        if drop > DROP_FLAG_PCT:
            regressions.append({
                "metric": key,
                "basis": basis,
                "prev": round(prev_v, 2),
                "now": round(cur_v, 2),
                "drop_pct": round(drop, 1),
            })
    return regressions


def _ingest_pct(st, ingest_bound_msps, bytes_per_sample=4) -> str:
    """E2e rows are capped by host->device ingest bandwidth, not by
    device speed — report the fraction of that measured ceiling.
    ``ingest_bound_msps`` is the 4 B/sample (cs16) ceiling; 8-bit wire
    rows get twice that."""
    bound = ingest_bound_msps * 4.0 / bytes_per_sample
    pct = 100.0 * st["median"] / bound
    return (f"{pct:.0f}% of the measured {bound:,.1f} Msps "
            f"host-link ingest ceiling ({bytes_per_sample} B/sample "
            "h2d-bound)")


def _fmt(st, unit="Msps"):
    """Median-first (the defensible number); best + spread alongside."""
    ratio = st["max"] / st["min"] if st["min"] > 0 else float("inf")
    return (f"{st['median']:,.1f} {unit} median (best {st['best']:,.1f}, "
            f"spread x{ratio:,.2f} over {len(st['trials'])} trials)")


def main():
    global PEAKS
    from tsl_sdr_tpu.utils import roofline
    from tsl_sdr_tpu.utils.device import (card_line, enable_compile_cache,
                                          require_gpu)

    enable_compile_cache()
    dev = require_gpu()
    PEAKS = roofline.peaks_for(dev["kind"])
    card = card_line()
    print(f"card: {card}", file=sys.stderr)

    # ---- prepare (compile/warm) everything up front ----
    # A single bench failing to compile must not take the suite down:
    # record the failure, bench everything else.
    prep_failures = {}

    def _prep(benches, name, fn, *args):
        try:
            benches[name] = fn(*args)
            from tsl_sdr_tpu.utils.benchtime import CalibratedBench

            if isinstance(benches[name], CalibratedBench):
                CALIBRATION[name] = benches[name]
        except Exception as e:  # noqa: BLE001
            prep_failures[name] = f"{type(e).__name__}: {e}"[:300]
            print(f"prep {name} FAILED: {e}", file=sys.stderr)

    print("preparing device benches...", file=sys.stderr)
    device_benches = {}
    for c in (1, 8, 64, 256):
        _prep(device_benches, f"multifm_{c}ch_xla", prep_multifm, c)
    _prep(device_benches, "exact_fir_8ch", prep_exact_fir)
    _prep(device_benches, "resampler_16_25", prep_resampler)
    _prep(device_benches, "costas_chain_device", prep_costas_device)
    print("preparing host/e2e benches...", file=sys.stderr)
    host_benches = {}
    _prep(host_benches, "pocsag_chain_e2e", prep_pocsag_chain)
    _prep(host_benches, "pipeline_8ch_e2e", prep_pipeline_8ch)
    _prep(host_benches, "pipeline_8ch_u8_e2e", prep_pipeline_8ch_u8)
    _prep(host_benches, "exact_pipeline_8ch_e2e", prep_exact_pipeline)
    _prep(host_benches, "exact_pipeline_8ch_u8_e2e", prep_exact_pipeline_u8)
    _prep(host_benches, "decoder_scans", prep_decoder_scans)
    _prep(host_benches, "decoder_dense", prep_decoder_dense)
    _prep(host_benches, "costas_native", prep_costas)

    # ---- interleaved measurement ----
    print("running interleaved device trials...", file=sys.stderr)
    trials = _collect(device_benches, DEVICE_TRIALS)
    print("running interleaved host trials...", file=sys.stderr)
    ingest_bound = measure_ingest_bound_msps()
    print(f"measured host-link ingest ceiling: {ingest_bound:.1f} Msps",
          file=sys.stderr)
    trials.update(_collect(host_benches, HOST_TRIALS))

    summary = {k: _summarize(v) for k, v in trials.items()}
    flat = _flatten_summary(summary)

    # e2e rows: the fraction of the SAME-RUN measured ingest ceiling is
    # the code-quality number (the raw Msps tracks the host link); the
    # regression gate keys off it
    E2E_BYTES = {"pocsag_chain_e2e": 4, "pipeline_8ch_e2e": 4,
                 "pipeline_8ch_u8_e2e": 2, "exact_pipeline_8ch_e2e": 4,
                 "exact_pipeline_8ch_u8_e2e": 2}
    for key, bps in E2E_BYTES.items():
        if key in flat:
            bound = ingest_bound * 4.0 / bps
            flat[key]["pct_of_ingest"] = round(
                100.0 * flat[key]["median"] / bound, 1)

    regressions = compare_with_previous(flat, REPO / "BENCH_SUITE.json")

    r1, r8, r64, r256 = (flat[f"multifm_{c}ch_xla"] for c in (1, 8, 64, 256))
    cpu8 = cpu_baseline(8, 128, 40)
    b1 = roofline.channelizer(1, 128, 40, PEAKS)
    b8 = roofline.channelizer(8, 128, 40, PEAKS)
    b64 = roofline.channelizer(64, 128, 40, PEAKS)
    b256 = roofline.channelizer(256, 128, 40, PEAKS)
    br = roofline.resampler(821, 16, 25, PEAKS)

    rows = [
        ("multifm 1-channel NBFM (128 taps, decim 40)",
         _fmt(r1), b1.describe(r1["median"])),
        ("multifm 8-channel channelizer (etc/multifm.json shape)",
         _fmt(r8) + f" = {r8['median'] / cpu8:,.0f}x the scalar C baseline "
         f"at {cpu8:.1f} Msps", b8.describe(r8["median"])),
        ("multifm 64-channel channelizer (8x the reference's flagship "
         "width)",
         _fmt(r64) + f" = {r64['median'] * 64 / 1e3:,.1f} G channel-samples/s",
         b64.describe(r64["median"])),
        ("multifm 256-channel channelizer (32x the reference's flagship "
         "width)",
         _fmt(r256) + f" = {r256['median'] * 256 / 1e3:,.1f} G "
         "channel-samples/s", b256.describe(r256["median"])),
        ("BIT-EXACT integer FIR bank (== C arithmetic, 8ch/128tap)",
         _fmt(flat["exact_fir_8ch"]),
         b8.describe(flat["exact_fir_8ch"]["median"])),
        ("rational resampler 16/25 (821 taps), XLA packed-row tier",
         _fmt(flat["resampler_16_25"]),
         br.describe(flat["resampler_16_25"]["median"])),
        ("POCSAG chain: wideband 1.2288 Msps -> channelize+demod (device) -> "
         "scan decode (host)",
         _fmt(flat["pocsag_chain_e2e"]) + ", messages verified",
         _ingest_pct(flat["pocsag_chain_e2e"], ingest_bound)),
        ("pipeline: 8-channel POCSAG deployment, wideband -> 8 decoded "
         "channels in one call",
         _fmt(flat["pipeline_8ch_e2e"]) + ", all 8 messages verified",
         _ingest_pct(flat["pipeline_8ch_e2e"], ingest_bound)),
        ("pipeline, 8-BIT WIRE ingest (rtl_u8 raw bytes, widened on "
         "device): same 8-channel deployment at 2 B/sample h2d",
         _fmt(flat["pipeline_8ch_u8_e2e"]) + ", all 8 messages verified",
         _ingest_pct(flat["pipeline_8ch_u8_e2e"], ingest_bound,
                     bytes_per_sample=2)),
        ("pipeline, BIT-EXACT tier: same 8-channel deployment, output == "
         "the C arithmetic",
         _fmt(flat["exact_pipeline_8ch_e2e"]) + ", all 8 messages verified",
         _ingest_pct(flat["exact_pipeline_8ch_e2e"], ingest_bound)),
        ("pipeline, BIT-EXACT tier on the 8-BIT WIRE (rtl_u8, widened "
         "on device inside the exact FIR dispatch): 2 B/sample h2d",
         _fmt(flat["exact_pipeline_8ch_u8_e2e"])
         + ", all 8 messages verified",
         _ingest_pct(flat["exact_pipeline_8ch_u8_e2e"], ingest_bound,
                     bytes_per_sample=2)),
        ("decoder batch scans on sync-free PCM (host)",
         f"POCSAG {flat['decoder_scans/pocsag']['median']:.1f} / "
         f"FLEX {flat['decoder_scans/flex']['median']:.0f} / "
         f"AIS {flat['decoder_scans/ais']['median']:.0f} Msps (median)", "-"),
        ("decoder 100%-duty burst traffic (host)",
         f"POCSAG {flat['decoder_dense/pocsag']['median']:.1f} / "
         f"FLEX {flat['decoder_dense/flex']['median']:.1f} / "
         f"AIS {flat['decoder_dense/ais']['median']:.0f} Msps (median)", "-"),
        ("Costas coherent chain, 8ch fully on-device (FIR bank + NCO + "
         "chunked PLL)", _fmt(flat["costas_chain_device"]), "-"),
        ("Costas loop (native serial PLL, host, 1ch)",
         _fmt(flat["costas_native"]), "-"),
    ]

    md = ["# Benchmark suite", "",
          f"Device: {dev['kind']} x{dev['count']} ({dev['platform']}); "
          f"card: {card}", "",
          "| Config | Result | % of single-card speed-of-light |",
          "|---|---|---|"]
    for name, result, sol in rows:
        md.append(f"| {name} | {result} | {sol} |")
    md.append("")
    if regressions:
        md.append(f"**REGRESSION FLAGS (>30% drop vs previous committed "
                  f"snapshot; e2e rows gate on % of the same-run ingest "
                  f"ceiling, device rows on median Msps):**")
        for r in regressions:
            md.append(f"* {r['metric']} [{r['basis']}]: {r['prev']} -> "
                      f"{r['now']} ({r['drop_pct']}% drop)")
        md.append("")
    else:
        md.append("No metric's median dropped >30% vs the previous "
                  "committed snapshot (BENCH_SUITE.json).")
        md.append("")
    md.append("Methodology: device numbers use the state-threaded "
              "differential harness with AUTO-CALIBRATED rep counts — each "
              "differential window is >= ~0.5 s of device compute so "
              "host-clock jitter is a percent-level error "
              "(utils/benchtime.py) — and trials implying rates above the "
              "config's speed-of-light bound are rejected as measurement "
              "artifacts. Headline numbers are MEDIANS; best/spread "
              "alongside. Trials run round-robin across configs to "
              "decorrelate noise bursts; every trial is recorded in "
              "BENCH_SUITE.json (with per-config calibration facts). "
              "Speed-of-light bounds are algorithmic: useful MACs at the "
              "card's published int8 tensor-core rate and minimal stream "
              f"bytes at its HBM rate ({PEAKS.source}; "
              "tsl_sdr_tpu/utils/roofline.py); 100% would mean zero "
              "overhead and perfect overlap, and a card capped below its "
              f"full power limit ({card}) cannot reach them. End-to-end "
              "rows are capped by the HOST->DEVICE link (int16 IQ is "
              "4 B/sample); the ceiling above is measured at bench time. "
              "Generated by bench_suite.py.")
    (REPO / "BENCH_SUITE.md").write_text("\n".join(md) + "\n")
    print("\n".join(md))

    out = {
        "device": dev,
        "card": card,
        "device_trials": DEVICE_TRIALS,
        "host_trials": HOST_TRIALS,
        "cpu_baseline_8ch_msps": cpu8,
        "ingest_bound_msps": round(ingest_bound, 2),
        "flat_summary": flat,
        "regressions": regressions,
        "prep_failures": prep_failures,
        "calibration": {
            name: {
                "rep_lo": b.rep_lo,
                "rep_hi": b.rep_hi,
                "window_ms": round(b.window_s * 1e3, 1),
                "bound_msps": b.bound_msps,
                "rejected_above_bound": b.rejected,
            }
            for name, b in CALIBRATION.items()
        },
    }
    (REPO / "BENCH_SUITE.json").write_text(json.dumps(out, indent=1) + "\n")
    if regressions:
        print(f"REGRESSIONS FLAGGED: {json.dumps(regressions)}",
              file=sys.stderr)


if __name__ == "__main__":
    main()
