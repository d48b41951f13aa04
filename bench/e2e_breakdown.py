#!/usr/bin/env python3
"""Additive breakdown of the e2e deployment rows (VERDICT r4 #1).

The streaming engines' host loop is SERIAL: every block is assembled,
uploaded, dispatched, and (inflight_depth blocks later) drained + decoded
by one thread. So the host-blocked seconds per phase — accumulated by
``ReceivePipeline.timing`` — sum to e2e wall time, giving the same
additive accounting of the e2e wall time:

    total = upload + dispatch + egress_start + drain_wait + unpack
            + decode + other (input assembly, python loop)

Alongside each config we record the SAME-RUN measured h2d/d2h host-link
bandwidths and the block's upload byte volume, so "h2d-bound" is shown,
not asserted. Writes bench/E2E_BREAKDOWN.json. Needs a GPU; the output
names the card and its power limit.

Configs: the three BENCH_SUITE e2e rows (POCSAG chain, 8ch production
pipeline, 8ch bit-exact pipeline) plus the 8-bit wire-ingest variant of
the production pipeline (rtl_u8: 2 B/sample upload, widened on device).
"""

import json
import statistics
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

TRIALS = 3


def measure_host_link():
    import jax
    import jax.numpy as jnp

    nbytes = 16 << 20
    host = np.zeros(nbytes // 2, np.int16)
    h2d, d2h = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        a = jax.device_put(host)
        float(jnp.sum(a[:4].astype(jnp.int32)))
        h2d.append(nbytes / (time.perf_counter() - t0))
    dev = jax.device_put(host)
    float(jnp.sum(dev[:4].astype(jnp.int32)))
    small = jax.device_put(np.zeros(1 << 18, np.int16))  # 512 KB probe
    for _ in range(3):
        t0 = time.perf_counter()
        np.asarray(small)
        d2h.append(small.nbytes / (time.perf_counter() - t0))
    return statistics.median(h2d), statistics.median(d2h)


def _iq_8ch(seed, caps_base):
    from tsl_sdr_tpu.testing import pocsag_gen

    decim = 32
    fs = 38400 * decim
    offsets = [-450_000, -320_000, -190_000, -60_000,
               60_000, 190_000, 320_000, 450_000]
    rng = np.random.default_rng(seed)
    parts = None
    for k, off in enumerate(offsets):
        bb = pocsag_gen.generate(
            [pocsag_gen.PocsagBurst(capcode=caps_base + k, function=1,
                                    kind="alpha", content=f"BD{k}")],
            baud=1200, tail_bits=256)
        dev = bb.astype(np.float64) / 16384.0 * 19200
        ph = np.cumsum(np.repeat(2 * np.pi * (off + dev) / fs, decim))
        sig = np.stack([np.cos(ph), np.sin(ph)], -1) * 4000
        if parts is None:
            parts = np.zeros((len(sig) + 2_000_000, 2))
        parts[200_000:200_000 + len(sig)] += sig
    x = parts + rng.normal(scale=80, size=parts.shape)
    return x, fs, decim, offsets


def _mk_pipe(fs, decim, offsets, caps_base, *, exact=False, wire="cs16",
             tiles=8, inflight_depth=4, drain_async=False):
    from tsl_sdr_tpu.models.pipeline import ChannelSpec, ReceivePipeline
    from tsl_sdr_tpu.utils.filter_design import firdes_low_pass

    center = 929_500_000
    return ReceivePipeline(
        firdes_low_pass(1.0, fs, 9_600, 7_000), center, fs, decim,
        [ChannelSpec(center + o, "pocsag") for o in offsets],
        exact=exact, wire_fmt=wire, inflight_depth=inflight_depth,
        drain_async=drain_async,
        block_size=4_194_304 if exact else None)


def run_pipeline_config(name, *, exact=False, wire="cs16", tiles=8,
                        inflight_depth=4, caps_base=500000,
                        drain_async=False):
    x, fs, decim, offsets = _iq_8ch(6, caps_base)
    iq16 = x.astype(np.int16)
    iq16 = np.concatenate([iq16] * tiles)
    if wire == "rtl_u8":
        feed = np.clip(np.round(x / 128.0) + 127, 0, 255) \
            .astype(np.uint8).reshape(-1)
        feed = np.concatenate([feed] * tiles)
        n_samples = feed.size // 2
    else:
        feed = iq16
        n_samples = len(feed)

    pipe = _mk_pipe(fs, decim, offsets, caps_base, exact=exact, wire=wire,
                    inflight_depth=inflight_depth, drain_async=drain_async)

    def run():
        # the exact tier's process_capture routes through the host-path
        # oracle; push/flush is its streaming deployment shape (and what
        # BENCH_SUITE times) — use it for both tiers
        res = pipe.push(feed)
        for c, part in enumerate(pipe.flush()):
            res[c].extend(part)
        return res

    res = run()  # warm + verify
    caps = sorted(set(m.capcode for msgs in res for m in msgs))
    assert caps == [caps_base + k for k in range(8)], caps

    best = None
    for _ in range(TRIALS):
        pipe.timing = {}
        t0 = time.perf_counter()
        run()
        total = time.perf_counter() - t0
        if best is None or total < best["total_s"]:
            stats = pipe.stream_stats
            best = {
                "total_s": total,
                "msps": n_samples / total / 1e6,
                "phases_s": {k: round(v, 4)
                             for k, v in sorted(pipe.timing.items())},
                "other_s": round(total - sum(pipe.timing.values()), 4),
                # the exact tier widens on host and uploads int16
                # (4 B/sample) through the chain's begin step; its
                # stream_stats don't track bytes, so compute directly
                "upload_bytes": (int(stats.get("upload_bytes", 0))
                                 or n_samples * 4),
                "blocks": int(stats.get("blocks", 0)),
            }
        pipe.timing = None
    best["n_samples"] = n_samples
    best["wire_fmt"] = wire
    print(f"{name}: {best['msps']:.1f} Msps  phases={best['phases_s']} "
          f"other={best['other_s']}", file=sys.stderr)
    return name, best


def run_pocsag_chain():
    """The 1-channel chain row: manual stage split (chain device path
    returns host PCM, so d2h of full PCM is inside chain_s)."""
    from tsl_sdr_tpu.models.channelizer import MultifmChain
    from tsl_sdr_tpu.models.pocsag import PocsagDecoder
    from tsl_sdr_tpu.testing import pocsag_gen
    from tsl_sdr_tpu.utils.filter_design import firdes_low_pass

    decim = 32
    fs = 38400 * decim
    offset = 250_000
    bursts = [pocsag_gen.PocsagBurst(capcode=1234567, function=1,
                                     kind="alpha", content="BENCH MSG")]
    bb = pocsag_gen.generate(bursts, baud=1200, amplitude=4096,
                             tail_bits=256)
    dev = bb.astype(np.float64) / 16384.0 * (38400 / 2)
    ph = np.cumsum(np.repeat(2 * np.pi * (offset + dev) / fs, decim))
    sig = (np.stack([np.cos(ph), np.sin(ph)], -1) * 9000).astype(np.int16)
    rng = np.random.default_rng(1)
    pad = rng.integers(-500, 500, size=(4_000_000, 2),
                       dtype=np.int64).astype(np.int16)
    iq = np.concatenate([pad, sig, pad])
    lpf = firdes_low_pass(1.0, fs, 9_600, 7_000)
    chain = MultifmChain(lpf, [offset], fs, decim, exact=False)
    chain.process_array(iq, block_size=4_000_000)  # warm

    best = None
    for _ in range(TRIALS):
        t0 = time.perf_counter()
        pcm = chain.process_array(iq, block_size=4_000_000)[0]
        t1 = time.perf_counter()
        msgs = PocsagDecoder().scan(pcm)
        t2 = time.perf_counter()
        assert any(m.capcode == 1234567 for m in msgs)
        total = t2 - t0
        if best is None or total < best["total_s"]:
            best = {
                "total_s": total,
                "msps": len(iq) / total / 1e6,
                "phases_s": {"chain_devpath_s": round(t1 - t0, 4),
                             "decode_s": round(t2 - t1, 4)},
                "other_s": 0.0,
                "upload_bytes": iq.nbytes,
                "n_samples": len(iq),
                "wire_fmt": "cs16",
            }
    print(f"pocsag_chain_e2e: {best['msps']:.1f} Msps "
          f"phases={best['phases_s']}", file=sys.stderr)
    return "pocsag_chain_e2e", best


def main():
    from tsl_sdr_tpu.utils.device import (card_line, enable_compile_cache,
                                          require_gpu)

    enable_compile_cache()
    dev = require_gpu()
    card = card_line()
    print(f"device: {dev}; card: {card}", file=sys.stderr)

    h2d, d2h = measure_host_link()
    print(f"host link: h2d {h2d / 1e6:.1f} MB/s, d2h {d2h / 1e6:.1f} MB/s",
          file=sys.stderr)

    out = {"device": dev, "card": card,
           "h2d_mbps": round(h2d / 1e6, 1),
           "d2h_mbps": round(d2h / 1e6, 1),
           "ingest_bound_msps_cs16": round(h2d / 4 / 1e6, 1),
           "ingest_bound_msps_u8": round(h2d / 2 / 1e6, 1),
           "configs": {}}

    for name, best in [
        run_pocsag_chain(),
        run_pipeline_config("pipeline_8ch_e2e", caps_base=100000),
        # async drain (the deployment CLI default): drain/decode overlaps
        # the next block's upload — phases then OVERLAP wall time, so the
        # sync rows above carry the additive model and these two carry
        # the shipped speed
        run_pipeline_config("pipeline_8ch_async_e2e", caps_base=100000,
                            drain_async=True),
        run_pipeline_config("pipeline_8ch_u8_e2e", wire="rtl_u8",
                            caps_base=200000),
        run_pipeline_config("pipeline_8ch_u8_async_e2e", wire="rtl_u8",
                            caps_base=200000, drain_async=True),
        run_pipeline_config("exact_pipeline_8ch_e2e", exact=True, tiles=4,
                            inflight_depth=2, caps_base=300000),
        run_pipeline_config("exact_pipeline_8ch_async_e2e", exact=True,
                            tiles=4, inflight_depth=2, caps_base=300000,
                            drain_async=True),
    ]:
        bps = 4 if best["wire_fmt"] == "cs16" else 2
        best["predicted_upload_s"] = round(
            best["n_samples"] * bps / h2d, 3)
        bound = h2d / bps / 1e6
        best["pct_of_ingest_bound"] = round(100 * best["msps"] / bound, 1)
        out["configs"][name] = best

    path = REPO / "bench" / "E2E_BREAKDOWN.json"
    path.write_text(json.dumps(out, indent=1) + "\n")
    print(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
