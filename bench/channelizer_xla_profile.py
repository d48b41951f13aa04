#!/usr/bin/env python3
"""Where the XLA channelizer's time goes on the GPU, width by width.

For 8, 64 and 256 channels (128 taps, decimate by 40, 1 Msps — the
``bench.py`` flagship shape widened) this:

* compiles the production step ``MultifmChain._step_raw`` on one
  16,711,680-sample block and prints ``compiled.memory_analysis()``, the
  route XLA gave every matrix product (``utils.profiling.dot_routes``) and
  the bytes of the int32 accumulator buffers the entry computation
  materializes;
* times the step on the host clock, warmed, each trial ending in
  ``block_until_ready`` (state threaded from step to step);
* records one short ``jax.profiler`` trace per width and prints the device
  time per kernel, the busy share of the traced window, and the share of
  the kernels that hold a matrix product and of those that hold the FM
  discriminator's ``atan2``.

It also prints the dot routes of the bit-exact FIR step, the exact scan
tier, the resampler's packed-row and transposed tiers (16/25, 821 taps)
and the sharded channelizer's and resampler's per-shard kernels.
Optimized HLO text goes to ``--out``. Needs a GPU; every line names the card and its power limit.

    python bench/channelizer_xla_profile.py --out DIR
"""

from __future__ import annotations

import argparse
import json
import re
import statistics
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

FS = 1_000_000
DECIM = 40
TAPS = 128
BLOCK = 16_711_680
WIDTHS = (8, 64, 256)
TRIALS = 5  # timed trials per width; the median is reported
STEPS = 4   # steps per trial, state threaded from step to step


def _entry_s32_bytes(hlo_text: str) -> int:
    """Bytes of the s32 buffers the ENTRY computation materializes (each
    is written to device memory once and read back at least once)."""
    entry = hlo_text[hlo_text.find("\nENTRY"):]
    total = 0
    for m in re.finditer(r"= s32\[([\d,]*)\]", entry):
        dims = [int(x) for x in m.group(1).split(",") if x]
        total += 4 * int(np.prod(dims)) if dims else 4
    return total


def _print_routes(tag: str, hlo_text: str, card: str) -> list:
    from tsl_sdr_tpu.utils.profiling import dot_routes

    routes = dot_routes(hlo_text)
    seen: dict = {}
    for r in routes:
        key = (r["route"], " x ".join(r["types"][1:]) + " -> "
               + (r["types"][0] if r["types"] else "?"))
        seen[key] = seen.get(key, 0) + 1
    for (route, types), n in seen.items():
        print(f"[{card}] {tag}: {n} x {route}: {types}", flush=True)
    return routes


def _kernel_classes(hlo_text: str) -> tuple[set, set]:
    """Names of fusions/custom calls holding a matrix product (including a
    dot XLA rewrote into multiply+reduce), and of fusions holding an atan2
    (the FM discriminator)."""
    from tsl_sdr_tpu.utils.profiling import dot_routes, hlo_computations

    comps = hlo_computations(hlo_text)
    dot_comps = {r["computation"] for r in dot_routes(hlo_text)}
    atan_comps = {c for c, ls in comps.items()
                  if any("atan2(" in ln for ln in ls)}
    dots, fms = set(), set()
    for ls in comps.values():
        for ln in ls:
            m = re.match(r"^(?:ROOT\s+)?%?([\w.\-]+)\s*=", ln)
            if not m:
                continue
            calls = re.search(r"calls=%?([\w.\-]+)", ln)
            if calls and calls.group(1) in dot_comps:
                dots.add(m.group(1))
            if calls and calls.group(1) in atan_comps:
                fms.add(m.group(1))
            if "custom-call(" in ln and re.search(r"gemm|matmul|cublas", ln,
                                                  re.I):
                dots.add(m.group(1))
    return dots, fms


def profile_width(nr_ch: int, out: Path, card: str) -> dict:
    import jax
    import jax.numpy as jnp

    from tsl_sdr_tpu.models.channelizer import MultifmChain
    from tsl_sdr_tpu.utils.filter_design import firdes_low_pass
    from tsl_sdr_tpu.utils.profiling import device_kernel_times

    lpf = firdes_low_pass(1.0, FS, 12_500, 9_000)[:TAPS]
    rng = np.random.default_rng(nr_ch)
    offsets = rng.integers(-FS // 3, FS // 3, size=nr_ch)
    chain = MultifmChain(lpf, offsets, FS, DECIM, exact=False)
    iq = rng.integers(-8000, 8000, size=(chain.carry_len + BLOCK, 2),
                      dtype=np.int64).astype(np.int16)
    state = chain.init_state(prefix=iq[: chain.carry_len])
    block = jax.device_put(jnp.asarray(iq[chain.carry_len:].reshape(-1)))
    step = jax.jit(chain._step_raw)

    t0 = time.perf_counter()
    compiled = step.lower(state, block).compile()
    compile_s = time.perf_counter() - t0
    hlo = compiled.as_text()
    (out / f"step_{nr_ch}ch.hlo.txt").write_text(hlo)
    tag = f"{nr_ch}ch/{TAPS} taps/D{DECIM}"
    print(f"[{card}] {tag}: compile {compile_s:.3f} s (set-up); "
          f"memory_analysis {compiled.memory_analysis()}", flush=True)
    _print_routes(f"{tag} production step", hlo, card)
    acc_bytes = _entry_s32_bytes(hlo)
    print(f"[{card}] {tag}: s32 buffers materialized per step "
          f"{acc_bytes} B ({acc_bytes / BLOCK:.2f} B per input sample, "
          "written once and read at least once)", flush=True)

    st, pcm = step(state, block)  # warm
    pcm.block_until_ready()
    per_step = []
    for _ in range(TRIALS):
        st = state
        t0 = time.perf_counter()
        for _ in range(STEPS):
            st, pcm = step(st, block)
        pcm.block_until_ready()
        per_step.append((time.perf_counter() - t0) / STEPS)
    med = statistics.median(per_step)
    print(f"[{card}] {tag}: step times s {per_step}; median {med} s = "
          f"{BLOCK / med / 1e6} Msps (host clock, block_until_ready)",
          flush=True)

    tdir = out / f"trace_{nr_ch}ch"
    with jax.profiler.trace(str(tdir)):
        st = state
        for _ in range(3):
            st, pcm = step(st, block)
        pcm.block_until_ready()
    red = device_kernel_times(str(tdir))
    total = sum(red["kernels"].values()) or 1
    dots, fms = _kernel_classes(hlo)

    def share(names):
        # trace kernels carry the HLO instruction name with "." -> "_"
        norm = {n.replace(".", "_") for n in names}
        return sum(v for k, v in red["kernels"].items() if k in norm) / total

    dot_share = share(dots)
    fm_share = share(fms)
    top = sorted(red["kernels"].items(), key=lambda kv: -kv[1])[:12]
    print(f"[{card}] {tag}: trace busy {red['busy_ns']} ns of window "
          f"{red['window_ns']} ns (idle share "
          f"{1 - red['busy_ns'] / max(red['window_ns'], 1)}); "
          f"dot kernels {dot_share}, kernels holding atan2 {fm_share} of "
          "device time", flush=True)
    for name, ns in top:
        print(f"[{card}] {tag}:   {ns / total:.4f} {ns} ns {name}",
              flush=True)
    return {"channels": nr_ch, "compile_s": compile_s, "step_s": per_step,
            "median_step_s": med, "msps": BLOCK / med / 1e6,
            "s32_bytes_per_step": acc_bytes, "dot_share": dot_share,
            "fm_share": fm_share, "busy_ns": red["busy_ns"],
            "window_ns": red["window_ns"],
            "top_kernels": [[n, ns] for n, ns in top]}


def other_routes(out: Path, card: str):
    """Dot routes of the other int16 product sites (module docstring)."""
    import jax
    import jax.numpy as jnp

    from tsl_sdr_tpu.models.channelizer import MultifmChain
    from tsl_sdr_tpu.ops import fir, packed_fir, polyphase, q14
    from tsl_sdr_tpu.utils.filter_design import (
        design_rational_resampler_filter, firdes_low_pass)

    lpf = firdes_low_pass(1.0, FS, 12_500, 9_000)[:TAPS]
    chain = MultifmChain(lpf, np.arange(8) * 50_000 - 200_000, FS, DECIM,
                         exact=True)
    plan = chain.packed_plan
    carry = packed_fir.init_packed_carry(plan)
    block = jnp.zeros((2 * 1_048_320,), jnp.int16)
    hlo = jax.jit(
        lambda c, b: packed_fir.packed_fir_step_exact(plan, c, b)
    ).lower(carry, block).compile().as_text()
    (out / "exact_step_8ch.hlo.txt").write_text(hlo)
    _print_routes("8ch exact FIR step", hlo, card)

    # the readable exact scan tier (ops/fir.py)
    splan = chain.plan
    sstate = fir.init_channel_fir_state(splan)
    hlo = jax.jit(
        lambda st, b: fir.channel_fir_step(splan, st, b, exact=True)
    ).lower(sstate, jnp.zeros((40_960, 2), jnp.int16)).compile().as_text()
    _print_routes("8ch exact scan tier", hlo, card)

    coeffs = q14.quantize_q14(design_rational_resampler_filter(16, 25, 0.4))
    for form, k_row_max in (("packed-row", 1024), ("transposed", 1)):
        rplan = polyphase.make_resampler_plan(coeffs, 16, 25,
                                              block_out_target=65_536,
                                              k_row_max=k_row_max)
        st = polyphase.init_resampler_state(rplan)
        for exact in (False, True):
            hlo = jax.jit(
                lambda s, b, e=exact, p=rplan: polyphase.resample_step(
                    p, s, b, exact=e)
            ).lower(st, jnp.zeros((rplan.block_in,), jnp.int16)).compile(
            ).as_text()
            name = "exact" if exact else "production"
            (out / f"resampler_{form}_{name}.hlo.txt").write_text(hlo)
            _print_routes(f"resampler 16/25 821 taps {form} {name} tier",
                          hlo, card)

    # the sharded kernels' per-shard dots, on a one-device mesh
    from tsl_sdr_tpu.parallel.channelizer import make_sharded_multifm
    from tsl_sdr_tpu.parallel.mesh import make_mesh
    from tsl_sdr_tpu.parallel.resampler import make_sharded_resampler

    mesh = make_mesh(time=1, channels=1, devices=jax.devices()[:1])
    fast = MultifmChain(lpf, np.arange(8) * 50_000 - 200_000, FS, DECIM,
                        exact=False)
    hlo = jax.jit(make_sharded_multifm(fast.packed_plan, mesh)).lower(
        jnp.zeros((2 * 1_048_320,), jnp.int16)).compile().as_text()
    _print_routes("8ch sharded channelizer (per shard)", hlo, card)
    rplan = polyphase.make_resampler_plan(coeffs, 16, 25,
                                          block_out_target=65_536)
    hlo = jax.jit(make_sharded_resampler(rplan, mesh)).lower(
        jnp.zeros((rplan.d_rep * 4096,), jnp.int16)).compile().as_text()
    _print_routes("sharded resampler (per shard)", hlo, card)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", required=True,
                    help="directory for the optimized HLO and summary.json")
    args = ap.parse_args(argv)

    from tsl_sdr_tpu.utils.device import (card_line, enable_compile_cache,
                                          require_gpu)

    dev = require_gpu()
    enable_compile_cache()
    card = card_line()
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    print(f"card: {card}; jax device {dev}", flush=True)
    other_routes(out, card)
    rows = [profile_width(w, out, card) for w in WIDTHS]
    (out / "summary.json").write_text(json.dumps(
        {"card": card, "device": dev, "rows": rows}, indent=1))


if __name__ == "__main__":
    main()
