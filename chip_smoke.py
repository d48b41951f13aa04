#!/usr/bin/env python3
"""Smoke test of the receive pipeline on one GPU.

Runs the system's main path once through the entry points a user calls,
at the reference's own deployment sizes, with every input generated from
``--seed``. Phases, each printing its result on its own line:

1. device — JAX's default device must be a GPU (no CPU fallback); prints
   its kind and count and the card's name and power limit;
2. numerics — at 8ch/128 taps/D40, 8ch/365 taps/D40, 64ch and 256ch/128
   taps/D40 and 3ch/577 taps/D32 (>= 4 M samples each), the bit-exact
   tier equals the same tier on the CPU backend bit for bit and the
   production tier tracks the float64 reference within 2 PCM LSB (99.9 %
   within 1); the resampler's packed-row tier at 16/25 (821 taps) the
   same way;
3. served path — ``pipeline-tpu`` (``cli.pipeline.main``) on a 60 s pager
   capture of ``etc/pipeline_pager_example.json`` (1.2288 Msps, 577 taps,
   POCSAG + FLEX + PCM), in batch and ``--follow`` file mode: every
   encoded message decoded, nothing else, the same in both modes;
4. ``multifm-tpu`` (``cli.multifm.main``, native runtime) on the 8-channel
   ``etc/multifm_rtlsdr_8ch.json`` plan switched to a file source: each
   channel's PCM equals the library's production tier on the same capture,
   sample for sample and at the same length.

``--four-cards`` runs only the four-card phase instead: ``pipeline-tpu
--time-shards 4`` on the pager capture, ``--channel-shards 4`` on the
8-channel plan with every channel POCSAG, and ``make_sharded_multifm`` at
64 channels on a time 2 x channels 2 mesh, each against the one-card run
of the same input in the same process.

The last line of standard output is ``{"ok": true, "device": {...}}``;
a failed phase raises, so the script exits non-zero and prints no such
line. Times printed are one smoke reading, not a benchmark.

    python chip_smoke.py [--seed N] [--four-cards]
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent

NUMERICS_SAMPLES = 4_194_304
RESAMPLER_SAMPLES = 4_194_304
PAGER_SECONDS = 60.0
MULTIFM_SECONDS = 8.0
SHARDED_SEGMENT = 320 * 6_554  # samples per time shard, whole 640-value rows


def say(phase: str, msg: str):
    print(f"[{phase}] {msg}", flush=True)


class CompileClock:
    """Seconds JAX spends tracing, lowering and compiling (set-up time),
    summed from ``jax.monitoring`` duration events."""

    def __init__(self):
        import jax

        self.seconds = 0.0
        jax.monitoring.register_event_duration_secs_listener(self._on)

    def _on(self, event, duration, **_):
        if event.startswith("/jax/core/compile/"):
            self.seconds += duration


def phase_device(count: int | None) -> dict:
    from tsl_sdr_tpu.utils.device import card_line, require_gpu

    dev = require_gpu()
    if count is not None and dev["count"] < count:
        raise RuntimeError(f"need {count} GPUs, JAX sees {dev['count']}")
    say("device", f"{dev['platform']} {dev['kind']} x{dev['count']}; "
                  f"card {card_line()}")
    return dev


def phase_numerics(seed: int):
    from tsl_sdr_tpu.testing import numerics

    for width in numerics.WIDTHS:
        t0 = time.perf_counter()
        r = numerics.check_channelizer(width, NUMERICS_SAMPLES, seed)
        say("numerics", f"{r['width']}: {r['samples']} samples, exact tier "
            f"{'==' if r['exact_equal'] else '!='} CPU backend over "
            f"{r['outputs']} outputs; production vs float64: max "
            f"{r['max_lsb']} LSB, {r['within_1']:.6f} within 1 LSB; "
            f"peak_bytes_in_use {r['peak_bytes_in_use']}; step "
            f"{r['step_memory']}; {time.perf_counter() - t0:.1f} s")
        if not (r["exact_equal"] and r["production_ok"]):
            raise AssertionError(f"numerics failed at {width.name}: {r}")
    r = numerics.check_resampler(RESAMPLER_SAMPLES, seed)
    say("numerics", f"{r['width']}: {r['samples']} samples, exact tier "
        f"{'==' if r['exact_equal'] else '!='} CPU backend over "
        f"{r['outputs']} outputs; production vs exact: max {r['max_lsb']} "
        f"LSB, {r['within_1']:.6f} within 1 LSB; peak_bytes_in_use "
        f"{r['peak_bytes_in_use']}")
    if not (r["exact_equal"] and r["production_ok"]):
        raise AssertionError(f"resampler numerics failed: {r}")


def _write_config(cfg: dict, path: Path, iq_path: Path, pcm_dir: Path):
    cfg = dict(cfg, device={"type": "file", "filename": str(iq_path),
                            "fileFormat": "cs16"})
    cfg["channels"] = [
        dict(ch, outFifo=str(pcm_dir / f"ch{i}.pcm")
             if ch.get("protocol", "pcm") == "pcm" else "")
        for i, ch in enumerate(cfg["channels"])]
    path.write_text(json.dumps(cfg))
    return path


def _run_pipeline(cfg_path: Path, out: Path, extra: list, clock,
                  phase: str, tag: str, n_samples: int) -> list:
    from tsl_sdr_tpu.cli import pipeline as pipeline_cli
    from tsl_sdr_tpu.testing.pager_capture import messages_from_json

    c0 = clock.seconds
    t0 = time.perf_counter()
    rc = pipeline_cli.main([str(cfg_path), "-o", str(out), *extra])
    wall = time.perf_counter() - t0
    if rc != 0:
        raise RuntimeError(f"pipeline-tpu {tag} exited {rc}")
    setup = clock.seconds - c0
    msgs = messages_from_json(out.read_text().splitlines())
    say(phase, f"{tag}: {len(msgs)} messages; wall {wall:.2f} s, of which "
        f"compile (set-up) {setup:.2f} s; {n_samples / wall / 1e6:.2f} "
        f"Msps wall, {n_samples / max(wall - setup, 1e-9) / 1e6:.2f} Msps "
        "after set-up (one smoke reading, not a benchmark)")
    return msgs


def _pcm_tone_hz(path: Path, rate: float) -> float:
    import numpy as np

    pcm = np.fromfile(path, np.int16).astype(np.float64)
    spec = np.abs(np.fft.rfft(pcm - pcm.mean()))
    return float(np.fft.rfftfreq(pcm.size, 1.0 / rate)[spec.argmax()])


def phase_served(seed: int, tmp: Path, clock):
    from tsl_sdr_tpu.testing.pager_capture import load_config, pager_capture

    cfg = load_config()
    t0 = time.perf_counter()
    iq, expected = pager_capture(PAGER_SECONDS, seed, cfg)
    iq_path = tmp / "pager.cs16"
    iq.reshape(-1).tofile(iq_path)
    say("served", f"pager capture {iq.shape[0]} samples "
        f"({PAGER_SECONDS:.0f} s at {cfg['sampleRateHz']} sps, "
        f"{iq_path.stat().st_size} B cs16), {len(expected)} encoded "
        f"messages, generated in {time.perf_counter() - t0:.1f} s")
    ch_rate = cfg["sampleRateHz"] / cfg["decimationFactor"]
    for mode, extra in (("batch", []),
                        ("follow", ["--follow", "--idle-exit", "0"])):
        pcm_dir = tmp / f"pcm_{mode}"
        pcm_dir.mkdir()
        cfg_path = _write_config(cfg, tmp / f"pager_{mode}.json", iq_path,
                                 pcm_dir)
        msgs = _run_pipeline(cfg_path, tmp / f"msgs_{mode}.json", extra,
                             clock, "served", f"pipeline-tpu {mode}",
                             iq.shape[0])
        if msgs != expected:
            missing = sorted(set(expected) - set(msgs))
            extra_m = sorted(set(msgs) - set(expected))
            raise AssertionError(f"{mode}: {len(missing)} missing "
                                 f"{missing[:5]}, {len(extra_m)} extra "
                                 f"{extra_m[:5]}")
        for pcm_file in pcm_dir.iterdir():
            hz = _pcm_tone_hz(pcm_file, ch_rate)
            say("served", f"{mode}: pcm channel {pcm_file.name} "
                f"{pcm_file.stat().st_size // 2} samples, tone {hz:.1f} Hz")
            if abs(hz - 1000.0) > 5.0:
                raise AssertionError(f"pcm tone at {hz} Hz, sent 1000 Hz")
    say("served", f"batch and follow each decoded all {len(expected)} "
        "encoded messages and nothing else (identical)")
    return iq_path, expected


def phase_multifm(seed: int, tmp: Path, clock):
    import numpy as np

    from tsl_sdr_tpu.cli import multifm as multifm_cli
    from tsl_sdr_tpu.models.channelizer import MultifmChain
    from tsl_sdr_tpu.testing import numerics
    from tsl_sdr_tpu.testing.pager_capture import (MULTIFM_8CH_CONFIG,
                                                   fm_tone_capture,
                                                   load_config)
    from tsl_sdr_tpu.utils.config import MultifmConfig

    cfg = load_config(MULTIFM_8CH_CONFIG)
    iq = fm_tone_capture(cfg, MULTIFM_SECONDS, seed)
    iq_path = tmp / "multifm8.cs16"
    iq.reshape(-1).tofile(iq_path)
    cfg = dict(cfg, device={"type": "file", "filename": str(iq_path),
                            "fileFormat": "cs16"})
    cfg["channels"] = [dict(ch, outFifo=str(tmp / f"mf_ch{i}.pcm"))
                       for i, ch in enumerate(cfg["channels"])]
    cfg_path = tmp / "multifm8.json"
    cfg_path.write_text(json.dumps(cfg))
    c0 = clock.seconds
    t0 = time.perf_counter()
    rc = multifm_cli.main([str(cfg_path), "--runtime", "native"])
    wall = time.perf_counter() - t0
    if rc != 0:
        raise RuntimeError(f"multifm-tpu exited {rc}")
    want = MultifmChain.from_config(MultifmConfig.load(str(cfg_path)),
                                    exact=False).process_array(iq)
    for i in range(want.shape[0]):
        got = np.fromfile(tmp / f"mf_ch{i}.pcm", np.int16)
        if got.shape != want[i].shape or not np.array_equal(got, want[i]):
            n = min(got.size, want.shape[1])
            a = numerics.lsb_agreement(got[:n], want[i, :n], skip=0)
            raise AssertionError(f"multifm channel {i}: {got.size} samples "
                                 f"vs library {want.shape[1]}; common span "
                                 f"{a}")
    say("multifm", f"multifm-tpu native runtime, {want.shape[0]} channels "
        f"x {want.shape[1]} samples: identical to the library production "
        f"tier, same length; wall {wall:.2f} s, compile (set-up) "
        f"{clock.seconds - c0:.2f} s (one smoke reading)")


def phase_four_cards(seed: int, tmp: Path, clock):
    from tsl_sdr_tpu.testing import numerics
    from tsl_sdr_tpu.testing.pager_capture import (MULTIFM_8CH_CONFIG,
                                                   load_config,
                                                   pager_capture,
                                                   pocsag_capture)

    phase = "four-cards"
    cfg = load_config()
    iq, expected = pager_capture(PAGER_SECONDS, seed, cfg)
    iq_path = tmp / "pager.cs16"
    iq.reshape(-1).tofile(iq_path)
    runs = {}
    for tag, extra in (("one card", []), ("--time-shards 4",
                                          ["--time-shards", "4"])):
        pcm_dir = tmp / f"pcm_{len(runs)}"
        pcm_dir.mkdir()
        cfg_path = _write_config(cfg, tmp / f"pager_{len(runs)}.json",
                                 iq_path, pcm_dir)
        runs[tag] = _run_pipeline(cfg_path, tmp / f"m_{len(runs)}.json",
                                  extra, clock, phase,
                                  f"pager pipeline-tpu {tag}", iq.shape[0])
    if not (runs["one card"] == runs["--time-shards 4"] == expected):
        raise AssertionError("time-sharded pager messages differ")
    say(phase, f"--time-shards 4: all {len(expected)} messages, identical "
        "to one card")

    # the 8-channel RTL-SDR plan, every channel assumed POCSAG
    cfg8 = load_config(MULTIFM_8CH_CONFIG)
    for ch in cfg8["channels"]:
        ch["protocol"] = "pocsag"
    iq8, expected8 = pocsag_capture(cfg8, 30.0, seed)
    iq8_path = tmp / "pocsag8.cs16"
    iq8.reshape(-1).tofile(iq8_path)
    runs = {}
    for tag, extra in (("one card", []), ("--channel-shards 4",
                                          ["--channel-shards", "4"])):
        cfg_path = _write_config(cfg8, tmp / f"p8_{len(runs)}.json",
                                 iq8_path, tmp)
        runs[tag] = _run_pipeline(cfg_path, tmp / f"m8_{len(runs)}.json",
                                  extra, clock, phase,
                                  f"8ch POCSAG pipeline-tpu {tag}",
                                  iq8.shape[0])
    if not (runs["one card"] == runs["--channel-shards 4"] == expected8):
        raise AssertionError("channel-sharded 8ch messages differ")
    say(phase, f"--channel-shards 4: all {len(expected8)} messages, "
        "identical to one card")

    r = numerics.check_sharded_multifm(
        64, 2, 2, taps=128, decimation=40, fs=1_000_000,
        segment=SHARDED_SEGMENT, seed=seed)
    say(phase, f"make_sharded_multifm 64ch/128 taps/D40 on time 2 x "
        f"channels 2, {r['samples']} samples: max {r['max_lsb']} LSB, "
        f"{r['identical']:.6f} identical, {r['within_1']:.6f} within 1 LSB "
        "of one card")
    if not r["equal_ok"]:
        raise AssertionError(f"sharded multifm differs from one card: {r}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Smoke test of the receive pipeline on the GPU.")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card sharded phase")
    args = ap.parse_args(argv)

    sys.path.insert(0, str(REPO))
    from tsl_sdr_tpu.utils.device import card_line, enable_compile_cache

    enable_compile_cache()
    dev = phase_device(4 if args.four_cards else None)
    clock = CompileClock()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as d:
        tmp = Path(d)
        if args.four_cards:
            phase_four_cards(args.seed, tmp, clock)
        else:
            phase_numerics(args.seed)
            phase_served(args.seed, tmp, clock)
            phase_multifm(args.seed, tmp, clock)
    print(f"card: {card_line()}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": dev["platform"], "kind": dev["kind"],
        "count": dev["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
