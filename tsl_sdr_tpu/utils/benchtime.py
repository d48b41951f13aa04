"""Differential device timing for the benchmark harnesses.

* the rep loop runs ON DEVICE as a ``lax.scan`` whose carry threads the
  streaming state through every rep (no rep can be hoisted or elided by
  XLA's loop-invariant code motion) and the output of every rep folds into
  a fetched checksum;
* per-rep time is the differential ``(T(hi) - T(lo)) / (hi - lo)``,
  cancelling dispatch + transfer overhead;
* the rep count is AUTO-CALIBRATED per config so the differential window
  ``(hi - lo) * t_rep`` is at least ``target_window_s`` (default 0.5 s) of
  device compute, which makes host-clock jitter a percent-level error.
  Rep counts snap to power-of-two buckets so the persistent compile cache
  hits across processes;
* trials whose implied rate exceeds the config's speed-of-light bound
  (utils/roofline.py, from the card's published peaks) are rejected as
  physically impossible measurement artifacts;
* callers report the MEDIAN of trials as the headline value (best/spread
  are recorded alongside for the regression log).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

__all__ = ["CalibratedBench", "make_calibrated_bench"]

_MAX_REPS = 4096
_MAX_HI_WALL_S = 30.0  # never let one hi run exceed this wall time


def _pow2_at_least(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


@dataclass
class CalibratedBench:
    """One differential trial per call; calibration facts recorded."""

    trial: object                      # () -> Msps | None
    rep_lo: int
    rep_hi: int
    t_rep_est_s: float                 # calibration estimate of per-rep time
    window_s: float                    # (rep_hi - rep_lo) * t_rep_est_s
    bound_msps: float | None = None
    rejected: list = field(default_factory=list)  # above-bound trial rates

    def __call__(self):
        return self.trial()


def make_calibrated_bench(
    step_fn,
    state0,
    blocks,
    samples_per_pass: int,
    *,
    target_window_s: float = 0.5,
    rep_lo: int = 2,
    probe_hi: int = 16,
    bound_msps: float | None = None,
) -> CalibratedBench:
    """Build a calibrated differential trial callable.

    ``step_fn(state, block) -> (state, out)`` is scanned over ``blocks``
    once per rep; ``samples_per_pass`` is the input samples consumed by one
    rep (one full scan over ``blocks``).
    """
    import jax
    import jax.numpy as jnp

    def make(reps):
        @jax.jit
        def run(state, blocks):
            def rep(carry, _):
                st, acc = carry
                st, out = jax.lax.scan(step_fn, st, blocks)
                return (st, acc + jnp.sum(out.astype(jnp.int32))), None

            (st, acc), _ = jax.lax.scan(
                rep, (state, jnp.int32(0)), None, length=reps
            )
            # consume all state leaves so nothing dead-codes away
            tot = acc.astype(jnp.float32)
            for leaf in jax.tree.leaves(st):
                tot = tot + jnp.sum(leaf.astype(jnp.float32))
            return tot

        return run

    run_lo = make(rep_lo)
    float(run_lo(state0, blocks))  # compile + warm with the exact shapes

    def timed(fn):
        t0 = time.perf_counter()
        float(fn(state0, blocks))
        return time.perf_counter() - t0

    # --- calibration: estimate per-rep device time with a probe count ---
    run_probe = make(probe_hi)
    float(run_probe(state0, blocks))  # compile
    diffs = []
    for _ in range(3):
        t_lo = timed(run_lo)
        t_pr = timed(run_probe)
        d = (t_pr - t_lo) / (probe_hi - rep_lo)
        if d > 0:
            diffs.append(d)
    # median of positive probes; if all swallowed by jitter the per-rep
    # time is far below host-clock noise -> assume a tiny value so we take
    # the rep-count cap (the biggest window we can buy)
    diffs.sort()
    t_rep = diffs[len(diffs) // 2] if diffs else 1e-5

    want = rep_lo + max(1, int(target_window_s / max(t_rep, 1e-9)))
    rep_hi = _pow2_at_least(want)
    rep_hi = min(rep_hi, _MAX_REPS,
                 _pow2_at_least(max(2, int(_MAX_HI_WALL_S / max(t_rep, 1e-9)))))
    if rep_hi <= rep_lo:
        rep_hi = rep_lo * 2
    if rep_hi == probe_hi:
        run_hi = run_probe
    else:
        run_hi = make(rep_hi)
        float(run_hi(state0, blocks))  # compile

    bench = CalibratedBench(
        trial=None,
        rep_lo=rep_lo,
        rep_hi=rep_hi,
        t_rep_est_s=t_rep,
        window_s=(rep_hi - rep_lo) * t_rep,
        bound_msps=bound_msps,
    )

    def trial():
        t_lo = timed(run_lo)
        t_hi = timed(run_hi)
        dt = (t_hi - t_lo) / (rep_hi - rep_lo)
        if dt <= 0:
            return None  # jitter swallowed the differential; drop trial
        rate = samples_per_pass / dt / 1e6
        if bound_msps is not None and rate > bound_msps:
            # faster than the hardware allows -> measurement artifact
            bench.rejected.append(round(rate, 1))
            return None
        return rate

    bench.trial = trial
    return bench
