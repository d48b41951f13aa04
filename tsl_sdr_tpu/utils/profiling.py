"""Observability: throughput meters and JAX profiler traces.

The reference's only observability is a handful of counters logged at
thread exit (``multifm/demod.h:71-81``); SURVEY §5 calls for real
profiling in the new framework. Two tools:

* :class:`Throughput` — running samples/s meter with EMA smoothing, for
  CLI --stats style reporting.
* :func:`trace` — context manager around ``jax.profiler`` writing a
  TensorBoard-loadable trace of device execution.
"""

from __future__ import annotations

import contextlib
import time


class Throughput:
    """Running samples/s with an exponential moving average."""

    def __init__(self, alpha: float = 0.2):
        self.alpha = alpha
        self.total = 0
        self.rate = 0.0
        self._t_last = None

    def update(self, n_samples: int):
        now = time.monotonic()
        self.total += n_samples
        if self._t_last is not None:
            dt = now - self._t_last
            if dt > 0:
                inst = n_samples / dt
                self.rate = (
                    inst if self.rate == 0.0
                    else self.alpha * inst + (1 - self.alpha) * self.rate
                )
        self._t_last = now

    def summary(self) -> str:
        return f"{self.total} samples, {self.rate / 1e6:.2f} Msps"


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the enclosed block: ``with trace('traces'): run()``.

    View with TensorBoard's profile plugin (or xprof). Produces device
    timelines for every XLA/Pallas kernel the block dispatches.
    """
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def hlo_computations(hlo_text: str) -> dict[str, list[str]]:
    """Split HLO module text into ``{computation name: [instruction
    lines, stripped]}`` (ENTRY included, under its own name)."""
    import re

    comps: dict[str, list[str]] = {}
    cur = None
    for line in hlo_text.splitlines():
        if line and not line[0].isspace() and line.rstrip().endswith("{"):
            m = re.match(r"^(?:ENTRY\s+)?%?([\w.\-]+)", line)
            cur = m.group(1) if m else None
            if cur is not None:
                comps[cur] = []
            continue
        if cur is not None and line.startswith("  "):
            comps[cur].append(line.strip())
    return comps


def dot_routes(hlo_text: str) -> list[dict]:
    """Every matrix product in an optimized HLO module and the route XLA
    gave it.

    ``hlo_text`` is ``jax.jit(f).lower(...).compile().as_text()`` (the same
    module ``XLA_FLAGS=--xla_dump_to`` writes after optimization). Returns
    one dict per ``dot`` or GEMM custom call: ``computation`` (where it
    sits), ``op`` (``dot`` or the custom-call target), ``types`` (result
    type first, then operand types) and ``route``:

    * ``library call <target>`` — a cuBLAS/cuBLASLt (or other) custom call;
    * ``Triton GEMM fusion`` — a ``kCustom`` fusion whose backend config
      names a Triton GEMM;
    * ``<kind> fusion`` — a dot inside a fusion XLA emits itself (for
      example ``kLoop``);
    * ``unfused dot`` — a dot left in a non-fusion computation;
    * ``multiply+reduce in ...`` — a ``dot_general`` XLA rewrote into a
      broadcast-multiply-reduce (found by its metadata).
    """
    import re

    comps = hlo_computations(hlo_text)
    callers: dict[str, tuple[str, str]] = {}
    for lines in comps.values():
        for ln in lines:
            if " fusion(" not in ln:
                continue
            calls = re.search(r"calls=%?([\w.\-]+)", ln)
            kind = re.search(r"kind=(k\w+)", ln)
            backend = re.search(r'"kind":"([^"]+)"', ln)
            if calls:
                callers[calls.group(1)] = (
                    kind.group(1) if kind else "",
                    backend.group(1) if backend else "",
                )
    routes = []
    for comp, lines in comps.items():
        defined = {}  # instruction name -> result type, for operand types
        for ln in lines:
            m = re.match(r"^(?:ROOT\s+)?%?([\w.\-]+)\s*=\s*([a-z]+\d*\[[\d,]*\])",
                         ln)
            if m:
                defined[m.group(1)] = m.group(2)
        for ln in lines:
            target = re.search(r'custom_call_target="([^"]+)"', ln)
            is_gemm_call = bool(
                target and re.search(r"gemm|matmul|cublas", target.group(1),
                                     re.I))
            # XLA may rewrite a dot_general it has no kernel for into a
            # broadcast-multiply-reduce; its metadata keeps the origin
            as_reduce = bool(re.search(r"\breduce\(", ln)
                             and re.search(r'op_name="[^"]*dot_general"', ln))
            if not (re.search(r"\bdot\(", ln) or is_gemm_call
                    or as_reduce):
                continue
            rhs = ln.split(" = ", 1)[-1]
            result = re.match(r"([a-z]+\d*\[[\d,]*\])", rhs)
            args = rhs[rhs.find("(") + 1:rhs.find(")")]
            types = ([result.group(1)] if result else []) + [
                defined.get(a, "?")
                for a in re.findall(r"%([\w.\-]+)", args)
            ]
            if is_gemm_call:
                route = f"library call {target.group(1)}"
            elif comp in callers:
                kind, backend = callers[comp]
                route = ("Triton GEMM fusion" if "triton" in backend.lower()
                         else f"{kind or 'unknown'} fusion"
                         + (f" ({backend})" if backend else ""))
            else:
                route = "unfused dot"
            if as_reduce:
                route = "multiply+reduce in " + route
            routes.append({
                "computation": comp,
                "op": (target.group(1) if is_gemm_call
                       else "reduce" if as_reduce else "dot"),
                "types": types,
                "route": route,
            })
    return routes


def device_kernel_times(trace_dir: str) -> dict:
    """Reduce a ``jax.profiler`` trace to device time per kernel.

    Reads the newest ``*.xplane.pb`` under ``trace_dir``. Kernel events are
    those on the GPU planes' stream lines (the ``XLA Ops`` / ``XLA
    Modules`` summary lines are skipped so nothing counts twice). Returns
    ``{"kernels": {name: total_ns}, "busy_ns": union of kernel intervals,
    "window_ns": first start to last end}``."""
    from pathlib import Path

    from jax.profiler import ProfileData

    files = sorted(Path(trace_dir).rglob("*.xplane.pb"),
                   key=lambda p: p.stat().st_mtime)
    if not files:
        raise FileNotFoundError(f"no .xplane.pb under {trace_dir}")
    data = ProfileData.from_file(str(files[-1]))
    kernels: dict[str, int] = {}
    spans = []
    for plane in data.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            if line.name.startswith("XLA") or line.name == "Steps":
                continue
            for ev in line.events:
                dur = int(ev.duration_ns)
                kernels[ev.name] = kernels.get(ev.name, 0) + dur
                spans.append((int(ev.start_ns), int(ev.start_ns) + dur))
    busy = 0
    end = None
    for s, e in sorted(spans):
        if end is None or s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    window = (max(e for _, e in spans) - min(s for s, _ in spans)
              if spans else 0)
    return {"kernels": kernels, "busy_ns": busy, "window_ns": window}
