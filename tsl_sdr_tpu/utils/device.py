"""The one place that decides where the program runs and where it caches.

* :func:`require_gpu` is the device check of every measurement and smoke
  path: it raises unless JAX's default device is a GPU, so a run that finds
  no accelerator fails instead of timing the CPU.
* :func:`enable_compile_cache` points JAX's persistent compilation cache at
  ``$JAX_COMPILATION_CACHE_DIR`` when that is set, and otherwise at a fixed
  ``.jax_cache/`` directory at the checkout root (listed in ``.gitignore``),
  so the cache key's path is the same in every process of a checkout.
* :func:`card_line` reads the card's name and power limit for the line every
  measurement prints beside its numbers.
"""

from __future__ import annotations

import os
import subprocess
from pathlib import Path

CHECKOUT_ROOT = Path(__file__).resolve().parents[2]
DEFAULT_CACHE_DIR = CHECKOUT_ROOT / ".jax_cache"


class NoAcceleratorError(RuntimeError):
    """Raised by :func:`require_gpu` when JAX's default device is not a GPU."""


def compile_cache_dir() -> Path:
    """The directory :func:`enable_compile_cache` uses."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    return Path(env) if env else DEFAULT_CACHE_DIR


def enable_compile_cache() -> Path:
    """Turn on JAX's persistent compilation cache (see module docstring)
    for programs that take at least half a second to compile.

    Safe to call more than once and before or after the backend starts."""
    import jax

    path = compile_cache_dir()
    if "JAX_COMPILATION_CACHE_DIR" not in os.environ:
        jax.config.update("jax_compilation_cache_dir", str(path))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    return path


def device_summary() -> dict:
    """``{"platform", "kind", "count"}`` of JAX's devices, as JAX reports
    them."""
    import jax

    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def require_gpu() -> dict:
    """Return :func:`device_summary`, or raise :class:`NoAcceleratorError`
    when JAX's default device is not a GPU (there is no CPU fallback)."""
    summary = device_summary()
    if summary["platform"] != "gpu":
        raise NoAcceleratorError(
            f"no GPU: JAX's default device is {summary['platform']} "
            f"({summary['kind']}); this path measures the accelerator only"
        )
    return summary


def card_line() -> str:
    """``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``,
    one line per card joined by ``; ``. Raises when nvidia-smi fails."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout
    return "; ".join(ln.strip() for ln in out.splitlines() if ln.strip())
