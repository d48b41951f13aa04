"""DSP kernel library (L2/L3 of the reference layer map, re-designed for accelerators).

Everything here is a pure function over JAX arrays: streaming state is an
explicit pytree threaded through ``(state, block) -> (state, out)`` calls so
kernels compose under ``jit``, ``scan``, ``vmap`` and ``shard_map``.
"""

from tsl_sdr_tpu.ops import q14  # noqa: F401
