"""Table-driven fast arctangent matching the reference demodulator.

The reference FM discriminator uses a public-domain 257-entry arctan LUT with
linear interpolation (reference ``multifm/fast_atan2f.c:14-174``): entries are
``atan(i / 255)`` for i in 0..255 printed to 7 significant digits (entry 256
repeats entry 255 so interpolation at z == 1.0 is exact). We *regenerate* the
table from that definition rather than porting the constants; a unit test
pins spot values against the published table.

Two implementations:

* :func:`fast_atan2` — vectorized jnp/f32, jit friendly.
* :func:`fast_atan2_np` — numpy implementation with C float/double promotion
  semantics, used as the bit-exact host oracle.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

TAN_MAP_RES = 0.003921569  # smallest non-zero table abscissa (1/255, rounded)
TAN_MAP_SIZE = 255

_PI_F32 = np.float32(3.14159265358979323846)
_HALF_PI_F32 = np.float32(1.57079632679489661923)


def _build_table() -> np.ndarray:
    """atan(i/255) for i=0..255 (+ repeated last entry), rounded the way the
    published table was printed (7 significant digits), stored as float32."""
    idx = np.minimum(np.arange(257), 255)
    exact = np.arctan(idx / 255.0)
    return np.asarray(
        [np.float32(float(f"{v:.6e}")) for v in exact], dtype=np.float32
    )


ATAN_TABLE = _build_table()
_ATAN_TABLE_J = jnp.asarray(ATAN_TABLE)


def fast_atan2(y, x):
    """Vectorized LUT arctan of (y, x) -> angle in (-pi, pi], float32.

    Matches reference ``multifm/fast_atan2f.c:101-174`` to float32 rounding.
    """
    y = jnp.asarray(y, dtype=jnp.float32)
    x = jnp.asarray(x, dtype=jnp.float32)
    y_abs = jnp.abs(y)
    x_abs = jnp.abs(x)
    both_zero = (y_abs == 0) & (x_abs == 0)

    lo = jnp.minimum(y_abs, x_abs)
    hi = jnp.maximum(y_abs, x_abs)
    # z = min/max in [0, 1]; guard 0/0 (result unused under both_zero mask)
    z = lo / jnp.where(hi == 0, jnp.float32(1), hi)

    alpha = z * jnp.float32(TAN_MAP_SIZE)
    index = alpha.astype(jnp.int32) & 0xFF
    frac = alpha - index.astype(jnp.float32)
    t0 = _ATAN_TABLE_J[index]
    t1 = _ATAN_TABLE_J[index + 1]
    interp = t0 + (t1 - t0) * frac
    base_angle = jnp.where(z < jnp.float32(TAN_MAP_RES), z, interp)

    # Quadrant unfolding (all float32, same constants as the reference).
    x_major = x_abs > y_abs
    angle_xmajor = jnp.where(
        x >= 0,
        jnp.where(y >= 0, base_angle, -base_angle),
        jnp.where(y >= 0, _PI_F32 - base_angle, base_angle - _PI_F32),
    )
    angle_ymajor = jnp.where(
        y >= 0,
        jnp.where(x >= 0, _HALF_PI_F32 - base_angle, _HALF_PI_F32 + base_angle),
        jnp.where(x >= 0, -_HALF_PI_F32 + base_angle, -_HALF_PI_F32 - base_angle),
    )
    angle = jnp.where(x_major, angle_xmajor, angle_ymajor)
    return jnp.where(both_zero, jnp.float32(0), angle)


def fast_atan2_np(y, x) -> np.ndarray:
    """Numpy oracle with exact C promotion semantics (float32 ops, double
    constants folded to float32 where C folds them)."""
    y = np.asarray(y, dtype=np.float32)
    x = np.asarray(x, dtype=np.float32)
    y_abs = np.abs(y)
    x_abs = np.abs(x)
    both_zero = (y_abs == 0) & (x_abs == 0)

    hi = np.maximum(y_abs, x_abs)
    safe_hi = np.where(hi == 0, np.float32(1), hi)
    z = (np.minimum(y_abs, x_abs) / safe_hi).astype(np.float32)

    alpha = (z * np.float32(TAN_MAP_SIZE)).astype(np.float32)
    index = alpha.astype(np.int32) & 0xFF
    frac = (alpha - index.astype(np.float32)).astype(np.float32)
    t0 = ATAN_TABLE[index]
    t1 = ATAN_TABLE[index + 1]
    interp = (t0 + ((t1 - t0) * frac).astype(np.float32)).astype(np.float32)
    # C compares double(z) < 0.003921569 (double); z is exactly representable
    base_angle = np.where(z.astype(np.float64) < TAN_MAP_RES, z, interp)

    x_major = x_abs > y_abs
    angle_xmajor = np.where(
        x >= 0,
        np.where(y >= 0, base_angle, -base_angle),
        np.where(y >= 0, _PI_F32 - base_angle, base_angle - _PI_F32),
    )
    angle_ymajor = np.where(
        y >= 0,
        np.where(x >= 0, _HALF_PI_F32 - base_angle, _HALF_PI_F32 + base_angle),
        np.where(x >= 0, -_HALF_PI_F32 + base_angle, -_HALF_PI_F32 - base_angle),
    )
    angle = np.where(x_major, angle_xmajor, angle_ymajor).astype(np.float32)
    return np.where(both_zero, np.float32(0), angle)
