"""FM quadrature discriminator.

Reference behavior (``multifm/fm_demod.c:36-83``): per sample,
``s = a[n] * conj(a[n-1])`` in int32, then ``phi = fast_atan2f(s_im, s_re)``
and ``pcm[n] = (int16)((phi / pi) * 2^14)`` (C truncating cast).

Accelerator redesign: the one-sample history is a tiny state carry; the conjugate
product and LUT atan vectorize across the whole block on the VPU. Output is
int16 PCM in both tiers (the decoders consume int16); the ``exact`` flag only
controls the upstream arithmetic, the discriminator itself is float32 with a
worst-case +/-1 LSB divergence from the C double-promoted scaling (messages
are unaffected; see tests/test_fm.py).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax.numpy as jnp

from tsl_sdr_tpu.ops import q14
from tsl_sdr_tpu.ops.atan2 import fast_atan2, fast_atan2_np

_PI_F32 = np.float32(np.pi)


class FmDemodState(NamedTuple):
    last: jnp.ndarray  # [..., 2] int32 — previous IQ sample (0 at stream start)


def init_fm_state(batch_shape=()) -> FmDemodState:
    return FmDemodState(last=jnp.zeros(batch_shape + (2,), dtype=jnp.int32))


def fm_demod_step(state: FmDemodState, block):
    """block: [..., N, 2] int Q.14 IQ -> ([..., N] int16 PCM, new state).

    Leading batch dims (e.g. channels) broadcast; history is per-batch.
    """
    block = jnp.asarray(block)
    if jnp.issubdtype(block.dtype, jnp.floating):
        # fast tier: IQ arrives as float32 in sample units; the conj product
        # and angle stay float (only the angle matters to the discriminator)
        a = block.astype(jnp.float32)
        prev_f = jnp.concatenate(
            [state.last.astype(jnp.float32)[..., None, :], a[..., :-1, :]], axis=-2
        )
        s_re = a[..., 0] * prev_f[..., 0] + a[..., 1] * prev_f[..., 1]
        s_im = a[..., 1] * prev_f[..., 0] - a[..., 0] * prev_f[..., 1]
        phi = fast_atan2(s_im, s_re)
        scaled = (phi / _PI_F32) * jnp.float32(q14.Q14_ONE)
        pcm = jnp.trunc(scaled).astype(jnp.int16)
        return FmDemodState(last=jnp.round(a[..., -1, :]).astype(jnp.int32)), pcm
    a = block.astype(jnp.int32)
    prev = jnp.concatenate([state.last[..., None, :], a[..., :-1, :]], axis=-2)
    # s = a * conj(prev):
    s_re = a[..., 0] * prev[..., 0] + a[..., 1] * prev[..., 1]
    s_im = a[..., 1] * prev[..., 0] - a[..., 0] * prev[..., 1]
    phi = fast_atan2(s_im.astype(jnp.float32), s_re.astype(jnp.float32))
    scaled = (phi / _PI_F32) * jnp.float32(q14.Q14_ONE)
    pcm = jnp.trunc(scaled).astype(jnp.int16)
    return FmDemodState(last=a[..., -1, :]), pcm


def fm_from_baseband(ar, ai, prev_r, prev_i, omega_d, nr_channels=None):
    """FM-discriminate channelized baseband WITHOUT an explicit derotator.

    The reference pipeline derotates each FIR output by ``e^{j*omega_d*k}``
    (``filter/direct_fir.c:152-172``) and then discriminates
    ``phi = atan2(Im, Re of y[k]*conj(y[k-1]))`` (``multifm/fm_demod.c:36-83``).
    Because the discriminator only sees phase *differences*, the rotation
    contributes exactly ``omega_d`` per output:

        arg(y[k] conj(y[k-1])) = arg(a[k] conj(a[k-1])) + omega_d   (mod 2pi)

    so we fold it into a post-atan2 constant add + wrap — no cos/sin
    oscillator, no complex rotate. This is the production path used by
    the fused channelizer; worst-case divergence from the rotate-then-atan2
    form is a few float32 ulp of angle.

    ar/ai: float32 un-derotated baseband whose *flat order* is (k, c) — either
    ``[K, C]`` or the packed ``[rows, opr*C]`` layout straight out of
    :func:`tsl_sdr_tpu.ops.packed_fir.packed_fir_step` (no relayout needed).
    prev_r/prev_i: [C] float32 — previous baseband output per channel
    omega_d: [C] float32 derotation increment (rad/output)
    nr_channels: required when ar is not [K, C]-shaped
    Returns (pcm int16, same shape as ar; new_prev_r; new_prev_i).
    """
    shape = ar.shape
    c = nr_channels or shape[-1]
    arf = ar.reshape(-1)
    aif = ai.reshape(-1)

    flat = arf.shape[0]
    pad = (-flat) % 128
    # reduce omega into (-pi, pi] so a single post-add wrap suffices. Callers
    # with omega many turns out should pre-reduce in float64 (the model does,
    # via np); this f32 pass is exact for already-reduced values.
    if isinstance(omega_d, np.ndarray):
        omega_d = omega_d.astype(np.float64)
        omega_d = omega_d - 2 * np.pi * np.round(omega_d / (2 * np.pi))
    omega_d = jnp.asarray(omega_d, dtype=jnp.float32)
    omega_d = omega_d - 2 * _PI_F32 * jnp.round(omega_d / (2 * _PI_F32))

    # lag-c correlation computed from SLICE views (fusible reads — the old
    # form materialized four shifted+padded operand copies, ~4x this
    # stage's whole HBM traffic); only the c head products need prev.
    main_re = arf[c:] * arf[:-c] + aif[c:] * aif[:-c]
    main_im = aif[c:] * arf[:-c] - arf[c:] * aif[:-c]
    head_re = arf[:c] * prev_r.astype(jnp.float32) + (
        aif[:c] * prev_i.astype(jnp.float32))
    head_im = aif[:c] * prev_r.astype(jnp.float32) - (
        arf[:c] * prev_i.astype(jnp.float32))

    if 128 % c == 0:
        # lane-packed fast path: reshape to [*, 128]; omega is a static
        # 128-lane pattern (c divides 128)
        w = jnp.tile(omega_d, 128 // c)[None, :]

        def pack(head, main):
            v = jnp.concatenate(
                [head, main, jnp.zeros((pad,), jnp.float32)]
            )
            return v.reshape(-1, 128)

        sre = pack(head_re, main_re)
        sim = pack(head_im, main_im)
    else:
        pad = 0
        w = omega_d[None, :]
        sre = jnp.concatenate([head_re, main_re]).reshape(-1, c)
        sim = jnp.concatenate([head_im, main_im]).reshape(-1, c)
    phi = jnp.arctan2(sim, sre) + w
    phi = jnp.where(phi > _PI_F32, phi - 2 * _PI_F32, phi)
    phi = jnp.where(phi <= -_PI_F32, phi + 2 * _PI_F32, phi)
    # zero-power inputs (incl. the cold-start k=0 sample) emit 0, matching
    # the reference LUT's both-zero guard (multifm/fast_atan2f.c:109-111)
    phi = jnp.where((sre == 0) & (sim == 0), jnp.float32(0), phi)
    pcm = jnp.trunc(phi / _PI_F32 * jnp.float32(q14.Q14_ONE)).astype(jnp.int16)
    pcm = pcm.reshape(-1)[:flat].reshape(shape) if pad else pcm.reshape(shape)
    return pcm, arf[-c:], aif[-c:]


def fm_demod_np(block, last=None):
    """Bit-exact host oracle with C float/double promotion semantics."""
    a = np.asarray(block).astype(np.int32)
    if last is None:
        last = np.zeros(a.shape[:-2] + (2,), dtype=np.int32)
    prev = np.concatenate([last[..., None, :], a[..., :-1, :]], axis=-2)
    s_re = a[..., 0] * prev[..., 0] + a[..., 1] * prev[..., 1]
    s_im = a[..., 1] * prev[..., 0] - a[..., 0] * prev[..., 1]
    phi = fast_atan2_np(s_im.astype(np.float32), s_re.astype(np.float32))
    # C: (phi / M_PI) * to_q15 — evaluated in double, stored to float.
    scaled = ((phi.astype(np.float64) / np.pi) * float(q14.Q14_ONE)).astype(
        np.float32
    )
    return np.trunc(scaled).astype(np.int16), a[..., -1, :]
