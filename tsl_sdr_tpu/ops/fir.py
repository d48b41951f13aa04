"""Direct-form complex FIR channelizer with decimation and phase derotation.

Reference behavior being matched (not ported): ``filter/direct_fir.c`` — a
streaming complex FIR over int16 IQ that emits one output per ``D`` input
samples, where output ``k`` is::

    acc[k]  = sum_t  c[t] * x[k*D + t]          (complex, int32 accum)
    out[k]  = round_q28_q14( rot[k] * round_q28_q14(acc[k]) )
    rot[k+1]= round_q28_q14( rot[k] * rot_incr )   # un-renormalized drift!

(reference ``filter/direct_fir.c:329-417`` scalar MAC, ``:152-172``
derotation; the tap/rotator setup is ``multifm/demod.c:205-269`` +
``direct_fir.c:44-87``.)

Accelerator redesign: the unbounded stream becomes fixed-size blocks with an
**overlap-save carry** of the trailing ``C_len`` input samples, so each step
is a pure function ``(state, block[N,2]) -> (state, out[K,2])`` with static
shapes (``N % D == 0``, ``K = N // D``). Multi-channel operation stacks taps
``[C, T]`` and rides one batched contraction (matmul in the fast tier).

Two tiers:

* ``exact``: int16/int32 arithmetic replicating the C pipeline bit-for-bit,
  including the Q.14 rounding and the rotator's slow amplitude decay. The
  rotator recurrence is a ``lax.scan`` producing the per-output rotator
  sequence; the MAC is a gathered int32 contraction.
* ``fast``: float32, analytic (drift-free) oscillator indexed by absolute
  output index, windows fed to the matmul via a strided convolution.

NOTE: the production fast path moved to :mod:`tsl_sdr_tpu.ops.packed_fir`
(lane-packed int16 matmuls — see that module for why this conv formulation
is an order of magnitude off the device's speed-of-light). This module remains the
bit-exact tier and a readable reference formulation.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from tsl_sdr_tpu.ops import q14


class ChannelFirPlan(NamedTuple):
    """Static (host-side) plan for a multi-channel decimating FIR."""

    taps_i16: np.ndarray       # [C, T, 2] int16 Q.14 complex bandpass taps
    taps_f32: np.ndarray       # [C, T, 2] float32 (unquantized, fast tier)
    rot_incr_i32: np.ndarray   # [C, 2] int32 Q.14 per-output derotator step
    omega_d: np.ndarray        # [C] float64: -2*pi*offset/fs * D  (fast tier)
    decimation: int
    carry_len: int             # overlap-save carry length (multiple-of-D)

    @property
    def nr_channels(self) -> int:
        return self.taps_i16.shape[0]

    @property
    def nr_taps(self) -> int:
        return self.taps_i16.shape[1]


class ChannelFirState(NamedTuple):
    """Streaming state threaded through block steps (a pytree)."""

    carry: jnp.ndarray     # [carry_len, 2] int16 — trailing input samples
    rot: jnp.ndarray       # [C, 2] int16 — exact-tier rotator phase
    out_index: jnp.ndarray # [] int32 — absolute output index (fast tier osc.)


def design_channel_taps(
    lpf_taps, offset_hz: float, sample_rate: float, gain: float = 1.0
):
    """Shift a real baseband LPF to a complex bandpass filter for one channel.

    tap[i] = gain * exp(-j*2*pi*offset/fs * i) * lpf[i], quantized to Q.14
    with C cast (truncate) semantics — reference ``multifm/demod.c:205-243``.
    Returns (taps_c128[T], rot_incr_i32[2], omega_d_factory) as float/host
    data; packing into a plan happens in :func:`make_channel_fir_plan`.
    """
    lpf_taps = np.asarray(lpf_taps, dtype=np.float64)
    f_offs = -2.0 * np.pi * float(offset_hz) / float(sample_rate)
    i = np.arange(lpf_taps.shape[0], dtype=np.float64)
    taps = gain * np.exp(1j * f_offs * i) * lpf_taps
    return taps, f_offs


def make_channel_fir_plan(
    lpf_taps,
    offsets_hz,
    sample_rate: float,
    decimation: int,
    gains=None,
) -> ChannelFirPlan:
    """Build the static plan for a bank of channels sharing one wideband input.

    ``offsets_hz`` are per-channel offsets from the capture center frequency
    (reference computes them as chanCenterFreq - centerFreqHz,
    ``multifm/receiver.c:227``).
    """
    offsets_hz = np.atleast_1d(np.asarray(offsets_hz, dtype=np.float64))
    nr_ch = offsets_hz.shape[0]
    if gains is None:
        gains = np.ones(nr_ch)
    gains = np.broadcast_to(np.asarray(gains, dtype=np.float64), (nr_ch,))

    taps_i16 = []
    taps_f32 = []
    rot_incr = []
    omega_d = []
    for c in range(nr_ch):
        taps, f_offs = design_channel_taps(
            lpf_taps, offsets_hz[c], sample_rate, gains[c]
        )
        ti = np.stack(
            [q14.quantize_q14(taps.real), q14.quantize_q14(taps.imag)], axis=-1
        )
        taps_i16.append(ti)
        taps_f32.append(
            np.stack([taps.real, taps.imag], axis=-1).astype(np.float32)
        )
        # Per-output derotator increment: exp(-j * f_wt0 * D) where
        # f_wt0 = 2*pi*offset/fs  (reference direct_fir.c:72-77). Note
        # f_offs = -f_wt0, so the increment is exp(+j*f_offs*D).
        incr = np.exp(1j * f_offs * decimation)
        rot_incr.append(
            np.array(
                [q14.quantize_q14_i32(incr.real), q14.quantize_q14_i32(incr.imag)],
                dtype=np.int32,
            )
        )
        omega_d.append(f_offs * decimation)

    nr_taps = len(np.asarray(lpf_taps))
    # Carry must cover the part of the last window that pokes past the block:
    # ceil(max(T - D, 0) / D) * D keeps block starts D-aligned.
    carry = int(-(-max(nr_taps - decimation, 0) // decimation) * decimation)
    return ChannelFirPlan(
        taps_i16=np.stack(taps_i16),
        taps_f32=np.stack(taps_f32),
        rot_incr_i32=np.stack(rot_incr),
        omega_d=np.asarray(omega_d),
        decimation=int(decimation),
        carry_len=carry,
    )


def init_channel_fir_state(plan: ChannelFirPlan, prefix=None) -> ChannelFirState:
    """Create initial streaming state.

    ``prefix``: the first ``plan.carry_len`` input samples ([carry_len, 2]
    int16). Priming with the true stream head makes block 0's first output
    window equal the reference's very first window (input samples [0, T)),
    keeping output streams aligned sample-for-sample. Pass ``None`` for a
    zero-primed (cold) start.
    """
    if prefix is None:
        carry = jnp.zeros((plan.carry_len, 2), dtype=jnp.int16)
    else:
        prefix = jnp.asarray(prefix, dtype=jnp.int16)
        assert prefix.shape == (plan.carry_len, 2)
        carry = prefix
    rot = jnp.zeros((plan.nr_channels, 2), dtype=jnp.int16)
    rot = rot.at[:, 0].set(q14.Q14_ONE)
    return ChannelFirState(
        carry=carry, rot=rot, out_index=jnp.zeros((), dtype=jnp.int32)
    )


# ---------------------------------------------------------------------------
# Exact tier
# ---------------------------------------------------------------------------

def _rotator_scan(rot0, incr, nr_steps: int):
    """Exact rotator sequence: rot[k] for k in [0, nr_steps), plus rot[K].

    rot0: [C, 2] int16, incr: [C, 2] int32. Returns ([K, C, 2] int16 sequence,
    [C, 2] int16 final). Matches cmul_q15_q15 iteration
    (reference ``direct_fir.c:166-167``).
    """
    incr_re = incr[:, 0]
    incr_im = incr[:, 1]

    def step(rot, _):
        nre, nim = q14.cmul_q14_q14(rot[:, 0], rot[:, 1], incr_re, incr_im)
        nxt = jnp.stack([nre, nim], axis=-1)
        return nxt, rot

    final, seq = jax.lax.scan(step, rot0, None, length=nr_steps)
    return seq, final


@functools.partial(jax.jit, static_argnames=("decimation", "nr_taps"))
def _channel_fir_exact_kernel(
    carry, block, taps_i16, rot0, rot_incr, *, decimation: int, nr_taps: int
):
    total = jnp.concatenate([carry, block], axis=0)  # [C_len + N, 2] int16
    n = block.shape[0]
    k_out = n // decimation

    # Window gather: [K, T] indices into the concatenated input.
    starts = np.arange(k_out, dtype=np.int32)[:, None] * decimation
    idx = starts + np.arange(nr_taps, dtype=np.int32)[None, :]
    win = total[idx].astype(jnp.int32)  # [K, T, 2]

    c = taps_i16.astype(jnp.int32)  # [C, T, 2]
    # acc = sum_t cmul(c[t], x[t]) — int32 accumulation, wraparound semantics
    # (reference direct_fir.c:366-385).
    acc_re = jnp.einsum(
        "kt,ct->ck", win[..., 0], c[..., 0], preferred_element_type=jnp.int32
    ) - jnp.einsum(
        "kt,ct->ck", win[..., 1], c[..., 1], preferred_element_type=jnp.int32
    )
    acc_im = jnp.einsum(
        "kt,ct->ck", win[..., 1], c[..., 0], preferred_element_type=jnp.int32
    ) + jnp.einsum(
        "kt,ct->ck", win[..., 0], c[..., 1], preferred_element_type=jnp.int32
    )

    # Derotation: acc -> Q.14, multiply by rotator sequence, Q.28 -> Q.14.
    rot_seq, rot_final = _rotator_scan(rot0, rot_incr, k_out)  # [K, C, 2]
    rot_re = rot_seq[..., 0].astype(jnp.int32).T  # [C, K]
    rot_im = rot_seq[..., 1].astype(jnp.int32).T
    a_re = q14.round_q28_q14(acc_re).astype(jnp.int32)
    a_im = q14.round_q28_q14(acc_im).astype(jnp.int32)
    d_re, d_im = q14.cmul_q14_q28(a_re, a_im, rot_re, rot_im)
    out = jnp.stack([q14.round_q28_q14(d_re), q14.round_q28_q14(d_im)], axis=-1)

    # Skip derotation entirely for channels with zero increment
    # (direct_fir.c:406 checks incr == (0, 0)).
    no_rot = jnp.all(rot_incr == 0, axis=-1)[:, None, None]
    out_plain = jnp.stack(
        [q14.round_q28_q14(acc_re), q14.round_q28_q14(acc_im)], axis=-1
    )
    out = jnp.where(no_rot, out_plain, out)

    new_carry = total[total.shape[0] - carry.shape[0]:]
    return new_carry, rot_final, out  # out: [C, K, 2] int16


# ---------------------------------------------------------------------------
# Fast tier (float32, matmul via strided conv, analytic oscillator)
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("decimation", "nr_taps"))
def _channel_fir_fast_kernel(
    carry, block, taps_f32, omega_d, out_index, *, decimation: int, nr_taps: int
):
    total = jnp.concatenate([carry, block], axis=0).astype(jnp.float32)
    n = block.shape[0]
    k_out = n // decimation
    nr_ch = taps_f32.shape[0]

    # lhs: [batch=1, features=2(IQ), width]; rhs: [out=2C, in=2, T].
    lhs = total.T[None]  # [1, 2, L]
    cr = taps_f32[..., 0]
    ci = taps_f32[..., 1]
    # out_re = cr*xr - ci*xi ; out_im = ci*xr + cr*xi
    rhs = jnp.stack(
        [jnp.stack([cr, -ci], axis=1), jnp.stack([ci, cr], axis=1)], axis=1
    ).reshape(2 * nr_ch, 2, nr_taps)
    conv = jax.lax.conv_general_dilated(
        lhs,
        rhs,
        window_strides=(decimation,),
        padding="VALID",
        dimension_numbers=("NCH", "OIH", "NCH"),
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )  # [1, 2C, K_full]
    acc = conv[0, :, :k_out].reshape(nr_ch, 2, k_out)

    # Analytic drift-free oscillator: rot[k] = exp(j * omega_d * (i0 + k)).
    k = (out_index + jnp.arange(k_out, dtype=jnp.int32)).astype(jnp.float32)
    theta = omega_d.astype(jnp.float32)[:, None] * k[None, :]
    rot_re = jnp.cos(theta)
    rot_im = jnp.sin(theta)
    out_re = acc[:, 0] * rot_re - acc[:, 1] * rot_im
    out_im = acc[:, 0] * rot_im + acc[:, 1] * rot_re
    out = jnp.stack([out_re, out_im], axis=-1)  # [C, K, 2] float32

    new_carry = jnp.concatenate([carry, block], axis=0)[n:]
    return new_carry, out


# ---------------------------------------------------------------------------
# Public stepping API
# ---------------------------------------------------------------------------

def channel_fir_step(
    plan: ChannelFirPlan,
    state: ChannelFirState,
    block,
    *,
    exact: bool = True,
):
    """Process one input block.

    block: [N, 2] int16 wideband IQ, N a multiple of plan.decimation.
    Returns (new_state, out) with out [C, N//D, 2]; int16 Q.14 in the exact
    tier, float32 (unity-gain scale) in the fast tier.
    """
    block = jnp.asarray(block)
    n = block.shape[0]
    if n % plan.decimation != 0:
        raise ValueError(
            f"block length {n} must be a multiple of decimation {plan.decimation}"
        )
    k_out = n // plan.decimation
    if exact:
        new_carry, rot_final, out = _channel_fir_exact_kernel(
            state.carry,
            block.astype(jnp.int16),
            jnp.asarray(plan.taps_i16),
            state.rot,
            jnp.asarray(plan.rot_incr_i32),
            decimation=plan.decimation,
            nr_taps=plan.nr_taps,
        )
        new_state = ChannelFirState(
            carry=new_carry, rot=rot_final, out_index=state.out_index + k_out
        )
        return new_state, out
    else:
        new_carry, out = _channel_fir_fast_kernel(
            state.carry,
            block.astype(jnp.int16),
            jnp.asarray(plan.taps_f32),
            jnp.asarray(plan.omega_d),
            state.out_index,
            decimation=plan.decimation,
            nr_taps=plan.nr_taps,
        )
        new_state = ChannelFirState(
            carry=new_carry, rot=state.rot, out_index=state.out_index + k_out
        )
        return new_state, out
