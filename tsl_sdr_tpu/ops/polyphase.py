"""Polyphase rational resampler: f_out = (I / D) * f_in on real int16 PCM.

Reference behavior (``filter/polyphase_fir.c``): taps are regrouped into I
phase filters (``coeff[i] -> phase[i % I][i / I]``, each phase zero-padded to
a multiple of 4 coefficients, ``polyphase_fir.c:70-83``); per output the
phase advances by D (mod I) and ``(phase + D) / I`` input samples are
consumed (``:205-224``); each output is ``round_q28_q14(dot(x[off:off+P],
phase_taps))`` (``filter/utils.c:89-112``).

Accelerator redesign — the key identity: the phase sequence is **affine in the output
index**. With initial phase p0::

    phase[k]  = (p0 + k*D) mod I
    offset[k] = (p0 + k*D) div I        (input offset of output k)

so by choosing the block's output count K with I | K*D, every block consumes
exactly N_in = K*D/I input samples and ends at phase p0 again. phases/offsets
become *build-time constants*: the kernel is one static gather + one batched
dot. No scan, no data-dependent control flow — the serial C state machine
compiles to a single dense contraction.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from tsl_sdr_tpu.ops import q14


class ResamplerPlan(NamedTuple):
    taps_sel_i16: np.ndarray  # [K, P] int16 — phase taps gathered per output
    taps_sel_f32: np.ndarray  # [K, P] float32
    offsets: np.ndarray       # [K] int32 — window start per output
    interpolation: int
    decimation: int
    block_in: int             # N_in input samples consumed per step
    block_out: int            # K outputs produced per step
    carry_len: int
    phase0: int
    # fast-tier frame formulation (see resample_step): outputs grouped
    # I_rep per D_rep input frame; windows = S row-shifted frame copies
    w_frames: np.ndarray      # [S*D_rep, I_rep] float32
    w_frames_i16: np.ndarray  # same, int16 Q.14 (transposed-residue tier)
    frame_shifts: int         # S
    i_rep: int
    d_rep: int
    # packed-row tier (the channelizer's [rows, ROW] @ [ROW, COLS] form,
    # see ops/packed_fir.py): K_ROW = lcm(I_rep, 128) outputs per row ride
    # the LANES of the result; the input reshapes to [M, ROW_IN] rows with
    # one trimmed spill-chunk matmul. k_row == 0 when the form would need
    # an oversized tap matrix (lcm(I_rep, 128) > 1024) — the
    # transposed-residue tier covers those.
    k_row: int = 0
    row_in: int = 0
    spill: int = 0
    w_row_i16: np.ndarray | None = None    # [ROW_IN, K_ROW] int16
    w_spill_i16: np.ndarray | None = None  # [spill_pad, K_ROW] or None


class ResamplerState(NamedTuple):
    carry: jnp.ndarray  # [carry_len] int16


def build_phase_filters(fir_coeff, interpolate: int) -> np.ndarray:
    """[I, P] int16 phase decomposition with the reference's zero padding."""
    coeff = np.asarray(fir_coeff, dtype=np.int16)
    nr = coeff.shape[0]
    pc = (nr + interpolate - 1) // interpolate
    pc = (pc + 3) & ~3  # round up to a multiple of 4 (polyphase_fir.c:73)
    phases = np.zeros((interpolate, pc), dtype=np.int16)
    i = np.arange(nr)
    phases[i % interpolate, i // interpolate] = coeff
    return phases


def make_resampler_plan(
    fir_coeff_q14,
    interpolate: int,
    decimate: int,
    block_out_target: int = 1024,
    phase0: int = 0,
    align_k_row: bool = True,
    k_row_max: int = 1024,
) -> ResamplerPlan:
    """Build the static plan. ``fir_coeff_q14``: int16 Q.14 taps (use
    :func:`tsl_sdr_tpu.ops.q14.quantize_q14` on float coefficients)."""
    phases = build_phase_filters(fir_coeff_q14, interpolate)
    from tsl_sdr_tpu.utils.diag import dump_phase_filters

    dump_phase_filters(phases)
    p = phases.shape[1]

    g = math.gcd(interpolate, decimate)
    base = interpolate // g
    k_row = math.lcm(base, 128)
    if k_row > k_row_max:
        k_row = 0  # tap matrix would be huge; transposed tier handles it
    if align_k_row and k_row:
        # round the block up to a packed-row multiple (the fast kernel's
        # K_ROW outputs/row); callers that need an EXACT n_in (the fused
        # pipeline) pass align_k_row=False and get the base quantum
        k_out = k_row * max(1, -(-block_out_target // k_row))
    else:
        k_out = base * max(1, -(-block_out_target // base))
        if k_row and k_out % k_row:
            k_row = 0  # this block size can't ride the packed-row kernel
    n_in = k_out * decimate // interpolate

    k = np.arange(k_out, dtype=np.int64)
    phase_seq = (phase0 + k * decimate) % interpolate
    offsets = (phase0 + k * decimate) // interpolate
    carry_len = int(max(0, offsets[-1] + p - n_in))

    taps_sel = phases[phase_seq]  # [K, P]

    # Fast-tier frame formulation: the resampler is I_rep parallel
    # decimate-by-D_rep FIRs sharing one input. Output j of frame m reads
    # x[m*D_rep + oj : + P] with oj = (phase0 + j*D) // I  constant per j —
    # window span <= max(oj) + P, covered by S consecutive frames. One tiny
    # dense tap matrix [S*D_rep, I_rep] replaces the per-output gather.
    i_rep = interpolate // g
    d_rep = decimate // g
    oj = (phase0 + np.arange(i_rep, dtype=np.int64) * decimate) // interpolate
    span = int(oj.max()) + p
    s_shifts = -(-span // d_rep)
    wf = np.zeros((s_shifts * d_rep, i_rep), dtype=np.float32)
    wq = np.zeros((s_shifts * d_rep, i_rep), dtype=np.int16)
    for j in range(i_rep):
        ph = phases[(phase0 + j * decimate) % interpolate]
        wf[oj[j] : oj[j] + p, j] = ph.astype(np.float32) / q14.Q14_ONE
        wq[oj[j] : oj[j] + p, j] = ph

    # Packed-row tier: K_ROW outputs per input row of ROW_IN samples.
    # Output kk = f*I_rep + j of a row reads the window starting at
    # f*D_rep + oj[j] within the row; span spills at most
    # win_r - ROW_IN = carry_len values into the next row.
    w_row = None
    w_spill = None
    row_in = 0
    spill = 0
    if k_row:
        frames = k_row // i_rep
        row_in = frames * d_rep
        win_r = (frames - 1) * d_rep + span
        spill = max(0, win_r - row_in)
        if spill > row_in:
            # the kernel's single spill-row assumption breaks (heavy
            # upsamplers: ROW_IN shrinks below the filter span); the
            # transposed-residue tier covers these
            k_row = 0
            row_in = 0
            spill = 0
    if k_row:
        spill_pad = min(row_in, -(-spill // 128) * 128) if spill else 0
        wp = np.zeros((row_in + spill_pad, k_row), dtype=np.int16)
        for f in range(frames):
            for j in range(i_rep):
                ph = phases[(phase0 + j * decimate) % interpolate]
                u0 = f * d_rep + int(oj[j])
                wp[u0 : u0 + p, f * i_rep + j] = ph
        w_row = wp[:row_in]
        w_spill = np.ascontiguousarray(wp[row_in:]) if spill else None

    return ResamplerPlan(
        taps_sel_i16=taps_sel,
        taps_sel_f32=taps_sel.astype(np.float32) / q14.Q14_ONE,
        offsets=offsets.astype(np.int32),
        interpolation=int(interpolate),
        decimation=int(decimate),
        block_in=int(n_in),
        block_out=int(k_out),
        carry_len=carry_len,
        phase0=int(phase0),
        w_frames=wf,
        w_frames_i16=wq,
        frame_shifts=int(s_shifts),
        i_rep=int(i_rep),
        d_rep=int(d_rep),
        k_row=int(k_row),
        row_in=int(row_in),
        spill=int(spill),
        w_row_i16=w_row,
        w_spill_i16=w_spill,
    )


def init_resampler_state(plan: ResamplerPlan, prefix=None) -> ResamplerState:
    """Prime the carry with the first ``carry_len`` stream samples (or zeros).

    Priming with the stream head aligns output 0 with the reference's first
    output (window at input offset 0)."""
    if prefix is None:
        carry = jnp.zeros((plan.carry_len,), dtype=jnp.int16)
    else:
        prefix = jnp.asarray(prefix, dtype=jnp.int16)
        assert prefix.shape == (plan.carry_len,)
        carry = prefix
    return ResamplerState(carry=carry)


@functools.partial(jax.jit, static_argnames=("exact",))
def _resample_kernel(carry, block, taps_sel, idx, *, exact: bool):
    total = jnp.concatenate([carry, block], axis=0)
    win = total[idx]  # [K, P] int16
    if exact:
        acc = jnp.einsum(
            "kp,kp->k",
            win.astype(jnp.int32),
            taps_sel.astype(jnp.int32),
            preferred_element_type=jnp.int32,
        )
        out = q14.round_q28_q14(acc)
    else:
        out = jnp.einsum(
            "kp,kp->k",
            win.astype(jnp.float32),
            taps_sel,
            preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        )
    new_carry = total[block.shape[0]:]
    return new_carry, out


@functools.partial(
    jax.jit, static_argnames=("s_shifts", "d_rep", "i_rep", "k_out")
)
def _resample_fast_kernel(carry, block, wf, *, s_shifts, d_rep, i_rep, k_out):
    """Gather-free fast tier: S row-shifted frame copies + one matmul.

    Frames F[m] = total[m*D_rep : (m+1)*D_rep]; output group m is
    ``concat(F[m..m+S-1]) @ W``. Builds dense [M, S*D_rep] windows with
    row shifts only — no gathers.
    """
    total = jnp.concatenate([carry, block], axis=0)
    new_carry = total[block.shape[0] :]
    m_out = k_out // i_rep
    need = (m_out + s_shifts - 1) * d_rep
    pad = need - total.shape[0]
    if pad > 0:
        total = jnp.concatenate([total, jnp.zeros((pad,), total.dtype)])
    f = total[:need].reshape(m_out + s_shifts - 1, d_rep).astype(jnp.float32)
    x = jnp.concatenate(
        [f[s0 : s0 + m_out] for s0 in range(s_shifts)], axis=1
    )  # [M, S*D_rep]
    out = jnp.dot(
        x, wf, preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )  # [M, I_rep]
    return new_carry, out.reshape(-1)


@functools.partial(
    jax.jit, static_argnames=("s_shifts", "d_rep", "i_rep", "k_out", "exact")
)
def _resample_fast_kernel_t(carry, block, wt, *, s_shifts, d_rep, i_rep,
                            k_out, exact=False):
    """Transposed-residue matmul tier — full 128-lane utilization.

    With ``u = oj + q`` split as ``u = 25*s + r`` (for d_rep = 25):

        out[16m + j] = sum_{s, r} W[s, j, r] * xT[r, m + s]

    where ``xT[r, m] = x[d_rep*m + r]`` is the residue-transposed input. The
    huge M axis rides the LANES of both matmul operands and the output —
    the ``[M, D_rep]`` frame layout of the plain kernel wastes 1 - D/128 of
    every register. S matmuls ``[I_rep, D_rep] @ [D_rep, M]`` in exact
    int16*int16->int32 (quantized taps = the reference's filter).

    ``exact=False`` scales the accumulators to float sample units;
    ``exact=True`` applies the reference's Q.28->Q.14 rounding
    (``filter/utils.c:89-112``) for int16 output BIT-IDENTICAL to the
    per-output gather oracle — int32 wrap addition is order-free, so the
    re-blocked summation produces the same accumulator values.
    """
    total = jnp.concatenate([carry, block], axis=0)
    new_carry = total[block.shape[0] :]
    m_out = k_out // i_rep
    need = (m_out + s_shifts - 1) * d_rep
    pad = need - total.shape[0]
    if pad > 0:
        total = jnp.concatenate([total, jnp.zeros((pad,), total.dtype)])
    xt = total[:need].reshape(m_out + s_shifts - 1, d_rep).T  # [D_rep, M+S-1]
    acc = jnp.dot(
        wt[0], xt[:, :m_out], preferred_element_type=jnp.int32
    )
    for s in range(1, s_shifts):
        acc = acc + jnp.dot(
            wt[s], xt[:, s : s + m_out], preferred_element_type=jnp.int32
        )
    if exact:
        out = q14.round_q28_q14(acc)
    else:
        out = acc.astype(jnp.float32) * jnp.float32(1.0 / q14.Q14_ONE)
    # [I_rep, M] -> flat (k = i_rep*m + j) requires the transpose back
    return new_carry, out.T.reshape(-1)


def row_matmul_acc(rows, m, w0, w1):
    """[m+1, ROW_IN] int16 rows -> [m, K_ROW] int32 wrap accumulators:
    main chunk + trimmed spill chunk (the delicate slice bounds live in
    exactly one place — the streaming kernel and the sharded local kernel
    both call this)."""
    acc = jnp.dot(rows[:m], w0, preferred_element_type=jnp.int32)
    if w1 is not None:
        sp = w1.shape[0]
        acc = acc + jnp.dot(
            rows[1 : m + 1, :sp], w1, preferred_element_type=jnp.int32
        )
    return acc


@functools.partial(
    jax.jit, static_argnames=("row_in", "k_row", "exact")
)
def _resample_row_kernel(carry, block, w0, w1, *, row_in, k_row, exact):
    """Packed-row matmul tier — the channelizer's re-blocking applied to
    the polyphase resampler (VERDICT r2 item 5; reference hot loop
    ``filter/polyphase_fir.c:162-233``).

    Input rows ``[M, ROW_IN]`` hit one dense ``[ROW_IN, K_ROW]`` tap
    matrix (K_ROW >= 128 outputs on the LANES of the result — the
    transposed-residue tier's [I_rep, D_rep] operands fill <8% of a 128x128 matmul
    tile; this form fills it completely) plus one trimmed spill-chunk
    matmul, exactly like ops/packed_fir. int16*int16->int32 wrap
    accumulation is order-free, so ``exact=True`` output is BIT-IDENTICAL
    to the gather oracle after the reference's Q.28->Q.14 rounding.
    """
    total = jnp.concatenate([carry, block], axis=0)
    new_carry = total[block.shape[0] :]
    m = block.shape[0] // row_in
    pad = (m + 1) * row_in - total.shape[0]
    tot = jnp.concatenate([total, jnp.zeros((pad,), total.dtype)])
    rows = tot.reshape(m + 1, row_in)
    acc = row_matmul_acc(rows, m, w0, w1)
    if exact:
        out = q14.round_q28_q14(acc)
    else:
        out = acc.astype(jnp.float32) * jnp.float32(1.0 / q14.Q14_ONE)
    return new_carry, out.reshape(-1)


def resample_step(plan: ResamplerPlan, state: ResamplerState, block, *,
                  exact=True, exact_impl: str = "packed"):
    """block: [N_in] int16 -> (state, out[K]) (int16 exact / float32 fast).

    The exact tier defaults to the lane-packed matmul form (bit-identical
    to the per-output window gather — wrap-int32 sums are order-free; the
    gather oracle stays available as ``exact_impl="gather"``). Both the
    fast tier and the default exact tier ride the packed-row kernel when
    the plan supports it (``plan.k_row``), else the transposed-residue
    kernel."""
    block = jnp.asarray(block, dtype=jnp.int16)
    assert block.shape == (plan.block_in,), (block.shape, plan.block_in)
    if (not exact or exact_impl == "packed") and plan.k_row:
        assert plan.carry_len == plan.spill, (plan.carry_len, plan.spill)
        w1 = (
            jnp.asarray(plan.w_spill_i16)
            if plan.w_spill_i16 is not None
            else None
        )
        new_carry, out = _resample_row_kernel(
            state.carry, block, jnp.asarray(plan.w_row_i16), w1,
            row_in=plan.row_in, k_row=plan.k_row, exact=exact,
        )
        return ResamplerState(carry=new_carry), out
    if not exact or exact_impl == "packed":
        # wt[s] = W_s [I_rep, D_rep]: wt[s, j, r] = w_frames_i16[25*s + r, j]
        wt = jnp.asarray(
            np.ascontiguousarray(
                plan.w_frames_i16.reshape(
                    plan.frame_shifts, plan.d_rep, plan.i_rep
                ).transpose(0, 2, 1)
            )
        )
        new_carry, out = _resample_fast_kernel_t(
            state.carry,
            block,
            wt,
            s_shifts=plan.frame_shifts,
            d_rep=plan.d_rep,
            i_rep=plan.i_rep,
            k_out=plan.block_out,
            exact=exact,
        )
        return ResamplerState(carry=new_carry), out
    idx = plan.offsets[:, None] + np.arange(plan.taps_sel_i16.shape[1])[None, :]
    taps = jnp.asarray(plan.taps_sel_i16)
    new_carry, out = _resample_kernel(
        state.carry, block, taps, jnp.asarray(idx), exact=True
    )
    return ResamplerState(carry=new_carry), out
