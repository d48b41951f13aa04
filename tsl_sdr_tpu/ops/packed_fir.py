"""Lane-packed multi-channel decimating FIR — the production tier.

This is the performance-critical reformulation of the reference channelizer
hot loop (``filter/direct_fir.c:329-417`` — per-output complex MAC over
``nr_taps`` taps at stride ``decimation``). The bit-exact integer tier lives
in :mod:`tsl_sdr_tpu.ops.fir`; this module is the float32 production tier,
designed around two hardware facts of the accelerator it was first built for:

1. **Its vector and matrix units are 128 lanes wide.** Arrays shaped ``[N, 2]`` (IQ pairs) or
   ``[K, C]`` with small C waste up to 98% of every vector register. All
   arrays here keep a trailing dimension that is a multiple of 128.
2. **Its matrix unit wants one large matmul, not strided windows.** The decimating
   FIR is re-blocked so it becomes a dense ``[rows, ROW] @ [ROW, COLS]``
   product:

   The interleaved int16 stream (``re,im,re,im,…``) is reshaped into rows of
   ``ROW = lcm(2*D, 128)`` values; each row yields ``OPR = ROW/(2*D)``
   decimated outputs for every channel. Output ``j`` of row ``r`` needs the
   ``2*T`` values starting at offset ``2*D*j`` in the row — a window that may
   spill up to ``WIN - ROW`` values into following rows. The tap matrix is
   therefore built as ``Wf[WIN, 2*OPR*C]`` (column layout ``[re/im, j, c]``)
   and split into ROW-row chunks ``W_0 … W_CR``; the product is assembled as

       P[r] = sum_i (rows @ W_i)[r + i]

   i.e. one dense matmul per chunk plus a cheap row shift — no overlapping
   gather, no strided conv, no halo concat. ``P[:, :OPR*C]`` reshapes
   directly to the real part ``[K, C]`` and the back half to the imaginary
   part.

Float matmuls, where used, set ``Precision.HIGHEST``: XLA's default f32
matmul may run in bf16 or TF32, far too coarse for Q.14-scale DSP data.

Streaming works on value-aligned carries: each step consumes a block of
``N`` samples (``2*N`` divisible by ``ROW``) plus ``CR`` carried rows of
history, and emits exactly ``N/D`` outputs per channel.

The derotator of the reference (``direct_fir.c:152-172``) is NOT applied
here: for FM demodulation the per-output rotation ``e^{j*omega_d*k}``
contributes a constant ``omega_d`` to the discriminated phase difference, so
:func:`tsl_sdr_tpu.ops.fm.fm_from_baseband` folds it into a post-atan2 add
(saving the cos/sin oscillator and complex rotate entirely). Consumers that
need rotated IQ (e.g. a Costas loop) use :func:`nco_rotate`, an integer-NCO
oscillator whose int32 wraparound keeps full phase precision at any absolute
output index.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from tsl_sdr_tpu.ops.fir import design_channel_taps

_HIGHEST = jax.lax.Precision.HIGHEST


class PackedFirPlan(NamedTuple):
    """Static host-side plan for the lane-packed channel bank."""

    w_chunks: tuple       # tuple of np.ndarray [ROW, COLS] f32 tap chunks
    w_chunks_i16: tuple   # same layout, int16 Q.14 (bit-exact tier)
    rot_incr_i32: np.ndarray  # [C, 2] int32 Q.14 derotator increment
    omega_d: np.ndarray  # [C] float64: per-output derotation increment (rad)
    row: int             # values per packed row (= lcm(2D, 128))
    opr: int             # outputs per row (= row / (2D))
    win: int             # window span in values (= row - 2D + 2T)
    cr_rows: int         # carried history rows
    decimation: int
    nr_taps: int
    nr_channels: int
    # per-chunk nonzero-row count, rounded up to a 128 lane tile (chunk i>0
    # is zero past row ``win - i*row``; contracting over those rows is pure
    # matmul waste — trimming cuts ~30% of the matmul FLOPs at the flagship
    # 8ch/128-tap shape). Empty tuple = untrimmed (legacy plans).
    chunk_nnz: tuple = ()

    @property
    def carry_vals(self) -> int:
        return self.cr_rows * self.row

    @property
    def carry_len(self) -> int:
        """Carry length in samples (for stream-prefix priming)."""
        return self.carry_vals // 2

    @property
    def block_quantum(self) -> int:
        """Block lengths must be a multiple of this many samples."""
        return self.row // 2


def make_packed_fir_plan(
    lpf_taps,
    offsets_hz,
    sample_rate: float,
    decimation: int,
    gains=None,
) -> PackedFirPlan:
    """Build the packed plan for a bank of channels on one wideband input.

    Mirrors the tap synthesis of the reference (``multifm/demod.c:205-243``):
    per channel the real LPF is shifted to a complex bandpass filter at
    ``-offset``; the per-output derotation increment is ``-2*pi*offset/fs*D``
    (``filter/direct_fir.c:65-76``).
    """
    lpf_taps = np.asarray(lpf_taps, dtype=np.float64)
    offsets_hz = np.atleast_1d(np.asarray(offsets_hz, dtype=np.float64))
    nr_ch = offsets_hz.shape[0]
    nr_taps = lpf_taps.shape[0]
    d = int(decimation)
    if gains is None:
        gains = np.ones(nr_ch)
    gains = np.broadcast_to(np.asarray(gains, dtype=np.float64), (nr_ch,))

    row = math.lcm(2 * d, 128)
    opr = row // (2 * d)
    win = row + max(2 * (nr_taps - d), 0)
    cr_rows = -(-(win - row) // row) if win > row else 0

    cols = 2 * opr * nr_ch
    wf = np.zeros((win, 2, opr, nr_ch), dtype=np.float32)
    wq = np.zeros((win, 2, opr, nr_ch), dtype=np.int16)
    tidx = 2 * np.arange(nr_taps)
    omega_d = np.empty(nr_ch, dtype=np.float64)
    rot_incr = np.empty((nr_ch, 2), dtype=np.int32)
    from tsl_sdr_tpu.ops import q14

    for c in range(nr_ch):
        taps, f_offs = design_channel_taps(
            lpf_taps, offsets_hz[c], sample_rate, gains[c]
        )
        omega_d[c] = f_offs * d
        incr = np.exp(1j * f_offs * d)
        rot_incr[c, 0] = q14.quantize_q14_i32(incr.real)
        rot_incr[c, 1] = q14.quantize_q14_i32(incr.imag)
        cr = taps.real.astype(np.float32)
        ci = taps.imag.astype(np.float32)
        # bit-exact tier uses the reference's truncating tap quantization
        # (multifm/demod.c:214-218)
        qr = q14.quantize_q14(taps.real)
        qi = q14.quantize_q14(taps.imag)
        from tsl_sdr_tpu.utils.diag import dump_shifted_lpf

        dump_shifted_lpf(int(offsets_hz[c]), taps, qr, qi)
        for j in range(opr):
            vre = 2 * d * j + tidx
            # out_re += cr*xr - ci*xi ; out_im += ci*xr + cr*xi
            wf[vre, 0, j, c] += cr
            wf[vre + 1, 0, j, c] -= ci
            wf[vre, 1, j, c] += ci
            wf[vre + 1, 1, j, c] += cr
            wq[vre, 0, j, c] += qr
            wq[vre + 1, 0, j, c] -= qi
            wq[vre, 1, j, c] += qi
            wq[vre + 1, 1, j, c] += qr
    wf = wf.reshape(win, cols)
    wq = wq.reshape(win, cols)

    padded = np.zeros(((cr_rows + 1) * row, cols), dtype=np.float32)
    padded[:win] = wf
    chunks = tuple(
        padded[i * row : (i + 1) * row] for i in range(cr_rows + 1)
    )
    padded_q = np.zeros(((cr_rows + 1) * row, cols), dtype=np.int16)
    padded_q[:win] = wq
    chunks_q = tuple(
        padded_q[i * row : (i + 1) * row] for i in range(cr_rows + 1)
    )
    chunk_nnz = tuple(
        row if i == 0 else min(row, -(-(win - i * row) // 128) * 128)
        for i in range(cr_rows + 1)
    )
    return PackedFirPlan(
        w_chunks=chunks,
        w_chunks_i16=chunks_q,
        rot_incr_i32=rot_incr,
        omega_d=omega_d,
        row=row,
        opr=opr,
        win=win,
        cr_rows=cr_rows,
        decimation=d,
        nr_taps=nr_taps,
        nr_channels=nr_ch,
        chunk_nnz=chunk_nnz,
    )


def _chunk_nnz(plan: PackedFirPlan, i: int) -> int:
    return plan.chunk_nnz[i] if plan.chunk_nnz else plan.row


class GroupedFirPlan(NamedTuple):
    """Phase-grouped windowed reformulation of a :class:`PackedFirPlan`.

    The chunked form contracts every output column over the full
    ``(cr+1) * ROW`` tap rows even though each phase ``j`` only reads the
    ``2T`` window starting at ``2*D*j`` — at 64 channels that is ~70%
    structural zeros fed to the matmul. Here the ``opr`` phases are split into
    ``n_groups`` groups of ``g`` consecutive phases with ``g*2C >= 128``
    (full output lanes); group ``G`` is one dense matmul

        xw[:, 2*D*g*G : 2*D*g*G + win_g] @ Wg[G]      (win_g = (g-1)*2D + 2T)

    over the windowed row view ``xw[r] = rows[r] ++ rows[r+1][:win-ROW]``.
    Tap density rises from ``2T / ((cr+1)*ROW)`` to ``2T / win_g`` — a
    ~3.5x matmul FLOP cut at 64ch/128taps (where ``g == 1``), fading to parity
    at 8ch (``g == opr`` degenerates to the trimmed chunked form, which
    needs no windowed copy — so narrow banks keep the chunked tier).
    """

    wg_f32: np.ndarray   # [n_groups, win_g, 2*g*C] float32
    wg_i16: np.ndarray   # same, int16 Q.14
    g: int               # phases per group
    n_groups: int        # = opr // g
    win_g: int           # window values per group
    spill: int           # = win - row (windowed-view overhang into next row)


def _group_size(opr: int, nr_channels: int) -> int:
    """Smallest power-of-two phase-group with >= 128 output columns (or
    the whole row). opr = 128 / gcd(2D, 128) is a power of two, so the
    result always divides it. Shared by the builder and the cost model —
    they must agree on the grouping."""
    g = 1
    while g < opr and g * 2 * nr_channels < 128:
        g *= 2
    return g


def make_grouped_from_plan(plan: PackedFirPlan) -> GroupedFirPlan:
    """Regroup a packed plan's taps into the phase-grouped windowed form."""
    row, opr, c = plan.row, plan.opr, plan.nr_channels
    d = plan.decimation
    t = plan.nr_taps
    g = _group_size(opr, c)
    n_groups = opr // g
    win_g = (g - 1) * 2 * d + 2 * t
    # rebuild the full [win, 2, opr, C] tap tensor from the padded chunks
    w_full = np.concatenate([np.asarray(w) for w in plan.w_chunks], axis=0)
    w_full = w_full[: plan.win].reshape(plan.win, 2, opr, c)
    wq_full = np.concatenate(
        [np.asarray(w) for w in plan.w_chunks_i16], axis=0
    )[: plan.win].reshape(plan.win, 2, opr, c)
    wg = np.zeros((n_groups, win_g, 2, g, c), dtype=np.float32)
    wgq = np.zeros((n_groups, win_g, 2, g, c), dtype=np.int16)
    for grp in range(n_groups):
        off = 2 * d * g * grp
        for jj in range(g):
            j = grp * g + jj
            # phase j's taps live at absolute rows [2*D*j, 2*D*j + 2T)
            a0 = 2 * d * j
            wg[grp, a0 - off : a0 - off + 2 * t, :, jj] = (
                w_full[a0 : a0 + 2 * t, :, j]
            )
            wgq[grp, a0 - off : a0 - off + 2 * t, :, jj] = (
                wq_full[a0 : a0 + 2 * t, :, j]
            )
    return GroupedFirPlan(
        wg_f32=wg.reshape(n_groups, win_g, 2 * g * c),
        wg_i16=wgq.reshape(n_groups, win_g, 2 * g * c),
        g=g,
        n_groups=n_groups,
        win_g=win_g,
        spill=plan.win - row,
    )


def grouped_fir_worthwhile(plan: PackedFirPlan, threshold=1.3) -> bool:
    """True when the grouped form cuts matmul work by at least ``threshold``."""
    chunk_macs = sum(
        _chunk_nnz(plan, i) for i in range(plan.cr_rows + 1)
    )
    g = _group_size(plan.opr, plan.nr_channels)
    n_groups = plan.opr // g
    win_g = (g - 1) * 2 * plan.decimation + 2 * plan.nr_taps
    grouped_macs = n_groups * win_g * (g / plan.opr)
    return chunk_macs / max(grouped_macs, 1) >= threshold


def _grouped_matmul(rows, wg, *, r_valid, row, spill, g, n_groups, win_g, d,
                    nr_ch):
    """[r_tot, ROW] int16 rows -> [r_valid, 2*opr*C] int32 accumulators.

    Column layout of the result: ``[re/im, j, c]`` flattened — identical to
    the chunked form's ``P`` so downstream reshapes are unchanged.
    """
    # windowed view xw[r] = rows[r] ++ rows[r+1] ++ ... (spill may span
    # several following rows when 2T >> ROW)
    parts = [rows[:r_valid]]
    rem, k = spill, 1
    while rem > 0:
        take = min(rem, row)
        parts.append(rows[k : k + r_valid, :take])
        rem -= take
        k += 1
    xw = parts[0] if len(parts) == 1 else jnp.concatenate(parts, axis=1)
    xg = jnp.stack(
        [
            xw[:, 2 * d * g * grp : 2 * d * g * grp + win_g]
            for grp in range(n_groups)
        ]
    )  # [n_groups, r_valid, win_g]
    q = jax.lax.dot_general(
        xg,
        wg,
        dimension_numbers=(((2,), (1,)), ((0,), (0,))),
        preferred_element_type=jnp.int32,
    )  # [n_groups, r_valid, 2*g*C]
    q = q.reshape(n_groups, r_valid, 2, g * nr_ch)
    # [G, r, 2, g*C] -> [r, 2, G, g*C] -> [r, 2*opr*C] (j = G*g + jj)
    q = jnp.transpose(q, (1, 2, 0, 3))
    return q.reshape(r_valid, 2 * n_groups * g * nr_ch)


def init_packed_carry(plan: PackedFirPlan, prefix=None) -> jnp.ndarray:
    """Initial carry: ``carry_vals`` interleaved int16 values.

    ``prefix`` (optional): the first ``plan.carry_len`` samples ([n, 2]
    int16) of the stream, aligning output sample indices with a reference
    run primed the same way. ``None`` = cold (zero) start.
    """
    if prefix is None:
        return jnp.zeros((plan.carry_vals,), dtype=jnp.int16)
    prefix = jnp.asarray(prefix, dtype=jnp.int16)
    assert prefix.shape == (plan.carry_len, 2), prefix.shape
    return prefix.reshape(-1)


def packed_fir_step(plan: PackedFirPlan, carry_vals, block, gplan=None):
    """One streaming step.

    carry_vals: [plan.carry_vals] int16 (interleaved values)
    block: int16 IQ — either flat interleaved ``[2N]`` (preferred: a device
    array shaped ``[N, 2]`` has a pathological 2-lane layout; np arrays
    reshape for free on the host) or ``[N, 2]``. N must be a multiple of
    ``plan.block_quantum``.
    ``gplan``: optional :class:`GroupedFirPlan` — runs the phase-grouped
    windowed matmuls instead of the chunked ones (bit-identical
    accumulators, far fewer matmul FLOPs for wide banks).
    Returns (new_carry_vals, ar, ai) with ar/ai ``[rows, opr*C]`` float32 —
    channelized, decimated, NOT derotated baseband in flat (k, c) order.
    """
    if isinstance(block, np.ndarray):
        block = block.reshape(-1)  # free on host
    block = jnp.asarray(block, dtype=jnp.int16)
    if block.ndim == 2:
        block = block.reshape(-1)
    n = block.shape[0] // 2
    if n % plan.block_quantum != 0:
        raise ValueError(
            f"block length {n} must be a multiple of {plan.block_quantum}"
        )
    vals = jnp.concatenate([carry_vals, block])
    r_tot = vals.shape[0] // plan.row
    rows = vals.reshape(r_tot, plan.row)
    r_valid = r_tot - plan.cr_rows

    # int16 x int16 -> int32 matmul: exact, skips an int16->f32
    # conversion pass, and uses the REFERENCE's own Q.14 tap quantization
    # (multifm/demod.c:214-218) — so the fast tier's filter response equals
    # the C filter's, with full-precision (unrounded) int32 accumulators.
    # P[r] = sum_i Q_i[r + i] (window spill into the i-th following row).
    # Only r_valid output rows exist and i <= cr_rows, so Q_i[i : i+r_valid]
    # is always in bounds: plain STATIC slices — no zero-concat, no
    # dynamic slice, nothing materialized beyond the matmul results.
    if gplan is not None:
        p = _grouped_matmul(
            rows, jnp.asarray(gplan.wg_i16), r_valid=r_valid,
            row=plan.row, spill=gplan.spill, g=gplan.g,
            n_groups=gplan.n_groups, win_g=gplan.win_g,
            d=plan.decimation, nr_ch=plan.nr_channels,
        )
    else:
        p = jnp.dot(
            rows,
            jnp.asarray(plan.w_chunks_i16[0]),
            preferred_element_type=jnp.int32,
        )[:r_valid]
        for i, w in enumerate(plan.w_chunks_i16[1:], start=1):
            nnz = _chunk_nnz(plan, i)  # spill chunks are zero past nnz rows
            q = jnp.dot(
                rows[:, :nnz], jnp.asarray(w[:nnz]),
                preferred_element_type=jnp.int32,
            )
            p = p + q[i : i + r_valid]
    p = p.astype(jnp.float32)
    half = plan.opr * plan.nr_channels
    # Keep the natural [rows, opr*C] layout — its flat order is (k, c), so
    # consumers index it like [K, C] without paying a 64-lane -> C-lane
    # relayout (which costs more than the matmuls themselves).
    ar = p[:, :half]
    ai = p[:, half : 2 * half]
    new_carry = jax.lax.dynamic_slice_in_dim(
        vals, r_valid * plan.row, plan.carry_vals
    )
    return new_carry, ar, ai


def packed_fir_step_exact(plan: PackedFirPlan, carry_vals, block,
                          gplan=None):
    """Bit-exact integer tier of :func:`packed_fir_step`.

    The reference's per-output complex MAC accumulates int16*int16 products
    into a wrapping int32 (``filter/direct_fir.c:366-385``); int32 modular
    addition is order-independent, so the same lane-packed matmul computes
    it EXACTLY — an int32-accumulating integer matmul wraps two's-complement
    (on the GPU XLA widens the operands to int32; ``chip_smoke.py`` checks
    the card's result against the CPU backend bit for bit). Returns (carry, a_re, a_im) with a_re/a_im
    ``[rows, opr*C]`` int16: the Q.28->Q.14 rounded, NOT-yet-derotated
    accumulators (reference rounding ``filter/complex.h:30-34``). Derotation
    is the serial Q.14 rotator — precomputed by the native helper
    ``tsl_rotator_seq`` and applied by the caller.
    """
    if isinstance(block, np.ndarray):
        block = block.reshape(-1)
    block = jnp.asarray(block, dtype=jnp.int16)
    if block.ndim == 2:
        block = block.reshape(-1)
    n = block.shape[0] // 2
    if n % plan.block_quantum != 0:
        raise ValueError(
            f"block length {n} must be a multiple of {plan.block_quantum}"
        )
    vals = jnp.concatenate([carry_vals, block])
    r_tot = vals.shape[0] // plan.row
    rows = vals.reshape(r_tot, plan.row)
    r_valid = r_tot - plan.cr_rows

    # static-slice spill adds (see packed_fir_step): wrap-exact int32 sums
    # are order-independent, so the restructuring preserves bit-exactness
    if gplan is not None:
        p = _grouped_matmul(
            rows, jnp.asarray(gplan.wg_i16), r_valid=r_valid,
            row=plan.row, spill=gplan.spill, g=gplan.g,
            n_groups=gplan.n_groups, win_g=gplan.win_g,
            d=plan.decimation, nr_ch=plan.nr_channels,
        )
    else:
        p = jnp.dot(
            rows, jnp.asarray(plan.w_chunks_i16[0]),
            preferred_element_type=jnp.int32,
        )[:r_valid]
        for i, w in enumerate(plan.w_chunks_i16[1:], start=1):
            nnz = _chunk_nnz(plan, i)  # zero products drop out of wrap sums
            q = jnp.dot(
                rows[:, :nnz], jnp.asarray(w[:nnz]),
                preferred_element_type=jnp.int32,
            )
            p = p + q[i : i + r_valid]
    half = plan.opr * plan.nr_channels
    from tsl_sdr_tpu.ops import q14

    a_re = q14.round_q28_q14(p[:, :half])
    a_im = q14.round_q28_q14(p[:, half : 2 * half])
    new_carry = jax.lax.dynamic_slice_in_dim(
        vals, r_valid * plan.row, plan.carry_vals
    )
    return new_carry, a_re, a_im


def omega_turns_i32(omega_d: np.ndarray) -> np.ndarray:
    """Per-output phase increment as signed-int32 turns (2^32 = one turn)."""
    turns = np.asarray(omega_d, dtype=np.float64) / (2.0 * np.pi)
    frac = turns - np.round(turns)
    return np.round(frac * 2.0**32).astype(np.int64).astype(np.int32)


def nco_rotate(ar, ai, omega_i32, k0):
    """Rotate baseband by ``e^{j*omega_d*k}`` with an integer NCO.

    ar/ai: [K, C] float32; omega_i32: [C] int32 turns (:func:`omega_turns_i32`);
    k0: scalar int32 absolute index of output 0. Phase is accumulated in
    int32 **turns** so wraparound is exact — float phase ``omega*k`` loses
    all precision once ``k`` is large, an NCO never does.
    """
    k = k0 + jnp.arange(ar.shape[0], dtype=jnp.int32)
    ph = k[:, None] * omega_i32[None, :]  # int32 wrap == mod 2^32 turns
    th = ph.astype(jnp.float32) * jnp.float32(2.0 * np.pi / 2.0**32)
    rr = jnp.cos(th)
    ri = jnp.sin(th)
    return ar * rr - ai * ri, ar * ri + ai * rr
