"""Sharded multifm: channelize + FM demod over a (time, channels) mesh.

Production (float32, lane-packed) tier — the multi-chip form of
:mod:`tsl_sdr_tpu.ops.packed_fir`. The wideband capture splits into
contiguous equal segments of packed ROWS on the ``time`` axis; the channel
bank's tap matrices split on the ``channels`` axis (each channel shard gets
its own pre-built column block, so no in-kernel gather is needed).

Halo exchange between neighbouring devices, all via ``jax.lax.ppermute`` of int16 rows:

* each shard sends its **first ``cr`` rows** to its *left* neighbor — the
  forward window spill of the packed FIR (output row r reads rows
  ``r..r+cr``);
* each shard sends its **last row** to its *right* neighbor — one row of
  look-back so the shard can locally recompute the decimated output that
  precedes its first one, seeding the FM discriminator's one-sample history
  without any serial dependency.

The per-output derotator folds into a constant ``omega_d`` added after the
atan2 (see :func:`tsl_sdr_tpu.ops.fm.fm_from_baseband`), so shards need no
absolute-phase oscillator at all — time sharding is embarrassingly parallel
up to the two neighbor exchanges.

The exact (integer) tier shards over channels only: its iterated Q.14
rotator is serial in time by construction (that drift IS the reference
semantics, ``filter/direct_fir.c:152-172``).
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import PartitionSpec as P

from tsl_sdr_tpu.ops.fm import fm_from_baseband
from tsl_sdr_tpu.ops.packed_fir import PackedFirPlan
from tsl_sdr_tpu.parallel.mesh import CHANNEL_AXIS, TIME_AXIS

_PI_F32 = np.float32(np.pi)


def _local_packed_fm(vals_local, w_all, omega_all, *, row, opr, cr, cols,
                     chunk_nnz=None, gspec=None):
    """Per-shard kernel. vals_local [2N] int16 (interleaved IQ values) ->
    pcm [C_local, N//D] int16."""
    w = w_all[0]          # [cr+1, ROW, cols_local] (leading shard dim squeezed)
    omega = omega_all[0]  # [C_local]
    nr_ch = omega.shape[0]

    r_local = vals_local.shape[0] // row
    rows_i16 = vals_local.reshape(r_local, row)

    # --- halo exchange between neighbours (int16, minimal bytes) ---
    n_t = jax.lax.axis_size(TIME_AXIS)
    fwd = [(i, i + 1) for i in range(n_t - 1)]
    bwd = [(i + 1, i) for i in range(n_t - 1)]
    # last row -> right neighbor (look-back seed); shard 0 receives zeros
    prev_row = jax.lax.ppermute(rows_i16[-1:], TIME_AXIS, fwd)
    # first cr rows -> left neighbor (window spill); last shard receives zeros
    next_rows = jax.lax.ppermute(rows_i16[:cr], TIME_AXIS, bwd)

    total = jnp.concatenate([prev_row, rows_i16, next_rows])
    r_tot = r_local + 1 + cr
    r_valid = r_local + 1

    # --- packed FIR: int16 x int16 -> int32 matmul per tap chunk + row shift
    # (same quantized taps and integer accumulation as the single-chip
    # packed tier, so shards agree with it bit-for-bit); wide channel
    # shards ride the phase-grouped windowed form instead (bit-identical,
    # fewer FLOPs — see ops/packed_fir.GroupedFirPlan) ---
    if gspec is not None:
        from tsl_sdr_tpu.ops.packed_fir import _grouped_matmul

        g_, n_groups, win_g, spill, d_ = gspec
        p = _grouped_matmul(
            total, w, r_valid=r_valid, row=row, spill=spill, g=g_,
            n_groups=n_groups, win_g=win_g, d=d_, nr_ch=nr_ch,
        ).astype(jnp.float32)
    else:
        p = jnp.dot(total, w[0], preferred_element_type=jnp.int32)
        for i in range(1, cr + 1):
            nnz = chunk_nnz[i] if chunk_nnz else row  # zero past nnz
            q = jnp.dot(
                total[:, :nnz], w[i][:nnz], preferred_element_type=jnp.int32
            )
            p = p + jax.lax.dynamic_slice_in_dim(
                jnp.concatenate([q, jnp.zeros((i, cols), jnp.int32)]),
                i, r_tot,
            )
        p = p[:r_valid].astype(jnp.float32)
    half = opr * nr_ch

    # --- FM with folded derotator; the extra leading row provides history
    # (cold prev only corrupts the look-back outputs, which are dropped) ---
    zero = jnp.zeros((nr_ch,), jnp.float32)
    pcm, _, _ = fm_from_baseband(
        p[:, :half], p[:, half : 2 * half], zero, zero, omega,
        nr_channels=nr_ch,
    )
    # drop the opr look-back outputs (they belong to the left shard)
    return pcm.reshape(-1, nr_ch)[opr:].T  # [C_local, r_local*opr]


def make_sharded_multifm(plan, mesh, omega_reduced=None):
    """Build a jitted sharded processor over ``mesh`` (axes: time, channels).

    ``plan``: a :class:`PackedFirPlan` (or an object exposing the same
    fields). Returns ``fn(vals[2S] int16) -> pcm[C, S//D] int16`` taking the
    capture as FLAT interleaved IQ values (``iq[S,2].reshape(-1)`` — free on
    the host, and the only lane-efficient device layout), ``2*S`` divided
    evenly into packed rows across the time axis; output index k is the
    global decimated index (output 0 = input samples ``[0, T)``).
    """
    if not isinstance(plan, PackedFirPlan):
        raise TypeError(
            "make_sharded_multifm now takes a PackedFirPlan "
            "(use MultifmChain.packed_plan)"
        )
    n_ch_shards = mesh.shape[CHANNEL_AXIS]
    nr_ch = plan.nr_channels
    if nr_ch % n_ch_shards:
        raise ValueError(f"{nr_ch} channels not divisible by {n_ch_shards}")
    c_local = nr_ch // n_ch_shards

    # per-channel-shard tap stacks: [shards, cr+1, ROW, cols_local]
    w_full = np.stack(plan.w_chunks_i16)  # [cr+1, ROW, 2*opr*C] int16
    w_full = w_full.reshape(
        plan.cr_rows + 1, plan.row, 2, plan.opr, n_ch_shards, c_local
    )
    w_sh = np.ascontiguousarray(np.moveaxis(w_full, 4, 0)).reshape(
        n_ch_shards, plan.cr_rows + 1, plan.row, 2 * plan.opr * c_local
    )

    # shard-width grouped form: group size is chosen for C_LOCAL (a
    # full-bank grouping would leave each shard's matmuls sub-lane)
    from tsl_sdr_tpu.ops.packed_fir import (
        grouped_fir_worthwhile, make_grouped_from_plan)

    def _shard_plan(sh):
        def _slice(chunks):
            return tuple(
                np.ascontiguousarray(
                    np.asarray(c).reshape(
                        plan.row, 2, plan.opr, n_ch_shards, c_local
                    )[:, :, :, sh].reshape(plan.row, 2 * plan.opr * c_local)
                )
                for c in chunks
            )

        return plan._replace(
            w_chunks=_slice(plan.w_chunks),
            w_chunks_i16=_slice(plan.w_chunks_i16),
            nr_channels=c_local,
            omega_d=plan.omega_d.reshape(n_ch_shards, c_local)[sh],
        )

    gspec = None
    wg_sh = None
    if grouped_fir_worthwhile(_shard_plan(0)):
        gplans = [make_grouped_from_plan(_shard_plan(sh))
                  for sh in range(n_ch_shards)]
        gp0 = gplans[0]
        wg_sh = np.stack([gp.wg_i16 for gp in gplans])
        gspec = (gp0.g, gp0.n_groups, gp0.win_g, gp0.spill, plan.decimation)
    if omega_reduced is None:
        w = plan.omega_d.astype(np.float64)
        omega_reduced = (w - 2 * np.pi * np.round(w / (2 * np.pi))).astype(
            np.float32
        )
    omega_sh = np.asarray(omega_reduced, np.float32).reshape(
        n_ch_shards, c_local
    )

    local = functools.partial(
        _local_packed_fm,
        row=plan.row,
        opr=plan.opr,
        cr=plan.cr_rows,
        cols=2 * plan.opr * c_local,
        chunk_nnz=tuple(plan.chunk_nnz) if plan.chunk_nnz else None,
        gspec=gspec,
    )

    fn = shard_map(
        local,
        mesh=mesh,
        in_specs=(
            P(TIME_AXIS),                    # flat IQ values: time-sharded
            P(CHANNEL_AXIS, None, None, None),  # tap stacks: channel-sharded
            P(CHANNEL_AXIS, None),           # omega
        ),
        out_specs=P(CHANNEL_AXIS, TIME_AXIS),
    )

    w_j = jnp.asarray(wg_sh if gspec is not None else w_sh)
    omega_j = jnp.asarray(omega_sh)

    @jax.jit
    def process(vals):
        if vals.ndim == 2:  # tolerate [S, 2] input
            vals = vals.reshape(-1)
        return fn(vals, w_j, omega_j)

    return process
