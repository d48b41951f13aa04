"""Time-sharded rational resampler over a device mesh.

The north-star design obligation (SURVEY §2.2 row 4): the reference's
resampler carries ``last_phase``/``sample_offset`` serially across buffers
(``filter/polyphase_fir_priv.h:62,92``), but the phase sequence is an exact
affine function of the absolute output index — so time shards need no
serial state at all. Each shard's first output phase is known analytically
(`phase0 = 0` at stream start and the block design keeps ``I | K*D``), and
the only communication is the forward window spill: ``(S-1)*D_rep`` input
samples fetched from the right neighbor with one ``jax.lax.ppermute``.

Uses the same frame-shift matmul formulation as the single-chip fast tier
(:func:`tsl_sdr_tpu.ops.polyphase._resample_fast_kernel`).
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import PartitionSpec as P

from tsl_sdr_tpu.ops.polyphase import ResamplerPlan
from tsl_sdr_tpu.parallel.mesh import TIME_AXIS


def _local_resample(x_local, wt, *, s_shifts, d_rep, i_rep):
    """Per-shard kernel: [N_local] int16 -> [N_local * I/D] float32.

    Same transposed-residue form as the single-chip fast tier
    (ops/polyphase._resample_fast_kernel_t): the shard's M axis rides the
    matmul lanes; taps are the exact Q.14 integers."""
    from tsl_sdr_tpu.ops import q14

    n_t = jax.lax.axis_size(TIME_AXIS)
    halo_len = (s_shifts - 1) * d_rep
    # window spill: first halo_len samples -> left neighbor
    head = x_local[:halo_len]
    nxt = jax.lax.ppermute(
        head, TIME_AXIS, [(i + 1, i) for i in range(n_t - 1)]
    )  # last shard receives zeros
    total = jnp.concatenate([x_local, nxt])
    m_out = x_local.shape[0] // d_rep
    xt = total.reshape(m_out + s_shifts - 1, d_rep).T  # [D_rep, M+S-1]
    acc = jnp.dot(wt[0], xt[:, :m_out], preferred_element_type=jnp.int32)
    for s in range(1, s_shifts):
        acc = acc + jnp.dot(
            wt[s], xt[:, s : s + m_out], preferred_element_type=jnp.int32
        )
    out = acc.astype(jnp.float32) * jnp.float32(1.0 / q14.Q14_ONE)
    return out.T.reshape(-1)


def _local_resample_row(x_local, w0, w1, *, row_in, k_row, spill):
    """Packed-row per-shard kernel (ops/polyphase._resample_row_kernel):
    [M, ROW_IN] rows @ [ROW_IN, K_ROW] taps + trimmed spill chunk. The
    right-neighbor halo is the ``spill`` window overhang (none needed
    when the filter span fits a row)."""
    from tsl_sdr_tpu.ops import q14
    from tsl_sdr_tpu.ops.polyphase import row_matmul_acc

    total = x_local
    if spill:
        n_t = jax.lax.axis_size(TIME_AXIS)
        head = x_local[:spill]
        nxt = jax.lax.ppermute(
            head, TIME_AXIS, [(i + 1, i) for i in range(n_t - 1)]
        )  # last shard receives zeros
        total = jnp.concatenate([x_local, nxt])
    m = x_local.shape[0] // row_in
    pad = (m + 1) * row_in - total.shape[0]
    tot = jnp.concatenate([total, jnp.zeros((pad,), total.dtype)])
    rows = tot.reshape(m + 1, row_in)
    acc = row_matmul_acc(rows, m, w0, w1)
    out = acc.astype(jnp.float32) * jnp.float32(1.0 / q14.Q14_ONE)
    return out.reshape(-1)


def make_sharded_resampler(plan: ResamplerPlan, mesh):
    """fn(pcm[N] int16) -> float32 [N * I/D], N split over the time axis.

    Requires ``phase0 == 0`` plans (the default) and per-shard sample counts
    divisible by ``D_rep``. Output index k is the global output index
    (window at input offset ``k*D//I``), identical to the single-chip fast
    tier modulo the f32 sum order. Shard lengths divisible by ``ROW_IN``
    ride the packed-row kernel (full matmul lanes); others fall back to the
    transposed-residue kernel.
    """
    if plan.phase0 != 0:
        raise ValueError("sharded resampler supports phase0 == 0 plans")
    local = functools.partial(
        _local_resample,
        s_shifts=plan.frame_shifts,
        d_rep=plan.d_rep,
        i_rep=plan.i_rep,
    )
    fn = shard_map(
        local,
        mesh=mesh,
        in_specs=(P(TIME_AXIS), P()),
        out_specs=P(TIME_AXIS),
    )
    wf = jnp.asarray(
        np.ascontiguousarray(
            plan.w_frames_i16.reshape(
                plan.frame_shifts, plan.d_rep, plan.i_rep
            ).transpose(0, 2, 1)
        )
    )
    n_t = mesh.shape[TIME_AXIS]

    fn_row = None
    if plan.k_row:
        has_spill = plan.w_spill_i16 is not None
        local_row = functools.partial(
            _local_resample_row,
            row_in=plan.row_in,
            k_row=plan.k_row,
            spill=plan.spill,
        )
        if not has_spill:
            base_row = local_row
            local_row = lambda x, w0: base_row(x, w0, None)  # noqa: E731
        fn_row = shard_map(
            local_row,
            mesh=mesh,
            in_specs=(P(TIME_AXIS), P(), P()) if has_spill
            else (P(TIME_AXIS), P()),
            out_specs=P(TIME_AXIS),
        )
        w_row = jnp.asarray(plan.w_row_i16)
        w_spill = (
            jnp.asarray(plan.w_spill_i16) if has_spill else None
        )

    def process(pcm):
        n = pcm.shape[0]
        q = n_t * plan.d_rep
        if n % q:
            raise ValueError(
                f"input length {n} must be a multiple of "
                f"time_shards*D_rep = {q} (pad or trim the capture)"
            )
        if fn_row is not None and n % (n_t * plan.row_in) == 0:
            if w_spill is not None:
                return _jitted_row(pcm, w_row, w_spill)
            return _jitted_row_nospill(pcm, w_row)
        return _jitted(pcm, wf)

    @jax.jit
    def _jitted(pcm, wf):
        return fn(pcm, wf)

    @jax.jit
    def _jitted_row(pcm, w0, w1):
        return fn_row(pcm, w0, w1)

    @jax.jit
    def _jitted_row_nospill(pcm, w0):
        return fn_row(pcm, w0)

    return process
