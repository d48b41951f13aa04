"""Coherent (Costas-loop) channelizer: PSK-style channels to rotated IQ.

The reference builds a Costas demodulator but never wires it to a config
path — its demod thread instantiates only FM (``multifm/demod.c:318``,
``multifm/costas_demod.c``). This framework exposes it as a first-class
chain: wideband IQ -> lane-packed channel FIR bank -> integer-NCO
derotation -> per-channel 2nd-order Costas loop (a true serial recurrence,
run as a ``lax.scan`` vmapped across channels).

Output is phase-locked IQ per channel (int16, Q.14-scaled like the
reference's ``multifm_costas_demod_process`` output).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from tsl_sdr_tpu.ops import costas, packed_fir


class CostasChainState(NamedTuple):
    carry_vals: jnp.ndarray   # packed FIR history
    out_index: jnp.ndarray    # [] int32 absolute output index (NCO)
    costas: costas.CostasState  # leaves vmapped over channels [C]


class CostasChannelizer:
    """Channelize + coherently demodulate N PSK channels.

    Same front-end contract as :class:`MultifmChain` (fast tier); the
    back-end replaces the FM discriminator with per-channel Costas loops.
    """

    def __init__(
        self,
        lpf_taps,
        offsets_hz,
        sample_rate: float,
        decimation: int,
        gains=None,
        *,
        alpha: float = 0.05,
        beta: float = 0.002,
        e_max_q14: int = 8192,
        f_shift: float = 0.0,
    ):
        self.packed_plan = packed_fir.make_packed_fir_plan(
            lpf_taps, offsets_hz, sample_rate, decimation, gains
        )
        self.grouped_plan = (
            packed_fir.make_grouped_from_plan(self.packed_plan)
            if packed_fir.grouped_fir_worthwhile(self.packed_plan)
            else None
        )
        self.params = costas.make_costas_params(
            f_shift, alpha=alpha, beta=beta, e_max_q14=e_max_q14
        )
        self.sample_rate = float(sample_rate)
        self.decimation = int(decimation)
        self._oi32 = jnp.asarray(
            packed_fir.omega_turns_i32(self.packed_plan.omega_d)
        )

    @property
    def nr_channels(self) -> int:
        return self.packed_plan.nr_channels

    @property
    def carry_len(self) -> int:
        return self.packed_plan.carry_len

    @property
    def block_quantum(self) -> int:
        return self.packed_plan.block_quantum

    def init_state(self, prefix=None) -> CostasChainState:
        c = self.nr_channels
        single = costas.init_costas_state(self.params)
        per_ch = jax.tree.map(
            lambda v: jnp.broadcast_to(v, (c,)), single
        )
        return CostasChainState(
            carry_vals=packed_fir.init_packed_carry(self.packed_plan, prefix),
            out_index=jnp.zeros((), jnp.int32),
            costas=per_ch,
        )

    def process_array_native(self, iq, block_size: int = 4_194_240):
        """Whole-capture path with the native serial PLL (production host
        Costas, ~30 Msps/channel vs ~1 Msps for the device scan).

        device does the sample-rate work (packed FIR bank + integer-NCO
        derotation); the per-sample feedback loop runs in C. Returns
        int16 IQ [C, K, 2].
        """
        from tsl_sdr_tpu.runtime.native import costas_native

        iq = np.asarray(iq, np.int16)
        q = self.block_quantum
        c_len = self.carry_len
        usable = (iq.shape[0] - c_len) // q * q
        if usable <= 0:
            raise ValueError("capture shorter than one block quantum")
        block_size = min(block_size - block_size % q, usable)
        if block_size <= 0:
            block_size = usable
        n_blocks = usable // block_size
        # the sub-block_size tail runs as one extra (shorter) block so no
        # part of the capture is dropped (< quantum residue excepted)
        tail_len = usable - n_blocks * block_size
        plan = self.packed_plan
        gplan = self.grouped_plan
        carry = packed_fir.init_packed_carry(plan, iq[:c_len] if c_len else None)
        body = iq[c_len : c_len + n_blocks * block_size]
        blocks = jnp.asarray(body.reshape(n_blocks, 2 * block_size))
        oi32 = self._oi32
        c = self.nr_channels

        @jax.jit
        def run(state, blocks):
            def body_fn(st, bv):
                cv, k0 = st
                cv, ar, ai = packed_fir.packed_fir_step(
                    plan, cv, bv, gplan=gplan
                )
                yr, yi = packed_fir.nco_rotate(
                    ar.reshape(-1, c), ai.reshape(-1, c), oi32, k0
                )
                scale = jnp.float32(1.0 / 16384.0)
                iq16 = jnp.stack(
                    [
                        jnp.trunc(yr * scale).astype(jnp.int16),
                        jnp.trunc(yi * scale).astype(jnp.int16),
                    ],
                    axis=-1,
                )  # [K, C, 2]
                return (cv, k0 + jnp.int32(yr.shape[0])), iq16

            return jax.lax.scan(body_fn, state, blocks)

        state, rot = run((carry, jnp.int32(0)), blocks)  # rot [n, K, C, 2]
        parts = [np.asarray(rot).reshape(-1, c, 2)]
        if tail_len:
            tb = iq[c_len + n_blocks * block_size : c_len + usable]
            # same jitted runner, one shorter block; the threaded (carry,
            # NCO index) state keeps the derotation phase continuous
            _, rot_t = run(state, jnp.asarray(tb.reshape(1, 2 * tail_len)))
            parts.append(np.asarray(rot_t).reshape(-1, c, 2))
        rot = np.concatenate(parts) if len(parts) > 1 else parts[0]
        out = np.empty((c, rot.shape[0], 2), np.int16)
        for ci in range(c):
            out[ci], _ = costas_native(
                np.ascontiguousarray(rot[:, ci, :]), self.params
            )
        return out

    def step(self, state: CostasChainState, block, *, tier: str = "block"):
        """(state, block[N,2] int16) -> (state, iq [C, N//D, 2] int16).

        ``tier="block"`` (production) runs the chunk-parallel device loop
        (:func:`tsl_sdr_tpu.ops.costas.costas_block_planes`) directly on
        the channelizer's ``[K, C]`` planes — fully on-device and ~3
        orders faster than the per-sample scan. ``tier="scan"`` keeps the
        serial-exact ``lax.scan`` oracle."""
        if isinstance(block, np.ndarray):
            block = block.reshape(-1)
        carry, ar, ai = packed_fir.packed_fir_step(
            self.packed_plan, state.carry_vals, block,
            gplan=self.grouped_plan,
        )
        c = self.nr_channels
        yr, yi = packed_fir.nco_rotate(
            ar.reshape(-1, c), ai.reshape(-1, c), self._oi32, state.out_index
        )
        # packed accumulators carry the Q.14 tap scale; the Costas loop's
        # quadratic error term expects sample-unit amplitudes
        scale = jnp.float32(1.0 / 16384.0)
        yr = yr * scale
        yi = yi * scale
        k = yr.shape[0]
        if tier == "block":
            # planes take Q.14-normalized amplitudes (what costas_step's
            # internal /Q14 produces) so the quadratic error matches
            norm = jnp.float32(1.0 / 16384.0)
            st2, o_re, o_im = costas.costas_block_planes(
                self.params, state.costas, yr * norm, yi * norm
            )
            out = jnp.stack(
                [
                    jnp.trunc(o_re.T * 16384.0).astype(jnp.int16),
                    jnp.trunc(o_im.T * 16384.0).astype(jnp.int16),
                ],
                axis=-1,
            )  # [C, K, 2]
        else:
            # per-channel serial PLL: vmap the scan over the channel axis
            blocks_c = jnp.stack([yr.T, yi.T], axis=-1)  # [C, K, 2] float
            st2, out = jax.vmap(
                lambda s, b: costas.costas_step(self.params, s, b)
            )(state.costas, blocks_c)
        new_state = CostasChainState(
            carry_vals=carry,
            out_index=state.out_index + jnp.int32(k),
            costas=st2,
        )
        return new_state, out
