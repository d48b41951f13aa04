"""Rational resampler chain: polyphase FIR + optional DC blocker.

The model behind the standalone resampler tool and the decoders' front-end
(reference ``resampler/resampler.c:204-263``, ``decoder/decoder.c:581-656``):
int16 PCM in at f_in, polyphase-resample by I/D, optionally DC-block, int16
PCM out at f_in * I / D.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from tsl_sdr_tpu.ops import dc_blocker, polyphase, q14


class ResamplerChainState(NamedTuple):
    resampler: polyphase.ResamplerState
    dc: dc_blocker.DcBlockerState


class ResamplerChain:
    def __init__(
        self,
        lpf_coeffs,
        interpolate: int,
        decimate: int,
        *,
        dc_block_pole: float | None = None,
        block_out: int = 1024,
        exact: bool = True,
    ):
        """``lpf_coeffs``: float taps (quantized to Q.14 like
        ``resampler/resampler.c:145-151``)."""
        self._coeffs_q14 = q14.quantize_q14(lpf_coeffs)
        self.plan = polyphase.make_resampler_plan(
            self._coeffs_q14, interpolate, decimate, block_out_target=block_out
        )
        self.exact = exact
        self.dc_pole = dc_block_pole
        self.dc_coeff = (
            dc_blocker.make_pole_coeff(dc_block_pole) if dc_block_pole else None
        )

    def init_state(self, prefix=None) -> ResamplerChainState:
        return ResamplerChainState(
            resampler=polyphase.init_resampler_state(self.plan, prefix=prefix),
            dc=dc_blocker.init_dc_blocker_state(),
        )

    def step(self, state: ResamplerChainState, block, plan=None):
        """(state, pcm[block_in] int16) -> (state, pcm[block_out] int16).

        ``plan`` overrides the block geometry (the capture-tail plan);
        taps/phase must match for the carry state to chain."""
        rs_state, out = polyphase.resample_step(
            self.plan if plan is None else plan, state.resampler, block,
            exact=self.exact,
        )
        if self.dc_coeff is not None:
            if self.exact:
                dc_state, out = dc_blocker.dc_blocker_step_exact(
                    state.dc, out, self.dc_coeff
                )
            else:
                dc_state, out = dc_blocker.dc_blocker_step_fast(
                    state.dc, out.astype(jnp.int16), self.dc_coeff
                )
        else:
            dc_state = state.dc
        return ResamplerChainState(resampler=rs_state, dc=dc_state), out

    def _tail_plan(self, tail_use: int) -> polyphase.ResamplerPlan:
        """Plan sized for the sub-block_in capture tail (``tail_use`` input
        samples on the d_rep grid). Same taps/phase0 as the main plan, so a
        step chains bit-exactly; align_k_row=False keeps k_out exact."""
        if not hasattr(self, "_tail_plans"):
            self._tail_plans = {}
        if tail_use not in self._tail_plans:
            p = self.plan
            self._tail_plans[tail_use] = polyphase.make_resampler_plan(
                self._coeffs_q14, p.interpolation, p.decimation,
                block_out_target=tail_use * p.i_rep // p.d_rep,
                phase0=p.phase0, align_k_row=False,
            )
        return self._tail_plans[tail_use]

    def _run_blocks(self, pcm):
        """Shared whole-stream driver: full blocks via the compiled scan +
        one shorter tail block threaded through the same carry state, so no
        part of the capture beyond the d_rep grid is dropped (the tail past
        n_blocks*block_in used to vanish entirely)."""
        c_len = self.plan.carry_len
        n_in = self.plan.block_in
        usable = pcm.shape[0] - c_len
        n_blocks = usable // n_in
        if n_blocks < 1:
            raise ValueError("stream shorter than one block")
        state = self.init_state(prefix=pcm[:c_len])
        blocks = pcm[c_len : c_len + n_blocks * n_in].reshape(n_blocks, n_in)
        state, out = self.scan_fn(state, blocks)
        outs = [out.reshape(-1)]
        tail_use = (usable - n_blocks * n_in) // self.plan.d_rep \
            * self.plan.d_rep
        if tail_use:
            tp = self._tail_plan(tail_use)
            pos = c_len + n_blocks * n_in
            # the resampler carry is pure trailing input history; re-slice
            # it at the tail plan's carry_len (== the main plan's for the
            # shared phase0/taps, but derived independently to stay robust)
            assert tp.carry_len <= pos, (tp.carry_len, pos)
            t_state = ResamplerChainState(
                resampler=polyphase.init_resampler_state(
                    tp, prefix=pcm[pos - tp.carry_len : pos]
                ),
                dc=state.dc,
            )
            _, t_out = self.step(t_state, pcm[pos : pos + tail_use], plan=tp)
            outs.append(t_out.reshape(-1))
        return jnp.concatenate(outs) if len(outs) > 1 else outs[0]

    def process_array(self, pcm) -> np.ndarray:
        """Resample a whole in-memory PCM stream; returns int16 (exact tier)
        or float32 (fast tier)."""
        pcm = np.asarray(pcm, dtype=np.int16)
        return np.asarray(self._run_blocks(jnp.asarray(pcm)))

    def process_array_device(self, pcm):
        """Device-resident variant of :meth:`process_array`: takes and
        returns device arrays, no host round-trip (shapes are static, so
        the slicing/reshaping traces into the same dispatch)."""
        return self._run_blocks(pcm.astype(jnp.int16))

    @functools.cached_property
    def scan_fn(self):
        step = self.step

        @jax.jit
        def run(state, blocks):
            return jax.lax.scan(step, state, blocks)

        return run
