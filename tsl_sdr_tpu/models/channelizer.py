"""multifm: the flagship model — N-channel NBFM channelizer.

One wideband IQ stream in; per channel: complex-bandpass FIR + decimate +
derotate, then FM quadrature discriminator; 16-bit PCM out. Mirrors the
capability of the reference's receiver/demod-thread fan-out
(``multifm/receiver.c:78-98`` + ``multifm/demod.c:49-121``) — but where the
reference broadcasts each buffer to N worker threads, here all channels ride
one batched tensor contraction, and blocks stream through a ``lax.scan``.

Two tiers:

* ``exact=True`` — int16/int32 arithmetic bit-matching the C pipeline
  (:mod:`tsl_sdr_tpu.ops.fir` exact tier + LUT discriminator).
* ``exact=False`` — the production tier: the lane-packed matmul channelizer
  (:mod:`tsl_sdr_tpu.ops.packed_fir`) fused with the oscillator-free FM
  discriminator (:func:`tsl_sdr_tpu.ops.fm.fm_from_baseband`).

Use :class:`MultifmChain` programmatically or build one from a reference
multifm JSON config via :meth:`MultifmChain.from_config`.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from tsl_sdr_tpu.ops import fir, fm, packed_fir
from tsl_sdr_tpu.utils.config import MultifmConfig


class MultifmState(NamedTuple):
    """Exact-tier streaming state."""

    fir: fir.ChannelFirState
    fm: fm.FmDemodState


class MultifmFastState(NamedTuple):
    """Fast-tier streaming state (lane-packed pipeline)."""

    carry_vals: jnp.ndarray  # [carry_vals] int16 interleaved history
    prev_r: jnp.ndarray      # [C] float32 last baseband output (re)
    prev_i: jnp.ndarray      # [C] float32 last baseband output (im)
    out_index: jnp.ndarray   # [] int32 absolute output index (debug NCO)


class ExactPackedState(NamedTuple):
    """Streaming state for the FAST bit-exact tier (matmul FIR on device;
    serial Q.14 rotator + LUT FM demod carried on the host)."""

    carry: jnp.ndarray       # packed input history (device)
    rot: np.ndarray          # [C, 2] int16 current rotator values
    fm_last: np.ndarray      # [C, 2] int32 last baseband sample (FM carry)


class MultifmChain:
    """Channelize + FM-demodulate a wideband IQ stream on the accelerator.

    Parameters
    ----------
    lpf_taps : baseband LPF (float, unity DC gain) shared by all channels
    offsets_hz : per-channel offsets from the capture center frequency
    sample_rate : wideband input sample rate (Hz)
    decimation : input->channel decimation factor
    gains : optional per-channel linear gains
    exact : bit-exact integer tier (True) or fast float tier (False)
    """

    def __init__(
        self,
        lpf_taps,
        offsets_hz,
        sample_rate: float,
        decimation: int,
        gains=None,
        *,
        exact: bool = True,
        exact_tier: str = "packed",
    ):
        """``exact_tier`` selects the bit-exact streaming implementation:
        "packed" (default) runs the int16 matmul FIR + native rotator +
        LUT FM demod — same bits, ~10^2-10^3x faster than "scan", the
        readable lax.scan reference tier kept for oracle tests."""
        self.plan = fir.make_channel_fir_plan(
            lpf_taps, offsets_hz, sample_rate, decimation, gains
        )
        self.packed_plan = packed_fir.make_packed_fir_plan(
            lpf_taps, offsets_hz, sample_rate, decimation, gains
        )
        # wide banks: phase-grouped windowed matmuls (bit-identical, ~3.5x
        # fewer matmul FLOPs at 64ch); narrow banks keep the chunked form
        self.grouped_plan = (
            packed_fir.make_grouped_from_plan(self.packed_plan)
            if packed_fir.grouped_fir_worthwhile(self.packed_plan)
            else None
        )
        self.exact = exact
        if exact_tier not in ("packed", "scan"):
            raise ValueError(f"unknown exact_tier {exact_tier!r}")
        self.exact_tier = exact_tier
        self.sample_rate = float(sample_rate)
        self.decimation = int(decimation)
        # per-output derotation increment reduced to (-pi, pi] in float64
        w = self.packed_plan.omega_d.astype(np.float64)
        self._omega_reduced = (
            w - 2 * np.pi * np.round(w / (2 * np.pi))
        ).astype(np.float32)

    @classmethod
    def from_config(
        cls, config: MultifmConfig, *, exact: bool = True
    ):
        return cls(
            config.lpf_taps,
            config.channel_offsets_hz,
            config.sample_rate_hz,
            config.decimation_factor,
            gains=config.channel_gains,
            exact=exact,
        )

    @property
    def nr_channels(self) -> int:
        return self.plan.nr_channels

    @property
    def channel_rate(self) -> float:
        return self.sample_rate / self.decimation

    @property
    def carry_len(self) -> int:
        """Stream-prefix length (samples) for the active tier."""
        if self.exact and self.exact_tier == "scan":
            return self.plan.carry_len
        return self.packed_plan.carry_len

    @property
    def block_quantum(self) -> int:
        """Step block lengths must be a multiple of this many samples."""
        if self.exact and self.exact_tier == "scan":
            return self.plan.decimation
        return self.packed_plan.block_quantum

    # -- streaming API ------------------------------------------------------

    def init_state(self, prefix=None):
        if self.exact:
            if self.exact_tier == "packed":
                return self.init_exact_packed_state(prefix)
            return MultifmState(
                fir=fir.init_channel_fir_state(self.plan, prefix=prefix),
                fm=fm.init_fm_state(batch_shape=(self.nr_channels,)),
            )
        c = self.nr_channels
        return MultifmFastState(
            carry_vals=packed_fir.init_packed_carry(self.packed_plan, prefix),
            prev_r=jnp.zeros((c,), jnp.float32),
            prev_i=jnp.zeros((c,), jnp.float32),
            out_index=jnp.zeros((), jnp.int32),
        )

    def init_exact_packed_state(self, prefix=None) -> ExactPackedState:
        """Streaming state for the fast bit-exact tier (VERDICT r1 item 5)."""
        from tsl_sdr_tpu.ops import q14

        c = self.nr_channels
        rot0 = np.zeros((c, 2), np.int16)
        rot0[:, 0] = q14.Q14_ONE  # direct_fir_init: rot_phase = 1<<14, 0
        return ExactPackedState(
            carry=packed_fir.init_packed_carry(self.packed_plan, prefix),
            rot=rot0,
            fm_last=np.zeros((c, 2), np.int32),
        )

    @functools.cached_property
    def _exact_packed_fir_fn(self):
        return self._exact_packed_fir_wire("cs16")

    def _exact_packed_fir_wire(self, wire_fmt: str):
        """Jitted exact matmul FIR dispatch, parameterized by WIRE format:
        with an 8-bit ``wire_fmt`` the block arrives as raw wire values
        and widens in the jitted program's first stage (2 B/sample on
        the host->device link instead of int16's 4). Integer widening is
        bit-identical on either side of the link — same rules as
        ``utils.iq.widen_iq_bytes`` / the production engine's
        ``dev_step`` (reference ``multifm/rtl_sdr_if.c:118-147``,
        ``file_if.c:85-157``) — so the tier's bit-exact contract is
        unchanged."""
        fns = self.__dict__.setdefault("_exact_packed_fir_wire_fns", {})
        if wire_fmt not in fns:
            plan = self.packed_plan
            gplan = self.grouped_plan

            @jax.jit
            def f(carry, block):
                if wire_fmt == "cs8":
                    block = block.astype(jnp.int16)
                elif wire_fmt in ("cu8", "cu8_unbiased"):
                    block = block.astype(jnp.int16) - 127
                elif wire_fmt == "rtl_u8":
                    block = (block.astype(jnp.int16) - 127) << 7
                return packed_fir.packed_fir_step_exact(
                    plan, carry, block, gplan=gplan
                )

            fns[wire_fmt] = f
        return fns[wire_fmt]

    def step_exact_packed_begin(self, state: ExactPackedState, block,
                                wire_fmt: str = "cs16"):
        """Dispatch half of the bit-exact step: device matmul FIR + async
        plane fetches + host rotator advance. Returns ``(state2,
        pending)`` where ``state2`` threads the carry/rotator to the NEXT
        begin immediately (no device sync), while ``state2.fm_last`` is
        still the pre-block value — it only advances when the matching
        :meth:`step_exact_packed_end` consumes ``pending``, so ends must
        run in dispatch order. Splitting lets a streaming caller keep
        several blocks in flight and hide the device->host plane fetch
        behind the next blocks' compute."""
        import math as _math

        from tsl_sdr_tpu.runtime.native import rotator_seq

        if wire_fmt == "cs16":
            block = np.asarray(block, np.int16).reshape(-1)
        else:
            from tsl_sdr_tpu.utils.iq import WIRE_DTYPES

            block = np.asarray(block, WIRE_DTYPES[wire_fmt]).reshape(-1)
        carry, a_re, a_im = self._exact_packed_fir_wire(wire_fmt)(
            state.carry, jnp.asarray(block))
        a_re.copy_to_host_async()
        a_im.copy_to_host_async()
        k = _math.prod(a_re.shape) // self.nr_channels
        # rotator values for the k outputs PLUS the carry-out for the next
        # block (the reference advances once per decimated output and never
        # renormalizes, filter/direct_fir.c:152-172)
        rot = rotator_seq(state.rot, self.packed_plan.rot_incr_i32, k + 1)
        new_state = ExactPackedState(
            carry=carry, rot=np.ascontiguousarray(rot[k]),
            fm_last=state.fm_last)
        return new_state, (a_re, a_im, rot[:k])

    def step_exact_packed_end(self, fm_last, pending, want_ch: bool = False):
        """Host half of the bit-exact step: fetch the FIR planes, apply
        the exact Q.14 derotation/rounding and the LUT FM discriminator.
        ``fm_last`` is the [C, 2] int32 FM carry from the PREVIOUS end.
        Returns ``(fm_last2, pcm)`` (plus the channelized IQ when
        ``want_ch``)."""
        from tsl_sdr_tpu.ops.fm import fm_demod_np

        a_re_d, a_im_d, rot = pending
        c = self.nr_channels
        a_re = np.asarray(a_re_d).reshape(-1, c)
        a_im = np.asarray(a_im_d).reshape(-1, c)
        k = a_re.shape[0]
        d_re = (a_re.astype(np.int32) * rot[:k, :, 0]
                - a_im.astype(np.int32) * rot[:k, :, 1])
        d_im = (a_re.astype(np.int32) * rot[:k, :, 1]
                + a_im.astype(np.int32) * rot[:k, :, 0])

        def round_np(v):
            return ((v >> 14) + ((v >> 13) & 1)).astype(np.int16)

        ch = np.stack([round_np(d_re), round_np(d_im)], axis=-1)  # [K, C, 2]
        pcm, fm_last2 = fm_demod_np(np.moveaxis(ch, 1, 0), last=fm_last)
        fm_last2 = np.asarray(fm_last2, np.int32)
        if want_ch:
            return fm_last2, pcm, ch
        return fm_last2, pcm

    def _step_exact_packed_impl(self, state: ExactPackedState, block,
                                want_debug: bool = False):
        """Shared body: matmul FIR block on device, serial rotator + exact
        rounding + LUT FM on the host, all carries threaded."""
        st2, pending = self.step_exact_packed_begin(state, block)
        if want_debug:
            fm_last, pcm, ch = self.step_exact_packed_end(
                state.fm_last, pending, want_ch=True)
            return st2._replace(fm_last=fm_last), pcm, ch
        fm_last, pcm = self.step_exact_packed_end(state.fm_last, pending)
        return st2._replace(fm_last=fm_last), pcm

    def step_exact_packed(self, state: ExactPackedState, block):
        """(state, block [N,2]|[2N] int16) -> (state, pcm [C, K]) — the
        STREAMING fast bit-exact tier: identical bits to the scan tier and
        the reference C, at matmul speed."""
        return self._step_exact_packed_impl(state, block)

    def _step_raw(self, state, block):
        """Fast-tier step keeping the lane-packed layouts end to end.

        ``block``: flat interleaved int16 values ``[2N]`` (preferred) or
        ``[N, 2]``. Returns (state, pcm [rows, opr*C] int16) — flat order
        (k, c). This is the layout the device computes in; converting to [C, K]
        is deferred to the caller (one cheap host-side transpose per capture)
        so no per-step relayout burns HBM bandwidth.
        """
        carry, ar, ai = packed_fir.packed_fir_step(
            self.packed_plan, state.carry_vals, block,
            gplan=self.grouped_plan,
        )
        pcm, pr, pi_ = fm.fm_from_baseband(
            ar,
            ai,
            state.prev_r,
            state.prev_i,
            self._omega_reduced,
            nr_channels=self.nr_channels,
        )
        new_state = MultifmFastState(
            carry_vals=carry,
            prev_r=pr,
            prev_i=pi_,
            out_index=state.out_index
            + jnp.int32(ar.size // self.nr_channels),
        )
        return new_state, pcm

    def step(self, state, block):
        """(state, block[N, 2] int16) -> (state, pcm[C, N//D] int16)."""
        if self.exact:
            if self.exact_tier == "packed":
                return self.step_exact_packed(state, block)
            fir_state, ch = fir.channel_fir_step(
                self.plan, state.fir, block, exact=True
            )
            fm_state, pcm = fm.fm_demod_step(state.fm, ch)
            return MultifmState(fir=fir_state, fm=fm_state), pcm
        new_state, pcm = self._step_raw(state, block)
        return new_state, pcm.reshape(-1, self.nr_channels).T

    def step_debug(self, state, block):
        """Like :meth:`step` but also returns the channelized IQ.

        Returns (state, pcm [C, K] int16, iq [C, K, 2] int16) — the
        post-FIR, derotated per-channel baseband, i.e. the reference's
        ``signalDebugFile`` tap (``multifm/demod.c:75-82``). The fast tier
        rotates with the integer NCO (exact analytic phase at any absolute
        output index).
        """
        if self.exact:
            if self.exact_tier == "packed":
                state, pcm, ch = self._step_exact_packed_impl(
                    state, block, want_debug=True)
                return state, pcm, np.moveaxis(ch, 1, 0)
            fir_state, ch = fir.channel_fir_step(
                self.plan, state.fir, block, exact=True
            )
            fm_state, pcm = fm.fm_demod_step(state.fm, ch)
            return MultifmState(fir=fir_state, fm=fm_state), pcm, ch
        carry, ar, ai = packed_fir.packed_fir_step(
            self.packed_plan, state.carry_vals, block,
            gplan=self.grouped_plan,
        )
        pcm, pr, pi_ = fm.fm_from_baseband(
            ar, ai, state.prev_r, state.prev_i,
            self._omega_reduced, nr_channels=self.nr_channels,
        )
        c = self.nr_channels
        oi32 = packed_fir.omega_turns_i32(self.packed_plan.omega_d)
        yr, yi = packed_fir.nco_rotate(
            ar.reshape(-1, c), ai.reshape(-1, c), jnp.asarray(oi32),
            state.out_index,
        )
        # packed accumulators carry the Q.14 tap scale; the reference dumps
        # the rounded-to-sample-units baseband (round_q28_q14 of the acc)
        scale = jnp.float32(1.0 / 16384.0)
        iq = jnp.stack(
            [
                jnp.trunc(yr * scale).astype(jnp.int16),
                jnp.trunc(yi * scale).astype(jnp.int16),
            ],
            axis=-1,
        ).transpose(1, 0, 2)
        new_state = MultifmFastState(
            carry_vals=carry,
            prev_r=pr,
            prev_i=pi_,
            out_index=state.out_index + jnp.int32(ar.size // c),
        )
        return new_state, pcm.reshape(-1, c).T, iq

    def process_array_exact_packed(self, iq, block_size: int = 4_194_304):
        """Bit-exact capture processing with a matmul doing the MACs.

        Identical output to the exact tier (``exact=True`` /
        ``process_array``) but far faster: the integer FIR
        rides the lane-packed int16 matmul (int32 modular accumulation is
        order-free, so the matmul result equals the C loop bit-for-bit), the
        serial Q.14 rotator drift is precomputed by the native helper, and
        the LUT FM discriminator runs vectorized on the host. Returns
        pcm [C, K_total] int16.
        """
        from tsl_sdr_tpu.ops import q14
        from tsl_sdr_tpu.ops.fm import fm_demod_np
        from tsl_sdr_tpu.runtime.native import rotator_seq

        iq = np.asarray(iq, dtype=np.int16)
        q = self.packed_plan.block_quantum
        c_len = self.packed_plan.carry_len
        usable = (iq.shape[0] - c_len) // q * q
        if usable <= 0:
            raise ValueError("capture shorter than one block quantum")
        block_size = min(block_size - block_size % q, usable)
        if block_size <= 0:
            block_size = usable
        n_blocks = usable // block_size
        # the sub-block_size tail runs as one extra (shorter) block so no
        # part of the capture is dropped; only the < quantum residue at the
        # very end falls off the quantum grid
        tail_len = usable - n_blocks * block_size
        carry = packed_fir.init_packed_carry(
            self.packed_plan, iq[:c_len] if c_len else None
        )
        body = iq[c_len : c_len + n_blocks * block_size]
        blocks = jnp.asarray(body.reshape(n_blocks, 2 * block_size))

        plan = self.packed_plan
        gplan = self.grouped_plan

        @jax.jit
        def run(carry, blocks):
            def body_fn(cv, bv):
                cv, a_re, a_im = packed_fir.packed_fir_step_exact(
                    plan, cv, bv, gplan=gplan
                )
                return cv, (a_re, a_im)

            return jax.lax.scan(body_fn, carry, blocks)

        carry, (a_re, a_im) = run(carry, blocks)
        c = self.nr_channels
        re_parts = [np.asarray(a_re).reshape(-1, c)]  # [K, C] int16
        im_parts = [np.asarray(a_im).reshape(-1, c)]
        if tail_len:
            tb = iq[c_len + n_blocks * block_size : c_len + usable]
            carry, (a_re, a_im) = run(
                carry, jnp.asarray(tb.reshape(1, 2 * tail_len))
            )
            re_parts.append(np.asarray(a_re).reshape(-1, c))
            im_parts.append(np.asarray(a_im).reshape(-1, c))
        a_re = np.concatenate(re_parts)
        a_im = np.concatenate(im_parts)
        k_total = a_re.shape[0]

        # serial Q.14 derotator (native precompute) + exact rounding
        rot0 = np.zeros((c, 2), np.int16)
        rot0[:, 0] = q14.Q14_ONE
        rot = rotator_seq(rot0, plan.rot_incr_i32, k_total)  # [K, C, 2]
        d_re = a_re.astype(np.int32) * rot[..., 0] - a_im.astype(
            np.int32
        ) * rot[..., 1]
        d_im = a_re.astype(np.int32) * rot[..., 1] + a_im.astype(
            np.int32
        ) * rot[..., 0]

        def round_np(v):
            return ((v >> 14) + ((v >> 13) & 1)).astype(np.int16)

        ch = np.stack([round_np(d_re), round_np(d_im)], axis=-1)  # [K, C, 2]
        pcm, _ = fm_demod_np(np.moveaxis(ch, 1, 0))  # [C, K]
        return pcm

    # -- whole-array API (bench / batch jobs) -------------------------------

    def process_array_device(self, iq, block_size: int = 4_194_304):
        """Like :meth:`process_array` but returns DEVICE-resident
        pcm [C, K_total] (no device->host transfer). Downstream device-side
        stages (resample, slice, bit-pack — see ReceivePipeline) chain off
        this so only protocol-rate bits ever cross to the host."""
        return self.process_array(iq, block_size=block_size, _device=True)

    def process_array(self, iq, block_size: int = 4_194_304, _device=False):
        """Process a whole in-memory capture. Returns pcm [C, K_total] int16.

        The capture is blocked and run through a jitted ``lax.scan`` so the
        full stream executes on-device in one dispatch.
        """
        if self.exact and self.exact_tier == "packed":
            pcm = self.process_array_exact_packed(iq, block_size=block_size)
            return jnp.asarray(pcm) if _device else pcm
        iq = np.asarray(iq, dtype=np.int16)
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
        # part of the capture is dropped; only the < quantum residue at the
        # very end falls off the quantum grid
        tail_len = usable - n_blocks * block_size
        state = self.init_state(prefix=iq[:c_len] if c_len else None)

        def _blocks(off, bs, nb):
            body = iq[c_len + off : c_len + off + nb * bs]
            if self.exact:
                return jnp.asarray(body.reshape(nb, bs, 2))
            # flat interleaved values: free on the host, and keeps every
            # device-side slice/copy in a fully lane-packed layout
            return jnp.asarray(body.reshape(nb, 2 * bs))

        state, pcm = self.scan_fn(state, _blocks(0, block_size, n_blocks))
        parts = [pcm]
        if tail_len:
            state, pcm = self.scan_fn(
                state, _blocks(n_blocks * block_size, tail_len, 1)
            )
            parts.append(pcm)
        xp = jnp if _device else np
        if not _device:
            parts = [np.asarray(p) for p in parts]
        if self.exact:
            # pcm: [n_blocks, C, K] -> [C, n_blocks * K]
            parts = [
                xp.moveaxis(p, 1, 0).reshape(self.nr_channels, -1)
                for p in parts
            ]
        else:
            # fast tier emits the packed [n_blocks, rows, opr*C] layout; one
            # reshape+transpose per part converts it to [C, K]
            parts = [p.reshape(-1, self.nr_channels).T for p in parts]
        if len(parts) == 1:
            return parts[0] if _device else parts[0].copy()
        return xp.concatenate(parts, axis=1)

    @functools.cached_property
    def scan_fn(self):
        """Jitted streaming scan over blocks.

        exact tier: (state, blocks[n, N, 2]) -> (state, pcm[n, C, K]);
        fast tier: (state, blocks[n, N, 2]) -> (state, pcm[n, rows, opr*C])
        — packed layout, flat order (k, c). The plan (taps, rotator
        increments) is baked in as compile-time constants; one compilation
        per block shape."""
        step = self.step if self.exact else self._step_raw

        @jax.jit
        def run(state, blocks):
            return jax.lax.scan(step, state, blocks)

        return run
