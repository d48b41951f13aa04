"""End-to-end receive pipeline: channelize -> resample -> protocol decode.

The reference deploys this as one multifm process plus one resampler/decoder
process *per channel*, glued by operator-created named FIFOs
(SURVEY §3.4; ``etc/multifm.json`` + ``decoder/decoder.c``). Here the same
topology is one object: the accelerator runs the wideband channelizer for all
channels in a single batched chain, each channel's PCM is rationally
resampled to its protocol's rate contract (POCSAG 38400 Hz, FLEX 16 kHz,
AIS 48 kHz — ``pager/pager_pocsag.c:105``, ``pager_flex_priv.h:345-348``,
``ais/ais_demod_priv.h:57-67``), and the bit-level state machines decode on
the host.

Streaming architecture (production tier): every device stage —
channelize, per-channel resample, DC block, sign slice, bit-pack, and the
sync-candidate prefilter — traces into ONE jitted dispatch per block, so
a block costs a single host->device->host round trip instead of one per
stage. :meth:`push` double-buffers: while the device computes block
k+1, the host decodes block k — mirroring the reference's run-forever
deployment (``multifm/multifm.c:163-165``) in one process.

Egress gating: the device prefilter (:mod:`tsl_sdr_tpu.ops.sync_prefilter`)
flags, per channel per block, whether any POCSAG/AIS/FLEX sync candidate
exists. Unflagged idle channels transfer ~½–1KB of carry tail instead of
their sign bits (POCSAG/AIS) or int16 PCM (FLEX), and their decoders do no
work — device->host egress stops scaling with channel count on quiet
bands.

The resampler ratio is derived automatically from the channel rate and the
protocol rate; its anti-alias filter is designed with the same Kaiser recipe
as the reference's GNURadio script.
"""

from __future__ import annotations

import math
import time
from collections import deque
from dataclasses import dataclass
from fractions import Fraction

import numpy as np

from tsl_sdr_tpu.models.channelizer import MultifmChain
from tsl_sdr_tpu.models.resampler import ResamplerChain
from tsl_sdr_tpu.utils.filter_design import design_rational_resampler_filter

PROTOCOL_RATES = {"pocsag": 38_400, "flex": 16_000, "ais": 48_000}


def _make_decoder(protocol: str, freq_hz: int, ais_packet_hook=None):
    if protocol == "pocsag":
        from tsl_sdr_tpu.models.pocsag import PocsagDecoder

        return PocsagDecoder()
    if protocol == "flex":
        from tsl_sdr_tpu.models.flex import FlexDecoder

        return FlexDecoder(freq_hz=freq_hz)
    if protocol == "ais":
        from tsl_sdr_tpu.models.ais import AisDecoder

        hook = None
        if ais_packet_hook is not None:
            # pipeline hook contract: callable(packet, center_freq_hz) —
            # the frequency identifies the VHF channel (A/B) for NMEA
            def hook(packet, _f=freq_hz, _h=ais_packet_hook):
                _h(packet, _f)
        return AisDecoder(packet_hook=hook)
    raise ValueError(f"unknown protocol {protocol!r}")


@dataclass
class ChannelSpec:
    """One narrowband channel: where it sits and what it speaks."""

    center_freq_hz: int
    protocol: str  # pocsag | flex | ais | pcm (raw demodulated audio)
    invert: bool = False
    dc_block: bool = False       # decoder -b flag (decoder/decoder.c:648-656)
    dc_block_pole: float = 0.9999
    db_gain: float | None = None  # per-channel dBGain (receiver.c:218-221)


class _SizedProgram:
    """Everything bound to one block length: per-channel resampler plans
    with ``block_in`` equal to the whole per-block channel span (so one
    ``resample_step`` call consumes the block) and the jitted fused fn."""

    def __init__(self, pipe: "ReceivePipeline", n: int):
        import jax
        import jax.numpy as jnp

        from tsl_sdr_tpu.ops import dc_blocker as dcb
        from tsl_sdr_tpu.ops import polyphase, q14, sync_prefilter

        self.n = n
        chain = pipe.chain
        decim = chain.decimation
        assert n % pipe.block_quantum == 0, (n, pipe.block_quantum)
        k_chain = n // decim
        self.k_chain = k_chain

        # per-ratio-group resampler plans sized to the block
        self.plans = {}
        for gid, g in pipe._rs_groups.items():
            i_, d_ = gid
            coeffs = pipe._rs_coeffs[gid]
            self.plans[gid] = polyphase.make_resampler_plan(
                q14.quantize_q14(coeffs), i_, d_,
                block_out_target=k_chain * i_ // d_,
                align_k_row=False,  # n_in must equal k_chain exactly
            )
            assert self.plans[gid].block_in == k_chain, (
                self.plans[gid].block_in, k_chain)
        self.k_out = {
            i: (self.plans[pipe._ratio_gid[i]].block_out
                if pipe._ratio_gid[i] is not None else k_chain)
            for i in range(len(pipe.channels))
        }

        c = chain.nr_channels
        inv_mask = np.array([s.invert for s in pipe.channels], bool)
        any_invert = bool(inv_mask.any())
        rs_groups = pipe._rs_groups
        dc_items = pipe._dc_items
        pack_groups = pipe._pack_groups
        raw_groups = pipe._raw_groups
        plans = self.plans
        tail_bits = pipe._tail_bits

        # multi-chip: annotate the [C, K] channel-PCM tensor and let GSPMD
        # partition the program (scaling-book recipe: pick a mesh,
        # constrain shardings, XLA inserts the collectives).
        #
        # - channels axis: the FIR bank / resamplers / prefilters split
        #   by channel; the contraction dim stays local, so sharded
        #   results are bit-identical.
        # - time axis: the SAME block's samples split across devices —
        #   single-stream scaling. Every integer stage (FIR accumulators,
        #   resampler matmuls, sign slice, bit-pack, prefilter popcounts)
        #   partitions exactly (int adds are associative); windowed ops
        #   get GSPMD halo exchanges. The only tolerance is the DC fast
        #   tier's f32 associative scan, whose cross-shard combine may
        #   round differently by a few PCM LSBs (that tier is already
        #   LSB-approximate vs the host oracle; decode margins absorb it).
        mesh = getattr(pipe, "mesh", None)
        mp_repl = getattr(pipe, "_mp_repl", None)
        ch_sharding = None
        if mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec
            from tsl_sdr_tpu.parallel.mesh import CHANNEL_AXIS, TIME_AXIS

            n_sh = mesh.shape.get(CHANNEL_AXIS, 1)
            n_t = mesh.shape.get(TIME_AXIS, 1)
            spec = PartitionSpec(
                CHANNEL_AXIS if n_sh > 1 and c % n_sh == 0 else None,
                TIME_AXIS if n_t > 1 else None,
            )
            if spec != PartitionSpec(None, None):
                ch_sharding = NamedSharding(mesh, spec)

        wire_fmt = pipe.wire_fmt

        def dev_step(chain_st, rs, dc, tails, vals):
            # 8-bit wire ingest: the block arrives as raw wire bytes
            # (2 B/sample instead of int16's 4) and widens HERE, in the
            # fused program's first stage — bit-identical to the host
            # rules in utils.iq.widen_iq_bytes (reference
            # multifm/rtl_sdr_if.c:118-147, file_if.c:85-157). On a
            # link-bound deployment this doubles the ingest ceiling of
            # every e2e row for 8-bit sources.
            if wire_fmt == "cs8":
                vals = vals.astype(jnp.int16)
            elif wire_fmt in ("cu8", "cu8_unbiased"):
                vals = vals.astype(jnp.int16) - 127
            elif wire_fmt == "rtl_u8":
                vals = (vals.astype(jnp.int16) - 127) << 7
            chain_st, pcm_flat = chain._step_raw(chain_st, vals)
            pcm = pcm_flat.reshape(-1, c).T  # [C, K]
            if ch_sharding is not None:
                pcm = jax.lax.with_sharding_constraint(pcm, ch_sharding)
            if any_invert:
                flipped = jnp.clip(
                    -(pcm.astype(jnp.int32)), -32768, 32767
                ).astype(jnp.int16)
                pcm = jnp.where(
                    jnp.asarray(inv_mask)[:, None], flipped, pcm
                )
            ch_rows = {}
            rs2 = {}
            for gid, idxs in rs_groups.items():
                rows = pcm[jnp.asarray(idxs), :]  # [G, K]
                plan = plans[gid]
                st2, outs = jax.vmap(
                    lambda s, b, _p=plan: polyphase.resample_step(
                        _p, s, b, exact=False
                    )
                )(rs[gid], rows)
                rs2[gid] = st2
                for j, i in enumerate(idxs):
                    ch_rows[i] = outs[j]
            for i in range(len(pipe.channels)):
                if i not in ch_rows:
                    ch_rows[i] = pcm[i]
            dc2 = {}
            for i, coeff in dc_items:
                # production tier: log-depth associative scan — the exact
                # per-sample scan would serialize ~100k steps per block on
                # the device (the host oracle path keeps it; outputs differ by a
                # few PCM LSBs of filter transient, below decode margins)
                st2, out = dcb.dc_blocker_step_fast(
                    dc[i], ch_rows[i].astype(jnp.int16), coeff
                )
                dc2[i] = st2
                ch_rows[i] = out
            tails2 = {}
            pack_out = {}
            for pgid, pg in pack_groups.items():
                rows = jnp.stack([ch_rows[i] for i in pg["idx"]])
                if pg["kind"] == "pcm":
                    # FLEX: the decoder needs real amplitudes (trained
                    # 4FSK thresholds), but its SYNC_1 hunt is the sign
                    # slice pcm >= 0 — prefilter on-device, gate the
                    # int16 rows. float->int16 truncates toward zero,
                    # matching the host path's np.astype.
                    rows = rows.astype(jnp.int16)
                    predu = (rows >= 0).astype(jnp.uint8)
                    k_out = rows.shape[1]
                    full = jnp.concatenate([tails[pgid], predu], axis=1)
                    flags = sync_prefilter.flex_any_candidate(full, k_out)
                    tails2[pgid] = full[:, -tail_bits[pgid]:]
                    # ONE int16 buffer: [flag | last TAIL pcm | pcm rows]
                    pack_out[pgid] = jnp.concatenate(
                        [flags.astype(jnp.int16)[:, None],
                         rows[:, -tail_bits[pgid]:], rows], axis=1,
                    )
                    continue
                if jnp.issubdtype(rows.dtype, jnp.floating):
                    # match the host oracle and the C reference, which
                    # slice int16-TRUNCATED PCM: a -0.4 sample is bit 0,
                    # not bit 1 (np.asarray(pcm, np.int16) truncates)
                    rows = jnp.trunc(rows)
                pred = (rows > 0) if pg["is_gt"] else (rows < 0)
                predu = pred.astype(jnp.uint8)
                k_out = predu.shape[1]
                full = jnp.concatenate([tails[pgid], predu], axis=1)
                if pgid == "pocsag":
                    flags = sync_prefilter.pocsag_any_candidate(full, k_out)
                else:
                    flags = sync_prefilter.ais_any_candidate(full, k_out)
                k8 = -(-k_out // 8) * 8
                if k8 != k_out:
                    predu = jnp.pad(predu, ((0, 0), (0, k8 - k_out)))
                packed = jnp.packbits(predu, axis=1)
                tails2[pgid] = full[:, -tail_bits[pgid]:]
                tail_packed = jnp.packbits(tails2[pgid], axis=1)
                # ONE output buffer per group: flags byte + packed tail +
                # packed bits — a single device->host transfer unit (each
                # separate fetch pays its own round trip)
                pack_out[pgid] = jnp.concatenate(
                    [flags.astype(jnp.uint8)[:, None], tail_packed, packed],
                    axis=1,
                )
            raw_out = {}
            for rgid, idxs in raw_groups.items():
                rows = jnp.stack([ch_rows[i] for i in idxs])
                if jnp.issubdtype(rows.dtype, jnp.floating):
                    # decoders/pcm sinks consume int16; converting on
                    # device (same round-toward-zero as np.astype) halves
                    # the raw-channel device->host egress
                    rows = rows.astype(jnp.int16)
                raw_out[rgid] = rows
            if mp_repl is not None:
                # multi-process mesh: gather the (small, egress-gated)
                # outputs back to every process on-device so the host
                # drain reads only addressable data; carried state stays
                # sharded across blocks
                pack_out = jax.tree.map(
                    lambda v: jax.lax.with_sharding_constraint(v, mp_repl),
                    pack_out)
                raw_out = jax.tree.map(
                    lambda v: jax.lax.with_sharding_constraint(v, mp_repl),
                    raw_out)
            return chain_st, rs2, dc2, tails2, (pack_out, raw_out)

        self.fn = jax.jit(dev_step, donate_argnums=(0, 1, 2, 3))
        # combined pack payload layout, in ELEMENTS of the group's dtype:
        # bits kind [flags u8 | packed tail bytes | packed bits], pcm kind
        # [flags i16 | tail pcm samples | pcm samples]
        self.meta_bytes = {
            pgid: (1 + tail_bits[pgid] if pg["kind"] == "pcm"
                   else 1 + tail_bits[pgid] // 8)
            for pgid, pg in pack_groups.items()
        }

    def init_rs_states(self, pipe):
        import jax

        from tsl_sdr_tpu.ops import polyphase

        out = {}
        for gid, idxs in pipe._rs_groups.items():
            plan = self.plans[gid]
            single = polyphase.init_resampler_state(plan)
            out[gid] = jax.tree.map(
                lambda v: np.broadcast_to(
                    np.asarray(v), (len(idxs),) + np.shape(v)
                ).copy(),
                single,
            )
        return out


class ReceivePipeline:
    """Wideband IQ in, decoded protocol messages (or raw PCM) out.

    Parameters
    ----------
    lpf_taps : channel-select LPF for the channelizer (shared, real)
    center_freq_hz : capture center frequency
    sample_rate : wideband sample rate (Hz)
    decimation : channelizer decimation; channel rate = fs / decimation
    channels : list of :class:`ChannelSpec`
    exact : bit-exact integer tier (True) or production float tier
    max_ratio : largest allowed resampler interpolation/decimation term
    block_size : streaming block length in wideband samples (rounded to
        the pipeline quantum); default ~4M
    """

    def __init__(
        self,
        lpf_taps,
        center_freq_hz: int,
        sample_rate: float,
        decimation: int,
        channels,
        *,
        exact: bool = False,
        max_ratio: int = 256,
        block_size: int | None = None,
        inflight_depth: int = 2,
        mesh=None,
        ais_packet_hook=None,
        wire_fmt: str = "cs16",
        drain_async: bool = False,
    ):
        # drain_async: run _drain (device->host fetch wait + bit unpack +
        # decoder scans) on a dedicated worker thread, so block k's drain
        # overlaps block k+1's host->device upload instead of serializing
        # with it. On a link where h2d is the binding resource this
        # recovers the decode/unpack/fetch-wait share of wall time.
        # Messages then surface on a LATER push() call (flush() always
        # joins and returns everything); per-channel order is unchanged
        # (single worker, FIFO). The deployment CLI enables it in
        # --follow mode; default off keeps push() fully synchronous.
        self.drain_async = bool(drain_async)
        # wire-format ingest (VERDICT r4 #2): with an 8-bit wire_fmt,
        # push()/process_capture() take RAW WIRE BYTES (flat uint8/bytes
        # or [N, 2] of the wire view dtype) and the widening runs in the
        # fused device program's first stage — host->device ships
        # 2 B/sample instead of 4. cs16 keeps the int16 [N, 2] API.
        from tsl_sdr_tpu.utils.iq import WIRE_DTYPES, WIRE_ZERO

        if wire_fmt not in WIRE_DTYPES:
            raise ValueError(f"unknown wire_fmt {wire_fmt!r}; expected one "
                             f"of {tuple(WIRE_DTYPES)}")
        self.wire_fmt = wire_fmt
        self._wire_dtype = WIRE_DTYPES[wire_fmt]
        self._wire_zero = WIRE_ZERO[wire_fmt]
        # e2e breakdown instrumentation: set ``pipe.timing = {}`` and the
        # streaming engines accumulate HOST-BLOCKED seconds per phase
        # (upload/dispatch/drain-wait/unpack/decode/...). The host loop is
        # serial, so these phases sum to e2e wall time — the additive
        # model for the deployment rows (bench/e2e_breakdown.py). Leave
        # None for zero overhead.
        self.timing = None
        # optional callable(packet_bytes, center_freq_hz) fired for every
        # CRC-valid AIS packet on any ais channel (survives
        # restore_stream's decoder recreation) — the NMEA AIVDM
        # re-emission tap; the frequency selects the VHF channel letter
        self._ais_packet_hook = ais_packet_hook
        # optional jax.sharding.Mesh with 'time'/'channels' axes: the fused
        # device program is GSPMD-partitioned across it (channel-sharded
        # FIR bank, resamplers, prefilters; time-sharded samples) —
        # decode-identical to the single-device program (see _SizedProgram)
        self.mesh = mesh
        # multi-PROCESS mesh (devices owned by other jax processes over
        # DCN): the initial state becomes a global replicated array, block
        # uploads become TIME-SHARDED global arrays assembled from each
        # process's local span (every host uploads only 1/P of the block —
        # see _dispatch), and per-block outputs are gathered back to every
        # process on-device (with_sharding_constraint to replicated) so the
        # host drain logic works unchanged. Single-process meshes leave
        # every path untouched.
        self._mp_repl = None
        self._mp_time_sharding = None
        self._sp_time_sharding = None
        if mesh is not None:
            import jax
            from jax.sharding import NamedSharding, PartitionSpec
            from tsl_sdr_tpu.parallel.mesh import TIME_AXIS

            multiproc = any(d.process_index != jax.process_index()
                            for d in mesh.devices.flat)
            time_sh = (NamedSharding(mesh, PartitionSpec(TIME_AXIS))
                       if mesh.shape.get(TIME_AXIS, 1) > 1 else None)
            if multiproc:
                self._mp_repl = NamedSharding(mesh, PartitionSpec())
                self._mp_time_sharding = time_sh
            else:
                # single-process mesh: device_put the block WITH the time
                # sharding so ingest DMAs land on every chip in parallel
                # instead of one chip + an on-device scatter
                self._sp_time_sharding = time_sh
        # device->host latency hiding: up to ``inflight_depth`` blocks stay
        # in flight before the oldest is drained, so each block's async
        # copies get ~depth iterations to land before np.asarray touches
        # them. On a high-latency link the e2e cap is
        # ~depth*block_size/RTT — deepen for throughput, at the cost of
        # depth blocks of added decode latency in --follow live mode.
        self.inflight_depth = int(inflight_depth)
        self.channels = list(channels)
        # checkpoint fingerprint inputs (see _stream_fingerprint): config
        # that changes decode semantics without changing state-leaf shapes
        self._fp_taps = np.asarray(lpf_taps, np.float64)
        self._fp_center = int(center_freq_hz)
        offsets = [c.center_freq_hz - center_freq_hz for c in self.channels]
        gains = [
            10.0 ** (c.db_gain / 10.0) if c.db_gain is not None else 1.0
            for c in self.channels
        ]
        self.chain = MultifmChain(
            lpf_taps, offsets, sample_rate, decimation, gains=gains,
            exact=exact,
        )
        ch_rate = self.chain.channel_rate

        # per-channel ratios + legacy per-channel ResamplerChains (exact /
        # host path); the fused streaming path builds its own sized plans
        self._resamplers = []
        self._decoders = []
        self._ratio_gid = []
        self._rs_coeffs = {}
        for spec in self.channels:
            if spec.protocol == "pcm":
                self._resamplers.append(None)
                self._decoders.append(None)
                self._ratio_gid.append(None)
                continue
            target = PROTOCOL_RATES[spec.protocol]
            ratio = Fraction(target, int(round(ch_rate)))
            if ratio.numerator > max_ratio or ratio.denominator > max_ratio:
                raise ValueError(
                    f"channel rate {ch_rate:.0f} Hz -> {target} Hz needs "
                    f"{ratio.numerator}/{ratio.denominator}; pick a "
                    "decimation giving a simpler ratio"
                )
            if ratio == 1:
                self._resamplers.append(None)
                self._ratio_gid.append(None)
            else:
                gid = (ratio.numerator, ratio.denominator)
                if gid not in self._rs_coeffs:
                    self._rs_coeffs[gid] = design_rational_resampler_filter(
                        ratio.numerator, ratio.denominator, 0.4
                    )
                self._ratio_gid.append(gid)
                self._resamplers.append(
                    ResamplerChain(
                        self._rs_coeffs[gid], ratio.numerator,
                        ratio.denominator, exact=exact,
                    )
                )
            self._decoders.append(
                _make_decoder(spec.protocol, spec.center_freq_hz,
                              self._ais_packet_hook)
            )

        self._setup_stream(block_size)

    # protocols whose decoders consume ONLY a sign predicate of the PCM, so
    # the device can slice + bit-pack before transfer (16x less egress than
    # int16). FLEX is gated too but with an int16 payload ("pcm" kind):
    # its 4FSK slicing needs trained amplitude thresholds
    # (pager_flex.c:149-171), while its SYNC_1 hunt is sign-only — so the
    # device prefilter still decides whether the full rows transfer at all.
    # value = is_gt: True slices pcm > 0 (ais_demod.c:126), False pcm < 0
    # (pager_pocsag.c:91)
    _PACK_PREDICATE = {"pocsag": False, "ais": True}

    # -- streaming engine ---------------------------------------------------

    def _setup_stream(self, block_size):
        from tsl_sdr_tpu.ops import sync_prefilter

        decim = self.chain.decimation
        # channel groups
        self._rs_groups: dict = {}
        for i, gid in enumerate(self._ratio_gid):
            if gid is not None:
                self._rs_groups.setdefault(gid, []).append(i)
        self._dc_items = []
        for i, spec in enumerate(self.channels):
            if spec.dc_block:
                from tsl_sdr_tpu.ops import dc_blocker as dcb

                self._dc_items.append(
                    (i, dcb.make_pole_coeff(spec.dc_block_pole))
                )
        self._pack_groups: dict = {}
        self._raw_groups: dict = {}
        for i, spec in enumerate(self.channels):
            if spec.protocol in self._PACK_PREDICATE:
                pg = self._pack_groups.setdefault(
                    spec.protocol,
                    {"idx": [], "kind": "bits",
                     "is_gt": self._PACK_PREDICATE[spec.protocol]},
                )
                pg["idx"].append(i)
            elif spec.protocol == "flex":
                pg = self._pack_groups.setdefault(
                    spec.protocol, {"idx": [], "kind": "pcm"},
                )
                pg["idx"].append(i)
            else:
                self._raw_groups.setdefault(spec.protocol, []).append(i)
        self._tail_bits = {
            "pocsag": sync_prefilter.POCSAG_TAIL,
            "ais": sync_prefilter.AIS_TAIL,
            "flex": sync_prefilter.FLEX_TAIL,
        }

        # block quantum: chain quantum, every resampler's input grid, and
        # a whole number of channel samples per byte of packed bits
        # (group ids come from a reduced Fraction, so d_ needs no gcd)
        q = self.chain.block_quantum
        for (i_, d_), _ in self._rs_groups.items():
            q = math.lcm(q, decim * d_)
            # align each group's per-block output to its K_ROW so the
            # matmul packed-row resampler kernel engages (the plans are
            # built with align_k_row=False for the exact-n_in contract,
            # which keeps k_row only when K is already aligned)
            k_row = math.lcm(i_, 128)
            if k_row <= 1024:
                row_in = (k_row // i_) * d_
                q = math.lcm(q, decim * row_in)
        q = math.lcm(q, decim * 8)
        self.block_quantum = q
        bs = block_size or 4_194_304
        self.block_size = max(q, bs // q * q)
        # gap-tail soundness: every pack channel's per-block output must
        # cover the carried prefilter tail — otherwise a skipped block's
        # tail would re-feed bits from earlier, already-decoded blocks
        # after a gap (duplicate messages)
        min_n = 0
        for pgid, pg in self._pack_groups.items():
            tail = self._tail_bits[pgid]
            for i in pg["idx"]:
                gid = self._ratio_gid[i]
                if gid is None:
                    need = tail * decim
                else:
                    i_, d_ = gid
                    need = -(-tail * d_ // i_) * decim
                min_n = max(min_n, need)
        if min_n:
            self.block_size = max(self.block_size, -(-min_n // q) * q)

        self._programs: dict[int, _SizedProgram] = {}
        self._stream = None
        self._xstream = None
        self._pending_prefix = np.zeros((0, 2), self._wire_dtype)

    def _program(self, n: int) -> _SizedProgram:
        if n not in self._programs:
            self._programs[n] = _SizedProgram(self, n)
        return self._programs[n]

    def stream_reset(self):
        """Forget all streaming state (device carries, input buffer,
        in-flight blocks). Decoder instances persist."""
        self._drain_shutdown()
        self._stream = None
        self._xstream = None
        self._pending_prefix = np.zeros((0, 2), self._wire_dtype)

    # -- wire-format helpers -------------------------------------------------

    def _coerce_wire(self, iq) -> np.ndarray:
        """Raw wire bytes (bytes/flat array/[N, 2]) -> [N, 2] wire-dtype
        view (reinterpret, never convert)."""
        if isinstance(iq, (bytes, bytearray, memoryview)):
            iq = np.frombuffer(iq, np.uint8)
        flat = np.asarray(iq).reshape(-1)
        return flat.view(self._wire_dtype).reshape(-1, 2)

    def _widen_host(self, arr) -> np.ndarray:
        """[N, 2] wire-dtype -> [N, 2] int16 by the host rules
        (utils.iq.widen_iq_bytes) — the prefix-priming / exact-tier /
        oracle path; the production device program widens on-chip."""
        if self.wire_fmt == "cs16":
            return np.asarray(arr, np.int16)
        from tsl_sdr_tpu.utils import iq as iqio

        flat = np.ascontiguousarray(arr).reshape(-1).view(np.uint8)
        return iqio.widen_iq_bytes(flat, self.wire_fmt).reshape(-1, 2)

    def _stream_init(self, prefix: np.ndarray | None):
        import jax
        import jax.numpy as jnp

        from tsl_sdr_tpu.ops import dc_blocker as dcb

        if prefix is not None and self.wire_fmt != "cs16":
            # the chain's carry prefix is tiny (carry_len samples); widen
            # it on the host — the bulk blocks widen on device
            prefix = self._widen_host(prefix)
        prog = self._program(self.block_size)
        st = {
            "chain": self.chain.init_state(prefix=prefix),
            "rs": prog.init_rs_states(self),
            "dc": {
                # distinct device buffers per leaf: jnp scalar literals
                # dedupe to one buffer, which the jit's donation rejects
                # ("donate the same buffer twice")
                i: jax.tree.map(
                    lambda v: jnp.asarray(np.asarray(v).copy()),
                    dcb.init_dc_blocker_state(),
                )
                for i, _ in self._dc_items
            },
            "tails": {
                pgid: jnp.zeros(
                    (len(pg["idx"]), self._tail_bits[pgid]), jnp.uint8
                )
                for pgid, pg in self._pack_groups.items()
            },
        }
        if self._mp_repl is not None:
            # multi-process: the jitted global computation requires global
            # arrays; the initial carries are identical on every process
            st = jax.tree.map(
                lambda a: jax.device_put(np.asarray(a), self._mp_repl), st
            )
        self._stream = {
            "st": st,
            "buf": [],
            "buf_len": 0,
            "inflight": deque(),
            # zero-primed resampler carries time-shift the fused engine's
            # output grid by carry_len channel samples vs the head-primed
            # host path (pure delay — harmless to the asynchronous
            # protocols); the first ceil(carry_len*I/D) outputs are
            # zero-history filter transient and are dropped here so
            # decoders and pcm sinks never see fabricated samples
            "lead_drop": {
                i: -(-prog.plans[gid].carry_len
                     * prog.plans[gid].interpolation
                     // prog.plans[gid].decimation)
                for gid, idxs in self._rs_groups.items()
                for i in idxs
            },
            # host-side per-pack-channel gating state
            "gap": {i: False for pg in self._pack_groups.values()
                    for i in pg["idx"]},
            "tail_pcm": {i: None for pg in self._pack_groups.values()
                         for i in pg["idx"]},
            # egress-gating observability: blocks drained, and per channel
            # how many had their full bit rows fetched/fed
            "blocks": 0,
            "fetched": np.zeros(len(self.channels), np.int64),
            # int16 elements THIS process moved host->device for block
            # ingest (multi-process time meshes upload only the local
            # 1/P span; replicated fallback uploads the whole block)
            "upload_elems": 0,
            # wire bytes THIS process moved host->device (2 B/sample for
            # 8-bit wire formats, 4 for cs16 — the host-link cost)
            "upload_bytes": 0,
            # speculative-prefetch state: a pack group that fetched rows
            # last block is "hot" — its next packed array is streamed to
            # the host asynchronously while the device computes, so the
            # fetch costs ~0 latency; cold (idle) groups transfer only
            # their ~0.5 KB meta row (egress gating)
            "hot": {pgid: True for pgid in self._pack_groups},
        }
        if self.drain_async:
            self._start_drain_worker(self._stream, self._drain)

    # -- drain worker (shared by the production and exact engines) ----------

    def _start_drain_worker(self, s: dict, drain_one):
        """Attach a drain worker to stream dict ``s``: entries enqueued by
        :meth:`_drain_entry` are drained by ``drain_one(entry, new)`` on a
        dedicated thread, overlapping the dispatch thread's next upload."""
        import queue as _queue
        import threading

        # bounded: a lagging worker backpressures push() instead of
        # letting undrained device buffers pile up in HBM
        s["dq"] = _queue.Queue(maxsize=max(2, self.inflight_depth))
        s["dres"] = [[] for _ in self.channels]
        s["dlock"] = threading.Lock()
        s["derr"] = None

        def _worker():
            while True:
                entry = s["dq"].get()
                if entry is None:
                    return
                if isinstance(entry, threading.Event):
                    entry.set()  # barrier: everything before is done
                    continue
                if s["derr"] is not None:
                    continue  # poisoned: discard, surface on push
                try:
                    tmp = [[] for _ in self.channels]
                    drain_one(entry, tmp)
                    with s["dlock"]:
                        for c, part in enumerate(tmp):
                            s["dres"][c].extend(part)
                except BaseException as e:  # noqa: BLE001
                    s["derr"] = e

        s["dthread"] = threading.Thread(
            target=_worker, daemon=True, name="tsl-drain")
        s["dthread"].start()

    def _drain_entry(self, s: dict, entry, new: list, drain_one):
        """Route one in-flight block to ``s``'s drain worker (async) or
        drain it inline; async results ready SO FAR fold into ``new``."""
        if s.get("dthread") is None:
            drain_one(entry, new)
            return
        if s["derr"] is not None:
            raise s["derr"]
        s["dq"].put(entry)
        with s["dlock"]:
            if any(s["dres"]):
                for c in range(len(self.channels)):
                    if s["dres"][c]:
                        new[c].extend(s["dres"][c])
                        s["dres"][c] = []

    def _drain_barrier(self, s: dict, new: list):
        """Wait until every enqueued block is drained; collect results."""
        import threading

        if s is None or s.get("dthread") is None:
            return
        ev = threading.Event()
        s["dq"].put(ev)
        ev.wait()
        if s["derr"] is not None:
            raise s["derr"]
        with s["dlock"]:
            for c in range(len(self.channels)):
                if s["dres"][c]:
                    new[c].extend(s["dres"][c])
                    s["dres"][c] = []

    def _drain_shutdown(self):
        """Stop the drain workers (stream teardown)."""
        for s in (getattr(self, "_stream", None),
                  getattr(self, "_xstream", None)):
            if s and s.get("dthread") is not None:
                s["dq"].put(None)
                s["dthread"] = None

    @property
    def stream_stats(self) -> dict:
        """{"blocks": drained blocks, "fetched": per-channel full-row fetch
        counts} — idle gated channels stay near zero."""
        s = self._stream
        if s is None:
            if getattr(self, "_last_stream_stats", None) is not None:
                return dict(self._last_stream_stats)
            return {"blocks": 0,
                    "fetched": np.zeros(len(self.channels), np.int64),
                    "upload_elems": 0, "upload_bytes": 0}
        return {"blocks": s["blocks"], "fetched": s["fetched"].copy(),
                "upload_elems": s["upload_elems"],
                "upload_bytes": s["upload_bytes"]}

    def push(self, iq) -> list:
        """Feed wideband IQ (any length); decode what completes.

        Returns a per-channel list of messages (or raw PCM arrays for
        ``pcm`` channels) completed during this call. State carries across
        calls — the streaming form of :meth:`process_capture`
        (reference run-forever semantics, ``multifm/multifm.c:163-165``).
        """
        if self.chain.exact:
            return self._push_exact(iq)
        new = [[] for _ in self.channels]
        for block in self._pump_blocks(iq, "_stream", self._stream_init):
            self._dispatch(block)
            # keep inflight_depth blocks in flight: block k's device->host
            # transfers complete while later blocks compute and earlier
            # ones host-decode
            s = self._stream
            while len(s["inflight"]) > self.inflight_depth:
                self._drain_entry(s, s["inflight"].popleft(), new,
                                  self._drain)
        return new

    def _pump_blocks(self, iq, attr: str, init_fn):
        """Shared input path of the production and bit-exact streaming
        engines: hold data until the chain prefix is covered, prime the
        stream (``init_fn``), buffer, and yield full block_size blocks."""
        if self.wire_fmt == "cs16":
            iq = np.asarray(iq, np.int16).reshape(-1, 2)
        else:
            iq = self._coerce_wire(iq)
        if getattr(self, attr) is None:
            c_len = self.chain.carry_len
            pend = np.concatenate([self._pending_prefix, iq])
            if pend.shape[0] < c_len + 1:
                self._pending_prefix = pend
                return
            init_fn(pend[:c_len] if c_len else None)
            self._pending_prefix = np.zeros((0, 2), self._wire_dtype)
            iq = pend[c_len:]
        s = getattr(self, attr)
        s["buf"].append(iq)
        s["buf_len"] += iq.shape[0]
        while s["buf_len"] >= self.block_size:
            buf = np.concatenate(s["buf"]) if len(s["buf"]) > 1 else s["buf"][0]
            block = buf[: self.block_size]
            rest = buf[self.block_size :]
            s["buf"] = [rest] if rest.shape[0] else []
            s["buf_len"] = rest.shape[0]
            yield block

    def _flush_unprimed(self) -> list:
        """Flush before the stream ever primed: error if data was pushed."""
        if self._pending_prefix.shape[0]:
            raise ValueError(
                f"capture shorter than the pipeline prefix "
                f"({self._pending_prefix.shape[0]} <= "
                f"{self.chain.carry_len} samples); nothing processed"
            )
        return [[] for _ in self.channels]

    def _tick(self, key: str, t0: float) -> float:
        """Accumulate host-blocked seconds into ``self.timing[key]``."""
        t1 = time.perf_counter()
        self.timing[key] = self.timing.get(key, 0.0) + (t1 - t0)
        return t1

    def _dispatch(self, block: np.ndarray, valid_n: int | None = None):
        import jax

        tm = self.timing
        if tm is not None:
            t0 = time.perf_counter()
        s = self._stream
        prog = self._program(block.shape[0])
        flat = np.ascontiguousarray(block).reshape(-1)
        if self._mp_time_sharding is not None:
            # multi-process time mesh: assemble a TIME-SHARDED global
            # array from this process's local spans only, so each host
            # uploads 1/P of the block instead of replicating it (the
            # multi-host ingest recipe: per-host spans over the network). A global array's semantics don't
            # depend on its sharding, so decode is unchanged.
            sh = self._mp_time_sharding
            imap = sh.devices_indices_map((flat.shape[0],))
            pieces = []
            for d in sh.addressable_devices:
                piece = flat[imap[d][0]]
                pieces.append(jax.device_put(piece, d))
                s["upload_elems"] += piece.shape[0]
                s["upload_bytes"] += piece.nbytes
            vals = jax.make_array_from_single_device_arrays(
                (flat.shape[0],), sh, pieces)
        elif self._mp_repl is not None:
            vals = jax.device_put(flat, self._mp_repl)
            s["upload_elems"] += flat.shape[0]
            s["upload_bytes"] += flat.nbytes
        else:
            vals = jax.device_put(flat, self._sp_time_sharding) \
                if self._sp_time_sharding is not None \
                else jax.device_put(flat)
            s["upload_elems"] += flat.shape[0]
            s["upload_bytes"] += flat.nbytes
        if tm is not None:
            t0 = self._tick("upload_s", t0)
        st = s["st"]
        chain_st, rs, dc, tails, outs = prog.fn(
            st["chain"], st["rs"], st["dc"], st["tails"], vals
        )
        if tm is not None:
            t0 = self._tick("dispatch_s", t0)
        s["st"] = {"chain": chain_st, "rs": rs, "dc": dc, "tails": tails}
        # start device->host copies now so they overlap the next block's
        # compute; by drain time np.asarray is (nearly) free. Hot groups
        # stream their whole payload; cold (idle) groups only the small
        # flags+tail head (egress gating).
        pack_out, raw_out = outs
        pre = {}
        for pgid, combined in pack_out.items():
            if s["hot"][pgid]:
                combined.copy_to_host_async()
                pre[pgid] = ("full", combined)
            else:
                head = combined[:, : prog.meta_bytes[pgid]]
                head.copy_to_host_async()
                pre[pgid] = ("head", head)
        for rows in raw_out.values():
            rows.copy_to_host_async()
        if tm is not None:
            self._tick("egress_start_s", t0)
        s["inflight"].append((prog, outs, pre, valid_n))

    def _valid_k(self, prog, i: int, valid_n: int | None) -> int:
        """Real (non-pad) output samples of channel ``i`` for a block whose
        first ``valid_n`` wideband samples are real."""
        if valid_n is None:
            return prog.k_out[i]
        k_chain = valid_n // self.chain.decimation
        gid = self._ratio_gid[i]
        if gid is None:
            return min(k_chain, prog.k_out[i])
        i_, d_ = gid
        return min(k_chain * i_ // d_, prog.k_out[i])

    def _drain(self, entry, new: list):
        tm = self.timing
        if tm is not None:
            t0 = time.perf_counter()
        prog, (pack_out, raw_out), pre, valid_n = entry
        raws = {rgid: np.asarray(rows) for rgid, rows in raw_out.items()}
        if tm is not None:
            t0 = self._tick("drain_wait_s", t0)

        s = self._stream
        s["blocks"] += 1
        for pgid, pg in self._pack_groups.items():
            mb = prog.meta_bytes[pgid]
            kind, arr = pre[pgid]
            if tm is not None:
                t0 = time.perf_counter()
            host = np.asarray(arr)
            if tm is not None:
                t0 = self._tick("drain_wait_s", t0)
            meta = host[:, :mb]
            flags = meta[:, 0].astype(bool)
            tail_cols = meta[:, 1:mb]
            pcm_kind = pg["kind"] == "pcm"
            is_gt = pg.get("is_gt")
            # rows needing a full fetch: flagged, or decoder mid-message,
            # or gating unsupported (no native FSM)
            need_rows = []
            for row, i in enumerate(pg["idx"]):
                dec = self._decoders[i]
                gate = getattr(dec, "supports_gating", False)
                if flags[row] or not gate or not dec.in_search:
                    need_rows.append(row)
            if need_rows:
                if kind == "full":
                    packed = host[np.asarray(need_rows), mb:]
                else:
                    # cold group turning active: fetch the WHOLE payload
                    # once and index on the host. A device-side gather
                    # (arr[rows, mb:]) compiles a fresh XLA executable per
                    # distinct row-count, and each uncached compile would
                    # stall live traffic crossing hot/cold transitions.
                    # The full d2h fetch is a few hundred KB and happens
                    # only on the (rare) cold->hot edge.
                    if tm is not None:
                        t0 = time.perf_counter()
                    full = np.asarray(pack_out[pgid])
                    packed = full[np.asarray(need_rows), mb:]
                    if tm is not None:
                        t0 = self._tick("drain_wait_s", t0)
            s["hot"][pgid] = bool(need_rows)
            # zero-history resampler transient (lead_drop) is consumed by
            # EVERY block's outputs, fetched or gated: a skipped block's
            # outputs contained the transient too, so the next fetched
            # block must not lose real samples to it
            ld0 = {i: s["lead_drop"].get(i, 0) for i in pg["idx"]}
            for row, i in enumerate(pg["idx"]):
                if ld0[i]:
                    vk = self._valid_k(prog, i, valid_n)
                    s["lead_drop"][i] = max(ld0[i] - vk, 0)
            if tm is not None:
                t0 = time.perf_counter()
            for j, row in enumerate(need_rows):
                i = pg["idx"][row]
                s["fetched"][i] += 1
                dec = self._decoders[i]
                vk = self._valid_k(prog, i, valid_n)
                if pcm_kind:
                    pcm = packed[j][:vk].astype(np.int16)
                else:
                    bits = np.unpackbits(packed[j])[:vk]
                    pcm = (np.where(bits, 1, -1) if is_gt
                           else np.where(bits, -1, 1)).astype(np.int16)
                if ld0[i]:
                    pcm = pcm[min(ld0[i], len(pcm)):]
                if s["gap"][i]:
                    dec.notify_gap()
                    tp = s["tail_pcm"][i]
                    if tp is not None:
                        pcm = np.concatenate([tp, pcm])
                    s["gap"][i] = False
                if tm is not None:
                    t0 = self._tick("unpack_s", t0)
                new[i].extend(dec.scan(pcm))
                if tm is not None:
                    t0 = self._tick("decode_s", t0)
            for row, i in enumerate(pg["idx"]):
                if row not in need_rows:
                    s["gap"][i] = True
                if pcm_kind:
                    tail = tail_cols[row].astype(np.int16)
                else:
                    tb = np.unpackbits(tail_cols[row])
                    tail = (
                        np.where(tb, 1, -1) if is_gt else np.where(tb, -1, 1)
                    ).astype(np.int16)
                if ld0[i]:
                    # the tail covers output positions [vk-T, vk); if the
                    # transient reaches into it, its head is fabricated
                    # zero-history samples the host oracle never sees
                    vk = self._valid_k(prog, i, valid_n)
                    cut = min(ld0[i], vk) - (vk - len(tail))
                    if cut > 0:
                        tail = tail[cut:]
                s["tail_pcm"][i] = tail

        for rgid, idxs in self._raw_groups.items():
            rows = raws[rgid]
            for j, i in enumerate(idxs):
                audio = np.asarray(rows[j]).astype(np.int16)[
                    : self._valid_k(prog, i, valid_n)]
                ld = s["lead_drop"].get(i, 0)
                if ld:
                    take = min(ld, len(audio))
                    audio = audio[take:]
                    s["lead_drop"][i] = ld - take
                dec = self._decoders[i]
                if tm is not None:
                    t0 = time.perf_counter()
                if dec is None:
                    new[i].append(audio)
                else:
                    new[i].extend(dec.scan(audio))
                if tm is not None:
                    t0 = self._tick("decode_s", t0)

    # -- bit-exact streaming engine ----------------------------------------
    #
    # The exact tier is the parity oracle: every stage already has a
    # bit-exact (state, block) step, so streaming is a host-coordinated
    # block loop — matmul FIR dispatched per block with the plane fetches
    # async and inflight_depth blocks in flight (the fetch RTT overlaps
    # the next blocks' device compute), then in dispatch order: host
    # derotate/round/LUT-FM -> per-ratio-group vmapped resampler scan
    # (ONE device round trip per group, not per channel) -> DC block ->
    # decoder scan, all carries threaded. No prefilter/gating (egress
    # stays at full PCM; bit-exactness is this tier's contract); output
    # is bit-identical to _process_capture_host at any push() split.

    def _xstream_init(self, prefix):
        from tsl_sdr_tpu.ops import dc_blocker as dcb

        if prefix is not None and self.wire_fmt != "cs16":
            prefix = self._widen_host(prefix)
        c = self.chain.nr_channels
        self._xstream = {
            "st": self.chain.init_state(prefix=prefix),
            "buf": [],
            "buf_len": 0,
            # FIR plane fetches in flight (see step_exact_packed_begin):
            # the device computes block k+1..k+depth while block k's
            # planes stream to the host — the fetch RTT stops gating e2e
            "fir_inflight": deque(),
            # the FM carry advances at END (host) time, in dispatch order
            "fm_last": np.zeros((c, 2), np.int32),
            # per-RATIO-GROUP resampler state/buffer: channels sharing a
            # ratio are in lockstep (same K per block, same carry_len), so
            # one vmapped device scan serves the whole group — one device
            # round trip per group per block instead of one per channel
            "g_rs_st": {gid: None for gid in self._rs_groups},
            "g_abuf": {gid: np.zeros((len(idxs), 0), np.int16)
                       for gid, idxs in self._rs_groups.items()},
            "dc_st": {i: dcb.init_dc_blocker_state()
                      for i, _ in self._dc_items},
        }
        if self.drain_async:
            # overlap the exact tier's END half (plane fetch wait + host
            # derotate/LUT-FM + resampler scans + decode) with the next
            # block's upload+FIR dispatch — the host end is most of this
            # tier's wall time; FIFO worker
            # preserves the fm carry's dispatch-order threading
            self._start_drain_worker(self._xstream, self._drain_exact_fir)

    def _push_exact(self, iq) -> list:
        new = [[] for _ in self.channels]
        tm = self.timing
        for block in self._pump_blocks(iq, "_xstream", self._xstream_init):
            x = self._xstream
            if tm is not None:
                t0 = time.perf_counter()
            # 8-bit wire blocks ship raw (2 B/sample) and widen in the
            # jitted dispatch's first stage — bit-identical to the host
            # rules (utils.iq.widen_iq_bytes), so the tier's parity
            # contract holds; only the tiny stream prefix widens on host
            x["st"], pending = self.chain.step_exact_packed_begin(
                x["st"], block, wire_fmt=self.wire_fmt)
            if tm is not None:
                self._tick("dispatch_s", t0)
            x["fir_inflight"].append(pending)
            while len(x["fir_inflight"]) > self.inflight_depth:
                self._drain_entry(x, x["fir_inflight"].popleft(), new,
                                  self._drain_exact_fir)
        return new

    def _drain_exact_fir(self, pending, new: list):
        """Finish one in-flight exact FIR block (host derotate/round/FM,
        FM carry threaded in dispatch order) and run the back half."""
        x = self._xstream
        tm = self.timing
        if tm is not None:
            t0 = time.perf_counter()
        x["fm_last"], pcm = self.chain.step_exact_packed_end(
            x["fm_last"], pending)
        if tm is not None:
            self._tick("fir_end_s", t0)
        self._drain_exact(pcm, new)

    def _gid_chain(self, gid):
        """The (shared-taps) ResamplerChain for a ratio group."""
        return self._resamplers[self._rs_groups[gid][0]]

    def _stack_rs_states(self, gid, prefixes: np.ndarray):
        """Head-prime every channel of a ratio group from its [G, c_len]
        prefix rows; returns the stacked (leading G axis) state pytree."""
        import jax
        import jax.numpy as jnp

        rs = self._gid_chain(gid)
        states = [rs.init_state(prefix=prefixes[j])
                  for j in range(prefixes.shape[0])]
        return jax.tree.map(lambda *ls: jnp.stack(ls), *states)

    def _exact_gscan(self, gid):
        """jit(vmap(scan)) over a ratio group: [G, chunks, block_in] int16
        -> [G, chunks, block_out], states carried per row. Bit-identical
        to per-channel scans (integer ops; vmap only batches them)."""
        import jax

        fns = getattr(self, "_exact_gscan_fns", None)
        if fns is None:
            fns = self._exact_gscan_fns = {}
        if gid not in fns:
            rs = self._gid_chain(gid)
            fns[gid] = jax.jit(jax.vmap(rs.scan_fn))
        return fns[gid]

    def _drain_exact(self, pcm: np.ndarray, new: list):
        import jax.numpy as jnp

        x = self._xstream
        pcm = np.asarray(pcm, np.int16)
        audio = {}
        for i, spec in enumerate(self.channels):
            a = pcm[i]
            if spec.invert:
                a = np.clip(
                    -(a.astype(np.int32)), -32768, 32767
                ).astype(np.int16)
            audio[i] = a
        for gid, idxs in self._rs_groups.items():
            rows = np.stack([audio[i] for i in idxs])  # [G, K]
            buf = (np.concatenate([x["g_abuf"][gid], rows], axis=1)
                   if x["g_abuf"][gid].shape[1] else rows)
            rs = self._gid_chain(gid)
            if x["g_rs_st"][gid] is None:
                c_len = rs.plan.carry_len
                if buf.shape[1] < c_len + 1:
                    x["g_abuf"][gid] = buf
                    continue
                x["g_rs_st"][gid] = self._stack_rs_states(gid,
                                                          buf[:, :c_len])
                buf = buf[:, c_len:]
            n_in = rs.plan.block_in
            chunks = buf.shape[1] // n_in
            if chunks:
                tm = self.timing
                if tm is not None:
                    t0 = time.perf_counter()
                st, out = self._exact_gscan(gid)(
                    x["g_rs_st"][gid],
                    jnp.asarray(buf[:, : chunks * n_in]
                                .reshape(len(idxs), chunks, n_in)),
                )
                x["g_rs_st"][gid] = st
                outs = np.asarray(out).reshape(len(idxs), -1)
                buf = buf[:, chunks * n_in:]
                if tm is not None:
                    self._tick("rs_s", t0)
            else:
                outs = np.zeros((len(idxs), 0), np.int16)
            x["g_abuf"][gid] = buf
            for j, i in enumerate(idxs):
                self._exact_channel_out(i, outs[j], new)
        for i in range(len(self.channels)):
            if self._ratio_gid[i] is None:
                self._exact_channel_out(i, audio[i], new)

    def _exact_channel_out(self, i: int, audio: np.ndarray, new: list):
        """Post-resampler per-channel stages: DC block -> decode/collect."""
        from tsl_sdr_tpu.ops import dc_blocker as dcb

        if audio.size == 0:
            return
        x = self._xstream
        spec = self.channels[i]
        if spec.dc_block:
            p = dcb.make_pole_coeff(spec.dc_block_pole)
            x["dc_st"][i], audio = dcb.dc_blocker_step_exact(
                x["dc_st"][i], audio, p
            )
            audio = np.asarray(audio)
        tm = self.timing
        if tm is not None:
            t0 = time.perf_counter()
        dec = self._decoders[i]
        if dec is None:
            new[i].append(np.asarray(audio, np.int16))
        else:
            new[i].extend(dec.scan(np.asarray(audio)))
        if tm is not None:
            self._tick("decode_s", t0)

    def _flush_exact(self) -> list:
        import jax

        x = self._xstream
        if x is None:
            return self._flush_unprimed()
        new = [[] for _ in self.channels]
        # drain the in-flight FIR blocks first: the tail block's END needs
        # the current FM carry, which only advances at drain time (the
        # barrier also quiesces the async worker before the tail legs
        # touch fm_last / the resampler group state)
        while x["fir_inflight"]:
            self._drain_entry(x, x["fir_inflight"].popleft(), new,
                              self._drain_exact_fir)
        self._drain_barrier(x, new)
        if x["buf_len"]:
            buf = np.concatenate(x["buf"]) if len(x["buf"]) > 1 else x["buf"][0]
            q = self.chain.block_quantum
            usable = buf.shape[0] // q * q
            if usable:
                x["st"], pending = self.chain.step_exact_packed_begin(
                    x["st"], self._widen_host(buf[:usable]))
                self._drain_exact_fir(pending, new)
            x["buf"] = []
            x["buf_len"] = 0
        # sub-block_in resampler tails: one shorter-plan step per channel,
        # chained through the live carry (same taps/phase0 => same
        # carry_len); group states are sliced back to per-channel rows
        for gid, idxs in self._rs_groups.items():
            rs = self._gid_chain(gid)
            buf = x["g_abuf"][gid]
            st_g = x["g_rs_st"][gid]
            if st_g is None:
                c_len = rs.plan.carry_len
                if buf.shape[1] < c_len + 1:
                    continue
                st_g = self._stack_rs_states(gid, buf[:, :c_len])
                buf = buf[:, c_len:]
            tail_use = buf.shape[1] // rs.plan.d_rep * rs.plan.d_rep
            if not tail_use:
                continue
            tp = rs._tail_plan(tail_use)
            assert tp.carry_len == rs.plan.carry_len, (tp.carry_len,
                                                       rs.plan.carry_len)
            for j, i in enumerate(idxs):
                st_j = jax.tree.map(lambda a, _j=j: a[_j], st_g)
                _, out = rs.step(st_j, buf[j, :tail_use], plan=tp)
                self._exact_channel_out(i, np.asarray(out).reshape(-1), new)
        # the stream consumed off-grid residue; a later push must re-prime
        self.stream_reset()
        return new

    def flush(self) -> list:
        """Drain in-flight blocks and process the buffered tail.

        The tail is zero-padded up to the FULL block size — reusing the
        already-compiled fused program (a fresh tail-sized program would
        cost a 30-160 s first compile per distinct capture length) — and
        the pad-derived output samples are trimmed before any decoder or
        pcm channel sees them (a truncated stream ends at its last real
        sample, exactly as the reference's file source reads EOF)."""
        if self.chain.exact:
            return self._flush_exact()
        s = self._stream
        if s is None:
            return self._flush_unprimed()
        new = [[] for _ in self.channels]
        padded = False
        if s["buf_len"]:
            valid = s["buf_len"]
            buf = np.concatenate(s["buf"]) if len(s["buf"]) > 1 else s["buf"][0]
            # pad with the wire format's zero-level value (127 for the
            # unsigned 8-bit formats: it widens to PCM 0 on device, so a
            # truncated capture ends in silence exactly like cs16's 0s)
            block = np.full((self.block_size, 2), self._wire_zero,
                            self._wire_dtype)
            block[:valid] = buf
            s["buf"] = []
            s["buf_len"] = 0
            self._dispatch(block, valid_n=valid)
            padded = True
        while s["inflight"]:
            self._drain_entry(s, s["inflight"].popleft(), new, self._drain)
        self._drain_barrier(s, new)
        if padded:
            # the device carries have consumed fabricated pad zeros; a
            # later push() must not splice real samples onto that history
            self._last_stream_stats = self.stream_stats
            self.stream_reset()
        return new

    def warm_device(self) -> float:
        """Pre-pay this process's device startup costs on throwaway zeros.

        A fresh process's first block compiles the fused program (or loads
        it from the persistent cache) and pays the device's first-transfer
        set-up. Run one full streaming block —
        dispatch, padded-tail flush (the checkpoint path's program) and
        fetch — BEFORE live data flows, so that cost lands in startup,
        not on live traffic queued behind it. Stream state and decoders
        end untouched (the zeros block is silence: every decoder stays
        in SEARCH and the stream is reset afterwards). No-op on an
        already-primed stream. Returns wall seconds spent."""
        if (self._stream is not None or self._xstream is not None
                or self._pending_prefix.shape[0]):
            return 0.0
        t0 = time.monotonic()
        n = self.chain.carry_len + self.block_size + 1024
        zeros = np.full((n, 2), self._wire_zero, self._wire_dtype)
        self.push(zeros)
        self.flush()  # drains in-flight AND compiles the padded-tail path
        self.stream_reset()
        self._last_stream_stats = None
        return time.monotonic() - t0

    # -- streaming checkpoint/resume ----------------------------------------

    def checkpoint_stream(self, path, user_meta: dict | None = None) -> list:
        """Drain in-flight device blocks and save the streaming state to
        ``path`` (.npz): device carries (channelizer history, resampler
        phases, DC poles, prefilter tail bits) plus the host gating state
        and buffered input. Returns the messages decoded while draining.

        Decoder FSMs are NOT serialized (the native machines live in
        C++); :meth:`restore_stream` re-enters them in SEARCH with a gap
        notification — a burst mid-flight across the boundary is lost,
        everything after re-syncs (the protocols are self-synchronizing,
        matching the reference's restart-from-live-stream behavior).
        Production tier only; the bit-exact tier is a parity oracle, not
        a deployment path."""
        import jax
        import json

        if self.chain.exact:
            raise NotImplementedError(
                "checkpoint_stream covers the production streaming engine"
            )
        if self._mp_repl is not None:
            raise NotImplementedError(
                "checkpoint_stream is single-process; multi-process "
                "deployments checkpoint their input feed per host"
            )
        s = self._stream
        if s is None:
            raise ValueError("no streaming state yet (push something first)")
        new = [[] for _ in self.channels]
        while s["inflight"]:
            self._drain_entry(s, s["inflight"].popleft(), new, self._drain)
        self._drain_barrier(s, new)
        leaves, treedef = jax.tree.flatten(s["st"])
        arrays = {f"leaf_{i}": np.asarray(v) for i, v in enumerate(leaves)}
        arrays["buf"] = (
            np.concatenate(s["buf"]) if s["buf"]
            else np.zeros((0, 2), self._wire_dtype)
        )
        arrays["fetched"] = s["fetched"]
        tail_rows = {}
        for i, tp in s["tail_pcm"].items():
            if tp is not None:
                arrays[f"tailpcm_{i}"] = tp
                tail_rows[i] = True
        meta = {
            "fingerprint": self._stream_fingerprint(),
            "treedef": str(treedef),
            "lead_drop": {str(k): int(v)
                          for k, v in s["lead_drop"].items()},
            "gap": {str(k): bool(v) for k, v in s["gap"].items()},
            "hot": {str(k): bool(v) for k, v in s["hot"].items()},
            "blocks": s["blocks"],
            "tail_rows": {str(k): v for k, v in tail_rows.items()},
            "user": user_meta or {},
        }
        arrays["__meta__"] = np.frombuffer(
            json.dumps(meta).encode(), dtype=np.uint8
        )
        # atomic replace + fsync: a crash (or a service manager's SIGKILL
        # after the grace period) mid-save must not leave a truncated .npz
        # that makes every subsequent --state-file start crash, and the
        # data must be durable before the old checkpoint is unlinked
        # (os.replace alone is not crash-safe against power loss)
        import os
        tmp = f"{path}.tmp"
        with open(tmp, "wb") as f:
            np.savez(f, **arrays)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        return new

    def restore_stream(self, path) -> dict:
        """Rebuild streaming state from a :meth:`checkpoint_stream` file.
        Returns the ``user_meta`` dict the checkpoint was saved with.

        The pipeline must be configured identically (same channels,
        block size, tier) — a mismatch raises. Decoders restart in
        SEARCH; every pack channel is marked gapped so the first fetched
        block splices the checkpointed tail PCM and notifies the gap."""
        import jax
        import json

        if self.chain.exact:
            raise NotImplementedError(
                "checkpoint_stream covers the production streaming engine"
            )
        data = np.load(path)
        meta = json.loads(bytes(data["__meta__"]).decode())
        if meta["fingerprint"] != self._stream_fingerprint():
            raise ValueError(
                "checkpoint was written by a differently-configured "
                f"pipeline: {meta['fingerprint']} != "
                f"{self._stream_fingerprint()}"
            )
        self.stream_reset()
        self._stream_init(None)
        s = self._stream
        leaves, treedef = jax.tree.flatten(s["st"])
        if meta["treedef"] != str(treedef):
            raise ValueError("checkpoint state tree mismatch")
        restored = []
        for i, tmpl in enumerate(leaves):
            arr = data[f"leaf_{i}"]
            # compare METADATA only — np.asarray(tmpl) here would fetch
            # every device leaf to the host just to read .shape/.dtype
            if arr.shape != tuple(tmpl.shape) or arr.dtype != tmpl.dtype:
                raise ValueError(
                    f"checkpoint leaf {i} is {arr.dtype}{arr.shape}, "
                    f"pipeline expects {tmpl.dtype}{tmpl.shape}"
                )
            restored.append(jax.device_put(arr))
        s["st"] = jax.tree.unflatten(treedef, restored)
        buf = data["buf"]
        s["buf"] = [buf] if buf.shape[0] else []
        s["buf_len"] = int(buf.shape[0])
        s["lead_drop"] = {int(k): int(v)
                          for k, v in meta["lead_drop"].items()}
        s["hot"] = dict(meta["hot"])
        s["blocks"] = int(meta["blocks"])
        s["fetched"] = np.asarray(data["fetched"])
        # decoder FSMs were not saved: recreate them so they really DO
        # restart in SEARCH (an in-process restore would otherwise keep a
        # live mid-message FSM, and notify_gap() below is only valid in
        # SEARCH), then force a gap + tail splice on every pack channel's
        # next fetched block
        for i, spec in enumerate(self.channels):
            if self._decoders[i] is not None:
                self._decoders[i] = _make_decoder(
                    spec.protocol, spec.center_freq_hz,
                    self._ais_packet_hook,
                )
        for i in s["gap"]:
            s["gap"][i] = True
            s["tail_pcm"][i] = (
                data[f"tailpcm_{i}"]
                if meta["tail_rows"].get(str(i)) else None
            )
        return meta.get("user", {})

    def _stream_fingerprint(self) -> str:
        """Every compile-time constant that changes decode semantics must
        appear here — carries restored under different filter/gain/rate
        constants would decode wrongly with no error (state-leaf shape
        checks cannot catch same-shape config edits like dcBlockPole)."""
        import zlib
        taps_crc = zlib.crc32(self._fp_taps.tobytes())
        return (
            f"bs={self.block_size};"
            f"fc={self._fp_center};fs={self.chain.sample_rate:.6f};"
            f"decim={self.chain.decimation};taps={taps_crc:08x};"
            # wire format changes the meaning of the buffered input bytes
            # (cs16 omitted so pre-wire checkpoints stay restorable)
            + (f"wire={self.wire_fmt};" if self.wire_fmt != "cs16" else "")
            + ";".join(
                f"{s.center_freq_hz}:{s.protocol}:{int(s.invert)}:"
                f"{int(s.dc_block)}:{s.dc_block_pole!r}:{s.db_gain!r}"
                for s in self.channels
            )
        )

    # -- whole-capture API ---------------------------------------------------

    def process_capture(self, iq, *, device_decode: bool = True):
        """Run a whole capture. Returns a list (one entry per channel) of
        decoded message lists, or the raw int16 PCM for ``pcm`` channels.

        Production tier with ``device_decode`` (default) routes through the
        fused streaming engine (:meth:`push`/:meth:`flush`) — single fused
        dispatch per block, candidate-gated egress. ``device_decode=False``
        keeps the reference-shaped host path; the bit-exact tier always
        uses it."""
        if device_decode and not self.chain.exact:
            self.stream_reset()
            results = self.push(iq)
            for i, part in enumerate(self.flush()):
                results[i].extend(part)
            for i, spec in enumerate(self.channels):
                if spec.protocol == "pcm":
                    results[i] = (
                        np.concatenate(results[i]) if results[i]
                        else np.zeros(0, np.int16)
                    )
            return results
        return self._process_capture_host(iq, device_decode=device_decode)

    def _process_capture_host(self, iq, *, device_decode: bool = False):
        """Stage-by-stage path (host arrays between stages). The bit-exact
        tier and the reference-shaped oracle for the fused engine."""
        import jax.numpy as jnp

        if self.wire_fmt != "cs16":
            iq = self._widen_host(self._coerce_wire(iq))
        if device_decode:
            pcm = self.chain.process_array_device(np.asarray(iq, np.int16))
        else:
            pcm = self.chain.process_array(np.asarray(iq, np.int16))

        audios = []
        for i, spec in enumerate(self.channels):
            audio = pcm[i]
            xp = jnp if device_decode else np
            if spec.invert:
                audio = xp.clip(
                    -(audio.astype(xp.int32)), -32768, 32767
                ).astype(xp.int16)
            rs = self._resamplers[i]
            if rs is not None:
                if device_decode:
                    audio = rs.process_array_device(audio)
                else:
                    audio = rs.process_array(audio)
            if spec.dc_block:
                from tsl_sdr_tpu.ops import dc_blocker as dcb

                st = dcb.init_dc_blocker_state()
                p = dcb.make_pole_coeff(spec.dc_block_pole)
                _, audio = dcb.dc_blocker_step_exact(st, audio, p)
                if not device_decode:
                    audio = np.asarray(audio)
            audios.append(audio)

        results = []
        for i, spec in enumerate(self.channels):
            audio = np.asarray(audios[i])
            dec = self._decoders[i]
            if dec is None:
                results.append(audio.astype(np.int16))
            elif hasattr(dec, "scan"):
                results.append(dec.scan(audio))
            else:
                results.append(dec.on_pcm(audio))
        return results
