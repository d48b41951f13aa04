"""Device-side sync-candidate prefilters for egress gating.

Device form of the host prefilters in ``models/pocsag.py`` (scan(): any
32-bit phase-interleaved slicer register within hamming 4 of the POCSAG
sync word ``pager_pocsag.c:298-334``) and ``models/ais.py`` (scan(): NRZI
register within hamming 2 of the AIS preamble ``ais_demod.c:114-213``;
plus FLEX's exact-BS1 SYNC_1 hunt, ``pager_flex.c``) — POCSAG/AIS
tightened one step: those decoders' sync triggers need a RUN of matching
positions (POCSAG: > spb/2 consecutive eye matches; AIS: >= 3 of 5 phase
registers), so a true trigger always yields two matches a fixed distance
apart and requiring the pair keeps the strict-superset property while
dropping the single-position false-positive rate from ~1e-5 to ~1e-10
per probe. A block whose prefilter raises no flag provably contains no
sync start — its sign bits never need to leave the device (VERDICT r2
item 1: egress only candidate flags + the packed bits of flagged
channels).

Shape discipline: registers are evaluated at EVERY position via 32
unit-stride shifted slices (never a strided slice or gather — those are
slow on the device); the extra positions vs the host's stride grid are
free on the VPU and only widen the superset.

All inputs are ``[C, T + K]`` bit planes (channels x time, oldest first):
``T`` carried tail bits from the previous block so registers (and match
runs) straddling the block boundary are still tested, ``K`` new positions
to test.
"""

from __future__ import annotations

import jax.numpy as jnp

POCSAG_SYNC = 0x7CD215D8     # pager_pocsag.c SYNC_CODEWORD
POCSAG_SPBS = (75, 32, 16)   # 38400 Hz / {512, 1200, 2400} baud
POCSAG_MAX_HAM = 4
# carried-tail bits: >= 31*spb_max register span + pair margin + the
# 34*spb_max feed lookback the host uses, rounded to a byte multiple
POCSAG_TAIL = 2560

AIS_PREAMBLE = 0x5555557E    # ais_demod.c preamble (HDLC flag tail)
AIS_DECIM = 5                # 48 kHz / 9600 bps
AIS_MAX_HAM = 2
AIS_TAIL = 256

FLEX_BS1 = 0xAAAAAAAA        # pager_flex.c SYNC_1 bit-sync pattern
FLEX_SPB = 10                # 16 kHz / 1600 bps SYNC_1 (pager_flex.c)
# carried-tail SAMPLES (FLEX's gated payload is int16 PCM, so tail bits
# and tail samples coincide): >= the 31*10 register span, and >= the
# 34*10 pre-candidate lookback margin the numpy scan tier would need
FLEX_TAIL = 384


def _popcount32(v):
    v = v - ((v >> 1) & jnp.uint32(0x55555555))
    v = (v & jnp.uint32(0x33333333)) + ((v >> 2) & jnp.uint32(0x33333333))
    v = (v + (v >> 4)) & jnp.uint32(0x0F0F0F0F)
    return (v * jnp.uint32(0x01010101)) >> jnp.uint32(24)


def _matches(bits, start: int, span: int, spb: int, word: int,
             max_ham: int):
    """[C, span] bool: is the 32-tap register ending at positions
    ``start .. start+span`` within ``max_ham`` of ``word``? Register bit k
    at position p = bits[p - k*spb]. All unit-stride slices."""
    assert start >= 31 * spb, (start, spb)
    w = jnp.zeros((bits.shape[0], span), jnp.uint32)
    for k in range(32):
        s0 = start - k * spb
        w = w | (jnp.asarray(bits[:, s0 : s0 + span], jnp.uint32)
                 << jnp.uint32(k))
    return _popcount32(w ^ jnp.uint32(word)) <= max_ham


def pocsag_any_candidate(pred, k_new: int):
    """``pred`` [C, T+K] = (pcm < 0) bits. Returns [C] bool — possible
    sync trigger in the block's new span, any of the three bauds.

    A POCSAG trigger needs > spb/2 consecutive samples whose register is
    within hamming 4 (pager_pocsag.c eye counter), i.e. a run of >=
    spb/2 + 1 matching positions — which always contains a pair at
    distance spb//4, so the pair test is a strict superset of the
    trigger.

    Boundary case: the FSM fires on the first NON-matching sample after
    the run, so a run ending exactly at the last OLD-span sample triggers
    on the new span's first sample while every matching position sits in
    the old span. The pair span therefore starts one position earlier
    (t - d - 1) so a pair whose later element is the final old-span
    position still flags this block; runs ending before that were already
    flagged when their positions were a previous block's new span."""
    t = pred.shape[1] - k_new
    flag = jnp.zeros((pred.shape[0],), bool)
    for spb in POCSAG_SPBS:
        d = max(1, spb // 4)
        m = _matches(pred, t - d - 1, k_new + d + 1, spb, POCSAG_SYNC,
                     POCSAG_MAX_HAM)
        flag = flag | (m[:, :-d] & m[:, d:]).any(axis=1)
    return flag


def flex_any_candidate(pred, k_new: int):
    """``pred`` [C, T+K] = (pcm >= 0) bits (the SYNC_1 2FSK slice,
    ``models/flex.py _slice_2fsk``; ``pager_flex.c`` 2FSK sample slicer).

    A FLEX SYNC_1 trigger is IMMEDIATE and EXACT: the FSM leaves
    SEARCH_BS1 the moment one of its ten phase-staggered 32-bit slicer
    registers equals BS1 ``0xAAAAAAAA`` (``models/flex.py _sync_update``),
    so the device probe is an exact register match at EVERY position of
    the new span — the ten phase registers collectively test each sample
    exactly once, and the all-positions probe is their strict superset.
    No run/pair test applies (unlike POCSAG there is no deferred "first
    non-matching sample" trigger; mid-BS1 runs straddling a boundary are
    vetoed host-side by ``FlexDecoder.in_search``). A partially refilled
    register can never alias to a match (BS1's top bit is 1, zero
    backfill pins it 0), so the carried tail only needs the 31*10-sample
    register span."""
    t = pred.shape[1] - k_new
    m = _matches(pred, t, k_new, FLEX_SPB, FLEX_BS1, 0)
    return m.any(axis=1)


def ais_any_candidate(pred, k_new: int):
    """``pred`` [C, T+K] = (pcm > 0) bits. NRZI-decodes then tests the
    preamble registers: an AIS trigger needs >= 3 of the 5 phase
    registers within hamming 2 — 3 matching positions inside a 5-sample
    window — so two matches within distance 4 is a strict superset of
    the trigger."""
    p = jnp.asarray(pred, jnp.uint8)
    nrzi = jnp.zeros_like(p)
    nrzi = nrzi.at[:, AIS_DECIM:].set(
        1 - (p[:, AIS_DECIM:] ^ p[:, :-AIS_DECIM])
    )
    t = pred.shape[1] - k_new
    margin = AIS_DECIM - 1
    m = _matches(nrzi, t - margin, k_new + margin, AIS_DECIM,
                 AIS_PREAMBLE, AIS_MAX_HAM)
    flag = jnp.zeros((p.shape[0],), bool)
    for d in range(1, AIS_DECIM):
        flag = flag | (m[:, :-d] & m[:, d:]).any(axis=1)
    return flag
