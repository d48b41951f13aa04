"""8-bit wire-format ingest: raw wire bytes upload at 2 B/sample and
widen in the fused device program's first stage (ReceivePipeline
``wire_fmt``), bit-identical to the host rules in utils.iq.widen_iq_bytes
(reference ``multifm/rtl_sdr_if.c:118-147`` for rtl_u8's ``(s-127)<<7``
and ``multifm/file_if.c:85-157`` for cs8/cu8's int8-bounce quirk).

Every test compares the wire path against the SAME pipeline fed the
host-widened int16 capture — outputs must be exactly equal (messages and
raw PCM), for every format, on both tiers, at any push() split.
"""

import numpy as np
import pytest

from tsl_sdr_tpu.models.pipeline import ChannelSpec, ReceivePipeline
from tsl_sdr_tpu.testing import pocsag_gen
from tsl_sdr_tpu.utils import iq as iqio
from tsl_sdr_tpu.utils.filter_design import firdes_low_pass

from tests.test_pipeline import _fm_mod

DECIM = 32
FS = 38400 * DECIM
CENTER = 929_500_000
ALL_8BIT = ["cs8", "cu8", "cu8_unbiased", "rtl_u8"]


def _analog(seed=5):
    """A POCSAG burst at +250 kHz plus noise, as float64 [N, 2]."""
    bb = pocsag_gen.generate(
        [pocsag_gen.PocsagBurst(capcode=777001, function=1, kind="alpha",
                                content="WIRE FMT")],
        baud=1200, amplitude=4096, tail_bits=256)
    sig = _fm_mod(bb, 38400, 250_000, FS, amp=6000)
    n = len(sig) + 300_000
    x = np.zeros((n, 2))
    x[150_000:150_000 + len(sig)] += sig
    rng = np.random.default_rng(seed)
    # length deliberately NOT a multiple of any block quantum so flush()
    # exercises the wire-zero pad path
    return (x + rng.normal(scale=90, size=x.shape))[: n - 12345]


def _wire_bytes(x, fmt) -> np.ndarray:
    """Quantize an analog capture to format ``fmt``'s raw wire bytes such
    that host widening reproduces a valid signal (where the format's
    range allows)."""
    if fmt == "rtl_u8":
        return np.clip(np.round(x / 128.0) + 127, 0, 255) \
            .astype(np.uint8).reshape(-1)
    if fmt == "cu8_unbiased":
        return np.clip(np.round(x / 64.0) + 127, 0, 255) \
            .astype(np.uint8).reshape(-1)
    if fmt == "cs8":
        return np.clip(np.round(x / 64.0), -128, 127) \
            .astype(np.int8).reshape(-1).view(np.uint8)
    if fmt == "cu8":
        # the reference quirk maps every byte to [-255, 0]; a decodable
        # signal is impossible — random bytes still must match the host
        # oracle exactly
        rng = np.random.default_rng(11)
        return rng.integers(0, 256, size=x.size, dtype=np.int64) \
            .astype(np.uint8)
    raise AssertionError(fmt)


def _lpf():
    return firdes_low_pass(1.0, FS, 12_000, 8_000)


def _specs():
    return [ChannelSpec(CENTER + 250_000, "pocsag", dc_block=True),
            ChannelSpec(CENTER - 150_000, "pcm")]


def _pipe(fmt="cs16", exact=False, block=262_144):
    return ReceivePipeline(_lpf(), CENTER, FS, DECIM, _specs(),
                           exact=exact, block_size=block, wire_fmt=fmt)


def _run(pipe, data):
    res = pipe.process_capture(data)
    msgs = [(m.capcode, bytes(m.data)) for m in res[0]]
    return msgs, np.asarray(res[1])


@pytest.mark.parametrize("fmt", ALL_8BIT)
def test_wire_equals_host_widened(fmt):
    raw = _wire_bytes(_analog(), fmt)
    widened = iqio.widen_iq_bytes(raw, fmt).reshape(-1, 2)

    msgs_ref, pcm_ref = _run(_pipe("cs16"), widened)
    msgs_wire, pcm_wire = _run(_pipe(fmt), raw)

    assert msgs_wire == msgs_ref
    np.testing.assert_array_equal(pcm_wire, pcm_ref)
    if fmt != "cu8":  # cu8's quirk range cannot carry a signal
        assert any(c == 777001 for c, _ in msgs_wire), msgs_wire


def test_wire_exact_tier_rtl_u8():
    raw = _wire_bytes(_analog(), "rtl_u8")
    widened = iqio.widen_iq_bytes(raw, "rtl_u8").reshape(-1, 2)

    msgs_ref, pcm_ref = _run(_pipe("cs16", exact=True), widened)
    msgs_wire, pcm_wire = _run(_pipe("rtl_u8", exact=True), raw)

    assert msgs_wire == msgs_ref
    assert any(c == 777001 for c, _ in msgs_wire), msgs_wire
    np.testing.assert_array_equal(pcm_wire, pcm_ref)


@pytest.mark.parametrize("fmt", ALL_8BIT)
def test_wire_exact_streaming_on_device_widen(fmt):
    """The bit-exact STREAMING engine ships raw wire blocks and widens in
    the jitted matmul dispatch's first stage (channelizer
    ``_exact_packed_fir_wire``); output must equal the same stream pushed
    as host-widened cs16, bit-for-bit, including the wire-zero padded
    flush tail."""
    raw = _wire_bytes(_analog(), fmt)
    widened = iqio.widen_iq_bytes(raw, fmt).reshape(-1, 2)

    def _stream(pipe, data):
        msgs, pcm_parts = [], []
        got = pipe.push(data)
        msgs += [(m.capcode, bytes(m.data)) for m in got[0]]
        pcm_parts += got[1]
        got = pipe.flush()
        msgs += [(m.capcode, bytes(m.data)) for m in got[0]]
        pcm_parts += got[1]
        return msgs, (np.concatenate(pcm_parts) if pcm_parts
                      else np.zeros(0, np.int16))

    msgs_ref, pcm_ref = _stream(_pipe("cs16", exact=True), widened)
    msgs_wire, pcm_wire = _stream(_pipe(fmt, exact=True), raw)

    assert msgs_wire == msgs_ref
    np.testing.assert_array_equal(pcm_wire, pcm_ref)
    if fmt != "cu8":
        assert any(c == 777001 for c, _ in msgs_wire), msgs_wire


def test_wire_push_split_invariance():
    """Raw bytes fed in arbitrary-size push() slices (always whole
    samples = even byte counts) decode identically to one call."""
    raw = _wire_bytes(_analog(), "rtl_u8")
    want_msgs, want_pcm = _run(_pipe("rtl_u8"), raw)

    pipe = _pipe("rtl_u8")
    rng = np.random.default_rng(3)
    msgs, pcm_parts = [], []
    i = 0
    while i < len(raw):
        ln = int(rng.integers(30_000, 300_000)) * 2
        got = pipe.push(raw[i: i + ln])
        msgs += [(m.capcode, bytes(m.data)) for m in got[0]]
        pcm_parts += got[1]
        i += ln
    got = pipe.flush()
    msgs += [(m.capcode, bytes(m.data)) for m in got[0]]
    pcm_parts += got[1]

    assert msgs == want_msgs
    np.testing.assert_array_equal(np.concatenate(pcm_parts), want_pcm)


def test_wire_accepts_plain_bytes():
    """push()/process_capture take Python bytes objects directly (the
    shape a FIFO read hands over)."""
    raw = _wire_bytes(_analog(), "rtl_u8")
    want_msgs, want_pcm = _run(_pipe("rtl_u8"), raw)
    msgs, pcm = _run(_pipe("rtl_u8"), raw.tobytes())
    assert msgs == want_msgs
    np.testing.assert_array_equal(pcm, want_pcm)


def test_wire_fmt_changes_checkpoint_fingerprint():
    a = _pipe("cs16")
    b = _pipe("rtl_u8")
    assert a._stream_fingerprint() != b._stream_fingerprint()


def test_unknown_wire_fmt_rejected():
    with pytest.raises(ValueError, match="wire_fmt"):
        _pipe("u16")
