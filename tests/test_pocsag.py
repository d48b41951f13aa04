import numpy as np
import pytest

from tsl_sdr_tpu.models.bch import pocsag_bch
from tsl_sdr_tpu.models.pocsag import PocsagDecoder, IDLE_CODEWORD
from tsl_sdr_tpu.testing import pocsag_gen as gen


@pytest.fixture(scope="module")
def bch():
    return pocsag_bch()


class TestBch:
    def test_generator_polynomial_is_pocsag_standard(self, bch):
        # x^10+x^9+x^8+x^6+x^5+x^3+1
        np.testing.assert_array_equal(bch.g, [1, 0, 0, 1, 0, 1, 1, 0, 1, 1, 1])

    def test_idle_codeword_is_clean(self, bch):
        c, f = bch.decode_one(IDLE_CODEWORD)
        assert c == IDLE_CODEWORD and not f

    def test_roundtrip_and_correction(self, bch):
        rng = np.random.default_rng(0)
        data = rng.integers(0, 1 << 21, size=500).astype(np.uint64)
        words = bch.encode(data).astype(np.uint32)
        c, f = bch.decode(words)
        assert (c == words).all() and not f.any()
        for nerr in (1, 2):
            w2 = words.copy()
            for i in range(len(w2)):
                for p in rng.choice(31, size=nerr, replace=False):
                    w2[i] ^= np.uint32(1 << p)
            c, f = bch.decode(w2)
            assert (c == words).all() and not f.any(), f"{nerr} errors"

    def test_three_errors_mostly_rejected(self, bch):
        rng = np.random.default_rng(1)
        data = rng.integers(0, 1 << 21, size=500).astype(np.uint64)
        words = bch.encode(data).astype(np.uint32)
        w3 = words.copy()
        for i in range(len(w3)):
            for p in rng.choice(31, size=3, replace=False):
                w3[i] ^= np.uint32(1 << p)
        c, f = bch.decode(w3)
        assert f.mean() > 0.4  # t=2 code: beyond-capability words detected


BURSTS = [
    gen.PocsagBurst(capcode=1234567, function=2, kind="alpha", content="HELLO WORLD"),
    gen.PocsagBurst(capcode=999, function=0, kind="numeric", content="0123456789-42"),
    gen.PocsagBurst(capcode=42, function=3, kind="alpha", content="Pager test 123\x04"),
]


def _expected(b: gen.PocsagBurst):
    if b.kind == "alpha":
        content = b.content if isinstance(b.content, bytes) else b.content.encode()
        return (b.capcode, b.function, "alpha", gen.expected_alpha_decode(content))
    return (
        b.capcode,
        b.function,
        "numeric",
        gen.expected_numeric_decode(b.content).encode(),
    )


class TestPocsagWire:
    @pytest.mark.parametrize("baud", [512, 1200, 2400])
    def test_roundtrip(self, baud):
        pcm = gen.generate(BURSTS, baud=baud)
        msgs = PocsagDecoder().on_pcm(pcm)
        assert [(m.capcode, m.function, m.kind, m.data) for m in msgs] == [
            _expected(b) for b in BURSTS
        ]
        assert all(m.baud == baud for m in msgs)

    def test_streaming_blocks_equal_oneshot(self):
        pcm = gen.generate(BURSTS, baud=1200)
        dec = PocsagDecoder()
        msgs = []
        for i in range(0, len(pcm), 1000):
            msgs.extend(dec.on_pcm(pcm[i : i + 1000]))
        assert [(m.capcode, m.data) for m in msgs] == [
            (m.capcode, m.data) for m in PocsagDecoder().on_pcm(pcm)
        ]

    def test_bch_corrects_channel_bit_errors(self):
        """Flip up to 2 bit-cells per codeword in the PCM domain."""
        rng = np.random.default_rng(7)
        baud = 1200
        spb = 38400 // baud
        pcm = gen.generate(BURSTS, baud=baud).copy()
        # preamble(576) + per batch: 32 sync + 512 bits
        pre = 576
        nwords = len(gen.build_words(BURSTS))
        for batch in range(nwords // 16):
            base = pre + batch * (32 + 512) + 32  # skip sync word
            for w in range(16):
                for p in rng.choice(31, size=2, replace=False):
                    b0 = (base + w * 32 + int(p)) * spb
                    pcm[b0 : b0 + spb] = -pcm[b0 : b0 + spb].astype(np.int32)
        msgs = PocsagDecoder().on_pcm(pcm)
        assert [(m.capcode, m.function, m.kind, m.data) for m in msgs] == [
            _expected(b) for b in BURSTS
        ]

    def test_noise_only_produces_nothing(self):
        rng = np.random.default_rng(8)
        pcm = rng.integers(-8000, 8000, size=200_000, dtype=np.int64).astype(np.int16)
        assert PocsagDecoder().on_pcm(pcm) == []


class TestPocsagFullChain:
    def test_through_tpu_channelizer(self):
        """POCSAG baseband -> NBFM modulate at an offset inside a wideband
        capture -> exact-tier channelize + FM demod -> decode: messages
        bit-exact. This is the BASELINE.json POCSAG parity configuration."""
        from tsl_sdr_tpu.models.channelizer import MultifmChain
        from tsl_sdr_tpu.utils.filter_design import firdes_low_pass

        baud = 1200
        decim = 32
        fs = 38400 * decim  # 1.2288 Msps wideband
        offset = 250_000

        # generous tail: process_array trims the final partial block
        baseband = gen.generate(BURSTS[:2], baud=baud, amplitude=4096, tail_bits=256)
        # FM modulate: pcm p -> inst. freq = p/2^14 * (38400/2) Hz
        dev = baseband.astype(np.float64) / 16384.0 * (38400 / 2)
        # per-wideband-sample phase increment for carrier offset + deviation
        inst = 2 * np.pi * (offset + dev) / fs
        phase = np.cumsum(np.repeat(inst, decim))
        rng = np.random.default_rng(9)
        iq = np.stack([np.cos(phase), np.sin(phase)], -1) * 9000
        iq = (iq + rng.normal(scale=150, size=iq.shape)).astype(np.int16)

        lpf = firdes_low_pass(1.0, fs, 9_600, 7_000)
        chain = MultifmChain(lpf, [offset], fs, decim, exact=True)
        pcm = chain.process_array(iq, block_size=decim * 4096)[0]

        msgs = PocsagDecoder().on_pcm(pcm)
        assert [(m.capcode, m.function, m.kind, m.data) for m in msgs] == [
            _expected(b) for b in BURSTS[:2]
        ]
        assert all(m.baud == baud for m in msgs)


class TestPocsagFastScan:
    def test_scan_equals_on_pcm(self):
        """Vectorized scan produces exactly the FSM's message list."""
        rng = np.random.default_rng(77)
        parts = []
        for b in BURSTS[:3]:
            parts.append(
                rng.integers(-8000, 8000, size=rng.integers(50_000, 120_000),
                             dtype=np.int64).astype(np.int16)
            )
            parts.append(gen.generate([b], baud=1200, tail_bits=64))
        parts.append(rng.integers(-8000, 8000, size=200_000,
                                  dtype=np.int64).astype(np.int16))
        pcm = np.concatenate(parts)

        ref = PocsagDecoder().on_pcm(pcm)
        got = PocsagDecoder().scan(pcm)
        assert [(m.capcode, m.function, m.kind, m.data) for m in got] == [
            (m.capcode, m.function, m.kind, m.data) for m in ref
        ]
        assert len(got) >= 3

    def test_scan_pure_noise_is_fast_and_empty(self):
        rng = np.random.default_rng(78)
        pcm = rng.integers(-8000, 8000, size=1_000_000, dtype=np.int64).astype(np.int16)
        import time
        # calibrate the per-sample python FSM rate on THIS box so the bound
        # is load-robust (ADVICE r1); the default decoder (native FSM or
        # windowed-prefilter scan) must beat it comfortably
        ref = PocsagDecoder(native=False, vectorized=False)
        t0 = time.perf_counter()
        ref.on_pcm(pcm[:50_000])
        fsm_rate = 50_000 / (time.perf_counter() - t0)
        t0 = time.perf_counter()
        msgs = PocsagDecoder().scan(pcm)
        scan_rate = len(pcm) / (time.perf_counter() - t0)
        assert msgs == []
        # vectorized prefilter: must be far faster than the FSM pass
        assert scan_rate > 5 * fsm_rate, (scan_rate, fsm_rate)


class TestPocsagExactPackedChain:
    def test_bitexact_mxu_path_decodes_identically(self):
        """BASELINE north star: POCSAG through the fast bit-exact tier
        (int16 matmul FIR + native rotator + LUT FM oracle) decodes the same
        messages as the reference-exact scan tier."""
        import shutil

        if shutil.which("g++") is None:
            pytest.skip("no C++ toolchain")
        from tsl_sdr_tpu.models.channelizer import MultifmChain
        from tsl_sdr_tpu.utils.filter_design import firdes_low_pass

        baud = 1200
        decim = 32
        fs = 38400 * decim
        offset = 250_000
        baseband = gen.generate(BURSTS[:2], baud=baud, amplitude=4096,
                                tail_bits=256)
        dev = baseband.astype(np.float64) / 16384.0 * (38400 / 2)
        inst = 2 * np.pi * (offset + dev) / fs
        phase = np.cumsum(np.repeat(inst, decim))
        rng = np.random.default_rng(9)
        iq = np.stack([np.cos(phase), np.sin(phase)], -1) * 9000
        iq = (iq + rng.normal(scale=150, size=iq.shape)).astype(np.int16)

        lpf = firdes_low_pass(1.0, fs, 9_600, 7_000)
        chain = MultifmChain(lpf, [offset], fs, decim, exact=True)
        pcm = chain.process_array_exact_packed(iq, block_size=decim * 4096)[0]

        msgs = PocsagDecoder().on_pcm(pcm)
        assert [(m.capcode, m.function, m.kind, m.data) for m in msgs] == [
            _expected(b) for b in BURSTS[:2]
        ]


def test_native_bch_matches_numpy_oracle():
    """The native C corrector (tslstream.cc tsl_bch3121_decode) is
    word-for-word identical to the numpy tier on random words, on valid
    codewords with 0-4 injected errors, and on bit-31-set words."""
    from tsl_sdr_tpu.models.bch import _NativeBch3121

    try:
        nat = _NativeBch3121()
    except Exception:
        pytest.skip("no native toolchain")
    ref = pocsag_bch(native=False)
    rng = np.random.default_rng(7)

    words = rng.integers(0, 1 << 32, size=50_000, dtype=np.int64).astype(
        np.uint32
    )
    cn, fn = nat.decode(words)
    cr, fr = ref.decode(words)
    assert np.array_equal(cn, cr) and np.array_equal(fn, fr)

    data = rng.integers(0, 1 << 21, size=10_000, dtype=np.int64)
    cw = ref.encode(data).astype(np.uint32)
    for nerr in range(5):
        w = cw.copy()
        for _ in range(nerr):
            w ^= np.uint32(1) << rng.integers(0, 31, size=w.size).astype(
                np.uint32
            )
        cn, fn = nat.decode(w)
        cr, fr = ref.decode(w)
        assert np.array_equal(cn, cr) and np.array_equal(fn, fr), nerr
