"""Execution-level parity: the compiled reference C vs the JAX framework.

VERDICT r1 item 1: every bit-exact claim previously rested on numpy oracles
*transcribed* from the C. Here the reference sources themselves
(pvachon/tsl-sdr) are compiled against the minimal TSL shim
(tsl_sdr_tpu/testing/refc/) and diffed against the framework
execution-for-execution on shared synthetic captures: messages
message-for-message, DSP kernels sample-for-sample.

Skips cleanly when the reference tree (env TSL_REF_DIR) or gcc is absent.
"""

import shutil

import numpy as np
import pytest

from tsl_sdr_tpu.testing import ais_gen, flex_gen, pocsag_gen, refc

import oracles

pytestmark = pytest.mark.skipif(
    not refc.available() or shutil.which("gcc") is None,
    reason="reference tree or C toolchain unavailable",
)

_FLEX_PHASE_INDEX = {"A": 0, "B": 1, "C": 2, "D": 3}


@pytest.fixture(scope="module")
def lib():
    return refc.load()


# ---- BCH(31,21,t=2) ----------------------------------------------------------


def test_bch_parity_random_errors(lib):
    """Reference bch_code_decode == our decode_one over random error patterns,
    including the s1==s2==0 pass-through quirk (pager/bch_code.c:307-398)."""
    from tsl_sdr_tpu.models.bch import pocsag_bch

    rng = np.random.default_rng(11)
    bch = pocsag_bch()
    datas = rng.integers(0, 1 << 21, size=400, dtype=np.int64)
    encoded = bch.encode(datas.astype(np.uint32))
    words = []
    for k in range(400):
        word = int(encoded[k])
        nerr = int(rng.integers(0, 4))  # 0..3 bit errors
        for pos in rng.choice(31, size=nerr, replace=False):
            word ^= 1 << int(pos)
        words.append(word)
    words = np.asarray(words, np.uint32)

    ref_corrected, ref_rc = refc.bch_decode(words)
    for w, rc_ref, corr_ref in zip(words, ref_rc, ref_corrected):
        corr, fail = bch.decode_one(int(w))
        assert bool(fail) == (rc_ref != 0), hex(w)
        assert corr == int(corr_ref), hex(w)


# ---- POCSAG -------------------------------------------------------------------


def _pocsag_capture(rng):
    parts = []
    cases = [
        (512, "alpha", "HELLO REF PARITY", 100),
        (1200, "numeric", "123-456 789", 77123),
        (2400, "alpha", "Mixed Case 42!", 2097151),
        (1200, "alpha", "END\x04", 31337),
    ]
    for baud, kind, content, cap in cases:
        parts.append(
            rng.integers(-6000, 6000, 25_000, dtype=np.int64).astype(np.int16))
        b = pocsag_gen.generate(
            [pocsag_gen.PocsagBurst(capcode=cap, function=2, kind=kind,
                                    content=content)],
            baud=baud, tail_bits=64).astype(np.int32)
        noise = rng.normal(scale=150, size=b.shape)
        parts.append(np.clip(b + noise, -32768, 32767).astype(np.int16))
    return np.concatenate(parts)


def test_pocsag_message_parity(lib):
    """pager/pager_pocsag.c messages == PocsagDecoder (on_pcm and scan)."""
    from tsl_sdr_tpu.models.pocsag import PocsagDecoder

    pcm = _pocsag_capture(np.random.default_rng(42))
    ref = [(m.kind, m.baud, m.capcode, m.function, m.data)
           for m in refc.pocsag_run(pcm, block=1024)]
    assert len(ref) >= 4
    got = [(m.kind, m.baud, m.capcode, m.function, m.data)
           for m in PocsagDecoder().on_pcm(pcm)]
    assert got == ref
    got_scan = [(m.kind, m.baud, m.capcode, m.function, m.data)
                for m in PocsagDecoder().scan(pcm)]
    assert got_scan == ref


# ---- FLEX ---------------------------------------------------------------------


@pytest.mark.parametrize("baud,fsk", [(1600, 2), (3200, 2), (3200, 4),
                                      (6400, 4)])
def test_flex_message_parity(lib, baud, fsk):
    """pager/pager_flex.c messages == FlexDecoder at every coding."""
    from tsl_sdr_tpu.models.flex import FlexDecoder

    rng = np.random.default_rng(baud + fsk)
    burst, _ = flex_gen.generate(
        [flex_gen.FlexBurstMessage(capcode=1234567, kind="alnum",
                                   content=f"REF {baud}/{fsk}"),
         flex_gen.FlexBurstMessage(capcode=99881, kind="numeric",
                                   content="555123")],
        baud=baud, fsk_levels=fsk, tail_bits=64)
    noise = rng.integers(-5000, 5000, 20_000, dtype=np.int64).astype(np.int16)
    pcm = np.concatenate([noise, burst, noise])

    ref = [(m.kind, m.baud, m.phase, m.cycle, m.frame, m.capcode, m.data)
           for m in refc.flex_run(pcm, block=1024)]
    assert len(ref) >= 2
    kindmap = {"alnum": "alnum", "numeric": "num", "siv": "siv"}
    got = [(kindmap[m.kind], m.baud, _FLEX_PHASE_INDEX[m.phase], m.cycle,
            m.frame, m.capcode, m.data) for m in FlexDecoder().on_pcm(pcm)]
    assert got == ref
    got_scan = [(kindmap[m.kind], m.baud, _FLEX_PHASE_INDEX[m.phase], m.cycle,
                 m.frame, m.capcode, m.data) for m in FlexDecoder().scan(pcm)]
    assert got_scan == ref


# ---- AIS ----------------------------------------------------------------------


def test_ais_packet_parity(lib):
    """ais/ais_demod.c raw HDLC packets == AisDemodulator byte-for-byte."""
    from tsl_sdr_tpu.models.ais import AisDemodulator

    rng = np.random.default_rng(77)
    pkts = [
        ais_gen.make_position_report(
            366123456, nav_stat=3, speed_over_ground=12.3, longitude=-70.1,
            latitude=42.35, course=885, heading=91, timestamp=30),
        ais_gen.make_base_station_report(
            3669999, year=2024, month=6, day=15, hour=12, minute=30,
            second=45, longitude=-71.0, latitude=41.5),
        ais_gen.make_static_voyage(
            366555444, imo=9114111, callsign="WDL123",
            ship_name="REF PARITY", ship_type=70, destination="BOSTON"),
    ]
    parts = []
    for p in pkts:
        parts.append(
            rng.integers(-5000, 5000, 25_000, dtype=np.int64).astype(np.int16))
        parts.append(ais_gen.generate([p]))
    pcm = np.concatenate(parts)

    ref = refc.ais_demod_run(pcm, block=1024)
    assert len(ref) == 3 and all(valid for _, valid in ref)
    d = AisDemodulator()
    d.on_pcm(pcm)
    assert [p for p, _ in ref] == d.packets

    # field-level reports, including the ASCII-armored raw payload
    reports = refc.ais_decode_run(pcm, block=1024)
    assert [r["type"] for r in reports] == ["position", "base_station",
                                            "voyage"]
    assert reports[0]["mmsi"] == 366123456
    assert reports[0]["course"] == 885
    assert reports[2]["ship_name"].rstrip("@ ") == "REF PARITY"

    from tsl_sdr_tpu.models.ais import AisDecoder
    ours = AisDecoder().on_pcm(pcm)
    assert [m.mmsi for m in ours] == [r["mmsi"] for r in reports]
    # armored AIVDM payload must match the reference's armor exactly
    assert [m.raw for m in ours if hasattr(m, "raw")] == [
        r["raw"] for r in reports]


# ---- DSP kernels ---------------------------------------------------------------


def test_direct_fir_parity_no_derotation(lib):
    from tsl_sdr_tpu.ops import q14

    rng = np.random.default_rng(7)
    taps = np.stack([q14.quantize_q14(rng.normal(size=31) * 0.2),
                     np.zeros(31, np.int16)], -1)
    x = rng.integers(-12000, 12000, size=(4096, 2),
                     dtype=np.int64).astype(np.int16)
    ref = refc.direct_fir_run(taps[:, 0], taps[:, 1], 5, x, derotate=False,
                              buf_samples=1000)
    want = oracles.direct_fir_oracle(x, taps, 5)
    m = min(len(ref), len(want))
    assert m > 500
    np.testing.assert_array_equal(ref[:m], want[:m])


def test_direct_fir_parity_with_derotation(lib):
    """Reference FIR+derotator == transcribed oracle == our exact tier, on
    the bandpass-shifted taps the demod path uses (multifm/demod.c:205-269)."""
    from tsl_sdr_tpu.ops import fir

    rng = np.random.default_rng(8)
    taps_f = rng.normal(size=57) * 0.2
    x = rng.integers(-12000, 12000, size=(8192, 2),
                     dtype=np.int64).astype(np.int16)
    fs, shift, d = 250_000, 31_250, 8
    plan = fir.make_channel_fir_plan(taps_f, [shift], sample_rate=fs,
                                     decimation=d)
    taps = plan.taps_i16[0]
    # buf_samples divides the capture: the reference's final-partial-buffer
    # flush is a corner its production paths never run (equal-size pool
    # frames, endless stream) and its last window diverges there
    ref = refc.direct_fir_run(taps[:, 0], taps[:, 1], d, x, derotate=True,
                              fs=fs, freq_shift=shift, buf_samples=1024)
    want = oracles.direct_fir_oracle(x, taps, d,
                                     rot_incr=plan.rot_incr_i32[0])
    m = min(len(ref), len(want))
    assert m > 400
    np.testing.assert_array_equal(ref[:m], want[:m])


def test_polyphase_parity(lib):
    from tsl_sdr_tpu.ops import q14

    rng = np.random.default_rng(9)
    coeff = q14.quantize_q14(rng.normal(size=161) * 0.2)
    pcm = rng.integers(-16000, 16000, size=20000,
                       dtype=np.int64).astype(np.int16)
    for i, d in [(16, 25), (25, 16), (3, 2)]:
        ref = refc.polyphase_run(coeff, i, d, pcm, buf_samples=333)
        want = oracles.polyphase_oracle(pcm, coeff, i, d)
        m = min(len(ref), len(want))
        assert m > 1000
        np.testing.assert_array_equal(ref[:m], want[:m], err_msg=f"I={i} D={d}")


def test_fm_demod_parity(lib):
    from tsl_sdr_tpu.ops import fm

    rng = np.random.default_rng(10)
    iq = rng.integers(-12000, 12000, size=(5000, 2),
                      dtype=np.int64).astype(np.int16)
    ref = refc.fm_demod_run(iq, block=777)
    ours, _ = fm.fm_demod_np(iq)
    np.testing.assert_array_equal(ref, ours[: len(ref)])


def test_chain_exact_packed_parity(lib):
    """Full channelizer chain: reference FIR(derot) -> reference FM demod
    == MultifmChain.process_array_exact_packed, sample-for-sample."""
    from scipy.signal import firwin

    from tsl_sdr_tpu.models.channelizer import MultifmChain

    rng = np.random.default_rng(12)
    fs, d, offset = 256_000, 8, 32_000
    n = 200_000
    t = np.arange(n) / fs
    tone = np.exp(2j * np.pi * offset * t + 0.8j * np.sin(2 * np.pi * 900 * t))
    iq = np.round(tone.view(np.float64).reshape(-1, 2) * 8000
                  + rng.normal(scale=300, size=(n, 2))).astype(np.int16)

    lpf = firwin(121, 12_500 / (fs / 2))
    chain = MultifmChain(lpf, [offset], fs, d, exact=True)
    got = np.asarray(chain.process_array_exact_packed(iq))[0]

    taps = chain.plan.taps_i16[0]
    # buf_samples divides n (see test_direct_fir_parity_with_derotation)
    ref_iq = refc.direct_fir_run(taps[:, 0], taps[:, 1], d, iq, derotate=True,
                                 fs=fs, freq_shift=offset, buf_samples=4000)
    ref_pcm = refc.fm_demod_run(ref_iq)
    m = min(len(got), len(ref_pcm))
    assert m > 20_000
    np.testing.assert_array_equal(got[:m], ref_pcm[:m])


# ---- Mueller-Müller ------------------------------------------------------------


def _pocsag_25khz_capture():
    """Synthetic 25 kHz / 1200 bps POCSAG capture with a known sync count
    (VERDICT r1 item 7; mirrors pager/test/test_mueller_muller.c:180-211).

    The NRZ waveform is band-limited like a real discriminator output —
    on ideal square waves the MM error sign(y[k-1])*y[k] - sign(y[k])*y[k-1]
    is identically zero, so ramped transitions are what give the loop its
    timing information. Content of 7 batches -> exactly 7 sync words.
    """
    from scipy.signal import firwin, lfilter

    burst = pocsag_gen.generate(
        [pocsag_gen.PocsagBurst(capcode=54321, function=1, kind="alpha",
                                content="MM ANCHOR " * 30)],
        baud=1200, tail_bits=64)
    # index-map the 38400 Hz NRZ waveform to 25 kHz (sign pattern preserved)
    idx = (np.arange(int(len(burst) * 25_000 / 38_400)) * 38_400) // 25_000
    sq = burst[idx].astype(np.float64)
    h = firwin(63, 2200 / 12500)
    rng = np.random.default_rng(5)
    return np.clip(lfilter(h, [1.0], sq)
                   + rng.normal(scale=60, size=sq.shape),
                   -32768, 32767).astype(np.int16)


def _count_syncs(decisions):
    """The reference anchor's criterion: popcount(sync ^ shr) < 4 over the
    sign-sliced decision stream (test_mueller_muller.c:128-137)."""
    shr = 0
    count = 0
    for dec in decisions:
        shr = ((shr << 1) | (1 if dec <= 0 else 0)) & 0xFFFFFFFF
        if bin(shr ^ 0x7CD215D8).count("1") < 4:
            count += 1
    return count


def test_mm_parity_and_sync_anchor(lib):
    """Reference mm_process == our MuellerMuller decision-for-decision, and
    both recover every sync word in a synthetic 25 kHz capture."""
    from tsl_sdr_tpu.models.pocsag import PocsagDecoder
    from tsl_sdr_tpu.ops.mueller_muller import MuellerMuller

    pcm = _pocsag_25khz_capture()
    spb = 25_000.0 / 1200.0
    kw, km, margin = 1e-4, 4e-6, 0.05

    ref_dec = refc.mm_run(pcm, kw=kw, km=km, samples_per_bit=spb,
                          error_min=spb - margin, error_max=spb + margin,
                          block=1024)
    ours = MuellerMuller(kw=kw, km=km, samples_per_bit=spb,
                         error_min=spb - margin, error_max=spb + margin)
    our_dec = []
    for off in range(0, len(pcm), 1024):
        our_dec.append(np.asarray(ours.process(pcm[off:off + 1024])))
    our_dec = np.concatenate(our_dec)

    m = min(len(ref_dec), len(our_dec))
    assert m > 1000
    np.testing.assert_array_equal(ref_dec[:m], our_dec[:m])

    # sanity: the underlying 38400 Hz burst is decodable
    wire_msgs = PocsagDecoder().on_pcm(
        pocsag_gen.generate(
            [pocsag_gen.PocsagBurst(capcode=54321, function=1, kind="alpha",
                                    content="MM ANCHOR " * 30)],
            baud=1200, tail_bits=64))
    assert len(wire_msgs) == 1

    # the pinned anchor: both MM loops must find EXACTLY the 7 sync words
    # the 7-batch burst carries (the reference fixture's analogue of the
    # "9 syncs in pocsag_hospital_25khz_long.raw" assertion)
    assert _count_syncs(ref_dec) == 7
    assert _count_syncs(our_dec) == 7


# ---- adversarial noise parity --------------------------------------------


def test_noise_path_parity_all_protocols(lib):
    """Heavy-noise captures (spurious syncs, CRC rejects, BCH-noise
    decodes): the running reference and every tier here (scalar python,
    vectorized, native FSM) must produce the SAME junk — transcription
    errors hide in exactly these garbage paths."""
    from tsl_sdr_tpu.models.ais import AisDemodulator
    from tsl_sdr_tpu.models.flex import FlexDecoder
    from tsl_sdr_tpu.models.pocsag import PocsagDecoder

    r = np.random.default_rng(90_001)
    parts = [r.integers(-20000, 20000, size=150_000,
                        dtype=np.int64).astype(np.int16)]
    b = pocsag_gen.generate(
        [pocsag_gen.PocsagBurst(capcode=123456, function=1, kind="alpha",
                                content="NZ")],
        baud=1200, amplitude=3000, tail_bits=32).astype(np.int32)
    parts.append(np.clip(b + r.normal(scale=2500, size=b.shape),
                         -32768, 32767).astype(np.int16))
    pcm = np.concatenate(parts)
    ref = [(m.kind, m.baud, m.capcode, m.function, m.data)
           for m in refc.pocsag_run(pcm, block=1024)]
    for dec in (PocsagDecoder(native=False, vectorized=False),
                PocsagDecoder(native=False), PocsagDecoder()):
        got = [(m.kind, m.baud, m.capcode, m.function, m.data)
               for m in dec.on_pcm(pcm)]
        assert got == ref

    r = np.random.default_rng(91_003)
    sig = ais_gen.generate(
        [ais_gen.make_position_report(366070809)],
        amplitude=4000).astype(np.int32)
    pcm = np.concatenate([
        r.integers(-25000, 25000, size=120_000,
                   dtype=np.int64).astype(np.int16),
        np.clip(sig + r.normal(scale=2800, size=sig.shape),
                -32768, 32767).astype(np.int16)])
    ref_pk = [p for p, ok in refc.ais_demod_run(pcm, block=1024) if ok]
    for d in (AisDemodulator(native=False, vectorized=False),
              AisDemodulator(native=False), AisDemodulator()):
        d.on_pcm(pcm)
        assert d.packets == ref_pk

    r = np.random.default_rng(92_002)
    burst, _ = flex_gen.generate(
        [flex_gen.FlexBurstMessage(capcode=54321, kind="alnum",
                                   content="NZF")],
        baud=3200, fsk_levels=4, amplitude=5000, tail_bits=32)
    pcm = np.concatenate([
        r.integers(-15000, 15000, size=100_000,
                   dtype=np.int64).astype(np.int16),
        np.clip(burst.astype(np.int32)
                + r.normal(scale=1800, size=burst.shape),
                -32768, 32767).astype(np.int16)])
    ref = [(m.kind, m.baud, m.phase, m.capcode, m.data)
           for m in refc.flex_run(pcm, block=1024)]
    kindmap = {"alnum": "alnum", "numeric": "num", "siv": "siv"}
    for dec in (FlexDecoder(native=False, vectorized=False),
                FlexDecoder(native=False), FlexDecoder()):
        got = [(kindmap[m.kind], m.baud, _FLEX_PHASE_INDEX[m.phase], m.capcode,
                m.data) for m in dec.on_pcm(pcm)]
        assert got == ref


def test_dc_blocker_parity(lib):
    """Reference dc_blocker_apply == our exact tier sample-for-sample."""
    from tsl_sdr_tpu.ops import dc_blocker as dcb

    rng = np.random.default_rng(13)
    pcm = (rng.integers(-12000, 12000, size=50_000, dtype=np.int64)
           + 1500).astype(np.int16)  # DC offset to actually remove
    for pole in (0.9999, 0.999, 0.95):
        want = refc.dc_blocker_run(pcm, pole)
        st = dcb.init_dc_blocker_state()
        p = dcb.make_pole_coeff(pole)
        _, got = dcb.dc_blocker_step_exact(st, pcm, p)
        np.testing.assert_array_equal(np.asarray(got), want, err_msg=str(pole))


def test_decoder_chain_parity(lib):
    """The full decoder-CLI chain (polyphase resample -> DC block ->
    POCSAG decode) == the same composition of the running reference."""
    from tsl_sdr_tpu.models.pocsag import PocsagDecoder
    from tsl_sdr_tpu.models.resampler import ResamplerChain
    from tsl_sdr_tpu.ops import q14
    from tsl_sdr_tpu.utils.filter_design import design_rational_resampler_filter

    # a 38400 Hz burst delivered at 25 kHz: decoder resamples 192/125 back
    rng = np.random.default_rng(14)
    burst = pocsag_gen.generate(
        [pocsag_gen.PocsagBurst(capcode=246810, function=1, kind="alpha",
                                content="CHAIN PARITY")],
        baud=1200, tail_bits=128)
    idx = (np.arange(int(len(burst) * 125 / 192)) * 192) // 125
    pcm25 = np.concatenate([
        rng.integers(-4000, 4000, 20_000, dtype=np.int64).astype(np.int16),
        (burst[idx].astype(np.int32)
         + rng.normal(scale=120, size=idx.shape).astype(np.int32))
        .clip(-32768, 32767).astype(np.int16),
        np.zeros(30_000, np.int16)])

    coeffs = design_rational_resampler_filter(192, 125, 0.4)
    taps_q14 = q14.quantize_q14(coeffs)
    pole = 0.9999

    # reference composition
    ref_rs = refc.polyphase_run(taps_q14, 192, 125, pcm25, buf_samples=1024)
    ref_dc = refc.dc_blocker_run(ref_rs, pole)
    ref_msgs = [(m.kind, m.capcode, m.data)
                for m in refc.pocsag_run(ref_dc, block=1024)]
    assert len(ref_msgs) == 1

    # our chain (exact tier, like decoder-tpu --exact)
    rs = ResamplerChain(coeffs, 192, 125, dc_block_pole=pole, exact=True)
    ours = np.asarray(rs.process_array(pcm25))
    m = min(len(ours), len(ref_dc))
    np.testing.assert_array_equal(ours[:m], ref_dc[:m])
    got = [(m2.kind, m2.capcode, m2.data)
           for m2 in PocsagDecoder().on_pcm(ours)]
    assert got == ref_msgs
