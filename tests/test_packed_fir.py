"""Lane-packed fast tier (ops/packed_fir + fm_from_baseband) vs float64 oracle.

The packed tier is the production path; it must track a plain float64
windowed-FIR + rotate + discriminate oracle to within ~1 PCM LSB, and be
invariant to block boundaries.
"""

import numpy as np

from tsl_sdr_tpu.models.channelizer import MultifmChain
from tsl_sdr_tpu.ops import fir, fm, packed_fir
from tsl_sdr_tpu.utils.filter_design import firdes_low_pass


def _oracle_pcm(x, lpf, offsets, fs, d):
    """float64 reference: windowed FIR -> analytic rotate -> atan2 FM."""
    c = len(offsets)
    t = len(lpf)
    k0 = (len(x) - t) // d + 1
    idx = np.arange(k0)[:, None] * d + np.arange(t)[None, :]
    win = np.asarray(x, np.float64)[idx]  # [K, T, 2]
    pcm = np.zeros((c, k0), np.int16)
    for ci in range(c):
        taps, f_offs = fir.design_channel_taps(lpf, offsets[ci], fs)
        # the production tier uses the reference's Q.14 quantized taps; the
        # oracle must filter with the same response (angles of near-zero
        # noise outputs are hypersensitive to tap perturbations)
        from tsl_sdr_tpu.ops import q14

        tre = q14.quantize_q14(taps.real).astype(np.float64)
        tim = q14.quantize_q14(taps.imag).astype(np.float64)
        ar = win[..., 0] @ tre - win[..., 1] @ tim
        ai = win[..., 1] @ tre + win[..., 0] @ tim
        th = f_offs * d * np.arange(k0)
        yr = ar * np.cos(th) - ai * np.sin(th)
        yi = ar * np.sin(th) + ai * np.cos(th)
        pr = np.concatenate([[0.0], yr[:-1]])
        pi_ = np.concatenate([[0.0], yi[:-1]])
        phi = np.arctan2(yi * pr - yr * pi_, yr * pr + yi * pi_)
        pcm[ci] = np.trunc(phi / np.pi * 16384).astype(np.int16)
    return pcm


def test_packed_matches_float64_oracle():
    fs, d = 512_000, 16
    rng = np.random.default_rng(7)
    lpf = firdes_low_pass(1.0, fs, 18_000, 9_000)[:96]
    offsets = [40_000, -100_000, 212_000]
    n = 200_000
    x = rng.integers(-9000, 9000, size=(n, 2), dtype=np.int64).astype(np.int16)

    chain = MultifmChain(lpf, offsets, fs, d, exact=False)
    got = chain.process_array(x, block_size=64_000)

    want = _oracle_pcm(x, lpf, offsets, fs, d)
    m = min(got.shape[1], want.shape[1])
    diff = np.abs(got[:, 1:m].astype(np.int32) - want[:, 1:m].astype(np.int32))
    diff = np.minimum(diff, 32768 - diff)  # +/-pi wrap counts as adjacent
    assert diff.max() <= 2, diff.max()
    assert (diff <= 1).mean() > 0.999


def test_packed_block_boundary_invariance():
    """Streaming in small blocks == one big block, exactly."""
    fs, d = 128_000, 4
    rng = np.random.default_rng(8)
    lpf = firdes_low_pass(1.0, fs, 12_000, 8_000)[:41]
    offsets = [8_000, -24_000]
    chain = MultifmChain(lpf, offsets, fs, d, exact=False)
    q = chain.block_quantum
    n = q * 40
    x = rng.integers(-9000, 9000, size=(n + chain.carry_len, 2), dtype=np.int64)
    x = x.astype(np.int16)

    st = chain.init_state(prefix=x[: chain.carry_len])
    _, whole = chain.step(st, x[chain.carry_len :])
    whole = np.asarray(whole)

    st = chain.init_state(prefix=x[: chain.carry_len])
    outs = []
    pos = chain.carry_len
    for i in range(8):
        st, pcm = chain.step(st, x[pos : pos + 5 * q])
        pos += 5 * q
        outs.append(np.asarray(pcm))
    blocked = np.concatenate(outs, axis=1)
    np.testing.assert_array_equal(whole, blocked)


def test_nco_rotate_matches_float64_phase():
    """Integer-NCO rotation stays phase-accurate at large absolute index."""
    rng = np.random.default_rng(9)
    c = 4
    k = 2048
    k0 = 10_000_000  # deep into a stream — float32 omega*k would be garbage
    omega = rng.uniform(-np.pi, np.pi, size=c)
    ar = rng.normal(size=(k, c)).astype(np.float32)
    ai = rng.normal(size=(k, c)).astype(np.float32)
    oi32 = packed_fir.omega_turns_i32(omega)
    yr, yi = packed_fir.nco_rotate(ar, ai, oi32, np.int32(k0))

    kk = k0 + np.arange(k)[:, None]
    # reproduce the NCO's quantized phase in float64 (the NCO quantizes
    # omega to 2^-32 turns; that is its contract)
    th = (kk * oi32[None, :].astype(np.int64)) % 2**32
    th = np.where(th >= 2**31, th - 2**32, th) * (2 * np.pi / 2**32)
    wr = ar * np.cos(th) - ai * np.sin(th)
    wi = ar * np.sin(th) + ai * np.cos(th)
    assert np.max(np.abs(np.asarray(yr) - wr)) < 1e-5
    assert np.max(np.abs(np.asarray(yi) - wi)) < 1e-5


def test_fm_from_baseband_equals_rotate_then_fm():
    rng = np.random.default_rng(10)
    k, c = 4096, 2
    omega = rng.uniform(-1.0, 1.0, size=c)
    ar = rng.normal(scale=3000, size=(k, c)).astype(np.float32)
    ai = rng.normal(scale=3000, size=(k, c)).astype(np.float32)

    pcm, _, _ = fm.fm_from_baseband(
        ar,
        ai,
        np.zeros(c, np.float32),
        np.zeros(c, np.float32),
        omega.astype(np.float32),
    )
    pcm = np.asarray(pcm)

    th = omega[None, :] * np.arange(k)[:, None]
    yr = ar * np.cos(th) - ai * np.sin(th)
    yi = ar * np.sin(th) + ai * np.cos(th)
    pr = np.vstack([np.zeros((1, c)), yr[:-1]])
    pi_ = np.vstack([np.zeros((1, c)), yi[:-1]])
    phi = np.arctan2(yi * pr - yr * pi_, yr * pr + yi * pi_)
    want = np.trunc(phi / np.pi * 16384).astype(np.int16)
    diff = np.abs(pcm.astype(np.int32) - want.astype(np.int32))
    diff = np.minimum(diff, 32768 - diff)
    assert diff[1:].max() <= 1, diff[1:].max()


def test_exact_packed_matches_exact_tier():
    """The matmul integer path == the reference-exact scan tier, bit for bit."""
    import shutil

    import pytest

    if shutil.which("g++") is None:
        pytest.skip("no C++ toolchain for the rotator helper")

    fs, d = 256_000, 16
    rng = np.random.default_rng(70)
    lpf = firdes_low_pass(1.0, fs, 9_000, 6_000)[:80]
    offsets = [24_000, -64_000, 100_000]
    n = 120_000
    x = rng.integers(-9000, 9000, size=(n, 2), dtype=np.int64).astype(np.int16)

    chain = MultifmChain(lpf, offsets, fs, d, exact=True)
    got = chain.process_array_exact_packed(x, block_size=40_000)

    # ground truth: the C-arithmetic oracle (direct FIR + Q.14 rotator +
    # double-promoted LUT FM) — got must equal it BIT FOR BIT
    import oracles
    from tsl_sdr_tpu.ops import fm as fm_ops

    for ci in range(len(offsets)):
        ch = oracles.direct_fir_oracle(
            x, chain.plan.taps_i16[ci], d, rot_incr=chain.plan.rot_incr_i32[ci]
        )
        want, _ = fm_ops.fm_demod_np(ch[: got.shape[1]][None])
        np.testing.assert_array_equal(got[ci], want[0])

    # and the device exact tier agrees within its documented 1-LSB FM slack
    tier = chain.process_array(x, block_size=32_000)
    m = min(tier.shape[1], got.shape[1])
    diff = np.abs(tier[:, :m].astype(np.int32) - got[:, :m].astype(np.int32))
    assert diff.max() <= 1


def test_packed_odd_configs_match_oracle():
    """Generality sweep: small/odd D, T <= D (cr_rows == 0), T spanning
    several rows, C == 1 — all must track the quantized-tap float64 oracle."""
    rng = np.random.default_rng(71)
    cases = [
        (96_000, 3, 2, [10_000]),        # T < D, zero carry
        (96_000, 3, 64, [10_000, -20_000]),
        (250_000, 7, 33, [50_000]),
        (128_000, 64, 200, [30_000]),    # window spans 4 rows
        (100_000, 5, 5, [12_345]),       # T == D
    ]
    for fs, d, taps, offs in cases:
        lpf = np.resize(firdes_low_pass(1.0, fs, fs // 8, fs // 10), taps)
        chain = MultifmChain(lpf, offs, fs, d, exact=False)
        n = max(chain.carry_len + chain.block_quantum * 8, taps * 4)
        x = rng.integers(-9000, 9000, size=(n, 2), dtype=np.int64).astype(
            np.int16
        )
        got = chain.process_array(x, block_size=chain.block_quantum * 4)
        want = _oracle_pcm(x, lpf, offs, fs, d)
        m = min(got.shape[1], want.shape[1])
        diff = np.abs(got[:, 1:m].astype(np.int32) - want[:, 1:m].astype(np.int32))
        diff = np.minimum(diff, 32768 - diff)
        assert diff.max() <= 2, (fs, d, taps, diff.max())


def test_exact_packed_streaming_step_bitexact():
    """The streaming exact-packed step (VERDICT r1 item 5) produces the
    same bits as the whole-capture path and the scan tier, across
    arbitrary block boundaries."""
    from scipy.signal import firwin

    from tsl_sdr_tpu.models.channelizer import MultifmChain

    rng = np.random.default_rng(31)
    fs, d = 256_000, 8
    offsets = [32_000, -24_000]
    n = 80_000
    iq = rng.integers(-12000, 12000, size=(n, 2),
                      dtype=np.int64).astype(np.int16)
    lpf = firwin(97, 12_500 / (fs / 2))

    chain = MultifmChain(lpf, offsets, fs, d, exact=True)  # packed default
    want = chain.process_array_exact_packed(iq, block_size=16_384)

    # streaming: same capture in uneven block_quantum-aligned slices
    q = chain.block_quantum
    c_len = chain.carry_len
    state = chain.init_state(prefix=iq[:c_len])
    outs = []
    pos = c_len
    for mult in (130, 37, 211, 64, 155, 99, 178, 41, 250, 86):
        take = mult * q
        if pos + take > n:
            break
        st2, pcm = chain.step(state, iq[pos:pos + take])
        state = st2
        outs.append(pcm)
        pos += take
    got = np.concatenate(outs, axis=1)
    m = min(got.shape[1], want.shape[1])
    assert m > 1000
    np.testing.assert_array_equal(got[:, :m], want[:, :m])

    # the scan tier agrees except for its documented f32-vs-double FM
    # scaling divergence (+-1 LSB on <0.1% of outputs; the packed tier is
    # the C-exact one — see test_exact_packed_matches_exact_tier)
    chain_scan = MultifmChain(lpf, offsets, fs, d, exact=True,
                              exact_tier="scan")
    want_scan = np.asarray(chain_scan.process_array(iq, block_size=16_000))
    m2 = min(m, want_scan.shape[1])
    diff = np.abs(got[:, :m2].astype(np.int32)
                  - want_scan[:, :m2].astype(np.int32))
    assert diff.max() <= 1
    assert (diff != 0).mean() < 1e-3


def test_exact_packed_process_array_device_multichannel():
    """Regression (r2 self-review): process_array_device must not scramble
    channels in the packed exact tier (it already returns [C, K])."""
    from scipy.signal import firwin

    from tsl_sdr_tpu.models.channelizer import MultifmChain

    rng = np.random.default_rng(41)
    fs, d = 256_000, 8
    iq = rng.integers(-12000, 12000, size=(40_000, 2),
                      dtype=np.int64).astype(np.int16)
    chain = MultifmChain(firwin(97, 12_500 / (fs / 2)),
                         [32_000, -24_000, 56_000], fs, d, exact=True)
    host = np.asarray(chain.process_array(iq, block_size=16_384))
    dev = np.asarray(chain.process_array_device(iq, block_size=16_384))
    np.testing.assert_array_equal(host, dev)


def test_grouped_tier_bitexact_and_streaming():
    """Phase-grouped windowed matmuls produce BIT-IDENTICAL accumulators to
    the chunked form (int32 wrap sums are order-free), across block splits.
    Covers g < opr (C=16: g=4) and g == 1 (C=64)."""
    rng = np.random.default_rng(7)
    fs, d, t = 1_000_000, 40, 128
    lpf = firdes_low_pass(1.0, fs, 12_500, 9_000)[:t]
    for c in (16, 64):
        offs = rng.integers(-fs // 3, fs // 3, size=c)
        plan = packed_fir.make_packed_fir_plan(lpf, offs, fs, d)
        assert packed_fir.grouped_fir_worthwhile(plan)
        g = packed_fir.make_grouped_from_plan(plan)
        n = plan.block_quantum * 6
        iq = rng.integers(
            -12000, 12000, size=(2 * n + plan.carry_vals,), dtype=np.int64
        ).astype(np.int16)
        import jax.numpy as jnp

        carry1 = jnp.asarray(iq[: plan.carry_vals])
        carry2 = jnp.asarray(iq[: plan.carry_vals])
        body = iq[plan.carry_vals :]
        # chunked: one shot; grouped: three uneven streaming steps
        _, ar_ref, ai_ref = packed_fir.packed_fir_step(plan, carry1, body)
        outs_r, outs_i = [], []
        q2 = plan.block_quantum * 2
        for part in (body[: 2 * q2], body[2 * q2 : 2 * (q2 + q2)],
                     body[2 * (q2 + q2):]):
            carry2, ar, ai = packed_fir.packed_fir_step(
                plan, carry2, part, gplan=g
            )
            outs_r.append(np.asarray(ar).reshape(-1, ar.shape[-1]))
            outs_i.append(np.asarray(ai).reshape(-1, ai.shape[-1]))
        ar_g = np.concatenate(outs_r)
        ai_g = np.concatenate(outs_i)
        assert np.array_equal(
            np.asarray(ar_ref).reshape(ar_g.shape), ar_g
        )
        assert np.array_equal(
            np.asarray(ai_ref).reshape(ai_g.shape), ai_g
        )
        # exact tier: rounded int16 accumulators also identical
        carry3 = jnp.asarray(iq[: plan.carry_vals])
        carry4 = jnp.asarray(iq[: plan.carry_vals])
        _, er1, ei1 = packed_fir.packed_fir_step_exact(plan, carry3, body)
        _, er2, ei2 = packed_fir.packed_fir_step_exact(
            plan, carry4, body, gplan=g
        )
        assert np.array_equal(np.asarray(er1), np.asarray(er2))
        assert np.array_equal(np.asarray(ei1), np.asarray(ei2))


def test_multifm_chain_auto_grouped_matches_narrow_logic():
    """MultifmChain picks the grouped tier only where it cuts FLOPs, and
    its fast-tier output is unchanged by the regrouping."""
    rng = np.random.default_rng(3)
    fs, d, t = 1_000_000, 40, 128
    lpf = firdes_low_pass(1.0, fs, 12_500, 9_000)[:t]
    offs8 = rng.integers(-fs // 3, fs // 3, size=8)
    chain8 = MultifmChain(lpf, offs8, fs, d, exact=False)
    assert chain8.grouped_plan is None  # g == opr: no FLOP cut at 8ch

    offs16 = rng.integers(-fs // 3, fs // 3, size=16)
    chain16 = MultifmChain(lpf, offs16, fs, d, exact=False)
    assert chain16.grouped_plan is not None
    n = chain16.packed_plan.block_quantum * 8 + chain16.carry_len
    iq = rng.integers(-9000, 9000, size=(n, 2), dtype=np.int64).astype(
        np.int16
    )
    pcm_g = chain16.process_array(iq)
    chain16.grouped_plan = None
    del chain16.__dict__["scan_fn"]  # drop the cached jitted scan
    pcm_c = chain16.process_array(iq)
    assert np.array_equal(pcm_g, pcm_c)
