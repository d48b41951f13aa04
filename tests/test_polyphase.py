import numpy as np

from tsl_sdr_tpu.ops import polyphase, q14
import oracles


def _run_stream(plan, x, exact=True):
    state = polyphase.init_resampler_state(plan, prefix=x[: plan.carry_len])
    pos = plan.carry_len
    outs = []
    while pos + plan.block_in <= x.shape[0]:
        state, out = polyphase.resample_step(
            plan, state, x[pos : pos + plan.block_in], exact=exact
        )
        outs.append(np.asarray(out))
        pos += plan.block_in
    return np.concatenate(outs)


def _case(rng, i, d, nr_taps, n=20000, block_out=64):
    coeff = q14.quantize_q14(rng.normal(size=nr_taps) * 0.2)
    x = rng.integers(-16000, 16000, size=n, dtype=np.int64).astype(np.int16)
    plan = polyphase.make_resampler_plan(coeff, i, d, block_out_target=block_out)
    got = _run_stream(plan, x)
    want = oracles.polyphase_oracle(x, coeff, i, d)
    m = min(len(got), len(want))
    assert m > 100
    np.testing.assert_array_equal(got[:m], want[:m], err_msg=f"I={i} D={d}")


def test_upsample_16_25():
    _case(np.random.default_rng(20), 16, 25, 161)


def test_downsample_25_16():
    _case(np.random.default_rng(21), 25, 16, 161)


def test_interp_3_2():
    _case(np.random.default_rng(22), 3, 2, 41)


def test_unity_1_1():
    _case(np.random.default_rng(23), 1, 1, 33)


def test_big_ratio_48_5():
    _case(np.random.default_rng(24), 48, 5, 97, block_out=96)


def test_block_invariance():
    rng = np.random.default_rng(25)
    coeff = q14.quantize_q14(rng.normal(size=63) * 0.2)
    x = rng.integers(-16000, 16000, size=30000, dtype=np.int64).astype(np.int16)
    pa = polyphase.make_resampler_plan(coeff, 16, 25, block_out_target=16)
    pb = polyphase.make_resampler_plan(coeff, 16, 25, block_out_target=512)
    a = _run_stream(pa, x)
    b = _run_stream(pb, x)
    m = min(len(a), len(b))
    np.testing.assert_array_equal(a[:m], b[:m])


def test_fast_tier_tracks_exact():
    rng = np.random.default_rng(26)
    coeff = q14.quantize_q14(rng.normal(size=63) * 0.2)
    x = rng.integers(-16000, 16000, size=30000, dtype=np.int64).astype(np.int16)
    plan = polyphase.make_resampler_plan(coeff, 16, 25)
    a = _run_stream(plan, x, exact=True).astype(np.float64)
    # fast tier uses unity-scale float taps: output already in sample units
    b = _run_stream(plan, x, exact=False).astype(np.float64)
    rms_sig = np.sqrt(np.mean(a**2)) + 1e-9
    rms_err = np.sqrt(np.mean((a - b) ** 2))
    assert rms_err / rms_sig < 1e-3


def test_exact_packed_impl_matches_gather_oracle():
    """The default lane-packed exact tier is bit-identical to the
    per-output window-gather oracle (wrap-int32 sums are order-free)."""
    import numpy as np

    from tsl_sdr_tpu.ops import polyphase, q14
    from tsl_sdr_tpu.utils.filter_design import design_rational_resampler_filter

    rng = np.random.default_rng(11)
    for (i_, d_) in ((16, 25), (5, 16), (25, 48)):
        coeffs = design_rational_resampler_filter(i_, d_, 0.4)
        plan = polyphase.make_resampler_plan(
            q14.quantize_q14(coeffs), i_, d_, block_out_target=512)
        x = rng.integers(-32768, 32768,
                         size=plan.carry_len + 3 * plan.block_in,
                         dtype=np.int64).astype(np.int16)
        st_a = polyphase.init_resampler_state(plan, prefix=x[:plan.carry_len])
        st_b = polyphase.init_resampler_state(plan, prefix=x[:plan.carry_len])
        for b in range(3):
            blk = x[plan.carry_len + b * plan.block_in:
                    plan.carry_len + (b + 1) * plan.block_in]
            st_a, oa = polyphase.resample_step(plan, st_a, blk, exact=True)
            st_b, ob = polyphase.resample_step(plan, st_b, blk, exact=True,
                                               exact_impl="gather")
            assert np.array_equal(np.asarray(oa), np.asarray(ob)), (i_, d_, b)


def test_packed_row_tier_bitexact_all_tiers():
    """The packed-row matmul tier (plan.k_row) is bit-identical to the
    gather oracle across streaming steps, and the fast tier matches the
    transposed-residue fast tier exactly (same int32 accumulators)."""
    import jax.numpy as jnp

    from tsl_sdr_tpu.ops import polyphase, q14
    from tsl_sdr_tpu.utils.filter_design import (
        design_rational_resampler_filter,
    )

    rng = np.random.default_rng(5)
    for (i_f, d_f) in ((16, 25), (3, 2), (4, 5)):
        coeffs = design_rational_resampler_filter(i_f, d_f, 0.4)
        plan = polyphase.make_resampler_plan(
            q14.quantize_q14(coeffs), i_f, d_f, block_out_target=2048
        )
        assert plan.k_row > 0 and plan.k_row % 128 == 0
        x = rng.integers(
            -12000, 12000, size=(plan.carry_len + 3 * plan.block_in,),
            dtype=np.int64,
        ).astype(np.int16)
        pre = x[: plan.carry_len] if plan.carry_len else None
        sts = [polyphase.init_resampler_state(plan, prefix=pre)
               for _ in range(3)]
        outs = [[], [], []]
        for b in range(3):
            blk = x[
                plan.carry_len + b * plan.block_in :
                plan.carry_len + (b + 1) * plan.block_in
            ]
            sts[0], o0 = polyphase.resample_step(
                plan, sts[0], blk, exact=True, exact_impl="gather"
            )
            sts[1], o1 = polyphase.resample_step(
                plan, sts[1], blk, exact=True, exact_impl="packed"
            )
            sts[2], o2 = polyphase.resample_step(
                plan, sts[2], blk, exact=False
            )
            outs[0].append(np.asarray(o0))
            outs[1].append(np.asarray(o1))
            outs[2].append(np.asarray(o2))
        gather = np.concatenate(outs[0])
        packed = np.concatenate(outs[1])
        fast = np.concatenate(outs[2])
        assert np.array_equal(gather, packed)
        # fast tier: same int32 accumulators scaled to float
        assert np.allclose(
            fast, gather.astype(np.float32), atol=1.0
        )


def test_packed_row_fallback_for_awkward_ratio():
    """Ratios whose lcm(I_rep, 128) explodes fall back to the
    transposed-residue tier and stay bit-exact."""
    from tsl_sdr_tpu.ops import polyphase, q14
    from tsl_sdr_tpu.utils.filter_design import (
        design_rational_resampler_filter,
    )

    rng = np.random.default_rng(6)
    coeffs = design_rational_resampler_filter(147, 160, 0.4)
    plan = polyphase.make_resampler_plan(
        q14.quantize_q14(coeffs), 147, 160, block_out_target=2048
    )
    assert plan.k_row == 0
    # heavy upsamplers (spill > ROW_IN) must also fall back, not crash
    for i_f, d_f in ((64, 1), (64, 3), (32, 5)):
        up = polyphase.make_resampler_plan(
            q14.quantize_q14(design_rational_resampler_filter(i_f, d_f, 0.4)),
            i_f, d_f, block_out_target=2048,
        )
        assert up.k_row == 0
    x = rng.integers(
        -12000, 12000, size=(plan.carry_len + plan.block_in,),
        dtype=np.int64,
    ).astype(np.int16)
    pre = x[: plan.carry_len] if plan.carry_len else None
    st1 = polyphase.init_resampler_state(plan, prefix=pre)
    st2 = polyphase.init_resampler_state(plan, prefix=pre)
    _, o1 = polyphase.resample_step(
        plan, st1, x[plan.carry_len :], exact=True, exact_impl="gather"
    )
    _, o2 = polyphase.resample_step(
        plan, st2, x[plan.carry_len :], exact=True, exact_impl="packed"
    )
    assert np.array_equal(np.asarray(o1), np.asarray(o2))
