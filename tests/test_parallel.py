import numpy as np
import jax
import pytest

from tsl_sdr_tpu.parallel.mesh import make_mesh
from tsl_sdr_tpu.testing.numerics import check_sharded_multifm
from tsl_sdr_tpu.utils.filter_design import firdes_low_pass

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 virtual devices"
)


def _equality_case(nr_channels, time_shards, ch_shards, taps=33, seed=60):
    """Sharded output == primed single-device run, element-for-element
    (within the documented f32-reassociation 1-LSB slack), at the given
    mesh shape and channel count."""
    r = check_sharded_multifm(nr_channels, time_shards, ch_shards, taps=taps,
                              decimation=4, fs=128_000, segment=512 * 4,
                              seed=seed)
    assert r["equal_ok"], r


@pytest.mark.parametrize("time_shards,ch_shards", [(4, 2), (2, 4), (8, 1)])
def test_sharded_matches_single_device(time_shards, ch_shards):
    _equality_case(nr_channels=8, time_shards=time_shards,
                   ch_shards=ch_shards)


def test_sharded_matches_single_device_64ch():
    """64-channel bank (8x the reference flagship) across 2 mesh shapes."""
    _equality_case(nr_channels=64, time_shards=2, ch_shards=4, taps=17,
                   seed=61)
    _equality_case(nr_channels=64, time_shards=4, ch_shards=2, taps=17,
                   seed=62)


def test_multihost_device_layout():
    """make_global_mesh's layout math: channel rows never cross a host and
    the time axis walks hosts in process order (multihost.py claims)."""
    from tsl_sdr_tpu.parallel.multihost import layout_devices

    class Dev:
        def __init__(self, proc, idx):
            self.process_index = proc
            self.id = proc * 100 + idx

    # 4 hosts x 8 local devices, 2-channel shards per host
    devs = [Dev(p, i) for p in range(4) for i in range(8)]
    arr = layout_devices(devs, n_local=8, channels_per_host=2)
    assert arr.shape == (16, 2)
    for row in arr:
        assert len({d.process_index for d in row}) == 1  # one host per row
    # time order == process order: rows 0-3 host 0, 4-7 host 1, ...
    assert [arr[t, 0].process_index for t in range(16)] == [
        t // 4 for t in range(16)]
    # every device appears exactly once
    assert len({d.id for d in arr.reshape(-1)}) == 32

    with pytest.raises(ValueError):
        layout_devices(devs, n_local=8, channels_per_host=3)


def test_dryrun_multichip():
    import __graft_entry__

    __graft_entry__.dryrun_multichip(8)


def test_entry_compiles():
    import __graft_entry__

    fn, args = __graft_entry__.entry()
    out_state, pcm = jax.jit(fn)(*args)
    assert np.asarray(pcm).shape[0] == 4  # n_blocks


def test_sharded_resampler_matches_single_device():
    from tsl_sdr_tpu.ops import polyphase, q14
    from tsl_sdr_tpu.parallel.resampler import make_sharded_resampler
    from tsl_sdr_tpu.utils.filter_design import design_rational_resampler_filter

    coeffs = design_rational_resampler_filter(16, 25, 0.4)
    plan = polyphase.make_resampler_plan(
        q14.quantize_q14(coeffs), 16, 25, block_out_target=1024
    )
    # per-shard span must be divisible by d_rep; 8 shards
    n = 8 * 40 * plan.d_rep
    rng = np.random.default_rng(61)
    x = rng.integers(-12000, 12000, size=n, dtype=np.int64).astype(np.int16)

    mesh = make_mesh(time=8, channels=1, devices=jax.devices()[:8])
    fn = make_sharded_resampler(plan, mesh)
    got = np.asarray(fn(x))

    # single-device reference primed with the stream head so its output 0
    # is the window at stream offset 0, like the sharded form
    st = polyphase.init_resampler_state(plan, prefix=x[: plan.carry_len])
    pos = plan.carry_len
    xx = np.concatenate([x, np.zeros(plan.block_in, np.int16)])
    want = []
    while pos + plan.block_in <= len(xx):
        st, o = polyphase.resample_step(plan, st, xx[pos : pos + plan.block_in],
                                        exact=False)
        want.append(np.asarray(o))
        pos += plan.block_in
    want = np.concatenate(want)[: got.shape[0]]

    # same formulation, different partition of the f32 sums -> tiny ulp slack
    np.testing.assert_allclose(got, want, rtol=0, atol=2.0)
    assert got.shape[0] == n * 16 // 25


def test_sharded_resampler_row_and_residue_paths_agree():
    """The packed-row shard kernel (shard length % ROW_IN == 0) and the
    transposed-residue fallback produce the same stream."""
    from tsl_sdr_tpu.ops import polyphase, q14
    from tsl_sdr_tpu.parallel.resampler import make_sharded_resampler
    from tsl_sdr_tpu.utils.filter_design import design_rational_resampler_filter

    coeffs = design_rational_resampler_filter(16, 25, 0.4)
    plan = polyphase.make_resampler_plan(
        q14.quantize_q14(coeffs), 16, 25, block_out_target=1024
    )
    assert plan.k_row == 128 and plan.row_in == 200
    rng = np.random.default_rng(62)
    mesh = make_mesh(time=8, channels=1, devices=jax.devices()[:8])
    fn = make_sharded_resampler(plan, mesh)

    n_row = 8 * plan.row_in * 3          # hits the packed-row path
    n_res = n_row + 8 * plan.d_rep       # d_rep-aligned but not row-aligned
    x = rng.integers(-12000, 12000, size=n_res, dtype=np.int64).astype(
        np.int16
    )

    def single_chip(xx):
        # stream the primed single-device fast tier over the capture
        st = polyphase.init_resampler_state(plan, prefix=xx[: plan.carry_len])
        pos = plan.carry_len
        xp = np.concatenate([xx, np.zeros(plan.block_in, np.int16)])
        outs = []
        while pos + plan.block_in <= len(xp):
            st, o = polyphase.resample_step(
                plan, st, xp[pos : pos + plan.block_in], exact=False
            )
            outs.append(np.asarray(o))
            pos += plan.block_in
        return np.concatenate(outs)

    got_row = np.asarray(fn(x[:n_row]))          # packed-row shard path
    assert got_row.shape[0] == n_row * 16 // 25
    want_row = single_chip(x[:n_row])[: got_row.shape[0]]
    # both compute the same int32 wrap sums; only outputs whose window
    # crosses the end-of-capture zero halo may differ — trim one row group
    trim = plan.k_row
    np.testing.assert_allclose(
        got_row[:-trim], want_row[:-trim], rtol=0, atol=0
    )

    out_res = np.asarray(fn(x))                  # residue fallback path
    assert out_res.shape[0] == n_res * 16 // 25
    want_res = single_chip(x)[: out_res.shape[0]]
    # residue tier partitions the f32 sums differently -> ulp slack
    np.testing.assert_allclose(
        out_res[:-trim], want_res[:-trim], rtol=0, atol=2.0
    )


@pytest.mark.parametrize("ch_shards", [2, 8])
def test_channel_sharded_pipeline_messages_match(ch_shards):
    """ReceivePipeline(mesh=...): the fused streaming program GSPMD-
    partitioned across the 'channels' axis decodes the identical messages
    to the single-device program (the FIR contraction dim stays local to
    each shard, so even the PCM is bit-identical)."""
    from tsl_sdr_tpu.models.pipeline import ChannelSpec, ReceivePipeline
    from tsl_sdr_tpu.testing import pocsag_gen

    decim, fs, center = 32, 38400 * 32, 929_500_000
    offsets = [-450_000 + 120_000 * k for k in range(8)]
    rng = np.random.default_rng(8)
    parts = None
    for k in (0, 3, 5):
        bb = pocsag_gen.generate(
            [pocsag_gen.PocsagBurst(capcode=300000 + k, function=1,
                                    kind="alpha", content=f"SH{k}")],
            baud=1200, amplitude=4096, tail_bits=256)
        dev = bb.astype(np.float64) / 16384.0 * 19200
        ph = np.cumsum(np.repeat(2 * np.pi * (offsets[k] + dev) / fs, decim))
        sig = np.stack([np.cos(ph), np.sin(ph)], -1) * 3500
        if parts is None:
            parts = np.zeros((len(sig) + 800_000, 2))
        parts[400_000:400_000 + len(sig)] += sig
    iq = (parts + rng.normal(scale=90, size=parts.shape)).astype(np.int16)
    lpf = firdes_low_pass(1.0, fs, 12_000, 8_000)
    specs = [ChannelSpec(center + o, "pocsag") for o in offsets]

    base = ReceivePipeline(lpf, center, fs, decim, specs, exact=False,
                           block_size=393_216)
    want = [[(m.capcode, m.data) for m in ch]
            for ch in base.process_capture(iq)]
    assert sum(len(c) for c in want) == 3

    mesh = make_mesh(time=8 // ch_shards, channels=ch_shards)
    pipe = ReceivePipeline(lpf, center, fs, decim, specs, exact=False,
                           block_size=393_216, mesh=mesh)
    got = [[(m.capcode, m.data) for m in ch]
           for ch in pipe.process_capture(iq)]
    assert got == want


def test_time_sharded_pipeline_messages_match():
    """Time-axis GSPMD: each block's SAMPLES split across 8 devices
    (single-stream scaling) with real resampler ratios (POCSAG 3/4,
    FLEX 5/16, AIS 15/16), a dc_block channel, and egress gating — the
    decoded messages and the per-channel fetch counters equal the
    single-device run. Integer stages partition exactly; the dc fast
    tier's f32 scan may differ by LSBs, absorbed by decode margins."""
    from tsl_sdr_tpu.models.pipeline import ChannelSpec, ReceivePipeline
    from tsl_sdr_tpu.testing import ais_gen, flex_gen, pocsag_gen
    from tests.test_pipeline import _fm_mod
    from tests.test_pipeline_stream import _keys

    decim = 24
    fs = 51200 * decim
    center = 929_500_000
    p_bb = pocsag_gen.generate(
        [pocsag_gen.PocsagBurst(capcode=555001, function=2, kind="alpha",
                                content="TS POCSAG")],
        baud=1200, amplitude=4096, tail_bits=128)
    p_iq = _fm_mod(p_bb, 38400, 250_000, fs)
    f_bb, _ = flex_gen.generate(
        [flex_gen.FlexBurstMessage(capcode=555002, kind="alnum",
                                   content="TS FLEX")],
        baud=1600, fsk_levels=2, amplitude=6144, tail_bits=200)
    f_iq = _fm_mod(f_bb, 16000, -180_000, fs, amp=7000)
    a_bb = ais_gen.generate(
        [ais_gen.make_position_report(367999111, longitude=-70.9,
                                      latitude=42.36)], amplitude=9000)
    a_iq = _fm_mod(a_bb, 48000, 400_000, fs, amp=7000, dev_hz=4800)
    rng = np.random.default_rng(17)
    n = max(len(p_iq), len(f_iq), len(a_iq)) + 700_000
    iq = rng.normal(scale=100, size=(n, 2))
    for s in (p_iq, f_iq, a_iq):
        iq[250_000:250_000 + len(s)] += s
    iq = iq.astype(np.int16)
    specs = [ChannelSpec(center + 250_000, "pocsag", dc_block=True),
             ChannelSpec(center - 180_000, "flex"),
             ChannelSpec(center + 400_000, "ais"),
             ChannelSpec(center - 350_000, "pocsag")]  # silent: gated
    lpf = firdes_low_pass(1.0, fs, 12_000, 8_000)

    base = ReceivePipeline(lpf, center, fs, decim, specs, exact=False,
                           block_size=393_216)
    want = _keys(base.process_capture(iq))
    assert want[0] and want[1] and want[2] and not want[3], want

    pipe = ReceivePipeline(lpf, center, fs, decim, specs, exact=False,
                           block_size=393_216,
                           mesh=make_mesh(time=8, channels=1))
    assert _keys(pipe.process_capture(iq)) == want
    assert (pipe.stream_stats["fetched"] ==
            base.stream_stats["fetched"]).all()


def test_sharded_pipeline_checkpoint_resume(tmp_path):
    """checkpoint_stream/restore_stream on a mesh-sharded pipeline: the
    sharded carried state round-trips through the .npz (np.asarray
    gathers, device_put re-distributes under the program's sharding
    constraint) and the two-run decode equals one uninterrupted run."""
    from tsl_sdr_tpu.models.pipeline import ChannelSpec, ReceivePipeline
    from tsl_sdr_tpu.testing import pocsag_gen
    from tests.test_pipeline import _fm_mod
    from tests.test_pipeline_stream import _keys

    decim, fs, center = 32, 38400 * 32, 929_500_000
    rng = np.random.default_rng(9)

    def burst(cap, txt):
        bb = pocsag_gen.generate(
            [pocsag_gen.PocsagBurst(capcode=cap, function=1, kind="alpha",
                                    content=txt)],
            baud=1200, amplitude=4096, tail_bits=256)
        return _fm_mod(bb, 38400, 250_000, fs).astype(np.int16)

    pad = rng.integers(-300, 300, size=(700_000, 2)).astype(np.int16)
    iq = np.concatenate([pad, burst(111, "MESH ONE"), pad,
                         burst(222, "MESH TWO"), pad])
    iq = (iq + rng.normal(scale=90, size=iq.shape)).astype(np.int16)
    lpf = firdes_low_pass(1.0, fs, 9_600, 7_000)
    specs = [ChannelSpec(center + 250_000, "pocsag"),
             ChannelSpec(center - 250_000, "pocsag")]

    def mk():
        return ReceivePipeline(lpf, center, fs, decim, specs, exact=False,
                               block_size=393_216,
                               mesh=make_mesh(time=2, channels=2))

    want = _keys(mk().process_capture(iq))
    assert [k[1] for k in want[0]] == [111, 222]

    half = len(iq) // 2
    state = tmp_path / "s.npz"
    p1 = mk()
    got = _keys(p1.push(iq[:half]))
    for i, part in enumerate(_keys(p1.checkpoint_stream(state))):
        got[i].extend(part)
    p2 = mk()
    p2.restore_stream(state)
    for res in (p2.push(iq[half:]), p2.flush()):
        keys = _keys(res)
        for i in range(len(specs)):
            got[i].extend(keys[i])
    assert got == want


def test_channel_sharded_pipeline_mixed_protocols():
    """mesh= with resampler-bearing channels (FLEX 16k, AIS 48k) and an
    indivisible channel count: 5 channels over 2 shards skips the
    constraint (graceful no-op), 6 channels partition — both decode
    identically to the single-device program."""
    from tsl_sdr_tpu.models.pipeline import ChannelSpec, ReceivePipeline
    from tests.test_pipeline_stream import _capture, _keys, _specs

    iq = _capture()
    fs = 38400 * 32
    lpf = firdes_low_pass(1.0, fs, 12_000, 8_000)

    for extra in ([], [ChannelSpec(929_500_000 - 480_000, "ais")]):
        specs = _specs() + extra          # 5 (indivisible) then 6 channels
        base = ReceivePipeline(lpf, 929_500_000, fs, 32, specs,
                               exact=False, block_size=262_144)
        want = _keys(base.process_capture(iq))
        assert sum(len(c) for c in want) == 3
        mesh = make_mesh(time=4, channels=2)
        pipe = ReceivePipeline(lpf, 929_500_000, fs, 32, specs,
                               exact=False, block_size=262_144, mesh=mesh)
        assert _keys(pipe.process_capture(iq)) == want
