"""Streaming ReceivePipeline: push()/flush() incremental feeding, the
fused single-dispatch device path, and device-prefilter egress gating.

Reference deployment context: the multifm + per-channel decoder processes
run forever on live streams (/root/reference/multifm/multifm.c:163-165,
decoder/decoder.c:581-656); push() is that contract in one process.
"""

import time

import numpy as np

from tsl_sdr_tpu.models.pipeline import ChannelSpec, ReceivePipeline
from tsl_sdr_tpu.testing import ais_gen, flex_gen, pocsag_gen
from tsl_sdr_tpu.utils.filter_design import firdes_low_pass

from tests.test_pipeline import _fm_mod

DECIM = 32
FS = 38400 * DECIM
CENTER = 929_500_000


def _capture(seed=21):
    """3 protocol channels + 1 silent POCSAG channel in one capture."""
    p_bb = pocsag_gen.generate(
        [pocsag_gen.PocsagBurst(capcode=1122334, function=2, kind="alpha",
                                content="STREAM POCSAG")],
        baud=1200, amplitude=4096, tail_bits=256)
    p_iq = _fm_mod(p_bb, 38400, 250_000, FS)

    f_bb, _ = flex_gen.generate(
        [flex_gen.FlexBurstMessage(capcode=1234567, kind="alnum",
                                   content="STREAM FLEX")],
        baud=1600, fsk_levels=2, amplitude=6144, tail_bits=300)
    f_iq = _fm_mod(f_bb, 16000, -180_000, FS, amp=7000)

    a_bb = ais_gen.generate(
        [ais_gen.make_position_report(367999111, longitude=-70.9,
                                      latitude=42.36)], amplitude=9000)
    a_iq = _fm_mod(a_bb, 48000, 400_000, FS, amp=7000, dev_hz=4800)

    n = max(len(p_iq), len(f_iq), len(a_iq)) + 600_000
    iq = np.zeros((n, 2))
    iq[300_000:300_000 + len(p_iq)] += p_iq
    iq[300_000:300_000 + len(f_iq)] += f_iq
    iq[300_000:300_000 + len(a_iq)] += a_iq
    rng = np.random.default_rng(seed)
    return (iq + rng.normal(scale=120, size=iq.shape)).astype(np.int16)


def _specs():
    return [
        # dc_block exercises the fused engine's per-channel DC stage
        ChannelSpec(CENTER + 250_000, "pocsag", dc_block=True),
        ChannelSpec(CENTER - 180_000, "flex"),
        ChannelSpec(CENTER + 400_000, "ais"),
        ChannelSpec(CENTER - 350_000, "pocsag"),  # silent: gating target
        ChannelSpec(CENTER + 480_000, "ais"),     # silent: AIS gating
    ]


def _keys(results):
    out = []
    for msgs in results:
        ch = []
        for m in msgs:
            if hasattr(m, "capcode"):
                ch.append(("pg", m.capcode, bytes(m.data)))
            elif hasattr(m, "mmsi"):
                ch.append(("ais", m.mmsi))
            else:
                ch.append(("?", repr(m)))
        out.append(ch)
    return out


def test_push_increments_equal_process_capture():
    """Feeding the capture in arbitrary-size push() slices produces the
    identical messages to one process_capture call."""
    iq = _capture()
    lpf = firdes_low_pass(1.0, FS, 12_000, 8_000)

    pipe_a = ReceivePipeline(lpf, CENTER, FS, DECIM, _specs(), exact=False,
                             block_size=262_144)
    want = _keys(pipe_a.process_capture(iq))
    assert len(want[0]) == 1 and want[0][0][1] == 1122334
    assert want[0][0][2].startswith(b"STREAM POCSAG")
    assert any(k[0] == "ais" for k in want[2])

    nch = len(_specs())
    pipe_b = ReceivePipeline(lpf, CENTER, FS, DECIM, _specs(), exact=False,
                             block_size=262_144)
    rng = np.random.default_rng(3)
    got = [[] for _ in range(nch)]
    i = 0
    while i < len(iq):
        ln = int(rng.integers(50_000, 400_000))
        part = pipe_b.push(iq[i : i + ln])
        for c in range(nch):
            got[c].extend(part[c])
        i += ln
    part = pipe_b.flush()
    for c in range(nch):
        got[c].extend(part[c])
    assert _keys(got) == want

    # the silent channels were egress-gated: their bit rows were fetched
    # for (at most) a couple of false-positive blocks, not every block
    stats = pipe_b.stream_stats
    assert stats["blocks"] >= 10
    assert stats["fetched"][3] <= stats["blocks"] // 3, stats  # pocsag idle
    assert stats["fetched"][4] <= stats["blocks"] // 3, stats  # ais idle
    # the active POCSAG channel fetched at least its burst blocks
    assert stats["fetched"][0] >= 1


def test_burst_straddles_push_block_boundary():
    """A message whose sync lands right at a streaming block boundary
    still decodes (carried prefilter tail + gap refeed margin)."""
    lpf = firdes_low_pass(1.0, FS, 12_000, 8_000)
    pipe = ReceivePipeline(
        lpf, CENTER, FS, DECIM,
        [ChannelSpec(CENTER + 250_000, "pocsag")], exact=False,
        block_size=262_144)
    bs = pipe.block_size

    p_bb = pocsag_gen.generate(
        [pocsag_gen.PocsagBurst(capcode=777777, function=1, kind="alpha",
                                content="BOUNDARY")],
        baud=1200, amplitude=4096, tail_bits=64)
    p_iq = _fm_mod(p_bb, 38400, 250_000, FS)
    rng = np.random.default_rng(5)
    # place the burst start just before a block boundary so its sync word
    # completes across it
    start = bs + pipe.chain.carry_len - 40_000
    n = start + len(p_iq) + bs
    iq = rng.normal(scale=120, size=(n, 2))
    iq[start : start + len(p_iq)] += p_iq
    iq = iq.astype(np.int16)

    got = []
    for part in (pipe.push(iq), pipe.flush()):
        got.extend(part[0])
    assert len(got) == 1 and got[0].capcode == 777777
    assert bytes(got[0].data).startswith(b"BOUNDARY")


def test_gated_leading_blocks_consume_resampler_transient():
    """The zero-history resampler transient (lead_drop) belongs to the
    stream's first samples, which live in whatever block covers them —
    fetched or egress-gated.  A silent (gated) leading block must consume
    it; the first *fetched* block later in the stream must not lose real
    samples to a stale lead_drop (regression: the trim used to apply to
    the first fetched block regardless of stream position)."""
    decim = 24
    fs = 51200 * decim  # channel rate 51200 -> POCSAG resamples 3/4
    lpf = firdes_low_pass(1.0, fs, 12_000, 8_000)

    def mk():
        return ReceivePipeline(
            lpf, CENTER, fs, decim,
            [ChannelSpec(CENTER + 250_000, "pocsag")], exact=False,
            block_size=262_144)

    pipe = mk()
    bs = pipe.block_size
    gid = pipe._ratio_gid[0]
    assert gid is not None, "config must exercise a real resampler ratio"

    p_bb = pocsag_gen.generate(
        [pocsag_gen.PocsagBurst(capcode=424242, function=1, kind="alpha",
                                content="TRANSIENT")],
        baud=1200, amplitude=4096, tail_bits=64)
    p_iq = _fm_mod(p_bb, 38400, 250_000, fs)
    rng = np.random.default_rng(11)
    # two full blocks of noise first: the channel is idle, its bit rows
    # are egress-gated, and the transient window passes entirely inside
    # gated block 0
    start = 2 * bs + pipe.chain.carry_len + 4_096
    n = start + len(p_iq) + bs
    iq = rng.normal(scale=120, size=(n, 2))
    iq[start : start + len(p_iq)] += p_iq
    iq = iq.astype(np.int16)

    got = []
    for part in (pipe.push(iq), pipe.flush()):
        got.extend(part[0])
    assert len(got) == 1 and got[0].capcode == 424242
    assert bytes(got[0].data).startswith(b"TRANSIENT")
    stats = pipe.stream_stats
    assert stats["fetched"][0] < stats["blocks"], (
        "leading noise blocks must be gated for this test to bite")

    # same messages as the stage-by-stage host oracle
    want = _keys(mk()._process_capture_host(iq, device_decode=False))
    assert _keys([got]) == want

    # whitebox: after the first drained (gated) block the transient is
    # fully consumed — the old code left it pending until the first fetch
    pipe2 = mk()
    pipe2.push(iq[: 4 * bs + pipe2.chain.carry_len])
    s = pipe2._stream
    assert s["blocks"] >= 1
    assert all(v == 0 for v in s["lead_drop"].values()), s["lead_drop"]


def test_exact_tier_streaming_push_equals_host_oracle():
    """The bit-exact tier streams through push()/flush() (host-coordinated
    block loop over the exact steps) and must reproduce the whole-capture
    host path bit-for-bit: identical messages on resampled protocol
    channels, identical samples on a raw pcm channel."""
    decim = 24
    fs = 51200 * decim  # POCSAG 3/4, FLEX 5/16 resampler ratios
    lpf = firdes_low_pass(1.0, fs, 12_000, 8_000)
    specs = [
        ChannelSpec(CENTER + 250_000, "pocsag", dc_block=True),
        ChannelSpec(CENTER - 180_000, "flex"),
        ChannelSpec(CENTER + 400_000, "pcm"),
    ]

    p_bb = pocsag_gen.generate(
        [pocsag_gen.PocsagBurst(capcode=555001, function=2, kind="alpha",
                                content="EXACT STREAM")],
        baud=1200, amplitude=4096, tail_bits=128)
    p_iq = _fm_mod(p_bb, 38400, 250_000, fs)
    f_bb, _ = flex_gen.generate(
        [flex_gen.FlexBurstMessage(capcode=555002, kind="alnum",
                                   content="EXACT FLEX")],
        baud=1600, fsk_levels=2, amplitude=6144, tail_bits=200)
    f_iq = _fm_mod(f_bb, 16000, -180_000, fs, amp=7000)

    n = max(len(p_iq), len(f_iq)) + 500_000
    rng = np.random.default_rng(17)
    iq = rng.normal(scale=100, size=(n, 2))
    iq[200_000:200_000 + len(p_iq)] += p_iq
    iq[200_000:200_000 + len(f_iq)] += f_iq
    iq = iq.astype(np.int16)

    def mk():
        return ReceivePipeline(lpf, CENTER, fs, decim, specs, exact=True,
                               block_size=262_144)

    want = mk().process_capture(iq)  # exact tier -> host whole-capture path
    assert [m.capcode for m in want[0]] == [555001]
    assert any(getattr(m, "capcode", None) == 555002 for m in want[1])

    pipe = mk()
    got = [[] for _ in specs]
    i0 = 0
    while i0 < len(iq):
        ln = int(rng.integers(40_000, 300_000))
        for c, part in enumerate(pipe.push(iq[i0 : i0 + ln])):
            got[c].extend(part)
        i0 += ln
    for c, part in enumerate(pipe.flush()):
        got[c].extend(part)

    assert _keys(got[:2]) == _keys(want[:2])
    pcm_got = (np.concatenate(got[2]) if got[2]
               else np.zeros(0, np.int16))
    np.testing.assert_array_equal(pcm_got, np.asarray(want[2]))


def test_pipeline_cli_follow_fifo(tmp_path):
    """pipeline-tpu --follow on a FIFO fed incrementally produces the same
    JSON messages as a one-shot process_capture run (VERDICT r2 item 4)."""
    import json
    import os
    import threading

    from tsl_sdr_tpu.cli import pipeline as pipeline_cli

    iq = _capture(seed=33)
    fifo = tmp_path / "iq.fifo"
    os.mkfifo(fifo)

    lpf = firdes_low_pass(1.0, FS, 12_000, 8_000)
    cfg = {
        "device": {"type": "file", "filename": str(fifo),
                   "fileFormat": "cs16"},
        "sampleRateHz": FS,
        "centerFreqHz": CENTER,
        "decimationFactor": DECIM,
        "lpfTaps": list(map(float, lpf)),
        "channels": [
            {"chanCenterFreq": CENTER + 250_000, "protocol": "pocsag"},
            {"chanCenterFreq": CENTER - 180_000, "protocol": "flex"},
            {"chanCenterFreq": CENTER + 400_000, "protocol": "ais"},
        ],
    }
    cfg_path = tmp_path / "pipe.json"
    cfg_path.write_text(json.dumps(cfg))
    out_path = tmp_path / "msgs.jsonl"

    raw = np.ascontiguousarray(iq).tobytes()

    def writer():
        import time as _t

        with open(fifo, "wb") as f:
            step = 1 << 19
            for o in range(0, len(raw), step):
                f.write(raw[o : o + step])
                f.flush()
                _t.sleep(0.002)

    t = threading.Thread(target=writer, daemon=True)
    t.start()
    rc = pipeline_cli.main(
        [str(cfg_path), "--follow", "--block-size", "262144",
         "-o", str(out_path)]
    )
    t.join(timeout=60)
    assert rc == 0
    msgs = [json.loads(line) for line in out_path.read_text().splitlines()]

    # same capture, one-shot reference run
    pipe = ReceivePipeline(
        lpf, CENTER, FS, DECIM,
        [ChannelSpec(CENTER + 250_000, "pocsag"),
         ChannelSpec(CENTER - 180_000, "flex"),
         ChannelSpec(CENTER + 400_000, "ais")],
        exact=False, block_size=262_144)
    want = pipe.process_capture(iq)
    assert len(msgs) == sum(len(w) for w in want)
    caps = {m.get("capCode") for m in msgs}
    assert 1122334 in caps and 1234567 in caps


def test_pipeline_cli_follow_growing_regular_file(tmp_path):
    """--follow on a REGULAR file that is still being written must poll
    past momentary EOF (a writer ahead of the reader used to truncate the
    capture at the first empty read) and stop via --idle-exit."""
    import json
    import threading

    from tsl_sdr_tpu.cli import pipeline as pipeline_cli

    iq = _capture(seed=41)
    path = tmp_path / "grow.cs16"
    path.write_bytes(b"")

    lpf = firdes_low_pass(1.0, FS, 12_000, 8_000)
    cfg = {
        "device": {"type": "file", "filename": str(path),
                   "fileFormat": "cs16"},
        "sampleRateHz": FS,
        "centerFreqHz": CENTER,
        "decimationFactor": DECIM,
        "lpfTaps": list(map(float, lpf)),
        "channels": [
            {"chanCenterFreq": CENTER + 250_000, "protocol": "pocsag"},
        ],
    }
    cfg_path = tmp_path / "pipe.json"
    cfg_path.write_text(json.dumps(cfg))
    out_path = tmp_path / "msgs.jsonl"

    raw = np.ascontiguousarray(iq).tobytes()

    def writer():
        import time as _t

        _t.sleep(0.3)  # reader hits EOF on the empty file first
        with open(path, "ab") as f:
            step = 1 << 18
            for o in range(0, len(raw), step):
                f.write(raw[o : o + step])
                f.flush()
                _t.sleep(0.02)

    t = threading.Thread(target=writer, daemon=True)
    t.start()
    rc = pipeline_cli.main(
        [str(cfg_path), "--follow", "--block-size", "262144",
         "--idle-exit", "1.5", "-o", str(out_path)]
    )
    t.join(timeout=60)
    assert rc == 0
    msgs = [json.loads(line) for line in out_path.read_text().splitlines()]
    ref = ReceivePipeline(
        lpf, CENTER, FS, DECIM,
        [ChannelSpec(CENTER + 250_000, "pocsag")],
        exact=False, block_size=262144,
    ).process_capture(iq)
    assert len(msgs) == len(ref[0]) > 0


def test_pipeline_cli_follow_exact_tier(tmp_path):
    """--follow now streams the bit-exact tier too (host-coordinated
    exact block loop); one POCSAG message decodes from a FIFO feed."""
    import json
    import os
    import threading

    from tsl_sdr_tpu.cli import pipeline as pipeline_cli

    p_bb = pocsag_gen.generate(
        [pocsag_gen.PocsagBurst(capcode=808080, function=1, kind="alpha",
                                content="EXACT FOLLOW")],
        baud=1200, amplitude=4096, tail_bits=64)
    p_iq = _fm_mod(p_bb, 38400, 250_000, FS)
    rng = np.random.default_rng(7)
    n = len(p_iq) + 700_000
    iq = rng.normal(scale=120, size=(n, 2))
    iq[300_000:300_000 + len(p_iq)] += p_iq
    iq = iq.astype(np.int16)

    fifo = tmp_path / "iq.fifo"
    os.mkfifo(fifo)
    lpf = firdes_low_pass(1.0, FS, 12_000, 8_000)
    cfg = {
        "device": {"type": "file", "filename": str(fifo),
                   "fileFormat": "cs16"},
        "sampleRateHz": FS,
        "centerFreqHz": CENTER,
        "decimationFactor": DECIM,
        "lpfTaps": list(map(float, lpf)),
        "channels": [
            {"chanCenterFreq": CENTER + 250_000, "protocol": "pocsag"},
        ],
    }
    cfg_path = tmp_path / "pipe.json"
    cfg_path.write_text(json.dumps(cfg))
    out_path = tmp_path / "msgs.jsonl"
    raw = np.ascontiguousarray(iq).tobytes()

    def writer():
        with open(fifo, "wb") as f:
            step = 1 << 19
            for o in range(0, len(raw), step):
                f.write(raw[o : o + step])

    t = threading.Thread(target=writer, daemon=True)
    t.start()
    rc = pipeline_cli.main(
        [str(cfg_path), "--follow", "--exact", "--block-size", "262144",
         "-o", str(out_path)]
    )
    t.join(timeout=60)
    assert rc == 0
    msgs = [json.loads(line) for line in out_path.read_text().splitlines()]
    assert [m.get("capCode") for m in msgs] == [808080]


def test_pipeline_block_size_floor_covers_gap_tail():
    """A tiny requested block_size is bumped so each pack channel's
    per-block output covers the carried prefilter tail (gap-rewind
    soundness: a shorter block would re-feed already-decoded bits)."""
    from tsl_sdr_tpu.ops import sync_prefilter

    lpf = firdes_low_pass(1.0, FS, 12_000, 8_000)
    pipe = ReceivePipeline(
        lpf, CENTER, FS, DECIM,
        [ChannelSpec(CENTER + 250_000, "pocsag")],
        exact=False, block_size=1,
    )
    gid = pipe._ratio_gid[0]
    k_chain = pipe.block_size // DECIM
    k_out = (k_chain * gid[0] // gid[1]) if gid else k_chain
    assert k_out >= sync_prefilter.POCSAG_TAIL


def test_inflight_depth_does_not_change_messages():
    """Deeper device->host latency-hiding queues (inflight_depth) reorder
    only WHEN blocks drain, never WHAT they decode: every depth produces
    the identical message stream, including across flush()."""
    iq = _capture(seed=33)
    lpf = firdes_low_pass(1.0, FS, 12_000, 8_000)
    want = None
    for depth in (1, 2, 7):
        pipe = ReceivePipeline(lpf, CENTER, FS, DECIM, _specs(),
                               exact=False, block_size=262_144,
                               inflight_depth=depth)
        rng = np.random.default_rng(40 + depth)
        got = [[] for _ in _specs()]
        i = 0
        while i < len(iq):
            ln = int(rng.integers(60_000, 350_000))
            for c, part in enumerate(pipe.push(iq[i : i + ln])):
                got[c].extend(part)
            i += ln
        for c, part in enumerate(pipe.flush()):
            got[c].extend(part)
        keys = _keys(got)
        if want is None:
            want = keys
            assert any(k[1] == 1122334 for k in keys[0])
        else:
            assert keys == want, depth


def test_sixteen_channel_bank_gates_silent_channels():
    """16-channel POCSAG bank, 4 active: the device prefilter keeps the
    12 silent channels' bit rows on the device (fetched==0) while every
    active channel decodes — the egress-gating contract at a bank width
    twice the reference's flagship config (etc/multifm.json)."""
    decim, fs, center = 32, 38400 * 32, 929_500_000
    offsets = [-450_000 + 60_000 * k for k in range(16)]
    active = [1, 6, 9, 14]
    rng = np.random.default_rng(8)
    parts = None
    for k in active:
        bb = pocsag_gen.generate(
            [pocsag_gen.PocsagBurst(capcode=200000 + k, function=1,
                                    kind="alpha", content=f"W{k}")],
            baud=1200, amplitude=4096, tail_bits=256)
        dev = bb.astype(np.float64) / 16384.0 * 19200
        ph = np.cumsum(np.repeat(2 * np.pi * (offsets[k] + dev) / fs, decim))
        sig = np.stack([np.cos(ph), np.sin(ph)], -1) * 3500
        if parts is None:
            parts = np.zeros((len(sig) + 800_000, 2))
        parts[400_000:400_000 + len(sig)] += sig
    iq = (parts + rng.normal(scale=90, size=parts.shape)).astype(np.int16)

    pipe = ReceivePipeline(
        firdes_low_pass(1.0, fs, 12_000, 8_000), center, fs, decim,
        [ChannelSpec(center + o, "pocsag") for o in offsets],
        exact=False, block_size=786_432)
    res = pipe.process_capture(iq)
    got = {i: [(m.capcode, m.data) for m in msgs]
           for i, msgs in enumerate(res) if msgs}
    want = {k: [(200000 + k,
                 pocsag_gen.expected_alpha_decode(f"W{k}".encode()))]
            for k in active}
    assert got == want
    stats = pipe.stream_stats
    for i in range(16):
        if i in active:
            assert stats["fetched"][i] >= 1, (i, stats)
        else:
            assert stats["fetched"][i] == 0, (i, stats)


def test_pipeline_cli_channel_shards(tmp_path):
    """pipeline-tpu --channel-shards 2: the CLI builds a channels mesh
    over the virtual devices and decodes identically."""
    import json as jsonlib

    from tsl_sdr_tpu.cli import pipeline as pipeline_cli

    iq = _capture()
    iq_path = tmp_path / "cap.cs16"
    iq.reshape(-1).tofile(iq_path)
    lpf = firdes_low_pass(1.0, FS, 12_000, 8_000)
    cfg = {
        "device": {"type": "file", "filename": str(iq_path),
                   "fileFormat": "cs16"},
        "sampleRateHz": FS, "centerFreqHz": CENTER,
        "decimationFactor": DECIM,
        "lpfTaps": list(map(float, lpf)),
        "channels": [
            {"chanCenterFreq": CENTER + 250_000, "protocol": "pocsag",
             "dcBlock": True},
            {"chanCenterFreq": CENTER - 180_000, "protocol": "flex"},
            {"chanCenterFreq": CENTER + 400_000, "protocol": "ais"},
            {"chanCenterFreq": CENTER - 350_000, "protocol": "pocsag"},
        ],
    }
    cfg_path = tmp_path / "p.json"
    cfg_path.write_text(jsonlib.dumps(cfg))
    out = tmp_path / "m.json"
    rc = pipeline_cli.main([str(cfg_path), "-o", str(out),
                            "--channel-shards", "2"])
    assert rc == 0
    lines = [jsonlib.loads(x) for x in out.read_text().splitlines()]
    protos = sorted(m["proto"] for m in lines)
    assert protos == ["ais", "flex", "pocsag"], lines

    # indivisible channel count is a clean CLI error, not a crash
    cfg["channels"] = cfg["channels"][:3]
    cfg_path.write_text(jsonlib.dumps(cfg))
    rc = pipeline_cli.main([str(cfg_path), "-o", str(out),
                            "--channel-shards", "2"])
    assert rc == 2


def test_pipeline_cli_state_file_kill_and_resume(tmp_path):
    """pipeline-tpu --follow --state-file: run over the first half of a
    capture (process 'dies' at idle-exit, state saved), append the rest,
    rerun — the two runs' messages equal one uninterrupted run."""
    import json as jsonlib

    from tsl_sdr_tpu.cli import pipeline as pipeline_cli
    from tsl_sdr_tpu.models.pipeline import ChannelSpec, ReceivePipeline

    decim, fs, center = 32, 38400 * 32, 929_500_000

    def burst(cap, txt):
        bb = pocsag_gen.generate(
            [pocsag_gen.PocsagBurst(capcode=cap, function=1, kind="alpha",
                                    content=txt)],
            baud=1200, amplitude=4096, tail_bits=256)
        return _fm_mod(bb, 38400, 250_000, fs)

    rng = np.random.default_rng(9)
    pad = rng.integers(-300, 300, size=(900_000, 2)).astype(np.int16)
    iq = np.concatenate([pad, burst(111, "PART ONE").astype(np.int16),
                         pad, burst(222, "PART TWO").astype(np.int16),
                         pad])
    iq = (iq + rng.normal(scale=90, size=iq.shape)).astype(np.int16)
    lpf = firdes_low_pass(1.0, fs, 9_600, 7_000)

    want = [(m.capcode, m.data) for m in ReceivePipeline(
        lpf, center, fs, decim,
        [ChannelSpec(center + 250_000, "pocsag")],
        exact=False, block_size=393_216).process_capture(iq)[0]]
    assert [c for c, _ in want] == [111, 222]

    half = len(iq) // 2
    iq_path = tmp_path / "cap.cs16"
    iq[:half].reshape(-1).tofile(iq_path)
    cfg = {
        "device": {"type": "file", "filename": str(iq_path),
                   "fileFormat": "cs16"},
        "sampleRateHz": fs, "centerFreqHz": center,
        "decimationFactor": decim,
        "lpfTaps": list(map(float, lpf)),
        "channels": [{"chanCenterFreq": center + 250_000,
                      "protocol": "pocsag"}],
    }
    cfg_path = tmp_path / "p.json"
    cfg_path.write_text(jsonlib.dumps(cfg))
    state = tmp_path / "state.npz"
    out1 = tmp_path / "m1.json"
    rc = pipeline_cli.main([str(cfg_path), "--follow", "--idle-exit",
                            "0.3", "--block-size", "393216",
                            "--state-file", str(state),
                            "-o", str(out1)])
    assert rc == 0 and state.exists()

    # the capture grows while the process is down; rerun resumes
    with open(iq_path, "ab") as f:
        iq[half:].reshape(-1).tofile(f)
    out2 = tmp_path / "m2.json"
    rc = pipeline_cli.main([str(cfg_path), "--follow", "--idle-exit",
                            "0.3", "--block-size", "393216",
                            "--state-file", str(state),
                            "-o", str(out2)])
    assert rc == 0
    got = [(m["capCode"], m["message"])
           for p in (out1, out2)
           for m in map(jsonlib.loads, p.read_text().splitlines())]
    assert got == [(c, d.decode()) for c, d in want]


def test_pipeline_cli_follow_live_stats(tmp_path, capsys):
    """--follow --stats prints periodic live lines with rate, messages and
    the egress-gating fetch counters."""
    import json as jsonlib

    from tsl_sdr_tpu.cli import pipeline as pipeline_cli

    rng = np.random.default_rng(3)
    iq = rng.integers(-300, 300, size=(2_000_000, 2)).astype(np.int16)
    path = tmp_path / "cap.cs16"
    iq.reshape(-1).tofile(path)
    lpf = firdes_low_pass(1.0, FS, 12_000, 8_000)
    cfg = {
        "device": {"type": "file", "filename": str(path),
                   "fileFormat": "cs16"},
        "sampleRateHz": FS, "centerFreqHz": CENTER,
        "decimationFactor": DECIM,
        "lpfTaps": list(map(float, lpf)),
        "channels": [{"chanCenterFreq": CENTER + 250_000,
                      "protocol": "pocsag"}],
    }
    cfg_path = tmp_path / "p.json"
    cfg_path.write_text(jsonlib.dumps(cfg))
    rc = pipeline_cli.main([str(cfg_path), "--follow", "--idle-exit", "0.2",
                            "--block-size", "262144", "--stats", "0.0001",
                            "-o", str(tmp_path / "m.jsonl")])
    assert rc == 0
    err = capsys.readouterr().err
    assert "pipeline-tpu: stats samples_in=" in err, err
    assert "Msps]" in err and "fetched=" in err, err


def test_pipeline_cli_realtime_pacing_and_iq_dump(tmp_path):
    """--realtime paces file delivery at sampleRateHz (reference
    file_if.c:160-203) and --iq-dump taps the ingested wideband IQ
    byte-for-byte."""
    import json as jsonlib
    import time as _time

    from tsl_sdr_tpu.cli import pipeline as pipeline_cli

    rng = np.random.default_rng(7)
    iq = rng.integers(-300, 300, size=(900_000, 2)).astype(np.int16)
    path = tmp_path / "cap.cs16"
    iq.reshape(-1).tofile(path)
    lpf = firdes_low_pass(1.0, FS, 12_000, 8_000)
    cfg = {
        "device": {"type": "file", "filename": str(path),
                   "fileFormat": "cs16"},
        "sampleRateHz": FS, "centerFreqHz": CENTER,
        "decimationFactor": DECIM,
        "lpfTaps": list(map(float, lpf)),
        "channels": [{"chanCenterFreq": CENTER + 250_000,
                      "protocol": "pocsag"}],
    }
    cfg_path = tmp_path / "p.json"
    cfg_path.write_text(jsonlib.dumps(cfg))
    dump = tmp_path / "tap.cs16"
    t0 = _time.monotonic()
    rc = pipeline_cli.main([str(cfg_path), "--follow", "--realtime",
                            "--idle-exit", "0.2", "--block-size", "262144",
                            "--iq-dump", str(dump),
                            "-o", str(tmp_path / "m.jsonl")])
    elapsed = _time.monotonic() - t0
    assert rc == 0
    # 900k samples at 1.2288 Msps = 0.73 s of stream time; unpaced this
    # finishes in well under 0.3 s of read time
    assert elapsed >= len(iq) / FS, elapsed
    np.testing.assert_array_equal(
        np.fromfile(dump, np.int16).reshape(-1, 2), iq)


def test_live_decode_latency_bounded_by_inflight_depth():
    """Live-mode latency contract: a message completes within
    inflight_depth+1 block-pushes of the block that carries its last
    samples (the drain lag is exactly the latency-hiding queue depth —
    a paging deployment can size --inflight-depth against it)."""
    lpf = firdes_low_pass(1.0, FS, 12_000, 8_000)
    depth = 2
    pipe = ReceivePipeline(
        lpf, CENTER, FS, DECIM,
        [ChannelSpec(CENTER + 250_000, "pocsag")], exact=False,
        block_size=262_144, inflight_depth=depth)
    bs = pipe.block_size

    p_bb = pocsag_gen.generate(
        [pocsag_gen.PocsagBurst(capcode=909090, function=1, kind="alpha",
                                content="LATENCY")],
        baud=1200, amplitude=4096, tail_bits=64)
    p_iq = _fm_mod(p_bb, 38400, 250_000, FS)
    rng = np.random.default_rng(13)
    start = bs // 2
    burst_end = start + len(p_iq)
    n = burst_end + (depth + 4) * bs  # noise tail to keep pushing after
    iq = rng.normal(scale=120, size=(n, 2))
    iq[start:burst_end] += p_iq
    iq = iq.astype(np.int16)

    # the burst's last sample lives in this 0-indexed pushed block
    # (the stream consumes carry_len samples of prefix first)
    end_block = (burst_end - pipe.chain.carry_len) // bs
    got_at = None
    for k in range(n // bs):
        if pipe.push(iq[k * bs : (k + 1) * bs])[0]:
            got_at = k
            break
    assert got_at is not None, "message never decoded"
    assert got_at <= end_block + depth + 1, (got_at, end_block, depth)


def test_state_file_corrupt_checkpoint_starts_fresh(tmp_path, capsys):
    """An unreadable state file must not crash-loop the service: it is
    set aside as .bad and the run starts fresh (then writes a good one)."""
    import json as jsonlib

    from tsl_sdr_tpu.cli import pipeline as pipeline_cli

    rng = np.random.default_rng(5)
    iq = rng.integers(-300, 300, size=(900_000, 2)).astype(np.int16)
    path = tmp_path / "cap.cs16"
    iq.reshape(-1).tofile(path)
    lpf = firdes_low_pass(1.0, FS, 12_000, 8_000)
    cfg = {
        "device": {"type": "file", "filename": str(path),
                   "fileFormat": "cs16"},
        "sampleRateHz": FS, "centerFreqHz": CENTER,
        "decimationFactor": DECIM,
        "lpfTaps": list(map(float, lpf)),
        "channels": [{"chanCenterFreq": CENTER + 250_000,
                      "protocol": "pocsag"}],
    }
    cfg_path = tmp_path / "p.json"
    cfg_path.write_text(jsonlib.dumps(cfg))
    state = tmp_path / "s.npz"
    state.write_bytes(b"not a zipfile at all")
    rc = pipeline_cli.main([str(cfg_path), "--follow", "--idle-exit", "0.2",
                            "--block-size", "262144",
                            "--state-file", str(state),
                            "-o", str(tmp_path / "m.jsonl")])
    assert rc == 0
    err = capsys.readouterr().err
    assert "state file unusable" in err, err
    assert (tmp_path / "s.npz.bad").exists()
    # the fresh run wrote a VALID replacement checkpoint
    data = np.load(state)
    assert "__meta__" in data


def test_follow_shutdown_before_stream_primes_is_clean(tmp_path, capsys):
    """--follow stopping before the chain prefix was ever covered (a few
    thousand samples then EOF) exits 0 with a note, not a ValueError
    traceback from flush()."""
    import json as jsonlib

    from tsl_sdr_tpu.cli import pipeline as pipeline_cli

    path = tmp_path / "tiny.cs16"
    np.zeros((100, 2), np.int16).reshape(-1).tofile(path)
    lpf = firdes_low_pass(1.0, FS, 12_000, 8_000)
    cfg = {
        "device": {"type": "file", "filename": str(path),
                   "fileFormat": "cs16"},
        "sampleRateHz": FS, "centerFreqHz": CENTER,
        "decimationFactor": DECIM,
        "lpfTaps": list(map(float, lpf)),
        "channels": [{"chanCenterFreq": CENTER + 250_000,
                      "protocol": "pocsag"}],
    }
    cfg_path = tmp_path / "p.json"
    cfg_path.write_text(jsonlib.dumps(cfg))
    rc = pipeline_cli.main([str(cfg_path), "--follow", "--idle-exit", "0.2",
                            "-o", str(tmp_path / "m.jsonl")])
    assert rc == 0
    assert "shorter than the pipeline prefix" in capsys.readouterr().err


def test_state_file_flag_guards(tmp_path):
    """--state-file without --follow, or with --exact, is a clean CLI
    error (exit 2) — not a silently-ignored flag / raw NotImplementedError
    when the state file already exists."""
    import json as jsonlib

    from tsl_sdr_tpu.cli import pipeline as pipeline_cli

    lpf = firdes_low_pass(1.0, FS, 12_000, 8_000)
    cfg = {
        "device": {"type": "file", "filename": "/dev/null",
                   "fileFormat": "cs16"},
        "sampleRateHz": FS, "centerFreqHz": CENTER,
        "decimationFactor": DECIM,
        "lpfTaps": list(map(float, lpf)),
        "channels": [{"chanCenterFreq": CENTER + 250_000,
                      "protocol": "pocsag"}],
    }
    cfg_path = tmp_path / "p.json"
    cfg_path.write_text(jsonlib.dumps(cfg))
    st = str(tmp_path / "s.npz")
    assert pipeline_cli.main([str(cfg_path), "--state-file", st]) == 2
    assert pipeline_cli.main(
        [str(cfg_path), "--follow", "--exact", "--state-file", st]) == 2


def test_signal_guard_defers_inside_critical_section():
    """The SIGTERM/SIGINT guard raises immediately outside defer() but
    only flags inside it — an async raise mid-push() would strand a block
    between the host buffer and device state."""
    import pytest

    from tsl_sdr_tpu.cli.pipeline import _SignalGuard

    g = _SignalGuard()
    with pytest.raises(KeyboardInterrupt):
        g.handler(15, None)
    g2 = _SignalGuard()
    with g2.defer():
        g2.handler(15, None)  # must NOT raise here
        assert g2.pending
    with pytest.raises(KeyboardInterrupt):
        g2.handler(15, None)  # outside again: raises


def test_check_resume_offset_rotated_file(tmp_path, capsys):
    """A rotated/recreated capture shorter than the checkpoint offset
    restarts from 0 instead of seeking past EOF (which would decode
    nothing and exit 0)."""
    from tsl_sdr_tpu.cli.pipeline import _check_resume_offset

    p = tmp_path / "cap.cs16"
    p.write_bytes(b"\x00" * 400)  # 100 cs16 IQ samples
    assert _check_resume_offset(str(p), "cs16", 50) == 50
    assert _check_resume_offset(str(p), "cs16", 1000) == 0
    # cs8: 2 bytes/sample
    assert _check_resume_offset(str(p), "cs8", 150) == 150
    assert _check_resume_offset(str(p), "cs8", 500) == 0


def test_checkpoint_fingerprint_catches_same_shape_config_edits(tmp_path):
    """Config edits that change decode semantics WITHOUT changing any
    state-leaf shape (dBGain, dcBlockPole, LPF taps) must fail the
    fingerprint check on restore — restoring carries under different
    constants would decode wrongly with no error."""
    import pytest

    lpf = firdes_low_pass(1.0, FS, 12_000, 8_000)

    def mk(**spec_kw):
        return ReceivePipeline(
            lpf, CENTER, FS, DECIM,
            [ChannelSpec(CENTER + 250_000, "pocsag", **spec_kw)],
            exact=False, block_size=262_144)

    pipe = mk()
    rng = np.random.default_rng(2)
    pipe.push(rng.integers(-200, 200, size=(600_000, 2)).astype(np.int16))
    state = tmp_path / "s.npz"
    pipe.checkpoint_stream(state)
    # atomic-replace leaves no temp file behind
    assert not (tmp_path / "s.npz.tmp").exists()

    for kw in ({"db_gain": 3.0}, {"dc_block": True},
               {"dc_block_pole": 0.95, "dc_block": True}):
        with pytest.raises(ValueError, match="differently-configured"):
            mk(**kw).restore_stream(state)

    # different taps, same length: also caught
    lpf2 = firdes_low_pass(1.0, FS, 11_000, 8_000)
    assert len(lpf2) == len(lpf)
    pipe2 = ReceivePipeline(
        lpf2, CENTER, FS, DECIM,
        [ChannelSpec(CENTER + 250_000, "pocsag")],
        exact=False, block_size=262_144)
    with pytest.raises(ValueError, match="differently-configured"):
        pipe2.restore_stream(state)


def test_restore_stream_resets_decoders_in_process():
    """restore_stream on a live object must deliver its documented
    'decoders restart in SEARCH' semantics: the FSMs are recreated, so the
    forced notify_gap() is valid even if a decoder was mid-message at
    restore time."""
    import tempfile

    lpf = firdes_low_pass(1.0, FS, 12_000, 8_000)
    pipe = ReceivePipeline(
        lpf, CENTER, FS, DECIM,
        [ChannelSpec(CENTER + 250_000, "pocsag"),
         ChannelSpec(CENTER + 400_000, "ais")],
        exact=False, block_size=262_144)
    rng = np.random.default_rng(6)
    pipe.push(rng.integers(-200, 200, size=(600_000, 2)).astype(np.int16))
    before = list(pipe._decoders)
    with tempfile.TemporaryDirectory() as d:
        path = f"{d}/s.npz"
        pipe.checkpoint_stream(path)
        pipe.restore_stream(path)
    for old, new_dec in zip(before, pipe._decoders):
        assert new_dec is not old
        assert new_dec.in_search


def test_pipeline_cli_state_file_sigterm(tmp_path):
    """SIGTERM (service-manager stop) writes the state file like Ctrl-C:
    run pipeline-tpu --follow --state-file as a real subprocess on a
    FIFO, deliver SIGTERM mid-stream, assert a loadable checkpoint."""
    import json as jsonlib
    import os
    import signal
    import subprocess
    import sys as _sys
    import threading
    import time as _time

    decim, fs, center = 32, 38400 * 32, 929_500_000
    lpf = firdes_low_pass(1.0, fs, 9_600, 7_000)
    fifo = tmp_path / "iq.fifo"
    os.mkfifo(fifo)
    cfg = {
        "device": {"type": "file", "filename": str(fifo),
                   "fileFormat": "cs16"},
        "sampleRateHz": fs, "centerFreqHz": center,
        "decimationFactor": decim,
        "lpfTaps": list(map(float, lpf)),
        "channels": [{"chanCenterFreq": center + 250_000,
                      "protocol": "pocsag"}],
    }
    cfg_path = tmp_path / "p.json"
    cfg_path.write_text(jsonlib.dumps(cfg))
    state = tmp_path / "state.npz"

    # the child pins the CPU backend via jax.config BEFORE device init
    # (an environment may re-force JAX_PLATFORMS; the config flag wins)
    child = (
        "import jax; jax.config.update('jax_platforms', 'cpu');\n"
        "import sys; from tsl_sdr_tpu.cli import pipeline;\n"
        f"sys.exit(pipeline.main({[str(cfg_path), '--follow', '--block-size', '393216', '--state-file', str(state), '-o', str(tmp_path / 'm.json')]!r}))"
    )
    proc = subprocess.Popen(
        [_sys.executable, "-c", child], stderr=subprocess.PIPE,
    )

    def feed():
        rng = np.random.default_rng(4)
        try:
            with open(fifo, "wb") as w:
                # stream noise until the test delivers SIGTERM
                for _ in range(4000):
                    if proc.poll() is not None:
                        return
                    w.write(rng.integers(-300, 300, size=(65_536, 2),
                                         dtype=np.int64).astype(np.int16)
                            .tobytes())
                    w.flush()
                    _time.sleep(0.02)
        except OSError:
            pass  # reader exited mid-write (the SIGTERM races the feed)

    t = threading.Thread(target=feed, daemon=True)
    t.start()
    # import + first fused compile in the child takes a while on CPU;
    # give it time to push at least one full block before the stop
    _time.sleep(30.0)
    proc.send_signal(signal.SIGTERM)
    rc = proc.wait(timeout=120)
    err = proc.stderr.read().decode()
    t.join(timeout=30)
    assert rc == 0, err
    assert state.exists(), err
    assert "state saved" in err, err
    data = np.load(state)
    assert "__meta__" in data


def test_pipeline_cli_ais_nmea_output(tmp_path):
    """pipeline-tpu --nmea: an ais channel's CRC-valid packets re-emit as
    standard AIVDM sentences alongside the JSON (live aggregator feed)."""
    import json
    import os

    from tsl_sdr_tpu.cli import pipeline as pipeline_cli
    from tsl_sdr_tpu.models.ais import nmea_dearmor
    from tsl_sdr_tpu.testing import ais_gen

    decim = 24
    fs = 51200 * decim  # channel rate 51200 -> AIS 48k = 15/16
    center = 161_900_000
    pkt = ais_gen.make_position_report(366778899, latitude=48.5,
                                       longitude=-124.75)
    bb = ais_gen.generate([pkt], amplitude=9000)
    dev = bb.astype(np.float64) / 16384.0 * 4800
    n_out = int(len(dev) * fs / 48000)
    idx = np.minimum((np.arange(n_out) * 48000 / fs).astype(np.int64),
                     len(dev) - 1)
    ph = np.cumsum(2 * np.pi * (75_000 + dev[idx]) / fs)
    rng = np.random.default_rng(3)
    iq = np.stack([np.cos(ph), np.sin(ph)], -1) * 7000
    iq = np.concatenate([np.zeros((400_000, 2)), iq,
                         np.zeros((400_000, 2))])
    iq = (iq + rng.normal(scale=60, size=iq.shape)).astype(np.int16)
    iq_path = tmp_path / "cap.cs16"
    iq.reshape(-1).tofile(iq_path)

    lpf = firdes_low_pass(1.0, fs, 24_000, 14_000)
    cfg = {
        "device": {"type": "file", "filename": str(iq_path),
                   "fileFormat": "cs16"},
        "sampleRateHz": fs, "centerFreqHz": center,
        "decimationFactor": decim,
        "lpfTaps": list(map(float, lpf)),
        "channels": [{"protocol": "ais",
                      "chanCenterFreq": center + 75_000}],
    }
    cfg_path = tmp_path / "pipe.json"
    cfg_path.write_text(json.dumps(cfg))
    out = tmp_path / "msgs.jsonl"
    nmea = tmp_path / "feed.nmea"

    rc = pipeline_cli.main([str(cfg_path), "-o", str(out),
                            "--nmea", str(nmea)])
    assert rc == 0
    jl = [json.loads(x) for x in out.read_text().splitlines()]
    assert [m["mmsi"] for m in jl] == [366778899]
    lines = nmea.read_text().splitlines()
    assert len(lines) == 1 and lines[0].startswith("!AIVDM,1,1,,A,")
    f = lines[0][1:-3].split(",")
    assert nmea_dearmor(f[5], int(f[6])) == pkt

    # --nmea without an ais channel is a config error
    cfg["channels"] = [{"protocol": "pocsag",
                        "chanCenterFreq": center + 75_000}]
    cfg_path.write_text(json.dumps(cfg))
    assert pipeline_cli.main([str(cfg_path), "--nmea", "-"]) == 2


def test_drain_async_equals_sync():
    """drain_async=True (the deployment CLI default) produces exactly the
    same messages as the synchronous engine at any push() split — the
    drain worker only moves WHERE the drain runs, never what it computes.
    Exercises egress gating, gap/tail splicing and checkpointing through
    the worker."""
    iq = _capture(seed=33)
    lpf = firdes_low_pass(1.0, FS, 12_000, 8_000)

    sync = ReceivePipeline(lpf, CENTER, FS, DECIM, _specs(), exact=False,
                           block_size=262_144)
    want = _keys(sync.process_capture(iq))
    assert want[0] and want[0][0][1] == 1122334

    pipe = ReceivePipeline(lpf, CENTER, FS, DECIM, _specs(), exact=False,
                           block_size=262_144, drain_async=True)
    nch = len(_specs())
    rng = np.random.default_rng(5)
    got = [[] for _ in range(nch)]
    i = 0
    while i < len(iq):
        ln = int(rng.integers(80_000, 500_000))
        part = pipe.push(iq[i:i + ln])
        for c in range(nch):
            got[c].extend(part[c])
        i += ln
    part = pipe.flush()
    for c in range(nch):
        got[c].extend(part[c])
    assert _keys(got) == want

    # a fresh async stream checkpoints mid-run (barrier through the
    # worker) and restores; everything after the gap still decodes
    import tempfile, os
    pipe2 = ReceivePipeline(lpf, CENTER, FS, DECIM, _specs(), exact=False,
                            block_size=262_144, drain_async=True)
    # checkpoint in the trailing pad, AFTER every burst: a split inside a
    # burst would (correctly) lose it to the SEARCH restart
    half = len(iq) - 250_000
    got2 = [list(ch) for ch in pipe2.push(iq[:half])]
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "st.npz")
        for c, part in enumerate(pipe2.checkpoint_stream(path)):
            got2[c].extend(part)
        pipe3 = ReceivePipeline(lpf, CENTER, FS, DECIM, _specs(),
                                exact=False, block_size=262_144,
                                drain_async=True)
        pipe3.restore_stream(path)
    for c, part in enumerate(pipe3.push(iq[half:])):
        got2[c].extend(part)
    for c, part in enumerate(pipe3.flush()):
        got2[c].extend(part)
    # the POCSAG burst lives in the first half; AIS/FLEX messages from
    # either side of the boundary must all be intact or cleanly lost to
    # the gap (self-synchronizing restart) — the strong assertion is the
    # known burst, decoded exactly once, plus no duplicates anywhere
    keys2 = _keys(got2)
    assert keys2[0].count(want[0][0]) == 1, keys2[0]
    for c in range(nch):
        assert len(keys2[c]) == len(set(map(repr, keys2[c]))), keys2[c]


def test_drain_async_exact_tier_equals_sync():
    """The exact tier's async END-half worker (plane fetch + host FM +
    resampler + decode) is output-identical to the inline drain: the FIFO
    worker preserves the fm-carry dispatch order."""
    from tests.test_pipeline import _fm_mod
    from tsl_sdr_tpu.testing import pocsag_gen

    bb = pocsag_gen.generate(
        [pocsag_gen.PocsagBurst(capcode=555001, function=1, kind="alpha",
                                content="EXACT ASYNC")],
        baud=1200, amplitude=4096, tail_bits=256)
    sig = _fm_mod(bb, 38400, 250_000, FS)
    iq = np.zeros((len(sig) + 300_000, 2))
    iq[150_000:150_000 + len(sig)] += sig
    rng = np.random.default_rng(7)
    iq = (iq + rng.normal(scale=90, size=iq.shape)).astype(np.int16)
    specs = [ChannelSpec(CENTER + 250_000, "pocsag"),
             ChannelSpec(CENTER - 150_000, "pcm")]
    lpf = firdes_low_pass(1.0, FS, 12_000, 8_000)

    outs = {}
    for asy in (False, True):
        pipe = ReceivePipeline(lpf, CENTER, FS, DECIM, specs, exact=True,
                               block_size=262_144, drain_async=asy)
        got = [list(ch) for ch in pipe.push(iq)]
        for c, part in enumerate(pipe.flush()):
            got[c].extend(part)
        outs[asy] = ([(m.capcode, bytes(m.data)) for m in got[0]],
                     np.concatenate(got[1]) if got[1]
                     else np.zeros(0, np.int16))
    assert outs[True][0] == outs[False][0]
    assert any(c == 555001 for c, _ in outs[True][0])
    np.testing.assert_array_equal(outs[True][1], outs[False][1])


def test_warm_device_leaves_stream_output_unchanged():
    """warm_device() before streaming is output-invisible: identical
    messages to a cold pipeline, and a no-op once the stream is primed."""
    iq = _capture()
    lpf = firdes_low_pass(1.0, FS, 12_000, 8_000)

    cold = ReceivePipeline(lpf, CENTER, FS, DECIM, _specs(), exact=False,
                           block_size=262_144)
    want = _keys(cold.process_capture(iq))

    warm = ReceivePipeline(lpf, CENTER, FS, DECIM, _specs(), exact=False,
                           block_size=262_144)
    spent = warm.warm_device()
    assert spent > 0.0
    assert warm._stream is None  # stream reset: real data starts fresh
    got = [list(ch) for ch in warm.push(iq)]
    for c, part in enumerate(warm.flush()):
        got[c].extend(part)
    assert _keys(got) == want
    # warm stats never leak into the live stream's accounting
    assert warm.stream_stats["blocks"] >= 1

    primed = ReceivePipeline(lpf, CENTER, FS, DECIM, _specs(), exact=False,
                             block_size=262_144)
    primed.push(iq[:300_000])
    assert primed.warm_device() == 0.0


def test_pipeline_cli_standby_failover(tmp_path):
    """--standby: a hot-standby leg waits for the primary's checkpoint
    file, then restores and continues the stream; the two legs' messages
    together equal one uninterrupted run (the soak driver's failover
    shape — per-session device warm paid before takeover)."""
    import json as jsonlib
    import threading

    from tsl_sdr_tpu.cli import pipeline as pipeline_cli
    from tsl_sdr_tpu.models.pipeline import ChannelSpec, ReceivePipeline

    decim, fs, center = 32, 38400 * 32, 929_500_000

    def burst(cap, txt):
        bb = pocsag_gen.generate(
            [pocsag_gen.PocsagBurst(capcode=cap, function=1, kind="alpha",
                                    content=txt)],
            baud=1200, amplitude=4096, tail_bits=256)
        return _fm_mod(bb, 38400, 250_000, fs)

    rng = np.random.default_rng(11)
    pad = rng.integers(-300, 300, size=(900_000, 2)).astype(np.int16)
    iq = np.concatenate([pad, burst(311, "BEFORE FAILOVER").astype(np.int16),
                         pad, burst(322, "AFTER FAILOVER").astype(np.int16),
                         pad])
    iq = (iq + rng.normal(scale=90, size=iq.shape)).astype(np.int16)
    lpf = firdes_low_pass(1.0, fs, 9_600, 7_000)

    want = [(m.capcode, m.data) for m in ReceivePipeline(
        lpf, center, fs, decim,
        [ChannelSpec(center + 250_000, "pocsag")],
        exact=False, block_size=393_216).process_capture(iq)[0]]
    assert [c for c, _ in want] == [311, 322]

    half = len(iq) // 2
    iq_path = tmp_path / "cap.cs16"
    iq[:half].reshape(-1).tofile(iq_path)
    cfg = {
        "device": {"type": "file", "filename": str(iq_path),
                   "fileFormat": "cs16"},
        "sampleRateHz": fs, "centerFreqHz": center,
        "decimationFactor": decim,
        "lpfTaps": list(map(float, lpf)),
        "channels": [{"chanCenterFreq": center + 250_000,
                      "protocol": "pocsag"}],
    }
    cfg_path = tmp_path / "p.json"
    cfg_path.write_text(jsonlib.dumps(cfg))
    state = tmp_path / "state.npz"
    out1, out2 = tmp_path / "m1.json", tmp_path / "m2.json"

    # standby leg starts FIRST (like the soak's hot standby): warms, then
    # blocks until the state file exists
    sb_rc = []
    standby = threading.Thread(
        target=lambda: sb_rc.append(pipeline_cli.main(
            [str(cfg_path), "--follow", "--idle-exit", "0.5",
             "--block-size", "393216", "--state-file", str(state),
             "--standby", "-o", str(out2)])),
        daemon=True)
    standby.start()
    time.sleep(0.3)
    assert not state.exists()

    rc = pipeline_cli.main([str(cfg_path), "--follow", "--idle-exit",
                            "0.3", "--block-size", "393216",
                            "--state-file", str(state),
                            "-o", str(out1)])
    assert rc == 0 and state.exists()
    with open(iq_path, "ab") as f:
        iq[half:].reshape(-1).tofile(f)
    standby.join(timeout=300)
    assert not standby.is_alive() and sb_rc == [0]

    got = [(m["capCode"], m["message"])
           for p in (out1, out2)
           for m in map(jsonlib.loads, p.read_text().splitlines())]
    assert got == [(c, d.decode()) for c, d in want]


def test_pipeline_cli_standby_fresh_takeover(tmp_path):
    """A supervisor that saw the primary die WITHOUT a checkpoint touches
    <state-file>.takeover; the standby starts fresh from the live stream
    (self-synchronizing protocols) instead of waiting forever."""
    import json as jsonlib
    import threading

    from tsl_sdr_tpu.cli import pipeline as pipeline_cli

    decim, fs, center = 32, 38400 * 32, 929_500_000
    bb = pocsag_gen.generate(
        [pocsag_gen.PocsagBurst(capcode=444, function=1, kind="alpha",
                                content="FRESH TAKEOVER")],
        baud=1200, amplitude=4096, tail_bits=256)
    sig = _fm_mod(bb, 38400, 250_000, fs)
    rng = np.random.default_rng(13)
    pad = rng.integers(-300, 300, size=(900_000, 2)).astype(np.int16)
    iq = np.concatenate([pad, sig.astype(np.int16), pad])
    iq = (iq + rng.normal(scale=90, size=iq.shape)).astype(np.int16)
    lpf = firdes_low_pass(1.0, fs, 9_600, 7_000)

    iq_path = tmp_path / "cap.cs16"
    iq.reshape(-1).tofile(iq_path)
    cfg = {
        "device": {"type": "file", "filename": str(iq_path),
                   "fileFormat": "cs16"},
        "sampleRateHz": fs, "centerFreqHz": center,
        "decimationFactor": decim,
        "lpfTaps": list(map(float, lpf)),
        "channels": [{"chanCenterFreq": center + 250_000,
                      "protocol": "pocsag"}],
    }
    cfg_path = tmp_path / "p.json"
    cfg_path.write_text(jsonlib.dumps(cfg))
    state = tmp_path / "state.npz"
    out = tmp_path / "m.json"

    sb_rc = []
    standby = threading.Thread(
        target=lambda: sb_rc.append(pipeline_cli.main(
            [str(cfg_path), "--follow", "--idle-exit", "0.5",
             "--block-size", "393216", "--state-file", str(state),
             "--standby", "--no-warm", "-o", str(out)])),
        daemon=True)
    standby.start()
    time.sleep(1.0)
    assert standby.is_alive()  # still waiting: no trigger yet
    (tmp_path / "state.npz.takeover").touch()
    standby.join(timeout=300)
    assert not standby.is_alive() and sb_rc == [0]
    assert not (tmp_path / "state.npz.takeover").exists()  # consumed
    msgs = [jsonlib.loads(ln) for ln in out.read_text().splitlines()]
    assert [(m["capCode"], m["message"]) for m in msgs] == \
        [(444, "FRESH TAKEOVER")]
