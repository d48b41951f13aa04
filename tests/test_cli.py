import json
import numpy as np
import pytest

from tsl_sdr_tpu.cli import decoder as decoder_cli
from tsl_sdr_tpu.cli import design_filter as design_cli
from tsl_sdr_tpu.cli import multifm as multifm_cli
from tsl_sdr_tpu.cli import resampler as resampler_cli
from tsl_sdr_tpu.testing import pocsag_gen


UNITY_FILTER = {"lpfCoeffs": [1.0]}


def test_design_filter_cli(tmp_path, capsys):
    assert design_cli.main(["16", "25", "0.4"]) == 0
    doc = json.loads(capsys.readouterr().out)["rationalResampler"]
    assert doc["interpolate"] == 16 and doc["decimate"] == 25
    assert len(doc["lpfCoeffs"]) == 821


def test_decoder_cli_pocsag_passthrough(tmp_path, capsys):
    bursts = [
        pocsag_gen.PocsagBurst(capcode=1234567, function=2, kind="alpha",
                               content="CLI TEST"),
    ]
    pcm = pocsag_gen.generate(bursts, baud=1200)
    src = tmp_path / "in.pcm"
    pcm.tofile(src)
    filt = tmp_path / "filt.json"
    filt.write_text(json.dumps(UNITY_FILTER))
    out = tmp_path / "out.json"

    rc = decoder_cli.main([
        "-m", "pocsag", "-I", "1", "-D", "1", "-S", "38400",
        "-F", str(filt), "-f", "929612500", "-o", str(out), "-c", str(src),
    ])
    assert rc == 0
    lines = [json.loads(x) for x in out.read_text().splitlines()]
    assert len(lines) == 1
    m = lines[0]
    assert m["proto"] == "pocsag" and m["type"] == "alphanumeric"
    assert m["capCode"] == 1234567 and m["function"] == 2
    assert m["message"] == "CLI TEST"
    assert m["baud"] == 1200


def test_decoder_cli_flex_with_resample(tmp_path):
    """FLEX at 16 kHz, delivered as a 25 kHz stream, decoder resamples 16/25."""
    scipy_signal = pytest.importorskip("scipy.signal")
    from tsl_sdr_tpu.testing import flex_gen
    from tsl_sdr_tpu.utils.filter_design import resampler_filter_json

    msgs = [flex_gen.FlexBurstMessage(capcode=424242, kind="alnum",
                                      content="RESAMPLED")]
    pcm16k, _ = flex_gen.generate(msgs, baud=1600, fsk_levels=2)
    pcm25k = scipy_signal.resample_poly(
        pcm16k.astype(np.float64), 25, 16
    ).astype(np.int16)
    src = tmp_path / "in25k.pcm"
    pcm25k.tofile(src)
    filt = tmp_path / "filt_16_25.json"
    filt.write_text(resampler_filter_json(16, 25, 0.4))
    out = tmp_path / "out.json"

    rc = decoder_cli.main([
        "-m", "flex", "-I", "16", "-D", "25", "-S", "25000",
        "-F", str(filt), "-f", "929612500", "-o", str(out), "-c", str(src),
    ])
    assert rc == 0
    lines = [json.loads(x) for x in out.read_text().splitlines()]
    assert len(lines) == 1
    assert lines[0]["proto"] == "flex"
    assert lines[0]["capCode"] == 424242
    assert lines[0]["message"] == "RESAMPLED"


def test_decoder_cli_ais(tmp_path):
    from tsl_sdr_tpu.testing import ais_gen

    pkt = ais_gen.make_position_report(367001234, latitude=37.7749,
                                       longitude=-122.4194)
    src = tmp_path / "ais.pcm"
    ais_gen.generate([pkt]).tofile(src)
    filt = tmp_path / "filt.json"
    filt.write_text(json.dumps(UNITY_FILTER))
    out = tmp_path / "out.json"

    rc = decoder_cli.main([
        "-m", "ais", "-I", "1", "-D", "1", "-S", "48000",
        "-F", str(filt), "-f", "161975000", "-o", str(out), "-c", str(src),
    ])
    assert rc == 0
    lines = [json.loads(x) for x in out.read_text().splitlines()]
    assert len(lines) == 1
    assert lines[0]["type"] == "positionReport"
    assert lines[0]["mmsi"] == 367001234
    assert abs(lines[0]["geoPosition"]["lat"] - 37.7749) < 1e-4


def test_resampler_cli(tmp_path):
    from tsl_sdr_tpu.utils.filter_design import resampler_filter_json

    rng = np.random.default_rng(0)
    pcm = rng.integers(-10000, 10000, size=50_000, dtype=np.int64).astype(np.int16)
    src = tmp_path / "in.pcm"
    pcm.tofile(src)
    filt = tmp_path / "filt.json"
    filt.write_text(resampler_filter_json(16, 25, 0.4))
    dst = tmp_path / "out.pcm"

    rc = resampler_cli.main([
        "-I", "16", "-D", "25", "-S", "25000", "-F", str(filt),
        str(src), str(dst),
    ])
    assert rc == 0
    out = np.fromfile(dst, dtype=np.int16)
    assert abs(len(out) - len(pcm) * 16 / 25) < 2100  # block-granular tail


def test_multifm_cli_file_device(tmp_path):
    """multifm-tpu on a file-device config: channelize NBFM POCSAG, decode
    the emitted per-channel PCM."""
    from tsl_sdr_tpu.models.pocsag import PocsagDecoder
    from tsl_sdr_tpu.utils.filter_design import firdes_low_pass

    decim = 32
    fs = 38400 * decim
    offset = 150_000
    bursts = [pocsag_gen.PocsagBurst(capcode=888888, function=1, kind="alpha",
                                     content="VIA MULTIFM")]
    baseband = pocsag_gen.generate(bursts, baud=1200, amplitude=4096,
                                   tail_bits=512)
    dev = baseband.astype(np.float64) / 16384.0 * (38400 / 2)
    phase = np.cumsum(np.repeat(2 * np.pi * (offset + dev) / fs, decim))
    iq = (np.stack([np.cos(phase), np.sin(phase)], -1) * 9000).astype(np.int16)
    iq_path = tmp_path / "capture.cs16"
    iq.reshape(-1).tofile(iq_path)

    lpf = firdes_low_pass(1.0, fs, 9_600, 7_000)
    out_pcm = tmp_path / "ch0.pcm"
    cfg = {
        "device": {"type": "file", "filename": str(iq_path), "fileFormat": "cs16"},
        "sampleRateHz": fs,
        "centerFreqHz": 929_500_000,
        "nrSampBufs": 128,
        "decimationFactor": decim,
        "lpfTaps": list(map(float, lpf)),
        "channels": [
            {"outFifo": str(out_pcm), "chanCenterFreq": 929_500_000 + offset},
        ],
    }
    cfg_path = tmp_path / "multifm.json"
    cfg_path.write_text(json.dumps(cfg))

    rc = multifm_cli.main([str(cfg_path), "--exact", "--block-size", "131072"])
    assert rc == 0
    pcm = np.fromfile(out_pcm, dtype=np.int16)
    msgs = PocsagDecoder().on_pcm(pcm)
    assert len(msgs) == 1
    assert msgs[0].capcode == 888888
    assert msgs[0].data == b"VIA MULTIFM"

    # BOTH runtimes' pipelined exact paths (begin/end split, in-flight
    # FIR dispatches) must agree byte-for-byte and decode: the python
    # runtime cuts fixed blocks and drops the sub-block tail, the native
    # runtime consumes to quantum granularity, so compare the common
    # prefix (the default runtime above is native)
    out_pcm.unlink()
    rc = multifm_cli.main([str(cfg_path), "--exact", "--runtime", "python",
                           "--block-size", "131072"])
    assert rc == 0
    pcm_py = np.fromfile(out_pcm, dtype=np.int16)
    n_common = min(len(pcm), len(pcm_py))
    assert n_common > 0.9 * len(pcm)
    np.testing.assert_array_equal(pcm_py[:n_common], pcm[:n_common])
    msgs_py = PocsagDecoder().on_pcm(pcm_py)
    assert [m.capcode for m in msgs_py] == [888888]


def test_multifm_cli_live_stats(tmp_path, capsys):
    """--stats SECS prints periodic live counters lines during the run
    (both runtimes), not only the exit summary."""
    from tsl_sdr_tpu.utils.filter_design import firdes_low_pass

    decim, fs = 32, 38400 * 32
    rng = np.random.default_rng(0)
    iq = rng.integers(-2000, 2000, size=(900_000, 2)).astype(np.int16)
    iq_path = tmp_path / "cap.cs16"
    iq.reshape(-1).tofile(iq_path)
    lpf = firdes_low_pass(1.0, fs, 9_600, 7_000)
    cfg = {
        "device": {"type": "file", "filename": str(iq_path),
                   "fileFormat": "cs16"},
        "sampleRateHz": fs, "centerFreqHz": 929_500_000,
        "decimationFactor": decim,
        "lpfTaps": list(map(float, lpf)),
        "channels": [{"outFifo": str(tmp_path / "ch0.pcm"),
                      "chanCenterFreq": 929_650_000}],
    }
    p = tmp_path / "c.json"
    p.write_text(json.dumps(cfg))
    for runtime in ("python", "native"):
        rc = multifm_cli.main([str(p), "--runtime", runtime,
                               "--block-size", "131072",
                               "--stats", "0.0001"])
        assert rc == 0
        err = capsys.readouterr().err
        assert ": stats samples_in=" in err, (runtime, err)
        assert "Msps]" in err, (runtime, err)


def test_multifm_cli_hardware_gated(tmp_path, capsys):
    cfg = {
        "device": {"type": "rtlsdr", "deviceIndex": 0},
        "sampleRateHz": 1_000_000,
        "centerFreqHz": 929_500_000,
        "decimationFactor": 40,
        "lpfTaps": [0.5, 0.5],
        "channels": [{"outFifo": str(tmp_path / "x"), "chanCenterFreq": 929_600_000}],
    }
    p = tmp_path / "c.json"
    p.write_text(json.dumps(cfg))
    assert multifm_cli.main([str(p)]) == 2


def test_multifm_cli_fast_tier_native_runtime(tmp_path):
    """Production combo: fast float tier + native C++ IO runtime."""
    import shutil

    if shutil.which("g++") is None:
        pytest.skip("no C++ toolchain")
    from tsl_sdr_tpu.models.pocsag import PocsagDecoder
    from tsl_sdr_tpu.utils.filter_design import firdes_low_pass

    decim = 32
    fs = 38400 * decim
    offset = 150_000
    bursts = [pocsag_gen.PocsagBurst(capcode=424242, function=3, kind="alpha",
                                     content="FAST NATIVE")]
    baseband = pocsag_gen.generate(bursts, baud=1200, amplitude=4096,
                                   tail_bits=512)
    dev = baseband.astype(np.float64) / 16384.0 * (38400 / 2)
    phase = np.cumsum(np.repeat(2 * np.pi * (offset + dev) / fs, decim))
    iq = (np.stack([np.cos(phase), np.sin(phase)], -1) * 9000).astype(np.int16)
    iq_path = tmp_path / "capture.cs16"
    iq.reshape(-1).tofile(iq_path)

    lpf = firdes_low_pass(1.0, fs, 9_600, 7_000)
    out_pcm = tmp_path / "ch0.pcm"
    cfg = {
        "device": {"type": "file", "filename": str(iq_path), "fileFormat": "cs16"},
        "sampleRateHz": fs,
        "centerFreqHz": 929_500_000,
        "decimationFactor": decim,
        "lpfTaps": list(map(float, lpf)),
        "channels": [
            {"outFifo": str(out_pcm), "chanCenterFreq": 929_500_000 + offset},
        ],
    }
    cfg_path = tmp_path / "multifm.json"
    cfg_path.write_text(json.dumps(cfg))

    rc = multifm_cli.main([str(cfg_path), "--runtime", "native",
                           "--block-size", "131072"])
    assert rc == 0
    pcm = np.fromfile(out_pcm, dtype=np.int16)
    msgs = PocsagDecoder().on_pcm(pcm)
    assert len(msgs) == 1
    assert msgs[0].capcode == 424242
    assert msgs[0].data == b"FAST NATIVE"


def test_multifm_cli_startup_mute(tmp_path):
    """muteStartupMs discards leading input before any channel output
    (the reference receiver's mute gate, receiver.h:98; VERDICT r1 #10)."""
    from tsl_sdr_tpu.models.pocsag import PocsagDecoder
    from tsl_sdr_tpu.utils.filter_design import firdes_low_pass

    decim = 32
    fs = 38400 * decim
    offset = 150_000
    bursts = [pocsag_gen.PocsagBurst(capcode=5150, function=1, kind="alpha",
                                     content="AFTER MUTE")]
    baseband = pocsag_gen.generate(bursts, baud=1200, amplitude=4096,
                                   tail_bits=256)
    dev = baseband.astype(np.float64) / 16384.0 * (38400 / 2)
    phase = np.cumsum(np.repeat(2 * np.pi * (offset + dev) / fs, decim))
    iq = (np.stack([np.cos(phase), np.sin(phase)], -1) * 9000).astype(np.int16)
    # 120 ms of junk that must be muted away
    junk = np.full((fs * 120 // 1000, 2), 12000, np.int16)
    iq = np.concatenate([junk, iq])
    iq_path = tmp_path / "capture.cs16"
    iq.reshape(-1).tofile(iq_path)

    lpf = firdes_low_pass(1.0, fs, 9_600, 7_000)
    out_pcm = tmp_path / "ch0.pcm"
    cfg = {
        "device": {"type": "file", "filename": str(iq_path),
                   "fileFormat": "cs16"},
        "sampleRateHz": fs,
        "centerFreqHz": 929_500_000,
        "decimationFactor": decim,
        "muteStartupMs": 120,
        "lpfTaps": list(map(float, lpf)),
        "channels": [
            {"outFifo": str(out_pcm), "chanCenterFreq": 929_500_000 + offset},
        ],
    }
    cfg_path = tmp_path / "multifm.json"
    cfg_path.write_text(json.dumps(cfg))

    rc = multifm_cli.main([str(cfg_path)])
    assert rc == 0
    pcm = np.fromfile(out_pcm, dtype=np.int16)
    # muted: output shorter than the unmuted stream by ~120ms worth
    assert len(pcm) <= (len(iq) - len(junk)) // decim + 1
    msgs = PocsagDecoder().on_pcm(pcm)
    assert [m.data for m in msgs] == [b"AFTER MUTE\x00"]

    # same through the native runtime
    out_pcm.unlink()
    rc = multifm_cli.main([str(cfg_path), "--runtime", "native"])
    assert rc == 0
    msgs = PocsagDecoder().on_pcm(np.fromfile(out_pcm, dtype=np.int16))
    assert [m.data for m in msgs] == [b"AFTER MUTE\x00"]


def test_cli_config_errors_are_clean(tmp_path, capsys):
    """Malformed/incomplete configs exit 2 with a diagnostic — no
    traceback (the reference prints and exits, multifm.c:105-146)."""
    # missing required keys, one at a time
    good = {
        "device": {"type": "file", "filename": "x", "fileFormat": "cs16"},
        "sampleRateHz": 1228800, "centerFreqHz": 929500000,
        "decimationFactor": 32, "lpfTaps": [1.0, 0.5],
        "channels": [{"outFifo": "o", "chanCenterFreq": 929650000}],
    }
    for key in ("sampleRateHz", "centerFreqHz", "decimationFactor",
                "lpfTaps", "channels"):
        bad = {k: v for k, v in good.items() if k != key}
        p = tmp_path / f"miss_{key}.json"
        p.write_text(json.dumps(bad))
        assert multifm_cli.main([str(p)]) == 2
        err = capsys.readouterr().err
        assert key in err or "lpfTaps" in err, (key, err)
    # invalid JSON
    p = tmp_path / "broken.json"
    p.write_text("{not json")
    assert multifm_cli.main([str(p)]) == 2
    assert "invalid JSON" in capsys.readouterr().err
    # missing file
    assert multifm_cli.main([str(tmp_path / "enoent.json")]) == 2
    assert "not found" in capsys.readouterr().err
    # empty channel list
    bad = dict(good); bad["channels"] = []
    p = tmp_path / "noch.json"
    p.write_text(json.dumps(bad))
    assert multifm_cli.main([str(p)]) == 2
    assert "channels" in capsys.readouterr().err
    # bad numeric
    bad = dict(good); bad["decimationFactor"] = "thirty-two"
    p = tmp_path / "badnum.json"
    p.write_text(json.dumps(bad))
    assert multifm_cli.main([str(p)]) == 2
    assert "bad value" in capsys.readouterr().err
    # decoder/resampler filter file without taps
    p = tmp_path / "nofilt.json"
    p.write_text(json.dumps({"rationalResampler": {"interpolate": 1}}))
    assert decoder_cli.main(["-m", "pocsag", "-I", "1", "-D", "1",
                             "-S", "38400", "-F", str(p), "-f", "0",
                             "-o", str(tmp_path / "o.json"),
                             "-c", str(tmp_path / "in.pcm")]) == 2
    assert "lpfCoeffs" in capsys.readouterr().err


def test_cli_config_value_errors_are_clean(tmp_path, capsys):
    """Regression: non-numeric CHANNEL values and filter taps take the
    exit-2 diagnostic path, not a traceback."""
    good = {
        "device": {"type": "file", "filename": "x", "fileFormat": "cs16"},
        "sampleRateHz": 1228800, "centerFreqHz": 929500000,
        "decimationFactor": 32, "lpfTaps": [1.0, 0.5],
        "channels": [{"outFifo": "o", "chanCenterFreq": "nine-two-nine"}],
    }
    p = tmp_path / "badch.json"
    p.write_text(json.dumps(good))
    assert multifm_cli.main([str(p)]) == 2
    assert "bad channel value" in capsys.readouterr().err

    f = tmp_path / "badtap.json"
    f.write_text(json.dumps({"lpfCoeffs": [1.0, "bad"]}))
    assert decoder_cli.main(["-m", "pocsag", "-I", "1", "-D", "1",
                             "-S", "38400", "-F", str(f), "-f", "0",
                             "-o", str(tmp_path / "o.json"),
                             "-c", str(tmp_path / "in.pcm")]) == 2
    assert "bad filter tap" in capsys.readouterr().err
