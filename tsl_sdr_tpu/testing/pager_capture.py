"""Seeded wideband captures for end-to-end checks of the receive path.

:func:`pager_capture` builds the stream the reference's mixed pager
deployment (``etc/pipeline_pager_example.json``) would receive: a POCSAG
channel and a FLEX channel carrying bursts of known messages, and a PCM
channel carrying an FM tone, all NBFM-modulated onto their offsets in one
cs16 capture with Gaussian noise. :func:`pocsag_capture` puts a POCSAG
burst train on every channel of a plan, and :func:`fm_tone_capture` an FM
tone (the ``multifm-tpu`` check). All three are deterministic in ``seed``
and build the capture in chunks, so a 60 s capture at 1.2288 Msps (74 M
samples, 295 MB) never holds more than a few float arrays of one chunk.
"""

from __future__ import annotations

import json
import string
from pathlib import Path

import numpy as np

from tsl_sdr_tpu.testing import flex_gen, pocsag_gen

CHECKOUT_ROOT = Path(__file__).resolve().parents[2]
PAGER_CONFIG = CHECKOUT_ROOT / "etc" / "pipeline_pager_example.json"
MULTIFM_8CH_CONFIG = CHECKOUT_ROOT / "etc" / "multifm_rtlsdr_8ch.json"

# one burst per protocol every BURST_PERIOD_S; FLEX frames sit half a
# period after the POCSAG bursts (different channels, but it keeps the
# decoders' busy spans apart in the logs)
BURST_PERIOD_S = 5.0
POCSAG_TEXT_LEN = 20  # 140 bits = 7 whole 20-bit words: no NUL padding
FLEX_TEXT_LEN = 18


def load_config(path=PAGER_CONFIG) -> dict:
    return json.loads(Path(path).read_text())


class FmChannel:
    """One carrier: ``bb`` is discriminator-domain int16 PCM at ``bb_rate``
    (full scale 16384 == ``dev_hz`` of deviation); beyond its end the
    carrier stays unmodulated."""

    def __init__(self, offset_hz, bb, bb_rate, dev_hz, amp):
        self.offset_hz = float(offset_hz)
        self.dev = np.asarray(bb, np.float64) / 16384.0 * float(dev_hz)
        self.bb_rate = float(bb_rate)
        self.amp = float(amp)
        self.phase = 0.0


def fm_capture(channels, fs: float, n_samples: int, seed: int,
               noise: float = 120.0, chunk: int = 1 << 22) -> np.ndarray:
    """Sum of NBFM carriers plus Gaussian noise -> [n_samples, 2] int16.

    Zero-order hold maps wideband sample ``n`` to baseband sample
    ``floor(n * bb_rate / fs)``, which handles non-integer rate ratios."""
    rng = np.random.default_rng(seed)
    out = np.empty((n_samples, 2), np.int16)
    for start in range(0, n_samples, chunk):
        n = min(chunk, n_samples - start)
        acc = rng.normal(scale=noise, size=(n, 2))
        idx_n = np.arange(start, start + n, dtype=np.int64)
        for ch in channels:
            idx = (idx_n * ch.bb_rate / fs).astype(np.int64)
            dev = np.zeros(n)
            ok = idx < ch.dev.shape[0]
            dev[ok] = ch.dev[idx[ok]]
            ph = ch.phase + np.cumsum(2 * np.pi * (ch.offset_hz + dev) / fs)
            acc[:, 0] += ch.amp * np.cos(ph)
            acc[:, 1] += ch.amp * np.sin(ph)
            ch.phase = float(np.mod(ph[-1], 2 * np.pi))
        out[start:start + n] = np.clip(np.rint(acc), -32768, 32767)
    return out


def _text(rng, n: int, tag: str) -> str:
    alphabet = string.ascii_uppercase + string.digits
    body = "".join(rng.choice(list(alphabet), size=n - len(tag) - 1))
    return f"{tag} {body}"


def _pocsag_train(rng, seconds: float, tag: str, start_s: float = 0.5):
    """POCSAG bursts every BURST_PERIOD_S -> (38.4 kHz PCM, [(capcode,
    message)]), message as the JSON output escapes it."""
    from tsl_sdr_tpu.utils.jsonout import escape_message

    rate = pocsag_gen.BASE_RATE
    bb = np.zeros(int(seconds * rate), np.int16)
    expected = []
    k = 0
    while start_s + k * BURST_PERIOD_S + 2.0 <= seconds:
        capcode = int(rng.integers(8, 2_000_000))
        text = _text(rng, POCSAG_TEXT_LEN, f"{tag}{k:03d}")
        burst = pocsag_gen.generate(
            [pocsag_gen.PocsagBurst(capcode=capcode, function=int(k % 4),
                                    kind="alpha", content=text)],
            baud=1200, amplitude=4096, tail_bits=256)
        i0 = int((start_s + k * BURST_PERIOD_S) * rate)
        bb[i0:i0 + burst.shape[0]] = burst[: bb.shape[0] - i0]
        expected.append((capcode, escape_message(
            pocsag_gen.expected_alpha_decode(text.encode()))))
        k += 1
    return bb, expected


def _flex_train(rng, seconds: float, tag: str, start_s: float):
    """FLEX 1600/2 frames, one alphanumeric message each, every
    BURST_PERIOD_S -> (16 kHz PCM, [(capcode, message)])."""
    from tsl_sdr_tpu.utils.jsonout import escape_message

    rate = 16_000
    bb = np.zeros(int(seconds * rate), np.int16)
    expected = []
    k = 0
    while start_s + k * BURST_PERIOD_S + 2.0 <= seconds:
        capcode = int(rng.integers(1, 1_000_000))
        text = _text(rng, FLEX_TEXT_LEN, f"{tag}{k:03d}")
        frame, _ = flex_gen.generate(
            [flex_gen.FlexBurstMessage(capcode=capcode, kind="alnum",
                                       content=text)],
            baud=1600, fsk_levels=2, frame=k % 128, amplitude=6144,
            tail_bits=300)
        i0 = int((start_s + k * BURST_PERIOD_S) * rate)
        bb[i0:i0 + frame.shape[0]] = frame[: bb.shape[0] - i0]
        expected.append((capcode, escape_message(text.encode())))
        k += 1
    return bb, expected


def pager_capture(seconds: float = 60.0, seed: int = 0,
                  cfg: dict | None = None):
    """Capture for the pager deployment ``cfg`` (default: the example
    config: one POCSAG, one FLEX and one PCM channel). Returns ``(iq [N, 2]
    int16, expected)``; ``expected`` is the sorted list of ``(proto,
    freq_hz, capcode, message)`` a correct receiver decodes
    (:func:`messages_from_json`)."""
    cfg = load_config() if cfg is None else cfg
    fs = float(cfg["sampleRateHz"])
    center = int(cfg["centerFreqHz"])
    rng = np.random.default_rng(seed)
    channels, expected = [], []
    for ch in cfg["channels"]:
        freq = int(ch["chanCenterFreq"])
        proto = ch.get("protocol", "pcm")
        if proto == "pocsag":
            bb, msgs = _pocsag_train(rng, seconds, "P")
            channels.append(FmChannel(freq - center, bb, pocsag_gen.BASE_RATE,
                                      pocsag_gen.BASE_RATE / 2, 9000))
        elif proto == "flex":
            bb, msgs = _flex_train(rng, seconds, "F",
                                   0.5 + BURST_PERIOD_S / 2)
            channels.append(FmChannel(freq - center, bb, 16_000, 8_000,
                                      7000))
        else:
            t = np.arange(int(seconds * 8_000)) / 8_000
            tone = (np.sin(2 * np.pi * 1_000 * t) * 8192).astype(np.int16)
            channels.append(FmChannel(freq - center, tone, 8_000, 6_000,
                                      7000))
            msgs = []
        expected += [(proto, freq, c, m) for c, m in msgs]
    iq = fm_capture(channels, fs, int(seconds * fs), seed + 1)
    return iq, sorted(expected)


def pocsag_capture(cfg: dict, seconds: float, seed: int = 0):
    """Every channel of plan ``cfg`` carries its own POCSAG burst train;
    returns ``(iq, expected)`` like :func:`pager_capture`."""
    fs = float(cfg["sampleRateHz"])
    center = int(cfg["centerFreqHz"])
    rng = np.random.default_rng(seed)
    channels, expected = [], []
    for i, ch in enumerate(cfg["channels"]):
        freq = int(ch["chanCenterFreq"])
        bb, msgs = _pocsag_train(rng, seconds, f"C{i}",
                                 0.5 + 0.4 * i)
        channels.append(FmChannel(freq - center, bb, pocsag_gen.BASE_RATE,
                                  pocsag_gen.BASE_RATE / 2, 3000))
        expected += [("pocsag", freq, c, m) for c, m in msgs]
    iq = fm_capture(channels, fs, int(seconds * fs), seed + 1)
    return iq, sorted(expected)


def messages_from_json(lines) -> list:
    """Sorted ``(proto, freq_hz, capcode, message)`` of ``pipeline-tpu``
    JSON lines (the comparison form of :func:`pager_capture`)."""
    out = []
    for ln in lines:
        if ln.strip():
            m = json.loads(ln)
            out.append((m["proto"], int(m["freqHz"]), int(m["capCode"]),
                        m["message"]))
    return sorted(out)


def fm_tone_capture(cfg: dict, seconds: float, seed: int = 0) -> np.ndarray:
    """Every channel of a multifm plan ``cfg`` carries an FM tone (a
    different audio frequency each); [N, 2] int16 at the plan's rate."""
    fs = float(cfg["sampleRateHz"])
    center = int(cfg["centerFreqHz"])
    audio_rate = 8_000
    t = np.arange(int(seconds * audio_rate)) / audio_rate
    channels = []
    for i, ch in enumerate(cfg["channels"]):
        tone = np.sin(2 * np.pi * (500 + 125 * i) * t) * 8192
        channels.append(FmChannel(int(ch["chanCenterFreq"]) - center,
                                  tone.astype(np.int16), audio_rate, 4_000,
                                  4000))
    return fm_capture(channels, fs, int(seconds * fs), seed)
