"""Execution-level parity oracle: the reference C, compiled and run in-process.

Builds the UNMODIFIED reference sources (pvachon/tsl-sdr, env ``TSL_REF_DIR``,
default ``/root/reference``) against the minimal TSL shim in ``shim/tsl``
plus the flat ctypes driver ``refc_driver.c``, and exposes them as plain
functions over numpy arrays.  Parity tests diff these outputs against the
JAX framework message-for-message and sample-for-sample, replacing trust in
hand-transcribed numpy oracles (VERDICT r1 item 1).

Everything degrades gracefully when the reference tree or a C toolchain is
absent: ``available()`` returns False and the parity tests skip.
"""

from __future__ import annotations

import ctypes
import os
import struct
import subprocess
import threading
from dataclasses import dataclass
from pathlib import Path

import numpy as np

REF_DIR = Path(os.environ.get("TSL_REF_DIR", "/root/reference"))
_HERE = Path(__file__).resolve().parent
_SHIM = _HERE / "shim"
_DRIVER = _HERE / "refc_driver.c"
_SO = _HERE / "_refc.so"
_LOCK = threading.Lock()
_LIB = None

SOURCES = [
    "pager/bch_code.c",
    "pager/pager_pocsag.c",
    "pager/pager_flex.c",
    "pager/mueller_muller.c",
    "ais/ais_demod.c",
    "ais/ais_decode.c",
    "filter/direct_fir.c",
    "filter/polyphase_fir.c",
    "filter/utils.c",
    "filter/sample_buf.c",
    "multifm/fm_demod.c",
    "multifm/fast_atan2f.c",
]


def available() -> bool:
    return (REF_DIR / "pager" / "pager_pocsag.c").exists()


def _build() -> Path:
    srcs = [str(REF_DIR / s) for s in SOURCES] + [str(_DRIVER)]
    deps = srcs + [str(p) for p in (_SHIM / "tsl").glob("*.h")]
    newest = max(os.path.getmtime(p) for p in deps)
    if _SO.exists() and _SO.stat().st_mtime >= newest:
        return _SO
    cmd = [
        "gcc", "-O2", "-std=c11", "-D_GNU_SOURCE", "-shared", "-fPIC",
        "-Wno-unused-variable", "-Wno-unused-but-set-variable", "-o", str(_SO),
        *srcs, f"-I{_SHIM}", f"-I{REF_DIR}", "-lm",
    ]
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(
            f"reference C build failed:\n{' '.join(cmd)}\n{r.stderr}")
    return _SO


def load():
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        lib = ctypes.CDLL(str(_build()))
        i16p = ctypes.POINTER(ctypes.c_int16)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        u32p = ctypes.POINTER(ctypes.c_uint32)
        i32p = ctypes.POINTER(ctypes.c_int32)
        for name in ("refc_pocsag_run",):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_long
            fn.argtypes = [i16p, ctypes.c_size_t, ctypes.c_size_t,
                           ctypes.c_int, u8p, ctypes.c_size_t]
        for name in ("refc_flex_run", "refc_ais_demod_run",
                     "refc_ais_decode_run"):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_long
            fn.argtypes = [i16p, ctypes.c_size_t, ctypes.c_size_t,
                           u8p, ctypes.c_size_t]
        lib.refc_bch_decode.restype = ctypes.c_long
        lib.refc_bch_decode.argtypes = [u32p, ctypes.c_size_t, u32p, i32p]
        lib.refc_direct_fir_run.restype = ctypes.c_long
        lib.refc_direct_fir_run.argtypes = [
            i16p, i16p, ctypes.c_size_t, ctypes.c_uint, ctypes.c_int,
            ctypes.c_uint32, ctypes.c_int32, i16p, ctypes.c_size_t,
            ctypes.c_size_t, i16p, ctypes.c_size_t,
        ]
        lib.refc_polyphase_run.restype = ctypes.c_long
        lib.refc_polyphase_run.argtypes = [
            i16p, ctypes.c_size_t, ctypes.c_uint, ctypes.c_uint,
            i16p, ctypes.c_size_t, ctypes.c_size_t, i16p, ctypes.c_size_t,
        ]
        lib.refc_fm_demod_run.restype = ctypes.c_long
        lib.refc_fm_demod_run.argtypes = [
            i16p, ctypes.c_size_t, ctypes.c_size_t, i16p, ctypes.c_size_t,
        ]
        lib.refc_dc_blocker_run.restype = ctypes.c_long
        lib.refc_dc_blocker_run.argtypes = [
            ctypes.c_double, i16p, ctypes.c_size_t, i16p,
        ]
        lib.refc_mm_run.restype = ctypes.c_long
        lib.refc_mm_run.argtypes = [
            ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
            ctypes.c_float, i16p, ctypes.c_size_t, ctypes.c_size_t,
            i16p, ctypes.c_size_t,
        ]
        _LIB = lib
        return lib


def _i16p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int16))


def _run_emitting(fn, pcm: np.ndarray, block: int, *extra) -> bytes:
    pcm = np.ascontiguousarray(pcm, dtype=np.int16)
    cap = 1 << 20
    while True:
        out = np.zeros(cap, np.uint8)
        ret = fn(_i16p(pcm), pcm.size, block, *extra,
                 out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), cap)
        if ret == -2:
            cap *= 4
            continue
        if ret < 0:
            raise RuntimeError(f"{fn} failed: {ret}")
        return out[:ret].tobytes()


class _Cursor:
    def __init__(self, data: bytes):
        self.d = data
        self.o = 0

    def take(self, fmt: str):
        vals = struct.unpack_from("<" + fmt, self.d, self.o)
        self.o += struct.calcsize("<" + fmt)
        return vals if len(vals) > 1 else vals[0]

    def raw(self, n: int) -> bytes:
        b = self.d[self.o:self.o + n]
        self.o += n
        return b

    def done(self) -> bool:
        return self.o >= len(self.d)


# ---- POCSAG ---------------------------------------------------------------

@dataclass
class RefPocsagMessage:
    kind: str       # "alpha" | "numeric"
    baud: int
    capcode: int
    function: int
    data: bytes


def pocsag_run(pcm, block: int = 1024, skip_bch: bool = False):
    """Run the reference POCSAG decoder (pager/pager_pocsag.c) on PCM."""
    raw = _run_emitting(load().refc_pocsag_run, pcm, block, int(skip_bch))
    c = _Cursor(raw)
    msgs = []
    while not c.done():
        tag = chr(c.take("B"))
        baud, capcode, function, ln = c.take("HIBI")
        msgs.append(RefPocsagMessage(
            kind="alpha" if tag == "A" else "numeric",
            baud=baud, capcode=capcode, function=function, data=c.raw(ln)))
    return msgs


# ---- FLEX -------------------------------------------------------------------

@dataclass
class RefFlexMessage:
    kind: str       # "alnum" | "num" | "siv"
    baud: int
    phase: int
    cycle: int
    frame: int
    capcode: int
    data: bytes = b""
    fragmented: bool = False
    maildrop: bool = False
    seq: int = 0
    siv_type: int = 0
    siv_data: int = 0


def flex_run(pcm, block: int = 1024):
    """Run the reference FLEX decoder (pager/pager_flex.c) on 16 kHz PCM."""
    raw = _run_emitting(load().refc_flex_run, pcm, block)
    c = _Cursor(raw)
    msgs = []
    while not c.done():
        tag = chr(c.take("B"))
        baud, phase, cyc, frame, cap = c.take("HBBBQ")
        if tag == "L":
            frag, maildrop, seq, ln = c.take("BBBI")
            msgs.append(RefFlexMessage(
                kind="alnum", baud=baud, phase=phase, cycle=cyc, frame=frame,
                capcode=cap, data=c.raw(ln), fragmented=bool(frag),
                maildrop=bool(maildrop), seq=seq))
        elif tag == "U":
            ln = c.take("I")
            msgs.append(RefFlexMessage(
                kind="num", baud=baud, phase=phase, cycle=cyc, frame=frame,
                capcode=cap, data=c.raw(ln)))
        else:
            siv_type, siv_data = c.take("BI")
            msgs.append(RefFlexMessage(
                kind="siv", baud=baud, phase=phase, cycle=cyc, frame=frame,
                capcode=cap, siv_type=siv_type, siv_data=siv_data))
    return msgs


# ---- AIS --------------------------------------------------------------------

def ais_demod_run(pcm, block: int = 1024):
    """Run the reference AIS demod; returns [(packet_bytes, fcs_valid)]."""
    raw = _run_emitting(load().refc_ais_demod_run, pcm, block)
    c = _Cursor(raw)
    pkts = []
    while not c.done():
        assert chr(c.take("B")) == "P"
        fcs, ln = c.take("BI")
        pkts.append((c.raw(ln), bool(fcs)))
    return pkts


def ais_decode_run(pcm, block: int = 1024):
    """Run the reference AIS field decoder; returns typed report dicts."""
    raw = _run_emitting(load().refc_ais_decode_run, pcm, block)
    c = _Cursor(raw)
    reports = []
    while not c.done():
        tag = chr(c.take("B"))
        mmsi, rawlen = c.take("II")
        armored = c.raw(rawlen).decode("ascii")
        if tag == "R":
            nav, course, heading, ts = c.take("IIII")
            lon, lat, sog = c.take("fff")
            reports.append({"type": "position", "mmsi": mmsi, "raw": armored,
                            "nav_stat": nav, "course": course,
                            "heading": heading, "timestamp": ts,
                            "longitude": lon, "latitude": lat,
                            "speed_over_ground": sog})
        elif tag == "B":
            y, mo, d, h, mi, s = c.take("IIIIII")
            lon, lat = c.take("ff")
            reports.append({"type": "base_station", "mmsi": mmsi,
                            "raw": armored, "year": y, "month": mo, "day": d,
                            "hour": h, "minute": mi, "second": s,
                            "longitude": lon, "latitude": lat})
        else:
            imo, ship_type = c.take("II")
            callsign = c.raw(8).split(b"\0")[0].decode("ascii")
            ship_name = c.raw(21).split(b"\0")[0].decode("ascii")
            dest = c.raw(21).split(b"\0")[0].decode("ascii")
            reports.append({"type": "voyage", "mmsi": mmsi, "raw": armored,
                            "imo_number": imo, "ship_type": ship_type,
                            "callsign": callsign, "ship_name": ship_name,
                            "destination": dest})
    return reports


# ---- BCH / FIR / polyphase / MM ----------------------------------------------

def bch_decode(words) -> tuple[np.ndarray, np.ndarray]:
    """Reference BCH(31,21,t=2) decode; returns (corrected, rc) arrays.

    rc != 0 means uncorrectable (pager/bch_code.c:307-398).
    """
    words = np.ascontiguousarray(words, dtype=np.uint32)
    corrected = np.zeros_like(words)
    rc = np.zeros(words.shape, np.int32)
    ret = load().refc_bch_decode(
        words.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)), words.size,
        corrected.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        rc.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    if ret < 0:
        raise RuntimeError("refc_bch_decode failed")
    return corrected, rc


def direct_fir_run(taps_re, taps_im, decim: int, iq, *, derotate=False,
                   fs: int = 0, freq_shift: int = 0,
                   buf_samples: int = 4096) -> np.ndarray:
    """Reference scalar direct FIR (filter/direct_fir.c) over [N,2] int16 IQ."""
    taps_re = np.ascontiguousarray(taps_re, np.int16)
    taps_im = np.ascontiguousarray(taps_im, np.int16)
    iq = np.ascontiguousarray(iq, np.int16)
    n = iq.shape[0]
    cap = n // decim + 16
    out = np.zeros((cap, 2), np.int16)
    ret = load().refc_direct_fir_run(
        _i16p(taps_re), _i16p(taps_im), taps_re.size, decim, int(derotate),
        fs, freq_shift, _i16p(iq), n, buf_samples, _i16p(out), cap)
    if ret < 0:
        raise RuntimeError("refc_direct_fir_run failed")
    return out[:ret]


def polyphase_run(taps, interp: int, decim: int, pcm, *,
                  buf_samples: int = 1024) -> np.ndarray:
    """Reference polyphase resampler (filter/polyphase_fir.c) over int16 PCM."""
    taps = np.ascontiguousarray(taps, np.int16)
    pcm = np.ascontiguousarray(pcm, np.int16)
    cap = int(pcm.size * interp / decim) + 64
    out = np.zeros(cap, np.int16)
    ret = load().refc_polyphase_run(
        _i16p(taps), taps.size, interp, decim, _i16p(pcm), pcm.size,
        buf_samples, _i16p(out), cap)
    if ret < 0:
        raise RuntimeError("refc_polyphase_run failed")
    return out[:ret]


def fm_demod_run(iq, block: int = 1024) -> np.ndarray:
    """Reference FM discriminator (multifm/fm_demod.c) over [N,2] int16 IQ."""
    iq = np.ascontiguousarray(iq, np.int16)
    n = iq.shape[0]
    out = np.zeros(n, np.int16)
    ret = load().refc_fm_demod_run(_i16p(iq), n, block, _i16p(out), n)
    if ret < 0:
        raise RuntimeError(f"refc_fm_demod_run failed: {ret}")
    return out[:ret]


def dc_blocker_run(pcm, pole: float) -> np.ndarray:
    """Reference DC blocker (filter/dc_blocker.h, header-only)."""
    pcm = np.ascontiguousarray(pcm, np.int16)
    out = np.empty_like(pcm)
    ret = load().refc_dc_blocker_run(pole, _i16p(pcm), pcm.size, _i16p(out))
    if ret < 0:
        raise RuntimeError("refc_dc_blocker_run failed")
    return out


def mm_run(pcm, *, kw: float, km: float, samples_per_bit: float,
           error_min: float, error_max: float,
           block: int = 1024) -> np.ndarray:
    """Reference Mueller-Müller decisions (pager/mueller_muller.c)."""
    pcm = np.ascontiguousarray(pcm, np.int16)
    cap = int(pcm.size / samples_per_bit) + 16 + 2 * (
        pcm.size // block + 1)
    out = np.zeros(cap, np.int16)
    ret = load().refc_mm_run(
        kw, km, samples_per_bit, error_min, error_max,
        _i16p(pcm), pcm.size, block, _i16p(out), cap)
    if ret < 0:
        raise RuntimeError(f"refc_mm_run failed: {ret}")
    return out[:ret]
