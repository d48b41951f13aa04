"""ctypes bindings for the native C++ streaming runtime (native/tslstream.cc).

The native library is the production ingest/egress path: a reader thread
fills a fixed frame pool from a file/FIFO (with the reference's 8-bit
widening and real-time pacing semantics) while the device computes, and sinks
drain PCM with EPIPE-tolerant drop-and-count behavior. Python only touches
whole blocks.

Built on demand with g++ (pybind11 is not in the image; the C ABI + ctypes
keeps the binding dependency-free). Falls back with a clear error when no
toolchain is present.
"""

from __future__ import annotations

import ctypes
import subprocess
import threading
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parents[1] / "native" / "tslstream.cc"
_SO = Path(__file__).resolve().parent / "_tslstream.so"
_LOCK = threading.Lock()
_LIB = None

FORMATS = {"cs16": 0, "cs8": 1, "cu8": 2, "rtl_u8": 3}


def _build() -> Path:
    if _SO.exists() and _SO.stat().st_mtime >= _SRC.stat().st_mtime:
        return _SO
    cmd = [
        "g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-pthread",
        str(_SRC), "-o", str(_SO),
    ]
    subprocess.run(cmd, check=True, capture_output=True)
    return _SO


def load():
    """Compile (if stale) and load the native library."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        lib = ctypes.CDLL(str(_build()))
        lib.tsl_source_new.restype = ctypes.c_void_p
        lib.tsl_source_new.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_size_t, ctypes.c_size_t,
            ctypes.c_double, ctypes.c_int,
        ]
        lib.tsl_source_start.argtypes = [ctypes.c_void_p]
        lib.tsl_source_read.restype = ctypes.c_long
        lib.tsl_source_read.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int16), ctypes.c_size_t,
        ]
        lib.tsl_source_level.restype = ctypes.c_size_t
        lib.tsl_source_level.argtypes = [ctypes.c_void_p]
        lib.tsl_source_stats.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint64)
        ]
        lib.tsl_source_free.argtypes = [ctypes.c_void_p]
        lib.tsl_sink_new.restype = ctypes.c_void_p
        lib.tsl_sink_new.argtypes = [ctypes.c_char_p]
        lib.tsl_sink_write.restype = ctypes.c_long
        lib.tsl_sink_write.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int16), ctypes.c_size_t,
        ]
        lib.tsl_sink_stats.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint64)
        ]
        lib.tsl_sink_free.argtypes = [ctypes.c_void_p]
        lib.tsl_rotator_seq.argtypes = [
            ctypes.POINTER(ctypes.c_int16), ctypes.POINTER(ctypes.c_int32),
            ctypes.c_size_t, ctypes.c_size_t, ctypes.POINTER(ctypes.c_int16),
        ]
        lib.tsl_costas.argtypes = [
            ctypes.POINTER(ctypes.c_int16), ctypes.c_size_t,
            ctypes.c_float, ctypes.c_float, ctypes.c_float,
            ctypes.c_float, ctypes.c_float,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int16),
        ]
        lib.tsl_flex_new.restype = ctypes.c_void_p
        lib.tsl_flex_free.argtypes = [ctypes.c_void_p]
        lib.tsl_flex_state.restype = ctypes.c_int
        lib.tsl_flex_state.argtypes = [ctypes.c_void_p]
        lib.tsl_flex_in_search.restype = ctypes.c_int
        lib.tsl_flex_in_search.argtypes = [ctypes.c_void_p]
        lib.tsl_flex_sync_reset_only.argtypes = [ctypes.c_void_p]
        lib.tsl_flex_verdict.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.tsl_flex_on_pcm.restype = ctypes.c_long
        lib.tsl_flex_on_pcm.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int16), ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_size_t),
        ]
        lib.tsl_bch3121_decode.argtypes = [
            ctypes.POINTER(ctypes.c_uint32), ctypes.c_long,
            ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_uint8),
        ]
        lib.tsl_pocsag_new.restype = ctypes.c_void_p
        lib.tsl_pocsag_free.argtypes = [ctypes.c_void_p]
        lib.tsl_pocsag_state.restype = ctypes.c_int
        lib.tsl_pocsag_state.argtypes = [ctypes.c_void_p]
        lib.tsl_pocsag_detect_reset.argtypes = [ctypes.c_void_p]
        lib.tsl_pocsag_on_pcm.restype = ctypes.c_long
        lib.tsl_pocsag_on_pcm.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int16), ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_size_t,
        ]
        lib.tsl_ais_new.restype = ctypes.c_void_p
        lib.tsl_ais_free.argtypes = [ctypes.c_void_p]
        lib.tsl_ais_detect_reset.argtypes = [ctypes.c_void_p]
        lib.tsl_ais_crc_rejects.restype = ctypes.c_uint64
        lib.tsl_ais_crc_rejects.argtypes = [ctypes.c_void_p]
        lib.tsl_ais_state.restype = ctypes.c_int
        lib.tsl_ais_state.argtypes = [ctypes.c_void_p]
        lib.tsl_ais_on_pcm.restype = ctypes.c_long
        lib.tsl_ais_on_pcm.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int16), ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_size_t,
        ]
        _LIB = lib
        return lib


def bch3121_decode_native(words: np.ndarray):
    """Batch BCH(31,21,t=2) decode via the native corrector.

    Same contract as models/bch.py BchCode.decode on the POCSAG/FLEX
    instance (fuzz-diffed in tests/test_models.py)."""
    lib = load()
    words = np.ascontiguousarray(words, np.uint32)
    out = np.empty_like(words)
    fail = np.empty(words.size, np.uint8)
    lib.tsl_bch3121_decode(
        words.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)), words.size,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        fail.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return out, fail.astype(bool)


class FlexNative:
    """Handle to the native FLEX sample FSM (tslstream.cc tsl_flex_*).

    Pauses at each FIW for the caller's BCH verdict (the FLEX FSM's
    transitions depend on BCH there, unlike POCSAG); frame events carry
    each phase's 88 words for vectorized BCH + message assembly."""

    def __init__(self):
        self._lib = load()
        self._h = self._lib.tsl_flex_new()

    def on_pcm(self, pcm: np.ndarray):
        """Returns (events, consumed). Events: ('fiw', coding_idx, range,
        delta, fiw_raw) — processing paused, call verdict() — or
        ('frame', coding_idx, [(phase_id, words[88])...])."""
        pcm = np.ascontiguousarray(pcm, np.int16)
        cap = pcm.size // 8 + 8192
        out = np.empty(cap, np.uint8)
        consumed = ctypes.c_size_t(0)
        ret = self._lib.tsl_flex_on_pcm(
            self._h, pcm.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
            pcm.size, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            cap, ctypes.byref(consumed))
        if ret < 0:
            raise RuntimeError("tsl_flex_on_pcm output buffer overflow")
        events = []
        buf = bytes(out[:ret])
        o = 0
        while o < ret:
            tag = buf[o]
            o += 1
            if tag == ord("F"):
                idx = buf[o]
                rng = int.from_bytes(buf[o+1:o+5], "little", signed=True)
                delta = int.from_bytes(buf[o+5:o+9], "little", signed=True)
                fiw = int.from_bytes(buf[o+9:o+13], "little")
                events.append(("fiw", idx, rng, delta, fiw))
                o += 13
            else:
                idx = buf[o]
                o += 1
                nr = (1, 2, 2, 4)[idx]
                phases = []
                for _ in range(nr):
                    pid = buf[o]
                    words = np.frombuffer(buf, np.uint32, 88, o + 1)
                    phases.append((pid, words))
                    o += 1 + 88 * 4
                events.append(("frame", idx, phases))
        return events, int(consumed.value)

    def verdict(self, ok: bool):
        self._lib.tsl_flex_verdict(self._h, 1 if ok else 0)

    def sync_reset_only(self):
        self._lib.tsl_flex_sync_reset_only(self._h)

    @property
    def state(self) -> int:
        return self._lib.tsl_flex_state(self._h)

    @property
    def in_search(self) -> bool:
        """SYNC_1 hunt with zero progress (see tsl_flex_in_search)."""
        return bool(self._lib.tsl_flex_in_search(self._h))

    def __del__(self):
        try:
            if self._h:
                self._lib.tsl_flex_free(self._h)
                self._h = None
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass


class PocsagNative:
    """Handle to the native POCSAG sample FSM (tslstream.cc tsl_pocsag_*).

    Emits ('batch', baud, words[16]) and ('sync_lost',) events; BCH and
    message assembly stay on the Python side (the FSM's transitions never
    depend on BCH, pager_pocsag.c:451-540)."""

    def __init__(self):
        self._lib = load()
        self._h = self._lib.tsl_pocsag_new()

    def on_pcm(self, pcm: np.ndarray) -> list[tuple]:
        pcm = np.ascontiguousarray(pcm, np.int16)
        # one batch per 512*spb(>=16) samples max, 67 bytes per event
        cap = pcm.size // 64 + 4096
        out = np.empty(cap, np.uint8)
        ret = self._lib.tsl_pocsag_on_pcm(
            self._h, pcm.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
            pcm.size, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), cap)
        if ret < 0:
            raise RuntimeError("tsl_pocsag_on_pcm output buffer overflow")
        events = []
        buf = bytes(out[:ret])
        o = 0
        while o < ret:
            tag = buf[o]
            o += 1
            if tag == ord("B"):
                baud = int.from_bytes(buf[o:o + 2], "little")
                words = np.frombuffer(buf, np.uint32, 16, o + 2)
                events.append(("batch", baud, words))
                o += 2 + 64
            else:
                events.append(("sync_lost",))
        return events

    def detect_reset(self):
        self._lib.tsl_pocsag_detect_reset(self._h)

    @property
    def in_search(self) -> bool:
        return self._lib.tsl_pocsag_state(self._h) == 0

    def __del__(self):
        try:
            if self._h:
                self._lib.tsl_pocsag_free(self._h)
                self._h = None
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass


class AisNative:
    """Handle to the native AIS demod FSM (tslstream.cc tsl_ais_*)."""

    def __init__(self):
        self._lib = load()
        self._h = self._lib.tsl_ais_new()

    def on_pcm(self, pcm: np.ndarray) -> list[bytes]:
        pcm = np.ascontiguousarray(pcm, np.int16)
        cap = pcm.size // 8 + 4096  # dense-traffic worst case, with margin
        out = np.empty(cap, np.uint8)
        ret = self._lib.tsl_ais_on_pcm(
            self._h, pcm.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
            pcm.size, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), cap)
        if ret < 0:
            raise RuntimeError("tsl_ais_on_pcm output buffer overflow")
        pkts = []
        o = 0
        buf = bytes(out[:ret])
        while o < ret:
            ln = int.from_bytes(buf[o:o + 4], "little")
            pkts.append(buf[o + 4 : o + 4 + ln])
            o += 4 + ln
        return pkts

    def detect_reset(self):
        self._lib.tsl_ais_detect_reset(self._h)

    @property
    def in_search(self) -> bool:
        return self._lib.tsl_ais_state(self._h) == 0

    @property
    def crc_rejects(self) -> int:
        return int(self._lib.tsl_ais_crc_rejects(self._h))

    def __del__(self):
        try:
            if self._h:
                self._lib.tsl_ais_free(self._h)
                self._h = None
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass


def costas_native(x: np.ndarray, params, state=None):
    """Serial Costas loop at native speed (see ops/costas.py for semantics).

    x: [N, 2] int16 IQ; params: CostasParams; state: optional (phase, f_dev)
    floats. Returns (out [N, 2] int16, (phase, f_dev)).
    """
    lib = load()
    x = np.ascontiguousarray(x, np.int16)
    out = np.empty_like(x)
    st = np.asarray(
        [0.0, params.f_dev_nominal] if state is None else list(state),
        dtype=np.float32,
    )
    lib.tsl_costas(
        x.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)), x.shape[0],
        params.alpha, params.beta, params.e_max,
        params.f_dev_min, params.f_dev_max,
        st.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
    )
    return out, (float(st[0]), float(st[1]))


def rotator_seq(rot: np.ndarray, incr: np.ndarray, n: int) -> np.ndarray:
    """Q.14 derotator sequence for the bit-exact tier (native helper).

    rot: [C, 2] int16 current rotator (UPDATED IN PLACE to the state after n
    outputs); incr: [C, 2] int32 Q.14 increment. Returns [n, C, 2] int16 —
    the rotator value BEFORE each output, exactly replicating the
    reference's use-then-advance recurrence with its un-renormalized drift
    (filter/direct_fir.c:152-172).
    """
    lib = load()
    rot = np.ascontiguousarray(rot, np.int16)
    incr = np.ascontiguousarray(incr, np.int32)
    c = rot.shape[0]
    out = np.empty((n, c, 2), dtype=np.int16)
    lib.tsl_rotator_seq(
        rot.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
        incr.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        c, n,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
    )
    return out


class NativeSource:
    """Background-threaded IQ/PCM source over a file or FIFO.

    Parameters mirror the reference source drivers: ``fmt`` selects the
    ingest widening (cs16/cs8/cu8/rtl_u8), ``pace_sps`` (complex samples/s)
    enables file_if-style real-time delivery, ``drop_on_full`` selects the
    receiver's drop-and-count overflow policy instead of backpressure.
    """

    def __init__(self, path, fmt="cs16", frame_samples=65536, pool_frames=64,
                 pace_sps=0.0, drop_on_full=False):
        self._lib = load()
        self._h = self._lib.tsl_source_new(
            str(path).encode(), FORMATS[fmt], 2 * frame_samples, pool_frames,
            2.0 * pace_sps, 1 if drop_on_full else 0,
        )
        if not self._h:
            raise OSError(f"cannot open source {path}")
        self._lib.tsl_source_start(self._h)

    def read(self, n_samples: int) -> np.ndarray:
        """Blocking read of up to n_samples; short result means EOF.

        Returns interleaved int16 values shaped [2 * got] (flat — the
        lane-packed layout the device pipeline wants).
        """
        out = np.empty(2 * n_samples, dtype=np.int16)
        got = self._lib.tsl_source_read(
            self._h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
            out.size,
        )
        return out[: got - (got % 2)]

    @property
    def stats(self) -> dict:
        if not self._h:
            raise ValueError("source is closed")
        buf = (ctypes.c_uint64 * 4)()
        self._lib.tsl_source_stats(self._h, buf)
        return {
            "values_in": buf[0],
            "values_out": buf[1],
            "dropped_frames": buf[2],
            "eof": bool(buf[3]),
        }

    def close(self):
        if self._h:
            self._lib.tsl_source_free(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class NativeSink:
    """EPIPE-tolerant PCM sink (drop + count, like the demod thread)."""

    def __init__(self, path):
        self._lib = load()
        self._h = self._lib.tsl_sink_new(str(path).encode())
        if not self._h:
            raise OSError(f"cannot open sink {path}")

    def write(self, pcm: np.ndarray) -> int:
        pcm = np.ascontiguousarray(pcm, dtype=np.int16)
        return self._lib.tsl_sink_write(
            self._h, pcm.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
            pcm.size,
        )

    @property
    def stats(self) -> dict:
        if not self._h:
            raise ValueError("sink is closed")
        buf = (ctypes.c_uint64 * 4)()
        self._lib.tsl_sink_stats(self._h, buf)
        return {
            "values_out": buf[1],
            "dropped_writes": buf[2],
            "broken": bool(buf[3]),
        }

    def close(self):
        if self._h:
            self._lib.tsl_sink_free(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
