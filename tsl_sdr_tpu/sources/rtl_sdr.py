"""RTL-SDR source: config vocabulary + gain planning (hardware-gated open).

Pure-logic port targets from the reference driver (``multifm/rtl_sdr_if.c``):

* tuner gain selection against the device's supported-gain table —
  first supported gain >= the request, else the largest (``:263-291``)
* the E4000 6-stage IF gain ladder: greedy per-stage stepping until the
  accumulated gain stops changing (``:180-223``)
* test mode: librtlsdr replaces samples with an incrementing 8-bit counter
  (``sdrTestMode``, ``:436-444``) — reproduced here so ingest paths can be
  validated without hardware
* u8 -> Q.14 widening ``(s - 127) << 7`` lives in the native runtime and
  :func:`tsl_sdr_tpu.utils.iq.rtl_u8_to_q14` (``:118-147``)

Config keys (``etc/multifm.json``): deviceIndex, dBGainLNA, dbGainIF
(E4000 only), ppmCorrection, iqDumpFile; top-level sdrTestMode.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


def select_tuner_gain(requested_tenth_db: int, supported) -> int:
    """Pick the device gain for a request, in tenths of a dB.

    Walks the (ascending) supported table and returns the first entry that
    is >= the request; saturates at the table's maximum. Matches the
    reference's loop (rtl_sdr_if.c:263-271), including its quirk of
    returning the first table entry when the request is below it.
    """
    supported = list(supported)
    if not supported:
        raise ValueError("empty gain table")
    real = supported[0]
    for g in supported[1:]:
        if real >= requested_tenth_db:
            break
        real = g
    return real


def e4000_if_gain_plan(if_gain_tenths: int):
    """Greedy E4000 IF gain ladder (rtl_sdr_if.c:180-210).

    Returns (per-stage gains in tenth-dB [6], achieved total). Each stage
    starts at its datasheet minimum and is stepped while more gain is wanted
    and the stage has headroom, until a full sweep makes no progress.
    """
    gains = [-30, 0, 0, 0, 30, 30]
    steps = [90, 30, 30, 10, 30, 30]
    mx = [60, 90, 90, 20, 150, 150]
    cur = 30
    last = None
    while last != cur:
        last = cur
        for i in range(6):
            if steps[i] + gains[i] > mx[i]:
                continue
            if if_gain_tenths - cur > steps[i]:
                gains[i] += steps[i]
                cur += steps[i]
    return gains, cur


def test_mode_pattern(n_bytes: int, start: int = 0) -> np.ndarray:
    """librtlsdr test-mode stream: an incrementing 8-bit counter."""
    return ((start + np.arange(n_bytes)) & 0xFF).astype(np.uint8)


@dataclass
class RtlSdrConfig:
    """Parsed ``device`` stanza for ``type: rtlsdr``."""

    device_index: int = 0
    db_gain_lna: float | None = None   # None => AGC stays enabled
    db_gain_if: float | None = None    # E4000 only
    ppm_correction: int = 0
    iq_dump_file: str | None = None
    test_mode: bool = False

    @classmethod
    def from_dict(cls, device: dict, top: dict | None = None):
        top = top or {}
        return cls(
            device_index=int(device.get("deviceIndex", 0)),
            db_gain_lna=device.get("dBGainLNA"),
            db_gain_if=device.get("dbGainIF"),
            ppm_correction=int(device.get("ppmCorrection", 0)),
            iq_dump_file=device.get("iqDumpFile"),
            test_mode=bool(top.get("sdrTestMode", False)),
        )

    @property
    def gain_tenths(self) -> int | None:
        if self.db_gain_lna is None:
            return None
        return int(round(self.db_gain_lna * 10.0))

    def open(self):
        """Attach to hardware. Requires librtlsdr, which accelerator hosts usually lack."""
        raise RuntimeError(
            "rtlsdr hardware source requires librtlsdr and an attached "
            "dongle; on this host stream a capture instead "
            "(device type 'file' or multifm-tpu --iq-file, format rtl_u8)"
        )
