"""IQ source drivers.

The reference supports four sources (``multifm/{rtl_sdr,airspy,uhd,file}_if.c``).
This build runs on accelerator hosts without radio hardware attached, so the hardware
drivers are split into their pure, testable logic (config parsing, gain
planning — implemented and unit-tested here) and the device-open step, which
raises a clear error unless the vendor library is importable.

File ingest (including real-time pacing and all 8-bit widenings) lives in
the native runtime (:mod:`tsl_sdr_tpu.runtime.native`) and
:mod:`tsl_sdr_tpu.utils.iq`.
"""

from tsl_sdr_tpu.sources.rtl_sdr import (  # noqa: F401
    RtlSdrConfig,
    e4000_if_gain_plan,
    select_tuner_gain,
    test_mode_pattern,
)
from tsl_sdr_tpu.sources.airspy import AirspyConfig  # noqa: F401
from tsl_sdr_tpu.sources.uhd import UhdConfig  # noqa: F401
