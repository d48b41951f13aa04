"""Speed-of-light bounds for the benchmark configs, from the card's peaks.

One table of published peaks keyed by JAX's ``device_kind``; a device
that is not in it is an error, never a default. Each bench row gets the
Msps bound its algorithm implies at those peaks and the % of that bound
attained.

The bounds are ALGORITHMIC lower bounds (useful MACs, minimal bytes:
stream in once, stream results out once). Real kernels move intermediates
too, so "% of SoL" is a conservative utilization number: 100% would mean
zero overhead AND perfect overlap. Published peaks assume the card's full
power limit; a card capped below it (``nvidia-smi`` ``power.limit``)
cannot hold its top clock, so quote the limit beside every share.
"""

from __future__ import annotations

import math
from dataclasses import dataclass


@dataclass(frozen=True)
class Peaks:
    """Dense (no sparsity) peak rates of one card, operations per second
    (one multiply-accumulate = 2 operations), and device-memory bytes/s."""

    bf16: float
    int8: float
    tf32: float
    f32: float
    hbm_bytes: float
    source: str


PEAKS = {
    "NVIDIA H100 80GB HBM3": Peaks(
        bf16=989e12, int8=1979e12, tf32=495e12, f32=67e12,
        hbm_bytes=3.35e12,
        source="NVIDIA H100 SXM data sheet, dense rates, 700 W"),
}


def peaks_for(device_kind: str) -> Peaks:
    """The :class:`Peaks` of ``device_kind``; raises ``KeyError`` for a
    device the table does not know."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise KeyError(
            f"no published peaks for device kind {device_kind!r}; add it "
            f"to utils.roofline.PEAKS (known: {sorted(PEAKS)})") from None


@dataclass
class Bound:
    sol_msps: float        # min(compute, memory)
    compute_msps: float
    hbm_msps: float

    @property
    def limiter(self) -> str:
        return "compute" if self.compute_msps <= self.hbm_msps else "HBM"

    def pct(self, measured_msps: float) -> float:
        return 100.0 * measured_msps / self.sol_msps

    def describe(self, measured_msps: float) -> str:
        return (f"{self.pct(measured_msps):.1f}% of the "
                f"{self.sol_msps / 1e3:,.0f} Gsps single-card "
                f"speed-of-light ({self.limiter}-bound)")


def _bound(macs_per_sample: float, bytes_per_sample: float, peaks: Peaks,
           rate: str) -> Bound:
    macs_per_s = getattr(peaks, rate) / 2.0
    compute = macs_per_s / macs_per_sample / 1e6
    hbm = peaks.hbm_bytes / bytes_per_sample / 1e6
    return Bound(sol_msps=min(compute, hbm), compute_msps=compute,
                 hbm_msps=hbm)


def channelizer(nr_channels: int, taps: int, decim: int, peaks: Peaks,
                rate: str = "int8") -> Bound:
    """N-channel complex-bandpass FIR + decimate + derotate + FM demod.

    Useful MACs per input sample: each channel computes one T-tap complex
    MAC (4T real MACs) per D input samples. Minimal HBM bytes per input
    sample: 4 (IQ int16 in) + 2*C/D (PCM int16 out). ``rate`` names the
    :class:`Peaks` field the MACs run at (default: the integer tensor-core
    rate, the fastest exact route for int16 data split into int8 halves).
    """
    macs = nr_channels * 4.0 * taps / decim
    bytes_per = 4.0 + 2.0 * nr_channels / decim
    return _bound(macs, bytes_per, peaks, rate)


def resampler(taps: int, interp: int, decim: int, peaks: Peaks,
              rate: str = "int8") -> Bound:
    """Rational I/D polyphase resampler on real int16 PCM.

    Per input sample: I/D outputs, each a ceil(T/I)-tap real MAC.
    Minimal bytes: 2 in + 2*I/D out.
    """
    phase_len = math.ceil(taps / interp)
    macs = (interp / decim) * phase_len
    bytes_per = 2.0 + 2.0 * interp / decim
    return _bound(macs, bytes_per, peaks, rate)
