"""Bit-exact numpy oracles of the reference C arithmetic.

These are behavioral transcriptions of the reference's documented numeric
contracts (cited per function), used ONLY as test oracles for the JAX
kernels. They are deliberately slow, obvious, and loop-based.
"""

from __future__ import annotations

import numpy as np

Q = 14
ONE = 1 << Q
_I32 = 1 << 32
_I16 = 1 << 16


def wrap_i32(v) -> int:
    v = int(v) & (_I32 - 1)
    return v - _I32 if v >= (1 << 31) else v


def wrap_i16(v) -> int:
    v = int(v) & (_I16 - 1)
    return v - _I16 if v >= (1 << 15) else v


def round_q28_q14(a: int) -> int:
    """filter/complex.h:30-34 (named round_q30_q15 there)."""
    a = wrap_i32(a)
    return wrap_i16((a >> Q) + ((a >> (Q - 1)) & 1))


def cmul_q14_q28(ar, ai, br, bi):
    """filter/complex.h:40-46."""
    return wrap_i32(ar * br - ai * bi), wrap_i32(ar * bi + ai * br)


def cmul_q14_q14(ar, ai, br, bi):
    """filter/complex.h:51-62."""
    rr, ri = cmul_q14_q28(ar, ai, br, bi)
    return round_q28_q14(rr), round_q28_q14(ri)


def direct_fir_oracle(x_iq, taps_i16, decimation, rot_incr=None):
    """Streaming direct FIR over one contiguous int16 IQ stream.

    Contract: filter/direct_fir.c:329-417 (scalar MAC + Q.28 rounding),
    :152-172 (derotation), :44-87 (rotator init). Emits every output whose
    full T-tap window fits in the stream, windows advancing by `decimation`.
    """
    x = np.asarray(x_iq, dtype=np.int64)
    t = taps_i16.shape[0]
    cr = taps_i16[:, 0].astype(np.int64)
    ci = taps_i16[:, 1].astype(np.int64)
    rot = (ONE, 0)
    outs = []
    off = 0
    while off + t <= x.shape[0]:
        w = x[off:off + t]
        acc_re = wrap_i32(int(np.sum(cr * w[:, 0] - ci * w[:, 1])))
        acc_im = wrap_i32(int(np.sum(cr * w[:, 1] + ci * w[:, 0])))
        if rot_incr is not None and not (rot_incr[0] == 0 and rot_incr[1] == 0):
            a_re = round_q28_q14(acc_re)
            a_im = round_q28_q14(acc_im)
            d_re, d_im = cmul_q14_q28(a_re, a_im, rot[0], rot[1])
            rot = cmul_q14_q14(rot[0], rot[1], wrap_i16(rot_incr[0]),
                               wrap_i16(rot_incr[1]))
            acc_re, acc_im = d_re, d_im
        outs.append((round_q28_q14(acc_re), round_q28_q14(acc_im)))
        off += decimation
    return np.asarray(outs, dtype=np.int16)


def polyphase_oracle(x, coeff_i16, interpolate, decimate):
    """Streaming polyphase resample of one contiguous int16 stream.

    Contract: filter/polyphase_fir.c:47-105 (phase decomposition + padding),
    :162-233 (phase stepping), filter/utils.c:89-112 (dot + rounding).
    """
    x = np.asarray(x, dtype=np.int64)
    nr = len(coeff_i16)
    pc = (nr + interpolate - 1) // interpolate
    pc = (pc + 3) & ~3
    phases = np.zeros((interpolate, pc), dtype=np.int64)
    i = np.arange(nr)
    phases[i % interpolate, i // interpolate] = np.asarray(coeff_i16)

    outs = []
    phase = 0
    off = 0
    while off + pc <= x.shape[0]:
        acc = wrap_i32(int(np.sum(x[off:off + pc] * phases[phase])))
        outs.append(round_q28_q14(acc))
        phase += decimate
        off += phase // interpolate
        phase %= interpolate
    return np.asarray(outs, dtype=np.int16)


def dc_blocker_oracle(samples, pole):
    """filter/dc_blocker.h:46-93."""
    p = wrap_i16(int(np.trunc((1.0 - pole) * ONE)))
    acc = 0
    x_prev = 0
    y_prev = 0
    out = []
    for s in np.asarray(samples, dtype=np.int64):
        acc = wrap_i32(acc - x_prev)
        x_prev = wrap_i32(int(s) << Q)
        acc = wrap_i32(acc + x_prev - wrap_i32(p * y_prev))
        y_prev = acc >> Q
        out.append(wrap_i16(y_prev))
    return np.asarray(out, dtype=np.int16)
