"""The plain reference's demodulator in NumPy: IQ buffers -> every preamble
position and, for each, both demodulation passes.

Behavioral contract: detectModeS and applyPhaseCorrection of
antirez/dump1090 (dump1090.c:1452-1793): the magnitude table, the preamble
predicate, the PPM bit slicing with its repeat rule and first-bit error, the
noise gate, and the phase-corrected retry, which is computed out of place
(the reference corrects its buffer and restores it).  Loops run over bits
and samples, each step over all candidates at once; nothing here is
approximate.
"""

from __future__ import annotations

import functools
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np

from .modes import (
    BIT_REPEAT_DELTA,
    FULL_LEN_SAMPLES,
    LONG_MSG_BITS,
    NOISE_GATE,
    PREAMBLE_SAMPLES,
    SCAN_LEN,
    SHORT_MSG_BITS,
)


@functools.cache
def maglut() -> np.ndarray:
    """The reference's 129 x 129 magnitude table (dump1090.c:359-364):
    round(sqrt(i^2 + q^2) * 360), half away from zero."""
    i = np.arange(129, dtype=np.float64)[:, None]
    q = np.arange(129, dtype=np.float64)[None, :]
    return np.floor(np.sqrt(i * i + q * q) * 360.0 + 0.5).astype(np.int32)


def magnitudes(iq: np.ndarray) -> np.ndarray:
    """uint8 interleaved IQ (..., 2N) -> int32 magnitudes (..., N)."""
    i = np.abs(iq[..., 0::2].astype(np.int32) - 127)
    q = np.abs(iq[..., 1::2].astype(np.int32) - 127)
    return maglut()[i, q]


def preamble_positions(m: np.ndarray, scan_len: int = SCAN_LEN) -> np.ndarray:
    """Every scan position j < scan_len of one buffer's magnitudes at which
    the preamble predicate holds (dump1090.c:1602-1650), ascending."""

    def s(k: int) -> np.ndarray:
        return m[k : k + scan_len]

    ok = ((s(0) > s(1)) & (s(1) < s(2)) & (s(2) > s(3)) & (s(3) < s(0))
          & (s(4) < s(0)) & (s(5) < s(0)) & (s(6) < s(0))
          & (s(7) > s(8)) & (s(8) < s(9)) & (s(9) > s(6)))
    high = (s(0) + s(2) + s(7) + s(9)) // 6
    ok &= (s(4) < high) & (s(5) < high)
    ok &= (s(11) < high) & (s(12) < high) & (s(13) < high) & (s(14) < high)
    return np.nonzero(ok)[0]


def _slice_bits(ms: np.ndarray):
    """PPM bit decisions of (N, 224) message samples, then the bytes
    (dump1090.c:1666-1706).  Returns (uint8 (N, 14), int errors (N,))."""
    n = ms.shape[0]
    bits = np.zeros((n, LONG_MSG_BITS), dtype=np.int64)
    errors = np.zeros(n, dtype=np.int64)
    prev = np.zeros(n, dtype=np.int64)
    for i in range(LONG_MSG_BITS):
        low = ms[:, 2 * i]
        high = ms[:, 2 * i + 1]
        b = np.where(low > high, 1, 0)
        if i == 0:
            same = low == high
            b = np.where(same, 2, b)
            errors += same
        else:
            b = np.where(np.abs(low - high) < BIT_REPEAT_DELTA, prev, b)
        bits[:, i] = b
        prev = b
    # bytes are ORs of shifted bit values: an error value 2 spills into the
    # next higher bit, as in the reference
    out = np.zeros((n, 14), dtype=np.int64)
    for k in range(8):
        out |= bits[:, k::8] << (7 - k)
    return (out & 0xFF).astype(np.uint8), errors


def _gate(orig: np.ndarray, df: np.ndarray) -> np.ndarray:
    """The noise gate on the ORIGINAL samples over the length the sliced DF
    claims (dump1090.c:1709-1726)."""
    delta = np.abs(orig[:, 0::2] - orig[:, 1::2])
    long_ = (df >= 16) & (df <= 21)
    total = np.where(long_, delta.sum(axis=1), delta[:, :SHORT_MSG_BITS].sum(axis=1))
    return total // np.where(long_, 14 * 4, 7 * 4) >= NOISE_GATE


def _phase_corrected(w: np.ndarray) -> np.ndarray:
    """applyPhaseCorrection (dump1090.c:1471-1558) of the 224 message
    samples of windows w (N, 241), w[:, 0] = m[j - 1]: from the preamble's
    early and late energy, every other sample is scaled by 16384 +- q
    (fixed point, / 16384, clamped to 65535), each factor chosen by the
    previous scaled sample's comparison with its neighbour; forward over
    the even samples, or backward over the odd ones when early > late."""
    w = w.astype(np.int64)
    on_time = w[:, 1] + w[:, 3] + w[:, 8] + w[:, 10]
    early = (w[:, 0] + w[:, 7]) * 2
    late = (w[:, 4] + w[:, 11]) * 2
    m = w[:, PREAMBLE_SAMPLES + 1 :].copy()
    backward = early > late
    e = np.where(backward, early, late)
    q = (16384 * e) // np.maximum(e + on_time, 1)
    up, down = 16384 + q, 16384 - q

    def scale(v, f):
        return np.minimum((v * f) >> 14, 65535)

    fw = ~backward
    bw = backward
    m[fw, 0] = scale(m[fw, 0], up[fw])
    m[bw, 223] = scale(m[bw, 223], up[bw])
    mf, mb = m[fw], m[bw]
    uf, df_, ub, db = up[fw], down[fw], up[bw], down[bw]
    for k in range(111):
        # forward: even sample 2k+2 by the scaled 2k against the odd 2k+1
        f = np.where(mf[:, 2 * k] > mf[:, 2 * k + 1], uf, df_)
        mf[:, 2 * k + 2] = scale(mf[:, 2 * k + 2], f)
        # backward: odd sample 221-2k by the even 222-2k against the
        # scaled 223-2k
        f = np.where(mb[:, 222 - 2 * k] > mb[:, 223 - 2 * k], db, ub)
        mb[:, 221 - 2 * k] = scale(mb[:, 221 - 2 * k], f)
    m[fw], m[bw] = mf, mb
    return m


@dataclass
class Candidates:
    """Both passes of every preamble candidate of a run of buffers, in scan
    order: `buf` is each candidate's buffer index, `pos` its position."""

    buf: np.ndarray
    pos: np.ndarray
    msg1: np.ndarray
    errors1: np.ndarray
    gate1: np.ndarray
    msg2: np.ndarray
    errors2: np.ndarray
    gate2: np.ndarray


def _demodulate(bufs: np.ndarray, first: int, phase_correction: bool) -> Candidates:
    windows, buf_idx, positions = [], [], []
    for b in range(bufs.shape[0]):
        m = magnitudes(bufs[b])
        pos = preamble_positions(m)
        padded = np.concatenate([[0], m])   # window index 0 is m[j - 1], 0 at j = 0
        idx = pos[:, None] + np.arange(FULL_LEN_SAMPLES + 1)
        windows.append(padded[idx])
        buf_idx.append(np.full(pos.size, first + b))
        positions.append(pos)
    w = np.concatenate(windows).astype(np.int64)
    pos = np.concatenate(positions).astype(np.int64)
    orig = w[:, PREAMBLE_SAMPLES + 1 :]
    msg1, errors1 = _slice_bits(orig)
    gate1 = _gate(orig, msg1[:, 0].astype(np.int64) >> 3)
    if phase_correction and w.shape[0]:
        corr = np.where((pos > 0)[:, None], _phase_corrected(w), orig)
    else:
        corr = orig
    msg2, errors2 = _slice_bits(corr)
    gate2 = _gate(orig, msg2[:, 0].astype(np.int64) >> 3)
    return Candidates(np.concatenate(buf_idx).astype(np.int64), pos, msg1, errors1, gate1,
                      msg2, errors2, gate2)


def demodulate(bufs: np.ndarray, *, phase_correction: bool = True, chunk: int = 16,
               threads: int = 4) -> Candidates:
    """Every candidate of uint8 IQ buffers (B, 262,620) with both passes,
    in buffer and scan order.  `phase_correction=False` breaks one
    guarantee on purpose: the retry then slices the uncorrected samples
    again (the benchmark's control).  Buffers are taken `chunk` at a time
    on up to `threads` threads; the result does not depend on either."""
    bufs = np.atleast_2d(bufs)
    starts = list(range(0, bufs.shape[0], chunk))
    with ThreadPoolExecutor(max_workers=max(1, min(threads, len(starts)))) as pool:
        parts = list(pool.map(lambda s: _demodulate(bufs[s : s + chunk], s, phase_correction),
                              starts))
    return Candidates(*[np.concatenate([getattr(p, f) for p in parts])
                        for f in Candidates.__dataclass_fields__])


def splice(c: Candidates, first: Candidates) -> Candidates:
    """`c` with buffer 0's candidates replaced by those of `first` (a
    one-buffer demodulation)."""
    keep = c.buf != 0
    return Candidates(*[np.concatenate([getattr(first, f), getattr(c, f)[keep]])
                        for f in Candidates.__dataclass_fields__])
