"""The yardstick of the roofline shares: the card's published peaks and
the bytes each hand-written kernel's call needs, computed from the call's
shapes and inputs.

Each input byte is counted once and each output byte once, whatever the
kernel reads again; where the work depends on the data, what these inputs
need is counted.  A share is the least time the card could take (bytes
over the peak bandwidth) over the kernel's measured time, so it cannot
pass 100% unless the count is too high or the time misses work.
"""

from __future__ import annotations

import numpy as np

# NVIDIA H100 SXM5 data sheet: 3.35 TB/s of HBM3 at the full 700 W limit
PEAK_BYTES_PER_S = {"NVIDIA H100 80GB HBM3": 3.35e12}
DEFAULT_PEAK_BYTES_PER_S = 3.35e12

K1_WINDOW = 256        # samples a window (csrc/gather_windows.cu's kWindow)
K1_LEAD = 1            # window index 0 is m[pos - 1]
ICAO_CACHE_LEN = 1024


def peak_bytes_per_s(kind: str) -> float:
    return PEAK_BYTES_PER_S.get(kind, DEFAULT_PEAK_BYTES_PER_S)


def k1_s_pad(s: int) -> int:
    """The clamp length of a window's start for rows of `s` samples (the
    TPU's padded row: one lead sample, 2,048 + 256 of tail, in 1,024s)."""
    return -(-(s + 1 + 2048 + K1_WINDOW) // 1024) * 1024


def k1_bytes(pos: np.ndarray, s: int) -> int:
    """Bytes one K1 call (gather_windows_kernel) moves for int32 magnitude
    rows (B, s) and int32 positions `pos` (B, MC), padded slots included:
    the union of the int32 samples its windows cover (each window the 256
    samples from clamp(pos, 0, s_pad - 256) - 1, inside the row), the
    positions in, and the uint16 windows (B, MC, 256) out."""
    pos = np.asarray(pos, dtype=np.int64)
    b, mc = pos.shape
    start = np.clip(pos, 0, k1_s_pad(s) - K1_WINDOW) - K1_LEAD
    lo = np.clip(start, 0, s)
    hi = np.clip(start + K1_WINDOW, 0, s)
    covered = 0
    for r in range(b):
        order = np.argsort(lo[r], kind="stable")
        l, h = lo[r][order], hi[r][order]
        reach = np.maximum.accumulate(h)
        # a window adds what lies past the furthest end before it
        prev = np.concatenate([[0], reach[:-1]])
        covered += int(np.clip(h - np.maximum(l, prev), 0, None).sum())
    return 4 * covered + 4 * b * mc + 2 * K1_WINDOW * b * mc


def k2_bytes(rows: int, mc: int) -> int:
    """Bytes one K2 call (resolve_words_kernel) moves over rows x mc
    candidate slots: four int32 candidate fields a slot (pf, w1, w2, h12)
    and one count a row in, one int32 decision word a slot out, and the
    ICAO cache (addresses and times, 1,024 int32 each) in and out."""
    slots = rows * mc
    return 16 * slots + 4 * rows + 4 * slots + 2 * 2 * 4 * ICAO_CACHE_LEN


def share_pct(bytes_: float, seconds: float, kind: str) -> float | None:
    """The roofline share in percent, or None where no time was measured."""
    if seconds <= 0:
        return None
    return 100.0 * bytes_ / peak_bytes_per_s(kind) / seconds
