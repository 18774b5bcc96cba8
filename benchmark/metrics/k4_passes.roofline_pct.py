"""k4_passes.roofline_pct: K4's (csrc/candidate_passes.cu) share of its
roofline: the bytes its calls in the traced slice need over their device
time, against the card's peak bandwidth.

One call computes both demod passes of every slot of a dispatch group,
valid or not: rows x mc candidates (benchmark.layers.k2_call), each of
which reads the 232 window samples the passes use (w[0], w[1], w[3], w[4],
w[7], w[8], w[10], w[11] and w[17:241], uint16) and its int32 position, and
writes its six outputs (two passes of 14 message bytes, an int32 error
count and a one-byte gate).  A program without K4 has no such kernel, and
the metric reads nothing there."""

from benchmark.layers import k2_call
from benchmark.roofline import share_pct

BYTES_PER_CANDIDATE = 232 * 2 + 4 + 2 * (14 + 4 + 1)   # 506


def is_k4(name: str) -> bool:
    return "candidate_passes_kernel" in name


def call_bytes(rows: int, mc: int) -> int:
    """Bytes one K4 call over rows x mc candidate slots needs."""
    return rows * mc * BYTES_PER_CANDIDATE


def read(run):
    t = run.trace
    if t is None:
        return None
    n, s = t.kernel_time(is_k4)
    if not n:
        return None
    return share_pct(n * call_bytes(*k2_call(run)), s, run.device_kind)
