"""k1_gather.roofline_pct: K1's (csrc/gather_windows.cu) share of its
roofline: the bytes its calls in the traced slice need (benchmark/
roofline.py's k1_bytes, from the group's shapes and the air's candidate
positions) over their device time, against the card's peak bandwidth."""

from benchmark.layers import is_k1, k1_call_bytes
from benchmark.roofline import share_pct


def read(run):
    t = run.trace
    if t is None:
        return None
    n, s = t.kernel_time(is_k1)
    if not n:
        return None
    return share_pct(n * k1_call_bytes(run), s, run.device_kind)
