"""k2_resolve.roofline_pct: K2's (csrc/resolve_words.cu) share of its
roofline: the candidate fields in and the decision words out of its calls
in the traced slice (benchmark/roofline.py's k2_bytes) over their device
time, against the card's peak bandwidth."""

from benchmark.layers import is_k2, k2_call
from benchmark.roofline import k2_bytes, share_pct


def read(run):
    t = run.trace
    if t is None:
        return None
    n, s = t.kernel_time(is_k2)
    if not n:
        return None
    rows, mc = k2_call(run)
    return share_pct(n * k2_bytes(rows, mc), s, run.device_kind)
