"""k2_resolve.ns_per_slot: K2's device nanoseconds per candidate slot
(buffers x the candidate slots the pipeline dispatched): its walk is a
chain of dependent steps, so this is the informative number."""

from benchmark.layers import is_k2, k2_call


def read(run):
    t = run.trace
    if t is None:
        return None
    n, s = t.kernel_time(is_k2)
    if not n:
        return None
    rows, mc = k2_call(run)
    return s / (n * rows * mc) * 1e9
