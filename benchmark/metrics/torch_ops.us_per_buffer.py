"""torch_ops.us_per_buffer: device microseconds a buffer of every kernel
but K1 and K2 (the front, the passes, the precompute and the emission as
torch operations), copies and sets left out."""

from benchmark.layers import is_k1, is_k2


def read(run):
    t = run.trace
    if t is None or t.done <= 0:
        return None
    n, s = t.kernel_time(lambda name: not is_k1(name) and not is_k2(name))
    return s / t.done * 1e6 if n else None
