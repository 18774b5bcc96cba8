"""latency_p95_ms: the 95th percentile, over every buffer offered in the
window, of the time from when the buffer was due (its last sample in) to
when its marker message reached the hub."""


def read(run):
    v = getattr(run, "latency_p95_s", None)
    return None if v is None else v * 1e3
