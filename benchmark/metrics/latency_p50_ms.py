"""latency_p50_ms: the median of the same buffer latencies as
latency_p95_ms."""


def read(run):
    v = getattr(run, "latency_p50_s", None)
    return None if v is None else v * 1e3
