"""ingest_lag_p95_ms: the 95th percentile, over the window's buffers, of
the time from when a buffer was due to when the pipeline's ingest took it
from the feed (in a traced run, the buffers before its profiler slice)."""

from benchmark.harness import percentile


def read(run):
    lag = getattr(run, "ingest_lag_s", None)
    if lag is None or not len(lag):
        return None
    return percentile(lag, 95) * 1e3
