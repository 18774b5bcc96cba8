"""ingest_wait.us_per_buffer: microseconds a buffer the main thread waited
for the reader thread's next group (the program's span
pipeline.ingest.wait)."""

from benchmark import spans


def read(run):
    return spans.metric_per_buffer(run, ("pipeline.ingest.wait",), 1e6)
