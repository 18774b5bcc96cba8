"""emit.ms_per_buffer: milliseconds a buffer in the pipeline's emit loop,
the hub's calls under the pipeline's lock (the program's span
pipeline.emit; hub_ms_per_buffer is the harness's clock around the same
calls)."""

from benchmark import spans


def read(run):
    return spans.metric_per_buffer(run, ("pipeline.emit",), 1e3)
