"""host_format.us_per_buffer: microseconds a buffer of host format, the
packed rows re-interleaved and written as `*<hex>;` lines (the program's
span pipeline.format)."""

from benchmark import spans


def read(run):
    return spans.metric_per_buffer(run, ("pipeline.format",), 1e6)
