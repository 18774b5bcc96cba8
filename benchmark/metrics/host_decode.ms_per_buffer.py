"""host_decode.ms_per_buffer: milliseconds a buffer of host field decode,
messages_from_device_arrays (the program's span pipeline.decode)."""

from benchmark import spans


def read(run):
    return spans.metric_per_buffer(run, ("pipeline.decode",), 1e3)
