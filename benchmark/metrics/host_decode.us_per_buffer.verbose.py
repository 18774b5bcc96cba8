"""host_decode.us_per_buffer.verbose: microseconds a buffer of host field
decode, messages_from_device_arrays over every attempted message of a
batch (the program's span pipeline.decode), in the verbose archive decode."""

from benchmark import spans


def read(run):
    return spans.metric_per_buffer(run, ("pipeline.decode",), 1e6)
