"""launches_per_buffer.archive: kernels the card ran in the traced slice
over the buffers the pipeline took in it (host issue)."""

from benchmark.layers import launches_per_buffer as read  # noqa: F401
