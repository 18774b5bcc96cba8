"""launches_per_buffer.feeder: kernels the card ran in the traced slice
over the buffers the feed handed over in it (host issue)."""

from benchmark.layers import launches_per_buffer as read  # noqa: F401
