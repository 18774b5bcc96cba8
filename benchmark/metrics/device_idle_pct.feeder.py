"""device_idle_pct.feeder: the share of the traced slice in which no
kernel, copy or set ran on the card, in the feeder cells."""

from benchmark.layers import idle_pct as read  # noqa: F401
