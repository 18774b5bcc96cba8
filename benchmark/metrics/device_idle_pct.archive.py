"""device_idle_pct.archive: the share of the traced slice in which no
kernel, copy or set ran on the card, in the archive cells."""

from benchmark.layers import idle_pct as read  # noqa: F401
