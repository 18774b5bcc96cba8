"""hub_ms_per_buffer: milliseconds a buffer spent in the message hub
(MessageHub.use_message: tracker, CPR, display, SBS), timed by the harness
around each call, over the traced run's buffers before its profiler
slice."""


def read(run):
    hub_s, buffers = getattr(run, "hub_s", None), getattr(run, "hub_buffers", 0)
    if not hub_s or not buffers:
        return None
    return hub_s / buffers * 1e3
