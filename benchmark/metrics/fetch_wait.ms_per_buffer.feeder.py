"""fetch_wait.ms_per_buffer.feeder: milliseconds a buffer the main thread
waited on a group's fetch event (the program's span pipeline.fetch.wait)."""

from benchmark import spans


def read(run):
    return spans.metric_per_buffer(run, (spans.FETCH_WAIT,), 1e3)
