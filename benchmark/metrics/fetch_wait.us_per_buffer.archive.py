"""fetch_wait.us_per_buffer.archive: microseconds a buffer the main thread
waited on a group's fetch event (the program's span pipeline.fetch.wait)."""

from benchmark import spans


def read(run):
    return spans.metric_per_buffer(run, (spans.FETCH_WAIT,), 1e6)
