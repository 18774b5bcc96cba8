"""host_issue.ms_per_buffer.feeder: milliseconds a buffer of host issue,
the group's enqueue and its fetch's copies and event, replays included
(the program's span pipeline.issue)."""

from benchmark import spans


def read(run):
    return spans.metric_per_buffer(run, (spans.ISSUE,), 1e3)
