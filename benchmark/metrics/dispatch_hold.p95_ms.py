"""dispatch_hold.p95_ms: the 95th percentile over the window's groups of
the time from the end of a group's last issue to the start of its fetch
wait (the program's spans pipeline.issue and pipeline.fetch.wait of one
group): the group's hold behind the dispatch depth."""

from benchmark import spans


def read(run):
    return spans.hold_p95_ms(run)
