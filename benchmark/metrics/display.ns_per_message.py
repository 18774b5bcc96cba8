"""display.ns_per_message: nanoseconds a displayed message in the hub: from
the start of the program's span pipeline.emit (a batch's
MessageHub.use_message calls under the pipeline's lock) to the batch's end
as the runner took it, first thing when the lock was released and before
its own work there, over the messages the hub displayed in those batches
(its counter `displayed`, read at the same moment), over the groups
benchmark/spans.py reads.  Nothing on a program whose hub has no such
counter."""

import bisect

from benchmark import spans


def read(run):
    ends = getattr(run, "batch_ends", None)
    if not ends or any(d is None for _, d in ends):
        return None
    times = [t for t, _ in ends]
    total_ns, shown = 0, 0
    for ss in (spans.window(run) or {}).values():
        for s in ss:
            if s.name != "pipeline.emit":
                continue
            k = bisect.bisect_left(times, s.start_ns)
            if k < len(times) and times[k] <= s.end_ns:
                total_ns += times[k] - s.start_ns
                shown += ends[k][1] - (ends[k - 1][1] if k else 0)
    return total_ns / shown if shown else None
