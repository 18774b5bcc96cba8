"""The program's own spans (dump1090_tpu_torch/utils/spans.py), read after
the window for the per-layer metrics of the host layers.  With program.py,
the only module of the benchmark that imports the port, and only its span
recorder; a program without one reads nothing.

The spans read are those that started in the window (start_ns >= run.t0)
of the dispatch groups that were issued and whose spans all ended before
the first span recorded while the profiler ran: the profiler slows the
host, and its stop holds the feeder for seconds (hub_ms_per_buffer makes
the same cut).  "Per buffer" is the summed span time of the groups read
over their buffers (the count of each group's first issue span).

The ring drops its oldest spans once full, and a span enters it as it
ends, so the spans dropped ended before any the ring holds.  Where it has
dropped some and every span it holds ended at or after t0, spans of the
window may be gone (a group's ingest, with its issue left), and the
window is not read at all.
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np

ISSUE = "pipeline.issue"
FETCH_WAIT = "pipeline.fetch.wait"
INGEST = ("pipeline.ingest.source", "pipeline.ingest.stack", "pipeline.ingest.upload")


def recorded():
    """The process's spans, oldest first, and how many the ring dropped, or
    None where the program has no recorder."""
    try:
        from dump1090_tpu_torch.utils import spans
    except ImportError:
        return None
    got = spans.RECORDER.spans()
    # read after the spans: a drop meanwhile errs toward reading nothing
    return got, spans.RECORDER.dropped


def groups(spans, t0_ns: int) -> dict:
    """group id -> its spans, for the groups read (see the module's doc)."""
    inside = [s for s in spans if s.start_ns >= t0_ns]
    profiled = [s.start_ns for s in inside if s.profiled]
    cut = min(profiled) if profiled else None
    by_group = defaultdict(list)
    for s in inside:
        if s.group >= 0:
            by_group[s.group].append(s)
    return {g: ss for g, ss in by_group.items()
            if any(s.name == ISSUE for s in ss)
            and (cut is None or all(s.end_ns < cut for s in ss))}


def window(run) -> dict | None:
    """The groups read of `run`'s window, or None (no window, no recorder,
    or spans of the window dropped)."""
    t0 = getattr(run, "t0", None)
    got = recorded()
    if t0 is None or got is None:
        return None
    spans, dropped = got
    t0_ns = int(t0 * 1e9)
    if dropped and spans and min(s.end_ns for s in spans) >= t0_ns:
        return None
    return groups(spans, t0_ns)


def buffers(group_spans) -> int:
    return next(s.count for s in sorted(group_spans, key=lambda s: s.start_ns) if s.name == ISSUE)


def per_buffer(read_groups, names, *, reader_thread: bool = False):
    """Seconds a buffer in the spans named `names` (only those off the
    thread that issued the group, with `reader_thread`), or None where no
    such span was read."""
    if not read_groups:
        return None
    total, n, found = 0, 0, False
    for ss in read_groups.values():
        main = next(s.thread for s in ss if s.name == ISSUE)
        for s in ss:
            if s.name in names and not (reader_thread and s.thread == main):
                total += s.end_ns - s.start_ns
                found = True
        n += buffers(ss)
    if not found or n == 0:
        return None
    return total / n / 1e9


def holds(read_groups) -> list:
    """Each group's hold in seconds: from the end of its last issue to the
    start of the first fetch wait after it."""
    out = []
    for ss in read_groups.values():
        issued = max(s.end_ns for s in ss if s.name == ISSUE)
        waits = [s.start_ns for s in ss if s.name == FETCH_WAIT and s.start_ns >= issued]
        if waits:
            out.append((min(waits) - issued) / 1e9)
    return out


def metric_per_buffer(run, names, scale: float, *, reader_thread: bool = False):
    """per_buffer over `run`'s window, times `scale` (1e6: us, 1e3: ms)."""
    v = per_buffer(window(run), names, reader_thread=reader_thread)
    return None if v is None else v * scale


def hold_p95_ms(run):
    h = holds(window(run) or {})
    return float(np.percentile(h, 95)) * 1e3 if h else None
