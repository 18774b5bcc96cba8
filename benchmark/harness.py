"""What the runners share: the run record the metrics read, the verdict of
the output check, and small statistics."""

from __future__ import annotations

import gc
import time
from dataclasses import dataclass, field

import numpy as np


@dataclass
class Check:
    """One number compared, with its limit: the run is correct only if
    value <= limit for every check."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value <= self.limit


@dataclass
class Verdict:
    attempted: int
    failed: int
    checks: list = field(default_factory=list)
    notes: list = field(default_factory=list)   # what went wrong, for stderr

    @property
    def correct(self) -> bool:
        return all(c.ok for c in self.checks) and not self.notes


@dataclass
class Run:
    """A run's record.  `window_s` is the host-clock length of the timed
    call; `done` the work it completed (samples or buffers); runners add
    their own fields through `extra`; `trace` is the profiler slice's
    reduction (traced runs only)."""

    cell: object
    setup_s: float = 0.0
    window_s: float = 0.0
    trace: object = None
    memory_peak_bytes: int = 0
    extra: dict = field(default_factory=dict)

    def __getattr__(self, name):
        extra = self.__dict__.get("extra", {})
        if name in extra:
            return extra[name]
        raise AttributeError(name)


def percentile(values, q: float) -> float:
    """The q-th percentile (numpy's linear interpolation) of `values`."""
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


def group_nows(values, tags, n_groups: int, samples0: int) -> list:
    """The `now` each of the window's `n_groups` dispatch groups was
    resolved with: the pipeline reads its clock once a dispatch, and a
    group whose outputs overflowed their shapes is dispatched again (its
    last read counts), with every group enqueued after it.  `tags` holds,
    for each read, (samples taken in, groups delivered) at the read; a
    read that comes with more samples taken in dispatches a new group.
    Any other is a replay: of the group being finished (the one after
    those delivered), or, right after that group was delivered, of every
    group enqueued after it, in order.  Raises ValueError where the reads
    fit neither."""
    nows = [None] * n_groups
    fresh, level = 0, samples0
    i, replayed = 0, None   # replayed: the tag of the last replay of a finished group
    while i < len(values):
        s, d = tags[i]
        if s > level:
            if fresh >= n_groups:
                raise ValueError(f"more groups dispatched than the {n_groups} delivered")
            nows[fresh] = values[i]
            fresh, level, replayed = fresh + 1, s, None
            i += 1
            continue
        j = i
        while j < len(values) and tags[j] == (s, d):
            j += 1
        groups = []
        if replayed == (s, d - 1):
            groups = list(range(d, fresh))   # the groups enqueued after the one replayed
            if j - i < len(groups):
                raise ValueError(f"{j - i} reads replay the {len(groups)} groups after group {d - 1}")
        extra = j - i - len(groups)
        groups += [d] * extra                # the group being finished, replayed
        replayed = (s, d) if extra else None
        for g, r in zip(groups, range(i, j)):
            if g >= fresh:
                raise ValueError(f"a read replays group {g}, not yet dispatched")
            nows[g] = values[r]
        i = j
    if any(v is None for v in nows):
        raise ValueError(f"{sum(v is None for v in nows)} of {n_groups} groups read no clock")
    return nows


class GcMeter:
    """The cyclic collector's work between start() and stop(): the number
    of collections of each generation and the seconds they took, with the
    longest."""

    def __init__(self):
        self.count = [0, 0, 0]
        self.seconds = 0.0
        self.longest = 0.0
        self._t = None

    def _cb(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            d = time.perf_counter() - self._t
            self.count[info["generation"]] += 1
            self.seconds += d
            self.longest = max(self.longest, d)
            self._t = None

    def start(self) -> None:
        gc.callbacks.append(self._cb)

    def stop(self) -> None:
        if self._cb in gc.callbacks:
            gc.callbacks.remove(self._cb)

    def line(self) -> str:
        return (f"gc in the window: {self.count[0]}/{self.count[1]}/{self.count[2]} collections "
                f"(generations 0/1/2), {self.seconds:.4f} s, longest {self.longest:.4f} s")
