"""Spans of the device pipeline: one in-memory recorder a process.

A span is one stretch of host work on models/pipeline.py's device path,
taken once a dispatch group or once a batch, never per message or per
kernel: its name, the sequence number of the dispatch group it belongs to
(every span of a group carries it), the batch within the group (or -1),
the thread, its start and end on time.perf_counter_ns(), one count (the
buffers of a group, the messages of a batch), whether a torch.profiler
was recording at its start or its end, and, for the zero-length marks of
a replay or a shape change, the shapes (candidate slots a buffer, short,
long and message rows a batch).  Spans of one thread nest or follow each
other; a span ends before the span that encloses it.

Spans go into a bounded ring of CAPACITY, about 17 MB when full (some
eight minutes of a live receiver); once it is full the oldest are dropped
and counted in `dropped`, which the benchmark's readers check, so that a
window whose first spans are gone is not read.

While a torch.profiler records, each span also runs inside
torch.profiler.record_function, so it shows in the profiler's Chrome trace
as a user_annotation of the same name (a mark's name followed by its
shapes) on the profiler's own clock, beside the kernels and copies.  The
profiler records annotations made on the thread that started it (on every
thread with its experimental profile_all_threads); the ring holds them
all.  When no profiler records, nothing calls record_function, and a span
costs two clock reads and an append to the ring.
"""

from __future__ import annotations

import collections
import itertools
import threading
import time
from typing import NamedTuple

from torch.autograd import profiler as _autograd_profiler
from torch.profiler import record_function

CAPACITY = 65536


class Span(NamedTuple):
    name: str
    group: int
    batch: int
    thread: int           # threading.get_ident() of the recording thread
    start_ns: int
    end_ns: int
    count: int
    profiled: bool
    shapes: tuple = ()


def profiling() -> bool:
    """Whether a torch.profiler records now, on any thread: the profiler's
    own process-wide flag (torch's private fast check)."""
    return _autograd_profiler._is_profiler_enabled


def label(name: str, shapes: tuple) -> str:
    """The name of a span's profiler annotation: its name, and a mark's
    shapes."""
    if not shapes:
        return name
    mc, mos, mol, mo = shapes
    return f"{name} mc={mc} mos={mos} mol={mol} mo={mo}"


class _Open:
    """A span being recorded: `with recorder.span(...) as s:`; `group`
    and `count` may be set inside."""

    __slots__ = ("rec", "name", "group", "batch", "count", "start_ns", "profiled", "mirror")

    def __init__(self, rec: Recorder, name: str, group: int, batch: int, count: int):
        self.rec, self.name, self.group, self.batch, self.count = rec, name, group, batch, count

    def __enter__(self) -> _Open:
        self.profiled = profiling()
        self.mirror = None
        if self.profiled:
            self.mirror = record_function(self.name)
            self.mirror.__enter__()
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        end = time.perf_counter_ns()
        if self.mirror is not None:
            self.mirror.__exit__(*exc)
        self.rec._add(Span(self.name, self.group, self.batch, threading.get_ident(),
                           self.start_ns, end, self.count, self.profiled or profiling()))
        return False


class Recorder:
    """A bounded ring of spans, with the sequence of dispatch group ids."""

    def __init__(self, capacity: int = CAPACITY):
        self.dropped = 0
        self._ring: collections.deque = collections.deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._groups = itertools.count()

    def _add(self, span: Span) -> None:
        with self._lock:
            if len(self._ring) == self._ring.maxlen:
                self.dropped += 1
            self._ring.append(span)

    def next_group(self) -> int:
        """The next dispatch group's sequence number."""
        return next(self._groups)

    def span(self, name: str, group: int = -1, batch: int = -1, count: int = 0) -> _Open:
        """A context manager that records the span of its body."""
        return _Open(self, name, group, batch, count)

    def mark(self, name: str, group: int = -1, shapes: tuple = ()) -> None:
        """Record a zero-length span (an event) now."""
        on = profiling()
        if on:
            with record_function(label(name, shapes)):
                pass
        now = time.perf_counter_ns()
        self._add(Span(name, group, -1, threading.get_ident(), now, now, 0, on, tuple(shapes)))

    def spans(self) -> list[Span]:
        """The spans in the ring, oldest first."""
        with self._lock:
            return list(self._ring)

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self.dropped = 0


RECORDER = Recorder()


def span(name: str, group: int = -1, batch: int = -1, count: int = 0) -> _Open:
    return RECORDER.span(name, group, batch, count)


def mark(name: str, group: int = -1, shapes: tuple = ()) -> None:
    RECORDER.mark(name, group, shapes)


def next_group() -> int:
    return RECORDER.next_group()
