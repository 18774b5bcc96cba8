"""The traced run's device trace: torch.profiler over a bounded slice of
the measured window, reduced to what the per-layer metrics read.

The runner calls Tracer.tick() from its main loop; the profiler (CPU and
CUDA activities) starts `start_s` into the window and stops `length_s`
later, so the trace stays small and its cost falls on a known slice; the
trace is read back only once the window has closed.  Two
annotations mark the slice's ends in the trace's own clock.  The trace is
exported as a Chrome trace into a temporary directory, read back and
reduced: device busy time (the union of kernel, copy and set intervals
inside the slice), kernel time and count by name, and the idle gaps
labelled by the host activity that overlapped them most.
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from collections import defaultdict
from dataclasses import dataclass, field

import numpy as np

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("user_annotation", "cpu_op", "cuda_runtime", "cuda_driver")
START, END = "bench.slice_start", "bench.slice_end"


@dataclass
class Trace:
    """The reduced slice: seconds are device-clock spans as the profiler
    recorded them; `progress` is the runner's count of buffers (or samples)
    at the slice's two ends."""

    window_s: float
    busy_s: float
    kernels: dict = field(default_factory=dict)     # name -> (count, seconds)
    device_ops: list = field(default_factory=list)  # [(name, seconds)], top 10
    idle_gaps: list = field(default_factory=list)   # [(host activity, seconds)], top 10
    progress: tuple = (0, 0)

    @property
    def done(self) -> float:
        return self.progress[1] - self.progress[0]

    def kernel_time(self, match) -> tuple[int, float]:
        """(launches, seconds) of the kernels whose name `match` accepts."""
        n, s = 0, 0.0
        for name, (c, t) in self.kernels.items():
            if match(name):
                n, s = n + c, s + t
        return n, s


class Tracer:
    """A profiler slice of the window; inert when not enabled."""

    def __init__(self, enabled: bool, device: str, *, start_s: float, length_s: float):
        self.enabled = enabled
        self.cuda = device == "cuda"
        self.start_s, self.length_s = start_s, length_s
        self._prof = None
        self._t0 = None
        self._progress = [0, 0]
        self._state = "idle"
        self.trace: Trace | None = None

    def _profile(self):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.cuda else [])
        return profile(activities=acts)

    def warm(self) -> None:
        """Start and stop the profiler once, in set-up: its first start
        (CUPTI's) is slow and must not fall into the window."""
        if not self.enabled:
            return
        import torch

        with self._profile():
            x = torch.zeros(8, device="cuda" if self.cuda else "cpu")
            x.add_(1)
            if self.cuda:
                torch.cuda.synchronize()

    def begin(self, t0: float) -> None:
        self._t0 = t0

    def tick(self, progress) -> None:
        """Start or stop the slice when its time has come; `progress()`
        gives the runner's count of work done."""
        if not self.enabled or self._state == "done" or self._t0 is None:
            return
        now = time.perf_counter() - self._t0
        if self._state == "idle" and now >= self.start_s:
            from torch.profiler import record_function

            self._prof = self._profile()
            self._prof.start()
            with record_function(START):
                self._progress[0] = progress()
            self._state = "on"
        elif self._state == "on" and now >= self.start_s + self.length_s:
            self.stop(progress)

    def stop(self, progress) -> None:
        """End the slice now if it is running (the window closed first).
        The trace is read back later, in finish(), outside the window."""
        if self._state != "on":
            return
        from torch.profiler import record_function

        with record_function(END):
            self._progress[1] = progress()
        self._prof.stop()
        self._state = "done"

    @property
    def started_at(self) -> float | None:
        """perf_counter() time the slice began at, or None."""
        return None if self._t0 is None or self._state == "idle" else self._t0 + self.start_s

    def finish(self) -> None:
        """Export the slice's trace and reduce it (after the window)."""
        if self._prof is None:
            return
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f).get("traceEvents", [])
        self._prof = None
        self.trace = reduce_events(events, tuple(self._progress))


def _short(name: str, limit: int = 160) -> str:
    """A kernel's name without its template arguments' tail, for the
    breakdown (C++ kernel names run to thousands of characters)."""
    return name if len(name) <= limit else name[: limit - 3] + "..."


def _merge(iv: np.ndarray) -> np.ndarray:
    """Union of [start, end) intervals (n, 2), sorted and disjoint."""
    if iv.size == 0:
        return iv.reshape(0, 2)
    iv = iv[np.argsort(iv[:, 0])]
    out = [list(iv[0])]
    for s, e in iv[1:]:
        if s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return np.array(out)


def reduce_events(events: list, progress: tuple) -> Trace:
    """Chrome-trace events -> Trace over the slice between the two
    annotations (microseconds in, seconds out)."""
    marks = {e["name"]: e for e in events if e.get("name") in (START, END) and "ts" in e}
    if START not in marks or END not in marks:
        raise RuntimeError("the trace lacks the slice's annotations")
    w0 = float(marks[START]["ts"])
    w1 = float(marks[END]["ts"]) + float(marks[END].get("dur", 0.0))
    dev, by_name, counts = [], defaultdict(float), defaultdict(int)
    kernels = {}
    for e in events:
        if e.get("cat") not in DEVICE_CATS or "dur" not in e:
            continue
        s, d = float(e["ts"]), float(e["dur"])
        lo, hi = max(s, w0), min(s + d, w1)
        if hi <= lo:
            continue
        dev.append((lo, hi))
        by_name[e["name"]] += (hi - lo) / 1e6
        counts[e["name"]] += 1
        if e["cat"] == "kernel":
            kernels[e["name"]] = (counts[e["name"]], by_name[e["name"]])
    busy = _merge(np.array(dev, dtype=np.float64).reshape(-1, 2))
    busy_s = float((busy[:, 1] - busy[:, 0]).sum()) / 1e6 if busy.size else 0.0
    ops = [(_short(k), v) for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]]
    return Trace(window_s=(w1 - w0) / 1e6, busy_s=busy_s, kernels=kernels,
                 device_ops=[[k, v] for k, v in ops],
                 idle_gaps=_idle_gaps(events, busy, w0, w1), progress=progress)


def _idle_gaps(events: list, busy: np.ndarray, w0: float, w1: float, label_top: int = 200):
    """The slice's idle time, summed by the host activity that overlapped
    each gap most (the `label_top` longest gaps are labelled, the rest
    summed as 'shorter gaps')."""
    edges = np.concatenate([[w0], busy.reshape(-1), [w1]]).reshape(-1, 2)
    gaps = edges[edges[:, 1] > edges[:, 0]]
    if gaps.size == 0:
        return []
    host = [e for e in events if e.get("cat") in HOST_CATS and "dur" in e
            and e.get("name") not in (START, END)]
    hs = np.array([float(e["ts"]) for e in host])
    he = hs + np.array([float(e["dur"]) for e in host])
    names = [e["name"] for e in host]
    order = np.argsort(gaps[:, 0] - gaps[:, 1])
    sums = defaultdict(float)
    for i in order[:label_top]:
        g0, g1 = gaps[i]
        label = "no profiled host activity"
        if len(names):
            ov = np.minimum(he, g1) - np.maximum(hs, g0)
            k = int(np.argmax(ov))
            if ov[k] > 0:
                label = names[k]
        sums[label] += (g1 - g0) / 1e6
    rest = order[label_top:]
    if rest.size:
        sums["shorter gaps"] += float((gaps[rest, 1] - gaps[rest, 0]).sum()) / 1e6
    return [[k, v] for k, v in sorted(sums.items(), key=lambda kv: -kv[1])[:10]]
