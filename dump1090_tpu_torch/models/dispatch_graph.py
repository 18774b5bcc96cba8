"""One CUDA graph a dispatch shape: the device path's whole dispatch of a
group (the front, K1, K4, both precomputes, K2, the emission and the
stats), captured once into a torch.cuda.CUDAGraph and replayed.

An eager dispatch issues some 550 launches from Python; a replay issues
one.  The graph holds the same kernels on the same inputs, so a replay's
results are the eager dispatch's, bit for bit.

A graph is keyed on everything that changes the captured work
(DispatchKey): the group's shape and dtype, the working shapes
(models/shapes.py Shapes.key), the emission format, the front, the decoder
flags and the device.  Per key, DispatchGraphs.run:

  * runs the first dispatch eagerly.  That builds what the dispatch reads
    and a capture cannot build (the fix table, the CRC matrices, the
    iotas, the popcount table, the cuBLAS handle), and a one-off shape (an
    EOF tail group, a replay at shapes that just grew) costs no capture;
  * captures at the second, then replays;
  * replays every later one.
It keeps at most CAPACITY graphs, dropping the least recently used with
its memory pool; a dropped key is captured again at its next dispatch.

Before each replay the group's IQ, the cache state and `now` are copied
into the graph's own tensors, on the dispatch stream.  A replay overwrites
the outputs of the one before: nothing may read them after the graph's
next replay is enqueued.  The pipeline's fetch copies are enqueued right
behind the replay on the same stream, and the cache state, which the next
group starts from and a replay after an overflow starts again from, is
cloned out here.

A capture runs on a side stream with capture_error_mode "thread_local",
so that the reader thread's uploads, on the dispatch stream, may go on
meanwhile.
"""

from __future__ import annotations

import collections
import contextlib
from typing import Callable, NamedTuple

import torch

from ..ops import _cuda
from ..utils import spans

CAPACITY = 4     # graphs kept a pipeline


class DispatchKey(NamedTuple):
    """What a dispatch's captured work depends on."""

    shape: tuple
    dtype: torch.dtype
    shapes: tuple           # Shapes.key: (mc, mos, mol, mo)
    packed: bool
    crcok_only: bool
    front: str
    fix_errors: bool
    aggressive: bool
    device: torch.device


def dispatch_key(xg: torch.Tensor, shapes: tuple, *, packed: bool, crcok_only: bool,
                 front: str, fix_errors: bool, aggressive: bool) -> DispatchKey:
    return DispatchKey(tuple(xg.shape), xg.dtype, tuple(shapes), bool(packed),
                       bool(crcok_only), front, bool(fix_errors), bool(aggressive), xg.device)


class Graph:
    """One dispatch shape's captured work: its static inputs (IQ, cache
    state, `now`), its graph, its static outputs, and the hand-written
    kernels' launches that one replay makes."""

    def __init__(self, fn: Callable, xg: torch.Tensor, cache_addr: torch.Tensor,
                 cache_ts: torch.Tensor):
        self.xg = torch.zeros_like(xg)
        self.addr = torch.zeros_like(cache_addr)
        self.ts = torch.zeros_like(cache_ts)
        self.now = torch.zeros(1, dtype=torch.int32, device=xg.device)
        # a capture launches nothing: its launches, tallied apart from other
        # threads' counts, are what each replay adds
        with _cuda.tally() as self.launches:
            self.outs = self._capture(fn)

    def _capture(self, fn: Callable) -> tuple:
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(torch.cuda.Stream(self.xg.device)):
            self.graph.capture_begin(capture_error_mode="thread_local")
            try:
                outs = fn(self.xg, self.addr, self.ts, self.now)
            except BaseException:
                # end the capture, so the stream is left capturing nothing;
                # the first error is the one raised
                with contextlib.suppress(RuntimeError):
                    self.graph.capture_end()
                raise
            self.graph.capture_end()
        return tuple(outs)

    def _launch(self) -> None:
        self.graph.replay()

    def replay(self, xg: torch.Tensor, cache_addr: torch.Tensor, cache_ts: torch.Tensor,
               now: int) -> tuple:
        """Copy the inputs in and replay, on the current stream; returns the
        static outputs."""
        self.xg.copy_(xg)
        self.addr.copy_(cache_addr)
        self.ts.copy_(cache_ts)
        self.now.fill_(now)
        self._launch()
        _cuda.add(self.launches)
        return self.outs


class DispatchGraphs:
    """The graphs of one pipeline's dispatch shapes (see the module's doc).
    `graph` builds a Graph; the tests stub it."""

    def __init__(self, graph: type = Graph):
        self._graph = graph
        self._graphs: collections.OrderedDict[DispatchKey, Graph] = collections.OrderedDict()
        self._seen: set[DispatchKey] = set()   # keys dispatched eagerly once

    def run(self, key: DispatchKey, fn: Callable, xg: torch.Tensor, cache_addr: torch.Tensor,
            cache_ts: torch.Tensor, now: int, group: int = -1) -> tuple:
        """One dispatch of `fn(xg, cache_addr, cache_ts, now)`, whose outputs
        end with the cache state after it: eager at the key's first sight,
        else replayed from its graph (captured first at the second), marked
        on `group`.  A replay's cache state is returned as clones."""
        g = self._graphs.get(key)
        if g is None:
            if key not in self._seen:
                self._seen.add(key)
                return tuple(fn(xg, cache_addr, cache_ts, now))
            g = self._graph(fn, xg, cache_addr, cache_ts)
            self._graphs[key] = g
            if len(self._graphs) > CAPACITY:
                self._graphs.popitem(last=False)
            spans.mark(spans.GRAPH_CAPTURE, group, key.shapes)
        else:
            self._graphs.move_to_end(key)
        outs = g.replay(xg, cache_addr, cache_ts, now)
        spans.mark(spans.GRAPH_REPLAY, group)
        return (*outs[:-2], outs[-2].clone(), outs[-1].clone())
