"""The device path's graph cache (models/dispatch_graph.py) on the CPU, with
the CUDA graph stubbed: its key, when it runs eagerly, captures and
replays, its bound, its copies in and out, its launch counts and its
marks; the pipeline's device paths through it; and resolve_words' two
forms of `now`."""

import io

import numpy as np
import pytest
import torch

from dump1090_tpu_torch.models import dispatch_graph as dg
from dump1090_tpu_torch.models.dispatch_graph import (DispatchGraphs, DispatchKey, Graph,
                                                       dispatch_key)
from dump1090_tpu_torch.ops import _cuda
from dump1090_tpu_torch.utils import spans

NOW = 1_700_000_000
KERNELS = ("gather_windows", "candidate_passes", "resolve_words")


class FakeGraph(Graph):
    """A graph on the CPU: the capture keeps the dispatch, a replay runs it
    on the static inputs and writes its results into the static outputs,
    as a replayed graph writes into the memory it captured."""

    def _capture(self, fn):
        self.fn, self.replays = fn, 0
        return tuple(fn(self.xg, self.addr, self.ts, self.now))

    def _launch(self):
        with _cuda.tally():   # Graph.replay counts the replay's kernels
            for out, new in zip(self.outs, self.fn(self.xg, self.addr, self.ts, self.now)):
                out.copy_(new)
        self.replays += 1


def stub(calls: list):
    """A dispatch on small tensors that launches one of each kernel and
    records the form of `now` it was given; its outputs are a function of
    every input, the cache state last."""

    def fn(xg, addr, ts, now):
        calls.append(type(now))
        for k in KERNELS:
            _cuda.count(k)
        t = now if isinstance(now, torch.Tensor) else torch.tensor([now], dtype=torch.int32)
        total = xg.to(torch.int32).sum().reshape(1)
        return total, total + t, addr + total, torch.maximum(ts, t)

    return fn


def inputs(seed: int, shape=(1, 1, 16)):
    g = torch.Generator().manual_seed(seed)
    xg = torch.randint(0, 256, shape, dtype=torch.uint8, generator=g)
    addr = torch.randint(0, 1 << 24, (1024,), dtype=torch.int32, generator=g)
    ts = torch.randint(NOW - 100, NOW, (1024,), dtype=torch.int32, generator=g)
    return xg, addr, ts


def key_of(xg, **kw):
    args = dict(packed=True, crcok_only=True, front="mask", fix_errors=True, aggressive=False)
    args.update(kw)
    return dispatch_key(xg, (256, 4096, 5461, 4096), **args)


@pytest.fixture
def marks():
    spans.RECORDER.clear()

    def names():
        return [(s.name, s.group) for s in spans.RECORDER.spans()]

    yield names
    spans.RECORDER.clear()


def test_first_sight_eager_second_captures_later_replays(marks):
    calls = []
    graphs, fn = DispatchGraphs(graph=FakeGraph), stub(calls)
    xg, addr, ts = inputs(0)
    key = key_of(xg)
    for k in range(5):
        x, a, t = inputs(k)
        got = graphs.run(key, fn, x, a, t, NOW + k, group=k)
        want = stub([])(x, a, t, NOW + k)
        assert all(torch.equal(g, w) for g, w in zip(got, want)), k
    # eager with the int, then the capture's one call with the static
    # tensor; the replays run the stub from the fake graph only
    assert calls[:2] == [int, torch.Tensor]
    assert graphs._graphs[key].replays == 4
    assert marks() == [(spans.GRAPH_CAPTURE, 1)] + [(spans.GRAPH_REPLAY, k) for k in range(1, 5)]


@pytest.mark.parametrize("field, change", [
    ("shape", dict(xg=torch.zeros((2, 1, 16), dtype=torch.uint8))),
    ("dtype", dict(xg=torch.zeros((1, 1, 16), dtype=torch.uint16))),
    ("shapes", dict(shapes=(64, 2048, 2048, 4096))),
    ("packed", dict(packed=False)),
    ("crcok_only", dict(crcok_only=False)),
    ("front", dict(front="packed")),
    ("fix_errors", dict(fix_errors=False)),
    ("aggressive", dict(aggressive=True)),
    ("device", dict(xg=torch.zeros((1, 1, 16), dtype=torch.uint8, device="meta"))),
])
def test_a_change_of_any_key_field_misses(field, change):
    base_x = torch.zeros((1, 1, 16), dtype=torch.uint8)
    base = key_of(base_x)
    xg = change.pop("xg", base_x)
    shapes = change.pop("shapes", base.shapes)
    args = dict(packed=True, crcok_only=True, front="mask", fix_errors=True, aggressive=False)
    args.update(change)
    other = dispatch_key(xg, shapes, **args)
    assert other != base
    assert [f for f in DispatchKey._fields if getattr(other, f) != getattr(base, f)] == [field]
    # the graph of the base key does not serve the other: it runs eagerly
    calls = []
    graphs, fn = DispatchGraphs(graph=FakeGraph), stub(calls)
    x, a, t = inputs(1)
    for _ in range(3):
        graphs.run(base, fn, x, a, t, NOW)
    calls.clear()
    graphs.run(other, fn, x, a, t, NOW)
    assert calls == [int] and other not in graphs._graphs and base in graphs._graphs


def test_least_recently_used_graph_goes_first(marks, monkeypatch):
    monkeypatch.setattr(dg, "CAPACITY", 2)
    graphs, fn = DispatchGraphs(graph=FakeGraph), stub([])
    x, a, t = inputs(2)
    keys = [key_of(x, front=f) for f in ("mask", "packed", "packed-mxu")]

    def twice(key):
        graphs.run(key, fn, x, a, t, NOW)
        graphs.run(key, fn, x, a, t, NOW)

    twice(keys[0])
    twice(keys[1])
    graphs.run(keys[0], fn, x, a, t, NOW)      # keys[0] used last: keys[1] goes
    twice(keys[2])
    assert list(graphs._graphs) == [keys[0], keys[2]]
    # a dropped key was dispatched eagerly before: its next dispatch
    # captures it again and replays
    calls = []
    graphs.run(keys[1], stub(calls), x, a, t, NOW)
    assert calls == [torch.Tensor, torch.Tensor]
    assert list(graphs._graphs) == [keys[2], keys[1]]


def test_the_cache_state_is_cloned_and_never_aliased():
    graphs, fn = DispatchGraphs(graph=FakeGraph), stub([])
    x0, a0, t0 = inputs(3)
    key = key_of(x0)
    graphs.run(key, fn, x0, a0, t0, NOW)
    records = []
    for k in range(3):
        x, a, t = inputs(10 + k)
        got = graphs.run(key, fn, x, a, t, NOW + 61 * k)
        records.append((got, [o.clone() for o in got]))
    static = graphs._graphs[key].outs
    ptrs = {o.data_ptr() for o in static}
    for got, kept in records:
        # the record's cache state is its own and still holds its values
        # after later replays; the rest are the graph's static outputs
        assert got[-2].data_ptr() not in ptrs and got[-1].data_ptr() not in ptrs
        assert torch.equal(got[-2], kept[-2]) and torch.equal(got[-1], kept[-1])
        assert got[0] is static[0] and got[1] is static[1]
    states = [p for got, _ in records for p in (got[-2].data_ptr(), got[-1].data_ptr())]
    assert len(set(states)) == len(states)


def test_the_inputs_are_copied_into_the_graphs_own(marks):
    graphs, fn = DispatchGraphs(graph=FakeGraph), stub([])
    x, a, t = inputs(4)
    key = key_of(x)
    graphs.run(key, fn, x, a, t, NOW)
    graphs.run(key, fn, x, a, t, NOW + 7)
    g = graphs._graphs[key]
    assert torch.equal(g.xg, x) and torch.equal(g.addr, a) and torch.equal(g.ts, t)
    assert g.now.tolist() == [NOW + 7]
    assert g.xg.data_ptr() != x.data_ptr() and g.addr.data_ptr() != a.data_ptr()


def test_replays_advance_the_launch_counts_by_the_captured_ones():
    graphs, fn = DispatchGraphs(graph=FakeGraph), stub([])
    x, a, t = inputs(5)
    key = key_of(x)
    _cuda.reset_launches()
    seen = []
    for k in range(4):
        graphs.run(key, fn, x, a, t, NOW + k)
        seen.append([_cuda.launches[n] for n in KERNELS])
    # one of each kernel a dispatch, eager, captured or replayed
    assert seen == [[k + 1] * 3 for k in range(4)]
    assert graphs._graphs[key].launches == {**dict.fromkeys(_cuda.launches, 0),
                                            **dict.fromkeys(KERNELS, 1)}
    _cuda.reset_launches()


def test_a_failed_capture_raises_and_keeps_no_graph():
    class Broken(FakeGraph):
        def _capture(self, fn):
            fn(self.xg, self.addr, self.ts, self.now)
            raise RuntimeError("operation not permitted when stream is capturing")

    graphs, fn = DispatchGraphs(graph=Broken), stub([])
    x, a, t = inputs(6)
    key = key_of(x)
    _cuda.reset_launches()
    graphs.run(key, fn, x, a, t, NOW)
    with pytest.raises(RuntimeError, match="capturing"):
        graphs.run(key, fn, x, a, t, NOW)
    assert not graphs._graphs and _cuda.launches["resolve_words"] == 1
    _cuda.reset_launches()


def test_keys_seen_once_stay_eager_and_capture_nothing():
    """One-off shapes (an EOF tail group, a replay at shapes that just
    grew) cost no capture, however many there are."""
    calls = []
    graphs, fn = DispatchGraphs(graph=FakeGraph), stub(calls)
    for k in range(10):
        x, a, t = inputs(100 + k, shape=(1, 1, 16 + k))
        graphs.run(key_of(x), fn, x, a, t, NOW)
    assert calls == [int] * 10 and not graphs._graphs


def test_a_capture_beside_another_threads_dispatches_counts_every_launch(marks):
    """One thread captures while another dispatches eagerly (two pipelines,
    a thread each, as the soak runs them): the other thread's launches are
    counted once, and each replay adds the capture's own alone."""
    import threading

    capturing, other_done = threading.Event(), threading.Event()

    class Slow(FakeGraph):
        def _capture(self, fn):
            outs = super()._capture(fn)
            capturing.set()
            assert other_done.wait(10)
            return outs

    graphs, fn = DispatchGraphs(graph=Slow), stub([])
    x, a, t = inputs(8)
    key = key_of(x)
    eager, replays = 5, 3

    def other():
        assert capturing.wait(10)
        for _ in range(eager):
            fn(x, a, t, NOW)
        other_done.set()

    _cuda.reset_launches()
    thread = threading.Thread(target=other)
    thread.start()
    for _ in range(1 + replays):   # eager, capture and replay, replays
        graphs.run(key, fn, x, a, t, NOW)
    thread.join()
    assert graphs._graphs[key].launches == {**dict.fromkeys(_cuda.launches, 0),
                                            **dict.fromkeys(KERNELS, 1)}
    # one of each kernel a dispatch: this thread's eager one and its
    # replays, and the other thread's eager ones
    assert {k: _cuda.launches[k] for k in KERNELS} == dict.fromkeys(KERNELS,
                                                                    1 + replays + eager)
    _cuda.reset_launches()


def test_a_tally_keeps_its_threads_launches_out_of_the_counts():
    _cuda.reset_launches()
    with _cuda.tally() as outer:
        _cuda.count("resolve_words")
        with _cuda.tally() as inner:
            _cuda.count("gather_windows")
        _cuda.count("resolve_words")
    _cuda.count("candidate_passes")
    assert outer["resolve_words"] == 2 and outer["gather_windows"] == 0
    assert inner["gather_windows"] == 1
    assert _cuda.launches == {**dict.fromkeys(_cuda.launches, 0), "candidate_passes": 1}
    _cuda.add(outer)
    assert _cuda.launches["resolve_words"] == 2
    _cuda.reset_launches()


# ---- the pipeline's device paths through the cache -------------------------------


@pytest.fixture
def fetch_copies(monkeypatch):
    """_Fetch as on CUDA, where it copies the outputs into host memory when
    it starts (enqueued right behind the dispatch); on the CPU it keeps the
    tensors, which a later replay would overwrite."""
    from dump1090_tpu_torch.models import pipeline

    class Copying(pipeline._Fetch):
        def __init__(self, tensors):
            super().__init__([t.clone() for t in tensors])

    monkeypatch.setattr(pipeline, "_Fetch", Copying)


def _pipeline(graphs: bool, **cfg):
    from dump1090_tpu_torch.models.pipeline import DemodPipeline, PipelineConfig

    p = DemodPipeline(PipelineConfig(**cfg), clock=lambda: NOW, device="cpu")
    assert p._graphs is None   # the CPU runs every dispatch eagerly
    if graphs:
        p._graphs = DispatchGraphs(graph=FakeGraph)
    return p


@pytest.mark.parametrize("path", ["stream_raw_device", "run_device"])
def test_pipeline_through_the_cache_equals_eager(marks, fetch_copies, path):
    """Chained groups, the first of which overflows mc 16 and grows the
    shapes (its replay and those behind it), then replays of the grown
    shape: the same lines or messages, counters and cache as eager."""
    from dump1090_tpu_torch.utils.synth import planted_capture

    data, _ = planted_capture(7, 40, seed=31, noise_sigma=3.0)
    cfg = dict(batch_buffers=1, dispatch_groups=1, max_candidates=16, dispatch_ahead=3)
    outs = {}
    for graphs in (False, True):
        p = _pipeline(graphs, **cfg)
        _cuda.reset_launches()
        if path == "stream_raw_device":
            got = b"".join(p.stream_raw_device(io.BytesIO(data)))
        else:
            msgs = []
            p.run_device(io.BytesIO(data), msgs.append)
            got = [vars(m) for m in msgs]
        outs[graphs] = (got, p.stats, p.shapes.key, p.cache.addr.tolist(), p.cache.ts.tolist())
    assert outs[True] == outs[False] and outs[True][0]
    names = [n for n, _ in marks()]
    assert names.count(spans.GRAPH_CAPTURE) >= 1
    assert names.count(spans.GRAPH_REPLAY) >= 3


def test_pipeline_on_the_cpu_keeps_its_eager_dispatch(marks):
    from dump1090_tpu_torch.utils.synth import planted_capture

    data, _ = planted_capture(3, 10, seed=32, noise_sigma=3.0)
    p = _pipeline(False, batch_buffers=1, dispatch_groups=1)
    assert b"".join(p.stream_raw_device(io.BytesIO(data)))
    assert not {n for n, _ in marks()} & {spans.GRAPH_CAPTURE, spans.GRAPH_REPLAY}


# ---- resolve_words' `now` ------------------------------------------------------------


@pytest.mark.parametrize("offset", [0, 4, 5, 6, 60, 61, 62])
def test_resolve_words_takes_now_as_int_or_tensor(offset):
    """The same contract with `now` an int or a one-element int32 tensor,
    at clocks that carry the stream's fresh and expired entries across the
    TTL (entries aged 5 and 61 s at NOW)."""
    from dump1090_tpu_torch.ops import resolve as tr
    from dump1090_tpu_torch.utils.synth import random_word_stream

    pf, w1, w2, nbuf, ca, ct = (torch.from_numpy(a) for a in random_word_stream(3, 6, 64, NOW))
    h12 = tr._hash_words(w1, w2)
    now = NOW + offset
    want = tr.resolve_words_plain(pf, w1, w2, h12, nbuf, ca, ct, now, 64)
    for form in (now, np.int64(now), torch.tensor([now], dtype=torch.int32)):
        got = tr.resolve_words(pf, w1, w2, h12, nbuf, ca, ct, form, 64)
        assert all(torch.equal(g, w) for g, w in zip(got, want)), type(form)


def test_resolve_words_refuses_a_now_of_another_form():
    from dump1090_tpu_torch.ops import resolve as tr
    from dump1090_tpu_torch.utils.synth import random_word_stream

    pf, w1, w2, nbuf, ca, ct = (torch.from_numpy(a) for a in random_word_stream(3, 2, 8, NOW))
    h12 = tr._hash_words(w1, w2)
    for bad in (torch.tensor([NOW], dtype=torch.int64), torch.tensor([NOW, NOW], dtype=torch.int32),
                torch.tensor([NOW], dtype=torch.int32, device="meta")):
        with pytest.raises(TypeError, match="now"):
            tr.resolve_words(pf, w1, w2, h12, nbuf, ca, ct, bad, 8)
