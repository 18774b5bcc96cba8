"""The device pipeline's spans (dump1090_tpu_torch/utils/spans.py) on the
CPU over planted air: the output is the same with the recorder on and off;
each dispatch group and each batch records its spans once, in order and
nested; a forced overflow records its replay and its new shapes; under a
running torch.profiler every span is also one annotation of its name, on
the profiler's clock; and the ring drops its oldest spans and counts them."""

import contextlib
import io
import json
import threading
import time
import types
from collections import Counter, defaultdict

import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile

from dump1090_tpu_torch.io.sources import iq_buffers
from dump1090_tpu_torch.models.pipeline import DemodPipeline, PipelineConfig
from dump1090_tpu_torch.utils import spans
from dump1090_tpu_torch.utils.synth import planted_capture

NOW = 1_700_000_000
GROUP = ("pipeline.ingest.source", "pipeline.ingest.stack", "pipeline.ingest.upload",
         "pipeline.ingest.wait", "pipeline.issue", "pipeline.fetch.wait")


@pytest.fixture(scope="module")
def capture():
    # 5 blocks: two full 2x2 groups and a short last group, dense enough to
    # overflow 16 candidate slots a buffer
    data, _ = planted_capture(5, 60, seed=21, noise_sigma=3.0, flip_weights=(0.6, 0.25, 0.15))
    return data


@pytest.fixture
def recorder():
    spans.RECORDER.clear()
    yield spans.RECORDER
    spans.RECORDER.clear()


def _pipeline(mc=256, **kw):
    return DemodPipeline(PipelineConfig(batch_buffers=2, dispatch_groups=2, max_candidates=mc,
                                        **kw), clock=lambda: NOW, device="cpu")


def _raw(data, mc=256):
    """stream_raw_device over a stream with no fileno: the reader thread's
    streaming ingest, as a long archive takes."""
    p = _pipeline(mc)
    return b"".join(p.stream_raw_device(io.BytesIO(data))), p


def _live(data, mc=256):
    """run_source_device over pre-framed live buffers, one a dispatch."""
    p = DemodPipeline(PipelineConfig(max_candidates=mc), clock=lambda: NOW, device="cpu")
    got = []
    p.run_source_device(list(iq_buffers(io.BytesIO(data))), lambda mm: got.append(vars(mm)))
    return got, p


def _counters(p):
    return vars(p.stats)


def _by_group(recorded):
    out = defaultdict(list)
    for s in recorded:
        out[s.group].append(s)
    return out


@pytest.mark.parametrize("path", ["stream_raw_device", "run_source_device"])
def test_output_is_the_same_with_the_recorder_on_and_off(capture, recorder, monkeypatch, path):
    decode = _raw if path == "stream_raw_device" else _live
    on, p_on = decode(capture, mc=16)
    assert recorder.spans()
    # the pipeline with no recorder: each span a bare context
    monkeypatch.setattr(spans, "span",
                        lambda *a, **k: contextlib.nullcontext(types.SimpleNamespace()))
    monkeypatch.setattr(spans, "mark", lambda *a, **k: None)
    recorder.clear()
    off, p_off = decode(capture, mc=16)
    assert recorder.spans() == []
    assert on == off and len(on) > 50
    assert _counters(p_on) == _counters(p_off)
    np.testing.assert_array_equal(p_on.cache.addr, p_off.cache.addr)


def _check_nesting_and_order(recorded):
    """On each thread the ring holds the spans in the order they ended, and
    any two either follow each other or one encloses the other."""
    for s in recorded:
        assert s.start_ns <= s.end_ns
    for t in {s.thread for s in recorded}:
        mine = [s for s in recorded if s.thread == t]
        assert [s.end_ns for s in mine] == sorted(s.end_ns for s in mine)
        for k, a in enumerate(mine):
            for b in mine[k + 1:]:   # b ended after a
                assert a.end_ns <= b.start_ns or b.start_ns <= a.start_ns


def test_each_group_and_batch_of_the_file_path_records_its_spans_once(capture, recorder):
    raw, p = _raw(capture)
    recorded = recorder.spans()
    main = threading.get_ident()
    groups = _by_group(recorded)
    issued = [s.group for s in recorded if s.name == "pipeline.issue"]
    assert issued == sorted(issued) == sorted(set(issued)) and len(issued) == 2
    buffers = 0
    for g in issued:
        ss = groups[g]
        assert Counter(s.name for s in ss if s.batch < 0) == Counter(GROUP)
        one = {s.name: s for s in ss if s.batch < 0}
        for name in GROUP[:3]:   # the ingest on the reader thread
            assert one[name].thread != main
        for name in GROUP[3:]:
            assert one[name].thread == main
        n = one["pipeline.issue"].count
        assert n in (4, 1) and all(one[name].count == n for name in GROUP)
        buffers += n
        # in order: source, stack, upload on the reader; the main thread
        # takes the group, issues it, later waits on its fetch, formats
        assert (one["pipeline.ingest.source"].end_ns <= one["pipeline.ingest.stack"].start_ns
                <= one["pipeline.ingest.stack"].end_ns <= one["pipeline.ingest.upload"].start_ns
                <= one["pipeline.ingest.upload"].end_ns <= one["pipeline.ingest.wait"].end_ns
                <= one["pipeline.issue"].start_ns <= one["pipeline.issue"].end_ns
                <= one["pipeline.fetch.wait"].start_ns)
        batches = [s for s in ss if s.batch >= 0]
        n_batches = -(-n // 2)
        assert Counter(s.name for s in batches) == {"pipeline.format": n_batches,
                                                    "pipeline.consumer": n_batches}
        for s in batches:
            assert s.thread == main and s.start_ns >= one["pipeline.fetch.wait"].end_ns
    assert buffers == 5
    # formats count the lines each batch yielded
    assert sum(s.count for s in recorded if s.name == "pipeline.format") == raw.count(b"\n")
    # the reader's last read finds the end of the stream: a source span
    # with no buffer, and the main thread's wait that receives the end
    assert [s.count for s in recorded if s.name == "pipeline.ingest.source"][-1] == 0
    assert [s.group for s in recorded if s.name == "pipeline.ingest.wait"][-1] == -1
    assert not any(s.name in ("pipeline.replay", "pipeline.reshape") for s in recorded)
    _check_nesting_and_order(recorded)
    assert not any(s.profiled for s in recorded) and recorder.dropped == 0


def test_each_live_buffer_records_its_decode_and_emit(capture, recorder):
    got, p = _live(capture)
    recorded = recorder.spans()
    groups = _by_group(recorded)
    issued = [s.group for s in recorded if s.name == "pipeline.issue"]
    assert len(issued) == 5 and issued == sorted(issued)
    for g in issued:
        names = Counter(s.name for s in groups[g])
        assert names == Counter(GROUP + ("pipeline.decode", "pipeline.emit"))
        decode, emit = (next(s for s in groups[g] if s.name == n)
                        for n in ("pipeline.decode", "pipeline.emit"))
        assert decode.batch == emit.batch == 0 and decode.count == emit.count > 0
        assert decode.end_ns <= emit.start_ns
    assert sum(s.count for s in recorded if s.name == "pipeline.emit") == len(got)
    _check_nesting_and_order(recorded)


def test_a_forced_overflow_records_the_replay_and_the_new_shapes(capture, recorder):
    raw, p = _raw(capture, mc=16)
    assert p.max_candidates > 16
    recorded = recorder.spans()
    reshapes = [s for s in recorded if s.name == "pipeline.reshape"]
    replays = [s for s in recorded if s.name == "pipeline.replay"]
    assert reshapes and replays
    assert reshapes[0].shapes[0] == p.max_candidates and len(reshapes[0].shapes) == 4
    for r in replays + reshapes:
        assert r.start_ns == r.end_ns and r.group >= 0
    for r in replays:
        # the mark sits inside the replayed group's second issue
        issues = [s for s in recorded if s.name == "pipeline.issue" and s.group == r.group]
        assert len(issues) == 2
        assert issues[0].end_ns < issues[1].start_ns <= r.start_ns <= issues[1].end_ns
        assert r.thread == issues[1].thread and r.shapes == reshapes[0].shapes
    # the group that overflowed waits on its fetch twice
    first = replays[0].group
    assert sum(s.name == "pipeline.fetch.wait" and s.group == first for s in recorded) == 2
    _check_nesting_and_order(recorded)


def test_the_profiler_flag_is_read_on_every_thread():
    """spans.profiling() reads torch's private, process-wide flag: on while
    a profiler records, on any thread, off before and after."""
    seen = []
    assert spans.profiling() is False
    with profile(activities=[ProfilerActivity.CPU]):
        t = threading.Thread(target=lambda: seen.append(spans.profiling()))
        t.start()
        t.join(timeout=10)
        assert not t.is_alive()
        assert spans.profiling() is True
    assert seen == [True]
    assert spans.profiling() is False


def test_spans_under_a_profiler_are_its_annotations_on_its_clock(capture, recorder, tmp_path):
    """With every thread profiled (the experimental profile_all_threads),
    each span recorded during the profile is one user_annotation of its
    name (a mark's name followed by its shapes), none without a span, and
    each at the time the trace has it (baseTimeNanoseconds + ts reads
    time.time_ns())."""
    from torch._C._profiler import _ExperimentalConfig

    wall_minus_perf = time.time_ns() - time.perf_counter_ns()
    with profile(activities=[ProfilerActivity.CPU],
                 experimental_config=_ExperimentalConfig(profile_all_threads=True)) as prof:
        _raw(capture, mc=16)
    recorded = recorder.spans()
    assert recorded and all(s.profiled for s in recorded)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())
    notes = [e for e in trace["traceEvents"] if e.get("cat") == "user_annotation"
             and e["name"].startswith("pipeline.")]
    assert Counter(e["name"] for e in notes) == Counter(spans.label(s.name, s.shapes)
                                                        for s in recorded)
    assert any(" mc=" in e["name"] for e in notes)
    base = int(trace["baseTimeNanoseconds"])
    issues = sorted((s for s in recorded if s.name == "pipeline.issue"), key=lambda s: s.start_ns)
    marks = sorted(e["ts"] for e in notes if e["name"] == "pipeline.issue")
    for s, ts in zip(issues, marks):
        at = base + int(ts * 1e3)
        assert abs(s.start_ns + wall_minus_perf - at) < 5_000_000


def test_no_annotation_without_a_profiler(capture, recorder, monkeypatch):
    calls = []
    monkeypatch.setattr(spans, "record_function", lambda *a: calls.append(a))
    _raw(capture, mc=16)
    assert recorder.spans() and calls == []


def test_the_ring_drops_its_oldest_spans_and_counts_them():
    rec = spans.Recorder(capacity=4)
    for k in range(6):
        with rec.span(f"s{k}", group=rec.next_group(), count=k) as s:
            s.count = 10 * k
    rec.mark("m", group=9, shapes=(1, 2, 3, 4))
    kept = rec.spans()
    assert [s.name for s in kept] == ["s3", "s4", "s5", "m"]
    assert [s.group for s in kept] == [3, 4, 5, 9] and kept[0].count == 30
    assert rec.dropped == 3 and kept[-1].shapes == (1, 2, 3, 4)
    rec.clear()
    assert rec.spans() == [] and rec.dropped == 0
