"""The per-layer metrics that read the program's spans (benchmark/spans.py),
on a hand-made span list, and on a traced CPU run of each runner."""

import pytest

from benchmark import spans as bspans
from benchmark import spec
from benchmark.harness import Run
from benchmark.run import execute
from dump1090_tpu_torch.utils.spans import Span

MS = 1_000_000   # ns
R, M = 7, 1      # the reader thread, the main thread
ARCHIVE = ("ingest.us_per_buffer", "ingest_wait.us_per_buffer", "host_issue.us_per_buffer.archive",
           "fetch_wait.us_per_buffer.archive", "host_format.us_per_buffer")
FEEDER = ("dispatch_hold.p95_ms", "host_issue.ms_per_buffer.feeder",
          "fetch_wait.ms_per_buffer.feeder", "host_decode.ms_per_buffer", "emit.ms_per_buffer")



def sp(name, group, thread, start, end, *, count=0, batch=-1, profiled=False):
    return Span(f"pipeline.{name}", group, batch, thread, start * MS, end * MS, count, profiled)


SPANS = [
    # group 0: the warm-up, before the window opens at 1000 ms
    sp("ingest.source", 0, R, 900, 910, count=4), sp("issue", 0, M, 920, 930, count=4),
    sp("fetch.wait", 0, M, 940, 941, count=4),
    # group 1: 4 buffers
    sp("ingest.source", 1, R, 1010, 1020, count=4), sp("ingest.stack", 1, R, 1020, 1025, count=4),
    sp("ingest.upload", 1, R, 1025, 1030, count=4), sp("ingest.wait", 1, M, 1005, 1031, count=4),
    sp("issue", 1, M, 1031, 1041, count=4), sp("fetch.wait", 1, M, 1100, 1102, count=4),
    sp("format", 1, M, 1102, 1104, batch=0, count=30), sp("format", 1, M, 1104, 1105, batch=1),
    sp("decode", 1, M, 1105, 1108, batch=0), sp("emit", 1, M, 1108, 1110, batch=0),
    # group 2: 2 buffers, replayed (a second issue after a first fetch)
    sp("ingest.source", 2, R, 1031, 1050, count=2), sp("ingest.stack", 2, R, 1050, 1051, count=2),
    sp("ingest.upload", 2, R, 1051, 1053, count=2), sp("ingest.wait", 2, M, 1041, 1054, count=2),
    sp("issue", 2, M, 1060, 1070, count=2), sp("fetch.wait", 2, M, 1105, 1106, count=2),
    sp("issue", 2, M, 1110, 1120, count=2), sp("fetch.wait", 2, M, 1130, 1131, count=2),
    sp("format", 2, M, 1131, 1135, batch=0), sp("decode", 2, M, 1135, 1136, batch=0),
    sp("emit", 2, M, 1136, 1140, batch=0),
    # group 3 ends after the profiler started (its fetch wait, at 1200):
    # not read; nor group 4, the end of the stream (no issue)
    sp("ingest.source", 3, R, 1060, 1070, count=4), sp("issue", 3, M, 1150, 1160, count=4),
    sp("fetch.wait", 3, M, 1200, 1210, count=4, profiled=True),
    sp("ingest.source", 4, R, 1070, 1071),
]


@pytest.fixture
def run(monkeypatch):
    monkeypatch.setattr(bspans, "recorded", lambda: (list(SPANS), 0))
    return Run(cell=None, extra=dict(t0=1000 * MS / 1e9))


def read(name, run):
    return spec.metric_reader(name)(run)


def test_the_window_and_the_profiler_cut():
    got = bspans.groups(SPANS, 1000 * MS)
    assert sorted(got) == [1, 2]
    # a window opened later leaves group 1's first spans out, and its issue
    assert sorted(bspans.groups(SPANS, 1032 * MS)) == [2]
    # with no span profiled, group 3 is read as well
    plain = [s._replace(profiled=False) for s in SPANS]
    assert sorted(bspans.groups(plain, 1000 * MS)) == [1, 2, 3]


def test_per_buffer_readings(run):
    # 6 buffers read (4 + 2)
    assert read("ingest.us_per_buffer", run) == pytest.approx((20 + 22) * 1e3 / 6)
    assert read("ingest_wait.us_per_buffer", run) == pytest.approx((26 + 13) * 1e3 / 6)
    assert read("host_issue.us_per_buffer.archive", run) == pytest.approx((10 + 20) * 1e3 / 6)
    assert read("host_issue.ms_per_buffer.feeder", run) == pytest.approx(30 / 6)
    assert read("fetch_wait.us_per_buffer.archive", run) == pytest.approx((2 + 2) * 1e3 / 6)
    assert read("fetch_wait.ms_per_buffer.feeder", run) == pytest.approx(4 / 6)
    assert read("host_format.us_per_buffer", run) == pytest.approx((3 + 4) * 1e3 / 6)
    assert read("host_decode.ms_per_buffer", run) == pytest.approx(4 / 6)
    assert read("emit.ms_per_buffer", run) == pytest.approx(6 / 6)


def test_the_reader_threads_ingest_only(run, monkeypatch):
    # ingest framed on the main thread (as a preloaded file's is) is not
    # the reader's: the uploads are left
    main = [s._replace(thread=M) if s.name.startswith("pipeline.ingest.s") else s for s in SPANS]
    monkeypatch.setattr(bspans, "recorded", lambda: (main, 0))
    assert read("ingest.us_per_buffer", run) == pytest.approx((5 + 2) * 1e3 / 6)


def test_the_hold_pairs_each_groups_last_issue_with_its_next_fetch_wait(run):
    # group 1: 1041 -> 1100; group 2: its replay's 1120 -> 1130
    assert bspans.holds(bspans.window(run)) == pytest.approx([0.059, 0.010])
    assert read("dispatch_hold.p95_ms", run) == pytest.approx(10 + 0.95 * (59 - 10))


def test_nothing_to_read_reads_none(monkeypatch):
    run = Run(cell=None, extra=dict(t0=1.0))
    monkeypatch.setattr(bspans, "recorded", lambda: ([], 0))
    for name in ARCHIVE + FEEDER:
        assert read(name, run) is None
    # a program without the recorder
    monkeypatch.setattr(bspans, "recorded", lambda: None)
    assert read("host_issue.us_per_buffer.archive", run) is None
    # a run with no window
    monkeypatch.setattr(bspans, "recorded", lambda: (list(SPANS), 0))
    assert read("host_issue.ms_per_buffer.feeder", Run(cell=None)) is None
    # the feeder's spans in an archive run, and the other way round
    archive_only = [s for s in SPANS if s.name not in ("pipeline.decode", "pipeline.emit")]
    monkeypatch.setattr(bspans, "recorded", lambda: (archive_only, 0))
    run.extra["t0"] = 1000 * MS / 1e9
    assert read("host_decode.ms_per_buffer", run) is None
    assert read("emit.ms_per_buffer", run) is None


def test_a_window_whose_first_spans_the_ring_dropped_is_not_read(run, monkeypatch):
    # spans dropped, but the ring still holds one that ended before t0
    # (group 0's): nothing of the window is gone, and it reads as before
    monkeypatch.setattr(bspans, "recorded", lambda: (list(SPANS), 5))
    assert sorted(bspans.window(run)) == [1, 2]
    assert read("host_issue.us_per_buffer.archive", run) == pytest.approx((10 + 20) * 1e3 / 6)
    # the ring wrapped inside the window: group 1 lost its ingest and wait
    # but kept its issue, so its buffers would count with half its spans
    wrapped = [s for s in SPANS if s.end_ns > 1030 * MS]
    monkeypatch.setattr(bspans, "recorded", lambda: (wrapped, 5))
    assert bspans.window(run) is None
    for name in ARCHIVE + FEEDER:
        assert read(name, run) is None, name
    # the same spans with nothing dropped are read as they are
    monkeypatch.setattr(bspans, "recorded", lambda: (wrapped, 0))
    assert sorted(bspans.window(run)) == [1, 2]


def test_recorded_gives_the_rings_spans_and_its_drops(monkeypatch):
    from dump1090_tpu_torch.utils import spans

    rec = spans.Recorder(capacity=2)
    monkeypatch.setattr(spans, "RECORDER", rec)
    for k in range(3):
        rec.mark(f"m{k}")
    got, dropped = bspans.recorded()
    assert [s.name for s in got] == ["m1", "m2"] and dropped == 1


def test_recorded_reads_nothing_without_the_programs_recorder(monkeypatch):
    import sys

    import dump1090_tpu_torch.utils

    monkeypatch.setitem(sys.modules, "dump1090_tpu_torch.utils.spans", None)
    monkeypatch.delattr(dump1090_tpu_torch.utils, "spans")
    assert bspans.recorded() is None


@pytest.mark.parametrize("workload, names", [("archive_raw.dense", ARCHIVE),
                                             ("feeder_net.live_dense", FEEDER)])
def test_a_cpu_run_of_each_runner_reads_every_new_metric(tiny_cell, workload, names):
    """Untraced, so that every group of the window is read however slowly
    this CPU runs it (a traced run reads the groups before its slice)."""
    _, verdict, run = execute(tiny_cell(workload, seconds=2.0), 0.0)
    assert verdict.correct, verdict.notes
    for name in names:
        assert read(name, run) >= 0, name
    assert read(names[1], run) > 0
