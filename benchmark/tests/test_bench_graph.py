"""graph_replay_pct.feeder and graph_replay_pct.archive
(benchmark/graph_replay.py) on a hand-made span list, and on an untraced
CPU run of each runner, where no dispatch replays a graph."""

import pytest

from benchmark import graph_replay
from benchmark import spans as bspans
from benchmark import spec
from benchmark.harness import Run
from dump1090_tpu_torch.utils.spans import Span

MS = 1_000_000   # ns
M = 1            # the main thread
NAMES = ["graph_replay_pct.feeder", "graph_replay_pct.archive"]


def sp(name, group, start, end, *, count=0, profiled=False):
    return Span(f"pipeline.{name}", group, -1, M, start * MS, end * MS, count, profiled)


def replay(group, at):
    return sp("graph.replay", group, at, at)


SPANS = [
    # group 0: the warm-up, before the window opens at 1000 ms
    sp("issue", 0, 920, 930, count=1), sp("fetch.wait", 0, 940, 941, count=1),
    # groups 1 and 2: read
    sp("issue", 1, 1031, 1041, count=1), sp("fetch.wait", 1, 1100, 1102, count=1),
    sp("issue", 2, 1060, 1070, count=1), sp("fetch.wait", 2, 1105, 1106, count=1),
    # group 3 ends after the profiler started (its fetch wait): not read
    sp("issue", 3, 1150, 1160, count=1), sp("fetch.wait", 3, 1200, 1210, count=1, profiled=True),
]


@pytest.fixture
def run(monkeypatch):
    monkeypatch.setattr(bspans, "recorded", lambda: (list(SPANS), 0))
    return Run(cell=None, extra=dict(t0=1000 * MS / 1e9))


def read(name, run):
    return spec.metric_reader(name)(run)


def given(monkeypatch, spans):
    monkeypatch.setattr(bspans, "recorded", lambda: (spans, 0))


@pytest.mark.parametrize("name", NAMES)
def test_every_group_marked_reads_a_hundred(run, monkeypatch, name):
    given(monkeypatch, SPANS + [replay(1, 1035), replay(2, 1065)])
    assert read(name, run) == 100.0


@pytest.mark.parametrize("name", NAMES)
def test_no_group_marked_reads_zero(run, monkeypatch, name):
    # a capture alone is no replay
    given(monkeypatch, SPANS + [sp("graph.capture", 1, 1034, 1034)])
    assert read(name, run) == 0.0


@pytest.mark.parametrize("name", NAMES)
def test_a_mark_counts_only_with_the_groups_read(run, monkeypatch, name):
    # group 0's mark is before the window, group 3's goes with the group
    # the profiler's first span cuts
    given(monkeypatch, SPANS + [replay(0, 925), replay(2, 1065), replay(3, 1155)])
    assert read(name, run) == 50.0


@pytest.mark.parametrize("name", NAMES)
def test_a_program_without_the_mark_reads_none(run, monkeypatch, name):
    from dump1090_tpu_torch.utils import spans

    monkeypatch.delattr(spans, "GRAPH_REPLAY")
    assert read(name, run) is None
    monkeypatch.undo()
    # no group read, no recorder, no window
    given(monkeypatch, [])
    assert read(name, run) is None
    monkeypatch.setattr(bspans, "recorded", lambda: None)
    assert read(name, run) is None
    given(monkeypatch, list(SPANS))
    assert read(name, Run(cell=None)) is None


def test_the_mark_is_the_programs():
    from dump1090_tpu_torch.utils import spans

    assert graph_replay.marks_replays()
    assert spans.GRAPH_REPLAY == graph_replay.GRAPH_REPLAY


@pytest.mark.parametrize("workload, name", [("archive_raw.dense", "graph_replay_pct.archive"),
                                            ("feeder_net.live_dense", "graph_replay_pct.feeder")])
def test_a_cpu_run_reads_zero(tiny_cell, workload, name):
    """On the CPU every dispatch runs eagerly: the share reads 0, not
    nothing."""
    from benchmark.run import execute

    _, verdict, run = execute(tiny_cell(workload, seconds=2.0), 0.0)
    assert verdict.correct, verdict.notes
    assert read(name, run) == 0.0
