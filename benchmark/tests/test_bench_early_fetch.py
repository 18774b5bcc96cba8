"""early_fetch_pct.feeder and early_fetch_pct.archive
(benchmark/early_fetch.py) on a hand-made span list, and on an untraced CPU
run of each runner."""

import pytest

from benchmark import early_fetch
from benchmark import spans as bspans
from benchmark import spec
from benchmark.harness import Run
from dump1090_tpu_torch.utils.spans import Span

MS = 1_000_000   # ns
M = 1            # the main thread
NAMES = ["early_fetch_pct.feeder", "early_fetch_pct.archive"]


def sp(name, group, start, end, *, count=0, profiled=False):
    return Span(f"pipeline.{name}", group, -1, M, start * MS, end * MS, count, profiled)


def early(group, at):
    return sp("fetch.early", group, at, at)


SPANS = [
    # group 0: the warm-up, before the window opens at 1000 ms
    sp("issue", 0, 920, 930, count=4), sp("fetch.wait", 0, 940, 941, count=4),
    # groups 1 and 2: read
    sp("issue", 1, 1031, 1041, count=4), sp("fetch.wait", 1, 1100, 1102, count=4),
    sp("issue", 2, 1060, 1070, count=2), sp("fetch.wait", 2, 1105, 1106, count=2),
    # group 3 ends after the profiler started (its fetch wait): not read
    sp("issue", 3, 1150, 1160, count=4), sp("fetch.wait", 3, 1200, 1210, count=4, profiled=True),
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
def test_none_marked_reads_zero(run, name):
    assert read(name, run) == 0.0


@pytest.mark.parametrize("name", NAMES)
def test_all_marked_reads_a_hundred(run, monkeypatch, name):
    given(monkeypatch, SPANS + [early(1, 1100), early(2, 1105)])
    assert read(name, run) == 100.0


@pytest.mark.parametrize("name", NAMES)
def test_a_mark_counts_only_with_the_groups_read(run, monkeypatch, name):
    # group 3's mark goes with group 3, which the profiler's first span
    # cuts: one of the two groups read; group 0's is before the window
    given(monkeypatch, SPANS + [early(0, 939), early(1, 1100), early(3, 1199)])
    assert read(name, run) == 50.0
    # with no span profiled, group 3 is read as well
    given(monkeypatch, [s._replace(profiled=False) for s in SPANS]
          + [early(1, 1100), early(3, 1199)])
    assert read(name, run) == pytest.approx(200 / 3)


@pytest.mark.parametrize("name", NAMES)
def test_nothing_to_read_reads_none(run, monkeypatch, name):
    # a program that does not mark early fetches (its groups are read)
    from dump1090_tpu_torch.utils import spans

    monkeypatch.delattr(spans, "FETCH_EARLY")
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

    assert early_fetch.marks_early()
    assert spans.FETCH_EARLY == early_fetch.FETCH_EARLY


@pytest.mark.parametrize("workload, name", [("archive_raw.dense", "early_fetch_pct.archive"),
                                            ("feeder_net.live_dense", "early_fetch_pct.feeder")])
def test_a_cpu_run_of_each_runner_reads_the_share(tiny_cell, workload, name):
    from benchmark.run import execute

    _, verdict, run = execute(tiny_cell(workload, seconds=2.0), 0.0)
    assert verdict.correct, verdict.notes
    assert 0 <= read(name, run) <= 100
