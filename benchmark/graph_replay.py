"""The share of the window's groups that the program dispatched by
replaying a captured CUDA graph: those that carry its zero-length mark
pipeline.graph.replay (dump1090_tpu_torch/utils/spans.py::GRAPH_REPLAY),
read from the groups that benchmark/spans.py reads.  A program that does
not mark replays reads nothing."""

from __future__ import annotations

from benchmark import spans

GRAPH_REPLAY = "pipeline.graph.replay"


def marks_replays() -> bool:
    try:
        from dump1090_tpu_torch.utils import spans as program_spans
    except ImportError:
        return False
    return getattr(program_spans, "GRAPH_REPLAY", None) == GRAPH_REPLAY


def replay_pct(read_groups):
    """The share of `read_groups` that carry the mark, in percent, or None
    where no group was read."""
    if not read_groups:
        return None
    replayed = sum(any(s.name == GRAPH_REPLAY for s in ss) for ss in read_groups.values())
    return 100.0 * replayed / len(read_groups)


def graph_replay_pct(run):
    return replay_pct(spans.window(run)) if marks_replays() else None
