"""The share of the window's groups that the program fetched because no next
input was ready: those that carry its zero-length mark pipeline.fetch.early
(dump1090_tpu_torch/utils/spans.py::FETCH_EARLY), read from the groups that
benchmark/spans.py reads.  A program that does not mark such groups reads
nothing."""

from __future__ import annotations

from benchmark import spans

FETCH_EARLY = "pipeline.fetch.early"


def marks_early() -> bool:
    try:
        from dump1090_tpu_torch.utils import spans as program_spans
    except ImportError:
        return False
    return getattr(program_spans, "FETCH_EARLY", None) == FETCH_EARLY


def early_pct(read_groups):
    """The share of `read_groups` that carry the mark, in percent, or None
    where no group was read."""
    if not read_groups:
        return None
    early = sum(any(s.name == FETCH_EARLY for s in ss) for ss in read_groups.values())
    return 100.0 * early / len(read_groups)


def early_fetch_pct(run):
    return early_pct(spans.window(run)) if marks_early() else None
