"""Readings the per-layer metric files share: from the traced slice
(benchmark/trace.py) and the run's shapes."""

from __future__ import annotations

import numpy as np

from benchmark import roofline
from benchmark.reference import modes


def is_k1(name: str) -> bool:
    """K1, csrc/gather_windows.cu."""
    return "gather_windows_kernel" in name


def is_k2(name: str) -> bool:
    """K2, csrc/resolve_words.cu's single-stream walk."""
    return "resolve_words_kernel" in name and "streams" not in name


def idle_pct(run):
    """The traced slice's share in which the card ran nothing."""
    t = run.trace
    if t is None or t.window_s <= 0 or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def launches_per_buffer(run):
    """Kernels run in the traced slice over the buffers taken in it."""
    t = run.trace
    if t is None or t.done <= 0:
        return None
    n, _ = t.kernel_time(lambda name: True)
    return n / t.done if n else None


def _group_rows(run) -> int:
    return run.nb * run.ng


def _mc(run) -> int:
    mc0, mc1 = run.mc
    if mc0 != mc1:
        raise RuntimeError(f"the candidate slots changed in the window ({mc0} -> {mc1})")
    return mc1


def k1_call_bytes(run) -> int:
    """Bytes of one K1 call on a group of the window: each buffer's first
    mc candidate positions (padded with the scan length, as the front pads
    them) in the air the window cycles."""
    mc = _mc(run)
    pos = np.full((_group_rows(run), mc), modes.SCAN_LEN, dtype=np.int64)
    for b, p in enumerate(run.k1_positions):
        p = p[:mc]
        pos[b, : p.size] = p
    return roofline.k1_bytes(pos, modes.BUF_SAMPLES)


def k2_call(run) -> tuple[int, int]:
    """(rows, candidate slots a row) of one K2 call in the window."""
    return _group_rows(run), _mc(run)
