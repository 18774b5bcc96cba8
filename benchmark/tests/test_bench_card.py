"""The runners on the card at a tiny size: a whole run through the
kernels, checked against the reference.  Run on a machine with a card:

    python -m pytest --noconftest -m cuda benchmark/tests/test_bench_card.py -p no:cacheprovider

(--noconftest keeps tests/conftest.py, which imports JAX, out; this file
needs no fixture of its own.)"""

import copy

import pytest

from benchmark import spec
from benchmark.run import execute, forbidden_modules


def _cell(workload: str, trace: bool):
    c = copy.deepcopy(spec.cell(workload, seed=2**31 + 77, seconds=2.0, trace=trace))
    if c.config["runner"] == "stream":
        c.config["settings"].update(batch_buffers=8, dispatch_groups=2)
        c.config["warmup_groups"] = 1
        c.traffic["distinct_blocks"] = 16
    else:
        c.config["warmup_seconds"] = 0.5
    return c


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [False, True], ids=["untraced", "traced"])
@pytest.mark.parametrize("workload", ["archive_raw.dense", "feeder_net.live_dense"])
def test_cell_on_the_card(workload, trace):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    result, verdict, run = execute(_cell(workload, trace), 0.0)
    assert verdict.correct, verdict.notes
    assert result["device"]["platform"] == "gpu"
    assert not forbidden_modules()
    if trace:
        assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
        for m in result["metrics"].values():
            if m["unit"] == "%":
                assert 0 <= m["value"] <= 105
