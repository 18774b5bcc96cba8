"""Tiny cells of the benchmark for the CPU tests: the configurations and
traffic mixes of BENCHMARK.json, cut to a few buffers and driven on the CPU
with the kernels' plain versions."""

from __future__ import annotations

import copy
import json

import pytest

from benchmark import spec


def tiny(workload: str, *, seed: int = 2**31 + 11, seconds: float = 1.0, trace: bool = False):
    c = spec.cell(workload, seed=seed, seconds=seconds, trace=trace)
    c = copy.deepcopy(c)
    c.device = "cpu"
    if c.config["runner"] == "stream":
        c.config["settings"].update(batch_buffers=2, dispatch_groups=2)
        c.config["warmup_groups"] = 1
        c.traffic["distinct_blocks"] = 4
    else:
        c.config["warmup_seconds"] = 0.3
        c.traffic["pace"] = 8.0
    return c


@pytest.fixture
def tiny_cell():
    return tiny


def load(path):
    return json.loads(path.read_text())
