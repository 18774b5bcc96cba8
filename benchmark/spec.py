"""The benchmark's data: BENCHMARK.json at the checkout's root, and the
files it names under benchmark/.  Everything of one configuration, one
traffic mix, one runner or one metric lives in a file of its own, found
here by its name, so a new cell or metric is a new file and an entry in
BENCHMARK.json, never an edit.

- a configuration: the JSON file its `configs` entry names; its "runner"
  key names benchmark/runners/<runner>.py;
- a traffic mix: benchmark/traffic/<traffic>.json, parameters that one
  general generator (benchmark/air.py) reads;
- a metric: benchmark/metrics/<name>.py, whose read(run) returns the value
  or None where it finds nothing to read.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclass
class Cell:
    """One run's cell: the workload's configuration and traffic, with the
    run's seed, length and mode.  `device` is "cuda" in every benchmark
    run; the CPU tests drive the same code on "cpu"."""

    name: str
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    chips: int = 1
    device: str = "cuda"
    end_to_end: list = field(default_factory=list)   # metric entries this cell reports
    per_layer: list = field(default_factory=list)


def load_spec(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _reports(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def cell(workload: str, *, seed: int, seconds: float, trace: bool, root: Path = ROOT) -> Cell:
    """The Cell of `workload` as BENCHMARK.json under `root` defines it."""
    spec = load_spec(root)
    w = next((w for w in spec["workloads"] if w["name"] == workload), None)
    if w is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    conf = next(c for c in spec["configs"] if c["name"] == w["config"])
    config = json.loads((root / conf["file"]).read_text())
    traffic = json.loads((root / "benchmark" / "traffic" / f"{w['traffic']}.json").read_text())
    return Cell(
        name=workload, config=config, traffic=traffic, seed=seed, seconds=seconds,
        trace=trace, chips=int(w["chips"]),
        end_to_end=[m for m in spec["end_to_end"] if _reports(m, workload)],
        per_layer=[m for m in spec["per_layer"] if _reports(m, workload)],
    )


def runner(name: str, root: Path = ROOT):
    """benchmark/runners/<name>.py as a module."""
    return _load(root / "benchmark" / "runners" / f"{name}.py", f"benchmark.runners.{name}")


def metric_reader(name: str, root: Path = ROOT):
    """benchmark/metrics/<name>.py's read function (metric names hold dots,
    so the file is loaded by its path)."""
    safe = name.replace(".", "_").replace("-", "_")
    return _load(root / "benchmark" / "metrics" / f"{name}.py",
                 f"benchmark.metrics.{safe}").read


def _load(path: Path, module_name: str):
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    spec = importlib.util.spec_from_file_location(module_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
