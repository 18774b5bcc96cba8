"""BENCHMARK.json against the benchmark's contract, and new cells and
metrics added as files only."""

import copy
import json
import re
import shutil

import pytest

from benchmark import spec
from benchmark.run import execute

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
ENTRY_KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


@pytest.fixture(scope="module")
def bench():
    return spec.load_spec()


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["paths"] == ["benchmark"]
    assert 1 <= bench["run_seconds"] <= 51 and isinstance(bench["run_seconds"], int)
    assert len(bench["command"]) <= 32


@pytest.mark.parametrize("section", sorted(ENTRY_KEYS))
def test_names_units_and_keys(bench, section):
    names = [e["name"] for e in bench[section]]
    assert len(names) == len(set(names))
    for e in bench[section]:
        assert NAME.match(e["name"]), e["name"]
        extra = {"workloads"} if section in ("end_to_end", "per_layer") else set()
        assert ENTRY_KEYS[section] <= set(e) <= ENTRY_KEYS[section] | extra
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        texts = [e[k] for k in ("why", "layer") if k in e]
        if section == "configs":
            texts.append(e["source"])
        for text in texts:
            assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text
        if section == "workloads":
            assert NAME.match(e["config"]) and NAME.match(e["traffic"]) and e["chips"] in (1, 4)


def test_metrics_sources_bounds_and_cells(bench):
    cells = {w["name"] for w in bench["workloads"]}
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", cells)) <= cells
    for m in bench["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e
        # every cell that reports it reports the metric it moves
        for w in m["workloads"]:
            assert w in e2e[m["moves"]].get("workloads", cells)
    for w in cells:
        reported = [m for m in bench["end_to_end"] if w in m.get("workloads", cells)]
        assert "setup_s" in [m["name"] for m in reported] and len(reported) >= 2
        assert any(w in m["workloads"] for m in bench["per_layer"])


def test_every_name_finds_its_files(bench):
    for c in bench["configs"]:
        conf = json.loads((spec.ROOT / c["file"]).read_text())
        assert c["file"].startswith("benchmark/")
        spec.runner(conf["runner"])
    for w in bench["workloads"]:
        assert (spec.HERE / "traffic" / f"{w['traffic']}.json").is_file()
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(spec.metric_reader(m["name"]))


def test_a_cell_and_a_metric_added_as_files_only_are_found(tmp_path):
    shutil.copytree(spec.HERE, tmp_path / "benchmark")
    b = spec.load_spec()
    b = copy.deepcopy(b)
    (tmp_path / "benchmark" / "traffic" / "sparse_air.json").write_text(json.dumps(
        dict(json.loads((spec.HERE / "traffic" / "quiet.json").read_text()),
             frames_per_buffer=1, why="one frame a buffer")))
    (tmp_path / "benchmark" / "metrics" / "window_seconds.archive.py").write_text(
        "def read(run):\n    return run.window_s\n")
    b["workloads"].append({"name": "archive_raw.sparse_air", "config": "archive_raw",
                           "traffic": "sparse_air", "chips": 1, "why": "a new cell"})
    for m in b["end_to_end"]:
        if "workloads" in m and "archive_raw.dense" in m["workloads"]:
            m["workloads"].append("archive_raw.sparse_air")
    b["per_layer"].append({"name": "window_seconds.archive", "unit": "s", "better": "lower",
                           "source": "host_clock", "layer": "device", "moves": "decode_msps",
                           "workloads": ["archive_raw.sparse_air"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    cell = spec.cell("archive_raw.sparse_air", seed=5, seconds=1.0, trace=True, root=tmp_path)
    assert cell.traffic["frames_per_buffer"] == 1
    assert [m["name"] for m in cell.per_layer] == ["window_seconds.archive"]
    cell.device = "cpu"
    cell.config["settings"].update(batch_buffers=2, dispatch_groups=2)
    cell.config["warmup_groups"] = 1
    cell.traffic["distinct_blocks"] = 4
    result, verdict, _ = execute(cell, 0.0, root=tmp_path)
    assert verdict.correct, verdict.notes
    assert result["metrics"]["window_seconds.archive"]["value"] > 0
