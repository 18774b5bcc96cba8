"""The plain reference against the port's CPU run, one small seed per
configuration, and the reference's independence from the program."""

import io
import subprocess
import sys

import numpy as np

from benchmark import air
from benchmark.runners import stream as stream_runner
from benchmark.run import execute


def test_reference_equals_the_ports_archive_decode_on_the_cpu(tiny_cell):
    from dump1090_tpu_torch.models.pipeline import DemodPipeline, PipelineConfig

    cell = tiny_cell("archive_raw.dense")
    blocks, _ = air.blocks(cell.seed, 4, cell.traffic)
    p = DemodPipeline(PipelineConfig(batch_buffers=2, dispatch_groups=2), device="cpu",
                      clock=lambda: 1_000)
    # two cycles of the four blocks: the first group's first buffer carries
    # no-signal samples, the second's the cycle's tail
    got = list(p.stream_raw_device(io.BytesIO(blocks.tobytes() * 2)))
    want, counters, _ = stream_runner.reference_groups(blocks, 2, 2, [1_000, 1_000])
    assert got == want
    assert sum(len(w) for w in want) > 0
    from dump1090_tpu_torch.models.decoder import STAT_FIELDS

    assert tuple(getattr(p.stats, f) for f in STAT_FIELDS) == counters


def test_feeder_run_on_the_cpu_equals_the_reference(tiny_cell):
    result, verdict, _ = execute(tiny_cell("feeder_net.live_dense"), 0.0)
    assert verdict.correct, verdict.notes
    assert result["attempted"] > 0 and result["failed"] == 0
    assert all(c["value"] == 0 for c in result["checks"].values())


def test_the_reference_imports_nothing_of_the_program_nor_jax():
    code = ("import sys, benchmark.reference.demod, benchmark.reference.decoder, "
            "benchmark.reference.hub, benchmark.reference.modes, benchmark.air; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True)
    tops = set(eval(out.stdout))
    assert not tops & {"dump1090_tpu_torch", "dump1090_tpu", "jax", "jaxlib", "flax", "torch"}


def test_a_run_loads_neither_jax_nor_the_jax_package():
    # every module a run imports, the program's entry points included
    code = ("import sys; from benchmark import run, spec, program, harness, trace, layers, "
            "roofline; from benchmark.runners import stream, paced; "
            "from dump1090_tpu_torch.models import pipeline, hub, tracker; "
            "import dump1090_tpu_torch.ops.resolve, dump1090_tpu_torch.native; "
            "print(run.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_forbidden_names_are_compared_whole(monkeypatch):
    from benchmark import run

    monkeypatch.setitem(sys.modules, "dump1090_tpu_torch_x", np)
    assert "dump1090_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", np)
    assert run.forbidden_modules() == ["jax"]
