"""The port stands alone: no file of dump1090_tpu_torch/ (io/rtlsdr.py among
them, nor chip_smoke.py) imports jax or dump1090_tpu, it decodes (file
decode, decode_captures, the message hub over run_device, the host-resolve
path with its C++ runtime, its Python twin and the --debug dumps, the
packed fronts and live buffers through run_source_device and run_source,
the sharded decode's worker and --tpu-shard-time) with both made
unimportable, and its entry points, the live CLI, the sharded decode, the
worker and every tool of dump1090_tpu_torch/tools/ that decodes IQ (the
measurement tools bench, measure and exp_demod_front among them), refuse
to fall back to the CPU when no card is present.  Nor does it import the
JAX package's tools (tools/*.py, the root's bench.py) or put their
directory on sys.path, and the tools run with jax, the JAX package and the
JAX tools' modules made unimportable."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "dump1090_tpu")
# the port's tools, each a port of the JAX tool of the same name in tools/
TOOLS = ("fuzz_diff", "soak_device", "snr_sweep", "net_capture", "fuzz_hex", "sweep_hex",
         "http_diff", "netdebug_diff", "gen_cpr_vectors", "refbuild")
# the tools that decode IQ and so take --device (the others need no card)
CARD_TOOLS = TOOLS[:4]
# the measurement tools: ports of the root's bench.py and of tools/measure.py
# and tools/exp_demod_front.py, with their inputs in air.py; all take --device
MEASURE_TOOLS = ("bench", "measure", "exp_demod_front")


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_no_file_imports_jax_or_the_jax_package():
    files = sorted((REPO / "dump1090_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10 and REPO / "dump1090_tpu_torch" / "io" / "rtlsdr.py" in files
    assert {REPO / "dump1090_tpu_torch" / "tools" / f"{t}.py"
            for t in TOOLS + MEASURE_TOOLS + ("air",)} <= set(files)
    # nor the JAX package's tools (tools/*.py and the root's bench.py,
    # imported by their file names)
    jax_tools = {p.stem for p in (REPO / "tools").glob("*.py")} | {"bench"}
    assert set(TOOLS) <= jax_tools
    for f in files:
        assert "sys.path" not in f.read_text(), f"{f.relative_to(REPO)} edits sys.path"
        for mod in _imported_modules(f):
            root = mod.split(".")[0]
            assert root not in FORBIDDEN, f"{f.relative_to(REPO)} imports {mod}"
            assert root not in jax_tools, f"{f.relative_to(REPO)} imports {mod}"


def test_decodes_with_jax_and_the_jax_package_unimportable():
    code = """
import io, sys
sys.modules["jax"] = None
sys.modules["dump1090_tpu"] = None
from dump1090_tpu_torch.models.pipeline import DemodPipeline, PipelineConfig
from dump1090_tpu_torch.utils.synth import planted_capture
data, planted = planted_capture(1, 20, seed=9, flip_weights=(1.0,))
p = DemodPipeline(PipelineConfig(), device="cpu", clock=lambda: 1_700_000_000)
out = b"".join(p.stream_raw_device(io.BytesIO(data)))
want = b"".join(b"*" + c.hex().encode() + b";\\n" for _, _, c, _ in planted)
assert out == want, (out, want)
import dump1090_tpu_torch
msgs = dump1090_tpu_torch.decode_captures([data, data[:200_000]], crcok_only=True,
                                          device="cpu", device_resolve=True)
assert [b"*" + m.msg[: m.msgbits // 8].hex().encode() + b";\\n" for m in msgs[0]] \
    == want.splitlines(keepends=True)
assert len(msgs[1]) > 0
# the message hub over run_device: the verbose display, with the tracker
# on through a counted SBS client, and the net and state modules loaded
from dump1090_tpu_torch.io import net
from dump1090_tpu_torch.models.hub import HubConfig, MessageHub
from dump1090_tpu_torch.models.tracker import AircraftTracker
from dump1090_tpu_torch.utils import state
p = DemodPipeline(PipelineConfig(), device="cpu", clock=lambda: 1_700_000_000)
p.stats.sbs_connections = 1
text, sbs = io.StringIO(), []
hub = MessageHub(HubConfig(), AircraftTracker(), p.stats, out=text, sbs_sink=sbs.append)
p.run_device(io.BytesIO(data), hub.use_message)
assert [ln for ln in text.getvalue().splitlines() if ln.startswith("*")] \
    == [w.decode() for w in want.split()]
assert sbs and all(line.startswith("MSG,") for line in sbs)
assert len(hub.tracker.aircraft) > 0 and state.snapshot(hub.tracker, p.cache, p.stats)
# the host-resolve path: the C++ runtime (built from the port's own copy),
# its Python twin with the --debug dumps, and decode_captures' host strategy
from dump1090_tpu_torch.native import records_to_raw_lines
from dump1090_tpu_torch.utils.debug import DebugFlags
h = DemodPipeline(PipelineConfig(batch_buffers=16), device="cpu", clock=lambda: 1_700_000_000,
                  native=True)
assert b"".join(map(records_to_raw_lines, h.stream_records(io.BytesIO(data)))) == want
dump = io.StringIO()
d = DemodPipeline(PipelineConfig(), device="cpu", clock=lambda: 1_700_000_000,
                  debug_flags=DebugFlags.parse("C"), debug_out=dump)
d.run(io.BytesIO(data), lambda mm: None)
assert dump.getvalue().count("--- Decoded with good CRC") == 20
host = dump1090_tpu_torch.decode_captures([data], crcok_only=True, device="cpu",
                                          device_resolve=False)
assert [m.msg for m in host[0]] == [m.msg for m in msgs[0]]
# live input: the RTL-SDR source binds librtlsdr at run time, and live
# buffers decode through both live paths under a packed front
from dump1090_tpu_torch.io.rtlsdr import RtlSdrSource, RtlSdrUnavailable
from dump1090_tpu_torch.io.sources import iq_buffers
try:
    RtlSdrSource(lib_path="/nonexistent/librtlsdr.so")
    raise AssertionError("no RtlSdrUnavailable")
except RtlSdrUnavailable:
    pass
for method in ("run_source_device", "run_source"):
    lp = DemodPipeline(PipelineConfig(front="packed-mxu"), device="cpu",
                       clock=lambda: 1_700_000_000)
    live = []
    getattr(lp, method)(iq_buffers(io.BytesIO(data)), live.append)
    assert [m.msg for m in live if m.crcok] == [m.msg for m in msgs[0]], method
assert not any(m == "jax" or m.startswith(("jax.", "dump1090_tpu."))
               for m, v in sys.modules.items() if v is not None)
print("ok", p.stats.goodcrc)
"""
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.strip() == "ok 20"


def test_sharded_paths_run_with_jax_unimportable(tmp_path):
    """The multi-process worker (one process, a (2, 2) mesh of the CPU) and
    the CLI's --tpu-shard-time run with jax and the JAX package made
    unimportable, and neither enters sys.modules."""
    path = tmp_path / "cap.bin"
    code = f"""
import contextlib, io, sys
sys.modules["jax"] = None
sys.modules["dump1090_tpu"] = None
from dump1090_tpu_torch.utils.synth import planted_capture
data, planted = planted_capture(2, 20, seed=9, flip_weights=(1.0,))
open({str(path)!r}, "wb").write(data)
from dump1090_tpu_torch.parallel import multihost_worker
worker = io.StringIO()
with contextlib.redirect_stdout(worker):
    assert multihost_worker.main(["0", "1", "0", "--local-shards", "4", "--dp", "2",
                                  "--device", "cpu"]) == 0
assert "MULTIHOST PASS: 1 processes x 4 shards, mesh dp=2 sp=2" in worker.getvalue()
from dump1090_tpu_torch import cli
out = io.BytesIO()
text = io.TextIOWrapper(out, encoding="utf-8", write_through=True)
with contextlib.redirect_stdout(text):
    assert cli.main(["--device", "cpu", "--tpu-shard-time", "4", "--ifile", {str(path)!r},
                     "--raw"]) == 0
want = b"".join(b"*" + c.hex().encode() + b";\\n" for _, _, c, _ in planted)
assert out.getvalue() == want, (out.getvalue(), want)
assert not any(m == "jax" or m.startswith(("jax.", "dump1090_tpu."))
               for m, v in sys.modules.items() if v is not None)
print("ok", len(planted))
"""
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                       env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.strip() == "ok 40"


def test_entry_points_refuse_cpu_fallback_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the no-card refusal cannot be shown")
    from dump1090_tpu_torch.models.pipeline import DemodPipeline

    with pytest.raises(RuntimeError, match="no CUDA device"):
        DemodPipeline()
    from dump1090_tpu_torch import decode_capture, decode_captures

    with pytest.raises(RuntimeError, match="no CUDA device"):
        decode_captures([b"\x7f" * 1000])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        decode_capture(b"\x7f" * 1000)
    with pytest.raises(RuntimeError, match="no CUDA device"):  # the host strategy
        decode_captures([b"\x7f" * 1000], device_resolve=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        decode_capture(b"\x7f" * 1000, device_resolve=False)
    # bulk path, hub path, and the host-resolve and --debug paths
    for flags in (["--raw"], [], ["--onlyaddr", "--net"], ["--raw", "--tpu-device-resolve", "off"],
                  ["--debug", "D"]):
        r = subprocess.run(
            [sys.executable, "-m", "dump1090_tpu_torch", "--ifile",
             str(REPO / "tests" / "golden" / "debug_p_input.bin"), *flags],
            cwd=REPO, capture_output=True,
        )
        assert r.returncode == 1 and b"no CUDA device" in r.stderr and r.stdout == b""
    # the time-sharded decode: the card is asked for before the mesh
    from dump1090_tpu_torch import decode_capture_sharded

    with pytest.raises(RuntimeError, match="no CUDA device"):
        decode_capture_sharded(b"\x7f" * 1000, sp=2)
    r = subprocess.run(
        [sys.executable, "-m", "dump1090_tpu_torch", "--ifile",
         str(REPO / "tests" / "golden" / "debug_p_input.bin"), "--raw", "--tpu-shard-time", "2"],
        cwd=REPO, capture_output=True,
    )
    assert r.returncode == 1 and b"no CUDA device" in r.stderr and r.stdout == b""
    r = subprocess.run(
        [sys.executable, "-m", "dump1090_tpu_torch.parallel.multihost_worker", "0", "1", "0"],
        cwd=REPO, capture_output=True,
    )
    assert r.returncode != 0 and b"no CUDA device" in r.stderr and r.stdout == b""
    # live input (no --ifile): the card is asked for before the radio
    r = subprocess.run([sys.executable, "-m", "dump1090_tpu_torch", "--raw"], cwd=REPO,
                       capture_output=True)
    assert r.returncode == 1 and b"no CUDA device" in r.stderr and r.stdout == b""
    # every tool that decodes IQ: the card is asked for before any work
    flags = {"fuzz_diff": ["--n", "1"], "soak_device": ["--wall-minutes", "1"],
             "net_capture": ["--ours", "--iq", "x", "--out-raw", "y", "--out-sbs", "z"],
             "measure": ["--probe", "link"], "exp_demod_front": ["--check"]}
    procs = {t: subprocess.Popen([sys.executable, "-m", f"dump1090_tpu_torch.tools.{t}",
                                  *flags.get(t, [])], cwd=REPO, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE) for t in CARD_TOOLS + MEASURE_TOOLS}
    for tool, p in procs.items():
        out, err = p.communicate(timeout=120)
        assert p.returncode != 0 and b"no CUDA device" in err and out == b"", tool


def test_tools_run_with_jax_and_the_jax_tools_unimportable(tmp_path):
    """The sweep, the CPR vectors, the hex stream, the benchmark, a probe and
    the front A/B of the tools run on --device cpu with jax, the JAX package
    and every JAX tool's module name (the root's bench.py among them) made
    unimportable, and none of them enters sys.modules."""
    jax_tools = sorted(p.stem for p in (REPO / "tools").glob("*.py")) + ["bench"]
    air = tmp_path / "air.bin"
    code = f"""
import contextlib, io, json, sys
for name in ["jax", "dump1090_tpu", *{jax_tools!r}]:
    sys.modules[name] = None
from dump1090_tpu_torch.tools import (bench, exp_demod_front, fuzz_hex, gen_cpr_vectors,
                                      http_diff, measure, net_capture, netdebug_diff,
                                      refbuild, snr_sweep, sweep_hex)
from dump1090_tpu_torch.utils.synth import planted_capture
open({str(air)!r}, "wb").write(planted_capture(1, 20, seed=3)[0])
small = ["--device", "cpu", "--input", {str(air)!r}, "--nb", "1", "--loops", "1"]
out = io.StringIO()
with contextlib.redirect_stdout(out):
    assert snr_sweep.main(["--device", "cpu", "--frames", "10", "--snrs", "20"]) == 0
    assert gen_cpr_vectors.main([]) == 0
    assert bench.main(small + ["--g", "1", "--w", "1", "--t", "1", "--cold-mb", "0"]) == 0
    assert measure.main(small + ["--probe", "steady", "--g", "1", "--t", "1"]) == 0
    assert exp_demod_front.main(small + ["--check"]) == 0
assert "| 20 | 100.0% | 100.0% |" in out.getvalue(), out.getvalue()
assert out.getvalue().count("\\nA ") > 1000
recs = [json.loads(ln) for ln in out.getvalue().splitlines() if ln.startswith("{{")]
assert [r.get("metric") or r.get("probe") or r.get("tool") for r in recs] \\
    == ["sustained_e2e", "steady", "exp_demod_front"], recs
assert all(r["device"]["platform"] == "cpu" for r in recs)
import numpy as np
assert fuzz_hex.gen_stream(np.random.default_rng(0), 50).count(b"\\n") >= 50
assert len(sweep_hex.SWEEPS) == 9 and http_diff.scenario()
assert not any(m in {jax_tools!r} or m == "jax" or m.startswith(("jax.", "dump1090_tpu."))
               for m, v in sys.modules.items() if v is not None)
print("ok")
"""
    env = dict(os.environ, DUMP1090_REF_SRC=str(tmp_path / "no_reference"))
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                       env=env)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.strip() == "ok"
    assert "reference column skipped" in r.stderr
