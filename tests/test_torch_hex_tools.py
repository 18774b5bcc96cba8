"""The port's differential tools for the hex input, the HTTP feed and the
--debug n log (dump1090_tpu_torch/tools/fuzz_hex.py, sweep_hex.py,
http_diff.py, netdebug_diff.py), with the port's CLI as ours and the JAX
CLI as the `--ref` oracle, on the CPU: each byte-identical (the SBS
streams with their MSG,3 positions canonicalized).  Also: gen_stream,
the sweeps' streams, the HTTP scenario and gen_cpr_vectors give the JAX
tools' bytes and lines (tools/*.py, imported read-only);
fuzz_diff.py --ref, with the JAX CLI as the oracle, passes on 4 streams
and finds a planted difference; refbuild.ensure_reference exits with its
instruction when the reference's source is missing and returns a
stand-in that is already executable; the tools that do no device work run
without a card.  Tolerance: exact equality."""

import concurrent.futures
import io
import os
import shlex
import subprocess
import sys
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import pytest
import torch

from dump1090_tpu_torch.tools import fuzz_diff as tfuzz
from dump1090_tpu_torch.tools import fuzz_hex, gen_cpr_vectors, http_diff, net_capture
from dump1090_tpu_torch.tools import netdebug_diff, refbuild, sweep_hex
# jax_native: the JAX CLI resolves with its native runtime, a private copy
from test_torch_native import JAX_MAIN, jax_native  # noqa: F401  (a fixture)

REPO = Path(__file__).resolve().parent.parent
# the JAX CLI as the oracle of the --net-only tools, which resolve nothing
JAX_NET = [sys.executable, "-m", "dump1090_tpu", "--tpu-backend", "cpu"]
# the port's CLI with its default device: --net-only needs no card
OURS = net_capture.ours_cmd()
SWEEPS = ("fsdr", "movement")


@pytest.fixture(scope="module")
def jtools():
    """The JAX package's tools, imported by their file names."""
    sys.path.insert(0, str(REPO / "tools"))
    import fuzz_hex as jfuzz_hex
    import gen_cpr_vectors as jgen
    import http_diff as jhttp
    import sweep_hex as jsweep

    return {"fuzz_hex": jfuzz_hex, "gen_cpr_vectors": jgen, "http_diff": jhttp,
            "sweep_hex": jsweep}


@pytest.fixture(scope="module")
def results(tmp_path_factory, jax_native):
    """Every tool run against the JAX CLI, four at a time: key -> (result,
    or None if it raised, log lines).  fuzz_diff's oracle, a file decode, is the JAX CLI on its
    native runtime: 4 streams (recipes 0-3) in two modes that share the
    oracle's flags."""
    out = tmp_path_factory.mktemp("hex_tools")
    ref = refbuild.reference_command(shlex.join([sys.executable, *JAX_MAIN, "--tpu-backend",
                                                 "cpu"]))
    runs = {("fuzz_hex", mode): lambda log, mode=mode: fuzz_hex.fuzz_round(
                JAX_NET, OURS, 0, 40, mode, out, log)
            for mode in fuzz_hex.MODE_FLAGS}
    runs.update({("sweep_hex", name): lambda log, name=name: sweep_hex.sweep(
        name, JAX_NET, OURS, out, log) for name in SWEEPS})
    runs[("http_diff",)] = lambda log: http_diff.diff(JAX_NET, OURS, log)
    runs[("netdebug_diff",)] = lambda log: netdebug_diff.diff(JAX_NET, OURS, log)
    runs[("fuzz_diff",)] = lambda log: tfuzz.fuzz(4, 1, ["device", "raw"], "cpu", out_dir=out,
                                                  ref_cmd=ref, log=log)

    def run(fn):
        log = []
        try:
            return fn(log.append), log
        except (OSError, RuntimeError, subprocess.SubprocessError) as e:
            return None, [*log, repr(e)]  # fails that run's test alone

    with pytest.MonkeyPatch.context() as mp:
        # JAX on the CPU with a compilation cache and one compute thread a
        # process, so these decoders do not crowd the other test workers
        xla = os.environ.get("XLA_FLAGS", "") + " --xla_cpu_multi_thread_eigen=false"
        mp.setenv("JAX_PLATFORMS", "cpu")
        mp.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path_factory.mktemp("jaxcache")))
        mp.setenv("OMP_NUM_THREADS", "1")
        mp.setenv("XLA_FLAGS", xla.strip())
        with concurrent.futures.ThreadPoolExecutor(4) as pool:
            futures = {k: pool.submit(run, fn) for k, fn in runs.items()}
            return {k: f.result() for k, f in futures.items()}


@pytest.mark.parametrize("mode", sorted(fuzz_hex.MODE_FLAGS))
def test_fuzz_hex_equals_jax_cli(results, mode):
    ok, log = results[("fuzz_hex", mode)]
    assert ok, log
    assert log[0].startswith("[0] ok (") and " 0 relayed" not in log[0]


@pytest.mark.parametrize("name", SWEEPS)
def test_sweep_hex_equals_jax_cli(results, name):
    ok, log = results[("sweep_hex", name)]
    assert ok, log
    assert f"[{name}] ok (512 msgs" in log[0] or f"[{name}] ok (513 msgs" in log[0]


def test_http_diff_equals_jax_cli(results):
    ok, log = results[("http_diff",)]
    assert ok, log
    assert len(log) == 2 and '"lat":10.216214' in log[0]


def test_netdebug_diff_equals_jax_cli(results):
    ok, log = results[("netdebug_diff",)]
    assert ok, log
    assert "(7 client events" in log[0]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_gen_stream_equals_jax(jtools, seed):
    want = jtools["fuzz_hex"].gen_stream(np.random.default_rng(seed), 200)
    assert fuzz_hex.gen_stream(np.random.default_rng(seed), 200) == want


@pytest.mark.parametrize("name", sorted(sweep_hex.SWEEPS))
def test_sweep_streams_equal_jax(jtools, name):
    assert sweep_hex.SWEEPS[name]() == jtools["sweep_hex"].SWEEPS[name]()


def test_http_scenario_equals_jax(jtools):
    assert http_diff.scenario() == jtools["http_diff"].scenario()


def test_gen_cpr_vectors_equals_jax(jtools):
    want = io.StringIO()
    with redirect_stdout(want):
        jtools["gen_cpr_vectors"].main()
    got = io.StringIO()
    with redirect_stdout(got):
        assert gen_cpr_vectors.main([]) == 0
    assert got.getvalue() == want.getvalue() and got.getvalue().count("\n") > 4000


def test_fuzz_diff_ref_passes_on_four_streams(results):
    """--ref with the JAX CLI: each of 4 streams in two modes equals the CPU
    run and the oracle."""
    res, log = results[("fuzz_diff",)]
    assert res is not None and res["fails"] == [], log
    assert res["streams_per_recipe"] == {0: 1, 1: 1, 2: 1, 3: 1}
    assert res["lines"]["device"] == res["lines"]["raw"] > 10


def test_fuzz_diff_main_takes_ref(monkeypatch):
    """main hands the --ref command line, split, to fuzz as the oracle, and
    says so in its summary."""
    seen = {}

    def fuzz(*a, **k):
        seen.update(k)
        return {"streams_per_recipe": {0: 1}, "lines": {"raw": 1}, "fails": []}

    monkeypatch.setattr(tfuzz, "fuzz", fuzz)
    out = io.StringIO()
    with redirect_stdout(out):
        assert tfuzz.main(["--device", "cpu", "--n", "1", "--ref", shlex.join(JAX_NET)]) == 0
    assert seen["ref_cmd"] == JAX_NET
    assert "identical on cpu and the CPU and the oracle" in out.getvalue()


def test_fuzz_diff_ref_reports_an_oracle_mismatch(tmp_path, monkeypatch):
    """An oracle that loses a line is a finding, named as the oracle's."""
    monkeypatch.setattr(tfuzz, "decode_ref",
                        lambda stream, ref_cmd, mode: tfuzz.decode_ours(stream, mode, "cpu")[:-1])
    log = []
    res = tfuzz.fuzz(3, 1, ["device"], "cpu", out_dir=tmp_path, log=log.append,
                     ref_cmd=["oracle"])
    assert res["fails"] == [(2, "device")]
    assert any("MISMATCH cpu" in m and " ref " in m for m in log)


def test_refbuild_exits_with_its_instruction(tmp_path, monkeypatch):
    monkeypatch.setenv("DUMP1090_REF_SRC", str(tmp_path / "nowhere"))
    with pytest.raises(SystemExit, match="source not found .* set DUMP1090_REF_SRC"):
        refbuild.ensure_reference(str(tmp_path / "bin" / "dump1090"))
    with pytest.raises(SystemExit, match="--ref <path-to-built-dump1090>"):
        refbuild.reference_command(str(tmp_path / "dump1090"))


def test_refbuild_returns_a_stand_in_and_commands(tmp_path, monkeypatch):
    monkeypatch.setenv("DUMP1090_REF_SRC", str(tmp_path / "nowhere"))
    stand_in = tmp_path / "dump1090"
    stand_in.write_text("#!/bin/sh\nexit 0\n")
    stand_in.chmod(0o755)
    assert refbuild.ensure_reference(str(stand_in)) == str(stand_in)
    assert refbuild.reference_command(str(stand_in)) == [str(stand_in)]
    cmd = shlex.join(JAX_NET)
    assert refbuild.reference_command(cmd) == JAX_NET
    out = io.StringIO()
    with redirect_stdout(out):
        assert refbuild.main([str(stand_in)]) == 0
    assert out.getvalue() == f"{stand_in}\n"


@pytest.mark.parametrize("tool", [fuzz_hex, sweep_hex, http_diff, netdebug_diff])
def test_net_only_tools_run_without_a_card(tool, tmp_path, monkeypatch):
    """The --net-only tools ask for no card: without one they go on to
    their oracle, and stop there only because it is missing."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("DUMP1090_REF_SRC", str(tmp_path / "nowhere"))
    with pytest.raises(SystemExit, match="source not found"):
        tool.main(["--ref", str(tmp_path / "dump1090")])


@pytest.mark.parametrize("tool", [gen_cpr_vectors, refbuild])
def test_host_tools_run_without_a_card(tool, tmp_path, monkeypatch):
    """gen_cpr_vectors and refbuild do no device work and run without a
    card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    stand_in = tmp_path / "dump1090"
    stand_in.write_text("#!/bin/sh\nexit 0\n")
    stand_in.chmod(0o755)
    out = io.StringIO()
    with redirect_stdout(out):
        assert tool.main([str(stand_in)] if tool is refbuild else []) == 0
    assert out.getvalue().count("\n") > (0 if tool is refbuild else 4000)
