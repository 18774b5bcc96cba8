"""The port's multi-process session (dump1090_tpu_torch/parallel/multihost.py
and multihost_worker.py) on the CPU: the launcher variables, the global
mesh, the timeline's placement, the sharded candidates against the JAX
package's multihost helpers, and a real two-process run over gloo in which
the time axis crosses the process boundary (each process holds 4 shards of
a global (1, 8) mesh; rank 0 checks the all-gathered candidates against an
unsharded scan and prints MULTIHOST PASS), once more with --bench over a
65,536-sample timeline (rank 0 prints MULTIHOST BENCH).  The worker's
flags against the JAX tools/multihost_worker.py: --devices-per-proc is
--local-shards, and over the capture $DUMP1090_FIXTURE names both workers
find the same candidates and print the same BENCH fields.  Tolerance:
exact equality."""

import os
import re
import socket
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from dump1090_tpu.parallel import multihost as jmh
from dump1090_tpu.parallel.sharding import make_sharded_demod as jax_sharded_demod
from dump1090_tpu_torch.parallel import multihost
from dump1090_tpu_torch.parallel.sharding import make_sharded_demod

REPO = Path(__file__).resolve().parent.parent
LAUNCHER = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_initialize_from_env_is_false_without_launcher_variables(monkeypatch):
    for name in LAUNCHER:
        monkeypatch.delenv(name, raising=False)
    assert multihost.initialize_from_env() is False
    assert multihost.initialize_from_env("cpu") is False
    monkeypatch.setenv("WORLD_SIZE", "1")  # one process: no session either
    assert multihost.initialize_from_env("cpu") is False


def test_global_mesh_and_shard_timeline_single_process():
    mesh = multihost.global_mesh(dp=2, sp=4, device="cpu")
    assert mesh.shape == {"dp": 2, "sp": 4} and not mesh.multiprocess
    assert len(mesh.local()) == 8
    with pytest.raises(ValueError, match="dp\\*sp"):
        multihost.global_mesh(dp=3, sp=4, device="cpu", local_shards=8)

    shard = 1024
    rng = np.random.default_rng(0)
    mag = rng.integers(0, 60000, (2, 4 * shard), dtype=np.int32)
    x = multihost.shard_timeline(mag, mesh)
    assert sorted(x.blocks) == [(d, s) for d in range(2) for s in range(4)] and x.rows == 1
    cand = make_sharded_demod(mesh, shard_samples=shard, max_candidates=64)(x)
    assert cand.pos.shape == (2, 4 * 64)

    # the JAX package's helpers on its 8 virtual CPU devices give the same
    jmesh = jmh.global_mesh(dp=2, sp=4)
    want = jax.device_get(jax_sharded_demod(jmesh, shard_samples=shard, max_candidates=64)(
        jmh.shard_timeline(mag, jmesh)))
    for name, g, w in zip(cand._fields, cand, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)


WORKER = [sys.executable, "-m", "dump1090_tpu_torch.parallel.multihost_worker"]


def _two_processes(*flags: str) -> list:
    """Both ranks of a real two-process gloo session, 4 shards each:
    [(rc, stdout, stderr)] by rank."""
    port = str(_free_port())
    # one compute thread a process: the test workers beside it keep theirs
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [
        subprocess.Popen([*WORKER, str(rank), "2", port, "--device", "cpu", *flags],
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=REPO,
                         env=env)
        for rank in (0, 1)
    ]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=120)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            p.kill()
    for rc, out, err in outs:
        assert rc == 0, f"worker failed rc={rc}\nstdout:\n{out}\nstderr:\n{err}"
    return outs


def test_two_process_gloo_decode():
    outs = _two_processes("--local-shards", "4")
    assert "MULTIHOST PASS: 2 processes x 4 shards, mesh dp=1 sp=8 on cpu" in outs[0][1]
    assert outs[1][1] == ""


def test_two_process_gloo_bench():
    """--bench: every rank runs the step, rank 0 alone prints the time."""
    outs = _two_processes("--devices-per-proc", "4", "--bench", "--steps", "2",
                          "--total", "65536")
    out = outs[0][1]
    assert "MULTIHOST PASS: 2 processes x 4 shards, mesh dp=1 sp=8 on cpu" in out
    m = re.search(r"^MULTIHOST BENCH ([0-9.]+) s/step total=65536 sp=8 nproc=2$", out, re.M)
    assert m and float(m.group(1)) > 0, out
    assert outs[1][1] == ""


def _run_worker(argv: list, env: dict) -> str:
    r = subprocess.run(argv, capture_output=True, text=True, cwd=REPO, timeout=180,
                       env=dict(os.environ, OMP_NUM_THREADS="1", **env))
    assert r.returncode == 0, r.stdout + r.stderr[-3000:]
    return r.stdout


def test_devices_per_proc_is_local_shards(monkeypatch, capsys):
    """The JAX name and the port's older one set the same shards; at world
    size 1 on the CPU the two runs print the same line."""
    from dump1090_tpu_torch.parallel import multihost_worker

    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.setenv(k, "")  # the worker sets them; put back after
    monkeypatch.setenv("DUMP1090_FIXTURE", str(REPO / "no-such-capture.bin"))
    lines = []
    for flag in ("--devices-per-proc", "--local-shards"):
        assert multihost_worker.main(["0", "1", "0", flag, "4", "--device", "cpu",
                                      "--total", "32768"]) == 0
        lines.append(capsys.readouterr().out)
    assert lines[0] == lines[1]
    assert "MULTIHOST PASS: 1 processes x 4 shards, mesh dp=1 sp=4 on cpu" in lines[0]


def test_fixture_and_bench_equal_the_jax_worker(tmp_path):
    """Over the capture $DUMP1090_FIXTURE names (its first buffer, tiled to
    --total), the port's worker finds the JAX worker's candidates and prints
    its BENCH fields; a missing file leaves the planted buffer."""
    from dump1090_tpu_torch.utils.synth import planted_capture

    fixture = tmp_path / "fixture.bin"
    fixture.write_bytes(planted_capture(1, 40, seed=7, noise_sigma=3.0)[0])
    flags = ["--devices-per-proc", "4", "--bench", "--steps", "2", "--total", "65536"]
    jax_out = _run_worker([sys.executable, str(REPO / "tools" / "multihost_worker.py"), "0",
                           "1", str(_free_port()), *flags],
                          {"JAX_PLATFORMS": "cpu", "DUMP1090_FIXTURE": str(fixture)})
    outs = {name: _run_worker([*WORKER, "0", "1", str(_free_port()), "--device", "cpu", *flags],
                              {"DUMP1090_FIXTURE": str(path)})
            for name, path in (("fixture", fixture), ("planted", tmp_path / "missing.bin"))}

    def candidates(out: str) -> int:
        m = re.search(r"MULTIHOST PASS: .* (\d+) candidates == unsharded (\d+)", out)
        assert m and m.group(1) == m.group(2), out
        return int(m.group(1))

    def bench_fields(out: str) -> str:
        m = re.search(r"^MULTIHOST BENCH [0-9.]+ s/step (.*)$", out, re.M)
        assert m, out
        return m.group(1)

    assert candidates(outs["fixture"]) == candidates(jax_out)
    assert candidates(outs["planted"]) != candidates(jax_out)
    assert bench_fields(outs["fixture"]) == bench_fields(jax_out) == "total=65536 sp=4 nproc=1"
