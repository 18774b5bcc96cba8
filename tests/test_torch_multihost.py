"""The port's multi-process session (dump1090_tpu_torch/parallel/multihost.py
and multihost_worker.py) on the CPU: the launcher variables, the global
mesh, the timeline's placement, the sharded candidates against the JAX
package's multihost helpers, and a real two-process run over gloo in which
the time axis crosses the process boundary (each process holds 4 shards of
a global (1, 8) mesh; rank 0 checks the all-gathered candidates against an
unsharded scan and prints MULTIHOST PASS).  Tolerance: exact equality."""

import os
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


def test_two_process_gloo_decode():
    port = str(_free_port())
    worker = [sys.executable, "-m", "dump1090_tpu_torch.parallel.multihost_worker"]
    # one compute thread a process: the test workers beside it keep theirs
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [
        subprocess.Popen([*worker, str(rank), "2", port, "--local-shards", "4",
                          "--device", "cpu"],
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
    assert "MULTIHOST PASS: 2 processes x 4 shards, mesh dp=1 sp=8 on cpu" in outs[0][1]
    assert outs[1][1] == ""
