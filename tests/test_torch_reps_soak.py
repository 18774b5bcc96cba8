"""The port's fixed-reps soak (dump1090_tpu_torch/tools/soak_device.py, the
default mode: a capture tiled --reps times, decoded cold and warm through
stream_raw_device, byte-compared with an oracle's --raw run) on the CPU,
with the JAX package's CLI as the oracle (JAX on the CPU, its native
runtime a private copy): a planted capture passes, an oracle that drops one
line fails at that line, and a missing input is an error that names it.
Tolerance: exact equality."""

import concurrent.futures
import os
import shlex
import subprocess
import sys
from pathlib import Path

import pytest

from dump1090_tpu_torch.tools import soak_device as tsoak
from dump1090_tpu_torch.utils.synth import planted_capture
from test_torch_native import JAX_MAIN, jax_native  # noqa: F401  (a fixture)

REPO = Path(__file__).resolve().parent.parent
DROP_LINE = 7  # the oracle wrapper's missing line

# an oracle wrapper: runs the command in its arguments and drops one line
# of its stdout
DROPPER = f"""\
import subprocess, sys
lines = subprocess.run(sys.argv[1:], check=True, capture_output=True).stdout.splitlines(True)
sys.stdout.buffer.write(b"".join(lines[:{DROP_LINE}] + lines[{DROP_LINE + 1}:]))
"""


def _soak(argv: list, env: dict) -> subprocess.CompletedProcess:
    return subprocess.run(
        [sys.executable, "-m", "dump1090_tpu_torch.tools.soak_device", "--device", "cpu", *argv],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600)


def test_reps_soak_passes_against_the_jax_cli_and_fails_on_a_dropped_line(tmp_path, jax_native):
    """3 reps of 2 planted blocks in 2-buffer batches, 2 a group (so the
    ICAO cache chains across dispatches): SOAK PASS against the JAX CLI,
    exit 0; the same oracle with one line dropped: SOAK FAIL at that line,
    exit 1."""
    data, _ = planted_capture(2, 40, seed=5)
    capture = tmp_path / "planted.bin"
    capture.write_bytes(data)
    (tmp_path / "drop_line.py").write_text(DROPPER)
    jax_cli = [sys.executable, *JAX_MAIN, "--tpu-backend", "cpu"]
    refs = {"jax": shlex.join(jax_cli),
            "dropped": shlex.join([sys.executable, str(tmp_path / "drop_line.py"), *jax_cli])}
    xla = os.environ.get("XLA_FLAGS", "") + " --xla_cpu_multi_thread_eigen=false"
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1", XLA_FLAGS=xla.strip(),
               JAX_COMPILATION_CACHE_DIR=str(tmp_path / "jaxcache"))
    argv = ["--reps", "3", "--input", str(capture), "--batch", "2", "--groups", "2"]
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        runs = {k: pool.submit(_soak, [*argv, "--ref", ref], env) for k, ref in refs.items()}
        runs = {k: f.result() for k, f in runs.items()}
    ok, bad = runs["jax"], runs["dropped"]
    assert ok.returncode == 0, ok.stdout + ok.stderr[-3000:]
    assert "SOAK PASS" in ok.stdout and "SOAK FAIL" not in ok.stdout
    n = int(ok.stdout.split("SOAK PASS: ")[1].split()[0])
    assert n > DROP_LINE + 50  # 3 x 2 blocks of 40 planted frames, most decoded
    assert "warm pass:" in ok.stderr and "Msamples/s on the CPU" in ok.stderr
    assert bad.returncode == 1, bad.stdout + bad.stderr[-3000:]
    assert f"SOAK FAIL at line {DROP_LINE}:" in bad.stdout
    assert f"SOAK FAIL: ours {n} ref {n - 1} lines" in bad.stdout


def test_reps_soak_without_its_input_names_the_missing_path(tmp_path, monkeypatch, capsys):
    """No --input and no reference capture in the repository, or a named
    input that does not exist: exit 1 with the path on stderr, before any
    oracle is looked for or decode is run (never a fall back to synthetic
    air)."""
    missing = tmp_path / "reference" / "testfiles" / "modes1.bin"
    monkeypatch.setattr(tsoak, "REFERENCE_CAPTURE", missing)

    def no_oracle(ref):
        raise AssertionError("the oracle was looked for")

    monkeypatch.setattr("dump1090_tpu_torch.tools.refbuild.reference_command", no_oracle)
    for argv in ([], ["--input", str(tmp_path / "nothing.bin")]):
        assert tsoak.main(["--device", "cpu", "--reps", "1", *argv]) == 1
        err = capsys.readouterr().err
        assert str(missing if not argv else tmp_path / "nothing.bin") in err


def test_reps_soak_is_the_default_mode_at_the_jax_tools_shapes():
    """With no wall-clock option the tool runs the fixed-reps soak, with
    the JAX tool's defaults: 60 reps, 16-buffer batches, 8 a group."""
    args = tsoak.parser().parse_args([])
    assert (args.reps, args.batch, args.ref, args.input) == (60, 16, None, None)
    assert args.groups == 8
    assert tsoak.REFERENCE_CAPTURE == REPO / "reference" / "testfiles" / "modes1.bin"
