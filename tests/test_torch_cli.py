"""`python -m dump1090_tpu_torch --device cpu` against `python -m dump1090_tpu
--tpu-backend cpu --tpu-device-resolve on`: stdout byte-equal for --raw and
--stats, at the CLI's own file-decode defaults (64-buffer batches, 8 batches
per group), on the committed golden input and on a seeded synthetic capture
with fixed frames.  Only stdout is compared: the throughput meter goes to
stderr."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

from dump1090_tpu_torch.utils.synth import planted_capture

REPO = Path(__file__).resolve().parent.parent
FLAGS = ("--raw", "--stats")


def _run_all(path: Path, cache_dir: Path) -> dict:
    """Both CLIs, both flags, started together; returns stdout by key."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", JAX_COMPILATION_CACHE_DIR=str(cache_dir))
    cmds = {}
    for flag in FLAGS:
        cmds[("jax", flag)] = [sys.executable, "-m", "dump1090_tpu", "--tpu-backend", "cpu",
                               "--tpu-device-resolve", "on", "--ifile", str(path), flag]
        cmds[("port", flag)] = [sys.executable, "-m", "dump1090_tpu_torch", "--device", "cpu",
                                "--ifile", str(path), flag]
    procs = {
        k: subprocess.Popen(c, cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE)
        for k, c in cmds.items()
    }
    out = {}
    for k, p in procs.items():
        stdout, stderr = p.communicate(timeout=300)
        assert p.returncode == 0, (k, stderr.decode()[-2000:])
        out[k] = stdout
    return out


@pytest.fixture(scope="module")
def outputs(tmp_path_factory, golden_dir):
    tmp = tmp_path_factory.mktemp("cli")
    synth = tmp / "synth.bin"
    data, planted = planted_capture(4, 40, seed=3, flip_weights=(0.7, 0.2, 0.1))
    synth.write_bytes(data)
    return {
        "golden": _run_all(golden_dir / "debug_p_input.bin", tmp / "jaxcache"),
        "synth": _run_all(synth, tmp / "jaxcache"),
    }


@pytest.mark.parametrize("flag", FLAGS)
@pytest.mark.parametrize("name", ["golden", "synth"])
def test_cli_stdout_equals_jax_cli(outputs, name, flag):
    got = outputs[name][("port", flag)]
    want = outputs[name][("jax", flag)]
    assert got == want
    if flag == "--raw":
        lines = got.split()
        assert len(lines) == (1 if name == "golden" else len(lines))
        if name == "synth":
            assert len(lines) >= 100
    else:
        fixed = int(got.decode().splitlines()[5].split()[0])
        assert fixed > 0 if name == "synth" else fixed == 0


def test_cli_refuses_what_is_not_ported(capsys):
    from dump1090_tpu_torch.cli import parse_args

    for args in (["--ifile", "x.bin", "--raw", "--net"],
                 ["--ifile", "x.bin", "--raw", "--debug", "d"],
                 ["--ifile", "x.bin"]):  # the verbose display
        with pytest.raises(SystemExit) as e:
            parse_args(args)
        assert e.value.code == 2
        out, err = capsys.readouterr()
        assert "not yet ported" in err and out == ""
    with pytest.raises(SystemExit) as e:
        parse_args(["--bogus"])
    assert e.value.code == 1
    assert "Unknown or not enough arguments" in capsys.readouterr().err
