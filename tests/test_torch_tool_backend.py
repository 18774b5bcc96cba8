"""`--backend`, the JAX tools' name for the device, in the port's fuzz_diff,
snr_sweep and soak_device: `--backend cpu` runs the tool exactly as
`--device cpu` does (the same stdout on a small seeded run of each);
cuda, gpu and auto name the card; tpu, or a --backend that contradicts
--device, exits 2 before any work, and nothing falls back to the CPU
(with no card, cuda raises).  Runs on the CPU."""

import contextlib
import io
import shlex
import sys

import numpy as np
import pytest
import torch

from dump1090_tpu_torch import tools
from dump1090_tpu_torch.tools import fuzz_diff, snr_sweep, soak_device
from dump1090_tpu_torch.utils.synth import planted_capture

TOOLS = {"fuzz_diff": fuzz_diff, "snr_sweep": snr_sweep, "soak_device": soak_device}


def _small_run(name: str, tmp_path) -> list:
    """A few seconds of the tool on the CPU, without --device/--backend."""
    if name == "fuzz_diff":
        return ["--n", "3", "--seed", "3", "--mode", "device", "--out", str(tmp_path)]
    if name == "snr_sweep":
        return ["--frames", "20", "--snrs", "12,20", "--ref", str(tmp_path / "no-ref")]
    capture = tmp_path / "capture.bin"
    capture.write_bytes(planted_capture(2, 40, seed=5)[0])
    oracle = shlex.join([sys.executable, "-m", "dump1090_tpu_torch", "--device", "cpu"])
    return ["--reps", "1", "--input", str(capture), "--batch", "2", "--groups", "2",
            "--ref", oracle]


def _stdout(main, argv) -> tuple[int, str]:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, out.getvalue()


@pytest.mark.parametrize("name", sorted(TOOLS))
def test_backend_cpu_is_device_cpu(name, tmp_path):
    main = TOOLS[name].main
    argv = _small_run(name, tmp_path)
    by_backend = _stdout(main, [*argv, "--backend", "cpu"])
    by_device = _stdout(main, [*argv, "--device", "cpu"])
    assert by_backend == by_device
    assert by_backend[0] == 0 and by_backend[1], by_backend


@pytest.mark.parametrize("name", sorted(TOOLS))
@pytest.mark.parametrize("argv", [["--backend", "tpu"], ["--backend", "cpu", "--device", "cuda"],
                                  ["--backend", "gpu", "--device", "cpu"]])
def test_backend_refuses_what_it_cannot_run(name, argv, capsys):
    with pytest.raises(SystemExit) as e:
        TOOLS[name].main(argv)
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert "--backend" in err
    if argv[1] == "tpu":
        assert "not 'tpu'" in err and all(b in err for b in tools.BACKENDS)


@pytest.mark.parametrize("name", sorted(TOOLS))
@pytest.mark.parametrize("backend", ["cuda", "gpu", "auto"])
def test_backend_names_the_card_and_never_falls_back(name, backend, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TOOLS[name].main(["--backend", backend])


def test_device_option_resolves_both_spellings():
    ap = soak_device.parser()
    for argv, want in ([[], "cuda"], [["--backend", "cpu"], "cpu"], [["--backend", "gpu"], "cuda"],
                       [["--backend", "auto"], "cuda"], [["--device", "cpu"], "cpu"],
                       [["--device", "cuda:0", "--backend", "cuda"], "cuda:0"],
                       [["--device", "cpu", "--backend", "cpu"], "cpu"]):
        assert tools.device_option(ap, ap.parse_args(argv)) == want, argv
    assert np.array_equal(list(tools.BACKENDS), ["cpu", "cuda", "gpu", "auto"])
