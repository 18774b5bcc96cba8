"""The port's differential fuzz (dump1090_tpu_torch/tools/fuzz_diff.py)
against the JAX package's tools/fuzz_diff.py, imported read-only, on the
CPU: random_stream gives the JAX tool's bytes for the same seed, across all
six recipes, and after the six recipe streams that come first; decode_ours on
`device="cpu"` equals the JAX decode_ours in the modes raw (the host
resolve, against the JAX native runtime), device and device-aggressive on
one stream of each recipe, and in sharded-device (a (1, 4) mesh of the CPU
against JAX's virtual devices) and device-verbose (the CLI) on one.  The
tool's entry point compares a device with the CPU, saves nothing when all
agree, and refuses to run without a card unless the CPU is named; its
in-process CLI run leaves the process's SIGPIPE handler as it found it.
Tolerance: exact equality."""

import io
import signal
import sys
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import pytest
import torch

from dump1090_tpu_torch.constants import DATA_LEN_BYTES
from dump1090_tpu_torch.tools import fuzz_diff as tfuzz
# jax_native: JAX's raw mode resolves with its native runtime, a private copy
from test_torch_native import jax_native  # noqa: F401  (a fixture)

REPO = Path(__file__).resolve().parent.parent
SEED = 1  # its recipe streams 0-5: 2, 1, 2, 1, 2 and 2 buffers; recipes 2-4 decode frames


@pytest.fixture(scope="module")
def jfuzz():
    """The JAX package's fuzz tool, as tests/test_synth.py imports its soak."""
    sys.path.insert(0, str(REPO / "tools"))
    import fuzz_diff

    return fuzz_diff


@pytest.fixture(scope="module")
def streams():
    """One stream of each recipe: the recipe streams 0-5 of SEED."""
    got = list(tfuzz.streams(tfuzz.RECIPES, SEED))
    assert [r for r, _ in got] == list(range(tfuzz.RECIPES))
    return [s for _, s in got]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_stream_equals_jax(jfuzz, seed):
    """Eight streams a seed, byte for byte; seeds 0-2 draw all six recipes
    (seed 2's first six streams are recipes 5, 0, 2, 3, 1, 4)."""
    r_jax, r_port = np.random.default_rng(seed), np.random.default_rng(seed)
    recipes = []
    for _ in range(8):
        want = jfuzz.random_stream(r_jax)
        recipe, got = tfuzz._random_stream(r_port)
        assert got.dtype == np.uint8 and len(got) % DATA_LEN_BYTES == 0
        np.testing.assert_array_equal(got, want)
        recipes.append(recipe)
    if seed == 2:
        assert sorted(set(recipes[:6])) == list(range(6))


def test_recipe_streams_come_before_the_jax_streams(jfuzz):
    """Six streams of recipes 0-5 come first and the JAX tool's streams
    0, 1, ... of the seed follow, byte for byte."""
    got = list(tfuzz.streams(9, SEED))
    assert [r for r, _ in got[:6]] == list(range(6))
    rng = np.random.default_rng(SEED)
    for _, stream in got[6:]:
        np.testing.assert_array_equal(stream, jfuzz.random_stream(rng))


@pytest.mark.parametrize("mode", ["raw", "device", "device-aggressive"])
@pytest.mark.parametrize("recipe", range(6))
def test_decode_ours_equals_jax(streams, jfuzz, recipe, mode, request):
    if mode == "raw":
        request.getfixturevalue("jax_native")
    want = jfuzz.decode_ours(streams[recipe], mode)
    got = tfuzz.decode_ours(streams[recipe], mode, "cpu")
    assert got == want
    if recipe in (2, 3, 4):
        assert got and all(x.startswith("*") and x.endswith(";") for x in got)


def test_sharded_device_equals_jax(streams, jfuzz):
    """The port's (1, 4) CPU mesh against the JAX tool's default mesh (the
    8 virtual CPU devices of conftest), on the recipe-2 stream."""
    want = jfuzz.decode_ours(streams[2], "sharded-device")
    got = tfuzz.decode_ours(streams[2], "sharded-device", "cpu")
    assert got == want and len(got) > 10


def test_device_verbose_equals_jax(streams, jfuzz):
    """The CLI's display with the device resolver: the port's subprocess and
    its in-process run against the JAX tool's subprocess."""
    want = jfuzz.decode_ours(streams[3], "device-verbose")
    assert tfuzz.decode_ours(streams[3], "device-verbose", "cpu") == want
    assert tfuzz.decode_ours(streams[3], "device-verbose", "cpu", in_process=True) == want
    assert any(line.startswith("*") for line in want)


def test_in_process_cli_puts_the_signal_handlers_back(streams):
    """cli.main sets SIGPIPE to SIG_DFL for its own process; the in-process
    run must put it back, or the caller dies at its next write to a closed
    socket."""
    before = signal.getsignal(signal.SIGPIPE)
    assert tfuzz.decode_ours(streams[3], "device-verbose", "cpu", in_process=True)
    assert signal.getsignal(signal.SIGPIPE) == before != signal.SIG_DFL


def test_main_compares_with_the_cpu(tmp_path):
    """The entry point on --device cpu: six streams covering the recipes,
    all equal, nothing saved, a summary line, exit 0."""
    out = io.StringIO()
    with redirect_stdout(out):
        rc = tfuzz.main(["--device", "cpu", "--n", "6", "--seed", str(SEED), "--mode", "device",
                         "--out", str(tmp_path)])
    assert rc == 0, out.getvalue()
    assert "6/6 stream-modes identical" in out.getvalue()
    assert "{0: 1, 1: 1, 2: 1, 3: 1, 4: 1, 5: 1}" in out.getvalue()
    assert not list(tmp_path.iterdir())


def test_fuzz_reports_and_saves_a_mismatch(tmp_path, monkeypatch):
    """A decode on the device that differs from the CPU's is a finding: the
    stream is saved under the output directory and the mode is listed."""
    real = tfuzz.decode_ours

    def decode(stream, mode, device="cuda", **kw):
        got = real(stream, mode, "cpu", **kw)
        return got[:-1] if device == "card" else got  # the "card" loses its last line

    monkeypatch.setattr(tfuzz, "decode_ours", decode)
    res = tfuzz.fuzz(3, SEED, ["device"], "card", out_dir=tmp_path,
                     log=lambda *_: None)
    assert res["fails"] == [(2, "device")]
    saved = tmp_path / f"fuzz_fail_{SEED}_2_device.bin"
    assert saved.stat().st_size == 2 * DATA_LEN_BYTES


def test_refuses_to_run_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tfuzz.main(["--n", "1"])
