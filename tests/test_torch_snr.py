"""The port's sensitivity sweep (dump1090_tpu_torch/tools/snr_sweep.py)
against the JAX package's tools/snr_sweep.py, imported read-only, on the
CPU, at the decode threshold (11-13 dB, where the phase-correction retry
does real work) and at 20 dB: build_stream gives the JAX tool's bytes and
hexes for the same generator, decode_ours on `device="cpu"` recovers the
same set of frames as the JAX decode_ours with the resolver on the device
(run_device) and on the host (run, against the JAX native runtime), and
at 12 dB and below at least one planted frame comes back through the
phase-corrected pass.  The tool's entry point prints the table and refuses
to run without a card unless the CPU is named.  Tolerance: exact
equality."""

import io
import shlex
import sys
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import pytest
import torch

from dump1090_tpu_torch.tools import snr_sweep as tsnr
# jax_native: the JAX host resolve runs its native runtime, a private copy
from test_torch_native import JAX_MAIN, jax_native  # noqa: F401  (a fixture)

REPO = Path(__file__).resolve().parent.parent
SNRS = (11.0, 12.0, 13.0, 20.0)
FRAMES = 50


@pytest.fixture(scope="module")
def jsnr():
    """The JAX package's sweep tool, as tests/test_snr.py imports it."""
    sys.path.insert(0, str(REPO / "tools"))
    import snr_sweep

    return snr_sweep


def _stream(build, snr):
    """The point's stream of tests/test_snr.py's seeds."""
    return build(snr, FRAMES, np.random.default_rng(int(snr * 10) + 777))


@pytest.fixture(scope="module")
def streams():
    return {snr: _stream(tsnr.build_stream, snr) for snr in SNRS}


@pytest.mark.parametrize("snr", SNRS)
def test_build_stream_equals_jax(jsnr, streams, snr):
    want, want_hexes = _stream(jsnr.build_stream, snr)
    got, hexes = streams[snr]
    assert got.dtype == np.uint8 and len(got) % (256 * 1024) == 0
    np.testing.assert_array_equal(got, want)
    assert hexes == want_hexes and len(hexes) == FRAMES


@pytest.mark.parametrize("device_resolve", [False, True], ids=["host", "device"])
@pytest.mark.parametrize("snr", SNRS)
def test_decode_ours_equals_jax(jsnr, streams, snr, device_resolve, request):
    if not device_resolve:
        request.getfixturevalue("jax_native")
    stream, hexes = streams[snr]
    planted = set(hexes)
    corrected = set()
    got = tsnr.decode_ours(stream, device_resolve, "cpu", corrected=corrected)
    want = jsnr.decode_ours(stream, device_resolve=device_resolve)
    assert got == want
    assert corrected <= got
    found = got & planted
    if snr >= 20:
        assert len(found) == FRAMES  # clean high-SNR frames all decode
    else:
        assert 0 < len(found) < FRAMES
    if snr <= 12:
        # the threshold points exercise the phase-corrected retry
        assert corrected & planted


def test_main_prints_the_table_and_compares_columns(jax_native):
    """The entry point on --device cpu with the JAX CLI as --ref: three
    equal columns, exit 0."""
    ref = shlex.join([sys.executable, *JAX_MAIN, "--tpu-backend", "cpu"])
    out = io.StringIO()
    with redirect_stdout(out):
        rc = tsnr.main(["--device", "cpu", "--device-resolve", "--frames", "20", "--snrs",
                        "12,20", "--ref", ref])
    text = out.getvalue()
    assert rc == 0, text
    assert "| SNR (dB) | port on cpu | port on cpu | reference |" in text
    assert "| 20 | 100.0% | 100.0% | 100.0% |" in text
    assert "identical at every point (device resolve): True" in text


def test_refuses_to_run_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsnr.main(["--frames", "1", "--snrs", "20"])
