"""The port's --debug dumps (utils/debug.py, the Python resolver's dump
sites, the CLI's --debug routing) on the CPU: `--debug p`, `C` and `D` on
the committed debug_p_input.bin byte-equal to the reference binary's own
output (the three goldens), and `c`, `d`, `Dj` and `p` byte-equal to the
JAX CLI on synthetic traffic, stdout and frames.js alike.  Also the dump
formatters against the JAX package's, and the flag parsing."""

import io
import time

import numpy as np
import pytest

from test_torch_cli import _main_inprocess

import dump1090_tpu.cli as jcli
import dump1090_tpu.utils.debug as jdbg
import dump1090_tpu_torch.cli as tcli
import dump1090_tpu_torch.utils.debug as tdbg
from dump1090_tpu_torch.utils.synth import traffic_capture, traffic_frames

NOW = 1_700_000_000.0


@pytest.fixture
def cli_env(monkeypatch, tmp_path):
    """Both CLIs in this process: the clock frozen, frames.js written in a
    fresh directory, and the JAX compilation cache kept under tmp_path."""
    monkeypatch.setattr(time, "time", lambda: NOW)
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "jaxcache"))
    work = tmp_path / "work"
    work.mkdir()
    monkeypatch.chdir(work)
    return work


def test_dump_formatters_match_jax():
    rng = np.random.default_rng(3)
    for index in range(-6, 240):
        for mag in (0, 25, 255, 256, 1080, int(rng.integers(0, 65168))):
            assert tdbg.dump_magnitude_bar(index, mag) == jdbg.dump_magnitude_bar(index, mag)
    m = rng.integers(0, 65168, 4000).astype(np.int32)
    for frame, _ in traffic_frames(9, 60):
        msg = np.zeros(14, np.uint8)
        msg[: len(frame)] = np.frombuffer(frame, np.uint8)
        for offset in (0, 3, 700):
            got, want = io.StringIO(), io.StringIO()
            tdbg.dump_raw_message("descr", msg, m, offset, out=got)
            jdbg.dump_raw_message("descr", msg, m, offset, out=want)
            assert got.getvalue() == want.getvalue()
    assert tdbg.DebugFlags.parse("dDcCpnj") == tdbg.DebugFlags(*[True] * 7)
    assert not tdbg.DebugFlags.parse("n").any_demod_dump
    assert tdbg.DEBUG_NOPREAMBLE_LEVEL == jdbg.DEBUG_NOPREAMBLE_LEVEL == 25


@pytest.mark.parametrize("flag,golden", [("p", "golden_debug_p.txt"),
                                         ("C", "golden_debug_C_synth.txt"),
                                         ("D", "golden_debug_D_synth.txt")])
def test_cli_debug_equals_reference_golden(cli_env, golden_dir, flag, golden):
    """The reference binary's own --debug output on the committed input."""
    got = _main_inprocess(tcli.main, ["--device", "cpu", "--ifile",
                                      str(golden_dir / "debug_p_input.bin"), "--debug", flag])
    assert got == (golden_dir / golden).read_bytes()


@pytest.mark.parametrize("flags", ["c", "d", "Dj", "p"])
def test_cli_debug_equals_jax_cli(cli_env, flags):
    """Mixed traffic with weak, flipped and demod-error frames over noise
    (for p, no noise and two frames a block, the first with its first bit
    silenced: p dumps each rejected position above the noise floor that no
    decoded frame covers, and the first dump of a buffer prints the last
    message sliced in the buffer before)."""
    if flags == "p":
        data, _ = traffic_capture(2, 2, seed=17, noise_sigma=0.0, blank_every=2)
    else:
        data, _ = traffic_capture(3, 150, seed=17, blank_every=9)
    path = cli_env / "cap.bin"
    path.write_bytes(data)
    args = ["--ifile", str(path), "--debug", flags]
    got = _main_inprocess(tcli.main, ["--device", "cpu", *args])
    frames = path.with_name("frames.js")
    got_js = frames.read_bytes() if frames.exists() else None
    if got_js is not None:
        frames.unlink()
    want = _main_inprocess(jcli.main, ["--tpu-backend", "cpu", *args])
    want_js = frames.read_bytes() if frames.exists() else None
    assert got == want and got_js == want_js
    marker = {"c": b"--- Decoded with bad CRC", "d": b"--- Demodulated with errors",
              "p": b"--- Unexpected ratio among first 10 samples"}
    if flags == "Dj":
        assert got_js.count(b"frames.push(") > 300 and b"--- " not in got
        assert got.count(b"CRC: ") > 300  # the verbose display stays on stdout
    else:
        assert got.count(marker[flags]) > (2 if flags == "p" else 20)


def test_unknown_debug_flag(capsys):
    with pytest.raises(SystemExit) as e:
        tcli.parse_args(["--ifile", "x.bin", "--debug", "Dx"])
    assert e.value.code == 1
    assert capsys.readouterr().err == "Unknown debugging flag: x\n"
    assert tcli.parse_args(["--ifile", "x.bin", "--debug", "dDcCpnj"]).debug == "dDcCpnj"
