"""The stdin feed, the shape of `rtl_sdr - | dump1090 --ifile - ...`, on the
CPU: `python -m dump1090_tpu_torch --device cpu --ifile -` (one buffer a
dispatch) with a synthetic capture on stdin, whose last buffer is partial,
gives the JAX CLI's stdout on the same stdin and the port's `--ifile FILE`
stdout, in --raw, --stats and the verbose display, with the resolver on
the host (the CPU's default) and on the device; cli.main reads a
swapped-in sys.stdin the same way.  And the port's net_capture tool
(dump1090_tpu_torch/tools/net_capture.py: a silence buffer, then the
capture, into `--ifile - --net`) gives, for the port's CLI, the raw-out
and canonical SBS streams that the JAX tool (tools/net_capture.py,
imported read-only) captures from the JAX CLI.  Tolerance: exact
equality."""

import concurrent.futures
import io
import os
import signal
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from dump1090_tpu_torch.tools import net_capture as tnc
from dump1090_tpu_torch.utils.synth import planted_capture
# jax_native: the JAX CLI resolves with its native runtime, a private copy
from test_torch_native import JAX_MAIN, jax_native  # noqa: F401  (a fixture)

REPO = Path(__file__).resolve().parent.parent
MODES = {"raw": ("--raw",), "stats": ("--stats",), "verbose": ()}
PORT = ("-m", "dump1090_tpu_torch", "--device", "cpu")
JAX = (*JAX_MAIN, "--tpu-backend", "cpu")
TAIL = 100_000  # bytes of a last, partial buffer: never decoded (io/sources.py)


def _env(tmp: Path) -> dict:
    """JAX on the CPU with a compilation cache, one compute thread a process."""
    xla = os.environ.get("XLA_FLAGS", "") + " --xla_cpu_multi_thread_eigen=false"
    return dict(os.environ, JAX_PLATFORMS="cpu", JAX_COMPILATION_CACHE_DIR=str(tmp),
                OMP_NUM_THREADS="1", XLA_FLAGS=xla.strip())


@pytest.fixture(scope="module")
def capture():
    data, planted = planted_capture(3, 40, seed=3, flip_weights=(0.7, 0.2, 0.1))
    return data + data[:TAIL], planted


@pytest.fixture(scope="module")
def outputs(tmp_path_factory, capture, jax_native):
    """stdout of each run by key: (who, mode), who one of "jax" (stdin),
    "port" and "port-on" (stdin, resolver on the host and on the device)
    and "file" (the port on the same bytes as a file)."""
    tmp = tmp_path_factory.mktemp("stdin")
    path = tmp / "capture.bin"
    path.write_bytes(capture[0])
    runs = {}
    for mode, flags in MODES.items():
        runs[("jax", mode)] = ((*JAX, "--tpu-device-resolve", "on", "--ifile", "-", *flags), True)
        runs[("port", mode)] = ((*PORT, "--ifile", "-", *flags), True)
        runs[("port-on", mode)] = ((*PORT, "--tpu-device-resolve", "on", "--ifile", "-",
                                    *flags), True)
        runs[("file", mode)] = ((*PORT, "--ifile", str(path), *flags), False)
    env = _env(tmp / "jaxcache")

    def run(cmd, stdin):
        r = subprocess.run([sys.executable, *cmd], input=capture[0] if stdin else None,
                           cwd=REPO, env=env, capture_output=True, timeout=300)
        assert r.returncode == 0, (cmd[-3:], r.stderr.decode()[-2000:])
        return r.stdout

    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        futures = {k: pool.submit(run, *v) for k, v in runs.items()}
        return {k: f.result() for k, f in futures.items()}


@pytest.mark.parametrize("who", ["port", "port-on", "file"])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_stdin_equals_jax_cli_and_the_file(outputs, capture, mode, who):
    got = outputs[(who, mode)]
    assert got == outputs[("jax", mode)]
    if mode == "raw":
        # the frames of the 3 whole buffers, none of the partial last one
        clean = [c for b, _, c, nflip in capture[1] if nflip == 0]
        lines = got.split()
        assert len(lines) >= len(clean) and all(b"*" + c.hex().encode() + b";" in lines
                                               for c in clean)
    elif mode == "stats":
        assert int(got.split()[0]) > 0
    else:
        assert b"CRC: " in got


def test_cli_main_reads_a_swapped_stdin(outputs, capture, monkeypatch):
    """cli.main(["--ifile", "-", "--raw"]) in this process reads
    sys.stdin.buffer, as chip_smoke.py's stdin phase feeds it."""
    from dump1090_tpu_torch import cli

    class Stdin:
        buffer = io.BytesIO(capture[0])

    monkeypatch.setattr(sys, "stdin", Stdin)
    buf = io.BytesIO()
    out = io.TextIOWrapper(buf, encoding="utf-8", write_through=True)
    saved = {s: signal.getsignal(s) for s in (signal.SIGPIPE, signal.SIGWINCH)}
    monkeypatch.setattr(sys, "stdout", out)
    try:
        assert cli.main(["--device", "cpu", "--tpu-device-resolve", "on", "--ifile", "-",
                         "--raw"]) == 0
    finally:
        for s, h in saved.items():
            signal.signal(s, h)
    assert buf.getvalue() == outputs[("file", "raw")]


@pytest.fixture(scope="module")
def net_streams(tmp_path_factory, capture, jax_native):
    """The raw-out and SBS streams of `--ifile - --net`: the JAX tool on
    the JAX CLI, and the port's tool on the port's CLI with the resolver on
    the host and on the device."""
    sys.path.insert(0, str(REPO / "tools"))
    import net_capture as jnc

    data = capture[0][: 3 * 262144]  # whole buffers, as the tool's protocol pads them

    def jax():
        raw_p, sbs_p, ri_p, http_p = jnc.free_ports(4)
        cmd = jnc.build_cmd([sys.executable, *JAX], raw_p, sbs_p, ri_p, http_p)
        return jnc.capture_streams(cmd, data, raw_p, sbs_p, cwd=str(REPO))

    def port(*flags):
        return tnc.capture([*tnc.ours_cmd("cpu"), *flags], data, cwd=str(REPO))

    with pytest.MonkeyPatch.context() as mp:
        for k, v in _env(tmp_path_factory.mktemp("jaxcache")).items():
            mp.setenv(k, v)
        with concurrent.futures.ThreadPoolExecutor(3) as pool:
            futures = {"jax": pool.submit(jax), "port": pool.submit(port),
                       "port-on": pool.submit(port, "--tpu-device-resolve", "on")}
            return {k: f.result() for k, f in futures.items()}


@pytest.mark.parametrize("who", ["port", "port-on"])
def test_net_capture_equals_the_jax_tool(net_streams, outputs, who):
    got, want = net_streams[who], net_streams["jax"]
    assert got["raw"] == want["raw"]
    assert tnc.canonicalize_sbs(got["sbs"]) == tnc.canonicalize_sbs(want["sbs"])
    # raw out is the uppercase --raw lines; SBS holds positions
    assert got["raw"] == outputs[("file", "raw")].upper() and got["raw"]
    assert got["sbs"].count(b"MSG,3,") > 0


def test_net_capture_main_and_no_card(tmp_path, capture, monkeypatch):
    """The entry point writes both streams; without a card it refuses
    unless the CPU is named."""
    iq = tmp_path / "iq.bin"
    iq.write_bytes(capture[0][:262144])
    out = io.StringIO()
    args = ["--ours", "--iq", str(iq), "--out-raw", str(tmp_path / "raw.txt"), "--out-sbs",
            str(tmp_path / "sbs.txt")]
    from contextlib import redirect_stdout

    with redirect_stdout(out):
        assert tnc.main(["--device", "cpu", *args]) == 0
    raw = (tmp_path / "raw.txt").read_bytes()
    assert raw and out.getvalue().startswith(f"raw: {len(raw)} bytes")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tnc.main(args)
