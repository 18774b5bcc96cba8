"""The port's RTL-SDR source (dump1090_tpu_torch/io/rtlsdr.py) and live decode
against a stub librtlsdr (tests/stub_rtlsdr.c, built with gcc; the tests
skip without it), on the CPU, with synthetic air from utils/synth.py: the
init wording and gain choice, the short-transfer stale tail, the mailbox's
buffers through DemodPipeline.run_source (host resolve) and
run_source_device (device resolve) equal to each other and to the JAX
package's run_source_device, and the live CLI (`--device-index`, `--gain`,
`--ppm`, `--enable-agc`, `--raw`; `--interactive`) byte-equal to the JAX
CLI over the same stub.  Contract: modesInitRTLSDR + rtlsdrCallback +
readerThreadEntryPoint (dump1090.c:385-458, 516-527).

The stub replays RTLSDR_STUB_DATA in 256 KiB transfers, RTLSDR_STUB_DELAY_US
apart.  The mailbox drops a buffer that the decoder has not taken before
the next arrives (as the reference does), so the in-process runs warm the
pipelines first and pace the stub at 200 ms, and every subprocess gets one
transfer, which nothing can overwrite."""

import dataclasses
import io
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from dump1090_tpu_torch.constants import DATA_LEN_BYTES
from dump1090_tpu_torch.utils.synth import planted_capture
from test_torch_native import JAX_MAIN, jax_native  # noqa: F401  (a fixture)

REPO = Path(__file__).resolve().parent.parent
STUB_SRC = REPO / "tests" / "stub_rtlsdr.c"
NOW = 1_700_000_000


@pytest.fixture(scope="module")
def stub_lib(tmp_path_factory):
    out = tmp_path_factory.mktemp("rtlsdr") / "librtlsdr_stub.so"
    try:
        subprocess.run(["gcc", "-shared", "-fPIC", str(STUB_SRC), "-o", str(out)],
                       check=True, capture_output=True)
    except (OSError, subprocess.CalledProcessError) as e:
        pytest.skip(f"cannot build stub librtlsdr: {e}")
    return out


@pytest.fixture(scope="module")
def air():
    """Two transfers of dense planted air, some frames with flipped bits."""
    data, _ = planted_capture(2, 60, seed=31, noise_sigma=3.0, flip_weights=(0.7, 0.2, 0.1))
    return data[: 2 * DATA_LEN_BYTES]


def _stub_env(monkeypatch, stub_lib, path, delay_us):
    monkeypatch.setenv("DUMP1090_TPU_LIBRTLSDR", str(stub_lib))
    monkeypatch.setenv("RTLSDR_STUB_DATA", str(path))
    monkeypatch.setenv("RTLSDR_STUB_DELAY_US", str(delay_us))


def test_unavailable_without_library(monkeypatch):
    from dump1090_tpu_torch.io.rtlsdr import RtlSdrSource, RtlSdrUnavailable

    monkeypatch.setenv("DUMP1090_TPU_LIBRTLSDR", "/nonexistent/librtlsdr.so")
    with pytest.raises(RtlSdrUnavailable):
        RtlSdrSource()


def test_init_sequence_and_gain_selection(stub_lib, monkeypatch):
    """Max-gain selection picks the last reported gain; the stderr wording
    is the reference's (dump1090.c:396-433) and the JAX package's."""
    from dump1090_tpu.io.rtlsdr import RtlSdrSource as JaxSource
    from dump1090_tpu_torch.io.rtlsdr import RtlSdrSource

    monkeypatch.setenv("DUMP1090_TPU_LIBRTLSDR", str(stub_lib))
    texts = {}
    for name, cls in (("port", RtlSdrSource), ("jax", JaxSource)):
        for gain in (999999, -100, 400):
            err = io.StringIO()
            src = cls(dev_index=0, gain=gain, err=err)
            src.close()
            texts[(name, gain)] = (err.getvalue(), src.gain)
    assert {k[1]: v for k, v in texts.items() if k[0] == "port"} == \
        {k[1]: v for k, v in texts.items() if k[0] == "jax"}
    text, gain = texts[("port", 999999)]
    assert "Found 1 device(s):" in text
    assert "0: StubVendor, StubProduct, SN: 00000001 (currently selected)" in text
    assert "Max available gain is: 49.60" in text
    assert "Setting gain to: 49.60" in text
    assert "Gain reported by device: 49.60" in text
    assert gain == 496
    assert "Using automatic gain control." in texts[("port", -100)][0]
    assert "Setting gain to: 40.00" in texts[("port", 400)][0]


def test_short_transfer_keeps_stale_tail(stub_lib, monkeypatch, tmp_path):
    """A short USB transfer overwrites only `len` bytes; the rest of the
    previous buffer stays in place (rtlsdrCallback memcpys exactly len,
    dump1090.c:445-451)."""
    from dump1090_tpu_torch.io.rtlsdr import RtlSdrSource
    from dump1090_tpu_torch.io.sources import BUF_BYTES, CARRY_BYTES

    rng = np.random.default_rng(0)
    full = rng.integers(0, 256, DATA_LEN_BYTES, dtype=np.uint8)
    short = rng.integers(0, 256, 1000, dtype=np.uint8)
    stub_data = tmp_path / "short.bin"
    np.concatenate([full, short]).tofile(stub_data)
    _stub_env(monkeypatch, stub_lib, stub_data, 100000)

    bufs = list(RtlSdrSource(err=io.StringIO()).buffers())
    assert len(bufs) == 2 and all(b.shape == (BUF_BYTES,) for b in bufs)
    assert (bufs[0][:CARRY_BYTES] == 127).all()
    assert np.array_equal(bufs[0][CARRY_BYTES:], full)
    assert np.array_equal(bufs[1][:CARRY_BYTES], bufs[0][DATA_LEN_BYTES:])
    assert np.array_equal(bufs[1][CARRY_BYTES : CARRY_BYTES + 1000], short)
    assert np.array_equal(bufs[1][CARRY_BYTES + 1000 :], bufs[0][CARRY_BYTES + 1000 :])


def test_run_source_device_equals_run_source_and_jax(stub_lib, jax_native, monkeypatch, tmp_path,
                                                    air):
    """The stub's two buffers through the port's run_source_device (the
    device path: _device_batches with no stream) and run_source (host
    resolve), and through the JAX package's run_source_device: the same
    messages field for field, and the same counters."""
    from dump1090_tpu.io.rtlsdr import RtlSdrSource as JaxSource
    from dump1090_tpu.models.pipeline import DemodPipeline as JaxPipeline
    from dump1090_tpu.models.pipeline import PipelineConfig as JaxPipelineConfig
    from dump1090_tpu_torch.io.rtlsdr import RtlSdrSource
    from dump1090_tpu_torch.models.pipeline import DemodPipeline, PipelineConfig

    stub_data = tmp_path / "air.bin"
    stub_data.write_bytes(air)
    _stub_env(monkeypatch, stub_lib, stub_data, 200000)
    runs = {}
    for name, make, src_cls, method in (
            ("device", lambda: DemodPipeline(PipelineConfig(), clock=lambda: NOW, device="cpu"),
             RtlSdrSource, "run_source_device"),
            ("host", lambda: DemodPipeline(PipelineConfig(), clock=lambda: NOW, device="cpu"),
             RtlSdrSource, "run_source"),
            ("jax", lambda: JaxPipeline(JaxPipelineConfig(), clock=lambda: NOW),
             JaxSource, "run_source_device")):
        # warm up first (compiles, allocations), so the paced stream is kept up with
        make().run_device(io.BytesIO(air[:DATA_LEN_BYTES]), lambda mm: None)
        p, got = make(), []
        getattr(p, method)(src_cls(err=io.StringIO()).buffers(), got.append)
        runs[name] = ([dataclasses.asdict(m) for m in got], dataclasses.astuple(p.stats), p)
    assert runs["device"][0] == runs["host"][0] == runs["jax"][0]
    assert runs["device"][1] == runs["host"][1] == runs["jax"][1]
    msgs = runs["device"][0]
    assert sum(m["crcok"] for m in msgs) >= 100 and not all(m["crcok"] for m in msgs)
    assert runs["device"][2].samples_in == 2 * DATA_LEN_BYTES // 2
    # the device path took the emission shapes; the host path never does
    assert runs["device"][2]._mo is not None and runs["host"][2]._mo is None
    np.testing.assert_array_equal(runs["device"][2].cache.addr, runs["jax"][2].cache.addr)


def _clis(runs, stub_lib, stub_data, tmp_path):
    """`python <args>` for each of `runs`, all at once, over the stub radio;
    their CompletedProcess results in order."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", DUMP1090_TPU_LIBRTLSDR=str(stub_lib),
               RTLSDR_STUB_DATA=str(stub_data),
               JAX_COMPILATION_CACHE_DIR=str(tmp_path / "jaxcache"))
    env.pop("PYTHONPATH", None)
    env.pop("RTLSDR_STUB_DELAY_US", None)
    procs = [subprocess.Popen([sys.executable, *args], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, env=env, cwd=REPO, text=True)
             for args in runs]
    out = []
    for args, p in zip(runs, procs):
        stdout, stderr = p.communicate(timeout=300)
        out.append(subprocess.CompletedProcess(args, p.returncode, stdout, stderr))
    return out


def test_cli_live_raw_equals_jax_cli(stub_lib, jax_native, tmp_path, air):
    """`--device-index 0 --gain 40 --ppm 1 --enable-agc --raw` over one
    transfer of the stub: the port's stdout (with --device cpu) is the JAX
    CLI's, byte for byte, and the file decode's of the same bytes; the init
    lines on stderr are the JAX CLI's too."""
    from dump1090_tpu_torch import decode_capture

    stub_data = tmp_path / "capture.bin"
    stub_data.write_bytes(air[:DATA_LEN_BYTES])
    flags = ["--device-index", "0", "--gain", "40", "--ppm", "1", "--enable-agc", "--raw"]
    got, want = _clis([["-m", "dump1090_tpu_torch", *flags, "--device", "cpu"],
                       [*JAX_MAIN, *flags, "--tpu-backend", "cpu"]], stub_lib, stub_data,
                      tmp_path)
    assert got.returncode == want.returncode == 0, (got.stderr, want.stderr)
    assert got.stdout == want.stdout
    assert got.stderr == want.stderr and "Setting gain to: 40.00" in got.stderr
    file_raw = "".join(f"*{m.msg[: m.msgbits // 8].hex()};\n"
                       for m in decode_capture(air[:DATA_LEN_BYTES], crcok_only=True,
                                               device="cpu"))
    assert got.stdout == file_raw and len(got.stdout.split()) >= 40


def test_cli_live_interactive(stub_lib, tmp_path, air):
    """Live capture with --interactive: the table renders the aircraft
    decoded from the stub radio (reader thread -> pipeline -> tracker ->
    screen), with the resolver on the device and on the host."""
    from dump1090_tpu_torch import decode_capture

    stub_data = tmp_path / "capture.bin"
    stub_data.write_bytes(air[:DATA_LEN_BYTES])
    addrs = {f"{m.aa1:02x}{m.aa2:02x}{m.aa3:02x}"
             for m in decode_capture(air[:DATA_LEN_BYTES], crcok_only=True, device="cpu")}
    runs = [["-m", "dump1090_tpu_torch", "--device-index", "0", "--interactive",
             "--interactive-rows", "10", "--device", "cpu", "--tpu-device-resolve", resolve]
            for resolve in ("on", "off")]
    for r in _clis(runs, stub_lib, stub_data, tmp_path):
        assert r.returncode == 0, r.stderr
        assert "Hex" in r.stdout and "Flight" in r.stdout  # the table header
        shown = {ln.split()[0] for ln in r.stdout.split("\x1b[H\x1b[2J")[-1].splitlines()[2:]
                 if ln.strip()}
        assert shown and shown <= addrs


def test_cli_live_without_library_uses_the_jax_wording(tmp_path):
    env = dict(os.environ, DUMP1090_TPU_LIBRTLSDR="/nonexistent/librtlsdr.so")
    r = subprocess.run([sys.executable, "-m", "dump1090_tpu_torch", "--raw", "--device", "cpu"],
                       capture_output=True, timeout=120, env=env, cwd=REPO, text=True)
    assert r.returncode == 1 and r.stdout == ""
    assert r.stderr.startswith("No RTL-SDR support on this host (could not load "
                               "/nonexistent/librtlsdr.so")
    assert r.stderr.endswith(": provide --ifile (use '-' for stdin) or --net-only.\n")
