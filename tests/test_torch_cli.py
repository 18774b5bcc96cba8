"""`python -m dump1090_tpu_torch --device cpu` against `python -m dump1090_tpu
--tpu-backend cpu --tpu-device-resolve on`: stdout byte-equal for every
output mode of the file decode, at the CLI's own file-decode defaults
(64-buffer batches, 8 batches per group), on the committed golden input and
on a seeded synthetic capture with fixed frames: --raw and --stats (the
bulk device path), and the plain verbose display, --onlyaddr,
--raw --no-crc-check, --stats --onlyaddr and --onlyaddr --metric (the
message hub over run_device).  Only stdout is compared: the throughput
meter goes to stderr.  With --tpu-device-resolve off (the resolver on the
host: stream_records for --raw, DemodPipeline.run for the rest) --raw,
--stats and the verbose display equal the device-resolve output and the
JAX CLI's own host path.  --tpu-shard-time 4 (--raw, --stats, verbose)
equals the JAX CLI's on its 8 virtual CPU devices.  Also
--tpu-state-save/--tpu-state-load, --net-only (which needs no card), --snip
and the flags the port once refused."""

import concurrent.futures
import json
import os
import signal
import socket
import subprocess
import sys
import time
from pathlib import Path

import pytest

from dump1090_tpu_torch.utils.synth import planted_capture

REPO = Path(__file__).resolve().parent.parent
MODES = {
    "raw": ("--raw",),
    "stats": ("--stats",),
    "verbose": (),
    "onlyaddr": ("--onlyaddr",),
    "raw_nocrc": ("--raw", "--no-crc-check"),
    "stats_onlyaddr": ("--stats", "--onlyaddr"),
    "onlyaddr_metric": ("--onlyaddr", "--metric"),
}
JAX_CLI = ("-m", "dump1090_tpu", "--tpu-backend", "cpu", "--tpu-device-resolve", "on")
PORT_CLI = ("-m", "dump1090_tpu_torch", "--device", "cpu", "--tpu-device-resolve", "on")


def _env(cache_dir: Path) -> dict:
    """The CLI processes' environment: JAX on the CPU with a shared
    compilation cache, and one compute thread per process (torch's and
    XLA's), so the processes this file starts beside the other test workers
    do not oversubscribe the machine."""
    xla = os.environ.get("XLA_FLAGS", "") + " --xla_cpu_multi_thread_eigen=false"
    return dict(os.environ, JAX_PLATFORMS="cpu", JAX_COMPILATION_CACHE_DIR=str(cache_dir),
                OMP_NUM_THREADS="1", XLA_FLAGS=xla.strip())


def _run_many(cmds: dict, env: dict) -> dict:
    """Each command in its own process, four at a time; stdout by key."""
    def run(cmd):
        r = subprocess.run([sys.executable, *cmd], cwd=REPO, env=env, capture_output=True,
                           timeout=300)
        assert r.returncode == 0, (cmd, r.stderr.decode()[-2000:])
        return r.stdout

    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        futures = {k: pool.submit(run, c) for k, c in cmds.items()}
        return {k: f.result() for k, f in futures.items()}


@pytest.fixture(scope="module")
def synth_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("cli") / "synth.bin"
    data, _ = planted_capture(4, 40, seed=3, flip_weights=(0.7, 0.2, 0.1))
    path.write_bytes(data)
    return path


@pytest.fixture(scope="module")
def outputs(tmp_path_factory, golden_dir, synth_path):
    env = _env(tmp_path_factory.mktemp("jaxcache"))
    cmds = {}
    for name, path in (("golden", golden_dir / "debug_p_input.bin"), ("synth", synth_path)):
        for mode, flags in MODES.items():
            cmds[(name, "jax", mode)] = (*JAX_CLI, "--ifile", str(path), *flags)
            cmds[(name, "port", mode)] = (*PORT_CLI, "--ifile", str(path), *flags)
    return _run_many(cmds, env)


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("name", ["golden", "synth"])
def test_cli_stdout_equals_jax_cli(outputs, name, mode):
    got = outputs[(name, "port", mode)]
    assert got == outputs[(name, "jax", mode)]
    text = got.decode()
    if mode == "raw":
        assert len(got.split()) == 1 if name == "golden" else len(got.split()) >= 100
    elif mode.startswith("stats"):
        fixed = int(text.splitlines()[5].split()[0])
        assert fixed > 0 if name == "synth" else fixed == 0
    elif mode == "verbose":
        # every --raw line opens a verbose block, in order
        raw = outputs[(name, "port", "raw")].decode().splitlines()
        assert [ln for ln in text.splitlines() if ln.startswith("*")] == raw
        assert text.count("CRC: ") == len(raw) and "DF 17: ADS-B message." in text
    elif mode == "raw_nocrc":
        # badly-received frames are shown too
        assert len(got.split()) > len(outputs[(name, "port", "raw")].split()) or name == "golden"
    else:
        assert got and all(len(a) == 6 for a in text.split())


def test_state_save_and_load_equal_jax(tmp_path, synth_path):
    """--tpu-state-save writes the JAX package's snapshot (the cache's
    timestamps aside, which are the wall clock of each run), and a --stats
    run that loads it prints the same accumulated counters."""
    env = _env(tmp_path / "jaxcache")
    saved = {pkg: tmp_path / f"{pkg}.json" for pkg in ("jax", "port")}
    _run_many({pkg: (*cli, "--ifile", str(synth_path), "--onlyaddr", "--tpu-state-save",
                     str(saved[pkg]))
               for pkg, cli in (("jax", JAX_CLI), ("port", PORT_CLI))}, env)
    docs = {pkg: json.loads(p.read_text()) for pkg, p in saved.items()}
    for d in docs.values():
        d["icao_cache"]["ts"] = [t > 0 for t in d["icao_cache"]["ts"]]
    assert docs["port"] == docs["jax"] and docs["port"]["stats"]["goodcrc"] > 100
    out = _run_many({pkg: (*cli, "--ifile", str(synth_path), "--stats", "--tpu-state-load",
                           str(saved["jax"]))
                     for pkg, cli in (("jax", JAX_CLI), ("port", PORT_CLI))}, env)
    assert out["port"] == out["jax"]
    assert int(out["port"].split()[0]) == 2 * docs["jax"]["stats"]["valid_preamble"]


def test_net_only_needs_no_card_and_relays(tmp_path):
    """--net-only does no device work: it starts without a card (CUDA is
    made unavailable to the process) and relays raw input to raw output."""
    ports = []
    socks = [socket.socket() for _ in range(4)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
        ports.append(s.getsockname()[1])
    for s in socks:
        s.close()
    ro, ri, http, sbs = ports
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.Popen(
        [sys.executable, *PORT_CLI[:2], "--net-only", "--net-ro-port", str(ro), "--net-ri-port",
         str(ri), "--net-http-port", str(http), "--net-sbs-port", str(sbs)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    try:
        deadline = time.time() + 60
        out = None
        while out is None and time.time() < deadline:
            try:
                out = socket.create_connection(("127.0.0.1", ro), timeout=1)
            except OSError:
                time.sleep(0.1)
        assert out is not None, "raw output port never opened"
        with out, socket.create_connection(("127.0.0.1", ri), timeout=5) as inp:
            time.sleep(0.1)
            inp.sendall(b"*8d4d2023991094ad487c14fc9e3d;\n")
            out.settimeout(10)
            assert out.recv(4096) == b"*8D4D2023991094AD487C14FC9E3D;\n"
    finally:
        p.send_signal(signal.SIGINT)
        _, err = p.communicate(timeout=30)
    assert p.returncode == 0
    assert b"Net-only mode, no RTL device or file open." in err


def test_bind_failure_equals_jax(tmp_path):
    """A port that cannot be bound: the reference's wording on stderr, after
    the net-only announcement, and exit 1, as the JAX CLI does."""
    busy = socket.socket()
    busy.bind(("127.0.0.1", 0))
    busy.listen()
    try:
        port = str(busy.getsockname()[1])
        got = {}
        for pkg, cli in (("jax", JAX_CLI[:2]), ("port", PORT_CLI[:2])):
            r = subprocess.run([sys.executable, *cli, "--net-only", "--net-sbs-port", port],
                               cwd=REPO, capture_output=True, timeout=120,
                               env=_env(tmp_path / "jaxcache"))
            got[pkg] = (r.returncode, r.stdout, r.stderr)
    finally:
        busy.close()
    assert got["port"] == got["jax"]
    assert got["port"][0] == 1 and got["port"][2] == (
        "Net-only mode, no RTL device or file open.\n"
        f"Error opening the listening port {port} (Basestation TCP output): "
        "Address already in use\n").encode()


def test_snip_equals_jax(golden_dir):
    data = (golden_dir / "debug_p_input.bin").read_bytes()[:60000]
    got = subprocess.run([sys.executable, *PORT_CLI[:2], "--snip", "25"], input=data, cwd=REPO,
                         capture_output=True, timeout=120)
    want = subprocess.run([sys.executable, *JAX_CLI[:2], "--snip", "25"], input=data, cwd=REPO,
                          capture_output=True, timeout=120, env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert got.returncode == want.returncode == 0
    assert got.stdout == want.stdout and 0 < len(got.stdout) <= len(data)


def test_cli_refuses_what_is_not_ported(capsys):
    from dump1090_tpu_torch.cli import parse_args

    # nothing is refused any more: --tpu-shard-time, the last flag that
    # was, and every case refused before it now parse
    assert parse_args(["--ifile", "x.bin", "--tpu-shard-time", "2"]).shard_time == 2
    assert parse_args(["--tpu-shard-time", "8"]).shard_time == 8
    assert parse_args([]).shard_time is None
    assert parse_args(["--ifile", "x.bin", "--raw", "--tpu-front", "mask"]).front == "mask"
    o = parse_args(["--raw"])  # live RTL-SDR input
    assert (o.filename, o.raw, o.dev_index, o.gain) == (None, True, 0, 999999)
    assert parse_args(["--ifile", "x.bin", "--gain", "10"]).gain == 100
    o = parse_args(["--device-index", "2x", "--gain", "-10.5", "--enable-agc", "--freq", "1e9",
                    "--ppm", "-3", "--tpu-preload", "staged", "--tpu-front", "packed-plain-mxu",
                    "--tpu-profile", "p", "--tpu-backend", "cpu"])
    assert (o.dev_index, o.gain, o.enable_agc, o.freq, o.ppm, o.preload, o.front, o.profile_dir,
            o.device) == (2, -105, True, 1, -3, "staged", "packed-plain-mxu", "p", "cpu")
    assert parse_args(["--tpu-backend", "gpu"]).device == "cuda"
    for flag, value, want in (("--tpu-front", "packed-fast", "expected mask|packed"),
                              ("--tpu-preload", "eager", "expected auto|staged|off"),
                              ("--tpu-backend", "tpu", "use --device cuda|cpu")):
        with pytest.raises(SystemExit) as e:
            parse_args(["--ifile", "x.bin", flag, value])
        assert e.value.code == 1
        out, err = capsys.readouterr()
        assert want in err and out == ""
    o = parse_args(["--ifile", "x.bin", "--net", "--onlyaddr", "--no-crc-check", "--metric",
                    "--interactive", "--interactive-rows", "9", "--interactive-ttl", "5", "--loop",
                    "--net-ro-port", "1", "--net-ri-port", "2x", "--net-http-port", "3",
                    "--net-sbs-port", "4", "--tpu-state-load", "a", "--tpu-state-save", "b"])
    assert (o.net, o.onlyaddr, o.check_crc, o.metric, o.interactive, o.loop) == \
        (True, True, False, True, True, True)
    assert (o.interactive_rows, o.interactive_ttl, o.ro_port, o.ri_port, o.http_port,
            o.sbs_port, o.state_load, o.state_save) == (9, 5, 1, 2, 3, 4, "a", "b")
    assert parse_args(["--net-only"]).net_only and parse_args(["--snip", "3"]).snip == 3
    o = parse_args(["--ifile", "x.bin", "--debug", "cn", "--tpu-device-resolve", "off"])
    assert (o.debug, o.device_resolve) == ("cn", "off")
    assert parse_args(["--ifile", "x.bin"]).device_resolve == "auto"
    with pytest.raises(SystemExit) as e:
        parse_args(["--ifile", "x.bin", "--tpu-device-resolve", "maybe"])
    assert e.value.code == 1
    assert "expected on|off|auto" in capsys.readouterr().err
    with pytest.raises(SystemExit) as e:
        parse_args(["--bogus"])
    assert e.value.code == 1
    assert "Unknown or not enough arguments" in capsys.readouterr().err


def _main_inprocess(main, argv) -> bytes:
    """A CLI's main in this process, stdout captured as bytes; the signal
    handlers it installs are put back."""
    import io

    buf = io.BytesIO()
    out = io.TextIOWrapper(buf, encoding="utf-8", write_through=True)
    saved = {s: signal.getsignal(s) for s in (signal.SIGPIPE, signal.SIGWINCH)}
    real = sys.stdout
    sys.stdout = out
    try:
        assert main(list(argv)) == 0
    finally:
        sys.stdout = real
        for s, h in saved.items():
            signal.signal(s, h)
    out.flush()
    return buf.getvalue()


def test_interactive_equals_jax(monkeypatch, tmp_path, golden_dir):
    """--interactive (one buffer per batch, the 5 ms playback brake, the
    250 ms refresh and the final screen) on a frozen clock: the same bytes
    as the JAX CLI, and the screen lists the tracked aircraft."""
    import dump1090_tpu.cli as jcli
    import dump1090_tpu_torch.cli as tcli

    data, _ = planted_capture(3, 40, seed=4)
    path = tmp_path / "cap.bin"
    path.write_bytes(data)
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "jaxcache"))
    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.0)
    monkeypatch.setattr(time, "sleep", lambda s: None)
    args = ["--ifile", str(path), "--interactive", "--interactive-rows", "12"]
    got = _main_inprocess(tcli.main, ["--device", "cpu", "--tpu-device-resolve", "on", *args])
    want = _main_inprocess(jcli.main, ["--tpu-backend", "cpu", "--tpu-device-resolve", "on",
                                       *args])
    assert got == want
    screens = got.decode().split("\x1b[H\x1b[2J")
    assert len(screens) == 3 and screens[-1].count(" sec\n") == 12


def test_sigwinch_rereads_rows_and_redraws(capsys):
    """On SIGWINCH the row count is re-read and the screen redrawn at once
    (sigWinchCallback, dump1090.c:2772-2777)."""
    import threading

    from dump1090_tpu_torch import cli
    from dump1090_tpu_torch.models.tracker import AircraftTracker

    o = cli.parse_args(["--ifile", "x.bin", "--interactive"])
    o.interactive_rows = 1  # stale; the handler must replace it
    old = signal.getsignal(signal.SIGWINCH)
    try:
        cli._install_sigwinch(o, AircraftTracker(), threading.RLock(), threading.Lock())
        os.kill(os.getpid(), signal.SIGWINCH)
        time.sleep(0.05)
        assert o.interactive_rows == cli.get_term_rows()
        assert "Flight" in capsys.readouterr().out
    finally:
        signal.signal(signal.SIGWINCH, old)


@pytest.mark.parametrize("mode", ["raw", "stats", "verbose"])
@pytest.mark.parametrize("name", ["golden", "synth"])
def test_host_resolve_cli_equals_device_resolve_and_jax(outputs, golden_dir, synth_path,
                                                        monkeypatch, tmp_path, name, mode):
    """--tpu-device-resolve off, in this process: the port's output equals
    its device-resolve output and the JAX CLI's (device resolve, and on the
    synthetic capture also the JAX CLI's own host path)."""
    import dump1090_tpu.cli as jcli
    import dump1090_tpu_torch.cli as tcli

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "jaxcache"))
    path = golden_dir / "debug_p_input.bin" if name == "golden" else synth_path
    args = ["--ifile", str(path), *MODES[mode], "--tpu-device-resolve", "off"]
    got = _main_inprocess(tcli.main, ["--device", "cpu", *args])
    assert got == outputs[(name, "port", mode)] == outputs[(name, "jax", mode)]
    if name == "synth":
        assert got == _main_inprocess(jcli.main, ["--tpu-backend", "cpu", *args])


FRONTS = ["mask", "packed", "packed-mxu", "packed-plain", "packed-plain-mxu"]


@pytest.fixture(scope="module")
def jax_front_outputs(tmp_path_factory, synth_path):
    """The JAX CLI's --raw under each --tpu-front, with its resolver on the
    host (16-buffer batches: the front runs in its demod_batch); one process
    each, since the JAX package reads the front when it first traces."""
    env = _env(tmp_path_factory.mktemp("jaxcache"))
    return _run_many({f: ("-m", "dump1090_tpu", "--tpu-backend", "cpu", "--tpu-device-resolve",
                          "off", "--tpu-front", f, "--ifile", str(synth_path), "--raw")
                      for f in FRONTS}, env)


@pytest.mark.parametrize("front", FRONTS)
def test_tpu_front_equals_jax_cli(outputs, jax_front_outputs, synth_path, front, monkeypatch):
    """--tpu-front v: the port's --raw with the resolver on the host
    (demod_batch) and on the device (_group_front) equals the JAX CLI's
    --tpu-front v, and the environment is left as it was."""
    import dump1090_tpu_torch.cli as tcli

    monkeypatch.delenv("DUMP1090_TPU_FRONT", raising=False)
    args = ["--device", "cpu", "--ifile", str(synth_path), "--raw", "--tpu-front", front]
    host = _main_inprocess(tcli.main, args)
    on = _main_inprocess(tcli.main, [*args, "--tpu-device-resolve", "on", "--tpu-batch", "2"])
    assert "DUMP1090_TPU_FRONT" not in os.environ
    assert host == on == jax_front_outputs[front] == outputs[("synth", "port", "raw")]


@pytest.mark.parametrize("preload", ["staged", "off"])
def test_tpu_preload_equals_auto_and_jax_cli(outputs, synth_path, monkeypatch, tmp_path,
                                             preload):
    """--tpu-preload staged|off on the device path: the same bytes as the
    default (auto) and as the JAX CLI's --tpu-preload of the same mode."""
    import dump1090_tpu.cli as jcli
    import dump1090_tpu_torch.cli as tcli

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "jaxcache"))
    args = ["--ifile", str(synth_path), "--raw", "--tpu-device-resolve", "on", "--tpu-batch", "2",
            "--tpu-preload", preload]
    got = _main_inprocess(tcli.main, ["--device", "cpu", *args])
    assert got == outputs[("synth", "port", "raw")]
    assert got == _main_inprocess(jcli.main, ["--tpu-backend", "cpu", *args])


def test_tpu_profile_writes_a_trace(outputs, synth_path, tmp_path):
    """--tpu-profile <dir>: the same stdout, and a Chrome trace of the
    decode in <dir> that names the decode's operators."""
    import dump1090_tpu_torch.cli as tcli

    prof = tmp_path / "prof"
    got = _main_inprocess(tcli.main, ["--device", "cpu", "--tpu-device-resolve", "on",
                                      "--ifile", str(synth_path), "--raw", "--tpu-profile",
                                      str(prof)])
    assert got == outputs[("synth", "port", "raw")]
    traces = list(prof.glob("dump1090_tpu_torch.*.pt.trace.json"))
    assert len(traces) == 1
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert any(e.get("name") == "aten::topk" or e.get("name") == "aten::cumsum" for e in events)


def test_tpu_backend_is_an_alias_of_device(outputs, synth_path, capsys):
    """--tpu-backend cpu runs as --device cpu; tpu (or any other name)
    exits 1 naming --device."""
    import dump1090_tpu_torch.cli as tcli

    got = _main_inprocess(tcli.main, ["--tpu-backend", "cpu", "--tpu-device-resolve", "on",
                                      "--ifile", str(synth_path), "--raw"])
    assert got == outputs[("synth", "port", "raw")]
    r = subprocess.run([sys.executable, "-m", "dump1090_tpu_torch", "--tpu-backend", "tpu",
                        "--ifile", str(synth_path), "--raw"], cwd=REPO, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 1 and r.stdout == "" and "--device" in r.stderr


@pytest.fixture(scope="module")
def shard_outputs(tmp_path_factory, synth_path):
    """--tpu-shard-time 4 on the synthetic capture: the JAX CLI on its 8
    virtual CPU devices (a (2, 4) mesh) and the port with --device cpu (a
    (1, 4) mesh of the CPU), one process each; both resolve on the host."""
    env = _env(tmp_path_factory.mktemp("jaxcache"))
    cmds = {}
    for mode in ("raw", "stats", "verbose"):
        tail = ("--tpu-shard-time", "4", "--ifile", str(synth_path), *MODES[mode])
        cmds[("jax", mode)] = ("-m", "dump1090_tpu", "--tpu-backend", "cpu", *tail)
        cmds[("port", mode)] = ("-m", "dump1090_tpu_torch", "--device", "cpu", *tail)
    return _run_many(cmds, env)


@pytest.mark.parametrize("mode", ["raw", "stats", "verbose"])
def test_tpu_shard_time_equals_jax_cli(outputs, shard_outputs, mode):
    """The port's --tpu-shard-time 4 is byte-equal to the JAX CLI's and to
    the port's own unsharded decode of the same file."""
    got = shard_outputs[("port", mode)]
    assert got == shard_outputs[("jax", mode)] == outputs[("synth", "port", mode)]
    assert len(got.split()) >= 9


def test_tpu_shard_time_needs_as_many_cards(synth_path, monkeypatch, capsys):
    """On cuda with fewer cards than --tpu-shard-time asks for, the CLI
    stops with an error that names both counts, before any decode."""
    import torch

    import dump1090_tpu_torch.cli as tcli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    saved = {s: signal.getsignal(s) for s in (signal.SIGPIPE, signal.SIGWINCH)}
    try:
        rc = tcli.main(["--ifile", str(synth_path), "--raw", "--tpu-shard-time", "4"])
    finally:
        for s, h in saved.items():
            signal.signal(s, h)
    out, err = capsys.readouterr()
    assert rc == 1 and out == ""
    assert "over 4 shards needs 4 CUDA devices, but 1 is visible" in err
