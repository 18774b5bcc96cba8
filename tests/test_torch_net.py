"""The port's network services (io/net.py) on loopback: the wire checks of
the JAX package's tests/test_net.py against the port's services (raw relay,
HTTP, SBS counter, the reference's line framing with its buffer reset and
NUL poisoning, the stalled-client drop, churn, the --debug n wording), and
the same raw input sent to both packages' services, wired as their CLIs
wire them, giving byte-equal raw-out, SBS and /data.json."""

import io
import re
import socket
import threading
import time
import urllib.request

import numpy as np
import pytest

import dump1090_tpu.io.net as jnet
import dump1090_tpu.models.decoder as jd
import dump1090_tpu.models.hub as jh
import dump1090_tpu.models.tracker as jt
import dump1090_tpu.utils.display as jdisp
import dump1090_tpu_torch.io.net as tnet
import dump1090_tpu_torch.models.decoder as td
import dump1090_tpu_torch.models.hub as th
import dump1090_tpu_torch.models.tracker as tt
import dump1090_tpu_torch.utils.display as tdisp

NOW = 1_700_000_000
PKGS = {"port": (tnet, td, th, tt, tdisp), "jax": (jnet, jd, jh, jt, jdisp)}


def _free_ports(n):
    socks = [socket.socket() for _ in range(n)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


def _start(pkg: str, *, hub_cfg=None, debug_net=False, frozen=False):
    """One package's services wired as its CLI wires them: raw input ->
    decode_hex_message -> hub (tracker, SBS and raw sinks), /data.json from
    the tracker, the HTTP and SBS counters.  Returns (net, ports, stats)."""
    net_mod, dec, hub_mod, tr_mod, disp = PKGS[pkg]
    ports = _free_ports(4)
    if frozen:
        ms = [NOW * 1000]

        def msclock():
            ms[0] += 300
            return ms[0]

        tracker = tr_mod.AircraftTracker(clock=lambda: NOW, msclock=msclock)
        cache = dec.IcaoCache(clock=lambda: NOW)
    else:
        tracker, cache = tr_mod.AircraftTracker(), dec.IcaoCache()
    cfg, stats = dec.DecoderConfig(), dec.DecoderStats()
    hub = hub_mod.MessageHub(hub_cfg or hub_mod.HubConfig(net=True, raw=True), tracker, stats,
                             out=io.StringIO())
    lock = threading.RLock()

    def on_raw_line(line):
        with lock:
            mm = dec.decode_hex_message(line, cache, cfg, stats)
            if mm is not None:
                hub.use_message(mm)

    def bump(attr):
        setattr(stats, attr, getattr(stats, attr) + 1)

    ro, ri, http, sbs = ports
    net = net_mod.NetworkServices(
        net_mod.NetConfig(ro_port=ro, ri_port=ri, http_port=http, sbs_port=sbs,
                          bind_host="127.0.0.1", debug_net=debug_net),
        on_raw_line=on_raw_line,
        data_json=lambda: disp.aircraft_json(tracker),
        on_http_request=lambda: bump("http_requests"),
        on_sbs_connect=lambda: bump("sbs_connections"),
    )
    hub.raw_sink = net.broadcast_raw
    hub.sbs_sink = net.broadcast_sbs
    net.start()
    return net, ports, stats


@pytest.fixture
def services():
    net, ports, stats = _start("port")
    yield net, ports, stats
    net.stop()


def _get(port, path):
    return urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=10)


def _wait(cond, timeout=10.0):
    deadline = time.time() + timeout
    while not cond() and time.time() < deadline:
        time.sleep(0.02)
    return cond()


def test_raw_in_to_raw_out_relay(services):
    net, (ro, ri, http, sbs), stats = services
    with socket.create_connection(("127.0.0.1", ro), timeout=10) as out:
        time.sleep(0.1)
        with socket.create_connection(("127.0.0.1", ri), timeout=10) as inp:
            inp.sendall(b"*8D4D2023991094AD487C14FC9E3D;\n*garbage;\nnoise\n*5D4D20237A55A6;\n")
            got = b""
            while b"5D4D2023" not in got:
                got += out.recv(4096)
    # valid frames re-broadcast uppercase; garbage silently dropped
    assert got == b"*8D4D2023991094AD487C14FC9E3D;\n*5D4D20237A55A6;\n"


def test_http_data_json_page_and_counters(services):
    net, (ro, ri, http, sbs), stats = services
    body = _get(http, "/data.json")
    assert body.headers["Content-Type"].startswith("application/json")
    assert body.headers["Access-Control-Allow-Origin"] == "*"
    assert body.read() == b"[\n]\n"
    page = _get(http, "/anything").read()
    assert b"<html" in page.lower()
    assert _wait(lambda: stats.http_requests == 2)
    c = socket.create_connection(("127.0.0.1", sbs), timeout=10)
    assert _wait(lambda: stats.sbs_connections == 1)
    c.close()


def test_bind_error_names_the_service():
    busy = socket.socket()
    busy.bind(("127.0.0.1", 0))
    busy.listen()
    try:
        ro, ri, http, sbs = _free_ports(4)
        net = tnet.NetworkServices(
            tnet.NetConfig(ro_port=ro, ri_port=busy.getsockname()[1], http_port=http,
                           sbs_port=sbs, bind_host="127.0.0.1"),
            on_raw_line=lambda line: None, data_json=lambda: "[\n]\n")
        with pytest.raises(OSError):
            net.start()
        assert net.bind_error_message().startswith(
            f"Error opening the listening port {busy.getsockname()[1]} (Raw TCP input): ")
        net.stop()
    finally:
        busy.close()


def test_stalled_client_dropped_at_buffer_bound(services):
    """A stalled raw-out reader is dropped at the next broadcast after its
    write buffer passes MAX_WRITE_BUFFER; a live client keeps receiving."""
    net, (ro, ri, http, sbs), stats = services
    stalled = socket.create_connection(("127.0.0.1", ro), timeout=10)
    live = socket.create_connection(("127.0.0.1", ro), timeout=10)
    time.sleep(0.2)
    net.MAX_WRITE_BUFFER = 64 * 1024
    try:
        line = "*8d4d2023587f345e35837e2218b2;\n"
        for _ in range(800):
            net.broadcast_raw(line * 320)
        assert _wait(lambda: len(net._raw_clients) < 2, timeout=10), "stalled client kept"
        live_data = b""
        live.setblocking(False)
        deadline = time.time() + 5
        while time.time() < deadline and len(live_data) < len(line):
            net.broadcast_raw(line)
            try:
                live_data += live.recv(65536)
            except BlockingIOError:
                time.sleep(0.05)
        assert len(live_data) >= len(line)
    finally:
        stalled.close()
        live.close()


def test_paused_readers_get_every_line_then_the_raw_input(services):
    """Raw-out and SBS clients that read nothing while about 300 KB each are
    broadcast (below MAX_WRITE_BUFFER, in many small writes, as a file
    decode emits them) then get every byte in order, and then the lines of
    one raw-input frame: the SBS line and the raw echo."""
    net, (ro, ri, http, sbs), stats = services
    raw_c = socket.create_connection(("127.0.0.1", ro), timeout=10)
    sbs_c = socket.create_connection(("127.0.0.1", sbs), timeout=10)
    try:
        assert _wait(lambda: stats.sbs_connections == 1 and len(net._raw_clients) == 1)
        raw_lines = [f"*8D{i:06X}58C382D690C8AC2863A7;\n" for i in range(9000)]
        sbs_lines = [f"MSG,3,,,{i:06X},,,,,,,33000,,,,,,,0,0,0,0\n" for i in range(6000)]
        for i, line in enumerate(raw_lines):
            net.broadcast_raw(line)
            if i < len(sbs_lines):
                net.broadcast_sbs(sbs_lines[i])
        with socket.create_connection(("127.0.0.1", ri), timeout=10) as inp:
            inp.sendall(b"*5dabcdef8a6ab3;\n")
            want_raw = "".join(raw_lines).encode() + b"*5DABCDEF8A6AB3;\n"
            want_sbs = "".join(sbs_lines).encode() + b"MSG,8,,,ABCDEF,,,,,,,,,,,,,,,,,\n"
            for sock, want in ((raw_c, want_raw), (sbs_c, want_sbs)):
                got = b""
                while len(got) < len(want):
                    chunk = sock.recv(1 << 16)
                    assert chunk, "the client was closed"
                    got += chunk
                assert got == want
    finally:
        raw_c.close()
        sbs_c.close()


def test_broadcast_and_http_under_client_churn(services):
    """Raw-out clients connect, read a little or nothing, and leave while
    the decode side broadcasts; HTTP keep-alive clients and half-sent
    requests hammer the map server.  No error, and fresh clients are
    served correctly afterwards."""
    net, (ro, ri, http, sbs), stats = services
    stop = threading.Event()
    errors = []

    def churn(read_some):
        try:
            while not stop.is_set():
                with socket.create_connection(("127.0.0.1", ro), 10) as s:
                    if read_some:
                        s.settimeout(0.2)
                        try:
                            s.recv(4096)
                        except socket.timeout:
                            pass
        except Exception as e:  # reported below
            errors.append(e)

    def fetch_loop():
        try:
            for _ in range(10):
                assert _get(http, "/data.json").read().startswith(b"[")
        except Exception as e:  # reported below
            errors.append(e)

    def slam_loop():
        try:
            for _ in range(20):
                with socket.create_connection(("127.0.0.1", http), 10) as s:
                    s.send(b"GET /data.json HTTP/1.1\r\n")  # incomplete
        except Exception as e:  # reported below
            errors.append(e)

    threads = [threading.Thread(target=churn, args=(i % 2 == 0,), daemon=True) for i in range(8)]
    threads += [threading.Thread(target=fetch_loop) for _ in range(4)]
    threads += [threading.Thread(target=slam_loop) for _ in range(2)]
    for t in threads:
        t.start()
    line = "*8f4d2023587f345e35837e2218b2;\n"
    t_end = time.time() + 2.0
    n = 0
    while time.time() < t_end:
        net.broadcast_raw(line)
        n += 1
        if n % 50 == 0:
            time.sleep(0.005)
    stop.set()
    for t in threads:
        t.join(timeout=30)
    assert not errors and not any(t.is_alive() for t in threads)
    with socket.create_connection(("127.0.0.1", ro), 10) as s:
        time.sleep(0.1)
        net.broadcast_raw(line)
        s.settimeout(10)
        assert line.encode().strip() in s.recv(4096)
    assert _get(http, "/data.json").read() == b"[\n]\n"


def test_oversized_garbage_line_keeps_client(services):
    net, (ro, ri, http, sbs), stats = services
    with socket.create_connection(("127.0.0.1", ro), 10) as out_s:
        time.sleep(0.1)
        with socket.create_connection(("127.0.0.1", ri), 10) as in_s:
            in_s.sendall(b"Z" * 200_000)  # no newline
            time.sleep(0.2)
            in_s.sendall(b"\n*8f4d2023587f345e35837e2218b2;\n")
            out_s.settimeout(10)
            assert b"*8F4D2023587F345E35837E2218B2;" in out_s.recv(4096)


@pytest.mark.parametrize("junk_len,copies", [(2048, 2), (1000, 1)])
def test_buffer_reset_prefix_discard(services, junk_len, copies):
    """The 1 KiB reset discards the accumulated prefix: a frame after 2048
    junk bytes survives, one after 1000 is cut by the reset."""
    msg = b"*8f4d2023587f345e35837e2218b2;"
    net, (ro, ri, http, sbs), stats = services
    with socket.create_connection(("127.0.0.1", ro), 10) as out_s:
        time.sleep(0.1)
        with socket.create_connection(("127.0.0.1", ri), 10) as in_s:
            in_s.sendall(b"Z" * junk_len + msg + b"\n")
            in_s.sendall(msg + b"\n")  # always-decodable marker
            out_s.settimeout(10)
            got = b""
            while got.count(b"*8F4D2023587F345E35837E2218B2;") < 1:
                got += out_s.recv(4096)
            time.sleep(0.2)
            out_s.setblocking(False)
            try:
                got += out_s.recv(65536)
            except OSError:
                pass
    assert got.count(b"*8F4D2023587F345E35837E2218B2;") == copies


def test_nul_byte_poisons_framing_until_reset(services):
    msg = b"*8f4d2023587f345e35837e2218b2;"
    out_msg = b"*8F4D2023587F345E35837E2218B2;"
    net, (ro, ri, http, sbs), stats = services

    def drain(out_s, want, timeout):
        out_s.settimeout(timeout)
        got = b""
        try:
            while got.count(out_msg) < want:
                got += out_s.recv(4096)
        except OSError:
            pass
        return got

    with socket.create_connection(("127.0.0.1", ro), 10) as out_s:
        time.sleep(0.1)
        with socket.create_connection(("127.0.0.1", ri), 10) as in_s:
            in_s.sendall(msg + b"\n\x00junk\n" + msg + b"\n")
            got = drain(out_s, 2, 1.5)
            assert got.count(out_msg) == 1
            in_s.sendall(b" " * 1024 + msg + b"\n")
            got += drain(out_s, 1, 10.0)
    assert got.count(out_msg) == 2


def test_debug_n_wording(capsys):
    """--debug n lines on stdout with the reference's wording: client
    creation and closing for raw input, and the HTTP request dump for one
    keep-alive request, byte for byte after the fd numbers."""
    net, (ro, ri, http, sbs), _ = _start("port", debug_net=True)
    try:
        with socket.create_connection(("127.0.0.1", http), 10) as s:
            s.settimeout(10)
            s.sendall(b"GET /data.json HTTP/1.1\r\nHost: t\r\n\r\n")
            buf = b""
            while b"[\n]\n" not in buf:
                buf += s.recv(4096)
        time.sleep(0.3)
        http_out = capsys.readouterr().out
        c = socket.create_connection(("127.0.0.1", ri), timeout=10)
        c.sendall(b"*5d4d20237a55a6;\n")
        c.close()
        out = ""
        deadline = time.time() + 5
        while out.count("Closing client") < 1 and time.time() < deadline:
            out += capsys.readouterr().out
            time.sleep(0.02)
    finally:
        net.stop()
    assert re.sub(r"client \d+", "client N", http_out) == (
        "Created new client N\n"
        "\nHTTP request: GET /data.json HTTP/1.1\r\nHost: t\n"
        "\nHTTP keep alive: 1\n"
        "HTTP requested URL: /data.json\n\n"
        "HTTP Reply header:\n"
        "HTTP/1.1 200 OK\r\n"
        "Server: Dump1090\r\n"
        "Content-Type: application/json;charset=utf-8\r\n"
        "Connection: keep-alive\r\n"
        "Content-Length: 4\r\n"
        "Access-Control-Allow-Origin: *\r\n\r\n"
        "Closing client N\n"
    )
    assert re.search(r"^Created new client \d+$", out, re.M)
    assert re.search(r"^Closing client \d+$", out, re.M)


def _sentinel() -> bytes:
    """A DF11 all-call reply of an address no traffic frame uses."""
    from dump1090_tpu_torch.ops.crc import compute_crc

    f = bytearray(b"\x5d\xab\xcd\xef\x00\x00\x00")
    c = compute_crc(np.frombuffer(bytes(f), np.uint8), 56)
    f[4:7] = c.to_bytes(3, "big")
    return b"*" + bytes(f).hex().encode() + b";\n"


def test_same_raw_input_gives_the_same_wire_bytes_in_both_packages():
    """Seeded traffic as hex lines into each package's raw input, with one
    raw-out client, one SBS client and one /data.json request made first
    (so tracking is on): the raw-out bytes, the SBS bytes and a /data.json
    fetched after are equal."""
    from dump1090_tpu_torch.utils.synth import traffic_frames

    lines = b"".join(b"*" + f.hex().encode() + b";\n" for f, _ in traffic_frames(51, 400))
    lines += b"*zz;\n" + _sentinel()
    sentinel_sbs = b"MSG,8,,,ABCDEF,,,,,,,,,,,,,,,,,\n"
    got = {}
    for pkg in PKGS:
        net, (ro, ri, http, sbs), stats = _start(pkg, frozen=True)
        try:
            raw_c = socket.create_connection(("127.0.0.1", ro), timeout=10)
            sbs_c = socket.create_connection(("127.0.0.1", sbs), timeout=10)
            assert _get(http, "/data.json").read() == b"[\n]\n"
            assert _wait(lambda: stats.sbs_connections == 1 and stats.http_requests == 1)
            with socket.create_connection(("127.0.0.1", ri), timeout=10) as inp:
                inp.sendall(lines)
                raw, sbs_b = b"", b""
                raw_c.settimeout(10)
                sbs_c.settimeout(10)
                while not raw.endswith(_sentinel().upper()):
                    raw += raw_c.recv(65536)
                while not sbs_b.endswith(sentinel_sbs):
                    sbs_b += sbs_c.recv(65536)
            got[pkg] = (raw, sbs_b, _get(http, "/data.json").read())
            raw_c.close()
            sbs_c.close()
        finally:
            net.stop()
    assert got["port"] == got["jax"]
    raw, sbs_b, js = got["port"]
    assert raw.count(b"\n") > 300 and sbs_b.count(b"MSG,3,") > 50 and js.count(b'"hex"') > 3
