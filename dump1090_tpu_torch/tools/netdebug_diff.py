"""Differential test of --debug n (network-event logging): the port's CLI
against an oracle that speaks the reference's CLI (a port of
tools/netdebug_diff.py).

Runs one scripted, deterministic network session against each decoder in
--net-only --debug n mode and byte-diffs the stdout logs after
canonicalizing file-descriptor numbers (the only process-specific content:
"Created new client %d" / "Closing client %d", dump1090.c:2334,2345).

The session reaches every MODES_DEBUG_NET print site that a healthy run can
reach (dump1090.c:2334-2335, 2345-2346, 2569-2570, 2590-2592, 2638-2639):
client accepts on the raw-in, raw-out and HTTP services, a raw relay, an
HTTP keep-alive request for /data.json, a second HTTP/1.0 close request for
the map page (both processes share one scratch working directory, so the
page bytes and the logged reply header's Content-Length are identical),
and read-detected client closes.  The "Accept %d: %s" errno print
(dump1090.c:2309) needs fault injection and is not driven.

    python -m dump1090_tpu_torch.tools.netdebug_diff [--ref CMD]

--ref is the oracle's command (default: the reference binary, see
refbuild.py).  `--net-only` does no device work, so the port's CLI runs
with its default device and needs no card.  Exit 0 when the canonicalized
logs are byte-identical.
"""

from __future__ import annotations

import argparse
import os
import re
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

from .fuzz_hex import REPO, oracle_cmd, unbuffered_env
from .net_capture import connect, free_ports, ours_cmd

FRAME = b"*8f4d2023991093ad287c148accdc;\n"      # good CRC: relays verbatim
SENTINEL = b"*8d4d202358792453ef858bae7fc9;\n"   # good CRC

HTTP_KEEPALIVE = (b"GET /data.json HTTP/1.1\r\nHost: t\r\n"
                  b"User-Agent: netdebug-diff\r\n\r\n")
HTTP_CLOSE = (b"GET / HTTP/1.0\r\nHost: t\r\n"
              b"User-Agent: netdebug-diff\r\n\r\n")

PAGE = b"<html><body>netdebug fixture page</body></html>\n"


def _recv_until(sock: socket.socket, token: bytes, timeout: float = 10.0) -> bytes:
    buf = b""
    deadline = time.monotonic() + timeout
    while token not in buf:
        if time.monotonic() > deadline:
            raise RuntimeError(f"never received {token!r}; got {buf!r}")
        try:
            b_ = sock.recv(1 << 14)
        except socket.timeout:
            continue
        if not b_:
            raise RuntimeError(f"socket closed waiting for {token!r}")
        buf += b_
    return buf


def run_session(cmd: list[str], cwd: str, env: dict | None = None) -> bytes:
    """One deterministic --debug n session; returns the decoder's stdout."""
    ro, ri, http_p, sbs = free_ports(4)
    full = cmd + ["--net-only", "--debug", "n",
                  "--net-ro-port", str(ro), "--net-ri-port", str(ri),
                  "--net-http-port", str(http_p), "--net-sbs-port", str(sbs)]
    proc = subprocess.Popen(full, stdin=subprocess.DEVNULL,
                            stdout=subprocess.PIPE,
                            stderr=subprocess.DEVNULL, cwd=cwd, env=env)
    try:
        # pacing: the reference's accept/read loop polls every ~100 ms
        # (backgroundTasks + usleep); generous gaps keep event ORDER stable
        gap = 0.4
        out_s = connect(ro, proc, 5)
        time.sleep(gap)
        in_s = connect(ri, proc, 5)
        time.sleep(gap)
        in_s.sendall(FRAME)
        _recv_until(out_s, FRAME.strip().upper())
        time.sleep(gap)

        # HTTP: keep-alive /data.json, then a 1.0 close request for the
        # shared CWD page on the SAME connection
        h = connect(http_p, proc, 5)
        time.sleep(gap)
        h.sendall(HTTP_KEEPALIVE)
        _recv_until(h, b"\r\n\r\n")
        time.sleep(gap)
        h.sendall(HTTP_CLOSE)
        _recv_until(h, PAGE)
        time.sleep(gap)
        h.close()          # already closing server-side (HTTP/1.0)
        time.sleep(gap)

        # raw-input close is read-detected by both decoders
        in_s.close()
        time.sleep(gap)

        # sentinel relay proves the event loop drained everything above
        in2 = connect(ri, proc, 5)
        time.sleep(gap)
        in2.sendall(SENTINEL)
        _recv_until(out_s, SENTINEL.strip().upper())
        time.sleep(gap)
        in2.close()
        # out_s stays open: the reference only detects a raw-OUT client's
        # death at the next broadcast write, so a read-detected close here
        # would log an event the reference never produces
        time.sleep(2 * gap)
    finally:
        proc.terminate()
        try:
            out, _ = proc.communicate(timeout=10)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, _ = proc.communicate()
    return out


_CLIENT_RE = re.compile(rb"^(Created new|Closing) client (\d+)$", re.M)


def canonicalize(log: bytes) -> bytes:
    """Map fd numbers to sequential ids by first appearance."""
    ids: dict[bytes, bytes] = {}

    def sub(m: re.Match) -> bytes:
        fd = m.group(2)
        if fd not in ids:
            ids[fd] = b"%d" % len(ids)
        return m.group(1) + b" client " + ids[fd]

    return _CLIENT_RE.sub(sub, log)


def diff(ref_cmd: list[str], ours: list[str], log=print) -> bool:
    """One session against each decoder, from one scratch working directory
    that serves the same page; True when the canonicalized logs are
    byte-identical."""
    with tempfile.TemporaryDirectory() as cwd:
        (Path(cwd) / "gmap.html").write_bytes(PAGE)
        # the decoders start in the scratch directory: find the packages
        env = unbuffered_env()
        env["PYTHONPATH"] = os.pathsep.join(filter(None, [str(REPO), env.get("PYTHONPATH")]))
        got = run_session(ours, cwd=cwd, env=env)
        ref = run_session(oracle_cmd(ref_cmd), cwd=cwd, env=env)
    a, b = canonicalize(got), canonicalize(ref)
    if a != b:
        log("OURS (canonicalized):\n" + a.decode("latin-1"))
        log("REFERENCE (canonicalized):\n" + b.decode("latin-1"))
        return False
    log(f"ok: --debug n logs identical after fd canonicalization "
        f"({len(_CLIENT_RE.findall(got))} client events, {len(a)} bytes)")
    return True


def main(argv=None) -> int:
    from .refbuild import reference_command

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ref", default=None, help="the oracle's command (default: the reference)")
    args = ap.parse_args(argv)
    if diff(reference_command(args.ref), ours_cmd()):
        return 0
    print("--debug n logs diverged", file=sys.stderr)
    return 1


if __name__ == "__main__":
    sys.exit(main())
