"""Capture a decoder's TCP output streams (raw 30002 and SBS 30003) byte
for byte, deterministically, while it decodes IQ piped into `--ifile -
--net`: the shape of `rtl_sdr - | dump1090 --ifile - --net` (a port of
tools/net_capture.py).

Works for the reference binary, the port's CLI and any decoder that speaks
the reference's CLI.  The decoder is spawned with `--net --ifile -` and fed
over stdin with a protocol that removes every timing race the reference
has (dump1090.c):

1. **Silence prefix.** The reference only accepts pending TCP clients inside
   `backgroundTasks` (dump1090.c:2831-2847), which runs once per decoded
   256 KiB buffer, so a client connected at start-up is invisible until
   buffer 1 has been decoded.  One full buffer of 127s (zero signal, the
   reference's own initial buffer, dump1090.c:343) goes first, then a
   pause, so every decoder sees the clients before the first real sample.
2. **Whole-buffer padding.** The reference's EOF handling races the decode
   loop and usually drops the final partial buffer (dump1090.c:496-507 vs
   2968-2990).  Padding the payload with 127s to a whole 256 KiB multiple
   makes the racy buffer pure silence.

SBS output has no wall-clock field (modesSendSBSOutput, dump1090.c:
2397-2448) except through the MSG,3 position pick below, so the streams
are stable golden material.

    python -m dump1090_tpu_torch.tools.net_capture (--ours | --cmd CMD) --iq FILE
        --out-raw FILE --out-sbs FILE [--device cuda]

--ours runs `python -m dump1090_tpu_torch --device <--device>`; --cmd any
decoder's command line (shell-quoted).  `connect` and `ours_cmd` serve the
other tools that drive a decoder over TCP.
"""

from __future__ import annotations

import argparse
import re
import shlex
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

from ..constants import DATA_LEN_BYTES

REPO = Path(__file__).resolve().parents[2]
START_S = 60.0  # the longest a decoder may take to listen (a Python one starts slowly)

# MSG,3 latitude/longitude come from the reference's CPR pair decode, which
# picks the newer of the even/odd latches by wall-clock millisecond
# timestamps (dump1090.c:2113-2125, mstime :278-287).  At full decode speed
# both latches usually land in the same millisecond and the comparison
# ties; whether a millisecond boundary falls between them varies from run
# to run, so two runs of one decoder can differ in exactly these fields.
# Comparisons canonicalize the two position fields of MSG,3 lines;
# everything else is byte-exact.
_MSG3_POS = re.compile(
    rb"^(MSG,3,,,[0-9A-F]+,,,,,,,-?\d+,,,)-?[\d.]+,-?[\d.]+(,.*)$")


def canonicalize_sbs(data: bytes) -> bytes:
    lines = data.split(b"\n")
    return b"\n".join(_MSG3_POS.sub(rb"\g<1><pos>\g<2>", ln) for ln in lines)


def free_ports(n: int) -> list[int]:
    socks = []
    for _ in range(n):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        socks.append(s)
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


def connect(port: int, proc: subprocess.Popen, timeout: float = 2.0) -> socket.socket:
    """A connection to a decoder's `port` on localhost, retried until it
    listens (up to START_S); RuntimeError if `proc` exits first or never
    listens.  The socket keeps `timeout` (seconds, None to block)."""
    deadline = time.monotonic() + START_S
    while True:
        try:
            s = socket.create_connection(("127.0.0.1", port), timeout=2)
            s.settimeout(timeout)
            return s
        except OSError:
            if time.monotonic() > deadline or proc.poll() is not None:
                raise RuntimeError(f"decoder never listened on port {port}")
            time.sleep(0.05)


def capture_streams(cmd: list[str], iq: bytes, raw_port: int, sbs_port: int,
                    timeout: float = 180.0, settle_s: float = 1.0,
                    cwd: str | None = None) -> dict[str, bytes]:
    """Run `cmd` (which must listen on the given ports and read IQ from
    stdin until EOF, then exit), return {"raw": ..., "sbs": ...} streams."""
    proc = subprocess.Popen(cmd, stdin=subprocess.PIPE,
                            stdout=subprocess.DEVNULL,
                            stderr=subprocess.DEVNULL, cwd=cwd)
    socks: dict[str, socket.socket] = {}
    try:
        for name, port in (("raw", raw_port), ("sbs", sbs_port)):
            socks[name] = connect(port, proc, timeout)

        out: dict[str, bytes] = {}

        def drain(name: str, s: socket.socket) -> None:
            chunks = []
            try:
                while True:
                    b = s.recv(1 << 16)
                    if not b:
                        break
                    chunks.append(b)
            except OSError:
                pass
            out[name] = b"".join(chunks)

        threads = [threading.Thread(target=drain, args=(n, s), daemon=True)
                   for n, s in socks.items()]
        for t in threads:
            t.start()

        # silence prefix buffer: lets the reference's per-buffer accept run
        # before any decodable sample arrives
        proc.stdin.write(b"\x7f" * DATA_LEN_BYTES)
        proc.stdin.flush()
        time.sleep(settle_s)
        proc.stdin.write(iq + b"\x7f" * (-len(iq) % DATA_LEN_BYTES))
        proc.stdin.close()
        proc.wait(timeout=timeout)
        for t in threads:
            t.join(timeout=30)
        return out
    finally:
        for s in socks.values():
            try:
                s.close()
            except OSError:
                pass
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def build_cmd(base: list[str], raw_port: int, sbs_port: int,
              ri_port: int, http_port: int) -> list[str]:
    return base + [
        "--ifile", "-", "--net",
        "--net-ro-port", str(raw_port), "--net-sbs-port", str(sbs_port),
        "--net-ri-port", str(ri_port), "--net-http-port", str(http_port),
    ]


def ours_cmd(device=None) -> list[str]:
    """The port's CLI, its stdout unbuffered (nothing is lost when it is
    killed), on `device` (a torch.device or its name), or with the CLI's
    own default (for `--net-only`, which needs no card)."""
    return [sys.executable, "-u", "-m", "dump1090_tpu_torch",
            *(["--device", str(device)] if device is not None else [])]


def capture(base: list[str], iq: bytes, **kw) -> dict[str, bytes]:
    """capture_streams of `base` (a decoder's command) on four free ports."""
    raw_p, sbs_p, ri_p, http_p = free_ports(4)
    return capture_streams(build_cmd(base, raw_p, sbs_p, ri_p, http_p), iq, raw_p, sbs_p, **kw)


def main(argv=None) -> int:
    from .. import resolve_device

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cmd", help="a decoder's command line (e.g. the reference binary)")
    ap.add_argument("--ours", action="store_true", help="capture the port's CLI on --device")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; no card is an error) or cpu")
    ap.add_argument("--iq", required=True)
    ap.add_argument("--out-raw", required=True)
    ap.add_argument("--out-sbs", required=True)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    if args.ours:
        base = ours_cmd(device.type)
    elif args.cmd:
        base = shlex.split(args.cmd)
    else:
        ap.error("need --cmd or --ours")

    streams = capture(base, Path(args.iq).read_bytes(), cwd=str(REPO))
    Path(args.out_raw).write_bytes(streams["raw"])
    Path(args.out_sbs).write_bytes(streams["sbs"])
    nl = b"\n"
    print(f"raw: {len(streams['raw'])} bytes, {streams['raw'].count(nl)} "
          f"lines; sbs: {len(streams['sbs'])} bytes, "
          f"{streams['sbs'].count(nl)} lines")
    return 0


if __name__ == "__main__":
    sys.exit(main())
