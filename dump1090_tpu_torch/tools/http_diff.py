"""Live /data.json differential: the port's CLI against an oracle that
speaks the reference's CLI (a port of tools/http_diff.py).

Drives a scripted position scenario into both decoders over the raw-input
port and byte-diffs the resulting /data.json (aircraftsToJson,
dump1090.c:2505-2551): the tracker, the CPR global decode and the JSON %f
formatting, end to end over real sockets, with and without --metric.

Tracking only runs once an HTTP request or SBS client has been seen
(useModesMessage, dump1090.c:1806), so /data.json is fetched once before
the messages.  Even and odd CPR frames are 60 ms apart so the newer-latch
choice (millisecond clock) is deterministic, which is why this diff is
exact where the SBS captures canonicalize MSG,3.

    python -m dump1090_tpu_torch.tools.http_diff [--ref CMD]

--ref is the oracle's command (default: the reference binary, see
refbuild.py).  `--net-only` does no device work, so the port's CLI runs
with its default device and needs no card.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
import urllib.request

from .fuzz_hex import REPO
from .net_capture import START_S, connect, free_ports, ours_cmd


def scenario() -> list[bytes | float]:
    """Messages (hex lines) interleaved with sleeps (seconds)."""
    from ..utils.synth import make_df17_frame

    def line(frame: bytes) -> bytes:
        return b"*" + frame.hex().encode() + b";\n"

    out: list[bytes | float] = []
    # Aircraft 1: ident, even+odd airborne position, velocity.
    a1 = 0x4D2023
    out.append(line(make_df17_frame(
        addr=a1, metype=4, mesub=0,
        me_payload=bytes([0x04, 0xD1, 0x06, 0x20, 0x82, 0x08]))))  # "ABC123"
    # Airborne position metype 11, alt code 0x530 (Q=1), even then odd.
    # ME bits: [altitude 12][T 1][F 1][lat 17][lon 17]
    def pos(fflag: int, lat17: int, lon17: int) -> bytes:
        # Field layout per the reference extraction (dump1090.c:1262-1272).
        me = bytes([
            0x53,                                               # AC12 hi
            0x00 | (fflag << 2) | ((lat17 >> 15) & 3),          # AC12 lo|T|F
            (lat17 >> 7) & 0xFF,
            ((lat17 & 0x7F) << 1) | ((lon17 >> 16) & 1),
            (lon17 >> 8) & 0xFF,
            lon17 & 0xFF,
        ])
        return make_df17_frame(addr=a1, metype=11, mesub=0, me_payload=me)

    out.append(line(pos(0, 92095, 39846)))
    out.append(0.06)
    out.append(line(pos(1, 88385, 125818)))
    out.append(0.06)
    out.append(line(make_df17_frame(
        addr=a1, metype=19, mesub=1,
        me_payload=bytes([0x01, 0x99, 0x44, 0x22, 0x80, 0x30]))))
    # Aircraft 2: positionless (must be OMITTED from the JSON).
    out.append(line(make_df17_frame(addr=0x111111, metype=4,
                                    me_payload=b"\x04\xd1\x06 \x82\x08")))
    return out


def run_one(cmd: list[str], cwd: str | None = None,
            extra: list[str] | None = None) -> bytes:
    ports = free_ports(4)
    ro, ri, http_p, sbs = ports
    full = cmd + ["--net-only", "--net-ro-port", str(ro),
                  "--net-ri-port", str(ri), "--net-http-port", str(http_p),
                  "--net-sbs-port", str(sbs)] + (extra or [])
    proc = subprocess.Popen(full, stdin=subprocess.DEVNULL,
                            stdout=subprocess.DEVNULL,
                            stderr=subprocess.DEVNULL, cwd=cwd)
    try:
        in_s = connect(ri, proc)
        url = f"http://127.0.0.1:{http_p}/data.json"
        deadline = time.monotonic() + START_S
        while True:  # arm tracking (stat_http_requests > 0) on both sides
            try:
                urllib.request.urlopen(url, timeout=2).read()
                break
            except OSError:
                if time.monotonic() > deadline:
                    raise
                time.sleep(0.1)
        for item in scenario():
            if isinstance(item, float):
                time.sleep(item)
            else:
                in_s.sendall(item)
        time.sleep(0.5)
        return urllib.request.urlopen(url, timeout=5).read()
    finally:
        proc.kill()
        proc.wait()


def diff(ref_cmd: list[str], ours: list[str], log=print) -> bool:
    """/data.json after the scenario, with the defaults and with --metric,
    from both decoders; True when each pair is byte-identical, holds one
    aircraft (the positionless one is omitted) and no zero latitude."""
    for extra in ([], ["--metric"]):
        ref = run_one(ref_cmd, cwd=str(REPO), extra=extra)
        got = run_one(ours, cwd=str(REPO), extra=extra)
        if ref != got:
            log(f"DIFF ({extra})\nref:  {ref!r}\nours: {got!r}")
            return False
        if ref.count(b'"hex"') != 1 or b'"lat":0' in ref:
            log(f"unexpected /data.json ({extra}): {ref!r}")
            return False
        log(f"ok: /data.json identical with {extra or 'defaults'} ({ref!r})")
    return True


def main(argv=None) -> int:
    from .refbuild import reference_command

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ref", default=None, help="the oracle's command (default: the reference)")
    args = ap.parse_args(argv)
    return 0 if diff(reference_command(args.ref), ours_cmd()) else 1


if __name__ == "__main__":
    sys.exit(main())
