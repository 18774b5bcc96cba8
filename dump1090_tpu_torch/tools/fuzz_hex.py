"""Differential fuzzing of the hex raw-input path (port 30001 -> the 30002
relay, the SBS feed and the verbose display), the port's CLI against an
oracle that speaks the reference's CLI (a port of tools/fuzz_hex.py).

Spawns both decoders in `--net-only` mode, feeds both the same randomized
byte stream on the raw-input port, and byte-diffs the raw-output relay, the
SBS stream (MSG,3 positions canonicalized, see net_capture.py) and stdout.
Covers the grammar of decodeHexMessage (dump1090.c:2472-2502): framing,
whitespace trim, hex case, length and parity rejects, NUL truncation; the
1 KiB client-buffer reset (dump1090.c:2708-2714), the CRC fix path, the
ICAO-cache / bruteForceAP acceptance chain for DF0/4/5/16/20/21/24, and the
DF11 IID rule, under sequences where cache state chains across lines.

Grammar restriction for determinism: the reference decodes hex payloads
shorter than the DF's message length by reading uninitialized stack bytes
(dump1090.c:2475, 2493-2499), so recipes always supply at least the DF's
byte count.

    python -m dump1090_tpu_torch.tools.fuzz_hex [--ref CMD] [--n 400] [--seed 0]
        [--rounds 3] [--mode default|aggressive|no-fix] [--out DIR]

--ref is the oracle's command (default: the reference binary, see
refbuild.py).  `--net-only` does no device work, so the port's CLI runs
with its default device and needs no card.  A failing round's streams are
saved under --out.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np

from .net_capture import canonicalize_sbs, connect, free_ports, ours_cmd

REPO = Path(__file__).resolve().parents[2]
SENTINEL = b"*8f4d2023991093ad087c133060d1;"  # a clean DF17
SENTINEL_OUT = b"*" + SENTINEL[1:-1].upper() + b";"
MODE_FLAGS = {"default": [], "aggressive": ["--aggressive"], "no-fix": ["--no-fix"]}


def _crc(msg: bytes, bits: int) -> int:
    from ..ops.crc import compute_crc

    return compute_crc(np.frombuffer(msg, dtype=np.uint8), bits)


def make_df17(rng: np.random.Generator, addr: int | None = None) -> bytes:
    from ..utils.synth import make_df17_frame

    return make_df17_frame(
        addr=int(rng.integers(1, 1 << 24)) if addr is None else addr,
        metype=int(rng.integers(1, 23)),
        mesub=int(rng.integers(0, 8)),
        me_payload=rng.integers(0, 256, 6, dtype=np.uint8).tobytes(),
    )


def make_short_ap(rng: np.random.Generator, addr: int, df: int) -> bytes:
    """A 7-byte DF0/4/5/24 frame whose Address/Parity field targets `addr`:
    accepted iff addr is in the ICAO cache (bruteForceAP, dump1090.c:942)."""
    head = bytes([df << 3]) + rng.integers(0, 256, 3, dtype=np.uint8).tobytes()
    ap = _crc(head + b"\x00\x00\x00", 56) ^ addr
    return head + bytes([(ap >> 16) & 0xFF, (ap >> 8) & 0xFF, ap & 0xFF])


def make_long_ap(rng: np.random.Generator, addr: int, df: int) -> bytes:
    """A 14-byte DF16/20/21 frame AP-keyed to `addr` (the long bruteForceAP
    branch, dump1090.c:955-960), with a random MB field."""
    head = bytes([df << 3]) + rng.integers(0, 256, 10, dtype=np.uint8).tobytes()
    ap = _crc(head + b"\x00\x00\x00", 112) ^ addr
    return head + bytes([(ap >> 16) & 0xFF, (ap >> 8) & 0xFF, ap & 0xFF])


def hexline(frame: bytes, rng: np.random.Generator) -> bytes:
    h = frame.hex()
    style = rng.integers(0, 4)
    if style == 1:
        h = h.upper()
    elif style == 2:
        h = "".join(c.upper() if rng.integers(0, 2) else c for c in h)
    pre = bytes(rng.choice([32, 9, 13], size=int(rng.integers(0, 3))).astype(np.uint8))
    post = bytes(rng.choice([32, 9, 13], size=int(rng.integers(0, 3))).astype(np.uint8))
    return pre + b"*" + h.encode() + b";" + post + b"\n"


def gen_stream(rng: np.random.Generator, n: int) -> bytes:
    """A byte stream of n 'lines' mixing valid, fixable and garbage input:
    the JAX tool's bytes for the same generator state."""
    out = []
    cached: list[int] = []
    for _ in range(n):
        r = int(rng.integers(0, 100))
        if r < 30:  # clean DF17 (enters the ICAO cache)
            f = make_df17(rng)
            cached.append(int.from_bytes(f[1:4], "big"))
            out.append(hexline(f, rng))
        elif r < 45:  # DF17 with 1-2 bit flips (fix path; not cached by the reference)
            f = bytearray(make_df17(rng))
            for _ in range(int(rng.integers(1, 3))):
                b = int(rng.integers(5, 112))
                f[b // 8] ^= 0x80 >> (b % 8)
            out.append(hexline(bytes(f), rng))
        elif r < 60 and cached:  # AP-keyed frame targeting a cached address
            addr = cached[int(rng.integers(0, len(cached)))]
            if rng.integers(0, 3):  # short DF0/4/5/24 (DF24: 56 bits, dump1090.c:746-753)
                df = int(rng.choice([0, 4, 5, 24]))
                out.append(hexline(make_short_ap(rng, addr, df), rng))
            else:  # long DF16/20/21 (air-air and Comm-B bruteForceAP branch)
                df = int(rng.choice([16, 20, 21]))
                out.append(hexline(make_long_ap(rng, addr, df), rng))
        elif r < 68:  # short frame AP-keyed to an uncached address (reject)
            out.append(hexline(make_short_ap(
                rng, int(rng.integers(1, 1 << 24)), 4), rng))
        elif r < 74:  # random full-length hex (random DF, usually bad CRC)
            nb = 14 if rng.integers(0, 2) else 7
            raw = bytearray(rng.integers(0, 256, nb, dtype=np.uint8).tobytes())
            if nb == 7:  # force a short DF so the reference reads nothing uninitialized
                raw[0] = (int(rng.choice([0, 4, 5, 11])) << 3) | (raw[0] & 7)
            out.append(hexline(bytes(raw), rng))
        elif r < 80:  # grammar rejects: bad framing / odd length / bad chars
            k = int(rng.integers(0, 5))
            if k == 0:
                out.append(b"*8d4d2023991093ad087c133060d\n")     # no ';'
            elif k == 1:
                out.append(b"8d4d2023991093ad087c133060d1;\n")    # no '*'
            elif k == 2:
                out.append(b"*8d4d2023991093ad087c133060d;\n")    # odd length
            elif k == 3:
                out.append(b"*8d4d2023991093ad087c133060dg;\n")   # bad hex
            else:
                out.append(b"*" + b"ab" * 15 + b";\n")            # >28 chars
        elif r < 86:  # embedded NUL: poisons strstr framing until the 1 KiB
            # reset; the message is not decoded and later lines are
            # swallowed until 1024 bytes accumulate
            f = make_df17(rng)
            tail = bytes(rng.integers(32, 127, int(rng.integers(1, 8)),
                                      dtype=np.uint8).tolist())
            out.append(b"*" + f.hex().encode() + b";\x00" + tail + b"\n")
        elif r < 94:  # unterminated junk (the 1 KiB buffer-reset differential)
            jl = int(rng.integers(1, 3000))
            junk = bytes(rng.choice(
                list(b"ZXYWV@#$%^&()qwerty"), size=jl).astype(np.uint8))
            if rng.integers(0, 2):  # sometimes junk||valid on one line
                out.append(junk + hexline(make_df17(rng), rng))
            else:
                out.append(junk + b"\n")
        else:  # empty-ish lines
            out.append(bytes(rng.choice([32, 9, 13], size=int(
                rng.integers(0, 4))).astype(np.uint8)) + b"\n")
    return b"".join(out)


def unbuffered_env() -> dict:
    """The environment of a decoder subprocess: a Python decoder writes its
    stdout unbuffered, so nothing is lost when it is killed."""
    return dict(os.environ, PYTHONUNBUFFERED="1")


def run_decoder(cmd: list[str], stream: bytes, cwd: str | None = None,
                timeout: float = 120.0) -> tuple[bytes, bytes, bytes]:
    """Spawn a --net-only decoder, relay `stream` and the sentinel, return
    the (raw 30002, SBS 30003, verbose stdout) output streams.

    stdout is the displayModesMessage text of every accepted message; the
    decoder must write it line-buffered or unbuffered (stdbuf -oL for a C
    binary; PYTHONUNBUFFERED is set) so the tail is not lost when it is
    killed after the sentinel relays."""
    for attempt in range(3):
        ro, ri, http_p, sbs = free_ports(4)
        full = cmd + ["--net-only", "--net-ro-port", str(ro),
                      "--net-ri-port", str(ri), "--net-http-port",
                      str(http_p), "--net-sbs-port", str(sbs)]
        proc = subprocess.Popen(full, stdin=subprocess.DEVNULL,
                                stdout=subprocess.PIPE,
                                stderr=subprocess.DEVNULL, cwd=cwd, env=unbuffered_env())
        try:
            # the outputs block: they are drained below
            out_s = connect(ro, proc, None)
            sbs_s = connect(sbs, proc, None)
            in_s = connect(ri, proc)
            time.sleep(0.2)
            # drain the outputs while feeding the input: both decoders drop
            # (the reference) or bound and then drop (the port) a client
            # whose output socket stalls
            chunks: list[bytes] = []
            sbs_chunks: list[bytes] = []
            std_chunks: list[bytes] = []
            done = threading.Event()

            def drain(sock, sink, signal=None) -> None:
                try:
                    while True:
                        b_ = sock.recv(1 << 16)
                        if not b_:
                            break
                        sink.append(b_)
                except OSError:
                    pass
                finally:
                    if signal is not None:
                        signal.set()

            def drain_pipe(pipe, sink) -> None:
                try:
                    while True:
                        b_ = pipe.read1(1 << 16)  # read() would block to EOF
                        if not b_:
                            break
                        sink.append(b_)
                except OSError:
                    pass

            threading.Thread(target=drain, args=(out_s, chunks, done), daemon=True).start()
            threading.Thread(target=drain, args=(sbs_s, sbs_chunks), daemon=True).start()
            threading.Thread(target=drain_pipe, args=(proc.stdout, std_chunks),
                             daemon=True).start()
            in_s.sendall(stream)
            # 2 KiB whitespace pad: forces at least one full-buffer reset so
            # a NUL-poisoned pending buffer (see gen_stream) is flushed and
            # the sentinel frames on both decoders
            in_s.sendall(b"\n" + b" " * 2048 + b"\n" + SENTINEL + b"\n")
            deadline = time.monotonic() + timeout
            while SENTINEL_OUT not in b"".join(chunks):
                if time.monotonic() > deadline:
                    raise RuntimeError("sentinel never relayed")
                if done.is_set():
                    raise RuntimeError("relay closed early")
                time.sleep(0.05)
            time.sleep(0.4)  # settle any queued trailing output
            return b"".join(chunks), b"".join(sbs_chunks), b"".join(std_chunks)
        except RuntimeError:
            if attempt == 2:
                raise
        finally:
            proc.kill()
            proc.wait()
    raise AssertionError("unreachable")


def oracle_cmd(ref_argv: list[str]) -> list[str]:
    """The oracle's command, line-buffered through stdbuf where it exists."""
    from shutil import which

    return (["stdbuf", "-oL"] if which("stdbuf") else []) + ref_argv


def first_diff(which: str, ref: bytes, ours: bytes) -> str:
    """A line naming the first line where two streams differ."""
    rl, ol = ref.split(b"\n"), ours.split(b"\n")
    for i, (a, b) in enumerate(zip(rl, ol)):
        if a != b:
            return f"FIRST {which} DIFF line {i}: ref={a!r} ours={b!r}"
    return f"{which} length diff: ref={len(rl)} ours={len(ol)}"


def compare(ref: tuple, ours: tuple) -> list[str]:
    """The names of the streams of two run_decoder results that differ (the
    SBS streams canonicalized: the MSG,3 CPR latch pick is racy)."""
    return [name for name, a, b in (
        ("raw", ref[0], ours[0]),
        ("sbs", canonicalize_sbs(ref[1]), canonicalize_sbs(ours[1])),
        ("stdout", ref[2], ours[2]),
    ) if a != b]


def fuzz_round(ref_cmd: list[str], ours: list[str], seed: int, n: int, mode: str,
               out_dir: Path | None = None, log=print) -> bool:
    """One round: gen_stream(seed, n) through both decoders in `mode`; True
    when the raw relay, the SBS stream and stdout agree.  A failing round's
    input and outputs are saved under `out_dir`."""
    flags = MODE_FLAGS[mode]
    stream = gen_stream(np.random.default_rng(seed), n)
    ref = run_decoder(oracle_cmd(ref_cmd) + flags, stream, cwd=str(REPO))
    got = run_decoder(ours + flags, stream, cwd=str(REPO))
    diffs = compare(ref, got)
    if not diffs:
        log(f"[{seed}] ok ({ref[0].count(b';')} relayed, {ref[1].count(b'MSG')} sbs, "
            f"{ref[2].count(b'CRC')} displayed)")
        return True
    if out_dir is not None:
        for tag, data in (("bin", stream), ("ref", ref[0]), ("ours", got[0]),
                          ("ref_sbs", ref[1]), ("ours_sbs", got[1]),
                          ("ref_std", ref[2]), ("ours_std", got[2])):
            (Path(out_dir) / f"fuzz_hex_fail_{seed}.{tag}").write_bytes(data)
    which = diffs[0]
    i = ("raw", "sbs", "stdout").index(which)
    log(f"[{seed}] {first_diff(which, ref[i], got[i])}")
    log(f"[{seed}] FAIL on {diffs}")
    return False


def main(argv=None) -> int:
    from .refbuild import reference_command

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ref", default=None, help="the oracle's command (default: the reference)")
    ap.add_argument("--n", type=int, default=400, help="lines per round")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--mode", default="default", choices=sorted(MODE_FLAGS),
                    help="CRC-fix policy passed to both decoders")
    ap.add_argument("--out", default=os.curdir, help="directory for a failing round's files")
    args = ap.parse_args(argv)
    ref_cmd = reference_command(args.ref)

    fails = sum(not fuzz_round(ref_cmd, ours_cmd(), args.seed + k, args.n,
                               args.mode, Path(args.out))
                for k in range(args.rounds))
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
