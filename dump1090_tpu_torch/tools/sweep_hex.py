"""Exhaustive field-domain differentials through the live hex-input path,
the port's CLI against an oracle that speaks the reference's CLI (a port of
tools/sweep_hex.py).

Where fuzz_hex.py samples the message space at random, this sweeps one
decoded field over its entire domain: every code becomes a real message fed
over TCP to both decoders, and the raw relay, SBS and verbose stdout
streams are byte-diffed (fuzz_hex.run_decoder).  Sweeps:

  ac13      all 8192 13-bit altitude codes in DF4 replies
            (decodeAC13Field, dump1090.c:988-1012)
  ac12      all 4096 12-bit altitude codes in DF17 airborne positions
            (decodeAC12Field, dump1090.c:1016-1031)
  id13      all 8192 13-bit identity codes in DF5 replies: the squawk bit
            shuffle (dump1090.c:1150-1178) and the SBS emergency flag
  movement  all surface movement codes in DF17 surface positions
            (decodeMovementField, dump1090.c:2056-2066)
  fsdr      all FS x DR/UM-adjacent header combinations in DF4
  velocity  DF17 ground velocity edges (dump1090.c:1275-1296)
  airspeed  every DF17 airspeed heading, valid bit both ways
  callsign  every AIS charset code in every callsign slot
  df11      DF11 across the syndrome < 80 IID acceptance boundary

DF4, DF5 and DF11 frames are keyed to an ICAO address first cached by a
clean DF17, so both decoders accept them.

    python -m dump1090_tpu_torch.tools.sweep_hex [--sweep all|NAME] [--ref CMD] [--out DIR]

`--net-only` does no device work, so the port's CLI runs with its default
device and needs no card.
"""

from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path

import numpy as np

from .fuzz_hex import REPO, _crc, compare, first_diff, oracle_cmd, run_decoder
from .net_capture import ours_cmd

ADDR = 0x4D2023


def _cache_line() -> bytes:
    from ..utils.synth import make_df17_frame

    return b"*" + make_df17_frame(addr=ADDR).hex().encode() + b";\n"


def _short_keyed(df: int, b1: int, b2: int, b3: int) -> bytes:
    head = bytes([df << 3, b1, b2, b3])
    ap = _crc(head + b"\x00\x00\x00", 56) ^ ADDR
    frame = head + bytes([(ap >> 16) & 0xFF, (ap >> 8) & 0xFF, ap & 0xFF])
    return b"*" + frame.hex().encode() + b";\n"


def stream_ac13() -> bytes:
    # DF4: AC13 is bits 19-31 = low 5 bits of msg[2] + all of msg[3].
    out = [_cache_line()]
    for code in range(8192):
        out.append(_short_keyed(4, 0, (code >> 8) & 0x1F, code & 0xFF))
    return b"".join(out)


def stream_id13() -> bytes:
    # DF5: the 13-bit identity field sits in the same bit positions.
    out = [_cache_line()]
    for code in range(8192):
        out.append(_short_keyed(5, 0, (code >> 8) & 0x1F, code & 0xFF))
    return b"".join(out)


def stream_fsdr() -> bytes:
    # DF4 header byte1: FS (3 bits) + DR high 2; byte2 top 3 = DR low/UM.
    out = [_cache_line()]
    for b1 in range(256):
        for b2_hi in (0, 0xE0):
            out.append(_short_keyed(4, b1, b2_hi | 0x05, 0xAA))
    return b"".join(out)


def stream_ac12() -> bytes:
    from ..utils.synth import make_df17_frame

    # DF17 airborne position (metype 11): AC12 = msg[5] + msg[6]>>4.
    out = []
    for code in range(4096):
        me = bytes([(code >> 4) & 0xFF, ((code & 0xF) << 4) | 0x3,
                    0x12, 0x34, 0x56, 0x78])
        f = make_df17_frame(addr=ADDR, metype=11, mesub=0, me_payload=me)
        out.append(b"*" + f.hex().encode() + b";\n")
    return b"".join(out)


def stream_movement() -> bytes:
    from ..utils.synth import make_df17_frame

    # DF17 surface position (metype 5-8): movement = (msg[4]&7)<<4 |
    # msg[5]>>4 (dump1090.c:1248), i.e. the mesub bits + ME byte1 top
    # nibble; the low nibble carries track-status/track bits, varied too.
    out = []
    for metype in (5, 6, 7, 8):
        for mov in range(128):
            me = bytes([((mov & 0xF) << 4) | ((mov * 3) & 0xF),
                        (mov * 5) & 0xFF, 0x12, 0x34, 0x56, 0x78])
            f = make_df17_frame(addr=ADDR, metype=metype,
                                mesub=(mov >> 4) & 7, me_payload=me)
            out.append(b"*" + f.hex().encode() + b";\n")
    return b"".join(out)


def stream_velocity() -> bytes:
    from ..utils.synth import make_df17_frame

    # DF17 type 19 subtype 1/2 (ground velocity, dump1090.c:1275-1296):
    # edge-cross EW x NS magnitudes with both direction bits, cycling the
    # vertical-rate field — covers sqrt/atan2 heading, the *-1 direction
    # flips, the 360-wrap, and vert-rate sign/source rendering.
    edges = (0, 1, 2, 3, 5, 100, 511, 512, 777, 1022, 1023)
    vrs = (0, 1, 2, 100, 510, 511)
    out = []
    k = 0
    for ew in edges:
        for ns in edges:
            for dirbits in range(4):
                vr = vrs[k % len(vrs)]
                vr_sign = (k >> 1) & 1
                k += 1
                me = bytes([
                    ((dirbits & 1) << 2) | ((ew >> 8) & 3), ew & 0xFF,
                    ((dirbits & 2) << 6) | ((ns >> 3) & 0x7F),
                    ((ns & 7) << 5) | ((k & 1) << 4) | (vr_sign << 3)
                    | ((vr >> 6) & 7),
                    (vr & 0x3F) << 2, 0x55,
                ])
                f = make_df17_frame(addr=ADDR, metype=19,
                                    mesub=1 + (k % 2), me_payload=me)
                out.append(b"*" + f.hex().encode() + b";\n")
    return b"".join(out)


def stream_airspeed() -> bytes:
    from ..utils.synth import make_df17_frame

    # DF17 type 19 subtype 3/4: every 10-bit heading value with the
    # heading-valid bit both ways (heading * 360/1024 truncation).
    out = []
    for hdg in range(1024):
        for valid in (0, 4):
            me = bytes([valid | ((hdg >> 8) & 3), hdg & 0xFF,
                        0x22, 0x33, 0x44, 0x55])
            f = make_df17_frame(addr=ADDR, metype=19, mesub=3 + (hdg & 1),
                                me_payload=me)
            out.append(b"*" + f.hex().encode() + b";\n")
    return b"".join(out)


def stream_callsign() -> bytes:
    from ..utils.synth import make_df17_frame

    # DF17 type 1-4 (identification): every AIS charset code (64) in every
    # of the 8 callsign slots — pins the '?'-substitution table and the
    # SBS/display rendering of partial/garbage callsigns.
    out = []
    for slot in range(8):
        for code in range(64):
            bits = 0
            for s in range(8):
                bits = (bits << 6) | (code if s == slot else 0x31)  # '1'
            me = bits.to_bytes(6, "big")
            f = make_df17_frame(addr=ADDR, metype=1 + (code % 4),
                                mesub=code % 8, me_payload=me)
            out.append(b"*" + f.hex().encode() + b";\n")
    return b"".join(out)


def stream_df11() -> bytes:
    from ..ops.crc import compute_crc

    # DF11 with every CA and syndromes 0..127: crosses the syndrome<80 IID
    # acceptance boundary (dump1090.c:1203-1209); the address is cached by
    # a clean DF17 first so the IID path's cache test passes.
    out = [_cache_line()]
    for ca in range(8):
        for syn in range(128):
            head = bytes([(11 << 3) | ca, (ADDR >> 16) & 0xFF,
                          (ADDR >> 8) & 0xFF, ADDR & 0xFF])
            crc = compute_crc(np.frombuffer(head + b"\x00\x00\x00",
                                            np.uint8), 56) ^ syn
            frame = head + bytes([(crc >> 16) & 0xFF, (crc >> 8) & 0xFF,
                                  crc & 0xFF])
            out.append(b"*" + frame.hex().encode() + b";\n")
    return b"".join(out)


SWEEPS = {"ac13": stream_ac13, "ac12": stream_ac12, "id13": stream_id13,
          "movement": stream_movement, "fsdr": stream_fsdr,
          "velocity": stream_velocity, "airspeed": stream_airspeed,
          "callsign": stream_callsign, "df11": stream_df11}


def sweep(name: str, ref_cmd: list[str], ours: list[str], out_dir: Path | None = None,
          log=print) -> bool:
    """One sweep through both decoders; True when the raw relay, the SBS
    stream and stdout agree.  A failing sweep's outputs are saved under
    `out_dir`."""
    stream = SWEEPS[name]()
    ref = run_decoder(oracle_cmd(ref_cmd), stream, cwd=str(REPO), timeout=300.0)
    got = run_decoder(ours, stream, cwd=str(REPO), timeout=300.0)
    bad = compare(ref, got)
    if not bad:
        log(f"[{name}] ok ({stream.count(b';')} msgs, {ref[2].count(b'CRC')} displayed identical)")
        return True
    if out_dir is not None:
        for side, streams in (("ref", ref), ("ours", got)):
            for lbl, data in zip(("raw", "sbs", "std"), streams):
                (Path(out_dir) / f"sweep_{name}_{side}.{lbl}").write_bytes(data)
    i = ("raw", "sbs", "stdout").index(bad[0])
    log(f"[{name}] {first_diff(bad[0], ref[i], got[i])}")
    log(f"[{name}] FAIL on {bad}")
    return False


def main(argv=None) -> int:
    from .refbuild import reference_command

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ref", default=None, help="the oracle's command (default: the reference)")
    ap.add_argument("--sweep", default="all", choices=["all"] + sorted(SWEEPS))
    ap.add_argument("--out", default=os.curdir, help="directory for a failing sweep's files")
    args = ap.parse_args(argv)
    ref_cmd = reference_command(args.ref)

    names = sorted(SWEEPS) if args.sweep == "all" else [args.sweep]
    fails = sum(not sweep(name, ref_cmd, ours_cmd(), Path(args.out))
                for name in names)
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
