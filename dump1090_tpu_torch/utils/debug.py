"""Debug visualizers: ASCII magnitude dumps and frames.js records (a copy of
dump1090_tpu/utils/debug.py).

Behavioral contract: dump1090.c:529-661 (dumpMagnitudeBar :543,
dumpMagnitudeVector :576, dumpRawMessageJS :589, dumpRawMessage :633) and the
--debug flag dispatch inside detectModeS (dump1090.c:1597-1791).

Output formatting is byte-identical to the reference.  One documented
divergence: the reference's "no preamble" dumps print whatever stale bytes
its scratch msg[] buffer holds (uninitialized C memory before the first
bit-slice of a buffer); we print the previous candidate's sliced bytes, with
zeros before any candidate.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass

import numpy as np

from ..constants import (
    LONG_MSG_BITS,
    LONG_MSG_BYTES,
    MAX_BITERRORS,
    PREAMBLE_SAMPLES,
    SHORT_MSG_BITS,
    SHORT_MSG_BYTES,
    message_bits_for_df,
)
from ..ops import crc as crc_ops

DEBUG_NOPREAMBLE_LEVEL = 25  # dump1090.c:88


@dataclass
class DebugFlags:
    """Parsed --debug flag set (dump1090.c:2904-2921)."""

    demod: bool = False       # D
    demoderr: bool = False    # d
    badcrc: bool = False      # c
    goodcrc: bool = False     # C
    nopreamble: bool = False  # p
    net: bool = False         # n
    js: bool = False          # j

    @classmethod
    def parse(cls, flags: str) -> "DebugFlags":
        return cls(
            demod="D" in flags,
            demoderr="d" in flags,
            badcrc="c" in flags,
            goodcrc="C" in flags,
            nopreamble="p" in flags,
            net="n" in flags,
            js="j" in flags,
        )

    @property
    def any_demod_dump(self) -> bool:
        return self.demod or self.demoderr or self.badcrc or self.goodcrc or \
            self.nopreamble or self.js


def dump_magnitude_bar(index: int, magnitude: int) -> str:
    """One ASCII bar (dumpMagnitudeBar, dump1090.c:543-565)."""
    charset = " .-o"
    div = magnitude // 256 // 4
    rem = magnitude // 256 % 4
    bar = "O" * div + charset[rem]
    if index >= 0:
        markchar = "]"
        if index in (0, 2, 7, 9):
            markchar = ">"
        if index >= 16:
            markchar = "|" if ((index - 16) // 2) & 1 else ")"
        return "[%.3d%c |%-66s %d\n" % (index, markchar, bar, magnitude)
    return "[%.2d] |%-66s %d\n" % (index, bar, magnitude)


def dump_magnitude_vector(m: np.ndarray, offset: int) -> str:
    """ASCII waveform covering preamble + short message
    (dumpMagnitudeVector, dump1090.c:576-585)."""
    padding = 5
    start = 0 if offset < padding else offset - padding
    end = offset + PREAMBLE_SAMPLES + SHORT_MSG_BITS * 2 - 1
    return "".join(
        dump_magnitude_bar(j - offset, int(m[j])) for j in range(start, end + 1)
    )


def _fixable(msg: np.ndarray) -> int:
    """Re-run the corrector on a copy to report fixability
    (dumpRawMessage, dump1090.c:639-646): -1 not applicable, else the number
    of bits a maxfix=2 correction would flip (0 if uncorrectable)."""
    msgtype = int(msg[0]) >> 3
    if msgtype not in (11, 17, 18):
        return -1
    msgbits = SHORT_MSG_BITS if msgtype == 11 else LONG_MSG_BITS
    aux = msg.copy()
    return len(crc_ops.fix_bit_errors(aux, msgbits, MAX_BITERRORS))


def dump_raw_message(
    descr: str,
    msg: np.ndarray,
    m: np.ndarray,
    offset: int,
    *,
    js: bool = False,
    out=None,
    frames_path: str = "frames.js",
) -> None:
    """dumpRawMessage (dump1090.c:633-661): hex + fixability + waveform to
    stdout, or a frames.js record when the j flag is set."""
    out = out or sys.stdout
    msg = np.asarray(msg, dtype=np.uint8)
    fixable = _fixable(msg)
    if js:
        _dump_raw_message_js(descr, msg, m, offset, fixable, frames_path)
        return
    parts = [f"\n--- {descr}\n    "]
    for j in range(LONG_MSG_BYTES):
        parts.append("%02x" % int(msg[j]))
        if j == SHORT_MSG_BYTES - 1:
            parts.append(" ... ")
    parts.append(" (DF %d, Fixable: %d)\n" % (int(msg[0]) >> 3, fixable))
    parts.append(dump_magnitude_vector(m, offset))
    parts.append("---\n\n")
    out.write("".join(parts))


def _dump_raw_message_js(
    descr: str, msg: np.ndarray, m: np.ndarray, offset: int, fixable: int,
    frames_path: str,
) -> None:
    """dumpRawMessageJS (dump1090.c:589-619): append one frames.push record."""
    padding = 5
    start = offset - padding
    end = offset + PREAMBLE_SAMPLES + LONG_MSG_BITS * 2 - 1
    fix1, fix2 = -1, -1
    if fixable != -1:
        fix1 = fixable & 0xFF
        if fixable > 255:
            fix2 = fixable >> 8
    mags = ",".join(
        str(0 if j < 0 else int(m[j])) for j in range(start, end + 1)
    )
    bits = message_bits_for_df(int(msg[0]) >> 3)
    hexstr = "".join("\\x%02x" % int(b) for b in msg[:LONG_MSG_BYTES])
    with open(frames_path, "a") as fp:
        fp.write(
            'frames.push({"descr": "%s", "mag": [%s], "fix1": %d, "fix2": %d,'
            ' "bits": %d, "hex": "%s"});\n'
            % (descr, mags, fix1, fix2, bits, hexstr)
        )
