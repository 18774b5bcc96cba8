"""`*<hex>;\\n` formatting of decoded frames (a copy of
dump1090_tpu/native/__init__.py::raw_lines_from_fields, which is numpy only:
the port needs none of that package's C++ runtime on the raw path)."""

from __future__ import annotations

import numpy as np


def raw_lines_from_fields(
    msg: np.ndarray, msgbits: np.ndarray, crcok: np.ndarray, upper: bool = False
) -> bytes:
    """`*<hex>;\\n` stream for (N, 14) message bytes + per-message bit lengths,
    keeping only crcok rows — the bulk form of displayModesMessage's --raw
    branch (dump1090.c:1317-1324).  Fully vectorized: every line is built in
    a fixed 31-byte row (hex arithmetic, no table gathers), short messages
    get their terminator rewritten in place, and the variable-length stream
    is a single boolean compaction of the row matrix."""
    ok = np.asarray(crcok)
    if ok.all():  # device-resolve path: rows are pre-filtered
        m = np.ascontiguousarray(msg)
        bits_ok = np.asarray(msgbits)
    else:
        m = np.ascontiguousarray(np.asarray(msg)[ok])
        bits_ok = np.asarray(msgbits)[ok]
    n = m.shape[0]
    if n == 0:
        return b""
    a_off = np.uint8((ord("A") if upper else ord("a")) - 10)

    def hexd(v: np.ndarray) -> np.ndarray:
        return v + np.where(v < 10, np.uint8(ord("0")), a_off)

    buf = np.empty((n, 31), dtype=np.uint8)
    buf[:, 0] = ord("*")
    buf[:, 1:29:2] = hexd(m >> 4)
    buf[:, 2:29:2] = hexd(m & 0xF)
    buf[:, 29] = ord(";")
    buf[:, 30] = ord("\n")
    short = bits_ok != 112
    if not short.any():
        return buf.tobytes()
    buf[short, 15] = ord(";")
    buf[short, 16] = ord("\n")
    keep = np.arange(31)[None, :] < np.where(short, 17, 31)[:, None]
    return buf[keep].tobytes()
