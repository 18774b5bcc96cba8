"""Mode S air-interface constants, the CRC-24 and the syndrome table of
the plain reference decoder (NumPy; imports nothing of the program).

Behavioral contract: antirez/dump1090, dump1090.c:49-95 (constants),
663-894 (checksum table, CRC, syndrome table, fixBitErrors).  The checksum
table is derived from the generator polynomial, not copied.
"""

from __future__ import annotations

import functools

import numpy as np

SAMPLE_RATE = 2_000_000
LONG_MSG_BITS = 112
SHORT_MSG_BITS = 56
LONG_MSG_BYTES = 14
PREAMBLE_US = 8
PREAMBLE_SAMPLES = 16
FULL_LEN_SAMPLES = 240
BIT_REPEAT_DELTA = 256
NOISE_GATE = 10 * 255
DATA_LEN_BYTES = 16 * 16384                  # 256 KiB of IQ a buffer
BLOCK_SAMPLES = DATA_LEN_BYTES // 2          # 131,072 new samples a buffer
CARRY_SAMPLES = (PREAMBLE_US + LONG_MSG_BITS - 1) * 2   # 238
CARRY_BYTES = CARRY_SAMPLES * 2              # 476
BUF_SAMPLES = BLOCK_SAMPLES + CARRY_SAMPLES  # 131,310
BUF_BYTES = DATA_LEN_BYTES + CARRY_BYTES     # 262,620
SCAN_LEN = BUF_SAMPLES - FULL_LEN_SAMPLES    # 131,070 scan positions
BUFFER_SECONDS = BLOCK_SAMPLES / SAMPLE_RATE  # 65.536 ms of air a buffer
CRC_POLY = 0xFFF409
ERRORBITS_FIRST = 5
N_ERRORINFO = 5778
ICAO_CACHE_LEN = 1024
ICAO_CACHE_TTL = 60
DF11_IID_MAX_SYNDROME = 80
LONG_DFS = (16, 17, 18, 19, 20, 21)
AP_DFS = (0, 4, 5, 16, 20, 21, 24)
AIS_CHARSET = "?ABCDEFGHIJKLMNOPQRSTUVWXYZ????? ???????????????0123456789??????"


def message_bits(df: int) -> int:
    """Frame length in bits by downlink format (dump1090.c:746-753)."""
    return LONG_MSG_BITS if df in LONG_DFS else SHORT_MSG_BITS


@functools.cache
def checksum_table() -> np.ndarray:
    """entry[k]: the CRC contribution of bit k of a 112-bit frame; 0 for the
    24 parity bits (dump1090.c:683-698)."""
    table = np.zeros(LONG_MSG_BITS, dtype=np.int64)
    rem = CRC_POLY
    for k in range(LONG_MSG_BITS - 25, -1, -1):
        table[k] = rem
        rem <<= 1
        if rem & (1 << 24):
            rem ^= (1 << 24) | CRC_POLY
    return table


@functools.cache
def _bit_matrix() -> np.ndarray:
    """(112, 24) bits of checksum_table(), most significant first."""
    shifts = np.arange(23, -1, -1)
    return ((checksum_table()[:, None] >> shifts) & 1).astype(np.float32)


def syndromes(msgs: np.ndarray, bits: np.ndarray) -> np.ndarray:
    """int64 syndromes (CRC of the data bits XOR the transmitted parity) of
    uint8 frames (N, 14) of per-row length `bits` (56 or 112)."""
    msgs = np.asarray(msgs, dtype=np.uint8)
    bits = np.asarray(bits)
    out = np.zeros(msgs.shape[0], dtype=np.int64)
    weights = 1 << np.arange(23, -1, -1, dtype=np.int64)
    for nbits in (SHORT_MSG_BITS, LONG_MSG_BITS):
        sel = np.nonzero(bits == nbits)[0]
        if sel.size == 0:
            continue
        nb = nbits // 8
        m = msgs[sel, :nb]
        b = np.unpackbits(m, axis=1)[:, : nbits - 24].astype(np.float32)
        off = LONG_MSG_BITS - nbits
        crc_bits = (b @ _bit_matrix()[off : off + nbits - 24]).astype(np.int64) & 1
        crc = crc_bits @ weights
        parity = (m[:, nb - 3].astype(np.int64) << 16) | (m[:, nb - 2].astype(np.int64) << 8) \
            | m[:, nb - 1].astype(np.int64)
        out[sel] = crc ^ parity
    return out


def syndrome(msg: bytes | bytearray, nbits: int) -> int:
    """The syndrome of one frame, in plain Python integers."""
    table = checksum_table()
    off = LONG_MSG_BITS - nbits
    crc = 0
    for k in range(nbits - 24):
        if (msg[k >> 3] >> (7 - (k & 7))) & 1:
            crc ^= int(table[off + k])
    nb = nbits // 8
    return crc ^ ((msg[nb - 3] << 16) | (msg[nb - 2] << 8) | msg[nb - 1])


@functools.cache
def fix_table() -> dict[int, tuple[int, ...]]:
    """syndrome -> the bit positions (of a 112-bit frame) the reference flips
    for it: the single- and double-bit entries for bits 5..111, built and
    stably sorted as dump1090.c:795-841 builds them, and for a syndrome
    held by several entries the one glibc's bsearch probes first
    (dump1090.c:862-865)."""
    table = checksum_table()

    def syn(positions) -> int:
        s = 0
        for p in positions:
            s ^= int(table[p]) if p < LONG_MSG_BITS - 24 else 1 << (LONG_MSG_BITS - 1 - p)
        return s & 0xFFFFFF

    entries = []
    for i in range(ERRORBITS_FIRST, LONG_MSG_BITS):
        entries.append((syn((i,)), (i,)))
        for j in range(i + 1, LONG_MSG_BITS):
            if len(entries) >= N_ERRORINFO:
                break
            entries.append((syn((i, j)), (i, j)))
    entries.sort(key=lambda e: e[0])  # stable, as glibc's qsort (a mergesort)
    keys = [e[0] for e in entries]
    found: dict[int, tuple[int, ...]] = {}
    for key in set(keys):
        lo, hi = 0, len(keys)
        while lo < hi:
            mid = (lo + hi) >> 1
            if key < keys[mid]:
                hi = mid
            elif key > keys[mid]:
                lo = mid + 1
            else:
                found[key] = entries[mid][1]
                break
    return found
