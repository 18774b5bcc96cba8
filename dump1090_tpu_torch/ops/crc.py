"""Mode S CRC-24 and the syndrome error table (numpy, host side).

Behavioral contract: dump1090.c:663-894 (checksum table :683-698, CRC
:703-742, syndrome table build :795-841, fixBitErrors :854-894).  A copy of
the numpy parts of dump1090_tpu/ops/crc.py: the port builds its device
tables (the GF(2) bit matrices and the dense syndrome -> fix table of
ops/resolve.py) from these, the host decode of raw network input
(models/decoder.py decode_message) fixes bit errors with fix_bit_errors,
and the tests hold them equal to the JAX package's.

The table is derived from the generator polynomial (not copied):
entry[k] = x^(111-k) mod g(x) for the 88 data bits of a long frame, 0 for the
24 checksum bits.
"""

from __future__ import annotations

import functools

import numpy as np

from ..constants import (
    CRC_POLY,
    ERRORBITS_FIRST,
    LONG_MSG_BITS,
    N_ERRORINFO,
    SHORT_MSG_BITS,
)


@functools.cache
def checksum_table() -> np.ndarray:
    """The 112-entry CRC-24 generator expansion (uint32).

    entry[k] is the 24-bit CRC contribution of message bit k of a 112-bit
    frame; the last 24 entries (the transmitted checksum itself) are zero.
    T[111-24] = g(x) - x^24 (= CRC_POLY) and
    T[k-1] = (T[k] << 1) ^ (CRC_POLY if bit 23 of T[k] else 0).
    """
    table = np.zeros(LONG_MSG_BITS, dtype=np.uint64)
    rem = int(CRC_POLY)  # x^24 mod g(x), the contribution of the last data bit
    for k in range(LONG_MSG_BITS - 24 - 1, -1, -1):
        table[k] = rem
        rem <<= 1
        if rem & (1 << 24):
            rem ^= (1 << 24) | CRC_POLY
    return table.astype(np.uint32)


@functools.cache
def checksum_bit_matrix() -> np.ndarray:
    """(112, 24) uint8 bit-expansion of checksum_table(); column b is bit
    (23-b) of each entry, so a GF(2) product with a (B, 112) bit matrix
    yields the 24 CRC bits MSB first."""
    table = checksum_table()
    shifts = np.arange(23, -1, -1, dtype=np.uint32)
    return ((table[:, None] >> shifts[None, :]) & 1).astype(np.uint8)


def bytes_to_bits(msgs: np.ndarray) -> np.ndarray:
    """(B, nbytes) uint8 -> (B, nbytes*8) bits, MSB first."""
    msgs = np.atleast_2d(np.asarray(msgs, dtype=np.uint8))
    return np.unpackbits(msgs, axis=1)


def compute_crc(msg: np.ndarray, bits: int) -> int:
    """CRC of the data portion only (dump1090.c:703-719). msg: uint8 bytes."""
    b = bytes_to_bits(np.asarray(msg, dtype=np.uint8).reshape(1, -1))[0]
    offset = 0 if bits == LONG_MSG_BITS else LONG_MSG_BITS - SHORT_MSG_BITS
    table = checksum_table()
    sel = table[offset : offset + bits - 24][b[: bits - 24] == 1]
    return int(np.bitwise_xor.reduce(sel, initial=np.uint32(0)) & 0xFFFFFF)


def checksum(msg: np.ndarray, bits: int) -> int:
    """24-bit syndrome: CRC of data bits XOR transmitted CRC
    (dump1090.c:733-742). Zero for a clean frame."""
    msg = np.asarray(msg, dtype=np.uint8)
    crc = compute_crc(msg, bits)
    nb = bits // 8
    rem = (int(msg[nb - 3]) << 16) | (int(msg[nb - 2]) << 8) | int(msg[nb - 1])
    return (crc ^ rem) & 0xFFFFFF


def batch_syndromes(msgs: np.ndarray, bits: int) -> np.ndarray:
    """Vectorized syndromes of a (B, 14) batch of frames (numpy, host side):
    the GF(2) product of checksum_bit_matrix() with the data bits, XOR the
    transmitted CRC.  uint32[B]."""
    msgs = np.atleast_2d(np.asarray(msgs, dtype=np.uint8))
    b = np.unpackbits(msgs[:, : bits // 8], axis=1)
    offset = 0 if bits == LONG_MSG_BITS else LONG_MSG_BITS - SHORT_MSG_BITS
    bitmat = checksum_bit_matrix()[offset : offset + bits - 24]  # (bits-24, 24)
    crc_bits = (b[:, : bits - 24].astype(np.int32) @ bitmat.astype(np.int32)) & 1
    weights = 1 << np.arange(23, -1, -1, dtype=np.int64)
    crc = (crc_bits.astype(np.int64) * weights).sum(axis=1)
    nb = bits // 8
    rem = (
        (msgs[:, nb - 3].astype(np.int64) << 16)
        | (msgs[:, nb - 2].astype(np.int64) << 8)
        | msgs[:, nb - 1].astype(np.int64)
    )
    return (crc ^ rem).astype(np.uint32)


@functools.cache
def bit_error_table() -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Precomputed (syndrome, nbits, pos0, pos1) arrays, sorted by syndrome.

    Build order and sort match the reference exactly (dump1090.c:795-841):
    single-bit entry for bit i, then double-bit entries (i, j>i), for
    i in [5, 112); sorted by syndrome.  glibc qsort is a stable mergesort, so
    ties keep insertion order; a stable argsort does the same — with
    duplicate syndromes the entry found by the bsearch emulation below must
    be the one the reference finds.
    """
    table = checksum_table()

    syndromes = np.zeros(N_ERRORINFO, dtype=np.uint32)
    nbits = np.zeros(N_ERRORINFO, dtype=np.int8)
    pos0 = np.zeros(N_ERRORINFO, dtype=np.int8)
    pos1 = np.full(N_ERRORINFO, -1, dtype=np.int8)

    def flip_syndrome(positions) -> int:
        """Syndrome of an all-zero long frame with the given bits flipped:
        data-bit flips contribute table[p]; flips inside the transmitted CRC
        (bits 88..111) contribute the corresponding CRC bit directly."""
        s = 0
        for p in positions:
            if p < LONG_MSG_BITS - 24:
                s ^= int(table[p])
            else:
                s ^= 1 << (LONG_MSG_BITS - 1 - p)
        return s & 0xFFFFFF

    n = 0
    for i in range(ERRORBITS_FIRST, LONG_MSG_BITS):
        syndromes[n] = flip_syndrome((i,))
        nbits[n] = 1
        pos0[n] = i
        n += 1
        for j in range(i + 1, LONG_MSG_BITS):
            if n >= N_ERRORINFO:
                break
            syndromes[n] = flip_syndrome((i, j))
            nbits[n] = 2
            pos0[n] = i
            pos1[n] = j
            n += 1
    if n != N_ERRORINFO:
        raise AssertionError(f"built {n} syndrome entries, expected {N_ERRORINFO}")

    order = np.argsort(syndromes, kind="stable")
    return syndromes[order], nbits[order], pos0[order], pos1[order]


def _glibc_bsearch(sorted_syndromes: np.ndarray, key: int) -> int:
    """Emulate glibc bsearch's probe sequence so that, among duplicate
    syndromes, we land on the same entry the reference lands on
    (dump1090.c:862-865)."""
    lo, hi = 0, len(sorted_syndromes)
    while lo < hi:
        mid = (lo + hi) >> 1
        v = int(sorted_syndromes[mid])
        if key < v:
            hi = mid
        elif key > v:
            lo = mid + 1
        else:
            return mid
    return -1


def fix_bit_errors(msg: np.ndarray, bits: int, maxfix: int) -> list[int]:
    """Correct up to `maxfix` bit errors in-place; returns the list of fixed
    bit positions (empty if uncorrectable).  dump1090.c:854-894."""
    syndromes, nbits, pos0, pos1 = bit_error_table()
    idx = _glibc_bsearch(syndromes, checksum(msg, bits))
    if idx < 0:
        return []
    k = int(nbits[idx])
    if k > maxfix:
        return []
    offset = LONG_MSG_BITS - bits
    positions = [int(pos0[idx])] + ([int(pos1[idx])] if k == 2 else [])
    rel = [p - offset for p in positions]
    if any(p < 0 or p >= bits for p in rel):
        return []
    for p in rel:
        msg[p >> 3] ^= 1 << (7 - (p & 7))
    return rel
