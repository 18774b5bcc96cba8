"""Decode state and configuration (a copy of IcaoCache, DecoderStats and
DecoderConfig from dump1090_tpu/models/decoder.py).

Field decoding of messages (the verbose and hub outputs) is not ported yet:
the raw/stats path needs only the frame bytes the device emits.
"""

from __future__ import annotations

import time as _time
from dataclasses import dataclass

import numpy as np

from ..constants import ICAO_CACHE_LEN


class IcaoCache:
    """Open-addressed cache of recently seen ICAO addresses with second
    granularity TTL (dump1090.c:896-925).  Single-slot per hash; collisions
    overwrite — exactly like the reference."""

    def __init__(self, clock=None):
        self.addr = np.zeros(ICAO_CACHE_LEN, dtype=np.uint32)
        self.ts = np.zeros(ICAO_CACHE_LEN, dtype=np.int64)
        self.clock = clock or (lambda: int(_time.time()))

    @staticmethod
    def hash(a: int) -> int:
        a &= 0xFFFFFFFF
        a = (((a >> 16) ^ a) * 0x45D9F3B) & 0xFFFFFFFF
        a = (((a >> 16) ^ a) * 0x45D9F3B) & 0xFFFFFFFF
        a = (a >> 16) ^ a
        return a & (ICAO_CACHE_LEN - 1)


@dataclass
class DecoderStats:
    """The reference's stat counters, including its documented double-count
    quirk for single-bit fixes (dump1090.c:186-195)."""

    valid_preamble: int = 0
    out_of_phase: int = 0
    demodulated: int = 0
    goodcrc: int = 0
    badcrc: int = 0
    fixed: int = 0
    single_bit_fix: int = 0
    two_bits_fix: int = 0
    http_requests: int = 0
    sbs_connections: int = 0


# the eight counters the device path produces per batch, in its stats order
STAT_FIELDS = (
    "valid_preamble", "out_of_phase", "demodulated", "goodcrc", "badcrc",
    "fixed", "single_bit_fix", "two_bits_fix",
)


@dataclass
class DecoderConfig:
    fix_errors: bool = True
    aggressive: bool = False
