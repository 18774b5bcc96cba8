"""The plain reference's sequential decoder: the scan walk over demodulated
candidates, the ICAO address cache, the CRC fix, the stat counters, and
the field decode of every message handed on.

Behavioral contract: detectModeS's control flow and decodeModesMessage of
antirez/dump1090 (dump1090.c:896-1310, 1563-1793): a good-CRC message at j
makes the scan skip to j + (8 + bits) * 2 + 1; a failed pass 1 is retried
once with the phase-corrected pass; address/parity frames are accepted
only when the address their CRC recovers was seen within the cache's TTL;
DF11, 17 and 18 fix one bit error (two when aggressive) and, when clean,
add their address to the cache; a DF11 with a syndrome under 80 from a
seen address is taken as an interrogator id.  The counters follow the
reference's update rules, its double count of single-bit fixes included.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from . import modes
from .demod import Candidates

STAT_FIELDS = ("valid_preamble", "out_of_phase", "demodulated", "goodcrc", "badcrc",
               "fixed", "single_bit_fix", "two_bits_fix")


@dataclass
class Stats:
    valid_preamble: int = 0
    out_of_phase: int = 0
    demodulated: int = 0
    goodcrc: int = 0
    badcrc: int = 0
    fixed: int = 0
    single_bit_fix: int = 0
    two_bits_fix: int = 0

    def as_tuple(self) -> tuple[int, ...]:
        return tuple(getattr(self, f) for f in STAT_FIELDS)


class Clock:
    """A clock that reads `now` until set again: the one value of the
    program's clock that a dispatch group was resolved with."""

    def __init__(self, now: int = 0):
        self.now = now

    def __call__(self) -> int:
        return self.now


class IcaoCache:
    """One slot per hash of the address, overwritten on collision, with a
    TTL in seconds against `clock` (dump1090.c:896-925).  `writes`, when a
    set, collects the slots written."""

    def __init__(self, clock):
        self.addr = [0] * modes.ICAO_CACHE_LEN
        self.ts = [0] * modes.ICAO_CACHE_LEN
        self.clock = clock
        self.writes = None

    @staticmethod
    def slot(a: int) -> int:
        a = ((((a >> 16) ^ a) * 0x45D9F3B) & 0xFFFFFFFF)
        a = ((((a >> 16) ^ a) * 0x45D9F3B) & 0xFFFFFFFF)
        return ((a >> 16) ^ a) & (modes.ICAO_CACHE_LEN - 1)

    def add(self, a: int) -> None:
        h = self.slot(a)
        self.addr[h] = a
        self.ts[h] = self.clock()
        if self.writes is not None:
            self.writes.add(h)

    def seen(self, a: int) -> bool:
        h = self.slot(a)
        return self.addr[h] != 0 and self.addr[h] == a \
            and self.clock() - self.ts[h] <= modes.ICAO_CACHE_TTL

    def key(self) -> bytes:
        """The state a walk at the clock's `now` depends on: the addresses
        held, and which of them are within their TTL."""
        now = self.clock()
        live = [a != 0 and now - t <= modes.ICAO_CACHE_TTL for a, t in zip(self.addr, self.ts)]
        return np.asarray(self.addr, dtype=np.uint32).tobytes() + np.packbits(live).tobytes()


@dataclass
class DecoderConfig:
    fix_errors: bool = True
    aggressive: bool = False


@dataclass
class Message:
    """A decoded frame, with the fields of struct modesMessage
    (dump1090.c:210-260) under the names the program's messages use."""

    msg: bytes = b""
    msgbits: int = 0
    msgtype: int = 0
    crcok: bool = False
    crc: int = 0
    errorbit: int = -1
    aa1: int = 0
    aa2: int = 0
    aa3: int = 0
    phase_corrected: bool = False
    ca: int = 0
    iid: int = 0
    metype: int = 0
    mesub: int = 0
    heading_is_valid: int = 0
    heading: int = 0
    aircraft_type: int = 0
    fflag: int = 0
    tflag: int = 0
    raw_latitude: int = 0
    raw_longitude: int = 0
    flight: str = ""
    ew_dir: int = 0
    ew_velocity: int = 0
    ns_dir: int = 0
    ns_velocity: int = 0
    vert_rate_source: int = 0
    vert_rate_sign: int = 0
    vert_rate: int = 0
    velocity: int = 0
    movement: int = 0
    movement_valid: int = 0
    ground_track: int = 0
    ground_track_valid: int = 0
    fs: int = 0
    dr: int = 0
    um: int = 0
    identity: int = 0
    altitude: int = 0
    unit: int = 0

    @property
    def addr(self) -> int:
        return (self.aa1 << 16) | (self.aa2 << 8) | self.aa3


MESSAGE_FIELDS = tuple(Message.__dataclass_fields__)


def _decode(frame: bytes, syn: int, cache: IcaoCache, cfg: DecoderConfig,
            stats: Stats, fields: bool) -> Message:
    """decodeModesMessage of one sliced frame whose syndrome is `syn`."""
    msg = bytearray(frame)
    mm = Message()
    mm.msgtype = msg[0] >> 3
    mm.msgbits = modes.message_bits(mm.msgtype)
    mm.crc = syn
    mm.crcok = syn == 0
    if not mm.crcok and cfg.fix_errors and mm.msgtype in (11, 17, 18):
        flips = modes.fix_table().get(syn)
        maxfix = 2 if cfg.aggressive else 1
        if flips is not None and len(flips) <= maxfix:
            rel = [p - (modes.LONG_MSG_BITS - mm.msgbits) for p in flips]
            if all(0 <= p < mm.msgbits for p in rel):
                for p in rel:
                    msg[p >> 3] ^= 1 << (7 - (p & 7))
                mm.crc = modes.syndrome(msg, mm.msgbits)
                mm.crcok = mm.crc == 0
                mm.errorbit = rel[0]
                if len(rel) == 1:
                    stats.single_bit_fix += 1
                else:
                    stats.two_bits_fix += 1
    mm.aa1, mm.aa2, mm.aa3 = msg[1], msg[2], msg[3]
    if mm.msgtype not in (11, 17, 18):
        # address/parity: the CRC XOR the parity field is the address
        mm.crcok = False
        if mm.msgtype in modes.AP_DFS and cache.seen(mm.crc):
            mm.aa1, mm.aa2, mm.aa3 = (mm.crc >> 16) & 0xFF, (mm.crc >> 8) & 0xFF, mm.crc & 0xFF
            mm.crcok = True
    else:
        a = (msg[1] << 16) | (msg[2] << 8) | msg[3]
        if mm.crcok and mm.errorbit == -1:
            cache.add(a)
        if mm.msgtype == 11 and not mm.crcok and mm.crc < modes.DF11_IID_MAX_SYNDROME:
            if cache.seen(a):
                mm.iid = mm.crc
                mm.crcok = True
    mm.msg = bytes(msg)
    if fields:
        decode_fields(mm, msg)
    return mm


def _count(stats: Stats, mm: Message, errors: int) -> None:
    """The stat block of detectModeS (dump1090.c:1737-1753)."""
    if errors == 0:
        stats.demodulated += 1
    if mm.errorbit == -1:
        if mm.crcok:
            stats.goodcrc += 1
        else:
            stats.badcrc += 1
    else:
        stats.badcrc += 1
        stats.fixed += 1
        stats.single_bit_fix += 1   # errorbit < 112 always holds


def walk(c: Candidates, cache: IcaoCache, cfg: DecoderConfig, stats: Stats, emit, *,
         fields: bool = False, on_buffer=None) -> None:
    """Replay the scan over candidates `c` in order, calling emit(buffer
    index, message) for every message the reference hands on (good and bad
    CRC, dump1090.c:1777), and on_buffer(buffer index) before the first
    candidate of each buffer."""
    n = c.pos.shape[0]
    if n == 0:
        return
    bits1 = np.where(np.isin(c.msg1[:, 0] >> 3, modes.LONG_DFS), 112, 56)
    bits2 = np.where(np.isin(c.msg2[:, 0] >> 3, modes.LONG_DFS), 112, 56)
    syn1 = modes.syndromes(c.msg1, bits1).tolist()
    syn2 = modes.syndromes(c.msg2, bits2).tolist()
    buf, pos = c.buf.tolist(), c.pos.tolist()
    gate1, gate2 = c.gate1.tolist(), c.gate2.tolist()
    err1, err2 = c.errors1.tolist(), c.errors2.tolist()
    msg1, msg2 = c.msg1, c.msg2
    agg = cfg.aggressive
    next_j, cur = 0, -1
    for k in range(n):
        b, j = buf[k], pos[k]
        if b != cur:
            cur, next_j = b, 0
            if on_buffer is not None:
                on_buffer(b)
        if j < next_j:
            continue
        stats.valid_preamble += 1
        if not gate1[k]:
            continue
        errors = err1[k]
        if errors == 0 or (agg and errors < 3):
            mm = _decode(msg1[k].tobytes(), syn1[k], cache, cfg, stats, fields)
            if mm.crcok:
                _count(stats, mm, errors)
                next_j = j + (modes.PREAMBLE_US + mm.msgbits) * 2 + 1
                emit(b, mm)
                continue
            emit(b, mm)
        if j > 0:
            stats.out_of_phase += 1
        if not gate2[k]:
            continue
        errors = err2[k]
        if errors == 0 or (agg and errors < 3):
            mm = _decode(msg2[k].tobytes(), syn2[k], cache, cfg, stats, fields)
            _count(stats, mm, errors)
            if mm.crcok:
                mm.phase_corrected = True
                next_j = j + (modes.PREAMBLE_US + mm.msgbits) * 2 + 1
            emit(b, mm)


# ---- field decode (dump1090.c:985-1030, 1133-1308, 2056-2066) ---------------


def decode_ac13(msg) -> tuple[int, int]:
    if not msg[3] & 0x40:
        if msg[3] & 0x10:
            n = ((msg[2] & 31) << 6) | ((msg[3] & 0x80) >> 2) | ((msg[3] & 0x20) >> 1) | (msg[3] & 15)
            return n * 25 - 1000, 0
        return 0, 0
    return 0, 1


def decode_ac12(msg) -> tuple[int, int]:
    if msg[5] & 1:
        n = ((msg[5] >> 1) << 4) | ((msg[6] & 0xF0) >> 4)
        return n * 25 - 1000, 0
    return 0, 0


def movement_knots(movement: int) -> int:
    if movement == 0:
        return -1
    if movement == 1:
        return 0
    if movement <= 8:
        return int((movement - 2) * 0.125 + 0.125)
    if movement <= 12:
        return int((movement - 9) * 0.25 + 1)
    if movement <= 38:
        return int((movement - 13) * 0.5 + 2)
    if movement <= 93:
        return (movement - 39) + 15
    if movement <= 108:
        return (movement - 94) * 2 + 70
    if movement <= 123:
        return (movement - 109) * 5 + 100
    return 175


def decode_fields(mm: Message, b) -> None:
    """The stateless fields of a frame, from its (fixed) bytes."""
    mm.ca = b[0] & 7
    mm.metype = b[4] >> 3
    mm.mesub = b[4] & 7
    mm.fs = b[0] & 7
    mm.dr = (b[1] >> 3) & 31
    mm.um = ((b[1] & 7) << 3) | (b[2] >> 5)
    a = ((b[3] & 0x80) >> 5) | (b[2] & 0x02) | ((b[2] & 0x08) >> 3)
    bb = ((b[3] & 0x02) << 1) | ((b[3] & 0x08) >> 2) | ((b[3] & 0x20) >> 5)
    c = ((b[2] & 0x01) << 2) | ((b[2] & 0x04) >> 1) | ((b[2] & 0x10) >> 4)
    d = ((b[3] & 0x01) << 2) | ((b[3] & 0x04) >> 1) | ((b[3] & 0x10) >> 4)
    mm.identity = a * 1000 + bb * 100 + c * 10 + d
    if mm.msgtype in (0, 4, 16, 20):
        mm.altitude, mm.unit = decode_ac13(b)
    if mm.msgtype not in (17, 18):
        return
    t = mm.metype
    if 1 <= t <= 4:
        mm.aircraft_type = t - 1
        six = (b[5] >> 2, ((b[5] & 3) << 4) | (b[6] >> 4), ((b[6] & 15) << 2) | (b[7] >> 6),
               b[7] & 63, b[8] >> 2, ((b[8] & 3) << 4) | (b[9] >> 4),
               ((b[9] & 15) << 2) | (b[10] >> 6), b[10] & 63)
        mm.flight = "".join(modes.AIS_CHARSET[v] for v in six)
    elif 5 <= t <= 8:
        mm.movement = ((b[4] & 0x07) << 4) | (b[5] >> 4)
        mm.movement_valid = int(mm.movement != 0)
        mm.ground_track_valid = (b[5] >> 3) & 1
        mm.ground_track = (((b[5] & 0x07) << 4) | (b[6] >> 4)) * 360 // 128
        mm.fflag = (b[6] >> 2) & 1
        mm.tflag = (b[6] >> 3) & 1
        mm.raw_latitude = ((b[6] & 3) << 15) | (b[7] << 7) | (b[8] >> 1)
        mm.raw_longitude = ((b[8] & 1) << 16) | (b[9] << 8) | b[10]
    elif 9 <= t <= 18:
        mm.fflag = b[6] & 4
        mm.tflag = b[6] & 8
        mm.altitude, mm.unit = decode_ac12(b)
        mm.raw_latitude = ((b[6] & 3) << 15) | (b[7] << 7) | (b[8] >> 1)
        mm.raw_longitude = ((b[8] & 1) << 16) | (b[9] << 8) | b[10]
    elif t == 19 and 1 <= mm.mesub <= 4:
        if mm.mesub in (1, 2):
            mm.ew_dir = (b[5] & 4) >> 2
            mm.ew_velocity = ((b[5] & 3) << 8) | b[6]
            mm.ns_dir = (b[7] & 0x80) >> 7
            mm.ns_velocity = ((b[7] & 0x7F) << 3) | ((b[8] & 0xE0) >> 5)
            mm.vert_rate_source = (b[8] & 0x10) >> 4
            mm.vert_rate_sign = (b[8] & 0x8) >> 3
            mm.vert_rate = ((b[8] & 7) << 6) | ((b[9] & 0xFC) >> 2)
            mm.velocity = int(math.sqrt(mm.ns_velocity ** 2 + mm.ew_velocity ** 2))
            if mm.velocity:
                ewv = -mm.ew_velocity if mm.ew_dir else mm.ew_velocity
                nsv = -mm.ns_velocity if mm.ns_dir else mm.ns_velocity
                # stored into an int (truncated) before the wrap, as in C
                mm.heading = int(math.atan2(ewv, nsv) * 360 / (2 * math.pi))
                if mm.heading < 0:
                    mm.heading += 360
            else:
                mm.heading = 0
        else:
            mm.heading_is_valid = b[5] & 4
            mm.heading = int((360.0 / 128) * (((b[5] & 3) << 5) | (b[6] >> 3)))


def raw_line(mm: Message, upper: bool = False) -> str:
    h = mm.msg[: mm.msgbits // 8].hex()
    return "*" + (h.upper() if upper else h) + ";"
