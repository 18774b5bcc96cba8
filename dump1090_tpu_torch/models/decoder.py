"""Decode state, configuration, and the field decode of messages (a copy
of dump1090_tpu/models/decoder.py).

Behavioral contract: decodeModesMessage and helpers, dump1090.c:896-1310.
On the device path the resolver makes every stateful decision (CRC fix,
brute-force AP acceptance, DF11 IID, cache adds) and encodes it in each
emitted message's meta word; message_from_device rebuilds the rest from the
post-fix frame bytes.  decode_message is the stateful host decode of one
frame against the host IcaoCache, used for `*<hex>;` lines that arrive on
the raw network input (decode_hex_message).
"""

from __future__ import annotations

import math
import time as _time
from dataclasses import dataclass

import numpy as np

from ..constants import (
    AIS_CHARSET,
    DF11_IID_MAX_SYNDROME,
    ICAO_CACHE_LEN,
    ICAO_CACHE_TTL,
    LONG_MSG_BITS,
    LONG_MSG_BYTES,
    MAX_BITERRORS,
    SHORT_MSG_BITS,
    message_bits_for_df,
)
from ..ops import crc as crc_ops
from ..ops.resolve import META_CRCOK, META_ERRBIT_MASK, META_ERRBIT_SHIFT, META_LONG, META_PHASE

UNIT_FEET = 0
UNIT_METERS = 1


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

    def add(self, addr: int) -> None:
        h = self.hash(addr)
        self.addr[h] = addr
        self.ts[h] = self.clock()

    def recently_seen(self, addr: int) -> bool:
        h = self.hash(addr)
        a = int(self.addr[h])
        return a != 0 and a == addr and self.clock() - int(self.ts[h]) <= ICAO_CACHE_TTL


@dataclass
class ModesMessage:
    """Decoded frame record — the semantic twin of struct modesMessage
    (dump1090.c:210-260)."""

    msg: bytes = b""              # frame bytes after any error correction
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
    unit: int = UNIT_FEET

    @property
    def addr(self) -> int:
        return (self.aa1 << 16) | (self.aa2 << 8) | self.aa3

    @property
    def hexaddr(self) -> str:
        return f"{self.addr:06x}"


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

    def add(self, counts) -> None:
        """Add a resolve's eight counts, in STAT_FIELDS order."""
        for name, d in zip(STAT_FIELDS, counts):
            setattr(self, name, getattr(self, name) + d)


# the eight counters the device path produces per batch, in its stats order
STAT_FIELDS = (
    "valid_preamble", "out_of_phase", "demodulated", "goodcrc", "badcrc",
    "fixed", "single_bit_fix", "two_bits_fix",
)


@dataclass
class DecoderConfig:
    fix_errors: bool = True
    aggressive: bool = False


def brute_force_ap(msg: np.ndarray, mm: ModesMessage, cache: IcaoCache) -> bool:
    """Recover the ICAO address of Address/Parity frames by XORing the
    computed CRC into the AP field; accept iff recently seen
    (dump1090.c:942-983)."""
    if mm.msgtype not in (0, 4, 5, 16, 20, 21, 24):
        return False
    lastbyte = mm.msgbits // 8 - 1
    c = crc_ops.compute_crc(msg, mm.msgbits)
    b0 = int(msg[lastbyte]) ^ (c & 0xFF)
    b1 = int(msg[lastbyte - 1]) ^ ((c >> 8) & 0xFF)
    b2 = int(msg[lastbyte - 2]) ^ ((c >> 16) & 0xFF)
    if cache.recently_seen(b0 | (b1 << 8) | (b2 << 16)):
        mm.aa1, mm.aa2, mm.aa3 = b2, b1, b0
        return True
    return False


def decode_ac13_field(msg: np.ndarray) -> tuple[int, int]:
    """13-bit altitude field of DF 0/4/16/20 (dump1090.c:985-1012)."""
    m_bit = msg[3] & 0x40
    q_bit = msg[3] & 0x10
    if not m_bit:
        if q_bit:
            n = ((int(msg[2]) & 31) << 6) | ((int(msg[3]) & 0x80) >> 2) | \
                ((int(msg[3]) & 0x20) >> 1) | (int(msg[3]) & 15)
            return n * 25 - 1000, UNIT_FEET
        return 0, UNIT_FEET
    return 0, UNIT_METERS


def decode_ac12_field(msg: np.ndarray) -> tuple[int, int]:
    """12-bit altitude field of DF17 airborne position (dump1090.c:1014-1030)."""
    if msg[5] & 1:
        n = ((int(msg[5]) >> 1) << 4) | ((int(msg[6]) & 0xF0) >> 4)
        return n * 25 - 1000, UNIT_FEET
    return 0, UNIT_FEET


def decode_movement_field(movement: int) -> int:
    """Piecewise-linear 7-bit surface ground-speed decode in knots
    (dump1090.c:2056-2066). C truncates the double result to int."""
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


def _decode_common_fields(mm: ModesMessage, msg: np.ndarray) -> None:
    """The stateless field extraction of decodeModesMessage
    (dump1090.c:1133-1179, 1213-1308): pure functions of the frame bytes."""
    mm.ca = int(msg[0]) & 7
    mm.aa1, mm.aa2, mm.aa3 = int(msg[1]), int(msg[2]), int(msg[3])
    mm.metype = int(msg[4]) >> 3
    mm.mesub = int(msg[4]) & 7
    mm.fs = int(msg[0]) & 7
    mm.dr = (int(msg[1]) >> 3) & 31
    mm.um = ((int(msg[1]) & 7) << 3) | (int(msg[2]) >> 5)

    # Gillham-interleaved 13-bit identity (squawk), dump1090.c:1163-1179
    a = ((int(msg[3]) & 0x80) >> 5) | (int(msg[2]) & 0x02) | ((int(msg[2]) & 0x08) >> 3)
    b = ((int(msg[3]) & 0x02) << 1) | ((int(msg[3]) & 0x08) >> 2) | ((int(msg[3]) & 0x20) >> 5)
    c = ((int(msg[2]) & 0x01) << 2) | ((int(msg[2]) & 0x04) >> 1) | ((int(msg[2]) & 0x10) >> 4)
    d = ((int(msg[3]) & 0x01) << 2) | ((int(msg[3]) & 0x04) >> 1) | ((int(msg[3]) & 0x10) >> 4)
    mm.identity = a * 1000 + b * 100 + c * 10 + d

    if mm.msgtype in (0, 4, 16, 20):
        mm.altitude, mm.unit = decode_ac13_field(msg)

    if mm.msgtype in (17, 18):
        _decode_extended_squitter(mm, msg)


def _decode_extended_squitter(mm: ModesMessage, msg: np.ndarray) -> None:
    """DF17/18 ME-field decode (dump1090.c:1225-1308)."""
    b = [int(x) for x in msg]
    if 1 <= mm.metype <= 4:
        mm.aircraft_type = mm.metype - 1
        six = [
            b[5] >> 2,
            ((b[5] & 3) << 4) | (b[6] >> 4),
            ((b[6] & 15) << 2) | (b[7] >> 6),
            b[7] & 63,
            b[8] >> 2,
            ((b[8] & 3) << 4) | (b[9] >> 4),
            ((b[9] & 15) << 2) | (b[10] >> 6),
            b[10] & 63,
        ]
        mm.flight = "".join(AIS_CHARSET[v] for v in six)
    elif 5 <= mm.metype <= 8:
        mm.movement = ((b[4] & 0x07) << 4) | (b[5] >> 4)
        mm.movement_valid = int(mm.movement != 0)
        mm.ground_track_valid = (b[5] >> 3) & 1
        mm.ground_track = (((b[5] & 0x07) << 4) | (b[6] >> 4)) * 360 // 128
        mm.fflag = (b[6] >> 2) & 1
        mm.tflag = (b[6] >> 3) & 1
        mm.raw_latitude = ((b[6] & 3) << 15) | (b[7] << 7) | (b[8] >> 1)
        mm.raw_longitude = ((b[8] & 1) << 16) | (b[9] << 8) | b[10]
    elif 9 <= mm.metype <= 18:
        mm.fflag = b[6] & (1 << 2)
        mm.tflag = b[6] & (1 << 3)
        mm.altitude, mm.unit = decode_ac12_field(msg)
        mm.raw_latitude = ((b[6] & 3) << 15) | (b[7] << 7) | (b[8] >> 1)
        mm.raw_longitude = ((b[8] & 1) << 16) | (b[9] << 8) | b[10]
    elif mm.metype == 19 and 1 <= mm.mesub <= 4:
        if mm.mesub in (1, 2):
            mm.ew_dir = (b[5] & 4) >> 2
            mm.ew_velocity = ((b[5] & 3) << 8) | b[6]
            mm.ns_dir = (b[7] & 0x80) >> 7
            mm.ns_velocity = ((b[7] & 0x7F) << 3) | ((b[8] & 0xE0) >> 5)
            mm.vert_rate_source = (b[8] & 0x10) >> 4
            mm.vert_rate_sign = (b[8] & 0x8) >> 3
            mm.vert_rate = ((b[8] & 7) << 6) | ((b[9] & 0xFC) >> 2)
            # C stores the double sqrt/atan2 results into int fields
            # (truncation toward zero), dump1090.c:1285-1299.
            mm.velocity = int(math.sqrt(mm.ns_velocity**2 + mm.ew_velocity**2))
            if mm.velocity:
                ewv = -mm.ew_velocity if mm.ew_dir else mm.ew_velocity
                nsv = -mm.ns_velocity if mm.ns_dir else mm.ns_velocity
                heading = math.atan2(ewv, nsv) * 360 / (2 * math.pi)
                # C stores into the int field FIRST (truncation toward
                # zero), then adds 360 to the int (dump1090.c:1296-1299) —
                # adding before truncation is off by one degree westbound
                mm.heading = int(heading)
                if mm.heading < 0:
                    mm.heading += 360
            else:
                mm.heading = 0
        elif mm.mesub in (3, 4):
            mm.heading_is_valid = b[5] & (1 << 2)
            mm.heading = int((360.0 / 128) * (((b[5] & 3) << 5) | (b[6] >> 3)))


def decode_message(
    raw: np.ndarray | bytes,
    cache: IcaoCache,
    cfg: DecoderConfig,
    stats: DecoderStats | None = None,
) -> ModesMessage:
    """Full field decode of a 56/112-bit frame (dump1090.c:1091-1310).

    `raw` is up to 14 bytes; mutates nothing but the ICAO cache (and the
    stats single/two-bit fix counters, mirroring the decode-path increments
    at dump1090.c:1122-1126).
    """
    msg = np.zeros(LONG_MSG_BYTES, dtype=np.uint8)
    raw = np.frombuffer(bytes(raw), dtype=np.uint8) if isinstance(raw, (bytes, bytearray)) \
        else np.asarray(raw, dtype=np.uint8)
    msg[: len(raw)] = raw[:LONG_MSG_BYTES]

    mm = ModesMessage()
    mm.msgtype = int(msg[0]) >> 3
    mm.msgbits = message_bits_for_df(mm.msgtype)
    mm.crc = crc_ops.checksum(msg, mm.msgbits)
    mm.crcok = mm.crc == 0

    if not mm.crcok and cfg.fix_errors and mm.msgtype in (11, 17, 18):
        fixed = crc_ops.fix_bit_errors(msg, mm.msgbits, MAX_BITERRORS if cfg.aggressive else 1)
        if fixed:
            mm.crc = crc_ops.checksum(msg, mm.msgbits)
            mm.crcok = mm.crc == 0
            mm.errorbit = fixed[0]
            if stats is not None:
                if len(fixed) == 1:
                    stats.single_bit_fix += 1
                else:
                    stats.two_bits_fix += 1

    _decode_common_fields(mm, msg)

    if mm.msgtype not in (11, 17, 18):
        mm.crcok = brute_force_ap(msg, mm, cache)
    else:
        addr = mm.addr
        if mm.crcok and mm.errorbit == -1:
            cache.add(addr)
        # DF11 with a small residual syndrome: treat it as the Interrogator
        # Identifier if we know the aircraft (dump1090.c:1204-1209).
        if mm.msgtype == 11 and not mm.crcok and mm.crc < DF11_IID_MAX_SYNDROME:
            if cache.recently_seen(addr):
                mm.iid = mm.crc
                mm.crcok = True

    mm.msg = bytes(msg)
    return mm


def decode_hex_message(
    line: str,
    cache: IcaoCache,
    cfg: DecoderConfig,
    stats: DecoderStats | None = None,
) -> ModesMessage | None:
    """Parse one `*<hex>;` raw-protocol line and decode it
    (decodeHexMessage, dump1090.c:2472-2502).  Returns None for invalid
    input — silently discarded, never an error, like the reference.

    Divergence note: for frames shorter than the DF-implied length the
    reference reads uninitialized stack bytes (C UB); the tail is
    deterministically zero-filled."""
    hexstr = line.strip()
    if len(hexstr) < 2 or hexstr[0] != "*" or hexstr[-1] != ";":
        return None
    body = hexstr[1:-1]
    if len(body) > LONG_MSG_BYTES * 2 or len(body) % 2:
        return None
    # strict hex only: bytes.fromhex tolerates embedded ASCII whitespace,
    # the reference rejects any non-hex character (dump1090.c:2492-2497)
    if not all(c in "0123456789abcdefABCDEF" for c in body):
        return None
    return decode_message(bytes.fromhex(body), cache, cfg, stats)


def message_from_device(raw, meta: int, syn: int) -> ModesMessage:
    """Rebuild the full ModesMessage for one device-resolved emission.

    The device resolver (ops/resolve.py) already made every stateful
    decision and encoded the outcome in `meta`; the remaining fields are
    pure functions of the post-fix frame bytes plus the 24-bit syndrome
    `syn` of those bytes:

      * mm.crc is the syndrome (zero after a fix, like the reference's
        recompute at dump1090.c:1119-1121);
      * a crcok DF11 with nonzero syndrome is an IID acceptance, and the
        syndrome IS the interrogator id (dump1090.c:1204-1209);
      * a crcok address/parity frame's recovered address IS the syndrome
        (AP = CRC xor addr, dump1090.c:942-983).
    """
    msg = np.zeros(LONG_MSG_BYTES, dtype=np.uint8)
    raw = np.asarray(raw, dtype=np.uint8)
    msg[: len(raw)] = raw[:LONG_MSG_BYTES]

    mm = ModesMessage()
    mm.msgtype = int(msg[0]) >> 3
    mm.msgbits = LONG_MSG_BITS if meta & META_LONG else SHORT_MSG_BITS
    mm.crc = int(syn)
    mm.crcok = bool(meta & META_CRCOK)
    mm.errorbit = ((meta >> META_ERRBIT_SHIFT) & META_ERRBIT_MASK) - 1
    _decode_common_fields(mm, msg)
    if mm.msgtype in (11, 17, 18):
        if mm.msgtype == 11 and mm.crcok and mm.crc != 0:
            mm.iid = mm.crc
    elif mm.crcok:  # brute-force-AP acceptance: address == syndrome
        mm.aa1 = (mm.crc >> 16) & 0xFF
        mm.aa2 = (mm.crc >> 8) & 0xFF
        mm.aa3 = mm.crc & 0xFF
    mm.phase_corrected = bool(meta & META_PHASE)
    mm.msg = bytes(msg)
    return mm


def messages_from_device_arrays(msg_rows, meta_rows) -> list[ModesMessage]:
    """Rebuild ModesMessages for a fetched batch of device emissions:
    vectorized syndromes of the post-fix frame bytes (split by frame
    length), then one message_from_device per row, in emission order."""
    meta_rows = np.asarray(meta_rows)
    msg_rows = np.asarray(msg_rows)
    c = meta_rows.shape[0]
    if c == 0:
        return []
    syn = np.empty(c, dtype=np.uint32)
    is_long = (meta_rows & META_LONG) != 0
    if is_long.any():
        syn[is_long] = crc_ops.batch_syndromes(msg_rows[is_long], LONG_MSG_BITS)
    if (~is_long).any():
        syn[~is_long] = crc_ops.batch_syndromes(msg_rows[~is_long], SHORT_MSG_BITS)
    return [
        message_from_device(msg_rows[i], int(meta_rows[i]), int(syn[i]))
        for i in range(c)
    ]
