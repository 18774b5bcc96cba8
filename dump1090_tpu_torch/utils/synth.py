"""Synthetic Mode S IQ generation: frame -> CRC -> PPM -> 2 Msps IQ (a copy
of dump1090_tpu/utils/synth.py).

Encode known frames into uint8 IQ at a chosen amplitude / noise level /
carrier phase, feed them through the demodulation pipeline, and assert on
what comes back.

Waveform model (Mode S downlink, 1090 MHz PPM at 1 Mbit/s, sampled 2 Msps):
  preamble: pulses in sample slots 0, 2, 7, 9 of 16 (dump1090.c:1569-1588)
  data bit 1: (pulse, silence); bit 0: (silence, pulse) — 2 samples/bit
"""

from __future__ import annotations

import numpy as np

from ..constants import LONG_MSG_BITS
from ..ops import crc as crc_ops

PREAMBLE_PATTERN = np.array(
    [1, 0, 1, 0, 0, 0, 0, 1, 0, 1, 0, 0, 0, 0, 0, 0], dtype=np.float64
)


def make_df17_frame(
    addr: int,
    metype: int = 11,
    mesub: int = 0,
    me_payload: bytes = b"\x00\x00\x00\x00\x00\x00",
    ca: int = 5,
) -> bytes:
    """Assemble a 112-bit DF17 frame with a valid CRC."""
    msg = bytearray(14)
    msg[0] = (17 << 3) | (ca & 7)
    msg[1] = (addr >> 16) & 0xFF
    msg[2] = (addr >> 8) & 0xFF
    msg[3] = addr & 0xFF
    msg[4] = ((metype & 31) << 3) | (mesub & 7)
    msg[5:11] = me_payload[:6].ljust(6, b"\x00")
    c = crc_ops.compute_crc(np.frombuffer(bytes(msg), np.uint8), LONG_MSG_BITS)
    msg[11], msg[12], msg[13] = (c >> 16) & 0xFF, (c >> 8) & 0xFF, c & 0xFF
    return bytes(msg)


def envelope(frame: bytes) -> np.ndarray:
    """Unit-amplitude PPM envelope of preamble + frame, 2 samples/us."""
    bits = np.unpackbits(np.frombuffer(frame, np.uint8))
    cells = np.zeros((len(bits), 2), dtype=np.float64)
    cells[bits == 1, 0] = 1.0
    cells[bits == 0, 1] = 1.0
    return np.concatenate([PREAMBLE_PATTERN, cells.reshape(-1)])


def frame_to_iq(
    frame: bytes,
    *,
    amplitude: float = 80.0,
    noise_sigma: float = 0.0,
    phase: float = 0.3,
    pad_before: int = 200,
    pad_after: int = 400,
    rng: np.random.Generator | None = None,
) -> np.ndarray:
    """Modulate one frame into interleaved uint8 IQ centered at 127.

    amplitude: pulse magnitude in ADC counts (<= ~127).
    noise_sigma: AWGN added independently to I and Q.
    phase: carrier phase in radians (splits energy between I and Q).
    """
    rng = rng or np.random.default_rng(0)
    env = envelope(frame)
    env = np.concatenate([np.zeros(pad_before), env, np.zeros(pad_after)])
    i = amplitude * np.cos(phase) * env
    q = amplitude * np.sin(phase) * env
    if noise_sigma > 0:
        i = i + rng.normal(0, noise_sigma, env.shape)
        q = q + rng.normal(0, noise_sigma, env.shape)
    iq = np.empty(2 * env.shape[0], dtype=np.float64)
    iq[0::2] = i
    iq[1::2] = q
    return np.clip(np.round(iq) + 127, 0, 255).astype(np.uint8)


def snr_db(amplitude: float, noise_sigma: float) -> float:
    """Pulse-power to noise-power ratio in dB (per complex sample)."""
    if noise_sigma <= 0:
        return float("inf")
    return 10 * np.log10((amplitude**2) / (2 * noise_sigma**2))


def planted_capture(
    n_blocks: int,
    frames_per_block: int,
    *,
    seed: int,
    noise_sigma: float = 2.0,
    flip_weights: tuple[float, ...] = (0.8, 0.15, 0.05),
    n_aircraft: int = 256,
    margin: int = 300,
) -> tuple[bytes, list[tuple[int, int, bytes, int]]]:
    """A synthetic capture of `n_blocks` reference blocks (131072 samples,
    262144 bytes each) with `frames_per_block` DF17 frames planted per block
    over Gaussian noise, all drawn from `seed`.

    Each frame has an address from a pool of `n_aircraft` (like real air,
    where the same aircraft transmit again and again), an amplitude
    (50..100 counts), a carrier phase, and 0, 1 or 2 flipped bits drawn
    with `flip_weights`.  Frames sit
    in equal slots of the block, at least `margin` samples from each other
    and from the block edges, so no frame straddles two buffers however the
    blocks are tiled.  Returns (IQ bytes, planted) with planted = [(block,
    sample offset in the block, clean frame bytes, flipped bits)] in stream
    order."""
    from ..constants import BLOCK_SAMPLES

    rng = np.random.default_rng(seed)
    frame_len = len(PREAMBLE_PATTERN) + 2 * LONG_MSG_BITS  # 240 samples
    slot = (BLOCK_SAMPLES - 2 * margin) // max(frames_per_block, 1)
    if slot < frame_len + margin:
        raise ValueError(f"{frames_per_block} frames do not fit one block")
    blocks = []
    planted = []
    weights = np.asarray(flip_weights, dtype=np.float64)
    pool = rng.integers(1, 1 << 24, n_aircraft)
    for b in range(n_blocks):
        i = rng.normal(0.0, noise_sigma, BLOCK_SAMPLES) if noise_sigma > 0 else np.zeros(BLOCK_SAMPLES)
        q = rng.normal(0.0, noise_sigma, BLOCK_SAMPLES) if noise_sigma > 0 else np.zeros(BLOCK_SAMPLES)
        for k in range(frames_per_block):
            clean = make_df17_frame(int(rng.choice(pool)),
                                    metype=int(rng.integers(1, 23)),
                                    me_payload=rng.bytes(6))
            nflip = int(rng.choice(len(weights), p=weights / weights.sum()))
            f = bytearray(clean)
            for p in rng.choice(np.arange(5, LONG_MSG_BITS), nflip, replace=False):
                f[p >> 3] ^= 1 << (7 - (int(p) & 7))
            off = margin + k * slot + int(rng.integers(0, slot - frame_len - margin + 1))
            amp = float(rng.uniform(50.0, 100.0))
            phase = float(rng.uniform(0.0, 2 * np.pi))
            env = envelope(bytes(f))
            i[off : off + frame_len] += amp * np.cos(phase) * env
            q[off : off + frame_len] += amp * np.sin(phase) * env
            planted.append((b, off, clean, nflip))
        iq = np.empty(2 * BLOCK_SAMPLES, dtype=np.float64)
        iq[0::2] = i
        iq[1::2] = q
        blocks.append(np.clip(np.round(iq) + 127, 0, 255).astype(np.uint8))
    return np.concatenate(blocks).tobytes() if blocks else b"", planted


def random_word_stream(seed: int, n_buffers: int, mc: int, now: int):
    """An adversarial input for the sequential resolver (ops.resolve
    resolve_words), shaped like the real candidate stream: ascending
    positions per buffer, a valid prefix of nbuf[b] slots, PF_NEWBUF at each
    buffer's slot 0, random gate bits; pass words with random flag bits and
    addresses from a small pool that holds ICAO-cache hash collisions; and
    an initial cache with fresh, just-expired (TTL) and empty entries.

    Returns numpy int32 (pf, w1, w2, nbuf, cache_addr, cache_ts)."""
    from ..constants import ICAO_CACHE_LEN, ICAO_CACHE_TTL, SCAN_POSITIONS
    from ..models.decoder import IcaoCache
    from ..ops.resolve import PF_GATE1, PF_NEWBUF, PF_VALID

    rng = np.random.default_rng(seed)
    colliding, by_slot = [], {}
    while len(colliding) < 24:
        a = int(rng.integers(1, 1 << 24))
        h = IcaoCache.hash(a)
        if h in by_slot:
            colliding += [by_slot.pop(h), a]
        else:
            by_slot[h] = a
    pool = np.array(colliding + [int(a) for a in rng.integers(1, 1 << 24, 8)])
    n = n_buffers * mc
    slot = np.arange(n) % mc
    nbuf = rng.integers(0, mc + 1, n_buffers).astype(np.int32)
    nbuf[0] = mc  # one full row
    valid = slot < np.repeat(nbuf, mc)
    pos = np.sort(rng.integers(0, SCAN_POSITIONS, (n_buffers, mc)), axis=1).reshape(-1)
    pf = (pos | valid * PF_VALID | (slot == 0) * PF_NEWBUF
          | (rng.random(n) < 0.7) * PF_GATE1).astype(np.int32)

    def words():
        flags = rng.integers(0, 32, n) << 24
        return (rng.choice(pool, n) | flags).astype(np.int32)

    w1, w2 = words(), words()
    ca = np.zeros(ICAO_CACHE_LEN, np.int32)
    ct = np.zeros(ICAO_CACHE_LEN, np.int32)
    for k, a in enumerate(pool[:16]):
        h = IcaoCache.hash(int(a))
        ca[h] = a
        ct[h] = now - (5 if k % 2 else ICAO_CACHE_TTL + 1)  # fresh / expired
    return pf, w1, w2, nbuf, ca, ct


def forced_cut_stream(seed: int, n_buffers: int, mc: int, now: int):
    """A resolver input (ops.resolve resolve_words) that writes one ICAO
    cache slot back to back with colliding addresses, so that a walk which
    settles several steps at once must cut nearly every batch: runs of 8
    slots alternate the two addresses of one colliding pair, most slots
    attempt an addable decode (a cache write) on pass 1 or, through the
    gate, on pass 2, and most pass CRC only when the cache holds their
    address, so each write turns the next slot's lookup.  One pair is
    address 0 and an address of the same slot, so 0 is written over a live
    entry.  Counts include 0, mc, one
    below 0, one above mc and odd ones; the initial cache holds fresh,
    just-expired and empty entries in the pairs' slots.

    Returns numpy int32 (pf, w1, w2, nbuf, cache_addr, cache_ts), as
    random_word_stream."""
    from ..constants import ICAO_CACHE_LEN, ICAO_CACHE_TTL, SCAN_POSITIONS
    from ..models.decoder import IcaoCache
    from ..ops.resolve import (
        PF_GATE1, PF_NEWBUF, PF_VALID, W_ADDABLE, W_ATTEMPT, W_CRCOK_NOSEEN, W_CRCOK_SEEN,
    )

    rng = np.random.default_rng(seed)
    h0 = IcaoCache.hash(0)
    zero_partner = next(a for a in iter(lambda: int(rng.integers(1, 1 << 24)), None)
                        if IcaoCache.hash(a) == h0)
    pairs, by_slot = [(0, zero_partner)], {}
    while len(pairs) < 6:
        a = int(rng.integers(1, 1 << 24))
        h = IcaoCache.hash(a)
        if h in by_slot:
            pairs.append((by_slot.pop(h), a))
        else:
            by_slot[h] = a
    pairs = np.array(pairs, dtype=np.int64)
    n = n_buffers * mc
    slot = np.arange(n) % mc
    nbuf = rng.integers(1, mc + 1, n_buffers).astype(np.int32)
    for b, c in enumerate((mc, 0, -3, mc + 5, min(37, mc))[:n_buffers]):
        nbuf[b] = c
    valid = slot < np.repeat(np.clip(nbuf, 0, mc), mc)
    pos = np.sort(rng.integers(0, SCAN_POSITIONS, (n_buffers, mc)), axis=1).reshape(-1)
    gate = rng.random(n) < 0.5
    pf = (pos | valid * PF_VALID | (slot == 0) * PF_NEWBUF | gate * PF_GATE1).astype(np.int32)

    i = np.arange(n)
    addr = pairs[(i // 8) % len(pairs), i % 2]
    crcok = rng.integers(0, 2, (2, n)) * W_CRCOK_SEEN | rng.integers(0, 2, (2, n)) * W_CRCOK_NOSEEN
    crcok[:, rng.random(n) < 0.85] = W_CRCOK_SEEN  # mostly: CRC ok when the cache holds it
    on2 = gate & (rng.random(n) < 0.4)  # pass 1 does not attempt, pass 2 writes
    w1 = addr | np.where(on2, 0, W_ATTEMPT | W_ADDABLE) | crcok[0]
    w2 = addr | W_ATTEMPT | W_ADDABLE | crcok[1]
    other = rng.random(n) < 0.1  # a few slots with random flags and addresses
    w1 = np.where(other, rng.choice(pairs.reshape(-1), n) | rng.integers(0, 32, n) << 24, w1)
    ca = np.zeros(ICAO_CACHE_LEN, np.int32)
    ct = np.zeros(ICAO_CACHE_LEN, np.int32)
    for k, (a, b) in enumerate(pairs):
        h = IcaoCache.hash(int(b))
        ca[h] = b
        ct[h] = now - (3 if k % 3 else ICAO_CACHE_TTL + 1)  # fresh / just expired
    return pf, w1.astype(np.int32), w2.astype(np.int32), nbuf, ca, ct


def _cpr_airborne_encode(lat: float, lon: float, odd: int) -> tuple[int, int]:
    """The 17-bit airborne CPR encoding of (lat, lon) for one parity (the
    inverse of models/cpr.py decode_cpr_airborne)."""
    from ..models.cpr import nl_function

    dlat = 360.0 / (60 - odd)
    yz = int(np.floor(131072 * (lat % dlat) / dlat + 0.5))
    rlat = dlat * (yz / 131072 + np.floor(lat / dlat))
    dlon = 360.0 / max(nl_function(rlat) - odd, 1)
    xz = int(np.floor(131072 * (lon % dlon) / dlon + 0.5))
    return yz & 0x1FFFF, xz & 0x1FFFF


def traffic_frames(seed: int, n: int, *, n_aircraft: int = 12,
                   flip_weights: tuple[float, ...] = (0.8, 0.15, 0.05)) -> list[tuple[bytes, int]]:
    """`n` frames of mixed Mode S traffic from `n_aircraft` aircraft, drawn
    from `seed`, as (frame bytes, flipped bits) in order: DF 0/4/5/16/20/21/24
    with address/parity (the CRC XOR the address), DF11 all-call replies
    (some with a small interrogator id in the parity), and DF17/18
    extended squitters of ME types 1-4 (identification), 5-8 (surface
    position), 9-18 (airborne position: an even and an odd frame of one
    aircraft back to back, CPR-encoded from where it flies: a position
    within 2 degrees of 52 N 4 E that drifts a little from pair to pair),
    19 (velocity, subtypes 0-7) and others with random payloads.  Short
    frames are 7 bytes.  Each frame has 0, 1 or 2 flipped bits past the DF
    field, drawn with `flip_weights`."""
    from ..constants import SHORT_MSG_BITS, message_bits_for_df

    rng = np.random.default_rng(seed)
    pool = [int(a) for a in rng.integers(1, 1 << 24, n_aircraft)]
    home = {a: (52.0 + float(rng.uniform(-1.5, 1.5)), 4.0 + float(rng.uniform(-2.0, 2.0)))
            for a in pool}
    weights = np.asarray(flip_weights, dtype=np.float64)
    out: list[tuple[bytes, int]] = []

    def finish(msg: bytearray, parity_xor: int = 0) -> None:
        bits = message_bits_for_df(msg[0] >> 3)
        nb = bits // 8
        msg = msg[:nb]
        c = crc_ops.compute_crc(np.frombuffer(bytes(msg), np.uint8), bits) ^ parity_xor
        msg[nb - 3], msg[nb - 2], msg[nb - 1] = (c >> 16) & 0xFF, (c >> 8) & 0xFF, c & 0xFF
        nflip = int(rng.choice(len(weights), p=weights / weights.sum()))
        for p in rng.choice(np.arange(5, bits), nflip, replace=False):
            msg[p >> 3] ^= 1 << (7 - (int(p) & 7))
        out.append((bytes(msg), nflip))

    def es(df: int, addr: int, me: bytes) -> bytearray:
        msg = bytearray(14)
        msg[0] = (df << 3) | int(rng.integers(0, 8))
        msg[1:4] = addr.to_bytes(3, "big")
        msg[4:11] = me
        return msg

    while len(out) < n:
        addr = pool[int(rng.integers(0, n_aircraft))]
        kind = int(rng.integers(0, 10))
        if kind <= 2:  # address/parity replies
            df = int(rng.choice([0, 4, 5, 16, 20, 21, 24]))
            msg = bytearray(rng.bytes(14))
            msg[0] = (df << 3) | (msg[0] & 7)
            if df == 24:
                msg[0] |= 0xC0
            finish(msg, addr)
        elif kind == 3:  # all-call reply, now and then with an IID
            msg = bytearray(rng.bytes(SHORT_MSG_BITS // 8))
            msg[0] = (11 << 3) | (msg[0] & 7)
            msg[1:4] = addr.to_bytes(3, "big")
            finish(msg, int(rng.integers(1, 80)) if rng.random() < 0.2 else 0)
        elif kind <= 6:  # an even/odd airborne position pair
            lat, lon = home[addr]
            home[addr] = (lat + float(rng.uniform(-0.01, 0.01)),
                          lon + float(rng.uniform(-0.01, 0.01)))
            n_alt = int(rng.integers(40, 1640))
            tc = int(rng.integers(9, 19))
            for odd in (0, 1):
                yz, xz = _cpr_airborne_encode(lat, lon, odd)
                me = bytes([tc << 3, ((n_alt >> 4) << 1) | 1,
                            ((n_alt & 0xF) << 4) | (odd << 2) | (yz >> 15),
                            (yz >> 7) & 0xFF, ((yz & 0x7F) << 1) | (xz >> 16),
                            (xz >> 8) & 0xFF, xz & 0xFF])
                finish(es(17, addr, me))
        else:  # identification, surface, velocity and other ME types
            tc = int(rng.choice([1, 2, 3, 4, 5, 6, 7, 8, 19, 19, 19, 23, 28, 29, 31]))
            sub = int(rng.integers(0, 8))
            me = bytes([(tc << 3) | sub]) + rng.bytes(6)
            finish(es(18 if rng.random() < 0.15 else 17, addr, me))
    return out[:n]


def traffic_capture(
    n_blocks: int,
    frames_per_block: int,
    *,
    seed: int,
    noise_sigma: float = 3.0,
    amplitude: tuple[float, float] = (20.0, 100.0),
    margin: int = 300,
    blank_every: int = 0,
) -> tuple[bytes, list[tuple[int, int, bytes]]]:
    """A synthetic capture of mixed Mode S traffic: the frames of
    traffic_frames(seed, ...) (every DF, 0-2 flipped bits, CPR pairs)
    modulated `frames_per_block` to a block, each in its own equal slot of
    the block at a random offset, amplitude and carrier phase, over
    Gaussian noise.  With `blank_every` k > 0, every k-th frame has its
    first bit cell silenced (both samples at zero magnitude), so both its
    demodulation passes end in a demod error.  Returns (IQ bytes, planted)
    with planted = [(block, sample offset of the preamble in the block,
    frame bytes)] in stream order."""
    from ..constants import BLOCK_SAMPLES

    frames = [f for f, _ in traffic_frames(seed, n_blocks * frames_per_block)]
    rng = np.random.default_rng(seed + 1)
    slot = (BLOCK_SAMPLES - 2 * margin) // max(frames_per_block, 1)
    longest = len(PREAMBLE_PATTERN) + 2 * LONG_MSG_BITS
    if slot < longest + margin:
        raise ValueError(f"{frames_per_block} frames do not fit one block")
    blocks, planted = [], []
    for b in range(n_blocks):
        i = rng.normal(0.0, noise_sigma, BLOCK_SAMPLES)
        q = rng.normal(0.0, noise_sigma, BLOCK_SAMPLES)
        for k, f in enumerate(frames[b * frames_per_block:(b + 1) * frames_per_block]):
            env = envelope(f)
            off = margin + k * slot + int(rng.integers(0, slot - longest - margin + 1))
            if blank_every and len(planted) % blank_every == 0:
                h = off + len(PREAMBLE_PATTERN)  # the first bit cell
                env[h - off : h - off + 2] = 0.0
                i[h : h + 2] = q[h : h + 2] = 0.0
            planted.append((b, off, f))
            amp = float(rng.uniform(*amplitude))
            phase = float(rng.uniform(0.0, 2 * np.pi))
            i[off : off + len(env)] += amp * np.cos(phase) * env
            q[off : off + len(env)] += amp * np.sin(phase) * env
        iq = np.empty(2 * BLOCK_SAMPLES, dtype=np.float64)
        iq[0::2] = i
        iq[1::2] = q
        blocks.append(np.clip(np.round(iq) + 127, 0, 255).astype(np.uint8))
    return np.concatenate(blocks).tobytes() if blocks else b"", planted
