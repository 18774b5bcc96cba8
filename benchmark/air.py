"""The benchmark's air: Mode S traffic as a receiver hears it, as uint8 IQ
blocks of the reference's geometry, drawn from a seed.

One general generator reads a traffic mix's parameters (frames a block,
the aircraft pool, noise, amplitudes, bit flips, the mix of downlink
formats).  The frames are every DF the reference decodes: address/parity
replies (DF 0/4/5/16/20/21/24), DF11 all-call replies (some with an
interrogator id in the parity), and DF17/18 squitters of identification,
surface position, airborne position (an even and an odd frame back to
back, CPR-encoded from where the aircraft flies near 52 N 4 E) and
velocity, with 0, 1 or 2 flipped bits past the DF field.  Each frame sits
in its own slot of the block at a random offset, amplitude and carrier
phase, over Gaussian noise, so no frame straddles two buffers.

The paced feeds reserve a block's tail for a marker: a strong, clean DF17
from MARKER_ADDR whose payload is the buffer's sequence number, placed so
that it ends before the samples the next buffer carries over.  Its arrival
at the message hub times the buffer.

A frozen copy of the generator of the program's synthetic air (the
traffic_frames / traffic_capture pair), vectorized so that hundreds of
blocks take seconds to make; it imports nothing of the program.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from .reference import modes

MARKER_ADDR = 0xBE4C4E               # reserved: no aircraft of the pool has it
MARKER_LEN = 240                     # samples of a long frame with its preamble
# the marker's first sample in the block: it ends 60 samples before the
# 238 samples the next buffer carries over
MARKER_OFF = modes.BLOCK_SAMPLES - modes.CARRY_SAMPLES - MARKER_LEN - 60
MARKER_AMPLITUDE = 100.0
PREAMBLE = np.array([1, 0, 1, 0, 0, 0, 0, 1, 0, 1, 0, 0, 0, 0, 0, 0], dtype=np.float32)
ES_TYPES = (1, 2, 3, 4, 5, 6, 7, 8, 19, 19, 19, 23, 28, 29, 31)
AP_TYPES = (0, 4, 5, 16, 20, 21, 24)
KINDS = ("address_parity", "all_call", "position_pair", "squitter")


def _rngs(seed: int, n: int):
    return [np.random.default_rng(s) for s in
            np.random.SeedSequence(seed & 0xFFFFFFFFFFFFFFFF).spawn(n)]


def _nl(lat: np.ndarray) -> np.ndarray:
    """Longitude zones at |lat| (the NL table of 1090-WP-9-14)."""
    from .reference.hub import _NL_THRESHOLDS

    th = np.array([t for t, _ in _NL_THRESHOLDS])
    nl = np.array([v for _, v in _NL_THRESHOLDS] + [1])
    return nl[np.searchsorted(th, np.abs(lat), side="right")]


def _cpr_encode(lat: np.ndarray, lon: np.ndarray, odd: int):
    """17-bit airborne CPR encoding of positions for one parity."""
    dlat = 360.0 / (60 - odd)
    yz = np.floor(131072 * np.mod(lat, dlat) / dlat + 0.5)
    rlat = dlat * (yz / 131072 + np.floor(lat / dlat))
    dlon = 360.0 / np.maximum(_nl(rlat) - odd, 1)
    xz = np.floor(131072 * np.mod(lon, dlon) / dlon + 0.5)
    return yz.astype(np.int64) & 0x1FFFF, xz.astype(np.int64) & 0x1FFFF


def _with_parity(msgs: np.ndarray, bits: np.ndarray, xor: np.ndarray) -> None:
    """Write each frame's CRC, XOR `xor`, into its last three bytes."""
    nb = bits // 8
    rows = np.arange(msgs.shape[0])
    for k in (1, 2, 3):
        msgs[rows, nb - k] = 0
    crc = modes.syndromes(msgs, bits) ^ xor
    for k, shift in ((3, 16), (2, 8), (1, 0)):
        msgs[rows, nb - k] = (crc >> shift) & 0xFF


def frames(rng, n: int, pool: np.ndarray, mix: dict, flip_weights) -> tuple[np.ndarray, np.ndarray]:
    """`n` frames (uint8 (n, 14), short ones zero-padded; bits (n,)) of the
    mix, in air order."""
    w = np.array([mix[k] for k in KINDS], dtype=np.float64)
    kind = rng.choice(len(KINDS), n, p=w / w.sum())
    per = np.where(kind == 2, 2, 1)
    keep = np.searchsorted(np.cumsum(per), n) + 1
    kind, per = kind[:keep], per[:keep]
    first = np.cumsum(per) - per
    total = int(per.sum())
    ac = rng.integers(0, pool.size, keep)
    addr = pool[ac]
    msgs = np.zeros((total, 14), dtype=np.uint8)
    xor = np.zeros(total, dtype=np.int64)
    body = rng.integers(0, 256, (keep, 14), dtype=np.uint8)

    ap = np.nonzero(kind == 0)[0]
    df = np.array(AP_TYPES)[rng.integers(0, len(AP_TYPES), ap.size)]
    msgs[first[ap]] = body[ap]
    msgs[first[ap], 0] = (df << 3) | (body[ap, 0] & 7)
    xor[first[ap]] = addr[ap]

    ac11 = np.nonzero(kind == 1)[0]
    msgs[first[ac11], :7] = body[ac11, :7]
    msgs[first[ac11], 0] = (11 << 3) | (body[ac11, 0] & 7)
    iid = np.where(rng.random(ac11.size) < 0.2, rng.integers(1, 80, ac11.size), 0)
    xor[first[ac11]] = iid

    sq = np.nonzero(kind == 3)[0]
    tc = np.array(ES_TYPES)[rng.integers(0, len(ES_TYPES), sq.size)]
    dfs = np.where(rng.random(sq.size) < 0.15, 18, 17)
    msgs[first[sq]] = body[sq]
    msgs[first[sq], 0] = (dfs << 3) | (body[sq, 0] & 7)
    msgs[first[sq], 4] = (tc << 3) | (body[sq, 4] & 7)

    pr = np.nonzero(kind == 2)[0]
    if pr.size:
        # each aircraft flies from its home, a little further each pair
        home = rng.uniform(-1.5, 1.5, (pool.size, 2)) + np.array([52.0, 4.0])
        step = rng.uniform(-0.01, 0.01, (pr.size, 2))
        order = np.argsort(ac[pr], kind="stable")
        drift = np.zeros_like(step)
        a_sorted = ac[pr][order]
        csum = np.cumsum(step[order], axis=0)
        start = np.searchsorted(a_sorted, a_sorted)            # first pair of each aircraft
        before = np.where(start[:, None] > 0, csum[np.maximum(start - 1, 0)], 0.0)
        drift[order] = csum - step[order] - before              # drift before this pair
        lat = home[ac[pr], 0] + drift[:, 0]
        lon = home[ac[pr], 1] + drift[:, 1]
        n_alt = rng.integers(40, 1640, pr.size)
        tcp = rng.integers(9, 19, pr.size)
        for odd in (0, 1):
            yz, xz = _cpr_encode(lat, lon, odd)
            r = first[pr] + odd
            msgs[r, 0] = (17 << 3) | (body[pr, 0] & 7)
            msgs[r, 4] = tcp << 3
            msgs[r, 5] = ((n_alt >> 4) << 1) | 1
            msgs[r, 6] = ((n_alt & 0xF) << 4) | (odd << 2) | (yz >> 15)
            msgs[r, 7] = (yz >> 7) & 0xFF
            msgs[r, 8] = ((yz & 0x7F) << 1) | (xz >> 16)
            msgs[r, 9] = (xz >> 8) & 0xFF
            msgs[r, 10] = xz & 0xFF
    for ev, odd in ((ac11, 0), (sq, 0), (pr, 0), (pr, 1)):
        for byte, shift in ((1, 16), (2, 8), (3, 0)):
            msgs[first[ev] + odd, byte] = (addr[ev] >> shift) & 0xFF

    bits = np.where(np.isin(msgs[:, 0] >> 3, modes.LONG_DFS), 112, 56)
    msgs[bits == 56, 7:] = 0
    _with_parity(msgs, bits, xor)

    fw = np.asarray(flip_weights, dtype=np.float64)
    nflip = rng.choice(fw.size, total, p=fw / fw.sum())
    p1 = 5 + (rng.random(total) * (bits - 5)).astype(np.int64)
    p2 = 5 + (rng.random(total) * (bits - 6)).astype(np.int64)
    p2 = np.where(p2 >= p1, p2 + 1, p2)
    for p, on in ((p1, nflip >= 1), (p2, nflip >= 2)):
        r = np.nonzero(on)[0]
        msgs[r, p[r] >> 3] ^= (1 << (7 - (p[r] & 7))).astype(np.uint8)
    return msgs[:n], bits[:n]


def envelopes(msgs: np.ndarray, bits: np.ndarray) -> np.ndarray:
    """Unit PPM envelopes (n, 240) of preamble + frame (1: pulse, then
    silence; 0: silence, then pulse), zero past a short frame."""
    b = np.unpackbits(msgs, axis=1).astype(np.float32)          # (n, 112)
    cells = np.stack([b, 1.0 - b], axis=2).reshape(msgs.shape[0], -1)
    cells[bits == 56, 2 * 56:] = 0.0
    return np.concatenate([np.broadcast_to(PREAMBLE, (msgs.shape[0], 16)), cells], axis=1)


def _pool(r_frames, mix: dict) -> np.ndarray:
    pool = r_frames.integers(1, 1 << 24, int(mix["aircraft"]))
    pool[pool == MARKER_ADDR] ^= 1
    return pool


def pool(seed: int, mix: dict) -> np.ndarray:
    """The ICAO addresses of the aircraft whose frames blocks() draws."""
    return _pool(_rngs(seed, 3)[0], mix)


def blocks(seed: int, n_blocks: int, mix: dict, *, marker: bool = False):
    """`n_blocks` blocks of air (uint8 (n_blocks, 262,144)) from `seed`, with
    the tail reserved for a marker when `marker`; also returns the float
    noise under each block's marker region ((n_blocks, 2, 240) float32),
    which `mark` needs."""
    r_frames, r_place, r_noise = _rngs(seed, 3)
    fpb = int(mix["frames_per_buffer"]) - int(marker)
    margin = int(mix["margin"])
    span = (MARKER_OFF - margin if marker else modes.BLOCK_SAMPLES - margin) - margin
    slot = span // max(fpb, 1)
    if fpb and slot < MARKER_LEN + margin:
        raise ValueError(f"{fpb} frames do not fit a block")
    pool = _pool(r_frames, mix)
    msgs, bits = frames(r_frames, n_blocks * fpb, pool, mix["kinds"], mix["flip_weights"])
    env = envelopes(msgs, bits)
    k = np.tile(np.arange(fpb), n_blocks)
    off = margin + k * slot + r_place.integers(0, slot - MARKER_LEN - margin + 1, k.size)
    lo, hi = mix["amplitude"]
    amp = r_place.uniform(lo, hi, k.size).astype(np.float32)
    phase = r_place.uniform(0.0, 2 * np.pi, k.size)
    # a frame arrives between two samples: a pulse's energy is split
    # between the sample it starts in and the next, as the fraction of
    # the sample period it covers in each
    frac = (r_place.random(k.size) * float(mix["subsample_offset"])).astype(np.float32)[:, None]
    split = np.zeros((k.size, MARKER_LEN + 1), dtype=np.float32)
    split[:, :-1] = env * (1 - frac)
    split[:, 1:] += env * frac
    env = split
    sig_i = env * (amp * np.cos(phase)).astype(np.float32)[:, None]
    sig_q = env * (amp * np.sin(phase)).astype(np.float32)[:, None]
    sigma = float(mix["noise_sigma"])
    out = np.empty((n_blocks, modes.DATA_LEN_BYTES), dtype=np.uint8)
    marker_noise = np.zeros((n_blocks, 2, MARKER_LEN), dtype=np.float32)
    chunk = 16
    starts = list(range(0, n_blocks, chunk))
    noise_rngs = [np.random.default_rng(s) for s in r_noise.bit_generator.seed_seq.spawn(len(starts))]

    def fill(c: int) -> None:
        b0 = starts[c]
        nb = min(chunk, n_blocks - b0)
        iq = noise_rngs[c].standard_normal((nb, 2, modes.BLOCK_SAMPLES), dtype=np.float32)
        iq *= sigma
        sel = slice(b0 * fpb, (b0 + nb) * fpb)
        rows = (np.arange(nb * fpb) // max(fpb, 1))[:, None]
        idx = off[sel][:, None] + np.arange(MARKER_LEN + 1)
        iq[rows, 0, idx] += sig_i[sel]
        iq[rows, 1, idx] += sig_q[sel]
        marker_noise[b0 : b0 + nb] = iq[:, :, MARKER_OFF : MARKER_OFF + MARKER_LEN]
        np.rint(iq, out=iq)
        iq += 127
        np.clip(iq, 0, 255, out=iq)
        out[b0 : b0 + nb, 0::2] = iq[:, 0]
        out[b0 : b0 + nb, 1::2] = iq[:, 1]

    # the chunks draw from their own streams, so the bytes do not depend on
    # how many threads make them
    with ThreadPoolExecutor(max_workers=min(4, os.cpu_count() or 1)) as pool_:
        list(pool_.map(fill, range(len(starts))))
    return out, marker_noise


def marker_frame(seq: int) -> np.ndarray:
    """The marker of buffer `seq`: DF17 from MARKER_ADDR, ME type 31 (an
    operational status, which moves no track), the sequence number in the
    six payload bytes, clean CRC."""
    m = np.zeros((1, 14), dtype=np.uint8)
    m[0, 0] = (17 << 3) | 5
    m[0, 1:4] = [(MARKER_ADDR >> 16) & 0xFF, (MARKER_ADDR >> 8) & 0xFF, MARKER_ADDR & 0xFF]
    m[0, 4] = 31 << 3
    m[0, 5:11] = list(int(seq).to_bytes(6, "big"))
    _with_parity(m, np.array([112]), np.zeros(1, dtype=np.int64))
    return m[0]


def is_marker(mm) -> bool:
    """Whether a decoded message (the program's or the reference's) is a
    marker."""
    return mm.crcok and mm.msgtype == 17 and mm.addr == MARKER_ADDR


def marker_seq(msg: bytes) -> int:
    """The sequence number a marker frame carries."""
    return int.from_bytes(bytes(msg[5:11]), "big")


def mark(block: np.ndarray, noise: np.ndarray, seq: int, phase: float) -> np.ndarray:
    """A copy of `block` with buffer `seq`'s marker modulated over the
    block's own noise in the marker region."""
    env = envelopes(marker_frame(seq)[None], np.array([112]))[0]
    i = noise[0] + MARKER_AMPLITUDE * np.cos(phase) * env
    q = noise[1] + MARKER_AMPLITUDE * np.sin(phase) * env
    out = block.copy()
    s = 2 * MARKER_OFF
    out[s : s + 2 * MARKER_LEN : 2] = np.clip(np.rint(i) + 127, 0, 255).astype(np.uint8)
    out[s + 1 : s + 2 * MARKER_LEN : 2] = np.clip(np.rint(q) + 127, 0, 255).astype(np.uint8)
    return out


def frame_buffers(data: np.ndarray) -> np.ndarray:
    """Blocks (n, 262,144) -> the buffers the reference's decode loop sees
    (n, 262,620): 476 bytes carried from the previous block (127, no
    signal, before the first), then the block."""
    n = data.shape[0]
    out = np.empty((n, modes.BUF_BYTES), dtype=np.uint8)
    out[:, modes.CARRY_BYTES :] = data
    out[0, : modes.CARRY_BYTES] = 127
    if n > 1:
        out[1:, : modes.CARRY_BYTES] = data[:-1, modes.DATA_LEN_BYTES - modes.CARRY_BYTES :]
    return out


def paced_buffers(seed: int, n: int, mix: dict) -> np.ndarray:
    """`n` framed buffers of a paced feed: the mix's distinct blocks in
    turn, buffer k carrying marker k."""
    distinct = min(int(mix["distinct_blocks"]), n)
    base, noise = blocks(seed, distinct, mix, marker=True)
    (r_phase,) = _rngs(seed ^ 0x5EED, 1)
    phase = r_phase.uniform(0.0, 2 * np.pi, n)
    data = np.stack([mark(base[k % distinct], noise[k % distinct], k, phase[k]) for k in range(n)])
    return frame_buffers(data)
