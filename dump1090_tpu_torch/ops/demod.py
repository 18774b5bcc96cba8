"""Block demodulator: magnitude rows -> compacted Mode S candidates, and both
demodulation passes of every candidate.

Behavioral contract: detectModeS + applyPhaseCorrection,
dump1090.c:1471-1793.  Port of dump1090_tpu/ops/demod.py, with the same
restructuring of the reference's branchy scan into a data-parallel pipeline
with no approximation:

  1. the preamble predicate (10 relational tests + high/quiet checks,
     dump1090.c:1602-1650) at every sample offset at once, as boolean masks
     over shifted views;
  2. the first `max_candidates` hit positions of each row, ascending, padded
     with scan_len, plus the exact hit count (overflow is detected by the
     caller, never silent) — an exclusive cumsum rank and one scatter, so no
     data-dependent shape and no host sync;
  3. for each candidate, BOTH demodulation passes as pure functions of its
     241-sample window: the uncorrected pass and the phase-corrected retry
     (the reference mutates then restores its buffer, dump1090.c:1655-1693,
     so the retry is local and is computed out of place);
  4. bit decisions, the repeat-previous-bit rule, byte packing, the first-bit
     demod-error flag and the noise gate as batched integer ops.

Everything is vectorized over all candidates of a dispatch group: tensors
are (N, ...) with N = buffers x max_candidates.

Steps 3 and 4 are one CUDA kernel on the card (K4, csrc/candidate_passes.cu,
launched by candidate_passes_window); candidate_passes_window_plain is its
plain version, which runs on a CPU tensor.

demod_batch, demod_block and demod_iq_block return the whole per-buffer
result as Candidates, the host-resolve path's device output: the sequential
skip rule and the ICAO cache are then replayed on the host (the C++ runtime
in native/, or models/resolver.py for the --debug dumps).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from ..constants import (
    BIT_REPEAT_DELTA,
    FULL_LEN_SAMPLES,
    LONG_MSG_BITS,
    PREAMBLE_SAMPLES,
    SHORT_MSG_BITS,
)
from . import _cuda
from .gather import WINDOW_PAD, gather_row_windows
from .magnitude import magnitude_from_iq, magnitude_from_pairs

WINDOW = FULL_LEN_SAMPLES + 1  # 241: one leading sample (m[j-1]) + preamble + frame


class Candidates(NamedTuple):
    """Compacted per-buffer demodulation results, fixed shape and padded:
    torch tensors on the device, or their numpy copies on the host.  Shapes
    are per buffer ([] and [C]) or per batch ([B] and [B, C])."""

    n: torch.Tensor        # int32, number of preambles (may exceed C: overflow)
    pos: torch.Tensor      # [C] int32 scan position of each candidate
    msg1: torch.Tensor     # [C, 14] uint8 packed frame, uncorrected pass
    errors1: torch.Tensor  # [C] int32 demod-error count, uncorrected pass
    gate1: torch.Tensor    # [C] bool noise-gate pass, uncorrected pass
    msg2: torch.Tensor     # [C, 14] uint8 packed frame, phase-corrected pass
    errors2: torch.Tensor  # [C] int32
    gate2: torch.Tensor    # [C] bool


def _preamble_stages(m: torch.Tensor, scan_len: int):
    """The three tests of the preamble predicate at every scan position of
    the last axis of int32 `m`: the 10-sample relational test, the 3..6
    high-level test and the 10..15 quiet-tail test (dump1090.c:1602-1650)."""

    def s(k: int) -> torch.Tensor:
        return m[..., k : k + scan_len]

    stage1 = (
        (s(0) > s(1))
        & (s(1) < s(2))
        & (s(2) > s(3))
        & (s(3) < s(0))
        & (s(4) < s(0))
        & (s(5) < s(0))
        & (s(6) < s(0))
        & (s(7) > s(8))
        & (s(8) < s(9))
        & (s(9) > s(6))
    )
    high = (s(0) + s(2) + s(7) + s(9)) // 6
    stage2 = (s(4) < high) & (s(5) < high)
    stage3 = (s(11) < high) & (s(12) < high) & (s(13) < high) & (s(14) < high)
    return stage1, stage2, stage3


def preamble_mask(m: torch.Tensor, scan_len: int) -> torch.Tensor:
    """The preamble predicate at every scan position of every row.

    Contract: dump1090.c:1602-1650.  `m` is int32 (B, S); returns bool
    (B, scan_len) with scan_len = S - FULL_LEN_SAMPLES (the reference scans
    j < mlen - MODES_FULL_LEN*2, dump1090.c:1593)."""
    stage1, stage2, stage3 = _preamble_stages(m, scan_len)
    return stage1 & stage2 & stage3


def preamble_reject_stages(m: torch.Tensor, *, scan_len: int) -> torch.Tensor:
    """Debug-mode companion of preamble_mask: the uint8 rejection code of
    each scan position of int32 magnitudes (..., S) -- 0 pass, 1 failed the
    10-sample relational test, 2 failed the 3..6 high-level test, 3 failed
    the 10..15 quiet-tail test.  Mirrors the reference's three --debug p
    dump sites (dump1090.c:1602-1650)."""
    stage1, stage2, stage3 = _preamble_stages(m, scan_len)
    code = torch.where(~stage1, 1, torch.where(~stage2, 2, torch.where(~stage3, 3, 0)))
    return code.to(torch.uint8)


def first_k_positions(mask: torch.Tensor, k: int, fill: int) -> torch.Tensor:
    """Indices of the first k set entries of each row of a bool (B, L) mask,
    ascending, padded with `fill`: int64 (B, k).

    Each set entry's exclusive running count is its output slot; entries
    past the k-th (and unset ones) go to a discarded slot k."""
    b, length = mask.shape
    mi = mask.to(torch.int32)
    rank = torch.cumsum(mi, dim=1, dtype=torch.int32).sub_(mi)
    slot = torch.where(mask & (rank < k), rank, k).to(torch.int64)
    out = torch.full((b, k + 1), fill, dtype=torch.int64, device=mask.device)
    src = torch.arange(length, dtype=torch.int64, device=mask.device)
    out.scatter_(1, slot, src.expand(b, length))
    return out[:, :k]


def compact_positions(mask: torch.Tensor, max_candidates: int, scan_len: int) -> torch.Tensor:
    """int32 (B, max_candidates): the first max_candidates set positions of
    each row in scan order, like the reference's left-to-right walk, padded
    with `scan_len`."""
    return first_k_positions(mask, max_candidates, scan_len).to(torch.int32)


_FILL = -(2**30)  # the score of an empty slot: below every real score
# popcount of every byte value (torch has no population count)
_POPCOUNT = [bin(v).count("1") for v in range(256)]


@functools.cache
def _popcount_lut(device: torch.device) -> torch.Tensor:
    """_POPCOUNT as int32 on `device`, built once: a dispatch that a CUDA
    graph captures copies nothing from the host."""
    return torch.tensor(_POPCOUNT, dtype=torch.int32, device=device)


def compact_positions_from_bytes(byte: torch.Tensor, max_candidates: int,
                                 scan_len: int) -> torch.Tensor:
    """compact_positions entered at the packed group-byte level: int32
    (B, n_grp) bytes (bit 7 = first position of the group) -> int32
    (B, max_candidates), the first max_candidates set positions of each row
    ascending, padded with `scan_len`.

    Levels, as in the JAX package, engaged by the static sizes: with
    max_candidates <= n_sup the first max_candidates non-empty supergroups
    of 8 groups are taken by a top_k over supergroup scores, their group
    bytes fetched, and the surviving groups taken by a second top_k; with
    max_candidates <= n_grp the first non-empty groups directly; otherwise
    a flat top_k over positions.  Every selected container holds a hit, so
    the first-K property holds at each level.  Scores are int32 with the
    JAX encodings (-(gidx*256 + 255 - byte), fill -(2**30)); only the top_k
    VALUES are used, so the order in which ties come back does not
    matter.  The JAX package fetches the supergroups' bytes with a one-hot
    product on the MXU, exact for one-hot rows and bytes <= 255; here that
    fetch is the gather it computes."""
    b, n_grp = byte.shape
    n_sup = -(-n_grp // 8)
    dev = byte.device
    t8 = torch.arange(8, dtype=torch.int32, device=dev)

    def top(score: torch.Tensor, k: int) -> torch.Tensor:
        return torch.topk(score, k, dim=-1).values

    if max_candidates <= n_sup:
        # level 0: first MC non-empty supergroups (64 positions each)
        bpad = torch.zeros((b, n_sup * 8), dtype=torch.int32, device=dev)
        bpad[:, :n_grp] = byte
        b8 = bpad.reshape(b, n_sup, 8)
        si = torch.arange(n_sup, dtype=torch.int32, device=dev)
        sscore = torch.where((b8 > 0).any(dim=2), -si, _FILL)
        ssel = -top(sscore, max_candidates)       # ascending, padded with 2^30
        valid_s = ssel < n_sup
        ssel_c = torch.where(valid_s, ssel, 0)
        gbytes = torch.gather(b8, 1, ssel_c.to(torch.int64)[:, :, None].expand(-1, -1, 8))
        gbytes = gbytes * valid_s[:, :, None]
        gidx = ssel_c[:, :, None] * 8 + t8
        gscore = torch.where((gbytes > 0) & valid_s[:, :, None],
                             -(gidx * 256 + 255 - gbytes), _FILL).reshape(b, -1)
        vals = top(gscore, max_candidates)
    elif max_candidates <= n_grp:
        # first MC non-empty groups; the byte folds into disjoint score
        # ranges so it travels with the group index
        gi = torch.arange(n_grp, dtype=torch.int32, device=dev)
        score = torch.where(byte > 0, -(gi * 256 + 255 - byte), _FILL)
        vals = top(score, max_candidates)
    else:
        # degenerate (tiny rows): flat top_k over positions
        flat_bits = ((byte[:, :, None] >> (7 - t8)) & 1).reshape(b, -1)
        pi = torch.arange(n_grp * 8, dtype=torch.int32, device=dev)
        k = min(max_candidates, n_grp * 8)
        fscore = torch.where(flat_bits > 0, -pi, _FILL)
        fpos = torch.clamp_max(-top(fscore, k), scan_len)
        pad = torch.full((b, max_candidates - k), scan_len, dtype=torch.int32, device=dev)
        return torch.cat([fpos, pad], dim=1)

    v = -vals
    grp = v // 256
    gbyte = torch.where(v < 2**30 - 1, 255 - v % 256, 0)
    # final level: expand each group's bits to positions, compact the rest
    hit = ((gbyte[:, :, None] >> (7 - t8)) & 1) > 0
    pos = grp[:, :, None] * 8 + t8
    pscore = torch.where(hit & (pos < scan_len), -pos, _FILL).reshape(b, -1)
    return torch.clamp_max(-top(pscore, max_candidates), scan_len)


def preamble_bytes(m: torch.Tensor, scan_len: int, *, algebra: bool = True,
                   mxu: bool = False) -> torch.Tensor:
    """Byte-packed preamble predicate of each row of int32 magnitudes
    (B, S): int32 (B, ceil(scan_len/8)), bit 7 of byte g = position 8g.

    The 15-tap predicate (dump1090.c:1602-1650) is evaluated once over the
    zero-padded group domain and materialized as packed group bytes: `n`
    is their popcount and compaction enters at
    compact_positions_from_bytes.  algebra=True shares pairwise
    subexpressions across taps (one gt/lt compare, a 2- and 4-wide running
    max for the s3..s6 < s0 and quiet-tail tests, one pair sum for
    `high`); algebra=False is the direct 15-slice form.  mxu=True packs
    bits into bytes by a product instead of shift and or (pack_bits).  All
    four are bit-identical to the mask form.

    Requires S >= ceil(scan_len/8)*8 + 17, which every caller geometry
    satisfies: a buffer carries FULL_LEN_SAMPLES = 240 real samples past its
    last scan position (dump1090.c:1593)."""
    b, s_len = m.shape
    n_grp = -(-scan_len // 8)
    n_pad = n_grp * 8
    if s_len < n_pad + 17:
        raise ValueError(
            f"preamble_bytes: row of {s_len} samples cannot cover "
            f"{scan_len} scan positions (needs >= {n_pad + 17})"
        )
    if not algebra:
        def s(k: int) -> torch.Tensor:
            return m[:, k : k + n_pad]

        c = (
            (s(0) > s(1)) & (s(1) < s(2)) & (s(2) > s(3)) & (s(3) < s(0))
            & (s(4) < s(0)) & (s(5) < s(0)) & (s(6) < s(0))
            & (s(7) > s(8)) & (s(8) < s(9)) & (s(9) > s(6))
        )
        high = (s(0) + s(2) + s(7) + s(9)) // 6
        c &= (s(4) < high) & (s(5) < high)
        c &= (s(11) < high) & (s(12) < high) & (s(13) < high) & (s(14) < high)
    else:
        # Shared subexpressions, each built once and tapped shifted.  The
        # largest tap offset is 11 (mm2), and mm2 reaches 2 further into mm,
        # so they are built over n_pad + 16 positions: the roll's
        # wraparound then lies beyond every tap.
        nb = n_pad + 16
        a0, a1 = m[:, :nb], m[:, 1 : nb + 1]
        gt = a0 > a1                       # m[j] >  m[j+1]
        lt = a0 < a1                       # m[j] <  m[j+1]
        mm = torch.maximum(a0, a1)         # max(m[j], m[j+1])
        mm2 = torch.maximum(mm, torch.roll(mm, -2, dims=1))  # max(m[j..j+3])
        q = a0 + torch.roll(a0, -2, dims=1)                  # m[j] + m[j+2]

        def tap(arr: torch.Tensor, k: int) -> torch.Tensor:
            return arr[:, k : k + n_pad]

        high = (tap(q, 0) + tap(q, 7)) // 6
        c = (
            tap(gt, 0) & tap(lt, 1) & tap(gt, 2)
            & (tap(mm2, 3) < tap(a0, 0))           # s3..s6 all < s0
            & tap(gt, 7) & tap(lt, 8)
            & (tap(a0, 9) > tap(a0, 6))            # s9 > s6
            & (tap(mm, 4) < high)                  # s4, s5 < high
            & (tap(mm2, 11) < high)                # s11..s14 < high
        )
    c &= torch.arange(n_pad, device=m.device) < scan_len
    return pack_bits(c.reshape(b, n_grp, 8), mxu=mxu)


def pack_bits(bits: torch.Tensor, *, mxu: bool = False) -> torch.Tensor:
    """bool (..., 8) -> int32 (...) bytes, the first bit the most
    significant: by shift and sum (the bits are disjoint, so the sum is the
    or), or with mxu=True by a product with the weights 128..1 in float32,
    where the operands are 0/1 and powers of two and every sum up to 255 is
    exact."""
    shifts = 7 - torch.arange(8, dtype=torch.int32, device=bits.device)
    if mxu:
        w = (1 << shifts).to(torch.float32)
        return torch.matmul(bits.to(torch.float32), w).to(torch.int32)
    return (bits.to(torch.int32) << shifts).sum(dim=-1, dtype=torch.int32)


def front_packed(m: torch.Tensor, scan_len: int, max_candidates: int, *,
                 algebra: bool = True, mxu: bool = False):
    """(n int32 (B,), pos int32 (B, max_candidates)) of int32 magnitudes
    (B, S) through the byte-packed predicate."""
    byte = preamble_bytes(m, scan_len, algebra=algebra, mxu=mxu)
    n = _popcount_lut(m.device)[byte.to(torch.int64)].sum(dim=1, dtype=torch.int32)
    return n, compact_positions_from_bytes(byte, max_candidates, scan_len)


FRONTS = ("mask", "packed", "packed-mxu", "packed-plain", "packed-plain-mxu")


def front_variant() -> str:
    """The front formulation taken when none is passed: DUMP1090_TPU_FRONT
    when set, else 'mask' on every device.

    'mask' is preamble_mask + compact_positions; 'packed[-plain][-mxu]' the
    single-evaluation preamble_bytes (-plain without the shared
    subexpressions, -mxu packing bytes by a product).  All bit-identical.
    The JAX package picks 'packed' off a TPU from CPU and TPU timings; the
    port keeps 'mask', with which every card number of the port was taken,
    until a card measurement picks another."""
    import os

    return os.environ.get("DUMP1090_TPU_FRONT") or "mask"


def check_front(front: str) -> tuple[bool, bool] | None:
    """None for 'mask', else (algebra, mxu) of a packed variant; ValueError
    for any other name."""
    if front == "mask":
        return None
    tokens = front.split("-")
    if tokens[0] != "packed" or not set(tokens[1:]) <= {"plain", "mxu"}:
        raise ValueError(f"unknown demod front variant: {front!r}")
    return "plain" not in tokens, "mxu" in tokens


def front_candidates(m2d: torch.Tensor, scan_len: int, max_candidates: int,
                     front: str | None = None):
    """Batched front half: int32 magnitudes (B, S) -> (n int32[B] exact
    preamble count, pos int32[B, max_candidates]) in the formulation named
    by `front` (None: front_variant())."""
    packed = check_front(front_variant() if front is None else front)
    if packed is None:
        mask = preamble_mask(m2d, scan_len)
        n = mask.sum(dim=1, dtype=torch.int32)
        return n, compact_positions(mask, max_candidates, scan_len)
    algebra, mxu = packed
    return front_packed(m2d, scan_len, max_candidates, algebra=algebra, mxu=mxu)


def _slice_window(ms: torch.Tensor):
    """PPM bit-slice (N, 224) message samples (dump1090.c:1666-1706).

    Returns (msg_bytes uint8[N, 14], errors int32[N], df int32[N]).

    Bit rules, in reference priority order: for cell i>0 with |low-high| <
    256 repeat the previous bit; low == high is a demod error (only reachable
    at i == 0); otherwise bit = low > high.  The repeat rule is a
    fill-forward: each cell takes the raw decision of the nearest preceding
    confident cell, via a cumulative max over (index << 2 | bit)."""
    n = ms.shape[0]
    low = ms[:, 0::2]
    high = ms[:, 1::2]
    delta = (low - high).abs_()
    t = torch.arange(LONG_MSG_BITS, dtype=torch.int32, device=ms.device)

    raw = (low > high).to(torch.int32)
    err0 = low[:, 0] == high[:, 0]
    raw[:, 0] = torch.where(err0, 2, raw[:, 0])
    confident = (t == 0) | (delta >= BIT_REPEAT_DELTA)
    coded = torch.where(confident, (t << 2) | raw, -1)
    bits = torch.cummax(coded, dim=1).values & 3

    # error bits (value 2) are only assigned at cell 0 (dump1090.c:1677-1682)
    errors = err0.to(torch.int32)

    # Pack MSB-first with bitwise OR — the reference ORs shifted bit values,
    # so an error value 2 at bit k spills into bit k-1 (and off the top of
    # the byte for k == 0), dump1090.c:1696-1706.  A sum would differ where
    # spills overlap, so the OR is taken column by column.
    shifts = 7 - torch.arange(8, dtype=torch.int32, device=ms.device)
    shifted = bits.reshape(n, 14, 8) << shifts
    packed = shifted[..., 0]
    for k in range(1, 8):
        packed = packed | shifted[..., k]
    packed = packed & 0xFF
    return packed.to(torch.uint8), errors, packed[:, 0] >> 3


def _noise_gate(orig: torch.Tensor, df: torch.Tensor) -> torch.Tensor:
    """Noise gate: mean per-cell |low-high| over the *claimed* message length
    must clear 10*255 under integer division (dump1090.c:1713-1726).

    The reference restores the original magnitudes *before* computing the
    gate (dump1090.c:1692-1693 vs :1713), so even on the phase-corrected
    retry the gate reads UNCORRECTED samples — only the claimed length (via
    the DF of the freshly sliced bits) differs between passes."""
    delta = (orig[:, 0::2] - orig[:, 1::2]).abs_()
    is_long = (df >= 16) & (df <= 21)
    msglen_bytes = torch.where(is_long, 14, 7)
    ds = torch.where(is_long, delta.sum(dim=1), delta[:, :SHORT_MSG_BITS].sum(dim=1))
    return ds // (msglen_bytes * 4) >= 10 * 255


def _phase_corrected_window(w: torch.Tensor) -> torch.Tensor:
    """Phase-corrected copy of the 224 message samples of windows `w`
    (int32 (N, 241), w[:, 0] = m[j-1]).  Contract: applyPhaseCorrection,
    dump1090.c:1471-1558.

    The reference walks the message serially, scaling each next sample by a
    fixed-point factor chosen from the previous (already-scaled) sample's bit
    decision.  Only every other sample is written (odd indices walking
    backward, even walking forward), so each direction is a 111-step
    recurrence carrying one value per candidate: both directions run in one
    Python loop of vector ops over all N candidates."""
    w64 = w.to(torch.int64)
    on_time = w64[:, 1] + w64[:, 3] + w64[:, 8] + w64[:, 10]
    early = (w64[:, 0] + w64[:, 7]) * 2
    late = (w64[:, 4] + w64[:, 11]) * 2
    m = w[:, PREAMBLE_SAMPLES + 1 :]  # w[17:241]

    def factors(e: torch.Tensor):
        # uint32 C semantics: 16384*e <= 16384*260668 < 2^32, no wrap
        q = ((16384 * e) // torch.clamp(e + on_time, min=1)).to(torch.int32)
        return 16384 + q, 16384 - q

    is_early = early > late
    up_e, down_e = factors(early)
    up_l, down_l = factors(late)
    up = torch.where(is_early, up_e, up_l)
    down = torch.where(is_early, down_e, down_l)

    def scale(v: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
        # uint16 scaleSample: v*f/16384 clamped to 65535 (dump1090.c:1473-1476);
        # v <= 65535 and f <= 32768 keep v*f inside int32
        return torch.clamp_max((v * f) >> 14, 65535)

    odd = m[:, 1::2]    # positions 1, 3, ..., 223
    even = m[:, 0::2]   # positions 0, 2, ..., 222

    # late >= early: seed-scale position 0, walk forward writing even
    # positions 2..222 (dump1090.c:1535-1556); step k reads odd[k], writes
    # even[k+1].  early > late: seed-scale position 223, walk backward
    # writing odd positions 221..1 (dump1090.c:1513-1533); step k reads
    # even[111-k], writes odd[110-k].
    v_f = scale(even[:, 0], up)
    v_b = scale(odd[:, 111], up)
    evens_fwd = [v_f]
    odds_bwd = [v_b]
    for k in range(111):
        v_f = scale(even[:, k + 1], torch.where(v_f > odd[:, k], up, down))
        v_b = scale(odd[:, 110 - k], torch.where(even[:, 111 - k] > v_b, down, up))
        evens_fwd.append(v_f)
        odds_bwd.append(v_b)
    m_fwd = torch.stack([torch.stack(evens_fwd, dim=1), odd], dim=2)
    m_bwd = torch.stack([even, torch.stack(odds_bwd[::-1], dim=1)], dim=2)
    n = w.shape[0]
    return torch.where(
        is_early[:, None], m_bwd.reshape(n, -1), m_fwd.reshape(n, -1)
    )


def widen_windows(w: torch.Tensor) -> torch.Tensor:
    """uint16 (storage only) or int32 windows -> int32, first WINDOW samples."""
    if w.dtype == torch.uint16:
        return w[:, :WINDOW].view(torch.int16).to(torch.int32) & 0xFFFF
    return w[:, :WINDOW].to(torch.int32)


def candidate_passes_window_plain(w: torch.Tensor, pos: torch.Tensor):
    """Plain version of candidate_passes_window: both demod passes for N
    candidates given their gathered windows ((N, >=241) uint16 or int32,
    w[:, 0] = m[pos-1]) and int32 scan positions (N,).  Phase correction is
    skipped at pos == 0, where m[-1] does not exist (dump1090.c:1658-1663).

    Returns (msg1 uint8[N,14], errors1 int32[N], gate1 bool[N], msg2,
    errors2, gate2)."""
    w = widen_windows(w)
    msg_region = w[:, PREAMBLE_SAMPLES + 1 :]
    msg1, errors1, df1 = _slice_window(msg_region)
    gate1 = _noise_gate(msg_region, df1)
    corrected = _phase_corrected_window(w)
    corrected = torch.where((pos > 0)[:, None], corrected, msg_region)
    msg2, errors2, df2 = _slice_window(corrected)
    gate2 = _noise_gate(msg_region, df2)  # gate reads restored originals
    return msg1, errors1, gate1, msg2, errors2, gate2


def _check_passes(w: torch.Tensor, pos: torch.Tensor) -> None:
    """What K4 indexes: contiguous (N, >=241) uint16 or int32 windows and
    N contiguous int32 positions, on one device."""
    if w.dtype not in (torch.uint16, torch.int32) or w.dim() != 2 or w.shape[1] < WINDOW:
        raise TypeError(f"w must be uint16 or int32 (N, >={WINDOW}), got {w.dtype} "
                        f"{tuple(w.shape)}")
    if pos.dtype != torch.int32 or pos.dim() != 1 or pos.shape[0] != w.shape[0]:
        raise TypeError(f"pos must be int32 (N,) with N = {w.shape[0]}, got {pos.dtype} "
                        f"{tuple(pos.shape)}")
    if not (w.is_contiguous() and pos.is_contiguous()):
        raise ValueError("the demod passes need contiguous windows and positions")
    if w.get_device() != pos.get_device():
        raise ValueError(f"w on {w.device} but pos on {pos.device}")


def candidate_passes_window(w: torch.Tensor, pos: torch.Tensor):
    """Both demod passes of N candidates (candidate_passes_window_plain's
    arguments and results): K4 on CUDA tensors, the plain version on the
    CPU.  The two passes' outputs are views of one buffer per field."""
    _check_passes(w, pos)
    if not w.is_cuda:
        if w.device.type != "cpu":
            raise ValueError(f"the demod passes run on cuda or cpu, not {w.device}")
        return candidate_passes_window_plain(w, pos)
    index = w.get_device()
    if index != torch.cuda.current_device():
        with torch.cuda.device(index):  # the launch goes to the current device
            return candidate_passes_window(w, pos)
    n = w.shape[0]
    msg = torch.empty((2, n, LONG_MSG_BITS // 8), dtype=torch.uint8, device=w.device)
    errors = torch.empty((2, n), dtype=torch.int32, device=w.device)
    gate = torch.empty((2, n), dtype=torch.bool, device=w.device)
    if n:
        err = _cuda.library().candidate_passes(
            w.data_ptr(), w.element_size(), w.shape[1], pos.data_ptr(), msg.data_ptr(),
            errors.data_ptr(), gate.data_ptr(), n, _cuda.current_stream(index),
        )
        _cuda.count("candidate_passes")
        _cuda.check(err, "candidate_passes")
    return msg[0], errors[0], gate[0], msg[1], errors[1], gate[1]


def gather_candidate_windows(m: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Fetch (B, MC, 256) uint16 candidate windows from magnitudes (B, S),
    int32 or uint16; window index 0 holds m[pos-1] (zero at the stream
    head).  K1 reads m itself: of the JAX package's padded row (one-sample
    lead, 2048 + 256 samples of tail, rounded up to 1024) only its length
    is kept, as the clamp of a window's start."""
    s_pad = -(-(m.shape[1] + 1 + 2048 + WINDOW_PAD) // 1024) * 1024
    return gather_row_windows(m.contiguous(), pos, lead=1, s_pad=s_pad)


def _candidate_passes(m: torch.Tensor, pos: torch.Tensor):
    """Windows (K1) and both demod passes of every candidate of int32
    magnitudes (B, S) at int32 positions (B, MC): the six per-candidate
    fields of Candidates, shaped (B, MC, ...)."""
    b, mc = pos.shape
    w = gather_candidate_windows(m, pos)
    outs = candidate_passes_window(w.reshape(b * mc, -1), pos.reshape(-1))
    return [o.reshape((b, mc) + tuple(o.shape[1:])) for o in outs]


def demod_batch(iq_buffers: torch.Tensor, *, scan_len: int, max_candidates: int,
                front: str | None = None) -> Candidates:
    """Batched demodulation of (B, nbytes) uint8 IQ buffers, or of the same
    wire bytes as (B, nbytes/2) uint16 I|Q<<8 pairs: magnitudes, the front
    (exact count and first-K positions, in the formulation `front` names;
    see front_candidates), the window gather (K1) and both demod passes,
    with every field shaped (B, ...).  Nothing syncs the host.  Port of
    dump1090_tpu/parallel/sharding.py::demod_batch (the batch-sharded form
    run on one device; parallel/sharding.py holds the time-sharded form)."""
    if iq_buffers.dtype == torch.uint16:
        m = magnitude_from_pairs(iq_buffers)
    else:
        m = magnitude_from_iq(iq_buffers)
    n, pos = front_candidates(m, scan_len, max_candidates, front)
    return Candidates(n, pos, *_candidate_passes(m, pos))


def demod_block(m: torch.Tensor, *, scan_len: int, max_candidates: int = 512,
                front: str | None = None) -> Candidates:
    """Demodulate one magnitude block: int32 (S,) -> Candidates of one
    buffer (n is a 0-d tensor).  scan_len: number of scan positions
    (reference: S - 240, dump1090.c:1593)."""
    n, pos = front_candidates(m[None], scan_len, max_candidates, front)
    return Candidates(n[0], pos[0], *(f[0] for f in _candidate_passes(m[None], pos)))


def demod_iq_block(iq_bytes: torch.Tensor, *, scan_len: int, max_candidates: int = 512,
                   front: str | None = None) -> Candidates:
    """One buffer of uint8 IQ bytes -> Candidates of one buffer:
    demod_batch over a batch of one."""
    cand = demod_batch(iq_bytes[None], scan_len=scan_len, max_candidates=max_candidates,
                       front=front)
    return Candidates(*(f[0] for f in cand))
