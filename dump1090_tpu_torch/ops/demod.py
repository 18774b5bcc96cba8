"""Block demodulator: magnitude rows -> compacted Mode S candidates, and both
demodulation passes of every candidate (plain PyTorch).

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

demod_batch, demod_block and demod_iq_block return the whole per-buffer
result as Candidates, the host-resolve path's device output: the sequential
skip rule and the ICAO cache are then replayed on the host (the C++ runtime
in native/, or models/resolver.py for the --debug dumps).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..constants import (
    BIT_REPEAT_DELTA,
    FULL_LEN_SAMPLES,
    LONG_MSG_BITS,
    PREAMBLE_SAMPLES,
    SHORT_MSG_BITS,
)
from .gather import WINDOW_PAD, gather_windows
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


def front_candidates(m: torch.Tensor, scan_len: int, max_candidates: int):
    """Batched front half in its `mask` form: magnitudes int32 (B, S) ->
    (n int32[B] exact preamble count, pos int32[B, max_candidates])."""
    mask = preamble_mask(m, scan_len)
    n = mask.sum(dim=1, dtype=torch.int32)
    return n, compact_positions(mask, max_candidates, scan_len)


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


def candidate_passes_window(w: torch.Tensor, pos: torch.Tensor):
    """Both demod passes for N candidates given their gathered windows
    ((N, >=241) uint16 or int32, w[:, 0] = m[pos-1]) and int32 scan
    positions (N,).  Phase correction is skipped at pos == 0, where m[-1]
    does not exist (dump1090.c:1658-1663).

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


def pad_magnitudes(m: torch.Tensor) -> torch.Tensor:
    """int32 magnitudes (B, S) -> the window gather's uint16 (B, S_pad) rows.

    The padded row keeps the JAX package's geometry (one-sample lead, 2048 +
    256 samples of tail, rounded up to 1024), so the window kernel sees the
    same (B, 134144) uint16 input at the file-decode width.  Magnitudes
    (<= 65167) are narrowed through int16, whose cast keeps the low 16 bits,
    and the buffer is reinterpreted as uint16."""
    b, s = m.shape
    s_pad = -(-(s + 1 + 2048 + WINDOW_PAD) // 1024) * 1024
    m_pad = torch.zeros((b, s_pad), dtype=torch.int16, device=m.device)
    m_pad[:, 1 : s + 1] = m
    return m_pad.view(torch.uint16)


def gather_candidate_windows(m: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Fetch (B, MC, 256) uint16 candidate windows from int32 magnitudes
    (B, S); window index 0 holds m[pos-1] (zero at the stream head)."""
    return gather_windows(pad_magnitudes(m), pos)


def _candidate_passes(m: torch.Tensor, pos: torch.Tensor):
    """Windows (K1) and both demod passes of every candidate of int32
    magnitudes (B, S) at int32 positions (B, MC): the six per-candidate
    fields of Candidates, shaped (B, MC, ...)."""
    b, mc = pos.shape
    w = gather_candidate_windows(m, pos)
    outs = candidate_passes_window(w.reshape(b * mc, -1), pos.reshape(-1))
    return [o.reshape((b, mc) + tuple(o.shape[1:])) for o in outs]


def demod_batch(iq_buffers: torch.Tensor, *, scan_len: int, max_candidates: int) -> Candidates:
    """Batched demodulation of (B, nbytes) uint8 IQ buffers, or of the same
    wire bytes as (B, nbytes/2) uint16 I|Q<<8 pairs: magnitudes, the front
    (exact count and first-K positions), the window gather (K1) and both
    demod passes, with every field shaped (B, ...).  Nothing syncs the
    host.  Port of dump1090_tpu/parallel/sharding.py::demod_batch (the
    single-device form; the sharded forms are not ported)."""
    if iq_buffers.dtype == torch.uint16:
        m = magnitude_from_pairs(iq_buffers)
    else:
        m = magnitude_from_iq(iq_buffers)
    n, pos = front_candidates(m, scan_len, max_candidates)
    return Candidates(n, pos, *_candidate_passes(m, pos))


def demod_block(m: torch.Tensor, *, scan_len: int, max_candidates: int = 512) -> Candidates:
    """Demodulate one magnitude block: int32 (S,) -> Candidates of one
    buffer (n is a 0-d tensor).  scan_len: number of scan positions
    (reference: S - 240, dump1090.c:1593)."""
    n, pos = front_candidates(m[None], scan_len, max_candidates)
    return Candidates(n[0], pos[0], *(f[0] for f in _candidate_passes(m[None], pos)))


def demod_iq_block(iq_bytes: torch.Tensor, *, scan_len: int, max_candidates: int = 512) -> Candidates:
    """One buffer of uint8 IQ bytes -> Candidates of one buffer:
    demod_batch over a batch of one."""
    cand = demod_batch(iq_bytes[None], scan_len=scan_len, max_candidates=max_candidates)
    return Candidates(*(f[0] for f in cand))
