"""On-device candidate resolver: demodulation, the order-independent decode
precompute, the sequential skip/ICAO-cache walk and the emission of one
dispatch group, or of many independent capture streams sharing one dispatch
(port of dump1090_tpu/ops/resolve.py: the packed raw emission, the unpacked
msg + meta emission, and demod_resolve_streams).

Behavioral contract: the candidate-resolution half of detectModeS +
decodeModesMessage (dump1090.c:1563-1793, 1091-1209).

Everything order-INDEPENDENT is vectorized over all candidates of the group
before the sequential part:

  * CRC-24 syndromes of both demod passes as one GF(2) product (float32
    operands: 0/1 values with sums <= 88 are exact, even under TF32);
  * syndrome-table error correction through a dense 2^24-entry table (the
    glibc bsearch probe choice among duplicate syndromes, dump1090.c:862-865,
    is baked in when the table is built) — one gather per candidate;
  * the brute-force AP address (dump1090.c:942-983) is the syndrome itself;
  * the whole CRC-acceptance policy collapses to two bits per pass: "CRC ok
    if the ICAO cache hits" and "CRC ok if it does not".

What remains is sequential: the skip-until position (reset per buffer,
advanced past good messages, dump1090.c:1769-1771) and the 1024-entry ICAO
cache whose hits gate AP/IID acceptance.  That walk is the CUDA kernel
csrc/resolve_words.cu (port of the Pallas kernel _resolve_kernel_factory;
a warp settles up to 32 steps a batch), in two forms: one stream
(resolve_words), and S independent streams, one block each
(resolve_words_streams); resolve_words_plain and
resolve_words_streams_plain are their plain versions.  Stats and the
emission are derived from the decision words afterwards, vectorized.

Integer semantics: the JAX package relies on int32 wraparound (hash
multiplies) and logical right shifts; torch's >> on int32 is arithmetic, so
those steps are done in int64 with explicit 32-bit masks.

No host sync happens between upload and the fetch of a group's results: no
op here has a data-dependent output shape, and the kernels read the
per-buffer counts on the device.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..constants import (
    DF11_IID_MAX_SYNDROME,
    ICAO_CACHE_LEN,
    ICAO_CACHE_TTL,
    LONG_MSG_BITS,
    MAX_BUFFER_CANDIDATES,
    PREAMBLE_US,
    SHORT_MSG_BITS,
)
from . import _cuda
from . import crc as crc_ops
from .demod import (
    candidate_passes_window,
    first_k_positions,
    front_candidates,
    gather_candidate_windows,
)
from .magnitude import magnitude_from_iq, magnitude_from_pairs

# ---- packed input word layout (per candidate) --------------------------------
# pf:  pos (bits 0..16) | valid<<17 | newbuf<<18 | gate1<<19
# w1/w2 (per pass): addr (bits 0..23) | attempt<<24 | crcok_seen<<25 |
#                   crcok_noseen<<26 | addable<<27 | long<<28
PF_POS_MASK = (1 << 17) - 1
PF_VALID = 1 << 17
PF_NEWBUF = 1 << 18
PF_GATE1 = 1 << 19
W_ADDR_MASK = (1 << 24) - 1
W_ATTEMPT = 1 << 24
W_CRCOK_SEEN = 1 << 25
W_CRCOK_NOSEEN = 1 << 26
W_ADDABLE = 1 << 27
W_LONG = 1 << 28

# ---- packed output word layout (per candidate) -------------------------------
R_RUN = 1
R_ATT1 = 2
R_CRCOK1 = 4
R_GOOD1 = 8
R_RUN2 = 16
R_ATT2 = 32
R_CRCOK2 = 64
R_GOOD2 = 128

# meta word layout of unpacked emissions (models/decoder.py message_from_device):
# pos<<12 | (errorbit+1)<<4 | pass<<3 | long<<2 | phase<<1 | crcok
META_CRCOK = 1
META_PHASE = 2
META_LONG = 4
META_PASS = 8
META_ERRBIT_SHIFT = 4
META_ERRBIT_MASK = 0xFF
META_POS_SHIFT = 12

# short / long frame skip distances: j + (8 us + msgbits) * 2 + 1
# (dump1090.c:1769-1771)
SKIP_SHORT = (PREAMBLE_US + SHORT_MSG_BITS) * 2 + 1  # 129
SKIP_EXTRA_LONG = (LONG_MSG_BITS - SHORT_MSG_BITS) * 2  # +112 for long frames

RESOLVE_CHUNK = 2048  # the JAX package's kernel chunk; mc rounds to it above

# packed short rows carry their batch emission rank in TWO uint8s, so one
# batch's emission count must fit 16 bits or the host re-interleave would
# read aliased ranks
PACKED_RANK_LIMIT = 1 << 16

# The port's own bound on candidate slots per dispatch group (buffers x
# max_candidates).  The pass and precompute intermediates of one group cost
# a few KB per slot on the device, so 2^21 slots keep a group within ~16 GB;
# sticky growth is clamped here and a buffer that cannot fit raises
# (DESIGN.md, "Bounded allocations": never silent, never stuck).
MAX_GROUP_SLOTS = 1 << 21


def clamp_packed_out(mos: int, mol: int, short_need: int = 0,
                     long_need: int = 0) -> tuple[int, int]:
    """Shrink packed emission allocations until mos + mol fits the 16-bit
    rank field, never below the exact per-kind needs (the overflow-retry
    counts).  Raises if the needs themselves exceed the wire format — one
    batch emitting >65536 messages needs fewer buffers per batch, not a
    wider allocation."""
    if short_need + long_need > PACKED_RANK_LIMIT:
        raise ValueError(
            f"one batch emitted {short_need} short + {long_need} long "
            f"messages; the packed wire format's 16-bit emission rank caps "
            f"a batch at {PACKED_RANK_LIMIT} — reduce batch_buffers per "
            f"dispatch"
        )
    # never shave an allocation to zero: the pipeline's sticky growth
    # multiplies by 4, and 0*4 == 0 would loop forever
    short_floor = max(short_need, 64)
    long_floor = max(long_need, 64)
    if short_floor + long_floor > PACKED_RANK_LIMIT:
        raise ValueError(
            f"packed emission needs {short_need}+{long_need} cannot fit the "
            f"{PACKED_RANK_LIMIT}-message rank field with nonzero "
            f"allocations for both kinds — reduce batch_buffers per dispatch"
        )
    over = mos + mol - PACKED_RANK_LIMIT
    if over > 0:
        d = min(over, mol - long_floor)
        mol -= d
        over -= d
    if over > 0:
        mos -= min(over, mos - short_floor)
    return mos, mol


def use_device_resolve(device: str | torch.device | None = None) -> bool:
    """The `auto` resolve policy (the CLI's --tpu-device-resolve auto and
    the API's device_resolve=None): the sequential resolver runs on the
    device for CUDA (the K2 and K3 kernels; `device` None means CUDA) and on
    the host for the CPU (the C++ runtime or its Python twin), as the JAX
    package keeps its device resolver for its accelerator.  Output is the
    same either way."""
    return torch.device("cuda" if device is None else device).type == "cuda"


def normalize_max_candidates(mc: int) -> int:
    """Round mc up to a multiple of RESOLVE_CHUNK above RESOLVE_CHUNK — the
    JAX package's kernel geometry, kept so both packages grow through the
    same candidate widths."""
    if mc > RESOLVE_CHUNK and mc % RESOLVE_CHUNK:
        mc += RESOLVE_CHUNK - (mc % RESOLVE_CHUNK)
    return mc


def max_candidates_cap(n_buffers: int) -> int:
    """Largest normalized max_candidates a group of n_buffers may grow to
    under MAX_GROUP_SLOTS, and never more than a buffer can hold
    (MAX_BUFFER_CANDIDATES)."""
    cap = min(MAX_GROUP_SLOTS // max(n_buffers, 1), MAX_BUFFER_CANDIDATES)
    if cap > RESOLVE_CHUNK:
        cap -= cap % RESOLVE_CHUNK
    return cap


def streams_dispatch_shape(s_n: int, nb: int, mc: int) -> tuple[int, int]:
    """Largest (streams, buffers-per-stream) tile of one demod_resolve_streams
    dispatch under MAX_GROUP_SLOTS candidate slots.  Callers with more
    streams x buffers than fit one dispatch split their work into such
    tiles; the result is the same, since skip state resets at every buffer
    and each stream's cache row chains from tile to tile."""
    mc = normalize_max_candidates(mc)
    per_stream = nb * mc
    if per_stream <= MAX_GROUP_SLOTS:
        return min(s_n, MAX_GROUP_SLOTS // per_stream), nb
    nb_fit = MAX_GROUP_SLOTS // mc
    if nb_fit < 1:
        raise OverflowError(
            f"max_candidates {mc} alone exceeds the {MAX_GROUP_SLOTS}-slot "
            f"dispatch bound — candidate density beyond the resolvable "
            f"geometry"
        )
    return 1, nb_fit


# ---- device-resident constant tables (built once per process and device) ----


@functools.cache
def _bit_matrices(device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """(88, 24) long-frame and (32, 24) short-frame GF(2) CRC contractions,
    float32 on `device`."""
    m = crc_ops.checksum_bit_matrix()
    return (
        torch.as_tensor(m[: LONG_MSG_BITS - 24], dtype=torch.float32, device=device),
        torch.as_tensor(m[SHORT_MSG_BITS : LONG_MSG_BITS - 24], dtype=torch.float32, device=device),
    )


@functools.cache
def _dense_fix_table_np() -> np.ndarray:
    """Direct-mapped 2^24-entry syndrome -> error-table-entry lookup.

    Duplicate syndromes resolve to the exact entry glibc's bsearch lands on
    (dump1090.c:862-865).  Packing: nbits << 14 | pos0 << 7 | (pos1 & 0x7F);
    0 = no entry.  pos0 is in [5, 112) and pos1 in [6, 112) or -1 (-1 packs
    to 0x7F, disambiguated by nbits)."""
    syn, nbits, pos0, pos1 = crc_ops.bit_error_table()
    t = np.zeros(1 << 24, dtype=np.uint16)
    for s in np.unique(syn):
        idx = crc_ops._glibc_bsearch(syn, int(s))
        t[s] = (int(nbits[idx]) << 14) | (int(pos0[idx]) << 7) | (int(pos1[idx]) & 0x7F)
    return t


@functools.cache
def _dense_fix_table(device: torch.device) -> torch.Tensor:
    """The dense fix table as int32 on `device` (67 MB): uint16 cannot be
    indexed in arithmetic there."""
    return torch.as_tensor(_dense_fix_table_np().astype(np.int32), device=device)


@functools.cache
def _iota(n: int, device: torch.device) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int32, device=device)


# ---- order-independent precompute ---------------------------------------------


def _unpack_bits(x: torch.Tensor, nbytes: int) -> torch.Tensor:
    """(N, >=nbytes) int32 bytes -> (N, nbytes*8) {0,1} float32, MSB first."""
    shifts = 7 - _iota(8, x.device)
    b = (x[:, :nbytes, None] >> shifts) & 1
    return b.reshape(x.shape[0], nbytes * 8).to(torch.float32)


def device_syndromes(msgs: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """24-bit syndromes of (N, 14) uint8 frames for both frame lengths.

    Returns (syn_long, syn_short) int32[N].  The GF(2) product runs as a
    float32 matmul: 0/1 operands and sums <= 88 are exact."""
    m_long, m_short = _bit_matrices(msgs.device)
    x = msgs.to(torch.int32)
    bits = _unpack_bits(x, 11)  # 88 data bits of a long frame
    w = 1 << (23 - _iota(24, msgs.device))

    def gf2(b: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
        par = torch.matmul(b, m).to(torch.int32) & 1
        return (par * w).sum(dim=1, dtype=torch.int32)

    def rem(b0: int, b1: int, b2: int) -> torch.Tensor:
        return (x[:, b0] << 16) | (x[:, b1] << 8) | x[:, b2]

    return gf2(bits, m_long) ^ rem(11, 12, 13), gf2(bits[:, :32], m_short) ^ rem(4, 5, 6)


def fix_candidates(msgs, syn, msgbits, want_fix, maxfix):
    """Vectorized fixBitErrors (dump1090.c:854-894) over (N, 14) frames.

    Returns (msg_fixed uint8, errorbit int32 (-1 when no fix), nbits applied
    int32 0/1/2)."""
    v = _dense_fix_table(msgs.device)[(syn & 0xFFFFFF).to(torch.int64)]
    k = v >> 14
    hit = k > 0
    offset = LONG_MSG_BITS - msgbits
    rel0 = ((v >> 7) & 0x7F) - offset
    rel1 = (v & 0x7F) - offset
    ok0 = (rel0 >= 0) & (rel0 < msgbits)
    ok1 = (k < 2) | ((rel1 >= 0) & (rel1 < msgbits))
    apply = want_fix & hit & (k <= maxfix) & ok0 & ok1

    byte_idx = _iota(14, msgs.device)

    def flip(rel: torch.Tensor, enable: torch.Tensor) -> torch.Tensor:
        onehot = ((rel[:, None] >> 3) == byte_idx) & enable[:, None]
        bit = 1 << (7 - (rel & 7))
        return torch.where(onehot, bit[:, None], 0)

    flips = flip(rel0, apply) ^ flip(rel1, apply & (k == 2))
    msg_fixed = (msgs.to(torch.int32) ^ flips).to(torch.uint8)
    errorbit = torch.where(apply, rel0, -1)
    return msg_fixed, errorbit, torch.where(apply, k, 0)


def icao_hash(a: torch.Tensor) -> torch.Tensor:
    """ICAOCacheHashAddress (dump1090.c:898-905): uint32 arithmetic done in
    int64 with 32-bit masks after each multiply.  Returns int32 slots."""
    h = a.to(torch.int64) & 0xFFFFFFFF
    h = (h >> 16) ^ h
    h = (h * 0x45D9F3B) & 0xFFFFFFFF
    h = (h >> 16) ^ h
    h = (h * 0x45D9F3B) & 0xFFFFFFFF
    h = (h >> 16) ^ h
    return (h & (ICAO_CACHE_LEN - 1)).to(torch.int32)


def _hash_words(w1: torch.Tensor, w2: torch.Tensor) -> torch.Tensor:
    """Both passes' ICAO-cache hash slots packed per candidate (pass1 bits
    0..9, pass2 bits 10..19), computed before the sequential walk."""
    return icao_hash(w1 & W_ADDR_MASK) | (icao_hash(w2 & W_ADDR_MASK) << 10)


def _pass_precompute(msgs, errors, gate, aggressive: bool, fix_errors: bool):
    """Order-independent decode work for one demod pass of all candidates.

    Returns (packed word int32, msg_fixed uint8, aux dict of flags for
    stats).  The word carries the FINAL per-candidate CRC verdict
    conditioned on the only sequential unknown (ICAO-cache hit or miss)
    (dump1090.c:1119-1209)."""
    x = msgs.to(torch.int32)
    msgtype = x[:, 0] >> 3
    is_long = (msgtype >= 16) & (msgtype <= 21)  # LONG_MSG_DFS
    msgbits = torch.where(is_long, LONG_MSG_BITS, SHORT_MSG_BITS).to(torch.int32)
    syn_long, syn_short = device_syndromes(msgs)
    syn = torch.where(is_long, syn_long, syn_short)
    crcok_clean = syn == 0

    is_std = (msgtype == 11) | (msgtype == 17) | (msgtype == 18)
    is_ap = (
        (msgtype == 0) | (msgtype == 4) | (msgtype == 5) | (msgtype == 16)
        | (msgtype == 20) | (msgtype == 21) | (msgtype == 24)
    )
    is11 = msgtype == 11

    maxfix = 2 if aggressive else 1
    want_fix = ~crcok_clean & is_std if fix_errors else torch.zeros_like(is_std)
    msg_fixed, errorbit, nfix = fix_candidates(msgs, syn, msgbits, want_fix, maxfix)
    crcok_fix = crcok_clean | (nfix > 0)

    xf = msg_fixed.to(torch.int32)
    addr_self = (xf[:, 1] << 16) | (xf[:, 2] << 8) | xf[:, 3]
    # brute-force AP address == the syndrome (AP = CRC xor addr); computed on
    # the unfixed bytes, but AP frame types are never fixed, so syn is it
    addr = torch.where(is_std, addr_self, syn)

    def b(flag: torch.Tensor, bit: int) -> torch.Tensor:
        return flag.to(torch.int32) * bit

    # errors is 0 or 1, so (errors == 0) | (aggressive & (errors < 3)) is:
    attempt = gate & ((errors < 3) if aggressive else (errors == 0))
    clean = errorbit == -1
    iid_ok = ~crcok_fix & is11 & (syn < DF11_IID_MAX_SYNDROME)
    # reference acceptance (decodeModesMessage): std frames pass on clean or
    # fixed CRC, or on a DF11-IID cache hit; AP frames pass only on a cache
    # hit of the brute-forced address
    crcok_seen = torch.where(is_std, crcok_fix | iid_ok, is_ap)
    crcok_noseen = is_std & crcok_fix
    word = (
        addr
        | b(attempt, W_ATTEMPT)
        | b(crcok_seen, W_CRCOK_SEEN)
        | b(crcok_noseen, W_CRCOK_NOSEEN)
        | b(is_std & crcok_fix & clean, W_ADDABLE)
        | b(is_long, W_LONG)
    )
    aux = dict(
        errors0=errors == 0,
        fixed_one=nfix == 1,
        fixed_two=nfix == 2,
        clean=clean,
        long=is_long,
        errorbit=errorbit,
    )
    return word, msg_fixed, aux


# ---- the sequential walk --------------------------------------------------------


def _check_resolve_inputs(pf, w1, w2, h12, nbuf, cache_addr, cache_ts, mc, n_streams=None):
    """The walk's input contract: contiguous int32 tensors on one device,
    1-D slot streams of n_buffers x mc, and a 1-D cache of ICAO_CACHE_LEN
    slots — or, for n_streams, (S, ICAO_CACHE_LEN) cache rows and a buffer
    count that S divides."""
    name = "resolve_words" if n_streams is None else "resolve_words_streams"
    for t in (pf, w1, w2, h12, nbuf, cache_addr, cache_ts):
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise TypeError(f"{name} takes contiguous int32 tensors")
        if t.device != pf.device:
            raise ValueError(f"{name} inputs must share one device")
    if any(t.dim() != 1 for t in (pf, w1, w2, h12, nbuf)):
        raise ValueError(f"{name} takes 1-D slot streams and buffer counts")
    n = pf.shape[0]
    if any(t.shape[0] != n for t in (w1, w2, h12)) or n != nbuf.shape[0] * mc:
        raise ValueError(
            f"stream lengths {[t.shape[0] for t in (pf, w1, w2, h12)]} must "
            f"all equal n_buffers x mc = {nbuf.shape[0]} x {mc}"
        )
    want = (ICAO_CACHE_LEN,) if n_streams is None else (n_streams, ICAO_CACHE_LEN)
    if tuple(cache_addr.shape) != want or tuple(cache_ts.shape) != want:
        raise ValueError(f"{name} takes ICAO caches of shape {want}")
    if n_streams is not None and (n_streams < 1 or nbuf.shape[0] % n_streams):
        raise ValueError(
            f"{nbuf.shape[0]} buffers do not split into {n_streams} streams"
        )


def resolve_words_plain(pf, w1, w2, h12, nbuf, cache_addr, cache_ts, now: int, mc: int):
    """Plain version of the sequential walk, on Python ints.

    pf/w1/w2/h12: int32[NBUF * mc] (whole buffers, fixed-width rows); nbuf:
    int32[NBUF] valid-candidate counts (the first nbuf[b] slots of buffer b
    are walked).  Returns (words, cache_addr', cache_ts') on pf's device,
    with words 0 on every slot not walked.  _step_semantics of the JAX
    package, step by step."""
    _check_resolve_inputs(pf, w1, w2, h12, nbuf, cache_addr, cache_ts, mc)
    pf_l, w1_l, w2_l, h_l, nb_l, ca, ct = (
        t.tolist() for t in (pf, w1, w2, h12, nbuf, cache_addr, cache_ts)
    )
    words = [0] * len(pf_l)

    def seen(h: int, addr: int) -> bool:
        age = ((now - ct[h] + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)  # int32 wrap
        return ca[h] == addr and ca[h] != 0 and age <= ICAO_CACHE_TTL

    skip = 0
    for b, cnt in enumerate(nb_l):
        base = b * mc
        for i in range(base, base + min(max(cnt, 0), mc)):
            p, v1, v2, hh = pf_l[i], w1_l[i], w2_l[i], h_l[i]
            pos = p & PF_POS_MASK
            if p & PF_NEWBUF:
                skip = 0
            run = bool(p & PF_VALID) and pos >= skip

            h1, a1 = hh & 0x3FF, v1 & W_ADDR_MASK
            att1 = run and bool(v1 & W_ATTEMPT)
            crcok1 = bool(v1 & (W_CRCOK_SEEN if seen(h1, a1) else W_CRCOK_NOSEEN))
            good1 = att1 and crcok1
            add1 = att1 and bool(v1 & W_ADDABLE)
            if good1:
                skip = pos + SKIP_SHORT + (SKIP_EXTRA_LONG if v1 & W_LONG else 0)

            run2 = run and bool(p & PF_GATE1) and not good1
            h2, a2 = (hh >> 10) & 0x3FF, v2 & W_ADDR_MASK
            att2 = run2 and bool(v2 & W_ATTEMPT)
            crcok2 = bool(v2 & (W_CRCOK_SEEN if seen(h2, a2) else W_CRCOK_NOSEEN))
            good2 = att2 and crcok2
            add2 = att2 and bool(v2 & W_ADDABLE)
            if good2:
                skip = pos + SKIP_SHORT + (SKIP_EXTRA_LONG if v2 & W_LONG else 0)

            # at most one cache write per candidate, after both lookups
            if add1:
                ca[h1], ct[h1] = a1, now
            elif add2:
                ca[h2], ct[h2] = a2, now
            words[i] = (
                run * R_RUN | att1 * R_ATT1 | crcok1 * R_CRCOK1 | good1 * R_GOOD1
                | run2 * R_RUN2 | att2 * R_ATT2 | crcok2 * R_CRCOK2
                | good2 * R_GOOD2
            )

    def out(vals):
        return torch.tensor(vals, dtype=torch.int32, device=pf.device)

    return out(words), out(ca), out(ct)


def _walk_counts_tensor(walk_counts: bool, blocks: int, device):
    """The kernel's per-block (batches, cuts) counts when the caller asks for
    them, else None (the kernel then counts nothing)."""
    if not walk_counts:
        return None
    if device.type != "cuda":
        raise ValueError("walk_counts come from the CUDA kernel; the plain version has none")
    return torch.zeros((blocks, 2), dtype=torch.int32, device=device)


def _now_tensor(now, device: torch.device) -> torch.Tensor:
    """`now` as the one-element int32 tensor on `device` that K2 reads: the
    tensor itself, or an int written to a new one (by a fill on the
    device, never a copy from the host)."""
    if isinstance(now, torch.Tensor):
        if now.dtype != torch.int32 or now.numel() != 1 or now.device != device:
            raise TypeError(f"now must be an int or a one-element int32 tensor on {device}, "
                            f"got {now.dtype} {tuple(now.shape)} on {now.device}")
        return now
    return torch.full((1,), int(now), dtype=torch.int32, device=device)


def resolve_words(pf, w1, w2, h12, nbuf, cache_addr, cache_ts, now, mc: int, *,
                  walk_counts: bool = False):
    """The sequential walk: the CUDA kernel on CUDA tensors, the plain
    version on CPU tensors.  Same contract as resolve_words_plain; the input
    cache tensors are never written.  `now` is an int, or a one-element
    int32 tensor on pf's device, which the kernel reads when it runs (a
    CUDA graph's input; the plain version takes its value).  With
    walk_counts (CUDA only) it also returns the kernel's int32 (1, 2) count
    of its batches and its cuts."""
    _check_resolve_inputs(pf, w1, w2, h12, nbuf, cache_addr, cache_ts, mc)
    counts = _walk_counts_tensor(walk_counts, 1, pf.device)
    if pf.device.type == "cpu":
        if isinstance(now, torch.Tensor):
            now = _now_tensor(now, pf.device).item()
        return resolve_words_plain(pf, w1, w2, h12, nbuf, cache_addr, cache_ts, int(now), mc)
    if pf.device.type != "cuda":
        raise ValueError(f"resolve_words runs on cuda or cpu, not {pf.device}")
    now_t = _now_tensor(now, pf.device)
    words = torch.empty_like(pf)
    ca = torch.empty_like(cache_addr)
    ct = torch.empty_like(cache_ts)
    lib = _cuda.library()
    with torch.cuda.device(pf.device):  # the launch goes to the current device
        err = lib.resolve_words(
            pf.data_ptr(), w1.data_ptr(), w2.data_ptr(), h12.data_ptr(),
            nbuf.data_ptr(), cache_addr.data_ptr(), cache_ts.data_ptr(),
            words.data_ptr(), ca.data_ptr(), ct.data_ptr(),
            None if counts is None else counts.data_ptr(),
            nbuf.shape[0], mc, now_t.data_ptr(), _cuda.current_stream(pf.device),
        )
    _cuda.count("resolve_words")
    _cuda.check(err, "resolve_words")
    return (words, ca, ct) if counts is None else (words, ca, ct, counts)


def resolve_words_streams_plain(pf, w1, w2, h12, nbuf, cache_addr, cache_ts,
                                now: int, mc: int, n_streams: int):
    """Plain version of the multi-stream walk: S independent streams laid
    end to end, stream s owning buffers [s*NB, (s+1)*NB) of the flat layout
    and cache row s.  Each stream is resolve_words_plain on its own slice,
    starting at skip 0.  Returns (words, cache_addr' (S, L), cache_ts' (S, L))."""
    _check_resolve_inputs(pf, w1, w2, h12, nbuf, cache_addr, cache_ts, mc, n_streams)
    nb = nbuf.shape[0] // n_streams
    per = nb * mc
    outs = [
        resolve_words_plain(
            pf[s * per:(s + 1) * per], w1[s * per:(s + 1) * per],
            w2[s * per:(s + 1) * per], h12[s * per:(s + 1) * per],
            nbuf[s * nb:(s + 1) * nb], cache_addr[s], cache_ts[s], now, mc,
        )
        for s in range(n_streams)
    ]
    words, ca, ct = zip(*outs)
    return torch.cat(words), torch.stack(ca), torch.stack(ct)


def resolve_words_streams(pf, w1, w2, h12, nbuf, cache_addr, cache_ts,
                          now: int, mc: int, n_streams: int, *, walk_counts: bool = False):
    """The multi-stream walk: the CUDA kernel (one block per stream, the
    streams in parallel) on CUDA tensors, the plain version on CPU tensors.
    Same contract as resolve_words_streams_plain; the input cache tensors
    are never written.  With walk_counts (CUDA only) it also returns the
    kernel's int32 (S, 2) count of each stream's batches and cuts."""
    _check_resolve_inputs(pf, w1, w2, h12, nbuf, cache_addr, cache_ts, mc, n_streams)
    counts = _walk_counts_tensor(walk_counts, n_streams, pf.device)
    if pf.device.type == "cpu":
        return resolve_words_streams_plain(
            pf, w1, w2, h12, nbuf, cache_addr, cache_ts, now, mc, n_streams
        )
    if pf.device.type != "cuda":
        raise ValueError(f"resolve_words_streams runs on cuda or cpu, not {pf.device}")
    words = torch.empty_like(pf)
    ca = torch.empty_like(cache_addr)
    ct = torch.empty_like(cache_ts)
    lib = _cuda.library()
    with torch.cuda.device(pf.device):
        err = lib.resolve_words_streams(
            pf.data_ptr(), w1.data_ptr(), w2.data_ptr(), h12.data_ptr(),
            nbuf.data_ptr(), cache_addr.data_ptr(), cache_ts.data_ptr(),
            words.data_ptr(), ca.data_ptr(), ct.data_ptr(),
            None if counts is None else counts.data_ptr(),
            n_streams, nbuf.shape[0] // n_streams, mc, int(now),
            _cuda.current_stream(pf.device),
        )
    _cuda.count("resolve_words_streams")
    _cuda.check(err, "resolve_words_streams")
    return (words, ca, ct) if counts is None else (words, ca, ct, counts)


# ---- stats and emission -------------------------------------------------------------


def _first_k(mask: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Indices of the first k set slots of each row of a bool (G, L) mask in
    scan order, padded with L-1 (the row the JAX package's clamped top_k
    selects there), plus their validity."""
    length = mask.shape[1]
    sel = first_k_positions(mask, k, length - 1)
    ok = _iota(k, mask.device) < mask.sum(dim=1, dtype=torch.int32)[:, None]
    return sel, ok


def _pairs(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Interleave per-slot pass-1 and pass-2 values into emission order:
    (G, P, ...) x2 -> (G, 2P, ...), slot i's pass 1 at 2i, pass 2 at 2i+1."""
    g_n, n_slots = a.shape[:2]
    return torch.stack([a, b], dim=2).reshape((g_n, 2 * n_slots) + tuple(a.shape[2:]))


def _batch_stats(words, pos, aux1, aux2):
    """The eight DecoderStats counter deltas of every batch, int32 (G, 8),
    from its decision words: dump1090.c:1737-1753 detect-path counters incl.
    the single-bit double count, dump1090.c:1122-1126 decode path."""

    def bit(b: int) -> torch.Tensor:
        return (words & b) != 0

    def s(a: torch.Tensor) -> torch.Tensor:
        return a.sum(dim=1, dtype=torch.int32)

    att1, crcok1 = bit(R_ATT1), bit(R_CRCOK1)
    run2, att2, crcok2 = bit(R_RUN2), bit(R_ATT2), bit(R_CRCOK2)
    d1 = att1 & crcok1  # pass-1 detect stats are gated on final crcok
    fixflag1 = d1 & ~aux1["clean"]
    fixflag2 = att2 & ~aux2["clean"]
    return torch.stack([
        s(bit(R_RUN)),                                     # valid_preamble
        s(run2 & (pos > 0)),                               # out_of_phase
        s(d1 & aux1["errors0"]) + s(att2 & aux2["errors0"]),   # demodulated
        s(d1 & aux1["clean"]) + s(att2 & crcok2 & aux2["clean"]),  # goodcrc
        s(att2 & ~crcok2 & aux2["clean"]) + s(fixflag1) + s(fixflag2),  # badcrc
        s(fixflag1) + s(fixflag2),                         # fixed
        # detect path always bumps single_bit (errorbit < 112 quirk);
        # decode path counts the true split on every decode attempt
        s(fixflag1) + s(fixflag2)
        + s(att1 & aux1["fixed_one"]) + s(att2 & aux2["fixed_one"]),
        s(att1 & aux1["fixed_two"]) + s(att2 & aux2["fixed_two"]),
    ], dim=1)


def _gather_rows(rows: torch.Tensor, sel: torch.Tensor) -> torch.Tensor:
    """rows (G, L, W) at the indices sel (G, K) -> (G, K, W)."""
    return torch.gather(rows, 1, sel[..., None].expand(sel.shape + rows.shape[2:]))


def _emit_mask(words, crcok_only: bool) -> torch.Tensor:
    """The emitted slots of every batch in emission order (G, 2P): every
    attempted decode, or with crcok_only the good-CRC ones only."""

    def bit(b: int) -> torch.Tensor:
        return (words & b) != 0

    if crcok_only:
        return _pairs(bit(R_ATT1) & bit(R_CRCOK1), bit(R_ATT2) & bit(R_CRCOK2))
    return _pairs(bit(R_ATT1), bit(R_ATT2))


def _postprocess_packed(words, msg1f, msg2f, pos, aux1, aux2, *,
                        max_out_short: int, max_out_long: int, crcok_only: bool):
    """Stats + packed emission of every batch of a group, vectorized over
    the batch axis: words/pos (G, P), msg*f (G, P, 14), aux* (G, P).
    With crcok_only (the raw/stats path) only good-CRC decodes are
    emitted, else every attempted decode.  Returns (count (G,), count_long
    (G,), shorts uint8 (G, mos, 9), longs uint8 (G, mol, 14), stats int32
    (G, 8))."""
    stats = _batch_stats(words, pos, aux1, aux2)
    emask = _emit_mask(words, crcok_only)
    count = emask.sum(dim=1, dtype=torch.int32)
    long_slot = _pairs(aux1["long"], aux2["long"])
    msgs12 = _pairs(msg1f, msg2f)

    count_long = (emask & long_slot).sum(dim=1, dtype=torch.int32)
    ei = emask.to(torch.int32)
    rank = torch.cumsum(ei, dim=1, dtype=torch.int32).sub_(ei)
    sel_s, ok_s = _first_k(emask & ~long_slot, max_out_short)
    sel_l, _ = _first_k(emask & long_slot, max_out_long)
    rank_s = torch.where(ok_s, torch.gather(rank, 1, sel_s), 0)
    shorts = torch.cat(
        [
            _gather_rows(msgs12[..., :7], sel_s),
            (rank_s & 0xFF).to(torch.uint8)[..., None],
            ((rank_s >> 8) & 0xFF).to(torch.uint8)[..., None],
        ],
        dim=2,
    )
    return count, count_long, shorts, _gather_rows(msgs12, sel_l), stats


def _postprocess_unpacked(words, msg1f, msg2f, pos, aux1, aux2, *, max_out: int,
                          crcok_only: bool):
    """Stats + unpacked emission of every batch, vectorized over the batch
    axis (the shapes of _postprocess_packed): every attempted decode, good
    and bad CRC (only the good ones with crcok_only), in scan order, as 14
    frame bytes and a meta word pos<<12 | (errorbit+1)<<4 | pass<<3 |
    long<<2 | phase<<1 | crcok, -1 beyond the count.  Returns (count (G,),
    msg uint8 (G, max_out, 14), meta int32 (G, max_out), stats int32 (G, 8))."""
    stats = _batch_stats(words, pos, aux1, aux2)

    def bit(b: int) -> torch.Tensor:
        return (words & b) != 0

    att1, crcok1, crcok2 = bit(R_ATT1), bit(R_CRCOK1), bit(R_CRCOK2)
    emask = _emit_mask(words, crcok_only)
    count = emask.sum(dim=1, dtype=torch.int32)
    sel, ok = _first_k(emask, max_out)
    msg_out = _gather_rows(_pairs(msg1f, msg2f), sel)

    def i32(a: torch.Tensor) -> torch.Tensor:
        return a.to(torch.int32)

    meta_slot = (
        i32(_pairs(crcok1, crcok2)) * META_CRCOK
        + i32(_pairs(torch.zeros_like(att1), bit(R_GOOD2))) * META_PHASE
        + i32(_pairs(aux1["long"], aux2["long"])) * META_LONG
        + ((_pairs(aux1["errorbit"], aux2["errorbit"]) + 1) << META_ERRBIT_SHIFT)
        + (_pairs(pos, pos) << META_POS_SHIFT)
    )
    pass2 = i32((sel & 1) == 1) * META_PASS
    meta_out = torch.where(ok, torch.gather(meta_slot, 1, sel) + pass2, -1)
    return count, msg_out, meta_out, stats


# ---- the group: front, back, and the two together ----------------------------------


def _mark(marks: list | None, name: str) -> None:
    """Record a CUDA event after stage `name` when the caller collects a
    per-stage split (marks is a list; None costs nothing)."""
    if marks is not None:
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((name, ev))


def _group_front(xg: torch.Tensor, *, scan_len: int, max_candidates: int,
                 front: str | None = None):
    """Magnitudes + preamble predicate + position compaction for every
    buffer of the group: xg uint8 (G, NB, nbytes), or the same wire bytes
    as uint16 I|Q<<8 pairs (G, NB, nbytes/2) -> (m int32 (G*NB, S), n int32
    (G*NB,), pos int32 (G*NB, MC)).  `front` picks the preamble-scan
    formulation (ops.demod.front_candidates; every choice bit-identical)."""
    g_n, nb, width = xg.shape
    rows = xg.reshape(g_n * nb, width)
    m = magnitude_from_pairs(rows) if xg.dtype == torch.uint16 else magnitude_from_iq(rows)
    n, pos = front_candidates(m, scan_len, max_candidates, front)
    return m, n, pos


def _group_precompute(m, n, pos, fix_errors: bool, aggressive: bool, *,
                      max_candidates: int, marks=None):
    """Candidate-window gather + both demod passes + the order-independent
    precompute, over all G*NB buffers of the group at once.  Returns the
    sequential walk's inputs (pf, w1, w2, h12, nbuf) and what the emission
    needs (msg1f, msg2f, aux1, aux2, flat positions)."""
    n_bufs = n.shape[0]
    mc = max_candidates
    dev = m.device

    w = gather_candidate_windows(m, pos)  # K1, from the magnitudes
    _mark(marks, "gather")
    pos_f = pos.reshape(-1)
    msg1, errors1, gate1, msg2, errors2, gate2 = candidate_passes_window(
        w.reshape(n_bufs * mc, -1), pos_f
    )
    del w
    _mark(marks, "passes")

    w1, msg1f, aux1 = _pass_precompute(msg1, errors1, gate1, aggressive, fix_errors)
    w2, msg2f, aux2 = _pass_precompute(msg2, errors2, gate2, aggressive, fix_errors)
    nbuf = torch.clamp_max(n, mc)
    slot = _iota(mc, dev)
    valid = (slot < nbuf[:, None]).reshape(-1)
    newbuf = (slot == 0).expand(n_bufs, mc).reshape(-1)
    pf = (
        torch.clamp_max(pos_f, PF_POS_MASK)
        | valid.to(torch.int32) * PF_VALID
        | newbuf.to(torch.int32) * PF_NEWBUF
        | gate1.to(torch.int32) * PF_GATE1
    )
    h12 = _hash_words(w1, w2)
    _mark(marks, "precompute")
    return (pf, w1, w2, h12, nbuf), (msg1f, msg2f, aux1, aux2, pos_f)


def _emit(post, rows: int, words, msg1f, msg2f, pos_f, aux1, aux2):
    """Run an emission (_postprocess_packed or _postprocess_unpacked, with
    its shape arguments bound) over the flat slot arrays cut into `rows`
    batches or streams."""

    def by_row(a: torch.Tensor) -> torch.Tensor:
        return a.reshape((rows, -1) + tuple(a.shape[1:]))

    return post(
        by_row(words), by_row(msg1f), by_row(msg2f), by_row(pos_f),
        {k: by_row(v) for k, v in aux1.items()},
        {k: by_row(v) for k, v in aux2.items()},
    )


def _group_back(m, n, pos, cache_addr, cache_ts, now, fix_errors: bool,
                aggressive: bool, *, g_n: int, max_candidates: int, post,
                marks=None):
    """_group_precompute + the single sequential walk over the group's
    candidate stream + stats and emission (`post`) of every batch."""
    walk_in, (msg1f, msg2f, aux1, aux2, pos_f) = _group_precompute(
        m, n, pos, fix_errors, aggressive, max_candidates=max_candidates,
        marks=marks,
    )
    words, ca, ct = resolve_words(
        *walk_in, cache_addr, cache_ts, now, max_candidates
    )
    _mark(marks, "resolve")
    outs = _emit(post, g_n, words, msg1f, msg2f, pos_f, aux1, aux2)
    _mark(marks, "emission")
    return (n.reshape(g_n, -1),) + outs + (ca, ct)


def _check_entry(x: torch.Tensor, scan_len: int, shape: str) -> None:
    if scan_len > PF_POS_MASK:
        raise ValueError(
            f"scan_len {scan_len} exceeds the {PF_POS_MASK} packed-position "
            f"limit of the resolver word layout"
        )
    if x.dtype not in (torch.uint8, torch.uint16) or x.dim() != 3:
        raise TypeError(f"the IQ input must be uint8 {shape} or its uint16 pairs, "
                        f"got {x.dtype} {tuple(x.shape)}")


def demod_resolve_group(
    xg: torch.Tensor,
    cache_addr: torch.Tensor,
    cache_ts: torch.Tensor,
    now: int | torch.Tensor,
    fix_errors: bool,
    aggressive: bool,
    *,
    scan_len: int,
    max_candidates: int,
    max_out: int = 0,
    max_out_short: int = 0,
    max_out_long: int = 0,
    packed: bool = True,
    crcok_only: bool = True,
    front: str | None = None,
    marks: list | None = None,
):
    """Device pipeline over a dispatch GROUP: xg is (G, NB, nbytes) uint8 IQ
    on the device, or the same wire bytes as (G, NB, nbytes/2) uint16 I|Q<<8
    pairs (numpy `.view("<u2")`, zero-copy on the host); every buffer is demodulated, the whole candidate stream
    is resolved in ONE kernel walk (the ICAO cache and the per-buffer skip
    state chain through it in stream order), and each batch's messages are
    emitted.  Everything is enqueued without a host sync.

    Returns, with packed=True (the raw/stats wire format; max_out is not
    read):
      n          int32[G, NB]      exact preamble count per buffer
      count      int32[G]          exact emitted-message count per batch
      count_long int32[G]          how many of those are 112-bit frames
      shorts     uint8[G, mos, 9]  7 frame bytes + emission rank (lo, hi)
      longs      uint8[G, mol, 14] 14 frame bytes, in emission order
      stats      int32[G, 8]       reference counter deltas (DecoderStats order)
      cache_addr', cache_ts'       int32[1024]
    With packed=False (the full-fidelity format of run_device):
      n, count, msg uint8[G, max_out, 14], meta int32[G, max_out], stats,
      cache_addr', cache_ts'
    Either format emits the good-CRC decodes only with crcok_only (the
    default), and every attempted decode, good and bad CRC, without; meta is pos<<12 | (errorbit+1)<<4 | pass<<3 | long<<2 | phase<<1
    | crcok, -1 beyond the count (models/decoder.py message_from_device
    consumes it).  Overflow is detected from the exact counts (n >
    max_candidates, count-count_long > mos or count_long > mol, count >
    max_out), never silently truncated.

    `now` is the clock in seconds, an int or a one-element int32 tensor on
    xg's device (resolve_words).  `front` picks the preamble-scan
    formulation (None: the DUMP1090_TPU_FRONT default,
    ops.demod.front_variant).  `marks`, when a list, collects (stage, CUDA
    event) pairs for a per-stage timing split (CUDA only)."""
    _check_entry(xg, scan_len, "(G, NB, nbytes)")
    if packed and max_out_short + max_out_long > PACKED_RANK_LIMIT:
        raise ValueError(
            f"max_out_short + max_out_long = "
            f"{max_out_short + max_out_long} exceeds the "
            f"{PACKED_RANK_LIMIT}-message packed rank field; use "
            f"clamp_packed_out on the allocations"
        )
    if packed:
        post = functools.partial(_postprocess_packed, max_out_short=max_out_short,
                                 max_out_long=max_out_long, crcok_only=crcok_only)
    else:
        post = functools.partial(_postprocess_unpacked, max_out=max_out,
                                 crcok_only=crcok_only)
    max_candidates = normalize_max_candidates(max_candidates)
    _mark(marks, "start")
    m, n, pos = _group_front(xg, scan_len=scan_len, max_candidates=max_candidates,
                             front=front)
    _mark(marks, "front")
    return _group_back(
        m, n, pos, cache_addr, cache_ts, now, bool(fix_errors), bool(aggressive),
        g_n=xg.shape[0], max_candidates=max_candidates, post=post, marks=marks,
    )


def demod_resolve_batch(
    iq_buffers: torch.Tensor,
    cache_addr: torch.Tensor,
    cache_ts: torch.Tensor,
    now: int,
    fix_errors: bool,
    aggressive: bool,
    *,
    scan_len: int,
    max_candidates: int,
    max_out: int = 0,
    max_out_short: int = 0,
    max_out_long: int = 0,
    crcok_only: bool = True,
    packed: bool = False,
):
    """Single-batch convenience wrapper over demod_resolve_group (G = 1):
    (NB, nbytes) uint8 IQ -> emitted messages.

    Unpacked returns (n[NB], count, msg[max_out,14], meta[max_out], stats[8],
    cache_addr', cache_ts'); packed returns (n, count, count_long, shorts,
    longs, stats, cache_addr', cache_ts') -- see demod_resolve_group for the
    layouts; either emits the good-CRC decodes only with crcok_only, every
    attempted decode without."""
    outs = demod_resolve_group(
        iq_buffers[None], cache_addr, cache_ts, now, fix_errors, aggressive,
        scan_len=scan_len, max_candidates=max_candidates, max_out=max_out,
        max_out_short=max_out_short, max_out_long=max_out_long, packed=packed,
        crcok_only=crcok_only,
    )
    return tuple(o[0] for o in outs[:-2]) + tuple(outs[-2:])


def resolve_candidate_segments(
    pos, msg1, errors1, gate1, msg2, errors2, gate2, nseg, row_id,
    cache_addr, cache_ts, now: int, fix_errors: bool, aggressive: bool, *,
    n_rows: int, max_out: int, crcok_only: bool = False,
):
    """Device resolve over pre-demodulated candidate SEGMENTS: the second
    stage of the time-sharded decode (parallel/sharding.py), the same
    precompute, sequential walk (K2, resolve_words) and emission as
    demod_resolve_group.

    pos..gate2: (S, mc) per-segment candidate fields on one device, with
    stream-global positions in scan order (a segment's valid candidates are
    a contiguous prefix; empty slots hold 2**30).  nseg: int32 (S,) valid
    candidates per segment.  row_id: int32 (S,) monotone row index in [0,
    n_rows): the segments of one row share a reference buffer, so the
    skip-until state resets at each row's FIRST VALID candidate (a segment
    boundary inside a row does not reset it, unlike the buffers of
    demod_resolve_group; that candidate may sit in a later segment when the
    first ones are empty) and the ICAO cache chains across all.

    Returns (count, msg uint8 (max_out, 14), meta int32 (max_out), stats
    int32 (8,), cache_addr', cache_ts') in the unpacked demod_resolve_group
    layout; the input cache tensors are never written."""
    s_n, mc = pos.shape
    dev = pos.device
    n_flat = s_n * mc

    def flat(a: torch.Tensor) -> torch.Tensor:
        return a.reshape((n_flat,) + tuple(a.shape[2:]))

    fe, ag = bool(fix_errors), bool(aggressive)
    w1, msg1f, aux1 = _pass_precompute(flat(msg1), flat(errors1), flat(gate1), ag, fe)
    w2, msg2f, aux2 = _pass_precompute(flat(msg2), flat(errors2), flat(gate2), ag, fe)

    nseg_c = torch.clamp_max(nseg.to(torch.int32), mc).contiguous()
    valid = (_iota(mc, dev) < nseg_c[:, None]).reshape(-1)
    vi = valid.to(torch.int32)
    # a row's first valid candidate: its exclusive running valid count
    # equals the row's base (the valid slots of all earlier rows)
    excl = torch.cumsum(vi, 0, dtype=torch.int32) - vi
    seg_base = torch.cumsum(nseg_c, 0, dtype=torch.int32) - nseg_c
    row_base = torch.full((n_rows,), torch.iinfo(torch.int32).max, dtype=torch.int32,
                          device=dev)
    row_base = row_base.scatter_reduce(0, row_id.to(torch.int64), seg_base, "amin")
    newbuf = valid & (excl == row_base[row_id.to(torch.int64)].repeat_interleave(mc))
    pos_f = flat(pos).to(torch.int32)
    pf = (
        torch.clamp_max(pos_f, PF_POS_MASK)
        | vi * PF_VALID
        | newbuf.to(torch.int32) * PF_NEWBUF
        | flat(gate1).to(torch.int32) * PF_GATE1
    )
    words, ca, ct = resolve_words(
        pf, w1, w2, _hash_words(w1, w2), nseg_c, cache_addr.to(torch.int32).contiguous(),
        cache_ts.to(torch.int32).contiguous(), now, mc,
    )
    post = functools.partial(_postprocess_unpacked, max_out=max_out, crcok_only=crcok_only)
    count, msg, meta, stats = _emit(post, 1, words, msg1f, msg2f, pos_f, aux1, aux2)
    return count[0], msg[0], meta[0], stats[0], ca, ct


def demod_resolve_streams(
    xs: torch.Tensor,
    cache_addr: torch.Tensor,
    cache_ts: torch.Tensor,
    now: int,
    fix_errors: bool,
    aggressive: bool,
    *,
    scan_len: int,
    max_candidates: int,
    max_out: int,
    crcok_only: bool = False,
    front: str | None = None,
    marks: list | None = None,
):
    """S INDEPENDENT capture streams share one demod + resolve dispatch
    (api.decode_captures): xs is (S, NB, nbytes) uint8, stream s's next NB
    buffers, and cache_addr/cache_ts are (S, ICAO_CACHE_LEN) per-stream
    ICAO caches.  All S*NB buffers go through one front and one precompute;
    the walk is the multi-stream kernel, each stream resolved exactly as if
    decoded alone (skip state from 0, its own cache row).  Nothing syncs the
    host.

    Returns (n (S, NB), count (S,), msg (S, max_out, 14), meta (S, max_out),
    stats (S, 8), cache_addr' (S, L), cache_ts' (S, L)) — the unpacked
    demod_resolve_group layout with a leading stream axis."""
    _check_entry(xs, scan_len, "(S, NB, nbytes)")
    s_n, nb, _ = xs.shape
    max_candidates = normalize_max_candidates(max_candidates)
    _mark(marks, "start")
    m, n, pos = _group_front(xs, scan_len=scan_len, max_candidates=max_candidates,
                             front=front)
    _mark(marks, "front")
    walk_in, (msg1f, msg2f, aux1, aux2, pos_f) = _group_precompute(
        m, n, pos, bool(fix_errors), bool(aggressive),
        max_candidates=max_candidates, marks=marks,
    )
    del m
    words, ca, ct = resolve_words_streams(
        *walk_in, cache_addr, cache_ts, now, max_candidates, s_n
    )
    _mark(marks, "resolve")
    post = functools.partial(_postprocess_unpacked, max_out=max_out, crcok_only=crcok_only)
    count, msg, meta, stats = _emit(post, s_n, words, msg1f, msg2f, pos_f, aux1, aux2)
    _mark(marks, "emission")
    return n.reshape(s_n, nb), count, msg, meta, stats, ca, ct


def interleave_packed(count, count_long, shorts, longs):
    """Host-side reconstruction of one batch's emission stream from the
    packed wire format: (msg uint8[count, 14] zero-padded short rows,
    bits int[count]) in exact scan order."""
    c = int(count)
    cl = int(count_long)
    cs = c - cl
    msg = np.zeros((c, 14), dtype=np.uint8)
    is_long = np.ones(c, dtype=bool)
    if cs:
        sh = np.asarray(shorts[:cs])
        ranks = sh[:, 7].astype(np.int64) | (sh[:, 8].astype(np.int64) << 8)
        is_long[ranks] = False
        msg[~is_long, :7] = sh[:, :7]
    if cl:
        msg[is_long] = np.asarray(longs[:cl])
    bits = np.where(is_long, 112, 56)
    return msg, bits
