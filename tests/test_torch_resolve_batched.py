"""A numpy model of the batched resolver walk of csrc/resolve_words.cu,
held against the plain walk (ops/resolve.py resolve_words_plain) and the
JAX package's XLA scan on the CPU, where the kernel cannot run.

The model follows the kernel's algorithm step for step: the TTL folded
into a `live` array, batches of up to W walked slots of one buffer that
never cross a 1024-slot chunk, the lanes' lookups against the cache as it
stands at the batch's start, the skip chain resolved from each lane's
successor, the cut at the first lane whose lookups give other crcok bits
against the cache as the running lanes before it leave it, and the
commit of the lanes before the cut in lane order.  It also counts batches and cuts the way the
kernel does, so tests/test_torch_cuda.py holds the kernel's counts to it.
Exact equality throughout.

JAX is imported inside the helpers that use it, so that the model can be
imported where JAX is absent.
"""

from __future__ import annotations

import functools
import io

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import dump1090_tpu_torch.ops.resolve as tr
from dump1090_tpu_torch.constants import (
    BUF_SAMPLES,
    FULL_LEN_SAMPLES,
    ICAO_CACHE_LEN,
    ICAO_CACHE_TTL,
)
from dump1090_tpu_torch.io.sources import iq_buffers
from dump1090_tpu_torch.models.decoder import IcaoCache
from dump1090_tpu_torch.utils.synth import forced_cut_stream, planted_capture, random_word_stream

NOW = 1_700_000_000
CHUNK = 1024  # the kernel's ring slot, in slots


def _batch(i, nb, pf, w1, w2, h12, live, written, words, skip):
    """One batch of walked slots [i, i + nb).  Returns (committed, skip)."""
    lane = np.arange(nb)
    p, v1, v2, hh = (a[i:i + nb] for a in (pf, w1, w2, h12))
    pos = p & tr.PF_POS_MASK
    valid = (p & tr.PF_VALID) != 0
    newbuf = (p & tr.PF_NEWBUF) != 0
    h1, h2 = hh & 0x3FF, (hh >> 10) & 0x3FF
    a1, a2 = v1 & tr.W_ADDR_MASK, v2 & tr.W_ADDR_MASK
    r1, r2 = live[h1], live[h2]  # the cache at the batch's start

    def crcok(v, a, r):
        return np.where((r == a) & (a != 0), v & tr.W_CRCOK_SEEN, v & tr.W_CRCOK_NOSEEN) != 0

    crcok1, crcok2 = crcok(v1, a1, r1), crcok(v2, a2, r2)
    # each lane's step as it goes if it runs
    att1 = (v1 & tr.W_ATTEMPT) != 0
    good1 = att1 & crcok1
    run2 = ((p & tr.PF_GATE1) != 0) & ~good1
    att2 = run2 & ((v2 & tr.W_ATTEMPT) != 0)
    good2 = att2 & crcok2
    good = good1 | good2
    end = pos + tr.SKIP_SHORT + np.where(np.where(good1, v1, v2) & tr.W_LONG, tr.SKIP_EXTRA_LONG, 0)
    add1 = att1 & ((v1 & tr.W_ADDABLE) != 0)
    add2 = att2 & ((v2 & tr.W_ADDABLE) != 0)

    # the skip chain.  Each lane's successor: the first later good lane
    # that runs if this lane runs and is good (at or past its end, or after
    # a PF_NEWBUF); the chain is the first good lane that runs under the
    # carried skip, then its successors, one step per good step
    goods = valid & good

    def from_first(m):
        return np.cumsum(m) > 0

    succ = np.full(nb, nb)
    for j in range(nb):
        later = lane > j
        ok = np.flatnonzero(goods & later & ((pos >= end[j]) | from_first(newbuf & later)))
        succ[j] = ok[0] if ok.size else nb
    first = np.flatnonzero(goods & ((pos >= skip) | from_first(newbuf)))
    chain = []
    f = first[0] if first.size else nb
    while f < nb:
        chain.append(int(f))
        f = succ[f]
    # each lane's skip: the last chain lane's end before it, the carried
    # skip, or 0 after a PF_NEWBUF since then
    e = np.empty(nb, np.int64)
    for k in lane:
        before = [c for c in chain if c < k]
        last = before[-1] if before else -1
        reset = newbuf[last + 1:k + 1].any()
        e[k] = 0 if reset else (end[last] if before else skip)
    run = valid & (pos >= e)
    on_chain = np.isin(lane, chain)
    assert (run[on_chain]).all() and not (run & goods & ~on_chain).any()
    skip_out = np.where(on_chain, end, e)

    # the writes, and the cut: the first lane whose lookups, against the
    # cache as the running lanes before it leave it, give other crcok bits
    # than against the cache at the batch's start
    wr = run & (add1 | add2)
    wh = np.where(add1, h1, h2)
    wa = np.where(add1, a1, a2)
    cut = nb
    for k in lane:
        true1, true2 = r1[k], r2[k]
        for j in range(k):
            if wr[j] and wh[j] == h1[k]:
                true1 = wa[j]
            if wr[j] and wh[j] == h2[k]:
                true2 = wa[j]
        if (crcok(v1[k], a1[k], true1) != crcok1[k]) or (crcok(v2[k], a2[k], true2) != crcok2[k]):
            cut = int(k)
            break
    assert cut >= 1

    # commit the lanes before the cut, in lane order
    full = (run * tr.R_RUN | (run & att1) * tr.R_ATT1 | crcok1 * tr.R_CRCOK1
            | (run & good1) * tr.R_GOOD1 | (run & run2) * tr.R_RUN2 | (run & att2) * tr.R_ATT2
            | crcok2 * tr.R_CRCOK2 | (run & good2) * tr.R_GOOD2)
    words[i:i + cut] = full[:cut]
    for j in range(cut):
        if wr[j]:
            written[wh[j]] = True
            live[wh[j]] = wa[j]
    return cut, int(skip_out[cut - 1])


def batched_walk(pf, w1, w2, h12, nbuf, cache_addr, cache_ts, now, mc, width=32, chunk=CHUNK):
    """The kernel's walk of one stream, batch by batch, on numpy int32
    arrays.  Returns (words, cache_addr', cache_ts', batches, cuts)."""
    pf, w1, w2, h12 = (np.asarray(a, np.int64) for a in (pf, w1, w2, h12))
    ca = np.asarray(cache_addr, np.int64)
    ct = np.asarray(cache_ts, np.int64)
    age = ((now - ct + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)  # int32 wraparound
    live = np.where((ca != 0) & (age <= ICAO_CACHE_TTL), ca, 0)
    written = np.zeros(ca.shape[0], bool)
    n = len(nbuf) * mc
    words = np.zeros(n, np.int64)
    skip = batches = cuts = 0
    for c0 in range(0, n, chunk):
        ln = min(chunk, n - c0)
        for b in range(c0 // mc, (c0 + ln - 1) // mc + 1):
            start = b * mc
            cnt = min(max(int(nbuf[b]), 0), mc)
            i, hi = max(start, c0), min(start + cnt, c0 + ln)
            while i < hi:
                nb = min(width, hi - i)
                done, skip = _batch(i, nb, pf, w1, w2, h12, live, written, words, skip)
                batches += 1
                cuts += done < nb
                i += done
    ca_out = np.where(written, live, ca).astype(np.int32)
    ct_out = np.where(written, now, ct).astype(np.int32)
    return words.astype(np.int32), ca_out, ct_out, batches, cuts


# ---- inputs -------------------------------------------------------------------------


def zero_write_stream(expired: bool):
    """Address 0 written over the entry of its own cache slot, which holds
    address X (fresh, or just expired), between lookups of X and of 0, on
    pass 1 and on pass 2.  Two buffers of 8 slots; positions 300 apart, so
    a good frame never skips the next slot."""
    h0 = IcaoCache.hash(0)
    x = next(a for a in range(1, 1 << 24) if IcaoCache.hash(a) == h0)
    att, add, seen = tr.W_ATTEMPT, tr.W_ADDABLE, tr.W_CRCOK_SEEN
    w1 = [x | att | seen, 0 | att | add, x | att | seen, 0 | att | seen,
          x | att | add, x | att | seen, x, x | att | seen]
    w2 = [x, x, x, x, x, x, 0 | att | add, x]
    w1, w2 = w1 * 2, w2 * 2
    pf = [(300 * (s % 8)) | tr.PF_VALID | (tr.PF_NEWBUF if s % 8 == 0 else 0)
          | (tr.PF_GATE1 if s % 8 == 6 else 0) for s in range(16)]
    ca = np.zeros(ICAO_CACHE_LEN, np.int32)
    ct = np.zeros(ICAO_CACHE_LEN, np.int32)
    ca[h0] = x
    ct[h0] = NOW - (ICAO_CACHE_TTL + 1 if expired else 5)
    i32 = functools.partial(np.asarray, dtype=np.int32)
    return i32(pf), i32(w1), i32(w2), i32([8, 8]), ca, ct


def real_stream():
    """The walk's input of one small dispatch group of the port's own
    precompute: 4 buffers of planted air, mc 128."""
    data, _ = planted_capture(4, 60, seed=9, noise_sigma=3.0)
    bufs = np.stack(list(iq_buffers(io.BytesIO(data))))[:4]
    xg = torch.from_numpy(bufs.reshape(1, 4, -1))
    m, n, pos = tr._group_front(xg, scan_len=BUF_SAMPLES - FULL_LEN_SAMPLES, max_candidates=128)
    (pf, w1, w2, _, nbuf), _ = tr._group_precompute(m, n, pos, True, False, max_candidates=128)
    ca = np.zeros(ICAO_CACHE_LEN, np.int32)
    ct = np.zeros(ICAO_CACHE_LEN, np.int32)
    return pf.numpy(), w1.numpy(), w2.numpy(), nbuf.numpy(), ca, ct


CASES = {
    "random_mc64": (lambda: random_word_stream(7, 6, 64, NOW), 64),
    "random_mc4096": (lambda: random_word_stream(11, 2, 4096, NOW), 4096),
    "real_group": (real_stream, 128),
    "forced_cut": (lambda: forced_cut_stream(5, 6, 64, NOW), 64),
    "forced_cut_mc4096": (lambda: forced_cut_stream(6, 2, 4096, NOW), 4096),
    "zero_write_fresh": (lambda: zero_write_stream(False), 8),
    "zero_write_expired": (lambda: zero_write_stream(True), 8),
}


def _h12(w1, w2):
    return tr._hash_words(torch.from_numpy(w1), torch.from_numpy(w2)).numpy()


@functools.cache
def expected(case: str):
    """(inputs, mc, plain walk) of a case; the plain walk checked once
    against the JAX package's XLA scan."""
    import jax.numpy as jnp

    import dump1090_tpu.ops.resolve as jr

    make, mc = CASES[case]
    pf, w1, w2, nbuf, ca, ct = make()
    h12 = _h12(w1, w2)
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in (pf, w1, w2, h12, nbuf, ca, ct)]
    words, ca2, ct2 = (a.numpy() for a in tr.resolve_words_plain(*t, NOW, mc))
    # the XLA scan walks every slot (invalid ones too): compare on valid slots
    valid = (pf & tr.PF_VALID) != 0
    xw, xca, xct, _ = jr._resolve_words_xla(
        jnp.asarray(pf), jnp.asarray(w1), jnp.asarray(w2), jnp.asarray(ca), jnp.asarray(ct), NOW
    )
    np.testing.assert_array_equal(words, np.where(valid, np.asarray(xw), 0))
    np.testing.assert_array_equal(ca2, np.asarray(xca))
    np.testing.assert_array_equal(ct2, np.asarray(xct))
    return (pf, w1, w2, h12, nbuf, ca, ct), mc, (words, ca2, ct2)


@pytest.mark.parametrize("width", [1, 4, 32])
@pytest.mark.parametrize("case", sorted(CASES))
def test_batched_model_matches_plain_and_xla(case, width):
    inputs, mc, want = expected(case)
    words, ca, ct, batches, cuts = batched_walk(*inputs, NOW, mc, width=width)
    for name, g, w in zip(("words", "cache_addr", "cache_ts"), (words, ca, ct), want):
        np.testing.assert_array_equal(g, w, err_msg=name)
    steps = int(np.clip(inputs[4], 0, mc).sum())
    assert steps <= batches * width and batches <= steps and cuts <= batches
    if width == 1:
        assert batches == steps and cuts == 0


def test_inputs_cover_what_the_walk_must_handle():
    """The cases hold what the kernel's walk is held to: every count kind,
    cuts in most batches of the forced-cut stream, address 0 written over
    a fresh entry and over an expired one."""
    (_, _, _, _, nbuf, _, _), mc, _ = expected("forced_cut")
    assert {mc, 0}.issubset(nbuf.tolist()) and (nbuf < 0).any() and (nbuf > mc).any()
    assert (np.clip(nbuf, 0, mc) % 32 != 0).any()
    for case in ("forced_cut", "forced_cut_mc4096"):
        inputs, mc, _ = expected(case)
        _, _, _, batches, cuts = batched_walk(*inputs, NOW, mc)
        assert cuts >= 0.8 * batches, (case, batches, cuts)
    inputs, mc, _ = expected("real_group")
    _, _, _, batches, cuts = batched_walk(*inputs, NOW, mc)
    steps = int(np.clip(inputs[4], 0, mc).sum())
    assert steps > 200 and batches < steps / 8  # real air settles many steps a batch
    h0 = IcaoCache.hash(0)
    for case in ("zero_write_fresh", "zero_write_expired"):
        (_, _, _, _, _, ca, _), _, (words, ca2, ct2) = expected(case)
        assert ca[h0] != 0 and ca2[h0] == 0 and ct2[h0] == NOW, case
        assert (words & tr.R_GOOD1).any()
    # over a fresh entry, writing 0 turns the later lookups of X unseen
    _, _, (words, _, _) = expected("zero_write_fresh")
    assert words[0] & tr.R_GOOD1 and not words[2] & tr.R_GOOD1


def _random_stream(seed: int, n_buffers: int, mc: int):
    """Arbitrary words: every flag bit at random (PF_NEWBUF on any slot),
    addresses from a pool of 4 (0 among them) and hash slots in 0..3, so
    lookups hit, collide and get overwritten; counts from -2 to mc + 2."""
    rng = np.random.default_rng(seed)
    n = n_buffers * mc
    pool = np.array([0, 5, 9, 0xABCDEF])
    pf = (rng.integers(0, 400, n) | rng.integers(0, 8, n) << 17).astype(np.int32)
    w1, w2 = (rng.choice(pool, n) | rng.integers(0, 32, n) << 24 for _ in range(2))
    h12 = rng.integers(0, 4, n) | rng.integers(0, 4, n) << 10
    nbuf = rng.integers(-2, mc + 3, n_buffers)
    ca = np.zeros(ICAO_CACHE_LEN, np.int64)
    ct = np.zeros(ICAO_CACHE_LEN, np.int64)
    ca[:4] = rng.choice(pool, 4)
    ct[:4] = NOW - rng.choice([0, 60, 61, -(1 << 31)], 4)
    return [np.asarray(a).astype(np.int32) for a in (pf, w1, w2, h12, nbuf, ca, ct)]


@settings(max_examples=150, deadline=None, derandomize=True)
@given(seed=st.integers(0, 2**32 - 1), n_buffers=st.integers(1, 4), mc=st.integers(1, 70),
       width=st.sampled_from([1, 2, 4, 32]), chunk=st.sampled_from([5, 16, CHUNK]))
def test_batched_model_equals_plain_on_arbitrary_words(seed, n_buffers, mc, width, chunk):
    inputs = _random_stream(seed, n_buffers, mc)
    want = tr.resolve_words_plain(*(torch.from_numpy(a) for a in inputs), NOW, mc)
    got = batched_walk(*inputs, NOW, mc, width=width, chunk=chunk)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w.numpy())


def test_walk_counts_come_only_from_the_kernel():
    """The wrappers return the kernel's batch and cut counts only through
    walk_counts, which a CPU tensor (the plain version) cannot give."""
    inputs, mc, (words, _, _) = expected("random_mc64")
    t = [torch.from_numpy(a) for a in inputs]
    with pytest.raises(ValueError, match="walk_counts"):
        tr.resolve_words(*t, NOW, mc, walk_counts=True)
    rows = [a[None] for a in t[5:]]
    with pytest.raises(ValueError, match="walk_counts"):
        tr.resolve_words_streams(*t[:5], *rows, NOW, mc, 1, walk_counts=True)
    got = tr.resolve_words(*t, NOW, mc)
    assert len(got) == 3 and np.array_equal(got[0].numpy(), words)
    assert len(tr.resolve_words_streams(*t[:5], *rows, NOW, mc, 1)) == 3
