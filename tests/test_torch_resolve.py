"""Port's resolver (dump1090_tpu_torch/ops/resolve.py) against the JAX
package on the CPU: the derived tables, the order-independent precompute,
the plain sequential walk against both JAX backends (the XLA scan and the
Pallas kernel in interpret mode), and every packed output of one dispatch
group.  Exact equality throughout: the pipeline is integer end to end and
the float32 GF(2) product is exact."""

import io

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import dump1090_tpu.ops.resolve as jr
import dump1090_tpu_torch.ops.resolve as tr
from dump1090_tpu_torch.constants import BUF_SAMPLES, FULL_LEN_SAMPLES, ICAO_CACHE_LEN
from dump1090_tpu_torch.io.sources import iq_buffers
from dump1090_tpu_torch.utils.synth import planted_capture, random_word_stream

SCAN = BUF_SAMPLES - FULL_LEN_SAMPLES
NOW = 1_700_000_000


def test_word_layout_constants_equal_jax():
    names = [
        "PF_POS_MASK", "PF_VALID", "PF_NEWBUF", "PF_GATE1", "W_ADDR_MASK",
        "W_ATTEMPT", "W_CRCOK_SEEN", "W_CRCOK_NOSEEN", "W_ADDABLE", "W_LONG",
        "R_RUN", "R_ATT1", "R_CRCOK1", "R_GOOD1", "R_RUN2", "R_ATT2",
        "R_CRCOK2", "R_GOOD2", "META_CRCOK", "META_PHASE", "META_LONG",
        "META_PASS", "META_ERRBIT_SHIFT", "META_ERRBIT_MASK", "META_POS_SHIFT",
        "SKIP_SHORT", "SKIP_EXTRA_LONG", "RESOLVE_CHUNK", "PACKED_RANK_LIMIT",
    ]
    for name in names:
        assert getattr(tr, name) == getattr(jr, name), name
    for mc in (1, 16, 64, 300, 2048, 2049, 4800, 5120, 8192):
        assert tr.normalize_max_candidates(mc) == jr.normalize_max_candidates(mc)
    for args in [(2048, 2048), (40_000, 50_000), (40_000, 50_000, 30_000, 30_000)]:
        assert tr.clamp_packed_out(*args) == jr.clamp_packed_out(*args)
    with pytest.raises(ValueError):
        tr.clamp_packed_out(70_000, 70_000, 40_000, 30_000)
    cap = tr.max_candidates_cap(512)
    assert cap * 512 <= tr.MAX_GROUP_SLOTS and cap >= 256


def test_dense_fix_table_and_bit_matrices_equal_jax():
    np.testing.assert_array_equal(tr._dense_fix_table_np(), jr._dense_fix_table())
    t = tr._dense_fix_table(torch.device("cpu"))
    assert t.dtype == torch.int32
    np.testing.assert_array_equal(t.numpy(), jr._dense_fix_table().astype(np.int32))
    m_long, m_short = tr._bit_matrices(torch.device("cpu"))
    j_long, j_short = jr._bit_matrices()
    np.testing.assert_array_equal(m_long.numpy(), j_long)
    np.testing.assert_array_equal(m_short.numpy(), j_short)


def _frames(seed, n):
    """Random frames plus clean/1-bit/2-bit-corrupted DF17s and DF11s, so
    syndromes hit the fix table."""
    from dump1090_tpu_torch.utils.synth import make_df17_frame

    rng = np.random.default_rng(seed)
    msgs = rng.integers(0, 256, (n, 14), dtype=np.uint8)
    for k in range(0, n, 3):
        f = bytearray(make_df17_frame(int(rng.integers(1, 1 << 24))))
        for p in rng.choice(np.arange(5, 112), (k // 3) % 3, replace=False):
            f[p >> 3] ^= 1 << (7 - (int(p) & 7))
        msgs[k] = np.frombuffer(bytes(f), np.uint8)
    msgs[1::9, 0] = (11 << 3) | 5  # DF11 (IID path)
    msgs[2::9, 0] = 4 << 3         # DF4 (AP path)
    return msgs


def test_syndromes_and_icao_hash_match_jax():
    msgs = _frames(0, 600)
    jl, js = jr.device_syndromes(jnp.asarray(msgs))
    tl, ts = tr.device_syndromes(torch.from_numpy(msgs))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    addr = np.random.default_rng(1).integers(0, 1 << 24, 5000).astype(np.int32)
    np.testing.assert_array_equal(
        tr.icao_hash(torch.from_numpy(addr)).numpy(),
        np.asarray(jr.icao_hash(jnp.asarray(addr))),
    )


@pytest.mark.parametrize("fix,aggressive", [(True, False), (False, False), (True, True)])
def test_pass_precompute_matches_jax(fix, aggressive):
    rng = np.random.default_rng(2)
    msgs = _frames(3, 900)
    errors = rng.integers(0, 2, 900).astype(np.int32)
    gate = rng.random(900) < 0.8
    jw, jm, jaux = jr._pass_precompute(
        jnp.asarray(msgs), jnp.asarray(errors), jnp.asarray(gate),
        jnp.asarray(aggressive), jnp.asarray(fix),
    )
    tw, tm, taux = tr._pass_precompute(
        torch.from_numpy(msgs), torch.from_numpy(errors), torch.from_numpy(gate),
        aggressive, fix,
    )
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    assert set(taux) == set(jaux)
    for k in jaux:
        np.testing.assert_array_equal(taux[k].numpy(), np.asarray(jaux[k]), err_msg=k)
    if fix:
        assert (taux["fixed_one"].numpy()).any()


@pytest.mark.parametrize("n_buffers,mc", [(6, 64), (2, 4096)])  # incl. mc > 2048
def test_resolve_words_plain_matches_xla_and_pallas(n_buffers, mc):
    pf, w1, w2, nbuf, ca, ct = random_word_stream(7, n_buffers, mc, NOW)
    h12 = tr._hash_words(torch.from_numpy(w1), torch.from_numpy(w2))
    np.testing.assert_array_equal(
        h12.numpy(), np.asarray(jr._hash_words(jnp.asarray(w1), jnp.asarray(w2)))
    )
    words, ca2, ct2 = tr.resolve_words_plain(
        torch.from_numpy(pf), torch.from_numpy(w1), torch.from_numpy(w2), h12,
        torch.from_numpy(nbuf), torch.from_numpy(ca), torch.from_numpy(ct), NOW, mc,
    )
    # the XLA scan walks every slot (invalid ones too): compare on valid slots
    valid = (pf & tr.PF_VALID) != 0
    xw, xca, xct, _ = jr._resolve_words_xla(
        jnp.asarray(pf), jnp.asarray(w1), jnp.asarray(w2), jnp.asarray(ca),
        jnp.asarray(ct), NOW,
    )
    np.testing.assert_array_equal(words.numpy(), np.where(valid, np.asarray(xw), 0))
    np.testing.assert_array_equal(ca2.numpy(), np.asarray(xca))
    np.testing.assert_array_equal(ct2.numpy(), np.asarray(xct))
    pw, pca, pct = jr._resolve_words_pallas(
        jnp.asarray(pf), jnp.asarray(w1), jnp.asarray(w2), jnp.asarray(nbuf),
        jnp.asarray(ca), jnp.asarray(ct), NOW, mc=mc, interpret=True,
    )
    np.testing.assert_array_equal(words.numpy(), np.asarray(pw))
    np.testing.assert_array_equal(ca2.numpy(), np.asarray(pca))
    np.testing.assert_array_equal(ct2.numpy(), np.asarray(pct))
    w = words.numpy()
    # the stream really exercised cache hits, skips and both passes
    assert (w & tr.R_GOOD1).any() and (w & tr.R_RUN2).any() and (w & tr.R_ATT2).any()
    assert (valid & ((w & tr.R_RUN) == 0)).any()  # skipped by skip-until
    assert not (ca2.numpy() == ca).all()
    # the wrapper takes the plain version on the CPU and leaves its inputs
    wrap = tr.resolve_words(
        torch.from_numpy(pf), torch.from_numpy(w1), torch.from_numpy(w2), h12,
        torch.from_numpy(nbuf), torch.from_numpy(ca), torch.from_numpy(ct), NOW, mc,
    )
    np.testing.assert_array_equal(wrap[0].numpy(), w)


def _group_input(seed, g, nb):
    data, _ = planted_capture(g * nb, 60, seed=seed, noise_sigma=3.0)
    bufs = np.stack(list(iq_buffers(io.BytesIO(data))))[: g * nb]
    return bufs.reshape(g, nb, -1)


@pytest.mark.parametrize("fix,aggressive", [(True, False), (True, True)])
def test_demod_resolve_group_packed_matches_jax(fix, aggressive):
    xg = _group_input(4, 2, 2)
    mc, mos, mol = 64, 256, 256
    rng = np.random.default_rng(0)
    ca0 = np.zeros(ICAO_CACHE_LEN, np.int32)
    ct0 = np.zeros(ICAO_CACHE_LEN, np.int32)
    ca0[rng.integers(0, ICAO_CACHE_LEN, 50)] = rng.integers(1, 1 << 24, 50)
    ct0[:] = NOW - 10
    want = jr.demod_resolve_group(
        jnp.asarray(xg), jnp.asarray(ca0), jnp.asarray(ct0), NOW, fix, aggressive,
        scan_len=SCAN, max_candidates=mc, max_out_short=mos, max_out_long=mol,
        crcok_only=True, pallas=False, packed=True,
    )
    n_j, count_j, clong_j, shorts_j, longs_j, stats_j, ca_j, ct_j = (np.asarray(a) for a in want)
    got = tr.demod_resolve_group(
        torch.from_numpy(xg), torch.from_numpy(ca0), torch.from_numpy(ct0), NOW,
        fix, aggressive, scan_len=SCAN, max_candidates=mc,
        max_out_short=mos, max_out_long=mol,
    )
    n_t, count_t, clong_t, shorts_t, longs_t, stats_t, ca_t, ct_t = (a.numpy() for a in got)
    for name, a, b in [("n", n_t, n_j), ("count", count_t, count_j),
                       ("count_long", clong_t, clong_j), ("stats", stats_t, stats_j),
                       ("cache_addr", ca_t, ca_j), ("cache_ts", ct_t, ct_j)]:
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert shorts_t.shape == shorts_j.shape and longs_t.shape == longs_j.shape
    for g in range(xg.shape[0]):
        cs = int(count_j[g] - clong_j[g])
        cl = int(clong_j[g])
        np.testing.assert_array_equal(shorts_t[g, :cs], shorts_j[g, :cs])
        np.testing.assert_array_equal(longs_t[g, :cl], longs_j[g, :cl])
        msg_t, bits_t = tr.interleave_packed(count_t[g], clong_t[g], shorts_t[g], longs_t[g])
        msg_j, bits_j = jr.interleave_packed(count_j[g], clong_j[g], shorts_j[g], longs_j[g])
        np.testing.assert_array_equal(msg_t, msg_j)
        np.testing.assert_array_equal(bits_t, bits_j)
    assert (n_t > mc).any()  # overflow rows are reported by exact count
    assert count_t.sum() > 0 and stats_t[:, 5].sum() > 0  # emitted, and fixed


def test_group_entry_guards():
    xg = torch.full((1, 1, 1000), 127, dtype=torch.uint8)
    z = torch.zeros(ICAO_CACHE_LEN, dtype=torch.int32)
    with pytest.raises(ValueError, match="rank"):
        tr.demod_resolve_group(xg, z, z, NOW, True, False, scan_len=SCAN,
                               max_candidates=64, max_out_short=40_000,
                               max_out_long=30_000)
    with pytest.raises(ValueError, match="packed-position"):
        tr.demod_resolve_group(xg, z, z, NOW, True, False, scan_len=1 << 17,
                               max_candidates=64, max_out_short=64, max_out_long=64)
