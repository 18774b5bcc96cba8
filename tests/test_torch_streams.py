"""The port's multi-stream resolver and unpacked emission against the JAX
package on the CPU: the plain multi-stream walk against the Pallas streams
kernel in interpret mode and the XLA scan per stream,
demod_resolve_streams, demod_resolve_group(packed=False), and the dispatch
tiling bound.  Exact equality throughout: the pipeline is integer end to
end."""

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


def _streams_input(n_streams, nb, mc, exhausted=1):
    """S per-stream random word streams laid end to end, each with its own
    initial cache row; stream `exhausted` has all-zero counts."""
    parts = [random_word_stream(11 + s, nb, mc, NOW) for s in range(n_streams)]
    pf, w1, w2, nbuf, ca, ct = (np.stack([p[i] for p in parts]) for i in range(6))
    nbuf[exhausted] = 0
    pf[exhausted] &= ~tr.PF_VALID
    flat = [a.reshape(-1) for a in (pf, w1, w2, nbuf)]
    return (*flat, ca, ct)


def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


# NB=32 at mc=64 fills whole 2048-slot chunks per stream, as the JAX streams
# kernel demands; NB=2 at mc=4096 spans each buffer over two chunks
@pytest.mark.parametrize("nb,mc", [(32, 64), (2, 4096)])
def test_resolve_words_streams_plain_matches_pallas_and_xla(nb, mc):
    s_n = 3
    pf, w1, w2, nbuf, ca, ct = _streams_input(s_n, nb, mc)
    t_pf, t_w1, t_w2, t_nbuf, t_ca, t_ct = _torch(pf, w1, w2, nbuf, ca, ct)
    h12 = tr._hash_words(t_w1, t_w2)
    words, ca2, ct2 = tr.resolve_words_streams_plain(
        t_pf, t_w1, t_w2, h12, t_nbuf, t_ca, t_ct, NOW, mc, s_n
    )
    assert ca2.shape == (s_n, ICAO_CACHE_LEN)
    valid = (pf & tr.PF_VALID) != 0
    pw, pca, pct = jr._resolve_words_pallas_streams(
        jnp.asarray(pf), jnp.asarray(w1), jnp.asarray(w2), jnp.asarray(nbuf),
        jnp.asarray(ca), jnp.asarray(ct), NOW, mc=mc, n_streams=s_n, interpret=True,
    )
    # the streams kernel returns words unmasked: compare on walked slots
    np.testing.assert_array_equal(words.numpy(), np.where(valid, np.asarray(pw), 0))
    np.testing.assert_array_equal(ca2.numpy(), np.asarray(pca))
    np.testing.assert_array_equal(ct2.numpy(), np.asarray(pct))
    per = nb * mc
    for s in range(s_n):
        sl = slice(s * per, (s + 1) * per)
        xw, xca, xct, _ = jr._resolve_words_xla(
            jnp.asarray(pf[sl]), jnp.asarray(w1[sl]), jnp.asarray(w2[sl]),
            jnp.asarray(ca[s]), jnp.asarray(ct[s]), NOW,
        )
        np.testing.assert_array_equal(words.numpy()[sl], np.where(valid[sl], np.asarray(xw), 0))
        np.testing.assert_array_equal(ca2.numpy()[s], np.asarray(xca))
        np.testing.assert_array_equal(ct2.numpy()[s], np.asarray(xct))
        # each stream equals the single-stream walk on its own slice
        one = tr.resolve_words_plain(
            t_pf[sl], t_w1[sl], t_w2[sl], h12[sl], t_nbuf[s * nb:(s + 1) * nb],
            t_ca[s], t_ct[s], NOW, mc,
        )
        np.testing.assert_array_equal(one[0].numpy(), words.numpy()[sl])
    w = words.numpy()
    assert (w & tr.R_GOOD1).any() and (w & tr.R_ATT2).any()
    # the exhausted stream walked nothing and kept its cache row
    assert not w[per:2 * per].any()
    np.testing.assert_array_equal(ca2.numpy()[1], ca[1])
    # the wrapper takes the plain version on the CPU
    wrap = tr.resolve_words_streams(t_pf, t_w1, t_w2, h12, t_nbuf, t_ca, t_ct, NOW, mc, s_n)
    np.testing.assert_array_equal(wrap[0].numpy(), w)


def test_resolve_words_streams_checks_inputs():
    pf, w1, w2, nbuf, ca, ct = _torch(*_streams_input(2, 2, 16))
    h12 = tr._hash_words(w1, w2)
    with pytest.raises(ValueError, match="shape"):
        tr.resolve_words_streams(pf, w1, w2, h12, nbuf, ca[0], ct[0], NOW, 16, 2)
    ca3 = torch.zeros((3, ICAO_CACHE_LEN), dtype=torch.int32)
    with pytest.raises(ValueError, match="split"):  # 4 buffers, 3 streams
        tr.resolve_words_streams(pf, w1, w2, h12, nbuf, ca3, ca3, NOW, 16, 3)
    with pytest.raises(TypeError):
        tr.resolve_words_streams(pf.long(), w1, w2, h12, nbuf, ca, ct, NOW, 16, 2)


def test_streams_dispatch_shape(monkeypatch):
    assert tr.streams_dispatch_shape(128, 4, 256) == (128, 4)
    assert tr.streams_dispatch_shape(3000, 4, 256) == (tr.MAX_GROUP_SLOTS // 1024, 4)
    monkeypatch.setattr(tr, "MAX_GROUP_SLOTS", 3 * 256)
    assert tr.streams_dispatch_shape(5, 4, 256) == (1, 3)
    assert tr.streams_dispatch_shape(5, 2, 256) == (1, 2)
    with pytest.raises(OverflowError):
        tr.streams_dispatch_shape(5, 4, 4096)


def _capture_bufs(seed, n):
    data, _ = planted_capture(n, 60, seed=seed, noise_sigma=3.0)
    return np.stack(list(iq_buffers(io.BytesIO(data))))[:n]


def _caches(seed, rows):
    rng = np.random.default_rng(seed)
    ca = np.zeros((rows, ICAO_CACHE_LEN), np.int32)
    for r in range(rows):
        ca[r, rng.integers(0, ICAO_CACHE_LEN, 50)] = rng.integers(1, 1 << 24, 50)
    ct = np.full((rows, ICAO_CACHE_LEN), NOW - 10, np.int32)
    return ca, ct


def _crcok_rows(count, msg, meta):
    """The port emits every attempted decode; keep the crcok rows on the
    host, as JAX's crcok_only=True emission does on the device: (count
    (R,), msg (R, M, 14), meta (R, M) with -1 beyond the count)."""
    count_f = np.zeros_like(count)
    msg_f = np.zeros_like(msg)
    meta_f = np.full_like(meta, -1)
    for r in range(count.shape[0]):
        c = int(count[r])
        keep = (meta[r, :c] & tr.META_CRCOK) != 0
        k = int(keep.sum())
        count_f[r] = k
        msg_f[r, :k] = msg[r, :c][keep]
        meta_f[r, :k] = meta[r, :c][keep]
    return count_f, msg_f, meta_f


# crcok_only=True holds JAX's device-side filter against the port's full
# emission filtered on the host
@pytest.mark.parametrize("crcok_only", [False, True])
def test_demod_resolve_streams_matches_jax(crcok_only):
    xs = _capture_bufs(5, 6).reshape(3, 2, -1)
    xs[1, 1] = 127  # one stream runs out half way
    ca0, ct0 = _caches(1, 3)
    mc, mo = 64, 512
    want = jr.demod_resolve_streams(
        jnp.asarray(xs), jnp.asarray(ca0), jnp.asarray(ct0), NOW, True, False,
        scan_len=SCAN, max_candidates=mc, max_out=mo, crcok_only=crcok_only,
        pallas=False,
    )
    n_j, count_j, msg_j, meta_j, stats_j, ca_j, ct_j = (np.asarray(a) for a in want)
    got = tr.demod_resolve_streams(
        torch.from_numpy(xs), *_torch(ca0, ct0), NOW, True, False,
        scan_len=SCAN, max_candidates=mc, max_out=mo,
    )
    n_t, count_t, msg_t, meta_t, stats_t, ca_t, ct_t = (a.numpy() for a in got)
    assert (count_t < mo).all()
    if crcok_only:
        count_t, msg_t, meta_t = _crcok_rows(count_t, msg_t, meta_t)
    for name, a, b in [("n", n_t, n_j), ("count", count_t, count_j),
                       ("meta", meta_t, meta_j), ("stats", stats_t, stats_j),
                       ("cache_addr", ca_t, ca_j), ("cache_ts", ct_t, ct_j)]:
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert msg_t.shape == msg_j.shape
    for s in range(3):
        c = int(count_j[s])
        # rows past the count differ: JAX pads streams to chunk boundaries
        np.testing.assert_array_equal(msg_t[s, :c], msg_j[s, :c])
    assert (n_t > mc).any() and (count_t > 0).all()
    assert not (ca_t == ca0).all()
    if not crcok_only:
        assert ((meta_t >= 0) & ((meta_t & tr.META_CRCOK) == 0)).any()


@pytest.mark.parametrize("crcok_only", [False, True])
def test_demod_resolve_group_unpacked_matches_jax(crcok_only):
    xg = _capture_bufs(4, 4).reshape(2, 2, -1)
    ca0, ct0 = (a[0] for a in _caches(2, 1))
    mc, mo = 64, 300
    want = jr.demod_resolve_group(
        jnp.asarray(xg), jnp.asarray(ca0), jnp.asarray(ct0), NOW, True, True,
        scan_len=SCAN, max_candidates=mc, max_out=mo, crcok_only=crcok_only,
        pallas=False, packed=False,
    )
    got = tr.demod_resolve_group(
        torch.from_numpy(xg), *_torch(ca0, ct0), NOW, True, True,
        scan_len=SCAN, max_candidates=mc, max_out=mo, packed=False,
    )
    assert len(got) == len(want) == 7
    got = [a.numpy() for a in got]
    assert (got[1] < mo).all()
    meta = got[3]
    assert ((meta >= 0) & ((meta & tr.META_PASS) != 0)).any()  # pass-2 emissions
    want = [np.asarray(b) for b in want]
    if crcok_only:
        got[1], got[2], got[3] = _crcok_rows(got[1], got[2], got[3])
        # rows past the host-filtered count are not the device filter's
        for g in range(2):
            c = int(want[1][g])
            np.testing.assert_array_equal(got[2][g, :c], want[2][g, :c])
        got[2], want[2] = got[2][:, :0], want[2][:, :0]
    names = ("n", "count", "msg", "meta", "stats", "cache_addr", "cache_ts")
    for name, a, b in zip(names, got, want):
        np.testing.assert_array_equal(a, b, err_msg=name)
