"""Port's demodulator (dump1090_tpu_torch/ops/demod.py) against the JAX
package on the same numpy inputs, on the CPU: the front half (exact count n
and first-K positions, JAX's `mask` form) and both demod passes of
candidate windows.  Exact equality."""

import io

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dump1090_tpu.ops import demod as jd
from dump1090_tpu.ops.magnitude import magnitude_from_iq as jax_mag
from dump1090_tpu_torch.constants import BUF_SAMPLES, FULL_LEN_SAMPLES
from dump1090_tpu_torch.io.sources import iq_buffers
from dump1090_tpu_torch.ops import demod as td
from dump1090_tpu_torch.ops.magnitude import magnitude_from_iq
from dump1090_tpu_torch.utils.synth import planted_capture

SCAN = BUF_SAMPLES - FULL_LEN_SAMPLES


@pytest.fixture(scope="module")
def mags():
    data, _ = planted_capture(2, 120, seed=5, noise_sigma=4.0)
    bufs = np.stack(list(iq_buffers(io.BytesIO(data))))
    m = magnitude_from_iq(torch.from_numpy(bufs)).numpy()
    np.testing.assert_array_equal(m, np.asarray(jax.vmap(jax_mag)(jnp.asarray(bufs))))
    return m


@pytest.mark.parametrize("mc", [64, 512])  # overflowing and fitting rows
def test_front_candidates_match_jax_mask_form(mags, mc):
    n_j, pos_j = jd.front_candidates(jnp.asarray(mags), SCAN, mc, "mask")
    n_t, pos_t = td.front_candidates(torch.from_numpy(mags), SCAN, mc)
    np.testing.assert_array_equal(n_t.numpy(), np.asarray(n_j))
    np.testing.assert_array_equal(pos_t.numpy(), np.asarray(pos_j))
    assert pos_t.dtype == torch.int32 and n_t.dtype == torch.int32
    if mc == 64:
        assert (n_t.numpy() > mc).all()  # the overflow case really ran
    else:
        assert (n_t.numpy() < mc).all()  # and the scan_len padding too


def _windows(mags, rng):
    """Windows at real candidate positions, plus random and flat windows
    (flat: low == high at cell 0, the demod-error bit)."""
    m = torch.from_numpy(mags)
    _, pos = td.front_candidates(m, SCAN, 256)
    w = td.gather_candidate_windows(m, pos).reshape(-1, 256).numpy()
    pos = pos.reshape(-1).numpy()
    rand = rng.integers(0, 65168, (200, 256), dtype=np.uint16)
    flat = np.repeat(rng.integers(0, 65168, (20, 1), dtype=np.uint16), 256, axis=1)
    w = np.concatenate([w, rand, flat])
    pos = np.concatenate([pos, rng.integers(0, SCAN, 220).astype(np.int32)])
    pos[::7] = 0  # phase correction is skipped at pos == 0
    return w, pos


def test_candidate_passes_match_jax(mags):
    w, pos = _windows(mags, np.random.default_rng(1))
    want = jax.vmap(jd.candidate_passes_window)(jnp.asarray(w), jnp.asarray(pos))
    got = td.candidate_passes_window(torch.from_numpy(w), torch.from_numpy(pos))
    names = ("msg1", "errors1", "gate1", "msg2", "errors2", "gate2")
    for name, g, j in zip(names, got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(j), err_msg=name)
    assert got[1].numpy().any() and got[2].numpy().any()  # both flags exercised


def test_gather_candidate_windows_matches_jax(mags):
    m = mags[:, :]
    _, pos = td.front_candidates(torch.from_numpy(m), SCAN, 128)
    want = jd.gather_candidate_windows(jnp.asarray(m), jnp.asarray(pos.numpy()), pallas=False)
    got = td.gather_candidate_windows(torch.from_numpy(m), pos)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


CAND_FIELDS = ("n", "pos", "msg1", "errors1", "gate1", "msg2", "errors2", "gate2")


def _assert_candidates_equal(got, want):
    for name, g, w in zip(CAND_FIELDS, got, want):
        g = g.numpy()
        w = np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape, name
        np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.fixture(scope="module")
def iq_bufs():
    from dump1090_tpu_torch.utils.synth import traffic_capture

    data, _ = traffic_capture(3, 150, seed=11, blank_every=9)
    return np.stack(list(iq_buffers(io.BytesIO(data))))


@pytest.mark.parametrize("mc", [64, 512])  # overflowing and fitting rows
@pytest.mark.parametrize("pairs", [False, True])
def test_demod_batch_matches_jax(iq_bufs, mc, pairs):
    """Every Candidates field of the batched demodulator, from uint8 IQ
    bytes and from the same bytes as uint16 I|Q<<8 pairs."""
    from dump1090_tpu.parallel.sharding import demod_batch as jax_demod_batch

    x = iq_bufs.view("<u2") if pairs else iq_bufs
    want = jax_demod_batch(jnp.asarray(x), scan_len=SCAN, max_candidates=mc)
    got = td.demod_batch(torch.from_numpy(x), scan_len=SCAN, max_candidates=mc)
    _assert_candidates_equal(got, want)
    n = got.n.numpy()
    assert (n > mc).any() if mc == 64 else (n < mc).all()
    assert got.errors2.numpy().any() and got.gate1.numpy().any()


def test_demod_block_and_iq_block_match_jax(iq_bufs):
    """One buffer: from magnitudes (demod_block) and from IQ bytes
    (demod_iq_block), n a 0-d count."""
    buf = iq_bufs[1]
    mag = magnitude_from_iq(torch.from_numpy(buf))
    want = jd.demod_block(jnp.asarray(mag.numpy()), scan_len=SCAN, max_candidates=256, pallas=False)
    got = td.demod_block(mag, scan_len=SCAN, max_candidates=256)
    _assert_candidates_equal(got, want)
    assert got.n.dim() == 0 and int(got.n) > 0
    want_iq = jd.demod_iq_block(jnp.asarray(buf), scan_len=SCAN, max_candidates=256, pallas=False)
    _assert_candidates_equal(td.demod_iq_block(torch.from_numpy(buf), scan_len=SCAN,
                                               max_candidates=256), want_iq)


def test_preamble_reject_stages_matches_jax(mags, iq_bufs):
    """The --debug p reject codes of every scan position; every code
    occurs.  A batch of rows gives each row's codes."""
    rows = np.concatenate([mags, magnitude_from_iq(torch.from_numpy(iq_bufs)).numpy()])
    got = td.preamble_reject_stages(torch.from_numpy(rows), scan_len=SCAN).numpy()
    assert got.dtype == np.uint8 and got.shape == (len(rows), SCAN)
    for r in range(len(rows)):
        want = np.asarray(jd.preamble_reject_stages(jnp.asarray(rows[r]), scan_len=SCAN))
        np.testing.assert_array_equal(got[r], want)
    assert set(np.unique(got)) == {0, 1, 2, 3}
    mask = td.preamble_mask(torch.from_numpy(rows), SCAN).numpy()
    np.testing.assert_array_equal(mask, got == 0)
