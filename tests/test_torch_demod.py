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


# ---- a scalar oracle of both passes, and the K4 wrapper's contract ----------

def _scalar_passes(w, pos):
    """A scalar transliteration of detectModeS's bit slicing and noise gate
    (dump1090.c:1666-1726) around applyPhaseCorrection (dump1090.c:1471-1558)
    for one window (w[0] = m[pos-1]): (msg1, errors1, gate1, msg2, errors2,
    gate2).  Where the reference would divide by zero (no early or late and
    no on-time energy) the factor is taken as 16384 both ways, the port's
    max(e + on_time, 1)."""
    from dump1090_tpu_torch.constants import message_bits_for_df

    w = [int(x) for x in w[:241]]
    orig = w[17:241]

    def scale(v, f):  # scaleSample: uint32 product over 16384, clamped
        return min(v * f // 16384, 65535)

    def detect(m):
        bits, errors = [0] * 112, 0
        for i in range(0, 224, 2):
            low, high = m[i], m[i + 1]
            if i > 0 and abs(low - high) < 256:
                bits[i // 2] = bits[i // 2 - 1]
            elif low == high:
                bits[i // 2] = 2
                errors += 1
            else:
                bits[i // 2] = int(low > high)
        msg = bytes(
            (bits[i] << 7 | bits[i + 1] << 6 | bits[i + 2] << 5 | bits[i + 3] << 4
             | bits[i + 4] << 3 | bits[i + 5] << 2 | bits[i + 6] << 1 | bits[i + 7]) & 0xFF
            for i in range(0, 112, 8))
        msglen = message_bits_for_df(msg[0] >> 3) // 8
        delta = sum(abs(orig[i] - orig[i + 1]) for i in range(0, msglen * 16, 2))
        return msg, errors, delta // (msglen * 4) >= 10 * 255

    m = list(orig)
    if pos > 0:
        on_time = w[1] + w[3] + w[8] + w[10]
        early, late = (w[0] + w[7]) * 2, (w[4] + w[11]) * 2
        e = early if early > late else late
        q = 16384 * e // max(e + on_time, 1)
        up, down = 16384 + q, 16384 - q
        if early > late:
            m[223] = scale(m[223], up)
            for j in range(222, 0, -2):
                m[j - 1] = scale(m[j - 1], down if m[j] > m[j + 1] else up)
        else:
            m[0] = scale(m[0], up)
            for j in range(0, 222, 2):
                m[j + 2] = scale(m[j + 2], up if m[j] > m[j + 1] else down)
    return (*detect(orig), *detect(m))


def _edge_windows(case, rng, k=24):
    w = rng.integers(0, 1 << 16, (k, 256), dtype=np.uint16)
    if case == "flat":
        w[:] = rng.integers(0, 1 << 16, (k, 1), dtype=np.uint16)
    elif case == "early_eq_late":
        w[:, 0], w[:, 7] = w[:, 4], w[:, 11]
    elif case == "no_energy":      # e + on_time == 0 in whichever direction
        w[:, [0, 1, 3, 4, 7, 8, 10, 11]] = 0
    elif case == "inherited_2":    # cell 0 an error, cell 1 repeats it, then a bit
        w[:, 17] = w[:, 18]
        w[:, 19] = np.minimum(w[:, 20].astype(np.int64) + 100, 65535)
        w[:, 21], w[:, 22] = 40000, 1000
    elif case == "saturating":     # factors near 2 and 0 over samples near 65535
        w = rng.integers(60000, 1 << 16, (k, 256), dtype=np.uint16)
        w[:, [1, 3, 8, 10]] = 1
    return w


EDGE_CASES = ["flat", "early_eq_late", "no_energy", "inherited_2", "saturating", "random"]


@pytest.mark.parametrize("case", EDGE_CASES)
def test_plain_passes_match_scalar_oracle_on_edge_windows(case):
    rng = np.random.default_rng(EDGE_CASES.index(case))
    w = _edge_windows(case, rng)
    pos = rng.integers(1, SCAN, len(w)).astype(np.int32)
    pos[::5] = 0
    got = td.candidate_passes_window_plain(torch.from_numpy(w), torch.from_numpy(pos))
    got = [g.numpy() for g in got]
    for i in range(len(w)):
        want = _scalar_passes(w[i], int(pos[i]))
        for f in (0, 3):
            assert bytes(got[f][i]) == want[f], (case, i, f)
        for f in (1, 2, 4, 5):
            assert int(got[f][i]) == int(want[f]), (case, i, f)
    if case == "saturating":
        corrected = td._phase_corrected_window(torch.from_numpy(w[:, :241]).to(torch.int32))
        assert (corrected == 65535).any()
    if case == "flat":
        assert got[1].all() and (got[0] == 0xFE).all()


def _bad_inputs():
    w = torch.zeros((4, 256), dtype=torch.int32)
    pos = torch.zeros(4, dtype=torch.int32)
    return {
        "int16_windows": (TypeError, w.to(torch.int16), pos),
        "int64_windows": (TypeError, w.to(torch.int64), pos),
        "int64_positions": (TypeError, w, pos.to(torch.int64)),
        "flat_windows": (TypeError, w.reshape(-1), pos),
        "short_windows": (TypeError, w[:, :240].contiguous(), pos),
        "positions_2d": (TypeError, w, pos[:, None]),
        "positions_too_few": (TypeError, w, pos[:3]),
        "strided_windows": (ValueError, torch.zeros((4, 512), dtype=torch.int32)[:, ::2], pos),
        "strided_positions": (ValueError, w, torch.zeros(8, dtype=torch.int32)[::2]),
    }


@pytest.mark.parametrize("case", list(_bad_inputs()))
def test_passes_wrapper_refuses_what_the_kernel_does_not_take(case):
    err, w, pos = _bad_inputs()[case]
    with pytest.raises(err):
        td.candidate_passes_window(w, pos)


@pytest.mark.parametrize("dtype", [torch.uint16, torch.int32])
def test_passes_wrapper_runs_the_plain_version_on_the_cpu(mags, dtype, monkeypatch):
    from dump1090_tpu_torch.ops import _cuda

    w, pos = _windows(mags, np.random.default_rng(2))
    wt = torch.from_numpy(w) if dtype == torch.uint16 else torch.from_numpy(w.astype(np.int32))

    def no_library():
        raise AssertionError("the CPU path reached the kernel library")

    monkeypatch.setattr(_cuda, "library", no_library)
    _cuda.reset_launches()
    got = td.candidate_passes_window(wt, torch.from_numpy(pos))
    want = td.candidate_passes_window_plain(wt, torch.from_numpy(pos))
    assert _cuda.launches["candidate_passes"] == 0
    for g, x in zip(got, want):
        assert g.device.type == "cpu" and torch.equal(g, x)
