"""Plain version of the port's window gather (gather_windows_plain, and the
wrapper on CPU tensors) against the JAX package's Pallas kernel in
interpret mode and its XLA reference.  Exact equality."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dump1090_tpu.ops.gather import CHUNK, gather_windows, gather_windows_xla
from dump1090_tpu_torch.ops.gather import (
    WINDOW_PAD,
    gather_windows as port_gather,
    gather_windows_plain,
)


def _inputs(seed, b, mc, s_pad=8 * 1024):
    rng = np.random.default_rng(seed)
    m_pad = rng.integers(0, 65168, (b, s_pad), dtype=np.uint16)
    max_pos = s_pad - WINDOW_PAD - 2048
    pos = np.sort(rng.integers(0, max_pos, (b, mc)), axis=1).astype(np.int32)
    return m_pad, pos


@pytest.mark.parametrize("mc", [CHUNK, 64, 24])  # incl. non-multiple of 16
def test_plain_gather_matches_pallas_interpret_and_xla(mc):
    m_pad, pos = _inputs(0, 3, mc)
    want = np.asarray(gather_windows(jnp.asarray(m_pad), jnp.asarray(pos), interpret=True))
    want_xla = np.asarray(gather_windows_xla(jnp.asarray(m_pad), jnp.asarray(pos)))
    got = gather_windows_plain(torch.from_numpy(m_pad), torch.from_numpy(pos))
    assert got.dtype == torch.uint16 and tuple(got.shape) == (3, mc, WINDOW_PAD)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), want_xla)
    # the wrapper takes the plain version for a CPU tensor
    np.testing.assert_array_equal(
        port_gather(torch.from_numpy(m_pad), torch.from_numpy(pos)).numpy(), want
    )


def test_plain_gather_edge_positions():
    """Window starts at 0, lane boundaries, 8-row edges and the largest
    allowed start (tests/test_gather.py's edge set), with MC = 11."""
    m_pad, _ = _inputs(1, 1, 1)
    max_pos = m_pad.shape[1] - WINDOW_PAD - 2048
    edges = [0, 1, 127, 128, 129, 1023, 1024, 1025, 2047, 2048, max_pos - 1]
    pos = np.array([edges], dtype=np.int32)
    got = gather_windows_plain(torch.from_numpy(m_pad), torch.from_numpy(pos)).numpy()
    for k, p in enumerate(edges):
        np.testing.assert_array_equal(got[0, k], m_pad[0, p : p + WINDOW_PAD])
    pos16 = np.sort(np.array(edges + [5] * (CHUNK - len(edges)), np.int32))[None]
    want = np.asarray(gather_windows(jnp.asarray(m_pad), jnp.asarray(pos16), interpret=True))
    got16 = gather_windows_plain(torch.from_numpy(m_pad), torch.from_numpy(pos16)).numpy()
    np.testing.assert_array_equal(got16, want)


def test_gather_wrapper_rejects_bad_inputs():
    m_pad, pos = _inputs(2, 2, 16)
    with pytest.raises(TypeError):
        port_gather(torch.from_numpy(m_pad.astype(np.int32)), torch.from_numpy(pos))
    with pytest.raises(TypeError):
        port_gather(torch.from_numpy(m_pad), torch.from_numpy(pos.astype(np.int64)))
    with pytest.raises(ValueError):
        port_gather(torch.from_numpy(m_pad)[:, ::2], torch.from_numpy(pos))


# ---- K1 from the magnitudes (gather_row_windows): both geometries ------------

from jax import lax  # noqa: E402

from dump1090_tpu.ops.demod import gather_candidate_windows as jax_candidate_windows  # noqa: E402
from dump1090_tpu_torch.ops.demod import gather_candidate_windows  # noqa: E402
from dump1090_tpu_torch.ops.gather import (  # noqa: E402
    gather_row_windows,
    gather_row_windows_plain,
)

S = 2000                      # samples a row (the file path's geometry, narrowed)
SCAN = S - 240                # scan_len: the empty slots' padding
T = 1024                      # a shard's owned samples (the sharded geometry)
S_PAD = -(-(S + 1 + 2048 + WINDOW_PAD) // 1024) * 1024   # 5120, as JAX pads
S_PAD_SHARD = -(-(T + WINDOW_PAD) // 1024) * 1024         # 2048
IN_RANGE = [0, 1, 2, 127, 128, 1023, 1024, SCAN - 1, SCAN]


def _magnitudes(seed, s=S, b=3):
    """Seeded int32 magnitudes up to 65,167, with values on both sides of
    int16's range at the head of every row."""
    m = np.random.default_rng(seed).integers(0, 65168, (b, s), dtype=np.int32)
    m[:, :4] = [32767, 32768, 65167, 40000]
    return m


def _positions(seed, mc, top, b=3):
    rng = np.random.default_rng(seed)
    return np.sort(rng.integers(0, top + 1, (b, mc)), axis=1).astype(np.int32)


def _formula(m, pos, lead, s_pad):
    """The fused gather written out in numpy: p = clamp(pos, 0, s_pad-256),
    out[j] = low 16 bits of m[p + j - lead] inside the row, else 0."""
    b, s = m.shape
    out = np.zeros(pos.shape + (WINDOW_PAD,), np.uint16)
    for r in range(b):
        for k, p in enumerate(pos[r]):
            src = min(max(int(p), 0), s_pad - WINDOW_PAD) + np.arange(WINDOW_PAD) - lead
            ok = (src >= 0) & (src < s)
            out[r, k, ok] = m[r, src[ok]].astype(np.uint16)
    return out


def _jax_padded(m, lead, s_pad):
    pad = np.zeros((m.shape[0], s_pad), np.uint16)
    pad[:, lead:lead + m.shape[1]] = m.astype(np.uint16)
    return pad


@pytest.mark.parametrize("dtype", [np.int32, np.uint16])
@pytest.mark.parametrize("mc", [16, 24])
def test_fused_gather_matches_jax_candidate_windows(mc, dtype):
    """The file path's geometry (lead 1): the port's gather_candidate_windows
    (the plain version on the CPU) equals JAX's gather_candidate_windows
    (XLA) and JAX's Pallas kernel in interpret mode on JAX's padded rows, at
    pos 0, the empty slots' scan_len and the other in-range edges."""
    m = _magnitudes(mc).astype(dtype)
    pos = _positions(mc, mc, SCAN)
    pos[0, : len(IN_RANGE)] = IN_RANGE
    pos[1, -4:] = SCAN  # empty slots
    want = np.asarray(jax_candidate_windows(jnp.asarray(m), jnp.asarray(pos), pallas=False))
    pallas = np.asarray(gather_windows(jnp.asarray(_jax_padded(m, 1, S_PAD)), jnp.asarray(pos),
                                       interpret=True))
    got = gather_candidate_windows(torch.from_numpy(m), torch.from_numpy(pos))
    assert got.dtype == torch.uint16 and tuple(got.shape) == (3, mc, WINDOW_PAD)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), pallas)
    np.testing.assert_array_equal(got.numpy(), _formula(m, pos, 1, S_PAD))


def test_fused_gather_clamped_positions_match_jax():
    """Starts past s_pad - 256 (clamped there, zeros past the row) in the
    last row, where JAX's gather over the flattened batch clamps as the
    port clamps per row: equal to JAX's gather_candidate_windows (XLA).
    (JAX's dynamic slice counts a negative start from the end of the
    batch; the port clamps it to 0 as its two-step path did, which
    test_fused_plain_equals_formula_and_two_step_at_every_edge holds.)"""
    m = _magnitudes(5)
    pos = _positions(5, 16, SCAN)
    pos[2, -5:] = [S, S_PAD - WINDOW_PAD - 1, S_PAD - WINDOW_PAD, S_PAD - 1, 2**30]
    want = np.asarray(jax_candidate_windows(jnp.asarray(m), jnp.asarray(pos), pallas=False))
    got = gather_candidate_windows(torch.from_numpy(m), torch.from_numpy(pos)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[2, -3:], 0)  # wholly past the row


@pytest.mark.parametrize("mc", [16, 40])
def test_fused_gather_shard_geometry_matches_jax(mc):
    """The sharded body's geometry (lead 0 on the extended row 1 + T + 240):
    the first 241 samples equal JAX's per-shard dynamic slice of the row,
    and all 256 equal JAX's gather over the row zero-padded to s_pad, for
    positions 0..T (T: the empty slots)."""
    m_ext = _magnitudes(mc, s=1 + T + 240)
    pos = _positions(mc, mc, T)
    pos[0, :4] = [0, 1, T - 1, T]
    got = gather_row_windows(torch.from_numpy(m_ext), torch.from_numpy(pos), lead=0,
                             s_pad=S_PAD_SHARD).numpy()
    m_u16 = jnp.asarray(m_ext.astype(np.uint16))
    for r in range(m_ext.shape[0]):
        want241 = np.asarray(jax.vmap(lambda p, r=r: lax.dynamic_slice_in_dim(m_u16[r], p, 241))(
            jnp.asarray(pos[r])))
        np.testing.assert_array_equal(got[r, :, :241], want241)
    want = np.asarray(gather_windows_xla(jnp.asarray(_jax_padded(m_ext, 0, S_PAD_SHARD)),
                                         jnp.asarray(pos)))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", [np.int32, np.uint16])
@pytest.mark.parametrize("lead,s,s_pad", [(1, S, S_PAD), (0, 1 + T + 240, S_PAD_SHARD)])
def test_fused_plain_equals_formula_and_two_step_at_every_edge(lead, s, s_pad, dtype):
    """Every row gets the edge positions (0, negative, at and past
    s_pad - 256, far past): the plain version equals the numpy formula and
    the old two-step path (zero-padded uint16 rows, then the gather on
    them), at both geometries, from int32 magnitudes and from uint16 rows."""
    m = _magnitudes(s + lead, s=s).astype(dtype)
    pos = _positions(s, 24, s - 240)
    pos[:, :9] = [0, 1, -1, -700, s - 240, s_pad - WINDOW_PAD, s_pad - WINDOW_PAD + 1,
                  s_pad - 1, 2**31 - 1]
    got = gather_row_windows_plain(torch.from_numpy(m), torch.from_numpy(pos), lead=lead,
                                   s_pad=s_pad).numpy()
    np.testing.assert_array_equal(got, _formula(m, pos, lead, s_pad))
    two_step = gather_windows_plain(torch.from_numpy(_jax_padded(m, lead, s_pad)),
                                    torch.from_numpy(pos)).numpy()
    np.testing.assert_array_equal(got, two_step)


def test_row_gather_wrapper_rejects_bad_inputs():
    m = torch.from_numpy(_magnitudes(3))
    pos = torch.from_numpy(_positions(3, 16, SCAN))
    with pytest.raises(TypeError):
        gather_row_windows(m.to(torch.int64), pos, lead=1, s_pad=S_PAD)
    with pytest.raises(TypeError):
        gather_row_windows(m, pos.to(torch.int64), lead=1, s_pad=S_PAD)
    with pytest.raises(TypeError):
        gather_row_windows(m[:2], pos, lead=1, s_pad=S_PAD)
    with pytest.raises(ValueError):
        gather_row_windows(m[:, ::2], pos, lead=1, s_pad=S_PAD)
    # a CPU tensor takes the plain version
    np.testing.assert_array_equal(
        gather_row_windows(m, pos, lead=1, s_pad=S_PAD).numpy(),
        gather_row_windows_plain(m, pos, lead=1, s_pad=S_PAD).numpy())
