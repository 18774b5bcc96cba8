"""Plain version of the port's window gather (gather_windows_plain, and the
wrapper on CPU tensors) against the JAX package's Pallas kernel in
interpret mode and its XLA reference.  Exact equality."""

import numpy as np
import pytest
import torch

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
