"""Port's magnitude stage (dump1090_tpu_torch/ops/magnitude.py) against the
reference LUT and the JAX package, on the CPU.  Exact equality: the
computation is integer (contract: dump1090.c:346-364, 1452-1469)."""

import numpy as np
import torch

import jax.numpy as jnp

from dump1090_tpu.ops.magnitude import magnitude_from_pairs as jax_from_pairs
from dump1090_tpu_torch.ops.magnitude import (
    magnitude_from_iq,
    magnitude_from_pairs,
    reference_maglut,
)


def test_all_129x129_pairs_match_reference_lut():
    """Every (|I-127|, |Q-127|) in 0..128 x 0..128 equals the reference's
    maglut entry, through both the byte and the pair entry."""
    i, q = np.meshgrid(np.arange(127, 256), np.arange(127, 256), indexing="ij")
    iq = np.stack([i.ravel(), q.ravel()], axis=1).astype(np.uint8).reshape(-1)
    m = magnitude_from_iq(torch.from_numpy(iq)).numpy()
    lut = reference_maglut()
    assert m.dtype == np.int32
    np.testing.assert_array_equal(m, lut[i.ravel() - 127, q.ravel() - 127])
    pairs = torch.from_numpy(iq.view("<u2").copy())
    np.testing.assert_array_equal(magnitude_from_pairs(pairs).numpy(), m)
    assert lut.max() == 65167


def test_random_pairs_match_jax():
    rng = np.random.default_rng(0)
    pairs = rng.integers(0, 1 << 16, (4, 5000), dtype=np.uint16)
    want = np.asarray(jax_from_pairs(jnp.asarray(pairs)))
    got = magnitude_from_pairs(torch.from_numpy(pairs)).numpy()
    np.testing.assert_array_equal(got, want)
    got_iq = magnitude_from_iq(torch.from_numpy(pairs.view(np.uint8))).numpy()
    np.testing.assert_array_equal(got_iq, want)
