"""The port's five preamble-scan formulations (dump1090_tpu_torch/ops/demod.py:
mask, packed, packed-mxu, packed-plain, packed-plain-mxu) against the JAX
package's, on the CPU with the same numpy inputs, bit for bit with no
tolerance: front_candidates at each of the three compaction levels of
compact_positions_from_bytes, demod_batch, compact_positions_from_bytes and
preamble_bytes themselves, and an unknown name refused by both packages.

The rows (4,339 samples, so 4,099 scan positions: not a multiple of 8, and
65 supergroups of 513 groups) are planted air, pure noise, an all-127 row
(no signal) and a row of a preamble every 15 samples (274 hits, more than
the first two levels' max_candidates)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dump1090_tpu.ops import demod as jd
from dump1090_tpu.parallel.sharding import demod_batch as jax_demod_batch
from dump1090_tpu_torch.constants import FULL_LEN_SAMPLES
from dump1090_tpu_torch.ops import demod as td
from dump1090_tpu_torch.ops.magnitude import magnitude_from_iq
from dump1090_tpu_torch.utils.synth import planted_capture

S = 4339
SCAN = S - FULL_LEN_SAMPLES  # 4099
# one max_candidates per level: <= 65 supergroups, <= 513 groups, flat
LEVELS = {"supergroups": 32, "groups": 256, "flat": 600}
FRONTS = ["mask", "packed", "packed-mxu", "packed-plain", "packed-plain-mxu"]


def _dense_row() -> np.ndarray:
    """IQ bytes with the preamble's pulses (samples 0, 2, 7, 9 high, the
    rest of 0..14 low) every 15 samples: a hit at each pulse start."""
    i = np.full(S, 127, np.uint8)
    for j in range(0, SCAN, 15):
        i[[j, j + 2, j + 7, j + 9]] = 227
    iq = np.full(2 * S, 127, np.uint8)
    iq[0::2] = i
    return iq


@pytest.fixture(scope="module")
def iq():
    data, _ = planted_capture(1, 150, seed=13, noise_sigma=3.0)
    planted = np.frombuffer(data, np.uint8)[: 2 * S]
    # uniform noise passes the predicate rarely: this seed's row holds 2 hits
    noise = np.random.default_rng(8).integers(0, 256, 2 * S, dtype=np.uint8)
    silent = np.full(2 * S, 127, np.uint8)
    return np.stack([planted, noise, silent, _dense_row()])


@pytest.fixture(scope="module")
def mags(iq):
    return magnitude_from_iq(torch.from_numpy(iq)).numpy()


@pytest.mark.parametrize("level", list(LEVELS))
@pytest.mark.parametrize("front", FRONTS)
def test_front_candidates_match_jax(mags, front, level):
    mc = LEVELS[level]
    n_j, pos_j = jd.front_candidates(jnp.asarray(mags), SCAN, mc, front)
    n_t, pos_t = td.front_candidates(torch.from_numpy(mags), SCAN, mc, front)
    assert n_t.dtype == pos_t.dtype == torch.int32 and pos_t.shape == (4, mc)
    np.testing.assert_array_equal(n_t.numpy(), np.asarray(n_j))
    np.testing.assert_array_equal(pos_t.numpy(), np.asarray(pos_j))
    n = n_t.tolist()
    assert n[0] > 0 and n[1] > 0 and n[2] == 0 and n[3] == 274
    if level != "flat":
        assert n[3] > mc  # the overflowing row really ran
    # and the mask form's positions, whatever the formulation
    _, pos_mask = td.front_candidates(torch.from_numpy(mags), SCAN, mc, "mask")
    assert torch.equal(pos_t, pos_mask)


@pytest.mark.parametrize("front", FRONTS)
def test_demod_batch_matches_jax(iq, front):
    mc = LEVELS["supergroups"]
    want = jax_demod_batch(jnp.asarray(iq), scan_len=SCAN, max_candidates=mc, front=front)
    got = td.demod_batch(torch.from_numpy(iq), scan_len=SCAN, max_candidates=mc, front=front)
    for name, a, b in zip(got._fields, got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
    assert int(got.n[3]) > mc and got.gate1.any()


@pytest.mark.parametrize("level", list(LEVELS))
def test_compact_positions_from_bytes_matches_jax(level):
    """Packed group bytes straight in, with full (255) bytes, empty rows and
    rows of fewer hits than max_candidates."""
    mc = LEVELS[level]
    n_grp = -(-SCAN // 8)
    rng = np.random.default_rng(17)
    byte = rng.integers(0, 256, (5, n_grp)).astype(np.int32)
    byte[0] = 255
    byte[1] = 0
    byte[2] *= rng.random(n_grp) < 0.02   # sparse: fewer hits than mc
    byte[3, ::7] = 255
    byte[4, -1] = 255                     # bits past scan_len are dropped
    want = jax.vmap(lambda r: jd.compact_positions_from_bytes(r, mc, SCAN))(jnp.asarray(byte))
    got = td.compact_positions_from_bytes(torch.from_numpy(byte), mc, SCAN)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got[1] == SCAN).all() and got[0, :8].tolist() == list(range(8))


@pytest.mark.parametrize("mxu", [False, True])
@pytest.mark.parametrize("algebra", [True, False])
def test_preamble_bytes_matches_jax(mags, algebra, mxu):
    want = jax.vmap(lambda r: jd.preamble_bytes(r, SCAN, algebra=algebra, mxu=mxu))(
        jnp.asarray(mags))
    got = td.preamble_bytes(torch.from_numpy(mags), SCAN, algebra=algebra, mxu=mxu)
    assert got.dtype == torch.int32 and got.shape == (4, -(-SCAN // 8))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    short = mags[:, : -(-SCAN // 8) * 8 + 16]
    with pytest.raises(ValueError, match="cannot cover"):
        td.preamble_bytes(torch.from_numpy(short), SCAN, algebra=algebra, mxu=mxu)
    with pytest.raises(ValueError, match="cannot cover"):
        jd.preamble_bytes(jnp.asarray(short[0]), SCAN, algebra=algebra, mxu=mxu)


@pytest.mark.parametrize("mxu", [False, True])
def test_pack_bits_is_exact_up_to_255(mxu):
    """A row of eight set bits packs to 255 by either route (the predicate
    never sets two neighbours, so preamble_bytes alone cannot reach it)."""
    rng = np.random.default_rng(19)
    bits = rng.random((3, 64, 8)) < 0.5
    bits[0] = True
    bits[1] = False
    got = td.pack_bits(torch.from_numpy(bits), mxu=mxu)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.packbits(bits, axis=-1)[..., 0])
    assert (got[0] == 255).all() and (got[1] == 0).all()


@pytest.mark.parametrize("front", ["bogus", "packed-fast", "mask-mxu", "packed-"])
def test_unknown_front_is_refused_by_both_packages(mags, front, monkeypatch):
    with pytest.raises(ValueError, match="unknown demod front variant"):
        td.front_candidates(torch.from_numpy(mags), SCAN, 32, front)
    with pytest.raises(ValueError, match="unknown demod front variant"):
        jd.front_candidates(jnp.asarray(mags), SCAN, 32, front)
    from dump1090_tpu_torch.models.pipeline import DemodPipeline, PipelineConfig

    with pytest.raises(ValueError, match="unknown demod front variant"):
        DemodPipeline(PipelineConfig(front=front), device="cpu")
    monkeypatch.setenv("DUMP1090_TPU_FRONT", front)
    with pytest.raises(ValueError, match="unknown demod front variant"):
        DemodPipeline(PipelineConfig(), device="cpu")


def test_default_front_is_mask_unless_the_environment_names_one(monkeypatch):
    from dump1090_tpu_torch.models.pipeline import DemodPipeline, PipelineConfig

    monkeypatch.delenv("DUMP1090_TPU_FRONT", raising=False)
    assert td.front_variant() == "mask"
    assert DemodPipeline(PipelineConfig(), device="cpu")._front == "mask"
    monkeypatch.setenv("DUMP1090_TPU_FRONT", "packed-mxu")
    assert td.front_variant() == "packed-mxu"
    assert DemodPipeline(PipelineConfig(), device="cpu")._front == "packed-mxu"
    # a name passed down wins over the environment
    assert DemodPipeline(PipelineConfig(front="packed-plain"), device="cpu")._front == \
        "packed-plain"
