"""The port's time-sharded decode (dump1090_tpu_torch/parallel/sharding.py,
ops.resolve.resolve_candidate_segments / demod_resolve_batch and
api.decode_capture_sharded) against the JAX package's, on the CPU: the JAX
side on conftest's 8 virtual CPU devices, the port on a Mesh of the CPU.
Inputs come from numpy seeds and utils/synth.py.  Tolerance: exact equality
(every output is integers or bytes)."""

import dataclasses
import io
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

import dump1090_tpu.api as japi
import dump1090_tpu_torch.api as tapi
from dump1090_tpu.models.decoder import DecoderConfig as JaxDecoderConfig
from dump1090_tpu.models.decoder import DecoderStats as JaxDecoderStats
from dump1090_tpu.models.decoder import IcaoCache as JaxIcaoCache
from dump1090_tpu.ops import resolve as jr
from dump1090_tpu.parallel import sharding as jsh
from dump1090_tpu_torch.constants import (
    BLOCK_SAMPLES,
    BUF_SAMPLES,
    FULL_LEN_SAMPLES,
    ICAO_CACHE_LEN,
    SCAN_POSITIONS,
)
from dump1090_tpu_torch.io.sources import iq_buffers
from dump1090_tpu_torch.models.decoder import DecoderConfig, DecoderStats, IcaoCache
from dump1090_tpu_torch.models.pipeline import DemodPipeline, PipelineConfig
from dump1090_tpu_torch.ops import resolve as tr
from dump1090_tpu_torch.ops.demod import demod_block
from dump1090_tpu_torch.ops.magnitude import magnitude_from_iq
from dump1090_tpu_torch.parallel import sharding as tsh
from dump1090_tpu_torch.utils.synth import envelope, make_df17_frame, planted_capture

NOW = 1_700_000_000
MODES = {
    "default": dict(),
    "aggressive": dict(aggressive=True),
    "nofix": dict(fix_errors=False),
}


def _jax_mesh(dp: int, sp: int) -> JaxMesh:
    return JaxMesh(np.array(jax.devices()[: dp * sp]).reshape(dp, sp), ("dp", "sp"))


def _cpu_mesh(dp: int, sp: int) -> tsh.Mesh:
    return tsh.Mesh([["cpu"] * sp for _ in range(dp)])


def _np(fields) -> list:
    return [np.asarray(f.numpy() if isinstance(f, torch.Tensor) else f) for f in fields]


def _buffer(offsets, seed: int, *, silent_until: int = 0) -> np.ndarray:
    """One reference buffer of uint8 IQ: Gaussian noise (sigma 2) with a
    clean DF17 frame at each sample offset, and silence (127) before
    `silent_until`."""
    rng = np.random.default_rng(seed)
    i = rng.normal(0, 2.0, BUF_SAMPLES)
    q = rng.normal(0, 2.0, BUF_SAMPLES)
    for k, off in enumerate(offsets):
        env = envelope(make_df17_frame(0x4D2023 + k, me_payload=rng.bytes(6)))
        i[off:off + 240] += 80 * np.cos(0.3) * env
        q[off:off + 240] += 80 * np.sin(0.3) * env
    i[:silent_until] = 0
    q[:silent_until] = 0
    iq = np.empty(2 * BUF_SAMPLES)
    iq[0::2], iq[1::2] = i, q
    return np.clip(np.round(iq) + 127, 0, 255).astype(np.uint8)


@pytest.fixture(scope="module")
def air():
    """Three blocks of dense planted air (150 frames a block, seed 1, the
    air of chip_smoke.py) and their reference buffers."""
    data, planted = planted_capture(3, 150, seed=1)
    return data, np.stack(list(iq_buffers(io.BytesIO(data))))


def _prefilled_caches(seed: int = 5):
    """The same pre-filled ICAO cache for both packages: fresh, expired and
    empty entries."""
    rng = np.random.default_rng(seed)
    addr = np.where(rng.random(ICAO_CACHE_LEN) < 0.3,
                    rng.integers(1, 1 << 24, ICAO_CACHE_LEN), 0).astype(np.uint32)
    ts = (NOW - rng.integers(0, 120, ICAO_CACHE_LEN)).astype(np.int64)
    caches = JaxIcaoCache(clock=lambda: NOW), IcaoCache(clock=lambda: NOW)
    for c in caches:
        c.addr[:] = addr
        c.ts[:] = ts
    return caches


def test_overlapping_buffers_equal_jax():
    rng = np.random.default_rng(0)
    stream = rng.integers(0, 256, 476 + 3 * 262144 + 1000, dtype=np.uint8)
    want = jsh.overlapping_buffers(stream)
    got = tsh.overlapping_buffers(stream)
    assert got.shape == want.shape == (3, BUF_SAMPLES * 2)
    np.testing.assert_array_equal(got, want)
    for mod in (jsh, tsh):
        with pytest.raises(ValueError, match="shorter than one buffer"):
            mod.overlapping_buffers(stream[: BUF_SAMPLES * 2 - 1])


@pytest.mark.parametrize("dp,sp,form", [(1, 8, "mag"), (1, 4, "mag"), (2, 4, "iq_tail")])
def test_time_sharded_candidates_equal_jax(air, dp, sp, form):
    """All 8 fields of the sharded candidates equal JAX's make_sharded_demod
    (global layout), and the merged stream equals an unsharded scan of the
    timeline extended by the tail (240 zeros without one)."""
    data, bufs = air
    if form == "mag":
        m = magnitude_from_iq(torch.from_numpy(bufs[0])).numpy()[: 8 * 16384]
        t = m.shape[0] // sp
        x, tail, ext = m[None], None, np.concatenate([m, np.zeros(FULL_LEN_SAMPLES, np.int32)])
        kw = dict(shard_samples=t, max_candidates=128)
        want = jsh.make_sharded_demod(_jax_mesh(dp, sp), **kw)(jnp.asarray(x))
        scan_total = sp * t
    else:  # the decode's form: IQ bytes, the buffer's real tail, a clipped scan
        t = -(-SCAN_POSITIONS // sp)
        width = 2 * (sp * t + tsh.HALO)
        full = np.full((dp, width), 127, np.uint8)
        full[:, : bufs.shape[1]] = bufs[:dp]
        x, tail = full[:, : 2 * sp * t], full[:, 2 * sp * t:]
        kw = dict(shard_samples=t, max_candidates=256, scan_total=SCAN_POSITIONS,
                  with_tail=True, from_iq=True)
        want = jsh.make_sharded_demod(_jax_mesh(dp, sp), **kw)(jnp.asarray(x), jnp.asarray(tail))
        scan_total = SCAN_POSITIONS
        ext = magnitude_from_iq(torch.from_numpy(bufs[0])).numpy()
    fn = tsh.make_sharded_demod(_cpu_mesh(dp, sp), **kw)
    got = fn(x) if tail is None else fn(x, tail)
    assert got.n.shape == (dp, sp) and got.pos.shape == (dp, sp * kw["max_candidates"])
    for name, g, w in zip(got._fields, _np(got), _np(jax.device_get(want))):
        np.testing.assert_array_equal(g, w, err_msg=name)

    n, merged = tsh.merge_sharded_candidates(got, scan_total=scan_total)
    ref = demod_block(torch.from_numpy(ext), scan_len=scan_total, max_candidates=1024)
    nref = int(ref.n)
    assert n == nref > 50
    for name in ("pos", "msg1", "errors1", "gate1", "msg2", "errors2", "gate2"):
        np.testing.assert_array_equal(getattr(merged, name),
                                      getattr(ref, name).numpy()[:nref], err_msg=name)


def test_boundary_straddling_preamble_found_once_by_the_left_shard():
    """A preamble across the first shard boundary (at T - 7) is found once,
    by the left shard through its right halo."""
    sp, t = 4, 4096
    m = np.zeros(sp * t, dtype=np.int32)
    p = t - 7
    for k in (0, 2, 7, 9):
        m[p + k] = 20000
    cand = tsh.make_sharded_demod(_cpu_mesh(1, sp), shard_samples=t, max_candidates=16)(m[None])
    assert cand.n.tolist() == [[1, 0, 0, 0]]
    n, merged = tsh.merge_sharded_candidates(cand, scan_total=sp * t)
    assert n == 1 and merged.pos.tolist() == [p]


def test_merges_raise_on_shard_overflow():
    mc = 4
    cand = tsh.make_sharded_demod(_cpu_mesh(2, 2), shard_samples=64, max_candidates=mc)(
        np.zeros((2, 128), np.int32))
    cand = cand._replace(n=torch.tensor([[0, 1], [mc + 1, 0]], dtype=torch.int32))
    assert tsh.merge_sharded_candidates(cand, scan_total=128, row=0)[0] == 1
    with pytest.raises(OverflowError, match="max_candidates 4"):
        tsh.merge_sharded_candidates(cand, scan_total=128, row=1)
    with pytest.raises(OverflowError, match="candidate overflow"):
        tsh.merge_sharded_rows(cand, scan_total=128)


def _segments(rows: np.ndarray, sp: int, mc: int):
    """The sharded candidates of uint8 IQ buffers (dp, bytes) as the device
    resolve's segments: (S, mc) fields, nseg and row_id, numpy."""
    dp = rows.shape[0]
    t = -(-SCAN_POSITIONS // sp)
    full = np.full((dp, 2 * (sp * t + tsh.HALO)), 127, np.uint8)
    full[:, : rows.shape[1]] = rows
    fn = tsh.make_sharded_demod(_cpu_mesh(dp, sp), shard_samples=t, max_candidates=mc,
                                scan_total=SCAN_POSITIONS, with_tail=True, from_iq=True)
    cand = fn(full[:, : 2 * sp * t], full[:, 2 * sp * t:])
    s_n = dp * sp
    fields = [f.reshape((s_n, mc) + tuple(f.shape[2:])) for f in _np(cand[1:])]
    return fields, cand.n.numpy().reshape(s_n), np.repeat(np.arange(dp, dtype=np.int32), sp)


SKIP_T = 32768  # a shard of the sp = 4 decode


@pytest.fixture(scope="module")
def streams(air):
    """Three candidate-segment streams at full buffer width, sp = 4:
    silent: one row whose first two shards are silence;
    skip: one row with a clean frame 60 samples before each shard boundary,
        whose skip covers a candidate of the next shard;
    rows: a 2-row mesh, dense air then the silent row."""
    _, bufs = air
    silent = _buffer([2 * SKIP_T + 1000 + 900 * k for k in range(20)], 3,
                     silent_until=2 * SKIP_T + 500)
    skip = _buffer([k * SKIP_T - 60 for k in (1, 2, 3)], 0)
    return {"silent": silent[None], "skip": skip[None], "rows": np.stack([bufs[1], silent])}


@pytest.mark.parametrize("name", ["silent", "skip", "rows"])
@pytest.mark.parametrize("mode", ["default", "aggressive"])
def test_resolve_candidate_segments_equal_jax(streams, name, mode):
    rows = streams[name]
    mc = 256
    fields, nseg, row_id = _segments(rows, 4, mc)
    jc, tc = _prefilled_caches()
    ca = tc.addr.astype(np.int64).astype(np.int32)
    ct = tc.ts.astype(np.int32)
    agg = mode == "aggressive"
    kw = dict(n_rows=rows.shape[0], max_out=2048, crcok_only=False)
    want = jax.device_get(jr.resolve_candidate_segments(
        *map(jnp.asarray, fields), jnp.asarray(nseg), jnp.asarray(row_id), jnp.asarray(ca),
        jnp.asarray(ct), NOW, True, agg, **kw))
    got = tr.resolve_candidate_segments(
        *map(torch.from_numpy, fields), torch.from_numpy(nseg), torch.from_numpy(row_id),
        torch.from_numpy(ca), torch.from_numpy(ct), NOW, True, agg, **kw)
    for k, (g, w) in enumerate(zip(_np(got), _np(want))):
        np.testing.assert_array_equal(g, w, err_msg=f"output {k}")
    count = int(got[0])
    assert count > 0
    # the same buffers through the unsharded device resolve (skip reset per
    # buffer, the cache chained): the same emissions, counters and cache
    one = tr.demod_resolve_batch(
        torch.from_numpy(rows), torch.from_numpy(ca), torch.from_numpy(ct), NOW, True, agg,
        scan_len=SCAN_POSITIONS, max_candidates=mc, max_out=2048, crcok_only=False)
    assert int(one[1]) == count
    np.testing.assert_array_equal(one[2][:count].numpy(), got[1][:count].numpy())
    np.testing.assert_array_equal(one[3][:count].numpy(), got[2][:count].numpy())
    for k in (4, 5, 6):
        np.testing.assert_array_equal(one[k].numpy(), got[k - 1].numpy())
    emitted_pos = set((got[2][:count].numpy() >> tr.META_POS_SHIFT).tolist())
    if name in ("silent", "rows"):
        assert nseg[-4:-2].tolist() == [0, 0] and nseg[-2:].min() > 0
    if name == "skip":
        # a clean frame at T - 60 is emitted, and its skip (to T + 181)
        # covers the first candidates of the next shard: they never run
        pos = fields[0]
        for k in (1, 2, 3):
            assert k * SKIP_T - 60 in emitted_pos
            covered = [p for p in pos[k].tolist() if k * SKIP_T <= p < k * SKIP_T + 181]
            if k > 1:
                assert covered, k
            assert not set(covered) & emitted_pos
        assert int(got[3][0]) < int(nseg.sum())  # valid_preamble: covered ones did not run


@pytest.mark.parametrize("crcok_only,packed", [(False, False), (True, False), (True, True),
                                               (False, True)])
def test_demod_resolve_batch_equal_jax(air, crcok_only, packed):
    data, _ = air
    stream = np.concatenate([np.full(476, 127, np.uint8), np.frombuffer(data, np.uint8)] * 3)
    bufs = np.ascontiguousarray(tsh.overlapping_buffers(stream)[:8])
    assert bufs.shape[0] == 8
    jc, tc = _prefilled_caches()
    ca = tc.addr.astype(np.int64).astype(np.int32)
    ct = tc.ts.astype(np.int32)
    kw = dict(scan_len=SCAN_POSITIONS, max_candidates=256, crcok_only=crcok_only, packed=packed)
    kw.update(dict(max_out_short=2048, max_out_long=2048) if packed else dict(max_out=4096))
    want = jax.device_get(jr.demod_resolve_batch(
        jnp.asarray(bufs), jnp.asarray(ca), jnp.asarray(ct), NOW, True, False, **kw))
    got = tr.demod_resolve_batch(torch.from_numpy(bufs), torch.from_numpy(ca),
                                 torch.from_numpy(ct), NOW, True, False, **kw)
    assert len(got) == len(want) and int(got[1]) > 1000
    for k, (g, w) in enumerate(zip(_np(got), _np(want))):
        np.testing.assert_array_equal(g, w, err_msg=f"output {k}")


def test_demod_resolve_batch_refuses_packed_with_bad_crc(air):
    """The packed emission with bad-CRC decodes is no longer refused: as in
    the JAX package, demod_resolve_batch(packed=True, crcok_only=False)
    packs every attempted decode.  With caps that both overflow, the exact
    counts and the rows up to each cap are JAX's."""
    _, bufs = air
    bufs = np.ascontiguousarray(bufs[:2])
    z = np.zeros(ICAO_CACHE_LEN, np.int32)
    kw = dict(scan_len=SCAN_POSITIONS, max_candidates=256, crcok_only=False, packed=True,
              max_out_short=8, max_out_long=16)
    want = jax.device_get(jr.demod_resolve_batch(
        jnp.asarray(bufs), jnp.asarray(z), jnp.asarray(z), NOW, True, False, **kw))
    got = tr.demod_resolve_batch(torch.from_numpy(bufs), torch.from_numpy(z),
                                 torch.from_numpy(z), NOW, True, False, **kw)
    for k, (g, w) in enumerate(zip(_np(got), _np(want))):
        np.testing.assert_array_equal(g, w, err_msg=f"output {k}")
    count, clong = int(got[1]), int(got[2])
    assert count - clong > 8 and clong > 16
    good = tr.demod_resolve_batch(torch.from_numpy(bufs), torch.from_numpy(z),
                                  torch.from_numpy(z), NOW, True, False,
                                  **dict(kw, crcok_only=True))
    assert count > int(good[1])


def test_device_mesh_defaults(monkeypatch):
    mesh = tsh.device_mesh(4, "cpu")
    assert mesh.shape == {"dp": 1, "sp": 4} and not mesh.multiprocess
    assert tsh.device_mesh(None, "cpu").shape == {"dp": 1, "sp": 1}
    with pytest.raises(ValueError, match="sp >= 1"):
        tsh.device_mesh(0, "cpu")
    # CUDA: the visible cards, dp = cards // sp, and fewer cards than sp raise
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    mesh = tsh.device_mesh(4)
    assert mesh.shape == {"dp": 2, "sp": 4}
    assert [[d.index for d in row] for row in mesh.devices] == [[0, 1, 2, 3], [4, 5, 6, 7]]
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="over 4 shards needs 4 CUDA devices, but 1 is visible"):
        tsh.device_mesh(4, "cuda")
    with pytest.raises(ValueError, match="needs 4 CUDA devices"):
        tapi.decode_capture_sharded(b"\x7f" * 1000, sp=4)
