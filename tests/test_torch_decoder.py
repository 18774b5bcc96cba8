"""The port's stateless message decode (models/decoder.py) and host
syndromes (ops/crc.py batch_syndromes) against the JAX package: every
Downlink Format, DF17 metypes 1-19, velocity subtypes 1-4 with headings in
every quadrant, both frame lengths, random meta words.  Exact equality."""

import dataclasses

import numpy as np

import dump1090_tpu.models.decoder as jd
import dump1090_tpu.ops.crc as jcrc
import dump1090_tpu_torch.models.decoder as td
import dump1090_tpu_torch.ops.crc as tcrc
from dump1090_tpu_torch.ops import resolve as tr


def _frames_and_meta(seed=0):
    rng = np.random.default_rng(seed)
    rows = []
    for df in range(32):  # every Downlink Format, a few frames each
        for _ in range(4):
            f = rng.integers(0, 256, 14, dtype=np.uint8)
            f[0] = (df << 3) | (f[0] & 7)
            rows.append(f)
    for metype in range(1, 20):  # DF17 ME types, incl. every velocity subtype
        for mesub in range(8):
            for _ in range(3):
                f = rng.integers(0, 256, 14, dtype=np.uint8)
                f[0] = (17 << 3) | 5
                f[4] = (metype << 3) | mesub
                rows.append(f)
    msgs = np.stack(rows)
    n = msgs.shape[0]
    df = msgs[:, 0] >> 3
    is_long = (df >= 16) & (df <= 21)
    msgs[~is_long, 7:] = 0  # short frames arrive zero-padded
    errbit = rng.integers(-1, 112, n)
    meta = (
        rng.integers(0, 2, n) * tr.META_CRCOK
        + rng.integers(0, 2, n) * tr.META_PHASE
        + is_long * tr.META_LONG
        + rng.integers(0, 2, n) * tr.META_PASS
        + ((errbit + 1) << tr.META_ERRBIT_SHIFT)
        + (rng.integers(0, 131070, n) << tr.META_POS_SHIFT)
    ).astype(np.int32)
    return msgs, meta


def test_batch_syndromes_match_jax():
    msgs, _ = _frames_and_meta(1)
    for bits in (56, 112):
        np.testing.assert_array_equal(
            tcrc.batch_syndromes(msgs, bits), jcrc.batch_syndromes(msgs, bits)
        )


def test_messages_from_device_arrays_match_jax():
    msgs, meta = _frames_and_meta(2)
    got = td.messages_from_device_arrays(msgs, meta)
    want = jd.messages_from_device_arrays(msgs, meta)
    assert len(got) == len(want) == msgs.shape[0]
    for g, w in zip(got, want):
        assert dataclasses.asdict(g) == dataclasses.asdict(w)
        assert (g.addr, g.hexaddr) == (w.addr, w.hexaddr)
    assert td.messages_from_device_arrays(msgs[:0], meta[:0]) == []
    # the decode really reached the branches: velocity with headings past
    # 180 degrees, identities, surface movement, IID acceptances
    assert any(m.metype == 19 and m.mesub in (1, 2) and m.heading > 180 for m in got)
    assert any(m.metype == 19 and m.mesub in (3, 4) and m.heading for m in got)
    assert any(m.flight for m in got) and any(m.movement_valid for m in got)
    assert any(m.iid for m in got) and any(m.unit == td.UNIT_METERS for m in got)
    assert [f.name for f in dataclasses.fields(td.ModesMessage)] == \
        [f.name for f in dataclasses.fields(jd.ModesMessage)]


def test_field_helpers_match_jax():
    rng = np.random.default_rng(3)
    for f in rng.integers(0, 256, (2000, 14), dtype=np.uint8):
        assert td.decode_ac13_field(f) == jd.decode_ac13_field(f)
        assert td.decode_ac12_field(f) == jd.decode_ac12_field(f)
    for mv in range(128):
        assert td.decode_movement_field(mv) == jd.decode_movement_field(mv)
