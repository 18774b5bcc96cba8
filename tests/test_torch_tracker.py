"""The port's aircraft tracker (models/tracker.py) against the JAX
package: seeded mixed traffic, decoded by each package, goes through each
package's tracker on the same frozen clocks (seconds and milliseconds); the
aircraft table (reverse-insertion order, every field, CPR latches and
positions), the auto reference position and stale eviction must be equal
after every message."""

import dataclasses

import pytest

import dump1090_tpu.models.decoder as jd
import dump1090_tpu.models.tracker as jt
import dump1090_tpu_torch.models.decoder as td
import dump1090_tpu_torch.models.tracker as tt
from dump1090_tpu_torch.utils.synth import traffic_frames

NOW = 1_700_000_000


def _clocks():
    t = {"s": NOW, "ms": NOW * 1000}
    return t, dict(clock=lambda: t["s"], msclock=lambda: t["ms"])


def _assert_same(a, b):
    assert [dataclasses.asdict(x) for x in a.aircraft] == [dataclasses.asdict(x) for x in b.aircraft]
    assert (a.ref_lat, a.ref_lon, a.ref_count) == (b.ref_lat, b.ref_lon, b.ref_count)
    assert sorted(a._by_addr) == sorted(b._by_addr)


@pytest.mark.parametrize("check_crc", [True, False])
def test_tracker_matches_jax(check_crc):
    t, clocks = _clocks()
    tr_t = tt.AircraftTracker(interactive_ttl=20, **clocks)
    tr_j = jt.AircraftTracker(interactive_ttl=20, **clocks)
    tc, jc = td.IcaoCache(clock=lambda: t["s"]), jd.IcaoCache(clock=lambda: t["s"])
    n_pos = n_surface = 0
    for k, (f, _) in enumerate(traffic_frames(21, 1200, flip_weights=(0.85, 0.1, 0.05))):
        t["ms"] += 400 if k % 50 else 12_000  # now and then a pair drifts past 10 s
        if k % 10 == 0:
            t["s"] += 1
        mt = td.decode_message(f, tc, td.DecoderConfig())
        mj = jd.decode_message(f, jc, jd.DecoderConfig())
        a = tr_t.receive(mt, check_crc=check_crc)
        b = tr_j.receive(mj, check_crc=check_crc)
        assert (a is None) == (b is None)
        if a is not None:
            assert dataclasses.asdict(a) == dataclasses.asdict(b)
            n_pos += mt.msgtype == 17 and 9 <= mt.metype <= 18 and a.lat != 0
            n_surface += mt.msgtype == 17 and 5 <= mt.metype <= 8 and a.lat != 0
        if k % 97 == 0:
            _assert_same(tr_t, tr_j)
        if k == 600:
            t["s"] += 15  # some aircraft go stale
            tr_t.remove_stale()
            tr_j.remove_stale()
    _assert_same(tr_t, tr_j)
    assert n_pos > 50 and n_surface > 0 and tr_t.ref_count > 50
    # the receiver's reference settles near the encoded positions (52 N 4 E)
    assert 50.0 < tr_t.ref_lat < 54.0 and 1.5 < tr_t.ref_lon < 6.5
    t["s"] += 21
    tr_t.remove_stale()
    tr_j.remove_stale()
    _assert_same(tr_t, tr_j)
    assert tr_t.aircraft == [] and tr_t.find(0) is None


def test_tracker_class_shapes_match_jax():
    assert [f.name for f in dataclasses.fields(tt.Aircraft)] == \
        [f.name for f in dataclasses.fields(jt.Aircraft)]
    assert dataclasses.asdict(tt.Aircraft(0x4D2023)) == dataclasses.asdict(jt.Aircraft(0x4D2023))
