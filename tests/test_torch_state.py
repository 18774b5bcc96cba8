"""The port's JSON checkpoint (utils/state.py) against the JAX package's:
a snapshot saved by the JAX package loads in the port and the port saves it
again text for text, and the other way round; a restored session decodes
on like the one it was taken from."""

import dataclasses
import json

import numpy as np
import pytest

import dump1090_tpu.models.decoder as jd
import dump1090_tpu.models.tracker as jt
import dump1090_tpu.utils.state as jstate
import dump1090_tpu_torch.models.decoder as td
import dump1090_tpu_torch.models.tracker as tt
import dump1090_tpu_torch.utils.state as tstate
from dump1090_tpu_torch.utils.synth import traffic_frames

NOW = 1_700_000_000


def _session(pkg_dec, pkg_tr, frames):
    """A tracker, cache and stats filled by decoding `frames` with one
    package, on frozen clocks."""
    t = {"ms": NOW * 1000}

    def msclock():
        t["ms"] += 250
        return t["ms"]

    tracker = pkg_tr.AircraftTracker(clock=lambda: NOW, msclock=msclock)
    cache, stats = pkg_dec.IcaoCache(clock=lambda: NOW), pkg_dec.DecoderStats()
    for f, _ in frames:
        mm = pkg_dec.decode_message(f, cache, pkg_dec.DecoderConfig(), stats)
        if mm.crcok:
            tracker.receive(mm)
            stats.goodcrc += 1
    return tracker, cache, stats


def test_jax_snapshot_loads_in_port_and_saves_text_equal(tmp_path):
    frames = traffic_frames(41, 800)
    jsess = _session(jd, jt, frames)
    assert jsess[0].aircraft and jsess[0].ref_count and jsess[1].addr.any()
    jpath, tpath = tmp_path / "jax.json", tmp_path / "port.json"
    jstate.save(str(jpath), *jsess)

    tr = tt.AircraftTracker(clock=lambda: NOW, msclock=lambda: NOW * 1000)
    cache, stats = td.IcaoCache(clock=lambda: NOW), td.DecoderStats()
    tstate.load(str(jpath), tr, cache, stats)
    tstate.save(str(tpath), tr, cache, stats)
    assert tpath.read_text() == jpath.read_text()
    assert not (tmp_path / "port.json.tmp").exists()  # saved by rename

    # the restored state is the session's, and it is live: the same traffic
    # decoded on from both gives the same tables
    psess = _session(td, tt, frames)
    assert tstate.snapshot(*psess) == jpath.read_text()
    assert tr._by_addr[tr.aircraft[0].addr] is tr.aircraft[0]
    more = traffic_frames(42, 300)
    jtr, jcache, jstats = jsess
    jtr.msclock = tr.msclock = lambda: (NOW + 200) * 1000
    for f, _ in more:
        a = td.decode_message(f, cache, td.DecoderConfig(), stats)
        b = jd.decode_message(f, jcache, jd.DecoderConfig(), jstats)
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
        if a.crcok:
            tr.receive(a)
            jtr.receive(b)
    assert tstate.snapshot(tr, cache, stats) == jstate.snapshot(jtr, jcache, jstats)


def test_port_snapshot_loads_in_jax():
    psess = _session(td, tt, traffic_frames(43, 500))
    text = tstate.snapshot(*psess)
    tr = jt.AircraftTracker()
    cache, stats = jd.IcaoCache(), jd.DecoderStats()
    jstate.restore(text, tr, cache, stats)
    assert jstate.snapshot(tr, cache, stats) == text
    doc = json.loads(text)
    assert doc["schema"] == tstate.SCHEMA == jstate.SCHEMA == 1
    np.testing.assert_array_equal(cache.addr, psess[1].addr)


def test_unknown_schema_refused():
    doc = json.loads(tstate.snapshot(tt.AircraftTracker(), td.IcaoCache(), td.DecoderStats()))
    doc["schema"] = 2
    with pytest.raises(ValueError, match="unknown state schema"):
        tstate.restore(json.dumps(doc), tt.AircraftTracker(), td.IcaoCache(), td.DecoderStats())
