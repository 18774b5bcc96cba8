"""The port's printers (utils/display.py) against the JAX package on the
same messages and the same tracker: the verbose display under every flag
combination, the raw hex in both cases, SBS lines, the /data.json document
(feet and metric) and the interactive screen, string for string.  Also the
hub (models/hub.py): the bytes it writes and sends to its sinks."""

import dataclasses
import io

import pytest

import dump1090_tpu.models.decoder as jd
import dump1090_tpu.models.hub as jh
import dump1090_tpu.models.tracker as jt
import dump1090_tpu.utils.display as jdisp
import dump1090_tpu_torch.models.decoder as td
import dump1090_tpu_torch.models.hub as th
import dump1090_tpu_torch.models.tracker as tt
import dump1090_tpu_torch.utils.display as tdisp
from dump1090_tpu_torch.utils.synth import traffic_frames

NOW = 1_700_000_000


def _messages(seed, n, cfg=None):
    """The same frames decoded by each package: [(port mm, JAX mm)]."""
    tc, jc = td.IcaoCache(clock=lambda: NOW), jd.IcaoCache(clock=lambda: NOW)
    out = []
    for f, _ in traffic_frames(seed, n, flip_weights=(0.7, 0.2, 0.1)):
        out.append((td.decode_message(f, tc, td.DecoderConfig(**(cfg or {}))),
                    jd.decode_message(f, jc, jd.DecoderConfig(**(cfg or {})))))
    return out


def test_display_message_matches_jax():
    pairs = _messages(31, 1500, dict(aggressive=True))
    for mt, mj in pairs:
        assert dataclasses.asdict(mt) == dataclasses.asdict(mj)
        for raw in (False, True):
            for onlyaddr in (False, True):
                for check_crc in (False, True):
                    kw = dict(raw=raw, onlyaddr=onlyaddr, check_crc=check_crc)
                    assert tdisp.display_message(mt, **kw) == jdisp.display_message(mj, **kw)
        assert tdisp.raw_hex(mt) == jdisp.raw_hex(mj)
        assert tdisp.raw_hex(mt, upper=True) == jdisp.raw_hex(mj, upper=True)
    texts = [tdisp.display_message(mt) for mt, _ in pairs]
    # the printers' branches were reached: ME 19 subtypes 3/4 without their
    # newlines, fixes, the DF 18 block, unknown ME types
    assert any("Heading status" in s and not s.endswith("\n") for s in texts)
    assert any("Single bit error fixed" in s for s in texts)
    assert any("DF 18: Extended Squitter." in s for s in texts)
    assert any("Unrecognized ME type" in s for s in texts)
    for metype in range(32):
        for mesub in range(8):
            assert tdisp.me_description(metype, mesub) == jdisp.me_description(metype, mesub)


@pytest.mark.parametrize("metric", [False, True])
def test_sbs_json_and_screen_match_jax(metric):
    """Both trackers fed the same messages on the same frozen clocks: the
    SBS line of each message against its aircraft, and every 100 messages
    the JSON document and the interactive screen (rows cut at 7 and 40)."""
    t = {"s": NOW, "ms": NOW * 1000}
    clocks = dict(clock=lambda: t["s"], msclock=lambda: t["ms"])
    tr_t, tr_j = tt.AircraftTracker(**clocks), jt.AircraftTracker(**clocks)
    n_sbs = n_json_rows = 0
    for k, (mt, mj) in enumerate(_messages(32, 1500)):
        t["ms"] += 300
        t["s"] += k % 4 == 0
        a, b = tr_t.receive(mt), tr_j.receive(mj)
        if a is not None:
            line = tdisp.sbs_line(mt, a)
            assert line == jdisp.sbs_line(mj, b)
            n_sbs += line is not None
        if k % 100 == 99:
            js = tdisp.aircraft_json(tr_t, metric)
            assert js == jdisp.aircraft_json(tr_j, metric)
            n_json_rows = js.count('"hex"')
            for rows in (7, 40):
                kw = dict(rows=rows, metric=metric, now=t["s"], spinner_t=k)
                assert tdisp.interactive_screen(tr_t, **kw) == jdisp.interactive_screen(tr_j, **kw)
    assert n_sbs > 500 and n_json_rows > 5
    assert tdisp.aircraft_json(tt.AircraftTracker()) == "[\n]\n"


@pytest.mark.parametrize("flags", [
    dict(), dict(raw=True), dict(onlyaddr=True), dict(check_crc=False),
    dict(raw=True, check_crc=False), dict(stats_only=True), dict(interactive=True),
    dict(net=True, raw=True),
])
def test_hub_matches_jax(flags):
    """MessageHub of each package over the same messages: the text it
    writes, the lines it gives its raw and SBS sinks (with tracking on
    through a counted SBS client), and the tracker it fills."""
    outs, sinks, trackers = {}, {}, {}
    for name, hub_mod, tr_mod, dec in (("port", th, tt, td), ("jax", jh, jt, jd)):
        stats = dec.DecoderStats(sbs_connections=1)
        trackers[name] = tr_mod.AircraftTracker(clock=lambda: NOW, msclock=lambda: NOW * 1000)
        outs[name] = io.StringIO()
        sinks[name] = []
        hub = hub_mod.MessageHub(hub_mod.HubConfig(**flags), trackers[name], stats,
                                 out=outs[name], raw_sink=lambda s, n=name: sinks[n].append(("raw", s)),
                                 sbs_sink=lambda s, n=name: sinks[n].append(("sbs", s)))
        for mt, mj in _messages(33, 400):
            hub.use_message(mt if name == "port" else mj)
    assert outs["port"].getvalue() == outs["jax"].getvalue()
    assert sinks["port"] == sinks["jax"]
    assert [dataclasses.asdict(a) for a in trackers["port"].aircraft] == \
        [dataclasses.asdict(a) for a in trackers["jax"].aircraft]
    if not flags.get("stats_only"):
        assert sinks["port"]
