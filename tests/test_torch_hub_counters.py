"""The hub's display counters (models/hub.py): the messages it dropped for
their CRC, the messages it displayed and the characters it wrote, against
what it really wrote, under every HubConfig mode; and the text it writes,
byte for byte the JAX package's hub on the same messages."""

import io

import pytest

import dump1090_tpu.models.decoder as jd
import dump1090_tpu.models.hub as jh
import dump1090_tpu.models.tracker as jt
import dump1090_tpu_torch.models.decoder as td
import dump1090_tpu_torch.models.hub as th
import dump1090_tpu_torch.models.tracker as tt
from dump1090_tpu_torch.utils.synth import traffic_frames

NOW = 1_700_000_000

MODES = {
    "verbose": dict(),
    "raw": dict(raw=True),
    "onlyaddr": dict(onlyaddr=True),
    "stats_only": dict(stats_only=True),
    "interactive": dict(interactive=True),
    "no_crc_check": dict(check_crc=False),
}


def _frames(seed: int, n: int):
    # 2 flipped bits a fifth of the time: without --aggressive those stay
    # bad, so good and bad CRCs both reach the hub
    return traffic_frames(seed, n, flip_weights=(0.6, 0.2, 0.2))


def _hub(mod, tracker_mod, dec_mod, flags: dict, out):
    tracker = tracker_mod.AircraftTracker(clock=lambda: NOW, msclock=lambda: NOW * 1000)
    return mod.MessageHub(mod.HubConfig(**flags), tracker, dec_mod.DecoderStats(), out=out)


class _Writes(io.StringIO):
    """A text sink that counts its write calls."""

    def __init__(self):
        super().__init__()
        self.calls = 0

    def write(self, s):
        self.calls += 1
        return super().write(s)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_counters_equal_what_the_hub_wrote(mode):
    flags = MODES[mode]
    out = _Writes()
    hub = _hub(th, tt, td, flags, out)
    cache = td.IcaoCache(clock=lambda: NOW)
    good = bad = 0
    for f, _ in _frames(41, 600):
        mm = td.decode_message(f, cache, td.DecoderConfig())
        good += mm.crcok
        bad += not mm.crcok
        hub.use_message(mm)
    assert good > 100 and bad > 50
    check_crc = flags.get("check_crc", True)
    shown = not flags.get("stats_only") and not flags.get("interactive")
    assert hub.crc_dropped == (bad if check_crc else 0)
    assert hub.displayed == ((good if check_crc else good + bad) if shown else 0)
    assert hub.written == len(out.getvalue())
    # one write a message displayed, two where the blank line follows
    per_message = 1 if flags.get("raw") or flags.get("onlyaddr") or not shown else 2
    assert out.calls == hub.displayed * per_message


@pytest.mark.parametrize("mode", sorted(MODES))
def test_text_written_equals_jax_hub(mode):
    flags = MODES[mode]
    outs, hubs = {}, {}
    for name, mod, tr, dec in (("port", th, tt, td), ("jax", jh, jt, jd)):
        outs[name] = io.StringIO()
        hubs[name] = _hub(mod, tr, dec, flags, outs[name])
        cache = dec.IcaoCache(clock=lambda: NOW)
        for f, _ in _frames(43, 500):
            hubs[name].use_message(dec.decode_message(f, cache, dec.DecoderConfig()))
    assert outs["port"].getvalue() == outs["jax"].getvalue()
    assert hubs["port"].written == len(outs["jax"].getvalue())
    if not flags.get("stats_only") and not flags.get("interactive"):
        assert outs["port"].getvalue()
