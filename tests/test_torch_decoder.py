"""The port's message decode (models/decoder.py) and host CRC (ops/crc.py)
against the JAX package.  The stateless decode of device emissions: every
Downlink Format, DF17 metypes 1-19, velocity subtypes 1-4 with headings in
every quadrant, both frame lengths, random meta words.  The stateful host
decode (decode_message, decode_hex_message, brute_force_ap, the ICAO cache,
fix_bit_errors): seeded traffic of every DF with 0-2 flipped bits under fix
on, fix off and aggressive, and malformed hex lines.  Exact equality."""

import dataclasses

import numpy as np
import pytest

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


NOW = 1_700_000_000
MODES = {"fix": dict(fix_errors=True), "nofix": dict(fix_errors=False),
         "aggressive": dict(fix_errors=True, aggressive=True)}


def _caches():
    """One ICAO cache per package, on one frozen clock that a test moves."""
    t = [NOW]
    return t, td.IcaoCache(clock=lambda: t[0]), jd.IcaoCache(clock=lambda: t[0])


def _assert_same_state(tc, jc, ts, js):
    np.testing.assert_array_equal(tc.addr, jc.addr)
    np.testing.assert_array_equal(tc.ts, jc.ts)
    assert dataclasses.asdict(ts) == dataclasses.asdict(js)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_decode_message_matches_jax(mode):
    """Seeded frames of DF 0/4/5/11/16/17/18/20/21/24 with 0-2 flipped
    bits, through both packages' decode_message with one cache and stats
    each: every field, the cache arrays and the counters after every
    frame.  The clock moves past the cache's TTL now and then."""
    from dump1090_tpu_torch.utils.synth import traffic_frames

    t, tc, jc = _caches()
    ts, js = td.DecoderStats(), jd.DecoderStats()
    tcfg, jcfg = td.DecoderConfig(**MODES[mode]), jd.DecoderConfig(**MODES[mode])
    frames = traffic_frames(5, 1500, flip_weights=(0.6, 0.25, 0.15))
    seen = set()
    for k, (f, nflip) in enumerate(frames):
        if k % 500 == 499:
            t[0] += 61  # every cached address expires
        g = td.decode_message(f, tc, tcfg, ts)
        w = jd.decode_message(f, jc, jcfg, js)
        assert dataclasses.asdict(g) == dataclasses.asdict(w), (k, f.hex())
        _assert_same_state(tc, jc, ts, js)
        seen.add((g.msgtype, g.crcok, g.errorbit != -1, bool(g.iid)))
    if mode != "nofix":
        assert ts.single_bit_fix > 0 and any(s[2] for s in seen)
    assert (ts.two_bits_fix > 0) == (mode == "aggressive")
    assert {df for df, ok, _, _ in seen if ok} >= {0, 4, 5, 11, 16, 17, 18, 20, 21, 24}
    assert any(iid for *_, iid in seen)  # a DF11 interrogator id accepted


def test_decode_hex_message_matches_jax():
    """Hex lines of the same traffic, in both cases and with surrounding
    whitespace, plus malformed lines: the same message or None, and the
    same cache and counters."""
    from dump1090_tpu_torch.utils.synth import traffic_frames

    _, tc, jc = _caches()
    ts, js = td.DecoderStats(), jd.DecoderStats()
    tcfg, jcfg = td.DecoderConfig(), jd.DecoderConfig()
    lines = []
    for k, (f, _) in enumerate(traffic_frames(6, 600)):
        h = f.hex().upper() if k % 2 else f.hex()
        lines.append(("  *%s;  \n" if k % 3 == 0 else "*%s;\n") % h)
    lines += ["", "*", ";", "*;", "5d4d20237a55a6;", "*5d4d20237a55a6", "*5d4d20237a55a;",
              "*zz4d20237a55a6;", "*" + "ab" * 15 + ";", "*5d4d 20237a55a6;", "*5d4d20237a55a6;x",
              "**5d4d20237a55a6;", "*8d4d2023991094ad487c14fc9e3d;", "*02e197b00179c3;",
              "*5d4d20237a55a6;;", "\x00*5d4d20237a55a6;", "*5D4D20237A55A6;\r\n"]
    n_none = 0
    for line in lines:
        g = td.decode_hex_message(line, tc, tcfg, ts)
        w = jd.decode_hex_message(line, jc, jcfg, js)
        assert (g is None) == (w is None), repr(line)
        if g is None:
            n_none += 1
        else:
            assert dataclasses.asdict(g) == dataclasses.asdict(w), repr(line)
        _assert_same_state(tc, jc, ts, js)
    assert n_none >= 12
    mm = td.decode_hex_message("*;", tc, tcfg)
    assert mm is not None and mm.msgtype == 0  # zero-filled, as in JAX


def test_fix_bit_errors_and_cache_match_jax():
    rng = np.random.default_rng(8)
    for _ in range(3000):
        f = rng.integers(0, 256, 14, dtype=np.uint8)
        bits = int(rng.choice([56, 112]))
        for maxfix in (1, 2):
            a, b = f.copy(), f.copy()
            assert tcrc.fix_bit_errors(a, bits, maxfix) == jcrc.fix_bit_errors(b, bits, maxfix)
            np.testing.assert_array_equal(a, b)
    t, tc, jc = _caches()
    for a in rng.integers(0, 1 << 24, 3000).tolist():
        tc.add(a)
        jc.add(a)
        t[0] += int(rng.integers(0, 3))
        probe = int(rng.integers(0, 1 << 24)) if rng.random() < 0.3 else a
        assert tc.recently_seen(probe) == jc.recently_seen(probe)
    np.testing.assert_array_equal(tc.addr, jc.addr)
    np.testing.assert_array_equal(tc.ts, jc.ts)
