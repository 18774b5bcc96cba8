"""The port's wall-clock soak (dump1090_tpu_torch/tools/soak_device.py)
against the JAX package's tools/soak_device.py, imported read-only, on the
CPU.  The fleet's frames and IQ equal the JAX tool's.  A small unpaced soak
of each plane (2-buffer batches, 2 batches a group, 4 planted blocks, a
2-aircraft fleet over 2 steps, 16 quiet buffers a period, up to the next
period's fleet) runs on device="cpu" under a fake clock that moves by a
fixed step at each read: 25 s for the raw-stream plane, which reads it once
a dispatch, and 0.5 s for the messages plane, whose tracker also reads it at
every message (CPR pairs must land within 10 s of each other to decode).
The recorded clocks are then replayed by the port's oracle subprocess and by
the JAX tool's passes (its FIXTURE pointed at a file of the port's dense
bytes).  All three agree on the stream, the 8 counters, and for the
messages plane the SBS lines, every snapshot and the tracker state; and the
run is not vacuous: its clock crosses the 60 s TTL, the pipeline shrinks
max_candidates to 64 on the quiet air and grows it back on the next dense
air, and the messages plane evicts aircraft.  The tool's entry point runs
both planes side by side on the CPU and refuses to run without a card
unless the CPU is named.  The pattern flags (--dense-reps, --fleet-aircraft,
--fleet-steps) reach the oracle's spec and give the JAX tool's stream, and
--oracle-messages names the messages plane as in the JAX tool.  Tolerance:
exact equality."""

import subprocess
import sys
import time
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from dump1090_tpu_torch.constants import DATA_LEN_BYTES
from dump1090_tpu_torch.tools import soak_device as tsoak

REPO = Path(__file__).resolve().parent.parent
SPEC = {"batch": 2, "groups": 2, "seed": 1, "dense_blocks": 4,
        "quiet_bufs": 16, "fleet_aircraft": 2, "fleet_steps": 2,
        "rate": None, "deadline_s": None, "evict_every": 50, "snap_every": 200}
STEP = {"wall": 25.0, "messages": 0.5}  # fake clock seconds a read
START = 1_700_000_000


@pytest.fixture(scope="module")
def jsoak():
    """The JAX package's soak tool, imported as tests/test_synth.py does."""
    sys.path.insert(0, str(REPO / "tools"))
    import soak_device

    return soak_device


@pytest.mark.parametrize("n_aircraft,steps", [(2, 2), (8, 6)])
def test_fleet_equals_jax(jsoak, n_aircraft, steps):
    frames = tsoak._fleet_frames(n_aircraft, steps)
    assert frames == jsoak._fleet_frames(n_aircraft, steps)
    assert len(frames) == n_aircraft * (4 * steps + 1)  # an ident, then 2 CPR, velocity, DF4
    np.testing.assert_array_equal(tsoak.fleet_iq_bytes(n_aircraft, steps),
                                  jsoak.fleet_iq_bytes(n_aircraft, steps))


def test_pattern_source_reads_the_period_by_slices():
    """Reads of any size give the bytes of the assembled period, period
    after period, and stop at total_bytes."""
    spec = dict(SPEC, quiet_bufs=2)
    src = tsoak._source(spec, paced=False)
    dense = tsoak.dense_bytes(1, 4)
    period = np.concatenate([dense, tsoak.fleet_iq_bytes(2, 2),
                             np.full(2 * DATA_LEN_BYTES, 127, np.uint8)])
    assert src.period_len == len(period)
    src.total = 2 * len(period) + 1000
    got = b"".join(iter(lambda: src.read(300_001), b""))
    want = np.concatenate([period, period, period[:1000]]).tobytes()
    assert got == want and src.pos == len(want)


def test_pattern_flags_give_the_stream_the_oracle_replays(jsoak, monkeypatch, tmp_path):
    """--dense-reps 2 tiles the 16 dense blocks twice a period and
    --fleet-aircraft 0 leaves the fleet out: the period has the expected
    length, and the spec's JSON (what the CPU oracle reads) and the JAX
    tool's PatternSource over the same dense bytes give the same stream.
    With no flags the spec is the stream of before: one tiling, an
    8-aircraft fleet over 6 steps."""
    import json

    dense = tsoak.dense_bytes(1, tsoak.DENSE_BLOCKS)
    args = tsoak.parser().parse_args(["--wall-minutes", "1", "--dense-reps", "2",
                                      "--fleet-aircraft", "0", "--quiet-bufs", "4"])
    spec = tsoak.make_spec(args, "wall")
    assert (spec["dense_reps"], spec["fleet_aircraft"], spec["fleet_steps"]) == (2, 0, 6)
    src = tsoak._source(spec, paced=False)
    assert src.dense_len == src.fleet_end == 2 * len(dense)
    assert src.period_len == 2 * len(dense) + 4 * DATA_LEN_BYTES
    total = src.period_len + 3 * len(dense) // 2  # into the next period's second tiling
    src.total = total
    got = b"".join(iter(lambda: src.read(1_000_003), b""))
    period = np.concatenate([dense, dense, np.full(4 * DATA_LEN_BYTES, 127, np.uint8)])
    assert got == np.concatenate([period, period])[:total].tobytes()
    replayed = tsoak._source(json.loads(json.dumps(dict(spec, total_bytes=total))), paced=False)
    assert b"".join(iter(lambda: replayed.read(262_144), b"")) == got
    fixture = tmp_path / "dense.bin"
    dense.tofile(fixture)
    monkeypatch.setattr(jsoak, "FIXTURE", str(fixture))
    jsrc = jsoak.PatternSource(total_bytes=total, dense_reps=2, quiet_bufs=4,
                               fleet_aircraft=0, fleet_steps=6)
    assert jsrc.period_len == src.period_len
    assert b"".join(iter(lambda: jsrc.read(524_288), b"")) == got

    default = tsoak.make_spec(tsoak.parser().parse_args(["--wall-minutes", "1"]), "wall")
    assert (default["dense_reps"], default["fleet_aircraft"], default["fleet_steps"]) == (1, 8, 6)
    src = tsoak._source(dict(default, quiet_bufs=1), paced=False)
    assert src.period_len == len(dense) + len(tsoak.fleet_iq_bytes(8, 6)) + DATA_LEN_BYTES


@pytest.mark.parametrize("argv,plane", [([], "wall"), (["--oracle-messages"], "messages"),
                                        (["--oracle-plane", "messages"], "messages")])
def test_oracle_messages_is_the_jax_spelling_of_the_messages_plane(argv, plane):
    args = tsoak.parser().parse_args(["--oracle-spec", "s.json", "--oracle-out", "o", *argv])
    assert args.oracle_plane == plane
    assert "--oracle-messages" not in tsoak.parser().format_help()  # internal


def _fake_time(monkeypatch, step: float) -> None:
    t = [float(START)]

    def now():
        t[0] += step
        return t[0]

    monkeypatch.setattr(tsoak, "time", types.SimpleNamespace(
        time=now, monotonic=time.monotonic, sleep=time.sleep))


@pytest.mark.parametrize("plane", ["wall", "messages"])
def test_small_soak_equals_its_replay_and_jax(plane, jsoak, monkeypatch, tmp_path):
    spec = dict(SPEC)
    src = tsoak._source(spec, paced=False)
    spec["total_bytes"] = src.period_len + src.fleet_end  # into the 2nd period's quiet
    _fake_time(monkeypatch, STEP[plane])
    run = tsoak._run_device_pass if plane == "wall" else tsoak._run_messages_pass
    dev = run(spec, paced=False, device="cpu")
    f = tsoak.facts(plane, dev)

    # not vacuous: the TTL is crossed, the shapes shrink and grow back
    assert f["clock_span_s"] > 60 and f["ttl_horizons"] >= 1
    assert f["mc_min"] == 64 and f["shrinks"] >= 1 and f["regrowths"] >= 1
    assert f["messages"] > 1000
    if plane == "messages":
        assert f["evicted"] >= 1 and f["sbs_lines"] > 100
        assert len(dev["snaps"]) >= 2 and any('"lat"' in s for s in dev["snaps"])
        assert dev["final"]["ref"][2] > 0  # airborne CPR positions decoded

    # the port's oracle: a CPU subprocess replaying the recorded clocks
    orc = tsoak.replay({plane: spec}, {plane: dev}, timeout=240)[plane]
    assert tsoak.check(plane, dev, orc) == []

    # the JAX tool's pass under the same clocks, over the same bytes
    fixture = tmp_path / "dense.bin"
    if plane == "wall":  # the JAX raw-stream pass has no fleet: fold it into the fixture
        np.concatenate([tsoak.dense_bytes(1, 4), tsoak.fleet_iq_bytes(2, 2)]).tofile(fixture)
    else:
        tsoak.dense_bytes(1, 4).tofile(fixture)
    monkeypatch.setattr(jsoak, "FIXTURE", str(fixture))
    jspec = dict(spec, dense_reps=1, **dev["rec"])
    if plane == "wall":
        raw, stats, nbytes, _ = jsoak._run_device_pass(jspec, [], paced=False)
        assert (raw, list(stats), nbytes) == (dev["raw"], dev["stats"], dev["nbytes"])
    else:
        want = jsoak._run_messages_pass(jspec, paced=False)
        for key in ("raw", "sbs", "snaps", "final", "stats", "nbytes", "n_msgs"):
            assert want[key] == dev[key], key


def test_replay_takes_the_device_pass_readiness(monkeypatch):
    """A device pass that fetches every group before the next is ready (a
    paced run on a host that keeps up with it) against its unpaced CPU
    replay, whose next group is mostly ready at once: the replay answers the
    pipeline's readiness probe as the device pass did, so both shrink and
    grow max_candidates at the same dispatches and read the same clocks.
    Without the recorded answers the replay diverges."""
    from dump1090_tpu_torch.models import pipeline as pl

    spec = dict(SPEC)
    src = tsoak._source(spec, paced=False)
    spec["total_bytes"] = src.period_len + src.fleet_end
    _fake_time(monkeypatch, STEP["wall"])
    with monkeypatch.context() as m:
        m.setattr(pl._Groups, "ready", lambda self: False)
        dev = tsoak._run_device_pass(spec, paced=False, device="cpu")
    f = tsoak.facts("wall", dev)
    assert f["shrinks"] >= 1 and f["regrowths"] >= 1
    assert dev["rec"]["ready"] and not any(dev["rec"]["ready"])
    orc = tsoak.replay({"wall": spec}, {"wall": dev}, timeout=240)["wall"]
    assert tsoak.check("wall", dev, orc) == []
    unrecorded = dict(dev, rec={k: v for k, v in dev["rec"].items() if k != "ready"})
    orc = tsoak.replay({"wall": spec}, {"wall": unrecorded}, timeout=240)["wall"]
    assert any("max_candidates per dispatch diverged" in f
               for f in tsoak.check("wall", unrecorded, orc))


def test_main_runs_both_planes_side_by_side_on_the_cpu():
    """The entry point with --device cpu over a 3 s window of each plane at
    8 MB/s (real clock), 16 quiet buffers a period: one PASS line a plane,
    exit 0."""
    r = subprocess.run(
        [sys.executable, "-m", "dump1090_tpu_torch.tools.soak_device", "--device", "cpu",
         "--wall-minutes", "0.05", "--wall-messages", "0.05", "--rate-mb-s", "8",
         "--batch", "2", "--groups", "2", "--quiet-bufs", "16"],
        cwd=REPO, capture_output=True, text=True, timeout=240)
    assert r.returncode == 0, r.stdout + r.stderr[-3000:]
    assert "WALL SOAK PASS" in r.stdout and "MESSAGES SOAK PASS" in r.stdout
    assert "wall plane: period" in r.stderr and "messages plane: period" in r.stderr


def test_refuses_to_run_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsoak.main(["--wall-minutes", "1"])
