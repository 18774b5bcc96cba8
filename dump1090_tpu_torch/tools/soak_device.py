"""Soaks of the port on the card (a port of tools/soak_device.py): a tiled
capture held byte for byte against a reference run, and the wall-clock
soaks, each held against the port's own CPU replay of the same bytes under
the same clock values.

    python -m dump1090_tpu_torch.tools.soak_device [--reps 60] [--ref CMD]
        [--input FILE] [--batch 16] [--groups 8] [--device cuda]

The fixed-reps mode (the default): --input (default
reference/testfiles/modes1.bin at the repository's root; a missing file is
an error) tiled --reps times is decoded twice through
DemodPipeline.stream_raw_device (K1 and K2) on --device, a cold pass and a
warm one, which must be equal, and the result is byte-compared with the
oracle's `--ifile <tiled file> --raw` (--ref: the reference binary, or any
command line that speaks its CLI, as tools/refbuild.py's
reference_command reads it; no --ref builds the reference from
`reference/`).  Prints SOAK PASS and exits 0, or SOAK FAIL at the first
differing line and exits 1.

    python -m dump1090_tpu_torch.tools.soak_device --wall-minutes 10 [--wall-messages 10]
        [--device cuda] [--rate-mb-s 4] [--batch 16] [--groups 8] [--seed 1]
        [--quiet-bufs 1024]

A deterministic pattern stream (PatternSource) of dense air (16 blocks of
150 planted DF17 frames from utils/synth.py, drawn from --seed), an
8-aircraft fleet over 6 steps (idents, CPR pairs, surface positions,
velocities, AP-addressed DF4 replies) and --quiet-bufs buffers of quiet
air (127s), past the 60 s ICAO-cache and aircraft TTLs, is paced at --rate-mb-s
(default the radio's 4 MB/s: one 262,144-byte buffer every 65.536 ms)
through a live-clock pipeline, so the decode crosses TTL horizons and the
pipeline's quiet-air shrink of its shapes (max_candidates down to 64) and
their regrowth on the next dense air.  Each pass records every value each
clock returned and every answer of the pipeline's probe for a ready input
group (which decides when a group is fetched); a CPU oracle subprocess
(--oracle-spec, --device cpu) then replays the identical byte stream with
the recorded clock and readiness sequences.

  --wall-minutes: the raw-stream plane, DemodPipeline.stream_raw_device
    (K1 and K2): the stream, the 8 counters and the max_candidates of every
    dispatch equal the replay's.
  --wall-messages: the messages plane, DemodPipeline.run_device -> the hub
    -> tracker (CPR, evictions), SBS and data.json snapshots: the raw
    stream, the SBS lines, every snapshot, the final tracker state (floats
    as IEEE-754 hex), the counters and the shapes equal the replay's.

With both, the two planes run side by side, one thread, one pipeline and
one CUDA stream each, over the same window.  Exit 0 when every plane
equals its replay and none is vacuous (no message, no SBS line, or fewer
than two snapshots).
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import io
import json
import math
import os
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch

from ..constants import DATA_LEN_BYTES
from . import add_device_options, device_option

REPO = Path(__file__).resolve().parents[2]
REFERENCE_CAPTURE = REPO / "reference" / "testfiles" / "modes1.bin"
RADIO_RATE_MB_S = 4.0  # one 262,144-byte buffer every 65.536 ms
PLANES = ("wall", "messages")
DENSE_BLOCKS = 16    # planted blocks of one tile of dense air (the chip_smoke.py air)
EVICT_EVERY = 200    # messages between stale-aircraft evictions (messages plane)
SNAP_EVERY = 1000    # messages between data.json snapshots (messages plane)


def _cpr_encode(lat: float, lon: float, odd: int, surface: bool) -> tuple:
    """CPR-encode a position into the 17-bit YZ/XZ fields (the inverse of
    models/cpr.py decode; airborne zone 360/60|59 deg, surface 90/60|59)."""
    from ..models.cpr import n_function

    base = 90.0 if surface else 360.0
    dlat = base / (59 if odd else 60)
    yz = int(math.floor(131072 * ((lat % dlat) / dlat) + 0.5))
    rlat = dlat * (yz / 131072 + math.floor(lat / dlat))
    dlon = base / n_function(rlat, odd)
    xz = int(math.floor(131072 * ((lon % dlon) / dlon) + 0.5))
    return yz & 131071, xz & 131071


def _fleet_frames(n_aircraft: int, steps: int) -> list:
    """Deterministic multi-aircraft Mode S traffic for the messages plane:
    per aircraft and timestep an ident, an even+odd airborne CPR pair (the
    global decode, dump1090.c:2069-2164), a velocity, and an AP-addressed
    DF4 altitude reply (ICAO-cache brute force); the last aircraft switches
    to surface positions once the auto-reference exists
    (dump1090.c:2144-2155).  Returns 14/7-byte frames in emission order."""
    from ..constants import AIS_CHARSET
    from ..ops import crc as crc_ops
    from ..utils.synth import make_df17_frame

    def df17(addr, metype, mesub, me):
        return make_df17_frame(addr, metype=metype, mesub=mesub, me_payload=bytes(me))

    def df4(addr, alt_ft):
        n = (alt_ft + 1000) // 25
        msg = bytearray(7)
        msg[0] = 4 << 3
        msg[2] = (n >> 6) & 31
        msg[3] = (((n >> 5) & 1) << 7) | (((n >> 4) & 1) << 5) | (n & 15) | 0x10
        c = crc_ops.compute_crc(np.frombuffer(bytes(msg), np.uint8), 56)
        ap = c ^ addr
        msg[4], msg[5], msg[6] = (ap >> 16) & 0xFF, (ap >> 8) & 0xFF, ap & 0xFF
        return bytes(msg)

    def pos_frame(addr, metype, alt_ft, odd, lat, lon, surface, track7=0, movement7=0):
        yz, xz = _cpr_encode(lat, lon, odd, surface)
        me = bytearray(6)
        if surface:  # movement's high 3 bits ride the mesub position
            me[0] = ((movement7 & 15) << 4) | 8 | ((track7 >> 4) & 7)
            me[1] = ((track7 & 15) << 4) | (odd << 2) | ((yz >> 15) & 3)
        else:
            n = (alt_ft + 1000) // 25
            me[0] = ((n >> 4) << 1) | 1           # AC12, Q=1
            me[1] = ((n & 15) << 4) | (odd << 2) | ((yz >> 15) & 3)
        me[2] = (yz >> 7) & 0xFF
        me[3] = ((yz & 0x7F) << 1) | ((xz >> 16) & 1)
        me[4] = (xz >> 8) & 0xFF
        me[5] = xz & 0xFF
        mesub = (movement7 >> 4) & 7 if surface else 0
        return df17(addr, metype, mesub, me)

    def velocity_me(ew, ew_dir, ns, ns_dir, vr, vr_sign):
        return bytes([
            (ew_dir << 2) | ((ew >> 8) & 3), ew & 0xFF,
            (ns_dir << 7) | ((ns >> 3) & 0x7F),
            ((ns & 7) << 5) | (vr_sign << 3) | ((vr >> 6) & 7),
            (vr & 0x3F) << 2, 0,
        ])

    frames = []
    for t in range(steps):
        for i in range(n_aircraft):
            addr = 0xA01000 + i * 0x111
            alt = 2000 + 1000 * i + 100 * t
            lat = 44.0 + 0.9 * i + 0.013 * t
            lon = 8.0 + 0.7 * i + 0.017 * t
            if t == 0:
                call = f"SOAK{i:02d}A "
                six = [AIS_CHARSET.index(c) for c in call]
                me = bytes([
                    (six[0] << 2) | (six[1] >> 4),
                    ((six[1] & 15) << 4) | (six[2] >> 2),
                    ((six[2] & 3) << 6) | six[3],
                    (six[4] << 2) | (six[5] >> 4),
                    ((six[5] & 15) << 4) | (six[6] >> 2),
                    ((six[6] & 3) << 6) | six[7],
                ])
                frames.append(df17(addr, 4, 0, me))
            surface = i == n_aircraft - 1 and t > 0
            for odd in (0, 1):
                if surface:
                    frames.append(pos_frame(
                        addr, 7, 0, odd, 44.0 + 0.013 * t, 8.0 + 0.017 * t,
                        True, track7=(20 + 3 * t) & 127, movement7=40 + t))
                else:
                    frames.append(pos_frame(addr, 11, alt, odd, lat, lon, False))
            frames.append(df17(addr, 19, 1,
                               velocity_me(120 + 10 * i + t, i & 1,
                                           200 + 7 * i + t, (i >> 1) & 1,
                                           64 + i, t & 1)))
            frames.append(df4(addr, alt))
    return frames


def fleet_iq_bytes(n_aircraft: int, steps: int) -> np.ndarray:
    """Modulate the fleet traffic into clean 2 Msps IQ (utils/synth.py)."""
    from ..utils.synth import frame_to_iq

    parts = [frame_to_iq(f, amplitude=80.0, pad_before=240, pad_after=240)
             for f in _fleet_frames(n_aircraft, steps)]
    return np.concatenate(parts)


@functools.lru_cache(maxsize=4)
def dense_bytes(seed: int, blocks: int = DENSE_BLOCKS) -> np.ndarray:
    """The dense air: `blocks` buffers of 150 planted DF17 frames over
    noise (utils/synth.py planted_capture, the air of chip_smoke.py)."""
    from ..utils.synth import planted_capture

    data = np.frombuffer(planted_capture(blocks, 150, seed=seed)[0], dtype=np.uint8)
    data.flags.writeable = False
    return data


class PatternSource:
    """Deterministic looping IQ byte stream: `dense_reps` tilings of the
    dense bytes, the fleet's frames, then `quiet_bufs` buffer-lengths of
    dead air (127s), repeated.  Byte content is a pure function of the
    stream offset, so a second instance with the same total_bytes replays
    the identical stream.  A rate cap (bytes/s) paces reads so a soak spans
    real wall time; a deadline (seconds from the first read) ends it.

    Each read assembles its slice of the period from the parts (O(read)
    memory): a quiet stretch past the 60 s TTLs is never materialized."""

    def __init__(self, dense, total_bytes=None, rate_bytes_s=None, deadline_s=None,
                 dense_reps=1, quiet_bufs=48, fleet_aircraft=0, fleet_steps=0):
        self.raw = np.asarray(dense, dtype=np.uint8)
        self.dense_len = dense_reps * len(self.raw)
        self.fleet = (fleet_iq_bytes(fleet_aircraft, fleet_steps)
                      if fleet_aircraft and fleet_steps
                      else np.empty(0, dtype=np.uint8))
        self.fleet_end = self.dense_len + len(self.fleet)
        self.period_len = self.fleet_end + quiet_bufs * DATA_LEN_BYTES
        self.total = total_bytes  # None = unbounded until the deadline
        self.rate = rate_bytes_s
        self.deadline_s = deadline_s
        self.deadline = None  # set at the FIRST read: kernel builds and
        self.pos = 0          # first-call setup must not eat the window
        self._t0 = None

    def seekable(self):
        return False

    def _slice(self, p: int, n: int) -> np.ndarray:
        """Bytes [p, p+n) of one period (p, p+n <= period_len)."""
        if p >= self.fleet_end:  # pure quiet
            return np.full(n, 127, dtype=np.uint8)
        parts = []
        while n > 0 and p < self.dense_len:
            q = p % len(self.raw)
            take = min(n, len(self.raw) - q)
            parts.append(self.raw[q : q + take])
            p += take
            n -= take
        if n > 0 and p < self.fleet_end:
            take = min(n, self.fleet_end - p)
            parts.append(self.fleet[p - self.dense_len : p - self.dense_len + take])
            p += take
            n -= take
        if n > 0:
            parts.append(np.full(n, 127, dtype=np.uint8))
        return parts[0] if len(parts) == 1 else np.concatenate(parts)

    def read(self, n: int) -> bytes:
        if self._t0 is None:
            self._t0 = time.monotonic()
            if self.deadline_s:
                self.deadline = self._t0 + self.deadline_s
        if self.total is not None:
            n = min(n, self.total - self.pos)
        if n <= 0:
            return b""
        if self.deadline is not None and time.monotonic() >= self.deadline:
            return b""
        if self.rate:
            ahead = (self.pos / self.rate) - (time.monotonic() - self._t0)
            if ahead > 0:
                time.sleep(ahead)
        parts = []
        pos, left = self.pos, n
        while left > 0:
            p = pos % self.period_len
            take = min(left, self.period_len - p)
            parts.append(self._slice(p, take))
            pos += take
            left -= take
        self.pos += n
        return b"".join(x.tobytes() for x in parts)


def _source(spec: dict, paced: bool) -> PatternSource:
    return PatternSource(
        dense_bytes(spec["seed"], spec["dense_blocks"]),
        total_bytes=spec.get("total_bytes"),
        rate_bytes_s=spec["rate"] if paced else None,
        deadline_s=spec.get("deadline_s") if paced else None,
        dense_reps=spec.get("dense_reps", 1),
        quiet_bufs=spec["quiet_bufs"],
        fleet_aircraft=spec.get("fleet_aircraft", 0),
        fleet_steps=spec.get("fleet_steps", 0),
    )


def _report_regime_shifts(yields, spec) -> list:
    """Flag inter-GROUP gaps well above the EXPECTED pacing period.

    A paced run yields one burst of `groups` chunks (one a batch) per
    dispatch group, so the detector compares the time between consecutive
    group completions against bytes-per-group / rate and reports only gaps
    >= 2x that (or +1.5 s absolute for unpaced runs): stalls, not the
    cadence.  Only the final group can be partial, so the stride stays on
    group boundaries; a partial tail contributes no sample."""
    ng = max(spec.get("groups", 1), 1)
    group_t = [t for t, _ in yields[ng - 1 :: ng]]
    gaps = [b - a for a, b in zip(group_t, group_t[1:])]
    if not gaps:
        return []
    rate = spec.get("rate")
    group_bytes = spec["batch"] * ng * DATA_LEN_BYTES
    expected = group_bytes / rate if rate else sorted(gaps)[len(gaps) // 2]
    thresh = max(2 * expected, expected + 1.5)
    shifts = [(i, g) for i, g in enumerate(gaps) if g > thresh]
    print(f"group gaps: expected {expected:.2f} s "
          f"({group_bytes / 1e6:.1f} MB/group at the pacing rate), median "
          f"{sorted(gaps)[len(gaps) // 2]:.2f} s, max {max(gaps):.2f} s; "
          f"{len(shifts)} regime shift(s) (>{thresh:.2f} s): "
          f"{[(i, round(g, 2)) for i, g in shifts[:12]]}", file=sys.stderr)
    return shifts


def _make_clock(spec: dict, name: str, rec: dict, ms: bool = False):
    """A recording clock (device pass) or a replaying clock (oracle pass).
    Determinism contract: both passes decode the identical byte stream, so
    every clock consumer runs in the identical order; recording each value
    returned and replaying the sequence reproduces every TTL / CPR-latch /
    eviction decision exactly."""
    vals = spec.get(name)
    if vals is not None:
        it = iter(vals)
        state = {"last": vals[-1] if vals else 0, "over": 0}

        def replay():
            # a divergence can change how many values a pass consumes: keep
            # returning the final value (and count the overrun) so the run
            # reaches the byte-level report that localizes the divergence
            v = next(it, None)
            if v is None:
                state["over"] += 1
                if state["over"] == 1:
                    print(f"WARNING: {name} clock replay exhausted ({len(vals)} recorded "
                          f"values): the passes diverged upstream; pinning to the final value",
                          file=sys.stderr)
                return state["last"]
            state["last"] = v
            return v

        rec.setdefault("overrun", {})[name] = state
        return replay
    lst = rec.setdefault(name, [])
    scale = 1000 if ms else 1

    def clock():
        v = int(time.time() * scale)
        lst.append(v)
        return v

    return clock


def _schedule(p, spec: dict, rec: dict) -> None:
    """Record (device pass) or replay (oracle pass) the pipeline's answers
    to whether its next input group is ready (`_Groups.ready`), as the
    clocks are.  The dispatch loop fetches a group as soon as no next one
    is ready, and that moves the group at which adapt_down's shrink takes
    effect and the groups a growth replays: a paced device pass and an
    unpaced oracle would answer differently, and the same answers give the
    same dispatches.  An oracle that asks past the recorded answers takes
    its own and counts the overrun."""
    real = p._ingest_groups
    vals = spec.get("ready")
    if vals is None:
        answers = rec.setdefault("ready", [])
    else:
        replayed = iter(vals)
        state = rec.setdefault("overrun", {})["ready"] = {"over": 0}

    def ingest(*a, **k):
        groups = real(*a, **k)
        probe = groups.ready

        def ready():
            if vals is None:
                answers.append(probe())
                return answers[-1]
            v = next(replayed, None)
            if v is None:
                state["over"] += 1
                return probe()
            return v

        groups.ready = ready
        return groups

    p._ingest_groups = ingest


def _pipeline(spec: dict, clock, device):
    """The plane's DemodPipeline on `device`, whose clock also notes the
    max_candidates of every dispatch (the pipeline reads its clock once a
    dispatch, replays included)."""
    from ..models.pipeline import DemodPipeline, PipelineConfig

    p = DemodPipeline(PipelineConfig(batch_buffers=spec["batch"],
                                     dispatch_groups=spec["groups"]),
                      clock=clock, device=device)
    shapes: list = []

    def noted():
        shapes.append(p.max_candidates)
        return clock()

    p.cache.clock = noted
    return p, shapes


def _counters(stats) -> list:
    return [stats.valid_preamble, stats.out_of_phase, stats.demodulated, stats.goodcrc,
            stats.badcrc, stats.fixed, stats.single_bit_fix, stats.two_bits_fix]


def _run_device_pass(spec: dict, paced: bool, device="cuda") -> dict:
    """Decode the pattern stream through stream_raw_device on `device`,
    recording (or replaying) every dispatch's clock value, with per-yield
    wall times.  Returns {"raw", "stats", "nbytes", "mc", "yields", "wall",
    "rec"}."""
    rec: dict = {}
    src = _source(spec, paced)
    p, shapes = _pipeline(spec, _make_clock(spec, "clocks", rec), device)
    _schedule(p, spec, rec)
    out, yields = [], []  # (t_monotonic, n_bytes) per fetched batch
    t0 = time.monotonic()
    for chunk in p.stream_raw_device(src):
        out.append(chunk)
        yields.append((time.monotonic(), len(chunk)))
    return {"raw": b"".join(out), "stats": _counters(p.stats), "nbytes": src.pos,
            "mc": shapes, "yields": yields, "wall": time.monotonic() - t0, "rec": rec}


def _tracker_state(tracker) -> dict:
    """Full tracker state, floats as IEEE-754 hex for byte-exact diffing."""
    return {
        "ref": [tracker.ref_lat.hex(), tracker.ref_lon.hex(), tracker.ref_count],
        "aircraft": [
            [a.hexaddr, a.flight, a.altitude, a.speed, a.track, a.seen,
             a.messages, a.odd_cprlat, a.odd_cprlon, a.even_cprlat,
             a.even_cprlon, a.odd_cprtime, a.even_cprtime,
             a.lat.hex(), a.lon.hex()]
            for a in tracker.aircraft
        ],
    }


def _run_messages_pass(spec: dict, paced: bool, device="cuda") -> dict:
    """The O(messages) plane: the device resolve path (run_device) on
    `device` feeding the hub -> tracker/CPR/SBS/raw/data.json chain
    (models/hub.py, models/tracker.py, utils/display.py), the subsystems
    the reference runs continuously in its main loop (useModesMessage
    dump1090.c:1795-1820, interactiveReceiveData :2069-2164,
    aircraftsToJson :2505-2551, stale eviction :2203-2224)."""
    from ..models.hub import HubConfig, MessageHub
    from ..models.tracker import AircraftTracker
    from ..utils import display as disp

    rec: dict = {}
    src = _source(spec, paced)
    p, shapes = _pipeline(spec, _make_clock(spec, "pipe_clocks", rec), device)
    _schedule(p, spec, rec)
    # enable the tracking gate the way live SBS/HTTP clients do
    # (useModesMessage dump1090.c:1806-1808)
    p.stats.sbs_connections = 1
    p.stats.http_requests = 1
    tracker = AircraftTracker(
        clock=_make_clock(spec, "trk_clocks", rec),
        msclock=_make_clock(spec, "trk_msclocks", rec, ms=True),
    )
    sbs: list = []
    raw_out = io.StringIO()
    hub = MessageHub(HubConfig(raw=True, net=False), tracker, p.stats,
                     out=raw_out, sbs_sink=sbs.append)
    snaps: list = []
    n_seen, evicted = [0], [0]
    evict_every = spec["evict_every"]
    snap_every = spec["snap_every"]

    def emit(mm):
        hub.use_message(mm)
        n_seen[0] += 1
        # the reference evicts and serves once per 65 ms buffer
        # (backgroundTasks dump1090.c:2831-2847); a message-count cadence
        # is the deterministic equivalent under replayed clocks
        if n_seen[0] % evict_every == 0:
            before = len(tracker.aircraft)
            tracker.remove_stale()
            evicted[0] += before - len(tracker.aircraft)
        if n_seen[0] % snap_every == 0:
            snaps.append(disp.aircraft_json(tracker))

    t0 = time.monotonic()
    p.run_device(src, emit)
    wall = time.monotonic() - t0
    snaps.append(disp.aircraft_json(tracker))  # final snapshot, always
    return {
        "raw": raw_out.getvalue(), "sbs": "".join(sbs), "snaps": snaps,
        "final": _tracker_state(tracker), "stats": _counters(p.stats),
        "nbytes": src.pos, "n_msgs": n_seen[0], "evicted": evicted[0], "mc": shapes,
        "wall": wall, "rec": rec,
    }


def make_spec(args, plane: str) -> dict:
    """The pattern, pipeline and cadence of one plane from the options."""
    spec = {
        "batch": args.batch, "groups": args.groups, "seed": args.seed,
        "dense_blocks": DENSE_BLOCKS, "dense_reps": args.dense_reps,
        "quiet_bufs": args.quiet_bufs,
        "fleet_aircraft": args.fleet_aircraft, "fleet_steps": args.fleet_steps,
        "rate": args.rate_mb_s * 1e6,
        "deadline_s": (args.wall_minutes if plane == "wall" else args.wall_messages) * 60,
    }
    if plane == "messages":
        spec.update(evict_every=EVICT_EVERY, snap_every=SNAP_EVERY)
    return spec


def _describe(plane: str, spec: dict) -> str:
    src = _source(spec, paced=False)
    rate = spec["rate"]
    quiet_s = spec["quiet_bufs"] * DATA_LEN_BYTES / rate
    return (f"{plane} plane: period {src.fleet_end / rate:.1f} s dense "
            f"({spec['dense_reps']} x {spec['dense_blocks']} planted blocks + "
            f"{spec['fleet_aircraft']}-aircraft fleet x{spec['fleet_steps']} steps) + "
            f"{quiet_s:.1f} s quiet (TTL 60 s: "
            f"{'crossed each period' if quiet_s > 60 else 'NOT crossed by the quiet air'}), "
            f"window {spec['deadline_s']:.0f} s at {rate / 1e6:g} MB/s")


def run_planes(specs: dict, device) -> dict:
    """The device pass of each plane in `specs` ("wall", "messages"), paced,
    side by side: one thread, one pipeline and (on CUDA) one stream each,
    so a wait in one plane never holds the other's pacing."""
    device = torch.device(device)
    passes = {"wall": _run_device_pass, "messages": _run_messages_pass}
    results, errors = {}, {}

    def work(plane):
        try:
            ctx = (torch.cuda.stream(torch.cuda.Stream(device)) if device.type == "cuda"
                   else contextlib.nullcontext())
            with ctx:
                results[plane] = passes[plane](specs[plane], paced=True, device=device)
        except BaseException as e:  # re-raised on the caller's thread
            errors[plane] = e

    threads = [threading.Thread(target=work, args=(plane,), name=f"soak-{plane}")
               for plane in specs]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise next(iter(errors.values()))
    return results


def replay(specs: dict, results: dict, *, timeout: float) -> dict:
    """The CPU oracle of each plane, all started together as subprocesses
    (`--oracle-spec ... --device cpu`, the CPU's cores split between them):
    the same bytes (total_bytes of the device pass) under the recorded
    clock sequences.  Returns each plane's oracle result."""
    threads = max(1, (os.cpu_count() or 1) // len(specs))
    procs = {}
    with tempfile.TemporaryDirectory() as tmp:
        for plane, spec in specs.items():
            dev = results[plane]
            oracle_spec = dict(spec, total_bytes=dev["nbytes"], **{
                k: v for k, v in dev["rec"].items() if k != "overrun"})
            spec_path = Path(tmp) / f"{plane}.json"
            spec_path.write_text(json.dumps(oracle_spec))
            out_path = Path(tmp) / f"{plane}.out.json"
            procs[plane] = (out_path, subprocess.Popen(
                [sys.executable, "-m", "dump1090_tpu_torch.tools.soak_device",
                 "--oracle-spec", str(spec_path), "--oracle-out", str(out_path),
                 "--oracle-plane", plane, "--oracle-threads", str(threads), "--device", "cpu"],
                cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        out = {}
        try:
            for plane, (out_path, proc) in procs.items():
                log = proc.communicate(timeout=timeout)[0]
                if proc.returncode != 0:
                    raise RuntimeError(f"the {plane} oracle exited {proc.returncode}:\n"
                                       f"{log[-2000:]}")
                out[plane] = json.loads(out_path.read_text())
        finally:
            for _, proc in procs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
    return out


def facts(plane: str, dev: dict) -> dict:
    """What shows that the device pass was real: the clock span and the TTL
    horizons it crossed, the dispatches, the smallest max_candidates and
    the shrinks and regrowths, and what came out."""
    clocks = dev["rec"]["clocks" if plane == "wall" else "pipe_clocks"]
    mc = dev["mc"]
    span = clocks[-1] - clocks[0] if clocks else 0
    out = {"wall_s": dev["wall"], "bytes": dev["nbytes"], "dispatches": len(mc),
           "clock_span_s": span, "ttl_horizons": span // 60,
           "mc_min": min(mc, default=0), "mc_max": max(mc, default=0),
           "shrinks": sum(b < a for a, b in zip(mc, mc[1:])),
           "regrowths": sum(b > a for a, b in zip(mc, mc[1:]))}
    if plane == "wall":
        out["messages"] = len(dev["raw"].splitlines())
    else:
        out.update(messages=dev["n_msgs"], raw_lines=len(dev["raw"].splitlines()),
                   sbs_lines=len(dev["sbs"].splitlines()), snapshots=len(dev["snaps"]),
                   evicted=dev["evicted"], aircraft_at_end=len(dev["final"]["aircraft"]))
    return out


def _first_diff(label: str, a: str, b: str) -> str:
    x, y = a.splitlines(), b.splitlines()
    for i, (p, q) in enumerate(zip(x, y)):
        if p != q:
            return f"{label} line {i}: card {p!r} cpu {q!r} ({len(x)} vs {len(y)} lines)"
    return f"{label}: card {len(x)} cpu {len(y)} lines"


def check(plane: str, dev: dict, orc: dict) -> list[str]:
    """Every difference between a plane's device pass and its CPU replay,
    and a vacuous run; empty when the plane passes."""
    bad = []
    if plane == "wall":
        if not dev["raw"]:
            bad.append("vacuous run (no message)")
        if orc["raw"] != dev["raw"].decode():
            bad.append(_first_diff("raw stream", dev["raw"].decode(), orc["raw"]))
        keys = (("stats", "counters"), ("mc", "max_candidates per dispatch"))
    else:
        if dev["n_msgs"] == 0 or not dev["sbs"] or len(dev["snaps"]) < 2:
            bad.append("vacuous run (no message, no SBS line or fewer than two snapshots)")
        for key, label in (("raw", "raw stream"), ("sbs", "SBS stream")):
            if orc[key] != dev[key]:
                bad.append(_first_diff(label, dev[key], orc[key]))
        if orc["snaps"] != dev["snaps"]:
            n = sum(a != b for a, b in zip(dev["snaps"], orc["snaps"]))
            bad.append(f"{n} of {len(dev['snaps'])} data.json snapshots differ "
                       f"(card {len(dev['snaps'])} cpu {len(orc['snaps'])})")
        keys = (("stats", "counters"), ("final", "tracker state"), ("evicted", "evictions"),
                ("mc", "max_candidates per dispatch"))
    for key, label in keys:
        if orc[key] != dev[key]:
            bad.append(f"{label} diverged: card {dev[key]} cpu {orc[key]}")
    if orc.get("overrun"):
        bad.append(f"the replay ran past the recorded clocks: {orc['overrun']}")
    return bad


def soak_messages(args) -> int:
    """Wall-clock soak of the messages plane alone (run_device -> hub ->
    tracker/CPR/SBS/data.json), then its CPU replay."""
    return 0 if soak({"messages": make_spec(args, "messages")}, args.device)["messages"]["ok"] else 1


def soak_wall(args) -> int:
    """Wall-clock soak of the raw-stream plane alone (stream_raw_device),
    then its CPU replay."""
    return 0 if soak({"wall": make_spec(args, "wall")}, args.device)["wall"]["ok"] else 1


def soak(specs: dict, device) -> dict:
    """Run the planes in `specs` on `device`, paced and side by side, then
    their CPU replays, and compare.  Returns per plane {"ok", "facts",
    "faults", "oracle_s"} and prints one PASS or FAIL line per plane."""
    names = {"wall": "WALL SOAK", "messages": "MESSAGES SOAK"}
    results = run_planes(specs, device)
    shifts = {}
    for plane, dev in results.items():
        print(f"{plane} device pass: {facts(plane, dev)}", file=sys.stderr)
        if plane == "wall":
            shifts[plane] = len(_report_regime_shifts(dev["yields"], specs[plane]))
    window = max(spec["deadline_s"] or 0 for spec in specs.values())
    t0 = time.monotonic()
    oracles = replay(specs, results, timeout=600 + 4 * window)
    oracle_s = time.monotonic() - t0
    report = {}
    for plane, dev in results.items():
        f = facts(plane, dev)
        faults = check(plane, dev, oracles[plane])
        report[plane] = {"ok": not faults, "facts": f, "faults": faults, "oracle_s": oracle_s,
                         "regime_shifts": shifts.get(plane)}
        if faults:
            for fault in faults:
                print(f"{names[plane]} FAIL: {fault}")
            continue
        extra = (f"{f['messages']} messages" if plane == "wall" else
                 f"{f['messages']} messages, {f['sbs_lines']} SBS lines, "
                 f"{f['snapshots']} data.json snapshots, {f['evicted']} aircraft evicted, "
                 f"{f['aircraft_at_end']} live at the end")
        what = ("stream + 8 counters + shapes" if plane == "wall" else
                "raw + SBS + snapshots + tracker state + 8 counters + shapes")
        print(f"{names[plane]} PASS: {f['wall_s'] / 60:.1f} min on {device}, "
              f"{f['bytes'] / 1e6:.0f} MB, {f['dispatches']} dispatches, clock span "
              f"{f['clock_span_s']} s ({f['ttl_horizons']} TTL horizons of 60 s), "
              f"max_candidates down to {f['mc_min']} ({f['shrinks']} shrinks, "
              f"{f['regrowths']} regrowths), {extra}; {what} identical to the CPU "
              f"replay ({oracle_s:.0f} s)")
    return report


def oracle_main(spec_path: str, out_path: str, plane: str, threads: int = 0) -> int:
    """Replay one plane on the CPU under the recorded clocks and write its
    result as JSON."""
    if threads:
        torch.set_num_threads(threads)
    spec = json.loads(Path(spec_path).read_text())
    run = _run_device_pass if plane == "wall" else _run_messages_pass
    res = run(spec, paced=False, device="cpu")
    res["overrun"] = {k: s["over"] for k, s in res["rec"].get("overrun", {}).items()
                      if s["over"]}
    for key in ("rec", "yields", "wall"):
        res.pop(key, None)
    if plane == "wall":
        res["raw"] = res["raw"].decode()
    Path(out_path).write_text(json.dumps(res))
    return 0


def reps_passes(stream: np.ndarray, batch: int, groups: int, device) -> dict:
    """The fixed-reps decode: `stream` (flat uint8 IQ) through
    DemodPipeline.stream_raw_device on `device` twice, each pass a fresh
    pipeline (cold, then warm).  Returns {"raw", "warm_raw", "cold_s",
    "warm_s", "samples"}; the caller compares the two passes."""
    from ..models.pipeline import DemodPipeline, PipelineConfig

    cfg = PipelineConfig(batch_buffers=batch, dispatch_groups=groups)
    out = {}
    for name in ("cold", "warm"):
        p = DemodPipeline(cfg, device=device)
        t0 = time.perf_counter()
        raw = b"".join(p.stream_raw_device(io.BytesIO(stream.tobytes())))
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        out[f"{name}_s"] = time.perf_counter() - t0
        out["raw" if name == "cold" else "warm_raw"] = raw
    out["samples"] = p.samples_in
    return out


def soak_reps(args) -> int:
    """The fixed-reps soak (tools/soak_device.py's default mode): the tiled
    capture on the device, cold and warm, against the oracle's --raw run."""
    from . import air
    from .refbuild import reference_command

    path = Path(args.input) if args.input else REFERENCE_CAPTURE
    try:
        raw = air.stream(path)
    except (FileNotFoundError, ValueError) as e:
        print(f"soak: {e}", file=sys.stderr)
        return 1
    ref_cmd = reference_command(args.ref)
    stream = np.tile(raw, args.reps)
    print(f"soak input: {path}, {stream.nbytes / 1e6:.0f} MB "
          f"({stream.nbytes // 2 / 1e6:.0f} M samples)", file=sys.stderr)
    res = reps_passes(stream, args.batch, args.groups, args.device)
    ours = res["raw"]
    print(f"ours: {len(ours.splitlines())} messages in {res['cold_s']:.2f}s "
          f"(cold: includes the kernels' first launches)", file=sys.stderr)
    if res["warm_raw"] != ours:
        print("SOAK FAIL: the warm pass differs from the cold pass")
        return 1
    name = (torch.cuda.get_device_name(args.device) if args.device.type == "cuda"
            else "the CPU")
    print(f"warm pass: {res['warm_s']:.2f}s -> {res['samples'] / res['warm_s'] / 1e6:.0f} "
          f"Msamples/s on {name}", file=sys.stderr)

    with tempfile.TemporaryDirectory() as tmp:
        tiled = Path(tmp) / "soak.bin"
        stream.tofile(tiled)
        t0 = time.perf_counter()
        r = subprocess.run([*ref_cmd, "--ifile", str(tiled), "--raw"], cwd=REPO,
                           capture_output=True, timeout=600)
        print(f"reference: {len(r.stdout.splitlines())} messages in "
              f"{time.perf_counter() - t0:.2f}s (exit {r.returncode})", file=sys.stderr)
    ref = r.stdout

    if ours == ref:
        print(f"SOAK PASS: {len(ours.splitlines())} messages, {len(ours)} bytes identical")
        return 0
    a, b = ours.splitlines(), ref.splitlines()
    for i, (x, y) in enumerate(zip(a, b)):
        if x != y:
            print(f"SOAK FAIL at line {i}: ours {x!r} ref {y!r}")
            break
    print(f"SOAK FAIL: ours {len(a)} ref {len(b)} lines")
    return 1


def parser() -> argparse.ArgumentParser:
    """The options of main; chip_smoke.py builds its soak from them too."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=60,
                    help="tilings of --input in the fixed-reps soak (the default mode)")
    ap.add_argument("--ref", default=None,
                    help="the fixed-reps soak's oracle: the reference binary or a command "
                    "line that speaks its CLI (default: built from reference/)")
    ap.add_argument("--input", default=None,
                    help=f"the fixed-reps soak's capture (default {REFERENCE_CAPTURE})")
    ap.add_argument("--wall-minutes", type=float, default=0,
                    help="soak the raw-stream plane (stream_raw_device) for this "
                    "many minutes")
    ap.add_argument("--wall-messages", type=float, default=0,
                    help="soak the messages plane (run_device -> hub -> tracker, "
                    "SBS, data.json) for this many minutes (with --wall-minutes: "
                    "side by side)")
    add_device_options(ap)
    ap.add_argument("--batch", type=int, default=16, help="buffers per batch")
    ap.add_argument("--groups", type=int, default=8, help="batches per dispatch group")
    ap.add_argument("--rate-mb-s", type=float, default=RADIO_RATE_MB_S,
                    help="ingest pacing (default: the radio's 4 MB/s)")
    ap.add_argument("--seed", type=int, default=1, help="seed of the dense air")
    ap.add_argument("--dense-reps", type=int, default=1,
                    help=f"tilings of the dense air ({DENSE_BLOCKS} planted blocks, "
                    f"{DENSE_BLOCKS * DATA_LEN_BYTES / 1e6:.2f} MB, "
                    f"{DENSE_BLOCKS * DATA_LEN_BYTES / (RADIO_RATE_MB_S * 1e6):.2f} s at "
                    f"{RADIO_RATE_MB_S:g} MB/s) per pattern period.  The JAX tool's 900 "
                    "tilings of modes1.bin are about 20 s of dense air at its 32 MB/s: "
                    "--dense-reps 20 here")
    ap.add_argument("--quiet-bufs", type=int, default=1024,
                    help="dead-air buffers per pattern period (1024: 67 s at 4 MB/s, "
                    "past the 60 s TTLs, so every period crosses an eviction horizon; "
                    "the JAX tool's 9216 are 75 s at its 32 MB/s)")
    ap.add_argument("--fleet-aircraft", type=int, default=8,
                    help="synthetic aircraft in the fleet segment of each period (CPR "
                    "pairs, surface positions, velocities, idents, AP-addressed DF4); "
                    "0 leaves the fleet out")
    ap.add_argument("--fleet-steps", type=int, default=6,
                    help="fleet timesteps per pattern period; 0 leaves the fleet out")
    ap.add_argument("--oracle-spec", help=argparse.SUPPRESS)
    ap.add_argument("--oracle-out", help=argparse.SUPPRESS)
    ap.add_argument("--oracle-plane", choices=PLANES, default="wall", help=argparse.SUPPRESS)
    ap.add_argument("--oracle-messages", action="store_const", dest="oracle_plane",
                    const="messages", help=argparse.SUPPRESS)
    ap.add_argument("--oracle-threads", type=int, default=0, help=argparse.SUPPRESS)
    return ap


def main(argv=None) -> int:
    from .. import resolve_device

    ap = parser()
    args = ap.parse_args(argv)
    args.device = resolve_device(device_option(ap, args))

    if args.oracle_spec:
        return oracle_main(args.oracle_spec, args.oracle_out, args.oracle_plane,
                           args.oracle_threads)
    if not (args.wall_minutes or args.wall_messages):
        return soak_reps(args)
    specs = {plane: make_spec(args, plane) for plane, minutes
             in (("wall", args.wall_minutes), ("messages", args.wall_messages)) if minutes}
    for plane, spec in specs.items():
        print(_describe(plane, spec), file=sys.stderr)
    return 0 if all(r["ok"] for r in soak(specs, args.device).values()) else 1


if __name__ == "__main__":
    sys.exit(main())
