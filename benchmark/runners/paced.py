"""A paced feed into an emit callback: the live `--net` feeder, `dump1090
--net` on a dongle (or `rtl_sdr ... | dump1090 --ifile - --net`), through
DemodPipeline.run_source_device(buffers, emit).

The buffers are pre-framed as io/rtlsdr.py yields them (the 476 carried
bytes included) and offered in an open loop: buffer k is due when its
last sample has arrived, t0 + (k + 1) x 65.536 ms / pace, and the
harness's iterable never yields a buffer before it is due nor waits for
the decoder.  The emit callback is MessageHub.use_message, built as
cli.main builds it for --net, with one SBS client attached; its raw-out,
SBS and display outputs go to collectors.  Every buffer ends with a marker
frame whose arrival at the hub times it.

The window starts from the ICAO cache of a feeder that has been up a
while: each aircraft of the air's pool last heard a number of seconds
before (drawn from the seed over the configuration's range), so some
entries have passed the cache's 60 s TTL and others pass it during the
window.  The check replays the reference over the same buffers, from the
same cache, with the clock values the program resolved each buffer with
and those its tracker read, and compares every message's fields, what the
hub produced for it, the aircraft table and the counters.
"""

from __future__ import annotations

import threading
import time

import numpy as np

from benchmark import air, program
from benchmark.harness import Check, GcMeter, Run, Verdict, group_nows, percentile
from benchmark.reference import decoder, demod, hub as ref_hub, modes
from benchmark.trace import Tracer

AIRCRAFT_FIELDS = ("addr", "hexaddr", "flight", "altitude", "speed", "track", "seen", "messages",
                   "odd_cprlat", "odd_cprlon", "even_cprlat", "even_cprlon", "odd_cprtime",
                   "even_cprtime", "lat", "lon")


class Feed:
    """The open-loop source: yields buffers[k] no earlier than its due
    time, recording when each was taken."""

    def __init__(self, buffers: np.ndarray, period_s: float, t0: float, annotate=None):
        self.buffers = buffers
        self.period_s = period_s
        self.t0 = t0
        self.due = t0 + period_s * np.arange(1, buffers.shape[0] + 1)
        self.taken = np.full(buffers.shape[0], np.nan)
        self.count = 0
        self.annotate = annotate

    def __iter__(self):
        for k in range(self.buffers.shape[0]):
            wait = self.due[k] - time.perf_counter()
            if wait > 0:
                if self.annotate is None:
                    time.sleep(wait)
                else:
                    with self.annotate("bench.air_wait"):
                        time.sleep(wait)
            self.taken[k] = time.perf_counter()
            self.count = k + 1
            yield self.buffers[k]


class Collector:
    """A text sink with the file methods the hub calls."""

    def __init__(self):
        self.parts: list[str] = []

    def write(self, s: str) -> None:
        self.parts.append(s)

    def flush(self) -> None:
        pass


def _period(cell) -> float:
    return modes.BUFFER_SECONDS / float(cell.traffic["pace"])


def start_cache(cell, now: int) -> tuple[list, list]:
    """The ICAO cache the window starts from (addresses, seconds last
    seen): each aircraft of the pool, last heard a whole number of seconds
    before `now` drawn from the seed over the configuration's age_s range,
    slotted as the cache slots it (a later one overwriting on collision)."""
    lo, hi = cell.config["cache_start"]["age_s"]
    pool = air.pool(cell.seed, cell.traffic)
    (rng,) = air._rngs(cell.seed ^ 0xCAC4E, 1)
    ages = rng.integers(int(lo), int(hi) + 1, pool.size)
    addr, ts = [0] * modes.ICAO_CACHE_LEN, [0] * modes.ICAO_CACHE_LEN
    for a, age in zip(pool.tolist(), ages.tolist()):
        h = decoder.IcaoCache.slot(a)
        addr[h], ts[h] = a, now - age
    return addr, ts


def prepare(cell) -> Run:
    """Set-up: the buffers, the pipeline, and a few seconds of paced air
    through a hub of their own on the same pipeline; then the ICAO cache
    set to the one the window starts from."""
    period = _period(cell)
    n_warm = int(np.ceil(float(cell.config["warmup_seconds"]) / period))
    n = int(cell.seconds / period)
    bufs = air.paced_buffers(cell.seed, n_warm + n, cell.traffic)
    clock = program.RecordingClock()
    p = program.pipeline(cell.config["settings"], cell.device, clock)
    sink = Collector()
    h, _ = program.hub(p, cell.config["hub"], out=sink, raw_sink=sink.write, sbs_sink=sink.write,
                       clock=program.RecordingClock(), msclock=program.RecordingClock(1000))
    lock = threading.RLock()

    def emit_warm(mm):
        with lock:
            h.use_message(mm)

    p.run_source_device(Feed(bufs[:n_warm], period, time.perf_counter()), emit_warm)
    program.reset_decode_state(p)
    cache0 = start_cache(cell, int(time.time()))
    program.set_cache(p, *cache0)
    clock.clear()
    tracer = Tracer(cell.trace, cell.device, start_s=0.5 * cell.seconds,
                    length_s=min(4.0, 0.3 * cell.seconds))
    tracer.warm()
    return Run(cell, extra=dict(pipeline=p, buffers=bufs[n_warm:], first_seq=n_warm, clock=clock,
                                tracer=tracer, period=period, cache0=cache0))


def measure(run: Run) -> None:
    """The window: one run_source_device call over the paced buffers."""
    cell, p, tracer = run.cell, run.pipeline, run.tracer
    n = run.buffers.shape[0]
    stats0, mc0 = program.stats(p), p.max_candidates
    raw, sbs, out = [], [], Collector()
    s_clock, ms_clock = program.RecordingClock(), program.RecordingClock(1000)
    h, tracker = program.hub(p, cell.config["hub"], out=out, raw_sink=raw.append,
                             sbs_sink=sbs.append, clock=s_clock, msclock=ms_clock)
    lock = threading.RLock()
    # each message as the tuple of its field values (atomic values, which
    # the cyclic GC stops tracking: retained message objects would grow its
    # full collections through the window, a cost of the harness's)
    messages, marks, ends, names = [], [], [], []
    arrived = np.full(n, np.nan)
    hub_s = [0.0]   # seconds in the hub before the profiler slice
    delivered = [0]   # markers arrived: the buffers whose messages are all out
    samples0 = p.samples_in
    run.clock.tag = lambda: (p.samples_in, delivered[0])
    gc_meter = GcMeter()
    annotate = None
    if cell.trace:
        from torch.profiler import record_function as annotate

    def progress() -> int:
        return feed.count

    def emit(mm) -> None:
        t = time.perf_counter()   # the message reaches the hub
        if annotate is None:
            with lock:
                h.use_message(mm)
        else:
            with lock, annotate("bench.hub"):
                h.use_message(mm)
            if tracer.started_at is None:
                hub_s[0] += time.perf_counter() - t
        fields = vars(mm)
        if not names:
            names.append(tuple(fields))
        messages.append(tuple(fields.values()))
        ends.append((len(raw), len(sbs), len(out.parts)))
        marks.append(air.is_marker(mm))
        if marks[-1]:
            delivered[0] += 1
            k = air.marker_seq(mm.msg) - run.first_seq
            if 0 <= k < n and np.isnan(arrived[k]):
                arrived[k] = t
        tracer.tick(progress)

    gc_meter.start()
    t0 = time.perf_counter()
    feed = Feed(run.buffers, run.period, t0, annotate)
    tracer.begin(t0)
    p.run_source_device(feed, emit)
    t1 = time.perf_counter()
    gc_meter.stop()
    run.clock.tag = None
    tracer.stop(progress)
    tracer.finish()
    run.window_s = t1 - t0
    run.trace = tracer.trace
    # the host-clock readings of a traced run come from before its
    # profiler slice, which slows the host while it runs
    cut = tracer.started_at if tracer.started_at is not None else t1
    lost = np.isnan(arrived)
    # a buffer whose marker never came is taken as arriving at the close
    latency = np.where(lost, t1, arrived) - feed.due
    lag = feed.taken - feed.due
    worst, late = int(np.nanargmax(lag)), int(np.nanargmax(latency))
    diag = [gc_meter.line(),
            f"ingest lag: longest {lag[worst] * 1e3:.3f} ms, buffer {worst} "
            f"({feed.due[worst] - t0:.3f} s into the window); buffers over 100 ms: "
            f"{int(np.sum(lag > 0.1))}",
            f"latency: longest {latency[late] * 1e3:.3f} ms, buffer {late} "
            f"({feed.due[late] - t0:.3f} s into the window); buffers over 200 ms: "
            f"{int(np.sum(latency > 0.2))}"]
    run.extra.update(
        t0=t0, shapes=f"candidate slots a buffer {mc0} -> {p.max_candidates}",
        latency_s=latency, lost=lost, ingest_lag_s=(feed.taken - feed.due)[feed.taken < cut],
        hub_s=hub_s[0], hub_buffers=int(np.sum(arrived < cut)),
        messages=messages, marks=marks, field_names=names[0] if names else None, ends=ends,
        raw=raw, sbs=sbs, display=out.parts,
        aircraft=[tuple(getattr(a, f) for f in AIRCRAFT_FIELDS) for a in tracker.aircraft],
        tracker_s=s_clock.values, tracker_ms=ms_clock.values,
        stats=tuple(b - a for a, b in zip(stats0, program.stats(p))),
        latency_p50_s=percentile(latency, 50), latency_p95_s=percentile(latency, 95),
        samples0=samples0, clock_values=list(run.clock.values), clock_tags=list(run.clock.tags),
        diag=diag,
    )


def release(run: Run) -> None:
    run.extra.pop("pipeline", None)
    run.extra.pop("tracer", None)
    program.release_device()


class _Replay:
    """Values recorded in a run, handed back in order (0 once spent)."""

    def __init__(self, values):
        self.values, self.i = values, 0

    def __call__(self) -> int:
        self.i += 1
        return self.values[self.i - 1] if self.i <= len(self.values) else 0


def reference(buffers: np.ndarray, nows, cache0, tracker_s, tracker_ms, hub_settings: dict, *,
              phase_correction: bool = True):
    """The reference's messages over `buffers`, buffer b resolved at the
    clock value nows[b] from the ICAO cache `cache0` (addresses, seconds),
    with what its hub makes of each (raw-out lines, SBS lines, display
    text), its aircraft table and its counters."""
    cands = demod.demodulate(buffers, phase_correction=phase_correction)
    clock = decoder.Clock()
    cache = decoder.IcaoCache(clock)
    cache.addr, cache.ts = list(cache0[0]), list(cache0[1])
    stats = decoder.Stats()
    tracker = ref_hub.AircraftTracker(_Replay(tracker_s), _Replay(tracker_ms))
    h = ref_hub.Hub(tracker, raw=hub_settings["raw"], net=hub_settings["net"],
                    sbs_connections=hub_settings["sbs_connections"])
    messages, marks, outputs = [], [], []

    def emit(b, mm):
        messages.append(tuple(getattr(mm, f) for f in decoder.MESSAGE_FIELDS))
        marks.append(air.is_marker(mm))
        outputs.append(h.use_message(mm))

    def on_buffer(b):
        clock.now = nows[b]

    decoder.walk(cands, cache, decoder.DecoderConfig(), stats, emit, fields=True,
                 on_buffer=on_buffer)
    table = [tuple(getattr(a, f) for f in AIRCRAFT_FIELDS) for a in tracker.aircraft]
    return messages, marks, outputs, table, stats.as_tuple()


def _by_buffer(messages, marks, outputs, n: int) -> dict:
    """Messages (fields, outputs) grouped by buffer: a marker closes its
    buffer, and what follows the last marker counts to the last buffer."""
    out, k = {}, 0
    for fields, mark, o in zip(messages, marks, outputs):
        out.setdefault(min(k, n - 1), []).append((fields, o))
        k += mark
    return out


def compare(got, want, n: int) -> tuple[dict, set, list]:
    """The check numbers, the buffers that differ, and notes, for two
    (messages, marks, outputs, aircraft table, counters)."""
    notes = []
    by_g, by_w = _by_buffer(*got[:3], n), _by_buffer(*want[:3], n)
    got_table, got_stats, want_table, want_stats = got[3], got[4], want[3], want[4]
    bad_fields = bad_out = 0
    bad = set()
    for k in range(n):
        g, w = by_g.get(k, []), by_w.get(k, [])
        f = sum(a[0] != b[0] for a, b in zip(g, w)) + abs(len(g) - len(w))
        o = sum(a[1] != b[1] for a, b in zip(g, w)) + abs(len(g) - len(w))
        bad_fields += f
        bad_out += o
        if f or o:
            bad.add(k)
            if len(notes) < 3:
                notes.append(f"buffer {k}: {len(g)} messages, {len(w)} expected; "
                             f"{f} differ in fields, {o} in output")
    table = sum(a != b for a, b in zip(got_table, want_table)) + abs(len(got_table) - len(want_table))
    counters = sum(a != b for a, b in zip(got_stats, want_stats))
    if table:
        notes.append(f"{table} aircraft differ ({len(got_table)} tracked, {len(want_table)} expected)")
    if counters:
        notes.append(f"counters {got_stats} vs the reference's {want_stats}")
    return ({"messages_differing": bad_fields, "outputs_differing": bad_out,
             "aircraft_differing": table, "counters_differing": counters}, bad, notes)


def check(run: Run) -> Verdict:
    n = run.buffers.shape[0]
    v = Verdict(attempted=n, failed=0)
    try:
        # one buffer a dispatch group
        nows = group_nows(run.clock_values, run.clock_tags, n, run.samples0)
    except ValueError as e:
        v.notes.append(f"the program's clock reads fit no dispatch order: {e}")
        return v
    ends = [(0, 0, 0)] + run.ends
    got_out = [(run.raw[a[0]:b[0]], run.sbs[a[1]:b[1]], "".join(run.display[a[2]:b[2]]))
               for a, b in zip(ends, ends[1:])]
    if run.field_names not in (None, decoder.MESSAGE_FIELDS):
        v.notes.append(f"the program's messages have the fields {run.field_names}")
        return v
    want = reference(run.buffers, nows, run.cache0, run.tracker_s, run.tracker_ms,
                     run.cell.config["hub"])
    got = (run.messages, run.marks, got_out, run.aircraft, run.stats)
    nums, bad, notes = compare(got, want, n)
    lost = set(np.nonzero(run.lost)[0].tolist())
    v.failed = len(bad | lost)
    v.checks.append(Check("buffers_lost", len(lost), 0))
    for name, value in nums.items():
        v.checks.append(Check(name, value, 0))
    v.notes += notes
    return v


def control(cell) -> Verdict:
    """The control: the reference with the phase-corrected retry left out
    (a guarantee broken) in the program's place, over the buffers of a
    window, from the window's starting cache, and held to check() as a
    run is."""
    period = _period(cell)
    n = int(cell.seconds / period)
    bufs = air.paced_buffers(cell.seed, n, cell.traffic)
    now = int(time.time())
    cache0 = start_cache(cell, now)
    # a clock read a buffer, one second a second; tracker clocks read back
    # identically on both sides
    nows = [now + int(k * period) for k in range(n)]
    reads = len(reference(bufs, nows, cache0, [], [], cell.config["hub"])[0])
    s_vals = [now + int(i * 0.001) for i in range(reads)]
    ms_vals = [now * 1000 + i for i in range(reads)]
    messages, marks, outputs, table, stats = reference(
        bufs, nows, cache0, s_vals, ms_vals, cell.config["hub"], phase_correction=False)
    raw, sbs, display, ends = [], [], [], []
    for r, s, text in outputs:
        raw += r
        sbs += s
        display.append(text)
        ends.append((len(raw), len(sbs), len(display)))
    msg_at = decoder.MESSAGE_FIELDS.index("msg")
    seqs = {air.marker_seq(m[msg_at]) for m, mark in zip(messages, marks) if mark}
    run = Run(cell, extra=dict(
        buffers=bufs, cache0=cache0, messages=messages, marks=marks, ends=ends, raw=raw, sbs=sbs,
        display=display, aircraft=table, stats=stats, field_names=decoder.MESSAGE_FIELDS,
        lost=np.array([k not in seqs for k in range(n)]), tracker_s=s_vals, tracker_ms=ms_vals,
        samples0=0, clock_values=nows,
        clock_tags=[((k + 1) * modes.BLOCK_SAMPLES, k) for k in range(n)]))
    return check(run)
