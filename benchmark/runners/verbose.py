"""The plain archive decode, `dump1090 --ifile <capture>`: every CRC-good
message's verbose display, through DemodPipeline.run_device(stream, emit)
with emit the MessageHub.use_message that cli.main builds for a plain
--ifile (HubConfig(): not raw, CRC checked, no net, no SBS or HTTP client,
so the tracker does not run).

The input is runners/stream.py's Air, cycled as for archive_raw: the
streaming ingest, dispatch depth 3, the unpacked emission, the host field
decode of every attempted message, the display of the good ones.  The
hub's `out` is a sink that joins each batch's text and keeps its CRC-32
and length, and the first two groups' text whole: the window's ~1.2
million messages leave nothing behind, so the cyclic collector's work does
not grow with what the harness holds.  A batch ends when the pipeline's
lock, held once around each batch's emit calls, is released: there the
runner first takes the time and the hub's displayed counter, then the
sink closes the batch and the tracer is ticked (its slice starts at a
group's end).  The emit callback takes the lock per message as
cli.main's does.

The check replays the reference over the same air, group by group at the
clock value each was resolved with (runners/stream.py's scheme), and holds
every batch's display text, the 8 counters and, where the program has
them, the hub's display counters to it.
"""

from __future__ import annotations

import threading
import time
import zlib

import numpy as np

from benchmark import air, program, spans
from benchmark.harness import Check, GcMeter, Run, Verdict, group_nows
from benchmark.reference import decoder, demod, hub as ref_hub, modes
from benchmark.runners.stream import Air, _shape, release  # noqa: F401
from benchmark.trace import Tracer

# the hub's display counters (models/hub.py), in the order compared
COUNTERS = ("crc_dropped", "displayed", "written")
REPLAY = "pipeline.replay"
MAIN_SPANS = ("ingest.wait", "issue", "fetch.wait", "decode", "emit")


class BatchLock:
    """The pipeline's reentrant lock, which calls `on_batch()` each time
    its outermost hold ends: run_device holds it once around each batch's
    emit calls.  `inner` is the plain lock the emit callback takes."""

    def __init__(self, on_batch):
        self.inner = threading.RLock()
        self.on_batch = on_batch
        self._depth = 0

    def __enter__(self):
        self.inner.acquire()
        self._depth += 1
        return self

    def __exit__(self, exc_type, *exc) -> bool:
        self._depth -= 1
        try:
            if self._depth == 0 and exc_type is None:
                self.on_batch()
        finally:
            self.inner.release()
        return False


class BatchSink:
    """The hub's `out`: the text of the batch being emitted; end_batch()
    keeps its (CRC-32, length), and the text itself for the first `keep`
    batches."""

    def __init__(self, keep: int):
        self.keep = keep
        self.parts: list[str] = []
        self.digests: list[tuple[int, int]] = []
        self.head: list[bytes] = []

    def write(self, s: str) -> None:
        self.parts.append(s)

    def flush(self) -> None:
        pass

    def end_batch(self) -> None:
        text = "".join(self.parts).encode()
        self.parts = []
        self.digests.append((zlib.crc32(text), len(text)))
        if len(self.head) < self.keep:
            self.head.append(text)


class _NullSink:
    def write(self, s: str) -> None:
        pass

    def flush(self) -> None:
        pass


class GcByGeneration(GcMeter):
    """GcMeter that also sums the seconds of each generation's
    collections."""

    def __init__(self):
        super().__init__()
        self.gen_seconds = [0.0, 0.0, 0.0]

    def _cb(self, phase, info):
        if phase != "start" and self._t is not None:
            self.gen_seconds[info["generation"]] += time.perf_counter() - self._t
        super()._cb(phase, info)


def hub_counters(h) -> tuple | None:
    """The hub's display counters, or None on a program without them."""
    values = tuple(getattr(h, c, None) for c in COUNTERS)
    return None if None in values else values


def _hub(p, hub_settings: dict, out):
    """MessageHub as cli.main builds it for a plain --ifile (the
    configuration's `hub`: no net, not raw, no SBS client)."""
    h, _ = program.hub(p, hub_settings, out=out, raw_sink=None, sbs_sink=None,
                       clock=program.RecordingClock(), msclock=program.RecordingClock(1000))
    return h


def _span_lines(t0_ns: int) -> list[str]:
    """The replay marks recorded before and after `t0_ns`, and each main
    thread span's and the reader's time a buffer over the window's groups
    (benchmark/spans.py's cut), from the program's spans."""
    got = spans.recorded()
    if got is None:
        return ["spans: none recorded (the program has no recorder)"]
    marks = [s.start_ns for s in got[0] if s.name == REPLAY]
    lines = [f"replay marks: {sum(t < t0_ns for t in marks)} in the set-up, "
             f"{sum(t >= t0_ns for t in marks)} in the window"]
    read = spans.groups(got[0], t0_ns)
    parts = [f"{name} {v * 1e6:.1f}" for name, v in
             [(n, spans.per_buffer(read, ("pipeline." + n,))) for n in MAIN_SPANS]
             + [("reader", spans.per_buffer(read, spans.INGEST, reader_thread=True))]
             if v is not None]
    lines.append(f"spans, us a buffer over {len(read)} groups: " + ", ".join(parts))
    return lines


def prepare(cell) -> Run:
    """Set-up: the air, the pipeline, and a warm-up call of whole groups
    through a hub of its own on the same pipeline (so its shapes have grown
    to the air)."""
    nb, ng, n_blocks = _shape(cell)
    blocks, _ = air.blocks(cell.seed, n_blocks, cell.traffic)
    data = blocks.tobytes()
    clock = program.RecordingClock()
    p = program.pipeline(cell.config["settings"], cell.device, clock)
    group_bytes = nb * ng * modes.DATA_LEN_BYTES
    warm = Air(data, group_bytes, limit=int(cell.config["warmup_groups"]) * group_bytes)
    p.run_device(warm, _hub(p, cell.config["hub"], _NullSink()).use_message)
    program.reset_decode_state(p)
    clock.clear()
    tracer = Tracer(cell.trace, cell.device, start_s=0.4 * cell.seconds,
                    length_s=min(2.0, 0.3 * cell.seconds))
    tracer.warm()
    return Run(cell, extra=dict(pipeline=p, blocks=blocks, data=data, clock=clock, tracer=tracer,
                                nb=nb, ng=ng, group_bytes=group_bytes))


def measure(run: Run) -> None:
    """The window: one run_device call over the cycled air."""
    p, tracer, ng = run.pipeline, run.tracer, run.ng
    stats0, samples0, mc0 = program.stats(p), p.samples_in, p.max_candidates
    sink = BatchSink(keep=2 * ng)
    h = _hub(p, run.cell.config["hub"], sink)   # a new hub: its counters start at 0
    # at each batch's end, before the sink's and the tracer's work:
    # (perf_counter_ns, the hub's displayed counter)
    ends: list[tuple[int, int | None]] = []

    def progress() -> int:
        return p.samples_in // modes.BLOCK_SAMPLES

    def on_batch() -> None:
        ends.append((time.perf_counter_ns(), getattr(h, "displayed", None)))
        sink.end_batch()
        if tracer.started_at is not None:
            tracer.tick(progress)
        elif tracer.enabled and len(sink.digests) % ng == 0:
            # the slice starts at the first group's end after its time, where
            # the next group's issue follows (a group's batches outlast the
            # slice, and a slice inside them would see no device work), and
            # lasts its length from there
            now = time.perf_counter() - t0
            if now >= tracer.start_s:
                tracer.start_s = now
                tracer.tick(progress)

    lock = BatchLock(on_batch)
    inner, use = lock.inner, h.use_message

    def emit(mm) -> None:
        with inner:
            use(mm)

    p._lock = lock   # as cli.main passes its state lock to the pipeline
    stream = Air(run.data, run.group_bytes)
    # each clock read with what the pipeline had taken in and delivered
    run.clock.tag = lambda: (p.samples_in, len(sink.digests) // ng)
    gc_meter = GcByGeneration()
    gc_meter.start()
    t0 = time.perf_counter()
    stream.stop_at = t0 + run.cell.seconds
    tracer.begin(t0)
    p.run_device(stream, emit)
    t1 = time.perf_counter()
    gc_meter.stop()
    run.clock.tag = None
    tracer.stop(progress)
    tracer.finish()
    run.window_s = t1 - t0
    run.trace = tracer.trace
    hub_delta = hub_counters(h)
    diag = [gc_meter.line(),
            f"gc generation 2 in the window: {gc_meter.count[2]} collections, "
            f"{gc_meter.gen_seconds[2]:.4f} s, {100 * gc_meter.gen_seconds[2] / run.window_s:.3f}% "
            "of the window"]
    diag += _span_lines(int(t0 * 1e9))
    diag.append("hub counters: none (the program has none)" if hub_delta is None else
                "hub counters in the window: " + ", ".join(f"{c} {v}" for c, v in zip(COUNTERS, hub_delta)))
    group_ends = [t for t, _ in ends[ng - 1 :: ng]]
    if len(group_ends) > 1:
        g = np.diff(np.array([int(t0 * 1e9)] + group_ends)) / 1e9
        diag.append(f"groups: {len(g)}, seconds a group: first {g[0]:.3f}, then min {g[1:].min():.3f}, "
                    f"median {np.median(g[1:]):.3f}, max {g[1:].max():.3f}")
    if run.trace is not None and run.trace.window_s > 0:
        diag.append(f"slice: {run.trace.done} buffers in {run.trace.window_s:.4f} s")
    run.extra.update(
        t0=t0, samples=p.samples_in - samples0, digests=sink.digests, head=sink.head,
        stats=tuple(b - a for a, b in zip(stats0, program.stats(p))), hub=hub_delta,
        batch_ends=ends,
        shapes=f"candidate slots a buffer {mc0} -> {p.max_candidates}",
        buffers=(p.samples_in - samples0) // modes.BLOCK_SAMPLES,
        samples0=samples0, clock_values=list(run.clock.values), clock_tags=list(run.clock.tags),
        diag=diag,
    )


def reference_groups(blocks: np.ndarray, nb: int, ng: int, nows, *,
                     phase_correction: bool = True):
    """The reference's display text of each batch of len(nows) groups over
    the cycled blocks, group g resolved at the clock value nows[g]; its 8
    counters over them; and the hub's display counters (CRC drops,
    messages displayed, characters written)."""
    bufs = air.frame_buffers(blocks)
    steady0 = bufs[:1].copy()
    steady0[0, : modes.CARRY_BYTES] = blocks[-1, modes.DATA_LEN_BYTES - modes.CARRY_BYTES :]
    first = demod.demodulate(bufs, phase_correction=phase_correction)
    kinds = (first, demod.splice(first, demod.demodulate(steady0, phase_correction=phase_correction)))
    clock = decoder.Clock()
    cache = decoder.IcaoCache(clock)
    cfg = decoder.DecoderConfig()
    memo = {}
    batches = []
    total = np.zeros(len(decoder.STAT_FIELDS), dtype=np.int64)
    hub_total = np.zeros(len(COUNTERS), dtype=np.int64)
    for g, now in enumerate(nows):
        kind = min(g, 1)
        clock.now = now
        key = (kind, cache.key())
        if key not in memo:
            texts = [[] for _ in range(ng)]
            counts = [0, 0, 0]
            stats = decoder.Stats()

            def emit(b, mm, texts=texts, counts=counts):
                if not mm.crcok:
                    counts[0] += 1
                    return
                text = ref_hub.display_message(mm) + "\n"
                texts[b // nb].append(text)
                counts[1] += 1
                counts[2] += len(text)

            cache.writes = set()
            decoder.walk(kinds[kind], cache, cfg, stats, emit, fields=True)
            memo[key] = ([("".join(x)).encode() for x in texts], stats.as_tuple(), tuple(counts),
                         list(cache.addr), sorted(cache.writes))
        out, st, counts, after, writes = memo[key]
        cache.addr = list(after)
        for h in writes:
            cache.ts[h] = now
        batches += out
        total += st
        hub_total += counts
    return batches, tuple(int(v) for v in total), tuple(int(v) for v in hub_total)


def check(run: Run) -> Verdict:
    """Every batch's display text, the 8 counters and the hub's display
    counters against the reference."""
    nb, ng = run.nb, run.ng
    v = Verdict(attempted=int(run.buffers), failed=0)
    if len(run.digests) % ng:
        v.notes.append(f"{len(run.digests)} batches are not whole groups of {ng}")
        return v
    groups = len(run.digests) // ng
    try:
        nows = group_nows(run.clock_values, run.clock_tags, groups, run.samples0)
    except ValueError as e:
        v.notes.append(f"the program's clock reads fit no dispatch order: {e}")
        return v
    want, counters, hub_want = reference_groups(run.blocks, nb, ng, nows)
    differ = [k for k, (d, w) in enumerate(zip(run.digests, want))
              if d != (zlib.crc32(w), len(w)) or (k < len(run.head) and run.head[k] != w)]
    v.failed = len(differ) * nb
    v.checks.append(Check("batches_differing", len(differ), 0))
    v.checks.append(Check("counters_differing", sum(a != b for a, b in zip(run.stats, counters)), 0))
    if run.hub is not None:
        v.checks.append(Check("display_differing", sum(a != b for a, b in zip(run.hub, hub_want)), 0))
        if tuple(run.hub) != hub_want:
            v.notes.append(f"hub counters {run.hub} vs the reference's {hub_want}")
    if differ:
        k = differ[0]
        got = run.head[k] if k < len(run.head) else None
        v.notes.append(f"batch {k} of {len(want)} differs: {len(want[k])} bytes expected, "
                       f"{run.digests[k][1]} produced"
                       + (f"; first lines {got[:96]!r} vs {want[k][:96]!r}" if got is not None else ""))
    if any(a != b for a, b in zip(run.stats, counters)):
        v.notes.append(f"counters {run.stats} vs the reference's {counters}")
    return v


def control(cell, groups: int | None = None) -> Verdict:
    """The control: the reference with the phase-corrected retry left out
    (a guarantee broken) in the program's place, over as many groups as a
    window takes at the rate measured, and held to check() as a run is."""
    nb, ng, n_blocks = _shape(cell)
    if groups is None:
        groups = max(2, round(cell.seconds * 20e6 / (nb * ng * modes.BLOCK_SAMPLES)))
    blocks, _ = air.blocks(cell.seed, n_blocks, cell.traffic)
    now = int(time.time())
    got, counters, hub = reference_groups(blocks, nb, ng, [now] * groups, phase_correction=False)
    group_samples = nb * ng * modes.BLOCK_SAMPLES
    run = Run(cell, extra=dict(
        blocks=blocks, nb=nb, ng=ng, buffers=groups * nb * ng, head=got[: 2 * ng],
        digests=[(zlib.crc32(b), len(b)) for b in got], stats=counters, hub=hub, samples0=0,
        clock_values=[now] * groups,
        clock_tags=[((g + 1) * group_samples, g) for g in range(groups)]))
    return check(run)
