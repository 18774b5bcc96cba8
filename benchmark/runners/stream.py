"""Throughput over a stream: the archive decode, `dump1090 --ifile
<capture> --raw`, through DemodPipeline.stream_raw_device.

The input is a binary stream the harness owns that behaves as a regular
file larger than the preload cap (seekable, no fileno), so the pipeline
takes the streaming ingest a long archive takes: a reader thread, one
group of lookahead, dispatch depth 3.  It cycles one dispatch group of
distinct air and returns EOF at a group boundary once the window's
seconds have passed; the pipeline then drains what is in flight, inside
the window.  Every `*<hex>;` line is produced; the harness keeps a
checksum of each batch's bytes (and the first two groups' bytes whole).

The check replays the reference over the same air: the first group
(whose first buffer carries no-signal samples) and every later group (the
same bytes, its first buffer carrying the cycle's tail), each from the
ICAO cache the previous group left and at the clock value the program
resolved that group with (so the cache's TTL is worked out again),
remembered by (group kind, cache contents and which entries are live) so
identical groups are walked once.
"""

from __future__ import annotations

import time
import zlib

import numpy as np

from benchmark import air, program
from benchmark.harness import Check, GcMeter, Run, Verdict, group_nows
from benchmark.reference import decoder, demod, modes
from benchmark.trace import Tracer


class Air:
    """A seekable binary stream with no fileno over `data` (one cycle of
    distinct air), cycled.  It ends only at a multiple of `boundary`
    bytes: after `limit` bytes, or once perf_counter() has passed
    `stop_at`."""

    def __init__(self, data: bytes, boundary: int, *, limit: int | None = None):
        self.data = data
        self.boundary = boundary
        self.limit = limit
        self.stop_at: float | None = None
        self.pos = 0

    def seekable(self) -> bool:
        return True

    def close(self) -> None:
        pass

    def read(self, size: int = -1) -> bytes:
        if self.pos % self.boundary == 0 and self.pos > 0:
            if self.limit is not None and self.pos >= self.limit:
                return b""
            if self.stop_at is not None and time.perf_counter() >= self.stop_at:
                return b""
        off = self.pos % len(self.data)
        n = len(self.data) - off if size is None or size < 0 else min(size, len(self.data) - off)
        self.pos += n
        return self.data[off : off + n]


def _shape(cell) -> tuple[int, int, int]:
    s = cell.config["settings"]
    nb, ng = int(s["batch_buffers"]), int(s["dispatch_groups"])
    n_blocks = int(cell.traffic["distinct_blocks"])
    if n_blocks % (nb * ng):
        raise ValueError(f"{n_blocks} distinct blocks are not whole groups of {nb * ng}")
    return nb, ng, n_blocks


def prepare(cell) -> Run:
    """Set-up: the air, the pipeline, and a warm-up call of whole groups
    on the same pipeline (so its shapes have grown or shrunk to the air)."""
    nb, ng, n_blocks = _shape(cell)
    blocks, _ = air.blocks(cell.seed, n_blocks, cell.traffic)
    data = blocks.tobytes()
    clock = program.RecordingClock()
    p = program.pipeline(cell.config["settings"], cell.device, clock)
    group_bytes = nb * ng * modes.DATA_LEN_BYTES
    warm = Air(data, group_bytes, limit=int(cell.config["warmup_groups"]) * group_bytes)
    for _ in p.stream_raw_device(warm):
        pass
    program.reset_decode_state(p)
    clock.clear()
    tracer = Tracer(cell.trace, cell.device, start_s=0.4 * cell.seconds,
                    length_s=min(2.0, 0.3 * cell.seconds))
    tracer.warm()
    return Run(cell, extra=dict(pipeline=p, blocks=blocks, data=data, clock=clock, tracer=tracer,
                                nb=nb, ng=ng, group_bytes=group_bytes))


def measure(run: Run) -> None:
    """The window: one stream_raw_device call over the cycled air."""
    p, tracer = run.pipeline, run.tracer
    stats0, samples0, mc0 = program.stats(p), p.samples_in, p.max_candidates
    stream = Air(run.data, run.group_bytes)
    digests, head = [], []
    keep = 2 * run.ng
    # each clock read with what the pipeline had taken in and delivered
    run.clock.tag = lambda: (p.samples_in, len(digests) // run.ng)
    gc_meter = GcMeter()

    def progress() -> int:
        return p.samples_in // modes.BLOCK_SAMPLES

    annotate = None
    if run.cell.trace:
        from torch.profiler import record_function as annotate
    gc_meter.start()
    t0 = time.perf_counter()
    stream.stop_at = t0 + run.cell.seconds
    tracer.begin(t0)
    for lines in p.stream_raw_device(stream):
        if annotate is None:
            digests.append((zlib.crc32(lines), len(lines)))
        else:
            with annotate("bench.consume"):
                digests.append((zlib.crc32(lines), len(lines)))
        if len(head) < keep:
            head.append(lines)
        tracer.tick(progress)
    t1 = time.perf_counter()
    gc_meter.stop()
    run.clock.tag = None
    tracer.stop(progress)
    tracer.finish()
    run.window_s = t1 - t0
    run.trace = tracer.trace
    diag = [gc_meter.line()]
    if run.trace is not None and run.trace.window_s > 0:
        diag.append(f"slice: {run.trace.done} buffers in {run.trace.window_s:.4f} s, "
                    f"{run.trace.done * modes.BLOCK_SAMPLES / run.trace.window_s / 1e6:.2f} "
                    "Msamples/s")
    run.extra.update(
        t0=t0, samples=p.samples_in - samples0, digests=digests, head=head,
        stats=tuple(b - a for a, b in zip(stats0, program.stats(p))),
        mc=(mc0, p.max_candidates), shapes=f"candidate slots a buffer {mc0} -> {p.max_candidates}",
        buffers=(p.samples_in - samples0) // modes.BLOCK_SAMPLES,
        samples0=samples0, clock_values=list(run.clock.values), clock_tags=list(run.clock.tags),
        diag=diag,
    )


def release(run: Run) -> None:
    run.extra.pop("pipeline", None)
    run.extra.pop("tracer", None)
    program.release_device()


def reference_groups(blocks: np.ndarray, nb: int, ng: int, nows, *,
                     phase_correction: bool = True):
    """The reference's bytes of each batch of len(nows) groups over the
    cycled blocks, group g resolved at the clock value nows[g], its
    counters over them, and each buffer's candidate positions in a later
    group (what K1's byte count reads)."""
    bufs = air.frame_buffers(blocks)
    steady0 = bufs[:1].copy()
    steady0[0, : modes.CARRY_BYTES] = blocks[-1, modes.DATA_LEN_BYTES - modes.CARRY_BYTES :]
    first = demod.demodulate(bufs, phase_correction=phase_correction)
    kinds = (first, demod.splice(first, demod.demodulate(steady0, phase_correction=phase_correction)))
    clock = decoder.Clock()
    cache = decoder.IcaoCache(clock)
    cfg = decoder.DecoderConfig()
    memo = {}
    batches, total = [], np.zeros(len(decoder.STAT_FIELDS), dtype=np.int64)
    for g, now in enumerate(nows):
        kind = min(g, 1)
        clock.now = now
        key = (kind, cache.key())
        if key not in memo:
            lines = [[] for _ in range(ng)]
            stats = decoder.Stats()

            def emit(b, mm, lines=lines):
                if mm.crcok:
                    lines[b // nb].append(decoder.raw_line(mm) + "\n")

            cache.writes = set()
            decoder.walk(kinds[kind], cache, cfg, stats, emit)
            memo[key] = ([("".join(x)).encode() for x in lines], stats.as_tuple(), list(cache.addr),
                         sorted(cache.writes))
        out, st, after, writes = memo[key]
        cache.addr = list(after)
        for h in writes:
            cache.ts[h] = now
        batches += out
        total += st
    steady = kinds[1]
    pos = [steady.pos[steady.buf == b] for b in range(blocks.shape[0])]
    return batches, tuple(int(v) for v in total), pos


def check(run: Run) -> Verdict:
    """Every batch's bytes and the 8 counters against the reference."""
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
    want, counters, pos = reference_groups(run.blocks, nb, ng, nows)
    differ = [k for k, (d, w) in enumerate(zip(run.digests, want))
              if d != (zlib.crc32(w), len(w)) or (k < len(run.head) and run.head[k] != w)]
    v.failed = len(differ) * nb
    v.checks.append(Check("batches_differing", len(differ), 0))
    v.checks.append(Check("counters_differing", sum(a != b for a, b in zip(run.stats, counters)), 0))
    if differ:
        k = differ[0]
        got = run.head[k] if k < len(run.head) else None
        v.notes.append(f"batch {k} of {len(want)} differs: {len(want[k])} bytes expected, "
                       f"{run.digests[k][1]} produced"
                       + (f"; first lines {got[:64]!r} vs {want[k][:64]!r}" if got is not None else ""))
    if any(a != b for a, b in zip(run.stats, counters)):
        v.notes.append(f"counters {run.stats} vs the reference's {counters}")
    run.extra["k1_positions"] = pos
    return v


def control(cell, groups: int | None = None) -> Verdict:
    """The control: the reference with the phase-corrected retry left out
    (a guarantee broken) in the program's place, over as many groups as a
    window takes at the rate measured, and held to check() as a run is."""
    nb, ng, n_blocks = _shape(cell)
    if groups is None:
        groups = max(2, round(cell.seconds * 270e6 / (nb * ng * modes.BLOCK_SAMPLES)))
    blocks, _ = air.blocks(cell.seed, n_blocks, cell.traffic)
    now = int(time.time())
    got, counters, _ = reference_groups(blocks, nb, ng, [now] * groups, phase_correction=False)
    group_samples = nb * ng * modes.BLOCK_SAMPLES
    run = Run(cell, extra=dict(
        blocks=blocks, nb=nb, ng=ng, buffers=groups * nb * ng, head=got[: 2 * ng],
        digests=[(zlib.crc32(b), len(b)) for b in got], stats=counters, samples0=0,
        clock_values=[now] * groups,
        clock_tags=[((g + 1) * group_samples, g) for g in range(groups)]))
    return check(run)
