"""End-to-end decode: IQ bytes -> `*<hex>;` lines or ModesMessage objects
(port of dump1090_tpu/models/pipeline.py), by two strategies.

Device resolve (stream_raw_device, the --raw/--stats path; run_device; and
run_source_device, live buffers): the demodulator AND the sequential
resolver run on the card.  Groups of
`dispatch_groups` x `batch_buffers` buffers are uploaded, and each group
runs ops.resolve.demod_resolve_group with the ICAO cache chained on the
device from one group to the next; on CUDA a dispatch shape's second and
later groups replay that dispatch as one CUDA graph
(models/dispatch_graph.py).  At most `dispatch_ahead` groups are in
flight: the oldest is fetched once one more is issued, or as soon as no
next input waits (a live source between buffers, a reader thread behind),
so a live buffer's results never wait on the next buffer.  A group's small
outputs are copied into pinned host memory with non-blocking copies and
one CUDA event, so the host formats group k while the device computes
k+1..k+depth.  Exact counts come back with the data; a group that
overflowed its shapes grows them (models/shapes.py) and is replayed, with
every group behind it, from the cache state it started from.

Host resolve (run, run_source, messages, stream_records): the card
demodulates `batch_buffers` buffers per dispatch (ops.demod.demod_batch, K1
inside) and the host replays the sequential scan, with the C++ runtime
(native/) or, for the --debug dumps, models/resolver.py.  Buffer N+1's
demodulation and the fetch of its candidates are enqueued before the host
waits on buffer N's, so the host resolves N while the card demodulates N+1,
like the reference's reader/decoder thread pair (dump1090.c:436-527).  A
buffer whose exact preamble count overflows the candidate shape is
demodulated again alone at 4x (sticky), never truncated.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import os
import queue
import sys
import threading
from dataclasses import dataclass, field
from typing import BinaryIO, Callable, Iterator

import numpy as np
import torch

from .. import resolve_device
from ..constants import BLOCK_SAMPLES, BUF_SAMPLES, FULL_LEN_SAMPLES
from ..io.raw_lines import raw_lines_from_fields
from ..io.sources import iq_buffers
from ..ops.demod import (
    Candidates,
    check_front,
    demod_batch,
    demod_block,
    demod_iq_block,
    front_variant,
    preamble_reject_stages,
)
from ..ops.magnitude import magnitude_from_iq
from ..ops.resolve import demod_resolve_group, interleave_packed
from ..utils import spans
from .decoder import (
    STAT_FIELDS,
    DecoderConfig,
    DecoderStats,
    IcaoCache,
    ModesMessage,
    messages_from_device_arrays,
)
from .dispatch_graph import DispatchGraphs, dispatch_key
from .resolver import BlockCandidates, DebugContext, resolve_block
from .shapes import Shapes, peaks
from .state import cache_from_device, cache_to_device, state_from_numpy, state_to_numpy


@dataclass
class PipelineConfig:
    decoder: DecoderConfig = field(default_factory=DecoderConfig)
    # Preamble candidates per buffer the device stages are shaped for; a
    # buffer with more is detected by its exact count, the group is replayed
    # at 4x, and the session keeps the larger shape.
    max_candidates: int = 256
    # Buffers per batch: one emission record per batch on the device path,
    # one demod dispatch on the host path (the CLI takes 16 for files there;
    # 1 is the lowest latency for live feeds).  Output is identical.
    batch_buffers: int = 1
    # --loop: read a seekable source again from its start at EOF, forever.
    loop: bool = False
    # Seconds slept per buffer fill: the reference's --interactive playback
    # brake for --ifile (usleep(5000) per 65.5 ms buffer, dump1090.c:471-477).
    throttle_s: float = 0.0
    # Batches per dispatch group (one device program sequence, one fetch).
    dispatch_groups: int = 1
    # Ingest strategy for regular files: "auto" uploads every group of a
    # file up to PRELOAD_CAP_BYTES before the first dispatch (never for a
    # looped or throttled source); "staged" uploads one group, dispatches
    # it, and uploads the rest on a reader thread meanwhile (for the first
    # message: the decode starts before the file is resident); "off" always
    # streams through a reader thread (one group of lookahead).
    preload: str = "auto"
    # The most dispatch groups in flight: the oldest is fetched once one
    # more is issued, or as soon as no next input waits.  0 = auto: 3 for
    # seekable sources under preload "auto" or "off"; 1 under "staged",
    # whose point is the first message, and for streams, live buffers and
    # looped or throttled sources, where two more groups of latency would
    # break the live cadence.  Output is identical at every depth.
    dispatch_ahead: int = 0
    # Preamble-scan formulation of every front call: "mask" or
    # "packed[-plain][-mxu]" (ops.demod.front_candidates), all
    # bit-identical; None takes DUMP1090_TPU_FRONT, else "mask".
    front: str | None = None


class _Fetch:
    """A group's outputs on their way to the host.

    On CUDA: pinned host tensors filled by non-blocking copies, and one
    event recorded after them; `get` waits on that event only.  On the CPU
    the tensors are already on the host."""

    def __init__(self, tensors):
        self.event = None
        if tensors[0].device.type == "cuda":
            host = []
            for t in tensors:
                h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                h.copy_(t, non_blocking=True)
                host.append(h)
            self.event = torch.cuda.Event()
            self.event.record()
            tensors = host
        self.tensors = tensors

    def get(self) -> list[np.ndarray]:
        if self.event is not None:
            self.event.synchronize()
        return [t.numpy() for t in self.tensors]


class _Groups:
    """The dispatch groups of DemodPipeline._ingest_groups, in order, with
    a probe that never blocks: ready() is true when the next group, or the
    end of the input, can be taken at once.  That always holds for groups
    in hand (a preloaded file's); groups from the reader thread (the staged
    tail, streamed and live input) are ready once it has queued one."""

    def __init__(self):
        self.gen = None
        self.queue: queue.Queue | None = None

    def __iter__(self) -> _Groups:
        return self

    def __next__(self):
        return next(self.gen)

    def ready(self) -> bool:
        return self.queue is None or not self.queue.empty()

    def close(self) -> None:
        self.gen.close()


@dataclass(slots=True)
class _InFlight:
    """A dispatch group on the device path, from its dispatch to its
    delivery; the cache states are (addr, ts), `shapes` a Shapes.key."""

    xg: torch.Tensor
    state_before: tuple
    fetch: _Fetch
    state_after: tuple
    shapes: tuple
    gid: int
    n_bufs: int


def _upload(x: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host IQ bytes to the device: through pinned memory with a
    non-blocking copy on CUDA, so the upload does not wait for the
    demodulation already in flight."""
    t = torch.from_numpy(x)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


class DemodPipeline:
    """Streaming demodulator over reference-geometry IQ buffers, on the
    device given by `device` (CUDA unless "cpu" is asked for)."""

    # a regular file this large or smaller is uploaded whole before the
    # first dispatch (overridable via DUMP1090_TPU_PRELOAD_BYTES); larger or
    # unseekable sources stream through a reader thread instead
    PRELOAD_CAP_BYTES = 1536 << 20

    def __init__(self, cfg: PipelineConfig | None = None, clock=None,
                 device: str | torch.device | None = None, lock=None, *,
                 native: bool | None = None, debug_flags=None, debug_out=None):
        self.cfg = cfg or PipelineConfig()
        if self.cfg.preload not in ("auto", "staged", "off"):
            raise ValueError(f"preload: expected auto|staged|off, got {self.cfg.preload!r}")
        # an unknown front name fails here, not at the first dispatch
        self._front = self.cfg.front or front_variant()
        check_front(self._front)
        self.device = resolve_device(device)
        # held around each batch's emit calls (and, on the host path, around
        # each resolve step, which mutates the shared cache and stats): a
        # caller that also decodes raw network input on another thread
        # passes the same (reentrant) lock, so the two paths never
        # interleave inside the tracker, the cache or stdout, like the
        # single-threaded reference that polls its sockets between buffers
        # (dump1090.c:2831-2847)
        self._lock = lock if lock is not None else contextlib.nullcontext()
        # working shapes (models/shapes.py), on the INSTANCE so a shared
        # PipelineConfig is not mutated
        self.shapes = Shapes(self.cfg.max_candidates)
        # the device path's CUDA graphs, one a dispatch shape
        # (models/dispatch_graph.py); on the CPU every dispatch runs eagerly
        self._graphs = DispatchGraphs() if self.device.type == "cuda" else None
        self.stats = DecoderStats()
        self.samples_in = 0      # new samples demodulated (throughput meter)
        self.cache = IcaoCache(clock=clock)
        self.debug_flags = debug_flags  # utils.debug.DebugFlags | None
        self.debug_out = debug_out
        # host resolver: the C++ runtime (native=None tries it, True
        # requires it, False refuses it); the demod-dump flags (dDcCpj)
        # take the Python replay, network debugging ('n') keeps native
        self._native = None
        if native is not False and not self._debugging:
            from ..native import NativeResolver

            try:
                self._native = NativeResolver()
            except (OSError, RuntimeError) as e:
                if native is True:
                    raise
                sys.stderr.write(f"dump1090_tpu_torch: native runtime unavailable ({e}); "
                                 "using the Python resolver\n")
        # --debug p prints the scratch msg buffer's stale content; in the
        # reference that is the previous detectModeS call's last sliced
        # message (the same stack frame is reused), so it carries across
        # buffers.  Before the very first slice it is C garbage, where zeros
        # are printed (documented divergence).
        self._debug_last_msg = None

    @property
    def max_candidates(self) -> int:
        """The candidate slots a buffer has now: cfg.max_candidates until
        the device paths shrink it on quiet air or grow it on overflow."""
        return self.shapes.mc

    @property
    def _debugging(self) -> bool:
        return self.debug_flags is not None and self.debug_flags.any_demod_dump

    def load_state(self, state) -> None:
        """Adopt a models.state.DecodeState: its ICAO cache and counters."""
        self.cache.addr[:], self.cache.ts[:], counts = state_to_numpy(state)
        for name, v in zip(STAT_FIELDS, counts.tolist()):
            setattr(self.stats, name, v)

    def state(self):
        """The pipeline's ICAO cache and counters as a DecodeState."""
        return state_from_numpy(self.cache.addr, self.cache.ts, self.stats, self.device)

    def stream_raw_device(self, stream: BinaryIO) -> Iterator[bytes]:
        """Yield the `*<hex>;\\n` bytes of each batch, in stream order, with
        both the demodulation and the sequential resolve on the device; the
        host only re-interleaves the packed short/long frame rows and
        formats hex."""
        batches = self._device_batches(stream, packed=True)
        try:
            for group, b, (count, count_long, shorts, longs) in batches:
                with spans.span("pipeline.format", group, b, count):
                    msg, bits = interleave_packed(count, count_long, shorts, longs)
                    lines = raw_lines_from_fields(msg, bits, np.ones(msg.shape[0], dtype=bool))
                # the caller's time with this batch
                with spans.span("pipeline.consumer", group, b, count):
                    yield lines
        finally:
            batches.close()

    def run_source_device(self, buffers, emit: Callable[[ModesMessage], None]) -> None:
        """Device-resolve twin of run_source: decode an iterable of
        pre-framed uint8[BUF_BYTES] buffers (a live io.rtlsdr.RtlSdrSource)
        with the demodulation and the sequential resolve on the device.  With
        the live defaults (batch_buffers=1, dispatch_groups=1) buffer N+1 is
        uploaded on the ingest thread while buffer N resolves on the device,
        like the reference's rtlsdrCallback -> detectModeS hand-off
        (dump1090.c:442-458, 2968-2990); buffer N is fetched while N+1 is
        still on its way from the radio."""
        self.run_device(None, emit, buffers=buffers)

    def run_device(self, stream: BinaryIO | None, emit: Callable[[ModesMessage], None],
                   buffers=None) -> None:
        """Full-fidelity device path: every message the reference hands to
        useModesMessage (good AND bad CRC), as ModesMessage objects in scan
        order, with demod + sequential resolve on the device, over `stream`
        or, when given, the pre-framed `buffers`.  The field decode on the
        host is stateless (models/decoder.py message_from_device): every
        cache/CRC decision arrives in the per-message meta word.  The emit
        calls of each batch run under the pipeline's lock.  However the
        decode ends (the end of the input, an exception, KeyboardInterrupt),
        the device's ICAO cache is synced back to the host cache before
        this returns."""
        batches = self._device_batches(stream, packed=False, buffers=buffers)
        try:
            for group, b, (meta_h, msg_h) in batches:
                with spans.span("pipeline.decode", group, b, len(meta_h)):
                    mms = messages_from_device_arrays(msg_h, meta_h)
                if not mms:
                    continue
                with spans.span("pipeline.emit", group, b, len(mms)), self._lock:
                    for mm in mms:
                        emit(mm)
        finally:
            batches.close()

    def _device_batches(self, stream: BinaryIO | None, *, packed: bool, buffers=None):
        """Dispatch GROUPS of batches chained through the device-resident
        ICAO cache, fetch each group's emissions in one transfer, detect
        overflow by exact counts and replay from the pre-group state with
        sticky shape growth.  Yields per batch (group, batch, payload): the
        group's sequence number (utils.spans), the batch's index in it, and
        (count, count_long, shorts, longs) when packed (see
        ops.resolve.interleave_packed), else (meta[count], msg[count, 14]).
        The buffers come from `stream`, or from the iterable `buffers` when
        given (a live source: no preload, auto depth 1).  At most `depth`
        groups are in flight, and the oldest is fetched as soon as no next
        group is ready (_Groups.ready), marked pipeline.fetch.early; with
        input always ready, a group waits for `depth` more.  The device cache
        is synced back to the host cache when the generator ends or is
        closed only, so raw network input decoded on the host meanwhile
        sees the host cache as it was before the decode; stats accumulate
        into self.stats.

        Clock granularity: `now` is sampled once per dispatch group, like
        the JAX package's device path."""
        nb = max(self.cfg.batch_buffers, 1)
        ng = max(self.cfg.dispatch_groups, 1)
        shapes, dcfg = self.shapes, self.cfg.decoder
        shapes.size(nb)
        pending: collections.deque[_InFlight] = collections.deque()
        # the cache state after the last group whose results were delivered
        delivered = cache_to_device(self.cache.addr, self.cache.ts, self.device)

        def tail():
            """The cache state the next group dispatched starts from."""
            return pending[-1].state_after if pending else delivered

        def dispatch(xg, cache_addr, cache_ts, now):
            # packed (the raw path): good-CRC decodes only; unpacked
            # (run_device): every attempted decode, as the hub needs
            return demod_resolve_group(
                xg, cache_addr, cache_ts, now, dcfg.fix_errors, dcfg.aggressive,
                scan_len=BUF_SAMPLES - FULL_LEN_SAMPLES,
                max_candidates=shapes.mc, max_out=shapes.mo,
                max_out_short=shapes.mos, max_out_long=shapes.mol,
                packed=packed, crcok_only=packed, front=self._front,
            )

        def issue(xg, state, gid, n_bufs, replay=False) -> _InFlight:
            """Dispatch one group from the cache `state`, and start its fetch."""
            with spans.span("pipeline.issue", gid, count=n_bufs):
                if replay:
                    spans.mark("pipeline.replay", gid, shapes.key)
                now = self.cache.clock()
                if self._graphs is None:
                    out = dispatch(xg, *state, now)
                else:
                    key = dispatch_key(xg, shapes.key, packed=packed, crcok_only=packed,
                                       front=self._front, fix_errors=dcfg.fix_errors,
                                       aggressive=dcfg.aggressive)
                    out = self._graphs.run(key, dispatch, xg, *state, now, gid)
                # the fetch starts now: it runs as soon as the group finishes,
                # while the next groups compute; the cache stays on the device
                return _InFlight(xg, state, _Fetch(out[:-2]), tuple(out[-2:]), shapes.key,
                                 gid, n_bufs)

        def finish(rec: _InFlight):
            """Fetch one group, replayed from the state it started from until
            its exact counts fit the shapes it RAN with (a shrink while it
            was in flight replays nothing); returns (the record that fit,
            its per-batch payloads)."""
            while True:
                with spans.span("pipeline.fetch.wait", rec.gid, count=rec.n_bufs):
                    host = rec.fetch.get()
                pk, before = peaks(host, packed), shapes.key
                if not shapes.fit(pk, rec.shapes, packed=packed, n_buffers=nb * ng):
                    break
                if shapes.key != before:
                    spans.mark("pipeline.reshape", rec.gid, shapes.key)
                rec = issue(rec.xg, rec.state_before, rec.gid, rec.n_bufs, replay=True)
            if shapes.shrink(pk):
                spans.mark("pipeline.reshape", rec.gid, shapes.key)
            self.stats.add(host[-1].sum(axis=0).tolist())
            rows, count = range(rec.xg.shape[0]), host[1]
            if packed:
                _, _, clong, shorts, longs, _ = host
                return rec, [(int(count[g]), int(clong[g]), shorts[g], longs[g]) for g in rows]
            _, _, msg, meta, _ = host
            return rec, [(meta[g, : count[g]], msg[g, : count[g]]) for g in rows]

        def deliver(early=False):
            """Fetch the oldest group in flight and yield its batches; if it
            was replayed, replay every group behind it, in order."""
            nonlocal delivered
            rec = pending.popleft()
            if early:
                spans.mark(spans.FETCH_EARLY, rec.gid)
            done, payloads = finish(rec)
            delivered = done.state_after
            for b, payload in enumerate(payloads):
                yield done.gid, b, payload
            if done is not rec:
                behind = list(pending)
                pending.clear()
                for r in behind:
                    pending.append(issue(r.xg, tail(), r.gid, r.n_bufs, replay=True))

        depth = self._dispatch_depth(stream, buffers)
        it = iter(buffers) if buffers is not None else iq_buffers(
            stream, loop=self.cfg.loop, throttle_s=self.cfg.throttle_s)
        groups = self._ingest_groups(stream, it, ng, nb)
        try:
            while True:
                # while no next input waits, fetch the oldest groups: the
                # host would only block on the input meanwhile
                while pending and not groups.ready():
                    yield from deliver(early=True)
                item = next(groups, None)
                if item is not None:
                    xg, n_bufs, gid = item
                    self.samples_in += n_bufs * BLOCK_SAMPLES
                    pending.append(issue(xg, tail(), gid, n_bufs))
                # at most `depth` groups in flight while the stream lives;
                # drain everything at EOF
                while len(pending) > (depth if item is not None else 0):
                    yield from deliver()
                if item is None:
                    return
        finally:
            groups.close()
            # device cache -> host cache, from the last group whose results
            # were delivered (an early close leaves later groups unvalidated)
            self.cache.addr[:], self.cache.ts[:] = cache_from_device(*delivered)

    def _dispatch_depth(self, stream, buffers) -> int:
        """PipelineConfig.dispatch_ahead, or its auto value."""
        if self.cfg.dispatch_ahead > 0:
            return self.cfg.dispatch_ahead
        seekable = False
        if buffers is None and stream is not None:
            try:
                seekable = stream.seekable()
            except (OSError, AttributeError, ValueError):
                seekable = False
        return 3 if (seekable and not self.cfg.loop and self.cfg.throttle_s == 0
                     and self.cfg.preload != "staged") else 1

    def _ingest_groups(self, stream, it, ng: int, nb: int) -> _Groups:
        """The device-resident dispatch groups (xg uint8 (g, nb, nbytes),
        n_bufs, the group's sequence number) of the buffers framed by `it`,
        uploaded, as a _Groups iterator.  A group's trailing batches that
        hold no buffer are not built: they would be all no-signal (127) and
        carry zero candidates.

        Three strategies: preload (regular files up to PRELOAD_CAP_BYTES,
        not looped or throttled) frames and uploads every group before the
        first dispatch; staged preload (the same files under preload
        "staged") uploads the first group, queues it, and uploads the rest
        on a reader thread into the same unbounded queue; streaming (stdin,
        live buffers with stream None, large files, --loop, throttled
        playback, or preload "off") frames and uploads group g+1 on a
        reader thread while the main thread dispatches and fetches g."""
        groups = _Groups()
        groups.gen = self._ingest(groups, stream, it, ng, nb)
        return groups

    def _ingest(self, groups: _Groups, stream, it, ng: int, nb: int):
        """The generator behind _ingest_groups; hands `groups` the reader
        thread's queue before the first group is taken from it."""
        dev = self.device

        def make_group(gid, bufs):
            n = len(bufs)
            with spans.span("pipeline.ingest.stack", gid, count=n):
                g_real = -(-n // nb)
                xg = np.full((g_real, nb, bufs[0].shape[0]), 127, dtype=np.uint8)
                xg.reshape(g_real * nb, -1)[:n] = np.stack(bufs)
            with spans.span("pipeline.ingest.upload", gid, count=n):
                return torch.from_numpy(xg).to(dev), n, gid

        def next_bufs():
            # a file's read and framing; a live source's wait on the radio
            gid = spans.next_group()
            with spans.span("pipeline.ingest.source", gid) as s:
                bufs = list(itertools.islice(it, ng * nb))
                s.count = len(bufs)
            return gid, bufs

        preload = False
        if (stream is not None and self.cfg.preload != "off" and not self.cfg.loop
                and self.cfg.throttle_s == 0):
            try:
                cap = int(os.environ.get("DUMP1090_TPU_PRELOAD_BYTES", self.PRELOAD_CAP_BYTES))
                preload = os.fstat(stream.fileno()).st_size <= cap and stream.seekable()
            except (OSError, AttributeError, ValueError):
                preload = False

        staged = preload and self.cfg.preload == "staged"
        if preload and not staged:
            preloaded = []
            while (got := next_bufs())[1]:
                preloaded.append(make_group(*got))
            yield from preloaded
            return

        # staged: an unbounded queue, so the reader uploads the whole tail
        # while the first groups decode; streaming: one group of lookahead
        q: queue.Queue = queue.Queue(maxsize=0 if staged else 1)
        if staged:
            got = next_bufs()
            if not got[1]:
                return
            q.put(make_group(*got))
        groups.queue = q
        stop = threading.Event()
        # a decode on a non-default stream keeps its uploads, and their
        # allocations, on that stream: the reader uploads on the consumer's
        # current stream
        upload_stream = torch.cuda.current_stream(dev) if dev.type == "cuda" else None

        def put(item) -> None:
            # retry until the consumer takes it or tears the generator down:
            # a dropped sentinel or error would leave the consumer blocked
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return
                except queue.Full:
                    continue

        def reader():
            try:
                with (torch.cuda.stream(upload_stream) if upload_stream is not None
                      else contextlib.nullcontext()):
                    while not stop.is_set():
                        gid, bufs = next_bufs()
                        put(make_group(gid, bufs) if bufs else None)
                        if not bufs:
                            return
            except BaseException as e:  # surfaced on the consumer side
                put(e)

        t = threading.Thread(target=reader, name="iq-upload", daemon=True)
        t.start()
        try:
            while True:
                with spans.span("pipeline.ingest.wait") as s:
                    item = q.get()
                    if isinstance(item, tuple):
                        s.count, s.group = item[1:]
                if item is None:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            t.join(timeout=5.0)

    # ---- host-resolve path: demod on the device, sequential resolve here ----

    def _demod(self, buf: np.ndarray, max_candidates: int | None = None):
        """Enqueue one buffer's demodulation and the fetch of its results;
        returns the work item (buf, fetch).  The fetch yields the eight
        Candidates fields and, when debugging, the magnitudes and the
        preamble reject codes (the --debug dumps read both on the host)."""
        mc = max_candidates or self.shapes.mc
        scan_len = BUF_SAMPLES - FULL_LEN_SAMPLES
        x = _upload(buf, self.device)
        if not self._debugging:
            cand = demod_iq_block(x, scan_len=scan_len, max_candidates=mc, front=self._front)
            return buf, _Fetch(list(cand))
        mag = magnitude_from_iq(x)
        cand = demod_block(mag, scan_len=scan_len, max_candidates=mc, front=self._front)
        rej = preamble_reject_stages(mag, scan_len=scan_len)
        return buf, _Fetch([*cand, mag, rej])

    def run(self, stream: BinaryIO, emit: Callable[[ModesMessage], None]) -> None:
        """Decode a whole IQ stream on the host-resolve path, calling `emit`
        for every message the reference would hand to useModesMessage."""
        for _ in self._stream(stream, emit):
            pass

    def run_source(self, buffers, emit: Callable[[ModesMessage], None]) -> None:
        """Decode an iterable of pre-framed uint8[BUF_BYTES] buffers (a live
        source), one buffer per dispatch: buffer N+1's device work is
        enqueued while N resolves on the host."""
        pending = None
        for buf in buffers:
            self.samples_in += BLOCK_SAMPLES
            work = self._demod(buf)
            if pending is not None:
                self._resolve(pending, emit)
            pending = work
        if pending is not None:
            self._resolve(pending, emit)

    def messages(self, stream: BinaryIO) -> Iterator[ModesMessage]:
        """The messages of run, as a generator."""
        out: list[ModesMessage] = []
        yield from self._stream(stream, out.append, out)

    @staticmethod
    def _drain(drain: list | None):
        if drain is not None:
            yield from drain
            drain.clear()

    def _stream(self, stream, emit, drain: list | None = None):
        if self.cfg.batch_buffers > 1 and not self._debugging:
            yield from self._stream_batched(stream, emit, drain)
            return
        pending = None  # the previous buffer's work, in flight
        for buf in iq_buffers(stream, loop=self.cfg.loop, throttle_s=self.cfg.throttle_s):
            self.samples_in += BLOCK_SAMPLES
            work = self._demod(buf)
            if pending is not None:
                self._resolve(pending, emit)
                yield from self._drain(drain)
            pending = work
        if pending is not None:
            self._resolve(pending, emit)
            yield from self._drain(drain)

    def _batches(self, stream):
        """Generator of (x, fetch, n_real): `batch_buffers` buffers of the
        stream per device dispatch, a short last batch padded with silence
        (127, which yields zero candidates); each batch's demodulation and
        the fetch of its Candidates are enqueued as it is yielded."""
        nb = max(self.cfg.batch_buffers, 1)
        it = iq_buffers(stream, loop=self.cfg.loop, throttle_s=self.cfg.throttle_s)
        while bufs := list(itertools.islice(it, nb)):
            n_real = len(bufs)
            self.samples_in += n_real * BLOCK_SAMPLES
            x = np.full((nb, bufs[0].shape[0]), 127, dtype=np.uint8)
            x[:n_real] = np.stack(bufs)
            cand = demod_batch(_upload(x, self.device), scan_len=BUF_SAMPLES - FULL_LEN_SAMPLES,
                               max_candidates=self.shapes.mc, front=self._front)
            yield x, _Fetch(list(cand)), n_real

    def _stream_batched(self, stream, emit, drain: list | None = None):
        """File-decode form of _stream: batch_buffers buffers per device
        dispatch, rows resolved in stream order, batch N+1 in flight while
        batch N resolves."""
        pending = None
        for work in self._batches(stream):
            if pending is not None:
                yield from self._resolve_batch(pending, emit, drain)
            pending = work
        if pending is not None:
            yield from self._resolve_batch(pending, emit, drain)

    def stream_records(self, stream: BinaryIO):
        """Bulk host-resolve path: yield one packed native Record array per
        buffer, in stream order, with no per-message Python objects.
        Requires the native resolver (raises RuntimeError otherwise); the
        CLI's pure --raw mode formats these vectorially."""
        if self._native is None:
            raise RuntimeError("stream_records requires the native resolver")
        pending = None
        batches = self._batches(stream)
        while True:
            work = next(batches, None)
            if pending is not None:
                x, fetch, n_real = pending
                host = fetch.get()
                with self._lock:
                    batch = self._native_batch(host, n_real)
                if batch is not None:
                    records, counts = batch
                    off = 0
                    for c in counts.tolist():
                        yield records[off : off + c]
                        off += c
                else:  # a row denser than the shape: row by row
                    for b in range(n_real):
                        bc = self._row_candidates(host, b, x[b])
                        with self._lock:
                            rec = self._native.resolve_block_records(
                                bc, self.cache, self.cfg.decoder, self.stats
                            )
                        yield rec
            if work is None:
                return
            pending = work

    def _native_batch(self, host: list, n_real: int):
        """The fetched batch's rows in ONE native call: (records, counts),
        or None when a row overflowed the shape (found before the cache is
        touched).  The caller holds the lock."""
        try:
            return self._native.resolve_blocks_records(
                [f[:n_real] for f in host[1:]], host[0][:n_real],
                self.cache, self.cfg.decoder, self.stats,
            )
        except OverflowError:
            return None

    def _resolve_block(self, bc: BlockCandidates, emit) -> None:
        """One buffer's candidates through the C++ runtime or its Python
        twin.  The caller holds the lock."""
        if self._native is not None:
            self._native.resolve_block(bc, self.cache, self.cfg.decoder, self.stats, emit)
        else:
            resolve_block(bc, self.cache, self.cfg.decoder, self.stats, emit)

    def _row_candidates(self, host: list, b: int, buf: np.ndarray) -> BlockCandidates:
        """Row b of a fetched batch as BlockCandidates; a row that
        overflowed the shape is demodulated again alone with more room."""
        row = Candidates(*(f[b] for f in host))
        try:
            return BlockCandidates.from_device(row)
        except OverflowError as e:
            return self.shapes.redo(lambda mc: self._demod(buf, max_candidates=mc)[1].get(),
                                    row.pos.shape[0], e)[1]

    def _resolve_batch(self, work, emit, drain: list | None):
        from ..native import records_to_messages

        x, fetch, n_real = work
        host = fetch.get()  # all eight fields, one event
        if self._native is not None:
            with self._lock:
                batch = self._native_batch(host, n_real)
                if batch is not None:
                    for mm in records_to_messages(batch[0]):
                        emit(mm)
            if batch is not None:
                yield from self._drain(drain)
                return
        for b in range(n_real):  # the Python twin, or a dense row
            bc = self._row_candidates(host, b, x[b])
            with self._lock:
                self._resolve_block(bc, emit)
            yield from self._drain(drain)

    def _resolve(self, work, emit) -> None:
        buf, fetch = work
        host = fetch.get()
        try:
            bc = BlockCandidates.from_device(Candidates(*host[:8]))
        except OverflowError as e:
            host, bc = self.shapes.redo(lambda mc: self._demod(buf, max_candidates=mc)[1].get(),
                                        host[1].shape[0], e)
        if not self._debugging:
            with self._lock:
                self._resolve_block(bc, emit)
            return
        debug = DebugContext(flags=self.debug_flags, mag=host[8], reject_code=host[9],
                             out=self.debug_out)
        if self._debug_last_msg is not None:
            debug.last_msg = self._debug_last_msg
        with self._lock:
            resolve_block(bc, self.cache, self.cfg.decoder, self.stats, emit, debug)
        self._debug_last_msg = debug.last_msg
