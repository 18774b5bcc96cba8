"""High-level decode API: captures in, decoded messages out (port of
dump1090_tpu/api.py).

  * `decode_capture` — one capture (path/bytes/array/stream) -> list of
    ModesMessage, through DemodPipeline.run_device (device resolve, the
    default on CUDA) or DemodPipeline.run (host resolve, the default on the
    CPU).
  * `decode_captures` — MANY independent captures decoded together.  Device
    strategy (the default on CUDA): every still-active capture adds its next
    buffers to one shared demod + resolve dispatch
    (ops.resolve.demod_resolve_streams), and the multi-stream resolver
    kernel walks each capture against its own ICAO cache, one block per
    capture.  Host strategy (device_resolve=False, the default on the
    CPU): each dispatch
    demodulates one buffer of every still-active capture on the device
    (ops.demod.demod_batch), and the host resolves each capture against
    its own cache, with the C++ runtime or its Python twin.  Per-capture
    results are bit-identical to `decode_capture` either way.

  * `decode_capture_sharded` — one capture with each buffer's timeline
    sharded over a (dp, sp) mesh of devices (parallel/sharding.py), the
    candidate segments replayed on the device
    (ops.resolve.resolve_candidate_segments) or on the host.

Messages are ModesMessage objects (good and bad CRC, like the reference's
useModesMessage stream); filter with `crcok_only=True` for the usable set.
All run on CUDA unless `device="cpu"` is given, and raise without a card.
"""

from __future__ import annotations

import io
import itertools
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Sequence

import numpy as np
import torch

from . import resolve_device
from .constants import (
    BLOCK_SAMPLES,
    BUF_SAMPLES,
    FULL_LEN_SAMPLES,
    ICAO_CACHE_LEN,
    SCAN_POSITIONS,
)
from .io.sources import iq_buffers
from .models.decoder import (
    DecoderConfig,
    DecoderStats,
    IcaoCache,
    ModesMessage,
    messages_from_device_arrays,
)
from .models.pipeline import DemodPipeline, PipelineConfig, _Fetch, _upload
from .models.resolver import BlockCandidates, resolve_block
from .models.shapes import Peaks, Shapes, step
from .models.state import cache_from_device, cache_to_device
from .native import NativeResolver
from .ops.demod import Candidates, demod_batch, demod_iq_block
from .ops.resolve import (
    demod_resolve_streams,
    normalize_max_candidates,
    resolve_candidate_segments,
    streams_dispatch_shape,
    use_device_resolve,
)
from .parallel.sharding import HALO, Mesh, device_mesh, make_sharded_demod, merge_sharded_rows

# buffers each still-active capture adds to one decode_captures round
STREAM_BUFFERS = 4
# emitted-message room of one group of decode_capture_sharded's device
# resolve at the start (grows x4 on overflow, as in the JAX package)
SHARDED_MAX_OUT = 4096


def _as_stream(capture) -> io.BufferedIOBase:
    if isinstance(capture, (str, Path)):
        return open(capture, "rb")
    if isinstance(capture, np.ndarray):
        return io.BytesIO(np.ascontiguousarray(capture, dtype=np.uint8).tobytes())
    if isinstance(capture, (bytes, bytearray, memoryview)):
        return io.BytesIO(bytes(capture))
    return capture  # already a binary stream


def decode_capture(
    capture,
    *,
    config: DecoderConfig | None = None,
    crcok_only: bool = False,
    batch_buffers: int = 16,
    device_resolve: bool | None = None,
    device: str | torch.device | None = None,
) -> list[ModesMessage]:
    """Decode one IQ capture (path, bytes, uint8 array, or binary stream).

    device_resolve: True runs the sequential resolver on the device too
    (DemodPipeline.run_device); False resolves on the host
    (DemodPipeline.run, the C++ runtime when it builds); None (auto) takes
    the device on CUDA and the host on the CPU
    (ops.resolve.use_device_resolve).  The messages are the same."""
    if device_resolve is None:
        device_resolve = use_device_resolve(device)
    cfg = PipelineConfig(decoder=config or DecoderConfig(), batch_buffers=batch_buffers)
    p = DemodPipeline(cfg, device=device)
    out: list[ModesMessage] = []
    stream = _as_stream(capture)
    try:
        if device_resolve:
            p.run_device(stream, out.append)
        else:
            p.run(stream, out.append)
    finally:
        if stream is not capture:
            stream.close()
    if crcok_only:
        out = [m for m in out if m.crcok]
    return out


@dataclass
class _StreamState:
    """Per-capture host state of decode_captures: the messages decoded so
    far and whether the capture has run out; on the host strategy also its
    own ICAO cache, counters and resolver (each capture decodes as if
    alone)."""

    messages: list = field(default_factory=list)
    done: bool = False
    cache: IcaoCache = field(default_factory=IcaoCache)
    stats: DecoderStats = field(default_factory=DecoderStats)
    resolver: object = None


def _results(states: list[_StreamState], crcok_only: bool) -> list[list[ModesMessage]]:
    """Each capture's messages, the good-CRC ones alone with crcok_only."""
    return [[m for m in st.messages if m.crcok or not crcok_only] for st in states]


def decode_captures(
    captures: Sequence,
    *,
    config: DecoderConfig | None = None,
    crcok_only: bool = False,
    device_resolve: bool | None = None,
    device: str | torch.device | None = None,
) -> list[list[ModesMessage]]:
    """Decode many independent captures, all of them sharing each device
    dispatch.  Per-capture results are bit-identical to `decode_capture`.

    device_resolve: True runs the device-resolve strategy (see
    _decode_captures_device), False the host-resolve strategy (see
    _decode_captures_host), None (auto) the device strategy on CUDA and the
    host strategy on the CPU (ops.resolve.use_device_resolve)."""
    if device_resolve is None:
        device_resolve = use_device_resolve(device)
    if not device_resolve:
        return _decode_captures_host(
            captures, config=config, crcok_only=crcok_only, device=device
        )
    return _decode_captures_device(
        captures, config=config, crcok_only=crcok_only, device=device
    )


def _decode_captures_host(
    captures: Sequence, *, config: DecoderConfig | None, crcok_only: bool,
    device: str | torch.device | None = None,
) -> list[list[ModesMessage]]:
    """decode_captures, host edition: each dispatch demodulates the next
    buffer of EVERY still-active capture (ops.demod.demod_batch, the batch
    axis being the captures), and each capture's row is resolved on the
    host against that capture's own ICAO cache and counters, with the C++
    runtime when it builds (else models/resolver.py).  Round N+1 is in
    flight on the device while round N resolves.  A row whose exact count
    overflows the candidate shape is demodulated again alone at 4x, and
    the larger shape sticks for later rounds."""
    dev = resolve_device(device)
    dcfg = config or DecoderConfig()
    shapes = Shapes(PipelineConfig().max_candidates)
    scan_len = BUF_SAMPLES - FULL_LEN_SAMPLES
    buf_bytes = BUF_SAMPLES * 2

    streams = [_as_stream(c) for c in captures]
    iters = [iq_buffers(s) for s in streams]
    states = [_StreamState() for _ in captures]
    try:
        for st in states:
            st.resolver = NativeResolver()
    except (OSError, RuntimeError):
        pass  # the Python twin resolves every capture

    try:
        pending = None
        while True:
            x = np.full((len(captures), buf_bytes), 127, dtype=np.uint8)
            live = []
            for k, (it, st) in enumerate(zip(iters, states)):
                if st.done:
                    continue
                buf = next(it, None)
                if buf is None:
                    st.done = True
                else:
                    x[k] = buf
                    live.append(k)
            work = None
            if live:
                cand = demod_batch(_upload(x, dev), scan_len=scan_len,
                                   max_candidates=shapes.mc)
                work = (_Fetch(list(cand)), live, x)
            if pending is not None:
                _resolve_rows(pending, states, dcfg, shapes, dev)
            if work is None:
                break
            pending = work
    finally:
        for s, c in zip(streams, captures):
            if s is not c:
                s.close()

    return _results(states, crcok_only)


def _resolve_rows(work, states, dcfg, shapes, dev) -> None:
    """Resolve the live rows of one fetched round, each against its
    capture's own state."""
    fetch, live, x = work
    host = fetch.get()
    for k in live:
        row = Candidates(*(f[k] for f in host))
        try:
            bc = BlockCandidates.from_device(row)
        except OverflowError as e:  # the row again alone, with more room
            bc = shapes.redo(lambda mc: demod_iq_block(
                _upload(x[k], dev), scan_len=BUF_SAMPLES - FULL_LEN_SAMPLES, max_candidates=mc,
            ), row.pos.shape[0], e)[1]
        st = states[k]
        if st.resolver is not None:
            st.resolver.resolve_block(bc, st.cache, dcfg, st.stats, st.messages.append)
        else:
            resolve_block(bc, st.cache, dcfg, st.stats, st.messages.append)


def _decode_captures_device(
    captures: Sequence, *, config: DecoderConfig | None, crcok_only: bool,
    device: str | torch.device | None = None,
) -> list[list[ModesMessage]]:
    """decode_captures, device edition: every still-active capture's next
    STREAM_BUFFERS buffers join ONE demod + resolve dispatch
    (ops.resolve.demod_resolve_streams); per-capture ICAO caches live on the
    device as (S, ICAO_CACHE_LEN) rows.  Exhausted captures contribute
    127-silence (zero candidates, zero kernel steps) until all finish.

    A round that would exceed the dispatch slot bound is cut into
    (streams, buffers) tiles (ops.resolve.streams_dispatch_shape), all
    enqueued before any is fetched, the cache rows chaining from tile to
    tile on the device.  A round whose exact counts overflow its shapes
    grows them (sticky x4) and is rerun from the cache state it started
    from."""
    dev = resolve_device(device)
    dcfg = config or DecoderConfig()
    s_n = len(captures)
    nb = STREAM_BUFFERS
    shapes = Shapes(PipelineConfig().max_candidates, mo=4096)
    scan_len = BUF_SAMPLES - FULL_LEN_SAMPLES
    buf_bytes = BUF_SAMPLES * 2

    streams = [_as_stream(c) for c in captures]
    iters = [iq_buffers(s) for s in streams]
    states = [_StreamState() for _ in captures]

    ca = torch.zeros((s_n, ICAO_CACHE_LEN), dtype=torch.int32, device=dev)
    ct = torch.zeros((s_n, ICAO_CACHE_LEN), dtype=torch.int32, device=dev)
    try:
        while True:
            xs = np.full((s_n, nb, buf_bytes), 127, dtype=np.uint8)
            n_live = 0
            for k, (it, stt) in enumerate(zip(iters, states)):
                if stt.done:
                    continue
                got = list(itertools.islice(it, nb))
                if not got:
                    stt.done = True
                    continue
                n_live += 1
                xs[k, : len(got)] = np.stack(got)
                if len(got) < nb:
                    stt.done = True
            if n_live == 0:
                break
            # per-round clock (one shared dispatch round ~ one pipeline
            # dispatch group): ICAO-cache TTLs age during long decodes the
            # way decode_capture's per-group cache.clock() does
            now = int(time.time())
            while True:
                mc, mo = shapes.mc, shapes.mo
                s_fit, nb_fit = streams_dispatch_shape(s_n, nb, mc)
                # the round's cache rows, updated tile by tile on the
                # device; ca/ct keep the pre-round state for a rerun
                ca_t, ct_t = ca.clone(), ct.clone()
                tiles = []
                for j0 in range(0, nb, nb_fit):
                    for k0 in range(0, s_n, s_fit):
                        ks = min(s_fit, s_n - k0)
                        js = min(nb_fit, nb - j0)
                        sub = np.ascontiguousarray(xs[k0:k0 + ks, j0:j0 + js])
                        n_d, count_d, msg_d, meta_d, _, ca2, ct2 = demod_resolve_streams(
                            torch.from_numpy(sub).to(dev),
                            ca_t[k0:k0 + ks], ct_t[k0:k0 + ks], now,
                            dcfg.fix_errors, dcfg.aggressive,
                            scan_len=scan_len, max_candidates=mc, max_out=mo,
                        )
                        tiles.append((k0, ks, _Fetch([n_d, count_d, msg_d, meta_d])))
                        ca_t[k0:k0 + ks] = ca2
                        ct_t[k0:k0 + ks] = ct2
                # fetch pass: an overflow discards the whole round, which
                # reruns from the pre-round cache state
                tile_msgs = [[] for _ in range(s_n)]
                peak_n = peak_c = 0
                for k0, ks, fetch in tiles:
                    n_h, count_h, msg_h, meta_h = fetch.get()
                    peak_n = max(peak_n, int(n_h.max(initial=0)))
                    peak_c = max(peak_c, int(count_h.max(initial=0)))
                    if peak_n > mc or peak_c > mo:
                        break
                    for k in range(ks):
                        c = int(count_h[k])
                        tile_msgs[k0 + k].extend(
                            messages_from_device_arrays(msg_h[k, :c], meta_h[k, :c])
                        )
                # sticky growth; rerun from the pre-round state
                if not shapes.retry(Peaks(peak_n, total=peak_c), "a buffer"):
                    break
            ca, ct = ca_t, ct_t
            for k, stt in enumerate(states):
                stt.messages.extend(tile_msgs[k])
    finally:
        for s, c in zip(streams, captures):
            if s is not c:
                s.close()

    return _results(states, crcok_only)


def decode_capture_sharded(
    capture,
    *,
    mesh: Mesh | None = None,
    sp: int | None = None,
    config: DecoderConfig | None = None,
    crcok_only: bool = False,
    max_candidates: int = 128,
    stats: DecoderStats | None = None,
    cache: IcaoCache | None = None,
    emit=None,
    progress: dict | None = None,
    lock=None,
    device_resolve: bool | None = None,
    device: str | torch.device | None = None,
) -> list[ModesMessage]:
    """Decode ONE capture with each buffer's timeline sharded over a device
    mesh: reference buffers on the "dp" axis, each buffer's scan range
    [0, SCAN_POSITIONS) owned by sp shards with 240-sample halos
    (parallel/sharding.py), and the candidates replayed sequentially in
    buffer order against one ICAO cache.  Bit-identical to decode_capture.

    The host uploads only the raw uint8 IQ bytes, one block to each shard's
    device, and each shard computes its own magnitudes.  With
    device_resolve the replay runs on the device too
    (ops.resolve.resolve_candidate_segments over the shards' candidate
    segments, gathered on mesh.devices[0][0]; only emitted messages reach
    the host); otherwise the merged candidate stream is replayed by the
    host resolver (the C++ runtime, or its Python twin).  None (auto) takes
    the device on CUDA and the host on the CPU
    (ops.resolve.use_device_resolve).

    mesh: a parallel.sharding.Mesh; by default sharding.device_mesh(sp,
    device): the visible cards (dp = cards // sp), or (1, sp) of the CPU.
    emit: optional callback invoked with every message in stream order (in
    addition to the returned list).  progress: a dict whose "samples" grows
    by each group's new samples.  lock: optional (reentrant) lock held
    across each resolve step when another thread shares the cache and the
    counters (the CLI passes its state lock).  A shard's candidate overflow
    and the emitted-message overflow are detected by exact counts and
    retried with sticky growth from the group's starting cache."""
    import contextlib

    if mesh is None:
        mesh = device_mesh(sp, device)
    elif device is not None and torch.device(device).type != mesh.devices[0][0].type:
        raise ValueError(f"device {device} and the mesh's {mesh.devices[0][0]} disagree")
    if mesh.multiprocess:
        raise ValueError("decode_capture_sharded takes a mesh held by one process")
    rdev = mesh.devices[0][0]
    dp_n, sp_n = mesh.shape["dp"], mesh.shape["sp"]
    shard_samples = -(-SCAN_POSITIONS // sp_n)
    total = sp_n * shard_samples  # padded timeline (scan clipped by the mask)
    if device_resolve is None:
        device_resolve = use_device_resolve(rdev)

    # chunk-valid from the start; the growth sites keep it so
    shapes = Shapes(normalize_max_candidates(max_candidates), mo=SHARDED_MAX_OUT)
    fns = {}

    def get_fn():
        mc = shapes.mc
        if mc not in fns:
            fns[mc] = make_sharded_demod(
                mesh, shard_samples=shard_samples, max_candidates=mc,
                scan_total=SCAN_POSITIONS, with_tail=True, from_iq=True,
            )
        return fns[mc]

    lock = lock if lock is not None else contextlib.nullcontext()
    dcfg = config or DecoderConfig()
    cache = cache if cache is not None else IcaoCache()
    st = stats if stats is not None else DecoderStats()
    out: list[ModesMessage] = []

    def sink(mm):
        out.append(mm)
        if emit is not None:
            emit(mm)

    resolver = None
    if not device_resolve:
        try:
            resolver = NativeResolver().resolve_block
        except (OSError, RuntimeError):
            resolver = resolve_block  # the Python twin: the same output
    ca, ct = cache_to_device(cache.addr, cache.ts, rdev)

    stream = _as_stream(capture)
    try:
        it = iq_buffers(stream)
        while True:
            bufs = list(itertools.islice(it, dp_n))
            if not bufs:
                break
            n_real = len(bufs)
            if progress is not None:
                progress["samples"] = progress.get("samples", 0) + n_real * BLOCK_SAMPLES
            # raw IQ bytes, padded with 127s (zero magnitude) to the sharded
            # timeline geometry; 2 bytes per sample
            x = np.full((dp_n, 2 * (total + HALO)), 127, dtype=np.uint8)
            for r, b in enumerate(bufs):
                x[r, : min(b.shape[0], 2 * (total + HALO))] = b[: 2 * (total + HALO)]
            iq_main, tail = x[:, : 2 * total], x[:, 2 * total:]
            if device_resolve:
                ca, ct = _resolve_group_on_device(
                    get_fn, iq_main, tail, shapes, dp_n, sp_n, ca, ct, cache, dcfg, st,
                    sink, lock,
                )
                continue
            while True:
                cand = get_fn()(iq_main, tail)
                try:
                    # every row merges before any resolves, so an overflow
                    # retry never sees a partly advanced cache
                    rows = merge_sharded_rows(cand, SCAN_POSITIONS)
                    break
                except OverflowError as e:
                    shapes.mc = step(shapes.mc, e, normalize=True)  # sticky
            for _, bc in rows[:n_real]:
                with lock:
                    resolver(bc, cache, dcfg, st, sink)
    finally:
        if device_resolve:
            # the device cache back into the host cache, also after a cut
            cache.addr[:], cache.ts[:] = cache_from_device(ca, ct)
        if stream is not capture:
            stream.close()
    if crcok_only:
        return [m for m in out if m.crcok]
    return out


def _resolve_group_on_device(get_fn, iq_main, tail, shapes, dp_n, sp_n, ca, ct, cache,
                             dcfg, st, sink, lock):
    """One dp-group of the sharded decode with the sequential replay on the
    device: sharded demod -> per-shard candidate segments ->
    ops.resolve.resolve_candidate_segments (rows = reference buffers: the
    skip resets per row, the ICAO cache chains across everything) ->
    emitted messages decoded statelessly on the host.  Padding rows beyond
    the real buffer count are 127-silence and give no candidates.  An
    exact-count overflow reruns the group from its starting cache."""
    s_n = dp_n * sp_n
    while True:
        cand = get_fn()(iq_main, tail)
        mc = shapes.mc

        def seg(a: torch.Tensor) -> torch.Tensor:
            return a.reshape((s_n, mc) + tuple(a.shape[2:]))

        row_id = torch.arange(dp_n, dtype=torch.int32, device=cand.pos.device)
        count, msg, meta, stats_d, ca2, ct2 = resolve_candidate_segments(
            seg(cand.pos), seg(cand.msg1), seg(cand.errors1), seg(cand.gate1),
            seg(cand.msg2), seg(cand.errors2), seg(cand.gate2), cand.n.reshape(s_n),
            row_id.repeat_interleave(sp_n), ca, ct, cache.clock(), dcfg.fix_errors,
            dcfg.aggressive, n_rows=dp_n, max_out=shapes.mo, crcok_only=False,
        )
        n_h, count_h, msg_h, meta_h, stats_h = _Fetch([cand.n, count, msg, meta, stats_d]).get()
        if not shapes.retry(Peaks(int(n_h.max()), total=int(count_h)), "shard",
                            normalize=True):
            break
    c = int(count_h)
    mms = messages_from_device_arrays(msg_h[:c], meta_h[:c])
    # the counters and the emissions of a group under ONE lock hold: a
    # concurrent reader (the --stats printer, the TUI) never sees the
    # group's counters half applied
    with lock:
        st.add(stats_h.tolist())
        for mm in mms:
            sink(mm)
    return ca2, ct2
