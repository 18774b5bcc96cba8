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

Messages are ModesMessage objects (good and bad CRC, like the reference's
useModesMessage stream); filter with `crcok_only=True` for the usable set.
Both run on CUDA unless `device="cpu"` is given, and raise without a card.
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
from .constants import BUF_SAMPLES, FULL_LEN_SAMPLES, ICAO_CACHE_LEN, SCAN_POSITIONS
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
from .native import NativeResolver
from .ops.demod import Candidates, demod_batch, demod_iq_block
from .ops.resolve import demod_resolve_streams, streams_dispatch_shape, use_device_resolve

# buffers each still-active capture adds to one decode_captures round
STREAM_BUFFERS = 4


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
    mc_box = {"mc": PipelineConfig().max_candidates}
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
                                   max_candidates=mc_box["mc"])
                work = (_Fetch(list(cand)), live, x)
            if pending is not None:
                _resolve_rows(pending, states, dcfg, mc_box, dev)
            if work is None:
                break
            pending = work
    finally:
        for s, c in zip(streams, captures):
            if s is not c:
                s.close()

    results = []
    for st in states:
        msgs = st.messages
        if crcok_only:
            msgs = [m for m in msgs if m.crcok]
        results.append(msgs)
    return results


def _redemod_with_retry(buf: np.ndarray, mc: int, mc_box: dict, dev) -> BlockCandidates:
    """One buffer demodulated again alone with 4x the candidate room until
    its exact preamble count fits; the larger shape sticks in mc_box."""
    while True:
        mc *= 4
        big = demod_iq_block(_upload(buf, dev),
                             scan_len=BUF_SAMPLES - FULL_LEN_SAMPLES, max_candidates=mc)
        try:
            bc = BlockCandidates.from_device(big)
            mc_box["mc"] = max(mc_box["mc"], mc)
            return bc
        except OverflowError:
            # every-other-position bound (adjacent preambles are excluded)
            if mc >= SCAN_POSITIONS // 2 + 1:
                raise


def _resolve_rows(work, states, dcfg, mc_box, dev) -> None:
    """Resolve the live rows of one fetched round, each against its
    capture's own state."""
    fetch, live, x = work
    host = fetch.get()
    for k in live:
        row = Candidates(*(f[k] for f in host))
        try:
            bc = BlockCandidates.from_device(row)
        except OverflowError:
            bc = _redemod_with_retry(x[k], row.pos.shape[0], mc_box, dev)
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
    shapes = {"mc": PipelineConfig().max_candidates, "mo": 4096}
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
                mc, mo = shapes["mc"], shapes["mo"]
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
                if peak_n > mc:
                    if mc >= scan_len // 2 + 1:
                        raise OverflowError(
                            f"candidate overflow: a buffer reported {peak_n} "
                            f"preambles > max_candidates {mc}"
                        )
                    shapes["mc"] *= 4  # sticky growth; rerun from the pre state
                    continue
                if peak_c > mo:
                    shapes["mo"] *= 4
                    continue
                break
            ca, ct = ca_t, ct_t
            for k, stt in enumerate(states):
                stt.messages.extend(tile_msgs[k])
    finally:
        for s, c in zip(streams, captures):
            if s is not c:
                s.close()

    results = []
    for stt in states:
        msgs = stt.messages
        if crcok_only:
            msgs = [m for m in msgs if m.crcok]
        results.append(msgs)
    return results
