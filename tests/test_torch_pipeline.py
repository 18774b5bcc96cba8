"""Port's file-decode pipeline (DemodPipeline.stream_raw_device) against the
JAX package's, on the CPU: output bytes and DecoderStats at dispatch-ahead
depths 0, 1 and 3 with candidate-overflow growth forced from
max_candidates=16, in fix / no-fix / aggressive modes; and the decode state
carried from the JAX package into the port half way through a stream."""

import dataclasses
import io

import numpy as np
import pytest

from dump1090_tpu.models.decoder import DecoderConfig as JaxDecoderConfig
from dump1090_tpu.models.pipeline import DemodPipeline as JaxPipeline
from dump1090_tpu.models.pipeline import PipelineConfig as JaxPipelineConfig
from dump1090_tpu_torch.models.decoder import DecoderConfig
from dump1090_tpu_torch.models.pipeline import DemodPipeline, PipelineConfig
from dump1090_tpu_torch.models.state import state_from_numpy, state_to_numpy
from dump1090_tpu_torch.utils.synth import planted_capture
# jax_native: the JAX package's pipelines resolve on the host with its
# native runtime, a private copy
from test_torch_native import jax_native  # noqa: F401  (a fixture)

NOW = 1_700_000_000
MODES = {"fix": (True, False), "nofix": (False, False), "aggressive": (True, True)}


def _counters(stats):
    return dataclasses.astuple(stats)


@pytest.fixture(scope="module")
def capture():
    # 5 blocks: two full 2x2 groups and a short last group
    data, planted = planted_capture(5, 60, seed=21, noise_sigma=3.0,
                                    flip_weights=(0.6, 0.25, 0.15))
    return data


def _jax_decode(data, fix, aggressive, **kw):
    p = JaxPipeline(
        JaxPipelineConfig(decoder=JaxDecoderConfig(fix_errors=fix, aggressive=aggressive),
                          batch_buffers=2, dispatch_groups=2, max_candidates=16, **kw),
        clock=lambda: NOW,
    )
    return p, b"".join(p.stream_raw_device(io.BytesIO(data)))


def _port_decode(data, fix, aggressive, pipeline=None, **kw):
    p = pipeline or DemodPipeline(
        PipelineConfig(decoder=DecoderConfig(fix_errors=fix, aggressive=aggressive),
                       batch_buffers=2, dispatch_groups=2, max_candidates=16, **kw),
        clock=lambda: NOW, device="cpu",
    )
    return p, b"".join(p.stream_raw_device(io.BytesIO(data)))


@pytest.fixture(scope="module")
def jax_results(capture, jax_native):
    out = {}
    for mode, (fix, aggressive) in MODES.items():
        p, raw = _jax_decode(capture, fix, aggressive)
        out[mode] = (raw, _counters(p.stats), p.cache.addr.copy(), p.cache.ts.copy())
    return out


@pytest.mark.parametrize("depth", [0, 1, 3])
@pytest.mark.parametrize("mode", list(MODES))
def test_stream_raw_device_matches_jax(capture, jax_results, mode, depth):
    fix, aggressive = MODES[mode]
    raw_j, stats_j, addr_j, ts_j = jax_results[mode]
    p, raw = _port_decode(capture, fix, aggressive, dispatch_ahead=depth)
    assert raw == raw_j
    assert _counters(p.stats) == stats_j
    np.testing.assert_array_equal(p.cache.addr, addr_j)
    np.testing.assert_array_equal(p.cache.ts, ts_j)
    assert p.shapes.mc > 16, "sticky growth should have fired"
    assert len(raw.split()) >= 100
    if mode == "fix":
        assert p.stats.fixed > 0
    if mode == "aggressive":
        assert p.stats.two_bits_fix > 0


def test_preload_and_streaming_ingest_identical(capture, jax_results, tmp_path, jax_native):
    """A regular file takes the preload strategy ("auto": every group
    uploaded first; "staged": one group, then the rest on a reader thread),
    a BytesIO or preload "off" the streaming reader thread; all give the
    JAX package's bytes, and so does the JAX package's own staged preload."""
    f = tmp_path / "cap.bin"
    f.write_bytes(capture)
    raw_j = jax_results["fix"][0]
    for preload in ("auto", "staged", "off"):
        p = DemodPipeline(PipelineConfig(batch_buffers=2, dispatch_groups=2, preload=preload),
                          clock=lambda: NOW, device="cpu")
        with open(f, "rb") as fh:
            assert b"".join(p.stream_raw_device(fh)) == raw_j
    with open(f, "rb") as fh:
        pj = JaxPipeline(JaxPipelineConfig(batch_buffers=2, dispatch_groups=2, max_candidates=16,
                                           preload="staged"), clock=lambda: NOW)
        assert b"".join(pj.stream_raw_device(fh)) == raw_j
    with pytest.raises(ValueError, match="expected auto|staged|off"):
        DemodPipeline(PipelineConfig(preload="eager"), device="cpu")


def test_state_carried_from_jax_into_port(capture, jax_native):
    """Decode half A in JAX, carry its ICAO cache and counters into the port
    with state_from_numpy, decode half B in the port: equal to JAX decoding
    A then B with one pipeline."""
    cut = 2 * 262144
    a, b = capture[:cut], capture[cut:]
    # JAX: A then B through one pipeline (the cache carries over)
    pj = JaxPipeline(JaxPipelineConfig(batch_buffers=2, dispatch_groups=2),
                     clock=lambda: NOW)
    want_a = b"".join(pj.stream_raw_device(io.BytesIO(a)))
    want_b = b"".join(pj.stream_raw_device(io.BytesIO(b)))

    pa = JaxPipeline(JaxPipelineConfig(batch_buffers=2, dispatch_groups=2),
                     clock=lambda: NOW)
    assert b"".join(pa.stream_raw_device(io.BytesIO(a))) == want_a
    assert (pa.cache.addr != 0).any()
    state = state_from_numpy(pa.cache.addr, pa.cache.ts, pa.stats, device="cpu")
    addr, ts, counts = state_to_numpy(state)
    np.testing.assert_array_equal(addr, pa.cache.addr)
    np.testing.assert_array_equal(ts, pa.cache.ts)
    assert tuple(counts) == _counters(pa.stats)[:8]

    pt = DemodPipeline(PipelineConfig(batch_buffers=2, dispatch_groups=2),
                       clock=lambda: NOW, device="cpu")
    pt.load_state(state)
    assert b"".join(pt.stream_raw_device(io.BytesIO(b))) == want_b
    assert _counters(pt.stats) == _counters(pj.stats)
    np.testing.assert_array_equal(pt.cache.addr, pj.cache.addr)
    back = state_to_numpy(pt.state())
    np.testing.assert_array_equal(back[0], pj.cache.addr)


def test_iq_buffers_loop_and_throttle_match_jax(capture, monkeypatch):
    """--loop reads a seekable stream again from its start at EOF, the same
    buffers as the JAX package's; the interactive brake sleeps before each
    fill."""
    import itertools

    from dump1090_tpu.io.sources import iq_buffers as jax_iq_buffers
    from dump1090_tpu_torch.io import sources

    got = list(itertools.islice(sources.iq_buffers(io.BytesIO(capture), loop=True), 13))
    want = list(itertools.islice(jax_iq_buffers(io.BytesIO(capture), loop=True), 13))
    assert len(got) == 13
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    flat = list(sources.iq_buffers(io.BytesIO(capture * 3)))
    for g, w in zip(got, flat):  # looping reads on seamlessly across EOF
        np.testing.assert_array_equal(g, w)
    sleeps = []
    monkeypatch.setattr(sources.time, "sleep", sleeps.append)
    assert len(list(sources.iq_buffers(io.BytesIO(capture), throttle_s=0.005))) == 5
    assert sleeps == [0.005] * 6  # one per fill, the EOF fill included


def _dispatch_log(monkeypatch):
    """Record the pipeline's dispatches (D) and fetches (F) in order."""
    from dump1090_tpu_torch.models import pipeline as pl

    log = []
    real_dispatch, real_get = pl.demod_resolve_group, pl._Fetch.get

    def dispatch(*a, **k):
        log.append("D")
        return real_dispatch(*a, **k)

    def get(self):
        log.append("F")
        return real_get(self)

    monkeypatch.setattr(pl, "demod_resolve_group", dispatch)
    monkeypatch.setattr(pl._Fetch, "get", get)
    return log


@pytest.mark.parametrize("kind", ["file", "throttled", "looped", "staged", "live"])
def test_dispatch_ahead_auto_depth_and_no_preload_for_live_sources(capture, tmp_path,
                                                                  monkeypatch, kind):
    """The auto depth is 3 for a seekable file, 1 for a looped or throttled
    one (and such sources stream through the reader thread instead of being
    preloaded: a looped file never ends), 1 under the staged preload (its
    point is the first message) and 1 for live buffers with no stream.  The
    looped decode equals the file read three times over.  The next group is
    taken as ready, as a preloaded file's always is, so no group is fetched
    early and the reader thread's pace cannot change the log."""
    import itertools

    from dump1090_tpu_torch.io import sources
    from dump1090_tpu_torch.models import pipeline as pl

    monkeypatch.setattr(sources.time, "sleep", lambda s: None)
    monkeypatch.setattr(pl._Groups, "ready", lambda self: True)
    f = tmp_path / "cap.bin"
    f.write_bytes(capture * (1 if kind == "looped" else 3))
    cfg = dict(batch_buffers=2, dispatch_groups=1, max_candidates=512,
               loop=kind == "looped", throttle_s=0.001 if kind == "throttled" else 0.0,
               preload="staged" if kind == "staged" else "auto")
    log = _dispatch_log(monkeypatch)
    p = DemodPipeline(PipelineConfig(**cfg), clock=lambda: NOW, device="cpu")
    # the new cases need only the first fetch: two batches
    n_batches = 2 if kind in ("staged", "live") else 6
    with open(f, "rb") as fh:
        if kind == "live":
            gen = p._device_batches(None, packed=False, buffers=sources.iq_buffers(fh))
        else:
            gen = p._device_batches(fh, packed=False)
        batches = list(itertools.islice(gen, n_batches))
    depth = 3 if kind == "file" else 1
    assert log[: depth + 2] == ["D"] * (depth + 1) + ["F"]
    assert len(batches) == n_batches
    if kind == "looped":
        flat = DemodPipeline(PipelineConfig(**dict(cfg, loop=False)), clock=lambda: NOW,
                             device="cpu")
        want = list(itertools.islice(flat._device_batches(io.BytesIO(capture * 3),
                                                          packed=False), 6))
        for (_, gb, (gm, gx)), (_, wb, (wm, wx)) in zip(batches, want):
            assert gb == wb
            np.testing.assert_array_equal(gm, wm)
            np.testing.assert_array_equal(gx, wx)


def test_a_live_group_is_fetched_before_the_next_buffer_comes(capture, monkeypatch):
    """Live buffers that come as a radio's do, the next one only once the
    consumer holds the last one's batches: with no next input waiting, each
    group is fetched as soon as it is issued (D F D F ...), and its batches
    reach the consumer before the source gives the next buffer.  A pipeline
    that fetched a group only once the next was issued would wait on the
    radio while the radio waits on it, and the source would time out."""
    import threading

    from dump1090_tpu_torch.io.sources import iq_buffers

    bufs = list(iq_buffers(io.BytesIO(capture)))
    log = _dispatch_log(monkeypatch)
    held = threading.Semaphore(0)

    def radio():
        for k, buf in enumerate(bufs):
            log.append("R")
            yield buf
            # the next buffer (or the end) once buffer k is out
            assert held.acquire(timeout=30), f"buffer {k} was not delivered in time"

    p = DemodPipeline(PipelineConfig(max_candidates=512), clock=lambda: NOW, device="cpu")
    got = []
    for _, _, (meta, msg) in p._device_batches(None, packed=False, buffers=radio()):
        log.append("Y")
        got.append((meta.copy(), msg.copy()))
        held.release()
    assert log == ["R", "D", "F", "Y"] * len(bufs)
    want = DemodPipeline(PipelineConfig(max_candidates=512), clock=lambda: NOW, device="cpu")
    for (gm, gx), (_, _, (wm, wx)) in zip(got, want._device_batches(None, packed=False,
                                                                     buffers=bufs), strict=True):
        np.testing.assert_array_equal(gm, wm)
        np.testing.assert_array_equal(gx, wx)


@pytest.mark.parametrize("depth", [1, 3])
def test_input_always_ready_keeps_depth_groups_in_flight(capture, tmp_path, monkeypatch,
                                                         depth):
    """A preloaded file's next group is always ready: the early fetch never
    engages, `depth` groups stay in flight behind each new one, and the
    tail drains at the end."""
    from dump1090_tpu_torch.utils import spans

    f = tmp_path / "cap.bin"
    f.write_bytes(capture * 2)
    log = _dispatch_log(monkeypatch)
    spans.RECORDER.clear()
    p = DemodPipeline(PipelineConfig(max_candidates=512, dispatch_ahead=depth),
                      clock=lambda: NOW, device="cpu")
    with open(f, "rb") as fh:
        n = sum(1 for _ in p._device_batches(fh, packed=False))
    assert n == 10
    assert log == ["D"] * (depth + 1) + ["F", "D"] * (n - depth - 1) + ["F"] * (depth + 1)
    assert not any(s.name == spans.FETCH_EARLY for s in spans.RECORDER.spans())


def _check_replays(recorded):
    """Each group that overflowed is issued again at once from its own
    start, and once it is delivered every group issued after it and still
    pending is issued again, in order, before any new group; returns how
    many groups those replays re-issued."""
    main = [s for s in recorded if s.name in ("pipeline.issue", "pipeline.fetch.wait")]
    marks = [s for s in recorded if s.name == "pipeline.replay"]
    events = sorted(main, key=lambda s: s.start_ns)
    pending, owed, redone, requeued = [], [], set(), 0
    for k, s in enumerate(events):
        replay = any(m.group == s.group and s.start_ns <= m.start_ns <= s.end_ns for m in marks)
        if s.name == "pipeline.issue":
            if owed:
                assert replay and s.group == owed.pop(0)
            elif replay:   # the group being finished, from its own start
                assert s.group == pending[0] and events[k - 1].name == "pipeline.fetch.wait"
                redone.add(s.group)
            else:
                pending.append(s.group)
            continue
        assert not owed and s.group == pending[0]
        nxt = events[k + 1] if k + 1 < len(events) else None
        if nxt is not None and nxt.name == "pipeline.issue" and nxt.group == s.group:
            continue   # replayed: not delivered yet
        pending.pop(0)
        if s.group in redone:
            owed = list(pending)
            requeued += len(owed)
    assert not owed and not pending and redone
    return requeued


@pytest.mark.parametrize("probe", ["early", "blocked"])
@pytest.mark.parametrize("depth", [0, 1, 3])
def test_the_early_fetch_keeps_output_and_replays(capture, jax_results, monkeypatch, depth,
                                                  probe):
    """With the early fetch forced (no next input is ever ready) and with it
    blocked (the next always is), a forced overflow (max_candidates=16)
    still replays the group from its own start and re-issues every group
    still pending, in order; the lines, counters and cache equal the JAX
    package's at every depth."""
    from dump1090_tpu_torch.models import pipeline as pl
    from dump1090_tpu_torch.utils import spans

    monkeypatch.setattr(pl._Groups, "ready", lambda self: probe == "blocked")
    raw_j, stats_j, addr_j, ts_j = jax_results["fix"]
    spans.RECORDER.clear()
    p, raw = _port_decode(capture, True, False, dispatch_ahead=depth)
    recorded = spans.RECORDER.spans()
    assert raw == raw_j and _counters(p.stats) == stats_j
    np.testing.assert_array_equal(p.cache.addr, addr_j)
    np.testing.assert_array_equal(p.cache.ts, ts_j)
    requeued = _check_replays(recorded)
    early = [s.group for s in recorded if s.name == spans.FETCH_EARLY]
    if probe == "early":   # nothing is pending behind a group being fetched
        assert requeued == 0 and early
    else:                  # the second group was in flight when the first replayed
        assert requeued >= 1 and not early


def test_run_device_emits_under_the_callers_lock(capture):
    """run_device holds the pipeline's lock around each batch's emits, so
    another thread decoding raw network input under the same lock never
    interleaves with a batch."""
    import threading

    lock = threading.RLock()
    p = DemodPipeline(PipelineConfig(batch_buffers=2, dispatch_groups=2), clock=lambda: NOW,
                      device="cpu", lock=lock)
    held = []
    p.run_device(io.BytesIO(capture), lambda mm: held.append(lock._is_owned()))
    assert len(held) > 100 and all(held)
    assert not lock._is_owned()


def test_run_source_device_equals_run_device_and_syncs_the_cache_when_cut(capture, monkeypatch):
    """Live buffers (no stream) through run_source_device, in two calls that
    chain through the host cache, give run_device's messages on the same
    bytes; a decode cut by KeyboardInterrupt while it hands over a group's
    messages still syncs the device cache of the groups it delivered back
    to the host cache (--tpu-state-save reads it): the cache that decoding
    only those groups leaves."""
    from dump1090_tpu_torch.io.sources import iq_buffers

    def make():
        return DemodPipeline(PipelineConfig(batch_buffers=2, dispatch_groups=1),
                             clock=lambda: NOW, device="cpu")

    want, got = [], []
    p = make()
    p.run_device(io.BytesIO(capture), want.append)
    bufs = list(iq_buffers(io.BytesIO(capture)))
    live = make()
    live.run_source_device(bufs[:4], got.append)
    after_two_groups = live.cache.addr.copy(), live.cache.ts.copy()
    live.run_source_device(bufs[4:], got.append)
    assert [dataclasses.astuple(m) for m in got] == [dataclasses.astuple(m) for m in want]
    assert _counters(live.stats) == _counters(p.stats)
    np.testing.assert_array_equal(live.cache.addr, p.cache.addr)

    # cut while the second group's messages are handed over: the first two
    # groups were delivered
    from dump1090_tpu_torch.models import pipeline as pl

    cut, calls, real = make(), [], pl.messages_from_device_arrays

    def decode(*a):
        calls.append(1)
        if len(calls) == 2:
            raise KeyboardInterrupt
        return real(*a)

    monkeypatch.setattr(pl, "messages_from_device_arrays", decode)
    with pytest.raises(KeyboardInterrupt):
        cut.run_device(io.BytesIO(capture), lambda mm: None)
    monkeypatch.undo()
    assert (cut.cache.addr != 0).any()
    np.testing.assert_array_equal(cut.cache.addr, after_two_groups[0])
    np.testing.assert_array_equal(cut.cache.ts, after_two_groups[1])


def test_raw_input_threads_and_run_device_share_the_hub_under_the_lock(capture):
    """The CLI's two writers of one state, stressed: run_device emitting
    into the hub while more threads than cores feed raw lines into it
    through decode_hex_message, all under one reentrant lock, with a short
    switch interval.  No update to the tracker is lost and no verbose block
    is cut by another."""
    import os
    import sys
    import threading

    from dump1090_tpu_torch.models.decoder import decode_hex_message
    from dump1090_tpu_torch.models.hub import HubConfig, MessageHub
    from dump1090_tpu_torch.models.tracker import AircraftTracker
    from dump1090_tpu_torch.utils.synth import traffic_frames

    lock = threading.RLock()
    p = DemodPipeline(PipelineConfig(batch_buffers=1, dispatch_groups=1), clock=lambda: NOW,
                      device="cpu", lock=lock)
    p.stats.sbs_connections = 1  # tracking on
    out = io.StringIO()
    hub = MessageHub(HubConfig(), AircraftTracker(clock=lambda: NOW, msclock=lambda: NOW * 1000),
                     p.stats, out=out)
    used = [0]

    def use(mm):
        with lock:
            hub.use_message(mm)
            used[0] += mm.crcok

    lines = ["*%s;\n" % f.hex() for f, _ in traffic_frames(61, 300)]

    done = threading.Event()

    def feed(k):
        while not done.is_set():  # raw input for as long as the decode runs
            for line in lines[k::4]:
                with lock:
                    mm = decode_hex_message(line, p.cache, p.cfg.decoder, p.stats)
                    if mm is not None:
                        use(mm)

    threads = [threading.Thread(target=feed, args=(k % 4,)) for k in range(2 * (os.cpu_count() or 4))]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        p.run_device(io.BytesIO(capture), use)
    finally:
        done.set()
        for t in threads:
            t.join(timeout=120)
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert used[0] > 500
    assert sum(a.messages for a in hub.tracker.aircraft) == used[0]
    text = out.getvalue().splitlines()
    starts = [i for i, ln in enumerate(text) if ln.startswith("*")]
    assert len(starts) == used[0]
    assert all(text[i + 1].startswith("CRC: ") for i in starts)


# ---- the host-resolve path: demod on the device, resolve on the host --------


@pytest.fixture(scope="module")
def traffic():
    from dump1090_tpu_torch.utils.synth import traffic_capture

    data, _ = traffic_capture(5, 160, seed=51, blank_every=13)
    return data


def _host_run(pkg_pipeline, pkg_config, dec_config, data, fix, aggressive, native, **kw):
    p = pkg_pipeline(pkg_config(decoder=dec_config(fix_errors=fix, aggressive=aggressive), **kw),
                     clock=lambda: NOW, native=native,
                     **({"device": "cpu"} if pkg_pipeline is DemodPipeline else {}))
    out = []
    p.run(io.BytesIO(data), out.append)
    return p, [dataclasses.asdict(m) for m in out]


@pytest.mark.parametrize("mode,native", [("fix", True), ("nofix", True), ("aggressive", True),
                                         ("fix", False)])
def test_host_path_matches_jax_and_run_device(traffic, mode, native, request):
    """DemodPipeline.run (2-buffer batches, candidate overflow forced from
    max_candidates=16) against the JAX package's run and against the
    port's own run_device on the same input: every message field, the 8
    counters and the ICAO cache."""
    if native:
        request.getfixturevalue("jax_native")
    fix, aggressive = MODES[mode]
    kw = dict(batch_buffers=2, max_candidates=16)
    p, got = _host_run(DemodPipeline, PipelineConfig, DecoderConfig, traffic, fix, aggressive,
                       native, **kw)
    pj, want = _host_run(JaxPipeline, JaxPipelineConfig, JaxDecoderConfig, traffic, fix,
                         aggressive, native, **kw)
    assert (p._native is not None) == (pj._native is not None) == native
    assert got == want and _counters(p.stats) == _counters(pj.stats)
    np.testing.assert_array_equal(p.cache.addr, pj.cache.addr)
    np.testing.assert_array_equal(p.cache.ts, pj.cache.ts)
    assert p.shapes.mc == pj._mc > 16, "the overflow retry should have grown the shape"
    dev = DemodPipeline(PipelineConfig(decoder=DecoderConfig(fix_errors=fix, aggressive=aggressive),
                                       batch_buffers=2, dispatch_groups=2),
                        clock=lambda: NOW, device="cpu")
    on_dev = []
    dev.run_device(io.BytesIO(traffic), on_dev.append)
    assert got == [dataclasses.asdict(m) for m in on_dev]
    assert _counters(p.stats) == _counters(dev.stats)
    assert sum(m["crcok"] for m in got) > 500 and len({m["msgtype"] for m in got}) >= 9


def test_messages_stream_records_and_run_source_agree(traffic):
    """messages() yields run's messages; stream_records (one native call a
    batch, the per-row fallback on overflow) gives one record array per
    buffer whose crcok frames are run's; run_source over framed buffers is
    run one buffer at a time."""
    from dump1090_tpu_torch.io.sources import iq_buffers
    from dump1090_tpu_torch.native import records_to_raw_lines

    def fresh(**kw):
        return DemodPipeline(PipelineConfig(**kw), clock=lambda: NOW, device="cpu")

    want = []
    fresh(batch_buffers=3).run(io.BytesIO(traffic), want.append)
    want = [dataclasses.asdict(m) for m in want]
    assert [dataclasses.asdict(m) for m in fresh(batch_buffers=3).messages(io.BytesIO(traffic))] \
        == want
    raw_want = b"".join(b"*" + m["msg"][: m["msgbits"] // 8].hex().encode() + b";\n"
                        for m in want if m["crcok"])
    for kw in (dict(batch_buffers=3), dict(batch_buffers=2, max_candidates=16)):
        p = fresh(**kw)
        recs = list(p.stream_records(io.BytesIO(traffic)))
        assert len(recs) == 5 and b"".join(map(records_to_raw_lines, recs)) == raw_want
    src = fresh()
    got = []
    src.run_source(list(iq_buffers(io.BytesIO(traffic))), got.append)
    assert [dataclasses.asdict(m) for m in got] == want and src.samples_in == 5 * 131072
    with pytest.raises(RuntimeError, match="native"):
        next(DemodPipeline(PipelineConfig(), device="cpu", native=False).stream_records(
            io.BytesIO(traffic)))


def test_host_path_enqueues_the_next_demod_before_waiting(traffic, monkeypatch):
    """Buffer (or batch) N+1's demodulation and fetch are enqueued before
    the host waits on N's fetch, on both forms of the host path."""
    from dump1090_tpu_torch.models import pipeline as pl

    log = []
    real_batch, real_block, real_get = pl.demod_batch, pl.demod_iq_block, pl._Fetch.get

    def batch(*a, **k):
        log.append("D")
        return real_batch(*a, **k)

    def block(*a, **k):
        log.append("D")
        return real_block(*a, **k)

    def get(self):
        log.append("F")
        return real_get(self)

    monkeypatch.setattr(pl, "demod_batch", batch)
    monkeypatch.setattr(pl, "demod_iq_block", block)
    monkeypatch.setattr(pl._Fetch, "get", get)
    for nb in (2, 1):
        log.clear()
        DemodPipeline(PipelineConfig(batch_buffers=nb), clock=lambda: NOW,
                      device="cpu").run(io.BytesIO(traffic), lambda mm: None)
        n = -(-5 // nb)
        assert log == ["D", "D"] + ["F", "D"] * (n - 2) + ["F", "F"], nb


def test_host_path_resolves_under_the_callers_lock(traffic):
    import threading

    lock = threading.RLock()
    for native in (True, False):
        p = DemodPipeline(PipelineConfig(batch_buffers=2), clock=lambda: NOW, device="cpu",
                          lock=lock, native=native)
        held = []
        p.run(io.BytesIO(traffic), lambda mm: held.append(lock._is_owned()))
        assert len(held) > 500 and all(held) and not lock._is_owned()


def test_demod_retry_grows_x4_sticks_and_stops_at_the_ceiling(capture, monkeypatch):
    """A buffer whose exact count overflows is demodulated again alone at
    4x until it fits, the shape sticks, and past the every-other-position
    ceiling the overflow raises."""
    from dump1090_tpu_torch.models import pipeline as pl
    from dump1090_tpu_torch.models import shapes as shapes_mod

    shapes = []
    real = pl.demod_iq_block

    def block(*a, **k):
        shapes.append(k["max_candidates"])
        return real(*a, **k)

    monkeypatch.setattr(pl, "demod_iq_block", block)
    p = DemodPipeline(PipelineConfig(max_candidates=16), clock=lambda: NOW, device="cpu",
                      native=False)
    p.run(io.BytesIO(capture), lambda mm: None)
    # buffer 2 was enqueued at 16 before buffer 1's retries (64, 256) grew
    # the shape; its own retry starts from the 16 it was demodulated with
    assert shapes == [16, 16, 64, 256, 256, 64, 256, 256, 256] and p.shapes.mc == 256
    monkeypatch.setattr(shapes_mod, "MAX_BUFFER_CANDIDATES", 100 // 2 + 1)
    with pytest.raises(OverflowError):
        DemodPipeline(PipelineConfig(max_candidates=4), device="cpu",
                      native=False).run(io.BytesIO(capture), lambda mm: None)
