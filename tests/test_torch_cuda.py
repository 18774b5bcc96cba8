"""The CUDA kernels against their plain versions, and the pipeline on the
card against the port's CPU run.  These need an NVIDIA card and nvcc; they
carry the `cuda` marker and skip without a card.  On a card:

    python -m pytest tests/test_torch_cuda.py -m cuda -q
"""

import dataclasses
import io

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

NOW = 1_700_000_000


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("mc", [16, 24, 256])
def test_gather_kernel_equals_plain(cuda, mc):
    from dump1090_tpu_torch.ops import _cuda
    from dump1090_tpu_torch.ops.gather import WINDOW_PAD, gather_windows, gather_windows_plain

    rng = np.random.default_rng(0)
    b, s_pad = 5, 8 * 1024
    m_pad = torch.from_numpy(rng.integers(0, 65168, (b, s_pad), dtype=np.uint16)).to(cuda)
    pos = np.sort(rng.integers(0, s_pad - WINDOW_PAD - 2048, (b, mc)), axis=1)
    pos[0, :4] = [0, 1, 127, 128]
    pos = torch.from_numpy(pos.astype(np.int32)).to(cuda)
    before = _cuda.launches["gather_windows"]
    got = gather_windows(m_pad, pos)
    torch.cuda.synchronize()
    assert _cuda.launches["gather_windows"] == before + 1
    assert torch.equal(got.view(torch.int16), gather_windows_plain(m_pad, pos).view(torch.int16))


@pytest.mark.parametrize("lead,s,s_pad", [(1, 2000, 5120), (0, 1 + 1024 + 240, 2048)])
@pytest.mark.parametrize("mc", [16, 24, 256])
def test_fused_gather_kernel_equals_plain_and_two_step(cuda, mc, lead, s, s_pad):
    """K1 on int32 magnitudes (the file path's geometry, lead 1, and a
    shard's, lead 0) bit-equal to its plain version and to the two-step
    path (zero-padded uint16 rows, then K1 on them), with edge positions
    (0, negative, at and past s_pad - 256) in every row and values above
    32,767."""
    from dump1090_tpu_torch.ops import _cuda
    from dump1090_tpu_torch.ops.gather import (
        gather_row_windows, gather_row_windows_plain, gather_windows)

    rng = np.random.default_rng(mc + lead)
    b = 4
    m = rng.integers(0, 65168, (b, s), dtype=np.int32)
    m[:, :3] = [32767, 32768, 65167]
    pos = np.sort(rng.integers(0, s - 240, (b, mc)), axis=1)
    pos[:, :8] = [0, 1, -1, -500, s - 240, s_pad - 256, s_pad - 100, s_pad + 9000]
    m, pos = (torch.from_numpy(a.astype(np.int32)).to(cuda) for a in (m, pos))
    before = _cuda.launches["gather_windows"]
    got = gather_row_windows(m, pos, lead=lead, s_pad=s_pad)
    torch.cuda.synchronize()
    assert _cuda.launches["gather_windows"] == before + 1
    want = gather_row_windows_plain(m, pos, lead=lead, s_pad=s_pad).view(torch.int16)
    m_pad = torch.zeros((b, s_pad), dtype=torch.int16, device=cuda)
    m_pad[:, lead:lead + s] = m
    assert torch.equal(got.view(torch.int16), want)
    assert torch.equal(gather_windows(m_pad.view(torch.uint16), pos).view(torch.int16), want)


def _walk_inputs(mc):
    """The walk's adversarial inputs at width mc, as numpy int32 (pf, w1,
    w2, nbuf, cache_addr, cache_ts): random words, and the forced-cut
    stream (a cache slot written back to back with colliding addresses,
    address 0 among them; counts 0, mc, below 0 and above mc)."""
    from dump1090_tpu_torch.utils.synth import forced_cut_stream, random_word_stream

    nb = 2 if mc > 1024 else 6
    return [random_word_stream(7, nb, mc, NOW), forced_cut_stream(8, nb, mc, NOW)]


def _at_offset(t, off):
    """t's values in a contiguous view `off` elements into a larger
    buffer: the kernel copies 16-byte aligned runs, so an input that starts
    between two 16-byte boundaries has ragged ends."""
    buf = torch.zeros(t.numel() + 4, dtype=t.dtype, device=t.device)
    buf[off:off + t.numel()] = t
    return buf[off:off + t.numel()]


def test_resolve_kernel_equals_plain(cuda):
    from test_torch_resolve_batched import _random_stream, batched_walk, zero_write_stream

    from dump1090_tpu_torch.ops import resolve as tr
    from dump1090_tpu_torch.utils.synth import random_word_stream

    def hashed(arrays):
        pf, w1, w2, nbuf, ca, ct = arrays
        return pf, w1, w2, tr._hash_words(torch.from_numpy(w1), torch.from_numpy(w2)).numpy(), nbuf, ca, ct

    cases = [(hashed(a), mc) for mc in (64, 4096) for a in _walk_inputs(mc)]
    cases += [(hashed(random_word_stream(7, 40, 256, NOW)), 256)]
    # buffers that straddle chunks, and a chunk of 1024 one-slot buffers
    cases += [(hashed(random_word_stream(9, 9, 300, NOW)), 300),
              (hashed(random_word_stream(5, 2100, 1, NOW)), 1)]
    cases += [(hashed(zero_write_stream(expired)), 8) for expired in (False, True)]
    # arbitrary words: every flag at random, walked slots without PF_VALID,
    # PF_NEWBUF anywhere, hash slots that collide
    cases += [(_random_stream(seed, 4, 70), 70) for seed in range(4)]
    cases += [(_random_stream(11, 20, 300), 300)]
    for arrays, mc in cases:
        pf, w1, w2, h12, nbuf, ca, ct = (torch.from_numpy(a).to(cuda) for a in arrays)
        want = tr.resolve_words_plain(pf, w1, w2, h12, nbuf, ca, ct, NOW, mc)
        model = batched_walk(*arrays, NOW, mc)
        for offsets in ((0, 0, 0, 0), (1, 2, 3, 1), (3, 0, 1, 2)):
            views = [_at_offset(t, off) for t, off in zip((pf, w1, w2, h12), offsets)]
            *got, counts = tr.resolve_words(*views, nbuf, ca, ct, NOW, mc, walk_counts=True)
            torch.cuda.synchronize()
            for g, w in zip(got, want):
                assert torch.equal(g, w), (mc, offsets)
            # the kernel took the model's batches and cuts
            assert counts.tolist() == [[model[3], model[4]]], (mc, offsets)
        assert len(tr.resolve_words(pf, w1, w2, h12, nbuf, ca, ct, NOW, mc)) == 3


@pytest.mark.parametrize("n_streams,nb,mc", [(1, 6, 64), (5, 4, 256), (3, 2, 4096)])
def test_resolve_streams_kernel_equals_plain_and_k2(cuda, n_streams, nb, mc):
    from test_torch_resolve_batched import batched_walk

    from dump1090_tpu_torch.ops import _cuda
    from dump1090_tpu_torch.ops import resolve as tr
    from dump1090_tpu_torch.utils.synth import forced_cut_stream, random_word_stream

    for make in (random_word_stream, forced_cut_stream):
        parts = [make(3 + s, nb, mc, NOW) for s in range(n_streams)]
        pf, w1, w2, nbuf, ca, ct = (np.stack([p[i] for p in parts]) for i in range(6))
        if n_streams > 1:  # one exhausted stream
            nbuf[1] = 0
            pf[1] &= ~tr.PF_VALID
        pf, w1, w2, nbuf = (torch.from_numpy(a.reshape(-1)).to(cuda) for a in (pf, w1, w2, nbuf))
        ca, ct = (torch.from_numpy(a).to(cuda) for a in (ca, ct))
        h12 = tr._hash_words(w1, w2)
        before = _cuda.launches["resolve_words_streams"]
        *got, counts = tr.resolve_words_streams(pf, w1, w2, h12, nbuf, ca, ct, NOW, mc,
                                                n_streams, walk_counts=True)
        torch.cuda.synchronize()
        assert _cuda.launches["resolve_words_streams"] == before + 1
        want = tr.resolve_words_streams_plain(pf, w1, w2, h12, nbuf, ca, ct, NOW, mc, n_streams)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        per = nb * mc
        for s in range(n_streams):  # each stream equals K2 on that stream alone
            sl = slice(s * per, (s + 1) * per)
            one = tr.resolve_words(pf[sl], w1[sl], w2[sl], h12[sl], nbuf[s * nb:(s + 1) * nb],
                                   ca[s], ct[s], NOW, mc)
            assert torch.equal(one[0], got[0][sl])
            assert torch.equal(one[1], got[1][s]) and torch.equal(one[2], got[2][s])
            model = batched_walk(*(t.cpu().numpy() for t in (
                pf[sl], w1[sl], w2[sl], h12[sl], nbuf[s * nb:(s + 1) * nb], ca[s], ct[s])), NOW, mc)
            assert counts[s].tolist() == [model[3], model[4]]


def test_decode_captures_on_card_equals_cpu(cuda, monkeypatch):
    import time

    from dump1090_tpu_torch import decode_captures
    from dump1090_tpu_torch.utils.synth import planted_capture

    monkeypatch.setattr(time, "time", lambda: float(NOW))
    data, _ = planted_capture(4, 60, seed=5, noise_sigma=3.0)
    caps = [data, data[: 2 * 262144], data[262144:]]
    outs = {dev: decode_captures(caps, device=dev, device_resolve=True)
            for dev in ("cuda", "cpu")}
    assert outs["cuda"] == outs["cpu"] and all(outs["cuda"])


def test_pipeline_on_card_equals_cpu(cuda):
    from dump1090_tpu_torch.models.pipeline import DemodPipeline, PipelineConfig
    from dump1090_tpu_torch.utils.synth import planted_capture

    data, _ = planted_capture(5, 60, seed=21, noise_sigma=3.0)
    outs = {}
    for dev in ("cuda", "cpu"):
        p = DemodPipeline(PipelineConfig(batch_buffers=2, dispatch_groups=2, max_candidates=16),
                          clock=lambda: NOW, device=dev)
        outs[dev] = (b"".join(p.stream_raw_device(io.BytesIO(data))), p.stats)
    assert outs["cuda"] == outs["cpu"]


def test_two_decodes_on_their_own_streams_equal_cpu(cuda):
    """Two stream_raw_device decodes at once, each in its own thread on its
    own CUDA stream (the soak's two planes), each equal to its CPU run: a
    decode on a non-default stream keeps its uploads and their allocations
    on that stream."""
    import threading

    from dump1090_tpu_torch.models.pipeline import DemodPipeline, PipelineConfig
    from dump1090_tpu_torch.utils.synth import planted_capture

    datas = [planted_capture(8, 60, seed=seed, noise_sigma=3.0)[0] for seed in (23, 24)]

    def decode(data, dev):
        p = DemodPipeline(PipelineConfig(batch_buffers=2, dispatch_groups=2, max_candidates=16),
                          clock=lambda: NOW, device=dev)
        return b"".join(p.stream_raw_device(io.BytesIO(data))), p.stats

    got, errors = {}, []

    def work(k):
        try:
            with torch.cuda.stream(torch.cuda.Stream(cuda)):
                got[k] = decode(datas[k], cuda)
        except BaseException as e:  # re-raised below
            errors.append(e)

    threads = [threading.Thread(target=work, args=(k,)) for k in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    for k, data in enumerate(datas):
        assert got[k] == decode(data, "cpu") and got[k][0]


def test_run_device_on_card_equals_cpu(cuda):
    """The unpacked group emission (run_device) on the card, with candidate
    growth forced, against the CPU run."""
    from dump1090_tpu_torch.models.pipeline import DemodPipeline, PipelineConfig
    from dump1090_tpu_torch.utils.synth import planted_capture

    data, _ = planted_capture(5, 60, seed=22, noise_sigma=3.0)
    outs = {}
    for dev in ("cuda", "cpu"):
        p = DemodPipeline(PipelineConfig(batch_buffers=2, dispatch_groups=2, max_candidates=16),
                          clock=lambda: NOW, device=dev)
        msgs = []
        p.run_device(io.BytesIO(data), msgs.append)
        outs[dev] = (msgs, p.stats)
    assert outs["cuda"] == outs["cpu"] and outs["cuda"][0]


def test_hub_over_run_device_on_card_equals_cpu(cuda):
    """The CLI's hub path on the card: run_device into the message hub,
    verbose display and SBS lines (tracking on through a counted SBS
    client), against the CPU run; K1 and K2 launched on the card run."""
    from dump1090_tpu_torch.models.hub import HubConfig, MessageHub
    from dump1090_tpu_torch.models.pipeline import DemodPipeline, PipelineConfig
    from dump1090_tpu_torch.models.tracker import AircraftTracker
    from dump1090_tpu_torch.ops import _cuda
    from dump1090_tpu_torch.utils.synth import planted_capture

    data, _ = planted_capture(6, 80, seed=23, noise_sigma=3.0, flip_weights=(0.6, 0.3, 0.1))
    outs = {}
    for dev in ("cuda", "cpu"):
        p = DemodPipeline(PipelineConfig(batch_buffers=2, dispatch_groups=2), clock=lambda: NOW,
                          device=dev)
        p.stats.sbs_connections = 1
        text, sbs = io.StringIO(), []
        tracker = AircraftTracker(clock=lambda: NOW, msclock=lambda: NOW * 1000)
        hub = MessageHub(HubConfig(), tracker, p.stats, out=text, sbs_sink=sbs.append)
        _cuda.reset_launches()
        p.run_device(io.BytesIO(data), hub.use_message)
        launches = dict(_cuda.launches)
        outs[dev] = (text.getvalue(), sbs, p.stats)
        if dev == "cuda":
            assert launches["gather_windows"] > 0 and launches["resolve_words"] > 0
    assert outs["cuda"] == outs["cpu"]
    assert outs["cuda"][0].count("CRC: ") > 300 and outs["cuda"][1]


def test_host_path_on_card_equals_cpu_with_k1_checked_at_its_shapes(cuda, monkeypatch):
    """The host-resolve path (DemodPipeline.run, native runtime) on one
    group of 16 dense buffers, in 16-buffer batches and one buffer at a
    time, on the card against the CPU run.  Every K1 launch on the card is
    held against gather_row_windows_plain: at (16, 256), at (1, 256), and at
    (1, 1024) after the forced retry of a buffer with more than 256
    preambles."""
    from dump1090_tpu_torch.models.pipeline import DemodPipeline, PipelineConfig
    from dump1090_tpu_torch.ops import _cuda
    from dump1090_tpu_torch.ops import demod as td
    from dump1090_tpu_torch.ops.gather import gather_row_windows_plain
    from dump1090_tpu_torch.utils.synth import planted_capture

    shapes = []
    real = td.gather_row_windows

    def checked(m, pos, **kw):
        out = real(m, pos, **kw)
        if out.is_cuda:
            shapes.append(tuple(pos.shape))
            want = gather_row_windows_plain(m, pos, **kw)
            assert torch.equal(out.view(torch.int16), want.view(torch.int16))
        return out

    monkeypatch.setattr(td, "gather_row_windows", checked)
    dense, _ = planted_capture(14, 150, seed=31)
    denser, _ = planted_capture(2, 240, seed=32)  # more than 256 preambles a buffer
    data = dense + denser
    for nb in (16, 1):
        outs = {}
        for dev in ("cuda", "cpu"):
            p = DemodPipeline(PipelineConfig(batch_buffers=nb), clock=lambda: NOW, device=dev,
                              native=True)
            msgs = []
            _cuda.reset_launches()
            p.run(io.BytesIO(data), msgs.append)
            # a native record becomes its ModesMessage on the way
            outs[dev] = ([dataclasses.astuple(m) for m in msgs], p.stats, p._mc)
            if dev == "cuda":
                assert _cuda.launches["gather_windows"] > 0
        assert outs["cuda"] == outs["cpu"] and outs["cuda"][2] == 1024
        assert sum(m.crcok for m in msgs) > 2000
    assert {(16, 256), (1, 256), (1, 1024)} <= set(shapes)


@pytest.mark.parametrize("front", ["packed", "packed-mxu", "packed-plain", "packed-plain-mxu"])
def test_front_variants_on_card_equal_mask_and_cpu(cuda, front):
    """Each packed front on the card, through _group_front at the live and
    the file shapes' candidate counts, gives the mask form's (n, pos) on
    the card and its own on the CPU; the file decode under it gives the
    mask decode's bytes."""
    from dump1090_tpu_torch.io.sources import iq_buffers
    from dump1090_tpu_torch.models.pipeline import DemodPipeline, PipelineConfig
    from dump1090_tpu_torch.ops.resolve import _group_front
    from dump1090_tpu_torch.utils.synth import planted_capture

    data, _ = planted_capture(4, 150, seed=41, noise_sigma=3.0)
    xg = torch.from_numpy(np.stack(list(iq_buffers(io.BytesIO(data))))).reshape(2, 2, -1)
    for mc in (64, 256, 4096):
        outs = {}
        for dev, f in (("cuda", front), ("cuda", "mask"), ("cpu", front)):
            _, n, pos = _group_front(xg.to(dev), scan_len=131070, max_candidates=mc, front=f)
            outs[(dev, f)] = (n.cpu(), pos.cpu())
        ref = outs[("cuda", "mask")]
        for got in outs.values():
            assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    raw = {}
    for f in ("mask", front):
        p = DemodPipeline(PipelineConfig(batch_buffers=2, dispatch_groups=2, front=f),
                          clock=lambda: NOW, device="cuda")
        raw[f] = b"".join(p.stream_raw_device(io.BytesIO(data)))
    assert raw[front] == raw["mask"] and raw["mask"]


def test_live_paths_on_card_equal_cpu(cuda, tmp_path, monkeypatch):
    """The stub radio's four paced buffers through run_source_device and
    run_source on the card (after a warm-up) against run_source on the CPU:
    the same messages and counters, K1 and K2 launched on the device path."""
    import subprocess
    from pathlib import Path

    from dump1090_tpu_torch.io.rtlsdr import RtlSdrSource
    from dump1090_tpu_torch.models.pipeline import DemodPipeline, PipelineConfig
    from dump1090_tpu_torch.ops import _cuda
    from dump1090_tpu_torch.utils.synth import planted_capture

    lib = tmp_path / "librtlsdr_stub.so"
    src = Path(__file__).resolve().parent / "stub_rtlsdr.c"
    try:
        subprocess.run(["gcc", "-shared", "-fPIC", str(src), "-o", str(lib)], check=True,
                       capture_output=True)
    except (OSError, subprocess.CalledProcessError) as e:
        pytest.skip(f"cannot build stub librtlsdr: {e}")
    data, _ = planted_capture(4, 150, seed=42, noise_sigma=3.0)
    (tmp_path / "air.bin").write_bytes(data)
    monkeypatch.setenv("DUMP1090_TPU_LIBRTLSDR", str(lib))
    monkeypatch.setenv("RTLSDR_STUB_DATA", str(tmp_path / "air.bin"))
    monkeypatch.setenv("RTLSDR_STUB_DELAY_US", "200000")
    outs = {}
    for dev, method in (("cuda", "run_source_device"), ("cuda", "run_source"),
                        ("cpu", "run_source")):
        DemodPipeline(PipelineConfig(), clock=lambda: NOW, device=dev).run_device(
            io.BytesIO(data), lambda mm: None)
        p, msgs = DemodPipeline(PipelineConfig(), clock=lambda: NOW, device=dev), []
        _cuda.reset_launches()
        getattr(p, method)(RtlSdrSource(err=io.StringIO()).buffers(), msgs.append)
        if method == "run_source_device":
            assert _cuda.launches["gather_windows"] >= 4 and _cuda.launches["resolve_words"] >= 4
        outs[(dev, method)] = ([dataclasses.astuple(m) for m in msgs], dataclasses.astuple(p.stats))
    assert len(set(map(repr, outs.values()))) == 1 and outs[("cpu", "run_source")][0]


def test_sharded_decode_on_card_equals_cpu(cuda):
    """decode_capture_sharded on a (2, 4) mesh of the one card and on a
    (1, 1) mesh, both resolve strategies, from max_candidates 16: the
    messages, counters and cache of the CPU run on a (2, 4) mesh, with K1
    (every shard) and K2 (the segments) launched."""
    from dump1090_tpu_torch import decode_capture_sharded
    from dump1090_tpu_torch.models.decoder import DecoderStats, IcaoCache
    from dump1090_tpu_torch.ops import _cuda
    from dump1090_tpu_torch.parallel.sharding import Mesh
    from dump1090_tpu_torch.utils.synth import planted_capture

    data, _ = planted_capture(4, 150, seed=1)

    def run(mesh, dr):
        st, cache = DecoderStats(), IcaoCache(clock=lambda: NOW)
        msgs = decode_capture_sharded(data, mesh=mesh, stats=st, cache=cache,
                                      max_candidates=16, device_resolve=dr)
        return ([dataclasses.asdict(m) for m in msgs], dataclasses.astuple(st),
                cache.addr.tolist(), cache.ts.tolist())

    for dr in (True, False):
        want = run(Mesh([["cpu"] * 4] * 2), dr)
        assert len(want[0]) > 500
        for dp, sp in ((2, 4), (1, 1)):
            _cuda.reset_launches()
            got = run(Mesh([[cuda] * sp] * dp), dr)
            torch.cuda.synchronize()
            assert got == want, (dp, sp, dr)
            assert _cuda.launches["gather_windows"] > 0
            assert (_cuda.launches["resolve_words"] > 0) == dr


def test_uint16_magnitudes_on_card_equal_int32_and_cpu(cuda):
    """out_dtype=torch.uint16 on the card: the same values as int32 (at most
    65,167) and as the CPU, through both entries."""
    from dump1090_tpu_torch.ops.magnitude import magnitude_from_iq, magnitude_from_pairs

    pairs = np.random.default_rng(4).integers(0, 1 << 16, (3, 4096), dtype=np.uint16)
    pairs[0, :2] = [0x0000, 0xFFFF]
    want = magnitude_from_pairs(torch.from_numpy(pairs)).numpy()
    for got in (magnitude_from_pairs(torch.from_numpy(pairs).to(cuda), out_dtype=torch.uint16),
                magnitude_from_iq(torch.from_numpy(pairs.view(np.uint8)).to(cuda),
                                  out_dtype=torch.uint16)):
        assert got.dtype == torch.uint16
        np.testing.assert_array_equal(got.cpu().view(torch.int16).numpy().view(np.uint16), want)
