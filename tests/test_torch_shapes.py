"""The working shapes of the port's device paths, on the CPU.

Unit cases for each rule of models/shapes.py: first-use sizing, fitting a
group to its peaks (the candidate cap and its error, the packed clamp, the
emission growth), the quiet-air shrink, and the retry steps with their
ceiling.  The characterization test records the shapes of every device
dispatch, replays included, of the port's two device paths and of the JAX
package's on the same input (dense air, then silence, from forced small
shapes, so that growth, replay and shrink all happen), and requires the two
sequences to be equal.  It also pins the host retry's steps and the final
shapes of decode_captures and decode_capture_sharded."""

import dataclasses
import functools
import io

import numpy as np
import pytest

import dump1090_tpu.ops.resolve as jr
import dump1090_tpu_torch.api as tapi
import dump1090_tpu_torch.models.pipeline as pl
from dump1090_tpu.models.decoder import DecoderConfig as JaxDecoderConfig
from dump1090_tpu.models.pipeline import DemodPipeline as JaxPipeline
from dump1090_tpu.models.pipeline import PipelineConfig as JaxPipelineConfig
from dump1090_tpu_torch.models import shapes as sh
from dump1090_tpu_torch.models.decoder import DecoderConfig
from dump1090_tpu_torch.models.pipeline import DemodPipeline, PipelineConfig
from dump1090_tpu_torch.models.shapes import Peaks, Shapes
from dump1090_tpu_torch.ops.resolve import PACKED_RANK_LIMIT, max_candidates_cap
from dump1090_tpu_torch.utils.synth import planted_capture
# jax_native: the JAX package's pipelines resolve on the host with its
# native runtime, a private copy
from test_torch_native import jax_native  # noqa: F401  (a fixture)
from test_torch_sharding import _cpu_mesh

NOW = 1_700_000_000
BLOCK = 262144
SHAPE_KEYS = ("max_candidates", "max_out_short", "max_out_long", "max_out")


def test_sizing_on_first_use_only():
    """The emission shapes stay None until sized, are sized from mc and
    the batch's buffers, and keep what they hold at a later start, which
    restarts the count of quiet groups."""
    s = Shapes(256)
    assert s.key == (256, None, None, None)
    s.size(1)
    assert s.key == (256, 2048, 2048, 4096)
    s = Shapes(256)
    s.size(64)
    assert s.key == (256, 4096, 5461, 8192)
    s.mo, s.quiet = 64, 2
    s.size(64)
    assert s.key == (256, 4096, 5461, 64) and s.quiet == 0


def test_fit_grows_each_overflowing_shape_to_its_peak():
    s = Shapes(16, 2048, 2048, 64)
    assert not s.fit(Peaks(16, 2048, 2048, 64), s.key, packed=False)
    assert s.fit(Peaks(300, 10, 9000, 65), s.key, packed=False)
    assert s.key == (1024, 2048, 32768, 256)
    # a later group that fit the shapes it RAN with is never replayed,
    # though they shrank since
    s.mc = 64
    assert not s.fit(Peaks(200), (256, 2048, 2048, 64), packed=False) and s.mc == 64


def test_fit_caps_the_candidates_of_a_group():
    cap = max_candidates_cap(64)
    s = Shapes(256, 2048, 2048, 4096)
    assert s.fit(Peaks(cap - 1), s.key, packed=True, n_buffers=64) and s.mc == cap
    s = Shapes(256, 2048, 2048, 4096)
    with pytest.raises(RuntimeError, match=f"a buffer reported {cap + 1} preamble candidates "
                                           f"but a group of 64 buffers may hold at most {cap}"):
        s.fit(Peaks(cap + 1), s.key, packed=True, n_buffers=64)
    # no group size: no cap (tools/bench.py's Group)
    s = Shapes(256, 2048, 2048, 0)
    assert s.fit(Peaks(cap + 1), s.key, packed=True) and s.mc == 4 ** 8


def test_fit_keeps_packed_emissions_in_the_rank_field():
    s = Shapes(64, 8192, 8192, 4096)
    assert s.fit(Peaks(0, 8193, 100), s.key, packed=True)
    assert s.mos + s.mol <= PACKED_RANK_LIMIT and s.mos >= 8193 and s.mol >= 100
    s = Shapes(64, 8192, 8192, 4096)
    assert s.fit(Peaks(0, 8193, 100), s.key, packed=False) and (s.mos, s.mol) == (32768, 8192)
    with pytest.raises(ValueError, match="16-bit emission rank"):
        Shapes(64, 8192, 8192, 4096).fit(Peaks(0, 40_000, 30_000), (64, 8192, 8192, 4096),
                                         packed=True)


def test_shrink_after_three_quiet_groups_a_busy_one_restarts_the_count():
    s = Shapes(1024, 8192, 8192, 16384)
    quiet, busy = Peaks(1, 1, 1, 1), Peaks(129)
    assert not s.shrink(quiet) and not s.shrink(quiet) and not s.shrink(busy)
    assert s.quiet == 0
    assert [s.shrink(quiet) for _ in range(3)] == [False, False, True]
    assert s.key == (256, 2048, 2048, 4096) and s.quiet == 0
    for _ in range(6):
        s.shrink(Peaks(0))
    assert s.key == sh.FLOORS


def test_retry_steps_x4_up_to_the_ceiling():
    err = OverflowError("the row's own")
    assert sh.step(16, err) == 64 and sh.step(600, err) == 2400
    assert sh.step(600, err, normalize=True) == 4096  # the resolve chunk, 2048
    assert sh.step(sh.MAX_BUFFER_CANDIDATES - 1, err) == 4 * (sh.MAX_BUFFER_CANDIDATES - 1)
    with pytest.raises(OverflowError, match="the row's own"):
        sh.step(sh.MAX_BUFFER_CANDIDATES, err)

def test_redo_steps_a_buffer_until_it_fits_and_keeps_the_shape(monkeypatch):
    """A buffer of 100 candidates that overflowed 16 slots is demodulated
    again at 64, then 256, where it fits; the larger shape sticks, a fit
    below the session's shape keeps the session's, and past the ceiling
    the last overflow raises."""
    tried = []

    def demod(n_cands):
        def fields(mc):
            tried.append(mc)
            z = np.zeros(mc, dtype=np.int32)
            return [np.int32(n_cands), z, np.zeros((mc, 14), np.uint8), z, z.astype(bool),
                    np.zeros((mc, 14), np.uint8), z, z.astype(bool)]
        return fields

    s = Shapes(16)
    host, bc = s.redo(demod(100), 16, OverflowError("first"))
    assert tried == [64, 256] and s.mc == 256 and bc.pos.shape[0] == 100
    s.mc = 1024
    s.redo(demod(10), 4, OverflowError("first"))
    assert s.mc == 1024
    monkeypatch.setattr(sh, "MAX_BUFFER_CANDIDATES", 256)
    with pytest.raises(OverflowError, match="1000 preambles > max_candidates 256"):
        s.redo(demod(1000), 16, OverflowError("first"))


def test_round_retry_grows_candidates_then_emissions():
    s = Shapes(16, mo=64)
    assert s.retry(Peaks(17, total=65), "a buffer") and s.key == (64, None, None, 64)
    assert s.retry(Peaks(17, total=65), "a buffer") and s.key == (64, None, None, 256)
    assert not s.retry(Peaks(64, total=256), "a buffer")
    s = Shapes(sh.MAX_BUFFER_CANDIDATES, mo=64)
    with pytest.raises(OverflowError, match="candidate overflow: shard reported 70000 "
                                            "preambles > max_candidates 65536"):
        s.retry(Peaks(70_000), "shard", normalize=True)


def test_peaks_of_a_fetched_group():
    n, count, clong = np.array([[3, 9]]), np.array([7, 2]), np.array([4, 0])
    assert sh.peaks([n, count, clong, None], packed=True) == Peaks(9, 3, 4, 0)
    assert sh.peaks([n, count, None], packed=False) == Peaks(9, 0, 0, 7)
    empty = np.zeros(0, dtype=np.int32)
    assert sh.peaks([empty, empty, empty], packed=True) == Peaks(0, 0, 0, 0)


@pytest.fixture(scope="module")
def dense_then_quiet(tmp_path_factory):
    """Four blocks of dense planted air, then thirty-six of silence (127s,
    zero candidates), as a regular file: every group is preloaded, so no
    fetch comes early and the dispatch order is fixed."""
    data, _ = planted_capture(4, 60, seed=21, noise_sigma=3.0,
                              flip_weights=(0.6, 0.25, 0.15))
    path = tmp_path_factory.mktemp("shapes") / "air.bin"
    path.write_bytes(data + b"\x7f" * (36 * BLOCK))
    return path


def _dicts(msgs) -> list:
    return [dataclasses.asdict(m) for m in msgs]


def _recording(monkeypatch, module, name, log, keys):
    real = getattr(module, name)

    def wrapped(*a, **k):
        log.append(tuple(k.get(key) for key in keys))
        return real(*a, **k)

    monkeypatch.setattr(module, name, wrapped)


def _decode(pipeline, path, packed):
    with open(path, "rb") as f:
        if packed:
            return b"".join(pipeline.stream_raw_device(f))
        out = []
        pipeline.run_device(f, out.append)
        return len(out)


@pytest.mark.parametrize("packed", [True, False], ids=["stream_raw_device", "run_device"])
def test_dispatch_shapes_match_jax(dense_then_quiet, monkeypatch, packed, jax_native):
    """Groups of 2 x 2 buffers from max_candidates 16 and an emission room
    of 64: the port dispatches the JAX package's shapes in the JAX
    package's order, and the sequence holds a growth, replays and a
    shrink."""
    got, want = [], []
    _recording(monkeypatch, pl, "demod_resolve_group", got, SHAPE_KEYS)
    _recording(monkeypatch, jr, "demod_resolve_group", want, SHAPE_KEYS)
    pt = DemodPipeline(PipelineConfig(decoder=DecoderConfig(), batch_buffers=2,
                                      dispatch_groups=2, max_candidates=16),
                       clock=lambda: NOW, device="cpu")
    pj = JaxPipeline(JaxPipelineConfig(decoder=JaxDecoderConfig(), batch_buffers=2,
                                       dispatch_groups=2, max_candidates=16),
                     clock=lambda: NOW)
    pj._mo = pt.shapes.mo = 64
    assert _decode(pt, dense_then_quiet, packed) == _decode(pj, dense_then_quiet, packed)
    assert got == want
    mcs = [s[0] for s in got]
    assert len(got) > 5 and mcs[0] == 16 and max(mcs) > 16 and mcs[-1] < max(mcs)
    assert pt.max_candidates == pj._mc


def test_retry_and_round_shapes_pinned(dense_then_quiet, monkeypatch):
    """The shapes of the retry sites, stepped x4 an attempt: the pipeline's
    host path (a buffer demodulated again alone until it fits, the larger
    shape kept), decode_captures on both strategies, and
    decode_capture_sharded on both."""
    blocks = open(dense_then_quiet, "rb").read()[: 4 * BLOCK]
    host = []
    _recording(monkeypatch, pl, "demod_iq_block", host, ("max_candidates",))
    p = DemodPipeline(PipelineConfig(max_candidates=16), clock=lambda: NOW, device="cpu",
                      native=False)
    p.run(io.BytesIO(blocks), lambda mm: None)
    # buffer 2 was enqueued at 16 before buffer 1's retries grew the shape
    assert [s for s, in host] == [16, 16, 64, 256, 256, 64, 256, 256]
    assert p.max_candidates == 256

    rounds, rows = [], []
    _recording(monkeypatch, tapi, "demod_resolve_streams", rounds, ("max_candidates", "max_out"))
    _recording(monkeypatch, tapi, "demod_iq_block", rows, ("max_candidates",))
    monkeypatch.setattr(tapi, "PipelineConfig",
                        functools.partial(PipelineConfig, max_candidates=16))
    caps = [blocks, blocks[: 2 * BLOCK]]
    assert [_dicts(m) for m in tapi.decode_captures(caps, device="cpu", device_resolve=True)] \
        == [_dicts(m) for m in tapi.decode_captures(caps, device="cpu", device_resolve=False)]
    # a round steps x4 a rerun; each overflowing row of a round fetched at
    # 16 steps from 16 again, the kept shape growing no further
    assert rounds == [(16, 4096), (64, 4096), (256, 4096)]
    assert [s for s, in rows] == [64, 256] * 4

    segs, demods = [], []
    real = tapi.resolve_candidate_segments
    monkeypatch.setattr(tapi, "resolve_candidate_segments",
                        lambda *a, **k: segs.append((a[0].shape[1], k["max_out"])) or real(*a, **k))
    _recording(monkeypatch, tapi, "make_sharded_demod", demods, ("max_candidates",))
    monkeypatch.setattr(tapi, "SHARDED_MAX_OUT", 64)
    outs = [tapi.decode_capture_sharded(blocks, mesh=_cpu_mesh(2, 2), max_candidates=16,
                                        device_resolve=dr) for dr in (True, False)]
    assert _dicts(outs[0]) == _dicts(outs[1])
    # the device resolve grows the candidates, then the emission room; the
    # host resolve the candidates alone, both reruns from the group's start
    assert segs == [(16, 64), (64, 64), (256, 64), (256, 256), (256, 256)]
    assert [s for s, in demods] == [16, 64, 256] * 2
