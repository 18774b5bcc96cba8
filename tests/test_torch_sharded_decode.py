"""The port's api.decode_capture_sharded against the JAX package's and
against the port's unsharded decode, on the CPU: the JAX side on conftest's
8 virtual CPU devices, the port on a Mesh of the CPU, both from the same
pre-filled ICAO cache.  Input: dense planted air (utils/synth.py, seed 1).
Tolerance: exact equality (message fields, counters, cache)."""

import dataclasses
import io
import threading

import numpy as np
import pytest

import dump1090_tpu.api as japi
import dump1090_tpu_torch.api as tapi
from dump1090_tpu.models.decoder import DecoderConfig as JaxDecoderConfig
from dump1090_tpu.models.decoder import DecoderStats as JaxDecoderStats
from dump1090_tpu_torch.constants import BLOCK_SAMPLES
from dump1090_tpu_torch.models.decoder import DecoderConfig, DecoderStats
from dump1090_tpu_torch.models.pipeline import DemodPipeline, PipelineConfig
from dump1090_tpu_torch.utils.synth import planted_capture
from test_torch_sharding import MODES, NOW, _cpu_mesh, _jax_mesh, _prefilled_caches


@pytest.fixture(scope="module")
def air():
    """Three blocks of dense planted air (150 frames a block, seed 1, the
    air of chip_smoke.py)."""
    return planted_capture(3, 150, seed=1)


def _dicts(msgs) -> list:
    return [dataclasses.asdict(m) for m in msgs]


@pytest.mark.parametrize("mc", [16, 2500])
@pytest.mark.parametrize("device_resolve", [True, False])
@pytest.mark.parametrize("mode", list(MODES))
def test_decode_capture_sharded_equal_jax_and_unsharded(air, mc, device_resolve, mode):
    """A (2, 4) mesh over three dense buffers: every message field, the 8
    counters and the final cache equal JAX's decode_capture_sharded (from
    the same pre-filled cache), and the port's unsharded decode
    (DemodPipeline.run_device or run, the engines of decode_capture)."""
    data, _ = air
    jc, tc = _prefilled_caches()
    js, ts = JaxDecoderStats(), DecoderStats()
    want = japi.decode_capture_sharded(
        data, mesh=_jax_mesh(2, 4), config=JaxDecoderConfig(**MODES[mode]), stats=js,
        cache=jc, max_candidates=mc, device_resolve=device_resolve)
    got = tapi.decode_capture_sharded(
        data, mesh=_cpu_mesh(2, 4), config=DecoderConfig(**MODES[mode]), stats=ts, cache=tc,
        max_candidates=mc, device_resolve=device_resolve)
    assert len(got) > 400 and any(not m.crcok for m in got)
    assert _dicts(got) == _dicts(want)
    assert dataclasses.astuple(ts) == dataclasses.astuple(js)
    np.testing.assert_array_equal(tc.addr, jc.addr)
    np.testing.assert_array_equal(tc.ts, jc.ts)

    _, pc = _prefilled_caches()
    p = DemodPipeline(PipelineConfig(decoder=DecoderConfig(**MODES[mode])), clock=lambda: NOW,
                      device="cpu")
    p.cache.addr[:], p.cache.ts[:] = pc.addr, pc.ts
    solo = []
    (p.run_device if device_resolve else p.run)(io.BytesIO(data), solo.append)
    assert _dicts(got) == _dicts(solo)
    assert dataclasses.astuple(ts) == dataclasses.astuple(p.stats)
    np.testing.assert_array_equal(tc.addr, p.cache.addr)
    np.testing.assert_array_equal(tc.ts, p.cache.ts)


def test_decode_capture_sharded_grows_both_shapes(air, monkeypatch):
    """Both overflows of the device resolve: max_candidates 16 and an
    emitted-message room of 64 grow (sticky x4) and rerun each group from
    its starting cache, with output equal to the host strategy's."""
    data, _ = air
    calls = []
    real = tapi.resolve_candidate_segments

    def counting(*a, **k):
        calls.append((a[0].shape[1], k["max_out"]))
        return real(*a, **k)

    monkeypatch.setattr(tapi, "resolve_candidate_segments", counting)
    monkeypatch.setattr(tapi, "SHARDED_MAX_OUT", 64)
    caches = [_prefilled_caches()[1] for _ in range(2)]
    outs = [tapi.decode_capture_sharded(data, mesh=_cpu_mesh(2, 2), cache=c,
                                        max_candidates=16, device_resolve=dr)
            for c, dr in zip(caches, (True, False))]
    assert _dicts(outs[0]) == _dicts(outs[1]) and len(outs[0]) > 400
    np.testing.assert_array_equal(caches[0].addr, caches[1].addr)
    np.testing.assert_array_equal(caches[0].ts, caches[1].ts)
    assert calls[0] == (16, 64) and max(c[0] for c in calls) > 16 \
        and max(c[1] for c in calls) > 64


@pytest.mark.parametrize("device_resolve", [True, False])
def test_decode_capture_sharded_emit_progress_lock(air, device_resolve):
    """emit sees every message in stream order, progress counts each
    group's new samples, every resolve step runs under the lock, and a
    decode cut by its emit callback leaves the cache of the groups before
    the cut, like JAX's."""
    data, _ = air

    class CountingLock:
        def __init__(self):
            self.lock, self.holds = threading.RLock(), 0

        def __enter__(self):
            self.lock.acquire()
            self.holds += 1

        def __exit__(self, *exc):
            self.lock.release()

    seen, progress, lock = [], {}, CountingLock()
    got = tapi.decode_capture_sharded(data, mesh=_cpu_mesh(1, 2), emit=seen.append,
                                      progress=progress, lock=lock,
                                      device_resolve=device_resolve, crcok_only=True)
    assert [m.msg for m in got] == [m.msg for m in seen if m.crcok] and len(seen) > len(got)
    assert progress["samples"] == 3 * BLOCK_SAMPLES
    assert lock.holds == 3  # one resolve step a buffer (a dp-group of one)

    class Cut(Exception):
        pass

    def cut_after(limit):
        box = []

        def emit(mm):
            box.append(mm)
            if len(box) == limit:
                raise Cut

        return emit

    jc, tc = _prefilled_caches()
    for mod, mesh, cache, dr in ((japi, _jax_mesh(1, 2), jc, device_resolve),
                                 (tapi, _cpu_mesh(1, 2), tc, device_resolve)):
        with pytest.raises(Cut):
            mod.decode_capture_sharded(data, mesh=mesh, cache=cache, emit=cut_after(300),
                                       device_resolve=dr)
    np.testing.assert_array_equal(tc.addr, jc.addr)
    np.testing.assert_array_equal(tc.ts, jc.ts)
