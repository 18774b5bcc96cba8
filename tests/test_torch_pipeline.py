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
def jax_results(capture):
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
    assert p._mc > 16, "sticky growth should have fired"
    assert len(raw.split()) >= 100
    if mode == "fix":
        assert p.stats.fixed > 0
    if mode == "aggressive":
        assert p.stats.two_bits_fix > 0


def test_preload_and_streaming_ingest_identical(capture, jax_results, tmp_path):
    """A regular file takes the preload strategy, a BytesIO the streaming
    reader thread; both give the JAX package's bytes."""
    f = tmp_path / "cap.bin"
    f.write_bytes(capture)
    raw_j = jax_results["fix"][0]
    for preload in ("auto", "off"):
        p = DemodPipeline(PipelineConfig(batch_buffers=2, dispatch_groups=2, preload=preload),
                          clock=lambda: NOW, device="cpu")
        with open(f, "rb") as fh:
            assert b"".join(p.stream_raw_device(fh)) == raw_j


def test_state_carried_from_jax_into_port(capture):
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
