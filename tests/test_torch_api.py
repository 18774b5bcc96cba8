"""The port's message-level decode against the JAX package on the CPU:
DemodPipeline.run_device, api.decode_capture and api.decode_captures (the
device-resolve strategy), field for field, with the clock frozen in both.
Also: each batched capture equals its solo decode, forced tiling and forced
candidate growth change nothing, and the host-resolve strategy
(device_resolve=False) equals the JAX package's and the device strategy."""

import dataclasses
import functools
import io
import time

import numpy as np
import pytest

import dump1090_tpu.api as japi
import dump1090_tpu_torch.api as tapi
import dump1090_tpu_torch.ops.resolve as tr
from dump1090_tpu.models.decoder import DecoderConfig as JaxDecoderConfig
from dump1090_tpu.models.pipeline import DemodPipeline as JaxPipeline
from dump1090_tpu.models.pipeline import PipelineConfig as JaxPipelineConfig
from dump1090_tpu_torch.models.decoder import DecoderConfig
from dump1090_tpu_torch.models.pipeline import DemodPipeline, PipelineConfig
from dump1090_tpu_torch.utils.synth import planted_capture
# jax_native: the JAX package's pipelines resolve on the host with its
# native runtime, a private copy
from test_torch_native import jax_native  # noqa: F401  (a fixture)

NOW = 1_700_000_000
BLOCK = 262144


@pytest.fixture
def frozen(monkeypatch):
    monkeypatch.setattr(time, "time", lambda: float(NOW))


@pytest.fixture(scope="module")
def captures():
    data, _ = planted_capture(6, 60, seed=3, noise_sigma=3.0,
                              flip_weights=(0.6, 0.25, 0.15))
    return [data, data[: 2 * BLOCK + 1000], data[3 * BLOCK:]]


def _dicts(msgs):
    return [dataclasses.asdict(m) for m in msgs]


@pytest.fixture(scope="module")
def jax_batched(captures, jax_native):
    mp = pytest.MonkeyPatch()
    mp.setattr(time, "time", lambda: float(NOW))
    try:
        return [_dicts(s) for s in japi.decode_captures(captures, device_resolve=True)]
    finally:
        mp.undo()


@pytest.mark.parametrize("mode", ["fix", "aggressive"])
def test_run_device_matches_jax(captures, mode, jax_native):
    """Groups of 2 x 2 buffers, candidate and emission shapes forced small
    so both grow by replay, in both packages."""
    fix, aggressive = True, mode == "aggressive"
    want, got = [], []
    pj = JaxPipeline(JaxPipelineConfig(
        decoder=JaxDecoderConfig(fix_errors=fix, aggressive=aggressive),
        batch_buffers=2, dispatch_groups=2, max_candidates=16), clock=lambda: NOW)
    pt = DemodPipeline(PipelineConfig(
        decoder=DecoderConfig(fix_errors=fix, aggressive=aggressive),
        batch_buffers=2, dispatch_groups=2, max_candidates=16),
        clock=lambda: NOW, device="cpu")
    pj._mo = pt.shapes.mo = 64
    pj.run_device(io.BytesIO(captures[0]), want.append)
    pt.run_device(io.BytesIO(captures[0]), got.append)
    assert _dicts(got) == _dicts(want)
    assert dataclasses.astuple(pt.stats) == dataclasses.astuple(pj.stats)
    np.testing.assert_array_equal(pt.cache.addr, pj.cache.addr)
    np.testing.assert_array_equal(pt.cache.ts, pj.cache.ts)
    assert pt.shapes.mc > 16 and pt.shapes.mo > 64, "sticky growth should have fired"
    assert any(not m.crcok for m in got) and sum(m.crcok for m in got) >= 300
    if aggressive:
        assert pt.stats.two_bits_fix > 0


def test_decode_capture_matches_jax(captures, frozen, jax_native):
    cfg = DecoderConfig(fix_errors=True)
    got = tapi.decode_capture(captures[1], config=cfg, device="cpu", device_resolve=True)
    want = japi.decode_capture(captures[1], config=JaxDecoderConfig(),
                               device_resolve=True)
    assert _dicts(got) == _dicts(want) and len(got) > 100
    ok = tapi.decode_capture(np.frombuffer(captures[1], np.uint8), crcok_only=True,
                             device="cpu", batch_buffers=1, device_resolve=True)
    assert _dicts(ok) == [d for d in _dicts(want) if d["crcok"]]


def test_decode_captures_matches_jax_and_solo(captures, jax_batched, frozen):
    got = tapi.decode_captures(captures, device="cpu", device_resolve=True)
    assert [len(s) for s in got] == [len(s) for s in jax_batched]
    assert [_dicts(s) for s in got] == jax_batched
    solo = [tapi.decode_capture(c, batch_buffers=1, device="cpu", device_resolve=True)
            for c in captures]
    assert [_dicts(s) for s in got] == [_dicts(s) for s in solo]
    crc = tapi.decode_captures(captures, crcok_only=True, device="cpu", device_resolve=True)
    assert [_dicts(s) for s in crc] == [[d for d in s if d["crcok"]] for s in jax_batched]


def test_decode_captures_tiled_equal(captures, jax_batched, frozen, monkeypatch):
    """A slot bound below one stream's buffers cuts each round into
    (1 stream, 3 buffers) tiles."""
    calls = []
    real = tr.demod_resolve_streams

    def counting(xs, *a, **k):
        calls.append(tuple(xs.shape[:2]))
        return real(xs, *a, **k)

    monkeypatch.setattr(tapi, "demod_resolve_streams", counting)
    monkeypatch.setattr(tr, "MAX_GROUP_SLOTS", 3 * 256)
    got = tapi.decode_captures(captures, device="cpu", device_resolve=True)
    assert [_dicts(s) for s in got] == jax_batched
    assert max(s * b for s, b in calls) * 256 <= 3 * 256 and len(calls) > 3


def test_decode_captures_candidate_growth(captures, frozen, monkeypatch, jax_native):
    """max_candidates 16 overflows and grows x4 in both packages."""
    monkeypatch.setattr(japi, "PipelineConfig",
                        functools.partial(JaxPipelineConfig, max_candidates=16))
    monkeypatch.setattr(tapi, "PipelineConfig",
                        functools.partial(PipelineConfig, max_candidates=16))
    calls = []
    real = tr.demod_resolve_streams

    def counting(xs, *a, **k):
        calls.append(k["max_candidates"])
        return real(xs, *a, **k)

    monkeypatch.setattr(tapi, "demod_resolve_streams", counting)
    caps = captures[1:]
    want = japi.decode_captures(caps, device_resolve=True)
    got = tapi.decode_captures(caps, device="cpu", device_resolve=True)
    assert [_dicts(s) for s in got] == [_dicts(s) for s in want]
    assert calls[0] == 16 and max(calls) > 16


def test_decode_captures_host_resolve_not_ported(captures, frozen):
    """The host-resolve strategy, once refused, is ported: it decodes, and
    an empty list of captures gives an empty list."""
    got = tapi.decode_captures(captures[1:2], device_resolve=False, device="cpu")
    assert [_dicts(s) for s in got] == [_dicts(tapi.decode_capture(captures[1], device="cpu",
                                                                   device_resolve=True))]
    assert tapi.decode_captures([], device_resolve=False, device="cpu") == []
    assert tapi.decode_captures([b"\x7f" * 1000], device_resolve=False, device="cpu") == [[]]
    assert tapi.decode_captures([], device="cpu", device_resolve=True) == []


@pytest.mark.parametrize("mc", [256, 16])
def test_decode_captures_host_matches_jax_and_device(captures, jax_batched, frozen, monkeypatch,
                                                    mc):
    """decode_captures(device_resolve=False) against the JAX package's host
    strategy and against the port's device strategy, per capture and field
    for field; from max_candidates 16 every round overflows at first and
    rows are demodulated again alone, in both packages."""
    monkeypatch.setattr(japi, "PipelineConfig", functools.partial(JaxPipelineConfig,
                                                                  max_candidates=mc))
    monkeypatch.setattr(tapi, "PipelineConfig", functools.partial(PipelineConfig,
                                                                  max_candidates=mc))
    got = tapi.decode_captures(captures, device_resolve=False, device="cpu")
    want = japi.decode_captures(captures, device_resolve=False)
    assert [_dicts(s) for s in got] == [_dicts(s) for s in want]
    assert [_dicts(s) for s in got] == jax_batched
    crc = tapi.decode_captures(captures, crcok_only=True, device_resolve=False, device="cpu")
    assert [_dicts(s) for s in crc] == [[d for d in s if d["crcok"]] for s in jax_batched]


def test_decode_capture_host_resolve_matches_jax(captures, frozen, jax_native):
    for cap in captures[:2]:
        got = tapi.decode_capture(cap, device_resolve=False, device="cpu")
        want = japi.decode_capture(cap, device_resolve=False)
        assert _dicts(got) == _dicts(want) and len(got) > 100
        assert _dicts(got) == _dicts(tapi.decode_capture(cap, device="cpu", device_resolve=True))


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_auto_resolve_policy_device_on_cuda_host_on_cpu(captures, frozen, monkeypatch, tmp_path,
                                                       device):
    """device_resolve=None and --tpu-device-resolve auto take the device
    resolver for cuda and the host resolver for cpu, in decode_capture,
    decode_captures and the CLI (its pure --raw and verbose routes, with
    their batch sizes).  The pipeline itself is built on the CPU here, so
    without a card the cuda case is checked through the routing only."""
    import signal

    import torch

    import dump1090_tpu_torch.cli as tcli
    from dump1090_tpu_torch.models import pipeline as pl

    assert tr.use_device_resolve(device) is (device == "cuda")
    assert tr.use_device_resolve(None) is True
    assert tr.use_device_resolve(torch.device(device)) is (device == "cuda")
    monkeypatch.setattr(pl, "resolve_device", lambda d: torch.device("cpu"))
    routes = []
    for name in ("run_device", "run", "stream_raw_device", "stream_records"):
        real = getattr(DemodPipeline, name)

        def recorder(self, *a, _name=name, _real=real, **k):
            routes.append((_name, self.cfg.batch_buffers, self.cfg.dispatch_groups))
            return _real(self, *a, **k)

        monkeypatch.setattr(DemodPipeline, name, recorder)
    for name in ("_decode_captures_device", "_decode_captures_host"):
        monkeypatch.setattr(tapi, name, lambda caps, _name=name, **k: routes.append(_name) or [])

    dev = device == "cuda"
    tapi.decode_capture(captures[1], device=device)
    tapi.decode_captures(captures[1:2], device=device)
    path = tmp_path / "cap.bin"
    path.write_bytes(captures[1])
    saved = signal.getsignal(signal.SIGPIPE)  # the CLI restores C semantics on it
    try:
        assert tcli.main(["--device", device, "--ifile", str(path), "--raw"]) == 0
        assert tcli.main(["--device", device, "--ifile", str(path), "--onlyaddr"]) == 0
    finally:
        signal.signal(signal.SIGPIPE, saved)
    assert routes == (
        [("run_device", 16, 1), "_decode_captures_device", ("stream_raw_device", 64, 8),
         ("run_device", 64, 8)] if dev else
        [("run", 16, 1), "_decode_captures_host", ("stream_records", 16, 1), ("run", 16, 1)])
    # an explicit choice wins over the policy on either device
    routes.clear()
    tapi.decode_capture(captures[1], device=device, device_resolve=not dev)
    assert routes == [("run", 16, 1)] if dev else [("run_device", 16, 1)]
