"""k4_passes.roofline_pct on hand-made traces: the bytes it counts for a
known group shape, and nothing on a trace without K4 (the parent's
program)."""

import importlib.util

import pytest

from benchmark import roofline, spec
from benchmark.harness import Run
from benchmark.trace import END, START, reduce_events

K4 = "void (anonymous namespace)::candidate_passes_kernel<unsigned short>(unsigned short const*)"


def ev(name, cat, ts, dur):
    return {"name": name, "cat": cat, "ts": ts, "dur": dur}


def metric_module():
    path = spec.ROOT / "benchmark" / "metrics" / "k4_passes.roofline_pct.py"
    s = importlib.util.spec_from_file_location("k4_passes_roofline_pct", path)
    mod = importlib.util.module_from_spec(s)
    s.loader.exec_module(mod)
    return mod


def traced_run(kernels):
    events = [ev(START, "user_annotation", 1000.0, 1.0), ev(END, "user_annotation", 11000.0, 0.0)]
    events += [ev(name, "kernel", ts, dur) for name, ts, dur in kernels]
    run = Run(cell=None)
    run.trace = reduce_events(events, (0, 1024))
    run.device_kind = "NVIDIA H100 80GB HBM3"
    run.extra.update(nb=64, ng=8, mc=(256, 256))
    return run


def test_bytes_of_a_call():
    # 512 rows x 256 slots: 232 uint16 samples and an int32 position in,
    # 2 x (14 message bytes + an int32 count + a one-byte gate) out, a slot
    mod = metric_module()
    assert mod.BYTES_PER_CANDIDATE == 506
    assert mod.call_bytes(512, 256) == 512 * 256 * 506 == 66_322_432
    assert mod.call_bytes(1, 256) == 129_536


def test_share_of_two_calls():
    run = traced_run([(K4, 2000.0, 40.0), (K4, 6000.0, 60.0),
                      ("gather_windows_kernel<int>", 3000.0, 50.0)])
    got = spec.metric_reader("k4_passes.roofline_pct")(run)
    want = roofline.share_pct(2 * 512 * 256 * 506, 100e-6, run.device_kind)
    assert got == pytest.approx(want)
    assert 0 < got <= 100


def test_nothing_without_k4():
    read = spec.metric_reader("k4_passes.roofline_pct")
    assert read(traced_run([("gather_windows_kernel<int>", 2000.0, 50.0),
                            ("at::native::elementwise_kernel<128, 4>", 3000.0, 9.0)])) is None
    assert read(Run(cell=None)) is None
