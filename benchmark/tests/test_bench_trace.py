"""The trace reduction and the per-layer readings on a hand-made trace."""

import numpy as np
import pytest

from benchmark import layers, roofline, spec
from benchmark.harness import Run
from benchmark.trace import END, START, reduce_events


def ev(name, cat, ts, dur):
    return {"name": name, "cat": cat, "ts": ts, "dur": dur}


EVENTS = [
    ev(START, "user_annotation", 1000.0, 1.0),
    ev(END, "user_annotation", 11000.0, 0.0),
    # kernels: K1 twice, K2 once, a torch op, one overlapping another, and
    # one that starts before the slice (clipped)
    ev("gather_windows_kernel<int>", "kernel", 2000.0, 100.0),
    ev("gather_windows_kernel<int>", "kernel", 6000.0, 100.0),
    ev("(anonymous namespace)::resolve_words_kernel(int const*)", "kernel", 3000.0, 1000.0),
    ev("at::native::elementwise_kernel<128, 4>", "kernel", 3500.0, 1000.0),
    ev("at::native::early", "kernel", 500.0, 1000.0),
    ev("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 8000.0, 2000.0),
    # host activity over the idle stretches
    ev("bench.hub", "user_annotation", 4600.0, 1300.0),
    ev("aten::to", "cpu_op", 6200.0, 1700.0),
]


def test_busy_window_and_kernels():
    t = reduce_events(EVENTS, (10, 30))
    assert t.window_s == pytest.approx(0.01)
    # busy: [1000,1500) + [2000,2100) + [3000,4500) + [6000,6100) + [8000,10000)
    assert t.busy_s == pytest.approx((500 + 100 + 1500 + 100 + 2000) / 1e6)
    assert t.done == 20
    assert t.kernel_time(layers.is_k1) == (2, pytest.approx(200e-6))
    assert t.kernel_time(layers.is_k2) == (1, pytest.approx(1000e-6))
    assert t.kernel_time(lambda n: True)[0] == 5
    assert t.device_ops[0][0] == "Memcpy HtoD (Pageable -> Device)"


def test_idle_gaps_are_labelled_by_host_activity():
    t = reduce_events(EVENTS, (0, 1))
    gaps = dict(t.idle_gaps)
    # [4500,6000) under bench.hub; [6100,8000) under aten::to
    assert gaps["bench.hub"] == pytest.approx(1500e-6)
    assert gaps["aten::to"] == pytest.approx(1900e-6)
    assert sum(gaps.values()) == pytest.approx(t.window_s - t.busy_s)


def test_per_layer_readings():
    run = Run(cell=None, extra=dict(trace=None))
    run.trace = reduce_events(EVENTS, (0, 4))
    run.device_kind = "NVIDIA H100 80GB HBM3"
    run.extra.update(nb=2, ng=2, mc=(4, 4), k1_positions=[np.array([10, 20])] * 4)
    assert layers.idle_pct(run) == pytest.approx(100 * (1 - 4200 / 10000))
    assert layers.launches_per_buffer(run) == pytest.approx(5 / 4)
    k1 = spec.metric_reader("k1_gather.roofline_pct")(run)
    pos = np.array([[10, 20, 131070, 131070]] * 4)
    want = roofline.share_pct(2 * roofline.k1_bytes(pos, 131310), 200e-6, run.device_kind)
    assert k1 == pytest.approx(want)
    ns = spec.metric_reader("k2_resolve.ns_per_slot")(run)
    assert ns == pytest.approx(1000e-6 / (4 * 4) * 1e9)
    us = spec.metric_reader("torch_ops.us_per_buffer")(run)
    assert us == pytest.approx((500 + 1000) / 4)


def test_a_metric_with_nothing_to_read_reads_nothing():
    run = Run(cell=None)
    for name in ("device_idle_pct.archive", "launches_per_buffer.feeder", "k1_gather.roofline_pct",
                 "k2_resolve.roofline_pct", "torch_ops.us_per_buffer", "hub_ms_per_buffer",
                 "ingest_lag_p95_ms", "decode_msps", "latency_p95_ms"):
        assert spec.metric_reader(name)(run) is None
