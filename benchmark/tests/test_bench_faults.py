"""The check fails the faults a cell can have: each test skips the look
for a card and drives a whole run on the CPU with the timed path broken
underneath, and `correct` comes out false.  (The exchange between chips
has no fault to plant: every cell runs on one card.)  The control, the
reference with the phase-corrected retry left out put in the program's
place, fails the same numbers."""

import numpy as np
import pytest

from benchmark import spec
from benchmark.run import execute

CELLS = ("archive_raw.dense", "feeder_net.live_dense")


def _state_unchanged(monkeypatch):
    """K2 hands back the ICAO cache it was given: the walk's state never
    moves, so no address/parity frame is ever accepted."""
    from dump1090_tpu_torch.ops import resolve

    real = resolve.resolve_words

    def frozen(pf, w1, w2, h12, nbuf, cache_addr, cache_ts, *a, **k):
        words, _, _ = real(pf, w1, w2, h12, nbuf, cache_addr, cache_ts, *a, **k)
        return words, cache_addr.clone(), cache_ts.clone()

    monkeypatch.setattr(resolve, "resolve_words", frozen)


def _half_left_out(monkeypatch):
    """Half of each dispatch group's buffers never reach the device
    program (no signal in their place)."""
    from dump1090_tpu_torch.models import pipeline

    real = pipeline.demod_resolve_group

    def half(xg, *a, **k):
        xg = xg.clone()
        flat = xg.reshape(-1, xg.shape[-1])
        flat[flat.shape[0] // 2 :] = 127
        return real(xg, *a, **k)

    monkeypatch.setattr(pipeline, "demod_resolve_group", half)


def _answer_altered(monkeypatch):
    """One bit of each batch's first message flipped where the message is
    produced (the packed rows, or the unpacked rows' bytes)."""
    from dump1090_tpu_torch.models import pipeline

    real_packed = pipeline.interleave_packed
    real_unpacked = pipeline.messages_from_device_arrays

    def packed(*a):
        msg, bits = real_packed(*a)
        if msg.shape[0]:
            msg = msg.copy()
            msg[0, 5] ^= 0x10
        return msg, bits

    def unpacked(msg_rows, meta_rows):
        msg_rows = np.array(msg_rows, copy=True)
        if msg_rows.shape[0]:
            msg_rows[0, 5] ^= 0x10
        return real_unpacked(msg_rows, meta_rows)

    monkeypatch.setattr(pipeline, "interleave_packed", packed)
    monkeypatch.setattr(pipeline, "messages_from_device_arrays", unpacked)


@pytest.mark.parametrize("fault", [_state_unchanged, _half_left_out, _answer_altered],
                         ids=["state_unchanged", "half_left_out", "answer_altered"])
@pytest.mark.parametrize("workload", CELLS)
def test_fault_makes_the_run_incorrect(tiny_cell, monkeypatch, fault, workload):
    fault(monkeypatch)
    result, verdict, _ = execute(tiny_cell(workload), 0.0)
    assert result["correct"] is False
    assert result["failed"] > 0
    assert any(c["value"] > c["limit"] for c in result["checks"].values())


def test_a_cache_ttl_left_out_makes_the_feeder_run_incorrect(tiny_cell, monkeypatch):
    """The device resolves every group at the clock's zero: no entry of the
    cache the window starts from ever reads as past its TTL."""
    from dump1090_tpu_torch.models import pipeline

    real = pipeline.demod_resolve_group

    def no_ttl(xg, ca, ct, now, *a, **k):
        return real(xg, ca, ct, 0, *a, **k)

    monkeypatch.setattr(pipeline, "demod_resolve_group", no_ttl)
    result, verdict, _ = execute(tiny_cell("feeder_net.live_dense"), 0.0)
    assert result["correct"] is False
    assert result["checks"]["messages_differing"]["value"] > 0


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(tiny_cell, workload):
    result, verdict, _ = execute(tiny_cell(workload), 0.0)
    assert result["correct"] is True, verdict.notes
    assert result["failed"] == 0


@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_a_compared_number(tiny_cell, workload):
    cell = tiny_cell(workload)
    verdict = spec.runner(cell.config["runner"]).control(cell)
    assert verdict.correct is False
    assert any(c.value > c.limit for c in verdict.checks), verdict.checks
