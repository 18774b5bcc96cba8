"""The verbose archive cell (benchmark/runners/verbose.py) on a tiny cell on
the CPU: a sound run is correct; a flipped display byte, a dropped message,
a lost bad-CRC message and the control are not; the runner keeps the text of the first two groups
only; its metrics read a value on a hub with display counters and nothing
on one without; and the display's time leaves out the runner's own work
at a batch's end."""

import copy
import time
import zlib

import pytest

from benchmark import spec
from benchmark.run import execute

CELL = "archive_verbose.dense"
NB, NG = 2, 2


def tiny():
    c = copy.deepcopy(spec.cell(CELL, seed=2**31 + 13, seconds=1.0, trace=False))
    c.device = "cpu"
    c.config["settings"].update(batch_buffers=NB, dispatch_groups=NG)
    c.config["warmup_groups"] = 1
    c.traffic["distinct_blocks"] = NB * NG
    return c


def _flip_a_display_byte(monkeypatch):
    """Every 97th message's display text with one character changed."""
    from dump1090_tpu_torch.utils import display

    real, n = display.display_message, [0]

    def flipped(mm, **kw):
        text = real(mm, **kw)
        n[0] += 1
        return text if n[0] % 97 else text[:4] + chr(ord(text[4]) ^ 1) + text[5:]

    monkeypatch.setattr(display, "display_message", flipped)


def _drop_a_message(monkeypatch):
    """The hub never sees every 97th message."""
    from dump1090_tpu_torch.models import hub

    real, n = hub.MessageHub.use_message, [0]

    def dropping(self, mm):
        n[0] += 1
        if n[0] % 97:
            real(self, mm)

    monkeypatch.setattr(hub.MessageHub, "use_message", dropping)


def _without_counters(monkeypatch):
    """A hub as the port had it before its display counters."""
    from dump1090_tpu_torch.models import hub
    from dump1090_tpu_torch.utils import display

    class Uncounted(hub.MessageHub):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            del self.crc_dropped, self.displayed, self.written

        def use_message(self, mm):
            # HubConfig()'s branch of the hub before its counters
            if not mm.crcok:
                return
            self.out.write(display.display_message(mm))
            self.out.write("\n")

    monkeypatch.setattr(hub, "MessageHub", Uncounted)


def test_sound_run_is_correct():
    result, verdict, run = execute(tiny(), 0.0)
    assert result["correct"] is True, verdict.notes
    assert result["failed"] == 0
    checks = result["checks"]
    assert set(checks) == {"batches_differing", "counters_differing", "display_differing"}
    assert all(c["value"] == 0 for c in checks.values())
    assert result["metrics"]["decode_msps"]["value"] > 0
    crc_dropped, displayed, written = run.hub
    assert displayed > 0 and crc_dropped > 0
    assert written == sum(n for _, n in run.digests)


@pytest.mark.parametrize("fault", [_flip_a_display_byte, _drop_a_message],
                         ids=["display_byte_flipped", "message_dropped"])
def test_fault_makes_the_run_incorrect(monkeypatch, fault):
    fault(monkeypatch)
    result, verdict, _ = execute(tiny(), 0.0)
    assert result["correct"] is False
    assert result["failed"] > 0
    assert result["checks"]["batches_differing"]["value"] > 0
    if fault is _drop_a_message:
        assert result["checks"]["display_differing"]["value"] > 0


def test_a_lost_bad_crc_message_is_caught_by_the_hub_counters(monkeypatch):
    # the digests hold only displayed text and the 8 counters are the
    # decoder's, so only the hub's crc_dropped sees a bad-CRC message that
    # never reached useModesMessage
    from dump1090_tpu_torch.models import hub

    real = hub.MessageHub.use_message

    def losing(self, mm):
        if mm.crcok:
            real(self, mm)

    monkeypatch.setattr(hub.MessageHub, "use_message", losing)
    result, _, _ = execute(tiny(), 0.0)
    assert result["correct"] is False
    checks = result["checks"]
    assert checks["batches_differing"]["value"] == 0
    assert checks["counters_differing"]["value"] == 0
    assert checks["display_differing"]["value"] > 0


def test_control_is_not_correct():
    cell = tiny()
    verdict = spec.runner(cell.config["runner"]).control(cell, groups=6)
    assert verdict.correct is False
    assert any(c.value > c.limit for c in verdict.checks), verdict.checks


def test_only_the_first_two_groups_are_kept_whole():
    _, _, run = execute(tiny(), 0.0)
    assert len(run.digests) > 2 * NG
    assert len(run.head) == 2 * NG
    assert [len(t) for t in run.head] == [n for _, n in run.digests[: 2 * NG]]
    assert len(run.batch_ends) == len(run.digests)


def test_metrics_read_with_counters_and_not_without(monkeypatch):
    # untraced, so that no profiler slice cuts the groups the readers read
    def read(run, name):
        return spec.metric_reader(name)(run)

    result, verdict, run = execute(tiny(), 0.0)
    assert result["correct"] is True, verdict.notes
    assert read(run, "display.ns_per_message") > 0
    assert read(run, "host_decode.us_per_buffer.verbose") > 0
    _without_counters(monkeypatch)
    result, verdict, run = execute(tiny(), 0.0)
    assert result["correct"] is True, verdict.notes
    assert run.hub is None
    assert "display_differing" not in result["checks"]
    assert read(run, "display.ns_per_message") is None
    assert read(run, "host_decode.us_per_buffer.verbose") > 0


def test_display_time_leaves_out_the_runners_work_at_a_batch_end(monkeypatch):
    # the sink's CRC-32 of each batch's text, slowed: the runner's own work
    slow_s = 0.05
    real = zlib.crc32

    def slow_crc32(data, *a):
        time.sleep(slow_s)
        return real(data, *a)

    monkeypatch.setattr(zlib, "crc32", slow_crc32)
    result, verdict, run = execute(tiny(), 0.0)
    assert result["correct"] is True, verdict.notes
    per_batch = max(b - a for (_, a), (_, b) in zip(run.batch_ends, run.batch_ends[1:]))
    # each batch's sleep alone would add at least slow_s / per_batch a message
    assert spec.metric_reader("display.ns_per_message")(run) < 0.5 * slow_s * 1e9 / per_batch
