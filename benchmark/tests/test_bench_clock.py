"""The ICAO cache's TTL, worked out again by the reference from the clock
values the program read: the mapping of clock reads to dispatch groups
(replays included), and the program's CPU runs against the reference
where entries expire."""

import io

import pytest

from benchmark import air
from benchmark.harness import group_nows
from benchmark.runners import paced, stream as stream_runner

G = 100   # samples a group, in these tags


def test_fresh_reads_map_one_to_one():
    tags = [((g + 1) * G, max(0, g - 2)) for g in range(5)]
    assert group_nows([10, 11, 12, 13, 14], tags, 5, 0) == [10, 11, 12, 13, 14]


def test_a_replay_while_streaming_maps_to_the_group_and_those_after_it():
    # depth 3: groups 0-3 enqueued, group 0 overflows (read 20), is
    # delivered, groups 1-3 are enqueued again (21-23), then group 4
    values = [1, 2, 3, 4, 20, 21, 22, 23, 5]
    tags = [(G, 0), (2 * G, 0), (3 * G, 0), (4 * G, 0), (4 * G, 0),
            (4 * G, 1), (4 * G, 1), (4 * G, 1), (5 * G, 1)]
    assert group_nows(values, tags, 5, 0) == [20, 21, 22, 23, 5]


def test_a_group_replayed_twice_keeps_its_last_read():
    values = [1, 2, 30, 31, 40]
    tags = [(G, 0), (2 * G, 0), (2 * G, 0), (2 * G, 0), (2 * G, 1)]
    assert group_nows(values, tags, 2, 0) == [31, 40]


def test_a_replay_in_the_drain_after_a_requeue():
    # groups 0-2 in flight at the end: group 0 replays (10) and 1-2 are
    # enqueued again (11, 12); group 1 then replays (13) and 2 again (14)
    values = [1, 2, 3, 10, 11, 12, 13, 14]
    tags = [(G, 0), (2 * G, 0), (3 * G, 0), (3 * G, 0), (3 * G, 1), (3 * G, 1),
            (3 * G, 1), (3 * G, 2)]
    assert group_nows(values, tags, 3, 0) == [10, 13, 14]


@pytest.mark.parametrize("values,tags,n", [
    ([1], [(G, 0)], 2),                                   # a group read no clock
    ([1, 2], [(G, 0), (2 * G, 0)], 1),                   # more dispatched than delivered
    ([1, 9], [(G, 0), (G, 1)], 1),                       # a replay of a group not dispatched
])
def test_reads_that_fit_no_dispatch_order_are_refused(values, tags, n):
    with pytest.raises(ValueError):
        group_nows(values, tags, n, 0)


class StepClock:
    """Reads `first` until `after` reads, then `then`; records each read
    with (samples taken in, batches delivered // ng)."""

    def __init__(self, first, then, after):
        self.first, self.then, self.after = first, then, after
        self.values, self.tags, self.tag = [], [], None

    def __call__(self):
        v = self.first if len(self.values) < self.after else self.then
        self.values.append(v)
        self.tags.append(self.tag())
        return v


def test_archive_groups_past_the_ttl_equal_the_reference(tiny_cell):
    from dump1090_tpu_torch.models.pipeline import DemodPipeline, PipelineConfig

    cell = tiny_cell("archive_raw.dense")
    blocks, _ = air.blocks(cell.seed, 4, cell.traffic)
    clock = StepClock(1_000, 1_000 + 61, 1)
    p = DemodPipeline(PipelineConfig(batch_buffers=2, dispatch_groups=2, dispatch_ahead=1),
                      device="cpu", clock=clock)
    got = []
    clock.tag = lambda: (p.samples_in, len(got) // 2)
    for lines in p.stream_raw_device(io.BytesIO(blocks.tobytes() * 3)):
        got.append(lines)
    nows = group_nows(clock.values, clock.tags, 3, 0)
    assert nows[0] == 1_000 and nows[-1] == 1_061
    want, _, _ = stream_runner.reference_groups(blocks, 2, 2, nows)
    assert got == want
    live, _, _ = stream_runner.reference_groups(blocks, 2, 2, [1_000] * 3)
    assert live != want   # the expiry changed what was accepted


def test_the_feeders_start_cache_expires_entries_the_reference_works_out(tiny_cell):
    cell = tiny_cell("feeder_net.live_dense")
    n = 8
    bufs = air.paced_buffers(cell.seed, n, cell.traffic)
    now = 5_000
    cache0 = paced.start_cache(cell, now)
    held = [t for a, t in zip(*cache0) if a]
    assert min(held) < now - 60 <= max(held)
    nows = [now] * n
    aged = paced.reference(bufs, nows, cache0, [], [], cell.config["hub"])
    fresh = paced.reference(bufs, nows, (cache0[0], [now if a else 0 for a in cache0[0]]), [], [],
                            cell.config["hub"])
    assert sum(m[3] for m in aged[0]) < sum(m[3] for m in fresh[0])   # fewer crcok
