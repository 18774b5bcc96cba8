"""The system under test: the port's product entry points, built as its
CLI builds them.  The only module of the benchmark that imports the port
(dump1090_tpu_torch), and only its DemodPipeline, MessageHub and
AircraftTracker.
"""

from __future__ import annotations

import threading
import time


class RecordingClock:
    """A wall clock in whole units (seconds, or milliseconds with
    scale=1000), as the program's own clocks read it, that records every
    value it returns so the reference can replay them.  With `tag` set,
    each read also records tag()'s value in `tags` (what the runner knew
    of the program's progress when the read came)."""

    def __init__(self, scale: int = 1):
        self.scale = scale
        self.values: list[int] = []
        self.tags: list = []
        self.tag = None

    def __call__(self) -> int:
        v = int(time.time() * self.scale)
        self.values.append(v)
        if self.tag is not None:
            self.tags.append(self.tag())
        return v

    def clear(self) -> None:
        self.values.clear()
        self.tags.clear()


def pipeline(settings: dict, device: str, clock: RecordingClock):
    """DemodPipeline with the configuration's settings (cli.py's file or
    live defaults), the resolver on the device, and the state lock the CLI
    passes."""
    from dump1090_tpu_torch.models.decoder import DecoderConfig
    from dump1090_tpu_torch.models.pipeline import DemodPipeline, PipelineConfig

    cfg = PipelineConfig(
        decoder=DecoderConfig(fix_errors=settings["fix_errors"], aggressive=settings["aggressive"]),
        max_candidates=settings["max_candidates"],
        batch_buffers=settings["batch_buffers"],
        dispatch_groups=settings["dispatch_groups"],
        preload=settings["preload"],
        dispatch_ahead=settings["dispatch_ahead"],
        front=settings["front"],
    )
    return DemodPipeline(cfg, clock=clock, device=device, lock=threading.RLock())


def reset_decode_state(p) -> None:
    """Empty the pipeline's ICAO cache, as a fresh process starts it; the
    shapes it has grown or shrunk stay."""
    p.cache.addr[:] = 0
    p.cache.ts[:] = 0


def set_cache(p, addr, ts) -> None:
    """Load the pipeline's ICAO cache with the given slots (address and
    the second it was last seen)."""
    p.cache.addr[:] = addr
    p.cache.ts[:] = ts


def stats(p) -> tuple[int, ...]:
    """The pipeline's 8 reference counters, in the reference's order."""
    from dump1090_tpu_torch.models.decoder import STAT_FIELDS

    return tuple(getattr(p.stats, f) for f in STAT_FIELDS)


def hub(p, hub_settings: dict, *, out, raw_sink, sbs_sink, clock, msclock):
    """The message hub of `dump1090 --net` with one SBS client attached
    (cli.main's HubConfig; stats.sbs_connections as on_sbs_connect leaves
    it), its network sinks being the given collectors."""
    from dump1090_tpu_torch.models.hub import HubConfig, MessageHub
    from dump1090_tpu_torch.models.tracker import AircraftTracker

    tracker = AircraftTracker(clock=clock, msclock=msclock)
    h = MessageHub(HubConfig(net=hub_settings["net"], raw=hub_settings["raw"]), tracker, p.stats,
                   out=out, raw_sink=raw_sink, sbs_sink=sbs_sink)
    p.stats.sbs_connections = hub_settings["sbs_connections"]
    return h, tracker


def release_device() -> None:
    """Return the device memory the program no longer references."""
    import gc

    import torch

    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
