"""Message hub: fan-out of decoded frames to tracking, display, and network
sinks (a copy of dump1090_tpu/models/hub.py).

Behavioral contract: useModesMessage (dump1090.c:1795-1820).  The reference
routes each decoded frame through: aircraft tracking (when interactive, or an
HTTP request or SBS client has ever been seen), SBS CSV output, stdout
display, and raw TCP broadcast.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass, field
from typing import Callable

from ..utils import display as disp
from .decoder import DecoderStats, ModesMessage
from .tracker import AircraftTracker


@dataclass
class HubConfig:
    raw: bool = False
    onlyaddr: bool = False
    check_crc: bool = True
    interactive: bool = False
    net: bool = False
    stats_only: bool = False     # --stats suppresses per-message output
    metric: bool = False


class MessageHub:
    """Routes each message like useModesMessage (dump1090.c:1802-1820)."""

    def __init__(
        self,
        cfg: HubConfig,
        tracker: AircraftTracker,
        stats: DecoderStats,
        *,
        out=None,
        raw_sink: Callable[[str], None] | None = None,
        sbs_sink: Callable[[str], None] | None = None,
    ):
        self.cfg = cfg
        self.tracker = tracker
        self.stats = stats
        self.out = out or sys.stdout
        self.raw_sink = raw_sink      # broadcast to raw TCP clients
        self.sbs_sink = sbs_sink      # broadcast to SBS TCP clients
        # display counters, for the benchmark's per-layer readings: plain
        # increments, no clock read or allocation per message
        self.crc_dropped = 0          # messages dropped for a bad CRC
        self.displayed = 0            # messages written to `out`
        self.written = 0              # characters written to `out`

    def use_message(self, mm: ModesMessage) -> None:
        cfg = self.cfg
        if cfg.check_crc and not mm.crcok:
            self.crc_dropped += 1
            return
        if cfg.stats_only:
            return
        if cfg.interactive or self.stats.http_requests > 0 or self.stats.sbs_connections > 0:
            a = self.tracker.receive(mm, check_crc=cfg.check_crc)
            if a is not None and self.stats.sbs_connections > 0 and self.sbs_sink:
                line = disp.sbs_line(mm, a)
                if line is not None:
                    self.sbs_sink(line + "\n")
        if not cfg.interactive:
            text = disp.display_message(
                mm, raw=cfg.raw, onlyaddr=cfg.onlyaddr, check_crc=cfg.check_crc
            )
            self.out.write(text)
            self.displayed += 1
            self.written += len(text)
            if not cfg.raw and not cfg.onlyaddr:
                self.out.write("\n")
                self.written += 1
            if cfg.raw:
                self.out.flush()  # provide data to the reader ASAP
        if cfg.net and self.raw_sink:
            self.raw_sink(disp.raw_hex(mm, upper=True) + "\n")
