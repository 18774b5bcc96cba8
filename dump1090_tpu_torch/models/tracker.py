"""Aircraft state tracking (interactive mode / HTTP / SBS data source; a
copy of dump1090_tpu/models/tracker.py).

Behavioral contract: dump1090.c:1822-2224 (aircraft struct :112-130,
interactiveReceiveData :2069, stale eviction :2203, auto reference position
:197-207 + :2126-2142).

The reference keeps a singly-linked list with new aircraft prepended; the
disabled head-reordering (if (0 && ...), dump1090.c:2090) means display order
is pure reverse-insertion order, which a Python list reproduces.
"""

from __future__ import annotations

import time as _time
from dataclasses import dataclass, field

from ..constants import INTERACTIVE_TTL
from . import cpr
from .decoder import ModesMessage


def _mstime() -> int:
    return int(_time.time() * 1000)


@dataclass
class Aircraft:
    """Tracked aircraft state (struct aircraft, dump1090.c:112-130)."""

    addr: int
    hexaddr: str = ""
    flight: str = ""
    altitude: int = 0
    speed: int = 0
    track: int = 0
    seen: int = 0                # unix seconds
    messages: int = 0
    odd_cprlat: int = 0
    odd_cprlon: int = 0
    even_cprlat: int = 0
    even_cprlon: int = 0
    odd_cprtime: int = 0         # ms
    even_cprtime: int = 0        # ms
    lat: float = 0.0
    lon: float = 0.0

    def __post_init__(self):
        if not self.hexaddr:
            self.hexaddr = f"{self.addr:06x}"


class AircraftTracker:
    """Aircraft table + CPR decode + receiver auto-reference position."""

    def __init__(self, clock=None, msclock=None, interactive_ttl: int = INTERACTIVE_TTL):
        self.aircraft: list[Aircraft] = []   # newest first (list prepend)
        self._by_addr: dict[int, Aircraft] = {}
        self.clock = clock or (lambda: int(_time.time()))
        self.msclock = msclock or _mstime
        self.interactive_ttl = interactive_ttl
        # receiver reference position: incremental mean of airborne decodes,
        # capped at 10000 samples (dump1090.c:197-207, 2126-2142)
        self.ref_lat = 0.0
        self.ref_lon = 0.0
        self.ref_count = 0

    def find(self, addr: int) -> Aircraft | None:
        return self._by_addr.get(addr)

    def receive(self, mm: ModesMessage, check_crc: bool = True) -> Aircraft | None:
        """interactiveReceiveData (dump1090.c:2069-2164)."""
        if check_crc and not mm.crcok:
            return None
        addr = mm.addr
        a = self._by_addr.get(addr)
        if a is None:
            a = Aircraft(addr)
            self.aircraft.insert(0, a)
            self._by_addr[addr] = a
        a.seen = self.clock()
        a.messages += 1

        if mm.msgtype in (0, 4, 20):
            a.altitude = mm.altitude
        elif mm.msgtype in (17, 18):
            if 1 <= mm.metype <= 4:
                a.flight = mm.flight
            elif 9 <= mm.metype <= 18:
                a.altitude = mm.altitude
                if mm.fflag:
                    a.odd_cprlat = mm.raw_latitude
                    a.odd_cprlon = mm.raw_longitude
                    a.odd_cprtime = self.msclock()
                else:
                    a.even_cprlat = mm.raw_latitude
                    a.even_cprlon = mm.raw_longitude
                    a.even_cprtime = self.msclock()
                if abs(a.even_cprtime - a.odd_cprtime) <= 10000:
                    prev = (a.lat, a.lon)
                    pos = cpr.decode_cpr_airborne(
                        a.even_cprlat, a.even_cprlon,
                        a.odd_cprlat, a.odd_cprlon,
                        use_even=a.even_cprtime > a.odd_cprtime,
                    )
                    if pos is not None:
                        a.lat, a.lon = pos
                    if (a.lat, a.lon) != prev:
                        self._update_reference(a.lat, a.lon)
            elif 5 <= mm.metype <= 8:
                # surface position needs a reference (dump1090.c:2144-2155)
                if self.ref_count:
                    if mm.ground_track_valid:
                        a.track = mm.ground_track
                    if mm.movement_valid:
                        from .decoder import decode_movement_field

                        a.speed = decode_movement_field(mm.movement)
                    a.altitude = 0  # on ground
                    pos = cpr.decode_cpr_surface(
                        self.ref_lat, self.ref_lon,
                        mm.fflag, mm.raw_latitude, mm.raw_longitude,
                    )
                    if pos is not None:
                        a.lat, a.lon = pos
            elif mm.metype == 19:
                if mm.mesub in (1, 2):
                    a.speed = mm.velocity
                    a.track = mm.heading
        return a

    def _update_reference(self, lat: float, lon: float) -> None:
        if self.ref_count == 0:
            self.ref_lat = lat
            self.ref_lon = lon
        else:
            self.ref_lat += (lat - self.ref_lat) / (self.ref_count + 1)
            self.ref_lon += (lon - self.ref_lon) / (self.ref_count + 1)
        if self.ref_count < 10000:
            self.ref_count += 1

    def remove_stale(self) -> None:
        """interactiveRemoveStaleAircrafts (dump1090.c:2203-2224)."""
        now = self.clock()
        keep = [a for a in self.aircraft if now - a.seen <= self.interactive_ttl]
        if len(keep) != len(self.aircraft):
            self.aircraft = keep
            self._by_addr = {a.addr: a for a in keep}
