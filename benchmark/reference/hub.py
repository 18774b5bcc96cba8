"""The plain reference's consumers of decoded messages: the aircraft table
with CPR positions, the verbose display, the SBS (BaseStation) lines and
the raw-out lines, routed as useModesMessage routes them.

Behavioral contract: antirez/dump1090, dump1090.c:1312-1451
(displayModesMessage), 1795-1820 (useModesMessage), 1822-2224 (aircraft
table, CPR decode, receiver reference position), 2380-2448 (raw and SBS
output).  A frozen copy of the program's host code for these, so that the
benchmark's yardstick does not move with the program.  Time comes from the
clocks passed in: the benchmark replays the values the program's run read.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

from .decoder import Message, movement_knots, raw_line

INTERACTIVE_TTL = 60


def raw_hex(mm: Message, upper: bool = False) -> str:
    return raw_line(mm, upper)


CA_STR = (
    "Level 1 (Survillance Only)",
    "Level 2 (DF0,4,5,11)",
    "Level 3 (DF0,4,5,11,20,21)",
    "Level 4 (DF0,4,5,11,20,21,24)",
    "Level 2+3+4 (DF0,4,5,11,20,21,24,code7 - is on ground)",
    "Level 2+3+4 (DF0,4,5,11,20,21,24,code7 - is on airborne)",
    "Level 2+3+4 (DF0,4,5,11,20,21,24,code7)",
    "Level 7 ???",
)

FS_STR = (
    "Normal, Airborne",
    "Normal, On the ground",
    "ALERT,  Airborne",
    "ALERT,  On the ground",
    "ALERT & Special Position Identification. Airborne or Ground",
    "Special Position Identification. Airborne or Ground",
    "Value 6 is not assigned",
    "Value 7 is not assigned",
)

AC_TYPE_STR = (
    "Aircraft Type D",
    "Aircraft Type C",
    "Aircraft Type B",
    "Aircraft Type A",
)


def me_description(metype: int, mesub: int) -> str:
    """getMEDescription (dump1090.c:1060-1089)."""
    if 1 <= metype <= 4:
        return "Aircraft Identification and Category"
    if 5 <= metype <= 8:
        return "Surface Position"
    if 9 <= metype <= 18:
        return "Airborne Position (Baro Altitude)"
    if metype == 19 and 1 <= mesub <= 4:
        return "Airborne Velocity"
    if 20 <= metype <= 22:
        return "Airborne Position (GNSS Height)"
    if metype == 23 and mesub == 0:
        return "Test Message"
    if metype == 24 and mesub == 1:
        return "Surface System Status"
    if metype == 28 and mesub == 1:
        return "Extended Squitter Aircraft Status (Emergency)"
    if metype == 28 and mesub == 2:
        return "Extended Squitter Aircraft Status (1090ES TCAS RA)"
    if metype == 29 and mesub in (0, 1):
        return "Target State and Status Message"
    if metype == 31 and mesub in (0, 1):
        return "Aircraft Operational Status Message"
    return "Unknown"


def _icao(mm: Message) -> str:
    return f"{mm.aa1:02x}{mm.aa2:02x}{mm.aa3:02x}"


def display_message(mm: Message, *, raw=False, onlyaddr=False, check_crc=True) -> str:
    """displayModesMessage as a string, without the trailing blank-line
    separator the hub adds (dump1090.c:1312-1451)."""
    if onlyaddr:
        return _icao(mm) + "\n"

    out = [raw_hex(mm) + "\n"]
    if raw:
        return out[0]

    out.append(f"CRC: {mm.crc:06x} ({'ok' if mm.crcok else 'wrong'})\n")
    if mm.errorbit != -1:
        out.append(f"Single bit error fixed, bit {mm.errorbit}\n")

    unit = "meters" if mm.unit == 1 else "feet"
    t = mm.msgtype
    if t == 0:
        out.append("DF 0: Short Air-Air Surveillance.\n")
        out.append(f"  Altitude       : {mm.altitude} {unit}\n")
        out.append(f"  ICAO Address   : {_icao(mm)}\n")
    elif t in (4, 20):
        out.append(f"DF {t}: {'Surveillance' if t == 4 else 'Comm-B'}, Altitude Reply.\n")
        out.append(f"  Flight Status  : {FS_STR[mm.fs]}\n")
        out.append(f"  DR             : {mm.dr}\n")
        out.append(f"  UM             : {mm.um}\n")
        out.append(f"  Altitude       : {mm.altitude} {unit}\n")
        out.append(f"  ICAO Address   : {_icao(mm)}\n")
    elif t in (5, 21):
        out.append(f"DF {t}: {'Surveillance' if t == 5 else 'Comm-B'}, Identity Reply.\n")
        out.append(f"  Flight Status  : {FS_STR[mm.fs]}\n")
        out.append(f"  DR             : {mm.dr}\n")
        out.append(f"  UM             : {mm.um}\n")
        out.append(f"  Squawk         : {mm.identity}\n")
        out.append(f"  ICAO Address   : {_icao(mm)}\n")
    elif t == 11:
        out.append("DF 11: All Call Reply.\n")
        out.append(f"  Capability  : {CA_STR[mm.ca]}\n")
        out.append(f"  ICAO Address: {_icao(mm)}\n")
    elif t == 17:
        out.append("DF 17: ADS-B message.\n")
        out.append(f"  Capability     : {mm.ca} ({CA_STR[mm.ca]})\n")
        out.append(f"  ICAO Address   : {_icao(mm)}\n")
        out.append(f"  Extended Squitter  Type: {mm.metype}\n")
        out.append(f"  Extended Squitter  Sub : {mm.mesub}\n")
        out.append(f"  Extended Squitter  Name: {me_description(mm.metype, mm.mesub)}\n")
        if 1 <= mm.metype <= 4:
            out.append(f"    Aircraft Type  : {AC_TYPE_STR[mm.aircraft_type]}\n")
            out.append(f"    Identification : {mm.flight}\n")
        elif 5 <= mm.metype <= 8:
            out.append(f"    F flag   : {'odd' if mm.fflag else 'even'}\n")
            out.append(f"    T flag   : {'UTC' if mm.tflag else 'non-UTC'}\n")
            if mm.movement_valid:
                out.append(f"    Movement : {mm.movement} ({movement_knots(mm.movement)} kt)\n")
            else:
                out.append(f"    Movement : {mm.movement} (not available)\n")
            out.append(
                f"    Track    : {mm.ground_track} degrees"
                + ("" if mm.ground_track_valid else " (not valid)")
                + "\n"
            )
            out.append(f"    Latitude : {mm.raw_latitude} (not decoded)\n")
            out.append(f"    Longitude: {mm.raw_longitude} (not decoded)\n")
        elif 9 <= mm.metype <= 18:
            out.append(f"    F flag   : {'odd' if mm.fflag else 'even'}\n")
            out.append(f"    T flag   : {'UTC' if mm.tflag else 'non-UTC'}\n")
            out.append(f"    Altitude : {mm.altitude} feet\n")
            out.append(f"    Latitude : {mm.raw_latitude} (not decoded)\n")
            out.append(f"    Longitude: {mm.raw_longitude} (not decoded)\n")
        elif mm.metype == 19 and 1 <= mm.mesub <= 4:
            if mm.mesub in (1, 2):
                out.append(f"    EW direction      : {mm.ew_dir}\n")
                out.append(f"    EW velocity       : {mm.ew_velocity}\n")
                out.append(f"    NS direction      : {mm.ns_dir}\n")
                out.append(f"    NS velocity       : {mm.ns_velocity}\n")
                out.append(f"    Vertical rate src : {mm.vert_rate_source}\n")
                out.append(f"    Vertical rate sign: {mm.vert_rate_sign}\n")
                out.append(f"    Vertical rate     : {mm.vert_rate}\n")
            else:
                # the reference omits both newlines here (dump1090.c:1428-1429)
                out.append(f"    Heading status: {mm.heading_is_valid}")
                out.append(f"    Heading: {mm.heading}")
        else:
            out.append(f"    Unrecognized ME type: {mm.metype} subtype: {mm.mesub}\n")
    elif t == 18:
        out.append("DF 18: Extended Squitter.\n")
        out.append(f"  Control Field  : {mm.ca}\n")
        out.append(f"  ICAO Address   : {_icao(mm)}\n")
        out.append(f"  Extended Squitter  Type: {mm.metype}\n")
        out.append(f"  Extended Squitter  Sub : {mm.mesub}\n")
        out.append(f"  Extended Squitter  Name: {me_description(mm.metype, mm.mesub)}\n")
    elif check_crc:
        out.append(f"DF {t} with good CRC received (decoding still not implemented).\n")
    return "".join(out)


def sbs_line(mm: Message, a: Aircraft) -> str | None:
    """SBS-1/BaseStation CSV line (modesSendSBSOutput, dump1090.c:2396-2448).
    Returns None for message types the reference does not forward."""
    emergency = ground = alert = spi = 0
    if mm.msgtype in (4, 5, 21):
        if mm.identity in (7500, 7600, 7700):
            emergency = -1
        if mm.fs in (1, 3):
            ground = -1
        if mm.fs in (2, 3, 4):
            alert = -1
        if mm.fs in (4, 5):
            spi = -1

    icao = f"{mm.aa1:02X}{mm.aa2:02X}{mm.aa3:02X}"
    t = mm.msgtype
    if t == 0:
        return f"MSG,5,,,{icao},,,,,,,{mm.altitude},,,,,,,,,,"
    if t == 4:
        return f"MSG,5,,,{icao},,,,,,,{mm.altitude},,,,,,,{alert},{emergency},{spi},{ground}"
    if t == 5:
        return f"MSG,6,,,{icao},,,,,,,,,,,,,{mm.identity},{alert},{emergency},{spi},{ground}"
    if t == 11:
        return f"MSG,8,,,{icao},,,,,,,,,,,,,,,,,"
    if t in (17, 18) and mm.metype == 4:
        return f"MSG,1,,,{icao},,,,,,{mm.flight},,,,,,,,0,0,0,0"
    if t in (17, 18) and 9 <= mm.metype <= 18:
        if a.lat == 0 and a.lon == 0:
            return f"MSG,3,,,{icao},,,,,,,{mm.altitude},,,,,,,0,0,0,0"
        return (
            f"MSG,3,,,{icao},,,,,,,{mm.altitude},,,{a.lat:.5f},{a.lon:.5f},,,0,0,0,0"
        )
    if t in (17, 18) and mm.metype == 19 and mm.mesub == 1:
        vr = (1 if mm.vert_rate_sign == 0 else -1) * (mm.vert_rate - 1) * 64
        return f"MSG,4,,,{icao},,,,,,,,{a.speed},{a.track},,,{vr},,0,0,0,0"
    if t == 21:
        return f"MSG,6,,,{icao},,,,,,,,,,,,,{mm.identity},{alert},{emergency},{spi},{ground}"
    return None


# Latitude zone thresholds from 1090-WP-9-14 (dump1090.c:1872-1929).
_NL_THRESHOLDS = (
    (10.47047130, 59), (14.82817437, 58), (18.18626357, 57), (21.02939493, 56),
    (23.54504487, 55), (25.82924707, 54), (27.93898710, 53), (29.91135686, 52),
    (31.77209708, 51), (33.53993436, 50), (35.22899598, 49), (36.85025108, 48),
    (38.41241892, 47), (39.92256684, 46), (41.38651832, 45), (42.80914012, 44),
    (44.19454951, 43), (45.54626723, 42), (46.86733252, 41), (48.16039128, 40),
    (49.42776439, 39), (50.67150166, 38), (51.89342469, 37), (53.09516153, 36),
    (54.27817472, 35), (55.44378444, 34), (56.59318756, 33), (57.72747354, 32),
    (58.84763776, 31), (59.95459277, 30), (61.04917774, 29), (62.13216659, 28),
    (63.20427479, 27), (64.26616523, 26), (65.31845310, 25), (66.36171008, 24),
    (67.39646774, 23), (68.42322022, 22), (69.44242631, 21), (70.45451075, 20),
    (71.45986473, 19), (72.45884545, 18), (73.45177442, 17), (74.43893416, 16),
    (75.42056257, 15), (76.39684391, 14), (77.36789461, 13), (78.33374083, 12),
    (79.29428225, 11), (80.24923213, 10), (81.19801349, 9), (82.13956981, 8),
    (83.07199445, 7), (83.99173563, 6), (84.89166191, 5), (85.75541621, 4),
    (86.53536998, 3), (87.00000000, 2),
)


def c_int_mod(a: int, b: int) -> int:
    """C `%` for ints (remainder truncated toward zero), then the reference's
    always-positive adjustment (cprModFunction, dump1090.c:1862-1866)."""
    r = int(math.fmod(a, b))
    if r < 0:
        r += b
    return r


def nl_function(lat: float) -> int:
    """Number of longitude zones at |lat| (dump1090.c:1869-1930)."""
    if lat < 0:
        lat = -lat
    for threshold, nl in _NL_THRESHOLDS:
        if lat < threshold:
            return nl
    return 1


def n_function(lat: float, isodd: int) -> int:
    nl = nl_function(lat) - isodd
    return nl if nl >= 1 else 1


def dlon_function(lat: float, isodd: int) -> float:
    return 360.0 / n_function(lat, isodd)


def decode_cpr_airborne(
    even_cprlat: int,
    even_cprlon: int,
    odd_cprlat: int,
    odd_cprlon: int,
    use_even: bool,
) -> tuple[float, float] | None:
    """Global airborne decode from an even/odd pair (dump1090.c:1952-1989).

    `use_even` selects which frame is fresher (even_cprtime > odd_cprtime in
    the reference).  Returns (lat, lon) or None when the two latitudes fall
    in different NL zones."""
    air_dlat0 = 360.0 / 60
    air_dlat1 = 360.0 / 59
    lat0, lat1 = float(even_cprlat), float(odd_cprlat)
    lon0, lon1 = float(even_cprlon), float(odd_cprlon)

    j = int(math.floor(((59 * lat0 - 60 * lat1) / 131072) + 0.5))
    rlat0 = air_dlat0 * (c_int_mod(j, 60) + lat0 / 131072)
    rlat1 = air_dlat1 * (c_int_mod(j, 59) + lat1 / 131072)
    if rlat0 >= 270:
        rlat0 -= 360
    if rlat1 >= 270:
        rlat1 -= 360
    if nl_function(rlat0) != nl_function(rlat1):
        return None

    if use_even:
        ni = n_function(rlat0, 0)
        m = int(math.floor((((lon0 * (nl_function(rlat0) - 1))
                             - (lon1 * nl_function(rlat0))) / 131072) + 0.5))
        lon = dlon_function(rlat0, 0) * (c_int_mod(m, ni) + lon0 / 131072)
        lat = rlat0
    else:
        ni = n_function(rlat1, 1)
        m = int(math.floor((((lon0 * (nl_function(rlat1) - 1))
                             - (lon1 * nl_function(rlat1))) / 131072.0) + 0.5))
        lon = dlon_function(rlat1, 1) * (c_int_mod(m, ni) + lon1 / 131072)
        lat = rlat1
    if lon > 180:
        lon -= 360
    return lat, lon


def decode_cpr_surface(
    ref_lat: float,
    ref_lon: float,
    fflag: int,
    raw_lat: int,
    raw_lon: int,
) -> tuple[float, float] | None:
    """Local surface decode relative to a reference position
    (dump1090.c:2004-2052).  Returns (lat, lon) or None on sanity failure.

    Reproduced reference quirk: the zone index uses
    cprModFunction((int)ref, (int)zone_width) — an integer mod whose base
    truncates to 1 degree — so the receiver's fractional zone offset is
    discarded and targets in the upper half of a CPR zone decode one whole
    zone (1.5 deg lat) off.  Behavioral parity wins over geodesy here."""
    dlat = (90.0 / 59) if fflag else (90.0 / 60)

    j = int(math.floor(ref_lat / dlat)) + int(
        math.floor(0.5 + c_int_mod(int(ref_lat), int(dlat)) / dlat
                   - float(raw_lat) / 131072)
    )
    lat = dlat * (j + float(raw_lat) / 131072)
    if abs(lat - ref_lat) > 45:
        if lat > ref_lat:
            lat -= 90
        else:
            lat += 90
    if lat < -90 or lat > 90:
        return None

    ni = n_function(lat, fflag)
    if ni == 0:
        ni = 1
    dlon = 90.0 / ni
    m = int(math.floor(ref_lon / dlon)) + int(
        math.floor(0.5 + c_int_mod(int(ref_lon), int(dlon)) / dlon
                   - float(raw_lon) / 131072)
    )
    lon = dlon * (m + float(raw_lon) / 131072)
    while lon > ref_lon + 45:
        lon -= 90
    while lon < ref_lon - 45:
        lon += 90
    if lon > 180:
        lon -= 360
    if lon < -180:
        lon += 360
    return lat, lon


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

    def __init__(self, clock, msclock, interactive_ttl: int = INTERACTIVE_TTL):
        self.aircraft: list[Aircraft] = []   # newest first (list prepend)
        self._by_addr: dict[int, Aircraft] = {}
        self.clock = clock
        self.msclock = msclock
        self.interactive_ttl = interactive_ttl
        # receiver reference position: incremental mean of airborne decodes,
        # capped at 10000 samples (dump1090.c:197-207, 2126-2142)
        self.ref_lat = 0.0
        self.ref_lon = 0.0
        self.ref_count = 0

    def receive(self, mm: Message, check_crc: bool = True) -> Aircraft | None:
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
                    pos = decode_cpr_airborne(
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
                        a.speed = movement_knots(mm.movement)
                    a.altitude = 0  # on ground
                    pos = decode_cpr_surface(
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


class Hub:
    """useModesMessage (dump1090.c:1802-1820) for a `--net` feeder with one
    SBS client attached: good-CRC messages go to the aircraft table, which
    feeds the SBS line; every good-CRC message is displayed and sent to the
    raw-out clients."""

    def __init__(self, tracker: AircraftTracker, *, raw: bool = False, net: bool = True,
                 sbs_connections: int = 1):
        self.tracker = tracker
        self.raw = raw
        self.net = net
        self.sbs_connections = sbs_connections

    def use_message(self, mm: Message) -> tuple[list[str], list[str], str]:
        """(raw-out lines, SBS lines, display text) that `mm` produces."""
        raw_out, sbs, text = [], [], ""
        if not mm.crcok:
            return raw_out, sbs, text
        if self.sbs_connections > 0:
            a = self.tracker.receive(mm)
            if a is not None:
                line = sbs_line(mm, a)
                if line is not None:
                    sbs.append(line + "\n")
        text = display_message(mm, raw=self.raw)
        if not self.raw:
            text += "\n"
        if self.net:
            raw_out.append(raw_hex(mm, upper=True) + "\n")
        return raw_out, sbs, text
