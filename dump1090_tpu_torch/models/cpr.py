"""CPR (Compact Position Reporting) decoding — airborne global and surface
local (a copy of dump1090_tpu/models/cpr.py).

Behavioral contract: dump1090.c:1861-2066 (cprNLFunction :1869, decodeCPR
:1952, decodeCPRSurface :2004, decodeMovementField :2056).

All math is IEEE-754 double precision on the host (Python floats are C
doubles), with C int-cast truncation and C `%` semantics reproduced exactly.
Position decode is O(position messages) and latches per-aircraft state, so it
stays on the host: there is nothing batched to win on the device, and
bit-exactness demands IEEE doubles with C's truncation.
"""

from __future__ import annotations

import math

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
    zone (1.5 deg lat) off.  Behavioral parity wins over geodesy here; the
    quirk is pinned by tests/test_cpr.py::test_surface_decode_roundtrip."""
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
