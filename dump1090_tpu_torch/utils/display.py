"""Human-readable message display, SBS/BaseStation CSV, raw hex, JSON (a
copy of dump1090_tpu/utils/display.py).

Behavioral contract: displayModesMessage (dump1090.c:1312-1451),
modesSendRawOutput (:2380-2393), modesSendSBSOutput (:2396-2448),
aircraftsToJson (:2505-2551), interactiveShowData (:2166-2199).
Output is byte-identical to the reference printers.
"""

from __future__ import annotations

from ..models.decoder import UNIT_METERS, ModesMessage, decode_movement_field
from ..models.tracker import Aircraft, AircraftTracker

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


def raw_hex(mm: ModesMessage, upper: bool = False) -> str:
    """The raw wire format `*<hex>;` (stdout uses lowercase, the TCP raw
    service uppercase — dump1090.c:1324-1326 vs :2385-2388)."""
    h = mm.msg[: mm.msgbits // 8].hex()
    return "*" + (h.upper() if upper else h) + ";"


def _icao(mm: ModesMessage) -> str:
    return f"{mm.aa1:02x}{mm.aa2:02x}{mm.aa3:02x}"


def display_message(mm: ModesMessage, *, raw=False, onlyaddr=False, check_crc=True) -> str:
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

    unit = "meters" if mm.unit == UNIT_METERS else "feet"
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
                out.append(f"    Movement : {mm.movement} ({decode_movement_field(mm.movement)} kt)\n")
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


def sbs_line(mm: ModesMessage, a: Aircraft) -> str | None:
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


def aircraft_json(tracker: AircraftTracker, metric: bool = False) -> str:
    """aircraftsToJson (dump1090.c:2505-2551): aircraft with a nonzero
    position as a JSON array."""
    rows = []
    for a in tracker.aircraft:
        altitude, speed = a.altitude, a.speed
        if metric:
            altitude = int(altitude / 3.2828)
            speed = int(speed * 1.852)
        if a.lat != 0 and a.lon != 0:
            rows.append(
                '{"hex":"%s", "flight":"%s", "lat":%f, "lon":%f, '
                '"altitude":%d, "track":%d, "speed":%d}'
                % (a.hexaddr, a.flight, a.lat, a.lon, altitude, a.track, speed)
            )
    return "[\n" + ",\n".join(rows) + ("\n" if rows else "") + "]\n"


def interactive_screen(tracker: AircraftTracker, *, rows: int, metric: bool, now: int, spinner_t: int) -> str:
    """interactiveShowData (dump1090.c:2166-2199): ANSI clear + table."""
    progress = [" ", " ", " "]
    progress[spinner_t % 3] = "."
    out = [
        "\x1b[H\x1b[2J",
        "Hex    Flight   Altitude  Speed   Lat       Lon       Track  Messages Seen %s\n"
        % "".join(progress),
        "-" * 80 + "\n",
    ]
    count = 0
    for a in tracker.aircraft:
        if count >= rows:
            break
        altitude, speed = a.altitude, a.speed
        if metric:
            altitude = int(altitude / 3.2828)
            speed = int(speed * 1.852)
        out.append(
            "%-6s %-8s %-9d %-7d %-7.03f   %-7.03f   %-3d   %-9d %d sec\n"
            % (a.hexaddr, a.flight, altitude, speed, a.lat, a.lon, a.track,
               a.messages, now - a.seen)
        )
        count += 1
    return "".join(out)
