"""Deterministic CPR fuzz vectors for tools/make_cpr_golden.sh (a port of
tools/gen_cpr_vectors.py, on the port's models/cpr.py).

Emits the harness input grammar (one vector per line):
  A <even_lat> <even_lon> <odd_lat> <odd_lon> <use_even>   airborne global
  S <ref_lat_hex> <ref_lon_hex> <fflag> <raw_lat> <raw_lon> surface local

The mix targets the decode's decision points (dump1090.c:1952-2052):
realistic even/odd pairs from a forward encoder (in-zone decodes), raw
17-bit randoms (NL-mismatch aborts and garbage-in pinning), latitudes that
straddle NL-table thresholds, polar and negative bands, and for surface:
references near whole-degree boundaries (the (int)ref truncation quirk),
near the +-180 lon wrap, and out-of-range aborts.  Reference doubles are
emitted as C99 hex floats so strtod round-trips them bit-exactly.

    python -m dump1090_tpu_torch.tools.gen_cpr_vectors

(no device work, so no card is needed).
"""

from __future__ import annotations

import argparse
import math
import sys

import numpy as np

from ..models.cpr import _NL_THRESHOLDS, nl_function


def encode_airborne(lat: float, lon: float, odd: int) -> tuple[int, int]:
    """Forward CPR encoding (DO-260 airborne): 17-bit YZ/XZ for one frame."""
    nz = 15
    dlat = 360.0 / (4 * nz - odd)
    yz = math.floor(0.5 + 131072 * (lat % dlat) / dlat)
    rlat = dlat * (yz / 131072 + math.floor(lat / dlat))
    nl = nl_function(rlat)
    n = max(nl - odd, 1)
    dlon = 360.0 / n
    xz = math.floor(0.5 + 131072 * (lon % dlon) / dlon)
    return int(yz) % 131072, int(xz) % 131072


def vectors() -> list[str]:
    """The vector lines, the JAX tool's for the same seed (42)."""
    rng = np.random.default_rng(42)
    out = []

    def airborne_pair(lat: float, lon: float, dlat: float, dlon: float) -> None:
        el, eg = encode_airborne(lat, lon, odd=0)
        ol, og = encode_airborne(lat + dlat, lon + dlon, odd=1)
        out.append(f"A {el} {eg} {ol} {og} {int(rng.integers(0, 2))}")

    # Realistic pairs: same aircraft, slight motion between frames.
    for _ in range(900):
        lat = float(rng.uniform(-85, 85))
        lon = float(rng.uniform(-180, 180))
        airborne_pair(lat, lon, float(rng.uniform(-0.02, 0.02)),
                      float(rng.uniform(-0.02, 0.02)))

    # NL-threshold straddles: pairs whose rlat0/rlat1 can land in different
    # zones (the decode's abort condition) and exact-threshold latitudes.
    for thr, _ in _NL_THRESHOLDS[::3]:
        for eps in (-0.05, -1e-9, 0.0, 1e-9, 0.05):
            for sign in (1.0, -1.0):
                lat = sign * (thr + eps)
                if abs(lat) <= 90:
                    airborne_pair(lat, float(rng.uniform(-180, 180)),
                                  float(rng.uniform(-0.3, 0.3)), 0.0)

    # Polar band and the NL<=2 floor.
    for _ in range(150):
        lat = float(rng.uniform(85, 90)) * (1 if rng.integers(0, 2) else -1)
        airborne_pair(lat, float(rng.uniform(-180, 180)), 0.0, 0.0)

    # Raw 17-bit randoms: mostly NL-mismatch aborts or nonsense decodes —
    # both must match the reference bit-for-bit.
    for _ in range(900):
        v = rng.integers(0, 131072, size=4)
        out.append(f"A {v[0]} {v[1]} {v[2]} {v[3]} {int(rng.integers(0, 2))}")

    # Surface local decode.
    def surf(ref_lat: float, ref_lon: float) -> None:
        out.append(
            f"S {float(ref_lat).hex()} {float(ref_lon).hex()} "
            f"{int(rng.integers(0, 2))} {int(rng.integers(0, 131072))} "
            f"{int(rng.integers(0, 131072))}"
        )

    for _ in range(1400):
        surf(float(rng.uniform(-89, 89)), float(rng.uniform(-179, 179)))
    # Whole-degree boundaries: the (int)ref truncation quirk.
    for base in range(-88, 89, 7):
        for eps in (-1e-9, 0.0, 1e-9, 0.49, 0.51):
            surf(base + eps, float(rng.uniform(-179, 179)))
            surf(float(rng.uniform(-89, 89)), base * 2 + eps)
    # Wrap and sanity-abort edges.
    for _ in range(200):
        surf(float(rng.uniform(-90, 90)),
             float(rng.choice([-180, 180]) + rng.uniform(-2, 2)))
        surf(float(rng.choice([-90, 90]) + rng.uniform(-1, 1) * 0.99),
             float(rng.uniform(-179, 179)))

    return out


def main(argv=None) -> int:
    argparse.ArgumentParser(description=__doc__.split("\n")[0]).parse_args(argv)
    print("\n".join(vectors()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
