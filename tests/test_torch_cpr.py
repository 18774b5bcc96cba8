"""The port's CPR decode (models/cpr.py) against the reference's own C and
against the JAX package: the 4,210 vectors of tests/golden/golden_cpr.txt
bit for bit (IEEE-754 patterns, no tolerance), and seeded inputs through
both packages, compared as bit patterns too."""

import struct
from pathlib import Path

import numpy as np
import pytest

import dump1090_tpu.models.cpr as jcpr
import dump1090_tpu_torch.models.cpr as tcpr

GOLDEN = Path(__file__).parent / "golden" / "golden_cpr.txt"


def _render(got) -> str:
    if got is None:
        return "NONE"
    return " ".join(struct.pack(">d", x).hex() for x in got)


def test_golden_cpr_vectors_bit_for_bit():
    n_air = n_surf = 0
    for ln in GOLDEN.read_text().splitlines():
        inp, _, want = ln.partition(" -> ")
        f = inp.split()
        if f[0] == "A":
            got = tcpr.decode_cpr_airborne(int(f[1]), int(f[2]), int(f[3]), int(f[4]),
                                           bool(int(f[5])))
            n_air += 1
        else:
            got = tcpr.decode_cpr_surface(float.fromhex(f[1]), float.fromhex(f[2]),
                                          int(f[3]), int(f[4]), int(f[5]))
            n_surf += 1
        assert _render(got) == want, inp
    assert n_air + n_surf == 4210 and n_air >= 2000 and n_surf >= 1500


@pytest.mark.parametrize("use_even", [True, False])
def test_airborne_equals_jax_on_seeded_inputs(use_even):
    rng = np.random.default_rng(11 + use_even)
    raw = rng.integers(0, 1 << 17, (3000, 4))
    n_none = 0
    for a, b, c, d in raw.tolist():
        got = tcpr.decode_cpr_airborne(a, b, c, d, use_even=use_even)
        assert _render(got) == _render(jcpr.decode_cpr_airborne(a, b, c, d, use_even=use_even))
        n_none += got is None
    assert 0 < n_none < len(raw)  # both outcomes reached


def test_surface_equals_jax_on_seeded_inputs():
    rng = np.random.default_rng(12)
    for _ in range(3000):
        ref_lat = float(rng.uniform(-89.0, 89.0))
        ref_lon = float(rng.uniform(-179.9, 179.9))
        fflag = int(rng.integers(0, 2))
        lat, lon = (int(x) for x in rng.integers(0, 1 << 17, 2))
        got = tcpr.decode_cpr_surface(ref_lat, ref_lon, fflag, lat, lon)
        assert _render(got) == _render(jcpr.decode_cpr_surface(ref_lat, ref_lon, fflag, lat, lon))


def test_zone_helpers_equal_jax():
    for lat in np.linspace(-91.0, 91.0, 20001).tolist() + [t for t, _ in jcpr._NL_THRESHOLDS]:
        assert tcpr.nl_function(lat) == jcpr.nl_function(lat)
        for odd in (0, 1):
            assert tcpr.n_function(lat, odd) == jcpr.n_function(lat, odd)
            assert tcpr.dlon_function(lat, odd) == jcpr.dlon_function(lat, odd)
    for a in range(-200, 201):
        for b in (1, 3, 6, 59, 60):
            assert tcpr.c_int_mod(a, b) == jcpr.c_int_mod(a, b)
    assert tcpr.c_int_mod(-7, 3) == 2
