"""IQ -> magnitude conversion (plain PyTorch, elementwise).

Behavioral contract: computeMagnitudeVector + maglut, dump1090.c:346-364,
1452-1469: m = round(sqrt(i^2 + q^2) * 360) with i = |I-127|, q = |Q-127|,
values in 0..65167.

Port of dump1090_tpu/ops/magnitude.py.  The exact integer-corrected sqrt is
kept:

    round(sqrt(v) * 360) == round(sqrt(129600 * v))    (360^2 == 129600)

A float32 sqrt gives a candidate c within +-1 of R = round(sqrt(W)); one
integer test d = W - c^2 against +-c pins R exactly (R is the unique integer
with R^2 - R < W <= R^2 + R).  W = 129600 * v can pass 2^31, so d is formed
in int64 (the JAX package relies on int32 wraparound instead; both give the
exact difference).
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import MAG_SCALE_SQ


def _magnitude(i: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """int32 I and Q bytes (0..255) -> int32 magnitudes."""
    i = (i - 127).abs_()
    q = (q - 127).abs_()
    v = i.mul_(i).add_(q * q)                      # <= 32768
    c = (torch.sqrt(v.to(torch.float32) * float(MAG_SCALE_SQ)) + 0.5).to(torch.int32)
    c64 = c.to(torch.int64)
    d = v.to(torch.int64) * MAG_SCALE_SQ - c64 * c64
    up = (d > c64).to(torch.int32)
    down = ((c > 0) & (d <= -c64)).to(torch.int32)
    return c.add_(up).sub_(down)


def magnitude_from_iq(iq: torch.Tensor, out_dtype: torch.dtype = torch.int32) -> torch.Tensor:
    """uint8 interleaved IQ [..., 2N] -> magnitudes [..., N] of out_dtype.

    Exact equivalent of the reference maglut path (dump1090.c:1461-1468).
    I and Q are strided views of the bytes, widened to int32 before any
    arithmetic.  Values are <= 65167, so out_dtype=torch.uint16 is lossless."""
    if iq.dtype != torch.uint8:
        raise TypeError(f"magnitude_from_iq takes uint8 IQ bytes, got {iq.dtype}")
    return _magnitude(iq[..., 0::2].to(torch.int32), iq[..., 1::2].to(torch.int32)).to(out_dtype)


def magnitude_from_pairs(pairs: torch.Tensor, out_dtype: torch.dtype = torch.int32) -> torch.Tensor:
    """uint16 IQ pairs [..., N] (little-endian I | Q<<8) -> magnitudes of
    out_dtype (int32 by default; uint16 is lossless).

    The same wire bytes as magnitude_from_iq viewed two at a time.  uint16
    is only a storage type here: the pairs are reinterpreted as int16 and
    widened to int32 before any arithmetic."""
    if pairs.dtype != torch.uint16:
        raise TypeError(f"magnitude_from_pairs takes uint16 pairs, got {pairs.dtype}")
    p = pairs.view(torch.int16).to(torch.int32) & 0xFFFF
    return _magnitude(p & 0xFF, p >> 8).to(out_dtype)


def reference_maglut() -> np.ndarray:
    """The reference's 129x129 lookup table, for differential tests
    (dump1090.c:359-364). C round() rounds half away from zero; all values
    here are nonnegative so floor(x+0.5) matches."""
    i = np.arange(129, dtype=np.float64)[:, None]
    q = np.arange(129, dtype=np.float64)[None, :]
    return np.floor(np.sqrt(i * i + q * q) * 360.0 + 0.5).astype(np.uint16)
