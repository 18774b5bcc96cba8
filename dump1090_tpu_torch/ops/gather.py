"""Candidate-window gather: the CUDA kernel csrc/gather_windows.cu (port of
the Pallas TPU kernel dump1090_tpu/ops/gather.py::_gather_kernel, with the
row padding its caller built folded in) and its plain PyTorch version.

gather_row_windows takes int32 magnitudes (or uint16 rows) m (B, S), int32
positions (B, MC), a lead of 0 or 1 and the length s_pad of the TPU's
padded row, and returns (B, MC, 256) uint16 windows: with
p = clamp(pos, 0, s_pad - 256), window sample j is the low 16 bits of
m[b, p + j - lead] where that index lies in the row, else 0.  That is the
gather from a row padded with `lead` zeros in front and zeros up to s_pad
samples, without building the row.  gather_windows(m_pad, pos) is the
JAX-shaped form on padded uint16 rows (lead 0, s_pad = S).  On a CPU tensor
each runs its plain version; on a CUDA tensor it launches the kernel or
raises.
"""

from __future__ import annotations

import torch

from . import _cuda

WINDOW_PAD = 256   # emitted window width (241 used)


def _check(m: torch.Tensor, pos: torch.Tensor) -> None:
    """What the kernel indexes: 2-D contiguous rows and positions of one
    row count, on one device."""
    if m.dtype not in (torch.int32, torch.uint16) or m.dim() != 2:
        raise TypeError(f"m must be int32 or uint16 (B, S), got {m.dtype} {tuple(m.shape)}")
    if pos.dtype != torch.int32 or pos.dim() != 2 or pos.shape[0] != m.shape[0]:
        raise TypeError(f"pos must be int32 (B, MC), got {pos.dtype} {tuple(pos.shape)}")
    if not (m.is_contiguous() and pos.is_contiguous()):
        raise ValueError("the window gather needs contiguous rows and positions")
    if m.get_device() != pos.get_device():
        raise ValueError(f"m on {m.device} but pos on {pos.device}")


def gather_row_windows_plain(m: torch.Tensor, pos: torch.Tensor, *, lead: int,
                             s_pad: int) -> torch.Tensor:
    """Plain version: one clamped index per window sample, zero outside the
    row (uint16 rows are indexed through an int16 view: uint16 is a storage
    type), narrowed through int16, whose cast keeps the low 16 bits."""
    _check(m, pos)
    b, s = m.shape
    dev = m.device
    start = pos.to(torch.int64).clamp(0, s_pad - WINDOW_PAD) - lead
    src = start[..., None] + torch.arange(WINDOW_PAD, device=dev)
    inside = (src >= 0) & (src < s)
    flat = src.clamp_(0, max(s - 1, 0)) + (torch.arange(b, device=dev) * s)[:, None, None]
    rows = m.view(torch.int16) if m.dtype == torch.uint16 else m
    v = rows.reshape(-1)[flat]
    return torch.where(inside, v, 0).to(torch.int16).view(torch.uint16)


def gather_row_windows(m: torch.Tensor, pos: torch.Tensor, *, lead: int,
                       s_pad: int) -> torch.Tensor:
    """(B, MC, 256) uint16 windows of m's rows: the kernel on CUDA, the
    plain version on the CPU."""
    _check(m, pos)
    if not m.is_cuda:
        if m.device.type != "cpu":
            raise ValueError(f"the window gather runs on cuda or cpu, not {m.device}")
        return gather_row_windows_plain(m, pos, lead=lead, s_pad=s_pad)
    index = m.get_device()
    if index != torch.cuda.current_device():
        with torch.cuda.device(index):  # the launch goes to the current device
            return gather_row_windows(m, pos, lead=lead, s_pad=s_pad)
    b, s = m.shape
    mc = pos.shape[1]
    out = torch.empty((b, mc, WINDOW_PAD), dtype=torch.uint16, device=m.device)
    if out.numel() == 0:
        return out
    err = _cuda.library().gather_windows(
        m.data_ptr(), m.element_size(), pos.data_ptr(), out.data_ptr(), b, s, s_pad, lead, mc,
        _cuda.current_stream(index),
    )
    _cuda.launches["gather_windows"] += 1
    _cuda.check(err, "gather_windows")
    return out


def _padded_rows(m_pad: torch.Tensor) -> int:
    if m_pad.dtype != torch.uint16 or m_pad.dim() != 2:
        raise TypeError(f"m_pad must be uint16 (B, S_pad), got {m_pad.dtype} {tuple(m_pad.shape)}")
    if m_pad.shape[1] < WINDOW_PAD:
        raise ValueError(f"rows of {m_pad.shape[1]} samples cannot hold a {WINDOW_PAD}-sample window")
    return m_pad.shape[1]


def gather_windows_plain(m_pad: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Plain version of gather_windows (gather_windows_xla semantics, the
    start clamped so the window stays inside its row)."""
    return gather_row_windows_plain(m_pad, pos, lead=0, s_pad=_padded_rows(m_pad))


def gather_windows(m_pad: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """The JAX-shaped gather: (B, MC, 256) uint16 windows
    m_pad[b, pos : pos + 256] of padded uint16 rows (B, S_pad), on the same
    kernel as gather_row_windows."""
    return gather_row_windows(m_pad, pos, lead=0, s_pad=_padded_rows(m_pad))
