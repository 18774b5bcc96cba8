"""Candidate-window gather: the CUDA kernel csrc/gather_windows.cu (port of
the Pallas TPU kernel dump1090_tpu/ops/gather.py::_gather_kernel) and its
plain PyTorch version.

gather_windows takes the padded magnitude rows m_pad uint16 (B, S_pad)
(one-sample lead, so window index 0 holds m[pos-1]) and int32 positions
(B, MC), and returns the uint16 windows m_pad[b, pos : pos + 256] as
(B, MC, 256).  On a CPU tensor it runs gather_windows_plain; on a CUDA
tensor it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from . import _cuda

WINDOW_PAD = 256   # emitted window width (241 used)


def _check(m_pad: torch.Tensor, pos: torch.Tensor) -> None:
    if m_pad.dtype != torch.uint16 or m_pad.dim() != 2:
        raise TypeError(f"m_pad must be uint16 (B, S_pad), got {m_pad.dtype} {tuple(m_pad.shape)}")
    if pos.dtype != torch.int32 or pos.dim() != 2 or pos.shape[0] != m_pad.shape[0]:
        raise TypeError(f"pos must be int32 (B, MC), got {pos.dtype} {tuple(pos.shape)}")
    if m_pad.shape[1] < WINDOW_PAD:
        raise ValueError(f"rows of {m_pad.shape[1]} samples cannot hold a {WINDOW_PAD}-sample window")
    if not (m_pad.is_contiguous() and pos.is_contiguous()):
        raise ValueError("gather_windows needs contiguous m_pad and pos")
    if m_pad.device != pos.device:
        raise ValueError(f"m_pad on {m_pad.device} but pos on {pos.device}")


def gather_windows_plain(m_pad: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Plain version with gather_windows_xla semantics: one flat slice per
    window, the start clamped so the window stays inside its row.  The
    rows are indexed through an int16 view (uint16 is a storage type)."""
    _check(m_pad, pos)
    b, s_pad = m_pad.shape
    dev = m_pad.device
    start = pos.to(torch.int64).clamp(0, s_pad - WINDOW_PAD)
    start += (torch.arange(b, device=dev) * s_pad)[:, None]
    idx = start[..., None] + torch.arange(WINDOW_PAD, device=dev)
    return m_pad.view(torch.int16).reshape(-1)[idx].view(torch.uint16)


def gather_windows(m_pad: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """(B, MC, 256) uint16 windows: the kernel on CUDA, the plain version on
    the CPU."""
    _check(m_pad, pos)
    if m_pad.device.type == "cpu":
        return gather_windows_plain(m_pad, pos)
    if m_pad.device.type != "cuda":
        raise ValueError(f"gather_windows runs on cuda or cpu, not {m_pad.device}")
    b, s_pad = m_pad.shape
    mc = pos.shape[1]
    out = torch.empty((b, mc, WINDOW_PAD), dtype=torch.uint16, device=m_pad.device)
    if out.numel() == 0:
        return out
    lib = _cuda.library()
    with torch.cuda.device(m_pad.device):  # the launch goes to the current device
        err = lib.gather_windows(
            m_pad.data_ptr(), pos.data_ptr(), out.data_ptr(), b, s_pad, mc,
            _cuda.current_stream(m_pad.device),
        )
    _cuda.launches["gather_windows"] += 1
    _cuda.check(err, "gather_windows")
    return out
