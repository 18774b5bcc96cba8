"""Decode state carried between the JAX package and the port.

There are no weights: what a decode carries forward is the ICAO address
cache and the stat counters.  The JAX package keeps them as numpy arrays
(IcaoCache.addr uint32 and .ts int64, and the DecoderStats counters);
state_from_numpy turns those into the port's form on a device, and
state_to_numpy turns it back.  DemodPipeline.load_state / .state hand the
state to and from a pipeline; cache_to_device / cache_from_device convert
the cache alone, as the device paths chain it.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..constants import ICAO_CACHE_LEN
from .decoder import STAT_FIELDS


@dataclass
class DecodeState:
    cache_addr: torch.Tensor  # int32 (1024,): ICAO addresses (24-bit)
    cache_ts: torch.Tensor    # int32 (1024,): unix seconds of each entry
    stats: torch.Tensor       # int64 (8,): counters in STAT_FIELDS order


def state_from_numpy(cache_addr, cache_ts, stats, device) -> DecodeState:
    """(IcaoCache.addr, IcaoCache.ts, the 8 counters) -> DecodeState on
    `device`.  `stats` is a DecoderStats or a sequence of 8 ints in
    DecoderStats order.  Timestamps are clipped to int32 like the device
    path of both packages."""
    addr = np.asarray(cache_addr)
    ts = np.asarray(cache_ts)
    if addr.shape != (ICAO_CACHE_LEN,) or ts.shape != (ICAO_CACHE_LEN,):
        raise ValueError(f"the ICAO cache has {ICAO_CACHE_LEN} slots")
    if not isinstance(stats, (list, tuple, np.ndarray)):
        stats = [getattr(stats, k) for k in STAT_FIELDS]
    counts = np.asarray(stats, dtype=np.int64)
    if counts.shape != (len(STAT_FIELDS),):
        raise ValueError(f"expected {len(STAT_FIELDS)} counters, got {counts.shape}")
    addr_d, ts_d = cache_to_device(addr, ts, device)
    return DecodeState(cache_addr=addr_d, cache_ts=ts_d,
                       stats=torch.as_tensor(counts, device=device))


def state_to_numpy(state: DecodeState) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """DecodeState -> (addr uint32 (1024,), ts int64 (1024,), stats int64
    (8,)): the JAX package's IcaoCache array types."""
    return (*cache_from_device(state.cache_addr, state.cache_ts),
            state.stats.cpu().numpy().astype(np.int64))


def cache_to_device(addr, ts, device) -> tuple[torch.Tensor, torch.Tensor]:
    """IcaoCache arrays -> the device paths' int32 tensors on `device`."""
    return (torch.as_tensor(np.asarray(addr).astype(np.int64).astype(np.int32), device=device),
            torch.as_tensor(np.clip(ts, 0, 2**31 - 1).astype(np.int32), device=device))


def cache_from_device(addr: torch.Tensor, ts: torch.Tensor) -> tuple[np.ndarray, np.ndarray]:
    """The device paths' cache tensors -> IcaoCache arrays."""
    return addr.cpu().numpy().astype(np.uint32), ts.cpu().numpy().astype(np.int64)
