"""Multi-device demodulation: a timeline sharded over a (dp, sp) mesh of
devices, with an overlap-save halo exchange (port of
dump1090_tpu/parallel/sharding.py).

The reference is strictly single-core; its only "parallel" concept is the
476-byte carry that lets a frame straddle two sequential reads
(dump1090.c:326-331, 447-451).  Sharded over devices, the same overlap-save
idea becomes a halo exchange: each row of magnitudes is split over the
mesh's "sp" axis, each shard's first 240 samples travel to its left
neighbour and its last sample to its right one, so every scan position is
owned by exactly one shard and every candidate window (240 samples + 1
leading sample for phase correction) is local.  Rows (reference buffers)
are split over the "dp" axis.

What stands in for the JAX package's shard_map and lax.ppermute:

  * a Mesh is a (dp, sp) grid of torch devices held by one process, and an
    entry may repeat (several shards on one card, or all on the CPU); each
    shard's body runs on its own device, and the launches are asynchronous,
    so shards on different cards overlap;
  * a halo between two shards of one process is Tensor.to(neighbour's
    device, non_blocking=True): a peer copy between cards, or the slice
    itself when both shards share a device;
  * a mesh built by multihost.global_mesh spans processes; a halo whose two
    shards live in different processes goes through
    torch.distributed.batch_isend_irecv, and the callable's result is
    all-gathered so every process holds the global candidates.

The sequential skip/ICAO replay is global: api.decode_capture_sharded runs
it over the gathered candidates (ops.resolve.resolve_candidate_segments on
the device, or the host resolver over merge_sharded_rows), so shard
boundaries never lose or duplicate a message.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from ..constants import BLOCK_SAMPLES, BUF_SAMPLES, FULL_LEN_SAMPLES
from ..ops.demod import (  # noqa: F401  (demod_batch: the batch-sharded form's counterpart)
    Candidates,
    candidate_passes_window,
    compact_positions,
    demod_batch,
    preamble_mask,
)
from ..ops.gather import WINDOW_PAD, gather_windows
from ..ops.magnitude import magnitude_from_iq

HALO = FULL_LEN_SAMPLES  # 240 samples from the right neighbour
EMPTY_POS = 2**30        # the global position of an empty candidate slot


def overlapping_buffers(iq: np.ndarray) -> np.ndarray:
    """View a flat IQ byte stream as (n_buffers, BUF_SAMPLES*2) overlapping
    reference-geometry buffers without copying (the 476-byte carry becomes a
    strided overlap).  The stream must start with the 476-byte initial
    silence region (callers prepend 127s)."""
    buf_bytes = BUF_SAMPLES * 2
    step = BLOCK_SAMPLES * 2
    n = (len(iq) - buf_bytes) // step + 1
    if n <= 0:
        raise ValueError("capture shorter than one buffer")
    return np.lib.stride_tricks.as_strided(
        iq, shape=(n, buf_bytes), strides=(step, 1), writeable=False
    )


class Mesh:
    """A (dp, sp) grid of torch devices, the counterpart of a JAX Mesh with
    ("dp", "sp") axes.  Entries may repeat.  `ranks` names the process that
    holds each shard (all `rank` by default: a one-process mesh); `rank` is
    this process's."""

    def __init__(self, devices, *, ranks=None, rank: int = 0):
        grid = [[torch.device(d) for d in row] for row in devices]
        if not grid or not grid[0] or any(len(row) != len(grid[0]) for row in grid):
            raise ValueError("a mesh is a non-empty (dp, sp) grid of devices")
        if ranks is None:
            ranks = [[rank] * len(row) for row in grid]
        ranks = [[int(r) for r in row] for row in ranks]
        if [len(row) for row in ranks] != [len(row) for row in grid]:
            raise ValueError("ranks must have the mesh's (dp, sp) shape")
        self.devices = grid
        self.ranks = ranks
        self.rank = rank
        self.shape = {"dp": len(grid), "sp": len(grid[0])}

    def local(self) -> list:
        """(d, s) of every shard this process holds, in mesh order."""
        return [(d, s) for d, row in enumerate(self.ranks) for s, r in enumerate(row)
                if r == self.rank]

    @property
    def multiprocess(self) -> bool:
        return any(r != self.rank for row in self.ranks for r in row)

    @property
    def out_device(self) -> torch.device:
        """Where the gathered candidates land: the first device of the mesh
        that this process holds (devices[0][0] in one process)."""
        d, s = self.local()[0]
        return self.devices[d][s]

    def __repr__(self) -> str:
        return f"Mesh(shape={self.shape}, devices={self.devices}, ranks={self.ranks})"


def device_mesh(sp: int | None = None, device: str | torch.device | None = None) -> Mesh:
    """The default mesh of decode_capture_sharded and --tpu-shard-time, as
    in the JAX package: dp = devices // sp over the first dp*sp devices.
    On CUDA the devices are the visible cards, and fewer than sp raise; on
    the CPU, which stands in for JAX's virtual CPU devices, the mesh is
    (1, sp) of the CPU.  An explicit Mesh that repeats one card runs sp > 1
    on one card."""
    from .. import resolve_device

    dev = resolve_device(device)
    if sp is not None and sp < 1:
        raise ValueError(f"a time-sharded decode needs sp >= 1, got {sp}")
    if dev.type == "cpu":
        return Mesh([[dev] * (sp or 1)])
    n = torch.cuda.device_count()
    sp = sp or n
    if sp > n:
        raise ValueError(
            f"a time-sharded decode over {sp} shards needs {sp} CUDA devices, "
            f"but {n} {'is' if n == 1 else 'are'} visible (an explicit Mesh may "
            f"repeat a card)"
        )
    dp = n // sp
    return Mesh([[torch.device("cuda", d * sp + s) for s in range(sp)] for d in range(dp)])


class Sharded(NamedTuple):
    """This process's shards of a (B, sp*width) array on a mesh: blocks[(d,
    s)] is rows [d*rows, (d+1)*rows) and columns [s*width, (s+1)*width) on
    mesh.devices[d][s]."""

    blocks: dict
    rows: int


def _to_device(a, dev: torch.device) -> torch.Tensor:
    """A host or device block on `dev`, contiguous; host blocks go to a
    card through pinned memory with a non-blocking copy."""
    if isinstance(a, np.ndarray):
        t = torch.from_numpy(np.ascontiguousarray(a))
        if dev.type == "cuda":
            return t.pin_memory().to(dev, non_blocking=True)
        return t
    return a.to(dev, non_blocking=True).contiguous()


def place(x, mesh: Mesh, width: int) -> Sharded:
    """Split a global (B, sp*width) array (numpy or tensor) into this
    process's shards, each on its device."""
    dp, sp = mesh.shape["dp"], mesh.shape["sp"]
    if x.ndim != 2 or x.shape[0] % dp or x.shape[1] != sp * width:
        raise ValueError(
            f"expected a ({dp}*rows, {sp}*{width}) array for this mesh, got {tuple(x.shape)}"
        )
    rows = x.shape[0] // dp
    return Sharded({
        (d, s): _to_device(x[d * rows:(d + 1) * rows, s * width:(s + 1) * width],
                           mesh.devices[d][s])
        for d, s in mesh.local()
    }, rows)


def _comm_device(dev: torch.device) -> torch.device:
    """The device a torch.distributed transfer runs from: the shard's card
    under NCCL, the host under gloo."""
    return dev if dist.get_backend() == "nccl" else torch.device("cpu")


def _extended_rows(mags: dict, tails: dict, mesh: Mesh, rows: int) -> dict:
    """Every local shard's extended row [left halo (1) | own T | right halo
    (240)].  The ring wraps as in the JAX package: shard 0's left halo is
    silence (like the reference's initial 127-filled carry region) and the
    last shard's right halo is the row's real post-scan tail."""
    sp = mesh.shape["sp"]
    left, right, ops, recv = {}, {}, [], []
    tag = 0
    for d in range(mesh.shape["dp"]):
        for s in range(sp - 1):
            a, b = (d, s), (d, s + 1)
            # b's first HALO samples go left to a; a's last sample goes right to b
            for src, dst, cut, store in ((b, a, slice(0, HALO), right),
                                         (a, b, slice(-1, None), left)):
                if src in mags and dst in mags:
                    store[dst] = mags[src][:, cut].to(mesh.devices[dst[0]][dst[1]],
                                                      non_blocking=True)
                elif src in mags or dst in mags:
                    if src in mags:
                        t = mags[src][:, cut].contiguous()
                        t = t.to(_comm_device(t.device))
                        ops.append(dist.P2POp(dist.isend, t, mesh.ranks[dst[0]][dst[1]], tag=tag))
                    else:
                        width = HALO if store is right else 1
                        buf = torch.empty((rows, width), dtype=torch.int32,
                                          device=_comm_device(mesh.devices[dst[0]][dst[1]]))
                        ops.append(dist.P2POp(dist.irecv, buf, mesh.ranks[src[0]][src[1]], tag=tag))
                        recv.append((store, dst, buf))
                tag += 1
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        for store, dst, buf in recv:
            store[dst] = buf.to(mesh.devices[dst[0]][dst[1]])
    ext = {}
    for (d, s), m in mags.items():
        lh = torch.zeros((rows, 1), dtype=torch.int32, device=m.device) if s == 0 else left[(d, s)]
        rh = tails[d] if s == sp - 1 else right[(d, s)]
        ext[(d, s)] = torch.cat([lh, m, rh], dim=1)
    return ext


def _shard_demod_body(m_ext: torch.Tensor, idx: int, scan_per_shard: int,
                      max_candidates: int, scan_total: int | None) -> Candidates:
    """Per-shard body: scans the owned positions [idx*T, (idx+1)*T) of every
    row of int32 m_ext (B, 1+T+240), clipped to scan_total when given, and
    returns the shard's candidates with stream-global positions
    (EMPTY_POS in empty slots): n (B,), fields (B, mc, ...)."""
    t = scan_per_shard
    b = m_ext.shape[0]
    dev = m_ext.device
    mask = preamble_mask(m_ext[:, 1:], t)
    if scan_total is not None:
        # positions past the true scan range (timeline padding) are not
        # scan positions: masked out of counts and compaction
        owned = idx * t + torch.arange(t, dtype=torch.int32, device=dev)
        mask = mask & (owned < scan_total)
    n = mask.sum(dim=1, dtype=torch.int32)
    pos = compact_positions(mask, max_candidates, t)
    # K1 reads m_pad[pos : pos+256] and clamps a start past S_pad - 256, so
    # the row is zero-padded to T + 256 (rounded to 1024): window index 0
    # is m_ext[pos] = m[pos-1], the left halo at pos 0
    s_pad = -(-(t + WINDOW_PAD) // 1024) * 1024
    m_pad = torch.zeros((b, s_pad), dtype=torch.int16, device=dev)
    m_pad[:, : m_ext.shape[1]] = m_ext
    w = gather_windows(m_pad.view(torch.uint16), pos)
    gpos = pos + idx * t
    # the pos > 0 phase-correction rule (dump1090.c:1658-1663) applies to
    # the stream-global position: only the timeline's first sample has no
    # left neighbour
    outs = candidate_passes_window(w.reshape(b * max_candidates, -1), gpos.reshape(-1))
    outs = [o.reshape((b, max_candidates) + tuple(o.shape[1:])) for o in outs]
    gpos = torch.where(pos < t, gpos, EMPTY_POS)
    return Candidates(n, gpos, *outs)


def _collect(outs: dict, mesh: Mesh) -> Candidates:
    """The shards' candidates in the JAX package's global layout on
    mesh.out_device: n (B, sp), every field (B, sp*mc, ...).  Across
    processes every process all-gathers the others' shards first."""
    dp, sp = mesh.shape["dp"], mesh.shape["sp"]
    dev = mesh.out_device
    grid = dict(outs)
    if mesh.multiprocess:
        world = dist.get_world_size()
        owned = [[(d, s) for d in range(dp) for s in range(sp) if mesh.ranks[d][s] == r]
                 for r in range(world)]
        if len({len(o) for o in owned}) != 1:
            raise ValueError("every process of a mesh must hold as many shards")
        comm = _comm_device(dev)
        fields = []
        for f in range(len(Candidates._fields)):
            mine = torch.stack([outs[k][f].to(comm) for k in mesh.local()])
            is_bool = mine.dtype == torch.bool
            mine = mine.to(torch.uint8) if is_bool else mine
            parts = [torch.empty_like(mine) for _ in range(world)]
            dist.all_gather(parts, mine)
            fields.append([p.bool() if is_bool else p for p in parts])
        grid = {k: Candidates(*(fields[f][r][i] for f in range(len(fields))))
                for r in range(world) for i, k in enumerate(owned[r])}

    def field(f: int) -> torch.Tensor:
        def col(k):
            x = grid[k][f]
            return (x[:, None] if f == 0 else x).to(dev, non_blocking=True)

        return torch.cat([torch.cat([col((d, s)) for s in range(sp)], dim=1)
                          for d in range(dp)], dim=0)

    return Candidates(*(field(f) for f in range(len(Candidates._fields))))


def make_sharded_demod(mesh: Mesh, *, shard_samples: int, max_candidates: int = 512,
                       scan_total: int | None = None, with_tail: bool = False,
                       from_iq: bool = False):
    """Build the time-sharded demodulation over `mesh`: fn(x) or, with
    with_tail, fn(x, tail).

    x: int32 magnitudes (B, sp*shard_samples), or with from_iq raw uint8 IQ
    bytes (B, 2*sp*shard_samples), each shard computing its own magnitudes;
    a numpy array or tensor holding the whole timeline (every process takes
    its own shards from it), or the Sharded blocks of
    multihost.shard_timeline.  tail: (B, HALO) samples (or (B, 2*HALO) IQ
    bytes) of real signal following the timeline (the reference buffer's
    post-scan region), the last shard's right halo; without with_tail it is
    silence.  scan_total clips the owned scan range when the timeline is
    padded to a multiple of the shard count.

    Returns Candidates with stream-global positions in the JAX package's
    global layout on mesh.out_device: n int32 (B, sp), every field (B,
    sp*max_candidates, ...), a shard's slots a contiguous block of its row.
    Each shard's windows come from the K1 gather (ops/gather.py)."""
    width = (2 if from_iq else 1) * shard_samples

    def fn(x, tail=None) -> Candidates:
        if (tail is not None) != with_tail:
            raise TypeError("fn takes a tail exactly when built with_tail")
        sh = x if isinstance(x, Sharded) else place(x, mesh, width)
        rows, sp = sh.rows, mesh.shape["sp"]
        mags = {k: magnitude_from_iq(b) if from_iq else b.to(torch.int32)
                for k, b in sh.blocks.items()}
        tails = {}
        for d, s in sh.blocks:
            if s != sp - 1:
                continue
            dev = mesh.devices[d][s]
            if tail is None:
                tails[d] = torch.zeros((rows, HALO), dtype=torch.int32, device=dev)
            else:
                t = _to_device(tail[d * rows:(d + 1) * rows], dev)
                tails[d] = magnitude_from_iq(t) if from_iq else t.to(torch.int32)
        ext = _extended_rows(mags, tails, mesh, rows)
        outs = {
            (d, s): _shard_demod_body(m, s, shard_samples, max_candidates, scan_total)
            for (d, s), m in ext.items()
        }
        return _collect(outs, mesh)

    return fn


def _host(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def merge_sharded_rows(cand: Candidates, scan_total: int):
    """Multi-row form of merge_sharded_candidates: host-side merge of every
    channel row's per-shard candidates, in row order.  Returns a list of
    (n_candidates, BlockCandidates), one per row."""
    cand = Candidates(*(_host(f) for f in cand))
    return [merge_sharded_candidates(cand, scan_total, row=r) for r in range(cand.n.shape[0])]


def merge_sharded_candidates(cand: Candidates, scan_total: int, row: int = 0):
    """Host-side merge of one channel row's per-shard candidate arrays into a
    single ascending position-ordered stream for the resolver.

    Returns (n_candidates, BlockCandidates).  Raises OverflowError on a
    shard's overflow, like BlockCandidates.from_device."""
    from ..models.resolver import BlockCandidates

    n_arr = _host(cand.n)[row]
    pos_all = _host(cand.pos)
    max_c = pos_all.shape[1] // n_arr.shape[0]
    if (n_arr > max_c).any():
        raise OverflowError(
            f"candidate overflow: shard reported {int(n_arr.max())} preambles "
            f"> max_candidates {max_c}"
        )
    pos = pos_all[row]
    valid = pos < scan_total
    order = np.argsort(pos[valid], kind="stable")

    def pick(x):
        return _host(x)[row][valid][order]

    return int(n_arr.sum()), BlockCandidates(
        pos=pos[valid][order],
        msg1=pick(cand.msg1),
        errors1=pick(cand.errors1),
        gate1=pick(cand.gate1),
        msg2=pick(cand.msg2),
        errors2=pick(cand.errors2),
        gate2=pick(cand.gate2),
    )
