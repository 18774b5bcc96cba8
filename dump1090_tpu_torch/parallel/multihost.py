"""Multi-process entry points: torch.distributed and a global (dp, sp) mesh
(port of dump1090_tpu/parallel/multihost.py).

The timeline ("sp") and the channel batch ("dp") shard over a mesh that
spans processes exactly as over the devices of one process: halos between
two processes go through torch.distributed point-to-point transfers
(parallel/sharding.py), NCCL between cards and gloo on the CPU, and the
sharded demodulation's result is all-gathered.  This module only wires the
session up; the sharded program itself is
parallel.sharding.make_sharded_demod.  parallel/multihost_worker.py runs
one process of such a session.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from .sharding import Mesh, Sharded, place


def initialize_from_env(device: str | torch.device | None = None) -> bool:
    """Start torch.distributed when launched as one process of several.

    Reads PyTorch's own launcher variables MASTER_ADDR, MASTER_PORT,
    WORLD_SIZE and RANK (the torch names for the JAX package's
    JAX_COORDINATOR_ADDRESS, JAX_NUM_PROCESSES and JAX_PROCESS_ID).  The
    backend is NCCL for CUDA (the default) and gloo when the caller asks
    for device="cpu"; under NCCL the process takes card LOCAL_RANK (else
    RANK) modulo the visible cards.  Returns True when a multi-process
    session was started, False for a single process (no-op)."""
    world = os.environ.get("WORLD_SIZE")
    addr, port = os.environ.get("MASTER_ADDR"), os.environ.get("MASTER_PORT")
    if not world or int(world) <= 1 or not addr or not port:
        return False
    rank = int(os.environ.get("RANK", "0"))
    cpu = device is not None and torch.device(device).type == "cpu"
    if not cpu:
        from .. import resolve_device

        resolve_device(device)  # raises without a card
        local = int(os.environ.get("LOCAL_RANK", rank))
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(
        "gloo" if cpu else "nccl", init_method=f"tcp://{addr}:{port}",
        world_size=int(world), rank=rank,
    )
    return True


def global_mesh(dp: int | None = None, sp: int | None = None,
                device: str | torch.device | None = None, local_shards: int | None = None) -> Mesh:
    """A (dp, sp) mesh over the devices of every process of the session,
    rank-major as jax.devices() is process-major.  Each process holds
    `local_shards` devices, every process as many: by default every visible
    card on CUDA (more entries repeat them); on the CPU, which stands in
    for the JAX package's virtual CPU devices, dp*sp / processes entries
    when both are given, else one.  Defaults: dp = 1
    row of channels, sp = every device on the time axis.  sp may cross the
    process boundary."""
    from .. import resolve_device

    dev = resolve_device(device)
    multi = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if multi else 1
    rank = dist.get_rank() if multi else 0
    if dev.type == "cpu":
        if local_shards is None:
            local_shards = dp * sp // world if dp and sp else 1
        local = [dev] * local_shards
    else:
        cards = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        local = cards if local_shards is None else [cards[i % len(cards)]
                                                    for i in range(local_shards)]
    n = world * len(local)
    if dp is None and sp is None:
        dp, sp = 1, n
    elif dp is None:
        dp = n // sp
    elif sp is None:
        sp = n // dp
    if dp * sp != n:
        raise ValueError(f"dp*sp = {dp}*{sp} != {n} devices")
    # every process names its own devices; the others' entries are theirs
    flat = [(r, local[i]) for r in range(world) for i in range(len(local))]
    return Mesh([[flat[d * sp + s][1] for s in range(sp)] for d in range(dp)],
                ranks=[[flat[d * sp + s][0] for s in range(sp)] for d in range(dp)],
                rank=rank)


def shard_timeline(mag, mesh: Mesh) -> Sharded:
    """Place a (B, T) magnitude array onto the mesh with (dp, sp) sharding.
    In one process `mag` is the whole array, split over the mesh; across
    processes it is this process's block of it (the rows and columns of the
    shards it holds, which must form a rectangle), the counterpart of
    make_array_from_process_local_data."""
    if not mesh.multiprocess:
        sp = mesh.shape["sp"]
        if mag.shape[1] % sp:
            raise ValueError(f"a timeline of {mag.shape[1]} samples does not split into {sp} shards")
        return place(mag, mesh, mag.shape[1] // sp)
    local = mesh.local()
    rows = sorted({d for d, _ in local})
    cols = sorted({s for _, s in local})
    if len(rows) * len(cols) != len(local) or rows != list(range(rows[0], rows[-1] + 1)) \
            or cols != list(range(cols[0], cols[-1] + 1)):
        raise ValueError("this process's shards do not form a rectangle of the mesh")
    sub = Mesh([[mesh.devices[d][s] for s in cols] for d in rows])
    if mag.shape[0] % len(rows) or mag.shape[1] % len(cols):
        raise ValueError(f"a local block of {tuple(mag.shape)} does not split into "
                         f"{len(rows)} x {len(cols)} shards")
    part = place(mag, sub, mag.shape[1] // len(cols))
    return Sharded({(rows[0] + d, cols[0] + s): b for (d, s), b in part.blocks.items()},
                   part.rows)

