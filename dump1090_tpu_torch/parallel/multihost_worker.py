"""One process of a multi-process time-sharded demodulation (port of the JAX
package's tools/multihost_worker.py).

    python -m dump1090_tpu_torch.parallel.multihost_worker <rank> <world> <port>
        [--devices-per-proc N] [--dp N] [--sp N] [--total 131072]
        [--bench] [--steps 8] [--device cuda|cpu]

Each process joins a torch.distributed session at localhost:<port> (NCCL on
cuda, gloo on the CPU), holds N shards of a global (dp, sp) mesh
(--devices-per-proc, or its older name --local-shards;
multihost.global_mesh: rank-major, so with dp = 1 the time axis crosses
the process boundary), contributes its own block of the magnitude timeline
(multihost.shard_timeline) and runs the time-sharded demodulation
(parallel/sharding.py); halos between processes travel as point-to-point
transfers.  The timeline is the first buffer of the capture that
$DUMP1090_FIXTURE names (default reference/testfiles/modes1.bin at the
repository's root) when that file exists, else the first buffer of a
seeded dense synthetic capture (utils/synth.py planted_capture), tiled to
--total samples (cut to a multiple of sp).

Rank 0 checks the all-gathered candidates against an unsharded scan of the
same timeline and prints `MULTIHOST PASS ...` (or FAIL, exit 1).  With
--bench every process runs the sharded step once to warm up, then --steps
times, each step ending in a device synchronize (cuda) and a barrier
across the processes, and rank 0 prints `MULTIHOST BENCH <seconds> s/step
total=<samples> sp=<sp> nproc=<world>`.
"""

from __future__ import annotations

import argparse
import io
import os
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

REFERENCE_CAPTURE = Path(__file__).resolve().parents[2] / "reference" / "testfiles" / "modes1.bin"


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("rank", type=int)
    ap.add_argument("world", type=int)
    ap.add_argument("port")
    ap.add_argument("--devices-per-proc", "--local-shards", dest="local_shards", type=int,
                    default=None,
                    help="shards this process holds (default: every visible card; on cpu "
                         "dp*sp / world when --sp is given, else 1)")
    ap.add_argument("--sp", type=int, default=None)
    ap.add_argument("--dp", type=int, default=1)
    ap.add_argument("--total", type=int, default=131072,
                    help="timeline samples, cut to a multiple of sp")
    ap.add_argument("--bench", action="store_true",
                    help="time the sharded step; rank 0 prints MULTIHOST BENCH")
    ap.add_argument("--steps", type=int, default=8, help="timed steps of --bench")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(args.port),
                      WORLD_SIZE=str(args.world), RANK=str(args.rank))
    from ..constants import FULL_LEN_SAMPLES
    from ..io.sources import iq_buffers
    from ..ops.demod import demod_block
    from ..ops.magnitude import magnitude_from_iq
    from ..utils.synth import planted_capture
    from . import multihost
    from .sharding import make_sharded_demod, merge_sharded_candidates, place

    started = multihost.initialize_from_env(args.device)
    if started != (args.world > 1):
        raise SystemExit("torch.distributed did not start as the world size asks")
    mesh = multihost.global_mesh(dp=args.dp, sp=args.sp, device=args.device,
                                 local_shards=args.local_shards)
    dp, sp = mesh.shape["dp"], mesh.shape["sp"]
    dev = mesh.out_device

    # the same input in every process; each contributes only its shards
    fixture = Path(os.environ.get("DUMP1090_FIXTURE", REFERENCE_CAPTURE))
    if fixture.is_file():
        with open(fixture, "rb") as f:
            buf = next(iq_buffers(f))
    else:
        data, _ = planted_capture(1, 150, seed=1)
        buf = next(iq_buffers(io.BytesIO(data)))
    m_full = magnitude_from_iq(torch.from_numpy(buf)).numpy()
    shard = args.total // sp
    total = sp * shard
    base = np.tile(m_full, 1 + total // len(m_full))[:total]
    m = np.tile(base[None, :], (dp, 1))

    if dp == 1 and args.world > 1:
        # the time axis runs across the processes in rank order: process p
        # contributes exactly its columns (the multi-process input path)
        cols = total // args.world
        local = np.ascontiguousarray(m[:, args.rank * cols:(args.rank + 1) * cols])
        x = multihost.shard_timeline(local, mesh)
    else:
        # every process has the whole input and takes its own shards
        x = place(m, mesh, shard)

    fn = make_sharded_demod(mesh, shard_samples=shard, max_candidates=128)
    cand = fn(x)

    ok = True
    if args.rank == 0:
        n, merged = merge_sharded_candidates(cand, scan_total=total)
        ext = np.concatenate([m[0], np.zeros(FULL_LEN_SAMPLES, np.int32)])
        ref = demod_block(torch.from_numpy(ext).to(dev), scan_len=total, max_candidates=1024)
        ref = [f.cpu().numpy() for f in ref]
        nref = int(ref[0])
        ok = (
            n == nref
            and list(merged.pos) == list(ref[1][:nref])
            and np.array_equal(merged.msg1, ref[2][:nref])
            and np.array_equal(merged.msg2, ref[5][:nref])
        )
        print(f"MULTIHOST {'PASS' if ok else 'FAIL'}: {args.world} processes x "
              f"{len(mesh.local())} shards, mesh dp={dp} sp={sp} on {args.device}, "
              f"{n} candidates == unsharded {nref}", flush=True)

    if args.bench:
        cards = {mesh.devices[d][s] for d, s in mesh.local()} if args.device == "cuda" else ()

        def step():
            fn(x)
            for card in cards:
                torch.cuda.synchronize(card)
            if started:
                dist.barrier()

        step()
        t0 = time.perf_counter()
        for _ in range(args.steps):
            step()
        dt = (time.perf_counter() - t0) / args.steps
        if args.rank == 0:
            print(f"MULTIHOST BENCH {dt:.6f} s/step total={total} sp={sp} "
                  f"nproc={args.world}", flush=True)

    if started:
        dist.destroy_process_group()
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
