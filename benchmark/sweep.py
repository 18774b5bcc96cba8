"""A pace sweep of a paced cell, on the card:

    python3 -m benchmark.sweep --workload feeder_net.live_dense --paces 1,1.5,2,3 --seconds 20

Each pace runs in a process of its own, as a benchmark run does, with the
cell's traffic offered that many times faster than the radio's rate; one
JSON line a pace gives the latencies, how late the feed ran (ingest lag),
the buffers lost and whether the output was correct.  Above the knee the
backlog grows all through the run.  The benchmark's runs never run this.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

_T_START = time.perf_counter()


def one(workload: str, pace: float, seed: int, seconds: float) -> dict:
    from benchmark import spec
    from benchmark.harness import percentile
    from benchmark.run import execute

    cell = spec.cell(workload, seed=seed, seconds=seconds, trace=False)
    cell.traffic["pace"] = pace
    result, verdict, run = execute(cell, _T_START)
    lat = run.latency_s
    return {"pace": pace, "correct": result["correct"], "buffers": result["attempted"],
            "failed": result["failed"],
            "latency_p50_ms": percentile(lat, 50) * 1e3, "latency_p95_ms": percentile(lat, 95) * 1e3,
            "latency_max_ms": float(lat.max()) * 1e3,
            "latency_last_tenth_ms": float(lat[-max(1, len(lat) // 10):].mean()) * 1e3,
            "ingest_lag_p95_ms": percentile(run.ingest_lag_s, 95) * 1e3,
            "checks": result["checks"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--paces", default="1,1.5,2,3")
    ap.add_argument("--seed", type=int, default=2**31 + 101)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--one", type=float, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.one is not None:
        print(json.dumps(one(args.workload, args.one, args.seed, args.seconds)), flush=True)
        return 0
    for pace in (float(p) for p in args.paces.split(",")):
        out = subprocess.run([sys.executable, "-m", "benchmark.sweep", "--workload", args.workload,
                              "--seed", str(args.seed), "--seconds", str(args.seconds),
                              "--one", str(pace)], capture_output=True, text=True)
        line = out.stdout.strip().splitlines()[-1:] or [json.dumps(
            {"pace": pace, "error": out.stderr.strip()[-400:]})]
        print(line[0], flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
