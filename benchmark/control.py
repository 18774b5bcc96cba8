"""The control of a cell's correctness check, at the cell's own size:

    python3 -m benchmark.control --workload <cell> --seeds 1,2,3 [--seconds S]

For each seed it puts the reference, with one guarantee of the
configuration broken (the phase-corrected retry left out), in the
program's place, holds what it produced to the cell's check as a run's
output is held, and prints the check's numbers and verdict, one JSON line
a seed.  It exits 1 if any seed's control comes out correct: the check
would then not tell the two apart.  The benchmark's runs never run this.
"""

from __future__ import annotations

import argparse
import json
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--seconds", type=float, default=None,
                    help="the window whose buffers the control reads (default run_seconds)")
    args = ap.parse_args(argv)

    from benchmark import spec

    seconds = args.seconds or spec.load_spec()["run_seconds"]
    passed = 0
    for seed in (int(s) for s in args.seeds.split(",")):
        cell = spec.cell(args.workload, seed=seed, seconds=seconds, trace=False)
        t = time.perf_counter()
        verdict = spec.runner(cell.config["runner"]).control(cell)
        passed += verdict.correct
        print(json.dumps({"workload": args.workload, "seed": seed, "correct": verdict.correct,
                          "attempted": verdict.attempted, "failed": verdict.failed,
                          "checks": {c.name: {"value": c.value, "limit": c.limit}
                                     for c in verdict.checks},
                          "seconds": time.perf_counter() - t}), flush=True)
    return 1 if passed else 0


if __name__ == "__main__":
    raise SystemExit(main())
