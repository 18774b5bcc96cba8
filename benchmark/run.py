"""The benchmark of dump1090_tpu_torch: one run of one cell, one process.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  It reads the cell from BENCHMARK.json, makes
its air from the seed, builds and warms the program, measures for the
given seconds, checks every output against the plain reference
(benchmark/reference/), and prints one JSON line last on standard output:
correct, attempted, failed, the cell's end-to-end metrics (--trace 0) or
per-layer metrics (--trace 1), the device, and the numbers compared with
their limits.  It exits non-zero with no result when no card is present,
when fewer cards than the cell asks for are present, or when the
process has loaded JAX or the JAX package.
"""

from __future__ import annotations

import time

_T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

# top-level module names that no run may load: JAX and the JAX package
# (compared whole: the port's own name begins with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "dump1090_tpu")


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def execute(cell, t_start: float, root=None):
    """Prepare, measure, check and read one cell; returns (the result
    line's object, the verdict, the run's record)."""
    import torch

    from benchmark import spec

    kw = {} if root is None else {"root": root}
    runner = spec.runner(cell.config["runner"], **kw)
    run = runner.prepare(cell)
    runner.measure(run)
    run.setup_s = run.t0 - t_start
    on_card = cell.device == "cuda"
    run.device_kind = torch.cuda.get_device_name(0) if on_card else "cpu"
    run.memory_peak_bytes = int(torch.cuda.max_memory_allocated()) if on_card else 0
    found = forbidden_modules()
    if found:
        raise SystemExit(f"benchmark: the process loaded {', '.join(found)}; no result")
    runner.release(run)
    verdict = runner.check(run)
    metrics = {}
    for m in (cell.per_layer if cell.trace else cell.end_to_end):
        value = spec.metric_reader(m["name"], **kw)(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    device = {"platform": "gpu" if on_card else "cpu", "kind": run.device_kind,
              "count": cell.chips, "memory_peak_bytes": run.memory_peak_bytes}
    result = {"correct": verdict.correct, "attempted": verdict.attempted,
              "failed": verdict.failed, "metrics": metrics, "device": device}
    if cell.trace and run.trace is not None:
        device["busy_s"] = run.trace.busy_s
        device["window_s"] = run.trace.window_s
        result["breakdown"] = {"device_ops": run.trace.device_ops,
                               "idle_gaps": run.trace.idle_gaps}
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in verdict.checks}
    return result, verdict, run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from benchmark import spec

    cell = spec.cell(args.workload, seed=args.seed, seconds=args.seconds, trace=bool(args.trace))
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        sys.stderr.write(f"benchmark: {cell.name} needs {cell.chips} CUDA card(s); "
                         f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} "
                         "available; no result\n")
        return 2
    result, verdict, run = execute(cell, _T_START)
    found = forbidden_modules()
    if found:
        sys.stderr.write(f"benchmark: the process loaded {', '.join(found)}; no result\n")
        return 3
    if "shapes" in run.extra:
        sys.stderr.write(f"shapes: {run.shapes}\n")
    for line in run.extra.get("diag", ()):
        sys.stderr.write(f"{line}\n")
    for note in verdict.notes:
        sys.stderr.write(f"check: {note}\n")
    for c in verdict.checks:
        sys.stderr.write(f"check {c.name}: {c.value} (limit {c.limit})\n")
    sys.stdout.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
