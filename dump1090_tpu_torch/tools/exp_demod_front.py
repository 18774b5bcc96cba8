"""A/B of the demod front's formulations (magnitudes -> exact preamble
count n and first-K positions pos), a port of tools/exp_demod_front.py.

    python -m dump1090_tpu_torch.tools.exp_demod_front --check [--time]
        [--device cuda] [--input FILE] [--nb 128] [--mc 256] [--loops 16]

The variants are the production fronts of ops/demod.py (front_candidates),
named as in the JAX tool:
  v0  "mask"              preamble_mask + compact_positions
  v1  "packed-plain"      one predicate evaluation packed into group bytes
  v2  "packed-plain-mxu"  v1 with the bytes packed by a product
  v3  "packed"            v1 with the shared pairwise compares and maxima
  v4  "packed-mxu"        v3 with the product pack

--check: every variant bit-identical to v0 on the air (tools/air.py's
load_batch tiling) and on 8 rows of uniform noise (seed 7; the padded tail
and the empty-group paths).  --time: each variant `--loops` times on the
air's magnitudes, both outputs consumed, by CUDA events (ms a batch).
Prints its lines, then one JSON line with the device (the card's name,
count and power limit).  --device cpu runs the logic on the CPU; with no
card and no --device cpu the tool raises.
"""

from __future__ import annotations

import argparse
import json

import torch

from . import air
from .bench import SCAN_LEN, best_per_call, device_record

VARIANTS = {"v0": "mask", "v1": "packed-plain", "v2": "packed-plain-mxu", "v3": "packed",
            "v4": "packed-mxu"}


def run_variant(name: str, m: torch.Tensor, mc: int):
    """(n, pos) of variant `name` over int32 magnitudes m (B, S)."""
    from ..ops.demod import front_candidates

    return front_candidates(m, SCAN_LEN, mc, VARIANTS[name])


def main(argv=None) -> int:
    from .. import resolve_device
    from ..ops.magnitude import magnitude_from_iq

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--time", action="store_true")
    ap.add_argument("--nb", type=int, default=128)
    ap.add_argument("--mc", type=int, default=256)
    ap.add_argument("--loops", type=int, default=16)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; no card is an error) or cpu")
    ap.add_argument("--input", default=None,
                    help="uint8 IQ capture (default: the planted dense air)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    iq = air.load_batch(air.stream(args.input), args.nb)
    d_iq = torch.from_numpy(iq).to(dev)
    d_noise = torch.from_numpy(air.noise_rows(iq)).to(dev)
    m = magnitude_from_iq(d_iq)
    rec = {"tool": "exp_demod_front", "device": device_record(dev), "nb": args.nb,
           "mc": args.mc}

    if args.check:
        mn = magnitude_from_iq(d_noise)
        ref = None
        for name in VARIANTS:
            got = run_variant(name, m, args.mc) + run_variant(name, mn, args.mc)
            if ref is None:
                ref = got
                print(f"{name}: baseline  n.sum={int(got[0].sum())}")
                rec["preambles"] = int(got[0].sum())
                continue
            for a, b in zip(ref, got):
                if not torch.equal(a, b):
                    raise AssertionError(f"{name} ({VARIANTS[name]}) differs from v0")
            print(f"{name}: bit-identical to v0 (traffic + noise)")
        rec["check"] = "bit-identical"

    if args.time:
        rec["ms_per_batch"] = {}
        for name in VARIANTS:
            def run(name=name):
                acc = torch.zeros((), dtype=torch.int64, device=dev)
                for _ in range(args.loops):
                    n, pos = run_variant(name, m, args.mc)
                    acc = acc + n.sum() + pos.sum()  # consume both outputs
                return acc

            dt = best_per_call(run, dev, args.loops, trials=1)
            rec["ms_per_batch"][name] = dt * 1e3
            print(f"{name} ({VARIANTS[name]}): {dt * 1e3:.3f} ms/batch (nb={args.nb}, "
                  f"mc={args.mc})")
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
