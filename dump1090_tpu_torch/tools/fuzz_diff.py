"""Differential fuzzing on the card: random IQ streams decoded on `--device`
and on the CPU by the same mode of the port, and, with `--ref`, by an
oracle that speaks the reference's CLI; any difference is a finding (a
port of tools/fuzz_diff.py).  The CPU oracle is the port's own CPU run,
which tests/test_torch_*.py hold bit for bit against the JAX package.

Stream recipes mix the hard cases: pure noise at a random level (0),
uniform garbage with saturated samples (1), and a noise floor with
planted DF17 frames at random SNR and carrier phase (2, 3), clustered
tightly, which stresses the skip rule and cuts the resolver's settled
batches (4), or straddling a buffer boundary, across the 476-byte carry
(5).  Streams are 1-3 whole 256 KiB buffers.  For the same seed,
random_stream gives the bytes of the JAX tool's.

    python -m dump1090_tpu_torch.tools.fuzz_diff [--n 50] [--seed 0]
        [--mode raw|nofix|aggressive|verbose|device|device-nofix|
                device-aggressive|device-verbose|sharded|sharded-device ...]
        [--device cuda] [--ref CMD] [--out DIR]

The first six streams take recipes 0-5 (each from its own generator), and
the seed's streams, the JAX tool's, follow.  --ref CMD (the reference
binary, or any command line that speaks its CLI, see refbuild.py) decodes
each stream with the JAX tool's flags for the mode (decode_ref) from a
file, and each mode's output must equal that too.

Exit 0 when every stream's output in every mode equals the CPU's (and the
oracle's) and at least one line was compared; a failing stream is saved
under --out.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import os
import subprocess
import sys
import tempfile
from collections import Counter
from pathlib import Path

import numpy as np
import torch

from ..constants import DATA_LEN_BYTES

RECIPES = 6
REPO = Path(__file__).resolve().parents[2]
MODES = ("raw", "nofix", "aggressive", "verbose", "device", "device-nofix",
         "device-aggressive", "device-verbose", "sharded", "sharded-device")


def _random_stream(rng: np.random.Generator, recipe: int | None = None) -> tuple[int, np.ndarray]:
    """(recipe, stream), with the draws of the JAX tool's random_stream; a
    given `recipe` overrides the drawn one (and so changes the draws that
    follow)."""
    from ..utils.synth import frame_to_iq, make_df17_frame

    drawn = int(rng.integers(0, RECIPES))
    recipe = drawn if recipe is None else recipe
    n = int(rng.integers(1, 4)) * DATA_LEN_BYTES
    if recipe == 0:  # pure noise, random level
        sigma = float(rng.uniform(1, 40))
        s = 127 + rng.normal(0, sigma, n)
    elif recipe == 1:  # uniform garbage (includes saturation)
        s = rng.integers(0, 256, n)
    else:  # noise floor + planted frames
        sigma = float(rng.uniform(2, 15))
        s = 127 + rng.normal(0, sigma, n)
        n_frames = int(rng.integers(1, 60))
        for _ in range(n_frames):
            f = make_df17_frame(
                addr=int(rng.integers(1, 1 << 24)),
                metype=int(rng.integers(1, 23)),
                mesub=int(rng.integers(0, 8)),
                me_payload=rng.integers(0, 256, 6, dtype=np.uint8).tobytes(),
            )
            amp = float(rng.uniform(sigma * 1.5, 120))
            iq = frame_to_iq(
                f, amplitude=amp, noise_sigma=0.0,
                phase=float(rng.uniform(0, 2 * np.pi)),
                pad_before=0, pad_after=0, rng=rng,
            ).astype(np.float64) - 127
            if recipe == 4:  # cluster frames tightly (skip-rule stress)
                at = int(rng.integers(0, max(1, n // 4))) * 2
            elif recipe == 5:  # straddle a buffer boundary
                b = int(rng.integers(1, n // DATA_LEN_BYTES + 1)) * DATA_LEN_BYTES
                at = b - int(rng.integers(1, len(iq))) // 2 * 2
            else:
                at = int(rng.integers(0, n - len(iq))) // 2 * 2
            at = max(0, min(at, n - len(iq)))
            s[at : at + len(iq)] += iq  # superpose on the noise floor
    return recipe, np.clip(s, 0, 255).astype(np.uint8)


def random_stream(rng: np.random.Generator) -> np.ndarray:
    """One random stream of whole buffers, the JAX tool's for the same
    generator state."""
    return _random_stream(rng)[1]


def streams(n: int, seed: int):
    """(recipe, stream) of `n` streams from `seed`: streams 0-5 with
    recipes 0-5, each drawn from its own generator (seed, k), then the JAX
    tool's streams 0, 1, ... of the seed."""
    rng = np.random.default_rng(seed)
    for k in range(n):
        if k < RECIPES:
            yield _random_stream(np.random.default_rng([seed, k]), k)
        else:
            yield _random_stream(rng)


def _cli_lines(argv: list, in_process: bool) -> list[str]:
    """stdout lines of the port's CLI: `python -m dump1090_tpu_torch` in a
    subprocess, or cli.main in this process (where the kernels' launch
    counters see it).  In process, the signal handlers cli.main installs
    are put back: left at SIG_DFL, SIGPIPE would kill this process at its
    next write to a closed socket."""
    if in_process:
        import signal

        from .. import cli

        out = io.StringIO()
        saved = {s: signal.getsignal(s) for s in (signal.SIGPIPE, signal.SIGWINCH)}
        try:
            with contextlib.redirect_stdout(out):
                rc = cli.main(argv)
        finally:
            for s, h in saved.items():
                signal.signal(s, h)
        if rc != 0:
            raise RuntimeError(f"cli.main({argv}) returned {rc}")
        return out.getvalue().splitlines()
    r = subprocess.run([sys.executable, "-m", "dump1090_tpu_torch", *argv], cwd=REPO,
                       capture_output=True, text=True, timeout=600)
    if r.returncode != 0:
        raise RuntimeError(f"python -m dump1090_tpu_torch {argv} exited {r.returncode}: "
                           f"{r.stderr[-2000:]}")
    return r.stdout.splitlines()


def decode_ours(stream: np.ndarray, mode: str, device="cuda", *,
                in_process: bool = False) -> list[str]:
    """The port's output for one stream in one mode on `device`: `*hex;`
    lines of the crcok messages, or for the verbose modes the CLI's whole
    display (device-verbose: the device resolver feeding the hub)."""
    from ..models.decoder import DecoderConfig
    from ..models.pipeline import DemodPipeline, PipelineConfig

    device = torch.device(device)
    if mode.endswith("verbose"):
        with tempfile.NamedTemporaryFile(suffix=".bin") as tf:
            stream.tofile(tf.name)
            return _cli_lines(
                ["--device", device.type, "--ifile", tf.name, "--tpu-device-resolve",
                 "on" if mode.startswith("device") else "off"], in_process)

    cfg = DecoderConfig(
        fix_errors=not mode.endswith("nofix"),
        aggressive=mode.endswith("aggressive"),
    )
    if mode.startswith("sharded"):
        # the time-sharded path on a (1, 4) mesh that repeats the device;
        # sharded-device also resolves the merged candidate stream there
        # (ops/resolve.py resolve_candidate_segments)
        from ..api import decode_capture_sharded
        from ..parallel.sharding import Mesh

        msgs = decode_capture_sharded(
            stream.tobytes(), mesh=Mesh([[device] * 4]), config=cfg, crcok_only=True,
            device_resolve=mode.endswith("device"),
        )
        return ["*" + m.msg[: m.msgbits // 8].hex() + ";" for m in msgs]
    p = DemodPipeline(PipelineConfig(decoder=cfg, batch_buffers=4), device=device)
    if mode.startswith("device"):
        # the resolver on the device too (ops/resolve.py)
        raw = b"".join(p.stream_raw_device(io.BytesIO(stream.tobytes())))
        return raw.decode().split()
    out = []
    p.run(
        io.BytesIO(stream.tobytes()),
        lambda m: out.append("*" + m.msg[: m.msgbits // 8].hex() + ";")
        if m.crcok
        else None,
    )
    return out


def ref_flags(mode: str) -> list[str]:
    """The reference's flags for a mode: the decoder mode's, with --raw
    unless the mode is verbose (the JAX tool's decode_ref)."""
    if mode.endswith("nofix"):
        return ["--raw", "--no-fix"]
    if mode.endswith("aggressive"):
        return ["--raw", "--aggressive"]
    return [] if mode.endswith("verbose") else ["--raw"]


def decode_ref(stream: np.ndarray, ref_cmd: list[str], mode: str) -> list[str]:
    """The oracle's output for one stream in one mode, compared as
    decode_ours gives it: the whole display for the verbose modes, else
    the `*hex;` lines."""
    with tempfile.NamedTemporaryFile(suffix=".bin") as tf:
        stream.tofile(tf.name)
        out = subprocess.run(
            [*ref_cmd, *ref_flags(mode), "--ifile", tf.name], capture_output=True, text=True,
            timeout=600, cwd=REPO,
        ).stdout
    if mode.endswith("verbose"):
        return out.splitlines()
    return [line.strip() for line in out.splitlines() if line.startswith("*")]


def fuzz(n: int, seed: int, modes, device, *, in_process: bool = False,
         out_dir: Path | None = None, around=None, ref_cmd: list[str] | None = None,
         log=print) -> dict:
    """Decode `n` random streams from `seed` (see streams) in each mode on
    `device` and on the CPU and compare; with `ref_cmd`, also with the
    oracle's decode of each stream (one run for the modes that share
    flags).  `around(mode)`, when given, is a context manager entered
    around each decode on `device`.  Returns {"streams_per_recipe",
    "lines" (compared, per mode), "fails" [(stream, mode)]}."""
    per_recipe, lines, fails = Counter(), Counter(), []
    for k, (recipe, stream) in enumerate(streams(n, seed)):
        per_recipe[recipe] += 1
        oracle = {}
        for mode in modes:
            with around(mode) if around is not None else contextlib.nullcontext():
                ours = decode_ours(stream, mode, device, in_process=in_process)
            want = decode_ours(stream, mode, "cpu", in_process=in_process)
            lines[mode] += len(want)
            ref = None
            if ref_cmd is not None:
                key = tuple(ref_flags(mode))
                if key not in oracle:
                    oracle[key] = decode_ref(stream, ref_cmd, mode)
                ref = oracle[key]
            if ours == want and ref in (None, ours):
                log(f"[{k}] {mode} ok ({len(ours)} lines, recipe {recipe}, "
                    f"{len(stream) // DATA_LEN_BYTES} buffers)")
                continue
            fails.append((k, mode))
            other, name = (want, "cpu") if ours != want else (ref, "ref")
            msg = f"[{k}] {mode} MISMATCH {device} {len(ours)} {name} {len(other)} lines"
            if out_dir is not None:
                path = Path(out_dir) / f"fuzz_fail_{seed}_{k}_{mode}.bin"
                stream.tofile(path)
                msg += f" -> {path}"
            log(msg)
            for a, b in zip(ours, other):
                if a != b:
                    log(f"    first diff: {device} {a} {name} {b}")
                    break
    return {"streams_per_recipe": {r: per_recipe[r] for r in sorted(per_recipe)},
            "lines": dict(lines), "fails": fails}


def main(argv=None) -> int:
    from .. import resolve_device
    from . import add_device_options, device_option

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=50, help="random streams")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mode", nargs="+", default=["raw"], choices=MODES,
                    help="one or more modes, each run on every stream")
    add_device_options(ap)
    ap.add_argument("--out", default=os.curdir, help="directory for failing streams")
    ap.add_argument("--ref", default=None,
                    help="also compare with this oracle (the reference binary, or a "
                    "command line that speaks its CLI)")
    args = ap.parse_args(argv)
    device = resolve_device(device_option(ap, args))
    ref_cmd = None
    if args.ref is not None:
        from .refbuild import reference_command

        ref_cmd = reference_command(args.ref)

    res = fuzz(args.n, args.seed, args.mode, device, out_dir=Path(args.out), ref_cmd=ref_cmd)
    total = sum(res["lines"].values())
    print(f"\n{args.n * len(args.mode) - len(res['fails'])}/{args.n * len(args.mode)} "
          f"stream-modes identical on {device} and the CPU"
          f"{' and the oracle' if ref_cmd else ''}, {total} lines compared, "
          f"streams per recipe {res['streams_per_recipe']}")
    if total == 0:
        print("FUZZ FAIL: vacuous run (no line decoded)")
        return 1
    return 1 if res["fails"] else 0


if __name__ == "__main__":
    sys.exit(main())
