"""Decode rate against SNR: the port on `--device` against its own CPU run,
and against the reference binary when `--ref` resolves (a port of
tools/snr_sweep.py).

For each SNR a batch of known DF17 frames is modulated at 2 Msps with AWGN
and random carrier phase (utils/synth.py), written as a uint8 IQ stream of
whole 256 KiB buffers, and decoded by each column's decoder; the score is
the fraction of planted frames whose exact 112-bit payload comes back with
a good CRC.  Every column sees the identical bytes, so any difference is
decoder sensitivity, not luck.

    python -m dump1090_tpu_torch.tools.snr_sweep [--device cuda] [--device-resolve]
        [--frames 200] [--snrs=-2,0,2,...] [--ref CMD]

--device-resolve decodes with the resolver on the device
(DemodPipeline.run_device, kernels K1 and K2, what --raw runs on the
card); without it, the device demodulates (K1) and the host resolves
(DemodPipeline.run).  The CPU column takes the same path.  Output: one
markdown table on stdout.  Exit 1 if any point's exact set of recovered
planted frames differs between columns.
"""

from __future__ import annotations

import argparse
import io
import subprocess
import sys
import tempfile

import numpy as np
import torch


def build_stream(snr_db: float, n_frames: int, rng) -> tuple[np.ndarray, list[str]]:
    """(uint8 IQ stream, planted frames' hex): the JAX tool's bytes for the
    same generator state."""
    from ..utils.synth import frame_to_iq, make_df17_frame

    noise_sigma = 10.0
    amplitude = noise_sigma * (10 ** (snr_db / 20.0))
    spacing = 2000 * 2  # samples apart (bytes: x2)
    frames, hexes = [], []
    for k in range(n_frames):
        f = make_df17_frame(addr=0x100000 + k, metype=4)
        hexes.append(f.hex())
        frames.append(f)
    # pad to a whole number of 256 KiB reader buffers: the final partial
    # buffer's decode is racy in the reference (dump1090.c:497 vs :2989),
    # so planted frames must never live there for a fair comparison
    n = n_frames * spacing + 8000
    n = -(-n // (256 * 1024)) * (256 * 1024)
    stream = (127 + rng.normal(0, noise_sigma, n)).clip(0, 255).astype(np.uint8)
    for k, f in enumerate(frames):
        iq = frame_to_iq(
            f,
            amplitude=min(amplitude, 126.0),
            noise_sigma=noise_sigma,
            phase=float(rng.uniform(0, 2 * np.pi)),
            pad_before=0,
            pad_after=0,
            rng=rng,
        )
        stream[k * spacing : k * spacing + len(iq)] = iq
    return stream, hexes


def decode_ours(stream: np.ndarray, device_resolve: bool = False, device="cuda", *,
                corrected: set | None = None) -> set[str]:
    """The hex of every crcok message of the port's decode of `stream` on
    `device`: run_device (K1 and K2) with `device_resolve`, else run (K1,
    then the host resolver).  `corrected`, when given, gets the hex of the
    messages recovered through the phase-corrected pass."""
    from ..models.pipeline import DemodPipeline, PipelineConfig

    p = DemodPipeline(PipelineConfig(batch_buffers=8), device=torch.device(device))
    got = set()

    def sink(mm) -> None:
        if mm.crcok:
            got.add(mm.msg.hex())
            if corrected is not None and mm.phase_corrected:
                corrected.add(mm.msg.hex())

    (p.run_device if device_resolve else p.run)(io.BytesIO(stream.tobytes()), sink)
    return got


def decode_reference(stream: np.ndarray, ref_cmd: list[str]) -> set[str]:
    """The hex of the `*hex;` lines of `[*ref_cmd, "--ifile", f, "--raw"]`."""
    with tempfile.NamedTemporaryFile(suffix=".bin") as tf:
        stream.tofile(tf.name)
        out = subprocess.run(
            [*ref_cmd, "--ifile", tf.name, "--raw"],
            capture_output=True, text=True, timeout=300,
        ).stdout
    return {line.strip()[1:-1] for line in out.splitlines() if line.startswith("*")}


def point_stream(snr: float, frames: int) -> tuple[np.ndarray, list[str]]:
    """The JAX tool's stream for one point: its generator is seeded from
    the SNR."""
    return build_stream(snr, frames, np.random.default_rng(int(snr * 10) + 12345))


def main(argv=None) -> int:
    from .. import resolve_device
    from . import add_device_options, device_option
    from .refbuild import reference_command

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ref", default=None,
                    help="the reference's command or binary (column skipped if it "
                    "cannot be had)")
    ap.add_argument("--frames", type=int, default=200)
    ap.add_argument("--snrs", default="-2,0,2,4,6,8,10,14,20",
                    help="comma-separated dB; a leading minus needs --snrs=-2,...")
    add_device_options(ap)
    ap.add_argument("--device-resolve", action="store_true",
                    help="resolve on the device (DemodPipeline.run_device) instead of "
                    "the host")
    args = ap.parse_args(argv)
    device = resolve_device(device_option(ap, args))

    try:  # build the reference on demand; sweep without it only if impossible
        ref_cmd = reference_command(args.ref)
    except SystemExit as e:
        print(f"snr_sweep: {e} — reference column skipped", file=sys.stderr)
        ref_cmd = None
    rows, exact_sets = [], True
    for snr in (float(s) for s in args.snrs.split(",")):
        stream, hexes = point_stream(snr, args.frames)
        planted = set(hexes)
        sets = [decode_ours(stream, args.device_resolve, device) & planted,
                decode_ours(stream, args.device_resolve, "cpu") & planted]
        if ref_cmd is not None:
            sets.append(decode_reference(stream, ref_cmd) & planted)
        exact_sets &= all(s == sets[0] for s in sets)
        rows.append((snr, [len(s) / len(planted) for s in sets]))

    cols = [f"port on {device}", "port on cpu"] + (["reference"] if ref_cmd else [])
    print("| SNR (dB) | " + " | ".join(cols) + " |")
    print("|---" * (len(cols) + 1) + "|")
    for snr, rates in rows:
        print(f"| {snr:g} | " + " | ".join(f"{r:.1%}" for r in rates) + " |")
    path = "device resolve" if args.device_resolve else "host resolve"
    print(f"\nexact recovered-frame sets identical at every point ({path}): {exact_sets}")
    return 0 if exact_sets else 1


if __name__ == "__main__":
    sys.exit(main())
