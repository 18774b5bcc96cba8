"""The inputs of the measurement tools (bench.py, measure.py,
exp_demod_front.py), in one place.

The stream is a flat uint8 IQ capture: the file `--input` names (a missing
file is an error), or else the dense planted air of chip_smoke.py
(utils/synth.py planted_capture: 16 blocks of 150 DF17 frames over Gaussian
noise, seed 1; about 200 preambles a buffer, close to the ~209 candidates a
buffer of the reference's modes1.bin, which the repository does not hold).

Each tool cuts the stream into reference-geometry buffers (262,620 bytes:
the 476-byte carry and 256 KiB of new samples) by the tiling of the JAX
tool it ports, byte for byte:

  bench_groups   tools' bench.py: W*G*NB distinct sliding-window buffers,
                 476 bytes of 127 first (bench.py:293-305)
  load_buffers   tools/measure.py's load_buffers (measure.py:50-60)
  load_batch     tools/exp_demod_front.py's load_batch, 8 reps (:73-80)

and the other inputs: bench.py's sparse batch (:594-613), `perturb` (the
int32-lane add of bench.py:438-441 and measure.py's stages probe) and
exp_demod_front's noise rows (seed 7).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from ..constants import DATA_LEN_BYTES
from ..io.sources import CARRY_BYTES
from ..parallel.sharding import overlapping_buffers

CARRY = np.full(CARRY_BYTES, 127, np.uint8)  # the first buffer's silent carry region
PLANTED = {"n_blocks": 16, "frames_per_block": 150, "seed": 1}


def planted_air() -> tuple[np.ndarray, list]:
    """(uint8 stream, planted frames) of the default dense air."""
    from ..utils.synth import planted_capture

    data, planted = planted_capture(PLANTED["n_blocks"], PLANTED["frames_per_block"],
                                    seed=PLANTED["seed"])
    return np.frombuffer(data, np.uint8), planted


def stream(path: str | Path | None = None) -> np.ndarray:
    """The flat uint8 IQ stream of a tool: the file at `path`, else the
    planted air.  A named file that is missing raises FileNotFoundError."""
    if path is None:
        return planted_air()[0]
    path = Path(path)
    if not path.is_file():
        raise FileNotFoundError(f"input capture not found: {path}")
    raw = np.fromfile(path, np.uint8)
    if raw.size == 0:
        raise ValueError(f"input capture is empty: {path}")
    return raw


def bench_groups(raw: np.ndarray, nb: int, g: int, w: int) -> list[np.ndarray]:
    """bench.py's W distinct dispatch groups of G batches of NB buffers,
    uint8 (G, NB, 262620) each: a sliding window over the capture repeated,
    so every batch decodes another message mix."""
    n_bufs_total = w * g * nb
    reps = int(np.ceil((n_bufs_total + w * g) * DATA_LEN_BYTES / len(raw)))
    bufs = overlapping_buffers(np.concatenate([CARRY] + [raw] * reps))
    return [
        np.stack([bufs[(j * g + k) * nb: (j * g + k) * nb + nb] for k in range(g)])
        for j in range(w)
    ]


def load_buffers(raw: np.ndarray, n_bufs: int) -> np.ndarray:
    """measure.py's n_bufs reference-geometry buffers (the capture tiled)."""
    reps = int(np.ceil((n_bufs + 1) * DATA_LEN_BYTES / len(raw)))
    bufs = np.asarray(overlapping_buffers(np.concatenate([CARRY] + [raw] * reps)))
    reps = -(-n_bufs // bufs.shape[0])
    return np.concatenate([bufs] * reps)[:n_bufs].copy()


def load_batch(raw: np.ndarray, nb: int) -> np.ndarray:
    """exp_demod_front.py's batch of nb buffers over 8 reps of the capture."""
    bufs = overlapping_buffers(np.concatenate([CARRY] + [raw] * 8))
    reps = -(-nb // bufs.shape[0])
    return np.concatenate([bufs] * reps)[:nb].copy()


def noise_rows(iq: np.ndarray) -> np.ndarray:
    """exp_demod_front.py's uniform noise rows (seed 7), shaped as iq[:8]:
    the padded tail and the empty-group paths of the fronts."""
    return np.random.default_rng(7).integers(0, 256, iq[:8].shape, np.uint8)


def sparse_batch(nb: int, nbytes: int) -> np.ndarray:
    """bench.py's sparse air: nb buffers of 3 DF17 frames each, 70,000
    samples apart, amplitude 80 over noise 2.0 (seed 5), on silence."""
    from ..utils.synth import frame_to_iq, make_df17_frame

    rng = np.random.default_rng(5)
    sparse = np.full((nb, nbytes), 127, dtype=np.uint8)
    for b in range(nb):
        at = 600
        for k in range(3):
            iq = frame_to_iq(make_df17_frame(0x100000 + 64 * b + k), amplitude=80,
                             noise_sigma=2.0, phase=float(rng.uniform(0, 6.28)), rng=rng)
            sparse[b, at: at + len(iq)] = iq
            at += len(iq) + 70000
    return sparse


def perturb(x: torch.Tensor, i: int) -> torch.Tensor:
    """x (..., n) uint8 or uint16 with i added to each int32 lane (4 bytes
    or 2 pairs, little-endian, wrapping): a distinct input each iteration of
    a timing loop, the same bytes as the JAX tools' bitcast add."""
    w = x.contiguous().view(torch.int32)
    return (w + i).view(x.dtype)
