"""dump1090-tpu on PyTorch and CUDA: the Mode S / ADS-B decode of files and of
live RTL-SDR input, with the demodulator and the sequential candidate
resolver on an NVIDIA card.

This package is a port of `dump1090_tpu` (JAX on a TPU), which stays beside
it as the reference.  It keeps that package's module paths and function
names so each ported function can be found and held bit for bit against its
counterpart.  It imports torch and numpy only: never jax, and nothing from
`dump1090_tpu` (modules it needs from there are copied).

Programmatic use: `decode_capture` (one capture), `decode_captures`
(many independent captures sharing each dispatch) and
`decode_capture_sharded` (one capture, each buffer's timeline sharded over
a mesh of devices, parallel/) return ModesMessage lists; `models.pipeline.DemodPipeline` is the streaming decoder behind the
CLI (`run_source_device` and `run_source` take the buffers of a live
`io.rtlsdr.RtlSdrSource`).

Entry points run on CUDA unless the caller asks for the CPU (`device="cpu"`,
`--device cpu`); with no card and no such request they raise.  The kernels
that the TPU package wrote in Pallas are hand-written CUDA C++ for Hopper
(`csrc/`), built with nvcc at first use; on a CPU tensor each kernel wrapper
runs its plain PyTorch version instead.  The host-resolve path
(`DemodPipeline.run`, `--tpu-device-resolve off`, `--debug`) demodulates on
the device and replays the sequential scan on the host, in a C++ runtime
(`native/`, built with g++ at first use) or its Python twin.
"""

import torch

__version__ = "0.1.0"


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The port's device policy: CUDA unless the caller names the CPU.

    Raises when CUDA is asked for (explicitly or by default) and no card is
    present: a decode never carries on quietly on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' (CLI: "
                "--device cpu) to decode on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}: expected cuda or cpu")
    return dev


from .api import (  # noqa: E402  (needs resolve_device)
    decode_capture,
    decode_capture_sharded,
    decode_captures,
)

__all__ = ["decode_capture", "decode_capture_sharded", "decode_captures", "resolve_device",
           "__version__"]
