"""Build, load and launch-count the port's hand-written CUDA kernels.

The sources in `csrc/*.cu` expose a plain C interface.  At first use each
source is compiled by its own nvcc process for `sm_90a` (all started
together), the objects are linked into one shared library, and the library
is loaded with ctypes.  Nothing here includes PyTorch's headers, so a build
takes seconds.  The library is cached under `_build/` in the package, keyed
by a hash of the sources and flags; a stale or missing library is rebuilt.

Each C entry point launches on the stream it is given (PyTorch's current
stream), allocates nothing, does not synchronise, and returns
cudaGetLastError(); `check` raises on a nonzero code.  `launches` counts
every kernel launch a wrapper makes, so a run can show that the main path
went through the kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
SOURCES = ("gather_windows.cu", "resolve_words.cu")
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# launches per kernel since the last reset_launches()
launches = {"gather_windows": 0, "resolve_words": 0, "resolve_words_streams": 0}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
# filled by the build that produced the loaded library (None: found cached)
build_info: dict = {}

_vp, _i = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    # (m, elem_bytes, pos, out, B, S, s_pad, lead, mc, stream)
    "gather_windows": [_vp, _i, _vp, _vp, _i, _i, _i, _i, _i, _vp],
    # (pf, w1, w2, h12, nbuf, ca_in, ct_in, words, ca_out, ct_out, counts,
    #  n_buffers, mc, now, stream)
    "resolve_words": [_vp] * 11 + [_i, _i, _i, _vp],
    # (pf, w1, w2, h12, nbuf, ca_in, ct_in, words, ca_out, ct_out, counts,
    #  n_streams, bufs_per_stream, mc, now, stream)
    "resolve_words_streams": [_vp] * 11 + [_i, _i, _i, _i, _vp],
}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH or $CUDA_HOME/bin): the CUDA kernels of "
        "dump1090_tpu_torch are compiled from csrc/ at first use"
    )


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update((CSRC_DIR / name).read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.read_bytes())
    return BUILD_DIR / f"libdump1090_kernels-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile csrc/*.cu into the shared library (no-op when cached)."""
    so = library_path()
    if so.exists():
        return so
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / (Path(name).stem + ".o") for name in SOURCES]
        procs = [
            subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(CSRC_DIR / name), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            for name, obj in zip(SOURCES, objs)
        ]
        logs = {}
        for name, p in zip(SOURCES, procs):
            logs[name] = p.communicate()[0]
        for name, p in zip(SOURCES, procs):
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed on csrc/{name}:\n{logs[name]}")
        tmp_so = Path(tmp) / so.name
        link = subprocess.run(
            [nvcc, *ARCH_FLAGS, "-shared", *map(str, objs), "-o", str(tmp_so)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(tmp_so, so)
    build_info.update(seconds=time.perf_counter() - t0, ptxas=logs)
    return so


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.d1090_error_string.argtypes = [ctypes.c_int]
            lib.d1090_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def check(err: int, name: str) -> None:
    if err != 0:
        msg = library().d1090_error_string(err).decode()
        raise RuntimeError(f"CUDA kernel {name} failed to launch: {msg} ({err})")


def current_stream(device) -> int:
    """The raw handle of PyTorch's current stream on a tensor's device (a
    torch.device or its index), read without building a Stream object."""
    import torch

    return torch._C._cuda_getCurrentRawStream(device if isinstance(device, int) else device.index)
