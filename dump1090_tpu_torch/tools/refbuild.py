"""Build (once) and locate the reference dump1090 binary, the oracle of the
differential tools' `--ref` (a port of tools/refbuild.py).

The reference is built from its source with a stub librtlsdr header: the
--ifile and --net-only paths never touch the radio (dump1090.c:2947-2954),
so the stub only has to satisfy the compiler and the linker.

    from .refbuild import reference_command
    ref = reference_command(args.ref)   # argv of the oracle, built if need be

`--ref` is a command: a path to a built reference binary, or any command
line that speaks the reference's CLI (the tests pass the JAX package's
CLI).  A single word names a binary: one that is already executable is
used as it is; otherwise it is built there from the reference's source,
found in $DUMP1090_REF_SRC or in `reference/` at the root of this
repository (where the reference's files go once the repository holds
them).  With no --ref the binary goes to _build/refbuild/dump1090 inside
the package.

    python -m dump1090_tpu_torch.tools.refbuild [PATH]

prints the binary's path (no device work, so no card is needed).
"""

from __future__ import annotations

import argparse
import os
import shlex
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
DEFAULT_BIN = str(REPO / "dump1090_tpu_torch" / "_build" / "refbuild" / "dump1090")

# Minimal librtlsdr stub: declarations dump1090.c uses, all inert (the file
# path never calls them; modesInitRTLSDR only runs without --ifile).
RTLSDR_STUB = """\
#ifndef RTL_SDR_STUB_H
#define RTL_SDR_STUB_H
#include <stdint.h>
typedef struct rtlsdr_dev rtlsdr_dev_t;
typedef void (*rtlsdr_read_async_cb_t)(unsigned char *buf, uint32_t len, void *ctx);
static inline uint32_t rtlsdr_get_device_count(void) { return 0; }
static inline int rtlsdr_get_device_usb_strings(uint32_t i, char *v, char *p, char *s) { (void)i;(void)v;(void)p;(void)s; return -1; }
static inline int rtlsdr_open(rtlsdr_dev_t **dev, uint32_t index) { (void)dev;(void)index; return -1; }
static inline int rtlsdr_close(rtlsdr_dev_t *dev) { (void)dev; return 0; }
static inline int rtlsdr_set_tuner_gain_mode(rtlsdr_dev_t *d, int m) { (void)d;(void)m; return 0; }
static inline int rtlsdr_set_tuner_gain(rtlsdr_dev_t *d, int g) { (void)d;(void)g; return 0; }
static inline int rtlsdr_get_tuner_gain(rtlsdr_dev_t *d) { (void)d; return 0; }
static inline int rtlsdr_get_tuner_gains(rtlsdr_dev_t *d, int *g) { (void)d; if(g) g[0]=0; return 1; }
static inline int rtlsdr_set_freq_correction(rtlsdr_dev_t *d, int p) { (void)d;(void)p; return 0; }
static inline int rtlsdr_set_agc_mode(rtlsdr_dev_t *d, int o) { (void)d;(void)o; return 0; }
static inline int rtlsdr_set_center_freq(rtlsdr_dev_t *d, uint32_t f) { (void)d;(void)f; return 0; }
static inline int rtlsdr_set_sample_rate(rtlsdr_dev_t *d, uint32_t r) { (void)d;(void)r; return 0; }
static inline int rtlsdr_reset_buffer(rtlsdr_dev_t *d) { (void)d; return 0; }
static inline int rtlsdr_read_async(rtlsdr_dev_t *d, rtlsdr_read_async_cb_t cb, void *ctx, uint32_t n, uint32_t len) { (void)d;(void)cb;(void)ctx;(void)n;(void)len; return 0; }
#endif
"""


def reference_source() -> str:
    """The directory of the reference's source: $DUMP1090_REF_SRC, or
    `reference/` inside this repository."""
    return os.environ.get("DUMP1090_REF_SRC", str(REPO / "reference"))


def ensure_reference(path: str | None = None, quiet: bool = False) -> str:
    """Return the path to an executable reference binary, building it if
    missing.  Exits with a one-line instruction if the build is impossible
    (reference source not found, or no C compiler)."""
    path = path or DEFAULT_BIN
    if os.access(path, os.X_OK):
        return path
    ref_src = reference_source()
    src = os.path.join(ref_src, "dump1090.c")
    if not os.path.exists(src):
        sys.exit(
            f"reference binary missing at {path} and source not found at "
            f"{src} — put the reference's source there (or set "
            f"DUMP1090_REF_SRC) and re-run, or pass --ref <path-to-built-dump1090>"
        )
    gcc = shutil.which("gcc") or shutil.which("cc")
    if gcc is None:
        sys.exit(
            f"reference binary missing at {path} and no C compiler on PATH — "
            f"build it elsewhere with tools/make_goldens.sh's recipe and "
            f"pass --ref <path>"
        )
    if not quiet:
        print(
            f"refbuild: building reference binary {path} from {ref_src} "
            f"(stub librtlsdr, {os.path.basename(gcc)} -O2)",
            file=sys.stderr, flush=True,
        )
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with tempfile.TemporaryDirectory() as build:
        with open(os.path.join(build, "rtl-sdr.h"), "w") as f:
            f.write(RTLSDR_STUB)
        for name in ("dump1090.c", "anet.c", "anet.h"):
            shutil.copy(os.path.join(ref_src, name), build)
        tmp_bin = os.path.join(build, "dump1090")
        r = subprocess.run(
            [gcc, "-O2", "-I", build,
             os.path.join(build, "dump1090.c"), os.path.join(build, "anet.c"),
             "-o", tmp_bin, "-lpthread", "-lm"],
            capture_output=True, text=True,
        )
        if r.returncode != 0:
            sys.exit(f"refbuild: reference build failed:\n{r.stderr}")
        # atomic move so a concurrent tool never sees a half-written binary
        staged = path + f".tmp.{os.getpid()}"
        shutil.move(tmp_bin, staged)
        os.replace(staged, path)
    return path


def reference_command(ref: str | None) -> list[str]:
    """The argv of the oracle named by `--ref`: a command line of several
    words as it is (shell-quoted), one word as a binary (ensure_reference),
    and no --ref as the default binary."""
    argv = shlex.split(ref) if ref else []
    if len(argv) > 1:
        return argv
    return [ensure_reference(argv[0] if argv else None)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("path", nargs="?", default=None, help=f"binary (default {DEFAULT_BIN})")
    args = ap.parse_args(argv)
    print(ensure_reference(args.path))
    return 0


if __name__ == "__main__":
    sys.exit(main())
