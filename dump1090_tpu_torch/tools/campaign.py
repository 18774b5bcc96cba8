"""The full differential campaign of the port against an oracle in one
command (a port of tools/campaign.sh): every stage runs one of the port's
tools, exits non-zero on the first byte difference, and stops the campaign.

    python -m dump1090_tpu_torch.tools.campaign --ref CMD [--device cuda]

--ref is the oracle: the reference binary, or any command line that speaks
its CLI (tools/refbuild.py); with none, the reference is built from
`reference/` at the repository's root, as campaign.sh builds it.  --device
is where the IQ tools (fuzz_diff, snr_sweep) decode; the hex tools drive
`--net-only`, which does no device work.  The stages are campaign.sh's, in
its order, with its seeds, counts and modes.
"""

from __future__ import annotations

import argparse
import os
import shlex
import subprocess
import sys

from .refbuild import REPO, ensure_reference


def stages(ref: str, device: str) -> list[tuple[list[str], dict]]:
    """(argv, extra environment) of each stage, in campaign.sh's order."""
    def tool(name, *args, env=None):
        argv = [sys.executable, "-m", f"dump1090_tpu_torch.tools.{name}", "--ref", ref, *args]
        if name in ("fuzz_diff", "snr_sweep"):
            argv += ["--device", device]
        return argv, env or {}

    return [
        # IQ-stream differential fuzz (host, device and sharded paths)
        tool("fuzz_diff", "--n", "10", "--seed", "11", "--mode", "raw"),
        tool("fuzz_diff", "--n", "10", "--seed", "12", "--mode", "aggressive"),
        tool("fuzz_diff", "--n", "10", "--seed", "13", "--mode", "nofix"),
        tool("fuzz_diff", "--n", "10", "--seed", "14", "--mode", "verbose"),
        tool("fuzz_diff", "--n", "6", "--seed", "15", "--mode", "device"),
        tool("fuzz_diff", "--n", "6", "--seed", "16", "--mode", "sharded-device"),
        # the packed demod front must stay bit-identical
        tool("fuzz_diff", "--n", "4", "--seed", "17", "--mode", "device",
             env={"DUMP1090_TPU_FRONT": "packed"}),
        # network hex-grammar fuzz (raw relay, SBS, stdout)
        tool("fuzz_hex", "--n", "300", "--rounds", "2", "--seed", "21"),
        tool("fuzz_hex", "--n", "300", "--rounds", "1", "--seed", "22", "--mode", "aggressive"),
        tool("fuzz_hex", "--n", "300", "--rounds", "1", "--seed", "23", "--mode", "no-fix"),
        # exhaustive field-domain sweeps
        tool("sweep_hex", "--sweep", "all"),
        # live /data.json differential
        tool("http_diff"),
        # --debug n network-event log differential
        tool("netdebug_diff"),
        # sensitivity parity (the SNR table)
        tool("snr_sweep"),
    ]


def run(stage_list: list[tuple[list[str], dict]]) -> int:
    """Run the stages in order from the repository's root; the first that
    fails ends the campaign with its exit code."""
    for argv, env in stage_list:
        prefix = "".join(f"{k}={v} " for k, v in env.items())
        print(f"== {prefix}{shlex.join(argv[2:])} ==", flush=True)
        rc = subprocess.run(argv, cwd=REPO, env={**os.environ, **env}).returncode
        if rc != 0:
            print(f"CAMPAIGN FAILED at {argv[2]} (exit {rc})", flush=True)
            return rc
    print("CAMPAIGN PASSED", flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ref", default=None,
                    help="the oracle's command (default: the reference, built from reference/)")
    ap.add_argument("--device", default="cuda",
                    help="where the IQ tools decode: cuda (default) or cpu")
    args = ap.parse_args(argv)
    return run(stages(args.ref or ensure_reference(), args.device))


if __name__ == "__main__":
    sys.exit(main())
