#!/usr/bin/env python3
"""Smoke run of dump1090_tpu_torch on one NVIDIA card.

    python3 chip_smoke.py [--seed N] [--groups N]

Builds the package's CUDA kernels from csrc/, holds each kernel against its
plain PyTorch version at the file-decode width, drives the main path (the
--raw file decode, DemodPipeline.stream_raw_device, at the CLI's defaults:
64-buffer batches, 8 batches per group, max_candidates 256, dispatch-ahead
3) over a synthetic dense capture, and checks what comes out.  Every phase
prints one JSON line; any failure raises and the script exits non-zero.
The last line is {"ok": true, "device": {...}}.

The capture: 16 distinct blocks of 150 planted DF17 frames each over
Gaussian noise (utils/synth.py planted_capture, drawn from --seed), tiled
to --groups dispatch groups of 512 buffers (134 MB of IQ per group).
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (NVIDIA data sheet)
NOW = 1_700_000_000        # frozen decode clock: the run is deterministic
REPO = Path(__file__).resolve().parent


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of fn() in ms, by CUDA events around `reps` calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    if a.dtype == torch.uint16:
        a, b = (t.view(torch.int16).to(torch.int32) & 0xFFFF for t in (a, b))
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max().item())


def window_union_bytes(pos: np.ndarray, width: int) -> int:
    """Bytes of m_pad the gather must read: the union of each row's windows."""
    p = np.sort(pos.astype(np.int64), axis=1)
    gaps = np.minimum(np.diff(p, axis=1), width)
    return int((gaps.sum() + width * p.shape[0]) * 2)


def build_phase() -> None:
    from dump1090_tpu_torch.ops import _cuda

    t0 = time.perf_counter()
    _cuda.library()
    seconds = time.perf_counter() - t0
    regs = [
        line.strip() for log in _cuda.build_info.get("ptxas", {}).values()
        for line in log.splitlines() if "registers" in line or "Function properties" in line
    ]
    emit({"phase": "build", "seconds": seconds, "built": bool(_cuda.build_info),
          "library": _cuda.library_path().name, "ptxas": regs})


def gather_phase(m_pad: torch.Tensor, pos: torch.Tensor) -> dict:
    """K1 against its plain version at the main path's shapes, plus edge
    positions and a ragged candidate count; timings."""
    from dump1090_tpu_torch.ops.gather import WINDOW_PAD, gather_windows, gather_windows_plain

    got = gather_windows(m_pad, pos)
    err = max_abs_err(got, gather_windows_plain(m_pad, pos))
    s_pad = m_pad.shape[1]
    edges = [0, 1, 127, 128, 129, 1023, 1024, 1025, 2047, 2048, s_pad - WINDOW_PAD - 1,
             s_pad - WINDOW_PAD]
    epos = pos[:4, :250].clone()  # ragged: 250 is not a multiple of 16
    epos[0, : len(edges)] = torch.tensor(edges, dtype=torch.int32)
    e_got = gather_windows(m_pad[:4].contiguous(), epos.contiguous())
    e_want = m_pad[0].view(torch.int16)[
        torch.tensor(edges, device=pos.device)[:, None] + torch.arange(WINDOW_PAD, device=pos.device)
    ].view(torch.uint16)
    err_edges = max(max_abs_err(e_got[0, : len(edges)], e_want),
                    max_abs_err(e_got, gather_windows_plain(m_pad[:4].contiguous(), epos.contiguous())))
    torch.cuda.synchronize()
    if err or err_edges:
        raise AssertionError(f"gather kernel differs from its plain version: {err}, {err_edges}")

    b, mc = pos.shape
    m16 = m_pad.view(torch.int16)
    bidx = torch.arange(b, device=pos.device)[:, None, None]
    ar = torch.arange(WINDOW_PAD, device=pos.device)

    def library_call():
        # the advanced index of one PyTorch call (a yardstick only)
        return m16[bidx, pos[..., None] + ar]

    if not torch.equal(library_call().view(torch.uint16).view(torch.int16), got.view(torch.int16)):
        raise AssertionError("advanced-index yardstick disagrees with the gather kernel")
    moved = window_union_bytes(pos.cpu().numpy(), WINDOW_PAD) + pos.numel() * 4 + got.numel() * 2
    res = {
        "name": "gather_windows", "route": "cuda",
        "source": "dump1090_tpu_torch/csrc/gather_windows.cu",
        "replaces": "dump1090_tpu/ops/gather.py:41",
        "max_abs_err": max(err, err_edges),
        "ms": cuda_ms(lambda: gather_windows(m_pad, pos), 50),
        "plain_ms": cuda_ms(lambda: gather_windows_plain(m_pad, pos), 10),
        "bound_ms": moved / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
        "library_ms": cuda_ms(library_call, 10),
    }
    emit({"phase": "kernel_gather", "shape": [b, mc, WINDOW_PAD], "s_pad": s_pad,
          "bit_equal": True, "edge_and_ragged_equal": True, "bytes_moved": moved, **res})
    return res


def resolve_phase(walk_in, mc: int, seed: int) -> dict:
    """K2 against its plain version on one full group's real word stream and
    on an adversarial random stream; timings and ns per executed step."""
    from dump1090_tpu_torch.ops.resolve import _hash_words, resolve_words, resolve_words_plain
    from dump1090_tpu_torch.utils.synth import random_word_stream

    pf, w1, w2, h12, nbuf = walk_in
    dev = pf.device
    ca = torch.zeros(1024, dtype=torch.int32, device=dev)
    ct = torch.zeros(1024, dtype=torch.int32, device=dev)
    got = resolve_words(pf, w1, w2, h12, nbuf, ca, ct, NOW, mc)
    t0 = time.perf_counter()
    want = resolve_words_plain(pf, w1, w2, h12, nbuf, ca, ct, NOW, mc)
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = max(max_abs_err(g, w) for g, w in zip(got, want))

    adv = [torch.from_numpy(a).to(dev) for a in random_word_stream(seed, 512, mc, NOW)]
    a_pf, a_w1, a_w2, a_nbuf, a_ca, a_ct = adv
    a_h12 = _hash_words(a_w1, a_w2)
    a_got = resolve_words(a_pf, a_w1, a_w2, a_h12, a_nbuf, a_ca, a_ct, NOW, mc)
    a_want = resolve_words_plain(a_pf, a_w1, a_w2, a_h12, a_nbuf, a_ca, a_ct, NOW, mc)
    err_adv = max(max_abs_err(g, w) for g, w in zip(a_got, a_want))
    torch.cuda.synchronize()
    if err or err_adv:
        raise AssertionError(f"resolve kernel differs from its plain version: {err}, {err_adv}")

    steps = int(torch.clamp_max(nbuf, mc).sum().item())
    ms = cuda_ms(lambda: resolve_words(pf, w1, w2, h12, nbuf, ca, ct, NOW, mc), 10)
    # each walked slot's four input words read once, every word written
    # once, the counts read once, the cache read and written once
    moved = steps * 16 + pf.numel() * 4 + nbuf.numel() * 4 + 4 * 1024 * 4
    res = {
        "name": "resolve_words", "route": "cuda",
        "source": "dump1090_tpu_torch/csrc/resolve_words.cu",
        "replaces": "dump1090_tpu/ops/resolve.py:544",
        "max_abs_err": max(err, err_adv), "ms": ms, "plain_ms": plain_ms,
        "bound_ms": moved / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
        "library_ms": None,
    }
    emit({"phase": "kernel_resolve", "slots": pf.numel(), "executed_steps": steps,
          "ns_per_step": ms * 1e6 / max(steps, 1), "equal": True,
          "adversarial_equal": True, "adversarial_steps": int(a_nbuf.sum().item()),
          "bytes_moved": moved, **res})
    return res


def stage_split(xg: torch.Tensor, shapes: dict) -> dict:
    """Per-stage device time of one resident group (CUDA events), and the
    device-to-host copy of its outputs, at the shapes the main path settled
    on."""
    from dump1090_tpu_torch.constants import BUF_SAMPLES, FULL_LEN_SAMPLES
    from dump1090_tpu_torch.models.pipeline import _Fetch
    from dump1090_tpu_torch.ops.resolve import demod_resolve_group

    ca = torch.zeros(1024, dtype=torch.int32, device=xg.device)
    kw = dict(scan_len=BUF_SAMPLES - FULL_LEN_SAMPLES, **shapes)
    demod_resolve_group(xg, ca, ca, NOW, True, False, **kw)  # warm
    split = {}
    reps = 3
    for _ in range(reps):
        marks = []
        out = demod_resolve_group(xg, ca, ca, NOW, True, False, marks=marks, **kw)
        d2h_start = torch.cuda.Event(enable_timing=True)
        d2h_start.record()
        fetch = _Fetch(out[:6])
        d2h_end = torch.cuda.Event(enable_timing=True)
        d2h_end.record()
        fetch.get()
        for (_, a), (name, b) in zip(marks, marks[1:]):
            split[name] = split.get(name, 0.0) + a.elapsed_time(b) / reps
        split["d2h"] = split.get("d2h", 0.0) + d2h_start.elapsed_time(d2h_end) / reps
    return split


def sustained(xg: torch.Tensor, shapes: dict, n_groups: int) -> float:
    """Msamples/s of back-to-back groups on a resident input: the cache
    chains through the groups and each group's outputs are fetched to
    pinned host memory, three groups in flight, as the pipeline does."""
    from dump1090_tpu_torch.constants import BLOCK_SAMPLES, BUF_SAMPLES, FULL_LEN_SAMPLES
    from dump1090_tpu_torch.models.pipeline import _Fetch
    from dump1090_tpu_torch.ops.resolve import demod_resolve_group

    kw = dict(scan_len=BUF_SAMPLES - FULL_LEN_SAMPLES, **shapes)
    ca = torch.zeros(1024, dtype=torch.int32, device=xg.device)
    ct = torch.zeros(1024, dtype=torch.int32, device=xg.device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pending = []
    for _ in range(n_groups):
        out = demod_resolve_group(xg, ca, ct, NOW, True, False, **kw)
        ca, ct = out[6], out[7]
        pending.append(_Fetch(out[:6]))
        if len(pending) > 3:
            pending.pop(0).get()
    for f in pending:
        f.get()
    dt = time.perf_counter() - t0
    return n_groups * xg.shape[0] * xg.shape[1] * BLOCK_SAMPLES / dt / 1e6


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--groups", type=int, default=3,
                    help="dispatch groups of 512 buffers in the end-to-end run")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1

    from dump1090_tpu_torch.cli import print_stats
    from dump1090_tpu_torch.constants import BLOCK_SAMPLES
    from dump1090_tpu_torch.models.pipeline import DemodPipeline, PipelineConfig
    from dump1090_tpu_torch.ops import _cuda
    from dump1090_tpu_torch.ops.demod import pad_magnitudes
    from dump1090_tpu_torch.ops.resolve import _group_front, _group_precompute
    from dump1090_tpu_torch.utils.synth import planted_capture

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    build_phase()

    # ---- input: 16 distinct dense blocks, tiled ------------------------------
    t0 = time.perf_counter()
    blocks, planted = planted_capture(16, 150, seed=args.seed)
    group_blocks = 512
    tiles = -(-args.groups * group_blocks // 16)
    data = blocks * tiles
    gen_s = time.perf_counter() - t0

    # one full group resident on the card, framed as the pipeline frames it
    from dump1090_tpu_torch.io.sources import iq_buffers

    bufs = np.stack(list(iq_buffers(io.BytesIO(data[: group_blocks * 262144]))))
    xg = torch.from_numpy(bufs[:group_blocks].reshape(8, 64, -1)).to(dev)
    mc = 256
    m, n, pos = _group_front(xg, scan_len=131070, max_candidates=mc)
    walk_in, _ = _group_precompute(m, n, pos, True, False, max_candidates=mc)
    k1 = gather_phase(pad_magnitudes(m), pos)
    k2 = resolve_phase(walk_in, mc, args.seed)
    del m, pos, walk_in

    with tempfile.TemporaryDirectory(dir=_cuda.BUILD_DIR) as tmp:
        # ---- the main path on the card vs the port's CPU run: first group ----
        first = Path(tmp) / "first_group.bin"
        first.write_bytes(data[: group_blocks * 262144])
        runs = {}
        for d in ("cuda", "cpu"):
            p = DemodPipeline(PipelineConfig(batch_buffers=64, dispatch_groups=8),
                              clock=lambda: NOW, device=d)
            t1 = time.perf_counter()
            with open(first, "rb") as f:
                raw = b"".join(p.stream_raw_device(f))
            runs[d] = (raw, p.stats, time.perf_counter() - t1)
        if runs["cuda"][:2] != runs["cpu"][:2]:
            raise AssertionError("the card's decode of the first group differs from the CPU run")
        emit({"phase": "first_group_vs_cpu", "equal": True,
              "lines": len(runs["cuda"][0].split()), "cuda_s": runs["cuda"][2],
              "cpu_s": runs["cpu"][2], "stats": vars(runs["cuda"][1])})

        # ---- the same group through the CLI, on the card by default ----------
        cli = {}
        for flag in ("--raw", "--stats"):
            r = subprocess.run(
                [sys.executable, "-m", "dump1090_tpu_torch", "--ifile", str(first), flag],
                cwd=REPO, capture_output=True, timeout=300,
            )
            if r.returncode != 0:
                raise AssertionError(f"the CLI failed with {flag}: {r.stderr.decode()[-2000:]}")
            cli[flag] = r
        if cli["--raw"].stdout != runs["cuda"][0]:
            raise AssertionError("the CLI's --raw output differs from stream_raw_device")
        want_stats = io.StringIO()
        with contextlib.redirect_stdout(want_stats):
            print_stats(runs["cuda"][1])
        if cli["--stats"].stdout.decode() != want_stats.getvalue():
            raise AssertionError("the CLI's --stats output differs from the pipeline's counters")
        stats_lines = want_stats.getvalue().splitlines()
        emit({"phase": "cli", "raw_equal": True, "stats": stats_lines,
              "meter": cli["--stats"].stderr.decode().strip()})

        # ---- the main path, counted: the file decode at full width -----------
        path = Path(tmp) / "capture.bin"
        path.write_bytes(data[: args.groups * group_blocks * 262144])
        p = DemodPipeline(PipelineConfig(batch_buffers=64, dispatch_groups=8),
                          clock=lambda: NOW, device=dev)
        torch.cuda.reset_peak_memory_stats(dev)
        torch.cuda.synchronize()
        _cuda.reset_launches()
        t1 = time.perf_counter()
        with open(path, "rb") as f:
            out = b"".join(p.stream_raw_device(f))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        launches = dict(_cuda.launches)
        peak = torch.cuda.max_memory_allocated(dev)
        stats = dict(vars(p.stats))

        # the same file through a fresh pipeline that starts at the shapes
        # the first one grew to, so no group is replayed; then the ingest
        # alone (read, frame, upload), to split the file decode's wall time
        shapes = dict(max_candidates=p._mc, max_out_short=p._mos, max_out_long=p._mol)
        warm = DemodPipeline(PipelineConfig(batch_buffers=64, dispatch_groups=8),
                             clock=lambda: NOW, device=dev)
        warm._mc, warm._mos, warm._mol = p._mc, p._mos, p._mol
        t1 = time.perf_counter()
        with open(path, "rb") as f:
            warm_out = b"".join(warm.stream_raw_device(f))
        torch.cuda.synchronize()
        warm_wall = time.perf_counter() - t1
        if warm_out != out:
            raise AssertionError("a second decode of the capture gave other bytes")
        t1 = time.perf_counter()
        with open(path, "rb") as f:
            ingested = list(warm._ingest_groups(f, iq_buffers(f), 8, 64))
        torch.cuda.synchronize()
        ingest_s = time.perf_counter() - t1
        del ingested
        t1 = time.perf_counter()
        with open(path, "rb") as f:
            n_framed = sum(1 for _ in iq_buffers(f))
        frame_s = time.perf_counter() - t1

    lines = out.split()
    n_blocks = args.groups * group_blocks
    want = [b"*" + c.hex().encode() + b";" for _, _, c, nflip in planted if nflip == 0]
    it = iter(lines)
    clean_in_order = all(w in it for w in want * (n_blocks // 16))
    if not clean_in_order:
        raise AssertionError("a clean planted frame is missing or out of order")
    if not lines or any(not (len(x) in (16, 30) and x[:1] == b"*" and x[-1:] == b";") for x in lines):
        raise AssertionError("malformed raw output")

    split = stage_split(xg, shapes)
    sus = sustained(xg, shapes, 6)
    samples = n_blocks * BLOCK_SAMPLES
    emit({"phase": "e2e", "groups": args.groups, "buffers": n_blocks,
          "samples": samples, "lines": len(lines), "stats": stats,
          "clean_planted_in_order": True, "generate_s": gen_s, "wall_s": wall,
          "file_msps": samples / wall / 1e6, "warm_wall_s": warm_wall,
          "warm_file_msps": samples / warm_wall / 1e6, "ingest_s": ingest_s,
          "read_and_frame_s": frame_s, "framed_buffers": n_framed,
          "sustained_msps": sus, "stage_ms_per_group": split,
          "peak_device_bytes": peak, "settled_shapes": shapes,
          "groups_replayed": launches["resolve_words"] - args.groups})

    emit({"phase": "kernels", "launches": launches})
    for name, n_launch in launches.items():
        if n_launch <= 0:
            raise AssertionError(f"kernel {name} was not launched on the main path")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    emit({"phase": "gpu", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda})
    print(smi, flush=True)

    k1["launches"] = launches["gather_windows"]
    k2["launches"] = launches["resolve_words"]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    emit({"kernels": [{k: r[k] for k in keys} for r in (k1, k2)]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
