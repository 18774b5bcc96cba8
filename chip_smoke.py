#!/usr/bin/env python3
"""Smoke run of dump1090_tpu_torch on one NVIDIA card.

    python3 chip_smoke.py [--seed N] [--groups N]

Builds the package's CUDA kernels from csrc/, holds each kernel against its
plain PyTorch version at the width of the path that runs it (the resolver
walks K2 and K3 on the dense and a sparse group's word streams, on random
words and on a forced-cut stream, with their batch and cut counts; K1,
which reads the int32 magnitudes itself, at every path's shape, also
against the two-step path it replaced, zero-padded uint16 rows
and then the gather, with edge positions, and the `gather` stage's kernels
read by the profiler), and drives the paths below over a synthetic dense
capture, checking what comes out:

  * the --raw file decode (DemodPipeline.stream_raw_device) at the CLI's
    defaults: 64-buffer batches, 8 batches per group, max_candidates 256,
    dispatch-ahead 3 (kernels K1 gather_windows and K2 resolve_words);
  * the emission's crcok_only (`crcok`: ops.resolve.demod_resolve_group
    with its defaults, packed with crcok_only False and True, and
    demod_resolve_batch packed with every attempted decode, over the first
    4 dense buffers at mc 256, each equal to the CPU's call; K1 and K2);
  * the multi-capture decode (decode_captures) of 128 captures of 4-16
    buffers, 4 buffers of each per round: one 512-buffer dispatch per round
    (kernels K1 and K3 resolve_words_streams);
  * the CLI's hub path (cli.main in this process, DemodPipeline.run_device
    and the message hub; kernels K1 and K2): the plain verbose display over
    the first group, checked against the --raw output, the planted frames,
    --onlyaddr and a `python -m dump1090_tpu_torch` subprocess; the first
    64 buffers in three modes on the card against --device cpu; and the
    network services on loopback (raw out, raw in, SBS, /data.json) over
    the first 64 buffers, on the card against the CPU;
  * the host-resolve path (kernel K1 in ops.demod.demod_batch, the
    sequential resolve in the C++ runtime): DemodPipeline.run with
    16-buffer batches over the whole capture against run_device, the CLI's
    --raw --tpu-device-resolve off (stream_records) against the file
    decode, the verbose CLI with the resolver off against on, the Python
    twin against the C++ runtime on 64 buffers, --debug p, C and D on
    tests/golden/debug_p_input.bin against the reference's goldens,
    --debug cdj over 16 buffers on the card against the CPU (stdout and
    frames.js), and decode_captures(device_resolve=False) on 16 captures
    against the device strategy.  K1 is also held against its plain
    version at this path's shapes: (1, 256), (16, 256) and (1, 1024), and
    at a shard's (1, 128) with no lead;
  * the packed preamble fronts (`front_variants`: the five formulations'
    (n, pos) on one dense group bit-equal to the mask form's, each timed,
    and the 3-group file decode under --tpu-front packed byte-equal),
    --tpu-preload auto, staged and off over the 3 groups (`preload`:
    byte-equal, wall time and time to the first line), --tpu-profile over
    one group (`profile`: the trace names K1 and K2), and live input from
    a stub librtlsdr (`live`: tests/stub_rtlsdr.c built with gcc; 64
    transfers through run_source_device at a 200 ms pace against
    run_source and run_device, the same at the radio's 65.536 ms pace with
    drops and the time per buffer, and the live CLI in this process and as
    a subprocess over one transfer);
  * the time-sharded decode (`sharded`: api.decode_capture_sharded on
    meshes that repeat the one card, K1 in every shard and K2 over the
    candidate segments): meshes (1, 1), (1, 4) and (2, 4) with both
    resolve strategies in three decoder modes against the unsharded decode
    and the CPU, a (32, 2) mesh that grows both shapes, --tpu-shard-time 1
    against --raw, the multi-process worker at world size 1 with --bench
    (the sharded step over 131,072 samples on 4 shards of the card, s/step
    printed beside the card's name and power limit, counted), K1
    and K2 against their plain versions at this path's shapes, and the
    (1, 4) and (2, 4) decodes of 64 dense buffers timed (counted);
  * the differential fuzz (`fuzz`: tools/fuzz_diff.py's random streams of
    six recipes, noise to frames across buffer boundaries, in six modes:
    the device resolver in three decoder modes, the host resolve, the
    sharded decode on a (1, 4) mesh of the card and the verbose CLI), every
    mode's output on the card equal to the CPU's;
  * the wall-clock soaks (`soak`: tools/soak_device.py's raw-stream and
    messages planes side by side for 2.5 minutes of a live clock at the
    radio's 4 MB/s, dense air, a fleet and 67 s of quiet air a period, so
    the ICAO-cache and aircraft TTLs are crossed and the pipeline shrinks
    and regrows its shapes), each equal byte for byte to its CPU replay
    under the recorded clocks;
  * the stdin feed (`stdin_net`: the 16 dense blocks piped into `python -m
    dump1090_tpu_torch --ifile - --net` by tools/net_capture.py on the card
    and the CPU, raw out byte-equal and SBS equal with the MSG,3 positions
    canonicalized; then cli.main --ifile - --raw over a pipe in this
    process, one buffer a dispatch, equal to the file decode, timed a
    buffer against its 65.536 ms of air);
  * the sensitivity sweep (`snr`: tools/snr_sweep.py's streams at 12 SNRs
    from -2 to 20 dB, 200 frames each, decoded with the resolver on the
    card, on the host, and on the CPU: equal recovered sets, every frame
    at 20 dB, phase-corrected frames at 11 and 12 dB);
  * the fixed-reps soak (`reps_soak`: tools/soak_device.py's default mode
    over the planted blocks tiled to 288 buffers (two full dispatch groups
    of 16 x 8 buffers and a partial one), in a process of its own against
    the port's CPU CLI as the oracle: SOAK PASS; its cold and warm passes
    again in this process, K1's and K2's inputs held against their plain
    versions at a full group on an empty ICAO cache, at a full group on
    the cache chained from the group before, and at the partial group; the
    CLI's --raw --tpu-device-resolve off with and without
    DUMP1090_TPU_NO_NATIVE=1, each run counted on its own, the hub path
    against the native bulk path, byte-equal; and uint16 magnitudes
    against int32);
  * the measurement tools (`measure`: tools/bench.py's sustained_e2e
    protocol in full in a process of its own; the bench's first group of
    1,536 buffers, formatted by its sustained run, byte-equal to
    DemodPipeline.stream_raw_device over the same buffers, with every
    planted frame of at most one flipped bit among its lines; each of
    tools/measure.py's ten probes once; tools/exp_demod_front.py --check
    --time), each exiting 0 on the card with every roofline and busy
    share in [0, 1].  The e2e phase's sustained rate and stage split are
    the tools' own code.

Each path runs with the launch counts set to 0 just before it and read just
after; every kernel must have launched on the path that uses it.  Every
phase prints one JSON line; any failure raises and the script exits
non-zero.  The last line is {"ok": true, "device": {...}}.

The capture: 16 distinct blocks of 150 planted DF17 frames each over
Gaussian noise (utils/synth.py planted_capture, drawn from --seed), tiled
to --groups dispatch groups of 512 buffers (134 MB of IQ per group) for the
file decode, and rotated and cut into the 128 captures of the multi-capture
decode.  Sparse air for the resolver phases: 16 blocks of 10 frames each at
the same noise, tiled to one group.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import io
import json
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from dump1090_tpu_torch.constants import DATA_LEN_BYTES

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (NVIDIA data sheet)
NOW = 1_700_000_000        # frozen decode clock: the run is deterministic
REPO = Path(__file__).resolve().parent


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    """The card's name and power limit, as `nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader` gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


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


def window_union_bytes(pos: np.ndarray, lead: int, s: int, s_pad: int, itemsize: int) -> int:
    """Bytes of the rows the gather must read: the union, within each row of
    s samples, of the windows [p - lead, p - lead + 256) at the clamped
    starts p."""
    lo = np.sort(np.clip(pos.astype(np.int64), 0, s_pad - 256), axis=1) - lead
    hi = np.clip(lo + 256, 0, s)
    lo = np.clip(lo, 0, s)
    prev = np.concatenate([np.zeros((lo.shape[0], 1), np.int64), hi[:, :-1]], axis=1)
    return int(np.maximum(hi - np.maximum(lo, prev), 0).sum()) * itemsize


def host_us(fn, n: int = 1000) -> float:
    """Host microseconds per call of fn() over n calls with no sync between
    them: what the caller's thread pays to launch."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    us = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return us


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


def padded_rows(m: torch.Tensor, lead: int, s_pad: int) -> torch.Tensor:
    """The zero-padded uint16 rows that K1 read before it read the
    magnitudes itself: `lead` zeros, m narrowed to 16 bits, zeros up to
    s_pad samples (the old pad step of the two-step path)."""
    out = torch.zeros((m.shape[0], s_pad), dtype=torch.int16, device=m.device)
    out[:, lead:lead + m.shape[1]] = m
    return out.view(torch.uint16)


def k1_check(m: torch.Tensor, pos: torch.Tensor, lead: int, s_pad: int, reps: int) -> dict:
    """K1 (gather_row_windows) at one shape, bit-equal to its plain version
    and to the two-step path (padded_rows, then K1 on the padded rows, and
    that step's plain version), on pos, on a copy whose row 0 starts with
    edge positions (0, negative, at and past s_pad - 256), and on that copy
    cut to a ragged candidate count (not a multiple of 16).  Times of each,
    the yardstick (one advanced index into the int32 rows, the clamp
    precomputed, then the zero mask and the narrowing), the bytes bound,
    and the host cost per call of K1 and of the two-step path."""
    from dump1090_tpu_torch.ops.gather import (
        WINDOW_PAD, gather_row_windows, gather_row_windows_plain, gather_windows,
        gather_windows_plain)

    b, s = m.shape
    dev = m.device
    edges = [0, 1, -1, -3000, s - 240, s_pad - WINDOW_PAD - 1, s_pad - WINDOW_PAD,
             s_pad - 100, s_pad + 5000, 2**30]
    epos = pos.clone()
    epos[0, : len(edges)] = torch.tensor(edges, dtype=torch.int32, device=dev)
    err = 0
    for p in (pos, epos, epos[:, :-6].contiguous()):
        want = gather_row_windows_plain(m, p, lead=lead, s_pad=s_pad)
        m_pad = padded_rows(m, lead, s_pad)
        err = max(err, max_abs_err(gather_windows(m_pad, p), want),
                  max_abs_err(gather_windows_plain(m_pad, p), want))
        err = max(err, max_abs_err(gather_row_windows(m, p, lead=lead, s_pad=s_pad), want))
    torch.cuda.synchronize()
    if err:
        raise AssertionError(f"K1 differs from its plain version or the two-step path at "
                             f"{tuple(pos.shape)}, lead {lead}: {err}")

    st = pos.to(torch.int64).clamp(0, s_pad - WINDOW_PAD) - lead
    src = st[..., None] + torch.arange(WINDOW_PAD, device=dev)
    outside = (src < 0) | (src >= s)
    idx = src.clamp(0, s - 1)
    bidx = torch.arange(b, device=dev)[:, None, None]

    def library_call():
        # one advanced index of PyTorch, masked and narrowed (a yardstick only)
        return m[bidx, idx].masked_fill_(outside, 0).to(torch.int16)

    got = gather_row_windows(m, pos, lead=lead, s_pad=s_pad)
    if not torch.equal(library_call(), got.view(torch.int16)):
        raise AssertionError("the advanced-index yardstick disagrees with K1")
    m_pad = padded_rows(m, lead, s_pad)
    moved = (window_union_bytes(pos.cpu().numpy(), lead, s, s_pad, m.element_size())
             + pos.numel() * 4 + got.numel() * 2)
    slow = max(reps // 5, 5)
    return {
        "shape": [b, pos.shape[1], WINDOW_PAD], "rows": [b, s], "lead": lead, "s_pad": s_pad,
        "max_abs_err": err,
        "ms": cuda_ms(lambda: gather_row_windows(m, pos, lead=lead, s_pad=s_pad), reps),
        "plain_ms": cuda_ms(lambda: gather_row_windows_plain(m, pos, lead=lead, s_pad=s_pad), slow),
        "two_step_ms": cuda_ms(lambda: gather_windows(padded_rows(m, lead, s_pad), pos), reps),
        "on_padded_rows_ms": cuda_ms(lambda: gather_windows(m_pad, pos), reps),
        "bound_ms": moved / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
        "library_ms": cuda_ms(library_call, slow),
        "host_us": host_us(lambda: gather_row_windows(m, pos, lead=lead, s_pad=s_pad)),
        "two_step_host_us": host_us(lambda: gather_windows(padded_rows(m, lead, s_pad), pos)),
        "bytes_moved": moved,
    }


def device_kernels(fn) -> list:
    """Names of the device kernels one call of fn() runs (torch.profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]


def gather_phase(m: torch.Tensor, pos: torch.Tensor) -> dict:
    """K1 at the file decode's shape, lead 1 (k1_check)."""
    s_pad = -(-(m.shape[1] + 1 + 2048 + 256) // 1024) * 1024
    res = k1_check(m, pos, 1, s_pad, 50)
    res.update(name="gather_windows", route="cuda",
               source="dump1090_tpu_torch/csrc/gather_windows.cu",
               replaces="dump1090_tpu/ops/gather.py:41")
    emit({"phase": "kernel_gather", "bit_equal": True, "edge_and_ragged_equal": True, **res})
    return res


def gather_stage_kernels(seed: int) -> int:
    """The kernels of the file decode's `gather` stage
    (ops.demod.gather_candidate_windows) on one dense group, read by the
    profiler, against the two-step path's: the stage must run K1 alone.
    Run by gather_stage_kernels_phase in a process of its own."""
    from dump1090_tpu_torch.io.sources import iq_buffers
    from dump1090_tpu_torch.ops.demod import gather_candidate_windows
    from dump1090_tpu_torch.ops.gather import gather_windows
    from dump1090_tpu_torch.ops.resolve import _group_front
    from dump1090_tpu_torch.utils.synth import planted_capture

    torch.cuda.set_device(0)
    blocks, _ = planted_capture(16, 150, seed=seed)
    bufs = np.stack(list(iq_buffers(io.BytesIO(blocks * 32))))
    xg = torch.from_numpy(bufs.reshape(8, 64, -1)).to("cuda")
    m, _, pos = _group_front(xg, scan_len=131070, max_candidates=256)
    s_pad = -(-(m.shape[1] + 1 + 2048 + 256) // 1024) * 1024
    fused = device_kernels(lambda: gather_candidate_windows(m, pos))
    two_step = device_kernels(lambda: gather_windows(padded_rows(m, 1, s_pad), pos))
    if len(fused) != 1 or "gather_windows_kernel" not in fused[0] or len(two_step) < 2:
        raise AssertionError(f"the gather stage runs {fused}, the two-step path {two_step}")
    emit({"phase": "gather_stage_kernels", "stage_kernels": fused, "two_step_kernels": two_step})
    return 0


def gather_stage_kernels_phase(seed: int) -> None:
    """gather_stage_kernels in a process of its own: there the profiler's
    session is the first, and no later phase runs after it (in one process,
    a session after --tpu-profile's saw no device kernels, and one early
    in the script left the later host work slower)."""
    code = f"import sys, chip_smoke; sys.exit(chip_smoke.gather_stage_kernels({seed}))"
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                       timeout=600)
    if r.returncode != 0:
        raise AssertionError(f"the gather stage's kernel check failed: {r.stderr[-3000:]}")
    print(r.stdout, end="", flush=True)


# K2's and K3's times on the dense stream with the one-thread walk that the
# batched walk replaced (chip runs on an NVIDIA H100 80GB HBM3 at 700 W,
# recorded in PERF.md), printed beside this run's for reference
K2_PREV_MS = [13.46, 13.58]
K3_PREV_MS = [0.1131, 0.1160]


def walk_summary(counts: torch.Tensor, steps: torch.Tensor, ms: float) -> dict:
    """Batches and cuts of a walk (per block: one for K2, one per stream for
    K3) beside its steps and time; ns per step along the longest block."""
    b, c = (int(x) for x in counts.sum(dim=0).tolist())
    longest = int(steps.max().item())
    return {"steps": int(steps.sum().item()), "longest_block_steps": longest, "ms": ms,
            "ns_per_step": ms * 1e6 / max(longest, 1), "batches": b, "cuts": c,
            "steps_per_batch": int(steps.sum().item()) / max(b, 1),
            "longest_block_batches": int(counts[:, 0].max().item())}


def resolve_phase(walk_in, sparse_in, mc: int, seed: int) -> dict:
    """K2 against its plain version on one full group's real word stream of
    dense and of sparse air, on an adversarial random stream and on the
    forced-cut stream; timings, ns per executed step, and the walk's
    batches and cuts."""
    from dump1090_tpu_torch.ops.resolve import _hash_words, resolve_words, resolve_words_plain
    from dump1090_tpu_torch.utils.synth import forced_cut_stream, random_word_stream

    pf, w1, w2, h12, nbuf = walk_in
    dev = pf.device
    ca = torch.zeros(1024, dtype=torch.int32, device=dev)
    ct = torch.zeros(1024, dtype=torch.int32, device=dev)

    def synthetic(make):
        s_pf, s_w1, s_w2, s_nbuf, s_ca, s_ct = (torch.from_numpy(a).to(dev)
                                                for a in make(seed, 512, mc, NOW))
        return s_pf, s_w1, s_w2, _hash_words(s_w1, s_w2), s_nbuf, s_ca, s_ct

    streams = {"dense": (pf, w1, w2, h12, nbuf, ca, ct),
               "sparse": (*sparse_in, ca, ct),
               "adversarial": synthetic(random_word_stream),
               "forced_cut": synthetic(forced_cut_stream)}
    err, plain_ms, counts = 0, None, {}
    for name, inp in streams.items():
        *got, counts[name] = resolve_words(*inp, NOW, mc, walk_counts=True)
        t0 = time.perf_counter()
        want = resolve_words_plain(*inp, NOW, mc)
        plain_ms = plain_ms if plain_ms is not None else (time.perf_counter() - t0) * 1e3
        err = max(err, *(max_abs_err(g, w) for g, w in zip(got, want)))
    torch.cuda.synchronize()
    if err:
        raise AssertionError(f"resolve kernel differs from its plain version: {err}")

    walks = {}
    for name, inp in streams.items():
        ms = cuda_ms(lambda: resolve_words(*inp, NOW, mc), 10)
        walks[name] = walk_summary(counts[name], torch.clamp(inp[4], 0, mc).sum()[None], ms)
    steps = walks["dense"]["steps"]
    # each walked slot's four input words read once, every word written
    # once, the counts read once, the cache read and written once
    moved = steps * 16 + pf.numel() * 4 + nbuf.numel() * 4 + 4 * 1024 * 4
    res = {
        "name": "resolve_words", "route": "cuda",
        "source": "dump1090_tpu_torch/csrc/resolve_words.cu",
        "replaces": "dump1090_tpu/ops/resolve.py:544",
        "max_abs_err": err, "ms": walks["dense"]["ms"], "plain_ms": plain_ms,
        "bound_ms": moved / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
        "library_ms": None,
    }
    emit({"phase": "kernel_resolve", "slots": pf.numel(), "executed_steps": steps,
          "ns_per_step": walks["dense"]["ns_per_step"], "equal": True,
          "sparse_equal": True, "adversarial_equal": True, "forced_cut_equal": True,
          "walks": walks, "prev_ms": K2_PREV_MS, "bytes_moved": moved, **res})
    return res


def resolve_streams_phase(bufs: np.ndarray, sparse_bufs: np.ndarray, seed: int,
                          dev: torch.device, s_n: int = 128) -> dict:
    """K3 against its plain version at the multi-capture width: 128 streams
    of 4 buffers at mc 256, from 128 distinct 4-buffer slices of the dense
    group (a seeded permutation of its 512 buffers), the same of the sparse
    group, and an adversarial random word stream and a forced-cut stream
    per stream, with some streams' counts all zero.  Each stream must also
    equal K2 walking that stream alone, and K3 with one stream must equal
    K2.  Timings (with the walk's batches and cuts): K3 on the dense and the
    sparse streams, its plain version, and K2 walking the same 512 buffers
    as one stream."""
    from dump1090_tpu_torch.ops.resolve import (
        PF_VALID,
        _group_front,
        _group_precompute,
        _hash_words,
        resolve_words,
        resolve_words_streams,
        resolve_words_streams_plain,
    )
    from dump1090_tpu_torch.utils.synth import forced_cut_stream, random_word_stream

    nb, mc = 4, 256
    perm = np.random.default_rng(seed).permutation(bufs.shape[0])[: s_n * nb]
    ca = torch.zeros((s_n, 1024), dtype=torch.int32, device=dev)
    ct = torch.zeros_like(ca)

    def from_air(b: np.ndarray):
        xs = torch.from_numpy(b[perm].reshape(s_n, nb, -1)).to(dev)
        m, n, pos = _group_front(xs, scan_len=131070, max_candidates=mc)
        walk_in, _ = _group_precompute(m, n, pos, True, False, max_candidates=mc)
        return (*walk_in, ca, ct)

    def synthetic(make):
        parts = [make(seed * 1000 + s, nb, mc, NOW) for s in range(s_n)]
        a_pf, a_w1, a_w2, a_nbuf, a_ca, a_ct = (np.stack([p[i] for p in parts]) for i in range(6))
        a_nbuf[5::16] = 0  # exhausted streams
        a_pf[5::16] &= ~PF_VALID
        a_pf, a_w1, a_w2, a_nbuf = (torch.from_numpy(a.reshape(-1)).to(dev)
                                    for a in (a_pf, a_w1, a_w2, a_nbuf))
        a_ca, a_ct = (torch.from_numpy(a).to(dev) for a in (a_ca, a_ct))
        return a_pf, a_w1, a_w2, _hash_words(a_w1, a_w2), a_nbuf, a_ca, a_ct

    streams = {"dense": from_air(bufs), "sparse": from_air(sparse_bufs),
               "adversarial": synthetic(random_word_stream),
               "forced_cut": synthetic(forced_cut_stream)}
    real = streams["dense"]
    pf, w1, w2, h12, nbuf = real[:5]

    per = nb * mc
    err = 0
    plain_ms = None
    counts = {}
    for name, inp in streams.items():
        *got, counts[name] = resolve_words_streams(*inp, NOW, mc, s_n, walk_counts=True)
        t0 = time.perf_counter()
        want = resolve_words_streams_plain(*inp, NOW, mc, s_n)
        plain_ms = plain_ms if plain_ms is not None else (time.perf_counter() - t0) * 1e3
        err = max(err, *(max_abs_err(g, w) for g, w in zip(got, want)))
        i_pf, i_w1, i_w2, i_h12, i_nbuf, i_ca, i_ct = inp
        for s in range(s_n):  # each stream alone through K2
            sl = slice(s * per, (s + 1) * per)
            one = resolve_words(i_pf[sl], i_w1[sl], i_w2[sl], i_h12[sl],
                                i_nbuf[s * nb:(s + 1) * nb], i_ca[s], i_ct[s], NOW, mc)
            err = max(err, max_abs_err(one[0], got[0][sl]), max_abs_err(one[1], got[1][s]),
                      max_abs_err(one[2], got[2][s]))
    # one stream of all 512 buffers: K3 with S = 1 against K2
    one_k3 = resolve_words_streams(pf, w1, w2, h12, nbuf, ca[:1], ct[:1], NOW, mc, 1)
    one_k2 = resolve_words(pf, w1, w2, h12, nbuf, ca[0], ct[0], NOW, mc)
    err_one = max(max_abs_err(one_k3[0], one_k2[0]), max_abs_err(one_k3[1][0], one_k2[1]))
    torch.cuda.synchronize()
    if err or err_one:
        raise AssertionError(f"multi-stream resolve kernel differs: {err}, {err_one}")

    walks = {}
    for name, inp in streams.items():
        ms = cuda_ms(lambda: resolve_words_streams(*inp, NOW, mc, s_n), 20)
        steps = torch.clamp(inp[4], 0, mc).reshape(s_n, nb).sum(dim=1)
        walks[name] = walk_summary(counts[name], steps, ms)
    ms, longest, total = (walks["dense"][k] for k in ("ms", "longest_block_steps", "steps"))
    k2_ms = cuda_ms(lambda: resolve_words(pf, w1, w2, h12, nbuf, ca[0], ct[0], NOW, mc), 5)
    # per stream, as resolve_phase reckons one walk: each walked slot's four
    # input words read once, every word written once, the counts read
    # once, the cache rows read and written once
    moved = total * 16 + pf.numel() * 4 + nbuf.numel() * 4 + s_n * 4 * 1024 * 4
    res = {
        "name": "resolve_words_streams", "route": "cuda",
        "source": "dump1090_tpu_torch/csrc/resolve_words.cu",
        "replaces": "dump1090_tpu/ops/resolve.py:544",
        "max_abs_err": max(err, err_one), "ms": ms, "plain_ms": plain_ms,
        "bound_ms": moved / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
        "library_ms": None,
    }
    a_nbuf = streams["adversarial"][4]
    emit({"phase": "kernel_resolve_streams", "streams": s_n, "buffers_per_stream": nb,
          "mc": mc, "slots": pf.numel(), "executed_steps": total,
          "longest_stream_steps": longest,
          "ns_per_critical_step": ms * 1e6 / max(longest, 1),
          "k2_one_stream_ms": k2_ms, "k2_ns_per_step": k2_ms * 1e6 / max(total, 1),
          "equal": True, "sparse_equal": True, "adversarial_equal": True,
          "forced_cut_equal": True, "each_stream_equals_k2": True,
          "one_stream_equals_k2": True, "walks": walks, "prev_ms": K3_PREV_MS,
          "adversarial_steps": int(torch.clamp(a_nbuf, 0, mc).sum().item()),
          "exhausted_streams": int((a_nbuf.reshape(s_n, nb).sum(dim=1) == 0).sum().item()),
          "bytes_moved": moved, **res})
    return res


@contextlib.contextmanager
def frozen_clock():
    """time.time() returns NOW inside: decode_captures reads its per-round
    clock and decode_capture its cache clock through it."""
    real = time.time
    time.time = lambda: float(NOW)
    try:
        yield
    finally:
        time.time = real


def captures_from_blocks(blocks: list, planted: list, n: int, lengths, rotate):
    """n captures, capture k being len(k) consecutive blocks starting at
    block rotate(k) (mod 16), with the clean planted frames it holds in
    order."""
    caps, want = [], []
    by_block = collections.defaultdict(list)
    for blk, _, frame, nflip in planted:
        if nflip == 0:
            by_block[blk].append(frame)
    for k in range(n):
        idx = [(rotate(k) + i) % len(blocks) for i in range(lengths(k))]
        caps.append(b"".join(blocks[i] for i in idx))
        want.append([f for i in idx for f in by_block[i]])
    return caps, want


def check_planted(results: list, want: list) -> int:
    """Every clean planted frame of each capture appears crcok, in order.
    Returns the number of frames checked."""
    for k, (msgs, frames) in enumerate(zip(results, want)):
        it = iter(m.msg[: m.msgbits // 8] for m in msgs if m.crcok)
        if not all(f in it for f in frames):
            raise AssertionError(f"capture {k}: a clean planted frame is missing or out of order")
    return sum(len(f) for f in want)


def captures_vs_cpu_phase(blocks: list, planted: list, dev: torch.device) -> None:
    """decode_captures on the card against the port's own CPU run, field
    for field, on 8 captures of 2-6 buffers."""
    from dump1090_tpu_torch import decode_captures

    caps, want = captures_from_blocks(blocks, planted, 8, lambda k: 2 + k % 5, lambda k: 3 * k)
    runs = {}
    with frozen_clock():
        for d in (dev, "cpu"):
            t1 = time.perf_counter()
            runs[str(d)] = (decode_captures(caps, device=d, device_resolve=True),
                            time.perf_counter() - t1)
    card, cpu = runs[str(dev)], runs["cpu"]
    if card[0] != cpu[0]:
        raise AssertionError("decode_captures on the card differs from the CPU run")
    frames = check_planted(card[0], want)
    emit({"phase": "decode_captures_vs_cpu", "equal": True, "captures": len(caps),
          "buffers": [len(c) // DATA_LEN_BYTES for c in caps],
          "messages": sum(len(r) for r in card[0]), "planted_checked": frames,
          "cuda_s": card[1], "cpu_s": cpu[1]})


def captures_e2e_phase(blocks: list, planted: list, dev: torch.device, n: int = 128) -> dict:
    """The multi-capture path, counted, at full width: 128 distinct
    captures of 4-16 buffers through decode_captures on the card.  Every
    capture is checked against its planted frames and 4 sampled ones against
    the solo decode_capture, on the card and on the CPU.  Returns the
    launch counts of the decode_captures run and of the solo runs."""
    from dump1090_tpu_torch import api, decode_capture, decode_captures
    from dump1090_tpu_torch.constants import BLOCK_SAMPLES
    from dump1090_tpu_torch.ops import _cuda

    caps, want = captures_from_blocks(blocks, planted, n, lambda k: 4 + (5 * k) % 13,
                                      lambda k: k)
    n_bufs = sum(len(c) // DATA_LEN_BYTES for c in caps)

    # instrument the run from outside: the dispatches (with their per-stage
    # CUDA events) and the host's message decode
    dispatches, host_s = [], [0.0]
    real_dispatch, real_decode = api.demod_resolve_streams, api.messages_from_device_arrays

    def dispatch(xs, *a, **k):
        marks = []
        out = real_dispatch(xs, *a, marks=marks, **k)
        dispatches.append((tuple(xs.shape[:2]), k["max_candidates"], k["max_out"], marks))
        return out

    def decode(*a):
        t0 = time.perf_counter()
        out = real_decode(*a)
        host_s[0] += time.perf_counter() - t0
        return out

    api.demod_resolve_streams, api.messages_from_device_arrays = dispatch, decode
    try:
        with frozen_clock():
            torch.cuda.reset_peak_memory_stats(dev)
            torch.cuda.synchronize()
            _cuda.reset_launches()
            t1 = time.perf_counter()
            results = decode_captures(caps, device=dev)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t1
            launches = dict(_cuda.launches)
    finally:
        api.demod_resolve_streams, api.messages_from_device_arrays = real_dispatch, real_decode
    peak = torch.cuda.max_memory_allocated(dev)

    frames = check_planted(results, want)
    # the solo path (decode_capture -> DemodPipeline.run_device, the
    # unpacked group emission), counted, on sampled captures; each is held
    # against decode_captures and against the same call on the CPU
    sampled = sorted({0, n // 3, 2 * n // 3, n - 1})
    with frozen_clock():
        torch.cuda.synchronize()
        _cuda.reset_launches()
        solo = {k: decode_capture(caps[k], device=dev) for k in sampled}
        torch.cuda.synchronize()
        solo_launches = dict(_cuda.launches)
        for k in sampled:
            if solo[k] != results[k]:
                raise AssertionError(f"capture {k}: decode_captures differs from decode_capture")
            if decode_capture(caps[k], device="cpu", device_resolve=True) != solo[k]:
                raise AssertionError(f"capture {k}: decode_capture on the card differs from the CPU")

    stages = collections.defaultdict(float)
    device_ms = []
    for _, _, _, marks in dispatches:
        device_ms.append(marks[0][1].elapsed_time(marks[-1][1]))
        for (_, a), (name, b) in zip(marks, marks[1:]):
            stages[name] += a.elapsed_time(b) / len(dispatches)
    rounds = -(-max(len(c) // DATA_LEN_BYTES for c in caps) // 4)
    shapes = [(mc, mo) for _, mc, mo, _ in dispatches]
    n_msgs = sum(len(r) for r in results)
    samples = n_bufs * BLOCK_SAMPLES
    res = {"phase": "decode_captures_e2e", "captures": len(caps), "buffers": n_bufs,
           "samples": samples, "messages": n_msgs,
           "crcok_messages": sum(m.crcok for r in results for m in r),
           "planted_checked": frames, "clean_planted_in_order": True,
           "solo_equal_sampled": sampled, "solo_equal_cpu": True,
           "wall_s": wall, "msps": samples / wall / 1e6,
           "messages_per_s": n_msgs / wall, "rounds": rounds,
           "dispatches": len(dispatches), "tile_shapes": sorted(set(d[0] for d in dispatches)),
           "replays": sum(1 for a, b in zip(shapes, shapes[1:]) if a != b),
           "shapes": sorted(set(shapes)), "device_ms_per_dispatch": device_ms,
           "stage_ms_per_dispatch": dict(stages), "device_s": sum(device_ms) / 1e3,
           "host_decode_s": host_s[0], "host_decode_share": host_s[0] / wall,
           "peak_device_bytes": peak}
    emit(res)
    return launches, solo_launches


class _FirstWrite(io.RawIOBase):
    """A binary file that notes when its first byte was written."""

    def __init__(self, fh):
        self.fh, self.first = fh, None

    def writable(self) -> bool:
        return True

    def write(self, b) -> int:
        if self.first is None and len(b):
            self.first = time.perf_counter()
        return self.fh.write(b)


def run_cli(argv: list, out: Path, timing: dict | None = None) -> float:
    """cli.main(argv) in this process, under the frozen clock, with stdout
    written to `out`, so the kernels' launch counts see its run.  Returns
    its wall time in seconds; `timing`, when a dict, also gets the seconds
    to the first byte of stdout ("first_s")."""
    from dump1090_tpu_torch import cli

    with frozen_clock(), open(out, "wb") as raw:
        sink = _FirstWrite(raw)
        text = io.TextIOWrapper(io.BufferedWriter(sink), encoding="utf-8", write_through=True)
        with contextlib.redirect_stdout(text):
            t0 = time.perf_counter()
            rc = cli.main(argv)
            if torch.cuda.is_initialized():
                torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
        text.flush()
    if rc != 0:
        raise AssertionError(f"cli.main({argv}) returned {rc}")
    if timing is not None:
        timing["first_s"] = None if sink.first is None else sink.first - t0
    return seconds


def verbose_cli_phase(first: Path, raw_want: bytes, planted: list, n_blocks: int,
                      tmp: Path) -> dict:
    """The CLI's plain (verbose) mode at its file defaults over the first
    group, on the card, counted: its `*hex;` lines must equal the --raw
    output, its text the display of the messages the hub was given, every
    clean planted frame's block must be there in order, --onlyaddr must
    give the crcok messages' addresses, and a `python -m dump1090_tpu_torch`
    subprocess with no --device the same bytes.  Host time: the message
    decode (messages_from_device_arrays) and the hub (use_message); device
    time: CUDA events around each dispatch (marks=)."""
    from dump1090_tpu_torch.constants import BLOCK_SAMPLES
    from dump1090_tpu_torch.models import pipeline as pl
    from dump1090_tpu_torch.models.decoder import DecoderConfig, IcaoCache, decode_message
    from dump1090_tpu_torch.models.hub import MessageHub
    from dump1090_tpu_torch.ops import _cuda
    from dump1090_tpu_torch.utils.display import display_message

    decode_s, hub_s, n_msgs, shown, dispatches = [0.0], [0.0], [0], [], []
    real_dispatch = pl.demod_resolve_group
    real_decode, real_use = pl.messages_from_device_arrays, MessageHub.use_message

    def dispatch(*a, **k):
        marks = []
        dispatches.append(marks)
        return real_dispatch(*a, marks=marks, **k)

    def decode(*a):
        t0 = time.perf_counter()
        out = real_decode(*a)
        decode_s[0] += time.perf_counter() - t0
        n_msgs[0] += len(out)
        return out

    def use(self, mm):
        t0 = time.perf_counter()
        real_use(self, mm)
        hub_s[0] += time.perf_counter() - t0
        if mm.crcok:
            shown.append(mm)

    verbose = tmp / "verbose.txt"
    pl.demod_resolve_group, pl.messages_from_device_arrays = dispatch, decode
    MessageHub.use_message = use
    try:
        torch.cuda.synchronize()
        _cuda.reset_launches()
        wall = run_cli(["--ifile", str(first)], verbose)
        launches = dict(_cuda.launches)
    finally:
        pl.demod_resolve_group, pl.messages_from_device_arrays = real_dispatch, real_decode
        MessageHub.use_message = real_use
    # device time of each dispatch (a replayed group counts twice)
    device_ms = [m[0][1].elapsed_time(m[-1][1]) for m in dispatches]
    text = verbose.read_text()
    hex_lines = "".join(ln + "\n" for ln in text.splitlines() if ln.startswith("*"))
    if hex_lines.encode() != raw_want:
        raise AssertionError("the verbose output's *hex; lines differ from the --raw output")
    if text != "".join(display_message(m) + "\n" for m in shown):
        raise AssertionError("the verbose output differs from the display of the hub's messages")
    clean = collections.defaultdict(list)
    for blk, _, frame, nflip in planted:
        if nflip == 0:
            clean[blk].append(frame)
    cache, cfg, blocks_text = IcaoCache(clock=lambda: NOW), DecoderConfig(), {}
    pos = checked = 0
    for b in range(n_blocks):
        for frame in clean[b % 16]:
            if frame not in blocks_text:
                blocks_text[frame] = display_message(decode_message(frame, cache, cfg)) + "\n"
            i = text.find(blocks_text[frame], pos)
            if i < 0:
                raise AssertionError("a clean planted frame's verbose block is missing or out of order")
            pos = i + len(blocks_text[frame])
            checked += 1

    onlyaddr_s = run_cli(["--ifile", str(first), "--onlyaddr"], tmp / "onlyaddr.txt")
    if (tmp / "onlyaddr.txt").read_text() != "".join(
            f"{m.aa1:02x}{m.aa2:02x}{m.aa3:02x}\n" for m in shown):
        raise AssertionError("--onlyaddr differs from the crcok messages' addresses")
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "dump1090_tpu_torch", "--ifile", str(first)],
                       cwd=REPO, capture_output=True, timeout=300)
    sub_s = time.perf_counter() - t0
    if r.returncode != 0 or r.stdout != text.encode():
        raise AssertionError(f"the CLI subprocess differs (rc {r.returncode}): "
                             f"{r.stderr.decode()[-2000:]}")
    samples = n_blocks * BLOCK_SAMPLES
    host = decode_s[0] + hub_s[0]
    emit({"phase": "verbose_cli", "buffers": n_blocks, "samples": samples,
          "messages": n_msgs[0], "printed_blocks": len(shown), "stdout_bytes": len(text),
          "raw_lines_equal": True, "display_equal": True, "planted_checked": checked,
          "clean_planted_in_order": True, "onlyaddr_equal": True, "subprocess_equal": True,
          "wall_s": wall, "msps": samples / wall / 1e6, "messages_per_s": n_msgs[0] / wall,
          "host_decode_s": decode_s[0], "hub_s": hub_s[0], "host_share": host / wall,
          "dispatches": len(device_ms), "device_ms_per_dispatch": device_ms,
          "device_share": sum(device_ms) / 1e3 / wall,
          "onlyaddr_s": onlyaddr_s, "subprocess_s": sub_s, "launches": launches})
    return launches


def verbose_vs_cpu_phase(first64: Path, tmp: Path) -> tuple:
    """The first 64 buffers in the plain mode, --onlyaddr and --raw
    --no-crc-check through cli.main on the card (counted) and with --device
    cpu: stdout byte-equal.  Returns the card runs' launches and the plain
    mode's output."""
    from dump1090_tpu_torch.ops import _cuda

    modes = {"verbose": [], "onlyaddr": ["--onlyaddr"], "raw_nocrc": ["--raw", "--no-crc-check"]}
    outs, secs, launches = {}, {}, {}
    for d in ("cuda", "cpu"):
        if d == "cuda":
            torch.cuda.synchronize()
            _cuda.reset_launches()
        for name, flags in modes.items():
            path = tmp / f"{name}_{d}.txt"
            secs[f"{name}_{d}_s"] = run_cli(["--ifile", str(first64), "--device", d,
                                             "--tpu-device-resolve", "on", *flags], path)
            outs[(d, name)] = path.read_bytes()
        if d == "cuda":
            launches = dict(_cuda.launches)
    for name in modes:
        if outs[("cuda", name)] != outs[("cpu", name)]:
            raise AssertionError(f"cli {name} on the card differs from --device cpu")
        if not outs[("cuda", name)]:
            raise AssertionError(f"cli {name} printed nothing")
    emit({"phase": "verbose_vs_cpu", "buffers": 64, "equal": True,
          "bytes": {n: len(outs[("cuda", n)]) for n in modes}, **secs, "launches": launches})
    return launches, outs[("cuda", "verbose")]


def _free_ports(n: int) -> list:
    socks = [socket.socket() for _ in range(n)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


NET_WAIT_S = 120.0  # the longest the net phase waits for one reply


class _Client:
    """A loopback client that reads on its own thread from the moment it
    connects, as a real network client does, so the server never holds
    data back for it; wait_for waits until what came in ends with a
    suffix and, if it does not, says what came and what the services
    looked like."""

    def __init__(self, port: int, name: str, state):
        import threading

        self.name, self.state = name, state
        self.sock = socket.create_connection(("127.0.0.1", port), timeout=NET_WAIT_S)
        self.sock.settimeout(None)
        self.data, self.eof, self.error = bytearray(), False, None
        self._cv = threading.Condition()
        self._thread = threading.Thread(target=self._read, name=f"client-{name}", daemon=True)
        self._thread.start()

    def _read(self) -> None:
        while True:
            try:
                chunk = self.sock.recv(1 << 16)
            except OSError as e:
                chunk, self.error = b"", e
            with self._cv:
                self.data += chunk
                self.eof = not chunk
                self._cv.notify_all()
            if not chunk:
                return

    def wait_for(self, suffix: bytes) -> bytes:
        deadline = time.monotonic() + NET_WAIT_S
        with self._cv:
            while not self.data.endswith(suffix):
                left = deadline - time.monotonic()
                if self.eof or left <= 0:
                    why = f"closed ({self.error!r})" if self.eof else f"silent for {NET_WAIT_S} s"
                    raise AssertionError(
                        f"the {self.name} client was {why} before {suffix!r}: "
                        f"{len(self.data)} bytes, ending {bytes(self.data[-120:])!r}; "
                        f"services {self.state()}")
                self._cv.wait(left)
            return bytes(self.data)

    def close(self) -> None:
        with contextlib.suppress(OSError):
            self.sock.shutdown(socket.SHUT_RDWR)  # wakes the reading thread
        self._thread.join()
        self.sock.close()


def net_phase(first64: Path, verbose64: bytes, dev: torch.device) -> dict:
    """The network services in this process on free loopback ports, wired
    as the CLI wires them (cli.network_services) to a --raw --net hub:
    one raw-out client, one SBS client and one GET /data.json (tracking on)
    before run_device decodes the first 64 buffers, on the card (counted)
    and on the CPU; then one `*hex;` line (a DF11 all-call of an address no
    frame uses) into raw input.  The raw-out bytes must be the uppercase
    `*HEX;` lines of the crcok messages and then that line; the SBS bytes
    and a /data.json fetched after must equal the CPU run's."""
    import os
    import threading
    import urllib.request

    from dump1090_tpu_torch import cli
    from dump1090_tpu_torch.models.decoder import DecoderConfig
    from dump1090_tpu_torch.models.hub import HubConfig, MessageHub
    from dump1090_tpu_torch.models.pipeline import DemodPipeline, PipelineConfig
    from dump1090_tpu_torch.models.tracker import AircraftTracker
    from dump1090_tpu_torch.ops import _cuda
    from dump1090_tpu_torch.ops.crc import compute_crc

    probe = bytearray(b"\x5d\xab\xcd\xef\x00\x00\x00")
    probe[4:7] = compute_crc(np.frombuffer(bytes(probe), np.uint8), 56).to_bytes(3, "big")
    probe_line = b"*" + bytes(probe).hex().encode() + b";\n"
    probe_sbs = b"MSG,8,,,ABCDEF,,,,,,,,,,,,,,,,,\n"
    want_raw = b"".join(ln.upper() + b"\n" for ln in verbose64.splitlines()
                        if ln.startswith(b"*")) + probe_line.upper()
    runs, launches = {}, {}
    for d in (dev, "cpu"):
        ro, ri, http, sbs = _free_ports(4)
        o = cli.parse_args(["--ifile", str(first64), "--raw", "--net", "--net-ro-port", str(ro),
                            "--net-ri-port", str(ri), "--net-http-port", str(http),
                            "--net-sbs-port", str(sbs)])
        state_lock = threading.RLock()
        with frozen_clock(), open(os.devnull, "w") as devnull:
            p = DemodPipeline(PipelineConfig(batch_buffers=64, dispatch_groups=8), device=d,
                              lock=state_lock)
            hub = MessageHub(HubConfig(raw=True, net=True), AircraftTracker(), p.stats,
                             out=devnull)
            net = cli.network_services(o, hub, p.cache, DecoderConfig(), state_lock)

            def state(net=net):
                return {"loop_alive": net._thread.is_alive(), "raw_clients": len(net._raw_clients),
                        "sbs_clients": len(net._sbs_clients), "pending": len(net._pending),
                        "drain_scheduled": net._drain_scheduled}

            net.start()
            clients = []
            try:
                raw_c = _Client(ro, "raw-out", state)
                clients.append(raw_c)
                sbs_c = _Client(sbs, "SBS", state)
                clients.append(sbs_c)
                url = f"http://127.0.0.1:{http}/data.json"
                if urllib.request.urlopen(url, timeout=NET_WAIT_S).read() != b"[\n]\n":
                    raise AssertionError("/data.json before the decode is not empty")
                deadline = time.monotonic() + NET_WAIT_S  # time.time is frozen here
                while (p.stats.sbs_connections, p.stats.http_requests) != (1, 1):
                    if time.monotonic() > deadline:
                        raise AssertionError("the SBS client or the HTTP request was not counted")
                    time.sleep(0.01)

                def on_message(mm):
                    with state_lock:
                        hub.use_message(mm)

                if d != "cpu":
                    torch.cuda.synchronize()
                    _cuda.reset_launches()
                t0 = time.perf_counter()
                with open(first64, "rb") as f:
                    p.run_device(f, on_message)
                if d != "cpu":
                    torch.cuda.synchronize()
                    launches = dict(_cuda.launches)
                wall = time.perf_counter() - t0
                with socket.create_connection(("127.0.0.1", ri), timeout=NET_WAIT_S) as inp:
                    inp.sendall(probe_line)
                    raw = raw_c.wait_for(probe_line.upper())
                    sbs_b = sbs_c.wait_for(probe_sbs)
                js = urllib.request.urlopen(url, timeout=NET_WAIT_S).read()
            finally:
                for c in clients:
                    c.close()
                net.stop()
        runs[str(d)] = (raw, sbs_b, js, wall)
    card, cpu = runs[str(dev)], runs["cpu"]
    if card[0] != want_raw:
        raise AssertionError("raw-out differs from the crcok messages' uppercase lines")
    if card[:3] != cpu[:3]:
        raise AssertionError("the SBS bytes or /data.json on the card differ from the CPU run")
    if card[2].count(b'"hex"') == 0 or card[1].count(b"MSG,3,") == 0:
        raise AssertionError("tracking never decoded a position")
    emit({"phase": "net", "buffers": 64, "raw_equal": True, "sbs_equal_cpu": True,
          "json_equal_cpu": True, "raw_in_echoed": True, "raw_lines": card[0].count(b"\n"),
          "sbs_lines": card[1].count(b"\n"), "json_aircraft": card[2].count(b'"hex"'),
          "cuda_s": card[3], "cpu_s": cpu[3], "launches": launches})
    return launches


def gather_shapes_phase(m: torch.Tensor) -> list:
    """K1 at the host-resolve path's shapes, lead 1, on the dense group's
    magnitudes: (16, 256), a 16-buffer batch; (1, 256), one buffer
    (--debug, stdin, the per-row retry, a live buffer); (1, 1024), one
    buffer demodulated again after an overflow; and at lead 0 a shard's
    (1, 128) of its extended row (1, 1 + 32768 + 240) at sp 4 (k1_check)."""
    from dump1090_tpu_torch.ops.demod import front_candidates

    shapes = []
    s_pad = -(-(m.shape[1] + 1 + 2048 + 256) // 1024) * 1024
    for b, mc in ((1, 256), (16, 256), (1, 1024)):
        mb = m[:b].contiguous()
        _, pos = front_candidates(mb, 131070, mc)
        shapes.append(k1_check(mb, pos, 1, s_pad, 200))
    t = 32768
    m_ext = m[:1, : 1 + t + 240].contiguous()
    _, pos = front_candidates(m_ext[:, 1:].contiguous(), t, 128)
    shapes.append(k1_check(m_ext, pos, 0, -(-(t + 256) // 1024) * 1024, 200))
    emit({"phase": "kernel_gather_host_shapes", "bit_equal": True, "shapes": shapes})
    return shapes


def as_tuples(msgs: list) -> list:
    """Every field of each message; a native RecordMessage is built into its
    ModesMessage on the way."""
    return [dataclasses.astuple(m) for m in msgs]


def host_resolve_phase(path: Path, n_bufs: int, raw_want: bytes, dev: torch.device,
                       tmp: Path) -> tuple:
    """The host-resolve path at the CLI's file defaults for it, counted:
    DemodPipeline(batch_buffers=16, native=True).run over the whole capture
    on the card, every message field and the 8 counters equal to the
    port's run_device on the same file; then cli.main with --raw
    --tpu-device-resolve off (stream_records) byte-equal to the file
    decode's --raw output.  The wall time split, measured from outside:
    device demod (CUDA events around each demod_batch dispatch), fetch wait
    (_Fetch.get), native resolve (resolve_blocks_records) and formatting
    (records_to_messages).  Fails if the Python replay ran.  Returns the
    launches of the run and of the CLI run."""
    from dump1090_tpu_torch import native
    from dump1090_tpu_torch.constants import BLOCK_SAMPLES
    from dump1090_tpu_torch.models import pipeline as pl
    from dump1090_tpu_torch.models.pipeline import DemodPipeline, PipelineConfig
    from dump1090_tpu_torch.ops import _cuda

    marks, host_s, python_calls = [], collections.defaultdict(float), [0]
    real = {"batch": pl.demod_batch, "get": pl._Fetch.get, "py": pl.resolve_block,
            "blocks": native.NativeResolver.resolve_blocks_records,
            "to_msgs": native.records_to_messages}

    def timed(name, fn):
        def wrapper(*a, **k):
            t0 = time.perf_counter()
            out = fn(*a, **k)
            host_s[name] += time.perf_counter() - t0
            return out
        return wrapper

    def batch(*a, **k):
        e0 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out = real["batch"](*a, **k)
        e1 = torch.cuda.Event(enable_timing=True)
        e1.record()
        marks.append((e0, e1))
        return out

    def python_resolve(*a, **k):
        python_calls[0] += 1
        return real["py"](*a, **k)

    pl.demod_batch, pl.resolve_block = batch, python_resolve
    pl._Fetch.get = timed("fetch_wait_s", real["get"])
    native.NativeResolver.resolve_blocks_records = timed("native_resolve_s", real["blocks"])
    native.records_to_messages = timed("format_s", real["to_msgs"])
    try:
        p = DemodPipeline(PipelineConfig(batch_buffers=16), clock=lambda: NOW, device=dev,
                          native=True)
        msgs = []
        torch.cuda.synchronize()
        _cuda.reset_launches()
        t0 = time.perf_counter()
        with open(path, "rb") as f:
            p.run(f, msgs.append)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(_cuda.launches)
    finally:
        pl.demod_batch, pl.resolve_block, pl._Fetch.get = real["batch"], real["py"], real["get"]
        native.NativeResolver.resolve_blocks_records = real["blocks"]
        native.records_to_messages = real["to_msgs"]
    if p._native is None or python_calls[0]:
        raise AssertionError(f"the Python replay ran ({python_calls[0]} blocks): native_used false")
    demod_ms = [a.elapsed_time(b) for a, b in marks]
    kernels = dispatch_kernels(path, dev)

    ref = DemodPipeline(PipelineConfig(batch_buffers=64, dispatch_groups=8), clock=lambda: NOW,
                        device=dev)
    ref_msgs = []
    t0 = time.perf_counter()
    with open(path, "rb") as f:
        ref.run_device(f, ref_msgs.append)
    ref_wall = time.perf_counter() - t0
    got = as_tuples(msgs)
    if got != as_tuples(ref_msgs):
        raise AssertionError("the host-resolve path's messages differ from run_device's")
    if vars(p.stats) != vars(ref.stats):
        raise AssertionError("the host-resolve path's counters differ from run_device's")

    torch.cuda.synchronize()
    _cuda.reset_launches()
    cli_s = run_cli(["--ifile", str(path), "--raw", "--tpu-device-resolve", "off"],
                    tmp / "raw_off.txt")
    cli_launches = dict(_cuda.launches)
    if (tmp / "raw_off.txt").read_bytes() != raw_want:
        raise AssertionError("--raw --tpu-device-resolve off differs from the file decode's --raw")
    samples = n_bufs * BLOCK_SAMPLES
    emit({"phase": "host_resolve", "buffers": n_bufs, "batch_buffers": 16, "samples": samples,
          "messages": len(msgs), "crcok_messages": sum(m.crcok for m in msgs),
          "equal_run_device": True, "stats_equal": True, "native_used": True,
          "cli_raw_off_equal": True, "stats": vars(p.stats), "settled_mc": p._mc,
          "wall_s": wall, "msps": samples / wall / 1e6, "dispatches": len(demod_ms),
          "device_demod_s": sum(demod_ms) / 1e3, "device_demod_ms_per_dispatch":
          [min(demod_ms), sum(demod_ms) / len(demod_ms), max(demod_ms)],
          **{k: v for k, v in host_s.items()}, "event_span_share": sum(demod_ms) / 1e3 / wall,
          "one_dispatch_kernels": kernels,
          "run_device_wall_s": ref_wall, "cli_raw_off_s": cli_s,
          "cli_raw_off_msps": samples / cli_s / 1e6, "launches": launches,
          "cli_launches": cli_launches})
    return launches, cli_launches


def dispatch_kernels(path: Path, dev: torch.device) -> dict:
    """The device work of one 16-buffer demod_batch dispatch alone, by
    torch.profiler (CUPTI): its kernels and their summed device time,
    beside the host's time to issue them.  None where the trace holds no
    device event."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from dump1090_tpu_torch.io.sources import iq_buffers
    from dump1090_tpu_torch.ops.demod import demod_batch

    with open(path, "rb") as f:
        x = torch.from_numpy(np.stack([b for _, b in zip(range(16), iq_buffers(f))])).to(dev)
    demod_batch(x, scan_len=131070, max_candidates=256)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        demod_batch(x, scan_len=131070, max_candidates=256)
        issue_s = time.perf_counter() - t0
        torch.cuda.synchronize()
    kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]
    if not kern:
        return {"kernels": None, "device_ms": None, "issue_ms": issue_s * 1e3}
    return {"kernels": len(kern), "device_ms": sum(e.self_device_time_total for e in kern) / 1e3,
            "issue_ms": issue_s * 1e3}


def host_resolve_python_phase(first64: Path, dev: torch.device) -> dict:
    """The first 64 buffers on the host path with native=False (the Python
    twin) against native=True, on the card: messages and counters equal."""
    from dump1090_tpu_torch.models.pipeline import DemodPipeline, PipelineConfig
    from dump1090_tpu_torch.ops import _cuda

    runs, launches = {}, {}
    for native in (True, False):
        p = DemodPipeline(PipelineConfig(batch_buffers=16), clock=lambda: NOW, device=dev,
                          native=native)
        msgs = []
        torch.cuda.synchronize()
        _cuda.reset_launches()
        t0 = time.perf_counter()
        with open(first64, "rb") as f:
            p.run(f, msgs.append)
        torch.cuda.synchronize()
        runs[native] = (as_tuples(msgs), vars(p.stats), time.perf_counter() - t0)
        if not native:
            launches = dict(_cuda.launches)
    if runs[True][:2] != runs[False][:2]:
        raise AssertionError("the Python resolver differs from the native runtime")
    emit({"phase": "host_resolve_python", "buffers": 64, "equal_native": True,
          "messages": len(runs[False][0]), "python_s": runs[False][2],
          "native_s": runs[True][2], "launches": launches})
    return launches


def debug_golden_phase(tmp: Path) -> dict:
    """cli.main --debug p, C and D on the committed input on the card: each
    byte-equal to the reference binary's own output."""
    from dump1090_tpu_torch.ops import _cuda

    golden = REPO / "tests" / "golden"
    secs = {}
    torch.cuda.synchronize()
    _cuda.reset_launches()
    for flag, name in (("p", "golden_debug_p.txt"), ("C", "golden_debug_C_synth.txt"),
                       ("D", "golden_debug_D_synth.txt")):
        out = tmp / f"debug_{flag}.txt"
        with contextlib.chdir(tmp):
            secs[flag] = run_cli(["--ifile", str(golden / "debug_p_input.bin"), "--debug", flag],
                                 out)
        if out.read_bytes() != (golden / name).read_bytes():
            raise AssertionError(f"--debug {flag} differs from tests/golden/{name}")
    launches = dict(_cuda.launches)
    emit({"phase": "debug_golden", "equal": ["golden_debug_p.txt", "golden_debug_C_synth.txt",
                                             "golden_debug_D_synth.txt"],
          "seconds": secs, "launches": launches})
    return launches


def debug_vs_cpu_phase(first16: Path, tmp: Path) -> dict:
    """--debug cdj over the first 16 dense buffers through cli.main on the
    card (counted) and with --device cpu: stdout and frames.js byte-equal."""
    from dump1090_tpu_torch.ops import _cuda

    outs, secs, launches = {}, {}, {}
    for d in ("cuda", "cpu"):
        work = tmp / f"debug_{d}"
        work.mkdir()
        if d == "cuda":
            torch.cuda.synchronize()
            _cuda.reset_launches()
        with contextlib.chdir(work):
            secs[d] = run_cli(["--ifile", str(first16), "--device", d, "--debug", "cdj"],
                              work / "stdout.txt")
        if d == "cuda":
            launches = dict(_cuda.launches)
        outs[d] = ((work / "stdout.txt").read_bytes(), (work / "frames.js").read_bytes())
    if outs["cuda"] != outs["cpu"]:
        raise AssertionError("--debug cdj on the card differs from --device cpu")
    records = outs["cuda"][1].count(b"frames.push(")
    if records == 0:
        raise AssertionError("--debug cdj wrote no frames.js record")
    emit({"phase": "debug_vs_cpu", "buffers": 16, "equal": True, "stdout_bytes": len(outs["cuda"][0]),
          "frames_js_records": records, "frames_js_bytes": len(outs["cuda"][1]),
          "cuda_s": secs["cuda"], "cpu_s": secs["cpu"], "launches": launches})
    return launches


def captures_host_phase(blocks: list, planted: list, dev: torch.device, n: int = 16) -> dict:
    """decode_captures(device_resolve=False) on 16 of the multi-capture
    phase's captures, on the card (counted): per capture, field for field,
    equal to the device strategy, and every clean planted frame there."""
    from dump1090_tpu_torch import decode_captures
    from dump1090_tpu_torch.ops import _cuda

    caps, want = captures_from_blocks(blocks, planted, n, lambda k: 4 + (5 * k) % 13, lambda k: k)
    with frozen_clock():
        torch.cuda.synchronize()
        _cuda.reset_launches()
        t0 = time.perf_counter()
        host = decode_captures(caps, device=dev, device_resolve=False)
        torch.cuda.synchronize()
        host_s = time.perf_counter() - t0
        launches = dict(_cuda.launches)
        t0 = time.perf_counter()
        on_dev = decode_captures(caps, device=dev)
        dev_s = time.perf_counter() - t0
    for k, (a, b) in enumerate(zip(host, on_dev)):
        if as_tuples(a) != as_tuples(b):
            raise AssertionError(f"capture {k}: the host strategy differs from the device strategy")
    frames = check_planted(host, want)
    emit({"phase": "decode_captures_host", "captures": n, "equal_device_strategy": True,
          "buffers": sum(len(c) // DATA_LEN_BYTES for c in caps), "messages": sum(len(r) for r in host),
          "planted_checked": frames, "host_strategy_s": host_s, "device_strategy_s": dev_s,
          "launches": launches})
    return launches


def verbose_host_phase(first: Path, tmp: Path) -> None:
    """The plain verbose CLI over the first group with the resolver on the
    device (on: run_device, messages_from_device_arrays) and on the host
    (off: native records, RecordMessage built lazily), in turns on, off,
    off, on: byte-equal, with the wall time of each."""
    outs, secs = {}, collections.defaultdict(list)
    for k, mode in enumerate(("on", "off", "off", "on")):
        out = tmp / f"verbose_{mode}_{k}.txt"
        secs[mode].append(run_cli(["--ifile", str(first), "--tpu-device-resolve", mode], out))
        outs.setdefault(mode, out.read_bytes())
        out.unlink()
    if outs["on"] != outs["off"]:
        raise AssertionError("the verbose CLI differs between --tpu-device-resolve on and off")
    emit({"phase": "verbose_host_vs_device", "buffers": 512, "equal": True,
          "on_s": secs["on"], "off_s": secs["off"], "stdout_bytes": len(outs["on"])})


def front_variants_phase(xg: torch.Tensor, path: Path, raw_want: bytes, tmp: Path) -> dict:
    """The five preamble-scan formulations on one dense 512-buffer group
    through _group_front at max_candidates 256: (n, pos) bit-equal to the
    mask form's, each timed by CUDA events (median of 5 rounds that take the
    variants in turn; magnitudes included); then the file decode of the 3
    groups through cli.main --raw --tpu-front packed (counted), byte-equal
    to the mask decode's."""
    from dump1090_tpu_torch.ops import _cuda
    from dump1090_tpu_torch.ops.demod import FRONTS
    from dump1090_tpu_torch.ops.resolve import _group_front

    kw = dict(scan_len=131070, max_candidates=256)
    _, n_ref, pos_ref = _group_front(xg, front="mask", **kw)
    for front in FRONTS:
        _, n, pos = _group_front(xg, front=front, **kw)
        if not (torch.equal(n, n_ref) and torch.equal(pos, pos_ref)):
            raise AssertionError(f"front {front}: (n, pos) differ from the mask form's")
    # 5 rounds, each timing every variant in turn, so drift hits all alike
    times = collections.defaultdict(list)
    for _ in range(5):
        for front in FRONTS:
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            _group_front(xg, front=front, **kw)
            e1.record()
            e1.synchronize()
            times[front].append(e0.elapsed_time(e1))
    ms = {front: sorted(t)[2] for front, t in times.items()}
    torch.cuda.synchronize()
    _cuda.reset_launches()
    cli_s = run_cli(["--ifile", str(path), "--raw", "--tpu-front", "packed"], tmp / "packed.txt")
    launches = dict(_cuda.launches)
    if (tmp / "packed.txt").read_bytes() != raw_want:
        raise AssertionError("--tpu-front packed differs from the mask decode's --raw")
    emit({"phase": "front_variants", "buffers": int(n_ref.numel()), "max_candidates": 256,
          "preambles": int(n_ref.sum().item()), "equal_mask": True,
          "group_front_ms_median_of_5": ms, "cli_packed_raw_equal": True, "cli_packed_s": cli_s,
          "launches": launches})
    return launches


def preload_phase(path: Path, raw_want: bytes, tmp: Path) -> dict:
    """cli.main --raw over the 3 groups under --tpu-preload auto, staged and
    off: byte-equal, with each run's wall time and its time to the first
    byte of stdout.  Returns the launches of the staged run."""
    from dump1090_tpu_torch.ops import _cuda

    res, launches = {}, {}
    for mode in ("auto", "staged", "off"):
        out, timing = tmp / f"preload_{mode}.txt", {}
        torch.cuda.synchronize()
        _cuda.reset_launches()
        wall = run_cli(["--ifile", str(path), "--raw", "--tpu-preload", mode], out, timing)
        launches[mode] = dict(_cuda.launches)
        if out.read_bytes() != raw_want:
            raise AssertionError(f"--tpu-preload {mode} differs from the file decode's --raw")
        res[mode] = {"wall_s": wall, "first_line_s": timing["first_s"]}
        out.unlink()
    emit({"phase": "preload", "groups": 3, "equal": True, **res, "launches": launches})
    return launches["staged"]


def _build_stub() -> Path:
    """tests/stub_rtlsdr.c built with gcc into the package's build
    directory: a librtlsdr that replays $RTLSDR_STUB_DATA."""
    from dump1090_tpu_torch.ops import _cuda

    out = _cuda.BUILD_DIR / "stub" / "librtlsdr_stub.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run(["gcc", "-O2", "-shared", "-fPIC", str(REPO / "tests" / "stub_rtlsdr.c"),
                    "-o", str(out)], check=True, capture_output=True, timeout=120)
    return out


@contextlib.contextmanager
def stub_radio(lib: Path, data: Path, delay_us: int | None):
    """The stub radio's variables set for this process and its children,
    and put back after."""
    import os

    keys = ("DUMP1090_TPU_LIBRTLSDR", "RTLSDR_STUB_DATA", "RTLSDR_STUB_DELAY_US")
    saved = {k: os.environ.get(k) for k in keys}
    os.environ["DUMP1090_TPU_LIBRTLSDR"] = str(lib)
    os.environ["RTLSDR_STUB_DATA"] = str(data)
    os.environ.pop("RTLSDR_STUB_DELAY_US", None)
    if delay_us is not None:
        os.environ["RTLSDR_STUB_DELAY_US"] = str(delay_us)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def live_phase(data: bytes, dev: torch.device, tmp: Path, n_live: int = 64) -> tuple:
    """The live path with the stub radio (tests/stub_rtlsdr.c), at the
    reference's geometry: one 256 KiB transfer a dispatch, max_candidates
    256, over 64 transfers of the dense air, after a warm-up.

    Correctness: run_source_device at a 200 ms pace (counted) must take all
    64 buffers, and its messages and counters must equal run_source's (host
    resolve, the C++ runtime) over the buffers it was handed and
    run_device's over the same bytes as a file.  Measurement: the same 64
    transfers at the radio's pace (65.536 ms apart): buffers sent, handed
    over and decoded, and per buffer the time from its hand-over to its
    last emit (which includes waiting for the next buffer: the dispatch
    queue fetches a group once the next is dispatched) and from the next
    buffer's hand-over to that last emit.  Then the live CLI: cli.main
    --device-index 0 --gain 40 --raw over one transfer (counted) and the
    same as a `python -m dump1090_tpu_torch` subprocess, both equal to the
    file decode of the same bytes.  Returns the launches of the correctness
    run and of the in-process CLI run."""
    from dump1090_tpu_torch.io.rtlsdr import RtlSdrSource
    from dump1090_tpu_torch.models import pipeline as pl
    from dump1090_tpu_torch.models.pipeline import DemodPipeline, PipelineConfig
    from dump1090_tpu_torch.ops import _cuda

    lib = _build_stub()
    air = tmp / "live.bin"
    air.write_bytes(data[: n_live * DATA_LEN_BYTES])

    def pipeline(**kw):
        return DemodPipeline(PipelineConfig(), clock=lambda: NOW, device=dev, **kw)

    def handed_over(gen, log):
        for buf in gen:
            log.append((time.perf_counter(), buf))
            yield buf

    # warm-up: kernels loaded, the live shapes allocated on the card
    with open(air, "rb") as f:
        pipeline().run_device(io.BytesIO(f.read(4 * DATA_LEN_BYTES)), lambda mm: None)
    torch.cuda.synchronize()

    with stub_radio(lib, air, 200_000):
        handed, msgs = [], []
        p = pipeline()
        _cuda.reset_launches()
        t0 = time.perf_counter()
        p.run_source_device(handed_over(RtlSdrSource(err=io.StringIO()).buffers(), handed),
                            msgs.append)
        torch.cuda.synchronize()
        paced_s = time.perf_counter() - t0
        launches = dict(_cuda.launches)
    if len(handed) != n_live:
        raise AssertionError(f"the paced live run took {len(handed)} of {n_live} buffers")
    host, host_msgs = pipeline(native=True), []
    host.run_source([b for _, b in handed], host_msgs.append)
    ref, ref_msgs = pipeline(), []
    with open(air, "rb") as f:
        ref.run_device(f, ref_msgs.append)
    got = as_tuples(msgs)
    if got != as_tuples(host_msgs) or vars(p.stats) != vars(host.stats):
        raise AssertionError("run_source_device differs from run_source on the live buffers")
    if got != as_tuples(ref_msgs) or vars(p.stats) != vars(ref.stats):
        raise AssertionError("run_source_device differs from run_device on the same file")

    # the radio's own pace: what a dongle would deliver
    batch_t, last_emit, rt_msgs, marks = [], {}, [], []
    real_decode, real_dispatch = pl.messages_from_device_arrays, pl.demod_resolve_group

    def decode(*a):
        batch_t.append(time.perf_counter())
        return real_decode(*a)

    def dispatch(*a, **k):
        marks.append([])
        t0 = time.perf_counter()
        out = real_dispatch(*a, marks=marks[-1], **k)
        marks[-1].append(("issue_s", time.perf_counter() - t0))
        return out

    def on_message(mm):
        last_emit[len(batch_t) - 1] = time.perf_counter()
        rt_msgs.append(mm)

    pl.messages_from_device_arrays, pl.demod_resolve_group = decode, dispatch
    try:
        with stub_radio(lib, air, 65_536):
            rt_handed, rt = [], pipeline()
            t0 = time.perf_counter()
            rt.run_source_device(handed_over(RtlSdrSource(err=io.StringIO()).buffers(),
                                             rt_handed), on_message)
            rt_s = time.perf_counter() - t0
    finally:
        pl.messages_from_device_arrays, pl.demod_resolve_group = real_decode, real_dispatch
    # per dispatch: device time between the first and the last stage event,
    # and the host's time to issue it (a replayed buffer counts twice)
    device_ms = [m[0][1].elapsed_time(m[-2][1]) for m in marks]
    issue_ms = [m[-1][1] * 1e3 for m in marks]
    done = [last_emit.get(k, batch_t[k]) for k in range(len(batch_t))]
    latency = [(done[k] - rt_handed[k][0]) * 1e3 for k in range(len(done))]
    after_next = [(done[k] - rt_handed[k + 1][0]) * 1e3 for k in range(len(done) - 1)]

    def spread(v):
        return {"median": float(np.median(v)), "max": max(v), "min": min(v)} if v else None

    # the live CLI over one transfer, which nothing can overwrite
    one = tmp / "live_one.bin"
    one.write_bytes(data[:DATA_LEN_BYTES])
    with open(one, "rb") as f:
        want = b"".join(pipeline().stream_raw_device(f))
    with stub_radio(lib, one, None):
        torch.cuda.synchronize()
        _cuda.reset_launches()
        cli_s = run_cli(["--device-index", "0", "--gain", "40", "--raw"], tmp / "live_cli.txt")
        cli_launches = dict(_cuda.launches)
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-m", "dump1090_tpu_torch", "--device-index", "0",
                            "--gain", "40", "--raw"], cwd=REPO, capture_output=True, timeout=300)
        sub_s = time.perf_counter() - t0
    if (tmp / "live_cli.txt").read_bytes() != want or not want:
        raise AssertionError("the live CLI's --raw differs from the file decode of its bytes")
    if r.returncode != 0 or r.stdout != want:
        raise AssertionError(f"the live CLI subprocess differs (rc {r.returncode}): "
                             f"{r.stderr.decode()[-2000:]}")
    if b"Setting gain to: 40.00" not in r.stderr:
        raise AssertionError("the live CLI subprocess did not set the gain")
    emit({"phase": "live", "buffer_ms": 65.536, "max_candidates": 256,
          "paced_200ms": {"buffers_sent": n_live, "buffers_decoded": len(handed),
                          "messages": len(msgs), "crcok": sum(m.crcok for m in msgs),
                          "equal_run_source": True, "equal_run_device_file": True,
                          "stats_equal": True, "wall_s": paced_s},
          "real_pace": {"buffers_sent": n_live, "buffers_handed_over": len(rt_handed),
                        "buffers_decoded": len(batch_t),
                        "buffers_dropped": n_live - len(rt_handed),
                        "messages": len(rt_msgs), "wall_s": rt_s,
                        "handover_to_last_emit_ms": spread(latency),
                        "next_handover_to_last_emit_ms": spread(after_next),
                        "dispatches": len(marks), "device_ms_per_dispatch": spread(device_ms),
                        "issue_ms_per_dispatch": spread(issue_ms)},
          "cli_equal_file": True, "cli_subprocess_equal": True, "cli_lines": len(want.split()),
          "cli_s": cli_s, "cli_subprocess_s": sub_s, "launches": launches,
          "cli_launches": cli_launches})
    return launches, cli_launches


def profile_phase(first: Path, raw_want: bytes, tmp: Path) -> dict:
    """cli.main --raw --tpu-profile <dir> over one group (counted): the same
    bytes as without it, and a Chrome trace in <dir> that names the K1 and
    K2 kernels."""
    from dump1090_tpu_torch.ops import _cuda

    prof = tmp / "profile"
    torch.cuda.synchronize()
    _cuda.reset_launches()
    wall = run_cli(["--ifile", str(first), "--raw", "--tpu-profile", str(prof)],
                   tmp / "profile.txt")
    launches = dict(_cuda.launches)
    if (tmp / "profile.txt").read_bytes() != raw_want:
        raise AssertionError("--tpu-profile changed the --raw output")
    traces = sorted(prof.glob("dump1090_tpu_torch.*.pt.trace.json"))
    if len(traces) != 1:
        raise AssertionError(f"--tpu-profile wrote {len(traces)} traces")
    events = json.loads(traces[0].read_text())["traceEvents"]
    cats = collections.Counter(str(e.get("cat")) for e in events)
    # full names: nvcc's may start with "(anonymous namespace)::"
    kernels = collections.Counter(str(e.get("name")) for e in events
                                  if e.get("cat") == "kernel")
    named = {k: sum(c for name, c in kernels.items() if k in name)
             for k in ("gather_windows_kernel", "resolve_words_kernel")}
    if not all(named.values()):
        top = [(k[:80], c) for k, c in kernels.most_common(12)]
        raise AssertionError(f"the trace does not name K1 and K2: {named}; categories "
                             f"{dict(cats)}; kernels {top}")
    emit({"phase": "profile", "buffers": 512, "raw_equal": True,
          "trace_bytes": traces[0].stat().st_size, "events": len(events),
          "kernel_events": sum(kernels.values()), "kernel_names": len(kernels),
          "named": named, "wall_s": wall, "launches": launches})
    return launches


def straddle_block(sp: int) -> tuple:
    """The synthetic air of the JAX package's multi-chip dry run
    (__graft_entry__.py::dryrun_multichip), on one block: 3*sp clean DF17
    frames over silence, three in each of the sp shards of the first
    buffer, the third of them across the shard's right edge (the last one
    into the buffer's post-scan tail).  Positions count from the buffer's
    start, whose first 238 samples are the initial silent carry.  Returns
    (DATA_LEN_BYTES IQ bytes, the frames in order)."""
    from dump1090_tpu_torch.constants import BLOCK_SAMPLES, CARRY_SAMPLES, SCAN_POSITIONS
    from dump1090_tpu_torch.utils.synth import frame_to_iq, make_df17_frame

    shard = -(-SCAN_POSITIONS // sp)
    iq = np.full(2 * BLOCK_SAMPLES, 127, dtype=np.uint8)
    frames = []
    for s in range(sp):
        for k, at in enumerate((shard // 3, 2 * shard // 3, shard - 120)):
            frame = make_df17_frame(0x4D2023 + 3 * s + k)
            x = frame_to_iq(frame, pad_before=0, pad_after=0)
            off = 2 * (s * shard + at - CARRY_SAMPLES)
            iq[off:off + len(x)] = x
            frames.append(frame)
    return iq.tobytes(), frames


def sharded_phase(blocks: list, planted: list, dev: torch.device, tmp: Path) -> dict:
    """The time-sharded decode (api.decode_capture_sharded: K1 gathers each
    shard's windows, K2 replays the candidate segments) on one card, meshes
    repeating cuda:0.

    Correctness, on the dry run's air (straddle_block, sp = 4) followed by
    4 dense blocks, max_candidates starting at 16 (it grows): meshes (1, 1),
    (1, 4) and (2, 4), device_resolve True and False, in the three decoder
    modes (default, --aggressive, --no-fix), every message field and the 8
    counters equal to the unsharded decode (DemodPipeline.run_device, the
    engine of decode_capture) on the card and to the same call on the CPU,
    and every clean planted frame found in order; a (32, 2) mesh over 32
    dense buffers, from max_candidates 64, grows the emitted-message room
    too and equals the unsharded decode; --tpu-shard-time 1 --raw through cli.main byte-equal
    to --raw; initialize_from_env() is False with no launcher variables, and
    the multi-process worker passes at world size 1 with 4 shards on the
    card under --bench (8 timed steps of the sharded step, counted on its
    own).  K1 and K2 are held against their plain versions
    at the shapes of the sharded path.  Measurement, counted: the (1, 4)
    and (2, 4) decodes with the device resolve over 64 dense buffers (wall
    time, Msamples/s).  Returns the launches of the (2, 4) run and of the
    worker's --bench."""
    import os

    from dump1090_tpu_torch import api, decode_capture_sharded
    from dump1090_tpu_torch.constants import BLOCK_SAMPLES
    from dump1090_tpu_torch.models.decoder import DecoderConfig, DecoderStats, IcaoCache
    from dump1090_tpu_torch.models.pipeline import DemodPipeline, PipelineConfig
    from dump1090_tpu_torch.ops import _cuda, resolve
    from dump1090_tpu_torch.parallel import multihost, multihost_worker, sharding

    t_phase = time.perf_counter()
    air, frames = straddle_block(4)
    capture = air + b"".join(blocks[:4])
    want = [frames + [f for b, _, f, nflip in planted if b < 4 and nflip == 0]]
    modes = {"default": {}, "aggressive": {"aggressive": True}, "no-fix": {"fix_errors": False}}

    def mesh(dp: int, sp: int, d) -> sharding.Mesh:
        return sharding.Mesh([[d] * sp for _ in range(dp)])

    def unsharded(data: bytes, cfg, d) -> tuple:
        p = DemodPipeline(PipelineConfig(decoder=cfg), clock=lambda: NOW, device=d)
        out = []
        p.run_device(io.BytesIO(data), out.append)
        return [dataclasses.asdict(m) for m in out], dataclasses.astuple(p.stats)

    def sharded(data: bytes, m, dr: bool, cfg, mc: int = 16) -> tuple:
        st, cache = DecoderStats(), IcaoCache(clock=lambda: NOW)
        msgs = decode_capture_sharded(data, mesh=m, config=cfg, stats=st, cache=cache,
                                      max_candidates=mc, device_resolve=dr)
        return [dataclasses.asdict(x) for x in msgs], dataclasses.astuple(st), msgs

    checked = 0
    t_matrix = time.perf_counter()
    for mode, kw in modes.items():
        cfg = DecoderConfig(**kw)
        ref = unsharded(capture, cfg, dev)
        if unsharded(capture, cfg, "cpu") != ref:
            raise AssertionError(f"[{mode}] the unsharded decode on the card differs from the CPU")
        for shape in ((1, 1), (1, 4), (2, 4)):
            for dr in (True, False):
                torch.cuda.synchronize()
                _cuda.reset_launches()
                card = sharded(capture, mesh(*shape, dev), dr, cfg)
                torch.cuda.synchronize()
                if _cuda.launches["gather_windows"] <= 0 or (dr and _cuda.launches["resolve_words"] <= 0):
                    raise AssertionError(f"[{mode}] {shape} device_resolve={dr}: a kernel was not launched")
                if card[:2] != ref:
                    raise AssertionError(f"[{mode}] the {shape} mesh (device_resolve={dr}) "
                                         f"differs from the unsharded decode")
                if sharded(capture, mesh(*shape, "cpu"), dr, cfg)[:2] != card[:2]:
                    raise AssertionError(f"[{mode}] the {shape} mesh (device_resolve={dr}) "
                                         f"on the card differs from the CPU")
                checked += check_planted([card[2]], want)
    matrix_s = time.perf_counter() - t_matrix

    # both overflows: 32 rows of dense air a group emit more than the 4096
    # messages the device resolve starts with
    dense32 = b"".join(blocks[:16]) * 2
    cfg = DecoderConfig()
    seen = []
    real_rcs = api.resolve_candidate_segments

    def counting(*a, **k):
        seen.append((a[0].shape[1], k["max_out"]))
        return real_rcs(*a, **k)

    api.resolve_candidate_segments = counting
    t_grow = time.perf_counter()
    try:
        grown = sharded(dense32, mesh(32, 2, dev), True, cfg, mc=64)
    finally:
        api.resolve_candidate_segments = real_rcs
    if grown[:2] != unsharded(dense32, cfg, dev):
        raise AssertionError("the (32, 2) mesh differs from the unsharded decode")
    if not (max(m for m, _ in seen) > 64 and max(o for _, o in seen) > api.SHARDED_MAX_OUT):
        raise AssertionError(f"the (32, 2) run did not grow both shapes: {sorted(set(seen))}")
    grow_s = time.perf_counter() - t_grow

    # the CLI: --tpu-shard-time 1 --raw against --raw
    path = tmp / "sharded.bin"
    path.write_bytes(capture)
    run_cli(["--ifile", str(path), "--raw"], tmp / "raw.txt")
    cli_s = run_cli(["--ifile", str(path), "--raw", "--tpu-shard-time", "1"], tmp / "shard1.txt")
    raw = (tmp / "raw.txt").read_bytes()
    if (tmp / "shard1.txt").read_bytes() != raw or len(raw.split()) < len(want[0]):
        raise AssertionError("--tpu-shard-time 1 --raw differs from --raw")

    # the multi-process session at world size 1 (one card cannot hold two
    # NCCL ranks); then the worker's --bench (the JAX package's only timing
    # of the sharded step): 131,072 samples over 4 shards of the card,
    # counted as a path of its own
    env = dict(os.environ)
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        os.environ.pop(k, None)
    try:
        if multihost.initialize_from_env() is not False:
            raise AssertionError("initialize_from_env() started a session with no launcher variables")
        out = io.StringIO()
        torch.cuda.synchronize()
        _cuda.reset_launches()
        with contextlib.redirect_stdout(out):
            rc = multihost_worker.main(["0", "1", "0", "--devices-per-proc", "4", "--bench",
                                        "--steps", "8"])
        torch.cuda.synchronize()
        bench_launches = dict(_cuda.launches)
    finally:
        os.environ.clear()
        os.environ.update(env)
    lines = out.getvalue().splitlines()
    pass_line = next((ln for ln in lines if ln.startswith("MULTIHOST PASS")), "")
    bench_line = next((ln for ln in lines if ln.startswith("MULTIHOST BENCH ")), "")
    if rc != 0 or not pass_line or not bench_line:
        raise AssertionError(f"the multi-process worker failed at world size 1: {out.getvalue()}")
    worker_bench = {"s_per_step": float(bench_line.split()[2]), "line": bench_line,
                    "nvidia_smi": nvidia_smi(), "launches": bench_launches}
    print(f"sharded step (worker --bench): {worker_bench['s_per_step']} s/step on "
          f"{worker_bench['nvidia_smi']}", flush=True)

    # measurement, counted: 64 dense buffers, device resolve; K1's and K2's
    # inputs recorded at the first call for the kernel checks
    data64 = b"".join(blocks[:16]) * 4
    want64 = [[f for b, _, f, nflip in planted if nflip == 0] * 4]
    timing, inputs = {}, {}
    real_gather, real_walk = sharding.gather_row_windows, resolve.resolve_words

    def gather_rec(m_ext, pos, **kw):
        inputs.setdefault("gather", (m_ext, pos, kw))
        return real_gather(m_ext, pos, **kw)

    def walk_rec(*a, **k):
        inputs.setdefault("walk", a)
        return real_walk(*a, **k)

    launches, outs = None, {}
    for shape in ((1, 4), (2, 4)):
        inputs.clear()  # the kernel checks take the (2, 4) run's first calls
        sharding.gather_row_windows, resolve.resolve_words = gather_rec, walk_rec
        try:
            torch.cuda.synchronize()
            _cuda.reset_launches()
            t1 = time.perf_counter()
            outs[shape] = sharded(data64, mesh(*shape, dev), True, cfg, mc=128)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t1
        finally:
            sharding.gather_row_windows, resolve.resolve_words = real_gather, real_walk
        launches = dict(_cuda.launches)
        timing[f"{shape[0]}x{shape[1]}"] = {
            "wall_s": wall, "msps": 64 * BLOCK_SAMPLES / wall / 1e6, "launches": launches,
            "messages": len(outs[shape][2])}
        check_planted([outs[shape][2]], want64)
    if outs[(1, 4)][:2] != outs[(2, 4)][:2]:
        raise AssertionError("the (1, 4) and (2, 4) decodes of the 64 buffers differ")

    # K1 and K2 at the sharded path's shapes against their plain versions
    m_ext, pos, kw = inputs["gather"]
    k1_sharded = k1_check(m_ext, pos, kw["lead"], kw["s_pad"], 50)
    walk = inputs["walk"]
    got = resolve.resolve_words(*walk)
    err_w = max(max_abs_err(g, w) for g, w in zip(got, resolve.resolve_words_plain(*walk)))
    torch.cuda.synchronize()
    if err_w:
        raise AssertionError(f"K2 differs from its plain version on the sharded path: {err_w}")
    kernels = {
        "gather_windows": k1_sharded,
        "resolve_words": {"slots": walk[0].numel(), "segments": walk[4].numel(),
                          "steps": int(walk[4].clamp(0, walk[-1]).sum().item()),
                          "max_abs_err": err_w,
                          "ms": cuda_ms(lambda: resolve.resolve_words(*walk), 10)},
    }
    emit({"phase": "sharded", "capture_buffers": len(capture) // DATA_LEN_BYTES,
          "meshes": ["1x1", "1x4", "2x4"], "modes": list(modes), "equal_unsharded": True,
          "equal_cpu": True, "planted_checked": checked, "matrix_s": matrix_s,
          "grow_s": grow_s, "grown_32x2": sorted(set(seen)),
          "cli_shard1_raw_equal": True, "cli_s": cli_s, "initialize_from_env": False,
          "worker": pass_line, "worker_bench": worker_bench, "dense64": timing,
          "kernels_sharded": kernels, "phase_s": time.perf_counter() - t_phase})
    return launches, bench_launches


FUZZ_MODES = ("device", "device-nofix", "device-aggressive", "raw", "sharded-device",
              "device-verbose")


def crcok_phase(data: bytes, dev: torch.device) -> dict:
    """The emission's crcok_only on the card (ops.resolve): the first 4
    dense buffers as a group of 2 batches of 2 at mc 256, four calls --
    demod_resolve_group with its defaults (packed, good-CRC decodes only),
    with packed=True, crcok_only=False (every attempted decode), with
    packed=True, crcok_only=True, and demod_resolve_batch(packed=True,
    crcok_only=False) over the 4 buffers as one batch -- each output array
    equal to the same call on the CPU.  The defaults equal the explicit
    good-CRC call, every decode outnumbers the good ones, and the batch
    emits the group's total.  Counted as a path of its own; K1 and K2 are
    held to their plain versions on each call's inputs.  Returns the
    launches."""
    from dump1090_tpu_torch.io.sources import iq_buffers
    from dump1090_tpu_torch.ops import _cuda
    from dump1090_tpu_torch.ops.resolve import (
        clamp_packed_out,
        demod_resolve_batch,
        demod_resolve_group,
    )

    t_phase = time.perf_counter()
    bufs = np.stack(list(iq_buffers(io.BytesIO(data[: 5 * DATA_LEN_BYTES]))))[:4]
    mos, mol = clamp_packed_out(4096, 4096)
    shapes = dict(scan_len=131070, max_candidates=256, max_out_short=mos, max_out_long=mol)
    group = bufs.reshape(2, 2, -1)
    calls = {
        "defaults": (demod_resolve_group, group, {}),
        "packed_every": (demod_resolve_group, group, dict(packed=True, crcok_only=False)),
        "packed_good": (demod_resolve_group, group, dict(packed=True, crcok_only=True)),
        "batch_packed_every": (demod_resolve_batch, bufs, dict(packed=True, crcok_only=False)),
    }

    def run(name: str, d) -> list:
        fn, x, kw = calls[name]
        z = torch.zeros(1024, dtype=torch.int32, device=d)
        out = fn(torch.from_numpy(x).to(d), z, z.clone(), NOW, True, False, **shapes, **kw)
        return [o.cpu().numpy() for o in out]

    current = [None]
    card = {}
    torch.cuda.synchronize()
    _cuda.reset_launches()
    with kernel_inputs(lambda kind, mc, n: current[0]) as rec:
        for name in calls:
            current[0] = name
            card[name] = run(name, dev)
        torch.cuda.synchronize()
    launches = dict(_cuda.launches)
    counts = {}
    for name in calls:
        cpu = run(name, "cpu")
        for k, (a, b) in enumerate(zip(card[name], cpu, strict=True)):
            if not np.array_equal(a, b):
                raise AssertionError(f"crcok {name}: output {k} on the card differs from the CPU")
        count, clong = card[name][1], card[name][2]
        if ((count - clong) > mos).any() or (clong > mol).any():
            raise AssertionError(f"crcok {name}: the emission overflowed its caps")
        counts[name] = {"decodes": int(count.sum()), "shorts": int((count - clong).sum()),
                        "longs": int(clong.sum())}
    good, every = counts["defaults"], counts["packed_every"]
    if good != counts["packed_good"] or not good["decodes"] > 0:
        raise AssertionError(f"crcok: the defaults are not the good-CRC emission: {counts}")
    if not every["decodes"] > good["decodes"] or counts["batch_packed_every"] != every:
        raise AssertionError(f"crcok: every attempted decode was not emitted: {counts}")
    kernels = check_kernel_inputs(rec, "crcok")
    emit({"phase": "crcok", "buffers": 4, "group": [2, 2], "mc": 256, "caps": [mos, mol],
          "counts": counts, "equal_cpu": True, "launches": launches, "kernels": kernels,
          "phase_s": time.perf_counter() - t_phase})
    return launches


@contextlib.contextmanager
def kernel_inputs(pick):
    """Record K1's and K2's inputs on the pipeline's dispatch path
    (ops.demod.gather_row_windows, ops.resolve.resolve_words) while the
    block runs.  pick(kind, mc, n) names the record a call belongs to (kind
    "k1" or "k2", mc its candidate slots a buffer, n K1's rows or K2's
    slots), or None; a name keeps the tensors (cloned before the call) of
    the last call given it.
    Yields {(name, kind): (args, kwargs)}; thread-safe, for the soak's
    planes."""
    import threading

    from dump1090_tpu_torch.ops import demod, resolve

    rec, lock = {}, threading.Lock()
    real = {"k1": demod.gather_row_windows, "k2": resolve.resolve_words}

    def wrap(kind, mc_of):
        def call(*a, **k):
            name = pick(kind, mc_of(a), a[0].shape[0])
            if name is not None:
                kept = tuple(x.clone() if torch.is_tensor(x) else x for x in a)
                with lock:
                    rec[(name, kind)] = (kept, dict(k))
            return real[kind](*a, **k)
        return call

    demod.gather_row_windows = wrap("k1", lambda a: a[1].shape[1])
    resolve.resolve_words = wrap("k2", lambda a: a[8])
    try:
        yield rec
    finally:
        demod.gather_row_windows, resolve.resolve_words = real["k1"], real["k2"]


def check_kernel_inputs(rec: dict, where: str) -> dict:
    """K1 (k1_check) and K2 (against resolve_words_plain) on each recorded
    call of kernel_inputs; raises on any difference.  Returns per name the
    K1 shape, the K2 slots, `now`, the cache's valid and aged (older than
    the ICAO TTL) entries, each error and time."""
    from dump1090_tpu_torch.constants import ICAO_CACHE_TTL
    from dump1090_tpu_torch.ops import resolve

    out = {}
    for name in sorted({n for n, _ in rec}):
        r = out[name] = {}
        if (name, "k1") in rec:
            (m, pos), kw = rec[(name, "k1")]
            k = k1_check(m, pos, kw["lead"], kw["s_pad"], 20)
            r["k1"] = {x: k[x] for x in ("shape", "max_abs_err", "ms", "plain_ms")}
        if (name, "k2") in rec:
            walk, _ = rec[(name, "k2")]
            got = resolve.resolve_words(*walk)
            err = max(max_abs_err(g, w) for g, w in zip(got, resolve.resolve_words_plain(*walk)))
            torch.cuda.synchronize()
            if err:
                raise AssertionError(f"{where}: K2 differs from its plain version at {name}: {err}")
            ca, ct, now, mc = walk[5], walk[6], walk[7], walk[8]
            valid = ca != 0
            r["k2"] = {"slots": walk[0].numel(), "mc": mc, "now": now,
                       "cache_valid": int(valid.sum()),
                       "cache_aged": int((valid & (now - ct.to(torch.int64) > ICAO_CACHE_TTL)).sum()),
                       "max_abs_err": err,
                       "ms": cuda_ms(lambda: resolve.resolve_words(*walk), 5)}
    return out


def fuzz_phase(seed: int, dev: torch.device, n: int = 24) -> dict:
    """The differential fuzz (dump1090_tpu_torch.tools.fuzz_diff) on the
    card, counted: `n` random streams of 1-3 buffers from `seed`, the first
    six one of each recipe (noise, garbage, planted frames twice, clustered
    frames, frames across a buffer boundary), each in FUZZ_MODES: the file
    decode with the device resolver in three decoder modes, the host
    resolve (`raw`, K1 only), the sharded decode on a (1, 4) mesh of the
    card and the CLI's verbose display with the device resolver (cli.main
    in this process).  Every mode's lines on the card must equal the same
    mode on the CPU.  K1's and K2's inputs of the last dispatch of each
    recipe stream's `device` decode (1-3 buffers a batch) are recorded and
    each kernel is held against its plain version on them.  Returns the
    phase's launches."""
    from dump1090_tpu_torch.ops import _cuda
    from dump1090_tpu_torch.tools import fuzz_diff

    per_mode = {m: collections.Counter() for m in FUZZ_MODES}
    card_s = collections.Counter()
    on_card = {"mode": None, "stream": -1}

    @contextlib.contextmanager
    def counted(mode):
        torch.cuda.synchronize()
        before = dict(_cuda.launches)
        on_card["mode"] = mode
        if mode == FUZZ_MODES[0]:  # each stream's first mode
            on_card["stream"] += 1
        t0 = time.perf_counter()
        try:
            yield
        finally:
            on_card["mode"] = None
        torch.cuda.synchronize()
        card_s[mode] += time.perf_counter() - t0
        per_mode[mode].update({k: _cuda.launches[k] - before[k] for k in before})

    def pick(kind, mc, n):
        k = on_card["stream"]
        return f"recipe{k}" if on_card["mode"] == "device" and k < fuzz_diff.RECIPES else None

    torch.cuda.synchronize()
    _cuda.reset_launches()
    t0 = time.perf_counter()
    with kernel_inputs(pick) as rec:
        res = fuzz_diff.fuzz(n, seed, FUZZ_MODES, dev, in_process=True, around=counted,
                             log=lambda *_: None)
    wall = time.perf_counter() - t0
    launches = dict(_cuda.launches)
    if res["fails"]:
        raise AssertionError(f"fuzz: the card differs from the CPU in (stream, mode) "
                             f"{res['fails']}")
    if sorted(res["streams_per_recipe"]) != list(range(fuzz_diff.RECIPES)):
        raise AssertionError(f"fuzz: a recipe was not drawn: {res['streams_per_recipe']}")
    for mode in FUZZ_MODES:
        used = ("gather_windows",) if mode == "raw" else ("gather_windows", "resolve_words")
        if any(per_mode[mode][k] <= 0 for k in used):
            raise AssertionError(f"fuzz: {mode} did not launch {used}: {dict(per_mode[mode])}")
    if len(rec) != 2 * fuzz_diff.RECIPES:
        raise AssertionError(f"fuzz: K1's and K2's inputs not recorded for every recipe: "
                             f"{sorted(rec)}")
    kernels = check_kernel_inputs(rec, "fuzz")
    emit({"phase": "fuzz", "seed": seed, "streams": n, "modes": list(FUZZ_MODES),
          "equal": True, "streams_per_recipe": res["streams_per_recipe"],
          "lines_compared": res["lines"],
          "launches_per_mode": {m: {k: per_mode[m][k] for k in ("gather_windows",
                                                                 "resolve_words")}
                                for m in FUZZ_MODES},
          "card_s_per_mode": dict(card_s), "phase_s": wall, "launches": launches,
          "kernels_at_recipes": kernels})
    return launches


def soak_phase(seed: int, dev: torch.device, window_min: float = 2.5) -> dict:
    """The wall-clock soaks (dump1090_tpu_torch.tools.soak_device) on the
    card, counted: the raw-stream plane (stream_raw_device) and the messages
    plane (run_device -> hub -> tracker, SBS, data.json) side by side, one
    thread and one CUDA stream each, 16-buffer batches, 2 a group, paced at
    the radio's 4 MB/s over `window_min` minutes of a live clock.  Each
    period: the 16 dense blocks of `seed`, an 8-aircraft fleet over 6 steps
    and 1,024 quiet buffers (67 s).  Then each plane's CPU replay under the
    recorded clocks.  Each plane must equal its replay byte for byte, span
    at least 120 s of clock, shrink max_candidates and grow it back; the
    messages plane must evict.  K1's and K2's inputs are recorded in each
    plane at its first dispatch with max_candidates shrunk to 64, its last
    one there (the dense air that overflows, over a cache aged past the
    TTL) and its first after the regrowth (the replay, aged cache), under
    the live `now`, and each kernel is held against its plain version on
    them.  Device time: CUDA events around each dispatch (marks=), summed
    over both planes.  Returns the launches of the card passes."""
    import threading

    from dump1090_tpu_torch.models import pipeline as pl
    from dump1090_tpu_torch.ops import _cuda
    from dump1090_tpu_torch.tools import soak_device

    args = soak_device.parser().parse_args(
        ["--wall-minutes", str(window_min), "--wall-messages", str(window_min),
         "--batch", "16", "--groups", "2", "--seed", str(seed)])
    specs = {plane: soak_device.make_spec(args, plane) for plane in soak_device.PLANES}
    spans, real_dispatch = [], pl.demod_resolve_group

    def dispatch(*a, **k):
        marks = []
        spans.append(marks)
        return real_dispatch(*a, marks=marks, **k)

    stage = {}  # (plane, kind) -> "shrunk" from the first dispatch at 64, then "regrown"

    def pick(kind, mc, n):
        plane = threading.current_thread().name.removeprefix("soak-")
        at = stage.get((plane, kind))
        if mc == 64 and at is None:
            stage[(plane, kind)] = "shrunk"
            return f"{plane}/shrunk"
        if mc == 64 and at == "shrunk":
            return f"{plane}/overflow"  # the last call at 64 is kept
        if mc > 64 and at == "shrunk":
            stage[(plane, kind)] = "regrown"
            return f"{plane}/regrown"
        return None

    torch.cuda.synchronize()
    _cuda.reset_launches()
    t0 = time.perf_counter()
    pl.demod_resolve_group = dispatch
    try:
        with contextlib.redirect_stdout(sys.stderr), kernel_inputs(pick) as rec:
            report = soak_device.soak(specs, dev)  # its PASS/FAIL lines go to stderr
    finally:
        pl.demod_resolve_group = real_dispatch
    launches = dict(_cuda.launches)  # the oracles run in CPU subprocesses
    wall = time.perf_counter() - t0
    device_s = sum(m[0][1].elapsed_time(m[-1][1]) for m in spans) / 1e3
    for plane, r in report.items():
        f = r["facts"]
        if not r["ok"]:
            raise AssertionError(f"soak {plane}: the card differs from its replay: {r['faults']}")
        if f["clock_span_s"] < 120 or f["shrinks"] < 1 or f["regrowths"] < 1:
            raise AssertionError(f"soak {plane}: too short a clock, or no shrink and regrowth: {f}")
        if plane == "messages" and f["evicted"] < 1:
            raise AssertionError(f"soak {plane}: no aircraft was evicted: {f}")
    if any(launches[k] <= 0 for k in ("gather_windows", "resolve_words")):
        raise AssertionError(f"soak: a kernel did not launch: {launches}")
    want = {(f"{p}/{at}", kind) for p in report for at in ("shrunk", "regrown")
            for kind in ("k1", "k2")}
    if not want <= set(rec):
        raise AssertionError(f"soak: K1's and K2's inputs not recorded at {sorted(want - set(rec))}")
    kernels = check_kernel_inputs(rec, "soak")
    for plane in report:
        if kernels[f"{plane}/regrown"]["k2"]["cache_aged"] < 1:
            raise AssertionError(f"soak {plane}: K2 met no aged cache entry at the regrowth: "
                                 f"{kernels[f'{plane}/regrown']}")
    emit({"phase": "soak", "window_min": window_min, "rate_mb_s": args.rate_mb_s,
          "batch": args.batch, "groups": args.groups, "quiet_bufs": args.quiet_bufs,
          "equal": True, "planes": {p: {"facts": r["facts"], "regime_shifts": r["regime_shifts"]}
                                    for p, r in report.items()},
          "oracle_s": next(iter(report.values()))["oracle_s"], "phase_s": wall,
          "dispatch_device_s": device_s, "device_share": device_s / (window_min * 60),
          "launches": launches, "kernels_at_shapes": kernels})
    return launches


class _Stdin:
    """A stand-in for sys.stdin whose `.buffer` is the read end of a pipe
    that a thread fills with `data` and then closes, so EOF arrives as it
    does from `rtl_sdr - |`."""

    def __init__(self, data: bytes):
        import os
        import threading

        r, w = os.pipe()
        self.buffer = os.fdopen(r, "rb")

        def feed():
            with os.fdopen(w, "wb") as f:
                f.write(data)

        self._thread = threading.Thread(target=feed, name="stdin-feed", daemon=True)
        self._thread.start()

    def close(self) -> None:
        self._thread.join()
        self.buffer.close()


def stdin_net_phase(iq: bytes, dev: torch.device, tmp: Path) -> dict:
    """The stdin feed, as `rtl_sdr - | dump1090 --ifile - --net` runs it:
    one buffer a dispatch.  First tools/net_capture.py's protocol (a silence
    buffer, then `iq` in whole 256 KiB buffers) through a `python -m
    dump1090_tpu_torch --ifile - --net` subprocess on the card and then with
    --device cpu: the raw-out streams byte-equal, and equal to the uppercase
    `--raw` lines of a file decode of `iq`; the SBS streams equal once the
    MSG,3 positions (a wall-clock latch pick) are canonicalized, with at
    least one MSG,3.  Then cli.main(["--ifile", "-", "--raw"]) in this
    process (counted), sys.stdin a pipe that a thread feeds: stdout equal to
    `--ifile FILE --raw`, K1 and K2 launched once a dispatch and at least
    once a buffer, the last dispatch's K1 and K2 inputs held against their
    plain versions, and the time a buffer: between successive dispatches
    (the feed outruns the decode) and over the whole run, against the
    65.536 ms of air a buffer holds.  Returns the in-process run's
    launches."""
    from dump1090_tpu_torch.models import pipeline as pl
    from dump1090_tpu_torch.ops import _cuda
    from dump1090_tpu_torch.tools import net_capture

    n_bufs = len(iq) // DATA_LEN_BYTES
    path = tmp / "stdin_air.bin"
    path.write_bytes(iq)
    file_s = run_cli(["--ifile", str(path), "--raw"], tmp / "stdin_file.txt")
    want = (tmp / "stdin_file.txt").read_bytes()

    runs, secs = {}, {}
    for d in (dev.type, "cpu"):
        t0 = time.perf_counter()
        runs[d] = net_capture.capture(net_capture.ours_cmd(d), iq, cwd=str(REPO))
        secs[f"net_capture_{d}_s"] = time.perf_counter() - t0
    card, cpu = runs[dev.type], runs["cpu"]
    if card["raw"] != cpu["raw"]:
        raise AssertionError("stdin --net: raw-out on the card differs from --device cpu")
    if card["raw"] != want.upper() or not want:
        raise AssertionError("stdin --net: raw-out differs from the file decode's --raw lines")
    canon = [net_capture.canonicalize_sbs(r["sbs"]) for r in (card, cpu)]
    if canon[0] != canon[1]:
        raise AssertionError("stdin --net: the canonical SBS stream differs from --device cpu")
    if card["sbs"].count(b"MSG,3,") < 1:
        raise AssertionError("stdin --net: no MSG,3 in the SBS stream")

    stamps, marks = [], []
    real_dispatch = pl.demod_resolve_group

    def dispatch(*a, **k):
        stamps.append(time.perf_counter())
        marks.append([])
        return real_dispatch(*a, marks=marks[-1], **k)

    stdin, real_stdin = _Stdin(iq), sys.stdin
    pl.demod_resolve_group, sys.stdin = dispatch, stdin
    try:
        with kernel_inputs(lambda kind, mc, n: "stdin") as rec:
            torch.cuda.synchronize()
            _cuda.reset_launches()
            t0 = time.perf_counter()
            wall = run_cli(["--ifile", "-", "--raw"], tmp / "stdin_raw.txt")
            launches = dict(_cuda.launches)
    finally:
        pl.demod_resolve_group, sys.stdin = real_dispatch, real_stdin
        stdin.close()
    if (tmp / "stdin_raw.txt").read_bytes() != want:
        raise AssertionError("--ifile - --raw differs from --ifile FILE --raw")
    if not (launches["gather_windows"] == launches["resolve_words"] == len(stamps) >= n_bufs):
        raise AssertionError(f"stdin: {len(stamps)} dispatches for {n_bufs} buffers, "
                             f"launches {launches}")
    kernels = check_kernel_inputs(rec, "stdin")
    per_buf = np.diff([t0] + stamps) * 1e3
    device_ms = [m[0][1].elapsed_time(m[-1][1]) for m in marks]
    emit({"phase": "stdin_net", "buffers": n_bufs, "buffer_ms": 65.536,
          "net_raw_equal_cpu": True, "net_raw_equal_file": True, "net_sbs_equal_cpu": True,
          "raw_lines": card["raw"].count(b"\n"), "sbs_lines": card["sbs"].count(b"\n"),
          "msg3_lines": card["sbs"].count(b"MSG,3,"), **secs,
          "stdin_raw_equal_file": True, "stdin_s": wall, "file_s": file_s,
          "dispatches": len(stamps), "ms_per_buffer_mean": wall * 1e3 / n_bufs,
          "ms_between_dispatches": {"median": float(np.median(per_buf)),
                                    "max": float(per_buf.max()), "min": float(per_buf.min())},
          "device_ms_per_dispatch": {"median": float(np.median(device_ms)),
                                     "max": max(device_ms)},
          "launches": launches, "kernels_at_last_dispatch": kernels})
    return launches


SNRS = (-2, 0, 2, 4, 6, 8, 10, 11, 12, 13, 14, 20)


def snr_phase(dev: torch.device, frames: int = 200) -> dict:
    """The sensitivity sweep (dump1090_tpu_torch.tools.snr_sweep) on the
    card, counted: at each of SNRS, `frames` DF17 frames at that SNR with
    random carrier phase over AWGN (the JAX tool's stream for the point),
    decoded with the resolver on the card (run_device, K1 and K2) and on the
    host (run, K1), and on the CPU.  Every crcok set, and the set recovered
    through the phase-corrected pass, must be equal across the three; at 20
    dB every planted frame must come back, and at 11 and 12 dB at least one
    through the phase-corrected pass.  K1's and K2's inputs of the 12 dB
    stream's last dispatch on each card path are held against their plain
    versions.  Emits the rate table; returns the card runs' launches."""
    from dump1090_tpu_torch.ops import _cuda
    from dump1090_tpu_torch.tools import snr_sweep

    at = {"snr": None, "resolve": None}

    def pick(kind, mc, n):
        return f"snr12/{at['resolve']}" if at["snr"] == 12 and at["resolve"] else None

    table, card_s, cpu_s = [], collections.Counter(), 0.0
    torch.cuda.synchronize()
    _cuda.reset_launches()
    t0 = time.perf_counter()
    with kernel_inputs(pick) as rec:
        for snr in SNRS:
            stream, hexes = snr_sweep.point_stream(snr, frames)
            planted = set(hexes)
            got = {}
            for resolve in ("device", "host"):
                at.update(snr=snr, resolve=resolve)
                t1 = time.perf_counter()
                corrected = set()
                got[resolve] = (snr_sweep.decode_ours(stream, resolve == "device", dev,
                                                      corrected=corrected), corrected)
                torch.cuda.synchronize()
                card_s[resolve] += time.perf_counter() - t1
            at.update(snr=None, resolve=None)
            t1 = time.perf_counter()
            corrected = set()
            got["cpu"] = (snr_sweep.decode_ours(stream, False, "cpu", corrected=corrected),
                          corrected)
            cpu_s += time.perf_counter() - t1
            if not got["device"] == got["host"] == got["cpu"]:
                raise AssertionError(f"snr {snr} dB: the recovered sets differ between the "
                                     f"card's resolve paths and the CPU")
            found, fixed = got["device"][0] & planted, got["device"][1] & planted
            table.append({"snr_db": snr, "recovered": len(found), "frames": frames,
                          "rate": len(found) / frames, "phase_corrected": len(fixed),
                          "crcok_not_planted": len(got["device"][0] - planted)})
    wall = time.perf_counter() - t0
    launches = dict(_cuda.launches)
    rows = {r["snr_db"]: r for r in table}
    if rows[20]["recovered"] != frames:
        raise AssertionError(f"snr: 20 dB recovered {rows[20]['recovered']} of {frames}")
    for snr in (11, 12):
        if rows[snr]["phase_corrected"] < 1:
            raise AssertionError(f"snr: no planted frame came back through the "
                                 f"phase-corrected pass at {snr} dB")
    if any(launches[k] <= 0 for k in ("gather_windows", "resolve_words")):
        raise AssertionError(f"snr: a kernel did not launch: {launches}")
    if set(rec) != {("snr12/device", "k1"), ("snr12/device", "k2"), ("snr12/host", "k1")}:
        raise AssertionError(f"snr: K1's and K2's inputs not recorded at 12 dB: {sorted(rec)}")
    kernels = check_kernel_inputs(rec, "snr")
    emit({"phase": "snr", "frames": frames, "equal": True, "table": table,
          "card_s": dict(card_s), "cpu_s": cpu_s, "phase_s": wall, "launches": launches,
          "kernels_at_12db": kernels})
    return launches


# the fixed-reps soak's input: the planted blocks tiled to two full dispatch
# groups of the mode (16 x 8 buffers) and a partial one
REPS_BUFFERS = 288


def reps_soak_phase(data: bytes, dev: torch.device, tmp: Path) -> dict:
    """The fixed-reps soak (dump1090_tpu_torch.tools.soak_device's default
    mode) on the card: the planted capture tiled to REPS_BUFFERS buffers
    (75.5 MB), `--reps 1 --device cuda` in a process of its own, against
    the port's CPU CLI as the oracle (this machine has no reference binary
    and no JAX): SOAK PASS and exit 0.  Then, counted, the tool's two passes
    (cold, warm: equal) in this process at its --batch 16 --groups 8 with
    K1's and K2's inputs recorded at every dispatch; held against their
    plain versions are the first (a full group, the cache empty), the last
    full group whose cache holds entries (chained from the group before)
    and the last dispatch (the partial group).  Then the --raw
    --tpu-device-resolve off CLI on the card with and without
    DUMP1090_TPU_NO_NATIVE=1, the counts set to 0 before each run (the
    per-message hub path against the native bulk path: byte-equal, and
    equal to the soak's bytes); and the magnitudes of the first buffer as
    uint16 against int32.  Returns the launches of the soak's passes and
    of each CLI run, by run."""
    import os
    import shlex

    from dump1090_tpu_torch.ops import _cuda
    from dump1090_tpu_torch.ops.magnitude import magnitude_from_iq
    from dump1090_tpu_torch.tools import soak_device

    t0 = time.perf_counter()
    capture = tmp / "reps_input.bin"
    capture.write_bytes(data[: REPS_BUFFERS * DATA_LEN_BYTES])
    oracle = shlex.join([sys.executable, "-m", "dump1090_tpu_torch", "--device", "cpu"])
    r = subprocess.run(
        [sys.executable, "-m", "dump1090_tpu_torch.tools.soak_device", "--reps", "1",
         "--input", str(capture), "--device", "cuda", "--ref", oracle],
        cwd=REPO, capture_output=True, text=True, timeout=600)
    tool_s = time.perf_counter() - t0
    if r.returncode != 0 or "SOAK PASS" not in r.stdout:
        raise AssertionError(f"the fixed-reps soak exited {r.returncode}: "
                             f"{r.stdout[-2000:]}{r.stderr[-3000:]}")
    tool_lines = {k: next(ln for ln in (r.stdout + r.stderr).splitlines() if ln.startswith(k))
                  for k in ("SOAK PASS", "warm pass", "reference")}

    stream = np.fromfile(capture, np.uint8)
    batch, groups = 16, soak_device.parser().get_default("groups")
    calls = collections.Counter()

    def pick(kind, mc, n):
        calls[kind] += 1
        return calls[kind]

    torch.cuda.synchronize()
    _cuda.reset_launches()
    with kernel_inputs(pick) as rec:
        res = soak_device.reps_passes(stream, batch, groups, dev)
    launches = dict(_cuda.launches)
    if res["warm_raw"] != res["raw"] or not res["raw"]:
        raise AssertionError("reps_soak: the warm pass differs from the cold pass, or is empty")
    dispatches = sorted({i for i, _ in rec})
    if set(rec) != {(i, k) for i in dispatches for k in ("k1", "k2")}:
        raise AssertionError(f"reps_soak: K1's and K2's inputs not recorded: {sorted(rec)}")
    rows = {i: rec[(i, "k1")][0][0].shape[0] for i in dispatches}
    chained = [i for i in dispatches
               if rows[i] == batch * groups and bool((rec[(i, "k2")][0][5] != 0).any())]
    if rows[dispatches[0]] != batch * groups or not chained:
        raise AssertionError(f"reps_soak: no full group, or none on a chained cache: {rows}")
    at = {"reps_first_group": dispatches[0], "reps_chained_group": chained[-1],
          "reps_last_dispatch": dispatches[-1]}
    kernels = check_kernel_inputs({(name, k): rec[(i, k)] for name, i in at.items()
                                   for k in ("k1", "k2")}, "reps_soak")
    del rec
    if kernels["reps_chained_group"]["k2"]["cache_valid"] < 1:
        raise AssertionError("reps_soak: K2 was not held on a chained ICAO cache")

    outs, cli_s, err, cli_launches = {}, {}, {}, {}
    for name in ("native", "no_native"):
        out = tmp / f"reps_{name}.txt"
        if name == "no_native":
            os.environ["DUMP1090_TPU_NO_NATIVE"] = "1"
        try:
            log = io.StringIO()
            torch.cuda.synchronize()
            _cuda.reset_launches()
            with contextlib.redirect_stderr(log):
                cli_s[name] = run_cli(["--ifile", str(capture), "--raw",
                                       "--tpu-device-resolve", "off"], out)
            cli_launches[name] = dict(_cuda.launches)
            err[name] = log.getvalue()
        finally:
            os.environ.pop("DUMP1090_TPU_NO_NATIVE", None)
        outs[name] = out.read_bytes()
    if "DUMP1090_TPU_NO_NATIVE" not in err["no_native"] or "native runtime" in err["native"]:
        raise AssertionError(f"reps_soak: the CLI did not take the expected host path: {err}")
    if not outs["native"] == outs["no_native"] == res["raw"]:
        raise AssertionError("reps_soak: the CLI's --raw with DUMP1090_TPU_NO_NATIVE=1 differs "
                             "from the native run or from the soak's bytes")

    x = torch.from_numpy(stream[:DATA_LEN_BYTES]).to(dev)
    m16 = magnitude_from_iq(x, out_dtype=torch.uint16)
    if m16.dtype != torch.uint16 or max_abs_err(m16.view(torch.int16).to(torch.int32) & 0xFFFF,
                                                magnitude_from_iq(x)):
        raise AssertionError("reps_soak: uint16 magnitudes differ from the int32 ones on the card")
    seconds = time.perf_counter() - t0
    emit({"phase": "reps_soak", "seconds": seconds, "buffers": REPS_BUFFERS,
          "bytes": int(stream.nbytes), "tool_s": tool_s, "tool": tool_lines,
          "lines": len(res["raw"].splitlines()), "cold_s": res["cold_s"],
          "warm_s": res["warm_s"], "warm_msps": res["samples"] / res["warm_s"] / 1e6,
          "launches": launches, "dispatch_rows": [rows[i] for i in dispatches],
          "kernels_at_reps": {name: {"dispatch": at[name], **k} for name, k in kernels.items()},
          "no_native_equal": True, "cli_s": cli_s, "cli_launches": cli_launches,
          "uint16_magnitudes_equal": True})
    return launches, cli_launches


# the probes that measure a fresh process (the link before the first
# kernel, the first dispatch's load) or run the profiler (which a session
# earlier in a process disturbs, gather_stage_kernels) get one of their own
PROBES_IN_SUBPROCESS = ("link", "staged-h2d", "trace")


def _shares(obj, path: str = "", inside: bool = False) -> dict:
    """Every roofline or busy share in a tool's record (keys `sol`,
    `sol_*` and `*share`, and the numbers under them), by key path."""
    out = {}
    if isinstance(obj, dict):
        for k, v in obj.items():
            sub = f"{path}.{k}" if path else k
            share = inside or k == "sol" or k.startswith("sol_") or k.endswith("share")
            if share and isinstance(v, (int, float)):
                out[sub] = v
            else:
                out.update(_shares(v, sub, share))
    return out


def _tool_record(out: str, name: str) -> dict:
    recs = [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]
    if not recs:
        raise AssertionError(f"{name} printed no JSON record")
    rec = recs[-1]
    shares = _shares(rec)
    if any(not 0 <= v <= 1.0 for v in shares.values()):
        raise AssertionError(f"{name}: a share outside [0, 1]: {shares}")
    if rec.get("device", {}).get("platform") != "gpu":
        raise AssertionError(f"{name} did not run on the card: {rec.get('device')}")
    return rec


def _run_tool(module: str, argv: list, name: str, timeout: int = 600) -> tuple:
    """`python -m dump1090_tpu_torch.tools.<module> argv` in a process of its
    own: (its record, seconds).  A non-zero exit fails the phase."""
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", f"dump1090_tpu_torch.tools.{module}", *argv],
                       cwd=REPO, capture_output=True, text=True, timeout=timeout)
    if r.returncode != 0:
        raise AssertionError(f"{name} exited {r.returncode}: {r.stderr[-3000:]}{r.stdout[-2000:]}")
    return _tool_record(r.stdout, name), time.perf_counter() - t0


def _call_tool(main, argv: list, name: str) -> tuple:
    """A tool's main in this process: (its record, seconds)."""
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    if rc != 0:
        raise AssertionError(f"{name} returned {rc}: {out.getvalue()[-2000:]}")
    return _tool_record(out.getvalue(), name), time.perf_counter() - t0


def measure_phase(dev: torch.device, tmp: Path, probe_nb: int = 64) -> tuple:
    """The measurement tools on the card: tools.bench in full (its own
    process: the upload probe comes before any kernel, the cold file
    first); then the bench's shapes in this process with K1's and K2's
    inputs recorded: its resident groups through its sustained run with
    the cache chained (the first group, from a fresh cache, against
    DemodPipeline.stream_raw_device over the same buffers: byte-equal,
    every planted frame of at most one flipped bit among its lines), its
    fused batch and its sparse batch.  Then each probe of tools.measure once
    at its defaults but for --nb probe_nb (the tools' 128 halved to keep
    the script inside half its time limit), and exp_demod_front --check
    --time.  Every tool must exit 0 on the card with every share in
    [0, 1].  K1's and K2's inputs of the probes' shapes are recorded in
    short reruns of `steady` (the group at the probes' shapes, the cache
    chained; the `ab-*` and `trace` probes run the same shapes) and `scan`
    (K2's walk at each length), so that the clones stay out of the probes'
    timings; every recorded call is held against the kernels' plain
    versions.  Returns the launches of the bench and of the probes, each
    counted in the tool's own run."""
    from dump1090_tpu_torch.models.pipeline import DemodPipeline, PipelineConfig
    from dump1090_tpu_torch.tools import air, bench, exp_demod_front, measure

    rec, secs = _run_tool("bench", [], "bench")
    if rec.get("error") or not rec["value"] > 0 or "sol_fraction" not in rec:
        raise AssertionError(f"bench failed: {rec}")
    bench_launches = rec["launches"]
    emit({"phase": "measure_bench", "seconds": secs, **rec})

    # the bench's shapes in this process, K1's and K2's inputs recorded:
    # its two groups with the cache chained as its sustained run chains
    # it, then its fused batch and its sparse batch
    raw, planted = air.planted_air()
    nb, g = bench.NB, bench.G
    groups = bench.upload_groups(air.bench_groups(raw, nb, g, bench.W), dev)
    program = bench.Group()
    program.fit(groups[0])
    zero = torch.zeros(1024, dtype=torch.int32, device=dev)
    at = {"where": None}
    with kernel_inputs(lambda kind, mc, n: at["where"]) as rec_b:
        at["where"] = "bench_group"
        run = bench.sustained_run(program, groups, zero, zero.clone(), t=len(groups) + 1,
                                  keep=True)
        x16 = groups[0][0]
        at["where"] = "bench_fused"
        bench.fused_loop(x16, run["ca"], run["ct"], 2, mc=program.mc, mos=program.mos,
                         mol=program.mol)
        at["where"] = "bench_sparse"
        xs = torch.from_numpy(air.sparse_batch(nb, 2 * x16.shape[1])).to(dev)
        bench.fused_loop(xs, run["ca"], run["ct"], 2, mc=bench.SPARSE_MC,
                         mos=bench.SPARSE_OUT, mol=bench.SPARSE_OUT)
        torch.cuda.synchronize()
    del groups, x16, xs
    want = {(w, k) for w in ("bench_group", "bench_fused", "bench_sparse") for k in ("k1", "k2")}
    if set(rec_b) != want:
        raise AssertionError(f"bench: K1's and K2's inputs not recorded: {sorted(rec_b)}")
    kernels_bench = check_kernel_inputs(rec_b, "bench")
    del rec_b
    torch.cuda.empty_cache()

    # the bench's first group, formatted by its sustained run, against the
    # product file decode of the same buffers (fresh cache, same clock)
    got = run["raw"][0]
    path = tmp / "bench_group.bin"
    reps = -(-nb * g * DATA_LEN_BYTES // len(raw))
    path.write_bytes(np.tile(raw, reps)[: nb * g * DATA_LEN_BYTES].tobytes())
    p = DemodPipeline(PipelineConfig(batch_buffers=nb, dispatch_groups=g),
                      clock=lambda: bench.NOW, device=dev)
    with open(path, "rb") as f:
        want = b"".join(p.stream_raw_device(f))
    path.unlink()
    if got != want:
        raise AssertionError("the bench's first group differs from stream_raw_device's bytes")
    # every planted frame with at most one flipped bit (the default fix
    # repairs one; two need --aggressive), as its clean frame
    lines = set(got.split())
    fixable = {b"*" + c.hex().encode() + b";" for _, _, c, nflip in planted if nflip <= 1}
    if not fixable <= lines:
        raise AssertionError(f"{len(fixable - lines)} planted frames missing from the "
                             "bench's first group")
    emit({"phase": "measure_bench_group", "buffers": nb * g, "raw_equal_stream_raw_device": True,
          "lines": len(got.split()), "planted_found": len(fixable),
          "shapes": {"mc": program.mc, "mos": program.mos, "mol": program.mol},
          "kernels_at_bench": kernels_bench})

    probe_launches = collections.Counter()
    nb_arg = ["--nb", str(probe_nb)]
    for probe in measure.PROBES:
        argv = ["--probe", probe, *nb_arg]
        if probe in PROBES_IN_SUBPROCESS:
            rec, secs = _run_tool("measure", argv + ["--trace-dir", str(tmp / "trace")], probe)
        else:
            rec, secs = _call_tool(measure.main, argv, probe)
        probe_launches.update(rec["launches"])
        emit({"phase": f"measure_{probe}", "seconds": secs, **rec})
        torch.cuda.empty_cache()
    rec, secs = _call_tool(exp_demod_front.main, ["--check", "--time", *nb_arg],
                           "exp_demod_front")
    emit({"phase": "measure_exp_demod_front", "seconds": secs, **rec})

    at = {"probe": None}

    def pick(kind, mc, n):
        return f"scan_n{n}" if at["probe"] == "scan" and kind == "k2" else at["probe"]

    t0 = time.perf_counter()
    with kernel_inputs(pick) as rec_m:
        for probe, short in (("steady", ["--t", "2"]), ("scan", ["--loops", "2"])):
            at["probe"] = probe
            _call_tool(measure.main, ["--probe", probe, *nb_arg, *short], probe)
        torch.cuda.synchronize()
    rerun_s = time.perf_counter() - t0
    walks = {min(n, probe_nb * bench.MC) for n in (2048, 8192, 32768)}
    want = ({("steady", "k1"), ("steady", "k2"), ("scan", "k1")}
            | {(f"scan_n{n}", "k2") for n in walks})
    if set(rec_m) != want:
        raise AssertionError(f"measure: K1's and K2's inputs not recorded: {sorted(rec_m)}")
    emit({"phase": "measure_probe_kernels", "rerun_s": rerun_s,
          "kernels_at_probes": check_kernel_inputs(rec_m, "measure")})
    return bench_launches, dict(probe_launches)


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
    from dump1090_tpu_torch.ops.resolve import _group_front, _group_precompute
    from dump1090_tpu_torch.tools.bench import Group, sustained_run
    from dump1090_tpu_torch.tools.measure import group_stage_split, sustained
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

    bufs = np.stack(list(iq_buffers(io.BytesIO(data[: group_blocks * DATA_LEN_BYTES]))))
    xg = torch.from_numpy(bufs[:group_blocks].reshape(8, 64, -1)).to(dev)
    mc = 256
    m, n, pos = _group_front(xg, scan_len=131070, max_candidates=mc)
    walk_in, _ = _group_precompute(m, n, pos, True, False, max_candidates=mc)
    k1 = gather_phase(m, pos)
    gather_shapes_phase(m)
    del m, pos
    # sparse air: 10 frames per block at the same noise, tiled to one group
    sparse_blocks, _ = planted_capture(16, 10, seed=args.seed + 1)
    sparse_bufs = np.stack(list(iq_buffers(io.BytesIO(sparse_blocks * (group_blocks // 16)))))
    m, n, pos = _group_front(torch.from_numpy(sparse_bufs.reshape(8, 64, -1)).to(dev),
                             scan_len=131070, max_candidates=mc)
    sparse_in, _ = _group_precompute(m, n, pos, True, False, max_candidates=mc)
    del m, pos
    k2 = resolve_phase(walk_in, sparse_in, mc, args.seed)
    del walk_in, sparse_in

    with tempfile.TemporaryDirectory(dir=_cuda.BUILD_DIR) as tmp:
        # ---- the main path on the card vs the port's CPU run: first group ----
        first = Path(tmp) / "first_group.bin"
        first.write_bytes(data[: group_blocks * DATA_LEN_BYTES])
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
        path.write_bytes(data[: args.groups * group_blocks * DATA_LEN_BYTES])
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

    # the per-stage split and the sustained rate of the resident group, at
    # the shapes the pipeline settled on, by the measurement tools' code:
    # sustained_msps fetches every group with three in flight and formats
    # none; sustained_formatted_msps adds the bench's formatting worker
    program = Group(p._mc, p._mos, p._mol)
    split = group_stage_split(program, xg)
    sus, _ = sustained(program, [xg], 6, depth=3)
    zero = torch.zeros(1024, dtype=torch.int32, device=dev)
    sus_wall = sustained_run(program, [xg], zero, zero.clone(), t=6)["wall_s"]
    sus_formatted = 6 * xg.shape[0] * xg.shape[1] * BLOCK_SAMPLES / sus_wall / 1e6
    samples = n_blocks * BLOCK_SAMPLES
    emit({"phase": "e2e", "groups": args.groups, "buffers": n_blocks,
          "samples": samples, "lines": len(lines), "stats": stats,
          "clean_planted_in_order": True, "generate_s": gen_s, "wall_s": wall,
          "file_msps": samples / wall / 1e6, "warm_wall_s": warm_wall,
          "warm_file_msps": samples / warm_wall / 1e6, "ingest_s": ingest_s,
          "read_and_frame_s": frame_s, "framed_buffers": n_framed,
          "sustained_msps": sus, "sustained_formatted_msps": sus_formatted,
          "stage_ms_per_group": split,
          "gather_stage_ms": {"two_step": k1["two_step_ms"], "fused": split["gather"]},
          "peak_device_bytes": peak, "settled_shapes": shapes,
          "groups_replayed": launches["resolve_words"] - args.groups})

    # ---- the emission's crcok_only, packed and not ----------------------------
    crcok_launches = crcok_phase(data, dev)

    # ---- the multi-capture path: K3 at its width, then the path itself ------
    k3 = resolve_streams_phase(bufs, sparse_bufs, args.seed, dev)
    del sparse_bufs
    blocks = [data[i * DATA_LEN_BYTES:(i + 1) * DATA_LEN_BYTES] for i in range(16)]
    captures_vs_cpu_phase(blocks, planted, dev)
    captures_launches, solo_launches = captures_e2e_phase(blocks, planted, dev)

    # ---- the CLI's hub path: verbose display, tracker, net services ---------
    with tempfile.TemporaryDirectory(dir=_cuda.BUILD_DIR) as tmp:
        first = Path(tmp) / "first_group.bin"
        first.write_bytes(data[: group_blocks * DATA_LEN_BYTES])
        first64 = Path(tmp) / "first_64.bin"
        first64.write_bytes(data[: 64 * DATA_LEN_BYTES])
        verbose_launches = verbose_cli_phase(first, runs["cuda"][0], planted, group_blocks,
                                             Path(tmp))
        first.unlink()
        vs_cpu_launches, verbose64 = verbose_vs_cpu_phase(first64, Path(tmp))
        net_launches = net_phase(first64, verbose64, dev)

    # ---- the host-resolve path and the --debug dumps --------------------------
    with tempfile.TemporaryDirectory(dir=_cuda.BUILD_DIR) as tmp:
        tmp = Path(tmp)
        path = tmp / "capture.bin"
        path.write_bytes(data[: args.groups * group_blocks * DATA_LEN_BYTES])
        host_launches, host_cli_launches = host_resolve_phase(path, n_blocks, out, dev, tmp)
        path.unlink()
        first = tmp / "first_group.bin"
        first.write_bytes(data[: group_blocks * DATA_LEN_BYTES])
        verbose_host_phase(first, tmp)
        first.unlink()
        first64 = tmp / "first_64.bin"
        first64.write_bytes(data[: 64 * DATA_LEN_BYTES])
        python_launches = host_resolve_python_phase(first64, dev)
        first16 = tmp / "first_16.bin"
        first16.write_bytes(data[: 16 * DATA_LEN_BYTES])
        debug_golden_launches = debug_golden_phase(tmp)
        debug_cpu_launches = debug_vs_cpu_phase(first16, tmp)
    captures_host_launches = captures_host_phase(blocks, planted, dev)

    # ---- the packed fronts, staged preload, --tpu-profile and live input ------
    with tempfile.TemporaryDirectory(dir=_cuda.BUILD_DIR) as tmp:
        tmp = Path(tmp)
        path = tmp / "capture.bin"
        path.write_bytes(data[: args.groups * group_blocks * DATA_LEN_BYTES])
        front_launches = front_variants_phase(xg, path, out, tmp)
        staged_launches = preload_phase(path, out, tmp)
        path.unlink()
        first = tmp / "first_group.bin"
        first.write_bytes(data[: group_blocks * DATA_LEN_BYTES])
        live_launches, live_cli_launches = live_phase(data, dev, tmp)
        profile_launches = profile_phase(first, runs["cuda"][0], tmp)
        first.unlink()

    # ---- the time-sharded decode ------------------------------------------------
    with tempfile.TemporaryDirectory(dir=_cuda.BUILD_DIR) as tmp:
        sharded_launches, worker_bench_launches = sharded_phase(blocks, planted, dev, Path(tmp))

    # ---- the differential fuzz and the wall-clock soaks -----------------------
    fuzz_launches = fuzz_phase(args.seed, dev)
    soak_launches = soak_phase(args.seed, dev)

    # ---- the stdin feed with the network services, and the SNR sweep ----------
    with tempfile.TemporaryDirectory(dir=_cuda.BUILD_DIR) as tmp:
        stdin_launches = stdin_net_phase(b"".join(blocks), dev, Path(tmp))
    snr_launches = snr_phase(dev)

    # ---- the fixed-reps soak, DUMP1090_TPU_NO_NATIVE ----------------------------
    with tempfile.TemporaryDirectory(dir=_cuda.BUILD_DIR) as tmp:
        reps_launches, reps_cli_launches = reps_soak_phase(data, dev, Path(tmp))

    # ---- the measurement tools: the benchmark, the probes, the front A/B -----
    with tempfile.TemporaryDirectory(dir=_cuda.BUILD_DIR) as tmp:
        bench_launches, probe_launches = measure_phase(dev, Path(tmp))

    gather_stage_kernels_phase(args.seed)

    paths = {
        "file_decode": (launches, ("gather_windows", "resolve_words")),
        "decode_captures": (captures_launches, ("gather_windows", "resolve_words_streams")),
        "decode_capture": (solo_launches, ("gather_windows", "resolve_words")),
        "verbose_cli": (verbose_launches, ("gather_windows", "resolve_words")),
        "verbose_vs_cpu": (vs_cpu_launches, ("gather_windows", "resolve_words")),
        "net": (net_launches, ("gather_windows", "resolve_words")),
        "host_resolve": (host_launches, ("gather_windows",)),
        "host_resolve_cli": (host_cli_launches, ("gather_windows",)),
        "host_resolve_python": (python_launches, ("gather_windows",)),
        "debug_golden": (debug_golden_launches, ("gather_windows",)),
        "debug_vs_cpu": (debug_cpu_launches, ("gather_windows",)),
        "decode_captures_host": (captures_host_launches, ("gather_windows",)),
        "front_packed": (front_launches, ("gather_windows", "resolve_words")),
        "preload_staged": (staged_launches, ("gather_windows", "resolve_words")),
        "live": (live_launches, ("gather_windows", "resolve_words")),
        "live_cli": (live_cli_launches, ("gather_windows", "resolve_words")),
        "profile": (profile_launches, ("gather_windows", "resolve_words")),
        "sharded": (sharded_launches, ("gather_windows", "resolve_words")),
        "worker_bench": (worker_bench_launches, ("gather_windows",)),
        "crcok": (crcok_launches, ("gather_windows", "resolve_words")),
        "fuzz": (fuzz_launches, ("gather_windows", "resolve_words")),
        "soak": (soak_launches, ("gather_windows", "resolve_words")),
        "stdin": (stdin_launches, ("gather_windows", "resolve_words")),
        "snr": (snr_launches, ("gather_windows", "resolve_words")),
        "reps_soak": (reps_launches, ("gather_windows", "resolve_words")),
        "reps_native_cli": (reps_cli_launches["native"], ("gather_windows",)),
        "reps_no_native_cli": (reps_cli_launches["no_native"], ("gather_windows",)),
        "bench": (bench_launches, ("gather_windows", "resolve_words")),
        "measure": (probe_launches, ("gather_windows", "resolve_words")),
    }
    emit({"phase": "kernels", "launches_by_path": {p: c for p, (c, _) in paths.items()}})
    for path, (counts, used) in paths.items():
        for name in used:
            if counts[name] <= 0:
                raise AssertionError(f"kernel {name} was not launched on the {path} path")

    smi = nvidia_smi()
    emit({"phase": "gpu", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda})
    print(smi, flush=True)

    # each kernel's launches on the path of its slice: K1 and K2 on the
    # file decode, K3 on the multi-capture decode
    k1["launches"] = launches["gather_windows"]
    k2["launches"] = launches["resolve_words"]
    k3["launches"] = captures_launches["resolve_words_streams"]
    # and on the time-sharded decode (K1 in every shard, K2 over the segments)
    for r in (k1, k2, k3):
        r["launches_sharded"] = sharded_launches[r["name"]]
        # and on the fuzz's and the soaks' card runs
        r["launches_fuzz"] = fuzz_launches[r["name"]]
        r["launches_soak"] = soak_launches[r["name"]]
        # and on the stdin feed's and the SNR sweep's
        r["launches_stdin"] = stdin_launches[r["name"]]
        r["launches_snr"] = snr_launches[r["name"]]
        # and on the fixed-reps soak's passes
        r["launches_reps"] = reps_launches.get(r["name"], 0)
        # and on the benchmark's and the probes' own runs
        r["launches_bench"] = bench_launches.get(r["name"], 0)
        r["launches_measure"] = probe_launches.get(r["name"], 0)
        # and on the crcok calls and the multihost worker's --bench
        r["launches_crcok"] = crcok_launches.get(r["name"], 0)
        r["launches_worker_bench"] = worker_bench_launches.get(r["name"], 0)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms", "launches_sharded",
            "launches_fuzz", "launches_soak", "launches_stdin", "launches_snr",
            "launches_reps", "launches_bench", "launches_measure", "launches_crcok",
            "launches_worker_bench")
    emit({"kernels": [{k: r[k] for k in keys} for r in (k1, k2, k3)]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
