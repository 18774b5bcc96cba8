"""Measurement probes of the port on one card (a port of tools/measure.py).

    python -m dump1090_tpu_torch.tools.measure --probe NAME [--device cuda]
        [--input FILE] [--nb 128] [--mc 256] [--g 12] [--t T] [--loops 32]
        [--front a,b] [--top 30] [--variant V] [--trace-dir DIR]

  steady      group dispatch and fetch accounting, steady Msamples/s and the
              candidates a batch
  scan        K2's ns a step against the word-stream length N
  front       the full demod_batch over four fronts (L = 32 loops)
  ab-sustained  the mask and packed fronts in the sustained group protocol,
              interleaved in one process
  ab-front2   the front arrangements (scan, hoist, pin, flat, hoist16) in
              the same protocol, each bit-identical to scan
  ab-depth    dispatch-ahead depths 1-4 on the uint16 wire
  trace       torch.profiler over T groups: device time and count by kernel,
              the device total and the device's busy share of the wall time
  stages      the per-stage demod breakdown (CUDA events) with its shares of
              3.35 TB/s
  link        H2D before and after the first kernel, pageable and from
              memory pinned beforehand; D2H blocking and pre-issued
              (non-blocking into pinned memory); the D2H floor at 4 KB and
              512 KB
  staged-h2d  do uploads issued while the first dispatch loads the kernels
              keep their rate?  (the card's form of --tpu-preload staged)

Each probe prints its lines, then one JSON line {"probe": ..., "device":
{...}, ...}: the card's name, count and power limit stand beside every
number.  Shares are of the published H100 SXM peak (3.35 TB/s); bytes bound
this work.  The input is --input's capture or the planted dense air
(tools/air.py), tiled as tools/measure.py's load_buffers tiles modes1.bin.

Ported as the arrangements they name, in eager PyTorch: `scan` is the
product's group front (ops.resolve._group_front, one magnitude and one
front over every buffer of the group; `flat` is the same arrangement
spelled out), `hoist` the magnitudes of the whole group then the front
batch by batch, `hoist16` the same from the uint16 wire, and `pin` (an XLA
entry-layout pin in the JAX tool) `hoist` on a .contiguous() row-major
input.  The JAX `steady` probe passed max_out to the packed emission, which
that format does not read, so its fetch carried no frame; the port's
fetches bench.py's 5,632 short and 9,216 long rows a batch.  `trace`
replaces the JAX trace-file parser with torch.profiler's key_averages();
where the profiler sees no device time it says so and reports CUDA events
per stage instead.  `--device cpu` (the JAX tool's --allow-cpu) dry-runs the
logic on the CPU: no shares, numbers meaningless.  With no card and no
--device cpu the tool raises.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import tempfile
import threading
import time

import numpy as np
import torch

from ..constants import BLOCK_SAMPLES
from . import air
from .bench import (
    HBM_BYTES_PER_S,
    MOL,
    MOS,
    NOW,
    SCAN_LEN,
    Group,
    _consume,
    best_per_call,
    device_record,
    log,
    sustained_run,
    sync,
)


def buffers(args, n: int) -> np.ndarray:
    return air.load_buffers(air.stream(args.input), n)


def resident_groups(args, g: int, w: int, *, u16: bool = False) -> list:
    """W distinct (G, NB, ...) groups on the device, uint8 or as uint16
    I|Q<<8 pairs."""
    bufs = buffers(args, w * g * args.nb)
    if u16:
        bufs = bufs.view("<u2")
    return [torch.from_numpy(bufs[k * g * args.nb:(k + 1) * g * args.nb]
                             .reshape(g, args.nb, -1)).to(args.dev) for k in range(w)]


def msps(groups: int, g: int, nb: int, seconds: float) -> float:
    return groups * g * nb * BLOCK_SAMPLES / seconds / 1e6


def sustained(program: Group, groups: list, t: int, depth: int = 1) -> tuple[float, int]:
    """(Msamples/s, messages) of t groups with `depth` in flight, each
    fetched, its counts summed, none formatted (bench.sustained_run); a
    fresh cache."""
    dev = groups[0].device
    ca = torch.zeros(1024, dtype=torch.int32, device=dev)
    r = sustained_run(program, groups, ca, ca.clone(), t=t, depth=depth, formatted=False)
    g, nb = groups[0].shape[:2]
    return msps(t, g, nb, r["wall_s"]), r["messages"]


def interleaved(runs: dict, t: int, reps: int = 3) -> dict:
    """Each run (name -> (program, groups, depth)) once warm, its shapes
    fitted to its first group, then `reps` rounds taking them in turn so
    drift hits all alike.  Raises unless every run emits the same
    messages."""
    warm, out = {}, {"warm_msps": {}, "reps_msps": collections.defaultdict(list)}
    for name, (program, groups, depth) in runs.items():
        program.fit(groups[0])
        r, n = sustained(program, groups, t, depth)
        warm[name] = n
        out["warm_msps"][name] = r
        log(f"warm {name}: {r:.0f} Ms/s ({n} msgs)")
    if len(set(warm.values())) != 1:
        raise AssertionError(f"variants disagree: {warm}")
    for rep in range(reps):
        for name, (program, groups, depth) in runs.items():
            r, _ = sustained(program, groups, t, depth)
            out["reps_msps"][name].append(r)
            log(f"rep{rep} {name}: {r:.0f} Ms/s")
    out["messages"] = next(iter(warm.values()))
    out["reps_msps"] = dict(out["reps_msps"])
    return out


# ---------------------------------------------------------------------------
# steady: the product group's dispatch and fetch accounting
# ---------------------------------------------------------------------------

def probe_steady(args) -> dict:
    g, w, t = args.g, 2, args.t or 6
    t0 = time.perf_counter()
    groups = resident_groups(args, g, w)
    sync(args.dev)
    h2d_s = time.perf_counter() - t0
    log(f"h2d: {sum(x.numel() for x in groups) / 1e6:.0f} MB in {h2d_s:.2f}s")
    program = Group(args.mc, MOS, MOL)
    t0 = time.perf_counter()
    (n_h, *_), ca, ct = program.fit(groups[0])
    first_s = time.perf_counter() - t0
    log(f"first group (shapes fitted: mc {program.mc}, mos {program.mos}, mol {program.mol}): "
        f"{first_s:.2f}s")
    cand = float(n_h.sum(axis=1).mean())
    log(f"candidates/batch: mean {cand:.0f} of {args.nb * args.mc} slots; per-buffer max "
        f"{int(n_h.max())}")
    compute_ms = []
    for _ in range(2):
        sync(args.dev)
        t0 = time.perf_counter()
        program.outputs(groups[0], ca, ct)
        sync(args.dev)
        compute_ms.append((time.perf_counter() - t0) * 1e3)
        log(f"group compute (no fetch): {compute_ms[-1]:.0f} ms")
    from ..models.pipeline import _Fetch

    out = program.outputs(groups[0], ca, ct)
    sync(args.dev)
    t0 = time.perf_counter()
    host = _Fetch(out[:6]).get()
    dt = time.perf_counter() - t0
    nbytes = sum(h.nbytes for h in host)
    log(f"fetch idle: {dt * 1e3:.1f} ms for {nbytes / 1e6:.2f} MB -> {nbytes / dt / 1e6:.0f} MB/s")
    t_disp = t_fetch = 0.0
    pending = None
    sync(args.dev)
    t0 = time.perf_counter()
    for k in range(t):
        ta = time.perf_counter()
        fetch, ca, ct = program.dispatch(groups[k % w], ca, ct)
        t_disp += time.perf_counter() - ta
        if pending is not None:
            ta = time.perf_counter()
            program.fetch(pending)
            t_fetch += time.perf_counter() - ta
        pending = fetch
    ta = time.perf_counter()
    program.fetch(pending)
    t_fetch += time.perf_counter() - ta
    wall = time.perf_counter() - t0
    rate = msps(t, g, args.nb, wall)
    log(f"steady: {t} groups in {wall * 1e3:.0f} ms -> {rate:.0f} Ms/s; dispatch-enqueue "
        f"{t_disp * 1e3:.0f} ms, fetch-blocked {t_fetch * 1e3:.0f} ms")
    return {"h2d_s": h2d_s, "first_group_s": first_s, "candidates_per_batch": cand,
            "per_buffer_max": int(n_h.max()), "group_compute_ms": compute_ms,
            "fetch_idle_ms": dt * 1e3, "fetch_mb": nbytes / 1e6,
            "fetch_idle_mb_s": nbytes / dt / 1e6, "steady_msps": rate, "wall_s": wall,
            "dispatch_enqueue_ms": t_disp * 1e3, "fetch_blocked_ms": t_fetch * 1e3}


# ---------------------------------------------------------------------------
# scan: K2's ns a step against the stream length
# ---------------------------------------------------------------------------

def probe_scan(args) -> dict:
    from ..ops.resolve import _group_front, _group_precompute, resolve_words

    x = torch.from_numpy(buffers(args, args.nb)).to(args.dev)
    mc = args.mc
    m, n, pos = _group_front(x[None], scan_len=SCAN_LEN, max_candidates=mc)
    (pf, w1, w2, h12, nbuf), _ = _group_precompute(m, n, pos, True, False, max_candidates=mc)
    del m
    ca0 = torch.zeros(1024, dtype=torch.int32, device=args.dev)
    res, loops = {}, args.loops
    for n_steps in (2048, 8192, 32768):
        n_steps = min(n_steps, pf.numel()) // mc * mc
        if n_steps == 0 or n_steps in res:
            continue
        ins = [a[:n_steps].contiguous() for a in (pf, w1, w2, h12)]
        nb_n = nbuf[:n_steps // mc].contiguous()

        def loop(ins=ins, nb_n=nb_n):
            ca, ct, acc = ca0, ca0, 0
            for _ in range(loops):
                words, ca, ct = resolve_words(*ins, nb_n, ca, ct, NOW, mc)
                acc = acc + words.sum()
            return acc

        dt = best_per_call(loop, args.dev, loops)
        res[n_steps] = {"ms": dt * 1e3, "ns_per_step": dt / n_steps * 1e9}
        log(f"resolve walk N={n_steps}: {dt * 1e3:.3f} ms -> {dt / n_steps * 1e9:.1f} ns/step")
    return {"walks": {str(k): v for k, v in res.items()}}


# ---------------------------------------------------------------------------
# front: the full demod_batch over the front formulations
# ---------------------------------------------------------------------------

def probe_front(args) -> dict:
    from ..ops.demod import demod_batch

    x = torch.from_numpy(buffers(args, args.nb)).to(args.dev)
    loops, res = args.loops, {}
    for front in ("mask", "packed-plain", "packed", "packed-mxu"):
        def run(front=front):
            # a distinct input each iteration, as the JAX probe perturbs it
            return sum(_consume(demod_batch(air.perturb(x, i), scan_len=SCAN_LEN,
                                            max_candidates=args.mc, front=front))
                       for i in range(loops))

        dt = best_per_call(run, args.dev, loops, trials=3)
        res[front] = dt * 1e3
        log(f"{front}: {dt * 1e3:.3f} ms/batch full demod (nb={args.nb})")
    return {"ms_per_batch": res}


# ---------------------------------------------------------------------------
# ab-sustained, ab-front2, ab-depth: A/Bs in the sustained group protocol
# ---------------------------------------------------------------------------

def probe_ab_sustained(args) -> dict:
    from ..ops.resolve import _group_front

    groups = resident_groups(args, args.g, 2)
    runs = {}
    for f in ("mask", "packed"):
        def fv(x, f=f, **kw):
            return _group_front(x, front=f, **kw)

        runs[f] = (Group(args.mc, MOS, MOL, front=fv), groups, 1)
    return interleaved(runs, t=args.t or 6)


def front_variants() -> dict:
    """The group-front arrangements of tools/measure.py's _front_variants,
    each xg -> (m int32 (G*NB, S), n (G*NB,), pos (G*NB, MC)) and each
    bit-identical to `scan`."""
    from ..ops.demod import front_candidates
    from ..ops.magnitude import magnitude_from_iq, magnitude_from_pairs
    from ..ops.resolve import _group_front

    def by_batch(m_g, scan_len, max_candidates, front):
        g_n, nb, s = m_g.shape
        n_pos = [front_candidates(m_g[k], scan_len, max_candidates, front) for k in range(g_n)]
        return (m_g.reshape(g_n * nb, s), torch.cat([n for n, _ in n_pos]),
                torch.cat([p for _, p in n_pos]))

    def hoist(xg, *, scan_len, max_candidates, front=None):
        g_n, nb, w = xg.shape
        m_g = magnitude_from_iq(xg.reshape(g_n * nb, w)).reshape(g_n, nb, -1)
        return by_batch(m_g, scan_len, max_candidates, front)

    def pin(xg, **kw):
        return hoist(xg.contiguous(), **kw)

    def flat(xg, *, scan_len, max_candidates, front=None):
        g_n, nb, w = xg.shape
        m = magnitude_from_iq(xg.reshape(g_n * nb, w))
        n, pos = front_candidates(m, scan_len, max_candidates, front)
        return m, n, pos

    def hoist16(xg16, *, scan_len, max_candidates, front=None):
        return by_batch(magnitude_from_pairs(xg16), scan_len, max_candidates, front)

    return {"scan": _group_front, "hoist": hoist, "pin": pin, "flat": flat, "hoist16": hoist16}


def probe_ab_front2(args) -> dict:
    groups = resident_groups(args, args.g, 2)
    groups16 = resident_groups(args, args.g, 2, u16=True)
    runs = {name: (Group(args.mc, MOS, MOL, front=fv),
                   groups16 if name.endswith("16") else groups, 1)
            for name, fv in front_variants().items()}
    return interleaved(runs, t=args.t or 6)


def probe_ab_depth(args) -> dict:
    groups16 = resident_groups(args, args.g, 3, u16=True)
    program = Group(args.mc, MOS, MOL, front=front_variants()["hoist16"])
    return interleaved({f"depth={d}": (program, groups16, d) for d in (1, 2, 3, 4)},
                       t=args.t or 10)


# ---------------------------------------------------------------------------
# trace: device time by kernel through torch.profiler
# ---------------------------------------------------------------------------

def group_stage_split(program: Group, x: torch.Tensor, reps: int = 3) -> dict:
    """Device ms of each stage of one group (CUDA events between stages,
    ops.resolve's `marks`), and of the device-to-host copy of its outputs;
    mean of `reps` after a warm group."""
    from ..models.pipeline import _Fetch

    ca = torch.zeros(1024, dtype=torch.int32, device=x.device)
    program.outputs(x, ca, ca)  # warm
    split: dict = {}
    for _ in range(reps):
        marks: list = []
        out = program.outputs(x, ca, ca, marks=marks)
        d2h = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        d2h[0].record()
        fetch = _Fetch(out[:6])
        d2h[1].record()
        fetch.get()
        for (_, a), (name, b) in zip(marks, marks[1:]):
            split[name] = split.get(name, 0.0) + a.elapsed_time(b) / reps
        split["d2h"] = split.get("d2h", 0.0) + d2h[0].elapsed_time(d2h[1]) / reps
    return split


def probe_trace(args) -> dict:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    t = args.t or 2
    arrange = front_variants()[args.variant or "scan"]
    x = resident_groups(args, args.g, 1, u16=(args.variant or "").endswith("16"))[0]
    on_card = args.dev.type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    os.makedirs(args.trace_dir, exist_ok=True)
    with profile(activities=acts):  # the tracer's start-up, outside every window
        torch.zeros(1, device=args.dev).add_(1)
        sync(args.dev)
    reports = {}
    for front in (args.front.split(",") if args.front else ["mask", "packed"]):
        def fv(xg, front=front, **kw):
            return arrange(xg, front=front, **kw)

        program = Group(args.mc, MOS, MOL, front=fv)
        _, ca, ct = program.fit(x)  # warm, outside the window
        sync(args.dev)
        t0 = time.perf_counter()
        with profile(activities=acts) as prof:
            for _ in range(t):
                fetch, ca, ct = program.dispatch(x, ca, ct)
                program.fetch(fetch)
            sync(args.dev)
        wall = time.perf_counter() - t0
        path = os.path.join(args.trace_dir, f"trace_{front}.json")
        prof.export_chrome_trace(path)
        if on_card:
            rows = [(e.key, e.self_device_time_total, e.count) for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
        else:
            rows = [(e.key, e.self_cpu_time_total, e.count) for e in prof.key_averages()]
        rows.sort(key=lambda r: -r[1])
        total_us = sum(r[1] for r in rows)
        batches = t * x.shape[0]
        log(f"\n=== front={front}: {t} groups x {x.shape[0]} batches in {wall * 1e3:.0f} ms "
            f"wall ({msps(t, x.shape[0], args.nb, wall):.0f} Ms/s with the profiler on); "
            f"trace: {path}")
        rep = {"wall_ms": wall * 1e3, "trace": path}
        if on_card and total_us == 0:
            # no device time in the profile: CUDA events per stage instead
            rep["profiler_device_time"] = "none seen; CUDA events per stage instead"
            rep["stage_ms_per_group"] = group_stage_split(program, x)
            log(f"the profiler saw no device time; per stage (CUDA events, ms a group): "
                f"{rep['stage_ms_per_group']}")
        else:
            what = "device" if on_card else "host CPU"
            log(f"{'per-batch':>10}  {'total':>9}  {'count':>6}  {what} op")
            for name, us, n in rows[:args.top]:
                log(f"{us / 1e3 / batches:8.3f} ms  {us / 1e3:7.1f} ms  {n:6d}  {name[:90]}")
            log(f"{what} total: {total_us / 1e3:.1f} ms ({total_us / 1e3 / batches:.3f} ms/batch)")
            rep["top"] = [{"name": nm, "ms": us / 1e3, "count": n} for nm, us, n in rows[:args.top]]
            if on_card:
                rep["device_total_ms"] = total_us / 1e3
                rep["busy_share"] = total_us / 1e3 / (wall * 1e3)
            else:
                rep["host_total_ms"] = total_us / 1e3
        reports[front] = rep
    return {"fronts": reports}


# ---------------------------------------------------------------------------
# stages: the per-stage demod breakdown and its roofline shares
# ---------------------------------------------------------------------------

def probe_stages(args) -> dict:
    from ..ops.demod import (
        candidate_passes_window,
        demod_batch,
        front_candidates,
        gather_candidate_windows,
    )
    from ..ops.magnitude import magnitude_from_iq

    mc, loops = args.mc, args.loops
    iq = torch.from_numpy(buffers(args, args.nb)).to(args.dev)
    nb, nbytes = iq.shape
    s = nbytes // 2
    m = magnitude_from_iq(iq)
    cand = demod_batch(iq, scan_len=SCAN_LEN, max_candidates=mc)
    w = gather_candidate_windows(m, cand.pos)
    stages = [
        # (name, stage, inputs (the first perturbed each call), least bytes:
        # inputs + outputs, magnitudes at 2 bytes)
        ("magnitude", magnitude_from_iq, (iq,), nb * (2 * s + 2 * s)),
        ("front", lambda mm: front_candidates(mm, SCAN_LEN, mc), (m,), nb * 2 * s + nb * mc * 4),
        ("gather", gather_candidate_windows, (m, cand.pos), nb * 2 * s + nb * mc * 256 * 2),
        ("passes", lambda ww, pp: candidate_passes_window(ww.reshape(nb * mc, -1),
                                                          pp.reshape(-1)),
         (w, cand.pos), nb * mc * 256 * 2 * 2),
        ("demod_full", lambda x: demod_batch(x, scan_len=SCAN_LEN, max_candidates=mc), (iq,),
         nb * 2 * s + nb * 2 * s),
    ]
    on_card = args.dev.type == "cuda"
    log(f"nb={nb} S={s} MC={mc}" + (f"  (roofline = least bytes / "
                                    f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s)" if on_card else ""))
    res = {}
    for name, fn, ins, least in stages:
        def run(fn=fn, ins=ins):
            acc = 0
            for i in range(loops):
                out = fn(air.perturb(ins[0], i), *ins[1:])
                acc = acc + _consume(out if isinstance(out, (tuple, list)) else (out,))
            return acc

        dt = best_per_call(run, args.dev, loops, trials=3)
        res[name] = {"ms": dt * 1e3, "least_mb": least / 1e6}
        line = f"{name:>10}: {dt * 1e3:6.3f} ms  least {least / 1e6:7.1f} MB"
        if on_card:
            res[name]["sol"] = least / HBM_BYTES_PER_S / dt
            line += f"  SoL {100 * res[name]['sol']:5.1f}%"
        log(line)
    return {"stages": res, "bound_by": "bytes"}


# ---------------------------------------------------------------------------
# link: transfer regimes
# ---------------------------------------------------------------------------

def probe_link(args) -> dict:
    dev, on_card, mb = args.dev, args.dev.type == "cuda", 64
    xs = [torch.from_numpy(np.random.randint(0, 255, mb << 20, dtype=np.uint8))
          for _ in range(3)]
    torch.empty(1, device=dev)  # the device context, outside the timing
    sync(dev)
    res = {}

    def h2d(name, tensors, pinned):
        if pinned:  # page-locked before the clock starts: the link's own rate
            tensors = [x.pin_memory() for x in tensors]
        t0 = time.perf_counter()
        ds = [x.to(dev, non_blocking=pinned) for x in tensors]
        sync(dev)
        dt = time.perf_counter() - t0
        res[name] = len(tensors) * mb / 1024 / dt
        log(f"H2D {name}: {res[name]:.2f} GB/s ({len(tensors) * mb} MB in {dt * 1e3:.0f} ms)")
        return ds

    ds = h2d("pre_kernel_pageable", xs, False)
    if on_card:
        h2d("pre_kernel_pinned", xs[:1], True)
    _ = int(torch.arange(1024, dtype=torch.int32, device=dev).sum())  # the first kernel
    h2d("post_kernel_pageable", xs[:1], False)
    if on_card:
        h2d("post_kernel_pinned", xs[:1], True)

    t0 = time.perf_counter()
    _ = ds[0].cpu()
    dt = time.perf_counter() - t0
    res["d2h_blocking"] = mb / 1024 / dt
    log(f"D2H (blocking): {res['d2h_blocking']:.3f} GB/s ({mb} MB in {dt * 1e3:.0f} ms)")
    if on_card:
        hosts = [torch.empty(d.shape, dtype=d.dtype, pin_memory=True) for d in ds[1:]]
        t0 = time.perf_counter()
        for h, d in zip(hosts, ds[1:]):
            h.copy_(d, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        done.synchronize()
        dt = time.perf_counter() - t0
        res["d2h_preissued_pinned"] = 2 * mb / 1024 / dt
        log(f"D2H (pre-issued non-blocking x2 into pinned memory): "
            f"{res['d2h_preissued_pinned']:.3f} GB/s ({2 * mb} MB in {dt * 1e3:.0f} ms)")
    for kb in (4, 512):
        small = torch.zeros(kb << 10, dtype=torch.uint8, device=dev)
        sync(dev)
        dt = best_per_call(lambda: small.cpu(), torch.device("cpu"), 1, trials=3)
        res[f"d2h_floor_{kb}kb_ms"] = dt * 1e3
        log(f"D2H floor ({kb} KB): {dt * 1e3:.3f} ms")
    return {"gbps_and_ms": res}


# ---------------------------------------------------------------------------
# staged-h2d: do uploads during the first dispatch keep their rate?
# ---------------------------------------------------------------------------

def probe_staged_h2d(args) -> dict:
    from ..ops import _cuda
    from ..ops.demod import demod_batch

    dev = args.dev
    g1_np = buffers(args, args.nb)
    chunks = [buffers(args, args.nb) for _ in range(6)]
    torch.empty(1, device=dev)  # the device context, outside the timing
    sync(dev)
    t0 = time.perf_counter()
    g1 = torch.from_numpy(g1_np).to(dev)
    sync(dev)
    rate0 = g1_np.nbytes / 1e9 / (time.perf_counter() - t0)
    log(f"[before any kernel] g1 {g1_np.nbytes / 1e6:.0f} MB at {rate0:.2f} GB/s")

    events = []
    stop = threading.Event()
    side = torch.cuda.Stream(dev) if dev.type == "cuda" else None

    def uploader():
        for x in chunks:
            if stop.is_set():
                return
            a = time.perf_counter()
            if side is not None:
                with torch.cuda.stream(side):
                    torch.from_numpy(x).to(dev)
                side.synchronize()
            else:
                torch.from_numpy(x).clone()
            events.append((a, time.perf_counter(), x.nbytes))

    th = threading.Thread(target=uploader, daemon=True)
    built_before = bool(_cuda.build_info)
    t_start = time.perf_counter()
    th.start()
    cand = demod_batch(g1, scan_len=SCAN_LEN, max_candidates=args.mc)
    t_dispatched = time.perf_counter()
    _ = int(cand.n.sum())
    t_done = time.perf_counter()
    stop.set()
    th.join(timeout=60)
    log(f"first dispatch returned: {t_dispatched - t_start:.2f}s (kernels "
        f"{'built here' if _cuda.build_info and not built_before else 'loaded, built before'});"
        f" first execution done: {t_done - t_start:.2f}s")
    uploads = []
    for a, b, nb_ in events:
        win = ("during-dispatch" if b <= t_dispatched else
               "post-execute" if a >= t_done else "straddles-exec")
        uploads.append({"window": win, "gbps": nb_ / 1e9 / (b - a),
                        "t0_s": a - t_start, "t1_s": b - t_start})
        log(f"[{win:>15}] {nb_ / 1e6:.0f} MB at {nb_ / 1e9 / (b - a):.2f} GB/s "
            f"(t={a - t_start:.2f}..{b - t_start:.2f}s)")
    t0 = time.perf_counter()
    torch.from_numpy(chunks[0]).to(dev)
    sync(dev)
    ctrl = chunks[0].nbytes / 1e9 / (time.perf_counter() - t0)
    log(f"[ post-execute] control {chunks[0].nbytes / 1e6:.0f} MB at {ctrl:.2f} GB/s")
    return {"before_kernel_gbps": rate0, "dispatch_s": t_dispatched - t_start,
            "first_done_s": t_done - t_start, "uploads": uploads, "control_gbps": ctrl,
            "kernels_built_here": bool(_cuda.build_info) and not built_before}


PROBES = {
    "steady": probe_steady,
    "scan": probe_scan,
    "front": probe_front,
    "ab-sustained": probe_ab_sustained,
    "ab-front2": probe_ab_front2,
    "ab-depth": probe_ab_depth,
    "trace": probe_trace,
    "stages": probe_stages,
    "link": probe_link,
    "staged-h2d": probe_staged_h2d,
}


def main(argv=None) -> int:
    from .. import resolve_device

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--probe", required=True, choices=sorted(PROBES))
    ap.add_argument("--nb", type=int, default=128)
    ap.add_argument("--mc", type=int, default=256)
    ap.add_argument("--g", type=int, default=12, help="batches a dispatch group")
    ap.add_argument("--t", type=int, default=None,
                    help="groups a timed run (default the probe's: 6; ab-depth 10; trace 2)")
    ap.add_argument("--loops", type=int, default=32,
                    help="calls in each timing loop of scan, front and stages")
    ap.add_argument("--front", default=None,
                    help="comma-separated front variants for --probe trace")
    ap.add_argument("--top", type=int, default=30, help="kernels to print per trace report")
    ap.add_argument("--variant", default=None, choices=sorted(front_variants()),
                    help="group-front arrangement for --probe trace (default the product's "
                    "_group_front; pin is hoist on a .contiguous() row-major input)")
    ap.add_argument("--trace-dir", default=os.path.join(tempfile.gettempdir(),
                                                        "d1090_torch_trace"),
                    help="where --probe trace writes its chrome traces")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; no card is an error) or cpu (a dry run of the "
                    "logic, the JAX tool's --allow-cpu)")
    ap.add_argument("--input", default=None,
                    help="uint8 IQ capture (default: the planted dense air)")
    args = ap.parse_args(argv)
    args.dev = resolve_device(args.device)
    dev_rec = device_record(args.dev)
    log(f"device: {dev_rec}")
    from ..ops import _cuda

    _cuda.reset_launches()
    res = PROBES[args.probe](args)
    print(json.dumps({"probe": args.probe, "device": dev_rec, **res,
                      "launches": dict(_cuda.launches)}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
