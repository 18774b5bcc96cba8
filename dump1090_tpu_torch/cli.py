"""Command line interface of the port (a port of dump1090_tpu/cli.py): file
and live RTL-SDR decode with the demodulator on the device and the resolver
on the device or the host, and every output of the JAX package's CLI behind
it.

Behavioral contract: main/showHelp/argv loop, dump1090.c:2787-3012.  Flags
keep the reference's and the JAX package's spellings and semantics.
Routing, as in the JAX package: on a file, pure `--raw` or `--stats` with no
other consumer takes the bulk device path (DemodPipeline.stream_raw_device);
with the resolver on the host, pure `--raw` takes the bulk host path
(stream_records, the C++ runtime); every other run (the verbose display,
`--onlyaddr`, `--no-crc-check`, `--interactive`, `--net`) takes
DemodPipeline.run_device and the message hub, or with the resolver on the
host or `--debug` DemodPipeline.run and the hub.  Live input (no `--ifile`:
io/rtlsdr.py) takes run_source_device, or run_source with the resolver on
the host or `--debug`, one buffer a dispatch.  `--tpu-shard-time <n>` takes
api.decode_capture_sharded: each buffer's timeline sharded over n devices
(parallel/sharding.py).  `--tpu-device-resolve auto`
puts the resolver on the device for cuda and on the host for cpu
(ops.resolve.use_device_resolve).  `--net-only` does no device work.

`--device cuda|cpu` picks the device; `--tpu-backend cpu|cuda|gpu` is an
alias.  The default is cuda, and without a card (or, for `--tpu-shard-time
n`, with fewer than n cards) the CLI stops with an error rather than
decoding on the CPU.
"""

from __future__ import annotations

import sys
import time

from .constants import INTERACTIVE_ROWS, INTERACTIVE_TTL

HELP = """\
--device-index <index>   Select RTL device (default: 0).
--gain <db>              Set gain (default: max gain. Use -100 for auto-gain).
--enable-agc             Enable the Automatic Gain Control (default: off).
--freq <hz>              Set frequency (default: 1090 Mhz).
--ppm <error>            Set receiver error in parts per million (default: 0).
--ifile <filename>       Read data from file (use '-' for stdin).
--loop                   With --ifile, read the same file in a loop.
--interactive            Interactive mode refreshing data on screen.
--interactive-rows <num> Max number of rows in interactive mode (default: 15).
--interactive-ttl <sec>  Remove from list if idle for <sec> (default: 60).
--raw                    Show only messages hex values.
--net                    Enable networking.
--net-only               Enable just networking, no RTL device or file used.
--net-ro-port <port>     TCP listening port for raw output (default: 30002).
--net-ri-port <port>     TCP listening port for raw input (default: 30001).
--net-http-port <port>   HTTP server port (default: 8080).
--net-sbs-port <port>    TCP listening port for BaseStation format output (default: 30003).
--no-fix                 Disable single-bits error correction using CRC.
--no-crc-check           Disable messages with broken CRC (discouraged).
--aggressive             More CPU for more messages (two bits fixes, ...).
--stats                  With --ifile print stats at exit. No other output.
--onlyaddr               Show only ICAO addresses (testing purposes).
--metric                 Use metric units (meters, km/h, ...).
--snip <level>           Strip IQ file removing samples < level.
--debug <flags>          Debug mode (verbose), see README for details.
--help                   Show this help.

--tpu-max-candidates <n> Max preamble candidates per block (default: 256).
--tpu-batch <n>          IQ buffers per batch (default: 64 for files, 16
                         with the resolver on the host, 1 for stdin).
--tpu-profile <dir>      Write a torch.profiler trace of the decode (host
                         and CUDA activity) to <dir> as a Chrome trace.
--tpu-dispatch-ahead <n> Dispatch groups held in flight before the oldest
                         is fetched (0 = auto: 3 for seekable files, 1
                         for stdin, live, looped or throttled input and
                         under --tpu-preload staged; identical output).
--tpu-preload <m>        auto|staged|off: upload a regular file to the
                         device before the first dispatch (auto), one
                         group and then the rest on a reader thread while
                         it decodes (staged), or always stream through
                         the reader thread (off).
--tpu-front <name>       Preamble-scan formulation: mask or
                         packed[-plain][-mxu] (default: mask, or
                         DUMP1090_TPU_FRONT).  All bit-identical; see
                         ops/demod.py:front_candidates.
--tpu-state-load <file>  Restore tracker/ICAO-cache/stats snapshot at start.
--tpu-state-save <file>  Save a state snapshot on exit (checkpoint/resume).
--tpu-shard-time <n>     Shard each buffer's timeline over <n> devices with
                         overlap-save halo exchange (multi-card decode of
                         one stream; identical output to the unsharded
                         path).  On cpu the n shards share the CPU.
--tpu-device-resolve <on|off|auto>
                         Run the sequential resolver on the device (on) or
                         on the host (off: the C++ runtime); auto = on for
                         cuda, off for cpu.
--device <name>          cuda (default) or cpu.
--tpu-backend <name>     Alias of --device: cpu, or cuda (gpu).

Debug mode flags: d = Log frames decoded with errors
                  D = Log frames decoded with zero errors
                  c = Log frames with bad CRC
                  C = Log frames with good CRC
                  p = Log frames with bad preamble
                  n = Log network debugging info
                  j = Log frames to frames.js, loadable by debug.html.
"""

# --tpu-backend names and the --device each stands for
_BACKENDS = {"cpu": "cpu", "cuda": "cuda", "gpu": "cuda"}


def get_term_rows() -> int:
    """Terminal row count for the interactive TUI (getTermRows,
    dump1090.c:2781-2785: TIOCGWINSZ on stdout), or the 15-row default when
    stdout is not a terminal."""
    import os

    try:
        return os.get_terminal_size(sys.stdout.fileno()).lines
    except (OSError, ValueError, AttributeError):
        return INTERACTIVE_ROWS


class Options:
    def __init__(self):
        self.gain = 999999
        self.dev_index = 0
        self.enable_agc = False
        self.freq = 1090000000
        self.ppm = 0
        self.filename: str | None = None
        self.loop = False
        self.fix_errors = True
        self.check_crc = True
        self.aggressive = False
        self.raw = False
        self.stats = False
        self.onlyaddr = False
        self.metric = False
        self.net = False
        self.net_only = False
        self.ro_port = 30002
        self.ri_port = 30001
        self.http_port = 8080
        self.sbs_port = 30003
        self.interactive = False
        self.interactive_rows = get_term_rows()
        self.interactive_ttl = INTERACTIVE_TTL
        self.snip: int | None = None
        self.max_candidates = 256
        self.batch: int | None = None   # buffers per batch
        self.dispatch_ahead = 0
        self.preload = "auto"
        self.front: str | None = None
        self.profile_dir: str | None = None
        self.state_load: str | None = None
        self.state_save: str | None = None
        self.debug = ""
        self.device_resolve = "auto"
        self.device = "cuda"
        self.shard_time: int | None = None


def _c_atoi(s: str) -> int:
    """C atoi semantics: the longest leading integer prefix, 0 on junk."""
    import re

    m = re.match(r"[ \t\n\r\f\v]*[+-]?[0-9]+", s)
    return int(m.group()) if m else 0


def _c_atof(s: str) -> float:
    """C atof: longest leading float prefix, 0.0 on junk (--gain)."""
    import re

    m = re.match(r"[ \t\n\r\f\v]*[+-]?([0-9]+(\.[0-9]*)?|\.[0-9]+)([eE][+-]?[0-9]+)?", s)
    return float(m.group()) if m else 0.0


def parse_args(argv: list[str]) -> Options:
    o = Options()
    j = 0
    while j < len(argv):
        arg = argv[j]
        more = j + 1 < len(argv)

        def nxt() -> str:
            nonlocal j
            j += 1
            return argv[j]

        if arg == "--device-index" and more:
            o.dev_index = _c_atoi(nxt())
        elif arg == "--gain" and more:
            o.gain = int(_c_atof(nxt()) * 10)
        elif arg == "--enable-agc":
            o.enable_agc = True
        elif arg == "--freq" and more:
            o.freq = _c_atoi(nxt())
        elif arg == "--ppm" and more:
            o.ppm = _c_atoi(nxt())
        elif arg == "--ifile" and more:
            o.filename = nxt()
        elif arg == "--loop":
            o.loop = True
        elif arg == "--no-fix":
            o.fix_errors = False
        elif arg == "--no-crc-check":
            o.check_crc = False
        elif arg == "--raw":
            o.raw = True
        elif arg == "--net":
            o.net = True
        elif arg == "--net-only":
            o.net = True
            o.net_only = True
        elif arg == "--net-ro-port" and more:
            o.ro_port = _c_atoi(nxt())
        elif arg == "--net-ri-port" and more:
            o.ri_port = _c_atoi(nxt())
        elif arg == "--net-http-port" and more:
            o.http_port = _c_atoi(nxt())
        elif arg == "--net-sbs-port" and more:
            o.sbs_port = _c_atoi(nxt())
        elif arg == "--onlyaddr":
            o.onlyaddr = True
        elif arg == "--metric":
            o.metric = True
        elif arg == "--aggressive":
            o.aggressive = True
        elif arg == "--interactive":
            o.interactive = True
        elif arg == "--interactive-rows" and more:
            o.interactive_rows = _c_atoi(nxt())
        elif arg == "--interactive-ttl" and more:
            o.interactive_ttl = _c_atoi(nxt())
        elif arg == "--debug" and more:
            flags = nxt()
            for f in flags:
                if f not in "dDcCpnj":
                    sys.stderr.write(f"Unknown debugging flag: {f}\n")
                    raise SystemExit(1)
            o.debug = flags
        elif arg == "--stats":
            o.stats = True
        elif arg == "--snip" and more:
            o.snip = _c_atoi(nxt())
        elif arg == "--tpu-max-candidates" and more:
            o.max_candidates = int(nxt())
        elif arg == "--tpu-batch" and more:
            o.batch = int(nxt())
        elif arg == "--tpu-dispatch-ahead" and more:
            o.dispatch_ahead = _c_atoi(nxt())
        elif arg == "--tpu-profile" and more:
            o.profile_dir = nxt()
        elif arg == "--tpu-front" and more:
            # validated here, not at the first dispatch; passed down as
            # PipelineConfig.front (the environment is left as it is)
            from .ops.demod import check_front

            o.front = nxt()
            try:
                check_front(o.front)
            except ValueError:
                sys.stderr.write(
                    f"--tpu-front: expected mask|packed[-plain][-mxu], got '{o.front}'.\n"
                )
                raise SystemExit(1) from None
        elif arg == "--tpu-preload" and more:
            o.preload = nxt()
            if o.preload not in ("auto", "staged", "off"):
                sys.stderr.write(
                    f"--tpu-preload: expected auto|staged|off, got '{o.preload}'.\n"
                )
                raise SystemExit(1)
        elif arg == "--tpu-backend" and more:
            name = nxt()
            if name not in _BACKENDS:
                sys.stderr.write(
                    f"--tpu-backend: this package runs on cuda or cpu, not '{name}'; "
                    f"use --device cuda|cpu.\n"
                )
                raise SystemExit(1)
            o.device = _BACKENDS[name]
        elif arg == "--tpu-state-load" and more:
            o.state_load = nxt()
        elif arg == "--tpu-state-save" and more:
            o.state_save = nxt()
        elif arg == "--tpu-device-resolve" and more:
            o.device_resolve = nxt()
            if o.device_resolve not in ("on", "off", "auto"):
                sys.stderr.write(
                    f"--tpu-device-resolve: expected on|off|auto, got '{o.device_resolve}'.\n"
                )
                raise SystemExit(1)
        elif arg == "--device" and more:
            o.device = nxt()
            if o.device not in ("cuda", "cpu"):
                sys.stderr.write(f"--device: expected cuda|cpu, got '{o.device}'.\n")
                raise SystemExit(1)
        elif arg == "--help":
            sys.stdout.write(HELP)
            raise SystemExit(0)
        elif arg == "--tpu-shard-time" and more:
            o.shard_time = int(nxt())
        else:
            sys.stderr.write(
                f"Unknown or not enough arguments for option '{arg}'.\n\n"
            )
            sys.stdout.write(HELP)
            raise SystemExit(1)
        j += 1
    return o


def snip_mode(level: int) -> None:
    """IQ thinning filter: drop runs of >32 consecutive low samples
    (snipMode, dump1090.c:2226-2244)."""
    stdin = sys.stdin.buffer
    stdout = sys.stdout.buffer
    c = 0
    while True:
        pair = stdin.read(2)
        if len(pair) < 2:
            break
        i, q = pair[0], pair[1]
        if abs(i - 127) < level and abs(q - 127) < level:
            c += 1
            if c > 8 * 4:
                continue
        else:
            c = 0
        stdout.write(pair)
    stdout.flush()


def print_stats(stats) -> None:
    """Exit stats printer, byte-identical to dump1090.c:2993-3006."""
    print(f"{stats.valid_preamble} valid preambles")
    print(f"{stats.out_of_phase} demodulated again after phase correction")
    print(f"{stats.demodulated} demodulated with zero errors")
    print(f"{stats.goodcrc} with good crc")
    print(f"{stats.badcrc} with bad crc")
    print(f"{stats.fixed} errors corrected")
    print(f"{stats.single_bit_fix} single bit errors")
    print(f"{stats.two_bits_fix} two bits errors")
    print(f"{stats.goodcrc + stats.fixed} total usable messages")


def main(argv: list[str] | None = None) -> int:
    o = parse_args(sys.argv[1:] if argv is None else argv)

    # C process semantics on a closed stdout pipe: die of SIGPIPE, so
    # `... --raw | head` prints no traceback and stops decoding (the
    # reference ignores SIGPIPE in net mode only, dump1090.c:2294)
    if not o.net:
        import signal

        try:
            signal.signal(signal.SIGPIPE, signal.SIG_DFL)
        except (ValueError, OSError, AttributeError):
            pass  # non-main thread / non-POSIX: keep Python's default

    if o.snip is not None:
        snip_mode(o.snip)
        return 0

    import threading

    from .models.decoder import DecoderConfig, DecoderStats, IcaoCache
    from .models.hub import HubConfig, MessageHub
    from .models.tracker import AircraftTracker

    dcfg = DecoderConfig(fix_errors=o.fix_errors, aggressive=o.aggressive)
    hub_cfg = HubConfig(
        raw=o.raw, onlyaddr=o.onlyaddr, check_crc=o.check_crc, interactive=o.interactive,
        net=o.net, stats_only=o.stats, metric=o.metric,
    )
    tracker = AircraftTracker(interactive_ttl=o.interactive_ttl)

    # Decode state (ICAO cache, stats, tracker, stdout) is mutated both by
    # the file decode and by raw network input arriving on the asyncio
    # thread; the reference is single-threaded (it polls its sockets
    # between buffers, dump1090.c:2831-2847), so the two are serialized.
    # Reentrant: the pipeline holds it around each batch's emits, and the
    # emit callback takes it again around hub.use_message.
    state_lock = threading.RLock()

    # --tpu-device-resolve auto: the resolver kernels on the card for
    # cuda, the host resolver for cpu
    if o.device_resolve == "auto":
        from .ops.resolve import use_device_resolve

        use_dev = use_device_resolve(o.device)
    else:
        use_dev = o.device_resolve == "on"
    live = o.filename is None

    # the pipeline owns the cache and the stats; in net-only mode there is
    # no pipeline and no device work
    pipeline = None
    if o.net_only:
        stats, cache = DecoderStats(), IcaoCache()
    else:
        from .models.pipeline import DemodPipeline, PipelineConfig
        from .utils.debug import DebugFlags

        if live:
            # one buffer per dispatch: 65 ms of air
            cfg = PipelineConfig(decoder=dcfg, max_candidates=o.max_candidates, batch_buffers=1,
                                 dispatch_ahead=o.dispatch_ahead, front=o.front)
        else:
            # batched dispatch for files; one buffer per dispatch for stdin.
            # The host-resolve path (resolver off, --debug) takes 16 buffers
            # a batch and no dispatch groups, as in the JAX package
            dev_batching = use_dev and not o.debug
            batch = o.batch if o.batch is not None else (
                1 if o.filename == "-" else 64 if dev_batching else 16)
            cfg = PipelineConfig(
                decoder=dcfg, max_candidates=o.max_candidates, loop=o.loop,
                batch_buffers=1 if o.interactive else batch,
                # the reference slows --ifile playback in interactive mode
                # (usleep(5000) per buffer, dump1090.c:471-477)
                throttle_s=0.005 if o.interactive else 0.0,
                # 8 batches per dispatch group for files on the device path,
                # 1 for stdin and interactive feeds
                dispatch_groups=(8 if dev_batching and not o.interactive
                                 and o.filename != "-" else 1),
                preload=o.preload, dispatch_ahead=o.dispatch_ahead, front=o.front,
            )
        mesh = None  # --tpu-shard-time's device mesh, made before any decode
        try:
            if o.shard_time and not live:
                from .parallel.sharding import device_mesh

                mesh = device_mesh(o.shard_time, o.device)
            pipeline = DemodPipeline(
                cfg, device=o.device, lock=state_lock,
                debug_flags=DebugFlags.parse(o.debug) if o.debug else None,
            )
        except (RuntimeError, ValueError) as e:
            sys.stderr.write(f"dump1090_tpu_torch: {e}\n")
            return 1
        stats, cache = pipeline.stats, pipeline.cache

    hub = MessageHub(hub_cfg, tracker, stats)

    # TUI redraw guard: a plain lock held while the main thread mutates the
    # tracker, so the SIGWINCH handler (which runs between bytecodes of the
    # same thread) redraws at once only when the tracker is consistent, and
    # otherwise leaves the new row count to the next refresh
    tui_guard = threading.Lock()
    if o.interactive:
        _install_sigwinch(o, tracker, state_lock, tui_guard)

    if o.state_load:
        from .utils import state as state_mod

        state_mod.load(o.state_load, tracker, cache, stats)

    net = None
    if o.net:
        net = network_services(o, hub, cache, dcfg, state_lock)
        try:
            net.start()
        except OSError:
            # reference order: main announces net-only mode (dump1090.c:2945)
            # before modesInitNet fails the bind (:2282-2289), both on stderr
            if o.net_only:
                sys.stderr.write("Net-only mode, no RTL device or file open.\n")
            sys.stderr.write(net.bind_error_message() + "\n")
            return 1

    try:
        if o.net_only:
            sys.stderr.write("Net-only mode, no RTL device or file open.\n")
            last_refresh = 0.0
            while True:
                time.sleep(0.1)
                if not o.interactive:
                    with state_lock:
                        tracker.remove_stale()
                # TUI refresh gated at 250 ms like backgroundTasks
                # (MODES_INTERACTIVE_REFRESH_TIME, dump1090.c:89, 2839-2846);
                # the refresh itself evicts stale aircraft under the lock
                elif time.time() - last_refresh > 0.25:
                    _interactive_refresh(tracker, o, state_lock, tui_guard)
                    last_refresh = time.time()

        sdr = None
        if live:
            # live RTL-SDR capture (modesInitRTLSDR, dump1090.c:385-434):
            # librtlsdr is bound at run time; without it, a clean error
            from .io.rtlsdr import RtlSdrError, RtlSdrSource, RtlSdrUnavailable

            try:
                sdr = RtlSdrSource(dev_index=o.dev_index, gain=o.gain,
                                   enable_agc=o.enable_agc, freq=o.freq, ppm=o.ppm)
            except RtlSdrUnavailable as e:
                sys.stderr.write(
                    f"No RTL-SDR support on this host ({e}): provide "
                    "--ifile (use '-' for stdin) or --net-only.\n"
                )
                return 1
            except RtlSdrError:
                return 1  # enumeration/open error already printed, like exit(1)

        from .io.sources import open_iq_source

        try:
            stream = open_iq_source(o.filename) if o.filename else None
        except OSError as e:
            # reference: perror("Opening data file") + exit(1), dump1090.c:2952-2953
            print(f"Opening data file: {e.strerror}", file=sys.stderr)
            return 1
        last_refresh = [0.0]
        t_start = time.time()
        profiler = _start_profiler(o.device) if o.profile_dir else None

        def on_message(mm) -> None:
            # the tui_guard marks the tracker-mutating region so a SIGWINCH
            # arriving mid-update defers its redraw
            with state_lock, tui_guard:
                hub.use_message(mm)
            if o.interactive:
                now = time.time()
                if now - last_refresh[0] > 0.25:
                    _interactive_refresh(tracker, o, state_lock, tui_guard)
                    last_refresh[0] = now

        # pure --raw / --stats with no other consumer: the bulk paths, which
        # format hex lines and build no per-message objects (file decode
        # only; live input takes the one-buffer streaming paths)
        solo = (sdr is None and not o.interactive and not o.net and not o.onlyaddr
                and o.check_crc and not o.debug)
        fast_dev = solo and (o.raw or o.stats) and use_dev
        fast_raw = solo and o.raw and not o.stats and not use_dev and pipeline._native is not None
        try:
            if sdr is not None:
                if use_dev and not o.debug:
                    # demod and the sequential resolve on the device; buffer
                    # N+1 uploads on the ingest thread while N resolves
                    pipeline.run_source_device(sdr.buffers(), on_message)
                else:
                    pipeline.run_source(sdr.buffers(), on_message)
            elif o.shard_time:
                # one stream's timeline sharded over the mesh's sp axis with
                # halo exchange (parallel/sharding.py)
                from .api import decode_capture_sharded

                progress = {"samples": 0}
                decode_capture_sharded(
                    stream, mesh=mesh, config=dcfg, stats=stats, cache=cache,
                    emit=on_message, max_candidates=o.max_candidates, progress=progress,
                    lock=state_lock,
                )
                pipeline.samples_in = progress["samples"]
            elif fast_dev:
                w = sys.stdout.buffer
                for line in pipeline.stream_raw_device(stream):
                    # --stats mode emits nothing but the counters
                    if line and o.raw and not o.stats:
                        w.write(line)
                        w.flush()
            elif fast_raw:
                from .native import records_to_raw_lines

                w = sys.stdout.buffer
                for rec in pipeline.stream_records(stream):
                    line = records_to_raw_lines(rec)
                    if line:
                        w.write(line)
                        w.flush()
            elif use_dev and not o.debug:
                # the full-fidelity hub path (verbose, tracker, SBS, net)
                # with the sequential resolve on the device
                pipeline.run_device(stream, on_message)
            else:
                # the hub path with the sequential resolve on the host;
                # --debug dumps interleave with the display in scan order
                pipeline.run(stream, on_message)
            if o.interactive:
                # the final state stays visible
                _interactive_refresh(tracker, o, state_lock, tui_guard)
        finally:
            if profiler is not None:
                _stop_profiler(profiler, o.profile_dir)
            if o.stats:
                # throughput meter on stderr keeps stdout byte-exact
                dt = max(time.time() - t_start, 1e-9)
                ns = pipeline.samples_in * 1.0
                sys.stderr.write(
                    f"# {ns/1e6:.1f} Msamples in {dt:.2f}s = "
                    f"{ns/dt/1e6:.1f} Msamples/s ({ns/dt/2e6:.0f}x realtime) "
                    f"on {pipeline.device}\n"
                )
            if sdr is not None:
                sdr.close()
            if stream is not None and stream is not sys.stdin.buffer:
                stream.close()
    except KeyboardInterrupt:
        return 0
    finally:
        if net:
            net.stop()
        if o.state_save:
            from .utils import state as state_mod

            state_mod.save(o.state_save, tracker, cache, stats)

    if o.stats and o.filename:
        print_stats(stats)
    return 0


def _start_profiler(device: str):
    """A started torch.profiler.profile recording host activity and, on
    cuda, the card's (kernels, copies): --tpu-profile's stand-in for the
    JAX package's jax.profiler.trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device == "cuda" and torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    return prof


def _stop_profiler(prof, out_dir: str) -> None:
    """Stop the profile and write it to `out_dir` as a Chrome trace
    (`dump1090_tpu_torch.<pid>.pt.trace.json`, readable by chrome://tracing,
    Perfetto and TensorBoard's profiler plugin)."""
    import os

    prof.stop()
    os.makedirs(out_dir, exist_ok=True)
    name = f"dump1090_tpu_torch.{os.getpid()}.pt.trace.json"
    prof.export_chrome_trace(os.path.join(out_dir, name))


def network_services(o: Options, hub, cache, dcfg, state_lock):
    """The CLI's network services wired to the message hub, not started:
    each raw input line decoded against the host ICAO cache into the hub
    under the state lock, /data.json from the hub's tracker, the HTTP and
    SBS client counters in the hub's stats, and the hub's raw and SBS
    sinks pointed at the broadcasts."""
    from .io.net import NetConfig, NetworkServices
    from .models.decoder import decode_hex_message
    from .utils import display as disp

    stats = hub.stats

    def on_raw_line(line: str) -> None:
        with state_lock:
            mm = decode_hex_message(line, cache, dcfg, stats)
            if mm is not None:
                hub.use_message(mm)

    def bump(attr: str) -> None:
        setattr(stats, attr, getattr(stats, attr) + 1)

    net = NetworkServices(
        NetConfig(ro_port=o.ro_port, ri_port=o.ri_port, http_port=o.http_port,
                  sbs_port=o.sbs_port, debug_net="n" in o.debug),
        on_raw_line=on_raw_line,
        data_json=lambda: disp.aircraft_json(hub.tracker, o.metric),
        on_http_request=lambda: bump("http_requests"),
        on_sbs_connect=lambda: bump("sbs_connections"),
    )
    hub.raw_sink = net.broadcast_raw
    hub.sbs_sink = net.broadcast_sbs
    return net


def _install_sigwinch(o, tracker, state_lock, tui_guard) -> None:
    """Re-read the terminal height and redraw on resize (sigWinchCallback,
    dump1090.c:2772-2777).  The handler runs between arbitrary bytecodes on
    the main thread, so it redraws only when the tracker is not mid-mutation
    (tui_guard free); otherwise the new row count takes effect at the next
    refresh."""
    import signal

    def _winch(sig, frame):
        o.interactive_rows = get_term_rows()
        if tui_guard.acquire(blocking=False):
            try:
                _interactive_refresh(tracker, o, state_lock, None)
            finally:
                tui_guard.release()

    try:
        signal.signal(signal.SIGWINCH, _winch)
    except (ValueError, AttributeError):
        pass  # non-main thread or platform without SIGWINCH


def _interactive_refresh(tracker, o, state_lock=None, tui_guard=None) -> None:
    """Evict stale aircraft and redraw the table, under the state lock (the
    asyncio net thread mutates the same tracker) and flagged by tui_guard
    so a concurrent SIGWINCH defers its own redraw."""
    import contextlib
    import shutil

    from .utils import display as disp

    with (state_lock or contextlib.nullcontext()), (tui_guard or contextlib.nullcontext()):
        tracker.remove_stale()
        rows = o.interactive_rows or shutil.get_terminal_size().lines
        now = int(time.time())
        screen = disp.interactive_screen(tracker, rows=rows, metric=o.metric, now=now,
                                         spinner_t=now)
    sys.stdout.write(screen)
    sys.stdout.flush()


if __name__ == "__main__":
    raise SystemExit(main())
