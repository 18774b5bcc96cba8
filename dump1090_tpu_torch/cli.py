"""Command line interface of the port: the file decode with the resolver on
the device, `--raw` and `--stats` (port of the fast device path of
dump1090_tpu/cli.py).

Flags keep the reference's and the JAX package's spellings and semantics.
`--device cuda|cpu` takes the place of `--tpu-backend`; the default is
cuda, and without a card the CLI stops with an error rather than decoding
on the CPU.  Every other flag of the JAX package's CLI, and any run that
would need its verbose (message display) output, stops with a "not yet
ported" error: the port never gives a different output without saying so.
"""

from __future__ import annotations

import sys
import time

HELP = """\
--ifile <filename>       Read data from file (use '-' for stdin).
--raw                    Show only messages hex values.
--no-fix                 Disable single-bits error correction using CRC.
--aggressive             More CPU for more messages (two bits fixes, ...).
--stats                  With --ifile print stats at exit. No other output.
--help                   Show this help.

--tpu-max-candidates <n> Max preamble candidates per block (default: 256).
--tpu-batch <n>          IQ buffers per batch (default: 64 for files, 1
                         for stdin).
--tpu-dispatch-ahead <n> Dispatch groups held in flight before the oldest
                         is fetched (0 = auto: 3 for seekable files, 1
                         otherwise; identical output).
--device <name>          cuda (default) or cpu.

Not yet ported to this package (use python -m dump1090_tpu): the verbose
display, --interactive, --net*, --onlyaddr, --no-crc-check, --debug,
--snip, --loop, live RTL-SDR input and the other --tpu-* options.
"""

# the JAX package's CLI flags that take a value and are not ported here
_UNPORTED_WITH_VALUE = {
    "--device-index", "--gain", "--freq", "--ppm", "--interactive-rows",
    "--interactive-ttl", "--net-ro-port", "--net-ri-port", "--net-http-port",
    "--net-sbs-port", "--snip", "--debug", "--tpu-profile", "--tpu-state-load",
    "--tpu-state-save", "--tpu-backend", "--tpu-shard-time", "--tpu-front",
    "--tpu-preload", "--tpu-device-resolve",
}
_UNPORTED = {
    "--enable-agc", "--loop", "--interactive", "--net", "--net-only",
    "--no-crc-check", "--onlyaddr", "--metric",
}


class Options:
    def __init__(self):
        self.filename: str | None = None
        self.fix_errors = True
        self.aggressive = False
        self.raw = False
        self.stats = False
        self.max_candidates = 256
        self.batch: int | None = None   # buffers per batch
        self.dispatch_ahead = 0
        self.device = "cuda"


def _c_atoi(s: str) -> int:
    """C atoi semantics: the longest leading integer prefix, 0 on junk."""
    import re

    m = re.match(r"[ \t\n\r\f\v]*[+-]?[0-9]+", s)
    return int(m.group()) if m else 0


def _not_ported(what: str) -> SystemExit:
    sys.stderr.write(
        f"dump1090_tpu_torch: {what} is not yet ported to the PyTorch/CUDA "
        f"package; use python -m dump1090_tpu for it.\n"
    )
    return SystemExit(2)


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

        if arg == "--ifile" and more:
            o.filename = nxt()
        elif arg == "--no-fix":
            o.fix_errors = False
        elif arg == "--raw":
            o.raw = True
        elif arg == "--aggressive":
            o.aggressive = True
        elif arg == "--stats":
            o.stats = True
        elif arg == "--tpu-max-candidates" and more:
            o.max_candidates = int(nxt())
        elif arg == "--tpu-batch" and more:
            o.batch = int(nxt())
        elif arg == "--tpu-dispatch-ahead" and more:
            o.dispatch_ahead = _c_atoi(nxt())
        elif arg == "--device" and more:
            o.device = nxt()
            if o.device not in ("cuda", "cpu"):
                sys.stderr.write(f"--device: expected cuda|cpu, got '{o.device}'.\n")
                raise SystemExit(1)
        elif arg == "--help":
            sys.stdout.write(HELP)
            raise SystemExit(0)
        elif arg in _UNPORTED or (arg in _UNPORTED_WITH_VALUE and more):
            raise _not_ported(f"option '{arg}'")
        else:
            sys.stderr.write(
                f"Unknown or not enough arguments for option '{arg}'.\n\n"
            )
            sys.stdout.write(HELP)
            raise SystemExit(1)
        j += 1
    if o.filename is None:
        raise _not_ported("live RTL-SDR input (no --ifile)")
    if not (o.raw or o.stats):
        raise _not_ported("the verbose message display (give --raw or --stats)")
    return o


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
    # `... --raw | head` prints no traceback and stops decoding
    import signal

    try:
        signal.signal(signal.SIGPIPE, signal.SIG_DFL)
    except (ValueError, OSError, AttributeError):
        pass  # non-main thread / non-POSIX: keep Python's default

    from .models.decoder import DecoderConfig
    from .models.pipeline import DemodPipeline, PipelineConfig

    batch = o.batch if o.batch is not None else (1 if o.filename == "-" else 64)
    try:
        pipeline = DemodPipeline(
            PipelineConfig(
                decoder=DecoderConfig(fix_errors=o.fix_errors, aggressive=o.aggressive),
                max_candidates=o.max_candidates,
                batch_buffers=batch,
                # 8 batches per dispatch group for files, 1 for stdin
                dispatch_groups=1 if o.filename == "-" else 8,
                dispatch_ahead=o.dispatch_ahead,
            ),
            device=o.device,
        )
    except RuntimeError as e:
        sys.stderr.write(f"dump1090_tpu_torch: {e}\n")
        return 1

    from .io.sources import open_iq_source

    try:
        stream = open_iq_source(o.filename)
    except OSError as e:
        # reference: perror("Opening data file") + exit(1), dump1090.c:2952-2953
        print(f"Opening data file: {e.strerror}", file=sys.stderr)
        return 1
    t_start = time.time()
    try:
        w = sys.stdout.buffer
        for line in pipeline.stream_raw_device(stream):
            # --stats mode emits nothing but the counters
            if line and o.raw and not o.stats:
                w.write(line)
                w.flush()
    except KeyboardInterrupt:
        return 0
    finally:
        if o.stats:
            # throughput meter on stderr keeps stdout byte-exact
            dt = max(time.time() - t_start, 1e-9)
            ns = pipeline.samples_in * 1.0
            sys.stderr.write(
                f"# {ns/1e6:.1f} Msamples in {dt:.2f}s = "
                f"{ns/dt/1e6:.1f} Msamples/s ({ns/dt/2e6:.0f}x realtime) "
                f"on {pipeline.device}\n"
            )
        if stream is not sys.stdin.buffer:
            stream.close()

    if o.stats:
        print_stats(pipeline.stats)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
