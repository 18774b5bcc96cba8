"""Correctness and measurement tools of the port, run as modules:

    python -m dump1090_tpu_torch.tools.fuzz_diff        differential fuzz of IQ streams
    python -m dump1090_tpu_torch.tools.soak_device      wall-clock soaks
    python -m dump1090_tpu_torch.tools.snr_sweep        decode rate against SNR
    python -m dump1090_tpu_torch.tools.net_capture      raw and SBS streams of `--ifile - --net`
    python -m dump1090_tpu_torch.tools.fuzz_hex         differential fuzz of the hex input
    python -m dump1090_tpu_torch.tools.sweep_hex        exhaustive field sweeps of the hex input
    python -m dump1090_tpu_torch.tools.http_diff        /data.json after a CPR scenario
    python -m dump1090_tpu_torch.tools.netdebug_diff    the --debug n log of a net session
    python -m dump1090_tpu_torch.tools.gen_cpr_vectors  CPR vectors for the golden harness
    python -m dump1090_tpu_torch.tools.refbuild         build the reference binary
    python -m dump1090_tpu_torch.tools.bench            sustained_e2e benchmark (bench.py)
    python -m dump1090_tpu_torch.tools.measure          measurement probes (--probe NAME)
    python -m dump1090_tpu_torch.tools.exp_demod_front  front formulations: check and time

The tools that decode IQ (fuzz_diff, soak_device, snr_sweep, net_capture)
take `--device` (default cuda; no card is an error; fuzz_diff, soak_device
and snr_sweep also under the JAX tools' name `--backend`) and hold the port on
the device against its own CPU run of the same bytes, under the same clock
values; those with `--ref CMD` also against an oracle that speaks the
reference's CLI (the reference binary, built by refbuild.py, or the JAX
package's CLI).  The hex-input, HTTP and --debug n tools drive
`--net-only`, which does no device work, and need `--ref`'s oracle; they,
gen_cpr_vectors and refbuild take no `--device` and need no card.  The
measurement tools (bench, measure, exp_demod_front; their inputs in
air.py) take `--device` too and print one JSON line with the card's name,
count and power limit beside every number."""

# --backend names (the JAX tools' spelling of --device) and the device each
# stands for: the JAX tools' platforms that this package runs on
BACKENDS = {"cpu": "cpu", "cuda": "cuda", "gpu": "cuda", "auto": "cuda"}


def add_device_options(ap) -> None:
    """--device, and --backend, its alias in the JAX tools' spelling."""
    ap.add_argument("--device", default=None,
                    help="cuda (default; no card is an error) or cpu")
    ap.add_argument("--backend", default=None,
                    help="the JAX tool's name for --device: cpu, or cuda (gpu, auto).  "
                    "The JAX tool's default is cpu; this one runs on the card unless "
                    "told otherwise")


def device_option(ap, args) -> str:
    """The device that --device and --backend name, cuda when neither is
    given.  A --backend this package cannot run on (tpu), or one that
    contradicts --device, exits 2 through ap.error: never a fallback."""
    backend = args.backend
    if backend is not None and backend not in BACKENDS:
        ap.error(f"--backend: this package runs on cuda or cpu, not '{backend}'; "
                 f"choose one of {', '.join(BACKENDS)}")
    device = args.device
    if backend is not None and device is not None and (
            str(device).split(":")[0] != BACKENDS[backend]):
        ap.error(f"--backend {backend} and --device {device} disagree")
    return device or (BACKENDS[backend] if backend else "cuda")
