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
take `--device` (default cuda; no card is an error) and hold the port on
the device against its own CPU run of the same bytes, under the same clock
values; those with `--ref CMD` also against an oracle that speaks the
reference's CLI (the reference binary, built by refbuild.py, or the JAX
package's CLI).  The hex-input, HTTP and --debug n tools drive
`--net-only`, which does no device work, and need `--ref`'s oracle; they,
gen_cpr_vectors and refbuild take no `--device` and need no card.  The
measurement tools (bench, measure, exp_demod_front; their inputs in
air.py) take `--device` too and print one JSON line with the card's name,
count and power limit beside every number."""
