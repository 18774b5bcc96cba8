"""Correctness tools of the port, run as modules:

    python -m dump1090_tpu_torch.tools.fuzz_diff     differential fuzz
    python -m dump1090_tpu_torch.tools.soak_device   wall-clock soaks

Each decodes on `--device` (default cuda; no card is an error) and holds
the result against the port's own CPU run of the same bytes, under the
same clock values."""
