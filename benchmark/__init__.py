"""The benchmark of dump1090_tpu_torch (see run.py and BENCHMARK.json)."""
