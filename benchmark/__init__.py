"""The benchmark of turboae_tpu_torch: one command runs one cell of
BENCHMARK.json once (run.py); see README.md."""
