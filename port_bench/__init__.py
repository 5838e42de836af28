"""The benchmark of `dvdgan_tpu_torch` on the H100: `run.py` runs one
cell of `BENCHMARK.json` (see `spec.py` for the files it finds by name)."""
