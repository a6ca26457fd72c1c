"""The benchmark of ``ccedit_tpu_torch`` on NVIDIA H100s: ``run.py`` runs a
cell of ``BENCHMARK.json``; ``control.py`` reads the readings its limits
were set from.  See ``PERF.md``."""
