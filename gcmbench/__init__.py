"""The benchmark of climt_tpu_torch on NVIDIA H100 cards: ``run.py`` runs
one cell of ``BENCHMARK.json``; everything a cell, a configuration, a
traffic mix or a per-layer metric needs is a file of its own here."""
