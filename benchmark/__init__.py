"""The benchmark of rlrpt_tpu_torch on one NVIDIA H100: ``run.py`` runs
one cell of ``BENCHMARK.json`` for ``--seconds`` and prints one JSON line
(README.md)."""
