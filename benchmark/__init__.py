"""The benchmark of ``fenics_eff_uptake_tpu_torch`` on one NVIDIA H100:
``run.py`` runs one cell of ``BENCHMARK.json`` once.  Configurations
(``configs/``), traffic mixes (``traffic/``), per-layer metric readers
(``metrics/``) and the check's limits (``limits/``) are files found by the
names in ``BENCHMARK.json``."""
