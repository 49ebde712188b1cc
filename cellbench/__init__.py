"""The benchmark of ``matvec_mpi_multiplier_torch``: one run of one cell
(``run.py``), driven by ``BENCHMARK.json`` and the files it names
(``configs/``, ``traffic/``, ``metrics/``), with the yardstick frozen in
``harness/``."""
