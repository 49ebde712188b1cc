"""SpeedUp / Efficiency analysis of the sweep's CSVs (the port's counterpart
of the JAX package's ``analysis/``): ``stats.py`` the tables, ``plots.py``
the figures (matplotlib, loaded lazily), and the two CLIs
``stats_visualization.py`` and ``results_table.py``."""
