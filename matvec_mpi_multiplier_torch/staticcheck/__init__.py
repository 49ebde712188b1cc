"""Symbolic collective census of the port's schedules.

The port's counterpart of the JAX package's ``staticcheck/``. Of it the
port holds only the formulas the cost model evaluates
(``staticcheck/hlo.py``): the per-config collective census and payload
bytes, the migration programs' census, and the storage formats' byte ratio.
"""
