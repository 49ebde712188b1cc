"""Serving engine: batched multi-RHS dispatch against a resident sharded A.

The port's counterpart of the JAX package's ``engine/``, its plain native
path and its served solvers: ``core.py`` (the engine, its futures,
promotion, backpressure, deadlines and ``submit(op=...)`` solves), ``buckets.py`` (the shape ladder) and ``executables.py`` (the
per-key program cache). Benchmarked by ``bench/serve.py`` (``--op serve``).
The scheduler, registry and global scheduler wait for later slices
(ROADMAP.md).

The re-exports resolve lazily (PEP 562), like the package's own.
"""

from __future__ import annotations

import importlib

_EXPORTS = {
    "MatvecEngine": ".core",
    "MatvecFuture": ".core",
    "SolverFuture": ".core",
    "DEFAULT_SOLVER_MAXITER": ".core",
    "EngineStats": ".core",
    "DEFAULT_PROMOTE_B": ".core",
    "ExecutableCache": ".executables",
    "ExecKey": ".executables",
    "ExecStats": ".executables",
    "DEFAULT_MAX_BUCKET": ".buckets",
    "bucket_ladder": ".buckets",
    "bucket_for": ".buckets",
    "split_widths": ".buckets",
    "pad_columns": ".buckets",
}

__all__ = list(_EXPORTS)


def __getattr__(name: str):
    try:
        module = _EXPORTS[name]
    except KeyError:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}"
        ) from None
    value = getattr(importlib.import_module(module, __name__), name)
    globals()[name] = value  # cache: resolve each export once
    return value


def __dir__():
    return sorted(set(globals()) | set(__all__))
