"""Serving engine: batched multi-RHS dispatch against a resident sharded A.

The port's counterpart of the JAX package's ``engine/``: ``core.py`` (the
engine, its futures, promotion, backpressure, deadlines, ``submit(op=...)``
solves, the request tracer, the fault sites, the integrity gate, and under
a ``resilience`` policy the retries, circuit breakers, degradation ladders
and ``health()``),
``scheduler.py`` (the arrival-window scheduler: continuous batching with
QoS tiers, deadline bypass and batch bisection), ``buckets.py`` (the shape
ladder) and ``executables.py`` (the per-key program cache). Benchmarked by
``bench/serve.py`` (``--op serve``; ``--arrival``/``--concurrency``/
``--coalesce`` for load) — and ``registry.py`` (the multi-tenant matrix
registry: many tenants' ``A`` under one device-memory budget, with
eviction, re-admission, pinning, quotas and tenant-scoped faults; the serve
bench's ``--tenants``) and ``global_scheduler.py`` (the cost-model-driven
scheduler over a registry: predicted-time admission, cross-tenant
interleaving and coalescing, demand-aware eviction, the reshard trigger;
the serve bench's ``--global-sched``).

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
    "ArrivalWindowScheduler": ".scheduler",
    "CoalescedFuture": ".scheduler",
    "SchedulerStats": ".scheduler",
    "QOS_TIERS": ".scheduler",
    "DEFAULT_MAX_WINDOW_MS": ".scheduler",
    "SYSTEMIC_FAILURE_THRESHOLD": ".scheduler",
    "MatrixRegistry": ".registry",
    "TenantHandle": ".registry",
    "TenantQuota": ".registry",
    "GlobalScheduler": ".global_scheduler",
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
