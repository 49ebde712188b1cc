"""Measured tuning: the decisions every ``"auto"`` of the port reads.

The port's counterpart of the JAX package's ``tuning/``: each performance
choice that depends on the shape — the local GEMV and GEMM (tier, and the
CUDA kernels' route or tiles), the combine schedule, the overlap stage
count, the GEMV→GEMM promotion crossover, the resident storage format and
the solver iteration tier — is a measured decision:

* ``tuning.search`` races the candidates under the benchmark's own timing
  protocol (``bench/timing.py``) and records the winners;
* ``tuning.cache`` keeps them in a versioned JSON file keyed by
  configuration and platform fingerprint;
* the ``auto`` consumers — ``kernel="auto"`` (``ops/gemv.py``,
  ``ops/gemm_kernels.py``), ``combine="auto"`` and ``stages=None``
  (``models/base.py``), and the engine's ``promote``, ``dtype_storage`` and
  ``solver_kernel`` — read it through the process singleton here and take
  the static default on any miss, so ``auto`` is always safe to ask for.

Fill it with ``python -m matvec_mpi_multiplier_torch.tuning`` or the
sweep's and serve bench's ``--tune``. The calibrated cost model
(``cost_model.py``; ``--calibrate`` records its constants) predicts every
candidate: with ``prune_margin`` the search measures only those predicted
near the predicted winner, and :func:`lookup_calibration` returns the
record it prunes with (every candidate is measured on a cache without one).
"""

from __future__ import annotations

from typing import Any

from .cache import (
    CACHE_ENV,
    CACHE_VERSION,
    TuningCache,
    broadcast_decisions,
    calibration_key,
    combine_key,
    default_cache_path,
    gemm_key,
    gemv_key,
    overlap_key,
    platform_fingerprint,
    promote_key,
    solver_kernel_key,
    storage_key,
)

__all__ = [
    "CACHE_ENV", "CACHE_VERSION", "TuningCache", "broadcast_decisions",
    "calibration_key", "combine_key", "default_cache_path", "gemm_key",
    "gemv_key", "overlap_key", "platform_fingerprint", "promote_key",
    "solver_kernel_key", "storage_key", "get_cache", "reset_cache",
    "lookup_gemv", "lookup_gemm", "lookup_combine", "lookup_promotion",
    "lookup_overlap", "lookup_storage", "lookup_solver_kernel",
    "lookup_calibration",
]

# The dispatch-side singleton, loaded on first lookup and reloaded when the
# resolved path changes (tests and CLIs redirect it through the env var).
_cache: TuningCache | None = None


def get_cache() -> TuningCache:
    """The dispatch-side view of the cache file. Over several processes
    only the coordinator reads the file; its decisions reach every process
    (``cache.broadcast_decisions``), so all dispatch the same schedules. One
    process: a plain read."""
    global _cache
    from ..parallel.distributed import is_main_process

    path = default_cache_path()
    if _cache is None or _cache.path != path:
        loaded = TuningCache.load(path) if is_main_process() else TuningCache(path)
        _cache = broadcast_decisions(loaded)
    return _cache


def reset_cache() -> None:
    """Drop the singleton so the next lookup reads the file again (after a
    tuning run writes new decisions, and in tests)."""
    global _cache
    _cache = None


def lookup_gemv(m: int, k: int, dtype: str) -> dict[str, Any] | None:
    """The recorded local-GEMV decision for this LOCAL shape and dtype on
    this platform, or None: the ``kernel="auto"`` tier's question."""
    return get_cache().lookup(gemv_key(m, k, dtype))


def lookup_gemm(m: int, k: int, n: int, dtype: str) -> dict[str, Any] | None:
    """The recorded local-GEMM decision, or None."""
    return get_cache().lookup(gemm_key(m, k, n, dtype))


def lookup_combine(*, op: str, strategy: str, m: int, k: int, p: int,
                   dtype: str) -> str | None:
    """The recorded combine schedule for this GLOBAL shape and mesh size, or
    None: the ``combine="auto"`` question."""
    decision = get_cache().lookup(combine_key(op, strategy, m, k, p, dtype))
    return None if decision is None else decision.get("combine")


def lookup_promotion(*, strategy: str, m: int, k: int, p: int,
                     dtype: str) -> dict[str, Any] | None:
    """The recorded promotion decision, or None: the engine's
    ``promote="auto"`` question. Its ``b_star`` is the smallest bucket whose
    one GEMM beat ``b`` GEMV dispatches (null: promotion never won)."""
    return get_cache().lookup(promote_key(strategy, m, k, p, dtype))


def lookup_storage(*, strategy: str, m: int, k: int, p: int,
                   dtype: str) -> dict[str, Any] | None:
    """The recorded resident storage format, or None: the engine's
    ``dtype_storage="auto"`` question (native on a miss)."""
    return get_cache().lookup(storage_key(strategy, m, k, p, dtype))


def lookup_solver_kernel(*, op: str, strategy: str, m: int, k: int, p: int,
                         dtype: str, storage: str) -> dict[str, Any] | None:
    """The recorded solver iteration tier (``torch`` | ``cuda_fused``), or
    None: the engine's ``solver_kernel="auto"`` question (the unfused tier
    on a miss)."""
    return get_cache().lookup(
        solver_kernel_key(op, strategy, m, k, p, dtype, storage))


def lookup_overlap(*, strategy: str, m: int, k: int, p: int,
                   dtype: str) -> dict[str, Any] | None:
    """The recorded overlap stage count, or None:
    ``MatvecStrategy.resolve_stages``'s question for ``stages=None``."""
    return get_cache().lookup(overlap_key(strategy, m, k, p, dtype))


def lookup_calibration(*, p: int) -> dict[str, Any] | None:
    """The recorded cost-model calibration for a ``p``-device mesh of this
    platform, or None: the tuner's ``prune_margin`` question
    (``cost_model.model_from_cache`` wraps it into a ``CostModel``; a miss
    means every axis measures all of its candidates)."""
    return get_cache().lookup(calibration_key(p))
