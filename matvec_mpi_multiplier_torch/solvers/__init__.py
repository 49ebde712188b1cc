"""Served iterative solvers: multi-step operations against the resident A.

The port's counterpart of the JAX package's ``solvers/``: each op is one
built loop around the strategy's matvec, served through
``engine.submit(op="cg", rhs=b, rtol=..., maxiter=...)`` so the executable
cache, buckets, deadline admission and metrics all inherit. The fused
CG/Chebyshev iteration tier lives in ``ops/cuda_solver.py``.
"""

from .common import (
    DIVERGENCE_GROWTH,
    SolverResult,
    above_tolerance,
    convergence_threshold,
    diverged,
    host_norm,
    keep_iterating,
    residual_norm,
)
from .ops import (
    DEFAULT_RESTART,
    DEFAULT_STEPS,
    EIGEN_OPS,
    SOLVER_OPS,
    build_solver,
    solver_bucket,
    solver_matvec_count,
)

__all__ = [
    "DIVERGENCE_GROWTH",
    "SolverResult",
    "above_tolerance",
    "convergence_threshold",
    "diverged",
    "host_norm",
    "keep_iterating",
    "residual_norm",
    "SOLVER_OPS",
    "EIGEN_OPS",
    "DEFAULT_RESTART",
    "DEFAULT_STEPS",
    "build_solver",
    "solver_bucket",
    "solver_matvec_count",
]
