"""Shared solver arithmetic: ONE residual norm, ONE convergence predicate.

The port's counterpart of the JAX package's ``solvers/common.py``. Every
served solver (``solvers/ops.py``) and the fused iteration tier
(``ops/cuda_solver.py``) stops on the same two scalars: a Euclidean
residual norm and a ``still-running?`` predicate over (norm, threshold,
step, cap). Each is written once here and imported everywhere, so no two
sites can drift onto different inequalities (``>=`` against ``>``) or
norms.

The predicates return tensors on the vectors' device. The host-stepped
loops read one of them per iteration (``bool(...)``, a small device→host
copy); nothing here synchronises by itself except :func:`host_norm`.
"""

from __future__ import annotations

import dataclasses

import torch

# Chebyshev divergence guard, shared by the unfused and fused tiers: once
# the recurrence residual-squared grows past this factor over ||b||², the
# semi-iteration is provably running away (an interval that excludes part
# of the spectrum amplifies the excluded modes geometrically) and the loop
# exits early; the engine's SolverFuture then raises SolverDivergedError.
DIVERGENCE_GROWTH = 1e12


def diverged(rr: torch.Tensor, b_rr: torch.Tensor) -> torch.Tensor:
    """THE divergence predicate of the fixed-interval recurrences:
    residual-squared non-finite or past :data:`DIVERGENCE_GROWTH` × ||b||²."""
    return ~torch.isfinite(rr) | (rr > b_rr * DIVERGENCE_GROWTH)


def residual_norm(v: torch.Tensor) -> torch.Tensor:
    """THE Euclidean norm every solver stops on: ``sqrt(sum(v*v))``, spelled
    out as the JAX package spells it (not ``torch.linalg.norm``, which may
    scale or reorder)."""
    return torch.sqrt(torch.sum(v * v))


def host_norm(v: torch.Tensor) -> float:
    """:func:`residual_norm` fetched to the host, for host-driven outer
    loops that want a Python float."""
    return float(residual_norm(v))


def above_tolerance(rnorm, threshold):
    """THE tolerance comparison: strict ``>`` against the threshold, so
    ``||r|| <= tol * ||b||`` counts as converged (scipy's semantics)."""
    return rnorm > threshold


def keep_iterating(rnorm, threshold, k, cap):
    """THE loop continuation predicate: still above tolerance
    (:func:`above_tolerance`) AND still under the iteration cap (strict
    ``<``). ``k`` and ``cap`` are host ints in the port's host-stepped
    loops."""
    return above_tolerance(rnorm, threshold) & (k < cap)


def convergence_threshold(rtol, b_norm):
    """Absolute stopping threshold from a relative tolerance:
    ``rtol * ||b||``, the one place the convention is written down."""
    return rtol * b_norm


@dataclasses.dataclass(frozen=True)
class SolverResult:
    """One served solve's answer and convergence telemetry, as tensors (the
    engine's ``SolverFuture`` materializes it on the host).

    ``x`` is the solution vector (linear ops) or the extremal eigenvector
    (eigen ops); ``value`` is the eigenvalue estimate for eigen ops and NaN
    for linear solves. ``residual_norm`` is the TRUE residual of the
    returned iterate — ``||b - A x||`` for linear ops, ``||A v - λ v||`` for
    eigen ops — recomputed after the loop, never the recurrence's drifted
    estimate. ``n_iters`` is a CPU int32 tensor: the host-stepped loop
    counts its iterations on the host."""

    x: torch.Tensor
    value: torch.Tensor
    n_iters: torch.Tensor
    residual_norm: torch.Tensor
    converged: torch.Tensor
