"""Distributed restarted GMRES on the strategy shardings.

The port's counterpart of the JAX package's ``models/gmres.py``: GMRES(m),
CG's general-matrix sibling, for nonsymmetric systems. Same composition as
``models/cg.py``: A stays placed by the strategy, one strategy matvec per
Arnoldi step is the only O(n²) work, the vectors live on the mesh's first
device. Each restart cycle is ``solvers/ops.py::gmres_cycle``, the served
gmres's own: CGS2 Arnoldi over a fixed-shape basis (a lucky breakdown zeros
the remaining columns), the small Hessenberg least-squares solve by SVD
with ``jnp.linalg.lstsq``'s cut-off (rank-revealing, as the breakdown
needs; CUDA's ``torch.linalg.lstsq`` has only ``gels``), and the TRUE
residual of the new iterate.

The loop is host-stepped: one read a cycle, the continuation predicate of
``solvers/common.py`` (JAX runs it as a ``lax.while_loop``). The
convergence decision never trusts the in-cycle recurrence, and the best
visited iterate is returned, with its true residual.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..parallel.mesh import Mesh
from ..solvers.common import convergence_threshold, keep_iterating, residual_norm
from ..solvers.ops import gmres_cycle
from .base import MatvecStrategy
from .cg import CGResult, square_matvec  # shared result contract; n_iters = CYCLES


def build_gmres(
    strategy: MatvecStrategy,
    mesh: Mesh,
    *,
    kernel: str | Callable = "cuda",
    restart: int = 40,
    tol: float = 1e-6,
    max_restarts: int = 50,
) -> Callable[[torch.Tensor, torch.Tensor], CGResult]:
    """Return ``gmres(a, b) -> CGResult`` solving ``A x = b`` for general
    square A (no symmetry or definiteness assumed).

    ``restart`` is the Arnoldi basis size m of GMRES(m); ``max_restarts``
    bounds the outer cycles, so the worst-case matvec count is
    ``max_restarts * (restart + 1)``. Shapes are checked through the
    strategy's own guards. The default ``kernel`` is the port's ``cuda``."""
    if restart < 1:
        raise ValueError(f"restart must be >= 1, got {restart}")
    matvec = strategy.build(mesh, kernel=kernel, gather_output=True)
    dev0 = mesh.devices[0]

    def gmres(a: torch.Tensor, b: torch.Tensor) -> CGResult:
        mv, acc, _ = square_matvec(matvec, strategy, mesh, a, "gmres")
        b_acc = b.to(device=dev0, dtype=acc)
        b_norm = residual_norm(b_acc)
        threshold = convergence_threshold(tol, b_norm)
        x = x_best = torch.zeros_like(b_acc)
        r, rnorm, rn_best = b_acc, b_norm, b_norm
        k = 0
        while bool(keep_iterating(rnorm, threshold, k, max_restarts)):
            x, r, rnorm = gmres_cycle(mv, b_acc, x, r, rnorm, restart)
            # Restarted GMRES can stagnate; like CG, return the best visited
            # iterate so an unreachable tolerance costs time, not the answer.
            better = rnorm < rn_best
            x_best = torch.where(better, x, x_best)
            rn_best = torch.where(better, rnorm, rn_best)
            k += 1
        return CGResult(x=x_best, n_iters=torch.tensor(k, dtype=torch.int32, device=dev0),
                        residual_norm=rn_best, converged=rn_best <= threshold)

    return gmres


def solve_gmres(strategy: MatvecStrategy, mesh: Mesh, a: torch.Tensor,
                b: torch.Tensor, **kwargs) -> CGResult:
    """Convenience one-shot (kwargs go to :func:`build_gmres`)."""
    return build_gmres(strategy, mesh, **kwargs)(a, b)
