"""Spectral estimates through the strategy matvec: power iteration.

The port's counterpart of the JAX package's ``models/spectral.py``. CG's
iteration count scales with ``sqrt(cond(A))`` and refinement's payoff with
``cond(A) * eps``, so the toolkit estimates the spectrum with the same
distributed matvec it solves with:

* :func:`spectral_norm` — power iteration for ``λ_max(A)`` (the 2-norm for
  SPD A): strategy matvec and normalize, until the Rayleigh quotient's
  relative step falls under ``tol``. One matvec and one host read an
  iteration (host-stepped; JAX runs it as a ``lax.while_loop``).
* :func:`condition_estimate` — ``λ_max`` by power iteration and ``λ_min``
  by INVERSE iteration, each ``A⁻¹ v`` an inner CG solve
  (``models/cg.py``). A host-driven outer loop of a handful of trips.

The start vectors are numpy's ``default_rng(seed)`` draws, the JAX
package's bitwise. Estimates, not guarantees: power iteration converges at
the eigenvalue gap ratio; a random start makes an orthogonal start
measure-zero.
"""

from __future__ import annotations

import warnings
from typing import Callable

import numpy as np
import torch

from ..ops.gemv import acc_dtype
from ..parallel.mesh import Mesh
from ..solvers.common import keep_iterating, residual_norm
from .base import MatvecStrategy
from .cg import build_cg, square_matvec


def build_spectral_norm(
    strategy: MatvecStrategy,
    mesh: Mesh,
    *,
    kernel: str | Callable = "cuda",
    tol: float = 1e-4,
    max_iters: int = 500,
) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """Return ``power(a, v0) -> lambda_max`` (the Rayleigh estimate, a tensor
    on the mesh's first device).

    ``v0`` is the start vector (callers pass a seeded random one: a fixed
    start could be orthogonal to the dominant eigenvector). Stops when the
    Rayleigh quotient's relative step falls under ``tol``, or after
    ``max_iters`` iterations."""
    matvec = strategy.build(mesh, kernel=kernel, gather_output=True)
    dev0 = mesh.devices[0]

    def power(a: torch.Tensor, v0: torch.Tensor) -> torch.Tensor:
        mv, acc, _ = square_matvec(matvec, strategy, mesh, a, "spectral_norm")
        v = v0.to(device=dev0, dtype=acc)
        v = v / residual_norm(v)
        lam = torch.zeros((), dtype=acc, device=dev0)
        prev = torch.full((), float("inf"), dtype=acc, device=dev0)
        k = 0

        def rel_step():
            return (lam - prev).abs() / torch.clamp(lam.abs(), min=1e-30)

        while bool(keep_iterating(rel_step(), tol, k, max_iters)):
            av = mv(v)
            lam, prev = torch.sum(v * av), lam  # Rayleigh quotient (unit v)
            v = av / torch.clamp(residual_norm(av), min=1e-30)
            k += 1
        return lam

    return power


def spectral_norm(strategy: MatvecStrategy, mesh: Mesh, a: torch.Tensor, *,
                  seed: int = 0, **kwargs) -> float:
    """Convenience one-shot ``lambda_max`` estimate with a seeded start."""
    v0 = torch.from_numpy(
        np.random.default_rng(seed).standard_normal(a.shape[1]).astype(np.float32))
    return float(build_spectral_norm(strategy, mesh, **kwargs)(a, v0))


def condition_estimate(
    strategy: MatvecStrategy,
    mesh: Mesh,
    a: torch.Tensor,
    *,
    kernel: str | Callable = "cuda",
    seed: int = 0,
    inverse_iters: int = 8,
    cg_tol: float = 1e-6,
    cg_max_iters: int = 2000,
    **power_kwargs,
) -> float:
    """Estimate ``cond_2(A) = λ_max / λ_min`` for SPD ``A``.

    ``λ_max`` by power iteration; ``λ_min`` by inverse iteration, each
    ``A⁻¹ v`` an inner CG solve. ``kernel`` drives BOTH halves, so the whole
    estimate runs at one accuracy tier. Returns a float estimate (a lower
    bound, up to the CG solves' accuracy). If any inner solve fails to
    converge, a ``RuntimeWarning`` says the λ_min half (and so the estimate)
    is unreliable."""
    rng = np.random.default_rng(seed)
    lam_max = spectral_norm(strategy, mesh, a, seed=seed, kernel=kernel, **power_kwargs)
    cg = build_cg(strategy, mesh, tol=cg_tol, max_iters=cg_max_iters, kernel=kernel)
    dev0 = mesh.devices[0]
    acc = acc_dtype(a.dtype)
    v = torch.from_numpy(rng.standard_normal(a.shape[1])).to(device=dev0, dtype=acc)
    v = v / torch.sqrt(torch.sum(v * v))
    mu = 0.0  # Rayleigh estimate of λ_min
    stalled = False
    for _ in range(inverse_iters):
        res = cg(a, v.to(a.dtype))
        stalled = stalled or not bool(res.converged)
        w = res.x.to(acc)  # w ≈ A⁻¹ v
        nw2 = float(torch.sum(w * w))
        if nw2 == 0.0:
            break
        # The Rayleigh quotient of w under A without a matvec: A w ≈ v (to
        # cg_tol), so μ = wᵀA w / wᵀw ≈ (w·v) / ||w||².
        mu = float(torch.sum(w * v)) / nw2
        v = w / float(np.sqrt(nw2))
    if stalled:
        warnings.warn(
            "condition_estimate: an inner CG solve did not converge "
            f"(tol={cg_tol}); the λ_min half of the estimate is unreliable — "
            "the true condition number is likely LARGER than reported",
            RuntimeWarning,
            stacklevel=2,
        )
    return lam_max / mu if mu > 0 else float("inf")
