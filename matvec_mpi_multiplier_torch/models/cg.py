"""Distributed conjugate gradients on the strategy shardings, and refinement.

The port's counterpart of the JAX package's ``models/cg.py``: the strategy
layer composed into a Krylov solver. ``A`` is placed by the strategy's own
spec, never replicated; each iteration's matvec is the strategy's program
(``strategy.build(mesh, kernel=..., gather_output=True)``); the vectors
live on the mesh's first device in the accumulator dtype, so bf16/fp32
storage never degrades the recurrences. The ``kernel`` knob takes the
accuracy tiers (``ozaki``, ``compensated``) for ill-conditioned systems.

**The loop.** JAX runs CG as one ``lax.while_loop``. The port runs the same
iterations as the solvers' device loop (``solvers/device_loop.py::
ChunkedLoop``): state in fixed tensors on the device, each iteration
committed under a device flag, one read a chunk of
:data:`~..solvers.device_loop.DEFAULT_CHUNK` iterations. Where the mesh lies
on one CUDA device and the GEMV is the ``cuda`` tier (the only local kernel
that takes a launch predicate), the chunk after the first is captured once
as a CUDA graph and replayed; everywhere else the chunks run eagerly, each
iteration's matvec and refresh decided by a host read of the flag. Either
way the iteration count is JAX's: only active iterations count.

:func:`build_refined` is mixed-precision iterative refinement: fp32 Krylov
corrections (CG, or GMRES for nonsymmetric systems) and residuals through an
accuracy tier, with ``x`` kept as a double-float pair. Its outer loop is
host-driven, one ``host_norm`` a trip, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from ..ops.compensated import df_add
from ..ops.gemv import acc_dtype
from ..ops.graphs import single_cuda_device
from ..parallel.mesh import Mesh, make_mesh, shard
from ..solvers.common import (
    convergence_threshold,
    host_norm,
    keep_iterating,
    residual_norm,
)
from ..solvers.device_loop import ChunkedLoop, commit, when
from ..solvers.ops import DeviceLoops, placed_operand, solver_loop
from ..utils.errors import ShardingError
from .base import MatvecStrategy


@dataclasses.dataclass(frozen=True)
class CGResult:
    """Solution and convergence telemetry, as tensors on the mesh's first
    device. gmres's ``n_iters`` counts restart cycles, refinement's trips."""

    x: torch.Tensor
    n_iters: torch.Tensor
    residual_norm: torch.Tensor
    converged: torch.Tensor


def square_matvec(matvec: Callable, strategy: MatvecStrategy, mesh: Mesh,
                  a: torch.Tensor, name: str):
    """``(mv, acc, placed)`` for a solver ``name`` on ``a``: the shape checked
    by the strategy's guards, then for squareness; ``placed`` the strategy's
    operand (cut once; at p = 1 on A's device it is A itself); ``mv(v)`` the
    built ``matvec`` of it against ``v`` in A's dtype, returned in the
    accumulator dtype ``acc`` on the mesh's first device."""
    strategy.validate(a.shape[0], a.shape[1], mesh)
    if a.shape[0] != a.shape[1]:
        # The solvers are defined for square A; the strategies themselves
        # multiply rectangular matrices happily.
        raise ValueError(f"{name} needs a square matrix, got {a.shape[0]}x{a.shape[1]}")
    acc = acc_dtype(a.dtype)
    placed = placed_operand(strategy, mesh, a)
    spec_x = strategy.specs(mesh)[1]

    def mv(v: torch.Tensor) -> torch.Tensor:
        return matvec(placed, shard(v.to(a.dtype), spec_x, mesh)).to(acc)

    return mv, acc, placed


def loop_device(strategy: MatvecStrategy, mesh: Mesh, kernel) -> torch.device | None:
    """The one CUDA device the solver loop captures its chunks on, where
    ``solvers/ops.py::solver_loop`` gives a served cg the device loop: the
    mesh lies on one card and the strategy's matvec runs the ``cuda`` GEMV
    (it takes a launch predicate) under a fixed combine other than the ring
    kernel (which refuses one). None otherwise: the chunks run eagerly."""
    combine = strategy.requested_combine or strategy.combine
    predicated = kernel == "cuda" and combine not in ("pallas_ring", "auto")
    if solver_loop(None, "cg", mesh, predicated=predicated) == "device":
        return single_cuda_device(mesh.devices)
    return None


def build_cg(
    strategy: MatvecStrategy,
    mesh: Mesh,
    *,
    kernel: str | Callable = "cuda",
    tol: float = 1e-6,
    max_iters: int = 1000,
    recompute_every: int = 50,
    precondition: bool | str = False,
) -> Callable[[torch.Tensor, torch.Tensor], CGResult]:
    """Return ``cg(a, b) -> CGResult`` solving ``A x = b`` for SPD ``A``.

    The function checks the shape through the strategy's own guards (the
    typed ShardingError of the benchmark entry points), then runs one
    strategy matvec and O(n) vector work per iteration (module docstring:
    the loop). The default ``kernel`` is the port's strategy default, the
    hand-written ``cuda`` GEMV (the JAX package's is ``xla``).

    ``precondition="jacobi"`` (or ``True``) runs preconditioned CG with
    ``M = diag(A)``; plain CG is the ``M = I`` case of the same recurrence.
    The stopping rule is ``||r|| <= tol * ||b||`` on the iterate's
    residual, the true one refreshed every ``recompute_every`` iterations;
    the best iterate seen is returned, with its TRUE residual (one more
    matvec)."""
    if not isinstance(precondition, bool) and precondition != "jacobi":
        raise ValueError(
            f"precondition must be False, True or 'jacobi'; got {precondition!r}"
        )
    matvec = strategy.build(mesh, kernel=kernel, gather_output=True)
    dev0 = mesh.devices[0]
    device = loop_device(strategy, mesh, kernel)
    use_jacobi = bool(precondition)
    loops = DeviceLoops(lambda mv: _PcgLoop(mv, recompute_every, use_jacobi, device))

    def cg(a: torch.Tensor, b: torch.Tensor) -> CGResult:
        mv, acc, placed = square_matvec(matvec, strategy, mesh, a, "cg")
        b_acc = b.to(device=dev0, dtype=acc)
        minv = None
        if use_jacobi:
            d = torch.diagonal(a).to(device=dev0, dtype=acc)
            # SPD diagonals are positive; zero entries fall back to the
            # identity rather than poisoning the solve.
            nonzero = d != 0
            minv = torch.where(nonzero, 1.0 / torch.where(nonzero, d, 1.0), 1.0)
        state = loops.get(placed, b_acc, mv)
        threshold, k = state.solve(b_acc, minv, tol, max_iters)
        x_best = state.x_best.clone()
        # The TRUE residual of the returned iterate: rr_best is a minimum
        # over recurrence estimates, biased low between refreshes.
        rnorm = residual_norm(b_acc - mv(x_best))
        return CGResult(x=x_best, n_iters=torch.tensor(k, dtype=torch.int32, device=dev0),
                        residual_norm=rnorm, converged=rnorm <= threshold)

    cg.loop_device = device
    return cg


class _PcgLoop:
    """The JAX package's PCG ``while_loop`` body as a masked device-loop
    iteration (``solvers/device_loop.py``): every value is committed under
    the flag ``go``, so an iteration after the stop changes nothing, and the
    refresh matvec runs through :func:`when` on exactly the iterations where
    JAX's ``lax.cond`` runs it."""

    def __init__(self, mv: Callable, recompute_every: int, jacobi: bool,
                 device: torch.device | None):
        self.mv = mv
        self.recompute_every = recompute_every
        self.jacobi = jacobi
        self._device = device
        self.loop = None

    def _alloc(self, b_acc: torch.Tensor) -> None:
        n, acc, dev = b_acc.shape[0], b_acc.dtype, b_acc.device
        vec = lambda: torch.zeros((n,), dtype=acc, device=dev)  # noqa: E731
        scalar = lambda: torch.zeros((), dtype=acc, device=dev)  # noqa: E731
        self.b, self.x, self.r, self.p, self.x_best, self.minv = (vec() for _ in range(6))
        self.threshold, self.rz, self.rr_best = (scalar() for _ in range(3))
        self.k, self.max_iters = (torch.zeros((), dtype=torch.int64, device=dev)
                                  for _ in range(2))
        self.go = torch.zeros((), dtype=torch.bool, device=dev)
        self.loop = ChunkedLoop(self.iteration, self.go, self.k, self._device)

    def _precondition(self, r: torch.Tensor) -> torch.Tensor:
        # M = I is plain CG: z = r (the JAX package multiplies by ones).
        return self.minv * r if self.jacobi else r

    def iteration(self) -> None:
        mv, go, x, r, p, rz = self.mv, self.go, self.x, self.r, self.p, self.rz
        ap = when(go, lambda: mv(p), lambda: p)
        # p'Ap > 0 for SPD A; a zero/negative breakdown (indefinite input)
        # stalls instead of emitting inf/NaN: the loop ends on max_iters.
        pap = torch.sum(p * ap)
        safe = pap > 0
        alpha = torch.where(safe, rz / torch.where(safe, pap, 1.0), 0.0)
        x_new = x + alpha * p
        r_rec = r - alpha * ap
        k_new = self.k + 1
        # The periodic true-residual refresh: the recurrence drifts in
        # finite precision.
        refresh = go & (k_new % self.recompute_every == 0)
        r_true = when(refresh, lambda: self.b - mv(x_new), lambda: r_rec)
        r_new = torch.where(refresh, r_true, r_rec)
        z = self._precondition(r_new)
        rz_new = torch.sum(r_new * z)
        beta = torch.where(safe, rz_new / torch.where(rz != 0, rz, 1.0), 0.0)
        p_new = z + beta * p
        rr_new = torch.sum(r_new * r_new)
        # Best-so-far: CG pushed past its attainable floor loses conjugacy
        # and can run away; the best visited iterate is what returns.
        better = rr_new < self.rr_best
        x_best = torch.where(better, x_new, self.x_best)
        rr_best = torch.where(better, rr_new, self.rr_best)
        go_new = keep_iterating(torch.sqrt(rr_new), self.threshold, k_new, self.max_iters)
        commit(go, ((self.x, x_new), (self.r, r_new), (self.p, p_new),
                    (self.rz, rz_new), (self.x_best, x_best),
                    (self.rr_best, rr_best), (self.k, k_new)))
        torch.logical_and(go, go_new, out=go)

    def solve(self, b_acc: torch.Tensor, minv: torch.Tensor | None, tol: float,
              max_iters: int) -> tuple[torch.Tensor, int]:
        """Run the loop from x = 0; return ``(threshold, n_iters)``."""
        if self.loop is None:
            self._alloc(b_acc)
        threshold = convergence_threshold(tol, residual_norm(b_acc))
        self.threshold.copy_(threshold)
        self.b.copy_(b_acc)
        if self.jacobi:
            self.minv.copy_(minv)
        z0 = self._precondition(b_acc)
        self.x.zero_()
        self.x_best.zero_()
        self.r.copy_(b_acc)
        self.p.copy_(z0)
        self.rz.copy_(torch.sum(b_acc * z0))
        rr0 = torch.sum(b_acc * b_acc)
        self.rr_best.copy_(rr0)
        self.k.zero_()
        self.max_iters.fill_(max_iters)
        self.go.copy_(keep_iterating(torch.sqrt(rr0), threshold, self.k, self.max_iters))
        return threshold, self.loop.run()


def solve_cg(strategy: MatvecStrategy, mesh: Mesh, a: torch.Tensor,
             b: torch.Tensor, **kwargs) -> CGResult:
    """Convenience one-shot: build and run (kwargs go to :func:`build_cg`)."""
    return build_cg(strategy, mesh, **kwargs)(a, b)


def build_refined(
    strategy: MatvecStrategy,
    mesh: Mesh,
    *,
    inner: str = "cg",
    residual_kernel: str | Callable = "ozaki",
    inner_tol: float = 1e-2,
    tol: float = 5e-7,
    max_refinements: int = 10,
    **inner_kwargs,
) -> Callable[[torch.Tensor, torch.Tensor], CGResult]:
    """Mixed-precision iterative refinement: fp32 Krylov speed, fp64-parity
    residuals. Returns ``refined(a, b) -> CGResult``; the inner solver and
    the residual programs are built once and reused across calls.

    Plain fp32 CG's forward error grows as ``cond(A) * u_fp32``. Refinement
    repeats ``r = b - A x`` in high precision (one strategy matvec through
    the accuracy tier ``residual_kernel``: ``ozaki`` by default,
    ``compensated`` for the exact-but-slow extreme), solves the correction
    ``A d = r`` cheaply in fp32 to ``inner_tol``, and updates ``x += d``:
    the forward error lands near fp32 ulp while ``cond(A) * u < 1``.

    * The residual is the augmented matvec ``[A | b] @ [x; -1]`` through the
      accuracy tier, so the ``b - A x`` cancellation happens inside its
      extended accumulation. It runs on a rowwise build (k + 1 columns can
      break the strategy's own guards), on the mesh, or on the mesh's first
      device where n + 1 does not divide it. ``[A | b]`` is a second copy of
      A for the call's duration.
    * ``x`` accumulates across trips as a double-float pair (hi, lo); the lo
      part costs one more accurate matvec a trip (``A @ x_lo``).

    The loop refines until stagnation (a trip that does not halve the
    residual), at most ``max_refinements`` trips; ``tol`` decides the
    reported convergence. ``n_iters`` counts trips, ``residual_norm`` is the
    high-precision ``||b - A x||``. ``inner="gmres"`` takes restarted GMRES
    (``models/gmres.py``) for the corrections, for nonsymmetric systems;
    ``inner_kwargs`` go to the inner solver's build, and GMRES's ``restart``
    defaults to 10 there (every inner trip pays all ``restart`` matvecs, and
    a few digits a trip is all refinement needs)."""
    from .rowwise import RowwiseStrategy

    if inner == "cg":
        inner_solve = build_cg(strategy, mesh, tol=inner_tol, **inner_kwargs)
    elif inner == "gmres":
        from . import gmres as gmres_mod  # deferred: gmres imports CGResult

        inner_kwargs.setdefault("restart", 10)
        inner_solve = gmres_mod.build_gmres(strategy, mesh, tol=inner_tol, **inner_kwargs)
    else:
        raise ValueError(f"inner must be 'cg' or 'gmres', got {inner!r}")
    res_strat = RowwiseStrategy()
    accurate_mesh = res_strat.build(mesh, kernel=residual_kernel)
    accurate_1dev = res_strat.build(make_mesh(1, devices=mesh.devices[:1]),
                                    kernel=residual_kernel)

    def refined(a: torch.Tensor, b: torch.Tensor) -> CGResult:
        if a.shape[0] != a.shape[1]:
            raise ValueError(
                f"refined solve needs a square matrix, got {a.shape[0]}x{a.shape[1]}"
            )
        try:
            res_strat.validate(a.shape[0], a.shape[1] + 1, mesh)
            accurate_mv = accurate_mesh
        except ShardingError:
            accurate_mv = accurate_1dev
        dev0 = mesh.devices[0]
        acc = acc_dtype(a.dtype)
        a_aug = torch.cat([a, b[:, None].to(device=a.device, dtype=a.dtype)], dim=1)
        b_acc = b.to(device=dev0, dtype=acc)
        threshold = tol * host_norm(b_acc)
        minus_one = -torch.ones((1,), dtype=acc, device=dev0)

        def residual(x_hi: torch.Tensor, x_lo: torch.Tensor) -> torch.Tensor:
            # r = b - A (x_hi + x_lo): the hi part rides the augmented
            # matvec ([A | b] @ [x_hi; -1] = A x_hi - b, the cancellation
            # inside the accurate accumulation), the lo part is a second
            # accurate matvec.
            v = torch.cat([x_hi, minus_one])
            r_hi = accurate_mv(a_aug, v.to(a.dtype)).to(device=dev0, dtype=acc)
            r_lo = accurate_mv(a, x_lo.to(a.dtype)).to(device=dev0, dtype=acc)
            return -(r_hi + r_lo)

        x_hi = torch.zeros_like(b_acc)
        x_lo = torch.zeros_like(b_acc)
        r = residual(x_hi, x_lo)
        rnorm = host_norm(r)
        trips = 0
        # Refine until STAGNATION, not until the threshold: under
        # ill-conditioning a small residual does not yet mean a small
        # forward error; stop when a trip fails to halve the residual.
        while trips < max_refinements and rnorm > 0.0:
            d = inner_solve(a, r.to(a.dtype)).x.to(acc)
            nh, nl = df_add(x_hi, x_lo, d, torch.zeros_like(d))
            r_new = residual(nh, nl)
            new_norm = host_norm(r_new)
            trips += 1
            if new_norm >= 0.5 * rnorm:
                # Stagnation: keep whichever iterate is better and stop.
                if new_norm < rnorm:
                    x_hi, x_lo, rnorm = nh, nl, new_norm
                break
            x_hi, x_lo, r, rnorm = nh, nl, r_new, new_norm
        # The accumulator dtype out: a bf16 storage dtype would floor the
        # forward error at bf16 ulp and discard the refinement.
        return CGResult(
            x=x_hi + x_lo,
            n_iters=torch.tensor(trips, dtype=torch.int32, device=dev0),
            residual_norm=torch.tensor(rnorm, dtype=acc, device=dev0),
            converged=torch.tensor(rnorm <= threshold, device=dev0),
        )

    return refined


def solve_refined(strategy: MatvecStrategy, mesh: Mesh, a: torch.Tensor,
                  b: torch.Tensor, **kwargs) -> CGResult:
    """Convenience one-shot (kwargs go to :func:`build_refined`)."""
    return build_refined(strategy, mesh, **kwargs)(a, b)
