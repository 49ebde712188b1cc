"""Served solver programs: one built loop per op, dynamic knobs as arguments.

The port's counterpart of the JAX package's ``solvers/ops.py``. Every op
builds to one function with the uniform signature

    ``fn(a, b, rtol, maxiter, p0, p1) -> SolverResult``

where ``rtol``/``maxiter``/``p0``/``p1`` are plain numbers passed per call
(``p0``/``p1`` carry chebyshev's spectral interval; other ops ignore them):
two solves with different tolerances or caps run the same built function,
and the only shape parameters — GMRES's restart, Lanczos's step count —
ride the engine's ExecKey ``bucket`` field. As in the JAX package, ``rtol``
and the interval reach the arithmetic as float32 values cast to the
accumulator, so both packages stop on the same threshold.

Each iteration's matvec is the strategy's own program
(``strategy.build(mesh, kernel=..., gather_output=True)``): the local GEMV
on every shard (``csrc/gemv.cu``, or ``csrc/quant_gemv.cu`` for quantized
storage), then the strategy's combine. The vectors live on the mesh's first
device in the accumulator dtype (``promote(dtype, float32)``).

**The loop is host-stepped.** PyTorch has no ``lax.while_loop``: each
iteration enqueues its work and then reads its continuation predicate as
one small device→host copy, one sync per iteration. CG and Chebyshev decide
their true-residual refresh on the host from a predicate read once per
iteration; only a refreshing iteration pays a second read. A GMRES cycle
reads once (and its tiny least-squares SVD may sync), and Lanczos's
fixed-depth loop reads nothing. The masked, graph-captured loop in chunks
of K iterations comes with CUDA-graph capture (ROADMAP.md, queue A 3b).

The algorithms are the JAX package's, operation for operation: CG with a
best-so-far iterate, a true-residual refresh every ``_RECOMPUTE_EVERY``
iterations and whenever the recurrence is about to declare convergence,
and a two-candidate verified exit; restarted GMRES with CGS2 Arnoldi and a
Hessenberg least-squares solve; power iteration with ``_TINY`` guards;
Lanczos with full reorthogonalisation and ``eigh`` of the tridiagonal;
Chebyshev with the folded β/α and the divergence exit. All stopping
arithmetic imports from ``solvers/common.py``.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..models.base import MatvecStrategy, shard_operand
from ..ops.gemv import acc_dtype
from ..parallel.mesh import Mesh, ShardedTensor, shard
from ..utils.convert import torch_dtype
from .common import (
    SolverResult,
    convergence_threshold,
    diverged,
    keep_iterating,
    residual_norm,
)

# The served solver op vocabulary: the values ``engine.submit(op=...)``
# accepts beyond "matvec", in ExecKey.op's namespace.
SOLVER_OPS: tuple[str, ...] = ("cg", "gmres", "power", "lanczos", "chebyshev")

# Ops whose answer is an eigenpair (rhs is the START VECTOR, ``value`` is
# the eigenvalue) rather than a linear-system solution (``value`` is NaN).
EIGEN_OPS: frozenset[str] = frozenset(("power", "lanczos"))

# Default shape parameters: GMRES's Arnoldi basis size and Lanczos's
# tridiagonalization depth. These are the ExecKey bucket values.
DEFAULT_RESTART = 10
DEFAULT_STEPS = 32

# True-residual refresh period for served CG.
_RECOMPUTE_EVERY = 50

_TINY = 1e-30  # division guard


def solver_matvec_count(
    op: str, k_est: int, *,
    restart: int = DEFAULT_RESTART, steps: int = DEFAULT_STEPS,
) -> int:
    """Strategy-matvec count of one served solve at ``k_est`` iterations:
    the loop body's matvecs plus each op's verification matvecs. The
    replicated vector work (dots, axpys, the CGS2 GEMVs) is uncounted."""
    if op == "gmres":
        # Per restart cycle: restart Arnoldi matvecs + the cycle's true
        # residual; +1 for the final verification.
        return k_est * (restart + 2) + 1
    if op == "lanczos":
        # Fixed-depth loop; k_est is ignored exactly as maxiter is.
        return steps + 1
    if op == "cg":
        # Body + periodic refresh + the final two-candidate verification.
        return k_est + k_est // _RECOMPUTE_EVERY + 2
    # power, chebyshev: body + one final verification matvec.
    return k_est + 1


def solver_bucket(op: str, *, restart: int, steps: int) -> int:
    """The op's shape parameter, encoded in ExecKey.bucket: GMRES's restart,
    Lanczos's step count, 1 for the shape-free loops."""
    if op == "gmres":
        return restart
    if op == "lanczos":
        return steps
    return 1


def f32_scalar(value, acc: torch.dtype, device: torch.device) -> torch.Tensor:
    """A knob as the JAX engine hands it to its program: rounded to float32,
    then cast to the accumulator dtype, on ``device``."""
    return torch.tensor(float(value), dtype=torch.float32).to(device=device, dtype=acc)


def placed_operand(strategy: MatvecStrategy, mesh: Mesh, a) -> ShardedTensor:
    """``a`` as the strategy's placed operand: a ShardedTensor passes
    through (the engine's resident A); a tensor or QuantizedMatrix is
    checked and cut once."""
    if isinstance(a, ShardedTensor):
        return a
    strategy._check_operand(a, mesh)
    return shard_operand(a, strategy.specs(mesh)[0], mesh)


def _lstsq(h: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """Least-squares ``argmin ||h y - rhs||`` by SVD with the JAX package's
    ``jnp.linalg.lstsq`` cut-off (singular values below ``eps·max(shape)``
    of the largest are dropped), so a lucky breakdown's rank-deficient
    Hessenberg solves the same way."""
    u, s, vh = torch.linalg.svd(h, full_matrices=False)
    rcond = torch.finfo(h.dtype).eps * max(h.shape)
    mask = s >= rcond * s[0]
    s_inv = torch.where(mask, 1.0 / torch.where(mask, s, 1.0), 0.0)
    return vh.T @ (s_inv * (u.T @ rhs))


def build_solver(
    op: str,
    strategy: MatvecStrategy,
    mesh: Mesh,
    *,
    dtype,
    kernel: str | Callable = "cuda",
    combine: str | None = None,
    stages: int | None = None,
    dtype_storage=None,
    restart: int = DEFAULT_RESTART,
    steps: int = DEFAULT_STEPS,
) -> Callable[..., SolverResult]:
    """Return the op's program ``fn(a, b, rtol, maxiter, p0, p1)``.

    ``dtype`` is the engine's operand dtype (the matvec input dtype), never
    inferred from ``a``, which under quantized ``dtype_storage`` is a
    payload. ``kernel`` names the local GEMV tier of the strategy's matvec
    (``"cuda"`` by default); ``"cuda_fused"`` selects the fused iteration
    tier (``ops/cuda_solver.py``; typed errors when the (op, strategy,
    combine) triple has no fused spelling), and ``"auto"`` takes it where
    it is supported and the ``"cuda"`` tier elsewhere. ``a`` may be the
    strategy's placed operand or a plain tensor/payload, placed once per
    call. The square-matrix requirement is the engine's to check."""
    if op not in SOLVER_OPS:
        raise ValueError(f"unknown solver op {op!r}; expected {SOLVER_OPS}")
    if op == "gmres" and restart < 1:
        raise ValueError(f"restart must be >= 1, got {restart}")
    if op == "lanczos" and steps < 2:
        raise ValueError(f"lanczos needs steps >= 2, got {steps}")
    dtype = dtype if isinstance(dtype, torch.dtype) else torch_dtype(str(dtype))
    if kernel in ("cuda_fused", "auto"):
        # Lazy import: ops.cuda_solver imports solvers.common, and this
        # module loads during the solvers package's own __init__.
        from ..ops.cuda_solver import build_fused_solver, fused_solver_supported

        if kernel == "cuda_fused" or fused_solver_supported(
            op, strategy.name, combine, mesh
        ):
            return build_fused_solver(
                op, strategy, mesh, dtype=dtype, combine=combine,
                dtype_storage=dtype_storage,
            )
        kernel = "cuda"
    matvec = strategy.build(
        mesh, kernel=kernel, gather_output=True, combine=combine,
        stages=stages, dtype_storage=dtype_storage,
    )
    spec_x = strategy.specs(mesh)[1]
    dev0 = mesh.devices[0]
    acc = acc_dtype(dtype)

    def _prologue(a, b, rtol):
        a = placed_operand(strategy, mesh, a)

        def mv(v: torch.Tensor) -> torch.Tensor:
            return matvec(a, shard(v.to(dtype), spec_x, mesh)).to(acc)

        return b.to(device=dev0, dtype=acc), f32_scalar(rtol, acc, dev0), mv

    def _nan() -> torch.Tensor:
        return torch.full((), float("nan"), dtype=acc, device=dev0)

    def _n_iters(k: int) -> torch.Tensor:
        return torch.tensor(k, dtype=torch.int32)

    def _linear_result(mv, b_acc, threshold, x, k, x_alt=None):
        # TRUE residual of the returned iterate (one extra matvec): a
        # recurrence minimum is biased low and could claim convergence the
        # returned x does not have. With ``x_alt`` (CG's best-so-far), both
        # candidates are measured and the verified-better one wins.
        rnorm = residual_norm(b_acc - mv(x))
        if x_alt is not None:
            rnorm_alt = residual_norm(b_acc - mv(x_alt))
            better = rnorm_alt < rnorm
            x = torch.where(better, x_alt, x)
            rnorm = torch.where(better, rnorm_alt, rnorm)
        return SolverResult(
            x=x, value=_nan(), n_iters=_n_iters(k),
            residual_norm=rnorm, converged=rnorm <= threshold,
        )

    if op == "cg":

        def solver(a, b, rtol, maxiter, p0, p1):
            b_acc, rtol_acc, mv = _prologue(a, b, rtol)
            threshold = convergence_threshold(rtol_acc, residual_norm(b_acc))
            x = torch.zeros_like(b_acc)
            r = p = b_acc  # x0 = 0, so r = b - A@0
            rz = rr_best = torch.sum(r * r)
            x_best = x
            k = 0
            go = bool(keep_iterating(torch.sqrt(rz), threshold, k, maxiter))
            while go:
                ap = mv(p)
                # pᵀAp > 0 for SPD A; stall (not inf/NaN) on breakdown so
                # the loop exits on maxiter with converged=False.
                pap = torch.sum(p * ap)
                safe = pap > 0
                alpha = torch.where(safe, rz / torch.where(safe, pap, 1.0), 0.0)
                x = x + alpha * p
                r_rec = r - alpha * ap
                rr_rec = torch.sum(r_rec * r_rec)
                # True-residual refresh: periodically, AND whenever the
                # recurrence is about to declare convergence, so the loop
                # exits converged only on a verified residual. The decision
                # is the iteration's one read.
                about = bool(torch.sqrt(rr_rec) <= threshold)
                refresh = (k + 1) % _RECOMPUTE_EVERY == 0 or about
                if refresh:
                    r = b_acc - mv(x)
                    rz_new = torch.sum(r * r)
                else:
                    r, rz_new = r_rec, rr_rec
                beta = torch.where(safe, rz_new / torch.where(rz != 0, rz, 1.0), 0.0)
                p = r + beta * p
                better = rz_new < rr_best
                x_best = torch.where(better, x, x_best)
                rr_best = torch.where(better, rz_new, rr_best)
                rz = rz_new
                k += 1
                # Without a refresh, ||r|| = sqrt(rr_rec) > threshold was
                # just read: only the cap can stop the loop.
                go = (bool(keep_iterating(torch.sqrt(rz), threshold, k, maxiter))
                      if refresh else k < maxiter)
            return _linear_result(mv, b_acc, threshold, x, k, x_alt=x_best)

        return solver

    if op == "gmres":
        m = restart

        def solver(a, b, rtol, maxiter, p0, p1):
            b_acc, rtol_acc, mv = _prologue(a, b, rtol)
            n = b_acc.shape[0]
            b_norm = residual_norm(b_acc)
            threshold = convergence_threshold(rtol_acc, b_norm)

            def cycle(x, r, rnorm):
                # One GMRES(m) cycle: CGS2 Arnoldi over a fixed-shape basis,
                # then the small Hessenberg least-squares solve.
                safe = rnorm > 0
                V = torch.zeros((m + 1, n), dtype=acc, device=dev0)
                V[0] = torch.where(safe, r / torch.where(safe, rnorm, 1.0), 0.0)
                H = torch.zeros((m + 1, m), dtype=acc, device=dev0)
                for j in range(m):
                    w = mv(V[j])
                    h1 = V @ w
                    w = w - h1 @ V
                    h2 = V @ w
                    w = w - h2 @ V
                    h = h1 + h2
                    wnorm = residual_norm(w)
                    ok = wnorm > 0  # 0 = lucky breakdown
                    V[j + 1] = torch.where(ok, w / torch.where(ok, wnorm, 1.0), 0.0)
                    h[j + 1] = wnorm
                    H[:, j] = h
                e1 = torch.zeros((m + 1,), dtype=acc, device=dev0)
                e1[0] = rnorm
                x_new = x + _lstsq(H, e1) @ V[:m]
                r_new = b_acc - mv(x_new)
                return x_new, r_new, residual_norm(r_new)

            x = x_best = torch.zeros_like(b_acc)
            r, rnorm, rn_best = b_acc, b_norm, b_norm
            k = 0
            # maxiter caps restart CYCLES; the worst-case matvec count is
            # maxiter * (restart + 2).
            while bool(keep_iterating(rnorm, threshold, k, maxiter)):
                x, r, rnorm = cycle(x, r, rnorm)
                better = rnorm < rn_best
                x_best = torch.where(better, x, x_best)
                rn_best = torch.where(better, rnorm, rn_best)
                k += 1
            return _linear_result(mv, b_acc, threshold, x_best, k)

        return solver

    if op == "power":

        def solver(a, b, rtol, maxiter, p0, p1):
            b_acc, rtol_acc, mv = _prologue(a, b, rtol)
            # rhs is the START vector (a seeded random one: a fixed start
            # could be orthogonal to the dominant eigenvector).
            v = b_acc / torch.clamp(residual_norm(b_acc), min=_TINY)
            lam = torch.zeros((), dtype=acc, device=dev0)
            resid = torch.full((), float("inf"), dtype=acc, device=dev0)
            k = 0

            def thresh_of(lam):
                # Relative eigenresidual: ||A v − λ v|| <= rtol·|λ|.
                return convergence_threshold(rtol_acc, torch.clamp(lam.abs(), min=_TINY))

            while bool(keep_iterating(resid, thresh_of(lam), k, maxiter)):
                av = mv(v)
                lam = torch.sum(v * av)  # Rayleigh quotient (unit v)
                resid = residual_norm(av - lam * v)
                v = av / torch.clamp(residual_norm(av), min=_TINY)
                k += 1
            # Final Rayleigh pair from the returned vector (same matvec).
            av = mv(v)
            lam = torch.sum(v * av)
            resid = residual_norm(av - lam * v)
            return SolverResult(
                x=v, value=lam, n_iters=_n_iters(k), residual_norm=resid,
                converged=resid <= thresh_of(lam),
            )

        return solver

    if op == "lanczos":
        s_steps = steps

        def solver(a, b, rtol, maxiter, p0, p1):
            b_acc, rtol_acc, mv = _prologue(a, b, rtol)
            n = b_acc.shape[0]
            v = b_acc / torch.clamp(residual_norm(b_acc), min=_TINY)
            V = torch.zeros((s_steps, n), dtype=acc, device=dev0)
            V[0] = v
            v_prev = torch.zeros_like(v)
            beta_prev = torch.zeros((), dtype=acc, device=dev0)
            alphas, betas = [], []
            # Fixed depth: the step count is the ExecKey bucket, so
            # `maxiter` is ignored, and the loop reads nothing.
            for j in range(s_steps):
                w = mv(v) - beta_prev * v_prev
                alpha = torch.sum(v * w)
                w = w - alpha * v
                # One full reorthogonalization pass against the built basis
                # (rows > j are zero, masking implicit).
                w = w - (V @ w) @ V
                beta = residual_norm(w)
                v_next = w / torch.clamp(beta, min=_TINY)
                if j + 1 < s_steps:
                    V[j + 1] = v_next
                v_prev, v, beta_prev = v, v_next, beta
                alphas.append(alpha)
                betas.append(beta)
            alphas, betas = torch.stack(alphas), torch.stack(betas)
            T = (torch.diag(alphas) + torch.diag(betas[:-1], 1)
                 + torch.diag(betas[:-1], -1))
            evals, evecs = torch.linalg.eigh(T)
            theta = evals[-1]  # extremal (largest) Ritz value
            y = evecs[:, -1] @ V  # Ritz vector
            y = y / torch.clamp(residual_norm(y), min=_TINY)
            # TRUE eigenresidual of the Ritz pair (one extra matvec).
            resid = residual_norm(mv(y) - theta * y)
            thresh = convergence_threshold(rtol_acc, torch.clamp(theta.abs(), min=_TINY))
            return SolverResult(
                x=y, value=theta, n_iters=_n_iters(s_steps),
                residual_norm=resid, converged=resid <= thresh,
            )

        return solver

    # chebyshev
    def solver(a, b, rtol, maxiter, p0, p1):
        b_acc, rtol_acc, mv = _prologue(a, b, rtol)
        # Spectral interval [λ_min, λ_max]; the engine validated
        # 0 < p0 < p1 at submit.
        lmin = f32_scalar(p0, acc, dev0)
        lmax = f32_scalar(p1, acc, dev0)
        d = (lmax + lmin) / 2
        c = (lmax - lmin) / 2
        threshold = convergence_threshold(rtol_acc, residual_norm(b_acc))
        x = torch.zeros_like(b_acc)
        r = b_acc
        p = torch.zeros_like(b_acc)
        alpha = torch.zeros((), dtype=acc, device=dev0)
        b_rr = torch.sum(r * r)
        k = 0
        # Early divergence exit: an interval that excludes part of the
        # spectrum amplifies the excluded modes geometrically.
        go = bool(keep_iterating(torch.sqrt(b_rr), threshold, k, maxiter)
                  & ~diverged(b_rr, b_rr))
        while go:
            # Classic Chebyshev semi-iteration (Saad Alg. 12.1), with the
            # β/α division folded away: β = factor·α where factor is ½c²α
            # (k=1) or ¼c²α (k≥2), so α' = 1/(d − factor).
            coef = 0.0 if k == 0 else (0.5 if k == 1 else 0.25)
            factor = coef * c * c * alpha
            alpha_new = 1.0 / (d - factor)
            beta = factor * alpha
            p = r + beta * p
            ap = mv(p)
            x = x + alpha_new * p
            r_rec = r - alpha_new * ap
            rr_rec = torch.sum(r_rec * r_rec)
            # One read: whether the recurrence is about to stop the loop
            # (then the TRUE residual replaces it, so a converged exit is a
            # verified one) and whether it diverged.
            about, blown = torch.stack(
                (torch.sqrt(rr_rec) <= threshold, diverged(rr_rec, b_rr))).tolist()
            alpha = alpha_new
            k += 1
            if about:
                r = b_acc - mv(x)
                rr = torch.sum(r * r)
                go = bool(keep_iterating(torch.sqrt(rr), threshold, k, maxiter)
                          & ~diverged(rr, b_rr))
            else:
                r = r_rec
                go = k < maxiter and not blown
        return _linear_result(mv, b_acc, threshold, x, k)

    return solver
