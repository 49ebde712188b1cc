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

**The loop.** PyTorch has no ``lax.while_loop``. Where the mesh lies on
one CUDA device and every kernel of the iteration takes a launch predicate
(the ``"cuda"`` GEMV on native storage with any combine but
``pallas_ring``, or the fused step on native storage), CG and Chebyshev run
as the device loop (``solvers/device_loop.py``): masked chunks of
iterations over state in fixed tensors, the iteration count and the
continuation predicate on the device, one read per chunk, each chunk a
captured CUDA graph; the true-residual refresh's matvec runs on exactly the
iterations where the host-stepped loop runs it (its GEMV takes the refresh
flag as a launch predicate). Everywhere else they run host-stepped: the
loop enqueues each iteration's work and then reads its continuation
predicate as one small device→host copy, and CG and Chebyshev decide their
true-residual refresh on the host from that read. Both loops give the same
iterate bitwise; :func:`_build_solver` builds either one (the eager device
loop off the card), for the tests and ``chip_smoke.py`` to hold them
against each other. GMRES, power and Lanczos stay host-stepped
(ROADMAP.md, queue A): a GMRES cycle reads once (and its tiny
least-squares SVD may sync), and Lanczos's fixed-depth loop reads
nothing.

The algorithms are the JAX package's, operation for operation: CG with a
best-so-far iterate, a true-residual refresh every ``_RECOMPUTE_EVERY``
iterations and whenever the recurrence is about to declare convergence,
and a two-candidate verified exit (the true residuals of the last and of
the best-so-far iterate; the smaller wins); restarted GMRES with CGS2
Arnoldi and a Hessenberg least-squares solve; power iteration with
``_TINY`` guards; Lanczos with full reorthogonalisation and ``eigh`` of the
tridiagonal; Chebyshev with the folded β/α and the divergence exit. All
stopping arithmetic imports from ``solvers/common.py``. The device CG
loop's exit takes from its state each residual that its last trip already
verified, and on the card predicates off the GEMV that would measure it
again (``_CgLoop.verified``): the same bits, fewer reads of A.
"""

from __future__ import annotations

import contextlib
from typing import Callable

import torch

from ..models.base import MatvecStrategy, shard_operand
from ..ops.gemv import acc_dtype
from ..ops.graphs import launch_predicate, single_cuda_device
from ..ops.quantize import NATIVE, normalize_storage
from ..parallel.mesh import Mesh, ShardedTensor, shard
from ..utils.convert import torch_dtype
from ..obs.annotations import profiler_span
from .device_loop import LOOP_SPAN, ChunkedLoop, commit, host_read, when
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

# The ops whose loop can run on the device; the rest are host-stepped.
DEVICE_LOOP_OPS = frozenset(("cg", "chebyshev"))

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
        # Launches: on the card the device loop's exit launches both
        # verification GEMVs, but predicates off those whose answer its
        # state already holds (``_CgLoop.verify_saved`` counts them).
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


def gmres_cycle(mv: Callable, b_acc: torch.Tensor, x: torch.Tensor,
                r: torch.Tensor, rnorm: torch.Tensor, m: int):
    """One GMRES(m) cycle from iterate ``x`` with residual ``r``: CGS2
    Arnoldi over a fixed-shape basis (rows > j of V are zero, so projecting
    on all of it masks itself), the small Hessenberg least-squares solve,
    and the TRUE residual of the new iterate (one matvec). Returns ``(x,
    r, ||r||)``; the served gmres and ``models/gmres.py`` both run it."""
    acc, dev0, n = b_acc.dtype, b_acc.device, b_acc.shape[0]
    safe = rnorm > 0  # b = 0 never gets here, but guard the division
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
    call. The square-matrix requirement is the engine's to check.

    cg and chebyshev run as the device loop where its chunks are captured,
    host-stepped elsewhere (module docstring); the returned function's
    ``loop`` attribute names the loop it runs, and a device loop's
    ``device_loops`` holds its states (``reads()``: the host reads so far)."""
    return _build_solver(
        op, strategy, mesh, None, dtype=dtype, kernel=kernel, combine=combine,
        stages=stages, dtype_storage=dtype_storage, restart=restart, steps=steps,
    )


def _build_solver(
    op: str,
    strategy: MatvecStrategy,
    mesh: Mesh,
    loop: str | None,
    *,
    dtype,
    kernel: str | Callable = "cuda",
    combine: str | None = None,
    stages: int | None = None,
    dtype_storage=None,
    restart: int = DEFAULT_RESTART,
    steps: int = DEFAULT_STEPS,
) -> Callable[..., SolverResult]:
    """:func:`build_solver` with the loop named by the caller (:func:`solver_loop`)."""
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
        from ..ops.cuda_solver import _build_fused_solver, fused_solver_supported

        if kernel == "cuda_fused" or fused_solver_supported(
            op, strategy.name, combine, mesh
        ):
            return _build_fused_solver(
                op, strategy, mesh, loop, dtype=dtype, combine=combine,
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
    device = single_cuda_device(mesh.devices)
    combine_r = combine if combine is not None else strategy.combine
    loop = solver_loop(loop, op, mesh, predicated=(
        kernel == "cuda" and normalize_storage(dtype_storage) == NATIVE
        and combine_r != "pallas_ring"))

    def _prologue(a, b, rtol):
        a = placed_operand(strategy, mesh, a)

        def mv(v: torch.Tensor) -> torch.Tensor:
            return matvec(a, shard(v.to(dtype), spec_x, mesh)).to(acc)

        return b.to(device=dev0, dtype=acc), f32_scalar(rtol, acc, dev0), mv

    def _nan() -> torch.Tensor:
        return torch.full((), float("nan"), dtype=acc, device=dev0)

    def _n_iters(k: int) -> torch.Tensor:
        return torch.tensor(k, dtype=torch.int32)

    def _true_norm(mv, b_acc, v, flag=None, norm=None):
        # ||b - A v||, or ``norm`` where the device ``flag`` holds: the loop
        # already measured it, bitwise (the same GEMV on the same v). On the
        # loop's one card the product then runs with the launch predicate
        # ~flag and reads no A; elsewhere it runs and is masked. The select
        # is on the norms alone: a GEMV predicated off leaves its output
        # unwritten.
        if flag is None:
            return residual_norm(b_acc - mv(v))
        with launch_predicate(~flag) if device is not None else contextlib.nullcontext():
            measured = residual_norm(b_acc - mv(v))
        return torch.where(flag, norm, measured)

    def _linear_result(mv, b_acc, threshold, x, k, x_alt=None,
                       fresh=None, r_norm=None, best_is_x=None):
        # TRUE residual of the returned iterate (one extra matvec): a
        # recurrence minimum is biased low and could claim convergence the
        # returned x does not have. With ``x_alt`` (CG's best-so-far), both
        # candidates are measured and the verified-better one wins. The
        # device CG loop passes what its last trip verified
        # (``_CgLoop.verified``): ``r_norm`` is x's true residual norm where
        # ``fresh`` holds, and x_alt is x where ``best_is_x`` holds (its
        # norm is then x's, so x stays); those products read no A.
        rnorm = _true_norm(mv, b_acc, x, fresh, r_norm)
        if x_alt is not None:
            rnorm_alt = _true_norm(mv, b_acc, x_alt, best_is_x, rnorm)
            better = rnorm_alt < rnorm
            x = torch.where(better, x_alt, x)
            rnorm = torch.where(better, rnorm_alt, rnorm)
        return SolverResult(
            x=x, value=_nan(), n_iters=_n_iters(k),
            residual_norm=rnorm, converged=rnorm <= threshold,
        )

    if op == "cg" and loop == "device":
        loops = DeviceLoops(lambda mv: _CgLoop(mv, acc, dev0, device))

        def solver(a, b, rtol, maxiter, p0, p1):
            b_acc, rtol_acc, mv = _prologue(a, b, rtol)
            state = loops.get(a, b_acc, mv)
            threshold, k = state.solve(b_acc, rtol_acc, maxiter)
            return _linear_result(state.mv, b_acc, threshold, state.x.clone(), k,
                                  x_alt=state.x_best.clone(), **state.verified())

        solver.loop = "device"
        solver.device_loops = loops
        return solver

    if op == "cg":

        def solver(a, b, rtol, maxiter, p0, p1):
            b_acc, rtol_acc, mv = _prologue(a, b, rtol)
            threshold = convergence_threshold(rtol_acc, residual_norm(b_acc))
            x = torch.zeros_like(b_acc)
            r = p = b_acc  # x0 = 0, so r = b - A@0
            rz = rr_best = torch.sum(r * r)
            x_best = x
            k = 0
            with profiler_span(LOOP_SPAN):
                with host_read():
                    go = bool(keep_iterating(torch.sqrt(rz), threshold, k, maxiter))  # tracer-sync-ok: the host-stepped loop's first continuation read
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
                    with host_read():
                        about = bool(torch.sqrt(rr_rec) <= threshold)  # tracer-sync-ok: the host-stepped loop's one read an iteration (the device loop reads once a chunk)
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
                    if refresh:
                        with host_read():
                            go = bool(keep_iterating(torch.sqrt(rz), threshold, k, maxiter))  # tracer-sync-ok: read only on a refresh trip, which already read
                    else:
                        # Without a refresh, ||r|| = sqrt(rr_rec) > threshold
                        # was just read: only the cap can stop the loop.
                        go = k < maxiter
            return _linear_result(mv, b_acc, threshold, x, k, x_alt=x_best)

        solver.loop = "host"
        return solver

    if op == "gmres":
        m = restart

        def solver(a, b, rtol, maxiter, p0, p1):
            b_acc, rtol_acc, mv = _prologue(a, b, rtol)
            b_norm = residual_norm(b_acc)
            threshold = convergence_threshold(rtol_acc, b_norm)

            x = x_best = torch.zeros_like(b_acc)
            r, rnorm, rn_best = b_acc, b_norm, b_norm
            k = 0
            # maxiter caps restart CYCLES; the worst-case matvec count is
            # maxiter * (restart + 2).
            with profiler_span(LOOP_SPAN):
                while True:
                    with host_read():
                        go = bool(keep_iterating(rnorm, threshold, k, maxiter))  # tracer-sync-ok: gmres is host-stepped: one read a cycle
                    if not go:
                        break
                    x, r, rnorm = gmres_cycle(mv, b_acc, x, r, rnorm, m)
                    better = rnorm < rn_best
                    x_best = torch.where(better, x, x_best)
                    rn_best = torch.where(better, rnorm, rn_best)
                    k += 1
            return _linear_result(mv, b_acc, threshold, x_best, k)

        solver.loop = "host"
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

            with profiler_span(LOOP_SPAN):
                while True:
                    with host_read():
                        go = bool(keep_iterating(resid, thresh_of(lam), k, maxiter))  # tracer-sync-ok: the power iteration is host-stepped: one read an iteration
                    if not go:
                        break
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

        solver.loop = "host"
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
            with profiler_span(LOOP_SPAN):
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

        solver.loop = "host"
        return solver

    if loop == "device":  # chebyshev
        loops = DeviceLoops(lambda mv: _ChebyshevLoop(mv, acc, dev0, device))

        def solver(a, b, rtol, maxiter, p0, p1):
            b_acc, rtol_acc, mv = _prologue(a, b, rtol)
            state = loops.get(a, b_acc, mv)
            threshold, k = state.solve(b_acc, rtol_acc, maxiter, p0, p1)
            return _linear_result(state.mv, b_acc, threshold, state.x.clone(), k)

        solver.loop = "device"
        solver.device_loops = loops
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
        with profiler_span(LOOP_SPAN):
            with host_read():
                go = bool(keep_iterating(torch.sqrt(b_rr), threshold, k, maxiter)  # tracer-sync-ok: the host-stepped loop's first continuation read
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
                with host_read():
                    about, blown = torch.stack(  # tracer-sync-ok: the host-stepped loop's one read an iteration (the device loop reads once a chunk)
                        (torch.sqrt(rr_rec) <= threshold, diverged(rr_rec, b_rr))).tolist()
                alpha = alpha_new
                k += 1
                if about:
                    r = b_acc - mv(x)
                    rr = torch.sum(r * r)
                    with host_read():
                        go = bool(keep_iterating(torch.sqrt(rr), threshold, k, maxiter)  # tracer-sync-ok: read only on a refresh trip, which already read
                                  & ~diverged(rr, b_rr))
                else:
                    r = r_rec
                    go = k < maxiter and not blown
        return _linear_result(mv, b_acc, threshold, x, k)

    solver.loop = "host"
    return solver


def solver_loop(loop: str | None, op: str, mesh: Mesh, *, predicated: bool) -> str:
    """The loop a solver build runs, ``"device"`` or ``"host"``.

    ``loop=None`` (what :func:`build_solver` passes) takes the device loop
    for cg and chebyshev where its chunks are captured: the mesh lies on one
    CUDA device and every kernel of the iteration takes a launch predicate
    (``predicated``). Off the card (the CPU, several CUDA devices) the
    device loop runs its chunks eagerly, with a host read per iteration and
    masked iterations after the stop, so it runs there only where the
    caller names it (``loop="device"``); ``loop="host"`` is always honored."""
    if loop not in (None, "device", "host"):
        raise ValueError(f"loop must be None, 'device' or 'host', got {loop!r}")
    if loop == "host" or op not in DEVICE_LOOP_OPS:
        return "host"
    if single_cuda_device(mesh.devices) is not None:
        return "device" if predicated else "host"
    return loop or "host"


class DeviceLoops:
    """One device-loop state per resident operand, made by ``make(body)``
    from the first call's iteration ``body`` (the torch tier's matvec, the
    fused tier's step): the captured chunk reads the operand's shards and
    the state's tensors where they were at capture, so a call on another
    operand (or right-hand side shape) makes its own."""

    # States kept at once; the oldest goes first (an engine has one operand).
    KEEP = 4

    def __init__(self, make: Callable):
        self._make = make
        self._states: dict = {}

    def get(self, a, b_acc: torch.Tensor, body: Callable):
        shards = a.shards if isinstance(a, ShardedTensor) else (a,)
        key = (tuple(_data_ptrs(s) for s in shards), tuple(b_acc.shape), b_acc.dtype)
        if key not in self._states:
            if len(self._states) >= self.KEEP:
                del self._states[next(iter(self._states))]
            state = self._make(body)
            state.a = a  # keep the operand the capture reads alive
            self._states[key] = state
        return self._states[key]

    def reads(self) -> int:
        """Host reads of every state's loop (``ChunkedLoop.reads``: every
        read its solves made, each one ``solver/host_read`` span)."""
        return sum(s.loop.reads for s in self._states.values() if s.loop is not None)

    def verify_saved(self) -> int:
        """Verification products the CG states' exits found redundant
        (``_CgLoop.verify_saved``), read from the device: for a caller
        between solves, never inside one. 0 for the other loops."""
        return sum(int(s.verify_saved) for s in self._states.values()
                   if getattr(s, "verify_saved", None) is not None)


def _data_ptrs(t) -> tuple:
    leaves = getattr(t, "leaves", None)
    if leaves is not None:  # a QuantizedMatrix shard
        return tuple(0 if leaf is None else leaf.data_ptr() for leaf in leaves)
    return (t.data_ptr(),)


def _zeros(shape, dtype, device) -> torch.Tensor:
    return torch.zeros(shape, dtype=dtype, device=device)


class _CgLoop:
    """The host-stepped CG loop's state and iteration, masked and on the
    device (``solvers/device_loop.py``). Each iteration is the host-stepped
    one, operation for operation: the refresh runs where that loop runs it
    (every _RECOMPUTE_EVERY-th iteration and where the recurrence is about
    to stop), through :func:`when`.

    Two device flags of the last active trip serve the verified exit
    (:meth:`verified`): ``fresh``, that trip refreshed, so ``r`` is the true
    residual of ``x``; ``best_is_x``, that trip's residual was the best
    yet, so ``x_best`` is ``x``. ``verify_saved`` counts, on the device,
    the exit products they made redundant over every solve."""

    def __init__(self, mv: Callable, acc: torch.dtype, dev0: torch.device,
                 device: torch.device | None):
        self.mv, self.acc, self.dev0 = mv, acc, dev0
        self._device = device
        self.loop = None

    def _alloc(self, n: int) -> None:
        acc, dev0 = self.acc, self.dev0
        self.b, self.x, self.r, self.p, self.x_best = (
            _zeros((n,), acc, dev0) for _ in range(5))
        self.threshold, self.rz, self.rr_best = (_zeros((), acc, dev0) for _ in range(3))
        self.k, self.maxiter, self.verify_saved = (
            _zeros((), torch.int64, dev0) for _ in range(3))
        self.go, self.fresh, self.best_is_x = (_zeros((), torch.bool, dev0) for _ in range(3))
        self.loop = ChunkedLoop(self.iteration, self.go, self.k, self._device)

    def iteration(self) -> None:
        mv, go, x, r, p, rz = self.mv, self.go, self.x, self.r, self.p, self.rz
        ap = when(go, lambda: mv(p), lambda: p)
        pap = torch.sum(p * ap)
        safe = pap > 0
        alpha = torch.where(safe, rz / torch.where(safe, pap, 1.0), 0.0)
        x_new = x + alpha * p
        r_rec = r - alpha * ap
        rr_rec = torch.sum(r_rec * r_rec)
        about = torch.sqrt(rr_rec) <= self.threshold
        k_new = self.k + 1
        refresh = go & ((k_new % _RECOMPUTE_EVERY == 0) | about)
        r_true = when(refresh, lambda: self.b - mv(x_new), lambda: r_rec)
        rz_true = torch.sum(r_true * r_true)
        r_new = torch.where(refresh, r_true, r_rec)
        rz_new = torch.where(refresh, rz_true, rr_rec)
        beta = torch.where(safe, rz_new / torch.where(rz != 0, rz, 1.0), 0.0)
        p_new = r_new + beta * p
        better = rz_new < self.rr_best
        x_best = torch.where(better, x_new, self.x_best)
        rr_best = torch.where(better, rz_new, self.rr_best)
        go_new = torch.where(
            refresh,
            keep_iterating(torch.sqrt(rz_new), self.threshold, k_new, self.maxiter),
            k_new < self.maxiter)
        commit(go, ((self.x, x_new), (self.r, r_new), (self.p, p_new),
                    (self.x_best, x_best), (self.rr_best, rr_best),
                    (self.rz, rz_new), (self.k, k_new),
                    (self.fresh, refresh), (self.best_is_x, better)))
        torch.logical_and(go, go_new, out=go)

    def verified(self) -> dict:
        """What the last active trip verified, as ``_linear_result``'s
        keywords, counted in ``verify_saved`` on the device."""
        self.verify_saved.add_(self.fresh.to(torch.int64) + self.best_is_x.to(torch.int64))
        return {"fresh": self.fresh, "r_norm": residual_norm(self.r),
                "best_is_x": self.best_is_x}

    def solve(self, b_acc: torch.Tensor, rtol_acc: torch.Tensor, maxiter: int):
        """Run the loop from x = 0; return ``(threshold, n_iters)``."""
        if self.loop is None:
            self._alloc(b_acc.shape[0])
        self.b.copy_(b_acc)
        threshold = convergence_threshold(rtol_acc, residual_norm(b_acc))
        self.threshold.copy_(threshold)
        self.x.zero_()
        self.r.copy_(b_acc)
        self.p.copy_(b_acc)
        self.rz.copy_(torch.sum(b_acc * b_acc))
        self.rr_best.copy_(self.rz)
        self.x_best.zero_()
        self.fresh.zero_()
        self.best_is_x.zero_()
        self.k.zero_()
        self.maxiter.fill_(maxiter)
        self.go.copy_(keep_iterating(torch.sqrt(self.rz), threshold, self.k, self.maxiter))
        return threshold, self.loop.run()


class _ChebyshevLoop:
    """The host-stepped Chebyshev loop's state and iteration, masked and on
    the device; the true-residual refresh where the recurrence is about to
    stop, through :func:`when`."""

    def __init__(self, mv: Callable, acc: torch.dtype, dev0: torch.device,
                 device: torch.device | None):
        self.mv, self.acc, self.dev0 = mv, acc, dev0
        self._device = device
        self.loop = None

    def _alloc(self, n: int) -> None:
        acc, dev0 = self.acc, self.dev0
        self.b, self.x, self.r, self.p = (_zeros((n,), acc, dev0) for _ in range(4))
        self.threshold, self.alpha, self.d, self.c, self.b_rr = (
            _zeros((), acc, dev0) for _ in range(5))
        self.k, self.maxiter = (_zeros((), torch.int64, dev0) for _ in range(2))
        self.go = _zeros((), torch.bool, dev0)
        self.loop = ChunkedLoop(self.iteration, self.go, self.k, self._device)

    def iteration(self) -> None:
        mv, go, k, c = self.mv, self.go, self.k, self.c
        # The host-stepped loop's coefficient of step k (0, 1/2, then 1/4),
        # as an accumulator value: the same products.
        coef = torch.where(k == 0, 0.0, torch.where(k == 1, 0.5, 0.25)).to(self.acc)
        factor = coef * c * c * self.alpha
        alpha_new = 1.0 / (self.d - factor)
        beta = factor * self.alpha
        p_new = self.r + beta * self.p
        ap = when(go, lambda: mv(p_new), lambda: p_new)
        x_new = self.x + alpha_new * p_new
        r_rec = self.r - alpha_new * ap
        rr_rec = torch.sum(r_rec * r_rec)
        about = torch.sqrt(rr_rec) <= self.threshold
        blown = diverged(rr_rec, self.b_rr)
        k_new = k + 1
        refresh = go & about
        r_true = when(refresh, lambda: self.b - mv(x_new), lambda: r_rec)
        rr = torch.sum(r_true * r_true)
        go_refresh = (keep_iterating(torch.sqrt(rr), self.threshold, k_new, self.maxiter)
                      & ~diverged(rr, self.b_rr))
        go_new = torch.where(about, go_refresh, (k_new < self.maxiter) & ~blown)
        commit(go, ((self.x, x_new), (self.r, torch.where(about, r_true, r_rec)),
                    (self.p, p_new), (self.alpha, alpha_new), (self.k, k_new)))
        torch.logical_and(go, go_new, out=go)

    def solve(self, b_acc: torch.Tensor, rtol_acc: torch.Tensor, maxiter: int,
              p0, p1):
        """Run the loop from x = 0 on the interval [p0, p1]; return
        ``(threshold, n_iters)``."""
        if self.loop is None:
            self._alloc(b_acc.shape[0])
        lmin = f32_scalar(p0, self.acc, self.dev0)
        lmax = f32_scalar(p1, self.acc, self.dev0)
        self.d.copy_((lmax + lmin) / 2)
        self.c.copy_((lmax - lmin) / 2)
        threshold = convergence_threshold(rtol_acc, residual_norm(b_acc))
        self.threshold.copy_(threshold)
        self.b.copy_(b_acc)
        self.x.zero_()
        self.r.copy_(b_acc)
        self.p.zero_()
        self.alpha.zero_()
        self.b_rr.copy_(torch.sum(b_acc * b_acc))
        self.k.zero_()
        self.maxiter.fill_(maxiter)
        self.go.copy_(keep_iterating(torch.sqrt(self.b_rr), threshold, self.k, self.maxiter)
                      & ~diverged(self.b_rr, self.b_rr))
        return threshold, self.loop.run()
