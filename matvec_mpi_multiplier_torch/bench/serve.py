"""Serve-throughput benchmark: the request-stream face of the suite.

The port's counterpart of the JAX package's ``bench/serve.py``, its
sequential protocol. Where ``bench.sweep`` measures one matvec at a time,
this drives the serving engine (``engine/``) with a mixed-width stream of
right-hand-side blocks against a resident sharded ``A`` and reports:

* **requests/sec** and **columns/sec** over the steady phase;
* **p50/p99 dispatch latency** — ``submit()`` entry to return: the host's
  cost of one request, which on the card includes the request's pageable
  host→device copy but not the device's execution (the stream drains once
  at the end). Percentiles come from the obs histogram;
* **compile counts** per phase — after warmup covers the widths,
  ``compiles_steady`` must be 0 across the mixed-width replay;
* the **GEMV→GEMM promotion check** — one block of ``b*`` columns against
  ``b*`` single-column dispatches, through the same warm engine under the
  same wall-clock protocol.

Rows land in ``data/out/serve_<strategy>.csv`` under the JAX package's
header, byte for byte. ``--dtype-storage int8|int8c|fp8`` serves from a
quantized resident (the row records the resolved format and the engine's
resident bytes). Columns of modes the port does not have yet (load, chaos,
speculative) carry the JAX package's defaults; those modes' flags raise
``ConfigError``.

``--op cg|gmres|power|lanczos|chebyshev`` serves ANSWERS instead
(:func:`run_serve_solver`): each request is one solve against the seeded SPD
:func:`solver_operand`, ``--n-requests`` is the steady solve count, and rows
land in ``serve_solver_<strategy>.csv`` under the JAX package's header.
``--solver-kernel torch|cuda_fused|auto`` picks the iteration tier.

Usage::

    python -m matvec_mpi_multiplier_torch.bench.serve --strategy blockwise \\
        --sizes 65536 --dtype bfloat16 --promote 4
    python -m matvec_mpi_multiplier_torch.bench.serve --platform cpu \\
        --host-devices 8 --sizes 64 --n-requests 20
    python -m matvec_mpi_multiplier_torch.bench.serve --op cg \\
        --strategy rowwise --sizes 65536 --solver-kernel cuda_fused --rtol 1e-5

    # or through the sweep CLI:
    python -m matvec_mpi_multiplier_torch.bench.sweep --op serve ...

This is timing code: host syncs are deliberate protocol fences here.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path
from typing import Sequence

import numpy as np
import torch

from ..engine.core import DEFAULT_SOLVER_MAXITER, SOLVER_KERNELS, MatvecEngine
from ..models import available_strategies
from ..models.base import not_ported
from ..obs.registry import MetricsRegistry
from ..parallel.mesh import Mesh
from ..solvers import SOLVER_OPS
from ..utils.convert import dtype_name, from_numpy, torch_dtype
from ..utils.errors import ConfigError, MatvecError, SolverDivergedError

# Default request-width mix: single vectors through full buckets, with
# off-bucket widths (3, 6, 12, 24) so the pad/unpad path is always
# exercised. Clipped to --max-bucket.
DEFAULT_WIDTH_MIX = (1, 2, 3, 4, 6, 8, 12, 16, 24, 32)

SERVE_CSV_HEADER = (
    "n_rows, n_cols, n_devices, strategy, dtype, kernel, combine, "
    "b_star, max_bucket, n_requests, total_cols, wall_s, rps, cols_per_s, "
    "p50_dispatch_ms, p99_dispatch_ms, compiles_warmup, compiles_steady, "
    "hits_steady, promo_b, promo_gemm_s, promo_seq_s, promo_speedup, "
    "arrival, rate_req_s, concurrency, coalesce, mean_batch_width, "
    "coalesce_ratio, success_rate, failed_requests, retries, downgrades, "
    "dtype_storage, resident_bytes, speculated, escalation_rate, "
    "spec_bandwidth_ratio"
)


@dataclasses.dataclass(frozen=True)
class ServeResult:
    """One serve-bench measurement (one CSV row)."""

    n_rows: int
    n_cols: int
    n_devices: int
    strategy: str
    dtype: str
    kernel: str
    combine: str
    b_star: int | None
    max_bucket: int
    n_requests: int
    total_cols: int
    wall_s: float
    p50_dispatch_ms: float
    p99_dispatch_ms: float
    compiles_warmup: int
    compiles_steady: int
    hits_steady: int
    # Promotion check: one b-wide GEMM dispatch vs b sequential single-RHS
    # dispatches, per-request wall seconds (NaN when promotion is off).
    promo_b: int
    promo_gemm_s: float
    promo_seq_s: float
    # Columns of the JAX package's other protocols, at its defaults for a
    # sequential, fault-free, native run.
    arrival: str = "closed"
    rate_req_s: float = float("nan")
    concurrency: int = 1
    coalesce: int = 0
    mean_batch_width: float = float("nan")
    coalesce_ratio: float = float("nan")
    failed_requests: int = 0
    retries: int = 0
    downgrades: int = 0
    dtype_storage: str = "native"
    resident_bytes: int = 0
    speculated: int = 0
    escalation_rate: float = float("nan")
    spec_bandwidth_ratio: float = float("nan")

    @property
    def success_rate(self) -> float:
        if self.n_requests == 0:
            return float("nan")
        return (self.n_requests - self.failed_requests) / self.n_requests

    @property
    def rps(self) -> float:
        return self.n_requests / self.wall_s

    @property
    def cols_per_s(self) -> float:
        return self.total_cols / self.wall_s

    @property
    def promo_speedup(self) -> float:
        """How many times faster the promoted block GEMM serves its batch
        than sequential dispatch would (>1 = promotion pays)."""
        if not (self.promo_gemm_s > 0):
            return float("nan")
        return self.promo_seq_s / self.promo_gemm_s


def serve_csv_path(strategy: str, root=None):
    from .metrics import out_dir

    return out_dir(root) / f"serve_{strategy}.csv"


def append_serve_result(result: ServeResult, root=None):
    from ..parallel.distributed import is_main_process
    from .metrics import _append_row

    path = serve_csv_path(result.strategy, root)
    if not is_main_process():
        return path
    row = (
        f"{result.n_rows}, {result.n_cols}, {result.n_devices}, "
        f"{result.strategy}, {result.dtype}, {result.kernel}, "
        f"{result.combine}, "
        f"{result.b_star if result.b_star is not None else -1}, "
        f"{result.max_bucket}, {result.n_requests}, {result.total_cols}, "
        f"{result.wall_s:.6f}, {result.rps:.2f}, {result.cols_per_s:.2f}, "
        f"{result.p50_dispatch_ms:.4f}, {result.p99_dispatch_ms:.4f}, "
        f"{result.compiles_warmup}, {result.compiles_steady}, "
        f"{result.hits_steady}, {result.promo_b}, "
        f"{result.promo_gemm_s:.6f}, {result.promo_seq_s:.6f}, "
        f"{result.promo_speedup:.3f}, {result.arrival}, "
        f"{result.rate_req_s:.2f}, {result.concurrency}, "
        f"{result.coalesce}, {result.mean_batch_width:.3f}, "
        f"{result.coalesce_ratio:.3f}, {result.success_rate:.4f}, "
        f"{result.failed_requests}, {result.retries}, {result.downgrades}, "
        f"{result.dtype_storage}, {result.resident_bytes}, "
        f"{result.speculated}, {result.escalation_rate:.4f}, "
        f"{result.spec_bandwidth_ratio:.4f}"
    )
    _append_row(path, SERVE_CSV_HEADER, row)
    return path


def resident_matrix(
    m: int, k: int, dtype: torch.dtype, device: torch.device, seed: int
) -> torch.Tensor:
    """A seeded uniform [0, 10) (m, k) matrix made on ``device`` in row
    chunks (the reference's range), so that no float64 host copy of a
    full-width A is ever held (65536² would be 34 GB)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    out = torch.empty((m, k), dtype=dtype, device=device)
    rows = max(1, (1 << 28) // max(1, k))
    for i in range(0, m, rows):
        n = min(rows, m - i)
        out[i:i + n] = torch.rand((n, k), generator=gen, device=device) * 10
    return out


def _request_pool(
    k: int, widths: Sequence[int], dtype: torch.dtype, seed: int
) -> dict[int, torch.Tensor]:
    """One seeded host block per distinct width — generated once so the
    timed loop measures dispatch, not the RNG. Drawn in float64 with numpy
    and cast by torch, so every dtype (bf16 included) works without numpy
    knowing it."""
    rng = np.random.default_rng(seed)
    return {
        w: torch.from_numpy(rng.uniform(0, 10, (k, w))).to(dtype)
        for w in sorted(set(widths))
    }


def _drain(futures) -> None:
    """Protocol fence: materialize every outstanding result."""
    for fut in futures:
        fut.result()


def measure_promotion(
    engine: MatvecEngine, pool: dict[int, torch.Tensor], *, n_reps: int = 20
) -> tuple[int, float, float]:
    """One promoted block dispatch vs the same columns served one by one,
    through the SAME warm engine and the same wall-clock protocol (submit
    everything, drain once). Returns per-request seconds
    ``(b, t_gemm, t_seq)``, or ``(0, nan, nan)`` when promotion is off."""
    if engine.b_star is None:
        return 0, float("nan"), float("nan")
    b = max(2, min(engine.b_star, engine.max_bucket))
    block = pool.get(b)
    if block is None:
        block = _request_pool(engine.k, [b], engine.dtype, seed=7)[b]
    cols = [block[:, j].contiguous() for j in range(b)]

    # Warm both paths (build + first-run costs out of the timed region).
    _drain([engine.submit(block)])
    _drain([engine.submit(c) for c in cols])

    start = time.perf_counter()
    _drain([engine.submit(block) for _ in range(n_reps)])
    t_gemm = (time.perf_counter() - start) / n_reps

    start = time.perf_counter()
    futures = []
    for _ in range(n_reps):
        futures.extend(engine.submit(c) for c in cols)
    _drain(futures)
    t_seq = (time.perf_counter() - start) / n_reps
    return b, t_gemm, t_seq


def run_serve(
    strategy_name: str,
    mesh: Mesh,
    m: int,
    k: int,
    *,
    dtype: str = "float32",
    kernel: str = "cuda",
    combine: str | None = None,
    stages: int | None = None,
    n_requests: int = 200,
    max_bucket: int = 32,
    widths: Sequence[int] | None = None,
    promote: str | int | None = "auto",
    donate: bool = True,
    seed: int = 0,
    promo_reps: int = 20,
    metrics_out: str | None = None,
    dtype_storage: str | None = None,
) -> ServeResult:
    """Run the serve protocol for one (strategy, shape, mesh) config.

    A is made on the mesh's first device (:func:`resident_matrix`) and
    placed by the engine; with ``dtype_storage`` the engine quantizes it
    there and drops it, so the card holds the payload alone while serving.
    ``combine`` and ``stages`` go to the engine (``MatvecEngine``).
    ``metrics_out`` writes the run's metrics snapshot (engine counters + the
    steady-phase dispatch-latency histogram, one registry) as JSON.
    """
    if widths is None:
        widths = [w for w in DEFAULT_WIDTH_MIX if w <= max_bucket]
    registry = MetricsRegistry()
    engine = MatvecEngine(
        resident_matrix(m, k, torch_dtype(dtype), mesh.devices[0], seed),
        mesh, strategy=strategy_name, kernel=kernel, combine=combine,
        stages=stages, max_bucket=max_bucket, promote=promote, donate=donate,
        metrics=registry, dtype_storage=dtype_storage,
    )
    latency_hist = registry.histogram(
        "serve_dispatch_latency_ms",
        "steady-phase submit() entry-to-return host time",
        # Sized to the run: percentiles exact over the whole steady phase.
        window=max(n_requests, 1),
    )
    pool = _request_pool(k, widths, engine.dtype, seed=seed + 1)

    # ---- warmup: cover the program set, then fence ----
    engine.warmup(widths)
    _drain([engine.submit(pool[w]) for w in sorted(set(widths))])
    warm_stats = engine.stats
    compiles_warmup = warm_stats.compiles

    # ---- steady phase: mixed-width replay, drain once ----
    rng = np.random.default_rng(seed + 2)
    sequence = rng.choice(list(pool), size=n_requests)
    futures = []
    start = time.perf_counter()
    for w in sequence:
        t0 = time.perf_counter()
        futures.append(engine.submit(pool[int(w)]))
        latency_hist.observe((time.perf_counter() - t0) * 1e3)
    _drain(futures)
    wall = time.perf_counter() - start
    steady_stats = engine.stats

    promo_b, promo_gemm, promo_seq = measure_promotion(
        engine, pool, n_reps=promo_reps
    )
    if metrics_out is not None:
        _ = engine.stats  # refresh the in_flight gauge before exporting
        path = Path(metrics_out)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(registry.snapshot(), indent=2) + "\n")
    engine.close()
    return ServeResult(
        n_rows=m,
        n_cols=k,
        n_devices=mesh.size,
        strategy=strategy_name,
        dtype=dtype_name(engine.dtype),
        kernel=kernel if isinstance(kernel, str) else "custom",
        combine=combine or "default",
        b_star=engine.b_star,
        max_bucket=max_bucket,
        n_requests=n_requests,
        total_cols=int(sum(int(w) for w in sequence)),
        wall_s=wall,
        p50_dispatch_ms=latency_hist.percentile(50),
        p99_dispatch_ms=latency_hist.percentile(99),
        compiles_warmup=compiles_warmup,
        compiles_steady=steady_stats.compiles - compiles_warmup,
        hits_steady=steady_stats.hits - warm_stats.hits,
        promo_b=promo_b,
        promo_gemm_s=promo_gemm,
        promo_seq_s=promo_seq,
        dtype_storage=engine.storage,
        resident_bytes=engine.resident_bytes,
    )


# ---------------------------------------------------------------- solvers

SOLVER_CSV_HEADER = (
    "n, n_devices, strategy, dtype, combine, op, solver_kernel, rtol, "
    "maxiter, n_solves, iterations, final_residual, final_value, "
    "time_per_iter_ms, solve_p50_ms, solve_p99_ms, wall_s, "
    "solves_per_s, compiles_warmup, compiles_steady, divergences"
)


@dataclasses.dataclass(frozen=True)
class SolverServeResult:
    """One solver-serve measurement (one CSV row).

    ``iterations``/``final_residual``/``final_value`` are the LAST converged
    solve's telemetry; ``time_per_iter_ms`` is steady-phase wall time over
    total iterations, both summed over CONVERGED solves only — a diverged
    solve burns its full cap and would flatter the per-iteration number.
    Divergences are counted, never folded in."""

    n: int
    n_devices: int
    strategy: str
    dtype: str
    combine: str
    op: str
    solver_kernel: str
    rtol: float
    maxiter: int
    n_solves: int
    iterations: int
    final_residual: float
    final_value: float
    time_per_iter_ms: float
    solve_p50_ms: float
    solve_p99_ms: float
    wall_s: float
    compiles_warmup: int
    compiles_steady: int
    divergences: int

    @property
    def solves_per_s(self) -> float:
        if not (self.wall_s > 0):
            return float("nan")
        return self.n_solves / self.wall_s


def solver_csv_path(strategy: str, root=None):
    from .metrics import out_dir

    return out_dir(root) / f"serve_solver_{strategy}.csv"


def append_solver_result(result: SolverServeResult, root=None):
    from ..parallel.distributed import is_main_process
    from .metrics import _append_row

    path = solver_csv_path(result.strategy, root)
    if not is_main_process():
        return path
    row = (
        f"{result.n}, {result.n_devices}, {result.strategy}, "
        f"{result.dtype}, {result.combine}, {result.op}, "
        f"{result.solver_kernel}, "
        f"{result.rtol:g}, {result.maxiter}, {result.n_solves}, "
        f"{result.iterations}, {result.final_residual:.6e}, "
        f"{result.final_value:.6e}, {result.time_per_iter_ms:.4f}, "
        f"{result.solve_p50_ms:.4f}, {result.solve_p99_ms:.4f}, "
        f"{result.wall_s:.6f}, {result.solves_per_s:.2f}, "
        f"{result.compiles_warmup}, {result.compiles_steady}, "
        f"{result.divergences}"
    )
    _append_row(path, SOLVER_CSV_HEADER, row)
    return path


def solver_operand(n: int, dtype, seed: int, *, device=None):
    """Seeded symmetric diagonally-dominant SPD operand: uniform(-1, 1)
    symmetrized, diagonal set to the absolute row sum plus one. Every
    Gershgorin disc then sits in [1, ·]: SPD with a bounded condition regime,
    valid for all five served ops. One diagonal entry is boosted 1.5× to
    isolate the dominant eigenvalue for the eigen ops.

    With ``device=None`` this is the JAX package's numpy construction, bit
    for bit, returned as a numpy array (the CPU tests hold the two packages
    against each other on it). With a ``device``, it is the SAME FAMILY WITH
    DIFFERENT DRAWS: the uniforms come from a ``torch.Generator`` on that
    device, in float32, and the matrix is built there in row chunks, so a
    full-width A (65536² fp32, 17 GB) never passes through host memory and
    the card holds at most the draws plus the result (2× A) and one
    float64 chunk. Returns a tensor of ``dtype`` on ``device``."""
    if device is None:
        rng = np.random.default_rng(seed)
        g = rng.uniform(-1.0, 1.0, (n, n))
        a = (g + g.T) / 2.0
        np.fill_diagonal(a, np.abs(a).sum(axis=1) + 1.0)
        a[0, 0] *= 1.5
        return a.astype(dtype)
    device = torch.device(device)
    dt = dtype if isinstance(dtype, torch.dtype) else torch_dtype(str(np.dtype(dtype)))
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    g = torch.empty((n, n), dtype=torch.float32, device=device)
    rows = max(1, (1 << 25) // n)  # 128 MiB of float32 per draw chunk
    for i in range(0, n, rows):
        j = min(n, i + rows)
        g[i:j] = torch.rand((j - i, n), generator=gen, device=device) * 2 - 1
    a = torch.empty((n, n), dtype=dt, device=device)
    for i in range(0, n, rows):
        j = min(n, i + rows)
        blk = (g[i:j].double() + g[:, i:j].T.double()) / 2.0
        diag = torch.arange(j - i, device=device)
        blk[diag, diag + i] = blk.abs().sum(dim=1) + 1.0
        if i == 0:
            blk[0, 0] *= 1.5
        a[i:j] = blk.to(dt)
        del blk
    del g
    return a


def gershgorin_interval(a) -> tuple[float, float]:
    """Enclosing spectral interval from Gershgorin discs: chebyshev's
    required ``interval=(λ_min, λ_max)`` without an eigendecomposition.
    Bounds, not estimates: a wider interval costs iterations, never
    correctness. A numpy array takes the JAX package's formula as it is; a
    tensor is read in float64 row chunks on its own device."""
    if not isinstance(a, torch.Tensor):
        d = np.abs(np.diag(a)).astype(np.float64)
        r = np.abs(a).astype(np.float64).sum(axis=1) - d
        return float((np.diag(a) - r).min()), float((np.diag(a) + r).max())
    n = a.shape[0]
    rows = max(1, (1 << 25) // max(1, a.shape[1]))
    lo, hi = [], []
    for i in range(0, n, rows):
        blk = a[i:i + rows].double()
        d = blk.diagonal(offset=i)
        r = blk.abs().sum(dim=1) - d.abs()
        lo.append((d - r).min())
        hi.append((d + r).max())
    return float(torch.stack(lo).min()), float(torch.stack(hi).max())


def run_serve_solver(
    strategy_name: str,
    mesh: Mesh,
    n: int,
    *,
    op: str,
    dtype: str = "float32",
    kernel: str = "cuda",
    solver_kernel: str = "torch",
    combine: str | None = None,
    stages: int | None = None,
    dtype_storage: str | None = None,
    rtol: float = 1e-6,
    rtol_sweep: Sequence[float] | None = None,
    maxiter: int | None = None,
    restart: int | None = None,
    steps: int | None = None,
    n_solves: int = 20,
    donate: bool = True,
    seed: int = 0,
    metrics_out: str | None = None,
) -> SolverServeResult:
    """Run the solver-serve protocol for one (op, strategy, n, mesh) config:
    one warmup solve (the build), then ``n_solves`` steady solves with fresh
    seeded right-hand sides (start vectors for the eigen ops), each
    materialized at once — a solve's latency IS submit-to-answer.

    The operand is :func:`solver_operand`: the JAX package's numpy draws on
    a CPU mesh, the device-built family on a CUDA mesh (made on the mesh's
    first device). rtol and maxiter are per-call arguments, every steady
    solve hits the warm executable, and ``compiles_steady`` must be 0.
    ``SolverDivergedError`` is counted and tolerated; any other failure
    aborts the run. ``rtol_sweep`` cycles the steady solves across a
    tolerance ladder (the CSV's rtol column records the tightest).
    """
    if op not in SOLVER_OPS:
        raise ConfigError(f"unknown solver op {op!r}; served ops: {SOLVER_OPS}")
    dev0 = mesh.devices[0]
    if dev0.type == "cpu":
        a = from_numpy(solver_operand(n, "float64", seed), "cpu").to(torch_dtype(dtype))
    else:
        a = solver_operand(n, dtype, seed, device=dev0)
    interval = gershgorin_interval(a) if op == "chebyshev" else None
    registry = MetricsRegistry()
    engine = MatvecEngine(
        a, mesh, strategy=strategy_name, kernel=kernel,
        solver_kernel=solver_kernel, combine=combine, stages=stages,
        dtype_storage=dtype_storage, dtype=dtype,
        donate=donate, metrics=registry,
    )
    del a  # a quantized engine holds the payload alone
    solve_hist = registry.histogram(
        "serve_solve_latency_ms",
        "steady-phase submit-entry to materialized-answer host time",
        window=max(n_solves, 1),
    )
    rng = np.random.default_rng(seed + 1)
    rhs_pool = [
        torch.from_numpy(rng.standard_normal(n)).to(engine.dtype)
        for _ in range(n_solves + 1)
    ]
    rtols = tuple(rtol_sweep) if rtol_sweep else (rtol,)

    def solve(b, i=0):
        return engine.submit(
            op=op, rhs=b, rtol=rtols[i % len(rtols)], maxiter=maxiter,
            restart=restart, steps=steps, interval=interval,
        ).result()

    # ---- warmup: one solve builds the loop; tolerate divergence the same
    # way the steady phase does (warmup's job is the executable).
    try:
        solve(rhs_pool[-1])
    except SolverDivergedError:
        pass
    warm_stats = engine.stats
    compiles_warmup = warm_stats.compiles

    # ---- steady phase: every solve must hit the warm executable ----
    divergences = 0
    total_iters = 0
    converged_s = 0.0
    last_iters, last_resid, last_value = 0, float("nan"), float("nan")
    start = time.perf_counter()
    for i in range(n_solves):
        t0 = time.perf_counter()
        try:
            res = solve(rhs_pool[i], i)
        except SolverDivergedError:
            divergences += 1
            continue
        dt = time.perf_counter() - t0
        solve_hist.observe(dt * 1e3)
        converged_s += dt
        total_iters += res.n_iters
        last_iters = res.n_iters
        last_resid = res.residual_norm
        last_value = res.value
    wall = time.perf_counter() - start
    steady_stats = engine.stats
    if metrics_out is not None:
        path = Path(metrics_out)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(registry.snapshot(), indent=2) + "\n")
    engine.close()
    return SolverServeResult(
        n=n,
        n_devices=mesh.size,
        strategy=strategy_name,
        dtype=dtype_name(engine.dtype),
        combine=combine or "default",
        op=op,
        solver_kernel=solver_kernel,
        rtol=min(rtols),
        maxiter=DEFAULT_SOLVER_MAXITER if maxiter is None else int(maxiter),
        n_solves=n_solves,
        iterations=last_iters,
        final_residual=last_resid,
        final_value=last_value,
        time_per_iter_ms=(
            converged_s * 1e3 / total_iters if total_iters else float("nan")
        ),
        solve_p50_ms=solve_hist.percentile(50),
        solve_p99_ms=solve_hist.percentile(99),
        wall_s=wall,
        compiles_warmup=compiles_warmup,
        compiles_steady=steady_stats.compiles - compiles_warmup,
        divergences=divergences,
    )


def _run_solver_config(args, name: str, mesh: Mesh, n: int) -> bool:
    """One ``--op <solver>`` config of :func:`run_serve_sweep`: run, write
    the row, print the summary. False when the config was skipped."""
    try:
        result = run_serve_solver(
            name, mesh, n, op=args.solver_op, dtype=args.dtype,
            kernel=args.kernel, combine=getattr(args, "combine", None),
            stages=getattr(args, "stages", None),
            dtype_storage=getattr(args, "dtype_storage", None),
            solver_kernel=getattr(args, "solver_kernel", "torch") or "torch",
            rtol=getattr(args, "rtol", 1e-6),
            rtol_sweep=getattr(args, "rtol_sweep", None),
            maxiter=getattr(args, "maxiter", None),
            restart=getattr(args, "restart", None),
            steps=getattr(args, "steps", None),
            n_solves=args.n_requests, seed=args.seed,
            metrics_out=getattr(args, "metrics_out", None),
        )
    except MatvecError as e:
        print(f"skip {name} {n}x{n} p={mesh.size}: {e}")
        return False
    path = None if args.no_csv else append_solver_result(result, args.data_root)
    print(
        f"serve-solver {result.op} {name} {n}x{n} "
        f"p={mesh.size} tier={result.solver_kernel} "
        f"solves={result.n_solves} "
        f"iters={result.iterations} "
        f"resid={result.final_residual:.3e} "
        f"t/iter={result.time_per_iter_ms:.3f}ms "
        f"p50={result.solve_p50_ms:.2f}ms "
        f"p99={result.solve_p99_ms:.2f}ms "
        f"compiles={result.compiles_warmup}+"
        f"{result.compiles_steady} "
        f"div={result.divergences}"
    )
    if path is not None:
        print(f"CSV: {path}")
    return True


# The flags that select the JAX package's load, chaos, multi-tenant and
# reshard modes, with their defaults: any other value raises. --reshard (the
# scheduler's drift mode) waits for the global scheduler (ROADMAP.md, queue
# A 5); the engine's own reshard() is ported.
_LATER_FLAGS = {
    "arrival": "closed", "concurrency": None,
    "coalesce": None, "fault_spec": None, "poison_rate": 0.0,
    "tenants": None, "reshard": "off",
}


def _check_ported(args: argparse.Namespace) -> None:
    for flag, default in _LATER_FLAGS.items():
        if getattr(args, flag, default) != default:
            raise not_ported(f"--{flag.replace('_', '-')} (serve mode)")
    if getattr(args, "dtype_storage", None) == "speculate":
        raise not_ported("--dtype-storage speculate (speculative serving)")


def tune_serve(
    strategies, sizes, meshes, dtype: str, *, max_bucket: int,
    kernel: str = "cuda", measure: str = "auto", min_gain: float | None = None,
    prune_margin: float | None = None, seed: int = 0, log=print,
) -> None:
    """The ``--tune`` pre-pass: fill every tuning axis a serve config reads
    at engine construction — the kernels, stages and combine of the matvec
    and the GEMM path (the GEMM at the widest bucket), the storage format,
    the solver tier and the promotion crossover over the bucket ladder —
    then drop the dispatch singleton so the engines read the fresh
    decisions."""
    from ..engine.buckets import bucket_ladder
    from ..tuning import TuningCache, reset_cache
    from ..tuning.search import TUNE_MIN_GAIN, tune_config, tune_promotion

    if min_gain is None:
        min_gain = TUNE_MIN_GAIN
    # kernel='auto' would read the cache being filled: race on the default.
    kernel = "cuda" if kernel == "auto" else kernel
    cache = TuningCache.load()
    log(f"serve tuning pre-pass -> {cache.path}")
    buckets = tuple(b for b in bucket_ladder(max_bucket) if b >= 2)
    for m, k in sizes:
        for mesh in meshes:
            for name in strategies:
                common = dict(kernel=kernel, min_gain=min_gain,
                              prune_margin=prune_margin, seed=seed, log=log)
                tune_config(name, mesh, m, k, dtype, cache, op="matvec",
                            measure=measure, **common)
                tune_config(name, mesh, m, k, dtype, cache, op="gemm",
                            n_rhs=max_bucket, measure=measure, **common)
                tune_promotion(name, mesh, m, k, dtype, cache, buckets=buckets,
                               **common)
            cache.save()
    cache.save()
    reset_cache()


def run_serve_sweep(args: argparse.Namespace) -> int:
    """The ``--op serve`` body shared by this module's CLI and
    ``bench.sweep``: the sequential protocol for every (size, strategy,
    device count)."""
    from ..parallel.mesh import make_mesh
    from .sweep import (
        SQUARE_SIZES,
        device_counts_available,
        platform_devices,
        resolve_strategies,
    )

    _check_ported(args)
    # Solver mode: --op selects a served solver; the namespace attribute is
    # solver_op because bench.sweep forwards its own args.op ("serve").
    solver_op = getattr(args, "solver_op", "matvec") or "matvec"
    devices = platform_devices(args.platform, args.host_devices)
    strategies = resolve_strategies(args.strategy)
    counts = args.devices or device_counts_available(len(devices))
    sizes = (
        [(s, s) for s in args.sizes] if args.sizes
        else [(s, s) for s in SQUARE_SIZES]
    )
    meshes = {n: make_mesh(n, devices=devices) for n in counts}
    if getattr(args, "tune", False) and solver_op == "matvec":
        tune_serve(
            strategies, sizes, [meshes[n] for n in counts], args.dtype,
            max_bucket=args.max_bucket, kernel=args.kernel,
            measure=getattr(args, "measure", "auto") or "auto",
            min_gain=getattr(args, "min_gain", None),
            prune_margin=getattr(args, "prune_margin", None), seed=args.seed,
        )
    promote = args.promote
    if promote == "never":
        promote = None
    elif promote not in (None, "auto"):
        promote = int(promote)
    metrics_out = getattr(args, "metrics_out", None)
    n_done = 0
    for m, k in sizes:
        for name in strategies:
            for n_dev in counts:
                if solver_op != "matvec":
                    n_done += _run_solver_config(args, name, meshes[n_dev], m)
                    continue
                try:
                    result = run_serve(
                        name, meshes[n_dev], m, k, dtype=args.dtype,
                        kernel=args.kernel, combine=getattr(args, "combine", None),
                        stages=getattr(args, "stages", None),
                        n_requests=args.n_requests,
                        max_bucket=args.max_bucket, promote=promote,
                        seed=args.seed, metrics_out=metrics_out,
                        dtype_storage=getattr(args, "dtype_storage", None),
                    )
                except MatvecError as e:
                    print(f"skip {name} {m}x{k} p={n_dev}: {e}")
                    continue
                path = None if args.no_csv else append_serve_result(
                    result, args.data_root
                )
                storage_suffix = (
                    f" storage={result.dtype_storage} "
                    f"resident={result.resident_bytes / 1e6:.2f}MB"
                    if result.dtype_storage != "native" else ""
                )
                print(
                    f"serve {name} {m}x{k} p={n_dev} "
                    f"b*={result.b_star} {result.rps:.1f} req/s "
                    f"{result.cols_per_s:.1f} cols/s "
                    f"p50={result.p50_dispatch_ms:.3f}ms "
                    f"p99={result.p99_dispatch_ms:.3f}ms "
                    f"compiles={result.compiles_warmup}+"
                    f"{result.compiles_steady} "
                    f"promo x{result.promo_speedup:.2f} @b={result.promo_b}"
                    f"{storage_suffix}"
                )
                if path is not None:
                    print(f"CSV: {path}")
                n_done += 1
    if n_done and metrics_out is not None:
        print(f"metrics: {metrics_out}")
    print(f"{n_done} serve configs measured")
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m matvec_mpi_multiplier_torch.bench.serve",
        description="Serve-throughput benchmark: mixed-width request "
        "stream against a resident sharded A through the serving engine "
        "(engine/), sequential protocol.",
    )
    p.add_argument(
        "--strategy", nargs="+", default=["all"],
        help=f"strategies to serve: {available_strategies()} or 'all'",
    )
    p.add_argument("--devices", nargs="+", type=int, default=None)
    p.add_argument("--sizes", nargs="+", type=int, default=None)
    p.add_argument("--dtype", default="float32")
    p.add_argument("--kernel", default="cuda")
    p.add_argument(
        "--combine", default=None,
        help="combine schedule (or 'auto': the tuning cache's, the static "
        "default on a miss)",
    )
    p.add_argument(
        "--stages", type=int, default=None,
        help="with --combine overlap: pin the staged schedule's stage "
        "count S (default: the tuning cache's, 2 on a miss; clamped per "
        "shape)",
    )
    p.add_argument("--n-requests", type=int, default=200,
                   help="steady-phase request count")
    p.add_argument("--max-bucket", type=int, default=32,
                   help="widest batch bucket (power-of-two ladder below it)")
    p.add_argument(
        "--promote", default="auto",
        help="GEMV->GEMM crossover b*: 'auto' (the tuning cache's, 4 on a "
        "miss), an int, or 'never'",
    )
    p.add_argument("--metrics-out", default=None, metavar="FILE",
                   help="write the metrics snapshot after each config")
    p.add_argument(
        "--dtype-storage", dest="dtype_storage", default=None,
        choices=["native", "int8", "int8c", "fp8", "auto", "speculate"],
        help="resident-A storage format (ops/quantize.py): quantize A once "
        "at residency and serve from the low-bit payload; 'auto' takes the "
        "tuning cache's format (native on a miss); 'speculate' is not "
        "ported. CSV "
        "rows record the resolved format + resident bytes",
    )
    p.add_argument(
        "--op", dest="solver_op", default="matvec",
        choices=["matvec"] + list(SOLVER_OPS),
        help="serve answers instead of multiplies (solvers/): each request is "
        "one solve of A x = b (cg/gmres/chebyshev) or an eigenpair estimate "
        "(power/lanczos) against a seeded SPD operand; --n-requests becomes "
        "the steady solve count and rows land in serve_solver_<strategy>.csv",
    )
    p.add_argument(
        "--solver-kernel", default="torch", choices=list(SOLVER_KERNELS),
        help="with --op cg|chebyshev: the iteration tier — the unfused "
        "PyTorch loop, the fused CUDA step (ops/cuda_solver.py), or 'auto' "
        "(the tuning cache's tier, the unfused one on a miss)",
    )
    p.add_argument(
        "--rtol", type=float, default=1e-6,
        help="with --op <solver>: relative convergence tolerance (a per-call "
        "argument — changing it never builds again)",
    )
    p.add_argument(
        "--rtol-sweep", nargs="+", type=float, default=None,
        help="with --op <solver>: cycle steady solves across this rtol "
        "ladder instead of one fixed --rtol — shows compiles_steady=0 "
        "across the whole ladder",
    )
    p.add_argument(
        "--maxiter", type=int, default=None,
        help="with --op <solver>: iteration cap (per-call; default: the "
        "engine's DEFAULT_SOLVER_MAXITER)",
    )
    p.add_argument(
        "--restart", type=int, default=None,
        help="with --op gmres: restart length (part of the executable's "
        "bucket key)",
    )
    p.add_argument(
        "--steps", type=int, default=None,
        help="with --op lanczos: Krylov steps (part of the executable's "
        "bucket key)",
    )
    # The JAX package's other modes, kept as flags so that asking for one
    # says it is not ported rather than that the flag is unknown.
    for flag in ("--arrival", "--coalesce", "--fault-spec", "--reshard"):
        p.add_argument(flag, default=_LATER_FLAGS[flag[2:].replace("-", "_")])
    p.add_argument("--concurrency", nargs="+", type=int, default=None)
    p.add_argument("--poison-rate", type=float, default=0.0)
    p.add_argument("--tenants", type=int, default=None)
    p.add_argument(
        "--tune", action="store_true",
        help="pre-pass: measure the kernels, stages, combines (matvec and "
        "gemm), storage, solver tier and promotion crossover of every "
        "config and keep them in the tuning cache",
    )
    p.add_argument("--min-gain", type=float, default=None,
                   help="with --tune: hysteresis margin (default 0.05)")
    p.add_argument("--prune-margin", type=float, default=None,
                   dest="prune_margin",
                   help="with --tune: cost-model pruning (no cost model yet: "
                   "every candidate is measured)")
    p.add_argument("--measure", choices=["auto", "loop", "chain", "sync"],
                   default="auto", help="with --tune: the races' timing method")
    p.add_argument("--data-root", default=None)
    p.add_argument("--no-csv", action="store_true")
    p.add_argument(
        "--platform", choices=["cuda", "cpu"], default="cuda",
        help="devices to mesh over: the CUDA devices (default) or CPU shards",
    )
    p.add_argument("--host-devices", type=int, default=None)
    p.add_argument("--seed", type=int, default=0)
    return p


def main(argv: list[str] | None = None) -> int:
    return run_serve_sweep(build_parser().parse_args(argv))


if __name__ == "__main__":
    sys.exit(main())
