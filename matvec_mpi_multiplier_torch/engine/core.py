"""MatvecEngine: batched multi-RHS dispatch against a resident sharded A.

The port's counterpart of the JAX package's ``engine/core.py``, its plain
native path. The engine holds ``A`` resident in its strategy placement and
serves a stream of right-hand sides through three mechanisms:

* **shape buckets** (``buckets.py``) — request widths quantize to a
  power-of-two ladder, so a mixed-width stream maps onto a bounded set of
  programs;
* **executable cache** (``executables.py``) — every (op × strategy × kernel
  × combine × bucket × dtype) program is built exactly once; after warmup
  the stream never builds again;
* **GEMV→GEMM promotion** — a block of ``b >= b*`` right-hand sides rides
  the strategy's program as ONE block GEMM per shard
  (``MatvecStrategy.build_batched``, the hand-written ``csrc/gemm.cu``),
  reading A once instead of ``b`` times; narrower blocks go one column at a
  time through the GEMV (``csrc/gemv.cu``).

With ``dtype_storage`` (int8, int8c, fp8) the resident operand is a
quantized payload instead of ``A`` (``ops/quantize.py``): construction
quantizes ``A`` once, on ``A``'s own device, and every dispatch, vector or
promoted block, runs the hand-written block-scaled GEMV
(``csrc/quant_gemv.cu``) on it.

``submit(op="cg"|"gmres"|"power"|"lanczos"|"chebyshev", rhs=b, ...)`` serves
an ANSWER instead of a multiply: an iterative solve (``solvers/``) against
the resident A, returned as a :class:`SolverFuture`. The iteration tier is
the constructor's ``solver_kernel``: ``"torch"`` runs each iteration as the
strategy's matvec plus PyTorch vector ops, ``"cuda_fused"`` as one fused
step per shard (``ops/cuda_solver.py``, the hand-written
``csrc/solver_step.cu``). The solver loop is host-stepped: it reads one
predicate per iteration, so a solver ``submit`` returns only after the
solve has been enqueued to its end and its last predicate read (the JAX
engine returns at once); only the verification matvec after the loop may
still be running, and ``result()`` then copies to the host.

``submit`` returns a :class:`MatvecFuture` once the request's work is
enqueued; the host waits for the card only when the caller materializes the
result. Two host-side costs stay inside ``submit``: the request's
host→device copy (a pageable ``tensor.to(device)``, which blocks the host
for the copy) and, with ``max_in_flight``, the backpressure gate: at the
high-water mark ``submit`` waits for the OLDEST outstanding dispatch
(drain-oldest) instead of enqueueing unboundedly ahead of the card. A CUDA
event recorded after each dispatch is its completion handle: ``query()``
reclaims finished work, ``synchronize()`` drains. A per-request
``deadline_ms`` fails the future at that gate rather than dispatching
stale work.

Requests are host tensors (CPU ``torch.Tensor``) or numpy arrays of a dtype
numpy has; ``result()`` returns a CPU tensor in the engine's dtype. Every
count lives in a :class:`~..obs.registry.MetricsRegistry`
(:class:`EngineStats` is a view over it).

``combine`` names any schedule the strategy offers (colwise's ring, a2a,
staged overlap and fused ``pallas_ring`` reductions; the gather schedules of
rowwise and blockwise), resolved once at construction; the staged schedules'
stage count S is pinned then too and baked into the executable keys
(``overlap@S``).

Left for later slices (ROADMAP.md, queue A 5): the tracer and timeline
spans, the resilience ladder (and with it the native safe tier of quantized
storage), fault injection and the integrity gate, residency/tenancy/reshard
hooks, speculative submits, lowering fingerprints, CUDA-graph capture (and
with it the graph-captured solver loop), and RHS buffer reuse; their
arguments raise ``ConfigError``. The tuned ``"auto"`` values of
``promote``, ``combine``, ``stages``, ``dtype_storage`` and
``solver_kernel`` wait for the tuning cache: each takes the JAX package's
cache-miss choice.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Callable, Sequence

import numpy as np
import torch

from ..models import get_strategy
from ..models.base import MatvecStrategy, not_ported, shard_operand
from ..obs.registry import MetricsRegistry
from ..ops import gemm_kernel_name_for, get_gemm_kernel, get_kernel
from ..ops.quantize import (
    NATIVE,
    get_storage_kernel,
    normalize_storage,
    quantize_matrix,
)
from ..parallel.mesh import Mesh, ShardedTensor, shard, unshard
from ..utils.convert import dtype_name, from_numpy, torch_dtype
from ..solvers import (
    DEFAULT_RESTART,
    DEFAULT_STEPS,
    SOLVER_OPS,
    SolverResult,
    build_solver,
    solver_bucket,
)
from ..utils.errors import ConfigError, DeadlineExceededError, SolverDivergedError
from .buckets import (
    DEFAULT_MAX_BUCKET,
    bucket_for,
    bucket_ladder,
    pad_columns,
    split_widths,
)
from .executables import ExecKey, ExecStats, ExecutableCache

# Static promotion default: one GEMM dispatch replaces 4+ GEMV dispatches.
# At b=4 the block reads A once instead of 4 times, so even bandwidth-bound
# shapes win. promote="auto" takes it: the tuned crossover waits for the
# tuning slice, so every lookup is the JAX package's cache miss.
DEFAULT_PROMOTE_B = 4

# Iteration cap when a solver submit leaves ``maxiter`` unset.
DEFAULT_SOLVER_MAXITER = 1000

# The solver iteration tiers: the unfused PyTorch loop, the fused CUDA step,
# and "auto" (no tuning cache yet: the unfused tier, the JAX package's
# cache-miss choice).
SOLVER_KERNELS = ("torch", "cuda_fused", "auto")

# The JAX package's other constructor arguments, not ported yet.
_LATER_ARGS = frozenset({
    "trace_jsonl",
    "trace_capacity", "resilience", "fault_plan", "integrity_gate",
    "retain_host", "defer_placement", "label_prefix", "exec_cache",
    "residency_listener", "timeline",
})


class _Dispatch:
    """Completion handle of one dispatch: a CUDA event recorded after it
    on every CUDA device of the mesh (none on a CPU mesh, where PyTorch
    runs synchronously and the work is done on return)."""

    __slots__ = ("events",)

    def __init__(self, devices: Sequence[torch.device]):
        self.events = []
        for dev in devices:
            with torch.cuda.device(dev):
                event = torch.cuda.Event()
                event.record()
            self.events.append(event)

    def query(self) -> bool:
        return all(e.query() for e in self.events)

    def synchronize(self) -> None:
        for e in self.events:
            e.synchronize()


class MatvecFuture:
    """Async handle to one request's result.

    Holds the dispatches' outputs (padded, when the GEMM path ran) plus the
    real column counts; ``result()`` copies them to the host and slices the
    pad columns away — the "masked-result unpad".
    """

    def __init__(
        self, parts: Sequence[tuple], vector: bool, materialize_hist=None,
    ):
        # parts: (output, width, dispatch) — width None marks a rank-1
        # single column, an int a rank-2 block whose first `width` columns
        # are real; output is a tensor, or a ShardedTensor when the engine
        # keeps the strategy's native output layout (gather_output=False).
        self._parts = list(parts)
        self._vector = vector
        self._error: Exception | None = None
        self._materialize_hist = materialize_hist
        self.retired = False

    @classmethod
    def failed(cls, error: Exception) -> "MatvecFuture":
        """A future that was never dispatched (deadline exceeded):
        ``result()`` raises ``error``, ``done()`` is immediately True."""
        fut = cls([], vector=True)
        fut._error = error
        return fut

    def device_values(self) -> list:
        """The raw (still padded) outputs, on their devices — empty for a
        failed future."""
        return [out for out, *_ in self._parts]

    def done(self) -> bool:
        """True when every part's device work has completed (never blocks)."""
        return all(d.query() for *_, d in self._parts)

    def exception(self) -> Exception | None:
        """The failure this future carries, or None for a dispatched one."""
        return self._error

    def result(self) -> torch.Tensor:
        """Materialize on the host: ``(m,)`` for a vector request, ``(m, b)``
        for a block request (pad columns sliced away), as a CPU tensor. A
        failed future raises its error instead."""
        self.retired = True
        if self._error is not None:
            raise self._error
        t0 = time.perf_counter()
        hosts = [
            ((unshard(out) if isinstance(out, ShardedTensor) else out).cpu(), width)
            for out, width, _ in self._parts
        ]
        if self._vector:
            value = hosts[0][0]
        else:
            cols = [h[:, None] if w is None else h[:, :w] for h, w in hosts]
            value = cols[0] if len(cols) == 1 else torch.cat(cols, dim=1)
        if self._materialize_hist is not None:
            self._materialize_hist.observe((time.perf_counter() - t0) * 1e3)
        return value


class SolverFuture:
    """Handle to one served solve (``engine.submit(op="cg", ...)``).

    Mirrors :class:`MatvecFuture`'s face — ``done()`` / ``exception()`` /
    ``result()`` / ``retired``. The contract differs: ``result()`` either
    returns a CONVERGED answer or raises :class:`SolverDivergedError` — when
    the loop hit its iteration cap still above tolerance, or when the
    answer is non-finite. An unconverged or corrupt ``x`` is never
    returned: a solver's whole point is the answer."""

    def __init__(
        self, res: SolverResult | None, op: str, rtol: float, cap: int,
        dispatch: _Dispatch | None = None, materialize_hist=None,
        iter_hist=None, divergence_counter=None, residual_gauge=None,
        iter_time_hist=None, submit_t0: float | None = None,
    ):
        self._res = res
        self.op = op
        self._rtol = rtol
        self._cap = cap  # maxiter (lanczos: its step count)
        self._dispatch = dispatch
        self._error: Exception | None = None
        self.retired = False
        self._materialize_hist = materialize_hist
        self._iter_hist = iter_hist
        self._divergence_counter = divergence_counter
        self._residual_gauge = residual_gauge
        self._iter_time_hist = iter_time_hist
        self._submit_t0 = submit_t0

    @classmethod
    def failed(cls, error: Exception) -> "SolverFuture":
        """A solve that was never dispatched (deadline exceeded):
        ``result()`` raises ``error``, ``done()`` is immediately True."""
        fut = cls(None, op="", rtol=0.0, cap=0)
        fut._error = error
        return fut

    def done(self) -> bool:
        """True when the solve's device work has completed (never blocks)."""
        return self._dispatch is None or self._dispatch.query()

    def exception(self) -> Exception | None:
        return self._error

    def result(self) -> SolverResult:
        """Materialize the solve on the host: a :class:`SolverResult` whose
        ``x`` is a CPU tensor and whose telemetry fields are Python scalars.
        Raises :class:`SolverDivergedError` if the loop exited on its cap
        (the partial iterate is withheld — retry with a larger ``maxiter``
        or a looser ``rtol``) or the answer is non-finite."""
        self.retired = True
        if self._error is not None:
            raise self._error
        t0 = time.perf_counter()
        res = self._res
        x = res.x.cpu()
        n_iters = int(res.n_iters)
        # One copy for the three device scalars.
        rnorm, value, converged = torch.stack((
            res.residual_norm.double(), res.value.double(), res.converged.double(),
        )).tolist()
        if self._iter_hist is not None:
            self._iter_hist.observe(n_iters)
        if self._residual_gauge is not None:
            self._residual_gauge.set(rnorm)
        if self._iter_time_hist is not None and self._submit_t0 is not None:
            # Total solve wall time per iteration (submit entry to here,
            # device wait included).
            self._iter_time_hist.observe(
                (time.perf_counter() - self._submit_t0) * 1e3 / max(n_iters, 1))
        if not bool(torch.isfinite(x).all()) or not np.isfinite(rnorm):
            self._error = SolverDivergedError(
                f"{self.op} solve produced a non-finite result "
                f"(residual_norm={rnorm}); the answer is withheld — check "
                "the operand for NaN/Inf"
            )
            raise self._error
        if not converged:
            if self._divergence_counter is not None:
                self._divergence_counter.inc()
            self._error = SolverDivergedError(
                f"{self.op} solve exhausted its iteration cap "
                f"({self._cap}) at residual_norm={rnorm:.6e} without "
                f"meeting rtol={self._rtol:g}; the partial iterate is "
                "withheld (converged or typed failure, never a silently "
                "wrong x) — retry with a larger maxiter, a looser rtol, or "
                "a better-suited op"
            )
            raise self._error
        if self._materialize_hist is not None:
            self._materialize_hist.observe((time.perf_counter() - t0) * 1e3)
        return SolverResult(x=x, value=value, n_iters=n_iters,
                            residual_norm=rnorm, converged=True)


class EngineStats(ExecStats):
    """Executable-cache counters plus dispatch-level ones (a point-in-time
    view over the engine's metrics registry). ``in_flight`` is the
    outstanding-dispatch count at snapshot time; ``drains`` counts blocking
    waits the backpressure high-water mark forced; ``deadline_failures``
    counts requests failed (never dispatched) because their ``deadline_ms``
    elapsed in the gate."""

    def __init__(
        self, compiles: int, hits: int, requests: int, dispatches: int,
        cols: int, in_flight: int = 0, drains: int = 0,
        deadline_failures: int = 0,
    ):
        super().__init__(compiles=compiles, hits=hits)
        self.requests = requests
        self.dispatches = dispatches
        self.cols = cols
        self.in_flight = in_flight
        self.drains = drains
        self.deadline_failures = deadline_failures


def _engine_dtype(dtype) -> torch.dtype | None:
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    return torch_dtype(dtype if isinstance(dtype, str) else str(np.dtype(dtype)))


def _as_tensor(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    return from_numpy(np.asarray(x), "cpu")


class MatvecEngine:
    """Serve batches of right-hand sides against a resident sharded ``A``.

    Parameters
    ----------
    a : (m, k) tensor on any device, or a host array — placed once with the
        strategy's A placement (at p=1 on A's own card, no copy is made).
    mesh : target device mesh (default: the CUDA devices, ``make_mesh``).
    strategy : strategy name or instance (``models``).
    kernel : local GEMV tier name (``ops/gemv.py``; default ``"cuda"``, the
        hand-written kernel); the GEMM path maps it through
        ``gemm_kernel_name_for``.
    combine : combine schedule name (``models``: colwise's ``psum``,
        ``psum_scatter``, ``ring``, ``ring_overlap``, ``a2a``, ``overlap``,
        ``overlap_ring``, ``pallas_ring``; the ``gather``/``ring``/
        ``overlap`` gathers of rowwise and blockwise), ``"auto"`` (no tuning
        cache yet: the static default, the JAX package's miss), or None for
        the static default. Resolved once here for both paths: a schedule
        the batched path has no face for (``pallas_ring``, the gather
        family) leaves promoted blocks on the strategy's default.
    stages : stage count of the staged ``overlap`` schedules — an int
        (clamped down the shape's stage ladder), or None/``"auto"`` (no
        tuning cache yet: ``DEFAULT_OVERLAP_STAGES``). Resolved once here
        and baked into the executable keys (``overlap@S``); ignored by every
        other schedule.
    dtype : operand dtype (default: ``a``'s).
    max_bucket : widest bucket in the ladder; wider requests split.
    promote : the GEMV→GEMM crossover ``b*``: an int, None (never promote),
        or ``"auto"`` — which has no tuning cache to read yet and takes the
        JAX package's cache-miss default, :data:`DEFAULT_PROMOTE_B`.
    donate : accepted for parity with the JAX package; the port does not
        reuse the RHS buffer yet (every request allocates its own).
    gather_output : as in ``MatvecStrategy.build`` (bools only).
    max_in_flight : backpressure high-water mark — the most outstanding
        dispatches ``submit`` tolerates before waiting on the OLDEST one.
        None (default) keeps the unbounded contract.
    metrics : the MetricsRegistry the engine counts into (default: a fresh
        private one).
    dtype_storage : the resident format of A: None/``"native"`` (A itself),
        ``"int8"``, ``"int8c"`` or ``"fp8"`` (quantized once here, on A's
        device, with the strategy's contraction shards; ``kernel`` then names
        a quantized-storage tier). The engine keeps no reference to the
        native A: the port has no native safe tier yet (the resilience
        ladder), so holding A would double the card's footprint for nothing.
        ``"auto"`` has no tuning cache to read yet and takes the JAX
        package's cold-cache path: native, ``storage_reason="auto_miss"``.
        ``"speculate"`` is not ported.
    solver_kernel : the iteration tier of solver submits: ``"torch"`` (the
        unfused loop: the strategy's matvec plus PyTorch vector ops, the JAX
        package's ``"xla"`` tier), ``"cuda_fused"`` (one fused step per shard
        and iteration, ``ops/cuda_solver.py``, the JAX package's
        ``"pallas_fused"``; cg and chebyshev on rowwise or colwise only —
        the strategy/combine half is checked here, the op half at submit)
        or ``"auto"``, which has no tuning cache yet and takes the unfused
        tier, as the JAX package does on a miss.

    The JAX package's other arguments (``resilience``, ``trace_jsonl``,
    ...) raise ``ConfigError``.
    """

    def __init__(
        self,
        a,
        mesh: Mesh | None = None,
        *,
        strategy: str | MatvecStrategy = "rowwise",
        kernel: str | Callable = "cuda",
        combine: str | None = None,
        stages: int | str | None = None,
        dtype=None,
        max_bucket: int = DEFAULT_MAX_BUCKET,
        promote: str | int | None = "auto",
        donate: bool = True,
        gather_output: bool = True,
        max_in_flight: int | None = None,
        metrics: MetricsRegistry | None = None,
        dtype_storage: str | None = None,
        solver_kernel: str = "torch",
        **later,
    ):
        for name in later:
            if name not in _LATER_ARGS:
                raise TypeError(
                    f"MatvecEngine() got an unexpected keyword argument {name!r}"
                )
            raise not_ported(f"MatvecEngine({name}=...)")
        if mesh is None:
            from ..parallel.mesh import make_mesh

            mesh = make_mesh()
        self.mesh = mesh
        self.strategy = (
            get_strategy(strategy) if isinstance(strategy, str) else strategy
        )
        if solver_kernel not in SOLVER_KERNELS:
            raise ConfigError(
                f"solver_kernel must be 'torch', 'cuda_fused' or 'auto'; "
                f"got {solver_kernel!r}"
            )
        self.solver_kernel = solver_kernel
        if solver_kernel == "cuda_fused":
            # The strategy/combine half of the fused tier's contract fails
            # here, not requests deep; the op half (cg/chebyshev only) is
            # submit()'s: this engine may serve matvecs and other ops too.
            from ..ops.cuda_solver import check_fused_solver

            check_fused_solver("cg", self.strategy.name, combine, mesh)
        a = _as_tensor(a)
        if a.dim() != 2:
            raise ConfigError(f"A must be rank 2, got shape {tuple(a.shape)}")
        self.dtype = _engine_dtype(dtype) or a.dtype
        a = a.to(self.dtype)
        self.m, self.k = a.shape
        self.strategy.validate(self.m, self.k, mesh)
        if not isinstance(gather_output, bool):
            raise ConfigError(
                f"engine gather_output must be True or False; got {gather_output!r}"
            )
        self.storage = self._resolve_storage(dtype_storage)
        # The REQUESTED combine, for the fused solver tier, which owns its
        # combine spelling.
        self._requested_combine = combine
        self._matvec_combine, self._gemm_combine = self._resolve_combine(combine)
        self.stages = self._resolve_stages(stages)
        self.kernel = kernel
        self.gather_output = gather_output
        self.max_bucket = max_bucket
        bucket_ladder(max_bucket)  # validates
        self.b_star = self._resolve_promotion(promote)
        # Unknown kernel names fail here, not requests deep.
        if self.storage != NATIVE:
            get_storage_kernel(kernel)  # one kernel serves both ranks
        else:
            get_kernel(kernel)
            if self.b_star is not None:
                get_gemm_kernel(kernel if callable(kernel) else gemm_kernel_name_for(kernel))
        if max_in_flight is not None and max_in_flight < 1:
            raise ConfigError(f"max_in_flight must be >= 1, got {max_in_flight}")
        self.max_in_flight = max_in_flight
        self._outstanding: deque = deque()
        self._cuda_devices = [d for d in mesh.distinct_devices() if d.type == "cuda"]
        spec_a, self._spec_x, _ = self.strategy.specs(mesh)
        _, self._spec_b, _ = self.strategy.batched_specs(mesh)

        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self._c_requests = self.metrics.counter(
            "engine_requests_total", "submit() calls"
        )
        self._c_dispatches = self.metrics.counter(
            "engine_dispatches_total", "device programs enqueued"
        )
        self._c_cols = self.metrics.counter(
            "engine_cols_total", "right-hand-side columns accepted"
        )
        self._c_drains = self.metrics.counter(
            "engine_drains_total", "backpressure drain-oldest waits"
        )
        self._c_deadline_failures = self.metrics.counter(
            "engine_deadline_failures_total",
            "requests failed in the gate (deadline_ms elapsed)",
        )
        self._c_dispatch_failures = self.metrics.counter(
            "engine_dispatch_failures_total", "submit() calls that raised at dispatch"
        )
        self._g_in_flight = self.metrics.gauge(
            "engine_in_flight", "outstanding dispatches at last snapshot"
        )
        self._h_submit = self.metrics.histogram(
            "engine_submit_latency_ms", "submit() entry-to-return host time"
        )
        self._h_materialize = self.metrics.histogram(
            "engine_materialize_latency_ms",
            "result() materialization host time (device wait included)",
        )
        # Solver metric handles, created on the FIRST solver submit so a
        # pure-matvec engine's snapshot has no solver_* entries.
        self._solver_metrics = None
        self._cache = ExecutableCache(
            compile_counter=self.metrics.counter(
                "engine_compiles_total", "executable builds"
            ),
            hit_counter=self.metrics.counter(
                "engine_hits_total", "executable-cache hits"
            ),
        )
        # Resident for the engine's life: at p=1 on A's own device the shard
        # IS a (or its payload: no copy). A quantized engine drops A here.
        if self.storage != NATIVE:
            a = quantize_matrix(
                a, self.storage,
                contraction_shards=self.strategy.contraction_shards(mesh),
            )
            self.storage_block = a.block
            self.resident_bytes = a.nbytes
        else:
            self.storage_block = None
            self.resident_bytes = a.numel() * a.element_size()
        self._a = shard_operand(a, spec_a, mesh)
        del a
        self.metrics.gauge(
            "engine_resident_bytes",
            "device bytes of the resident A operand (payload + scales for "
            "quantized storage)",
        ).set(self.resident_bytes)
        # Info metric: the label set carries the fact, the value is always 1.
        self.metrics.gauge(
            f'engine_storage_format{{format="{self.storage}",'
            f'dtype="{dtype_name(self.dtype)}",reason="{self.storage_reason}"}}',
            "resident-A storage format (info metric; value is always 1)",
        ).set(1)
        self._closed = False

    # ---- configuration ----

    def _resolve_storage(self, dtype_storage: str | None) -> str:
        """Pin the resident-A storage format at construction and record why
        (``storage_reason``: ``"default"``, ``"explicit"`` or
        ``"auto_miss"``). An explicit format fails loudly when the strategy
        cannot serve it."""
        self.storage_reason = "default" if dtype_storage is None else "explicit"
        if dtype_storage == "speculate":
            raise not_ported("dtype_storage='speculate' (speculative serving)")
        if dtype_storage == "auto":
            # No tuning cache yet: every lookup is the JAX package's miss.
            self.storage_reason = "auto_miss"
            return NATIVE
        fmt = normalize_storage(dtype_storage)
        if fmt != NATIVE and not self.strategy.storage_combine_ok(None):
            raise ConfigError(
                f"strategy {self.strategy.name!r} binds an A-tiling combine "
                "schedule, which cannot compose with quantized "
                f"dtype_storage={fmt!r}"
            )
        return fmt

    def _resolve_combine(self, combine: str | None) -> tuple[str | None, str | None]:
        """Pin the combine schedule of both paths at construction. An
        explicit name binds the matvec path always, and the batched path
        when the strategy has a batched face for it (``pallas_ring`` and the
        gather family leave it on the strategy's default). ``"auto"`` has no
        tuning cache to read yet: both paths take the default (None)."""
        if combine not in (None, "auto") and not self.strategy.supports_combine(combine):
            # Fail at construction, not requests deep.
            raise ConfigError(
                f"strategy {self.strategy.name!r} has no combine schedule "
                f"{combine!r}"
            )
        if (self.storage != NATIVE and combine not in (None, "auto")
                and not self.strategy.storage_combine_ok(combine)):
            raise ConfigError(
                f"combine {combine!r} tiles A inside its schedule body and "
                f"cannot compose with quantized dtype_storage={self.storage!r}"
            )
        if combine in (None, "auto"):
            return None, None
        batched_ok = combine in self.strategy.combine_candidates_batched(self.mesh)
        return combine, (combine if batched_ok else None)

    def _effective_combine(self, combine: str | None) -> str | None:
        """The schedule a path runs: the resolved name, or the strategy
        instance's own binding (colwise_overlap & co.) when none was given."""
        return combine if combine is not None else self.strategy.combine

    def _is_overlap(self, combine: str | None) -> bool:
        return self._effective_combine(combine).startswith("overlap")

    def _resolve_stages(self, stages: int | str | None) -> int | None:
        """Pin the overlap stage count S at construction (None when no path
        runs an overlap schedule): the explicit int clamped to the shape's
        ladder, or the cache-miss default."""
        if not (self._is_overlap(self._matvec_combine)
                or self._is_overlap(self._gemm_combine)):
            return None
        return self.strategy.resolve_stages(
            self.m, self.k, self.mesh, stages,
            self.strategy.overlap_chunk_devices(self.mesh), self.dtype,
        )

    def _combine_label(self, combine: str | None) -> str | None:
        """The combine identity an executable is cached under: the staged
        schedules embed their pinned S (``overlap@4``), as the JAX engine's
        labels do; a strategy-bound overlap labels the same way."""
        if self.stages is not None and self._is_overlap(combine):
            return f"{self._effective_combine(combine)}@{self.stages}"
        return combine

    def _resolve_promotion(self, promote: str | int | None) -> int | None:
        """The crossover ``b*``: blocks of ``b >= b_star`` columns take the
        single-GEMM path; below it, per-column GEMV dispatches. None
        disables promotion entirely."""
        if promote is None:
            return None
        if promote == "auto":
            return DEFAULT_PROMOTE_B  # no tuning cache yet: the miss default
        b_star = int(promote)
        if b_star < 1:
            raise ConfigError(f"promote must be >= 1, got {promote}")
        return b_star

    def _kernel_label(self) -> str:
        return self.kernel if isinstance(self.kernel, str) else getattr(
            self.kernel, "__name__", "custom"
        )

    def _matvec_key(self) -> ExecKey:
        return ExecKey(
            "matvec", self.strategy.name, self._kernel_label(),
            self._combine_label(self._matvec_combine), 1,
            dtype_name(self.dtype), self.storage,
        )

    def _gemm_key(self, bucket: int) -> ExecKey:
        return ExecKey(
            "gemm", self.strategy.name, self._kernel_label(),
            self._combine_label(self._gemm_combine), bucket,
            dtype_name(self.dtype), self.storage,
        )

    def _build_matvec(self) -> Callable:
        return self.strategy.build(
            self.mesh, kernel=self.kernel, gather_output=self.gather_output,
            combine=self._matvec_combine, stages=self.stages,
            dtype_storage=self.storage,
        )

    def _build_gemm(self) -> Callable:
        return self.strategy.build_batched(
            self.mesh, kernel=self.kernel, gather_output=self.gather_output,
            combine=self._gemm_combine, stages=self.stages,
            dtype_storage=self.storage,
        )

    # ---- dispatch ----

    def _reclaim(self) -> None:
        """Drop completed dispatches from the outstanding window (a
        non-blocking sweep: ``query`` never waits)."""
        while self._outstanding and self._outstanding[0].query():
            self._outstanding.popleft()

    def _admit(self) -> None:
        """The backpressure gate: at the high-water mark, even after
        reclaiming completed work, wait for the OLDEST dispatch (drain-
        oldest keeps the stream ordered and the device queue bounded)."""
        if self.max_in_flight is None:
            return
        self._reclaim()
        while len(self._outstanding) >= self.max_in_flight:
            self._outstanding.popleft().synchronize()
            self._c_drains.inc()
            self._reclaim()

    def _track(self, dispatch: _Dispatch) -> _Dispatch:
        if self.max_in_flight is not None:
            self._outstanding.append(dispatch)
        return dispatch

    def _run(self, key: ExecKey, build, rhs: torch.Tensor, spec) -> tuple:
        fn = self._cache.get(key, build)
        self._c_dispatches.inc()
        out = fn(self._a, shard(rhs, spec, self.mesh))
        return out, self._track(_Dispatch(self._cuda_devices))

    def _dispatch_matvec(self, col: torch.Tensor) -> tuple:
        """One column -> one result part ``(output, None, dispatch)``."""
        out, dispatch = self._run(self._matvec_key(), self._build_matvec,
                                  col, self._spec_x)
        return out, None, dispatch

    def _dispatch_block(self, chunk: torch.Tensor) -> tuple:
        """One <= max_bucket-wide chunk -> one bucket-padded GEMM part."""
        width = chunk.shape[1]
        bucket = bucket_for(width, self.max_bucket)
        padded = pad_columns(chunk, bucket)
        out, dispatch = self._run(self._gemm_key(bucket), self._build_gemm,
                                  padded, self._spec_b)
        return out, width, dispatch

    def submit(
        self,
        x=None,
        *,
        rhs=None,
        deadline_ms: float | None = None,
        op: str = "matvec",
        rtol: float | None = None,
        maxiter: int | None = None,
        restart: int | None = None,
        steps: int | None = None,
        interval: tuple[float, float] | None = None,
        integrity: bool | None = None,
    ) -> MatvecFuture | SolverFuture:
        """Dispatch one request: a ``(k,)`` vector or a ``(k, b)`` block of
        ``b`` right-hand sides (columns). Returns once the work is enqueued
        (after the backpressure drain, when the high-water mark forces one);
        the future materializes (and unpads) on demand.

        ``deadline_ms``: a request whose deadline has elapsed before
        dispatch gets a FAILED future (``result()`` raises
        :class:`DeadlineExceededError`) and no device work is enqueued. The
        deadline is checked on entry (a non-positive value fails at once,
        without the drain) and again after the backpressure drain, which is
        not interrupted mid-wait, so the call can outlast the deadline by
        up to one drain. A request that made it to dispatch always
        completes.

        ``op`` (default ``"matvec"``) selects a SERVED SOLVER instead of a
        multiply: ``"cg"``/``"gmres"``/``"chebyshev"`` solve ``A x = b``
        against the resident A, ``"power"``/``"lanczos"`` estimate its
        extremal eigenpair (the request vector is then the start vector).
        ``rhs`` is an alias for the positional request; ``rtol`` (default
        1e-6) and ``maxiter`` (default :data:`DEFAULT_SOLVER_MAXITER`) are
        per-call arguments of one built loop (changing them never builds
        again), while ``restart`` (gmres) and ``steps`` (lanczos) are shapes
        keyed into the executable's bucket. ``interval=(λ_min, λ_max)`` is
        chebyshev's required spectral interval. Solver submits return a
        :class:`SolverFuture` once the host-stepped loop has been enqueued to
        its end (module docstring). ``rtol`` on a plain matvec (speculative
        serving) and ``integrity`` (the integrity gate) are not ported yet
        and raise ``ConfigError``.
        """
        t0 = time.monotonic()
        t0_perf = time.perf_counter()
        if rhs is not None:
            if x is not None:
                raise ConfigError(
                    "pass the request as either the positional x or rhs=, not both"
                )
            x = rhs
        if x is None:
            raise ConfigError("submit() needs a request vector or block")
        if op == "matvec" and rtol is not None:
            raise not_ported("submit(rtol=...) (speculative serving)")
        if integrity is not None:
            raise not_ported("submit(integrity=...) (the integrity gate)")
        x = _as_tensor(x).to(self.dtype)
        self._c_requests.inc()
        if op != "matvec":
            return self._submit_solver(
                x, op=op, rtol=rtol, maxiter=maxiter, restart=restart,
                steps=steps, interval=interval, deadline_ms=deadline_ms,
                t0=t0, t0_perf=t0_perf,
            )
        if x.dim() == 1:
            if x.shape[0] != self.k:
                raise ConfigError(
                    f"request length {x.shape[0]} != A columns {self.k}"
                )
        elif x.dim() != 2 or x.shape[0] != self.k:
            raise ConfigError(
                f"request must be (k,) or (k, b) with k={self.k}; got "
                f"shape {tuple(x.shape)}"
            )
        elif x.shape[1] == 0:
            raise ConfigError("empty request (b=0)")

        def expired() -> bool:
            return deadline_ms is not None and (time.monotonic() - t0) * 1e3 > deadline_ms

        def fail() -> MatvecFuture:
            self._c_deadline_failures.inc()
            self._h_submit.observe((time.perf_counter() - t0_perf) * 1e3)
            return MatvecFuture.failed(DeadlineExceededError(
                f"request deadline of {deadline_ms} ms elapsed in the "
                "backpressure gate before dispatch"
            ))

        if deadline_ms is not None and deadline_ms <= 0:
            return fail()  # stale on arrival: skip even the drain
        self._admit()  # may block draining the oldest dispatch
        if expired():
            return fail()
        try:
            if x.dim() == 1:
                self._c_cols.inc()
                parts = [self._dispatch_matvec(x)]
            else:
                b = x.shape[1]
                self._c_cols.inc(b)
                parts = []
                if self.b_star is not None and b >= self.b_star:
                    offset = 0
                    for width in split_widths(b, self.max_bucket):
                        parts.append(self._dispatch_block(x[:, offset:offset + width]))
                        offset += width
                else:
                    parts = [self._dispatch_matvec(x[:, j].contiguous())
                             for j in range(b)]
        except BaseException:
            self._c_dispatch_failures.inc()
            self._h_submit.observe((time.perf_counter() - t0_perf) * 1e3)
            raise
        fut = MatvecFuture(parts, vector=x.dim() == 1,
                           materialize_hist=self._h_materialize)
        self._h_submit.observe((time.perf_counter() - t0_perf) * 1e3)
        return fut

    # ---- served solvers ----

    def _solver_metric_handles(self):
        """The solver metrics, with the JAX package's names, created on
        first use: requests counter, iterations histogram, divergence
        counter, residual gauge, per-iteration time histogram."""
        if self._solver_metrics is None:
            self._solver_metrics = (
                self.metrics.counter(
                    "solver_requests_total", "solver submits accepted"
                ),
                self.metrics.histogram(
                    "solver_iterations",
                    "iterations the solver loop ran per solve",
                ),
                self.metrics.counter(
                    "solver_divergences_total",
                    "solves that exhausted their cap unconverged "
                    "(SolverDivergedError raised at materialization)",
                ),
                self.metrics.gauge(
                    "solver_residual_norm",
                    "true residual norm of the last materialized solve",
                ),
                self.metrics.histogram(
                    "solver_iteration_time",
                    "per-iteration solve wall time, ms (submit-to-"
                    "materialize / n_iters)",
                ),
            )
        return self._solver_metrics

    def _resolve_solver_kernel(self, op: str) -> str:
        """The iteration tier one solve of ``op`` runs: "cuda_fused" or
        "torch". An explicit "cuda_fused" re-raises the fused tier's typed
        errors for an op it does not serve; "auto" has no tuning cache to
        read yet and stays on the unfused tier (the JAX package's miss)."""
        if self.solver_kernel == "cuda_fused":
            from ..ops.cuda_solver import check_fused_solver

            check_fused_solver(op, self.strategy.name, self._requested_combine, self.mesh)
            return "cuda_fused"
        return "torch"

    def _solver_key(self, op: str, bucket: int) -> ExecKey:
        """A solver executable's cache identity: the matvec key with the op
        swapped in and its shape parameter (GMRES restart, Lanczos steps) in
        the bucket field. A fused solve keys on kernel="cuda_fused" and the
        fused body's own combine."""
        if self._resolve_solver_kernel(op) == "cuda_fused":
            from ..ops.cuda_solver import check_fused_solver

            return ExecKey(
                op, self.strategy.name, "cuda_fused",
                check_fused_solver(op, self.strategy.name, self._requested_combine,
                                   self.mesh),
                bucket, dtype_name(self.dtype), self.storage,
            )
        return ExecKey(
            op, self.strategy.name, self._kernel_label(),
            self._combine_label(self._matvec_combine), bucket,
            dtype_name(self.dtype), self.storage,
        )

    def _build_solver(self, key: ExecKey, restart: int, steps: int) -> Callable:
        fused = key.kernel == "cuda_fused"
        return build_solver(
            key.op, self.strategy, self.mesh, dtype=self.dtype,
            kernel="cuda_fused" if fused else self.kernel,
            combine=self._requested_combine if fused else self._matvec_combine,
            stages=None if fused else self.stages,
            dtype_storage=self.storage, restart=restart, steps=steps,
        )

    def _submit_solver(
        self, rhs: torch.Tensor, *, op, rtol, maxiter, restart, steps,
        interval, deadline_ms, t0, t0_perf,
    ) -> SolverFuture:
        """The solver twin of :meth:`submit`'s dispatch tail: validate on
        the host (the last place a typed ConfigError can catch the knobs),
        run the deadline/backpressure gate, then ONE dispatch of the
        solver's built loop."""
        if op not in SOLVER_OPS:
            raise ConfigError(
                f"unknown op {op!r}; expected 'matvec' or one of "
                f"{sorted(SOLVER_OPS)}"
            )
        if self.m != self.k:
            raise ConfigError(
                f"op={op!r} iterates against a square resident A; this "
                f"engine holds {self.m}x{self.k}"
            )
        if rhs.dim() != 1 or rhs.shape[0] != self.k:
            raise ConfigError(
                f"op={op!r} takes one (k,) right-hand side with "
                f"k={self.k}; got shape {tuple(rhs.shape)}"
            )
        rtol = float(1e-6 if rtol is None else rtol)
        if not (rtol > 0.0):
            raise ConfigError(f"rtol must be > 0, got {rtol}")
        maxiter = DEFAULT_SOLVER_MAXITER if maxiter is None else int(maxiter)
        if maxiter < 1:
            raise ConfigError(f"maxiter must be >= 1, got {maxiter}")
        restart = DEFAULT_RESTART if restart is None else int(restart)
        steps = DEFAULT_STEPS if steps is None else int(steps)
        if op == "chebyshev":
            if interval is None:
                raise ConfigError(
                    "op='chebyshev' needs interval=(lambda_min, "
                    "lambda_max) — the semi-iteration is defined by its "
                    "spectral interval (estimate one with op='power'/"
                    "'lanczos')"
                )
            lo, hi = float(interval[0]), float(interval[1])
            # Strictly ordered: reversed endpoints flip the recurrence's sign
            # structure, and a zero-width interval makes c = 0 with d = lo —
            # config mistakes, caught here rather than as a maxiter'd
            # divergence.
            if not (0.0 < lo < hi):
                raise ConfigError(
                    f"chebyshev interval needs 0 < lambda_min < "
                    f"lambda_max (strict: a reversed or zero-width "
                    f"interval has no convergent semi-iteration); got "
                    f"({lo}, {hi})"
                )
        else:
            lo = hi = 0.0
        bucket = solver_bucket(op, restart=restart, steps=steps)
        c_requests, iter_hist, c_div, g_resid, iter_time_hist = (
            self._solver_metric_handles())
        c_requests.inc()

        def expired() -> bool:
            return deadline_ms is not None and (time.monotonic() - t0) * 1e3 > deadline_ms

        def fail() -> SolverFuture:
            self._c_deadline_failures.inc()
            self._h_submit.observe((time.perf_counter() - t0_perf) * 1e3)
            return SolverFuture.failed(DeadlineExceededError(
                f"request deadline of {deadline_ms} ms elapsed in the "
                "backpressure gate before dispatch"
            ))

        if deadline_ms is not None and deadline_ms <= 0:
            return fail()
        self._admit()
        if expired():
            return fail()
        try:
            self._c_cols.inc()
            key = self._solver_key(op, bucket)
            fn = self._cache.get(key, lambda: self._build_solver(key, restart, steps))
            self._c_dispatches.inc()
            res = fn(self._a, rhs.to(self.mesh.devices[0]), rtol, maxiter, lo, hi)
            dispatch = self._track(_Dispatch(self._cuda_devices))
        except BaseException:
            self._c_dispatch_failures.inc()
            self._h_submit.observe((time.perf_counter() - t0_perf) * 1e3)
            raise
        fut = SolverFuture(
            res, op=op, rtol=rtol, cap=steps if op == "lanczos" else maxiter,
            dispatch=dispatch, materialize_hist=self._h_materialize,
            iter_hist=iter_hist, divergence_counter=c_div,
            residual_gauge=g_resid, iter_time_hist=iter_time_hist,
            submit_t0=t0_perf,
        )
        self._h_submit.observe((time.perf_counter() - t0_perf) * 1e3)
        return fut

    def __call__(self, x) -> torch.Tensor:
        """Synchronous convenience: ``submit(x).result()``."""
        return self.submit(x).result()

    # ---- warmup & introspection ----

    def warmup(self, widths: Sequence[int] | None = None) -> int:
        """Build the program set a request stream will hit: the single-RHS
        program plus (when promotion is on) every GEMM bucket — by default
        the whole ladder, or exactly the buckets requests of ``widths``
        columns would dispatch to under :meth:`submit`'s routing (sub-``b*``
        widths take the per-column path and build no GEMM bucket). Returns
        the number of fresh builds."""
        before = self._cache.stats.compiles
        self._cache.get(self._matvec_key(), self._build_matvec)
        if self.b_star is not None:
            if widths is None:
                buckets = set(bucket_ladder(self.max_bucket))
            else:
                buckets = set()
                for w in widths:
                    if w < self.b_star:
                        continue  # submit() serves these per column
                    for chunk in split_widths(w, self.max_bucket):
                        buckets.add(bucket_for(chunk, self.max_bucket))
            for bucket in sorted(buckets):
                self._cache.get(self._gemm_key(bucket), self._build_gemm)
        return self._cache.stats.compiles - before

    @property
    def stats(self) -> EngineStats:
        s = self._cache.stats
        self._reclaim()  # in_flight reports live work, not finished stubs
        in_flight = len(self._outstanding)
        self._g_in_flight.set(in_flight)
        return EngineStats(
            compiles=s.compiles, hits=s.hits,
            requests=self._c_requests.value,
            dispatches=self._c_dispatches.value,
            cols=self._c_cols.value,
            in_flight=in_flight, drains=self._c_drains.value,
            deadline_failures=self._c_deadline_failures.value,
        )

    def close(self) -> None:
        """Drop the outstanding-dispatch references (the device work itself
        cannot be cancelled). Idempotent."""
        if self._closed:
            return
        self._closed = True
        self._outstanding.clear()

    @property
    def n_executables(self) -> int:
        return len(self._cache)
