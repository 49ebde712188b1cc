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

Left for later slices (ROADMAP.md, queue A 5): the tracer and timeline
spans, the resilience ladder (and with it the native safe tier of quantized
storage), fault injection and the integrity gate, residency/tenancy/reshard
hooks, speculative and solver submits, lowering fingerprints, CUDA-graph
capture, tuned ``promote="auto"`` and ``dtype_storage="auto"``, and RHS
buffer reuse. Their arguments raise ``ConfigError``.
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
from ..utils.errors import ConfigError, DeadlineExceededError
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

# The JAX package's other constructor arguments, not ported yet.
_LATER_ARGS = frozenset({
    "solver_kernel", "stages", "trace_jsonl",
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
    combine : the strategy's own combine schedule or None; any other name
        raises (the ring/overlap/auto schedules are not ported yet).
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

    The JAX package's other arguments (``stages``, ``resilience``,
    ``trace_jsonl``, ...) raise ``ConfigError``.
    """

    def __init__(
        self,
        a,
        mesh: Mesh | None = None,
        *,
        strategy: str | MatvecStrategy = "rowwise",
        kernel: str | Callable = "cuda",
        combine: str | None = None,
        dtype=None,
        max_bucket: int = DEFAULT_MAX_BUCKET,
        promote: str | int | None = "auto",
        donate: bool = True,
        gather_output: bool = True,
        max_in_flight: int | None = None,
        metrics: MetricsRegistry | None = None,
        dtype_storage: str | None = None,
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
        if combine not in (None, self.strategy.combine):
            raise not_ported(f"engine combine={combine!r} for {self.strategy.name}")
        # The batched path has the in-body reductions only; the output
        # gather of rowwise/blockwise is its default (the JAX package's
        # batched fallback for a matvec-only schedule).
        self._matvec_combine = combine
        self._gemm_combine = combine if combine in ("psum", "psum_scatter") else None
        self.storage = self._resolve_storage(dtype_storage)
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
            self._matvec_combine, 1, dtype_name(self.dtype), self.storage,
        )

    def _gemm_key(self, bucket: int) -> ExecKey:
        return ExecKey(
            "gemm", self.strategy.name, self._kernel_label(),
            self._gemm_combine, bucket, dtype_name(self.dtype), self.storage,
        )

    def _build_matvec(self) -> Callable:
        return self.strategy.build(
            self.mesh, kernel=self.kernel, gather_output=self.gather_output,
            combine=self._matvec_combine, dtype_storage=self.storage,
        )

    def _build_gemm(self) -> Callable:
        return self.strategy.build_batched(
            self.mesh, kernel=self.kernel, gather_output=self.gather_output,
            combine=self._gemm_combine, dtype_storage=self.storage,
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
        x,
        *,
        deadline_ms: float | None = None,
        op: str = "matvec",
        rtol: float | None = None,
        integrity: bool | None = None,
    ) -> MatvecFuture:
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

        ``op`` other than ``"matvec"`` (served solvers), ``rtol``
        (speculative serving) and ``integrity`` (the integrity gate) are
        not ported yet and raise ``ConfigError``.
        """
        t0 = time.monotonic()
        t0_perf = time.perf_counter()
        if op != "matvec":
            raise not_ported(f"submit(op={op!r})")
        if rtol is not None:
            raise not_ported("submit(rtol=...) (speculative serving)")
        if integrity is not None:
            raise not_ported("submit(integrity=...) (the integrity gate)")
        x = _as_tensor(x).to(self.dtype)
        self._c_requests.inc()
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
