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
``csrc/solver_step.cu``). CG and Chebyshev run on the device in masked
chunks of iterations, each chunk a captured CUDA graph on one card, the host
reading the continuation flag once per chunk (``solvers/device_loop.py``);
GMRES, power and Lanczos read it once per iteration. Either way a solver
``submit`` returns only after the solve has been enqueued to its end and its
last flag read (the JAX engine returns at once); only the verification
matvec after the loop may still be running, and ``result()`` then copies to
the host.

**Dispatch.** On a mesh whose shards all lie on one CUDA device, each
:class:`ExecKey`'s program is captured once as a CUDA graph (``warmup`` or
the key's first dispatch; a capture counts as the key's compile) and every
dispatch replays it: the request is copied into the key's static input,
through pinned memory without blocking the host for a host request
(device to device for a request already on the card), the graph replays,
and the static output is copied into the future's own tensor, so no future
aliases a buffer the next replay writes. On the CPU, and on a mesh over
more than one CUDA device, every dispatch runs the key's program eagerly
(``stats.dispatch`` says which).

``submit`` returns a :class:`MatvecFuture` once the request's work is
enqueued; the host waits for the card only when the caller materializes the
result. With ``max_in_flight`` the backpressure gate stays inside
``submit``: at the
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

**Tuning.** The ``"auto"`` values of ``promote``, ``combine``, ``stages``,
``dtype_storage`` and ``solver_kernel`` read the measured tuning cache
(``tuning/``) for this strategy, global shape, mesh size and dtype, once at
construction (the solver tier per op, at each submit), and take the static
default on a miss; ``kernel="auto"`` reads it per local shape
(``ops/gemv.py``).

**Reshard.** :meth:`MatvecEngine.reshard` migrates the resident operand to
another of rowwise, colwise and blockwise in place
(``parallel/reshard.py``), re-resolves the configuration against the
destination and drops every program built over the old layout.

**Observability and faults.** Every request opens a span tree in
``engine.tracer`` (``obs/tracing.py``: submit → gate → bucket_pad →
exec_lookup → dispatch → materialize, host ``perf_counter`` spans, an
optional JSONL sink) under a process-unique correlation id, and emits
``submit`` / ``deadline_failed`` / ``dispatch_failed`` / ``integrity_refused``
on the event timeline (``obs/timeline.py``). A ``fault_plan``
(``resilience/faults.py``) is consulted at the build site of a key's first
program and at every dispatch; the optional ``integrity_gate`` refuses a
non-finite result on the host copy ``result()`` makes anyway. None of these
adds a host sync to ``submit``. Without a recovery policy a failed dispatch
raises to the caller: the engine runs no dispatch again.

**Recovery** (``resilience/``): with a :class:`~..resilience.ResiliencePolicy`
the engine stops treating a build or dispatch exception as the request's
fate. Each dispatch walks a **degradation ladder** of config levels — the
preferred (strategy × kernel × combine@S × storage) program first, then the
safe ``torch`` tier (the library matmul in the accumulator dtype,
``ops/gemv.py::matmul_acc``, and the unfused solver loop; the default
combine, no stages, ``NATIVE`` storage: the JAX package's plain-XLA tier),
and for block requests the per-column GEMV floor — with a
per-ExecKey **circuit breaker** gating each level (repeated failure of a
config opens its breaker, so later requests skip straight to the fallback;
after the cooldown one request probes the preferred config and a success
restores it). Retryable faults get bounded backoff retries within a level;
resource exhaustion on a block dispatch halves the bucket instead. Under
quantized storage the safe tier's native A is placed from the host copy the
engine keeps, on the first degraded dispatch only. Every reroute is counted
(``resil_*`` metrics), emitted on the timeline (``retry``, ``degrade``,
``breaker_open``, ``breaker_close``) and visible in :meth:`MatvecEngine.health`.
The ladder routes around the faults a ``fault_plan`` injects, and around
nothing else: resource exhaustion (injected, or a real out-of-memory error)
halves a block request's bucket, down to the GEMV floor, and any other real
error — a kernel's failed build or launch, a CUDA error — reaches the caller
at once, with no retry elsewhere and no breaker fed. A device fault that
surfaces later, when ``result()`` copies, is that request's failure.

**Releasable residency** (the hooks ``engine/registry.py`` drives): with
``retain_host=True`` the engine keeps its own host payload (A, or a
quantized resident's payload and scales), so :meth:`MatvecEngine.
release_residency` really frees the card's copy and
:meth:`MatvecEngine.ensure_resident` places it again, bitwise. A release
drops the resident operands and every program built over them: a captured
graph holds A's device address, not a reference to A, so no program
outlives the A it was captured against. The dropped programs are kept until
the work already queued on them has run; the operands go at once, which
PyTorch's caching allocator makes safe because it hands a freed block only
to work later on the same stream, and the engine places and dispatches on
the current stream only. A dispatch after a release places A again before
any program is looked up (the dispatch path's self-heal), so the program
that runs is always one built against the current A. Every change of the
engine's device footprint reports ``(delta_bytes, reason)`` to the
optional ``residency_listener`` (``"resident"``, ``"released"``,
``"native_fallback"``, ``"reshard"``), never while an engine lock is held.
``label_prefix`` makes the fault sites' labels tenant-scoped, and
``exec_cache`` shares the strategy's built functions, which hold no A,
between engines of equal :meth:`MatvecEngine.exec_signature`; the programs
over A (and their captures) stay each engine's own.

**Speculative serving** (``ops/speculative.py``): ``dtype_storage=
"speculate"`` (or a tuned ``speculate`` winner under ``"auto"``) keeps the
primary residency native, so ``rtol=None`` requests are bitwise those of a
plain engine, and places beside it a compensated-int8 (``int8c``) copy of A,
the seeded probes U and their projection P = U A (computed in float64 on
the card). ``submit(x, rtol=...)`` then serves the int8c candidate and its
acceptance check as one program (one CUDA graph on one card, ``rtol`` a
device scalar written before each replay); the verdict stays on the card
until ``result()`` reads it, and a miss escalates the request through the
native program on the materializing thread, under the swap fence. A
tolerance under ``SPEC_RTOL_FLOOR``, or a speculative breaker that an
escalation storm opened, serves native at submit and counts in
``engine_storage_fallbacks_total``. An injected fault on a speculative key
falls back to native the same way; a real error of the candidate's kernel
or of the check reaches the caller.

Left for a later slice (ROADMAP.md, queue A item 6): lowering
fingerprints.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from typing import Callable, Sequence

import numpy as np
import torch

from ..models import get_strategy
from ..models.base import (
    STORAGE_INCOMPATIBLE_COMBINES,
    MatvecStrategy,
    not_ported,
    shard_operand,
)
from ..obs.registry import MetricsRegistry
from ..obs.sink import JsonlSink
from ..obs.slo import ENGINE_TARGETS, SloMonitor
from ..obs.timeline import TimelineHub, bind_request, bound_request_id, get_hub, next_request_id
from ..obs.tracing import ActiveTrace, RequestTracer
from ..ops import gemm_kernel_name_for, get_gemm_kernel, get_kernel
from ..ops.gemv import gemv_acc, matmul_acc
from ..ops.graphs import capture, single_cuda_device
from ..ops.quantize import (
    NATIVE,
    QuantizedMatrix,
    default_block,
    fp8_supported,
    get_storage_kernel,
    normalize_storage,
    quantize_matrix,
)
from ..ops.speculative import (
    SPEC_RTOL_FLOOR,
    build_speculative,
    eligible as spec_eligible,
    probe_count,
    probe_matrix,
    probe_spec,
    project_probes,
)
from ..parallel.mesh import Mesh, ShardedTensor, shard, unshard
from ..resilience.faults import (
    FaultPlan,
    ResultIntegrityError,
    is_injected,
    is_payload_fault,
    out_of_memory_as_exhausted,
    refuse_nonfinite,
)
from ..resilience.policy import (
    BREAKER_CLOSED,
    CircuitBreaker,
    ResiliencePolicy,
    classify_failure,
)
from ..utils.convert import dtype_name, from_numpy, torch_dtype
from ..solvers import (
    DEFAULT_RESTART,
    DEFAULT_STEPS,
    SOLVER_OPS,
    SolverResult,
    build_solver,
    solver_bucket,
)
from ..utils.errors import (
    ConfigError,
    DeadlineExceededError,
    ResidencyError,
    SolverDivergedError,
)
from .buckets import (
    DEFAULT_MAX_BUCKET,
    bucket_for,
    bucket_ladder,
    pad_columns,
    split_widths,
)
from .executables import ExecKey, ExecStats, ExecutableCache

# The speculative tier's vocabulary: SPECULATE is the storage label its
# ExecKeys carry (never a resident format: a speculative engine's own storage
# stays native), SPEC_STORAGE the format its candidate is served from.
SPECULATE = "speculate"
SPEC_STORAGE = "int8c"

# Static promotion default on a tuning-cache miss: one GEMM dispatch replaces
# 4+ GEMV dispatches. At b=4 the block reads A once instead of 4 times, so
# even bandwidth-bound shapes win.
DEFAULT_PROMOTE_B = 4

# Iteration cap when a solver submit leaves ``maxiter`` unset.
DEFAULT_SOLVER_MAXITER = 1000

# The solver iteration tiers: the unfused PyTorch loop, the fused CUDA step,
# and "auto" (the tuning cache's winner; the unfused tier on a miss).
SOLVER_KERNELS = ("torch", "cuda_fused", "auto")

# Finished-request records the tracer's in-memory ring keeps
# (``engine.tracer.traces()``).
TRACE_CAPACITY = 256

# The degradation floor's tier: the plain PyTorch one, the counterpart of
# the JAX package's "xla" (its matvec and GEMM programs run
# ops/gemv.py::matmul_acc, which holds no widened copy of a 16-bit A; its
# solvers the unfused loop). The hand-written kernels are exactly the
# configs a breaker may be routing around.
SAFE_KERNEL = "torch"

# The JAX package's other constructor arguments, not ported: the trace
# ring's size and a private timeline hub, which no caller of the port sets
# (the ring holds TRACE_CAPACITY records; events go to the process hub,
# ``obs.get_hub()``, which ``obs.reset_hub()`` replaces).
_LATER_ARGS = frozenset({"trace_capacity", "timeline"})


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


def _clone_out(out):
    """A fresh copy of a program's output: a tensor, a ShardedTensor, or the
    speculative program's (y, est, accept) tuple of them."""
    if isinstance(out, tuple):
        return tuple(_clone_out(o) for o in out)
    if isinstance(out, ShardedTensor):
        return ShardedTensor(tuple(s.clone() for s in out.shards), out.shape,
                             out.spec, out.mesh)
    return out.clone()


class _EagerProgram:
    """One key's program dispatched eagerly: the request is placed by the
    strategy's spec (a host request: a blocking pageable copy) and the
    program runs. A speculative program reads its tolerance from ``rtol``,
    a device scalar each call writes first."""

    def __init__(self, fn: Callable, a, spec, mesh: Mesh, rtol=None):
        self.fn, self.a, self.spec, self.mesh, self.rtol = fn, a, spec, mesh, rtol

    def __call__(self, rhs: torch.Tensor, rtol: float | None = None):
        if rtol is not None:
            self.rtol.fill_(rtol)
        return self.fn(self.a, shard(rhs, self.spec, self.mesh))

    def release(self) -> None:
        self.a = None


class _CapturedProgram:
    """One key's program captured as a CUDA graph on the mesh's one CUDA
    device, against a static input of the request's shape.

    A dispatch copies the request into the static input (a host request
    through pinned memory, ``non_blocking``: PyTorch's pinned-memory cache
    keeps the staging block until its copy has run, so the host never waits
    for the card here; a request already on the card device to device),
    replays, and copies the static output into a fresh tensor the future
    owns. A speculative program's tolerance is a second static input,
    ``rtol``, written (a fill on the card, no copy from the host) before the
    replay."""

    def __init__(self, fn: Callable, a, spec, mesh: Mesh, shape: tuple,
                 dtype: torch.dtype, device: torch.device, rtol=None):
        self.device = device
        self.rtol = rtol
        self.static_in = torch.zeros(shape, dtype=dtype, device=device)
        placed = shard(self.static_in, spec, mesh)  # views: one device
        self.graph, self.static_out = capture(lambda: fn(a, placed), device)

    def __call__(self, rhs: torch.Tensor, rtol: float | None = None):
        with torch.cuda.device(self.device):
            if rhs.device.type == "cpu":
                self.static_in.copy_(rhs.pin_memory(), non_blocking=True)
            else:
                self.static_in.copy_(rhs)
            if rtol is not None:
                self.rtol.fill_(rtol)
            self.graph.replay()
            return _clone_out(self.static_out)

    def release(self) -> None:
        self.graph = self.static_in = self.static_out = self.rtol = None


def _placed_bytes(st: ShardedTensor | None) -> int:
    """Bytes of the distinct tensors one placed operand holds (a quantized
    resident's payload and scale leaves included)."""
    if st is None:
        return 0
    tensors = {}
    for shard_ in st.shards:
        for t in (shard_.leaves if isinstance(shard_, QuantizedMatrix) else (shard_,)):
            if t is not None:
                tensors[id(t)] = t.numel() * t.element_size()
    return sum(tensors.values())


def _spec_bytes(spec: tuple | None) -> int:
    """Bytes of a placed speculative set: the int8c payload and scales, P's
    shards and U."""
    if spec is None:
        return 0
    qa, p, u = spec
    return _placed_bytes(qa) + _placed_bytes(p) + u.numel() * u.element_size()


def _host_copy(t: torch.Tensor) -> torch.Tensor:
    """``t`` on the host, in pageable memory. A CUDA tensor is copied into a
    page-locked staging block on the current stream and waited for by an
    event: a pageable ``.cpu()`` copy blocks inside the CUDA runtime while it
    waits for the card, and every other client's submit queues behind it (a
    closed loop of 8 clients on one card ran its submits in series that
    way). The staged values are then copied out on the host, so a caller
    never holds page-locked memory and the staging block goes back to
    PyTorch's pinned-memory cache."""
    if t.device.type != "cuda":
        return t.cpu()
    staging = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    with torch.cuda.device(t.device):
        staging.copy_(t, non_blocking=True)
        copied = torch.cuda.Event()
        copied.record()
    copied.synchronize()
    return torch.empty(t.shape, dtype=t.dtype).copy_(staging)


class MatvecFuture:
    """Async handle to one request's result.

    Holds the dispatches' outputs (padded, when the GEMM path ran) plus the
    real column counts; ``result()`` copies them to the host and slices the
    pad columns away — the "masked-result unpad". Several parts (a block
    below ``b*``, or a block wider than the widest bucket) are joined on
    their card first, so a request is one device-to-host copy.
    """

    def __init__(
        self, parts: Sequence[tuple], vector: bool, materialize_hist=None,
        trace: ActiveTrace | None = None, integrity_counter=None,
        timeline: TimelineHub | None = None,
    ):
        # parts: (output, width, dispatch, corrupt[, accept, resolve]) —
        # width None marks a rank-1 single column, an int a rank-2 block
        # whose first `width` columns are real; output is a tensor, or a
        # ShardedTensor when the engine keeps the strategy's native output
        # layout (gather_output=False). corrupt marks a part an injected
        # "nan" fault poisons at materialization (resilience/faults.py).
        # accept/resolve mark a speculative part: accept is the check's
        # device verdict, resolve(accepted) the engine's settlement (the
        # bookkeeping, and on a miss the native re-dispatch, whose parts
        # replace the candidate).
        self._parts = list(parts)
        # Settled once: a second result() reads no verdict and escalates
        # nothing again.
        self._settled: list | None = None
        self._vector = vector
        self._error: Exception | None = None
        self._materialize_hist = materialize_hist
        self.retired = False
        # Request-lifecycle trace: opened by submit, completed here (the
        # materialize span and the finish run on whichever thread
        # materializes; obs/tracing.py).
        self._trace = trace
        # Non-None enables the NaN/Inf integrity gate: result() refuses a
        # non-finite block (ResultIntegrityError), counting here.
        self._integrity_counter = integrity_counter
        self._timeline = timeline

    @classmethod
    def failed(cls, error: Exception, trace: ActiveTrace | None = None) -> "MatvecFuture":
        """A future that was never dispatched (deadline exceeded):
        ``result()`` raises ``error``, ``done()`` is immediately True."""
        fut = cls([], vector=True, trace=trace)
        fut._error = error
        return fut

    def device_values(self) -> list:
        """The raw (still padded) outputs, on their devices — empty for a
        failed future."""
        return [out for out, *_ in self._parts]

    def done(self) -> bool:
        """True when every part's device work has completed (never blocks)."""
        return all(p[2].query() for p in self._parts)

    def exception(self) -> Exception | None:
        """The failure this future carries, or None for a dispatched one."""
        return self._error

    def _settle(self) -> list:
        """Settle the speculative verdicts once: read every speculative
        part's accept flag in one copy (the one host read speculation adds,
        made here because ``result()`` is the engine's sync point), keep an
        accepted candidate and put the parts of its native re-dispatch in
        the place of a rejected one. Plain parts pass through."""
        if self._settled is None:
            spec = [i for i, part in enumerate(self._parts) if len(part) > 4]
            verdicts = {}
            if spec:
                flags = torch.stack([self._parts[i][4].reshape(()) for i in spec])
                verdicts = dict(zip(spec, _host_copy(flags).tolist()))
            settled = []
            for i, part in enumerate(self._parts):
                if i not in verdicts:
                    settled.append(part)
                elif verdicts[i]:
                    part[5](True)
                    settled.append(part[:4])
                else:
                    settled.extend(part[5](False))
            self._settled = settled
        return self._settled

    def _host_value(self) -> torch.Tensor:
        """The request's columns on the host: one copy of the joined parts,
        with an injected corruption planted in element [0] / [0, 0] of each
        corrupt part (one real column, what the integrity gate catches)."""
        outs = [(unshard(out) if isinstance(out, ShardedTensor) else out, width, corrupt)
                for out, width, _, corrupt in self._settle()]
        if self._vector:
            out, _, corrupt = outs[0]
            host = _host_copy(out)
            if corrupt and host.is_floating_point():
                host = host.clone()
                host[0] = float("nan")
            return host
        if len(outs) == 1:
            out, width, corrupt = outs[0]
            host = _host_copy(out)  # the padded block whole: no gather kernel
            value = host[:, None] if width is None else host[:, :width]
            corrupt_at = [0] if corrupt else []
        else:
            dev = outs[0][0].device
            cols = [(out[:, None] if width is None else out[:, :width]).to(dev)
                    for out, width, _ in outs]
            value = _host_copy(torch.cat(cols, dim=1))
            offsets = np.cumsum([0] + [c.shape[1] for c in cols[:-1]])
            corrupt_at = [int(o) for o, (_, _, c) in zip(offsets, outs) if c]
        if corrupt_at and value.is_floating_point():
            value = value.clone()
            for col in corrupt_at:
                value[0, col] = float("nan")
        return value

    def _gate(self, out: torch.Tensor) -> torch.Tensor:
        """The optional NaN/Inf integrity gate, on the host copy: a corrupt
        result raises instead of being served. The refusal is cached like
        any other failure — a second result() raises it again without
        counting again."""
        if self._integrity_counter is not None:
            err = refuse_nonfinite(out, self._integrity_counter,
                                   "the materialized result block")
            if err is not None:
                self._error = err
                if self._timeline is not None:
                    self._timeline.emit(
                        "integrity_refused",
                        request_id=(self._trace.request_id
                                    if self._trace is not None else None),
                    )
                raise err
        return out

    def result(self) -> torch.Tensor:
        """Materialize on the host: ``(m,)`` for a vector request, ``(m, b)``
        for a block request (pad columns sliced away), as a CPU tensor. A
        failed future raises its error instead. Records the ``materialize``
        span and finishes the request's trace (a second call materializes
        again but never emits again)."""
        if self._error is not None:
            self.retired = True
            raise self._error
        trace = self._trace
        t0 = time.perf_counter()
        span = trace.span("materialize") if trace is not None else None
        status = "ok"
        try:
            return self._gate(self._host_value())
        except ResultIntegrityError:
            status = "integrity_failed"
            raise
        except BaseException:
            # A device error surfacing at the copy must not be recorded as
            # a fast successful request.
            status = "materialize_error"
            raise
        finally:
            self.retired = True
            if span is not None:
                span.__exit__(None, None, None)
                trace.finish(status=status)
            if self._materialize_hist is not None and status == "ok":
                self._materialize_hist.observe((time.perf_counter() - t0) * 1e3)


class SolverFuture:
    """Handle to one served solve (``engine.submit(op="cg", ...)``).

    Mirrors :class:`MatvecFuture`'s face — ``done()`` / ``exception()`` /
    ``result()`` / ``retired``. The contract differs: ``result()`` either
    returns a CONVERGED answer or raises — :class:`SolverDivergedError` when
    the loop hit its iteration cap still above tolerance, and
    :class:`ResultIntegrityError` (under the integrity gate) or
    :class:`SolverDivergedError` when the answer is non-finite. An
    unconverged or corrupt ``x`` is never returned: a solver's whole point
    is the answer."""

    def __init__(
        self, res: SolverResult | None, op: str, rtol: float, cap: int,
        dispatch: _Dispatch | None = None, materialize_hist=None,
        iter_hist=None, divergence_counter=None, residual_gauge=None,
        iter_time_hist=None, submit_t0: float | None = None,
        trace: ActiveTrace | None = None, corrupt: bool = False,
        integrity_counter=None, timeline: TimelineHub | None = None,
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
        self._trace = trace
        self._corrupt = bool(corrupt)
        self._integrity_counter = integrity_counter
        self._timeline = timeline

    @classmethod
    def failed(cls, error: Exception, trace: ActiveTrace | None = None) -> "SolverFuture":
        """A solve that was never dispatched (deadline exceeded):
        ``result()`` raises ``error``, ``done()`` is immediately True."""
        fut = cls(None, op="", rtol=0.0, cap=0, trace=trace)
        fut._error = error
        return fut

    def _emit_failure(self, kind: str, **fields) -> None:
        """One typed-failure event on the timeline, correlated to this
        solve."""
        if self._timeline is not None:
            self._timeline.emit(
                kind,
                request_id=(self._trace.request_id
                            if self._trace is not None else None),
                op=self.op, **fields,
            )

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
        or a looser ``rtol``) or the answer is non-finite
        (:class:`ResultIntegrityError` under the integrity gate). Finishes
        the request trace with ``status=ok|diverged|integrity_failed``."""
        if self._error is not None:
            self.retired = True
            raise self._error
        trace = self._trace
        t0 = time.perf_counter()
        span = trace.span("materialize") if trace is not None else None
        status = "ok"
        try:
            res = self._res
            x = res.x.cpu()
            if self._corrupt and x.is_floating_point():
                # Injected silent corruption (resilience/faults.py): the
                # poison lands here so the refusal below catches it.
                x = x.clone()
                x[0] = float("nan")
            n_iters = int(res.n_iters)
            # One copy for the three device scalars.
            rnorm, value, converged = torch.stack((
                res.residual_norm.double(), res.value.double(),
                res.converged.double(),
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
                status = "integrity_failed"
                self._emit_failure("integrity_refused")
                if self._integrity_counter is not None:
                    err = refuse_nonfinite(
                        x, self._integrity_counter,
                        f"the materialized {self.op} solution")
                    if err is not None:
                        self._error = err
                        raise err
                self._error = SolverDivergedError(
                    f"{self.op} solve produced a non-finite result "
                    f"(residual_norm={rnorm}); the answer is withheld — check "
                    "the operand for NaN/Inf"
                )
                raise self._error
            if not converged:
                status = "diverged"
                if self._divergence_counter is not None:
                    self._divergence_counter.inc()
                self._emit_failure("solver_diverged", n_iters=n_iters,
                                   residual_norm=rnorm)
                self._error = SolverDivergedError(
                    f"{self.op} solve exhausted its iteration cap "
                    f"({self._cap}) at residual_norm={rnorm:.6e} without "
                    f"meeting rtol={self._rtol:g}; the partial iterate is "
                    "withheld (converged or typed failure, never a silently "
                    "wrong x) — retry with a larger maxiter, a looser rtol, or "
                    "a better-suited op"
                )
                raise self._error
            return SolverResult(x=x, value=value, n_iters=n_iters,
                                residual_norm=rnorm, converged=True)
        except (SolverDivergedError, ResultIntegrityError):
            raise
        except BaseException:
            status = "materialize_error"
            raise
        finally:
            self.retired = True
            if span is not None:
                span.__exit__(None, None, None)
                trace.finish(status=status)
            if self._materialize_hist is not None and status == "ok":
                self._materialize_hist.observe((time.perf_counter() - t0) * 1e3)


class EngineStats(ExecStats):
    """Executable-cache counters plus dispatch-level ones (a point-in-time
    view over the engine's metrics registry). ``dispatch`` is ``"graph"``
    (each key's program captured once and replayed) or ``"eager"`` (the CPU,
    or a mesh over several CUDA devices). ``in_flight`` is the
    outstanding-dispatch count at snapshot time; ``drains`` counts blocking
    waits the backpressure high-water mark forced; ``deadline_failures``
    counts requests failed (never dispatched) because their ``deadline_ms``
    elapsed in the gate; ``dropped`` counts programs :meth:`MatvecEngine.reshard`
    dropped with the old layout (the builds that replace them count in
    ``compiles``)."""

    def __init__(
        self, compiles: int, hits: int, requests: int, dispatches: int,
        cols: int, in_flight: int = 0, drains: int = 0,
        deadline_failures: int = 0, dispatch: str = "eager", dropped: int = 0,
    ):
        super().__init__(compiles=compiles, hits=hits)
        self.dispatch = dispatch
        self.requests = requests
        self.dispatches = dispatches
        self.cols = cols
        self.in_flight = in_flight
        self.drains = drains
        self.deadline_failures = deadline_failures
        self.dropped = dropped


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
        ``overlap`` gathers of rowwise and blockwise), ``"auto"`` (the tuning
        cache's schedule for each path, ``op="matvec"`` and ``op="gemm"``;
        the static default on a miss), or None for the static default.
        Resolved once here for both paths: a schedule
        the batched path has no face for (``pallas_ring``, the gather
        family) leaves promoted blocks on the strategy's default.
    stages : stage count of the staged ``overlap`` schedules — an int
        (clamped down the shape's stage ladder), or None/``"auto"`` (the
        tuning cache's stage count, ``DEFAULT_OVERLAP_STAGES`` on a miss).
        Resolved once here and baked into the executable keys
        (``overlap@S``); ignored by every other schedule.
    dtype : operand dtype (default: ``a``'s).
    max_bucket : widest bucket in the ladder; wider requests split.
    promote : the GEMV→GEMM crossover ``b*``: an int, None (never promote),
        or ``"auto"`` — the tuning cache's measured crossover (its
        ``b_star``; a recorded null means promotion never won and is
        honored), :data:`DEFAULT_PROMOTE_B` on a miss.
    donate : a request already on the mesh's first card is handed to the
        engine, which reads its buffer where it lies (eager dispatch places
        it by views, captured dispatch copies it into the key's static
        input); the caller must not write it until the future is done.
        ``donate=False`` copies such a request first. A host request is
        copied either way.
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
        native A on the card; under a ``resilience`` policy it keeps A on
        the host, and the ladder's native safe tier places it on the first
        degraded dispatch. ``"auto"`` takes the tuning cache's format
        (``storage_reason="tuned"``), native on a miss (``"auto_miss"``) or
        where the recorded format cannot serve here (``"auto_degraded"``).
        ``"speculate"`` keeps A native and arms the speculative tier beside
        it (module docstring): the int8c payload of A, the probes U and
        their projection P, placed and released with A and counted in
        ``resident_bytes``; ``kernel`` must then name a quantized-storage
        tier too. A strategy bound to an A-tiling combine refuses it.
    solver_kernel : the iteration tier of solver submits: ``"torch"`` (the
        unfused loop: the strategy's matvec plus PyTorch vector ops, the JAX
        package's ``"xla"`` tier), ``"cuda_fused"`` (one fused step per shard
        and iteration, ``ops/cuda_solver.py``, the JAX package's
        ``"pallas_fused"``; cg and chebyshev on rowwise or colwise only —
        the strategy/combine half is checked here, the op half at submit)
        or ``"auto"``: per op, the tuning cache's tier where the fused tier
        serves the op, the unfused tier on a miss.
    retain_host : keep the host payload for the engine's life — A (a
        reference when A is a host tensor already, else a copy) and, under
        quantized storage, the quantized payload and scales too — so the
        residency is releasable (:meth:`release_residency`) and restorable
        (:meth:`ensure_resident`), bitwise, and :meth:`reshard` can
        requantize a quantized resident whose block size the destination
        changes. Off by default: a plain engine places A once and keeps no
        host copy, except a quantized engine under a ``resilience`` policy,
        which keeps A (the native safe tier's source).
    trace_jsonl : path for the request-trace JSONL sink (``obs/sink.py``);
        every finished request's span tree is appended there by the sink's
        thread. :meth:`flush_traces` fences the file; :meth:`close`
        releases it.
    fault_plan : a seeded :class:`~..resilience.FaultPlan` consulted at the
        build site (a key's first build and capture) and the dispatch site
        (``resilience/faults.py``). Works with or without ``resilience``:
        without it, injected faults reach the caller and no dispatch is run
        again.
    resilience : a :class:`~..resilience.ResiliencePolicy` enabling the
        retry + circuit-breaker + degradation-ladder dispatch path (module
        docstring). None (default): dispatch exceptions propagate, and the
        scheduler's batch bisection still isolates them.
    integrity_gate : check every materialized result for NaN/Inf and raise
        :class:`~..resilience.ResultIntegrityError` instead of serving it
        (counted in ``engine_integrity_failures_total``). The check runs on
        the host copy ``result()`` makes anyway. Off by default.
    defer_placement : place nothing at construction: the first
        :meth:`ensure_resident`, or the first dispatch, places A. Needs
        ``retain_host=True``; registry tenants start evicted, so
        registering many tenants spends host memory, not the card's.
    label_prefix : prefix every fault-site label with this string
        (``"tenant-7/"``), so a :class:`~..resilience.FaultSpec` ``key`` can
        target one tenant; un-prefixed patterns keep matching through the
        base label (``FaultPlan.check``).
    exec_cache : an :class:`ExecutableCache` of the strategy's built
        functions to share with other engines of equal
        :meth:`exec_signature` (default: a private one). The functions hold
        no A; the programs over A, and their CUDA graphs, stay this
        engine's own.
    residency_listener : ``callable(delta_bytes, reason)`` called after
        every change of :attr:`device_resident_bytes` — ``"resident"`` (the
        payload placed), ``"released"``, ``"native_fallback"`` (the
        ladder's native safe tier placed) or ``"reshard"`` — once per
        change, and never while an engine lock is held. The registry's
        device-memory ledger charges through it.

    The JAX package's ``trace_capacity`` and ``timeline`` raise
    ``ConfigError``.
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
        retain_host: bool = False,
        trace_jsonl: str | None = None,
        fault_plan: FaultPlan | None = None,
        integrity_gate: bool = False,
        resilience: ResiliencePolicy | None = None,
        defer_placement: bool = False,
        label_prefix: str = "",
        exec_cache: ExecutableCache | None = None,
        residency_listener: Callable[[int, str], None] | None = None,
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
        if mesh.spans_processes:
            # The engine captures CUDA graphs and serves from threads; the
            # processes' exchanges would need the same requests in the same
            # order on every rank. The multi-process world runs the
            # strategies and the benchmark protocol.
            raise ConfigError(
                "MatvecEngine serves from one process: a mesh over several "
                "processes runs through strategy.build and the benchmark "
                "protocol (bench/timing.py)"
            )
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
        # combine spelling; the requested stages and promotion, which a
        # reshard resolves again against the destination.
        self._requested_combine = combine
        self._requested_stages = stages
        self._requested_promote = promote
        self._matvec_combine, self._gemm_combine = self._resolve_combine(
            combine, self.strategy)
        self.stages = self._resolve_stages(
            stages, self.strategy, (self._matvec_combine, self._gemm_combine))
        self.kernel = kernel
        self.gather_output = gather_output
        self.max_bucket = max_bucket
        bucket_ladder(max_bucket)  # validates
        self.b_star = self._resolve_promotion(promote, self.strategy)
        # Unknown kernel names fail here, not requests deep.
        if self.speculative:
            get_storage_kernel(kernel)  # the candidate's tier
        if self.storage != NATIVE:
            get_storage_kernel(kernel)  # one kernel serves both ranks
        else:
            get_kernel(kernel)
            if self.b_star is not None:
                get_gemm_kernel(kernel if callable(kernel) else gemm_kernel_name_for(kernel))
        if max_in_flight is not None and max_in_flight < 1:
            raise ConfigError(f"max_in_flight must be >= 1, got {max_in_flight}")
        self.max_in_flight = max_in_flight
        self.donate = donate
        self.retain_host = bool(retain_host)
        if defer_placement and not self.retain_host:
            raise ConfigError(
                "defer_placement needs retain_host=True — a deferred "
                "engine has only the host payload to place from"
            )
        self._label_prefix = str(label_prefix)
        self._residency_listener = residency_listener
        # reshard() migrations run one at a time; the commit swaps the
        # layout under _swap_lock, which every dispatch holds while it
        # enqueues, so a dispatch sees the old layout or the new one whole.
        self._reshard_lock = threading.Lock()
        self._swap_lock = threading.RLock()
        self._graph_device = single_cuda_device(mesh.devices)
        self._outstanding: deque = deque()
        # Guards the outstanding window: the scheduler's flusher and its
        # clients' bypasses submit from several threads at once.
        self._outstanding_lock = threading.Lock()
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
        self._c_reshards = self.metrics.counter(
            "engine_reshards_total", "reshard() migrations committed"
        )
        self._c_reshard_bytes = self.metrics.counter(
            "engine_reshard_bytes_total", "bytes reshard() migrations copied"
        )
        self._c_dropped = self.metrics.counter(
            "engine_executables_dropped_total",
            "programs of an old layout dropped by reshard()",
        )
        self._cache = ExecutableCache(
            compile_counter=self.metrics.counter(
                "engine_compiles_total", "executable builds"
            ),
            hit_counter=self.metrics.counter(
                "engine_hits_total", "executable-cache hits"
            ),
        )
        # The strategy's built functions, which hold no A: shared by engines
        # of one exec_signature() (exec_cache=). _cache holds this engine's
        # programs over its own A.
        self._fns = exec_cache if exec_cache is not None else ExecutableCache()
        self.tracer = RequestTracer(
            capacity=TRACE_CAPACITY,
            sink=JsonlSink(trace_jsonl) if trace_jsonl is not None else None,
        )
        # Correlated event timeline (obs/timeline.py), the process hub:
        # always on — an emission is a dict and a deque.append, no host sync.
        self._timeline = get_hub()
        self._fault_plan = fault_plan
        self.integrity_gate = bool(integrity_gate)
        # engine.health()["slo"]'s burn-rate monitor, made on the first
        # health() call so a plain engine's snapshot carries no slo_* names.
        self._slo_monitor = None
        # ---- recovery state (module docstring) ----
        self._resilience = resilience
        self._breakers: dict[ExecKey, CircuitBreaker] = {}
        self._breakers_lock = threading.Lock()
        self._degraded: dict[str, str] = {}  # preferred label -> serving label
        self._retry_serials = itertools.count()
        # Counters exist only where the machinery is configured, so a plain
        # engine's snapshot stays as it was.
        if resilience is not None or fault_plan is not None:
            self._c_faults = self.metrics.counter(
                "resil_faults_injected_total",
                "faults the FaultPlan injected (all kinds)",
            )
            self._c_retries = self.metrics.counter(
                "resil_retries_total",
                "dispatch retries after a retryable fault",
            )
            self._c_downgrades = self.metrics.counter(
                "resil_downgrades_total",
                "dispatches served by a degradation-ladder fallback "
                "(safe combine, shrunken bucket, or GEMV floor)",
            )
            self._c_breaker_opens = self.metrics.counter(
                "resil_breaker_opens_total",
                "circuit-breaker closed/half-open -> open transitions",
            )
            self._c_recoveries = self.metrics.counter(
                "resil_recoveries_total",
                "circuit-breaker half-open -> closed recoveries "
                "(preferred config restored)",
            )
            self._g_breakers_open = self.metrics.gauge(
                "resil_breakers_open",
                "breakers not in the closed state at last health() call",
            )
        else:
            self._c_faults = self._c_retries = self._c_downgrades = None
            self._c_breaker_opens = self._c_recoveries = None
            self._g_breakers_open = None
        self._c_integrity = None
        if self.integrity_gate:
            self._integrity_counter()
        # Every pass on the storage tier asked or tuned for: an "auto" winner
        # degraded at construction, and an armed engine serving an rtol
        # request native (an open breaker, a tolerance under the floor, an
        # injected fault on a speculative key). Made only where a storage
        # was asked for, so a plain engine's snapshot stays as it was.
        if dtype_storage is not None:
            self._c_storage_fallbacks = self.metrics.counter(
                "engine_storage_fallbacks_total",
                "requests (or the construction itself) served native "
                "despite a quantized/speculative storage ask",
            )
            if self.storage_reason == "auto_degraded":
                self._c_storage_fallbacks.inc()
        else:
            self._c_storage_fallbacks = None
        if self.speculative:
            self._c_speculative = self.metrics.counter(
                "engine_speculative_dispatches_total",
                "requests served through the speculative int8c tier "
                "(candidate + fused acceptance check, one program)",
            )
            self._c_escalations = self.metrics.counter(
                "engine_escalations_total",
                "speculative candidates the on-device check rejected "
                "(a native re-dispatch served the request)",
            )
            # A windowed average (tau 60 s), not a lifetime ratio: the cost
            # model's escalation rate follows recent traffic.
            self._g_escalation_rate = self.metrics.ewma_gauge(
                "engine_escalation_rate",
                "escalation EWMA over speculative dispatches (tau=60s), "
                "refreshed at each speculative settlement (the cost "
                "model's epsilon feed)",
            )
        else:
            self._c_speculative = self._c_escalations = None
            self._g_escalation_rate = None
        # The host A (a host tensor is kept by reference): the swap-in
        # source of a releasable native resident, what a requantizing
        # reshard quantizes, and the ladder's native safe tier under
        # quantized storage.
        self._a_host = (
            a.cpu() if self.retain_host or (resilience is not None and self.storage != NATIVE)
            else None
        )
        # The native safe tier of a quantized resident: placed on the first
        # degraded dispatch (_a_for), dropped by reshard and release.
        # _layout_epoch counts committed layouts, so a placement made
        # against an old one is never installed.
        self._a_native: ShardedTensor | None = None
        self._layout_epoch = 0
        self._residency_lock = threading.Lock()
        # Residency changes not yet reported to the listener, and the
        # programs a release dropped, each batch with the fence after which
        # the work queued on them has run.
        self._notes: list[tuple[int, str]] = []
        self._retired: deque = deque()
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
        # The quantized payload and scales on the host: a re-admission
        # places these bytes again instead of quantizing A again.
        self._qa_host = a.to("cpu") if self.retain_host and self.storage != NATIVE else None
        # The speculative set, built once here from the native A: the int8c
        # payload the candidate reads, the probes U and P = U A (float64 on
        # the mesh's first device, stored in the serving dtype). Sized for
        # the tightest eligible tolerance, so one P and U serve every rtol.
        self._spec: tuple | None = None
        self._spec_host: tuple | None = None
        self._spec_probes = self.spec_storage_block = None
        self.spec_resident_bytes = 0
        if self.speculative:
            self._spec_probes = probe_count(SPEC_RTOL_FLOOR)
            dev0 = mesh.devices[0]
            sq = quantize_matrix(a, SPEC_STORAGE,
                                 contraction_shards=self.strategy.contraction_shards(mesh))
            u = probe_matrix(self._spec_probes, self.m, self.dtype).to(dev0)
            pm = project_probes(u, a, self.dtype, device=dev0)
            self.spec_storage_block = sq.block
            # P and U, whose size no layout changes.
            self._spec_aux_bytes = u.numel() * u.element_size() + pm.numel() * pm.element_size()
            self.spec_resident_bytes = int(sq.nbytes + self._spec_aux_bytes)
            self.resident_bytes += self.spec_resident_bytes
            if self.retain_host:
                self._spec_host = (sq.to("cpu"), pm.cpu(), u.cpu())
            if not defer_placement:
                self._spec = self._place_spec(sq, pm, u, self.strategy)
            del sq, pm, u
        # At p=1 on A's own device the shard IS a (or its payload: no
        # copy). A quantized engine drops A here.
        self._a = None if defer_placement else shard_operand(a, spec_a, mesh)
        del a
        self._g_resident = self.metrics.gauge(
            "engine_resident_bytes",
            "device bytes of the resident A operand (payload + scales for "
            "quantized storage, plus the native safe tier once placed)",
        )
        self._g_resident.set(self.device_resident_bytes)
        if self._a is not None:
            self._notes.append((self.device_resident_bytes, "resident"))
        # Info metric: the label set carries the fact, the value is always 1.
        self.metrics.gauge(
            f'engine_storage_format{{format="{self.storage}",'
            f'dtype="{dtype_name(self.dtype)}",reason="{self.storage_reason}"}}',
            "resident-A storage format (info metric; value is always 1)",
        ).set(1)
        self._closed = False
        self._fire_residency_notes()

    # ---- configuration ----

    def _resolve_storage(self, dtype_storage: str | None) -> str:
        """Pin the resident-A storage format at construction, arm the
        speculative tier (``"speculate"``, or a tuned ``speculate`` winner
        under ``"auto"``) and record why (``storage_reason``: ``"default"``,
        ``"explicit"``, ``"tuned"``, ``"auto_miss"`` or ``"auto_degraded"``).
        An explicit format fails loudly when the strategy cannot serve it."""
        self.storage_reason = "default" if dtype_storage is None else "explicit"
        # Armed only here: by an explicit "speculate", or a tuned speculate
        # winner under "auto". The primary residency stays native.
        self.speculative = False
        if dtype_storage == SPECULATE:
            if not self.strategy.storage_combine_ok(None):
                raise ConfigError(
                    f"strategy {self.strategy.name!r} binds an A-tiling "
                    "combine schedule, which cannot compose with the "
                    f"speculative int8c resident (dtype_storage={SPECULATE!r})"
                )
            self.speculative = True
            return NATIVE
        if dtype_storage == "auto":
            from ..tuning import lookup_storage

            decision = lookup_storage(
                strategy=self.strategy.name, m=self.m, k=self.k,
                p=self.mesh.size, dtype=dtype_name(self.dtype),
            )
            self.storage_reason = "tuned" if decision else "auto_miss"
            fmt = (decision or {}).get("storage") or NATIVE
            if fmt == SPECULATE and self.strategy.storage_combine_ok(None):
                self.speculative = True
                return NATIVE
            try:
                fmt = normalize_storage(fmt)
            except ConfigError:
                fmt = None  # a format this build does not know (or speculate)
            if fmt is None or (fmt == "fp8" and not fp8_supported()) or (
                    fmt != NATIVE and not self.strategy.storage_combine_ok(None)):
                self.storage_reason = "auto_degraded"
                return NATIVE
            return fmt
        fmt = normalize_storage(dtype_storage)
        if fmt != NATIVE and not self.strategy.storage_combine_ok(None):
            raise ConfigError(
                f"strategy {self.strategy.name!r} binds an A-tiling combine "
                "schedule, which cannot compose with quantized "
                f"dtype_storage={fmt!r}"
            )
        return fmt

    def _resolve_combine(self, combine: str | None,
                         strategy) -> tuple[str | None, str | None]:
        """Pin the combine schedule of both paths for ``strategy`` (the
        engine's, or a reshard's destination). An explicit name binds the
        matvec path always, and the batched path when the strategy has a
        batched face for it (``pallas_ring`` and the gather family leave it
        on the strategy's default). ``"auto"`` reads the tuning cache once,
        here (``op="matvec"``, ``op="gemm"``): a recorded schedule the
        strategy offers on that path (and, under quantized storage, one
        that does not tile A), else the default (None)."""
        if combine not in (None, "auto") and not strategy.supports_combine(combine):
            # Fail at construction, not requests deep.
            raise ConfigError(
                f"strategy {strategy.name!r} has no combine schedule "
                f"{combine!r}"
            )
        if (self.storage != NATIVE and combine not in (None, "auto")
                and not strategy.storage_combine_ok(combine)):
            raise ConfigError(
                f"combine {combine!r} tiles A inside its schedule body and "
                f"cannot compose with quantized dtype_storage={self.storage!r}"
            )
        if combine == "auto":
            from ..tuning import lookup_combine

            common = dict(strategy=strategy.name, m=self.m, k=self.k,
                          p=self.mesh.size, dtype=dtype_name(self.dtype))
            mv = lookup_combine(op="matvec", **common)
            gm = lookup_combine(op="gemm", **common)
            if mv not in strategy.combine_candidates(self.mesh):
                mv = None
            if gm not in strategy.combine_candidates_batched(self.mesh):
                gm = None
            if self.storage != NATIVE:
                mv = None if mv in STORAGE_INCOMPATIBLE_COMBINES else mv
                gm = None if gm in STORAGE_INCOMPATIBLE_COMBINES else gm
            return mv, gm
        if combine is None:
            return None, None
        batched_ok = combine in strategy.combine_candidates_batched(self.mesh)
        return combine, (combine if batched_ok else None)

    def _effective_combine(self, combine: str | None, strategy=None) -> str | None:
        """The schedule a path runs: the resolved name, or the strategy
        instance's own binding (colwise_overlap & co.) when none was given."""
        strategy = self.strategy if strategy is None else strategy
        return combine if combine is not None else strategy.combine

    def _is_overlap(self, combine: str | None, strategy=None) -> bool:
        return self._effective_combine(combine, strategy).startswith("overlap")

    def _resolve_stages(self, stages: int | str | None, strategy,
                        combines: tuple[str | None, str | None]) -> int | None:
        """Pin the overlap stage count S for ``strategy`` running
        ``combines`` (None when no path runs an overlap schedule): the
        explicit int clamped to the shape's ladder, or the tuning cache's
        (the static default on a miss)."""
        if not any(self._is_overlap(c, strategy) for c in combines):
            return None
        return strategy.resolve_stages(
            self.m, self.k, self.mesh, stages,
            strategy.overlap_chunk_devices(self.mesh), self.dtype,
        )

    def _combine_label(self, combine: str | None) -> str | None:
        """The combine identity an executable is cached under: the staged
        schedules embed their pinned S (``overlap@4``), as the JAX engine's
        labels do; a strategy-bound overlap labels the same way."""
        if self.stages is not None and self._is_overlap(combine):
            return f"{self._effective_combine(combine)}@{self.stages}"
        return combine

    def _resolve_promotion(self, promote: str | int | None, strategy) -> int | None:
        """The crossover ``b*`` for ``strategy``: blocks of ``b >= b_star``
        columns take the single-GEMM path; below it, per-column GEMV
        dispatches. None disables promotion entirely."""
        if promote is None:
            return None
        if promote == "auto":
            from ..tuning import lookup_promotion

            decision = lookup_promotion(
                strategy=strategy.name, m=self.m, k=self.k,
                p=self.mesh.size, dtype=dtype_name(self.dtype),
            )
            if decision is None:
                return DEFAULT_PROMOTE_B  # cache miss: the static default
            # A measured "promotion never won" is None, honored as such.
            return decision.get("b_star")
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

    def _program(self, fn: Callable, spec, shape: tuple, storage: str | None = None):
        """The dispatchable program of one key, over the resident A of its
        storage format (``_a_for``): captured on the mesh's one CUDA
        device, else eager. A speculative program takes the speculative set
        and a tolerance scalar of its own on the mesh's first device."""
        storage = self.storage if storage is None else storage
        a, rtol = self._a_for(storage), None
        if storage == SPECULATE:
            rtol = torch.zeros((), dtype=torch.float32, device=self.mesh.devices[0])
            spec_fn = fn

            def fn(ops, x):
                return spec_fn(*ops, x, rtol)
        if self._graph_device is None:
            return _EagerProgram(fn, a, spec, self.mesh, rtol)
        return _CapturedProgram(fn, a, spec, self.mesh, shape, self.dtype,
                                self._graph_device, rtol)

    def _matvec_fn(self) -> Callable:
        return self._fns.get(self._matvec_key(), lambda: self.strategy.build(
            self.mesh, kernel=self.kernel, gather_output=self.gather_output,
            combine=self._matvec_combine, stages=self.stages,
            dtype_storage=self.storage,
        ))

    def _gemm_fn(self, bucket: int) -> Callable:
        return self._fns.get(self._gemm_key(bucket), lambda: self.strategy.build_batched(
            self.mesh, kernel=self.kernel, gather_output=self.gather_output,
            combine=self._gemm_combine, stages=self.stages,
            dtype_storage=self.storage,
        ))

    def _build_matvec(self):
        return self._program(self._matvec_fn(), self._spec_x, (self.k,))

    def _build_gemm(self, bucket: int):
        return self._program(self._gemm_fn(bucket), self._spec_b, (self.k, bucket))

    # ---- the speculative tier: candidate and check in one program, keyed
    # under storage="speculate", so it never collides with the native
    # programs the rtol=None path rides ----

    @staticmethod
    def _spec_combine(combine: str | None) -> str | None:
        """The combine the speculative (quantized) program runs: the
        engine's, unless it tiles A inside its body (the filter quantized
        residency applies), in which case the strategy's default."""
        return None if combine in STORAGE_INCOMPATIBLE_COMBINES else combine

    def _spec_matvec_key(self) -> ExecKey:
        return ExecKey("matvec", self.strategy.name, self._kernel_label(),
                       self._spec_combine(self._matvec_combine), 1,
                       dtype_name(self.dtype), SPECULATE)

    def _spec_gemm_key(self, bucket: int) -> ExecKey:
        return ExecKey("gemm", self.strategy.name, self._kernel_label(),
                       self._spec_combine(self._gemm_combine), bucket,
                       dtype_name(self.dtype), SPECULATE)

    def _spec_fn(self, bucket: int | None = None) -> Callable:
        """The strategy's fused speculative function for the vector face, or
        for a block ``bucket`` (``ops/speculative.py``); it holds no A."""
        key = self._spec_matvec_key() if bucket is None else self._spec_gemm_key(bucket)
        return self._fns.get(key, lambda: build_speculative(
            self.strategy, self.mesh, probes=self._spec_probes, kernel=self.kernel,
            combine=key.combine, stages=None, storage=SPEC_STORAGE,
            gather_output=self.gather_output, b=bucket,
        ))

    def _build_spec(self, bucket: int | None = None):
        if bucket is None:
            return self._program(self._spec_fn(), self._spec_x, (self.k,), SPECULATE)
        return self._program(self._spec_fn(bucket), self._spec_b, (self.k, bucket),
                             SPECULATE)

    def _place_spec(self, sq: QuantizedMatrix, pm: torch.Tensor, u: torch.Tensor,
                    strategy) -> tuple:
        """The speculative set placed for ``strategy``: the int8c payload by
        A's spec, P by :func:`~..ops.speculative.probe_spec`, U on the mesh's
        first device."""
        mesh = self.mesh
        return (shard_operand(sq, strategy.specs(mesh)[0], mesh),
                shard(pm, probe_spec(strategy, mesh), mesh), u.to(mesh.devices[0]))

    # ---- degradation ladders (module docstring) ----
    #
    # A ladder is an ordered list of (ExecKey, builder) config levels for
    # one logical dispatch: the preferred config first, the safe tier
    # (SAFE_KERNEL, the default combine, no stages, NATIVE storage) last.
    # A safe level whose key equals the preferred one is dropped, so an
    # engine already running the safe config has a one-level ladder. As in
    # the JAX package, a strategy instance that binds its own combine
    # (colwise_overlap) keeps that binding under combine=None. Ladders are
    # made per dispatch from the current layout, so a reshard leaves none
    # stale: the whole walk costs 4–7 µs a dispatch on an H100 host
    # (chip_smoke.py, resilient_clean's ladder_host_us). The JAX package
    # memoizes them, but a memo of builders bound to the engine would keep
    # an engine that is dropped without close() in a reference cycle.

    def _build_safe_matvec(self):
        return self._program(self.strategy.build(
            self.mesh, kernel=gemv_acc, gather_output=self.gather_output,
            dtype_storage=NATIVE,
        ), self._spec_x, (self.k,), NATIVE)

    def _build_safe_gemm(self, bucket: int):
        return self._program(self.strategy.build_batched(
            self.mesh, kernel=matmul_acc, gather_output=self.gather_output,
            dtype_storage=NATIVE,
        ), self._spec_b, (self.k, bucket), NATIVE)

    def _safe_key(self, op: str, bucket: int) -> ExecKey:
        return ExecKey(op, self.strategy.name, SAFE_KERNEL, None, bucket,
                       dtype_name(self.dtype), NATIVE)

    @staticmethod
    def _ladder(preferred: tuple, safe: tuple) -> list:
        return [preferred] if safe[0] == preferred[0] else [preferred, safe]

    def _matvec_levels(self) -> list[tuple[ExecKey, Callable]]:
        return self._ladder((self._matvec_key(), self._build_matvec),
                            (self._safe_key("matvec", 1), self._build_safe_matvec))

    def _gemm_levels(self, bucket: int) -> list[tuple[ExecKey, Callable]]:
        return self._ladder(
            (self._gemm_key(bucket), lambda: self._build_gemm(bucket)),
            (self._safe_key("gemm", bucket), lambda: self._build_safe_gemm(bucket)))

    def _solver_levels(self, op: str, bucket: int, restart: int,
                       steps: int) -> list[tuple[ExecKey, Callable]]:
        """The solver's ladder: the engine's preferred tier, combine and
        storage first (the fused step under ``cuda_fused``), then the same
        NATIVE-storage torch-tier floor every other dispatch falls back to
        — a breaker opening on a solver config degrades the solve, never
        refuses it."""
        preferred = self._solver_key(op, bucket)
        safe = self._safe_key(op, bucket)
        return self._ladder(
            (preferred, lambda: self._build_solver(preferred, restart, steps)),
            (safe, lambda: self._build_solver(safe, restart, steps)))

    # ---- residency (engine/registry.py drives it) ----

    @property
    def resident(self) -> bool:
        """True while the payload A operand is placed on the mesh: False
        after :meth:`release_residency` (until the next placement) and after
        :meth:`close`."""
        return self._a is not None

    @property
    def device_resident_bytes(self) -> int:
        """Device bytes this engine's A residencies hold, read off the
        placed tensors: the resident operand while placed (0 once released
        or closed), plus the native safe tier once the ladder has placed
        it. An armed engine's speculative set is placed and released with
        the payload and counts here too."""
        return (_placed_bytes(self._a) + _placed_bytes(self._a_native)
                + _spec_bytes(self._spec))

    def exec_signature(self) -> tuple:
        """Identity of this engine's space of built functions. A strategy's
        function depends on the mesh, the shapes and the configuration,
        never on A's values, so engines of equal signatures may share one
        function cache (``exec_cache=``). The programs over A, and their
        CUDA graphs, are never shared: each engine builds and captures its
        own."""
        return (
            self.mesh, self.strategy.name,
            # The kernel object for callables: two callables that share a
            # __name__ must not share functions.
            self.kernel,
            self._combine_label(self._matvec_combine),
            self._combine_label(self._gemm_combine),
            self.stages, self.m, self.k, dtype_name(self.dtype), self.storage,
            self.storage_block, self.gather_output, self.max_bucket, self.donate,
            # Arming adds the speculative functions; a plain engine's
            # signature is as it was.
        ) + ((SPECULATE, self._spec_probes) if self.speculative else ())

    def prediction_config(self, b: int = 1, rtol: float | None = None) -> dict:
        """The cost model's view of one dispatch through this engine's
        preferred config (``tuning.cost_model.CostModel.predict`` /
        ``predict_admission`` keywords): the resolved combine schedule (the
        strategy's static default when none was pinned) at the bucket a
        ``b``-column request rides (``b >= b*`` promotes to the padded GEMM
        bucket; below it the per-column path dispatches ``b`` single-RHS
        programs, which the caller models as ``b`` sequential ``b=1``
        predictions). A request declaring an eligible ``rtol`` on an armed
        engine prices as ``storage="speculate"``, the two-tier expected cost
        ``T_int8c + T_check + ε·T_native`` (``tuning/cost_model.py``).
        Degradation-ladder fallbacks are not modeled: admission predicts the
        healthy path. An advisory snapshot, read without the engine's locks
        (a racing reshard yields one stale prediction)."""
        gemm = self.b_star is not None and b >= self.b_star
        combine = self._effective_combine(
            self._gemm_combine if gemm else self._matvec_combine)
        if combine is None:
            combine = self.strategy.default_combine(self.mesh)
        return dict(
            strategy=self.strategy.name,
            combine=combine,
            stages=self.stages,
            m=self.m,
            k=self.k,
            p=self.mesh.size,
            dtype=dtype_name(self.dtype),
            b=bucket_for(b, self.max_bucket) if gemm else 1,
            storage=SPECULATE if self.speculative and spec_eligible(rtol) else self.storage,
        )

    def _fire_residency_notes(self) -> None:
        """Report the queued footprint changes: the gauge, then the
        listener, which may take the registry's lock. Called only where no
        engine lock is held, so a listener never waits on a dispatch."""
        if not self._notes:
            return
        with self._residency_lock:
            notes, self._notes = self._notes, []
        self._g_resident.set(self.device_resident_bytes)
        if self._residency_listener is not None:
            for delta, reason in notes:
                if delta:
                    self._residency_listener(delta, reason)

    def _retire(self, programs: list) -> None:
        """Keep dropped programs until the work queued on them has run: an
        eager program lets go of its A at once; a captured graph, which
        holds A's address and not A, is freed after a fence event."""
        for program in programs:
            if isinstance(program, _EagerProgram):
                program.release()
        if self._cuda_devices and programs:
            fence = _Dispatch(self._cuda_devices)
            with self._residency_lock:
                self._retired.append((fence, programs))

    def _sweep_retired(self, wait: bool = False) -> None:
        """Free the retired programs whose fence has completed (all of
        them, waiting, with ``wait``). Never called under
        ``_residency_lock``."""
        done = []
        with self._residency_lock:
            while self._retired and (wait or self._retired[0][0].query()):
                done.append(self._retired.popleft())
        for fence, programs in done:
            fence.synchronize()
            for program in programs:
                if isinstance(program, _CapturedProgram):
                    program.release()

    def ensure_resident(self) -> bool:
        """Place the payload A operand if it is not placed; True when this
        call placed it. The payload is the retained host copy, so a
        re-admission is bitwise the first placement. Race-safe: two
        concurrent callers may both copy, but one installs its copy and
        the listener hears of it once. Raises :class:`ResidencyError` when
        the engine keeps no host payload (``retain_host=False``)."""
        self._check_open()
        try:
            return self._place()
        finally:
            self._fire_residency_notes()

    def _place(self) -> bool:
        """:meth:`ensure_resident` without reporting (a dispatch under
        ``_swap_lock`` reports after it). The copy runs outside
        ``_residency_lock``; a reshard committed meanwhile makes it place
        again in the new layout."""
        if self._a is not None:
            return False
        self._sweep_retired()
        while True:
            epoch = self._layout_epoch
            payload = self._qa_host if self.storage != NATIVE else self._a_host
            if payload is None:
                raise ResidencyError(
                    "resident A was released and the engine retains no host "
                    "payload (construct with retain_host=True for releasable "
                    "residency)"
                )
            strategy = self.strategy
            placed = shard_operand(payload, strategy.specs(self.mesh)[0], self.mesh)
            # The speculative set rides the payload's residency: placed with
            # it from the same host copies, bitwise the first placement.
            spec = self._place_spec(*self._spec_host, strategy) if self.speculative else None
            with self._residency_lock:
                if self._layout_epoch != epoch:
                    continue  # resharded mid-placement: place again
                if self._a is not None:
                    return False  # lost a concurrent placement
                self._a, self._spec = placed, spec
                self._notes.append((_placed_bytes(placed) + _spec_bytes(spec), "resident"))
            return True

    def release_residency(self) -> int:
        """Drop the device residency, the payload, an armed engine's
        speculative set and any placed native safe tier, with every program
        built over them (the speculative captures too); keep the host
        payload for a later :meth:`ensure_resident`. Returns the device
        bytes released. Waits only for a dispatch being enqueued on this
        engine (``_swap_lock``), never for the card: the operands are freed
        at once (the caching allocator reuses their blocks only for later
        work on the same stream), the captured programs once the work
        queued on them has run."""
        if not self.retain_host:
            raise ResidencyError(
                "release_residency needs retain_host=True — without the "
                "host payload the engine could never serve again"
            )
        with self._swap_lock:
            self._sweep_retired()
            with self._residency_lock:
                released = self.device_resident_bytes
                programs = self._cache.clear()
                self._a = self._a_native = self._spec = None
                self._notes.append((-released, "released"))
            self._retire(programs)
        self._fire_residency_notes()
        return released

    def _a_for(self, storage: str):
        """The resident A of one storage format (the dispatch region has
        placed the payload already). The native safe tier of a quantized
        resident is placed from the host copy on the first degraded
        dispatch (the build of a safe-level program) and kept: the device
        memory is spent only once a breaker routes around the quantized
        config. It goes through the engine's own placement
        (``shard_operand`` by the strategy's A spec), counts in
        ``engine_resident_bytes`` and ``device_resident_bytes``, is
        reported to the listener as ``"native_fallback"``, and is not
        installed over a layout a reshard committed meanwhile."""
        if storage == SPECULATE:
            return self._spec
        if storage == self.storage:
            return self._a
        native = self._a_native
        if native is not None:
            return native
        while True:
            epoch = self._layout_epoch
            placed = shard_operand(self._a_host, self.strategy.specs(self.mesh)[0],
                                   self.mesh)
            with self._residency_lock:
                if self._layout_epoch != epoch:
                    continue  # resharded mid-placement: place again
                if self._a_native is None:
                    self._a_native = placed
                    self._notes.append((_placed_bytes(placed), "native_fallback"))
                native = self._a_native
            break
        return native

    # ---- dispatch ----

    def _reclaim(self) -> None:
        """Drop completed dispatches from the outstanding window (a
        non-blocking sweep: ``query`` never waits)."""
        with self._outstanding_lock:
            while self._outstanding and self._outstanding[0].query():
                self._outstanding.popleft()

    def _admit(self) -> None:
        """The backpressure gate: at the high-water mark, even after
        reclaiming completed work, wait for the OLDEST dispatch (drain-
        oldest keeps the stream ordered and the device queue bounded). The
        wait runs outside the window's lock, so concurrent submitters each
        drain their own oldest dispatch."""
        if self.max_in_flight is None:
            return
        self._reclaim()
        while True:
            with self._outstanding_lock:
                if len(self._outstanding) < self.max_in_flight:
                    return
                oldest = self._outstanding.popleft()
            oldest.synchronize()
            self._c_drains.inc()
            self._reclaim()

    def _track(self, dispatch: _Dispatch) -> _Dispatch:
        if self.max_in_flight is not None:
            with self._outstanding_lock:
                self._outstanding.append(dispatch)
        return dispatch

    def _check_faults(self, site: str, key: ExecKey, block=None) -> bool:
        """Consult the fault plan at one site. Error kinds raise here;
        latency stalls here; returns True for a "nan" corruption (the
        caller marks the result part). False = healthy or no plan. A
        tenant-scoped engine presents its prefixed label
        (``tenant-7/op:...``), and un-prefixed patterns still match the
        base label (``FaultPlan.check``)."""
        plan = self._fault_plan
        if plan is None:
            return False
        label = key.label()
        action = plan.check(site, self._label_prefix + label, block=block,
                            base_label=label if self._label_prefix else None)
        if action is None:
            return False
        self._c_faults.inc()
        if action.error is not None:
            raise action.error
        if action.latency_ms > 0:
            time.sleep(action.latency_ms / 1e3)  # an injected straggler
            return False
        return action.corrupt

    def _run(self, key: ExecKey, build, rhs: torch.Tensor, trace: ActiveTrace,
             call: Callable | None = None, **span_attrs) -> tuple:
        """One program's dispatch at one config level (the caller holds
        ``_swap_lock``): the build site's fault check for a key not built
        yet (before any capture begins), the lookup (build and capture on a
        miss; a build that raises leaves nothing in the cache, so a retry
        builds again) under its ``exec_lookup`` span, the dispatch site's
        fault check on the host payload, then ``call(program)`` (default
        ``program(rhs)``) under its ``dispatch`` span. A
        ``torch.cuda.OutOfMemoryError`` in the build or the dispatch raises
        ``ResourceExhaustedError``. Every fault check runs before the
        payload is staged, so a retry stages it once."""
        if self._fault_plan is not None and key not in self._cache:
            self._check_faults("compile", key)
        with trace.span("exec_lookup") as span:
            before = self._cache.stats.compiles
            with out_of_memory_as_exhausted(f"the build of {key.label()}"):
                program = self._cache.get(key, build)
            span.attrs = {"outcome": "compile" if self._cache.stats.compiles > before
                          else "hit"}
        corrupt = self._check_faults("dispatch", key, block=rhs)
        self._c_dispatches.inc()
        with trace.span("dispatch", **span_attrs), \
                out_of_memory_as_exhausted(f"the dispatch of {key.label()}"):
            out = program(rhs) if call is None else call(program)
        return out, self._track(_Dispatch(self._cuda_devices)), corrupt

    def _dispatch_matvec(self, col: torch.Tensor, trace: ActiveTrace) -> tuple:
        """One column -> one result part ``(output, None, dispatch, corrupt)``."""
        if self._resilience is None:
            out, dispatch, corrupt = self._run(self._matvec_key(), self._build_matvec,
                                               col, trace, op="matvec")
        else:
            out, dispatch, corrupt = self._walk_ladder(
                self._matvec_levels(),
                lambda key, build: self._run(key, build, col, trace, op="matvec"))
        return out, None, dispatch, corrupt

    def _dispatch_block(self, chunk: torch.Tensor, trace: ActiveTrace) -> list:
        """One <= max_bucket-wide chunk -> its result parts: one
        bucket-padded GEMM part, or under a recovery policy several (halved
        buckets on resource exhaustion, or the per-column GEMV floor when
        every GEMM level failed).

        Payload faults walk the same ladder and floor: a fault scoped to
        the GEMM keys is served by the GEMV floor, so the walk cannot stop
        at ``is_payload_fault`` alone (the error does not say which keys its
        spec matches); an unscoped poison still fails the chunk, loudly. A
        real error other than exhaustion raises (``_walk_ladder``)."""
        width = chunk.shape[1]
        bucket = bucket_for(width, self.max_bucket)
        with trace.span("bucket_pad", width=width, bucket=bucket):
            padded = pad_columns(chunk, bucket)
        if self._resilience is None:
            out, dispatch, corrupt = self._run(
                self._gemm_key(bucket), lambda: self._build_gemm(bucket), padded,
                trace, op="gemm", bucket=bucket)
            return [(out, width, dispatch, corrupt)]
        try:
            out, dispatch, corrupt = self._walk_ladder(
                self._gemm_levels(bucket),
                lambda key, build: self._run(key, build, padded, trace, op="gemm",
                                             bucket=bucket))
            return [(out, width, dispatch, corrupt)]
        except Exception as exc:
            _, exhausted = classify_failure(exc)
            if not (exhausted or is_injected(exc)):
                raise
            self._c_downgrades.inc()
            if exhausted and width > 1:
                # Too big at this width: halve it, each half entering the
                # ladder at its own bucket.
                mid = (width + 1) // 2
                return (self._dispatch_block(chunk[:, :mid], trace)
                        + self._dispatch_block(chunk[:, mid:], trace))
            # The GEMV floor: the promotion itself degrades, the chunk
            # served column by column through the matvec ladder.
            return [self._dispatch_matvec(chunk[:, j].contiguous(), trace)
                    for j in range(width)]

    # ---- resilient dispatch: retries, breakers, the ladder ----

    def _breaker_for(self, key: ExecKey) -> CircuitBreaker:
        br = self._breakers.get(key)
        if br is None:
            with self._breakers_lock:
                br = self._breakers.get(key)
                if br is None:
                    # The transition callbacks stay lock-free: one counter
                    # inc and one timeline append. The event carries
                    # cause_id: a state transition is a consequence of the
                    # request whose dispatch tripped it. They hold the
                    # counters and the hub, not the engine (no cycle).
                    label = key.label()
                    opens, recoveries = self._c_breaker_opens, self._c_recoveries
                    timeline = self._timeline

                    def opened():
                        opens.inc()
                        timeline.emit("breaker_open", cause_id=bound_request_id(), key=label)

                    def recovered():
                        recoveries.inc()
                        timeline.emit("breaker_close", cause_id=bound_request_id(), key=label)

                    br = self._resilience.make_breaker(on_open=opened, on_close=recovered)
                    self._breakers[key] = br
        return br

    def _attempt_with_retry(self, key: ExecKey, build, attempt: Callable):
        """One ladder level, with bounded backoff retries for retryable
        faults. Non-retryable ones — build failures, resource exhaustion,
        poisoned payloads, CUDA errors — raise on the first attempt, to the
        ladder (an injected fault), the bucket halving (exhaustion) or the
        caller (a real error). The backoff sleeps on
        the dispatch thread under the swap fence, so a retry sees the
        layout its first attempt saw (bounded by ``max_backoff_ms``)."""
        retry = self._resilience.retry
        serial = next(self._retry_serials)
        n = 1
        while True:
            try:
                return attempt(key, build)
            except Exception as exc:
                retryable, _ = classify_failure(exc)
                if not retryable or n >= retry.max_attempts:
                    raise
                self._c_retries.inc()
                # Correlated by the request id submit() bound.
                self._timeline.emit("retry", key=key.label(), attempt=n,
                                    fault=type(exc).__name__)
                self._resilience.sleep(retry.delay_s(serial, n))
                n += 1

    def _walk_ladder(self, levels: list, attempt: Callable):
        """Serve one dispatch from the first ladder level whose breaker
        admits it and whose attempt succeeds. The floor level is always
        attempted when reached — an open breaker degrades a request, never
        refuses it. Only an injected fault moves the walk down a level:
        resource exhaustion propagates at once (the fix is a smaller
        program: the caller's halving), and a real error — a hand-written
        kernel's failed build or launch, a real out-of-memory error —
        leaves the ladder without feeding the breaker, so no later request
        skips the kernel for it either. Payload faults are the request's
        fault, not the config's: they never feed the breaker."""
        preferred_label = levels[0][0].label()
        for i, (key, build) in enumerate(levels):
            breaker = self._breaker_for(key)
            if not breaker.allow() and i < len(levels) - 1:
                continue
            try:
                out = self._attempt_with_retry(key, build, attempt)
            except Exception as exc:
                injected = is_injected(exc)
                if injected and not is_payload_fault(exc):
                    breaker.record_failure()
                else:
                    breaker.record_inconclusive()
                if not injected or classify_failure(exc)[1] or i == len(levels) - 1:
                    raise  # a real error, the caller's halving, or the floor's
                continue
            breaker.record_success()
            with self._breakers_lock:  # health() copies _degraded under it
                if i == 0:
                    self._degraded.pop(preferred_label, None)
                else:
                    self._degraded[preferred_label] = key.label()
            if i > 0:
                self._c_downgrades.inc()
                self._timeline.emit("degrade", preferred=preferred_label,
                                    served=key.label(), level=i)
            return out

    def _start_trace(self, **attrs) -> ActiveTrace:
        """Open a request's trace under its correlation id: the one bound
        by a caller above (the scheduler's), else a fresh one from the
        process counter the scheduler also draws from."""
        if bound_request_id() is None:
            with bind_request(next_request_id()):
                return self.tracer.start(**attrs)
        return self.tracer.start(**attrs)

    def _integrity_counter(self):
        """The integrity-failure counter, made on first use (a
        ``submit(integrity=True)`` on an engine without the gate counts
        too)."""
        if self._c_integrity is None:
            self._c_integrity = self.metrics.counter(
                "engine_integrity_failures_total",
                "materializations the NaN/Inf integrity gate refused",
            )
        return self._c_integrity

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

        ``integrity``: per-request override of the engine's NaN/Inf
        integrity gate (None = the engine default). The batching scheduler
        passes False and gates each coalesced request's own slice instead,
        so one corrupt column cannot fail its batchmates.

        A dispatch that fails (an injected fault, a device error, or
        ``ResourceExhaustedError`` for a ``torch.cuda.OutOfMemoryError``)
        raises out of this call after finishing the request's trace with
        ``status=dispatch_failed``, emitting ``dispatch_failed`` on the
        timeline and counting ``engine_dispatch_failures_total``.

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
        its end (module docstring).

        ``rtol`` on a matvec request is the speculative contract: the caller
        declares a relative tolerance, and an armed engine
        (``dtype_storage="speculate"``) serves the int8c candidate with its
        acceptance check in one program, the verdict settling at
        ``result()`` (a miss is a native re-dispatch there, bitwise the
        plain engine's answer). Such a future always refuses a non-finite
        result. ``rtol=None`` (the default) is the exact native path; an
        unarmed engine serves an ``rtol`` request native too, and a
        non-positive ``rtol`` raises ``ConfigError``.
        """
        self._check_open()
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
        x = _as_tensor(x)
        if not self.donate and x.device.type != "cpu":
            x = x.clone()  # the caller keeps its buffer
        x = x.to(self.dtype)
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
        spec_rtol = self._spec_admit(rtol)
        cols = 1 if x.dim() == 1 else int(x.shape[1])
        shape = "vector" if x.dim() == 1 else "block"
        trace = self._start_trace(cols=cols, kind=shape)
        self._timeline.emit("submit", request_id=trace.request_id, cols=cols,
                            shape=shape)

        def expired() -> bool:
            return deadline_ms is not None and (time.monotonic() - t0) * 1e3 > deadline_ms

        def fail() -> MatvecFuture:
            self._c_deadline_failures.inc()
            trace.finish(status="deadline_failed")
            self._timeline.emit("deadline_failed", request_id=trace.request_id,
                                deadline_ms=deadline_ms)
            self._h_submit.observe((time.perf_counter() - t0_perf) * 1e3)
            return MatvecFuture.failed(DeadlineExceededError(
                f"request deadline of {deadline_ms} ms elapsed in the "
                "backpressure gate before dispatch"
            ), trace=trace)

        gate = self.integrity_gate if integrity is None else bool(integrity)
        # A speculative answer is refused when non-finite whatever the gate
        # says: the caller declared a tolerance, so a poisoned candidate
        # fails typed and is never served within it.
        integrity_counter = self._integrity_counter() if gate or spec_rtol is not None else None
        # The binding correlates everything emitted from inside the
        # dispatch with this request.
        with bind_request(trace.request_id), trace.span("submit"):
            if deadline_ms is not None and deadline_ms <= 0:
                return fail()  # stale on arrival: skip even the drain
            with trace.span("gate", max_in_flight=self.max_in_flight):
                self._admit()  # may block draining the oldest dispatch
            if expired():
                return fail()
            try:
                with self._swap_lock:
                    # The self-heal: a released A is placed again before any
                    # program is looked up.
                    self._place()
                    parts = self._dispatch_request(x, trace, spec_rtol)
            except BaseException as exc:
                self._c_dispatch_failures.inc()
                trace.finish(status="dispatch_failed")
                self._timeline.emit("dispatch_failed", request_id=trace.request_id,
                                    error=type(exc).__name__)
                self._h_submit.observe((time.perf_counter() - t0_perf) * 1e3)
                raise
            finally:
                self._fire_residency_notes()
            fut = MatvecFuture(parts, vector=x.dim() == 1,
                               materialize_hist=self._h_materialize, trace=trace,
                               integrity_counter=integrity_counter,
                               timeline=self._timeline)
            self._h_submit.observe((time.perf_counter() - t0_perf) * 1e3)
            return fut

    def _dispatch_request(self, x: torch.Tensor, trace: ActiveTrace,
                          spec_rtol: float | None = None) -> list:
        """Enqueue one request's dispatches: one GEMV program per column
        below ``b*``, bucket-padded GEMM blocks from it; through the
        speculative tier when ``spec_rtol`` is set."""
        def column(col):
            if spec_rtol is None:
                return self._dispatch_matvec(col, trace)
            return self._spec_part_matvec(col, spec_rtol, trace)

        if x.dim() == 1:
            self._c_cols.inc()
            return [column(x)]
        b = x.shape[1]
        self._c_cols.inc(b)
        if self.b_star is None or b < self.b_star:
            return [column(x[:, j].contiguous()) for j in range(b)]
        parts, offset = [], 0
        for width in split_widths(b, self.max_bucket):
            chunk = x[:, offset:offset + width]
            parts.extend(self._dispatch_block(chunk, trace) if spec_rtol is None
                         else self._spec_part_block(chunk, spec_rtol, trace))
            offset += width
        return parts

    # ---- speculative dispatch: the int8c candidate first, verified on the
    # card, escalated to native only on a miss ----

    def _spec_allowed(self) -> bool:
        """The speculative breaker's admission: misses feed it at
        settlement, so an escalation storm opens it and the tier stands
        down to native until its cooldown half-opens it. One breaker, the
        matvec speculative key's, governs the tier; without a recovery
        policy the tier is always admitted."""
        if self._resilience is None:
            return True
        return self._breaker_for(self._spec_matvec_key()).allow()

    def _spec_admit(self, rtol: float | None) -> float | None:
        """The tolerance the speculative tier serves a matvec request at,
        or None for native: an armed engine, an eligible tolerance and an
        admitting breaker. A pass on an armed engine counts as a storage
        fallback. A non-positive tolerance raises, armed or not."""
        if rtol is None:
            return None
        rtol = float(rtol)
        if not (rtol > 0.0):
            raise ConfigError(f"rtol must be > 0, got {rtol}")
        if not self.speculative:
            return None
        if not spec_eligible(rtol) or not self._spec_allowed():
            self._c_storage_fallbacks.inc()
            return None
        return rtol

    def _spec_record(self, accepted: bool) -> None:
        """Settlement bookkeeping, on the host at ``result()``: the
        escalation counter, the escalation-rate average the cost model
        reads, and the speculative breaker (a miss is the configuration's
        failure: the quantization budget does not hold for this traffic)."""
        if not accepted:
            self._c_escalations.inc()
        self._g_escalation_rate.observe(0.0 if accepted else 1.0)
        if self._resilience is not None:
            breaker = self._breaker_for(self._spec_matvec_key())
            (breaker.record_success if accepted else breaker.record_failure)()

    def _spec_fallback(self, exc: Exception) -> None:
        """An injected fault on a speculative key (the only error that falls
        back: a real one reaches the caller): fed to the breaker as the
        ladder feeds one, counted as a storage fallback; the request rides
        native."""
        if self._resilience is not None:
            breaker = self._breaker_for(self._spec_matvec_key())
            (breaker.record_inconclusive if is_payload_fault(exc)
             else breaker.record_failure)()
        self._c_storage_fallbacks.inc()

    def _run_spec(self, key: ExecKey, build, rhs: torch.Tensor, rtol: float,
                  trace: ActiveTrace, **span_attrs) -> tuple:
        """One speculative dispatch: candidate and check, one program (one
        replay on one card) with ``rtol`` written into its scalar first.
        Nothing here reads the card."""
        out, dispatch, corrupt = self._run(key, build, rhs, trace,
                                           call=lambda program: program(rhs, rtol),
                                           kind="speculate", **span_attrs)
        self._c_speculative.inc()
        return out, dispatch, corrupt

    def _escalate(self, trace: ActiveTrace, op: str, dispatch: Callable,
                  **fields) -> list:
        """A rejected candidate's native re-dispatch, on the materializing
        thread: under the swap fence like any dispatch (a reshard may have
        committed since the candidate was enqueued), after the self-heal
        placement, in an ``escalate`` span."""
        self._timeline.emit("escalate", op=op, **fields)
        try:
            with self._swap_lock:
                self._place()
                with trace.span("escalate", op=op, kind="escalate"):
                    return dispatch()
        finally:
            self._fire_residency_notes()

    def _spec_part_matvec(self, col: torch.Tensor, rtol: float,
                          trace: ActiveTrace) -> tuple:
        """One column through the speculative tier -> one part
        ``(candidate, None, dispatch, corrupt, accept, resolve)``;
        ``resolve`` settles it at ``result()``."""
        try:
            (y, _, accept), dispatch, corrupt = self._run_spec(
                self._spec_matvec_key(), self._build_spec, col, rtol, trace, op="matvec")
        except Exception as exc:
            if not is_injected(exc):
                raise
            self._spec_fallback(exc)
            return self._dispatch_matvec(col, trace)

        def resolve(accepted: bool) -> list:
            with bind_request(trace.request_id):
                self._spec_record(accepted)
                if accepted:
                    return []
                return self._escalate(trace, "matvec",
                                      lambda: [self._dispatch_matvec(col, trace)])

        return (y, None, dispatch, corrupt, accept, resolve)

    def _spec_part_block(self, chunk: torch.Tensor, rtol: float,
                         trace: ActiveTrace) -> list:
        """One <= max_bucket-wide chunk through the speculative GEMM face.
        The check accepts only when every column passes (the zero pad
        columns pass), so a miss escalates the whole chunk through the
        native block path."""
        width = chunk.shape[1]
        bucket = bucket_for(width, self.max_bucket)
        with trace.span("bucket_pad", width=width, bucket=bucket):
            padded = pad_columns(chunk, bucket)
        try:
            (y, _, accept), dispatch, corrupt = self._run_spec(
                self._spec_gemm_key(bucket), lambda: self._build_spec(bucket), padded,
                rtol, trace, op="gemm", bucket=bucket)
        except Exception as exc:
            if not is_injected(exc):
                raise
            self._spec_fallback(exc)
            return self._dispatch_block(chunk, trace)

        def resolve(accepted: bool) -> list:
            with bind_request(trace.request_id):
                self._spec_record(accepted)
                if accepted:
                    return []
                return self._escalate(trace, "gemm",
                                      lambda: self._dispatch_block(chunk, trace),
                                      width=width)

        return [(y, width, dispatch, corrupt, accept, resolve)]

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
        errors for an op it does not serve; "auto" takes the tuning cache's
        tier for this op, strategy, shape, mesh size and storage where the
        fused tier serves the op, and the unfused tier on a miss."""
        if self.solver_kernel == "cuda_fused":
            from ..ops.cuda_solver import check_fused_solver

            check_fused_solver(op, self.strategy.name, self._requested_combine, self.mesh)
            return "cuda_fused"
        if self.solver_kernel == "auto":
            from ..ops.cuda_solver import fused_solver_supported
            from ..tuning import lookup_solver_kernel

            if fused_solver_supported(op, self.strategy.name,
                                      self._requested_combine, self.mesh):
                decision = lookup_solver_kernel(
                    op=op, strategy=self.strategy.name, m=self.m, k=self.k,
                    p=self.mesh.size, dtype=dtype_name(self.dtype),
                    storage=self.storage,
                )
                if (decision or {}).get("solver_kernel") == "cuda_fused":
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
        """The solver loop of ``key``: the fused tier (its own combine
        spelling, no stages), the safe tier (SAFE_KERNEL, the default
        combine, NATIVE storage) or the engine's kernel and combine."""
        if key.kernel == "cuda_fused":
            kernel, combine, stages = "cuda_fused", self._requested_combine, None
        elif key == self._safe_key(key.op, key.bucket):
            kernel, combine, stages = SAFE_KERNEL, None, None
        else:
            kernel, combine, stages = self.kernel, self._matvec_combine, self.stages
        return build_solver(
            key.op, self.strategy, self.mesh, dtype=self.dtype, kernel=kernel,
            combine=combine, stages=stages, dtype_storage=key.storage,
            restart=restart, steps=steps,
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
        trace = self._start_trace(cols=1, kind=op)
        self._timeline.emit("submit", request_id=trace.request_id, cols=1, op=op)

        def expired() -> bool:
            return deadline_ms is not None and (time.monotonic() - t0) * 1e3 > deadline_ms

        def fail() -> SolverFuture:
            self._c_deadline_failures.inc()
            trace.finish(status="deadline_failed")
            self._timeline.emit("deadline_failed", request_id=trace.request_id,
                                deadline_ms=deadline_ms)
            self._h_submit.observe((time.perf_counter() - t0_perf) * 1e3)
            return SolverFuture.failed(DeadlineExceededError(
                f"request deadline of {deadline_ms} ms elapsed in the "
                "backpressure gate before dispatch"
            ), trace=trace)

        with bind_request(trace.request_id), trace.span("submit"):
            if deadline_ms is not None and deadline_ms <= 0:
                return fail()
            with trace.span("gate", max_in_flight=self.max_in_flight):
                self._admit()
            if expired():
                return fail()
            try:
                self._c_cols.inc()
                with self._swap_lock:
                    self._place()

                    def attempt(key, build):
                        return self._run(
                            key, build, rhs, trace, op=op, bucket=bucket,
                            call=lambda fn: fn(self._a_for(key.storage),
                                               rhs.to(self.mesh.devices[0]),
                                               rtol, maxiter, lo, hi))

                    if self._resilience is None:
                        key = self._solver_key(op, bucket)
                        res, dispatch, corrupt = attempt(
                            key, lambda: self._build_solver(key, restart, steps))
                    else:
                        res, dispatch, corrupt = self._walk_ladder(
                            self._solver_levels(op, bucket, restart, steps), attempt)
            except BaseException as exc:
                self._c_dispatch_failures.inc()
                trace.finish(status="dispatch_failed")
                self._timeline.emit("dispatch_failed", request_id=trace.request_id,
                                    error=type(exc).__name__)
                self._h_submit.observe((time.perf_counter() - t0_perf) * 1e3)
                raise
            finally:
                self._fire_residency_notes()
            fut = SolverFuture(
                res, op=op, rtol=rtol, cap=steps if op == "lanczos" else maxiter,
                dispatch=dispatch, materialize_hist=self._h_materialize,
                iter_hist=iter_hist, divergence_counter=c_div,
                residual_gauge=g_resid, iter_time_hist=iter_time_hist,
                submit_t0=t0_perf, trace=trace, corrupt=corrupt,
                integrity_counter=(self._integrity_counter()
                                   if self.integrity_gate else None),
                timeline=self._timeline,
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
        widths take the per-column path and build no GEMM bucket). On one
        CUDA device each build captures its program's graph. Returns the
        number of fresh builds. An engine whose A is not placed (deferred,
        or released) places nothing here: it builds the strategy's
        functions only, which hold no A, and returns how many it built; its
        programs are built at the first dispatch after a placement. An armed
        engine warms both tiers, the speculative programs beside the native
        ones, so a mixed stream of exact and ``rtol`` requests, escalations
        included, builds nothing after it."""
        self._check_open()
        with self._swap_lock:
            if self._a is None:
                before = self._fns.stats.compiles
                self._warmup(widths, self._matvec_fn, self._gemm_fn, self._spec_fn)
                return self._fns.stats.compiles - before
            before = self._cache.stats.compiles

            def spec(bucket=None):
                key = self._spec_matvec_key() if bucket is None else self._spec_gemm_key(bucket)
                self._cache.get(key, lambda: self._build_spec(bucket))

            self._warmup(widths, lambda: self._cache.get(self._matvec_key(),
                                                         self._build_matvec),
                         lambda bucket: self._cache.get(
                             self._gemm_key(bucket), lambda: self._build_gemm(bucket)),
                         spec)
            return self._cache.stats.compiles - before

    def _warmup(self, widths: Sequence[int] | None, matvec: Callable,
                gemm: Callable, spec: Callable) -> None:
        matvec()
        if self.speculative:
            spec()
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
                gemm(bucket)
                if self.speculative:
                    spec(bucket)

    # ---- online reshard ----

    def reshard(self, strategy, *, warm_widths: Sequence[int] | None = None) -> dict:
        """Migrate the resident operand to another strategy in place: the
        payload, and a quantized resident's payload and scales, move between
        layouts by the ``all_to_all``/``ppermute`` program of
        ``parallel/reshard.py``, and the configuration (combine, stages,
        ``b*``) resolves against the destination as a fresh construction's
        would. The migrated resident is bitwise what a fresh engine in the
        destination layout holds, shard for shard.

        A quantized resident's scales move with the payload when the block
        size (a function of k and the contraction shards) is the same in
        both layouts; where the destination changes it, A is quantized
        again from the host copy ``retain_host=True`` keeps (without one,
        ``ConfigError``).

        **The fence.** The destination's configuration is resolved and the
        migration built while the old layout still serves (a failure there
        leaves the engine as it was); the commit swaps the layout under
        ``_swap_lock``, which
        every dispatch holds while it enqueues, so a dispatch runs on the
        old layout or the new one, whole. The commit drops every program of
        the executable cache (each closes over the old shards: a captured
        graph holds their addresses, a solver's device-loop state its
        operand), counted in ``engine_executables_dropped_total``; builds
        after it count as compiles. The old shards and programs are
        released only after an event recorded at the commit has completed,
        so no dispatch queued on the old layout reads freed memory.

        A released engine reshards its configuration only: the next
        placement is in the destination layout. A release that lands
        during a migration aborts the migrated copy at the commit (the
        configuration still moves), so the device never holds two
        footprints; the next dispatch places A again in the destination
        layout.

        Returns ``{src, dst, migrated, aborted, requantized, bytes_moved}``:
        ``bytes_moved`` is what the program copied (``copy_bytes``: 0 for a
        requantization, an abort, a released engine, or where every step
        is a reordering of shards on one card); ``migrated`` is True where
        a placed resident moved, ``aborted`` where a release during the
        migration dropped the copy. ``warm_widths`` forwards to
        :meth:`warmup` after the commit, so the destination's programs are
        built off the request path.
        """
        self._check_open()
        from ..parallel.reshard import (
            RESHARD_STRATEGIES,
            build_reshard,
            copy_bytes,
            validate_reshard,
        )

        dst = get_strategy(strategy) if isinstance(strategy, str) else strategy
        with self._reshard_lock:
            src = self.strategy
            result = dict(src=src.name, dst=dst.name, migrated=False,
                          aborted=False, requantized=False, bytes_moved=0)
            if dst.name == src.name:
                return result
            for name in (src.name, dst.name):
                if name not in RESHARD_STRATEGIES:
                    raise ConfigError(
                        f"online reshard covers {RESHARD_STRATEGIES}; "
                        f"asked for {src.name!r} -> {dst.name!r}"
                    )
            mesh = self.mesh
            dst.validate(self.m, self.k, mesh)
            validate_reshard((self.m, self.k), mesh)
            if (self.storage != NATIVE or self.speculative) and not dst.storage_combine_ok(None):
                raise ConfigError(
                    f"strategy {dst.name!r} binds an A-tiling combine and "
                    f"cannot host the quantized resident (storage="
                    f"{SPECULATE if self.speculative else self.storage!r})"
                )
            # An explicit combine with no spelling in the destination falls
            # back to the static default: a reshard never fails over a name.
            req = self._requested_combine
            if req not in (None, "auto") and (
                not dst.supports_combine(req)
                or (self.storage != NATIVE and not dst.storage_combine_ok(req))
            ):
                req = None
            # The destination's configuration, planned before anything is
            # committed: a resolver that raises leaves the engine as it was.
            combines = self._resolve_combine(req, dst)
            stages = self._resolve_stages(self._requested_stages, dst, combines)
            b_star = self._resolve_promotion(self._requested_promote, dst)

            # ---- the migration, while the old layout still serves ----
            dst_shards = dst.contraction_shards(mesh)
            requant = None
            if self.storage != NATIVE:
                new_block = default_block(self.k, dst_shards)
                try:
                    if new_block != self.storage_block:
                        raise ConfigError("block→shard mapping changed")
                    validate_reshard((self.m, self.k // new_block), mesh,
                                     what="scales")
                except ConfigError:
                    if self._a_host is None:
                        raise ConfigError(
                            "reshard needs the host A to recompute per-block "
                            "scales, and this engine retains none (construct "
                            "it with retain_host=True)"
                        ) from None
                    requant = quantize_matrix(self._a_host, self.storage,
                                              contraction_shards=dst_shards)
            # An armed engine's int8c payload moves like a quantized
            # resident's (quantized again from the host A where the block
            # changes); P only changes placement (its values are
            # layout-free) and U stays on the first device.
            spec_requant = None
            if self.speculative:
                spec_block = default_block(self.k, dst_shards)
                try:
                    if spec_block != self.spec_storage_block:
                        raise ConfigError("block→shard mapping changed")
                    validate_reshard((self.m, self.k // spec_block), mesh, what="scales")
                except ConfigError:
                    if self._a_host is None:
                        raise ResidencyError(
                            "reshard needs the host A to recompute the "
                            "speculative int8c scales, and this engine retains "
                            "none (construct it with retain_host=True)"
                        ) from None
                    spec_requant = quantize_matrix(self._a_host, SPEC_STORAGE,
                                                   contraction_shards=dst_shards)
            with self._residency_lock:
                src_a, src_spec = self._a, self._spec
            resident = src_a is not None
            new_a, new_spec, bytes_moved = None, None, 0
            if resident and requant is not None:
                new_a = shard_operand(requant, dst.specs(mesh)[0], mesh)
            elif resident:
                new_a = build_reshard(mesh, src.name, dst.name)(src_a)
                bytes_moved = copy_bytes(mesh, src.name, dst.name, src_a)
            if resident and self.speculative:
                src_qa, src_p, u = src_spec
                if spec_requant is not None:
                    new_qa = shard_operand(spec_requant, dst.specs(mesh)[0], mesh)
                else:
                    new_qa = build_reshard(mesh, src.name, dst.name)(src_qa)
                    bytes_moved += copy_bytes(mesh, src.name, dst.name, src_qa)
                new_spec = (new_qa, shard(unshard(src_p), probe_spec(dst, mesh), mesh), u)

            # ---- the commit: the only window a dispatch waits on ----
            with self._swap_lock:
                with self._residency_lock:
                    before = self.device_resident_bytes
                    # Released (or placed again) during the migration: drop
                    # the copy and move the configuration only — never two
                    # footprints. A placement made meanwhile is in the old
                    # layout, so it goes too.
                    aborted = resident and self._a is not src_a
                    if aborted:
                        new_a, new_spec, bytes_moved = None, None, 0
                    # The native safe tier is placed by the old layout: drop
                    # it (a degraded dispatch places it again).
                    old = (self._a, self._cache.clear(), self._a_native, self._spec)
                    self._a, self._a_native, self._spec = new_a, None, new_spec
                    # The layout changes with the epoch, under this lock, so
                    # a placement that read the old epoch places again.
                    self._layout_epoch += 1
                    self.strategy = dst
                    _, self._spec_x, _ = dst.specs(mesh)
                    _, self._spec_b, _ = dst.batched_specs(mesh)
                    if requant is not None:
                        self.storage_block = requant.block
                        self.resident_bytes = requant.nbytes
                        if self.retain_host:
                            self._qa_host = requant.to("cpu")
                    if spec_requant is not None:
                        spec_bytes = int(spec_requant.nbytes + self._spec_aux_bytes)
                        self.resident_bytes += spec_bytes - self.spec_resident_bytes
                        self.spec_resident_bytes = spec_bytes
                        self.spec_storage_block = spec_requant.block
                        if self._spec_host is not None:
                            self._spec_host = (spec_requant.to("cpu"), *self._spec_host[1:])
                    self._matvec_combine, self._gemm_combine = combines
                    self.stages = stages
                    self.b_star = b_star
                    delta = self.device_resident_bytes - before
                    self._notes.append((delta, "reshard"))
                fence = _Dispatch(self._cuda_devices)
            del src_a, new_a, src_spec, new_spec
            self._c_dropped.inc(len(old[1]))
            self._c_reshards.inc()
            self._c_reshard_bytes.inc(bytes_moved)
            result.update(migrated=resident and not aborted, aborted=aborted,
                          requantized=requant is not None,
                          bytes_moved=int(bytes_moved))
            # Release the old layout once the work queued on it is done.
            fence.synchronize()
            del old
        self._fire_residency_notes()
        if warm_widths is not None:
            self.warmup(widths=warm_widths)
        return result

    def health(self) -> dict:
        """Point-in-time recovery snapshot, with the JAX package's keys:
        breaker states per ExecKey, the configs serving degraded (preferred
        label → the fallback label dispatching), fault-injection tallies,
        the recovery counters, the storage section (with
        ``native_fallback_resident``), the tuning cost model's divergence
        signal and the engine-local SLO burn-rate evaluation (``"slo"``:
        each call is one sample, so a polled endpoint accumulates burn
        history). Refreshes the ``resil_breakers_open`` gauge, so a metrics
        snapshot taken after it agrees. Host bookkeeping only: a health
        endpoint may poll it."""
        from ..tuning.cost_model import divergence_health

        with self._breakers_lock:
            items = list(self._breakers.items())
            # _walk_ladder mutates _degraded under the same lock.
            degraded = dict(self._degraded)
        breakers = {key.label(): br.snapshot() for key, br in items}
        if self._g_breakers_open is not None:
            self._g_breakers_open.set(
                sum(1 for snap in breakers.values() if snap["state"] != BREAKER_CLOSED))

        def val(counter) -> int:
            return counter.value if counter is not None else 0

        if self._slo_monitor is None:
            self._slo_monitor = SloMonitor(self.metrics, ENGINE_TARGETS)
        self._slo_monitor.sample()
        return {
            "resilience": self._resilience is not None,
            # The tuner's signal, read off the process default registry.
            "cost_model": divergence_health(),
            "slo": self._slo_monitor.evaluate(),
            "integrity_gate": self.integrity_gate,
            "storage": {
                "format": self.storage,
                "reason": self.storage_reason,
                "resident": self.resident,
                "resident_bytes": self.resident_bytes,
                "device_resident_bytes": self.device_resident_bytes,
                "block": self.storage_block,
                # True once the native safe tier is placed: the card then
                # holds both residencies.
                "native_fallback_resident": self._a_native is not None,
                "speculative": self.speculative,
                "escalation_rate": (self._g_escalation_rate.value
                                    if self._g_escalation_rate is not None else 0.0),
            },
            "breakers": breakers,
            "degraded": degraded,
            "fault_injection": (self._fault_plan.summary()
                                if self._fault_plan is not None else None),
            "counters": {
                "retries": val(self._c_retries),
                "downgrades": val(self._c_downgrades),
                "breaker_opens": val(self._c_breaker_opens),
                "recoveries": val(self._c_recoveries),
                "faults_injected": val(self._c_faults),
                "dispatch_failures": self._c_dispatch_failures.value,
                "deadline_failures": self._c_deadline_failures.value,
                "integrity_failures": val(self._c_integrity),
                "storage_fallbacks": val(self._c_storage_fallbacks),
                "speculative_dispatches": val(self._c_speculative),
                "escalations": val(self._c_escalations),
            },
        }

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
            dispatch="eager" if self._graph_device is None else "graph",
            dropped=self._c_dropped.value,
        )

    def flush_traces(self, timeout: float = 5.0) -> bool:
        """Fence the JSONL trace sink: every request finished before this
        call is on disk when it returns True (trivially so without
        ``trace_jsonl``). False means the sink could not confirm (a dead
        writer thread, an unwritable path, or the timeout). Caller and test
        code only — never the dispatch path."""
        return self.tracer.flush(timeout=timeout)

    def close(self) -> None:
        """Release the trace sink (writer thread and file) after draining
        it, drop the outstanding-dispatch references (the device work
        itself cannot be cancelled), and release the engine's memory once
        the work already queued has run: the resident A, the native safe
        tier, the host copy and every built program (a captured one's
        graph and buffers). Device memory so never waits on the last
        reference to the engine: a failed request's error, which holds the
        frames it passed, may outlive it. Futures already returned keep
        their results; a later ``submit``, ``warmup`` or ``reshard``
        raises ``ConfigError``. Idempotent; the sink is released even when
        the drain cannot confirm."""
        if self._closed:
            return
        self._closed = True
        with self._outstanding_lock:
            self._outstanding.clear()
        try:
            self.flush_traces()
        finally:
            self.tracer.close()
            with self._swap_lock:
                _Dispatch(self._cuda_devices).synchronize()
                self._sweep_retired(wait=True)
                with self._residency_lock:
                    for program in self._cache.clear():
                        if isinstance(program, (_EagerProgram, _CapturedProgram)):
                            program.release()
                    self._a = self._a_native = self._a_host = self._qa_host = None
                    self._spec = self._spec_host = None

    def _check_open(self) -> None:
        if self._closed:
            raise ConfigError("this engine is closed: its resident A is released")

    @property
    def n_executables(self) -> int:
        return len(self._cache)
