"""Arrival-window batching scheduler: continuous batching for the engine.

The port's counterpart of the JAX package's ``engine/scheduler.py``.
``MatvecEngine.submit`` dispatches each request alone; under heavy
single-column traffic every dispatch reads all of ``A`` for one column of
output, so the stream is bound by HBM bandwidth at 1× amortization. This
module coalesces *concurrent* requests against the same resident ``A`` into
one column-stacked dispatch through the engine's bucket ladder: ``b``
requests per dispatch read A once (the hand-written GEMM, ``csrc/gemm.cu``,
from the promotion point ``b*`` on; below it the engine serves the block a
column at a time through the GEMV, ``csrc/gemv.cu``).

Mechanics:

* **arrival window** — the first pending request opens a window; requests
  arriving inside it column-stack into one batch. The window is adaptive:
  sized from an obs :class:`~..obs.registry.RateEstimator` so it stays near
  zero at a low arrival rate (a lone request dispatches at once) and widens
  under load up to ``max_window_ms`` (``window = cap · λ/(1+λ)`` with ``λ``
  the expected arrivals per cap window).
* **three flush triggers**, earliest wins: (1) the window expires; (2) the
  accumulated width reaches the engine's widest bucket (flush at once, on
  the submitting thread: a wider batch only splits); (3) the width reaches
  the tuned promotion point ``b*`` (``tuning.lookup_promotion``, static
  :data:`~.core.DEFAULT_PROMOTE_B` on a miss) AND arrivals pause for
  :data:`SETTLE_MS` — a closed-loop stampede of N clients coalesces into width-N
  batches without waiting out the window.
* **deadline- and priority-aware admission** — each request carries a QoS
  tier (:data:`QOS_TIERS`): ``interactive`` flushes the open window at once,
  ``standard`` rides the adaptive window, ``bulk`` waits the full cap. A
  request whose ``deadline_ms`` cannot survive the current window
  **bypasses coalescing** and dispatches alone (deadline intact); one that
  expires while its window is open fails with :class:`DeadlineExceededError`
  before dispatch and is left out of the batch.
* **per-request unpad** — one flush is ONE engine request: its block is
  column-stacked on the host (one pinned copy to the card in the engine),
  its result is materialized once (one device-to-host copy) and each
  :class:`CoalescedFuture` slices its own columns out of it. Each output
  column is a contraction over its own input column only, and within one
  bucket program the result is position- and pad-independent, so coalesced
  columns are bitwise what the same request gives alone through the same
  bucket.
* **backpressure on whole batches** — a flush is one ``engine.submit``, so
  the engine's ``max_in_flight`` gate counts and drains whole batches.
* **batch bisection** — a flush whose dispatch raises is split in half and
  each half dispatched again (recursively), so only the requests that fail
  ALONE fail their callers. Each half is zero-padded back to the original
  flush's bucket, so a surviving request rides the same captured program
  with the same padded width, bitwise. When
  :data:`SYSTEMIC_FAILURE_THRESHOLD` dispatches of one flush's tree fail
  with no success and the error names no payload
  (``resilience.is_payload_fault``), the failure is declared **systemic**
  and the rest of the batch fails at once. Failures go to the callers:
  nothing is run again on the plain version or on the CPU. With the
  engine's integrity gate on, the scheduler applies it **per request
  slice**, so one corrupt column fails one caller, not the batch.

Threading: all pending state lives under one condition variable; a flush
*swaps the batch out* under it and dispatches after releasing it, so the
engine's dispatch (which may block in the backpressure drain) never holds
it against new arrivals. A flush plans its members, pad target and ids
before it changes anything. The flusher thread exists for window expiry;
width and interactive flushes dispatch on the submitting thread. The
flusher may meet a bucket whose program is not captured yet: the capture
runs under the engine's ``_swap_lock`` with CUDA's thread-local capture
mode (``ops/graphs.py``), so client threads copying results to the host or
querying events meanwhile neither end it nor fail.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import torch

from ..obs.timeline import bind_request, next_request_id
from ..resilience.faults import is_payload_fault, refuse_nonfinite
from ..utils.convert import dtype_name, from_numpy
from ..utils.errors import ConfigError, DeadlineExceededError
from .buckets import bucket_for, split_widths
from .core import DEFAULT_PROMOTE_B, MatvecEngine, MatvecFuture

# QoS tiers, most to least latency-sensitive. interactive: flush the open
# window now; standard: adaptive window; bulk: full window cap.
QOS_TIERS = ("interactive", "standard", "bulk")

# Widest coalescing window the adaptive sizing may reach (and the fixed
# window bulk requests wait).
DEFAULT_MAX_WINDOW_MS = 2.0

# Batch-width histogram buckets (requests per flush, not milliseconds).
WIDTH_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256)

# The arrival lull that flushes a batch already at or above flush_width:
# long enough that a thread stampede lands whole, short next to any window.
SETTLE_MS = 0.2

# Slack added to the current window when deciding whether a request's
# deadline can survive coalescing (a deadline inside window + margin
# bypasses the window).
BYPASS_MARGIN_MS = 0.2

# Time constant of the arrival-rate EWMA the adaptive window reads.
RATE_TAU_S = 0.25

# Bisection's systemic-failure escape: once this many dispatches of one
# flush's tree have failed with ZERO successes (the offered flush and both
# halves) and the error is not payload-scoped, the backend is at fault, not
# a request; the rest of the batch fails at once.
SYSTEMIC_FAILURE_THRESHOLD = 3


class _SharedResult:
    """One flush's materialization, shared by every request in the batch:
    the first ``value()`` caller copies the engine future's block to the
    host (the flush's one device-to-host copy); siblings wait on the same
    lock and read the cached host tensor."""

    __slots__ = ("_future", "_lock", "_value", "_error", "_done")

    def __init__(self, future: MatvecFuture):
        self._future = future
        self._lock = threading.Lock()
        self._value: torch.Tensor | None = None
        self._error: Exception | None = None
        self._done = False

    def done(self) -> bool:
        return self._future.done()

    def value(self) -> torch.Tensor:
        with self._lock:
            if not self._done:
                try:
                    self._value = self._future.result()  # callback-ok: materialize-once latch by design: the engine future's result() fires no scheduler or registry callback
                except Exception as e:  # a device error reaches every waiter
                    self._error = e
                self._done = True
            if self._error is not None:
                raise self._error
            return self._value


class CoalescedFuture:
    """Async handle to one scheduled request's result.

    Mirrors the :class:`~.core.MatvecFuture` face (``result`` / ``done`` /
    ``exception``) and resolves one of three ways: sliced out of a coalesced
    batch's shared result, adopted from a bypass dispatch's own engine
    future, or failed (deadline expired before dispatch, or a dispatch
    failure bisection pinned on it). ``result()`` returns a CPU tensor.

    Batch-placement metadata (``offset``, ``width``, ``batch_width``,
    ``coalesced``) is exposed for introspection and the exactness tests —
    ``None``/``False`` until resolution, and for adopted futures.
    """

    def __init__(self, vector: bool, width: int, integrity_counter=None):
        self._vector = vector
        self.width = width
        self._event = threading.Event()
        self._shared: _SharedResult | None = None
        self._inner: MatvecFuture | None = None
        self._error: Exception | None = None
        self.offset: int | None = None
        self.batch_width: int | None = None
        self.coalesced = False
        # Non-None: apply the NaN/Inf integrity gate to THIS request's slice
        # of the shared result (adopted futures gate inside the engine).
        self._integrity_counter = integrity_counter

    # ---- resolution (scheduler-internal) ----

    def _adopt(self, inner: MatvecFuture) -> None:
        self._inner = inner
        self._event.set()

    def _resolve(self, shared: _SharedResult, offset: int, batch_width: int,
                 n_requests: int) -> None:
        self._shared = shared
        self.offset = offset
        self.batch_width = batch_width
        self.coalesced = n_requests > 1
        self._event.set()

    def _fail(self, error: Exception) -> None:
        self._error = error
        self._event.set()

    # ---- the MatvecFuture face ----

    def done(self) -> bool:
        """True when the result is ready to materialize without waiting for
        the card (a failed future is done by definition); False while the
        request still waits in an open window."""
        if not self._event.is_set():
            return False
        if self._error is not None:
            return True
        if self._inner is not None:
            return self._inner.done()
        return self._shared.done()

    def exception(self) -> Exception | None:
        """The failure this future carries, or None (also while pending)."""
        if self._error is not None:
            return self._error
        if self._inner is not None:
            return self._inner.exception()
        return None

    def result(self, timeout: float | None = None) -> torch.Tensor:
        """Materialize this request's columns: ``(m,)`` for a vector
        request, ``(m, b)`` for a block. Blocks until the window flushes
        (``timeout`` bounds only that wait — ``None`` waits forever) and the
        shared batch result materializes; a failed future raises its
        error."""
        if not self._event.wait(timeout):
            raise TimeoutError(
                "request still pending in the coalescing window after "
                f"{timeout} s (is the scheduler's flusher running?)"
            )
        if self._error is not None:
            raise self._error
        if self._inner is not None:
            return self._inner.result()
        block = self._shared.value()
        if self._vector:
            out = block[:, self.offset].contiguous()
        else:
            out = block[:, self.offset:self.offset + self.width].contiguous()
        if self._integrity_counter is not None:
            # Per-request gate: this caller's columns are corrupt; batchmates
            # with finite slices still succeed. Cached like any failure.
            err = refuse_nonfinite(out, self._integrity_counter,
                                   "this request's slice of the coalesced result")
            if err is not None:
                self._error = err
                raise err
        return out


class _BisectState:
    """Shared across ONE flush's bisection tree: dispatch outcomes so far,
    and the systemic short-circuit (the error every remaining sub-batch is
    failed with once the backend, not a payload, is at fault)."""

    __slots__ = ("failures", "successes", "systemic")

    def __init__(self):
        self.failures = 0
        self.successes = 0
        self.systemic: Exception | None = None


class _Pending:
    """One request waiting in the window: its host block, its absolute
    deadline (scheduler-clock seconds, None = none), its QoS tier, its
    process-unique correlation id (``obs/timeline.py``), and the future its
    batch placement will resolve."""

    __slots__ = ("block", "width", "deadline", "qos", "future", "rid")

    def __init__(self, block, width, deadline, qos, future, rid):
        self.block = block
        self.width = width
        self.deadline = deadline
        self.qos = qos
        self.future = future
        self.rid = rid


class SchedulerStats:
    """Point-in-time view over the scheduler's registry counters."""

    def __init__(self, requests: int, batches: int, coalesced_requests: int,
                 bypass: int, deadline_failures: int, mean_batch_width: float):
        self.requests = requests
        self.batches = batches
        self.coalesced_requests = coalesced_requests
        self.bypass = bypass
        self.deadline_failures = deadline_failures
        self.mean_batch_width = mean_batch_width

    @property
    def coalesce_ratio(self) -> float:
        """Fraction of scheduled requests that shared a dispatch with at
        least one other (NaN before any request)."""
        if self.requests == 0:
            return float("nan")
        return self.coalesced_requests / self.requests


def _host_request(x, dtype: torch.dtype) -> torch.Tensor:
    """A request as a host tensor of the engine's dtype. The scheduler
    stacks requests on the host, so a request already on a card is refused
    (submit it to the engine directly)."""
    if not isinstance(x, torch.Tensor):
        x = from_numpy(np.asarray(x), "cpu")  # tracer-sync-ok: x is no tensor here (the isinstance above)
    if x.device.type != "cpu":
        raise ConfigError(
            f"the scheduler stacks requests on the host; this one is on "
            f"{x.device} (submit it to the engine directly)"
        )
    return x.to(dtype)


class ArrivalWindowScheduler:
    """Coalesce concurrent requests into batched engine dispatches.

    Parameters
    ----------
    engine : the :class:`~.core.MatvecEngine` to dispatch through. The
        scheduler counts into ``engine.metrics`` (one snapshot holds both
        vocabularies) and emits on the engine's event timeline.
    window_ms : ``"auto"`` (adaptive from the arrival-rate estimator, the
        default) or a fixed window in milliseconds (0 = flush every request
        at once unless a partner is already waiting).
    max_window_ms : adaptive-window cap, and the fixed window ``bulk``
        requests wait.
    flush_width : accumulated batch width past which the scheduler stops
        insisting on the window (flush at the first lull):
        ``"auto"`` (the tuned promotion point ``b*``, the static default on a
        cache miss, ``engine.max_bucket`` when promotion measurably never
        won) or an int. Clamped to ``engine.max_bucket``; width reaching
        ``max_bucket`` itself flushes at once, and from ``flush_width`` on a
        lull of :data:`SETTLE_MS` flushes.

    The JAX scheduler's ``settle_ms``, ``bypass_margin_ms`` and
    ``rate_tau_s`` are the constants :data:`SETTLE_MS`,
    :data:`BYPASS_MARGIN_MS` and :data:`RATE_TAU_S` here (no caller sets
    another value), and its ``auto_flush`` and ``clock`` test hooks are not
    parameters: tests monkeypatch ``_flusher_loop`` and ``_clock``.
    """

    def __init__(
        self,
        engine: MatvecEngine,
        *,
        window_ms: str | float = "auto",
        max_window_ms: float = DEFAULT_MAX_WINDOW_MS,
        flush_width: str | int = "auto",
    ):
        self.engine = engine
        if window_ms != "auto":
            window_ms = float(window_ms)
            if window_ms < 0:
                raise ConfigError(f"window_ms must be >= 0, got {window_ms}")
        if max_window_ms < 0:
            raise ConfigError(f"max_window_ms must be >= 0, got {max_window_ms}")
        self._window_ms = window_ms
        self.max_window_ms = float(max_window_ms)
        self.flush_width = self._resolve_flush_width(flush_width)
        self._clock = time.monotonic
        # All pending state lives under this condition variable; a dispatch
        # NEVER runs while it is held.
        self._cond = threading.Condition()
        self._pending: list[_Pending] = []
        self._pending_width = 0
        self._flush_at: float | None = None
        self._last_arrival = 0.0
        self._closed = False

        metrics = engine.metrics
        self._rate = metrics.rate_estimator(
            "sched_arrival_req_per_s", "EWMA request arrival rate at the scheduler",
            tau_s=RATE_TAU_S,
        )
        self._c_requests = metrics.counter("sched_requests_total",
                                           "scheduler submit() calls")
        self._c_batches = metrics.counter("sched_batches_total",
                                          "coalesced batches dispatched")
        self._c_coalesced = metrics.counter(
            "sched_coalesced_requests_total",
            "requests that shared a dispatch with >= 1 other",
        )
        self._c_bypass = metrics.counter(
            "sched_bypass_total",
            "deadline-tight requests dispatched outside the window",
        )
        self._c_deadline_failures = metrics.counter(
            "sched_deadline_failures_total",
            "requests that expired inside an open window (failed before dispatch)",
        )
        self._c_amortized_bytes = metrics.counter(
            "sched_amortized_bytes_total",
            "bytes of A re-read traffic coalescing avoided vs per-request dispatch",
        )
        self._c_bisects = metrics.counter(
            "sched_bisect_splits_total",
            "failed coalesced dispatches split in half for re-dispatch "
            "(blast-radius isolation)",
        )
        self._c_isolated = metrics.counter(
            "sched_isolated_failures_total",
            "requests bisection isolated as genuinely failing (failed alone "
            "after log-depth splits)",
        )
        self._c_batch_failed = metrics.counter(
            "sched_batch_failures_total",
            "requests failed with their whole (sub-)batch when bisection "
            "declared the failure systemic (repeated non-payload dispatch "
            "failures with zero successes)",
        )
        # Per-request integrity gating (CoalescedFuture): the engine gate's
        # counter, one number for "results refused".
        self._integrity_counter = (
            engine._integrity_counter() if engine.integrity_gate else None
        )
        self._h_batch_width = metrics.histogram(
            "sched_batch_width", "columns per coalesced flush", buckets=WIDTH_BUCKETS,
        )
        self._g_window = metrics.gauge(
            "sched_coalesce_window_ms", "coalescing window at the last admission decision",
        )
        # Bytes of A one dispatch reads: the amortization unit.
        self._a_bytes = engine.m * engine.k * engine.dtype.itemsize
        self._timeline = engine._timeline

        self._flusher = threading.Thread(
            target=self._flusher_loop, name="matvec-sched-flusher", daemon=True,
        )
        self._flusher.start()

    # ---- construction-time resolution ----

    def _resolve_flush_width(self, flush_width: str | int) -> int:
        """Pin the early-flush threshold at construction: ``"auto"`` routes
        through the tuned promotion decision (a cold cache takes
        :data:`~.core.DEFAULT_PROMOTE_B`, a measured "promotion never won"
        the widest bucket); always clamped to ``engine.max_bucket``."""
        engine = self.engine
        if flush_width == "auto":
            from ..tuning import lookup_promotion

            decision = lookup_promotion(
                strategy=engine.strategy.name, m=engine.m, k=engine.k,
                p=engine.mesh.size, dtype=dtype_name(engine.dtype),
            )
            if decision is None:  # cold cache: static default
                b_star = DEFAULT_PROMOTE_B
            else:
                b_star = decision.get("b_star")
                if b_star is None:  # measured: promotion never won
                    b_star = engine.max_bucket
            return max(1, min(int(b_star), engine.max_bucket))
        flush_width = int(flush_width)
        if flush_width < 1:
            raise ConfigError(f"flush_width must be >= 1, got {flush_width}")
        return min(flush_width, engine.max_bucket)

    # ---- window sizing ----

    def current_window_ms(self, now: float | None = None) -> float:
        """The coalescing window a standard request arriving now would wait:
        the fixed override, or ``cap · λ/(1+λ)`` with ``λ = rate · cap``."""
        if self._window_ms != "auto":
            return self._window_ms
        if now is None:
            now = self._clock()
        lam = self._rate.rate_per_s(now=now) * (self.max_window_ms / 1e3)
        return self.max_window_ms * lam / (1.0 + lam)

    # ---- admission ----

    def submit(self, x, *, deadline_ms: float | None = None,
               qos: str = "standard") -> CoalescedFuture:
        """Admit one request — a ``(k,)`` vector or ``(k, b)`` block on the
        host (a CPU tensor or a numpy array) — into the coalescing window
        (or past it: see the module docstring). Returns at once unless this
        submission trips a flush, whose dispatch (and any engine
        backpressure it absorbs) then runs on this thread."""
        if qos not in QOS_TIERS:
            raise ConfigError(f"unknown QoS tier {qos!r}; expected one of {QOS_TIERS}")
        if self._closed:  # unguarded-ok: advisory fast-fail; the decisive check repeats under the condition on the queued path
            # Checked again under the condition on the queued path; this
            # early check keeps the refusal uniform across the bypass and
            # stale-on-arrival paths.
            raise ConfigError("scheduler is closed")
        engine = self.engine
        now = self._clock()
        x = _host_request(x, engine.dtype)
        if x.dim() == 1:
            if x.shape[0] != engine.k:
                raise ConfigError(f"request length {x.shape[0]} != A columns {engine.k}")
            vector, block = True, x[:, None]
        elif x.dim() != 2 or x.shape[0] != engine.k:
            raise ConfigError(
                f"request must be (k,) or (k, b) with k={engine.k}; got "
                f"shape {tuple(x.shape)}"
            )
        elif x.shape[1] == 0:
            raise ConfigError("empty request (b=0)")
        else:
            vector, block = False, x
        width = block.shape[1]
        self._c_requests.inc()
        self._rate.observe(now=now)
        fut = CoalescedFuture(vector, width, integrity_counter=self._integrity_counter)
        # Process-unique correlation id, allocated at ADMISSION: every event
        # this request causes below (the engine's dispatch, the batch it
        # coalesces into) shares it.
        rid = next_request_id()
        if deadline_ms is not None and deadline_ms <= 0:
            # Stale on arrival: fail without touching the window or the engine.
            self._c_deadline_failures.inc()
            self._timeline.emit("deadline_failed", request_id=rid,
                                deadline_ms=deadline_ms, at="admission")
            fut._fail(DeadlineExceededError(
                f"request deadline of {deadline_ms} ms elapsed before admission"
            ))
            return fut

        window_ms = self.current_window_ms(now)
        self._g_window.set(window_ms)
        if deadline_ms is not None and deadline_ms <= window_ms + BYPASS_MARGIN_MS:
            # The deadline cannot survive the window: dispatch alone, now,
            # with the deadline intact for the engine's own gate.
            self._c_bypass.inc()
            self._timeline.emit("bypass", request_id=rid, deadline_ms=deadline_ms,
                                window_ms=window_ms)
            with bind_request(rid):
                fut._adopt(engine.submit(x, deadline_ms=deadline_ms))
            return fut

        deadline = now + deadline_ms / 1e3 if deadline_ms is not None else None
        pend = _Pending(block, width, deadline, qos, fut, rid)
        batch = None
        with self._cond:
            if self._closed:
                raise ConfigError("scheduler is closed")
            self._pending.append(pend)
            self._pending_width += width
            self._last_arrival = now
            tier_window_s = (self.max_window_ms if qos == "bulk" else window_ms) / 1e3
            flush_at = now + tier_window_s
            if self._flush_at is None or len(self._pending) == 1:
                self._flush_at = flush_at
            else:
                # A later, more latency-sensitive arrival pulls the batch's
                # flush forward; it never pushes it back.
                self._flush_at = min(self._flush_at, flush_at)
            if deadline is not None:
                # Never *plan* to hold a request past its deadline; the
                # margin leaves room for the dispatch itself.
                self._flush_at = min(self._flush_at, deadline - BYPASS_MARGIN_MS / 1e3)
            if qos == "interactive" or self._pending_width >= engine.max_bucket:
                # Immediate triggers: the latency-sensitive tier, or a batch
                # already at the widest bucket (wider only splits).
                batch = self._take_locked()
            else:
                self._cond.notify_all()  # re-arm the flusher's timer
        if batch is not None:
            self._dispatch(batch)
        return fut

    def __call__(self, x) -> torch.Tensor:
        """Synchronous convenience: ``submit(x).result()``."""
        return self.submit(x).result()

    # ---- flushing ----

    def _take_locked(self) -> list[_Pending] | None:
        """Swap the pending batch out (caller holds the condition). The
        dispatch happens after release — never under the lock."""
        if not self._pending:
            return None
        batch = self._pending
        self._pending = []
        self._pending_width = 0
        self._flush_at = None
        return batch

    def _dispatch(self, batch: list[_Pending]) -> None:
        """Dispatch one swapped-out batch. The plan comes first — which
        requests expired in the window, which are live, the batch's id —
        and only then does anything change: the expired fail (without
        poisoning the rest), the live column-stack into ONE engine request,
        bisecting on failure. Runs with no scheduler lock held. The
        coalescing accounting records the OFFERED flush, unless none of its
        dispatches ran."""
        now = self._clock()
        expired = [p for p in batch if p.deadline is not None and now > p.deadline]
        live = [p for p in batch if p.deadline is None or now <= p.deadline]
        batch_rid = next_request_id() if live else None
        for p in expired:
            self._c_deadline_failures.inc()
            self._timeline.emit("deadline_failed", request_id=p.rid, at="window")
            p.future._fail(DeadlineExceededError(
                "request deadline elapsed inside the coalescing window before dispatch"
            ))
        if not live:
            return
        width = sum(p.width for p in live)
        # The batch gets its OWN correlation id: the flush's engine dispatch
        # correlates to the batch, whose members are on this event.
        self._timeline.emit("coalesce", request_id=batch_rid,
                            members=[p.rid for p in live], width=width)
        if not self._submit_batch(live, pad_to=None, batch_rid=batch_rid):
            return  # no device work ran: nothing was coalesced
        # Accounting after the dispatch, off the flush's critical path.
        self._c_batches.inc()
        self._h_batch_width.observe(width)
        if len(live) > 1:
            self._c_coalesced.inc(len(live))
        saved = sum(self._dispatches_for(p.width) for p in live) - self._dispatches_for(width)
        if saved > 0:
            self._c_amortized_bytes.inc(saved * self._a_bytes)

    def _bisect_pad_target(self, width: int) -> int | None:
        """The bucket a failed flush's halves are zero-padded back to, so
        survivors ride the same program at the same padded width. None when
        the flush did not ride one GEMM bucket (per-column dispatch below
        ``b*`` is position-independent anyway; a flush wider than
        ``max_bucket`` was already split)."""
        engine = self.engine
        if engine.b_star is not None and engine.b_star <= width <= engine.max_bucket:
            return bucket_for(width, engine.max_bucket)
        return None

    def _stack(self, live: list[_Pending], pad_to: int | None) -> torch.Tensor:
        """The batch's host block: its members' columns in arrival order,
        zero-padded to ``pad_to`` columns when given."""
        width = sum(p.width for p in live)
        cols = max(width, pad_to or 0)
        if len(live) == 1 and cols == width:
            return live[0].block
        stacked = torch.zeros((self.engine.k, cols), dtype=live[0].block.dtype)
        offset = 0
        for p in live:
            stacked[:, offset:offset + p.width] = p.block
            offset += p.width
        return stacked

    def _fail_systemic(self, live: list[_Pending], error: Exception,
                       batch_rid: int | None) -> None:
        self._c_batch_failed.inc(len(live))
        self._timeline.emit("batch_failure", cause_id=batch_rid,
                            members=[p.rid for p in live], error=type(error).__name__)
        for p in live:
            p.future._fail(error)

    def _submit_batch(self, live: list[_Pending], pad_to: int | None,
                      state: _BisectState | None = None,
                      batch_rid: int | None = None) -> bool:
        """Dispatch a batch of live requests as one engine submit; on
        failure, bisect and dispatch each half again (log depth) until each
        failing request has failed ALONE. Never raises (a flusher-thread
        dispatch error must land in futures, not kill the thread); returns
        True when at least one dispatch of the batch's tree ran.

        Bisection is for failures a REQUEST causes (a poisoned payload); a
        backend outage fails every dispatch alike, so once
        :data:`SYSTEMIC_FAILURE_THRESHOLD` dispatches have failed with no
        success and the error is not payload-scoped, the remaining requests
        fail together (``sched_batch_failures_total``)."""
        engine = self.engine
        if state is not None and state.systemic is not None:
            self._fail_systemic(live, state.systemic, batch_rid)
            return False
        stacked = self._stack(live, pad_to)
        width = sum(p.width for p in live)
        target = pad_to if pad_to is not None else self._bisect_pad_target(width)
        try:
            # The batch id binds around the dispatch: the engine's trace and
            # events correlate to the batch.
            with bind_request(batch_rid):
                if self._integrity_counter is None:
                    inner = engine.submit(stacked)
                else:
                    # With the gate on, each CoalescedFuture checks its own
                    # slice; the whole-block check would fail batchmates.
                    inner = engine.submit(stacked, integrity=False)
        except Exception as e:
            if state is None:
                state = _BisectState()
            state.failures += 1
            if (state.successes == 0 and state.failures >= SYSTEMIC_FAILURE_THRESHOLD
                    and not is_payload_fault(e)):
                # Every dispatch of this tree failed and nothing points at a
                # payload: the backend is the problem (at a leaf too).
                state.systemic = e
                self._fail_systemic(live, e, batch_rid)
                return False
            if len(live) == 1:
                # Failed alone: genuinely poisoned — this caller's fate.
                self._c_isolated.inc()
                self._timeline.emit("isolated_failure", request_id=live[0].rid,
                                    cause_id=batch_rid, error=type(e).__name__)
                live[0].future._fail(e)
                return False
            self._c_bisects.inc()
            mid = len(live) // 2
            self._timeline.emit("bisect", cause_id=batch_rid,
                                members=[p.rid for p in live], split_at=mid)
            left = self._submit_batch(live[:mid], target, state, batch_rid)
            right = self._submit_batch(live[mid:], target, state, batch_rid)
            return left or right
        if state is not None:
            state.successes += 1
        shared = _SharedResult(inner)
        batch_width = stacked.shape[1]
        offset = 0
        for p in live:
            p.future._resolve(shared, offset, batch_width, len(live))
            offset += p.width
        return True

    def _dispatches_for(self, width: int) -> int:
        """How many programs the engine runs for a block of this width:
        bucketed GEMM chunks at or above ``b*``, per-column GEMVs below."""
        engine = self.engine
        if engine.b_star is not None and width >= engine.b_star:
            return len(split_widths(width, engine.max_bucket))
        return width

    def flush(self) -> int:
        """Flush the open window now (the serve bench fences with it before
        draining). Returns the number of requests dispatched or failed."""
        with self._cond:
            batch = self._take_locked()
        if batch is None:
            return 0
        self._dispatch(batch)
        return len(batch)

    def _flush_due_locked(self, now: float) -> float | None:
        """When the open batch should flush (caller holds the condition):
        the window deadline, pulled forward to the next :data:`SETTLE_MS` lull
        once the width has reached ``flush_width``. None with nothing
        pending."""
        if not self._pending:
            return None
        due = self._flush_at if self._flush_at is not None else now
        if self._pending_width >= self.flush_width:
            due = min(due, self._last_arrival + SETTLE_MS / 1e3)
        return due

    def _flusher_loop(self) -> None:
        """Flush watchdog: dispatches the open batch at its due time. When
        the engine's backpressure gate blocks here, the next whole batch
        accumulates until the oldest drains."""
        while True:
            batch = None
            with self._cond:
                if self._closed:
                    return
                now = self._clock()
                due = self._flush_due_locked(now)
                if due is None:
                    self._cond.wait()
                    continue
                if now < due:
                    self._cond.wait(timeout=due - now)
                    continue
                batch = self._take_locked()
            if batch is not None:
                self._dispatch(batch)

    # ---- lifecycle & introspection ----

    @property
    def stats(self) -> SchedulerStats:
        h = self._h_batch_width
        count = h.count
        return SchedulerStats(
            requests=self._c_requests.value,
            batches=self._c_batches.value,
            coalesced_requests=self._c_coalesced.value,
            bypass=self._c_bypass.value,
            deadline_failures=self._c_deadline_failures.value,
            mean_batch_width=h.sum / count if count else float("nan"),
        )

    @property
    def pending_width(self) -> int:
        """Columns waiting in the open window right now."""
        with self._cond:
            return self._pending_width

    def close(self) -> None:
        """Flush the open window, stop the flusher thread, and refuse
        further submits. Does NOT close the engine (the scheduler is a
        front end; the engine may serve other callers)."""
        with self._cond:
            if self._closed:
                return
            self._closed = True
            batch = self._take_locked()
            self._cond.notify_all()
        if batch is not None:
            self._dispatch(batch)
        self._flusher.join(timeout=5.0)

    def __enter__(self) -> "ArrivalWindowScheduler":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
