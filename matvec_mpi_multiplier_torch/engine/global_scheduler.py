"""Cost-model-driven global scheduler: every decision is a prediction.

The port's counterpart of the JAX package's ``engine/global_scheduler.py``:
a cross-tenant scheduling layer over the :class:`~.registry.MatrixRegistry`
that consults the calibrated :class:`~..tuning.cost_model.CostModel` on
every decision. Four mechanisms:

* **predicted-time admission** — each request's ``deadline_ms`` is checked
  at submit time against the queue-aware ETA for its config
  (:meth:`~..tuning.cost_model.CostModel.predict_admission`: the predicted
  backlog of outstanding dispatches + the restore transfer if the tenant's
  ``A`` is evicted + the dispatch itself). A request that cannot make its
  deadline is **rejected fast** with a typed
  :class:`~..utils.errors.AdmissionRejectedError` (a failed future) instead
  of burning a dispatch slot to expire in the backpressure gate. Admission
  owns the deadline: an admitted request is dispatched without one, so
  deadline-expire after admission is structurally zero.
* **cross-tenant flush interleaving** — ahead of a **predicted-long**
  dispatch the scheduler swaps in the hottest evicted tenant
  (:meth:`~.registry.MatrixRegistry.prefetch`). The port's swap-in is a
  blocking copy on the submitting thread (the registry's doctrine: the
  caching allocator's stream order keeps a freed block from queued work),
  so the swap-in is ordered ahead of the covering dispatch but overlaps
  nothing of it.
* **cross-tenant coalescing** — tenants whose engines share an exec
  signature and payload bytes (``registry.coalesce_group``: the same
  functions over the same ``A``) may share one column-stacked flush;
  per-column results are bitwise those of solo submits. Counted in
  ``sched_cross_tenant_coalesced_total``. Coalescing is opportunistic over
  back-to-back submissions (a group switch, a width threshold, a deadline
  or ``flush()`` closes the open batch; there is no timer thread).
* **demand-aware eviction** — the registry's victim score gains a
  predicted-demand term (``MatrixRegistry(demand_weight=...)``); rejected
  demand still ticks the estimator (``registry.observe_demand``).

With ``reshard="auto"`` the scheduler also migrates a tenant's resident
``A`` to the layout whose predicted dispatch, plus the predicted migration
amortized over the tenant's demand horizon, beats its current one
(``CostModel.predict_reshard``, ``MatrixRegistry.reshard``).

**Every decision explains itself**: admit / reject / interleave / evict /
flush / reshard land in a bounded decision ring (mirrored to a JSONL file
via the obs sink thread when ``decision_jsonl`` is set) carrying
``predicted_s`` and ``reason``, and as ``gsched_*`` metrics the obs CLI
renders as the ``global scheduler`` panel.

**Uncalibrated degrade**: with no calibration record in the tuning cache
the scheduler runs the greedy baseline — every request admitted, deadlines
handed through to the engine's own gate, one warning line — and never
rejects on ``predicted_s=None``. Calibrate (``python -m
matvec_mpi_multiplier_torch.tuning.cost_model --calibrate quick``) to turn
prediction on.

The admission path consults predictions but never *measures*: no probe, no
``perf_counter`` pair around a dispatch, no device synchronization
(``tests/test_torch_global_scheduler.py`` pins it). Decision timestamps
read ``_clock`` (``time.monotonic``), which tests set.

Benchmarked by ``bench/serve.py --tenants ... --global-sched on|off|both
--deadline-ms ...`` (same-trace A/B) and ``run_reshard_drift``.
"""

from __future__ import annotations

import sys
import threading
import time
from typing import Callable

import torch

from ..obs.sink import JsonlSink
from ..obs.timeline import (
    bind_request,
    bound_request_id,
    get_hub,
    next_request_id,
)
from ..utils.errors import AdmissionRejectedError, ConfigError
from .core import DEFAULT_PROMOTE_B, MatvecFuture
from .registry import MatrixRegistry
from .scheduler import QOS_TIERS, _host_request, _SharedResult

# Decision vocabulary (the ring's `decision` field).
DECISIONS = ("admit", "reject", "interleave", "evict", "flush", "reshard")

# Bounded decision ring: a whole bench trace's decisions without growing
# with uptime.
DEFAULT_DECISION_CAPACITY = 4096

# Per-dispatch queue charge when the model has no formula for a config (the
# backlog estimate must not read an unpredictable dispatch as free).
_FALLBACK_DISPATCH_S = 1e-4


class _GsSlice:
    """One coalesced member's future: resolves to its own columns of the
    shared flush result (the ``MatvecFuture`` face). Materializing an
    un-flushed member triggers the flush itself."""

    def __init__(self, sched: "GlobalScheduler", vector: bool, width: int):
        self._sched = sched
        self._vector = vector
        self.width = width
        self._event = threading.Event()
        self._shared: _SharedResult | None = None
        self.offset: int | None = None
        self.retired = False

    def _resolve(self, shared: _SharedResult, offset: int) -> None:
        self._shared = shared
        self.offset = offset
        self._event.set()

    def done(self) -> bool:
        return self._event.is_set() and self._shared.done()

    def exception(self) -> Exception | None:
        """The failure this member's flush carries (once someone
        materialized the shared result), or None — also while the batch is
        still open."""
        if self._event.is_set() and self._shared._done:
            return self._shared._error
        return None

    def result(self) -> torch.Tensor:
        if not self._event.is_set():
            self._sched.flush()  # draining forces the flush
        self._event.wait()
        block = self._shared.value()
        self.retired = True
        if self._vector:
            return block[:, self.offset]
        return block[:, self.offset:self.offset + self.width]


class _PendingMember:
    """One request waiting in the open cross-tenant batch."""

    __slots__ = ("tenant_id", "block", "width", "future", "rid")

    def __init__(self, tenant_id, block, width, future, rid):
        self.tenant_id = tenant_id
        self.block = block
        self.width = width
        self.future = future
        self.rid = rid


class GlobalScheduler:
    """SLO-aware cross-tenant scheduling over a
    :class:`~.registry.MatrixRegistry` (the module docstring has the
    doctrine).

    Parameters
    ----------
    registry : the tenant fleet to schedule. The scheduler registers itself
        as the registry's ``eviction_listener`` (evictions enter the trace)
        and counts into ``registry.metrics``.
    cost_model : ``"auto"`` (any calibration record of this platform in the
        tuning cache, largest calibrated mesh —
        ``tuning.cost_model.any_model_from_cache``), an explicit
        :class:`~..tuning.cost_model.CostModel`, or None (greedy: one
        warning line, never rejects).
    deadline_margin : admission rejects when ``eta_s > deadline · margin``.
    interleave_threshold_s : a dispatch predicted at or above this swaps in
        the hottest evicted tenant first. None: the predicted restore cost
        of a mean-size payload.
    coalesce : allow same-group cross-tenant coalescing (default True).
    reshard : ``"auto"`` arms the online-resharding crossover trigger after
        each admission; ``"off"`` (default) never migrates. Needs a
        calibrated model.
    reshard_cooldown_s : per-tenant minimum seconds between migrations.
    reshard_horizon_s : the demand window the migration cost amortizes
        over: expected requests = rate · horizon.
    flush_width : open-batch width that forces a flush; None uses the
        tenant engine's promotion point ``b*`` (the static default without
        one).
    decision_jsonl : mirror every decision record to this JSONL file via
        the obs sink thread (None: ring only).
    decision_capacity : bounded decision-ring length.
    log : one-line warning sink (default: stderr), the uncalibrated
        degrade notice.
    """

    def __init__(
        self,
        registry: MatrixRegistry,
        *,
        cost_model="auto",
        deadline_margin: float = 1.0,
        interleave_threshold_s: float | None = None,
        coalesce: bool = True,
        reshard: str = "off",
        reshard_cooldown_s: float = 30.0,
        reshard_horizon_s: float = 30.0,
        flush_width: int | None = None,
        decision_jsonl=None,
        decision_capacity: int = DEFAULT_DECISION_CAPACITY,
        log: Callable[[str], None] | None = None,
    ):
        if deadline_margin <= 0:
            raise ConfigError(
                f"deadline_margin must be > 0, got {deadline_margin}"
            )
        if reshard not in ("auto", "off"):
            raise ConfigError(
                f"reshard must be 'auto' or 'off', got {reshard!r}"
            )
        self.registry = registry
        self.deadline_margin = float(deadline_margin)
        self._interleave_threshold_s = interleave_threshold_s
        self._coalesce = bool(coalesce)
        self._reshard = reshard
        self._reshard_cooldown_s = float(reshard_cooldown_s)
        self._reshard_horizon_s = float(reshard_horizon_s)
        self._last_reshard: dict[str, float] = {}
        self._flush_width = flush_width
        self._clock = time.monotonic
        self._log = log if log is not None else (
            lambda line: print(line, file=sys.stderr)
        )
        if cost_model == "auto":
            from ..tuning.cache import TuningCache
            from ..tuning.cost_model import any_model_from_cache

            cost_model = any_model_from_cache(TuningCache.load())
        self.model = cost_model
        if self.model is None:
            # The cold-cache contract: greedy, loudly, exactly once.
            self._log(
                "global scheduler: cost model uncalibrated — degrading "
                "to greedy admission (no predicted-time rejects; run "
                "`python -m matvec_mpi_multiplier_torch.tuning.cost_model "
                "--calibrate quick` to enable them)"
            )

        # Admission bookkeeping mutex: pending batch, outstanding window,
        # decision ring, prediction memo. Dispatches, prefetches and flushes
        # run after it is released.
        self._lock = threading.Lock()
        self._pending: list[_PendingMember] = []
        self._pending_group: tuple | None = None
        self._pending_width = 0
        self._outstanding: list[tuple[object, float]] = []
        self._decisions: list[dict] = []
        self._decision_capacity = int(decision_capacity)
        self._predict_memo: dict[tuple, float | None] = {}
        self._closed = False
        self._sink = (
            JsonlSink(decision_jsonl) if decision_jsonl is not None else None
        )
        self._timeline = get_hub()

        metrics = registry.metrics
        self._c_decisions = metrics.counter(
            "gsched_decisions_total",
            "global-scheduler decisions (admit+reject+interleave+evict"
            "+flush)",
        )
        self._c_admits = metrics.counter(
            "gsched_admits_total", "requests admitted to dispatch"
        )
        self._c_rejects = metrics.counter(
            "gsched_rejects_total",
            "requests rejected fast at admission (typed "
            "AdmissionRejectedError — predicted ETA past the deadline; "
            "rejected != failed in availability accounting)",
        )
        self._c_interleaves = metrics.counter(
            "gsched_interleaves_total",
            "evicted-tenant swap-ins made ahead of a predicted-long "
            "dispatch",
        )
        self._c_evict_decisions = metrics.counter(
            "gsched_evictions_total",
            "demand-aware evictions recorded in the decision trace",
        )
        self._c_flushes = metrics.counter(
            "gsched_flushes_total", "coalesced flushes dispatched"
        )
        self._c_reshard_decisions = metrics.counter(
            "gsched_reshards_total",
            "cost-model crossover migrations triggered (predicted "
            "new-layout dispatch + amortized migration < old layout "
            "over the EWMA demand horizon)",
        )
        self._c_cross_tenant = metrics.counter(
            "sched_cross_tenant_coalesced_total",
            "requests that shared a coalesced flush with another "
            "tenant's (same exec signature, same payload bytes)",
        )
        self._g_queue = metrics.gauge(
            "gsched_queue_predicted_s",
            "predicted seconds of outstanding dispatch backlog at the "
            "last admission decision",
        )
        self._g_greedy = metrics.gauge(
            "gsched_degraded_greedy",
            "1 while the scheduler is running WITHOUT a calibrated cost "
            "model (greedy admission; no predicted-time rejects)",
        )
        self._g_greedy.set(0 if self.model is not None else 1)
        self._h_predicted = metrics.histogram(
            "gsched_predicted_dispatch_ms",
            "predicted dispatch milliseconds per admitted request",
        )

        if registry.eviction_listener is None:
            registry.eviction_listener = self._on_eviction

    # ---- the decision trace ----

    def _record(self, decision: str, tenant_id: str, *,
                predicted_s, reason: str, request_id=None, cause_id=None,
                **fields) -> None:
        record = {
            "decision": decision,
            "tenant": tenant_id,
            "predicted_s": predicted_s,
            "reason": reason,
            "t_s": self._clock(),
            **fields,
        }
        if request_id is not None:
            record["request_id"] = request_id
        if cause_id is not None:
            record["cause_id"] = cause_id
        with self._lock:
            self._decisions.append(record)
            if len(self._decisions) > self._decision_capacity:
                del self._decisions[: -self._decision_capacity]
        self._c_decisions.inc()
        # Mirrored into the correlated event timeline, so `obs timeline
        # <rid>` shows admission decisions inline with the engine's events.
        self._timeline.emit(
            decision, request_id=request_id, cause_id=cause_id,
            tenant=tenant_id, **fields,
        )
        if self._sink is not None:
            self._sink.put(record)

    def decisions(self) -> list[dict]:
        """Snapshot of the bounded decision ring (newest last)."""
        with self._lock:
            return list(self._decisions)

    def _on_eviction(self, victim: str, caused_by: str, score: float,
                     restore_bytes: int) -> None:
        """Registry eviction listener: the eviction enters the decision
        trace with its predicted restore cost. Runs under the registry lock
        — bookkeeping only (the ring append and a queue put)."""
        self._c_evict_decisions.inc()
        self._record(
            "evict", victim,
            predicted_s=(
                self.model.restore_s(restore_bytes)
                if self.model is not None else None
            ),
            reason=(
                f"lowest demand-aware victim score ({score:.3f}) making "
                f"headroom for {caused_by}"
            ),
            cause_id=bound_request_id(),
            caused_by=caused_by,
            restore_bytes=restore_bytes,
        )

    # ---- prediction ----

    def _predict_dispatch_s(
        self, engine, b: int, rtol: float | None = None,
    ) -> float | None:
        """Predicted seconds for one ``b``-column dispatch through the
        engine's preferred config, memoized per (engine, bucket, storage).
        The per-column path models ``b`` sequential single-RHS programs; a
        config the formula cannot express predicts None (admitted, never
        rejected)."""
        if self.model is None:
            return None
        cfg = engine.prediction_config(b, rtol)
        memo_key = (id(engine), cfg["b"], cfg["storage"])
        with self._lock:
            if memo_key in self._predict_memo:
                base = self._predict_memo[memo_key]
                return None if base is None else (
                    base * (b if cfg["b"] == 1 else 1)
                )
        try:
            base = self.model.predict(
                cfg["strategy"], cfg["combine"], m=cfg["m"], k=cfg["k"],
                p=cfg["p"], dtype=cfg["dtype"], stages=cfg["stages"],
                b=cfg["b"], storage=cfg["storage"],
            ).total_s
        except Exception:  # swallow-ok: a formula-less schedule predicts None: admitted, never rejected
            base = None
        with self._lock:
            self._predict_memo[memo_key] = base
        return None if base is None else base * (b if cfg["b"] == 1 else 1)

    def _predict_solver_s(self, engine, op: str, k_est: int,
                          restart: int | None,
                          steps: int | None) -> float | None:
        """Predicted seconds for one served solve through the engine's
        preferred config (``CostModel.predict_solver`` at ``k_est`` = the
        request's maxiter). None (admit, never reject) when the formula
        cannot express the config."""
        if self.model is None:
            return None
        cfg = engine.prediction_config(1)
        try:
            return self.model.predict_solver(
                op, cfg["strategy"], cfg["combine"], m=cfg["m"],
                k=cfg["k"], p=cfg["p"], dtype=cfg["dtype"],
                stages=cfg["stages"], storage=cfg["storage"],
                k_est=k_est, restart=restart, steps=steps,
            ).total_s
        except Exception:  # swallow-ok: a formula-less schedule predicts None: admitted, never rejected
            return None

    def _queue_s(self) -> float:
        """Predicted backlog: the sum of the outstanding (not yet done)
        dispatches' predictions. Done futures are swept (a non-blocking
        ``done()`` per entry)."""
        with self._lock:
            self._outstanding = [
                (fut, s) for fut, s in self._outstanding if not fut.done()
            ]
            total = sum(s for _, s in self._outstanding)
        self._g_queue.set(total)
        return total

    def _track(self, fut, predicted_s: float | None) -> None:
        """Track one dispatch in the predicted-backlog window (greedy mode
        never reads the backlog, so it tracks nothing)."""
        if self.model is None:
            return
        with self._lock:
            self._outstanding.append(
                (fut, predicted_s if predicted_s is not None
                 else _FALLBACK_DISPATCH_S)
            )

    # ---- interleaving ----

    def _interleave_threshold(self) -> float:
        if self._interleave_threshold_s is not None:
            return self._interleave_threshold_s
        # Default: the restore cost of a mean-size payload — a dispatch long
        # enough to cover the transfer.
        with self.registry._lock:
            mean = self.registry._mean_payload_locked()
        return self.model.restore_s(int(mean))

    def _maybe_interleave(self, tenant_id: str,
                          dispatch_s: float | None) -> str | None:
        """Ahead of a predicted-long dispatch, pick the hottest evicted
        tenant and swap it in. Returns the prefetched tenant id (or None).
        The decision is recorded before the swap-in, so the trace orders it
        ahead of the covering dispatch.

        Damped against thrash: under a full budget every prefetch evicts
        someone, so the swap-in happens only when the evicted candidate's
        demand exceeds the coldest unpinned resident's."""
        if self.model is None or dispatch_s is None:
            return None
        if dispatch_s < self._interleave_threshold():
            return None
        now = self.registry._clock()
        best, best_rate = None, 0.0
        coldest_resident = None
        for tid in self.registry.tenant_ids():
            if tid == tenant_id:
                continue
            entry = self.registry._tenants.get(tid)
            if entry is None:
                continue
            rate = entry.rate.rate_per_s(now=now)
            if entry.engine.resident:
                if not entry.pinned and (
                    coldest_resident is None or rate < coldest_resident
                ):
                    coldest_resident = rate
            elif rate > best_rate:
                best, best_rate = tid, rate
        if best is None:
            return None
        if coldest_resident is not None and best_rate <= coldest_resident:
            return None  # placement already follows demand: don't churn
        entry = self.registry._tenants.get(best)
        if entry is None:
            return None  # raced an unregister between scan and pick
        restore = entry.engine.resident_bytes
        self._c_interleaves.inc()
        self._record(
            "interleave", best,
            predicted_s=self.model.restore_s(restore),
            reason=(
                f"swap-in ({best_rate:.2f} req/s demand) overlapped "
                f"under {tenant_id}'s {dispatch_s * 1e3:.3f} ms dispatch"
            ),
            cause_id=bound_request_id(),
            under=tenant_id,
            restore_bytes=restore,
        )
        try:
            self.registry.prefetch(best, protect=tenant_id)
        except ConfigError:
            return None  # the tenant was unregistered mid-decision
        return best

    # ---- online resharding ----

    def _maybe_reshard(self, tenant_id: str, width: int,
                       dispatch_s: float | None) -> str | None:
        """The ``reshard="auto"`` crossover trigger: migrate ``tenant_id``'s
        resident ``A`` to the layout whose predicted per-request dispatch,
        plus the migration cost amortized over the demand horizon, beats
        the current layout's. Pure prediction (``CostModel.predict`` and
        ``predict_reshard``). Returns the destination strategy name when a
        migration was triggered.

        Damped three ways: a per-tenant cooldown, the amortization itself (a
        cold tenant's horizon carries too few requests to pay for the
        collectives), and the strict inequality (ties keep the layout). The
        migration runs on this admission's thread, with ``warm_widths`` so
        the new layout's builds land here too."""
        if self._reshard != "auto" or self.model is None:
            return None
        if dispatch_s is None:
            return None  # formula-less config: nothing to compare
        entry = self.registry._tenants.get(tenant_id)
        if entry is None:
            return None
        engine = entry.engine
        if not engine.resident or entry.resharding:
            return None
        now = self._clock()
        with self._lock:
            last = self._last_reshard.get(tenant_id)
            if last is not None and now - last < self._reshard_cooldown_s:
                return None
        rate = entry.rate.rate_per_s(now=self.registry._clock())
        horizon_n = rate * self._reshard_horizon_s
        if horizon_n < 1.0:
            return None  # no demand to amortize the collectives over
        from ..models import get_strategy
        from ..parallel.reshard import RESHARD_STRATEGIES

        cfg = engine.prediction_config(width)
        src = cfg["strategy"]
        if src not in RESHARD_STRATEGIES:
            return None  # custom strategy instance: no migration program
        best = None  # (total_s, dst, new_s, migrate_s)
        for dst in RESHARD_STRATEGIES:
            if dst == src:
                continue
            try:
                combine = get_strategy(dst).default_combine(engine.mesh)
                base = self.model.predict(
                    dst, combine, m=cfg["m"], k=cfg["k"], p=cfg["p"],
                    dtype=cfg["dtype"], b=cfg["b"], storage=cfg["storage"],
                ).total_s
                migrate_s = self.model.predict_reshard(
                    src, dst, m=cfg["m"], k=cfg["k"], p=cfg["p"],
                    dtype=cfg["dtype"],
                ).total_s
            except Exception:  # swallow-ok: a formula-less candidate drops out of the comparison
                continue
            new_s = base * (width if cfg["b"] == 1 else 1)
            total = new_s + migrate_s / horizon_n
            if best is None or total < best[0]:
                best = (total, dst, new_s, migrate_s)
        if best is None or best[0] >= dispatch_s:
            return None  # the current layout already wins the horizon
        _total, dst, new_s, migrate_s = best
        with self._lock:
            self._last_reshard[tenant_id] = now
        self._c_reshard_decisions.inc()
        self._record(
            "reshard", tenant_id,
            predicted_s=migrate_s,
            cause_id=bound_request_id(),
            reason=(
                f"crossover: {dst} predicts {new_s * 1e3:.3f} ms/req vs "
                f"{src} {dispatch_s * 1e3:.3f} ms, and the "
                f"{migrate_s * 1e3:.3f} ms migration amortizes over "
                f"~{horizon_n:.0f} requests ({rate:.2f} req/s x "
                f"{self._reshard_horizon_s:.0f} s horizon)"
            ),
            src=src, dst=dst, old_s=dispatch_s, new_s=new_s,
            migrate_s=migrate_s, horizon_requests=horizon_n,
        )
        try:
            self.registry.reshard(
                tenant_id, dst,
                warm_widths=(1,) if width == 1 else (1, width),
            )
        except ConfigError:
            return None  # unregistered or evicted mid-decision: traced, not fatal
        finally:
            # The memo keys omit the strategy (one seat per engine); a
            # migration makes the engine's seats stale.
            with self._lock:
                self._predict_memo = {
                    key: s for key, s in self._predict_memo.items()
                    if key[0] != id(engine)
                }
        return dst

    # ---- admission & dispatch ----

    def submit(
        self,
        tenant_id: str,
        x=None,
        *,
        deadline_ms: float | None = None,
        qos: str = "standard",
        op: str = "matvec",
        rhs=None,
        rtol: float | None = None,
        maxiter: int | None = None,
        restart: int | None = None,
        steps: int | None = None,
        interval: tuple[float, float] | None = None,
    ):
        """Admit one request for ``tenant_id``: a ``(k,)`` vector or
        ``(k, b)`` block on the host (a CPU tensor or a numpy array).
        Calibrated and deadlined: the queue-aware ETA is checked first and
        an infeasible request gets a failed future carrying
        :class:`AdmissionRejectedError` (no dispatch, no eviction
        pressure). Admitted requests dispatch without a deadline. Greedy
        (uncalibrated): everything passes through with its deadline intact
        for the engine's own gate.

        A solver ``op`` (``MatvecEngine.submit(op=...)`` semantics) is
        admitted against :meth:`~..tuning.cost_model.CostModel.predict_solver`
        at ``k_est = maxiter`` and dispatched solo. A matvec declaring
        ``rtol`` (the speculative contract, ``MatvecEngine.submit(rtol=)``)
        passes it through and bypasses coalescing: the fused check carries
        one tolerance a dispatch, and stacking requests of different budgets
        would hold every column to the tightest. On an armed tenant the
        admission prices such a request as ``storage="speculate"``."""
        if qos not in QOS_TIERS:
            raise ConfigError(
                f"unknown QoS tier {qos!r}; expected one of {QOS_TIERS}"
            )
        if self._closed:
            raise ConfigError("global scheduler is closed")
        if op != "matvec":
            return self._submit_solver_op(
                tenant_id, x, deadline_ms=deadline_ms, op=op, rhs=rhs,
                rtol=rtol, maxiter=maxiter, restart=restart, steps=steps,
                interval=interval,
            )
        entry = self.registry._entry(tenant_id)
        engine = entry.engine
        block = _host_request(x, engine.dtype)
        vector = block.dim() == 1
        if block.dim() not in (1, 2) or block.shape[0] != engine.k or (
            block.dim() == 2 and block.shape[1] == 0
        ):
            raise ConfigError(
                f"request must be (k,) or (k, b) with k={engine.k}; got "
                f"shape {tuple(block.shape)}"
            )
        if vector:
            block = block[:, None]
        width = block.shape[1]
        # One correlation id per admitted request: every decision line,
        # timeline event and (through bind_request) the engine's own trace.
        rid = next_request_id()

        dispatch_s = self._predict_dispatch_s(engine, width, rtol)
        if self.model is not None:
            from ..tuning.cost_model import AdmissionEstimate

            queue_s = self._queue_s()
            swap_bytes = 0 if engine.resident else engine.resident_bytes
            swap_s = self.model.restore_s(swap_bytes) if swap_bytes else 0.0
            # One ETA formula: AdmissionEstimate composes the terms (the
            # dispatch prediction is memoized here).
            est = (
                AdmissionEstimate(
                    dispatch_s=dispatch_s, queue_s=queue_s, swap_s=swap_s
                )
                if dispatch_s is not None else None
            )
            eta_s = est.eta_s if est is not None else None
            if deadline_ms is not None and (
                deadline_ms <= 0
                or (
                    eta_s is not None
                    and eta_s * 1e3 > deadline_ms * self.deadline_margin
                )
            ):
                # Reject fast: typed, pre-dispatch, traced. Rejected demand
                # still ticks the tenant's rate estimator.
                self.registry.observe_demand(tenant_id)
                self._c_rejects.inc()
                reason = (
                    "deadline elapsed before admission"
                    if deadline_ms <= 0 else
                    f"predicted eta {eta_s * 1e3:.3f} ms (queue "
                    f"{queue_s * 1e3:.3f} + swap {swap_s * 1e3:.3f} + "
                    f"dispatch {dispatch_s * 1e3:.3f}) > deadline "
                    f"{deadline_ms:.3f} ms"
                )
                self._record(
                    "reject", tenant_id, predicted_s=dispatch_s,
                    reason=reason, request_id=rid, eta_s=eta_s,
                    queue_s=queue_s, deadline_ms=deadline_ms,
                )
                return MatvecFuture.failed(AdmissionRejectedError(
                    f"request for tenant {tenant_id!r} rejected at "
                    f"admission: {reason}"
                ))
            if dispatch_s is not None:
                self._h_predicted.observe(dispatch_s * 1e3)
            self._record(
                "admit", tenant_id, predicted_s=dispatch_s,
                reason=(
                    "uncalibrated config: admitted without a prediction"
                    if dispatch_s is None else
                    f"predicted eta "
                    f"{(eta_s if eta_s is not None else dispatch_s) * 1e3:.3f}"
                    f" ms within "
                    + (f"deadline {deadline_ms:.3f} ms"
                       if deadline_ms is not None else "no deadline")
                ),
                request_id=rid, eta_s=eta_s, queue_s=queue_s,
                deadline_ms=deadline_ms,
            )
            with bind_request(rid):
                # Bound so consequences (evictions under prefetch, the
                # reshard migration) record cause_id=rid.
                self._maybe_interleave(tenant_id, dispatch_s)
                if self._maybe_reshard(tenant_id, width, dispatch_s):
                    # The migrated layout serves this request too: the
                    # backlog window charges the new config's time.
                    dispatch_s = self._predict_dispatch_s(
                        engine, width, rtol
                    )
            # Admission owns the deadline from here (module docstring).
            engine_deadline = None
        else:
            # Greedy degrade: admit, the deadline handed through to the
            # engine's own gate, the decision still traced.
            self._c_admits.inc()
            self._record(
                "admit", tenant_id, predicted_s=None,
                reason="greedy admission (cost model uncalibrated)",
                request_id=rid, deadline_ms=deadline_ms,
            )
            with bind_request(rid):
                fut = self.registry.submit(
                    tenant_id, x, deadline_ms=deadline_ms, rtol=rtol
                )
            self._track(fut, None)
            return fut

        self._c_admits.inc()
        if not self._coalesce or rtol is not None:
            with bind_request(rid):
                fut = self.registry.submit(
                    tenant_id, x, deadline_ms=engine_deadline, rtol=rtol
                )
            self._track(fut, dispatch_s)
            return fut
        return self._enqueue_coalesced(
            tenant_id, block, vector, width, dispatch_s, rid,
            flush_now=deadline_ms is not None or qos == "interactive",
        )

    def _submit_solver_op(
        self, tenant_id: str, x, *, deadline_ms, op, rhs, rtol, maxiter,
        restart, steps, interval,
    ):
        """The solver ops' admission and dispatch: the predicted-time gate
        of the matvec path with :meth:`_predict_solver_s` as the dispatch
        term, no coalescing (one loop, one RHS). Shape validation stays the
        engine's: ``x``/``rhs`` are forwarded untouched."""
        entry = self.registry._entry(tenant_id)
        engine = entry.engine
        kwargs = dict(
            op=op, rhs=rhs, rtol=rtol, maxiter=maxiter,
            restart=restart, steps=steps, interval=interval,
        )
        rid = next_request_id()
        if self.model is None:
            self._c_admits.inc()
            self._record(
                "admit", tenant_id, predicted_s=None,
                reason="greedy admission (cost model uncalibrated)",
                request_id=rid, deadline_ms=deadline_ms, op=op,
            )
            with bind_request(rid):
                fut = self.registry.submit(
                    tenant_id, x, deadline_ms=deadline_ms, **kwargs
                )
            self._track(fut, None)
            return fut

        from ..tuning.cost_model import AdmissionEstimate
        from .core import DEFAULT_SOLVER_MAXITER

        k_est = maxiter if maxiter is not None else DEFAULT_SOLVER_MAXITER
        dispatch_s = self._predict_solver_s(engine, op, k_est, restart,
                                            steps)
        queue_s = self._queue_s()
        swap_bytes = 0 if engine.resident else engine.resident_bytes
        swap_s = self.model.restore_s(swap_bytes) if swap_bytes else 0.0
        est = (
            AdmissionEstimate(
                dispatch_s=dispatch_s, queue_s=queue_s, swap_s=swap_s
            )
            if dispatch_s is not None else None
        )
        eta_s = est.eta_s if est is not None else None
        if deadline_ms is not None and (
            deadline_ms <= 0
            or (
                eta_s is not None
                and eta_s * 1e3 > deadline_ms * self.deadline_margin
            )
        ):
            self.registry.observe_demand(tenant_id)
            self._c_rejects.inc()
            reason = (
                "deadline elapsed before admission"
                if deadline_ms <= 0 else
                f"predicted {op} eta {eta_s * 1e3:.3f} ms at "
                f"maxiter={k_est} (queue {queue_s * 1e3:.3f} + swap "
                f"{swap_s * 1e3:.3f} + solve {dispatch_s * 1e3:.3f}) > "
                f"deadline {deadline_ms:.3f} ms"
            )
            self._record(
                "reject", tenant_id, predicted_s=dispatch_s,
                reason=reason, request_id=rid, eta_s=eta_s,
                queue_s=queue_s, deadline_ms=deadline_ms, op=op,
            )
            return MatvecFuture.failed(AdmissionRejectedError(
                f"request for tenant {tenant_id!r} rejected at "
                f"admission: {reason}"
            ))
        if dispatch_s is not None:
            self._h_predicted.observe(dispatch_s * 1e3)
        self._record(
            "admit", tenant_id, predicted_s=dispatch_s,
            reason=(
                "uncalibrated config: admitted without a prediction"
                if dispatch_s is None else
                f"predicted {op} eta "
                f"{(eta_s if eta_s is not None else dispatch_s) * 1e3:.3f}"
                f" ms (maxiter={k_est}) within "
                + (f"deadline {deadline_ms:.3f} ms"
                   if deadline_ms is not None else "no deadline")
            ),
            request_id=rid, eta_s=eta_s, queue_s=queue_s,
            deadline_ms=deadline_ms, op=op,
        )
        self._c_admits.inc()
        with bind_request(rid):
            self._maybe_interleave(tenant_id, dispatch_s)
            # Admission owns the deadline from here (module docstring).
            fut = self.registry.submit(
                tenant_id, x, deadline_ms=None, **kwargs
            )
        self._track(fut, dispatch_s)
        return fut

    def __call__(self, tenant_id: str, x) -> torch.Tensor:
        """Synchronous convenience: ``submit(tenant_id, x).result()``."""
        return self.submit(tenant_id, x).result()

    # ---- coalescing ----

    def _resolved_flush_width(self, engine) -> int:
        if self._flush_width is not None:
            return self._flush_width
        b_star = engine.b_star
        return b_star if b_star is not None else DEFAULT_PROMOTE_B

    def _enqueue_coalesced(self, tenant_id, block, vector, width,
                           dispatch_s, rid, flush_now: bool):
        # Members reach registry.submit only through the flush owner, so
        # tick each member's demand estimator here (the owner gets one
        # extra tick per flush from registry.submit: a bounded overcount
        # that never changes a hot/cold ranking).
        self.registry.observe_demand(tenant_id)
        group = self.registry.coalesce_group(tenant_id)
        fut = _GsSlice(self, vector, width)
        member = _PendingMember(tenant_id, block, width, fut, rid)
        engine = self.registry._entry(tenant_id).engine
        batch = None
        with self._lock:
            if self._pending and self._pending_group != group:
                # Order preservation: another group's arrival closes the
                # open batch first.
                batch = self._swap_batch_locked()
            self._pending.append(member)
            self._pending_group = group
            self._pending_width += width
            if (
                flush_now
                or self._pending_width >= self._resolved_flush_width(engine)
            ):
                own = self._swap_batch_locked()
            else:
                own = None
        if batch is not None:
            self._flush_batch(batch)
        if own is not None:
            self._flush_batch(own)
        return fut

    def _swap_batch_locked(self) -> list[_PendingMember] | None:
        if not self._pending:
            return None
        batch = self._pending
        self._pending = []
        self._pending_group = None
        self._pending_width = 0
        return batch

    def _flush_batch(self, batch: list[_PendingMember]) -> None:
        """Dispatch one swapped-out batch as one registry submit through
        the first member's tenant (the flush owner: its residency and hit
        accounting absorb the dispatch). Runs with no scheduler lock held;
        per-member futures resolve to their own columns."""
        owner = batch[0].tenant_id
        stacked = (
            batch[0].block if len(batch) == 1
            else torch.cat([m.block for m in batch], dim=1)
        )
        width = stacked.shape[1]
        owner_engine = self.registry._entry(owner).engine
        predicted = self._predict_dispatch_s(owner_engine, width)
        cross = sum(1 for m in batch if m.tenant_id != owner)
        if cross:
            self._c_cross_tenant.inc(cross + 1)  # every sharing member
        self._c_flushes.inc()
        # One fresh id per flushed batch; `members` walks from any member's
        # rid to the batch and back.
        batch_rid = next_request_id()
        self._record(
            "flush", owner, predicted_s=predicted,
            reason=(
                f"{len(batch)} request(s), {width} column(s)"
                + (f", {cross} from other tenants" if cross else "")
            ),
            request_id=batch_rid, members=[m.rid for m in batch],
            n_requests=len(batch), width=width,
        )
        try:
            with bind_request(batch_rid):
                inner = self.registry.submit(owner, stacked)
        except Exception as e:  # swallow-ok: parked in every member's future: result() raises it
            shared = _SharedResult(MatvecFuture.failed(e))
        else:
            self._track(inner, predicted)
            shared = _SharedResult(inner)
        offset = 0
        for m in batch:
            m.future._resolve(shared, offset)
            offset += m.width

    def flush(self) -> int:
        """Dispatch the open batch now. Returns the number of requests
        flushed."""
        with self._lock:
            batch = self._swap_batch_locked()
        if batch is None:
            return 0
        self._flush_batch(batch)
        return len(batch)

    # ---- lifecycle ----

    def close(self) -> None:
        """Flush the open batch, stop accepting submits, release the
        decision sink. Does not close the registry."""
        if self._closed:
            return
        self.flush()
        self._closed = True
        if self._sink is not None:
            self._sink.close()

    def __enter__(self) -> "GlobalScheduler":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
