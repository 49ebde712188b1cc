"""Multi-tenant resident-matrix registry: many tenants' ``A`` matrices
against one fixed device-memory budget.

The port's counterpart of the JAX package's ``engine/registry.py``. One
engine (``core.py``) holds one resident ``A``; a service holding many
tenants' matrices on a card whose memory does not grow with the tenant
count needs the layer above it. Five mechanisms:

* **device-memory accountant** — every resident payload is charged to its
  tenant: a quantized resident's payload and scales under quantized
  storage, AND the degradation ladder's native safe tier once placed (a
  degraded tenant's footprint is payload + fallback, and the accountant
  sees both). Charges flow through the engine's ``residency_listener`` and
  reconcile to ``device_resident_bytes``, the bytes of the tensors actually
  placed.
* **cost-aware LRU eviction** — admitting a tenant that is not resident
  under a full budget evicts the resident tenant with the lowest
  ``last_used + cost_weight · (restore_bytes / mean_payload_bytes)`` score:
  plain LRU for homogeneous tenants, a swap-cost bonus for tenants that are
  expensive to bring back (the GreedyDual-Size idea). Eviction drops the
  victim's device operands and the programs built over them
  (``MatvecEngine.release_residency``: the caching allocator hands a freed
  block only to later work on the same stream, so a dispatch already
  queued still reads the old bytes); the swap-in, a copy of the retained
  host payload to the card, runs OUTSIDE the registry lock. An evicted
  tenant re-admits transparently on its next submit with bitwise the
  results it had (same host bytes, same kernels), its programs built and
  captured again against the new placement.
* **warm-pinning** — :meth:`MatrixRegistry.pin` makes a hot tenant
  ineligible for eviction (and admits it at once); :meth:`unpin` returns it
  to the eviction pool.
* **per-tenant quotas / admission control** — a tenant at its
  ``max_in_flight`` quota gets a FAILED future carrying a typed
  :class:`~..utils.errors.TenantQuotaError` before any dispatch: its burst
  fails ITS requests and exerts no eviction or degradation pressure on its
  neighbors. Breakers, degradation ladders and the integrity gate are
  per-engine and therefore per-tenant already; fault patterns become
  tenant-addressable through the engine's ``label_prefix``
  (``--fault-spec 'dispatch:device_error:key=tenant-7/*'`` targets exactly
  one tenant).
* **shared functions** — a strategy's built functions depend on shapes and
  configuration, never on ``A``'s values, so tenants with equal
  ``exec_signature`` share one function cache. A program over ``A`` is
  never shared: a captured CUDA graph holds its tenant's ``A`` address, so
  each tenant builds and captures its own (the JAX package shares whole
  compiled executables instead: N tenants, one compile per key; here one
  function build per key and one capture per tenant and key).

Lock discipline: the registry mutex guards bookkeeping only — never a
placement copy, a dispatch, or a wait on the card. A victim's release under
the lock is legal (it drops references and waits only for a dispatch being
enqueued on the victim's engine); placements and dispatches happen after
the lock is released. The mutex is reentrant because the engine's residency
listener (which takes it) fires inside a victim's release.

Budget semantics are SOFT at the edges, deliberately: when every resident
tenant is pinned or mid-submit, the admission proceeds anyway and
``registry_budget_overshoots_total`` counts the breach — a full budget
degrades to a measured overshoot, never to a refused or deadlocked request.
(Hard per-tenant admission is what quotas are for.)

Observability: per-tenant resident bytes, hit/evict/pin counters and quota
rejections live in the shared metrics registry under
``tenant_*{tenant="..."}`` names (the obs ``tenants`` panel renders them:
``python -m matvec_mpi_multiplier_torch.obs metrics``), and
:meth:`MatrixRegistry.health` mirrors them as one dict next to each tenant
engine's breaker/degradation state. Benchmarked by ``bench/serve.py
--tenants/--zipf-a/--hbm-budget``.
"""

from __future__ import annotations

import dataclasses
import hashlib
import itertools
import threading
import time
from typing import Callable, Sequence

import torch

from ..obs.registry import MetricsRegistry, label
from ..obs.timeline import bound_request_id, get_hub
from ..utils.errors import ConfigError, TenantQuotaError
from .core import MatvecEngine, MatvecFuture
from .executables import ExecutableCache

# Eviction-score weight of restore cost relative to one recency step: a
# tenant twice the mean payload size gets one extra serial of protection
# per cost_weight unit. 1.0 keeps homogeneous fleets exactly LRU while still
# breaking recency ties toward the cheaper restore.
DEFAULT_COST_WEIGHT = 1.0

# Time constant of the per-tenant arrival-rate EWMA feeding demand-aware
# eviction (and exported as tenant_rate_req_per_s{tenant=...} gauges): long
# enough to remember a Zipf-hot tenant across a few of its gaps, short
# enough that a tenant going cold stops being protected within seconds.
DEFAULT_RATE_TAU_S = 5.0

# Tenant ids become fault-label prefixes (``<tenant>/op:strategy:...``),
# metric label values and CSV cells — the grammar forbids the separators
# those surfaces key on.
_TENANT_ID_FORBIDDEN = set(':/,"{}* \t\n')


def _validate_tenant_id(tenant_id: str) -> str:
    if not isinstance(tenant_id, str) or not tenant_id:
        raise ConfigError(
            f"tenant id must be a non-empty string, got {tenant_id!r}"
        )
    bad = _TENANT_ID_FORBIDDEN.intersection(tenant_id)
    if bad:
        raise ConfigError(
            f"tenant id {tenant_id!r} contains reserved characters "
            f"{sorted(bad)} (ids become fault-label prefixes, metric "
            "labels and CSV cells)"
        )
    return tenant_id


@dataclasses.dataclass(frozen=True)
class TenantQuota:
    """Admission limits for one tenant.

    max_in_flight : most outstanding (not yet materialized) futures the
        tenant may hold; the next submit past it fails with
        :class:`TenantQuotaError` BEFORE dispatch. None = unlimited.
    max_resident_bytes : ceiling on the tenant's registered payload bytes,
        checked at :meth:`MatrixRegistry.register` — an A too big for the
        tenant's reservation is refused up front, not admitted and then
        thrashed. None = unlimited.
    """

    max_in_flight: int | None = None
    max_resident_bytes: int | None = None

    def __post_init__(self):
        if self.max_in_flight is not None and self.max_in_flight < 1:
            raise ConfigError(
                f"max_in_flight must be >= 1, got {self.max_in_flight}"
            )
        if (
            self.max_resident_bytes is not None
            and self.max_resident_bytes <= 0
        ):
            raise ConfigError(
                "max_resident_bytes must be positive, got "
                f"{self.max_resident_bytes}"
            )


class HbmAccountant:
    """The per-tenant device-memory ledger. A plain object mutated only
    under the registry lock (no lock of its own). Entries are RECONCILED to
    each engine's actual current footprint rather than delta-applied: the
    residency listener fires outside the engine's locks, so a swap-in's
    notification can arrive AFTER the eviction that undid it — replaying
    deltas in that order would leak a phantom charge, while reconciling to
    the engine's present state converges to the truth regardless of arrival
    order. ``budget=None`` means unlimited (accounting still runs — the
    tenants panel reports real bytes either way)."""

    def __init__(self, budget: int | None):
        if budget is not None and budget <= 0:
            raise ConfigError(f"hbm_budget must be positive, got {budget}")
        self.budget = int(budget) if budget is not None else None
        self.charged: dict[str, int] = {}
        self.overshoots = 0

    @property
    def total(self) -> int:
        return sum(self.charged.values())

    def headroom(self, needed: int) -> bool:
        """True when ``needed`` more bytes fit under the budget."""
        return self.budget is None or self.total + needed <= self.budget

    def reconcile(self, tenant_id: str, n: int) -> bool:
        """Set the tenant's ledger entry to its ACTUAL current footprint
        ``n``; True when this grew the entry past the budget (counted as
        an overshoot)."""
        prev = self.charged.get(tenant_id, 0)
        if n > 0:
            self.charged[tenant_id] = int(n)
        else:
            self.charged.pop(tenant_id, None)
        breached = (
            self.budget is not None and n > prev
            and self.total > self.budget
        )
        if breached:
            self.overshoots += 1
        return breached


class _Tenant:
    """Registry-internal per-tenant record (mutated under the registry
    lock; the engine itself is touched outside it)."""

    __slots__ = (
        "tenant_id", "engine", "quota", "pinned", "last_used", "active",
        "outstanding", "charged_bytes", "requests", "hits", "evictions",
        "evictions_caused", "quota_rejections", "swap_ins", "payload_sha",
        "rate", "resharding", "reshards", "g_resident_bytes", "g_pinned",
        "g_strategy", "c_requests", "c_hits", "c_evictions",
        "c_evictions_caused", "c_quota_rejections",
    )

    def __init__(self, tenant_id: str, engine: MatvecEngine,
                 quota: TenantQuota | None):
        self.tenant_id = tenant_id
        self.engine = engine
        self.quota = quota
        self.pinned = False
        self.last_used = 0
        self.active = 0          # submits between admission and dispatch
        self.outstanding: list[MatvecFuture] = []
        self.charged_bytes = 0   # actual placed bytes (payload + fallback)
        self.requests = 0
        self.hits = 0
        self.evictions = 0
        self.evictions_caused = 0
        self.quota_rejections = 0
        self.swap_ins = 0
        self.payload_sha = ""    # host-A content hash, lazy (coalesce groups)
        self.rate = None         # per-tenant arrival RateEstimator
        self.resharding = False  # one online migration at a time per tenant
        self.reshards = 0        # completed strategy migrations
        self.g_strategy = None   # current tenant_strategy{...} info gauge

    def sweep(self) -> None:
        """Drop consumed futures from the outstanding window (the quota
        denominator): a future is outstanding until the caller
        materializes it — un-materialized results are exactly the buffers
        still holding device memory, which is what the quota bounds. A
        pre-dispatch failure (deadline) retires on its raising ``result()``
        too; the ``exception()`` probe covers a caller that polls instead.
        Never blocks."""
        self.outstanding = [
            f for f in self.outstanding
            if not f.retired and f.exception() is None
        ]


class TenantHandle:
    """The caller's face for one registered tenant: submit against its
    resident ``A``, pin/unpin it, read its stats. A thin delegate — the
    registry owns all state, so handles are freely copyable and remain
    valid until :meth:`MatrixRegistry.unregister`."""

    def __init__(self, registry: "MatrixRegistry", tenant_id: str):
        self._registry = registry
        self.tenant_id = tenant_id

    def submit(self, x, **kwargs):
        return self._registry.submit(self.tenant_id, x, **kwargs)

    def __call__(self, x):
        """Synchronous convenience: ``submit(x).result()``."""
        return self.submit(x).result()

    def pin(self) -> None:
        self._registry.pin(self.tenant_id)

    def unpin(self) -> None:
        self._registry.unpin(self.tenant_id)

    def reshard(self, strategy, *, warm_widths=None) -> dict | None:
        """Migrate this tenant's resident ``A`` to another strategy on the
        card (:meth:`MatrixRegistry.reshard`)."""
        return self._registry.reshard(
            self.tenant_id, strategy, warm_widths=warm_widths
        )

    @property
    def engine(self) -> MatvecEngine:
        return self._registry._entry(self.tenant_id).engine

    def stats(self) -> dict:
        return self._registry.tenant_stats(self.tenant_id)


# Engine parameters the registry owns — a caller supplying them would break
# the residency/accounting/identity contracts register() wires up.
_RESERVED_ENGINE_KWARGS = frozenset({
    "metrics", "retain_host", "defer_placement", "label_prefix",
    "exec_cache", "residency_listener", "fault_plan", "resilience",
    "integrity_gate",
})


class MatrixRegistry:
    """Per-tenant ``A`` registration, device-memory accounting, cost-aware
    LRU eviction, warm-pinning and quota admission — the module docstring
    has the doctrine.

    Parameters
    ----------
    mesh : device mesh every tenant engine shares (default: the CUDA
        devices, ``make_mesh``).
    hbm_budget : resident-payload byte budget across all tenants (None =
        unlimited; accounting still runs).
    cost_weight : eviction-score weight of restore cost vs recency
        (:data:`DEFAULT_COST_WEIGHT`; 0 = pure LRU).
    demand_weight : eviction-score weight of PREDICTED DEMAND — each
        tenant's EWMA arrival rate (its :class:`~..obs.registry.
        RateEstimator`, exported as ``tenant_rate_req_per_s{tenant=...}``)
        times its restore-cost ratio. One sustained request/s of demand on
        a mean-size payload buys ``demand_weight`` recency serials of
        protection. 0 (the default) keeps the recency+cost score exactly;
        the serve bench's global-scheduler runs turn it on
        (``--demand-weight``).
    rate_tau_s : the demand estimators' EWMA time constant. They read the
        registry's ``_clock`` (``time.monotonic``).
    eviction_listener : ``callable(victim_id, caused_by_id, score,
        restore_bytes)`` called after each eviction's release, under the
        registry lock — bookkeeping only, by the lock discipline.
    metrics : shared obs registry for the whole fleet (default: a fresh
        one). Tenant engines count into it too, so ``engine_*`` counters
        read as fleet aggregates; per-tenant truth lives under the
        ``tenant_*{tenant="..."}`` names.
    resilience / fault_plan / integrity_gate : forwarded to every tenant
        engine (one plan, per-tenant targeting via ``tenant-X/*`` key
        patterns; breakers and ladders are per-tenant by construction).
    **engine_defaults : forwarded to every tenant's
        :class:`~.core.MatvecEngine` (strategy, kernel, combine, stages,
        dtype_storage, max_bucket, promote, donate, ...); per-tenant
        overrides go to :meth:`register`.
    """

    def __init__(
        self,
        mesh=None,
        *,
        hbm_budget: int | None = None,
        cost_weight: float = DEFAULT_COST_WEIGHT,
        demand_weight: float = 0.0,
        rate_tau_s: float = DEFAULT_RATE_TAU_S,
        eviction_listener: (
            Callable[[str, str, float, int], None] | None
        ) = None,
        metrics: MetricsRegistry | None = None,
        resilience=None,
        fault_plan=None,
        integrity_gate: bool = False,
        **engine_defaults,
    ):
        if mesh is None:
            from ..parallel.mesh import make_mesh

            mesh = make_mesh()
        self.mesh = mesh
        if cost_weight < 0:
            raise ConfigError(f"cost_weight must be >= 0, got {cost_weight}")
        self.cost_weight = float(cost_weight)
        if demand_weight < 0:
            raise ConfigError(
                f"demand_weight must be >= 0, got {demand_weight}"
            )
        self.demand_weight = float(demand_weight)
        self.rate_tau_s = float(rate_tau_s)
        self._clock = time.monotonic
        self.eviction_listener = eviction_listener
        bad = _RESERVED_ENGINE_KWARGS.intersection(engine_defaults)
        if bad:
            raise ConfigError(
                f"engine defaults {sorted(bad)} are registry-owned "
                "(the registry wires residency, accounting and identity "
                "itself)"
            )
        self._engine_defaults = dict(engine_defaults)
        self._resilience = resilience
        self._fault_plan = fault_plan
        self._integrity_gate = bool(integrity_gate)
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.accountant = HbmAccountant(hbm_budget)
        # Reentrant: a victim's release under the lock fires the engine's
        # residency listener, which re-enters for the ledger update.
        self._lock = threading.RLock()
        self._tenants: dict[str, _Tenant] = {}
        self._exec_caches: dict[tuple, ExecutableCache] = {}
        self._serial = itertools.count(1)
        self._closed = False
        self._timeline = get_hub()

        self._g_budget = self.metrics.gauge(
            "registry_hbm_budget_bytes",
            "resident-payload device-memory budget (0 = unlimited)",
        )
        self._g_budget.set(hbm_budget or 0)
        self._g_charged = self.metrics.gauge(
            "registry_hbm_charged_bytes",
            "resident bytes currently charged across all tenants",
        )
        self._g_tenants = self.metrics.gauge(
            "registry_tenants", "registered tenants"
        )
        self._g_resident_tenants = self.metrics.gauge(
            "registry_tenants_resident",
            "tenants whose payload A is device-resident",
        )
        self._c_requests = self.metrics.counter(
            "registry_requests_total", "registry submit() calls"
        )
        self._c_hits = self.metrics.counter(
            "registry_hits_total",
            "submits that found the tenant's A already resident",
        )
        self._c_swap_ins = self.metrics.counter(
            "registry_swap_ins_total",
            "payload placements (admissions and re-admissions)",
        )
        self._c_evictions = self.metrics.counter(
            "registry_evictions_total",
            "tenants evicted to make device-memory headroom",
        )
        self._c_quota_rejections = self.metrics.counter(
            "registry_quota_rejections_total",
            "submits refused by a tenant's max_in_flight quota",
        )
        self._c_overshoots = self.metrics.counter(
            "registry_budget_overshoots_total",
            "charges that breached the budget (every resident tenant "
            "pinned or mid-submit — soft-budget admissions)",
        )
        self._c_pins = self.metrics.counter(
            "registry_pins_total", "pin() calls"
        )
        self._c_native_fallbacks = self.metrics.counter(
            "registry_native_fallback_charges_total",
            "degradation-ladder native safe-tier placements charged to "
            "their tenant (the footprint a degraded dispatch adds)",
        )
        self._c_prefetches = self.metrics.counter(
            "registry_prefetches_total",
            "prefetch() admissions (swap-ins made ahead of a tenant's "
            "next request)",
        )
        # Reshard counters are created on the FIRST migration, so a fleet
        # that never reshards carries no reshard names in its snapshot.
        self._c_reshards = None
        self._c_reshard_bytes = None

    # ---- registration ----

    def _tenant_gauge(self, tenant_id: str, what: str, help_: str):
        return self.metrics.gauge(
            label(f"tenant_{what}", tenant=tenant_id), help_
        )

    def _tenant_counter(self, tenant_id: str, what: str, help_: str):
        return self.metrics.counter(
            label(f"tenant_{what}", tenant=tenant_id), help_
        )

    def _strategy_gauge(self, tenant_id: str, strategy: str):
        return self.metrics.gauge(
            label("tenant_strategy", tenant=tenant_id, strategy=strategy),
            "tenant's current partitioning strategy (info metric; the "
            "active strategy label reads 1)",
        )

    def register(
        self,
        tenant_id: str,
        a,
        *,
        quota: TenantQuota | None = None,
        pinned: bool = False,
        **engine_overrides,
    ) -> TenantHandle:
        """Register one tenant's ``A``. The engine keeps its payload on the
        host (quantization included, on ``A``'s own device) and places
        nothing: no device memory is spent until the tenant's first submit
        (or :meth:`pin`) admits it. Returns the tenant's
        :class:`TenantHandle`.

        ``quota.max_resident_bytes`` is checked here against the engine's
        actual payload footprint; a payload over quota is refused before it
        can ever thrash the budget."""
        _validate_tenant_id(tenant_id)
        bad = _RESERVED_ENGINE_KWARGS.intersection(engine_overrides)
        if bad:
            raise ConfigError(
                f"engine overrides {sorted(bad)} are registry-owned"
            )
        with self._lock:
            if self._closed:
                raise ConfigError("registry is closed")
            if tenant_id in self._tenants:
                raise ConfigError(
                    f"tenant {tenant_id!r} is already registered "
                    "(unregister it first to replace its A)"
                )
        kwargs = dict(self._engine_defaults)
        kwargs.update(engine_overrides)
        engine = MatvecEngine(
            a, self.mesh,
            metrics=self.metrics,
            retain_host=True,
            defer_placement=True,
            label_prefix=f"{tenant_id}/",
            resilience=self._resilience,
            fault_plan=self._fault_plan,
            integrity_gate=self._integrity_gate,
            residency_listener=(
                lambda delta, reason, _tid=tenant_id:
                self._on_residency(_tid, delta, reason)
            ),
            **kwargs,
        )
        if (
            quota is not None
            and quota.max_resident_bytes is not None
            and engine.resident_bytes > quota.max_resident_bytes
        ):
            engine.close()
            raise TenantQuotaError(
                f"tenant {tenant_id!r} payload is {engine.resident_bytes} "
                f"bytes, over its max_resident_bytes="
                f"{quota.max_resident_bytes} quota"
            )
        entry = _Tenant(tenant_id, engine, quota)
        # Per-tenant arrival-rate EWMA: the predicted-demand signal
        # (demand-aware eviction) and a snapshot gauge.
        entry.rate = self.metrics.rate_estimator(
            label("tenant_rate_req_per_s", tenant=tenant_id),
            "EWMA arrival rate of this tenant's offered requests "
            "(admission-rejected demand included)",
            tau_s=self.rate_tau_s,
        )
        entry.g_resident_bytes = self._tenant_gauge(
            tenant_id, "resident_bytes",
            "device-resident bytes charged to this tenant",
        )
        entry.g_pinned = self._tenant_gauge(
            tenant_id, "pinned", "1 while warm-pinned (eviction-exempt)"
        )
        entry.c_requests = self._tenant_counter(
            tenant_id, "requests_total", "registry submits for this tenant"
        )
        entry.c_hits = self._tenant_counter(
            tenant_id, "hits_total", "submits that found A resident"
        )
        entry.c_evictions = self._tenant_counter(
            tenant_id, "evictions_total", "times this tenant was evicted"
        )
        entry.c_evictions_caused = self._tenant_counter(
            tenant_id, "evictions_caused_total",
            "neighbor evictions this tenant's admissions forced",
        )
        entry.c_quota_rejections = self._tenant_counter(
            tenant_id, "quota_rejections_total",
            "submits refused by this tenant's quota",
        )
        # Info gauge: the label set carries the fact (the obs tenants
        # panel's strategy column); a reshard flips the old label to 0 and
        # the new one to 1.
        entry.g_strategy = self._strategy_gauge(
            tenant_id, engine.strategy.name
        )
        entry.g_strategy.set(1)
        with self._lock:
            if self._closed or tenant_id in self._tenants:
                engine.close()
                raise ConfigError(
                    "registry is closed" if self._closed
                    else f"tenant {tenant_id!r} is already registered"
                )
            self._adopt_functions_locked(engine)
            self._tenants[tenant_id] = entry
            self._g_tenants.set(len(self._tenants))
        if pinned:
            self.pin(tenant_id)
        return TenantHandle(self, tenant_id)

    def _adopt_functions_locked(self, engine: MatvecEngine) -> None:
        """Shared functions: the first engine of a signature donates its
        function cache, later ones adopt it. Nothing of the engine's own
        was built in its current layout yet, so adoption is a pointer
        swap."""
        sig = engine.exec_signature()
        cache = self._exec_caches.get(sig)
        if cache is None:
            self._exec_caches[sig] = engine._fns
        else:
            engine._fns = cache

    def unregister(self, tenant_id: str) -> None:
        """Remove a tenant: release its residency (work already queued
        completes unaffected), clear its ledger, close its engine."""
        with self._lock:
            entry = self._entry(tenant_id)
            entry.engine.release_residency()  # the listener re-enters this RLock
            del self._tenants[tenant_id]
            self._g_tenants.set(len(self._tenants))
            self._g_resident_tenants.set(self._resident_count_locked())
        entry.engine.close()

    # ---- accounting (the engine residency listener lands here) ----

    def _on_residency(self, tenant_id: str, delta: int, reason: str) -> None:
        """Ledger update for one ACTUAL residency change — placement,
        release, reshard or the degradation ladder's native safe tier. The
        event's sign drives the COUNTERS; the BYTE ledger reconciles to the
        engine's current footprint instead of applying the delta, because
        listeners fire outside the engine's locks and can arrive out of
        order (a dispatch-path self-heal's notification racing the
        eviction that undid it) — reconciliation converges either way."""
        with self._lock:
            entry = self._tenants.get(tenant_id)
            if entry is None:
                return  # raced an unregister; nothing left to charge
            if delta > 0:
                if reason == "resident":
                    entry.swap_ins += 1
                    self._c_swap_ins.inc()
                elif reason == "native_fallback":
                    self._c_native_fallbacks.inc()
            actual = entry.engine.device_resident_bytes
            if self.accountant.reconcile(tenant_id, actual):
                self._c_overshoots.inc()
            entry.charged_bytes = actual
            entry.g_resident_bytes.set(actual)
            self._g_charged.set(self.accountant.total)
            self._g_resident_tenants.set(self._resident_count_locked())

    def _resident_count_locked(self) -> int:
        return sum(1 for e in self._tenants.values() if e.engine.resident)

    # ---- eviction (bookkeeping under the lock; placements never) ----

    def _mean_payload_locked(self) -> float:
        if not self._tenants:
            return 1.0
        total = sum(e.engine.resident_bytes for e in self._tenants.values())
        return max(1.0, total / len(self._tenants))

    def _victim_score_locked(self, e: _Tenant, mean: float,
                             now: float) -> float:
        """One tenant's eviction score (lowest evicts): recency, plus the
        restore-cost ratio, plus — when ``demand_weight`` is on — the
        tenant's EWMA arrival rate weighed by that same restore ratio. A
        cold estimator (rate 0) reduces the score to the recency+cost
        form."""
        restore_ratio = e.charged_bytes / mean
        score = e.last_used + self.cost_weight * restore_ratio
        if self.demand_weight:
            score += (
                self.demand_weight
                * e.rate.rate_per_s(now=now)
                * restore_ratio
            )
        return score

    def _pick_victim_locked(self, exclude: _Tenant) -> _Tenant | None:
        """Evict the eligible resident tenant with the lowest
        :meth:`_victim_score_locked`. Pinned tenants and tenants mid-submit
        (``active > 0`` — the window between admission and the dispatch
        that needs the placement) are never eligible; futures already
        dispatched need no protection (their work is queued ahead of any
        reuse of the freed memory)."""
        mean = self._mean_payload_locked()
        now = self._clock() if self.demand_weight else 0.0
        best: _Tenant | None = None
        best_score = None
        for e in self._tenants.values():
            if (
                e is exclude or e.pinned or e.active > 0
                or not e.engine.resident
            ):
                continue
            score = self._victim_score_locked(e, mean, now)
            if best_score is None or score < best_score:
                best, best_score = e, score
        return best

    def _evict_for_locked(self, entry: _Tenant) -> None:
        """Make budget headroom for ``entry``'s payload: evict lowest-score
        victims until it fits or no victim remains (then the admission
        proceeds as a counted overshoot — the soft-budget doctrine). The
        freed bytes enter the ledger through the victim's residency
        listener before the next victim is scored. The optional
        ``eviction_listener`` fires per victim under the lock."""
        needed = entry.engine.resident_bytes
        mean = self._mean_payload_locked()
        now = self._clock() if self.demand_weight else 0.0
        while not self.accountant.headroom(needed):
            victim = self._pick_victim_locked(entry)
            if victim is None:
                break
            score = self._victim_score_locked(victim, mean, now)
            victim.engine.release_residency()  # the listener re-enters this RLock
            victim.evictions += 1
            victim.c_evictions.inc()
            self._c_evictions.inc()
            entry.evictions_caused += 1
            entry.c_evictions_caused.inc()
            # A swap-out is a background consequence of the admission that
            # needed headroom: cause_id, never request_id.
            self._timeline.emit(
                "swap_out", cause_id=bound_request_id(),
                tenant=victim.tenant_id, caused_by=entry.tenant_id,
                score=score,
            )
            if self.eviction_listener is not None:
                self.eviction_listener(
                    victim.tenant_id, entry.tenant_id, score,
                    victim.engine.resident_bytes,
                )

    # ---- the serving face ----

    def _entry(self, tenant_id: str) -> _Tenant:
        entry = self._tenants.get(tenant_id)
        if entry is None:
            raise ConfigError(f"unknown tenant {tenant_id!r}")
        return entry

    def submit(self, tenant_id: str, x, **kwargs):
        """Dispatch one request against ``tenant_id``'s resident ``A``
        (``MatvecEngine.submit`` semantics — ``deadline_ms``,
        ``integrity``, ``op=`` solves pass through). Admission happens
        here: quota gate first (a refused request fails its future with
        :class:`TenantQuotaError` BEFORE any dispatch or eviction), then
        residency — a hit dispatches at once; a miss evicts by score under
        the lock and swaps the payload in outside it."""
        with self._lock:
            if self._closed:
                raise ConfigError("registry is closed")
            entry = self._entry(tenant_id)
            entry.requests += 1
            entry.c_requests.inc()
            self._c_requests.inc()
            entry.rate.observe(now=self._clock())  # the demand signal
            quota = entry.quota
            if quota is not None and quota.max_in_flight is not None:
                entry.sweep()
                # entry.active counts submits past this gate whose futures
                # are not yet appended (appending happens under the same
                # lock hold that decrements active), so N threads racing
                # this check cannot overrun the quota.
                if (
                    len(entry.outstanding) + entry.active
                    >= quota.max_in_flight
                ):
                    entry.quota_rejections += 1
                    entry.c_quota_rejections.inc()
                    self._c_quota_rejections.inc()
                    return MatvecFuture.failed(TenantQuotaError(
                        f"tenant {tenant_id!r} has "
                        f"{len(entry.outstanding)} requests in flight, "
                        f"at its max_in_flight={quota.max_in_flight} "
                        "quota; re-submit after materializing results"
                    ))
            entry.last_used = next(self._serial)
            hit = entry.engine.resident
            if hit:
                entry.hits += 1
                entry.c_hits.inc()
                self._c_hits.inc()
            else:
                self._evict_for_locked(entry)
            entry.active += 1
        fut = None
        try:
            if not hit:
                # The swap-in, outside the lock (the emit adopts the bound
                # request id, so the miss shows inside the request's
                # timeline).
                self._timeline.emit(
                    "swap_in", tenant=tenant_id,
                    restore_bytes=entry.engine.resident_bytes,
                )
                entry.engine.ensure_resident()
            fut = entry.engine.submit(x, **kwargs)
        finally:
            with self._lock:
                # One lock hold for both: the quota gate reads outstanding
                # + active, so the future is appended before active drops.
                entry.active -= 1
                if fut is not None and (
                    entry.quota is not None
                    and entry.quota.max_in_flight is not None
                ):
                    entry.outstanding.append(fut)
        return fut

    def __call__(self, tenant_id: str, x):
        """Synchronous convenience: ``submit(tenant_id, x).result()``."""
        return self.submit(tenant_id, x).result()

    # ---- pinning ----

    def pin(self, tenant_id: str) -> None:
        """Warm-pin: admit the tenant now (evicting by score if needed)
        and exempt it from eviction until :meth:`unpin`."""
        with self._lock:
            entry = self._entry(tenant_id)
            entry.pinned = True
            entry.g_pinned.set(1)
            entry.last_used = next(self._serial)
            self._c_pins.inc()
            if not entry.engine.resident:
                self._evict_for_locked(entry)
            entry.active += 1
        try:
            entry.engine.ensure_resident()
        finally:
            with self._lock:
                entry.active -= 1

    def unpin(self, tenant_id: str) -> None:
        with self._lock:
            entry = self._entry(tenant_id)
            entry.pinned = False
            entry.g_pinned.set(0)

    # ---- demand terms (the global scheduler's hooks) ----

    def observe_demand(self, tenant_id: str, n: int = 1) -> None:
        """Tick a tenant's demand estimator WITHOUT a submit — for
        requests a scheduler refused, so a tenant being refused under load
        still reads as hot demand to the eviction score."""
        with self._lock:
            self._entry(tenant_id).rate.observe(n, now=self._clock())

    def demand_rate(self, tenant_id: str) -> float:
        """The tenant's EWMA offered-request rate (req/s, idle-decayed)."""
        with self._lock:
            entry = self._entry(tenant_id)
        return entry.rate.rate_per_s(now=self._clock())

    def coalesce_group(self, tenant_id: str) -> tuple:
        """The tenant's cross-tenant coalescing identity: its engine's exec
        signature plus the sha256 of its host ``A``. Tenants in one group
        run the same functions over the same ``A`` bytes, so their requests
        may share one column-stacked flush with bitwise the per-column
        results. The hash is computed on first use and cached (the host A
        is immutable for the tenant's life, so a racing duplicate
        computation is idempotent)."""
        with self._lock:
            entry = self._entry(tenant_id)
            sha = entry.payload_sha
        if not sha:
            host = entry.engine._a_host.contiguous()
            sha = hashlib.sha256(
                host.view(torch.uint8).numpy() if host.numel() else b""
            ).hexdigest()
            with self._lock:
                entry.payload_sha = sha
        return (entry.engine.exec_signature(), sha)

    def prefetch(self, tenant_id: str, *, protect: str | None = None)\
            -> bool:
        """Swap a tenant's payload in NOW (evict by score if needed)
        without pinning it, ahead of its next request. Returns True when
        this call placed the payload (False: already resident). The
        prefetch counts as an anticipated USE (recency bumped) so the next
        admission does not immediately re-evict it, and ``protect`` shields
        one tenant — the one whose dispatch the swap-in should overlap —
        from being chosen as the victim. The copy itself runs outside the
        lock."""
        with self._lock:
            entry = self._entry(tenant_id)
            if entry.engine.resident:
                return False
            guard = (
                self._tenants.get(protect)
                if protect is not None else None
            )
            if guard is not None:
                guard.active += 1  # victim-ineligible for this pick only
            try:
                self._evict_for_locked(entry)
            finally:
                if guard is not None:
                    guard.active -= 1
            entry.last_used = next(self._serial)
            entry.active += 1
        try:
            placed = entry.engine.ensure_resident()
        finally:
            with self._lock:
                entry.active -= 1
        if placed:
            self._c_prefetches.inc()
            self._timeline.emit(
                "prefetch", cause_id=bound_request_id(),
                tenant=tenant_id, protect=protect,
            )
        return placed

    def reshard(
        self, tenant_id: str, strategy, *, warm_widths=None
    ) -> dict | None:
        """Migrate one tenant's resident ``A`` to another strategy on the
        card (``MatvecEngine.reshard``) and re-home its function cache
        under the new exec signature — the same first-donates/later-adopts
        idiom as :meth:`register`, so same-shaped tenants already serving
        in the destination layout hand this one their functions. The
        migration runs OUTSIDE the registry lock; eviction stays legal
        throughout — an eviction landing mid-migration aborts the copy at
        the engine's commit, so the ledger never carries a double
        footprint. Returns the engine's migration summary, or None when
        the tenant is already mid-reshard or already in the destination
        layout. ``warm_widths`` builds the destination's programs after
        the re-home."""
        with self._lock:
            if self._closed:
                raise ConfigError("registry is closed")
            entry = self._entry(tenant_id)
            engine = entry.engine
            dst_name = (
                strategy if isinstance(strategy, str) else strategy.name
            )
            if entry.resharding or engine.strategy.name == dst_name:
                return None
            entry.resharding = True
        try:
            result = engine.reshard(strategy)
        finally:
            with self._lock:
                entry.resharding = False
        with self._lock:
            self._adopt_functions_locked(engine)
            entry.reshards += 1
            if entry.g_strategy is not None:
                entry.g_strategy.set(0)
            entry.g_strategy = self._strategy_gauge(
                tenant_id, engine.strategy.name
            )
            entry.g_strategy.set(1)
            if self._c_reshards is None:
                self._c_reshards = self.metrics.counter(
                    "registry_reshards_total",
                    "completed online strategy migrations (config-only "
                    "and aborted swaps included)",
                )
                self._c_reshard_bytes = self.metrics.counter(
                    "reshard_bytes_total",
                    "payload bytes redistributed by reshard programs "
                    "(requantized and aborted swaps move 0)",
                )
            self._c_reshards.inc()
            self._c_reshard_bytes.inc(int(result.get("bytes_moved", 0)))
        self._timeline.emit(
            "reshard_apply", cause_id=bound_request_id(),
            tenant=tenant_id, dst=engine.strategy.name,
            bytes_moved=int(result.get("bytes_moved", 0)),
        )
        if warm_widths is not None:
            engine.warmup(widths=warm_widths)
        return result

    # ---- warmup, stats, health ----

    def warmup(self, widths: Sequence[int] | None = None) -> int:
        """Build the strategy functions ONCE per distinct exec signature
        (shared function caches make that the whole fleet's warmup). A
        tenant not resident needs no placement for it; a resident one
        builds and captures its programs. Returns fresh builds."""
        with self._lock:
            engines: dict[tuple, MatvecEngine] = {}
            for e in self._tenants.values():
                engines.setdefault(e.engine.exec_signature(), e.engine)
            todo = list(engines.values())
        return sum(engine.warmup(widths) for engine in todo)

    def tenant_ids(self) -> list[str]:
        with self._lock:
            return list(self._tenants)

    def __len__(self) -> int:
        with self._lock:
            return len(self._tenants)

    def tenant_stats(self, tenant_id: str) -> dict:
        with self._lock:
            e = self._entry(tenant_id)
            return {
                "tenant": tenant_id,
                "strategy": e.engine.strategy.name,
                "resident": e.engine.resident,
                "resharding": e.resharding,
                "resident_bytes": e.charged_bytes,
                "payload_bytes": e.engine.resident_bytes,
                "pinned": e.pinned,
                "requests": e.requests,
                "hits": e.hits,
                "swap_ins": e.swap_ins,
                "reshards": e.reshards,
                "evictions": e.evictions,
                "evictions_caused": e.evictions_caused,
                "quota_rejections": e.quota_rejections,
            }

    def health(self) -> dict:
        """Fleet snapshot: the device-memory ledger plus one entry per
        tenant — the registry-side counters next to the tenant engine's
        resilience summary (breakers not closed, degraded configs). The obs
        ``tenants`` panel renders the same numbers from the metrics
        snapshot."""
        with self._lock:
            entries = list(self._tenants.values())
            hbm = {
                "budget_bytes": self.accountant.budget,
                "charged_bytes": self.accountant.total,
                "overshoots": self.accountant.overshoots,
                "per_tenant": dict(self.accountant.charged),
            }
            stats = [self.tenant_stats(e.tenant_id) for e in entries]
        tenants = {}
        for e, stat in zip(entries, stats):
            eh = e.engine.health()
            stat["breakers_open"] = sum(
                1 for snap in eh["breakers"].values()
                if snap["state"] != "closed"
            )
            stat["degraded"] = eh["degraded"]
            stat["native_fallback_resident"] = (
                eh["storage"]["native_fallback_resident"]
            )
            tenants[e.tenant_id] = stat
        return {"hbm": hbm, "tenants": tenants}

    # ---- lifecycle ----

    def close(self) -> None:
        """Retire the fleet: release every residency (work already queued
        completes on its own), close every tenant engine (idempotent and
        exception-safe even with failed in-flight futures —
        ``MatvecEngine.close``). A second close is a no-op; submits after
        close raise."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            entries = list(self._tenants.values())
            for e in entries:
                e.engine.release_residency()  # the listener re-enters this RLock
            self._tenants.clear()
            self._g_tenants.set(0)
            self._g_resident_tenants.set(0)
        for e in entries:
            e.engine.close()
