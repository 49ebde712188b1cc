"""Declarative SLO targets with multi-window burn-rate alerting.

An SLO is a promise over a window ("99.9% of offered requests succeed"),
and the operational question is never "what is the instantaneous error
rate" but "how fast is the error *budget* burning". This module
evaluates declared targets from an existing
:class:`~.registry.MetricsRegistry` — no new instrumentation, the
counters and gauges the stack already maintains ARE the SLIs — using
the standard SRE multi-window, multi-burn-rate recipe:

* **burn rate** = (window error fraction) / (budget fraction). Burn 1.0
  consumes exactly the budget over the SLO period; burn 14.4 over 5
  minutes consumes a 30-day 99.9% budget in ~2 hours.
* **page** when the fast pair breaches: burn > 14.4 on BOTH the 5 m and
  1 h windows (the long window filters blips, the short window resets
  the alert promptly once the incident ends);
* **ticket** when the slow pair breaches: burn > 6 on BOTH 1 h and 6 h.

Two target kinds cover the declared SLOs:

* ``availability`` — ratio of summed *bad* counters to summed *total*
  counters, windowed by cumulative-sample deltas;
* ``threshold`` — a gauge or histogram percentile compared to a bound
  (e2e p99, escalation rate, cost-model divergence); its window error
  fraction is the fraction of samples in the window observed in breach,
  so the same burn algebra applies with a declared time-in-breach
  budget.

The monitor is sampling-based: ``sample()`` records one cumulative
observation, ``evaluate()`` answers from the retained samples and exports
``slo_*`` gauges back into the registry (bounded cardinality — the
declared target names). Nothing here touches the dispatch path: sampling
and evaluation run from ``health()``, the serve bench or a CLI.

The port's copy of the JAX package's ``obs/slo.py``. The clock is
``time.time``; no caller of the port sets another, so it is not a
parameter: ``sample(now=)`` and ``evaluate(now=)`` take a time, and tests
set ``monitor._clock``. The cost model's divergence gauge feeds
``cost_model_divergence`` once a prediction is recorded, and a
speculative engine's ``engine_escalation_rate`` the escalation targets (an
engine that is not armed exports none, and they evaluate as ``no_data``).
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from .registry import MetricsRegistry

__all__ = [
    "ALERT_POLICIES",
    "DEFAULT_TARGETS",
    "ENGINE_TARGETS",
    "SloMonitor",
    "SloTarget",
    "WINDOWS_S",
]

# The evaluation windows, by display name. 5m/1h is the fast (paging)
# pair, 1h/6h the slow (ticket) pair.
WINDOWS_S = {"5m": 300.0, "1h": 3600.0, "6h": 21600.0}

# (severity, short window, long window, burn threshold): an alert fires
# when burn exceeds the threshold on BOTH windows of its pair.
ALERT_POLICIES = (
    ("page", "5m", "1h", 14.4),
    ("ticket", "1h", "6h", 6.0),
)


@dataclasses.dataclass(frozen=True)
class SloTarget:
    """One declared objective, evaluated from registry names.

    ``availability`` kind: ``objective`` is the success-ratio promise
    (0.999), ``total``/``bad`` name the counters to sum for the
    denominator/numerator, and the budget fraction is ``1 -
    objective``. ``threshold`` kind: ``source`` names a gauge (or a
    histogram, with ``percentile``) compared against ``objective`` as
    an upper bound, and ``budget`` is the allowed fraction of time in
    breach."""

    name: str
    kind: str                       # "availability" | "threshold"
    objective: float
    total: tuple[str, ...] = ()     # availability: offered-request counters
    bad: tuple[str, ...] = ()       # availability: failed-request counters
    source: str | None = None       # threshold: gauge or histogram name
    percentile: int | None = None   # threshold: histogram percentile (50/95/99)
    budget: float | None = None     # threshold: allowed breach-time fraction
    description: str = ""

    def __post_init__(self):
        if self.kind not in ("availability", "threshold"):
            raise ValueError(f"unknown SLO kind {self.kind!r}")
        if self.kind == "availability":
            if not (0.0 < self.objective < 1.0):
                raise ValueError(
                    f"availability objective must be in (0, 1), got "
                    f"{self.objective}"
                )
            if not self.total or not self.bad:
                raise ValueError(
                    f"availability SLO {self.name!r} needs total and bad "
                    "counter names"
                )
        else:
            if self.source is None:
                raise ValueError(
                    f"threshold SLO {self.name!r} needs a source metric"
                )

    @property
    def budget_fraction(self) -> float:
        if self.kind == "availability":
            return 1.0 - self.objective
        return self.budget if self.budget is not None else 0.05


# The serve-capture targets (the chaos/demo vocabulary: the steady-phase
# offered/failed counters are the availability SLI by the same doctrine
# as the obs `resilience` panel).
DEFAULT_TARGETS = (
    SloTarget(
        name="availability", kind="availability", objective=0.999,
        total=("serve_requests_total",),
        bad=("serve_failed_requests_total",),
        description="steady-phase requests that materialized",
    ),
    SloTarget(
        name="e2e_p99_ms", kind="threshold", objective=50.0,
        source="serve_e2e_latency_ms", percentile=99, budget=0.05,
        description="steady-phase e2e p99 under the declared bound",
    ),
    SloTarget(
        name="escalation_rate", kind="threshold", objective=0.05,
        source="engine_escalation_rate", budget=0.05,
        description="speculative-tier escalation EWMA under the "
                    "acceptance bound",
    ),
    SloTarget(
        name="cost_model_divergence", kind="threshold", objective=1.0,
        source="tuning_cost_model_divergence", budget=0.05,
        description="cost-model |log10(predicted/measured)| EWMA under "
                    "one decade",
    ),
)

# The engine-local targets (``engine.health()["slo"]``): same promises
# against the engine's own failure counters — no serve bench required.
# Engine-local targets carry an engine_ prefix: an engine's registry is
# often the serve bench's registry too, and the exported slo_<name>_*
# gauges share that one namespace — same-named targets in two monitors
# would overwrite each other's verdicts.
ENGINE_TARGETS = (
    SloTarget(
        name="engine_availability", kind="availability", objective=0.999,
        total=("engine_requests_total",),
        bad=(
            "engine_dispatch_failures_total",
            "engine_integrity_failures_total",
            "engine_deadline_failures_total",
        ),
        description="submitted requests that dispatched and materialized",
    ),
    SloTarget(
        name="engine_escalation_rate", kind="threshold", objective=0.05,
        source="engine_escalation_rate", budget=0.05,
        description="speculative-tier escalation EWMA under the "
                    "acceptance bound",
    ),
)


class SloMonitor:
    """Sample-and-evaluate burn-rate engine over one registry.

    ``sample()`` reads the registry once and retains (t, cumulative
    counters, instantaneous values); ``evaluate()`` computes per-window
    error fractions and burn rates from the retained ring, fires the
    multi-window alert policies, and exports ``slo_<name>_burn_<w>`` /
    ``slo_<name>_alert`` gauges (0 ok / 1 ticket / 2 page / -1 no
    data). ``time.time`` is the clock (tests set ``_clock`` to replay hours
    of burn history in milliseconds)."""

    def __init__(
        self,
        registry: MetricsRegistry,
        targets: tuple[SloTarget, ...] = DEFAULT_TARGETS,
        *,
        capacity: int = 4096,
    ):
        names = [t.name for t in targets]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate SLO target names: {names}")
        self.registry = registry
        self.targets = tuple(targets)
        self._clock = time.time
        self._samples: deque[dict] = deque(maxlen=capacity)
        # Gauge handles up front: declared target names x fixed windows
        # is bounded by construction, and evaluate() then touches no
        # registry locks beyond the per-gauge sets.
        self._g_burn = {
            (t.name, w): registry.gauge(  # cardinality-ok: declared SLO targets x the fixed windows, bounded at construction
                f"slo_{t.name}_burn_{w}",
                f"error-budget burn rate of {t.name} over {w}",
            )
            for t in self.targets for w in WINDOWS_S
        }
        self._g_alert = {
            t.name: registry.gauge(  # cardinality-ok: one gauge per declared SLO target, bounded at construction
                f"slo_{t.name}_alert",
                f"alert state of {t.name}: 0 ok, 1 ticket, 2 page, "
                "-1 no data",
            )
            for t in self.targets
        }

    # ------------------------------------------------------------ sampling

    def sample(self, now: float | None = None) -> dict:
        """Record one observation of every target's SLI sources."""
        if now is None:
            now = self._clock()
        snap = self.registry.snapshot()
        counters = snap.get("counters", {})
        gauges = snap.get("gauges", {})
        hists = snap.get("histograms", {})
        record: dict = {"t": now, "counters": {}, "values": {}}
        for t in self.targets:
            if t.kind == "availability":
                for name in t.total + t.bad:
                    record["counters"][name] = counters.get(name, 0)
            else:
                record["values"][t.name] = self._read_value(
                    t, gauges, hists
                )
        self._samples.append(record)
        return record

    @staticmethod
    def _read_value(t: SloTarget, gauges: dict, hists: dict):
        if t.source in gauges:
            return gauges[t.source]
        summ = hists.get(t.source)
        if summ is not None:
            q = t.percentile if t.percentile is not None else 99
            v = summ.get(f"p{q}")
            # An empty histogram reports NaN percentiles: no evidence.
            if v is not None and v == v:
                return v
        return None

    # ---------------------------------------------------------- evaluation

    def _window_samples(self, now: float, window_s: float) -> list[dict]:
        return [s for s in self._samples if s["t"] > now - window_s]

    def _baseline(self, now: float, window_s: float) -> dict | None:
        """The cumulative-counter baseline for a window: the newest
        sample at or before the window start, else the oldest retained
        sample (a partial window reads as the traffic it saw)."""
        base = None
        for s in self._samples:
            if s["t"] <= now - window_s:
                base = s
            else:
                break
        if base is None and self._samples:
            base = self._samples[0]
        return base

    def _window_error(
        self, t: SloTarget, now: float, window_s: float
    ) -> float | None:
        """The error fraction of one target over one window, or None
        when the window holds no evidence."""
        if t.kind == "availability":
            base = self._baseline(now, window_s)
            if base is None or not self._samples:
                return None
            cur = self._samples[-1]["counters"]
            ref = base["counters"]
            total = sum(
                cur.get(n, 0) - ref.get(n, 0) for n in t.total
            )
            if total <= 0:
                return None
            bad = sum(cur.get(n, 0) - ref.get(n, 0) for n in t.bad)
            return min(1.0, max(0.0, bad / total))
        window = self._window_samples(now, window_s)
        flags = [
            float(s["values"][t.name] > t.objective)
            for s in window
            if s["values"].get(t.name) is not None
        ]
        if not flags:
            return None
        return sum(flags) / len(flags)

    def evaluate(self, now: float | None = None) -> dict:
        """Burn rates, alert states, and gauge export — the
        ``engine.health()["slo"]`` block, the ``obs slo`` panel's JSON,
        and the demo capture's ``slo.json``."""
        if now is None:
            now = self._clock()
        targets: dict[str, dict] = {}
        fired: list[dict] = []
        for t in self.targets:
            budget = t.budget_fraction
            errors: dict[str, float | None] = {}
            burn: dict[str, float | None] = {}
            for w, span in WINDOWS_S.items():
                err = self._window_error(t, now, span)
                errors[w] = err
                burn[w] = None if err is None else err / budget
            alerts = []
            for severity, short, long_, threshold in ALERT_POLICIES:
                bs, bl = burn[short], burn[long_]
                if bs is not None and bl is not None and (
                    bs > threshold and bl > threshold
                ):
                    alerts.append({
                        "slo": t.name,
                        "severity": severity,
                        "short": short,
                        "long": long_,
                        "burn_short": bs,
                        "burn_long": bl,
                        "threshold": threshold,
                    })
            if all(b is None for b in burn.values()):
                status, level = "no_data", -1.0
            elif any(a["severity"] == "page" for a in alerts):
                status, level = "page", 2.0
            elif alerts:
                status, level = "ticket", 1.0
            else:
                status, level = "ok", 0.0
            current = None
            if t.kind == "threshold" and self._samples:
                current = self._samples[-1]["values"].get(t.name)
            targets[t.name] = {
                "kind": t.kind,
                "objective": t.objective,
                "budget": budget,
                "description": t.description,
                "value": current,
                "errors": errors,
                "burn": burn,
                "status": status,
                "alerts": alerts,
            }
            fired.extend(alerts)
            for w in WINDOWS_S:
                self._g_burn[(t.name, w)].set(
                    burn[w] if burn[w] is not None else 0.0
                )
            self._g_alert[t.name].set(level)
        return {"t_s": now, "targets": targets, "alerts": fired}
