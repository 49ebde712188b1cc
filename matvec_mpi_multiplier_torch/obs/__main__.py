"""Obs CLI: render a metrics snapshot, summarize a JSONL request trace,
replay one request's causal timeline, render an SLO evaluation, or open
a flight-recorder bundle.

The port's copy of the JAX package's ``obs/__main__.py``: the same
subcommands and the same text, so a capture of either package renders the
same way. The storage panel renders the speculative tier's dispatches,
escalations and escalation rate; the tenants, global scheduler and cost
model panels render the registry's, the scheduler's and the tuner's
metrics.

Usage::

    python -m matvec_mpi_multiplier_torch.obs metrics metrics.json
    python -m matvec_mpi_multiplier_torch.obs metrics metrics.json --prometheus
    python -m matvec_mpi_multiplier_torch.obs metrics live.json --watch 2
    python -m matvec_mpi_multiplier_torch.obs trace trace.jsonl --top 5
    python -m matvec_mpi_multiplier_torch.obs timeline events.jsonl 17
    python -m matvec_mpi_multiplier_torch.obs slo slo.json
    python -m matvec_mpi_multiplier_torch.obs dump flight/flight_000_dispatch_failed.json

``metrics`` pretty-prints a ``MetricsRegistry.snapshot()`` JSON (the
``--metrics-out`` payload of ``bench/serve.py``); ``--watch N``
re-reads and re-renders the file every N seconds until interrupted (live
dashboards over a snapshot the serve loop rewrites). ``trace`` aggregates a
request-trace JSONL (the ``--trace-jsonl`` payload): per-phase time
breakdown across every span tree, and the top-k slowest requests with
their per-phase split; ``--since T`` drops records stamped before the
epoch-seconds cutoff. ``timeline`` reconstructs one request's causal
story from an event JSONL (a :class:`~.timeline.TimelineHub` sink
capture, or a flight bundle's ``events``): every event carrying the
request id, plus the background actions its admission caused
(``cause_id``), plus the batch events it rode (one-hop ``members``
expansion — ``obs/timeline.py``). ``slo`` renders an
``SloMonitor.evaluate()`` JSON as the burn-rate panel; ``dump`` opens a
flight-recorder bundle (``obs/flight.py``).

This is a command-line tool: it reads files freely.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time
from pathlib import Path


def _fmt_ms(v: float) -> str:
    if v is None or (isinstance(v, float) and math.isnan(v)):
        return "nan"
    return f"{v:.3f}ms"


def render_batching(snapshot: dict) -> str | None:
    """The batching panel: coalescing efficiency read off the scheduler's
    ``sched_*`` metrics (``engine/scheduler.py``). None when the snapshot
    holds no scheduler counters (a run without coalescing)."""
    counters = snapshot.get("counters", {})
    if "sched_batches_total" not in counters:
        return None
    gauges = snapshot.get("gauges", {})
    requests = counters.get("sched_requests_total", 0)
    batches = counters.get("sched_batches_total", 0)
    coalesced = counters.get("sched_coalesced_requests_total", 0)
    width = snapshot.get("histograms", {}).get("sched_batch_width", {})
    mean_width = (
        width["sum"] / width["count"] if width.get("count") else float("nan")
    )
    out = [
        "batching:",
        f"  requests          {requests} "
        f"({counters.get('sched_bypass_total', 0)} bypassed, "
        f"{counters.get('sched_deadline_failures_total', 0)} deadline-"
        "failed)",
        f"  batches           {batches}",
        f"  mean batch width  {mean_width:.2f}",
        f"  coalesce ratio    "
        f"{(coalesced / requests) if requests else float('nan'):.2f} "
        "(requests that shared a dispatch)",
        f"  window            "
        f"{gauges.get('sched_coalesce_window_ms', float('nan')):.3f}ms "
        f"@ {gauges.get('sched_arrival_req_per_s', float('nan')):.1f} "
        "req/s",
        f"  amortized bytes   "
        f"{counters.get('sched_amortized_bytes_total', 0):.3e} "
        "(A re-reads coalescing avoided)",
    ]
    return "\n".join(out)


def render_storage(snapshot: dict) -> str | None:
    """The storage panel: the resident-A format, its HBM payload, WHY the
    engine landed on that format (the ``reason`` label — "explicit" vs
    "tuned" vs "auto_degraded", so a silent speculation-disable is
    visible), and the speculative tier's dispatch/escalation story, read
    off ``engine_resident_bytes``, the ``engine_storage_format{...}``
    info gauge, and the ``engine_storage_fallbacks_total`` /
    ``engine_speculative_*`` / ``engine_escalation*`` metrics
    (engine/core.py; docs/QUANTIZATION.md). None when the snapshot
    predates the storage axis (no resident-bytes gauge)."""
    gauges = snapshot.get("gauges", {})
    if "engine_resident_bytes" not in gauges:
        return None
    counters = snapshot.get("counters", {})
    resident = gauges["engine_resident_bytes"]
    fmt, dtype, reason = "native", "?", None
    for name in gauges:
        if name.startswith("engine_storage_format{"):
            # Prometheus-style info metric: the label set carries the fact.
            labels = dict(
                part.split("=", 1)
                for part in name[name.index("{") + 1:name.rindex("}")].split(",")
            )
            fmt = labels.get("format", "native").strip('"')
            dtype = labels.get("dtype", "?").strip('"')
            reason = labels.get("reason", "").strip('"') or None
    out = [
        "storage:",
        f"  format          {fmt} (operand dtype {dtype})"
        + (f" [{reason}]" if reason else ""),
        f"  resident bytes  {resident:.3e} "
        + ("(quantized payload + per-block scales)" if fmt != "native"
           else "(full-width A)"),
    ]
    if reason == "auto_degraded" or "engine_storage_fallbacks_total" in counters:
        fallbacks = counters.get("engine_storage_fallbacks_total", 0)
        out.append(
            f"  fallbacks       {fallbacks} "
            "(requested format degraded to native — "
            + ("SILENT speculation/quantization disable"
               if reason == "auto_degraded" else "per-request tier misses")
            + ")"
        )
    if "engine_speculative_dispatches_total" in counters:
        spec = counters.get("engine_speculative_dispatches_total", 0)
        esc = counters.get("engine_escalations_total", 0)
        rate = gauges.get("engine_escalation_rate", float("nan"))
        out.append(
            f"  speculative     {spec} dispatches, {esc} escalations "
            f"(rate {rate:.4f} — the cost model's ε feed; "
            "docs/QUANTIZATION.md: reading the escalation gauge)"
        )
    return "\n".join(out)


def _labeled(metrics: dict, prefix: str) -> dict[str, dict[str, float]]:
    """Parse ``<prefix><what>{tenant="X"}`` metric names into
    ``{tenant: {what: value}}`` (Prometheus-style labeled names — the
    registry's per-tenant vocabulary, engine/registry.py)."""
    out: dict[str, dict[str, float]] = {}
    for name, value in metrics.items():
        if not name.startswith(prefix) or "{" not in name:
            continue
        what = name[len(prefix):name.index("{")]
        labels = dict(
            part.split("=", 1)
            for part in name[name.index("{") + 1:name.rindex("}")].split(",")
        )
        tenant = labels.get("tenant", "?").strip('"')
        out.setdefault(tenant, {})[what] = value
    return out


def render_tenants(snapshot: dict) -> str | None:
    """The tenants panel: the multi-tenant registry's HBM ledger and
    per-tenant residency/hit/evict/quota table, read off the
    ``registry_*`` and ``tenant_*{tenant="..."}`` metrics
    (engine/registry.py; docs/MULTITENANT.md). Mirrors
    ``MatrixRegistry.health()``. None when the snapshot carries no
    registry vocabulary (a single-tenant run)."""
    gauges = snapshot.get("gauges", {})
    if "registry_tenants" not in gauges:
        return None
    counters = snapshot.get("counters", {})
    budget = gauges.get("registry_hbm_budget_bytes", 0)
    requests = counters.get("registry_requests_total", 0)
    hits = counters.get("registry_hits_total", 0)
    out = [
        "tenants:",
        f"  registered        {gauges.get('registry_tenants', 0):.0f} "
        f"({gauges.get('registry_tenants_resident', 0):.0f} resident)",
        f"  hbm               "
        f"{gauges.get('registry_hbm_charged_bytes', 0):.3e} of "
        + (f"{budget:.3e} budget" if budget else "unlimited budget")
        + f" ({counters.get('registry_budget_overshoots_total', 0)} "
        "overshoots)",
        f"  hit rate          "
        f"{(hits / requests) if requests else float('nan'):.3f} "
        f"({hits} of {requests} submits found A resident)",
        f"  swap-ins          "
        f"{counters.get('registry_swap_ins_total', 0)} "
        f"(evictions {counters.get('registry_evictions_total', 0)}, "
        f"pins {counters.get('registry_pins_total', 0)})",
        f"  quota rejections  "
        f"{counters.get('registry_quota_rejections_total', 0)}",
        f"  native fallbacks  "
        f"{counters.get('registry_native_fallback_charges_total', 0)} "
        "(degraded-tier placements charged to their tenant)",
        f"  reshards          "
        f"{counters.get('registry_reshards_total', 0)} "
        f"({counters.get('reshard_bytes_total', 0):.3e} payload bytes "
        "migrated on-device; docs/RESHARDING.md)",
    ]
    per = _labeled(counters, "tenant_")
    for tenant, vals in _labeled(gauges, "tenant_").items():
        per.setdefault(tenant, {}).update(vals)
    # Each tenant's CURRENT layout: tenant_strategy{tenant=...,strategy=...}
    # is a one-hot gauge family (1 on the live layout, 0 on layouts the
    # tenant migrated away from — engine/registry.py), so the column shows
    # the strategy label whose gauge reads 1.
    strategy_of: dict[str, str] = {}
    for name, value in gauges.items():
        if not name.startswith("tenant_strategy{") or not value:
            continue
        labels = dict(
            part.split("=", 1)
            for part in name[name.index("{") + 1:name.rindex("}")].split(",")
        )
        strategy_of[labels.get("tenant", "?").strip('"')] = labels.get(
            "strategy", "?"
        ).strip('"')
    if per:
        width = max(len(t) for t in per)
        swidth = max(
            [len("strategy")] + [len(s) for s in strategy_of.values()]
        )
        out.append(
            f"  {'tenant':<{width}}  {'strategy':<{swidth}}  "
            "resident_bytes  requests  hits  evicted  caused  "
            "quota_rej  pinned"
        )
        for tenant in sorted(per):
            v = per[tenant]
            out.append(
                f"  {tenant:<{width}}  "
                f"{strategy_of.get(tenant, '-'):<{swidth}}  "
                f"{v.get('resident_bytes', 0):>14.3e}  "
                f"{v.get('requests_total', 0):>8.0f}  "
                f"{v.get('hits_total', 0):>4.0f}  "
                f"{v.get('evictions_total', 0):>7.0f}  "
                f"{v.get('evictions_caused_total', 0):>6.0f}  "
                f"{v.get('quota_rejections_total', 0):>9.0f}  "
                f"{v.get('pinned', 0):>6.0f}"
            )
    return "\n".join(out)


def render_gsched(snapshot: dict) -> str | None:
    """The global scheduler panel: the decision mix (admit / reject /
    interleave / evict / flush), the predicted-dispatch distribution and
    the predicted queue depth, read off the ``gsched_*`` metrics
    (engine/global_scheduler.py; docs/SCHEDULING.md explains reading a
    rejection trace). None when the snapshot carries no global-scheduler
    vocabulary (a greedy run)."""
    counters = snapshot.get("counters", {})
    if "gsched_decisions_total" not in counters:
        return None
    gauges = snapshot.get("gauges", {})
    hists = snapshot.get("histograms", {})
    predicted = hists.get("gsched_predicted_dispatch_ms", {})
    admits = counters.get("gsched_admits_total", 0)
    rejects = counters.get("gsched_rejects_total", 0)
    offered = admits + rejects
    greedy = gauges.get("gsched_degraded_greedy", 0)
    out = [
        "global scheduler:",
        f"  decisions         {counters.get('gsched_decisions_total', 0)}"
        + (" [DEGRADED: greedy — cost model uncalibrated]" if greedy
           else ""),
        f"  admits            {admits}",
        f"  rejects           {rejects} (typed, pre-dispatch; "
        f"{(rejects / offered) if offered else float('nan'):.3f} of "
        "offered — rejected != failed)",
        f"  interleaves       "
        f"{counters.get('gsched_interleaves_total', 0)} "
        "(swap-ins overlapped under predicted-long dispatches)",
        f"  evict decisions   {counters.get('gsched_evictions_total', 0)} "
        "(demand-aware victim picks in the trace)",
        f"  flushes           {counters.get('gsched_flushes_total', 0)} "
        f"(cross-tenant coalesced requests "
        f"{counters.get('sched_cross_tenant_coalesced_total', 0)})",
        f"  predicted p50     "
        f"{_fmt_ms(predicted.get('p50'))} per dispatch "
        f"(p95 {_fmt_ms(predicted.get('p95'))}, "
        f"n={predicted.get('count', 0)})",
        f"  queue predicted   "
        f"{gauges.get('gsched_queue_predicted_s', 0) * 1e3:.3f}ms "
        "backlog at last admission",
    ]
    return "\n".join(out)


def render_resilience(snapshot: dict) -> str | None:
    """The resilience panel: fault-injection volume, recovery activity
    (retries, downgrades, breaker opens/recoveries), blast-radius
    isolation (bisection splits / isolated failures) and integrity-gate
    refusals, read off the ``resil_*`` / ``sched_bisect_*`` /
    ``engine_integrity_*`` metrics (engine/core.py, engine/scheduler.py;
    docs/RESILIENCE.md explains how to read it). None when the snapshot
    carries no resilience vocabulary (a run without faults, policy, or
    gate)."""
    counters = snapshot.get("counters", {})
    trigger_keys = (
        "resil_faults_injected_total",
        "resil_retries_total",
        "engine_integrity_failures_total",
    )
    if not any(k in counters for k in trigger_keys):
        return None
    gauges = snapshot.get("gauges", {})
    failed = counters.get("serve_failed_requests_total")
    out = ["resilience:"]
    if failed is not None:
        # Denominator preference: the serve bench's steady-phase offered
        # count; then the scheduler's (warmup never routes through it);
        # engine_requests_total last — it includes warmup submits, so an
        # old uncoalesced snapshot reads slightly optimistic.
        requests = counters.get(
            "serve_requests_total",
            counters.get(
                "sched_requests_total",
                counters.get("engine_requests_total", 0),
            ),
        )
        rate = (
            (requests - failed) / requests if requests else float("nan")
        )
        out.append(
            f"  availability      {rate:.4f} "
            f"({failed} fault-failed of {requests})"
        )
        rejected = counters.get("gsched_rejects_total", 0)
        if rejected:
            # Rejected != failed (resilience.is_rejection): a typed
            # pre-dispatch admission refusal is a scheduling outcome,
            # not downtime — it never enters the failed numerator.
            out.append(
                f"  rejected          {rejected} "
                "(typed pre-dispatch admission refusals — not counted "
                "as failures)"
            )
    out += [
        f"  faults injected   "
        f"{counters.get('resil_faults_injected_total', 0)}",
        f"  retries           {counters.get('resil_retries_total', 0)}",
        f"  downgrades        {counters.get('resil_downgrades_total', 0)} "
        "(ladder fallbacks: safe combine / shrunken bucket / GEMV floor)",
        f"  breaker opens     "
        f"{counters.get('resil_breaker_opens_total', 0)} "
        f"(recoveries {counters.get('resil_recoveries_total', 0)}, "
        f"open now {gauges.get('resil_breakers_open', 0):.0f})",
        f"  bisect splits     "
        f"{counters.get('sched_bisect_splits_total', 0)} "
        f"(isolated failures "
        f"{counters.get('sched_isolated_failures_total', 0)}, "
        f"systemic batch failures "
        f"{counters.get('sched_batch_failures_total', 0)})",
        f"  integrity refused "
        f"{counters.get('engine_integrity_failures_total', 0)}",
        f"  dispatch failures "
        f"{counters.get('engine_dispatch_failures_total', 0)} "
        f"(deadline {counters.get('engine_deadline_failures_total', 0)}"
        f"+{counters.get('sched_deadline_failures_total', 0)} sched)",
    ]
    return "\n".join(out)


def render_cost_model(snapshot: dict) -> str | None:
    """The cost model panel: predicted-vs-measured agreement of the
    tuning cost model (``tuning/cost_model.py``; docs/COST_MODEL.md),
    read off the ``tuning_predicted_vs_measured_ratio`` histogram, the
    divergence gauge, and the pruning/stale counters. None when the
    snapshot carries no prediction vocabulary (an uncalibrated run)."""
    hists = snapshot.get("histograms", {})
    ratio = hists.get("tuning_predicted_vs_measured_ratio")
    if ratio is None:
        return None
    counters = snapshot.get("counters", {})
    gauges = snapshot.get("gauges", {})
    divergence = gauges.get("tuning_cost_model_divergence", float("nan"))
    # Threshold and min-sample gate mirror cost_model.DIVERGENCE_LOG10 /
    # DIVERGENCE_MIN_SAMPLES (not imported: this CLI renders snapshots
    # from other runs; the numbers are the contract). The sample gate
    # keeps this panel's verdict consistent with health() — one noisy
    # candidate is not a regression.
    n_samples = ratio.get("count", 0)
    if n_samples < 8:
        verdict = "warming"
    elif divergence > 1.0:
        verdict = "DIVERGENT"
    else:
        verdict = "ok"
    out = [
        "cost model:",
        f"  predictions       {ratio.get('count', 0)} candidates "
        "(predicted/measured ratio)",
        f"  ratio p50         {ratio.get('p50', float('nan')):.3f} "
        f"(p95 {ratio.get('p95', float('nan')):.3f})",
        f"  divergence        {divergence:.3f} median |log10 ratio| "
        f"[{verdict}, threshold 1.0]",
        f"  pruned            "
        f"{counters.get('tuning_pruned_candidates_total', 0)} candidates "
        "skipped by prediction (each one logged)",
        f"  stale re-measures "
        f"{counters.get('tuning_cache_stale_total', 0)}",
    ]
    return "\n".join(out)


def render_solvers(snapshot: dict) -> str | None:
    """The served-solvers panel: request volume, the iterations-to-exit
    distribution, divergences (typed ``SolverDivergedError`` exits — the
    converged-or-typed-failure contract, docs/SOLVERS.md) and the last
    materialized true residual, read off the ``solver_*`` metrics
    (engine/core.py ``SolverFuture``). None when the snapshot carries no
    solver vocabulary (a matvec-only run)."""
    counters = snapshot.get("counters", {})
    if "solver_requests_total" not in counters:
        return None
    hists = snapshot.get("histograms", {})
    gauges = snapshot.get("gauges", {})
    iters = hists.get("solver_iterations", {})
    iter_time = hists.get("solver_iteration_time", {})
    requests = counters.get("solver_requests_total", 0)
    diverged = counters.get("solver_divergences_total", 0)
    out = [
        "solvers:",
        f"  requests          {requests}",
        f"  iterations p50    {iters.get('p50', float('nan')):.0f} "
        f"(p95 {iters.get('p95', float('nan')):.0f}, "
        f"n={iters.get('count', 0)})",
        f"  iter time p50     {iter_time.get('p50', float('nan')):.3f} ms "
        f"(p95 {iter_time.get('p95', float('nan')):.3f} — per-iteration "
        "solve wall time, the fused tier's floor)",
        f"  divergences       {diverged} "
        f"(typed SolverDivergedError; "
        f"{(diverged / requests) if requests else float('nan'):.3f} of "
        "requests — never a silently wrong x)",
        f"  last residual     "
        f"{gauges.get('solver_residual_norm', float('nan')):.3e} "
        "(true ||b - A x|| at last materialize)",
    ]
    return "\n".join(out)


def render_metrics(snapshot: dict, prometheus: bool = False) -> str:
    """Human-readable (or Prometheus text) rendering of a snapshot dict.
    Snapshots carrying batching-scheduler metrics get the ``batching``
    panel appended (:func:`render_batching`); snapshots carrying
    resilience metrics get the ``resilience`` panel
    (:func:`render_resilience`)."""
    if prometheus:
        from .registry import prometheus_text

        return prometheus_text(snapshot).rstrip("\n")
    out = []
    counters = snapshot.get("counters", {})
    if counters:
        out.append("counters:")
        width = max(len(n) for n in counters)
        for name, value in counters.items():
            out.append(f"  {name:<{width}}  {value}")
    gauges = snapshot.get("gauges", {})
    if gauges:
        out.append("gauges:")
        width = max(len(n) for n in gauges)
        for name, value in gauges.items():
            out.append(f"  {name:<{width}}  {value}")
    histograms = snapshot.get("histograms", {})
    if histograms:
        out.append("histograms:")
        for name, summ in histograms.items():
            out.append(
                f"  {name}: n={summ.get('count', 0)} "
                f"sum={_fmt_ms(summ.get('sum'))} "
                f"p50={_fmt_ms(summ.get('p50'))} "
                f"p95={_fmt_ms(summ.get('p95'))} "
                f"p99={_fmt_ms(summ.get('p99'))}"
            )
    storage = render_storage(snapshot)
    if storage is not None:
        out.append(storage)
    cost_model = render_cost_model(snapshot)
    if cost_model is not None:
        out.append(cost_model)
    tenants = render_tenants(snapshot)
    if tenants is not None:
        out.append(tenants)
    gsched = render_gsched(snapshot)
    if gsched is not None:
        out.append(gsched)
    solvers = render_solvers(snapshot)
    if solvers is not None:
        out.append(solvers)
    batching = render_batching(snapshot)
    if batching is not None:
        out.append(batching)
    resilience = render_resilience(snapshot)
    if resilience is not None:
        out.append(resilience)
    return "\n".join(out) if out else "(empty snapshot)"


def _walk(spans: list[dict], phases: dict[str, list[float]]) -> None:
    for span in spans:
        phases.setdefault(span["name"], []).append(span["dur_ms"])
        _walk(span.get("children", []), phases)


def _phase_split(record: dict) -> str:
    phases: dict[str, list[float]] = {}
    _walk(record.get("spans", []), phases)
    return " ".join(
        f"{name}={sum(vals):.3f}ms" for name, vals in phases.items()
    )


def summarize_trace(records: list[dict], top: int = 5) -> str:
    """Per-phase breakdown + top-k slowest requests for a trace JSONL."""
    if not records:
        return "(empty trace)"
    phases: dict[str, list[float]] = {}
    for record in records:
        _walk(record.get("spans", []), phases)
    durs = [float(r.get("dur_ms", 0.0)) for r in records]
    n_failed = sum(1 for r in records if r.get("status") != "ok")
    out = [
        f"{len(records)} requests, total {sum(durs):.3f}ms"
        + (f" ({n_failed} failed)" if n_failed else ""),
        "",
        "per-phase breakdown (host time inside spans of that name):",
    ]
    width = max(len(n) for n in phases)
    for name, vals in sorted(
        phases.items(), key=lambda kv: -sum(kv[1])
    ):
        total = sum(vals)
        out.append(
            f"  {name:<{width}}  total={total:10.3f}ms  n={len(vals):>5}  "
            f"mean={total / len(vals):8.4f}ms"
        )
    ranked = sorted(
        records, key=lambda r: float(r.get("dur_ms", 0.0)), reverse=True
    )[:top]
    out += ["", f"top {len(ranked)} slowest requests:"]
    for record in ranked:
        out.append(
            f"  #{record.get('request_id')}: "
            f"{float(record.get('dur_ms', 0.0)):.3f}ms "
            f"[{record.get('status', '?')}] {_phase_split(record)}"
        )
    return "\n".join(out)


def load_trace(path: str | Path) -> list[dict]:
    records = []
    for line in Path(path).read_text().splitlines():
        line = line.strip()
        if line:
            records.append(json.loads(line))
    return records


# ------------------------------------------------- timeline / slo / dump


def load_events(path: str | Path) -> list[dict]:
    """Timeline events from a hub-sink JSONL, or from a flight bundle /
    ``{"events": [...]}`` JSON (one loader for both capture shapes)."""
    text = Path(path).read_text()
    try:
        payload = json.loads(text)
    except json.JSONDecodeError:
        # More than one top-level document: JSONL, one event per line.
        return [
            json.loads(line) for line in text.splitlines() if line.strip()
        ]
    if isinstance(payload, dict) and "events" in payload:
        return list(payload["events"])  # flight bundle
    return [payload] if isinstance(payload, dict) else list(payload)


def _fmt_event(event: dict, t0: float) -> str:
    ids = []
    if "request_id" in event:
        ids.append(f"req={event['request_id']}")
    if "cause_id" in event:
        ids.append(f"cause={event['cause_id']}")
    fields = " ".join(
        f"{k}={v}" for k, v in event.items()
        if k not in ("seq", "t_s", "kind", "request_id", "cause_id")
    )
    return (
        f"  +{event.get('t_s', t0) - t0:9.3f}s  "
        f"{event.get('kind', '?'):<18} {' '.join(ids):<18} {fields}"
    ).rstrip()


def render_timeline(
    events: list[dict], request_id: int, since: float | None = None
) -> str:
    """One request's causal story: the events carrying its id, the
    background actions it caused, and the batch it rode."""
    from .timeline import FAILURE_KINDS, related_events

    story = related_events(events, request_id)
    if since is not None:
        story = [e for e in story if e.get("t_s", 0.0) >= since]
    if not story:
        return f"(no events for request {request_id})"
    t0 = story[0].get("t_s", 0.0)
    failures = [e for e in story if e.get("kind") in FAILURE_KINDS]
    out = [
        f"request {request_id}: {len(story)} event(s)"
        + (f", {len(failures)} failure(s)" if failures else ""),
    ]
    out += [_fmt_event(e, t0) for e in story]
    return "\n".join(out)


def render_slo(evaluation: dict) -> str:
    """The burn-rate panel for one ``SloMonitor.evaluate()`` payload."""
    targets = evaluation.get("targets", {})
    if not targets:
        return "(no SLO targets)"
    out = ["slo:"]
    width = max(len(n) for n in targets)
    for name, t in targets.items():
        burn = t.get("burn", {})
        burns = " ".join(
            f"{w}={b:.2f}" if b is not None else f"{w}=-"
            for w, b in burn.items()
        )
        goal = (
            f"{t.get('objective'):.4g}"
            if t.get("kind") == "availability"
            else f"<= {t.get('objective'):.4g}"
        )
        value = t.get("value")
        out.append(
            f"  {name:<{width}}  [{t.get('status', '?'):>7}]  "
            f"objective {goal}"
            + (f"  value {value:.4g}" if value is not None else "")
            + f"  burn {burns}"
        )
    for alert in evaluation.get("alerts", []):
        out.append(
            f"  ALERT [{alert['severity']}] {alert['slo']}: burn "
            f"{alert['burn_short']:.1f}x over {alert['short']} and "
            f"{alert['burn_long']:.1f}x over {alert['long']} "
            f"(threshold {alert['threshold']}x) — error budget burning "
            f"{alert['burn_short']:.0f}x faster than sustainable"
        )
    return "\n".join(out)


def render_dump(bundle: dict) -> str:
    """A flight-recorder bundle: the trigger, the failure mix of the
    retained ring, the SLO verdict, and the trailing events."""
    events = bundle.get("events", [])
    trigger = bundle.get("trigger")
    out = ["flight bundle:"]
    if trigger is not None:
        out.append(
            f"  trigger   {trigger.get('kind', '?')} "
            + " ".join(
                f"{k}={v}" for k, v in trigger.items()
                if k not in ("seq", "t_s", "kind")
            )
        )
    else:
        out.append("  trigger   (manual dump)")
    kinds: dict[str, int] = {}
    for e in events:
        kinds[e.get("kind", "?")] = kinds.get(e.get("kind", "?"), 0) + 1
    mix = ", ".join(f"{k}={n}" for k, n in sorted(kinds.items()))
    out.append(f"  events    {len(events)} retained ({mix})")
    out.append(
        f"  snapshots {len(bundle.get('metric_snapshots', []))} metric "
        "snapshot(s) retained"
    )
    if "slo" in bundle:
        out.append(render_slo(bundle["slo"]))
    if events:
        t0 = events[0].get("t_s", 0.0)
        tail = events[-10:]
        out.append(f"  last {len(tail)} events:")
        out += [_fmt_event(e, t0) for e in tail]
    return "\n".join(out)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m matvec_mpi_multiplier_torch.obs",
        description="Render a metrics snapshot, a request-trace JSONL, a "
        "request timeline, an SLO evaluation, or a flight bundle.",
    )
    sub = p.add_subparsers(dest="cmd", required=True)
    pm = sub.add_parser("metrics", help="pretty-print a metrics snapshot")
    pm.add_argument("file", help="snapshot JSON (serve --metrics-out)")
    pm.add_argument(
        "--prometheus", action="store_true",
        help="emit Prometheus text format instead of the table",
    )
    pm.add_argument(
        "--watch", type=float, default=None, metavar="SECONDS",
        help="re-read and re-render the snapshot every SECONDS",
    )
    pt = sub.add_parser("trace", help="summarize a request-trace JSONL")
    pt.add_argument("file", help="trace JSONL (serve --trace-jsonl)")
    pt.add_argument(
        "--top", type=int, default=5,
        help="slowest requests to list (default 5)",
    )
    pt.add_argument(
        "--since", type=float, default=None, metavar="EPOCH_S",
        help="only requests whose trace timestamp is >= this epoch time",
    )
    pl = sub.add_parser(
        "timeline", help="replay one request's causal event story"
    )
    pl.add_argument(
        "file", help="event JSONL (TimelineHub sink) or flight bundle JSON"
    )
    pl.add_argument("request_id", type=int, help="the correlation id")
    pl.add_argument(
        "--since", type=float, default=None, metavar="EPOCH_S",
        help="only events stamped >= this epoch time",
    )
    ps = sub.add_parser("slo", help="render an SLO burn-rate evaluation")
    ps.add_argument(
        "file", help="SloMonitor.evaluate() JSON (serve --slo-out)"
    )
    pd = sub.add_parser("dump", help="render a flight-recorder bundle")
    pd.add_argument("file", help="bundle JSON (FlightRecorder.dump)")
    return p


def _watch_metrics(args, path: Path) -> None:
    while True:
        try:
            snapshot = json.loads(path.read_text())
        except (OSError, json.JSONDecodeError) as e:
            body = f"({path}: {e})"  # racing the writer is routine
        else:
            body = render_metrics(snapshot, prometheus=args.prometheus)
        # ANSI clear + home, like watch(1); falls through harmlessly to
        # plain separators on dumb terminals.
        print(f"\x1b[2J\x1b[H{path} @ {time.strftime('%H:%M:%S')}")
        print(body, flush=True)
        time.sleep(args.watch)


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    path = Path(args.file)
    if not path.exists():
        print(f"no such file: {path}", file=sys.stderr)
        return 1
    try:
        if args.cmd == "metrics":
            if args.watch is not None:
                _watch_metrics(args, path)  # until interrupted
            print(render_metrics(
                json.loads(path.read_text()), prometheus=args.prometheus
            ))
        elif args.cmd == "trace":
            records = load_trace(path)
            if args.since is not None:
                records = [
                    r for r in records if r.get("ts", 0.0) >= args.since
                ]
            print(summarize_trace(records, top=args.top))
        elif args.cmd == "timeline":
            out = render_timeline(
                load_events(path), args.request_id, since=args.since
            )
            print(out)
            if out.startswith("(no events"):
                return 1  # script-friendly miss: the id is not in the file
        elif args.cmd == "slo":
            print(render_slo(json.loads(path.read_text())))
        else:
            print(render_dump(json.loads(path.read_text())))
    except KeyboardInterrupt:
        return 130  # interrupted --watch is the normal way out
    except BrokenPipeError:
        # `obs ... | head` closing the pipe early is normal CLI usage.
        # Point stdout at devnull so the interpreter-shutdown flush of the
        # broken pipe can't fail either (which would turn exit 0 into the
        # flush error's nonzero status despite this handler).
        import os

        os.dup2(os.open(os.devnull, os.O_WRONLY), sys.stdout.fileno())
    return 0


if __name__ == "__main__":
    sys.exit(main())
