"""SLO burn-rate and flight-recorder evidence under seeded chaos.

The port's counterpart of the JAX package's ``scripts/slo_study.py``. One
load run (``bench/serve.py::run_serve_load``) under the resilience demo's
chaos protocol (targeted dispatch faults on the colwise ``psum_scatter``
config, 5% poisoned payloads, NaN corruption behind the integrity gate, a
background transient-fault rate), with

* the correlated event timeline streaming to ``events.jsonl`` (every line
  carries ``request_id`` or ``cause_id``);
* the flight recorder armed, its post-mortem bundles under ``flight/``;
* the SLO burn-rate monitor replaying the run's measured failure fraction
  over a fake-clock history (:func:`replay_slo`: six hours clean, then the
  incident for 30 minutes), its evaluation with the fired page alert in
  ``slo.json``;
* the run's registry snapshot in ``metrics.json`` and the headline in
  ``summary.json`` (and a ``README.md`` that tells one failed request's
  causal story).

Outputs under ``--out`` (default ``data/torch_demo/slo``).

Usage::

    python -m matvec_mpi_multiplier_torch.bench.slo_study --devices 8
    python -m matvec_mpi_multiplier_torch.bench.slo_study --platform cpu \\
        --host-devices 8 --out /tmp/slo
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from .studies import add_platform_args, default_out, platform_label, study_mesh

# The resilience demo's chaos protocol (the JAX study's).
SHAPE = 256
N_REQUESTS = 200
MAX_BUCKET = 32
RATE_REQ_S = 100.0
BURST = 8
FAULT_SPEC = (
    "dispatch:device_error:key=*psum_scatter*,times=12;"
    "dispatch:nan:times=2,after=40;"
    "dispatch:device_error:p=0.04,retryable=1"
)
FAULT_SEED = 7
POISON_RATE = 0.05
BREAKER_RESET_S = 0.6
SEED = 0

# The replay: 6 h of clean history at the run's request rate, then the
# run's measured failure fraction for a 30-minute incident. The page policy
# needs burn > 14.4 on both the 5 m and the 1 h window.
GOOD_HISTORY_S = 6 * 3600.0
INCIDENT_S = 1800.0
REPLAY_STEP_S = 60.0


def replay_slo(run_snapshot: dict, *, failed: int, offered: int) -> dict:
    """Drive a fake-clock ``SloMonitor`` through good history and the
    run's measured incident; return its evaluation."""
    from ..obs import DEFAULT_TARGETS, MetricsRegistry, SloMonitor

    fail_frac = failed / offered
    chaos_p99 = (run_snapshot.get("histograms", {})
                 .get("serve_e2e_latency_ms", {}).get("p99"))
    reg = MetricsRegistry()
    total = reg.counter("serve_requests_total")
    bad = reg.counter("serve_failed_requests_total")
    g_p99 = reg.gauge("serve_e2e_latency_ms")
    clock = {"t": 0.0}
    mon = SloMonitor(reg, DEFAULT_TARGETS)
    mon._clock = lambda: clock["t"]
    p99_bound = next(t.objective for t in DEFAULT_TARGETS if t.name == "e2e_p99_ms")
    clean_p99 = p99_bound * 0.6
    incident_p99 = chaos_p99 if chaos_p99 is not None else clean_p99

    def tick(frac: float, p99: float) -> None:
        clock["t"] += REPLAY_STEP_S
        n = max(1, int(RATE_REQ_S * REPLAY_STEP_S))
        total.inc(n)
        bad.inc(int(round(n * frac)))
        g_p99.set(p99)
        mon.sample()

    while clock["t"] < GOOD_HISTORY_S:
        tick(0.0, clean_p99)
    if mon.evaluate()["alerts"]:
        raise RuntimeError("an alert fired on the clean history")
    while clock["t"] < GOOD_HISTORY_S + INCIDENT_S:
        tick(fail_frac, incident_p99)
    return mon.evaluate()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default=default_out("slo"))
    add_platform_args(parser, devices=8)
    parser.add_argument("--shape", type=int, default=SHAPE)
    parser.add_argument("--n-requests", type=int, default=N_REQUESTS)
    args = parser.parse_args(argv)

    from ..obs import FAILURE_KINDS
    from ..obs.__main__ import render_slo, render_timeline
    from .serve import run_serve_load

    mesh = study_mesh(args)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    print("== chaos run with timeline + flight recorder armed ==")
    result = run_serve_load(
        "colwise", mesh, args.shape, args.shape, combine="psum_scatter",
        n_requests=args.n_requests, max_bucket=MAX_BUCKET, arrival="burst",
        rate=RATE_REQ_S, burst=BURST, coalesce=True, fault_spec=FAULT_SPEC,
        fault_seed=FAULT_SEED, poison_rate=POISON_RATE, integrity_gate=True,
        breaker_reset_s=BREAKER_RESET_S, seed=SEED,
        events_jsonl=str(out / "events.jsonl"), flight_dir=str(out / "flight"),
        metrics_out=str(out / "metrics.json"))
    failed, offered = result.failed_requests, result.n_requests
    print(f"chaos run: {failed} of {offered} failed ({result.retries} retries, "
          f"{result.downgrades} downgrades)")
    if failed == 0:
        raise RuntimeError("the chaos trace failed nothing: no incident to demonstrate")

    events = [json.loads(line) for line in (out / "events.jsonl").read_text().splitlines()]
    if not events or not all("request_id" in e or "cause_id" in e for e in events):
        raise RuntimeError("an event line is missing its correlation id")
    failures = [e for e in events
                if e["kind"] in FAILURE_KINDS and ("request_id" in e or "cause_id" in e)]
    if not failures:
        raise RuntimeError("chaos produced no typed-failure timeline events")
    failed_ev = failures[0]
    failed_rid = failed_ev.get("request_id", failed_ev.get("cause_id"))
    dumps = sorted((out / "flight").glob("flight_*.json"))
    if not dumps:
        raise RuntimeError("the flight recorder dumped nothing under chaos")
    print(f"flight dumps: {[d.name for d in dumps]}")

    print("== fake-clock SLO replay (6 h clean + the incident) ==")
    run_snapshot = json.loads((out / "metrics.json").read_text())
    evaluation = replay_slo(run_snapshot, failed=failed, offered=offered)
    pages = [a for a in evaluation["alerts"] if a["severity"] == "page"]
    if not pages:
        raise RuntimeError(f"no page alert fired: {json.dumps(evaluation['alerts'])}")
    (out / "slo.json").write_text(json.dumps(evaluation, indent=2) + "\n")
    print(render_slo(evaluation))

    timeline_text = render_timeline(events, failed_rid)
    summary = {
        "failed_request_id": failed_rid,
        "failed_request_kind": failed_ev["kind"],
        "failed_requests": failed,
        "offered_requests": offered,
        "retries": result.retries,
        "downgrades": result.downgrades,
        "alerts": evaluation["alerts"],
        "flight_dumps": [d.name for d in dumps],
        "n_events": len(events),
    }
    (out / "summary.json").write_text(json.dumps(summary, indent=2) + "\n")
    trigger = json.loads(dumps[0].read_text())["trigger"]["kind"]
    readme = f"""# SLO burn-rate and flight-recorder demo (seeded chaos)

The chaos trace of the resilience demo on {platform_label(mesh)}
({mesh.size} shards), with the correlated event timeline streaming, the
flight recorder armed, and the SLO burn-rate monitor replaying the run's
measured failure fraction over a fake-clock history.

Command: `python -m matvec_mpi_multiplier_torch.bench.slo_study --out {out}`

The run: {offered} burst-arrival requests, {failed} failed under the four
seeded fault families ({result.retries} retries, {result.downgrades} ladder
downgrades absorbed the rest). The replay: six hours of clean traffic at
{RATE_REQ_S:.0f} req/s, then the measured {failed / offered:.1%} failure
fraction for {INCIDENT_S / 60:.0f} minutes: burn {pages[0]["burn_short"]:.0f}x
over 5m and {pages[0]["burn_long"]:.0f}x over 1h against the 99.9%
availability objective.

Artifacts: `events.jsonl` ({len(events)} events), `flight/{dumps[0].name}`
(trigger `{trigger}`), `slo.json`
(`python -m matvec_mpi_multiplier_torch.obs slo {out}/slo.json`),
`metrics.json`, `summary.json`.

One failed request's causal story
(`python -m matvec_mpi_multiplier_torch.obs timeline {out}/events.jsonl {failed_rid}`):

```
{timeline_text}
```
"""
    (out / "README.md").write_text(readme)
    print(f"written: {sorted(p.name for p in out.iterdir())}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
