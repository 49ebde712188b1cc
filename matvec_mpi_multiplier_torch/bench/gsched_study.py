"""Global-scheduler evidence: greedy against scheduled serving under overload.

The port's counterpart of the JAX package's ``scripts/gsched_study.py``:
one seeded multi-tenant protocol (``bench/serve.py::run_serve_multitenant``,
six Zipf tenants in an HBM budget of three, an SLO overlay at about twice
the load a straggler-afflicted fleet sustains inside the deadline), served
twice: greedy (``--global-sched off``) and through the ``GlobalScheduler``
on a quick calibration of this mesh.

Outputs under ``--out`` (default ``data/torch_demo/gsched``):

* ``tuning_cache.json`` — the quick calibration the scheduled run read;
* ``out/serve_tenants_rowwise.csv`` — both runs' per-tenant rows;
* ``decisions.jsonl`` — the scheduled run's decision trace;
* ``metrics.json`` — the scheduled run's registry snapshot;
* ``summary.json`` — the A/B headline, written only after the gates pass:
  better p99 and availability, no engine-gate expiry in the scheduled run,
  rejections made (admission acted), the greedy run expiring (the overload
  is real), on-time goodput kept, every decision with ``predicted_s`` and a
  reason, no reject without a prediction.

Usage::

    python -m matvec_mpi_multiplier_torch.bench.gsched_study --devices 8
    python -m matvec_mpi_multiplier_torch.bench.gsched_study --platform cpu \\
        --host-devices 8 --out /tmp/gsched
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from .studies import add_platform_args, default_out, study_mesh, tuning_cache_at

# The protocol (the JAX study's).
N_TENANTS = 6
SHAPE = 128
ZIPF_A = 1.1
HBM_BUDGET = "3x"
PIN_HOT = 1
N_REQUESTS = 240
SEED = 0
DEADLINE_MS = 10.0
RATE_REQ_S = 1000.0
MAX_IN_FLIGHT = 4
DEADLINE_MARGIN = 1.5
DEMAND_WEIGHT = 2.0
FAULT_SPEC = "dispatch:latency:latency_ms=6,p=0.08"
FAULT_SEED = 7

# The gates that compare the two runs' measured times and deadline outcomes
# (the others check admission itself and the decision trace).
TIMING_GATES = ("p99 not better", "availability not better", "on-time goodput regressed",
                "baseline never expired")


def _row(result) -> dict:
    all_row = result.rows[-1]
    return {
        "global_sched": result.global_sched,
        "deadline_expires": result.deadline_expires,
        "rejected": all_row.rejected,
        "failed": all_row.failed_requests,
        "served": all_row.requests - all_row.failed_requests - all_row.rejected,
        "on_time": result.on_time,
        "p50_e2e_ms": result.p50_e2e_ms,
        "p99_e2e_ms": result.p99_e2e_ms,
        "availability": all_row.availability,
        "hit_rate": result.hit_rate,
        "evictions": all_row.evictions,
    }


def gate_failures(g: dict, s: dict, out: Path) -> list[str]:
    """The A/B's acceptance gates (the JAX study's)."""
    failures = []
    if not s["p99_e2e_ms"] < g["p99_e2e_ms"]:
        failures.append(f"p99 not better: {s['p99_e2e_ms']:.2f} vs {g['p99_e2e_ms']:.2f}")
    if not s["availability"] > g["availability"]:
        failures.append(f"availability not better: {s['availability']:.3f} vs "
                        f"{g['availability']:.3f}")
    if s["deadline_expires"] != 0:
        failures.append(f"scheduled run still expired {s['deadline_expires']} requests "
                        "in an engine gate")
    if s["rejected"] == 0:
        failures.append("scheduled run rejected nothing (no admission)")
    if g["deadline_expires"] == 0:
        failures.append("baseline never expired (overload too mild)")
    if not s["on_time"] >= g["on_time"]:
        failures.append(f"on-time goodput regressed: {s['on_time']} vs {g['on_time']}")
    decisions = [json.loads(ln) for ln in (out / "decisions.jsonl").read_text().splitlines()]
    if not decisions:
        failures.append("decision trace is empty")
    missing = [d for d in decisions if "predicted_s" not in d or "reason" not in d]
    if missing:
        failures.append(f"{len(missing)} decisions missing predicted_s/reason")
    unpredicted = [d for d in decisions
                   if d["decision"] == "reject" and d["predicted_s"] is None]
    if unpredicted:
        failures.append(f"{len(unpredicted)} rejects carried predicted_s=None")
    return failures


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default=default_out("gsched"))
    add_platform_args(parser, devices=8)
    parser.add_argument("--calib-reps", type=int, default=5)
    parser.add_argument("--shape", type=int, default=SHAPE)
    parser.add_argument("--n-requests", type=int, default=N_REQUESTS)
    args = parser.parse_args(argv)

    from ..tuning import reset_cache
    from ..tuning.cache import TuningCache, calibration_key
    from ..tuning.cost_model import calibrate
    from .serve import append_multitenant_result, run_serve_multitenant

    mesh = study_mesh(args)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    with tuning_cache_at(out / "tuning_cache.json"):
        print("== quick calibration (2 probes) ==")
        cal = calibrate(mesh, level="quick", n_reps=args.calib_reps)
        cache = TuningCache.load()
        cache.record(calibration_key(mesh.size), cal.to_record())
        cache.save()
        reset_cache()
        common = dict(n_tenants=N_TENANTS, zipf_a=ZIPF_A, hbm_budget=HBM_BUDGET,
                      pin_hot=PIN_HOT, n_requests=args.n_requests, seed=SEED,
                      max_in_flight=MAX_IN_FLIGHT, deadline_ms=DEADLINE_MS,
                      rate=RATE_REQ_S, fault_spec=FAULT_SPEC, fault_seed=FAULT_SEED)
        print("== greedy baseline (--global-sched off) ==")
        off = run_serve_multitenant("rowwise", mesh, args.shape, args.shape, **common)
        print("== scheduled run (--global-sched on) ==")
        on = run_serve_multitenant(
            "rowwise", mesh, args.shape, args.shape, global_sched=True,
            demand_weight=DEMAND_WEIGHT, deadline_margin=DEADLINE_MARGIN,
            decision_jsonl=str(out / "decisions.jsonl"),
            metrics_out=str(out / "metrics.json"), **common)

    summary = {
        "protocol": {
            "n_tenants": N_TENANTS, "shape": args.shape, "zipf_a": ZIPF_A,
            "hbm_budget": HBM_BUDGET, "pin_hot": PIN_HOT, "n_requests": args.n_requests,
            "seed": SEED, "deadline_ms": DEADLINE_MS, "rate_req_s": RATE_REQ_S,
            "max_in_flight": MAX_IN_FLIGHT, "deadline_margin": DEADLINE_MARGIN,
            "demand_weight": DEMAND_WEIGHT, "fault_spec": FAULT_SPEC,
            "fault_seed": FAULT_SEED, "calibration_level": cal.level,
        },
        "greedy": _row(off),
        "scheduled": _row(on),
    }
    g, s = summary["greedy"], summary["scheduled"]
    print(json.dumps(summary, indent=2))
    failures = gate_failures(g, s, out)
    if failures:
        print("GATE FAILURES:\n  " + "\n  ".join(failures), file=sys.stderr)
        return 1
    for result in (off, on):
        append_multitenant_result(result, root=out)
    (out / "summary.json").write_text(json.dumps(summary, indent=2) + "\n")
    print(f"\nA/B capture -> {out}")
    print(f"  p99 {g['p99_e2e_ms']:.2f} -> {s['p99_e2e_ms']:.2f} ms, availability "
          f"{g['availability']:.3f} -> {s['availability']:.3f}, on-time {g['on_time']} -> "
          f"{s['on_time']}, expires {g['deadline_expires']} -> 0 (rejected fast: "
          f"{s['rejected']})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
