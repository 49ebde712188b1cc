"""Online-resharding evidence: the drifting-shape A/B capture.

The port's counterpart of the JAX package's ``scripts/reshard_study.py``.
One seeded protocol (``bench/serve.py::run_reshard_drift``), run twice: a
3-tenant Zipf fleet registered in the calibrated cost model's
predicted-worst layout for the steady traffic shape serves a trace that
drifts at the rollover index (width-1 vectors trickling below the
amortization threshold before it, closed-loop 32-column blocks after it).
``--reshard off`` keeps the fleet in the registered layout; ``auto`` lets
the ``GlobalScheduler``'s crossover trigger migrate each tenant's resident
A on the device once its demand amortizes the migration. Each arm runs in
a process of its own, so one arm's allocator state cannot bias the other's
percentiles (``--in-process`` runs both here, for a quick run).

Outputs under ``--out`` (default ``data/torch_demo/reshard``):

* ``tuning_cache.json`` — the full (6-probe) calibration both the
  registration-layout pick and the trigger's predictions came from;
* ``out/reshard_ab.csv`` — both arms' rows;
* ``decisions.jsonl`` — the auto arm's decision trace;
* ``metrics.json`` — the auto arm's registry snapshot;
* ``summary.json`` — the A/B headline, written only after the gates pass:
  auto beats off on steady p99 and p50, every migration lands before the
  steady window, no steady-phase builds in either arm, every reshard
  decision carries ``predicted_s`` and its reason.

Usage::

    python -m matvec_mpi_multiplier_torch.bench.reshard_study --devices 8
    python -m matvec_mpi_multiplier_torch.bench.reshard_study --platform cpu \\
        --host-devices 8 --out /tmp/reshard
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

from .studies import add_platform_args, default_out, study_mesh, tuning_cache_at

# The protocol (the JAX study's): a tall-narrow A whose predicted-worst
# layout pays two collective launches per steady request.
M, K = 8192, 256
WIDTH_STEADY = 32
N_TENANTS = 3
ZIPF_A = 1.1
N_REQUESTS = 280
ROLLOVER = 24
STEADY_SKIP = 56
PRE_RATE = 6.0
SEED = 0
CALIB_REPS = 10

# The gates that compare the two arms' measured times (the others check
# the protocol itself: migrations, builds, bytes, the decision trace).
TIMING_GATES = ("steady p99 not better", "steady p50 not better")


def _drift(args, mesh, src: str, arm: str, metrics_out=None, decision_jsonl=None) -> dict:
    from .serve import run_reshard_drift

    return run_reshard_drift(
        src, mesh, args.m, args.k, n_tenants=N_TENANTS, zipf_a=ZIPF_A,
        n_requests=args.n_requests, rollover=ROLLOVER, width_steady=WIDTH_STEADY,
        pre_rate=PRE_RATE, steady_skip=STEADY_SKIP, seed=SEED, reshard=arm,
        metrics_out=metrics_out, decision_jsonl=decision_jsonl)


def run_arm(args) -> int:
    """Child mode: one arm in a fresh process; the result as JSON."""
    result = _drift(args, study_mesh(args), args.src, args.arm,
                    args.metrics_out or None, args.decision_jsonl or None)
    Path(args.result).write_text(json.dumps(result, indent=2) + "\n")
    return 0


def gate_failures(off: dict, auto: dict, src: str, out: Path, m: int, k: int,
                  rollover: int = ROLLOVER, steady_skip: int = STEADY_SKIP) -> list[str]:
    """The A/B's acceptance gates (the JAX study's)."""
    window = rollover + steady_skip
    failures = []
    if not auto["p99_steady_ms"] < off["p99_steady_ms"]:
        failures.append(f"steady p99 not better: {auto['p99_steady_ms']:.2f} vs "
                        f"{off['p99_steady_ms']:.2f}")
    if not auto["p50_steady_ms"] < off["p50_steady_ms"]:
        failures.append(f"steady p50 not better: {auto['p50_steady_ms']:.2f} vs "
                        f"{off['p50_steady_ms']:.2f}")
    if auto["reshards"] < 1:
        failures.append("auto arm never migrated")
    if off["reshards"] != 0:
        failures.append(f"off arm migrated {off['reshards']} times")
    if not (0 <= auto["last_reshard_at"] < window):
        failures.append(f"migration at request {auto['last_reshard_at']} did not land "
                        f"before the steady window (opens at {window})")
    for arm, r in (("off", off), ("auto", auto)):
        if r["compiles_steady"] != 0:
            failures.append(f"{arm} arm built {r['compiles_steady']} times in the "
                            "steady window")
    if auto["reshard_bytes"] != auto["reshards"] * m * k * 4:
        failures.append(f"reshard_bytes {auto['reshard_bytes']} != {auto['reshards']} "
                        f"migrations x {m * k * 4} payload bytes")
    if set(off["final_strategies"].values()) != {src}:
        failures.append("off arm did not stay in the src layout")
    if not any(s != src for s in auto["final_strategies"].values()):
        failures.append("auto arm's fleet still entirely in the src layout")
    decisions = [json.loads(ln) for ln in (out / "decisions.jsonl").read_text().splitlines()]
    reshard_decisions = [d for d in decisions if d.get("decision") == "reshard"]
    if len(reshard_decisions) != auto["reshards"]:
        failures.append(f"{len(reshard_decisions)} reshard decisions traced but "
                        f"{auto['reshards']} migrations counted")
    for d in reshard_decisions:
        if not (d.get("predicted_s") and "amortizes" in d.get("reason", "")
                and d.get("src") == src and d.get("dst")):
            failures.append(f"undertraced reshard decision: {d}")
    counters = json.loads((out / "metrics.json").read_text())["counters"]
    if counters.get("registry_reshards_total") != auto["reshards"]:
        failures.append("metrics.json reshard counter disagrees")
    return failures


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default=default_out("reshard"))
    add_platform_args(parser, devices=8)
    parser.add_argument("--m", type=int, default=M)
    parser.add_argument("--k", type=int, default=K)
    parser.add_argument("--n-requests", type=int, default=N_REQUESTS)
    parser.add_argument("--calib-reps", type=int, default=CALIB_REPS)
    parser.add_argument("--in-process", action="store_true",
                        help="run both arms in this process")
    # Child-mode plumbing (the parent spawns itself):
    parser.add_argument("--arm", choices=["off", "auto"], default=None)
    parser.add_argument("--src", default=None)
    parser.add_argument("--result", default=None)
    parser.add_argument("--metrics-out", default=None)
    parser.add_argument("--decision-jsonl", default=None)
    args = parser.parse_args(argv)

    if args.arm is not None:
        return run_arm(args)

    from ..models import get_strategy
    from ..parallel.reshard import RESHARD_STRATEGIES
    from ..tuning.cache import TuningCache, calibration_key
    from ..tuning.cost_model import CostModel, calibrate
    from .serve import append_reshard_result

    mesh = study_mesh(args)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    p = mesh.size
    # The tuning cache is an artifact: the calibration that picked the
    # registration layout and armed the trigger travels with the numbers;
    # the arm processes inherit the setting.
    with tuning_cache_at(out / "tuning_cache.json"):
        print("== full calibration (6 probes) ==")
        cal = calibrate(mesh, level="full", n_reps=args.calib_reps)
        cache = TuningCache.load()
        cache.record(calibration_key(p), cal.to_record())
        cache.save()

        model = CostModel(cal)
        predicted = {
            s: model.predict(s, get_strategy(s).default_combine(mesh), m=args.m, k=args.k,
                             p=p, dtype="float32", b=WIDTH_STEADY).total_s
            for s in RESHARD_STRATEGIES
        }
        src = max(predicted, key=predicted.get)
        print("predicted steady ms/req: "
              + "  ".join(f"{s}={t * 1e3:.3f}" for s, t in predicted.items())
              + f"  -> registering in {src}")

        def arm(name: str, **outputs) -> dict:
            print(f"== --reshard {name} ({'in process' if args.in_process else 'subprocess'}) ==")
            if args.in_process:
                return _drift(args, mesh, src, name, **{
                    k: str(v) for k, v in outputs.items()})
            result_path = out / f".{name}_result.json"
            cmd = [sys.executable, "-m", __spec__.name, "--arm", name, "--src", src,
                   "--platform", args.platform, "--devices", str(p),
                   "--m", str(args.m), "--k", str(args.k),
                   "--n-requests", str(args.n_requests), "--result", str(result_path)]
            if args.host_devices is not None:
                cmd += ["--host-devices", str(args.host_devices)]
            for flag, path in outputs.items():
                cmd += [f"--{flag.replace('_', '-')}", str(path)]
            subprocess.run(cmd, check=True)
            result = json.loads(result_path.read_text())
            result_path.unlink()
            return result

        off = arm("off")
        auto = arm("auto", metrics_out=out / "metrics.json",
                   decision_jsonl=out / "decisions.jsonl")

    summary = {
        "protocol": {
            "m": args.m, "k": args.k, "p": p, "src": src, "predicted_steady_s": predicted,
            "n_tenants": N_TENANTS, "zipf_a": ZIPF_A, "n_requests": args.n_requests,
            "rollover": ROLLOVER, "steady_skip": STEADY_SKIP, "width_steady": WIDTH_STEADY,
            "pre_rate_req_s": PRE_RATE, "seed": SEED, "calibration_level": cal.level,
        },
        "off": off,
        "auto": auto,
    }
    print(json.dumps(summary, indent=2))
    failures = gate_failures(off, auto, src, out, args.m, args.k)
    if failures:
        print("GATE FAILURES:\n  " + "\n  ".join(failures), file=sys.stderr)
        return 1
    for result in (off, auto):
        append_reshard_result(result, root=out)
    (out / "summary.json").write_text(json.dumps(summary, indent=2) + "\n")
    print(f"\nA/B capture -> {out}")
    print(f"  steady p99 {off['p99_steady_ms']:.2f} -> {auto['p99_steady_ms']:.2f} ms, "
          f"p50 {off['p50_steady_ms']:.2f} -> {auto['p50_steady_ms']:.2f} ms "
          f"({auto['reshards']} migrations, {auto['reshard_bytes'] / 1e6:.1f} MB moved, "
          f"last at request {auto['last_reshard_at']}, steady builds 0/0)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
