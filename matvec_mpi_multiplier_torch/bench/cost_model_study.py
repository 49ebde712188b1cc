"""Cost-model evidence: calibration, the predicted crossover surface, and
pruned against exhaustive tuning.

The port's counterpart of the JAX package's ``scripts/cost_model_study.py``.
Outputs under ``--out`` (default ``data/torch_demo/cost_model``):

* ``calibration.json`` — the full 6-probe calibration of this mesh (the
  machine constants and the probe times they came from);
* ``crossover.csv`` — the predicted combine-crossover surface over (m, k,
  p, dtype) from that calibration (``tuning/cost_model.py``);
* ``prune_parity.csv`` — every tuner axis run twice with real
  measurement, exhaustive and with ``prune_margin``: one row per axis and
  strategy with both decisions, the measured-candidate counts and the
  pruned candidates. The study fails if a decision differs after the
  tie-break retries, or if pruning saves under 40% of the measurements;
* ``metrics.json`` — the pruned run's registry snapshot (the
  predicted-over-measured histogram, the divergence gauge, the pruned
  counter, and one deliberate forced re-measure for the stale counter);
* ``exhaustive_cache.json`` and ``pruned_cache.json``.

Usage::

    python -m matvec_mpi_multiplier_torch.bench.cost_model_study --devices 8
    python -m matvec_mpi_multiplier_torch.bench.cost_model_study --platform cpu \\
        --host-devices 8 --out /tmp/cm --n-reps 3
"""

from __future__ import annotations

import argparse
import csv
import json
import sys
from pathlib import Path

from .studies import add_platform_args, default_out, study_mesh

# The tuned operand of the parity capture (storage races a wider k, so the
# resident stream is a real object), and the capture's hysteresis margin.
PARITY_M = 64
PARITY_K = 64
PARITY_STORAGE_K = 1024
PARITY_MIN_GAIN = 0.4
STRATEGIES = ("rowwise", "colwise", "blockwise")

# Both verdicts compare measured races: a near-tie decided by host noise,
# or a calibration that prunes less.
TIMING_GATES = ("PARITY FAILURE", "SAVINGS FAILURE")


def _measured_counts(snapshot: dict) -> tuple[int, int]:
    """(measured, pruned) candidate totals from a registry snapshot."""
    from ..tuning.cost_model import PRUNED_COUNTER

    counters = snapshot["counters"]
    measured = sum(v for k, v in counters.items()
                   if k.startswith("tuning_") and k.endswith("_candidates_total")
                   and k != PRUNED_COUNTER)
    return measured, counters.get(PRUNED_COUNTER, 0)


def axis_calls(mesh):
    """The capture's axis table: ``(axis, strategy, runner)``, where
    ``runner(cache, kw)`` returns the decision field. The local-kernel axes
    race on the mesh's first device."""
    from ..tuning import search

    p = mesh.size
    device = mesh.devices[0]
    calls = [
        ("gemv", "-", lambda cache, kw: search.tune_gemv(
            PARITY_M // p, PARITY_K, "float32", cache, device=device, **kw)["kernel"]),
        ("gemm", "-", lambda cache, kw: search.tune_gemm(
            PARITY_M // p, PARITY_K, 8, "float32", cache, device=device, **kw)["kernel"]),
    ]
    for strategy in STRATEGIES:
        calls += [
            ("combine", strategy, lambda cache, kw, s=strategy: search.tune_combine(
                s, mesh, PARITY_M, PARITY_K, "float32", cache, **kw)["combine"]),
            ("overlap", strategy, lambda cache, kw, s=strategy: search.tune_overlap(
                s, mesh, PARITY_M, PARITY_K, "float32", cache, **kw)["stages"]),
            ("storage", strategy, lambda cache, kw, s=strategy: search.tune_storage(
                s, mesh, PARITY_M, PARITY_STORAGE_K, "float32", cache, **kw)["storage"]),
            # Buckets from 16: smaller ones sit inside the hysteresis band at
            # this operand, so two runs would land b* by noise.
            ("promotion", strategy, lambda cache, kw, s=strategy: search.tune_promotion(
                s, mesh, PARITY_M, PARITY_K, "float32", cache, buckets=(16, 32),
                **kw)["b_star"]),
        ]
    calls.append(("gemm_combine", "colwise", lambda cache, kw: search.tune_gemm_combine(
        "colwise", mesh, PARITY_M, PARITY_K, 8, "float32", cache, **kw)["combine"]))
    return calls


def run_axes(cache, mesh, *, prune_margin, n_reps, log, only=None, force=False):
    """One pass over the tuner's axes: per-axis rows with the decision and
    this call's measured and pruned counts. ``only`` restricts to (axis,
    strategy) pairs (the tie-break retry); ``force`` re-measures over
    cached entries."""
    from ..obs.registry import get_registry

    rows = []
    kw = dict(n_reps=n_reps, samples=1, min_gain=PARITY_MIN_GAIN, log=log,
              prune_margin=prune_margin, measure="sync", force=force)
    for axis, strategy, runner in axis_calls(mesh):
        if only is not None and (axis, strategy) not in only:
            continue
        before = _measured_counts(get_registry().snapshot())
        decision = runner(cache, kw)
        after = _measured_counts(get_registry().snapshot())
        rows.append({"axis": axis, "strategy": strategy, "decision": decision,
                     "measured": after[0] - before[0], "pruned": after[1] - before[1]})
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=default_out("cost_model"))
    add_platform_args(ap, devices=8)
    ap.add_argument("--margin", type=float, default=0.5,
                    help="prune_margin for the pruned pass")
    ap.add_argument("--n-reps", type=int, default=12)
    args = ap.parse_args(argv)

    from ..obs.registry import get_registry, reset_registry
    from ..tuning import search
    from ..tuning.cache import TuningCache, calibration_key, platform_fingerprint
    from ..tuning.cost_model import (
        CostModel,
        calibrate,
        crossover_surface,
        divergence_health,
        write_surface_csv,
    )

    mesh = study_mesh(args)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    p = mesh.size

    print(f"== calibrating ({p}-shard mesh) ==")
    cal = calibrate(mesh, level="full", n_reps=max(args.n_reps, 5))
    (out / "calibration.json").write_text(json.dumps({
        "fingerprint": platform_fingerprint(), "key": calibration_key(p),
        "record": cal.to_record()}, indent=2) + "\n")

    print("== predicted crossover surface ==")
    rows = crossover_surface(CostModel(cal), ms=[256, 1024, 4096, 16384, 65536],
                             ps=[2, 4, 8, 16, 64], dtypes=["float32", "bfloat16"])
    write_surface_csv(rows, out / "crossover.csv")
    print(f"  {len(rows)} surface rows")

    print("== exhaustive tuning pass ==")
    reset_registry()
    ex_cache = TuningCache(out / "exhaustive_cache.json")
    ex_cache.record(calibration_key(p), cal.to_record())
    ex_rows = run_axes(ex_cache, mesh, prune_margin=None, n_reps=args.n_reps, log=print)
    ex_cache.save()

    print(f"== pruned tuning pass (margin {args.margin}) ==")
    reset_registry()
    pr_cache = TuningCache(out / "pruned_cache.json")
    pr_cache.record(calibration_key(p), cal.to_record())
    pr_rows = run_axes(pr_cache, mesh, prune_margin=args.margin, n_reps=args.n_reps,
                       log=print)
    # One deliberate forced re-measure, so the stale counter shows in the
    # snapshot (its candidates land only in metrics.json).
    search.tune_overlap("rowwise", mesh, PARITY_M, PARITY_K, "float32", pr_cache,
                        measure="sync", n_reps=args.n_reps, samples=1,
                        min_gain=PARITY_MIN_GAIN, force=True, prune_margin=args.margin,
                        log=print)

    # Tie-break retry: a near-tie can flip between two independent runs by
    # host noise alone, so a mismatched axis is raced again on both caches
    # and only a reproduced disagreement fails the capture.
    for attempt in range(2):
        mismatched = {(ex["axis"], ex["strategy"]) for ex, pr in zip(ex_rows, pr_rows)
                      if ex["decision"] != pr["decision"]}
        if not mismatched:
            break
        print(f"== tie-break retry {attempt + 1}: {sorted(mismatched)} ==")
        retry_ex = run_axes(ex_cache, mesh, prune_margin=None, n_reps=args.n_reps,
                            log=print, only=mismatched, force=True)
        retry_pr = run_axes(pr_cache, mesh, prune_margin=args.margin, n_reps=args.n_reps,
                            log=print, only=mismatched, force=True)
        by_ex = {(r["axis"], r["strategy"]): r for r in retry_ex}
        by_pr = {(r["axis"], r["strategy"]): r for r in retry_pr}
        ex_rows = [by_ex.get((r["axis"], r["strategy"]), r) for r in ex_rows]
        pr_rows = [by_pr.get((r["axis"], r["strategy"]), r) for r in pr_rows]
    ex_cache.save()
    pr_cache.save()
    (out / "metrics.json").write_text(json.dumps(get_registry().snapshot(), indent=2) + "\n")

    parity_rows, failures = [], []
    for ex, pr in zip(ex_rows, pr_rows):
        match = ex["decision"] == pr["decision"]
        if not match:
            failures.append((ex["axis"], ex["strategy"], ex["decision"], pr["decision"]))
        parity_rows.append({
            "axis": ex["axis"], "strategy": ex["strategy"],
            "decision_exhaustive": ex["decision"], "decision_pruned": pr["decision"],
            "match": int(match), "measured_exhaustive": ex["measured"],
            "measured_pruned": pr["measured"], "pruned": pr["pruned"],
        })
    with open(out / "prune_parity.csv", "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(parity_rows[0]))
        w.writeheader()
        w.writerows(parity_rows)

    total_ex = sum(r["measured_exhaustive"] for r in parity_rows)
    total_pr = sum(r["measured_pruned"] for r in parity_rows)
    total_skip = sum(r["pruned"] for r in parity_rows)
    health = divergence_health()
    print(f"== parity: {len(parity_rows)} axis rows, {total_ex} -> {total_pr} measured "
          f"({1 - total_pr / total_ex:.0%} fewer, {total_skip} pruned), "
          f"divergence {health['median_abs_log10_ratio']:.3f} ==")
    if failures:
        print(f"PARITY FAILURE: {failures}", file=sys.stderr)
        return 1
    if total_pr > 0.6 * total_ex:
        print(f"SAVINGS FAILURE: only {1 - total_pr / total_ex:.0%} fewer candidates "
              "(need >= 40%)", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
