"""Quantized-storage evidence: the tuner's storage race and the error budget.

The port's counterpart of the JAX package's ``scripts/quantized_study.py``.
Two outputs under ``--out`` (default ``data/torch_demo/quantized``):

* **The storage race**: ``tuning/search.py::tune_storage`` for each
  (strategy, m, k) cell — every supported format quantized, placed and
  raced as the full distributed matvec (the block-scaled GEMV
  ``csrc/quant_gemv.cu`` on every shard on the card), winners with each
  candidate's resident bytes and rate in ``tuning_cache.json``;
* **Error-budget compliance** (:func:`error_study`): per format, the
  distributed matvec against the numpy fp64 oracle, the normwise residual
  against its budget seat (``ops.quantize.FP32_LEVEL_RELERR`` for int8c,
  four times ``INT8_EPS`` for int8 and fp8) and the resident-bytes ratio,
  in ``errors.json`` (merged with earlier runs' cells).

The storage race's ``speculate`` candidate serves from int8c and escalates
a miss to native, so the error study has no row of its own for it.

Usage::

    python -m matvec_mpi_multiplier_torch.bench.quantized_study
    python -m matvec_mpi_multiplier_torch.bench.quantized_study --platform cpu \\
        --host-devices 8 --sizes 256 --n-reps 3 --samples 1 --out /tmp/q
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from .studies import add_platform_args, default_out, platform_label, study_mesh

# (strategy, m, k) cells raced by default: one output-sharded and one
# contraction-sharded strategy.
DEFAULT_CONFIGS = (("rowwise", 512, 4096), ("colwise", 512, 4096))


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default=default_out("quantized"),
                   help="output directory (cache + errors.json)")
    add_platform_args(p, devices=None)
    p.add_argument("--strategy", nargs="+", default=None,
                   help="strategies to race (default: rowwise colwise)")
    p.add_argument("--sizes", nargs="+", type=int, default=None,
                   help="square sizes overriding the default config cells")
    p.add_argument("--n-reps", type=int, default=30, help="timing reps per candidate")
    p.add_argument("--samples", type=int, default=3, help="slope samples per candidate")
    p.add_argument("--seed", type=int, default=0)
    return p


def error_study(configs, seed: int, mesh) -> dict:
    """Normwise residual against the fp64 oracle per (config, format) on
    ``mesh``, with the budget seat each format must clear."""
    import numpy as np
    import torch

    from ..models import get_strategy
    from ..ops.quantize import FP32_LEVEL_RELERR, INT8_EPS, quantize_matrix
    from ..tuning.search import storage_format_candidates
    from ..utils.io import generate_matrix, generate_vector

    budgets = {"int8": 4 * INT8_EPS, "fp8": 4 * INT8_EPS, "int8c": FP32_LEVEL_RELERR}
    out: dict = {"budgets": budgets, "configs": {}}
    device = mesh.devices[0]
    for name, m, k in configs:
        strat = get_strategy(name)
        a = np.asarray(generate_matrix(m, k, seed=seed), np.float32)
        x = np.asarray(generate_vector(k, seed=seed + 1), np.float32)
        oracle = a.astype(np.float64) @ x.astype(np.float64)
        scale = np.abs(oracle).max()
        a_t, x_t = torch.from_numpy(a).to(device), torch.from_numpy(x).to(device)
        shards = strat.contraction_shards(mesh)
        entry: dict = {}
        for fmt in storage_format_candidates("float32"):
            if fmt == "speculate":
                continue
            if fmt == "native":
                fn, operand, nbytes = strat.build(mesh), a_t, a.nbytes
            else:
                operand = quantize_matrix(a_t, fmt, contraction_shards=shards)
                fn, nbytes = strat.build(mesh, dtype_storage=fmt), operand.nbytes
            y = fn(*strat.place(operand, x_t, mesh)).to("cpu", torch.float64).numpy()  # fp64-ok: compared with the fp64 oracle
            relerr = float(np.abs(y - oracle).max() / scale)
            entry[fmt] = {
                "max_relerr_vs_fp64": relerr,
                "bytes_ratio": round(nbytes / a.nbytes, 6),
                "budget": budgets.get(fmt),
                "within_budget": True if fmt == "native" else relerr <= budgets[fmt],
            }
        out["configs"][f"{name}|{m}x{k}"] = entry
    return out


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from ..tuning.cache import TuningCache
    from ..tuning.search import tune_storage

    mesh = study_mesh(args)
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    strategies = args.strategy or sorted({c[0] for c in DEFAULT_CONFIGS})
    if args.sizes:
        configs = [(s, n, n) for s in strategies for n in args.sizes]
    else:
        configs = [c for c in DEFAULT_CONFIGS if c[0] in strategies]

    # load(), not a fresh cache: repeated runs accumulate into one cache.
    cache = TuningCache.load(out_dir / "tuning_cache.json")
    print(f"storage race on {mesh.size} shards ({platform_label(mesh)}):")
    for name, m, k in configs:
        decision = tune_storage(name, mesh, m, k, "float32", cache, n_reps=args.n_reps,
                                samples=args.samples, seed=args.seed, force=True)
        if decision is not None:
            print(f"  -> {name} {m}x{k}: {decision['storage']}")
    cache.save()
    print(f"cache: {cache.path}")

    errors = error_study(configs, args.seed, mesh)
    errors_path = out_dir / "errors.json"
    if errors_path.exists():
        try:
            merged = dict(json.loads(errors_path.read_text()).get("configs", {}))
            merged.update(errors["configs"])
            errors["configs"] = merged
        except (json.JSONDecodeError, AttributeError):
            pass  # a hand-damaged errors.json is rewritten from this run's measurements
    bad = [(cfg, fmt) for cfg, entry in errors["configs"].items()
           for fmt, row in entry.items() if not row["within_budget"]]
    errors_path.write_text(json.dumps(errors, indent=1, sort_keys=True) + "\n")
    print(f"errors: {errors_path}")
    for cfg, entry in errors["configs"].items():
        for fmt, row in entry.items():
            mark = "ok" if row["within_budget"] else "OVER BUDGET"
            print(f"  {cfg} {fmt}: relerr {row['max_relerr_vs_fp64']:.2e} "
                  f"bytes {row['bytes_ratio']:.3f}x [{mark}]")
    if bad:
        print(f"ERROR-BUDGET FAILURES: {bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
