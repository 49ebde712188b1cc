"""Render the per-size results table from an extended CSV.

The port's counterpart of the JAX package's ``scripts/results_table.py``:
markdown to stdout, one row per size, one column per strategy, each cell the
time (ms) with the aggregate effective GB/s, from
``<data-root>/out/results_extended.csv`` (the last row of a key wins: the
CSV is append-only).

Usage::

    python -m matvec_mpi_multiplier_torch.analysis.results_table \\
        --data-root data --shape asym
"""

from __future__ import annotations

import argparse
import sys
from collections import defaultdict
from pathlib import Path

from ..bench.metrics import read_csv


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(
        prog="matvec-torch-results-table",
        description="Per-size results table (time and GB/s per strategy) "
        "from the extended CSV.",
    )
    p.add_argument("--data-root", default="data")
    p.add_argument("--measure", default="loop",
                   help="protocol filter (loop = the device rep loop)")
    p.add_argument("--mode", default="amortized")
    p.add_argument("--dtype", default="float32")
    p.add_argument("--devices", type=int, default=1)
    p.add_argument("--shape", choices=["square", "asym", "all"],
                   default="square")
    args = p.parse_args(argv)

    ext = Path(args.data_root) / "out" / "results_extended.csv"
    if not ext.exists():
        print(f"no dataset at {ext}", file=sys.stderr)
        return 1
    rows = [
        r for r in read_csv(ext)
        if r["measure"] == args.measure and r["mode"] == args.mode
        and r["dtype"] == args.dtype and r["n_devices"] == args.devices
        and r["n_rhs"] == 1
    ]
    if args.shape != "all":
        want_square = args.shape == "square"
        rows = [r for r in rows if (r["n_rows"] == r["n_cols"]) == want_square]
    if not rows:
        print(
            f"no {args.measure}/{args.mode}/{args.dtype} p={args.devices} "
            f"rows in {ext}", file=sys.stderr,
        )
        return 1

    # cells[size][strategy] = (time, gbps); the last row per key wins.
    cells: dict[tuple, dict] = defaultdict(dict)
    strategies: list[str] = []
    for r in rows:
        if r["strategy"] not in strategies:
            strategies.append(r["strategy"])
        cells[(r["n_rows"], r["n_cols"])][r["strategy"]] = (r["time"], r["gbps"])
    strategies.sort()

    header = "| size | " + " | ".join(strategies) + " |"
    sep = "|---" * (len(strategies) + 1) + "|"
    lines = [header, sep]
    for (m, n) in sorted(cells, key=lambda s: (s[0] * s[1], s)):
        label = f"{m}²" if m == n else f"{m}×{n}"
        row = [label]
        for s in strategies:
            if s in cells[(m, n)]:
                t, g = cells[(m, n)][s]
                row.append(f"{t * 1e3:.3f} ms ({g:.0f} GB/s)")
            else:
                row.append("—")
        lines.append("| " + " | ".join(row) + " |")
    print("\n".join(lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
