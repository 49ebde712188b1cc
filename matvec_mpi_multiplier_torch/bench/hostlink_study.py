"""Measure the host→device link and derive reference-mode (Q5) CSV rows.

The port's counterpart of the JAX package's ``scripts/hostlink_study.py``:

1. measure the host→card link once over a bounded size ladder
   (``bench/hostlink.py``, the pageable copy the ``reference`` mode times)
   and print the fitted latency/bandwidth model;
2. read the amortized rows of the extended CSV;
3. derive and append reference-mode rows (``mode="reference_derived"``,
   ``measure="derived"``) to the per-strategy
   ``<strategy>_reference_derived.csv`` and the extended CSV, a file apart
   from literal ``mode="reference"`` measurements. Re-runs are idempotent
   per config.

Usage::

    python -m matvec_mpi_multiplier_torch.bench.hostlink_study --data-root data
    python -m matvec_mpi_multiplier_torch.bench.hostlink_study --platform cpu \\
        --data-root /tmp/x --max-mb 4
"""

from __future__ import annotations

import argparse
import sys


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(
        prog="matvec-torch-hostlink",
        description="Measure the host->device link and derive reference-mode "
        "rows from the amortized ones.",
    )
    p.add_argument("--data-root", default="data", help="data directory root")
    p.add_argument(
        "--max-mb", type=int, default=256,
        help="largest transfer in the measurement ladder (MB)",
    )
    p.add_argument("--reps", type=int, default=3, help="transfers per ladder size")
    p.add_argument(
        "--platform", choices=["cuda", "cpu"], default="cuda",
        help="where the link ends: cuda:0 (default) or the CPU",
    )
    args = p.parse_args(argv)

    from .hostlink import DEFAULT_LADDER_BYTES, derive_reference_result, measure_link
    from .metrics import append_result, extended_csv_path, read_csv
    from .timing import TimingResult

    ladder = [b for b in DEFAULT_LADDER_BYTES if b <= args.max_mb * 2**20]
    device = "cpu" if args.platform == "cpu" else None
    link = measure_link(ladder, reps=args.reps, device=device)
    print(
        f"link: alpha={link.alpha_s * 1e3:.3f} ms  "
        f"bandwidth={link.gbps:.2f} GB/s  "
        f"({len(link.samples)} ladder points, min of {args.reps})"
    )

    ext = extended_csv_path(args.data_root)
    if not ext.exists():
        print(f"no amortized rows at {ext}; link model printed only")
        return 0

    def key(row):
        return (
            row["n_rows"], row["n_cols"], row["n_devices"], row["strategy"],
            row["dtype"], row.get("n_rhs", 1),
        )

    all_rows = read_csv(ext)
    # Idempotent re-runs: a config that already has a derived row keeps it
    # (a second would over-weight it in the analysis's averaging).
    already = {key(r) for r in all_rows if r.get("mode") == "reference_derived"}
    n_derived = n_skipped = 0
    for row in all_rows:
        if row.get("mode") != "amortized":
            continue
        if key(row) in already:
            n_skipped += 1
            continue
        already.add(key(row))
        amortized = TimingResult(
            n_rows=row["n_rows"],
            n_cols=row["n_cols"],
            n_devices=row["n_devices"],
            strategy=row["strategy"],
            dtype=row["dtype"],
            mode=row["mode"],
            measure=row["measure"],
            mean_time_s=row["time"],
            times_s=(row["time"],),
            n_rhs=row.get("n_rhs", 1),
        )
        append_result(derive_reference_result(amortized, link), args.data_root)
        n_derived += 1
    print(
        f"{n_derived} reference-mode rows derived"
        + (f", {n_skipped} already present (skipped)" if n_skipped else "")
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
