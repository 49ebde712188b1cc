"""Analysis CLI: SpeedUp/Efficiency tables and figures from the CSVs.

The port's counterpart of the JAX package's ``scripts/stats_visualization.py``,
the reference's missing ``stats_visualization.ipynb`` (C13,
``.MISSING_LARGE_BLOBS:1``) as a script. Reads reference-schema CSVs from a
``data/out`` directory (this framework's output or the reference's
committed CSVs) and writes:

* a markdown scaling table per strategy (stdout),
* per-strategy Time/SpeedUp/Efficiency figures,
* a cross-strategy comparison figure at the largest common size,

the figures only where matplotlib is installed (a line says so otherwise).
``--cards`` holds the roofline and MFU columns against that many cards'
peaks, for a run whose p counts logical shards of fewer cards; the table
then says that its SpeedUp/Efficiency measure shards run in turn.

Usage::

    python -m matvec_mpi_multiplier_torch.analysis.stats_visualization \\
        --data-out data/out --itemsize 4 --hbm-peak 3350 --cards 1
"""

from __future__ import annotations

import argparse
import importlib.util
import sys
from pathlib import Path

from ..bench.metrics import read_csv
from ..utils.constants import DTYPE_ITEMSIZE
from .plots import plot_comparison, plot_overlay, plot_roofline, plot_strategy
from .stats import format_table, load_strategy_csv


def _ext_lookups(
    data_out: Path,
) -> tuple[
    dict[str, dict[tuple[int, int, int], int]],
    dict[str, dict[tuple[int, int, int], int]],
]:
    """Per-strategy (m, n, p) → n_rhs and → itemsize maps from the extended
    CSV (the reference schema carries neither: without them GEMM GFLOP/s
    would be understated n_rhs times, and a mixed-dtype dataset would have
    GB/s misstated wherever the one --itemsize does not fit)."""
    ext = data_out / "results_extended.csv"
    n_rhs_l: dict[str, dict[tuple[int, int, int], int]] = {}
    item_l: dict[str, dict[tuple[int, int, int], int]] = {}
    if ext.exists():
        for r in read_csv(ext):
            key = (r["n_rows"], r["n_cols"], r["n_devices"])
            n_rhs = r.get("n_rhs", 1)
            if isinstance(n_rhs, int) and n_rhs > 1:
                n_rhs_l.setdefault(r["strategy"], {})[key] = n_rhs
            isz = DTYPE_ITEMSIZE.get(str(r.get("dtype", "")))
            if isz is not None:
                per = item_l.setdefault(r["strategy"], {})
                # The same (size, p) at two dtypes: the averaged row has no
                # one itemsize, so it falls back to --itemsize.
                per[key] = isz if per.get(key, isz) == isz else None
    for per in item_l.values():
        for key in [k for k, v in per.items() if v is None]:
            del per[key]
    return n_rhs_l, item_l


def load_run(data_out: Path) -> dict[str, list]:
    """Load every per-strategy CSV in a data/out directory, keyed by stem."""
    lookups, item_lookups = _ext_lookups(data_out)

    def strategy_of(stem: str) -> str:
        # Every file variant of a strategy (asymmetric_, _reference,
        # _reference_derived) hits the same extended-CSV strategy key.
        stem = stem.replace("asymmetric_", "")
        for suffix in ("_reference_derived", "_reference"):
            stem = stem.removesuffix(suffix)
        return stem

    run: dict[str, list] = {}
    for path in sorted(data_out.glob("*.csv")):
        if path.stem == "results_extended":
            continue
        run.setdefault(path.stem, []).extend(
            load_strategy_csv(
                path,
                n_rhs_lookup=lookups.get(strategy_of(path.stem)),
                itemsize_lookup=item_lookups.get(strategy_of(path.stem)),
            )
        )
    return run


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(
        prog="matvec-torch-stats",
        description="SpeedUp/Efficiency tables and Time/SpeedUp/Efficiency "
        "figures from a data/out directory of CSVs.",
    )
    p.add_argument("--data-out", default="data/out", help="directory of CSVs")
    p.add_argument("--fig-dir", default="figures", help="output directory")
    p.add_argument(
        "--itemsize", type=int, default=8,
        help="bytes per element for GB/s (8=fp64, 4=fp32, 2=bf16)",
    )
    p.add_argument(
        "--hbm-peak", type=float, default=None, metavar="GBPS",
        help="per-card HBM peak GB/s; adds the roofline %%-of-peak column "
        "(3350 for the H100)",
    )
    p.add_argument(
        "--mxu-peak", type=float, default=None, metavar="TFLOPS",
        help="per-card tensor-core peak TFLOP/s; adds the MFU column, the "
        "compute roofline of GEMM rows (989 bf16 TFLOP/s for the H100)",
    )
    p.add_argument(
        "--cards", type=int, default=None, metavar="N",
        help="the run's card count: the roofline and MFU columns hold the "
        "rows against N cards' peaks (default: one device a shard, p)",
    )
    p.add_argument(
        "--overlay", nargs="+", default=None, metavar="LABEL=DIR",
        help="overlay runs from several data/out dirs in one figure at the "
        "largest shared size, e.g. --overlay 'reference=/path/data/out' "
        "'this work=data/out'",
    )
    args = p.parse_args(argv)
    if args.hbm_peak is not None and args.hbm_peak <= 0:
        p.error("--hbm-peak must be positive")
    if args.mxu_peak is not None and args.mxu_peak <= 0:
        p.error("--mxu-peak must be positive")
    if args.cards is not None and args.cards < 1:
        p.error("--cards must be >= 1")

    data_out = Path(args.data_out)
    by_strategy = load_run(data_out)
    if not by_strategy and not args.overlay:
        print(f"no CSVs in {data_out}", file=sys.stderr)
        return 1
    figures = importlib.util.find_spec("matplotlib") is not None
    if not figures:
        print("figures: matplotlib is not installed; tables only")

    for name, points in by_strategy.items():
        print(f"\n## {name}\n")
        if args.cards is not None and any(q.n_processes > args.cards for q in points):
            print(f"p counts logical shards of {args.cards} card(s): SpeedUp "
                  "and Efficiency over p measure shards run in turn, not "
                  "scaling")
        print(
            format_table(
                points, itemsize=args.itemsize, hbm_peak_gbps=args.hbm_peak,
                mxu_peak_tflops=args.mxu_peak, n_cards=args.cards,
            )
        )
        if figures:
            fig = plot_strategy(points, Path(args.fig_dir) / f"{name}.png",
                                title=name)
            print(f"\nfigure: {fig}")

    if not figures:
        return 0
    if args.hbm_peak is not None and by_strategy:
        # One roofline per device count present in the dataset (the roof
        # and the per-card bytes both depend on it).
        matvec = {
            k: v for k, v in by_strategy.items() if not k.startswith("gemm")
        }
        counts = sorted({
            q.n_processes for pts in matvec.values() for q in pts
            if q.n_rhs == 1
        })
        for n_proc in counts:
            suffix = "" if n_proc == 1 else f"_p{n_proc}"
            fig = plot_roofline(
                matvec,
                Path(args.fig_dir) / f"roofline{suffix}.png",
                itemsize=args.itemsize, hbm_peak_gbps=args.hbm_peak,
                n_processes=n_proc, n_cards=args.cards,
            )
            if fig is not None:
                print(f"\nroofline figure (p={n_proc}): {fig}")

    if args.overlay:
        runs: dict[str, dict[str, list]] = {}
        for spec in args.overlay:
            label, _, d = spec.partition("=")
            if not d:
                p.error(f"--overlay expects LABEL=DIR, got {spec!r}")
            run = load_run(Path(d))
            if not run:
                p.error(f"--overlay: no strategy CSVs in {d!r}")
            runs[label] = run
        size_sets = [
            {(q.n_rows, q.n_cols) for pts in run.values() for q in pts}
            for run in runs.values()
        ]
        shared_sizes = set.intersection(*size_sets) if size_sets else set()
        if shared_sizes:
            m, n = max(shared_sizes, key=lambda s: s[0] * s[1])
            fig = plot_overlay(
                runs, m, n, Path(args.fig_dir) / f"overlay_{m}x{n}.png"
            )
            print(f"\noverlay figure: {fig}")
        else:
            print("\nno size shared by all overlay runs", file=sys.stderr)

    # Comparison at the largest size shared by >1 strategy, per op: matvec
    # and GEMM curves never share a figure (different operations).
    for op, strategies in (
        ("comparison", {k: v for k, v in by_strategy.items()
                        if not k.startswith("gemm")}),
        ("gemm_comparison", {k: v for k, v in by_strategy.items()
                             if k.startswith("gemm")}),
    ):
        sizes: dict[tuple[int, int], int] = {}
        for points in strategies.values():
            for size in {(q.n_rows, q.n_cols) for q in points}:
                sizes[size] = sizes.get(size, 0) + 1
        shared = [s for s, c in sizes.items() if c > 1]
        if shared:
            m, n = max(shared, key=lambda s: s[0] * s[1])
            fig = plot_comparison(
                strategies, m, n, Path(args.fig_dir) / f"{op}_{m}x{n}.png"
            )
            print(f"\n{op} figure: {fig}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
