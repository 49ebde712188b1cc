"""SpeedUp / Efficiency analysis.

The port's counterpart of the JAX package's ``analysis/stats.py``.
Reference analog: components C13/C14 — the *missing* plotting notebook
``stats_visualization.ipynb`` (listed in ``.MISSING_LARGE_BLOBS:1``) that
consumed ``data/out/*.csv`` and produced the README's Time / SpeedUp /
Efficiency figures (``README.md:59-68``). Formulas (``README.md:47-50``):

* SpeedUp   ``S_p = T_1 / T_p``  (baseline = same strategy, same size, p=1)
* Efficiency ``E_p = S_p / p``

plus the derived throughput columns: ``GFLOP/s = 2·m·n / T / 1e9`` and
``GB/s = itemsize·(m·n + m + n) / T / 1e9``.

Reads this framework's CSVs and the reference's committed ones (both header
variants, ``bench.metrics.read_csv``). Two departures from the JAX package,
both about the card: the residency boundary is the H100's L2
(``H100_L2_BYTES``, the marker ``(L2)``, what the chip runs call
``l2_resident``), and the roofline and MFU columns can take the number of
cards (``n_cards``): in the port p may count logical shards of one card,
whose peak does not grow with p. ``n_cards=None`` keeps the JAX rule
(peak × p).
"""

from __future__ import annotations

import dataclasses
import os
from collections import defaultdict
from pathlib import Path
from typing import Iterable

from ..bench.metrics import read_csv
from ..utils.constants import H100_L2_BYTES


@dataclasses.dataclass(frozen=True)
class ScalingPoint:
    n_rows: int
    n_cols: int
    n_processes: int
    time_s: float
    speedup: float | None  # None when no p=1 baseline exists for this size
    efficiency: float | None
    strategy: str = ""
    # Right-hand-side width: 1 = matvec (the reference's scope); >1 = GEMM
    # rows (gemm_<strategy>.csv) — the throughput formulas depend on it.
    n_rhs: int = 1
    # Bytes per element when known for THIS row (from the extended CSV's
    # dtype column); None → the caller-supplied table default.
    itemsize: int | None = None

    def gflops(self) -> float:
        return (
            2.0 * self.n_rows * self.n_cols * self.n_rhs / self.time_s / 1e9
        )

    def gbps(self, itemsize: int = 8) -> float:
        elems = (
            self.n_rows * self.n_cols
            + (self.n_rows + self.n_cols) * self.n_rhs
        )
        return (self.itemsize or itemsize) * elems / self.time_s / 1e9


def _mean_times(rows: Iterable[dict]) -> dict[tuple[int, int, int], float]:
    """Average duplicate rows (append-only CSVs accumulate re-runs)."""
    acc: dict[tuple[int, int, int], list[float]] = defaultdict(list)
    for r in rows:
        key = (int(r["n_rows"]), int(r["n_cols"]), int(r["n_processes"]))
        acc[key].append(float(r["time"]))
    return {k: sum(v) / len(v) for k, v in acc.items()}


def scaling_table(
    rows: Iterable[dict],
    strategy: str = "",
    n_rhs_lookup: dict[tuple[int, int, int], int] | None = None,
    itemsize_lookup: dict[tuple[int, int, int], int] | None = None,
) -> list[ScalingPoint]:
    """Compute S and E for every (size, p) against the p=1 row of the same
    size (README.md:47-50).

    ``n_rhs_lookup`` maps (n_rows, n_cols, p) → RHS width for GEMM rows and
    ``itemsize_lookup`` the same key → operand bytes per element (the
    reference CSV schema carries neither; the extended CSV does, and
    ``stats_visualization`` builds both lookups from it).
    """
    means = _mean_times(rows)
    points = []
    for (m, n, p), t in sorted(means.items()):
        t1 = means.get((m, n, 1))
        s = t1 / t if t1 is not None else None
        points.append(
            ScalingPoint(
                n_rows=m, n_cols=n, n_processes=p, time_s=t,
                speedup=s, efficiency=(s / p if s is not None else None),
                strategy=strategy,
                n_rhs=(n_rhs_lookup or {}).get((m, n, p), 1),
                itemsize=(itemsize_lookup or {}).get((m, n, p)),
            )
        )
    return points


def load_strategy_csv(
    path: str | os.PathLike,
    strategy: str = "",
    n_rhs_lookup: dict[tuple[int, int, int], int] | None = None,
    itemsize_lookup: dict[tuple[int, int, int], int] | None = None,
) -> list[ScalingPoint]:
    path = Path(path)
    if not strategy:
        strategy = path.stem.replace("asymmetric_", "")
    return scaling_table(
        read_csv(path), strategy=strategy, n_rhs_lookup=n_rhs_lookup,
        itemsize_lookup=itemsize_lookup,
    )


def best_point(points: list[ScalingPoint], n_rows: int, n_cols: int) -> ScalingPoint:
    """Fastest configuration for a given size (the README's 'best wall time'
    comparison, README.md:71-75)."""
    cands = [p for p in points if p.n_rows == n_rows and p.n_cols == n_cols]
    if not cands:
        raise ValueError(f"no rows for size {n_rows}x{n_cols}")
    return min(cands, key=lambda p: p.time_s)


def _peak_units(p: ScalingPoint, n_cards: int | None) -> int:
    """How many devices' peaks a row's aggregate rate is held against: the
    cards, where given, else p (the JAX package's rule, one chip a shard)."""
    return p.n_processes if n_cards is None else n_cards


def format_table(
    points: list[ScalingPoint],
    itemsize: int = 8,
    hbm_peak_gbps: float | None = None,
    mxu_peak_tflops: float | None = None,
    l2_bytes: int = H100_L2_BYTES,
    n_cards: int | None = None,
) -> str:
    """Markdown table in the BASELINE.md column layout.

    ``hbm_peak_gbps`` adds the roofline column (%-of-HBM-peak): aggregate
    peak = per-card peak × the cards (``n_cards``; None: × p), e.g. 3350
    for the H100. Rows whose matrix fits the L2 of the card that holds it
    (``l2_bytes``; the matrix over ``n_cards``, or over p when None) are
    marked ``(L2)``: the rep loop can serve it from cache, so its
    percentage is not an HBM fraction.

    ``mxu_peak_tflops`` adds the MFU column (%-of-tensor-core-peak, the
    compute roofline of GEMM rows), with the same aggregate rule, e.g. 989
    bf16 TFLOP/s for the H100. Matvec rows get one too, but for them HBM is
    the binding roof.
    """
    roofline = hbm_peak_gbps is not None
    mfu = mxu_peak_tflops is not None
    lines = [
        "| Strategy | Matrix | p | Time (s) | SpeedUp | Efficiency | GFLOP/s | GB/s |"
        + (" % HBM peak |" if roofline else "")
        + (" MFU % |" if mfu else ""),
        "|---|---|---|---|---|---|---|---|"
        + ("---|" if roofline else "")
        + ("---|" if mfu else ""),
    ]
    for p in points:
        s = f"{p.speedup:.2f}" if p.speedup is not None else "—"
        e = f"{p.efficiency:.3f}" if p.efficiency is not None else "—"
        row = (
            f"| {p.strategy} | {p.n_rows}×{p.n_cols} | {p.n_processes} "
            f"| {p.time_s:.6f} | {s} | {e} | {p.gflops():.2f} "
            f"| {p.gbps(itemsize):.2f} |"
        )
        units = _peak_units(p, n_cards)
        if roofline:
            pct = 100.0 * p.gbps(itemsize) / (hbm_peak_gbps * units)
            # The per-point itemsize, as the gbps above honours it.
            per_card_bytes = (
                (p.itemsize or itemsize) * p.n_rows * p.n_cols / max(1, units)
            )
            mark = " (L2)" if per_card_bytes <= l2_bytes else ""
            row += f" {pct:.1f}{mark} |"
        if mfu:
            pct = 100.0 * p.gflops() / (mxu_peak_tflops * 1e3 * units)
            row += f" {pct:.1f} |"
        lines.append(row)
    return "\n".join(lines)
