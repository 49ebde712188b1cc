"""Time / SpeedUp / Efficiency figures.

The port's counterpart of the JAX package's ``analysis/plots.py``.
Reinstates the reference's missing ``stats_visualization.ipynb`` (C13): per
strategy, three curves over process/device count for each matrix size, plus a
cross-strategy comparison at a fixed size — the figures the reference README
embeds as (dead) image links (``README.md:59-68``).

Matplotlib is imported lazily so the core framework has no hard plotting
dependency. The roofline draws the H100's L2 as its residency boundary and
takes the number of cards (``n_cards``) where p counts logical shards.
"""

from __future__ import annotations

import os
from collections import defaultdict
from pathlib import Path

from .stats import ScalingPoint


def _mpl():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _series(points: list[ScalingPoint]):
    """Group points into {(n_rows, n_cols): sorted [(p, point)]}."""
    by_size = defaultdict(list)
    for p in points:
        by_size[(p.n_rows, p.n_cols)].append(p)
    return {
        size: sorted(ps, key=lambda q: q.n_processes)
        for size, ps in sorted(by_size.items())
    }


def plot_strategy(
    points: list[ScalingPoint], out_path: str | os.PathLike, title: str = ""
) -> Path:
    """One figure per strategy: Time, SpeedUp, Efficiency vs device count,
    one line per matrix size (the README's per-algorithm figure set)."""
    plt = _mpl()
    fig, axes = plt.subplots(1, 3, figsize=(15, 4))
    panels = [
        ("time_s", "Time (s)", lambda q: q.time_s),
        ("speedup", "SpeedUp  S = T1/Tp", lambda q: q.speedup),
        ("efficiency", "Efficiency  E = S/p", lambda q: q.efficiency),
    ]
    for ax, (_, ylabel, get) in zip(axes, panels):
        for (m, n), ps in _series(points).items():
            xs = [q.n_processes for q in ps if get(q) is not None]
            ys = [get(q) for q in ps if get(q) is not None]
            if xs:
                ax.plot(xs, ys, marker="o", label=f"{m}×{n}")
        ax.set_xlabel("devices")
        ax.set_ylabel(ylabel)
        ax.grid(True, alpha=0.3)
    axes[0].set_yscale("log")
    axes[1].legend(fontsize=7, ncol=2)
    fig.suptitle(title or (points[0].strategy if points else ""))
    fig.tight_layout()
    out_path = Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def plot_overlay(
    runs: dict[str, dict[str, list[ScalingPoint]]],
    n_rows: int,
    n_cols: int,
    out_path: str | os.PathLike,
) -> Path:
    """Overlay Time/SpeedUp/Efficiency curves from multiple result sets.

    ``runs`` maps a run label (e.g. "reference (MPI)", "this work (CPU
    shards)") to its per-strategy points: the port's card or CPU-shard
    curves drawn directly over the reference's MPI process-count curves at one matrix size, one linestyle per run, one
    color per strategy. With a single run under an empty label this renders
    the plain single-run comparison (see :func:`plot_comparison`).
    """
    plt = _mpl()
    fig, axes = plt.subplots(1, 3, figsize=(15, 4))
    panels = [
        ("Time (s)", lambda q: q.time_s),
        ("SpeedUp", lambda q: q.speedup),
        ("Efficiency", lambda q: q.efficiency),
    ]
    linestyles = ["-", "--", ":", "-."]
    colors: dict[str, object] = {}
    for run_i, (run_label, by_strategy) in enumerate(runs.items()):
        ls = linestyles[run_i % len(linestyles)]
        for name, points in sorted(by_strategy.items()):
            ps = sorted(
                (q for q in points if (q.n_rows, q.n_cols) == (n_rows, n_cols)),
                key=lambda q: q.n_processes,
            )
            if not ps:
                continue
            if name not in colors:
                colors[name] = f"C{len(colors)}"
            curve_label = f"{name} [{run_label}]" if run_label else name
            for ax, (ylabel, get) in zip(axes, panels):
                xs = [q.n_processes for q in ps if get(q) is not None]
                ys = [get(q) for q in ps if get(q) is not None]
                if xs:
                    ax.plot(
                        xs, ys, marker="o", linestyle=ls, color=colors[name],
                        label=curve_label,
                    )
    for ax, (ylabel, _) in zip(axes, panels):
        ax.set_xlabel("processes / devices")
        ax.set_ylabel(ylabel)
        ax.grid(True, alpha=0.3)
    axes[0].set_yscale("log")
    axes[0].legend(fontsize=6 if len(runs) > 1 else 8)
    title = f"{n_rows}×{n_cols}"
    if len(runs) > 1:
        title += ": overlaid runs"
    fig.suptitle(title)
    fig.tight_layout()
    out_path = Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def plot_comparison(
    by_strategy: dict[str, list[ScalingPoint]],
    n_rows: int,
    n_cols: int,
    out_path: str | os.PathLike,
) -> Path:
    """Cross-strategy Time/SpeedUp/Efficiency at one size (the README's
    comparison figures at the largest sweep size) — the single-run special
    case of :func:`plot_overlay`."""
    return plot_overlay({"": by_strategy}, n_rows, n_cols, out_path)


def plot_roofline(
    by_strategy: dict[str, list[ScalingPoint]],
    out_path: str | os.PathLike,
    *,
    itemsize: int = 4,
    hbm_peak_gbps: float,
    l2_bytes: int | None = None,
    n_processes: int = 1,
    n_cards: int | None = None,
) -> Path | None:
    """Effective bandwidth vs per-card operand bytes, against the HBM roof.

    The memory-side counterpart of the Time/SpeedUp panels: one line per
    strategy (matvec rows at ``n_processes`` shards), x = the matrix bytes
    on one card (log), y = effective GB/s, a horizontal line at the HBM
    peak of the cards (``n_cards``; None: one card a shard, the JAX rule),
    and a vertical boundary at the L2's capacity — sizes left of it may sit
    above the HBM roof through cache residency (``stats.format_table``'s
    (L2) marker). Returns None when no matvec rows match ``n_processes``.
    """
    from ..utils.constants import H100_L2_BYTES

    l2 = H100_L2_BYTES if l2_bytes is None else l2_bytes
    cards = n_processes if n_cards is None else n_cards
    plt = _mpl()
    fig, ax = plt.subplots(figsize=(7, 4.5))
    drew = False
    for name, points in sorted(by_strategy.items()):
        rows = sorted(
            (p for p in points
             if p.n_rhs == 1 and p.n_processes == n_processes),
            key=lambda p: p.n_rows * p.n_cols,
        )
        xs = [(p.itemsize or itemsize) * p.n_rows * p.n_cols / cards
              for p in rows]
        ys = [p.gbps(itemsize) for p in rows]
        if xs:
            ax.plot(xs, ys, marker="o", ms=3, label=name)
            drew = True
    if not drew:
        plt.close(fig)
        return None
    # gbps() is AGGREGATE bandwidth, so the roof scales with the cards —
    # stats.format_table's %-of-peak rule.
    roof = hbm_peak_gbps * cards
    ax.axhline(roof, color="k", ls="--", lw=1,
               label=f"HBM peak ({roof:.0f} GB/s, {cards} card(s), "
                     f"p={n_processes})")
    ax.axvline(l2, color="gray", ls=":", lw=1,
               label=f"L2 capacity ({l2 / 1e6:.0f} MB)")
    ax.set_xscale("log")
    ax.set_xlabel(f"per-card matrix bytes (p={n_processes})")
    ax.set_ylabel("effective GB/s")
    ax.grid(True, alpha=0.3)
    ax.legend(fontsize=7)
    ax.set_title(
        "Bandwidth roofline (left of the L2 line: cache residency)",
        fontsize=10,
    )
    fig.tight_layout()
    out_path = Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def plot_crossover_roofline(
    points: list[tuple[int, float, float]],
    out_path: str | os.PathLike,
    *,
    hbm_peak_gbps: float,
    mxu_peak_gflops: float,
) -> Path | None:
    """The classic roofline diagram for the GEMV→GEMM crossover study.

    ``points`` are ``(n_rhs, intensity FLOP/byte, achieved GFLOP/s)`` from
    one n_rhs sweep at a fixed matrix. Axes
    are log-log: the bandwidth roof is the slope ``hbm · I``, the compute
    roof the flat ``mxu`` line, their intersection the ridge. Measured
    points hug the slope while HBM-bound and peel onto the flat roof past
    the knee — the figure form of the study's t/t_bw column. Returns None
    on no points (every row unmeasurable).
    """
    if not points:
        return None
    plt = _mpl()
    fig, ax = plt.subplots(figsize=(6.5, 4.5))
    pts = sorted(points)
    xs = [i for _, i, _ in pts]
    ys = [g for _, _, g in pts]
    lo, hi = min(xs) / 2, max(xs) * 2
    grid = [lo * (hi / lo) ** (k / 200) for k in range(201)]
    ax.plot(grid, [min(hbm_peak_gbps * i, mxu_peak_gflops) for i in grid],
            color="k", ls="--", lw=1,
            label=f"roofline (HBM {hbm_peak_gbps:.0f} GB/s, "
                  f"compute {mxu_peak_gflops / 1e3:.0f} TFLOP/s)")
    ridge = mxu_peak_gflops / hbm_peak_gbps
    ax.axvline(ridge, color="gray", ls=":", lw=1,
               label=f"ridge ({ridge:.0f} FLOP/byte)")
    ax.plot(xs, ys, marker="o", ms=4, color="C0", label="measured")
    for (r, i, g) in pts:
        ax.annotate(f"r={r}", (i, g), textcoords="offset points",
                    xytext=(4, -9), fontsize=7)
    ax.set_xscale("log")
    ax.set_yscale("log")
    ax.set_xlabel("arithmetic intensity (FLOP/byte)")
    ax.set_ylabel("achieved GFLOP/s")
    ax.grid(True, alpha=0.3, which="both")
    ax.legend(fontsize=7, loc="lower right")
    ax.set_title("GEMV→GEMM crossover on the roofline (r = n_rhs)",
                 fontsize=10)
    fig.tight_layout()
    out_path = Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path
