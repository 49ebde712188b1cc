"""The port's SpeedUp/Efficiency analysis (``analysis/stats.py``,
``analysis/plots.py`` and the two CLIs) against the JAX package's
(``tests/test_analysis.py``, ``scripts/stats_visualization.py``,
``scripts/results_table.py``), on the repo's committed ``data/out`` CSVs and
synthetic points.

``ScalingPoint``s are equal; ``format_table`` strings are bitwise the JAX
package's once its ``(VMEM)`` marker reads ``(L2)`` at the same boundary.
The port's own defaults: the H100's L2 (``H100_L2_BYTES``) as the boundary,
and ``n_cards`` holding the roofline and MFU columns against the cards'
peaks instead of p's.
"""

import dataclasses
import importlib.util
import sys
from pathlib import Path

import pytest

from matvec_mpi_multiplier_tpu.analysis import plots as jplots
from matvec_mpi_multiplier_tpu.analysis import stats as jstats
from matvec_mpi_multiplier_torch.analysis import plots, results_table
from matvec_mpi_multiplier_torch.analysis import stats_visualization as viz
from matvec_mpi_multiplier_torch.analysis.stats import (
    ScalingPoint,
    best_point,
    format_table,
    load_strategy_csv,
    scaling_table,
)
from matvec_mpi_multiplier_torch.utils.constants import H100_HBM_PEAK_GBPS, H100_L2_BYTES

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "scripts"))
import results_table as jax_results_table  # noqa: E402
import stats_visualization as jax_viz  # noqa: E402

CSVS = [p for d in ("", "cpu_mesh") for p in sorted((ROOT / "data" / "out" / d).glob("*.csv"))
        if p.stem != "results_extended"]
CSV_IDS = [str(p.relative_to(ROOT / "data" / "out")) for p in CSVS]


def _as_dicts(points):
    return [dataclasses.asdict(p) for p in points]


def _jax_table(points, **kw):
    return jstats.format_table(points, **kw).replace("(VMEM)", "(L2)")


@pytest.mark.parametrize("path", CSVS, ids=CSV_IDS)
def test_scaling_points_are_the_jax_packages(path):
    port = load_strategy_csv(path)
    assert port, f"{path} holds no rows"
    assert _as_dicts(port) == _as_dicts(jstats.load_strategy_csv(path))
    for m, n in {(q.n_rows, q.n_cols) for q in port}:
        assert dataclasses.asdict(best_point(port, m, n)) == dataclasses.asdict(
            jstats.best_point(jstats.load_strategy_csv(path), m, n))


@pytest.mark.parametrize("kw", [
    dict(itemsize=8),
    dict(itemsize=4, hbm_peak_gbps=819.0),
    dict(itemsize=4, hbm_peak_gbps=H100_HBM_PEAK_GBPS, mxu_peak_tflops=989.0),
    dict(itemsize=2, mxu_peak_tflops=197.0),
], ids=["plain", "roofline", "roofline-mfu", "mfu"])
@pytest.mark.parametrize("path", CSVS, ids=CSV_IDS)
def test_format_table_is_bitwise_the_jax_packages(path, kw):
    port = load_strategy_csv(path)
    jax_points = jstats.load_strategy_csv(path)
    # At the JAX boundary, and at the port's (the L2) passed to both.
    assert format_table(port, l2_bytes=jstats.VMEM_BYTES, **kw) == _jax_table(jax_points, **kw)
    assert format_table(port, **kw) == _jax_table(jax_points, vmem_bytes=H100_L2_BYTES, **kw)


def test_cpu_mesh_speedup_rows_have_baselines():
    points = load_strategy_csv(ROOT / "data" / "out" / "cpu_mesh" / "rowwise.csv")
    multi = [q for q in points if q.n_processes > 1]
    assert multi and all(q.speedup is not None for q in multi)
    for q in multi:
        assert q.efficiency == pytest.approx(q.speedup / q.n_processes)


def test_scaling_table_no_baseline():
    (pt,) = scaling_table([{"n_rows": 8, "n_cols": 8, "n_processes": 2, "time": 0.5}])
    assert pt.speedup is None and pt.efficiency is None


def test_scaling_table_averages_duplicates():
    rows = [
        {"n_rows": 8, "n_cols": 8, "n_processes": 1, "time": 1.0},
        {"n_rows": 8, "n_cols": 8, "n_processes": 1, "time": 3.0},
        {"n_rows": 8, "n_cols": 8, "n_processes": 4, "time": 1.0},
    ]
    pts = scaling_table(rows)
    p4 = next(p for p in pts if p.n_processes == 4)
    assert p4.speedup == pytest.approx(2.0) and p4.efficiency == pytest.approx(0.5)
    assert _as_dicts(pts) == _as_dicts(jstats.scaling_table(rows))


def test_scaling_table_gemm_n_rhs():
    rows = [{"n_rows": 8, "n_cols": 4, "n_processes": 1, "time": 1e-9}]
    (plain,) = scaling_table(rows)
    assert plain.n_rhs == 1 and plain.gflops() == pytest.approx(2 * 8 * 4)
    (gemm,) = scaling_table(rows, n_rhs_lookup={(8, 4, 1): 16})
    assert gemm.n_rhs == 16 and gemm.gflops() == pytest.approx(2 * 8 * 4 * 16)
    assert gemm.gbps(itemsize=1) == pytest.approx(8 * 4 + (8 + 4) * 16)
    (jgemm,) = jstats.scaling_table(rows, n_rhs_lookup={(8, 4, 1): 16})
    assert (gemm.gflops(), gemm.gbps(2)) == (jgemm.gflops(), jgemm.gbps(2))


def test_per_point_itemsize_overrides_table_default():
    pt = ScalingPoint(n_rows=1000, n_cols=1000, n_processes=1, time_s=0.001,
                      speedup=1.0, efficiency=1.0, strategy="gemm_blockwise",
                      n_rhs=1, itemsize=2)
    assert pt.gbps(itemsize=4) == pytest.approx(pt.gbps(itemsize=2))
    assert ScalingPoint(n_rows=1000, n_cols=1000, n_processes=1, time_s=0.001,
                        speedup=1.0, efficiency=1.0).gbps(itemsize=4) == \
        pytest.approx(2 * pt.gbps(itemsize=4))


def test_format_table_roofline_column():
    pt = ScalingPoint(n_rows=1000, n_cols=1000, n_processes=2, time_s=0.001,
                      speedup=1.5, efficiency=0.75, strategy="rowwise")
    out = format_table([pt], itemsize=4, hbm_peak_gbps=H100_HBM_PEAK_GBPS)
    assert "% HBM peak" in out
    # gbps ~ 4.008; pct = 100*4.008/(3350*2) ~ 0.06; a 4 MB matrix fits the L2.
    assert "| 0.1 (L2) |" in out
    assert "% HBM peak" not in format_table([pt], itemsize=4)
    big = ScalingPoint(n_rows=16384, n_cols=16384, n_processes=1, time_s=0.0015,
                       speedup=None, efficiency=None, strategy="blockwise")
    assert "(L2)" not in format_table([big], itemsize=4, hbm_peak_gbps=3350.0)
    # The per-point itemsize decides the residency too: 3000² bf16 (18 MB)
    # fits the L2 where the fp32 default (36 MB) would as well, 4000² bf16
    # (32 MB) where fp32 (64 MB) would not.
    bf16 = ScalingPoint(n_rows=4000, n_cols=4000, n_processes=1, time_s=0.001,
                        speedup=None, efficiency=None, strategy="b", itemsize=2)
    assert "(L2)" in format_table([bf16], itemsize=4, hbm_peak_gbps=3350.0)
    assert "(L2)" not in format_table([dataclasses.replace(bf16, itemsize=None)],
                                      itemsize=4, hbm_peak_gbps=3350.0)


def test_the_asymmetric_120_row_fp32_cell_is_l2_resident():
    """120 x 60000 fp32 (28.8 MB) is the cell the chip runs call
    l2_resident; 1200 rows (288 MB) are not."""
    small = ScalingPoint(n_rows=120, n_cols=60000, n_processes=1, time_s=2e-5,
                         speedup=1.0, efficiency=1.0, strategy="rowwise")
    big = dataclasses.replace(small, n_rows=1200, time_s=1e-4)
    out = format_table([small, big], itemsize=4, hbm_peak_gbps=3350.0).splitlines()
    assert out[2].endswith("(L2) |") and not out[3].endswith("(L2) |")


def test_n_cards_holds_logical_shards_against_one_card():
    """p logical shards of one card: the peak is one card's, and the whole
    matrix sits on that card (4096² fp32, 67 MB, past the L2; a quarter of
    it, as the JAX rule counts, would fit)."""
    pt = ScalingPoint(n_rows=4096, n_cols=4096, n_processes=4, time_s=1e-4,
                      speedup=0.9, efficiency=0.225, strategy="blockwise")
    per_p = format_table([pt], itemsize=4, hbm_peak_gbps=3350.0, mxu_peak_tflops=989.0)
    one = format_table([pt], itemsize=4, hbm_peak_gbps=3350.0, mxu_peak_tflops=989.0,
                       n_cards=1)
    pct = 100.0 * pt.gbps(4) / 3350.0
    mfu = 100.0 * pt.gflops() / (989.0 * 1e3)
    assert one.splitlines()[2].endswith(f"| {pct:.1f} | {mfu:.1f} |")
    assert per_p.splitlines()[2].endswith(f"| {pct / 4:.1f} (L2) | {mfu / 4:.1f} |")
    assert format_table([pt], itemsize=4, hbm_peak_gbps=3350.0, n_cards=4) == \
        format_table([pt], itemsize=4, hbm_peak_gbps=3350.0)


# ------------------------------------------------------------------ figures

needs_mpl = pytest.mark.skipif(importlib.util.find_spec("matplotlib") is None,
                               reason="matplotlib is not installed")


def _pts(scale, strategy="rowwise", size=8):
    return [ScalingPoint(n_rows=size, n_cols=size, n_processes=p, time_s=scale / p,
                         speedup=float(p), efficiency=1.0, strategy=strategy)
            for p in (1, 2, 4)]


@needs_mpl
def test_plots_render(tmp_path):
    points = load_strategy_csv(ROOT / "data" / "out" / "cpu_mesh" / "rowwise.csv")
    f1 = plots.plot_strategy(points, tmp_path / "rowwise.png")
    assert f1.exists() and f1.stat().st_size > 1000
    m, n = max({(q.n_rows, q.n_cols) for q in points}, key=lambda s: s[0] * s[1])
    by = {"rowwise": points,
          "colwise": load_strategy_csv(ROOT / "data" / "out" / "cpu_mesh" / "colwise.csv")}
    f2 = plots.plot_comparison(by, m, n, tmp_path / "cmp.png")
    assert f2.exists() and f2.stat().st_size > 1000
    f3 = plots.plot_overlay({"ref": {"rowwise": _pts(1.0)}, "ours": {"rowwise": _pts(0.1)}},
                            8, 8, tmp_path / "overlay.png")
    assert f3.exists() and f3.stat().st_size > 0
    f4 = plots.plot_crossover_roofline(
        [(1, 1.0, 2000.0), (8, 8.0, 15000.0), (64, 60.0, 150000.0)], tmp_path / "x.png",
        hbm_peak_gbps=3350.0, mxu_peak_gflops=989_000.0)
    assert f4.exists()
    assert plots.plot_crossover_roofline([], tmp_path / "none.png", hbm_peak_gbps=1.0,
                                         mxu_peak_gflops=1.0) is None


@needs_mpl
@pytest.mark.parametrize("n_cards", [None, 1])
def test_plot_roofline(tmp_path, n_cards):
    by = {"rowwise": load_strategy_csv(ROOT / "data" / "out" / "rowwise.csv")}
    f = plots.plot_roofline(by, tmp_path / "roof.png", itemsize=4,
                            hbm_peak_gbps=3350.0, n_cards=n_cards)
    assert f is not None and f.exists() and f.stat().st_size > 1000
    gemm_only = {"gemm_rowwise": [dataclasses.replace(p, n_rhs=4) for p in by["rowwise"]]}
    assert plots.plot_roofline(gemm_only, tmp_path / "none.png", itemsize=4,
                               hbm_peak_gbps=3350.0) is None
    assert not (tmp_path / "none.png").exists()
    # The JAX package draws the same datasets (None on the same ones).
    assert jplots.plot_roofline(gemm_only, tmp_path / "none.png", itemsize=4,
                                hbm_peak_gbps=819.0) is None


# --------------------------------------------------------------------- CLIs


def _table_lines(text: str) -> list[str]:
    return [ln for ln in text.splitlines() if ln.startswith("|") or ln.startswith("## ")]


def _write_run(out: Path) -> None:
    out.mkdir()
    for stem in ("rowwise", "colwise", "gemm_rowwise", "gemm_colwise"):
        (out / f"{stem}.csv").write_text(
            "n_rows, n_cols, n_processes, time\n8, 8, 1, 0.5\n8, 8, 2, 0.25\n"
            "512, 512, 1, 0.5\n512, 512, 2, 0.25\n1024, 1024, 2, 0.9\n")
    (out / "gemm_rowwise_reference.csv").write_text(
        "n_rows, n_cols, n_processes, time\n8, 8, 1, 0.5\n")
    (out / "results_extended.csv").write_text(
        "n_rows, n_cols, n_devices, time, strategy, dtype, mode, measure, "
        "gflops, gbps, n_rhs\n"
        "8, 8, 1, 0.5, gemm_rowwise, float64, amortized, sync, 0.1, 0.1, 8\n"
        "512, 512, 1, 0.5, rowwise, bfloat16, amortized, loop, 0.1, 0.1, 1\n")


@needs_mpl
@pytest.mark.parametrize("extra", [[], ["--hbm-peak", "3350"],
                                   ["--hbm-peak", "3350", "--mxu-peak", "989"]])
def test_stats_visualization_tables_are_the_jax_scripts(tmp_path, capsys, extra):
    out = tmp_path / "out"
    _write_run(out)
    argv = ["--data-out", str(out), "--itemsize", "4", *extra]
    assert jax_viz.main(argv + ["--fig-dir", str(tmp_path / "jfigs")]) == 0
    jax_text = capsys.readouterr().out.replace("(VMEM)", "(L2)")
    assert viz.main(argv + ["--fig-dir", str(tmp_path / "figs")]) == 0
    port_text = capsys.readouterr().out
    assert _table_lines(port_text) == _table_lines(jax_text)
    figs = tmp_path / "figs"
    assert (figs / "comparison_1024x1024.png").exists()
    assert (figs / "gemm_comparison_1024x1024.png").exists()
    if extra:
        assert (figs / "roofline.png").exists() and (figs / "roofline_p2.png").exists()
    run = viz.load_run(out)
    assert run["gemm_rowwise"][0].n_rhs == 8
    assert run["rowwise"][0].n_rhs == 1
    assert run["gemm_rowwise_reference"][0].n_rhs == 8
    jrun = jax_viz.load_run(out)
    assert {k: _as_dicts(v) for k, v in run.items()} == \
        {k: _as_dicts(v) for k, v in jrun.items()}


def test_stats_visualization_cards_and_no_matplotlib(tmp_path, capsys, monkeypatch):
    """--cards: the logical-shards line above each table whose p exceeds
    the cards; without matplotlib the tables still print and a line says
    the figures are skipped."""
    out = tmp_path / "out"
    _write_run(out)
    real = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec",
                        lambda name, *a: None if name == "matplotlib" else real(name, *a))
    assert viz.main(["--data-out", str(out), "--fig-dir", str(tmp_path / "figs"),
                     "--itemsize", "4", "--hbm-peak", "3350", "--cards", "1"]) == 0
    text = capsys.readouterr().out
    assert "figures: matplotlib is not installed; tables only" in text
    assert text.count("p counts logical shards of 1 card(s)") == 4  # the p = 2 tables
    assert not (tmp_path / "figs").exists()
    assert viz.main(["--data-out", str(tmp_path / "empty")]) == 1


@pytest.mark.parametrize("argv", [[], ["--shape", "asym"], ["--shape", "all"],
                                  ["--measure", "chain"], ["--devices", "2"]])
def test_results_table_is_the_jax_scripts(tmp_path, capsys, argv):
    out = tmp_path / "out"
    out.mkdir()
    (out / "results_extended.csv").write_text(
        "n_rows, n_cols, n_devices, time, strategy, dtype, mode, measure, "
        "gflops, gbps, n_rhs\n"
        "600, 600, 1, 0.001, rowwise, float32, amortized, loop, 1, 2.0, 1\n"
        "600, 600, 1, 0.0005, rowwise, float32, amortized, loop, 1, 4.0, 1\n"
        "600, 600, 1, 0.002, colwise, float32, amortized, loop, 1, 1.0, 1\n"
        "600, 600, 1, 0.009, rowwise, float32, amortized, chain, 1, 0.1, 1\n"
        "120, 60000, 1, 0.003, rowwise, float32, amortized, loop, 1, 9.0, 1\n")
    argv = ["--data-root", str(tmp_path), *argv]
    rc_jax = jax_results_table.main(argv)
    jax_out = capsys.readouterr()
    rc = results_table.main(argv)
    port_out = capsys.readouterr()
    assert (rc, port_out.out, port_out.err) == (rc_jax, jax_out.out, jax_out.err)


def test_results_table_last_row_wins(tmp_path, capsys):
    out = tmp_path / "out"
    out.mkdir()
    (out / "results_extended.csv").write_text(
        "n_rows, n_cols, n_devices, time, strategy, dtype, mode, measure, "
        "gflops, gbps, n_rhs\n"
        "600, 600, 1, 0.001, rowwise, float32, amortized, loop, 1, 2.0, 1\n"
        "600, 600, 1, 0.0005, rowwise, float32, amortized, loop, 1, 4.0, 1\n")
    assert results_table.main(["--data-root", str(tmp_path)]) == 0
    assert "| 600² | 0.500 ms (4 GB/s) |" in capsys.readouterr().out
    assert results_table.main(["--data-root", str(tmp_path / "none")]) == 1
