"""The port's timing protocol, metrics and sweep CLI against the JAX package's.

Timings here are CPU numbers of tiny shapes: the tests check the protocol
(how many reps, which reduction, which errors) and the CSV files, never a
speed.
"""

import numpy as np
import pytest
import torch

from matvec_mpi_multiplier_tpu.bench import metrics as jax_metrics
from matvec_mpi_multiplier_tpu.bench.timing import TimingResult as JaxTimingResult
from matvec_mpi_multiplier_tpu.utils import constants as jax_constants
from matvec_mpi_multiplier_torch import get_strategy
from matvec_mpi_multiplier_torch.bench import metrics, sweep
from matvec_mpi_multiplier_torch.bench.timing import (
    TimingResult,
    benchmark_strategy,
    resolve_measure,
    time_fn_chained,
)
from matvec_mpi_multiplier_torch.parallel.mesh import make_mesh
from matvec_mpi_multiplier_torch.utils import constants
from matvec_mpi_multiplier_torch.utils.errors import ConfigError

CPU = torch.device("cpu")


def cpu_mesh(p):
    return make_mesh(p, devices=[CPU] * p)


@pytest.mark.parametrize("mode,measure", [
    ("amortized", "sync"), ("amortized", "chain"), ("reference", "sync"),
])
def test_benchmark_strategy_cpu(mode, measure):
    rng = np.random.default_rng(0)
    a, x = rng.uniform(0, 10, (256, 256)), rng.uniform(0, 10, 256)
    res = benchmark_strategy(
        get_strategy("blockwise"), cpu_mesh(4), a, x, dtype="float32",
        n_reps=20, mode=mode, measure=measure, chain_samples=3,
    )
    assert (res.n_rows, res.n_cols, res.n_devices) == (256, 256, 4)
    assert (res.strategy, res.dtype, res.mode, res.measure) == (
        "blockwise", "float32", mode, measure)
    if measure == "sync":
        assert len(res.times_s) == 20
        assert res.mean_time_s == pytest.approx(np.mean(res.times_s))
        assert min(res.times_s) > 0
    else:
        assert len(res.times_s) == 3
        assert res.mean_time_s == pytest.approx(np.median(res.times_s))
    assert res.mean_time_s > 0


def test_throughput_formulas_match_jax():
    fields = dict(n_rows=1000, n_cols=3000, n_devices=4, strategy="rowwise",
                  mode="amortized", measure="chain", mean_time_s=1.5e-3,
                  times_s=(1.5e-3,))
    for dtype in ("float64", "float32", "bfloat16", "float16"):
        mine = TimingResult(dtype=dtype, **fields)
        ref = JaxTimingResult(dtype=dtype, **fields)
        assert mine.gflops == pytest.approx(ref.gflops, rel=1e-15)
        assert mine.gbps == pytest.approx(ref.gbps, rel=1e-15)


@pytest.mark.parametrize("mode,measure,resolved", [
    ("amortized", "auto", "chain"), ("reference", "auto", "sync"),
    ("amortized", "chain", "chain"), ("amortized", "sync", "sync"),
    ("reference", "sync", "sync"),
])
def test_resolve_measure(mode, measure, resolved):
    assert resolve_measure(mode, measure) == resolved


@pytest.mark.parametrize("mode,measure,match", [
    ("amortized", "loop", "CUDA graph"), ("reference", "loop", "CUDA graph"),
    ("reference", "chain", "cannot time mode='reference'"),
    ("bogus", "auto", "mode must be"), ("amortized", "bogus", "measure must be"),
])
def test_resolve_measure_errors(mode, measure, match):
    with pytest.raises(ConfigError, match=match):
        resolve_measure(mode, measure)


def test_time_fn_chained_counts_calls():
    calls = []
    times = time_fn_chained(lambda: calls.append(torch.ones(64).sum()), (),
                            cpu_mesh(1), n_reps=10, samples=2, warmup=1)
    assert len(times) == 2
    # 2 warm-up calls, then per sample chains of n1=1 and n2=11.
    assert len(calls) == 2 + 2 * (1 + 11)


def test_csv_headers_are_the_jax_packages():
    assert constants.CSV_HEADER == jax_constants.CSV_HEADER
    assert constants.CSV_HEADER_EXTENDED == jax_constants.CSV_HEADER_EXTENDED


def test_metrics_write_the_same_bytes_as_jax(tmp_path):
    fields = dict(n_rows=64, n_cols=64, n_devices=4, strategy="colwise",
                  dtype="float32", mode="amortized", measure="chain",
                  mean_time_s=1.234567e-4, times_s=(1.234567e-4,))
    for mode in ("amortized", "reference"):
        fields["mode"] = mode
        metrics.append_result(TimingResult(**fields), tmp_path / "port")
        jax_metrics.append_result(JaxTimingResult(**fields), tmp_path / "jax")
    for name in ("colwise.csv", "colwise_reference.csv", "results_extended.csv"):
        assert (tmp_path / "port" / "out" / name).read_bytes() == (
            tmp_path / "jax" / "out" / name).read_bytes()


def test_stale_header_rotates_to_bak(tmp_path):
    path = metrics.csv_path("rowwise", tmp_path)
    path.parent.mkdir(parents=True)
    path.write_text("old, header\n1, 2\n")
    metrics.append_result(TimingResult(
        n_rows=8, n_cols=8, n_devices=1, strategy="rowwise", dtype="float32",
        mode="amortized", measure="sync", mean_time_s=1e-3, times_s=(1e-3,),
    ), tmp_path)
    assert path.with_suffix(".csv.bak").read_text() == "old, header\n1, 2\n"
    assert path.read_text().splitlines()[0] == jax_constants.CSV_HEADER


def test_sweep_cli_writes_reference_csvs(tmp_path, capsys):
    rc = sweep.main([
        "--platform", "cpu", "--host-devices", "4", "--sizes", "64",
        "--n-reps", "3", "--measure", "sync", "--data-root", str(tmp_path),
    ])
    assert rc == 0
    assert "9 configs timed, 0 skipped" in capsys.readouterr().out
    out = tmp_path / "out"
    for name in ("rowwise", "colwise", "blockwise"):
        lines = (out / f"{name}.csv").read_text().splitlines()
        assert lines[0] == jax_constants.CSV_HEADER
        assert [ln.split(", ")[:3] for ln in lines[1:]] == [
            ["64", "64", str(p)] for p in (1, 2, 4)]
        for ln in lines[1:]:
            assert len(ln.split(", ")[3].split(".")[1]) == 6  # "%f"
    ext = (out / "results_extended.csv").read_text().splitlines()
    assert ext[0] == jax_constants.CSV_HEADER_EXTENDED
    assert len(ext) == 10
    assert all(ln.split(", ")[5:8] == ["float32", "amortized", "sync"]
               for ln in ext[1:])


def test_sweep_cli_cuda_without_card_fails(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ConfigError, match="no CUDA device"):
        sweep.main(["--sizes", "64", "--no-csv"])
