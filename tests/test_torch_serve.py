"""The port's serve bench (bench/serve.py) against the JAX package's.

Mirrors the sequential-protocol tests of tests/test_serve_bench.py on 8
logical CPU shards. Timings here are CPU numbers of tiny shapes: the tests
check the protocol (phases, counts, percentiles, CSV), never a speed.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from matvec_mpi_multiplier_tpu.bench import serve as jax_serve
from matvec_mpi_multiplier_tpu.bench.metrics import read_csv
from matvec_mpi_multiplier_torch.bench import serve
from matvec_mpi_multiplier_torch.bench.serve import (
    SERVE_CSV_HEADER,
    ServeResult,
    append_serve_result,
    measure_promotion,
    resident_matrix,
    run_serve,
    serve_csv_path,
)
from matvec_mpi_multiplier_torch.engine import MatvecEngine
from matvec_mpi_multiplier_torch.parallel.mesh import make_mesh
from matvec_mpi_multiplier_torch.utils.errors import ConfigError

CPU = torch.device("cpu")
CPU_ARGS = ["--platform", "cpu", "--host-devices", "8", "--devices", "8"]


def port_mesh(p=8):
    return make_mesh(p, devices=[CPU] * p)


@pytest.fixture(scope="module")
def result():
    return run_serve("rowwise", port_mesh(), 64, 64, n_requests=30, max_bucket=8,
                     promote=4, seed=0, promo_reps=5)


def test_serve_zero_recompiles_after_warmup(result):
    assert result.compiles_steady == 0
    # Widths 1..8 with b* = 4: the matvec program and buckets 4 (width 4)
    # and 8 (widths 6 and 8).
    assert result.compiles_warmup == 3
    assert result.hits_steady >= result.n_requests


def test_serve_reports_throughput_and_latency(result):
    assert result.n_requests == 30
    assert result.wall_s > 0 and result.rps > 0
    assert result.cols_per_s >= result.rps
    assert 0 < result.p50_dispatch_ms <= result.p99_dispatch_ms
    assert result.total_cols >= result.n_requests
    assert (result.strategy, result.dtype, result.kernel, result.combine) == (
        "rowwise", "float32", "cuda", "default")
    assert result.resident_bytes == 64 * 64 * 4


def test_serve_promotion_fields(result):
    assert result.promo_b == result.b_star == 4
    assert result.promo_gemm_s > 0 and result.promo_seq_s > 0
    assert np.isfinite(result.promo_speedup)


def test_serve_result_has_the_jax_fields():
    names = [f.name for f in dataclasses.fields(ServeResult)]
    assert names == [f.name for f in dataclasses.fields(jax_serve.ServeResult)]
    assert serve.DEFAULT_WIDTH_MIX == jax_serve.DEFAULT_WIDTH_MIX


def test_serve_csv_header_and_rows_are_the_jax_packages(result, tmp_path):
    assert SERVE_CSV_HEADER == jax_serve.SERVE_CSV_HEADER
    path = append_serve_result(result, tmp_path / "port")
    assert path == serve_csv_path("rowwise", tmp_path / "port")
    jax_path = jax_serve.append_serve_result(
        jax_serve.ServeResult(**dataclasses.asdict(result)), tmp_path / "jax")
    assert path.read_bytes() == jax_path.read_bytes()
    rows = read_csv(path)
    assert len(rows) == 1
    assert (rows[0]["compiles_steady"], rows[0]["n_requests"], rows[0]["b_star"]) == (0, 30, 4)
    assert path.read_text().splitlines()[0] == SERVE_CSV_HEADER


def test_measure_promotion_prefers_gemm(rng):
    a = rng.uniform(0, 10, (256, 256)).astype(np.float32)
    eng = MatvecEngine(a, port_mesh(), strategy="rowwise", promote=8, max_bucket=8)
    b, t_gemm, t_seq = measure_promotion(eng, {}, n_reps=5)
    assert b == 8 and t_gemm > 0 and t_seq > 0
    assert t_gemm < 2.0 * t_seq  # noise guard only


def test_measure_promotion_disabled_reports_nan(rng):
    a = rng.uniform(0, 10, (64, 64)).astype(np.float32)
    eng = MatvecEngine(a, port_mesh(), strategy="rowwise", promote=None)
    b, t_gemm, t_seq = measure_promotion(eng, {}, n_reps=2)
    assert b == 0 and np.isnan(t_gemm) and np.isnan(t_seq)
    res = run_serve("rowwise", port_mesh(), 64, 64, n_requests=5, max_bucket=4,
                    promote=None, promo_reps=2)
    assert res.b_star is None and res.promo_b == 0 and np.isnan(res.promo_speedup)


def test_serve_metrics_snapshot_matches_engine_counts(tmp_path):
    path = tmp_path / "metrics.json"
    res = run_serve("colwise", port_mesh(), 64, 64, n_requests=25, max_bucket=8,
                    promote=4, promo_reps=2, metrics_out=str(path))
    snap = json.loads(path.read_text())
    counters = snap["counters"]
    hist = snap["histograms"]["serve_dispatch_latency_ms"]
    assert hist["count"] == 25
    assert (res.p50_dispatch_ms, res.p99_dispatch_ms) == (hist["p50"], hist["p99"])
    assert counters["engine_compiles_total"] == res.compiles_warmup
    assert counters["engine_hits_total"] == counters["engine_dispatches_total"]
    assert counters["engine_drains_total"] == counters["engine_deadline_failures_total"] == 0


def test_resident_matrix_is_seeded_uniform():
    a = resident_matrix(70, 33, torch.float32, CPU, seed=3)
    assert tuple(a.shape) == (70, 33) and a.dtype == torch.float32
    assert 0 <= a.min() and a.max() < 10
    assert torch.equal(a, resident_matrix(70, 33, torch.float32, CPU, seed=3))
    assert not torch.equal(a, resident_matrix(70, 33, torch.float32, CPU, seed=4))
    assert resident_matrix(8, 8, torch.bfloat16, CPU, seed=0).dtype == torch.bfloat16


def test_serve_cli_no_csv(capsys):
    rc = serve.main(["--strategy", "rowwise", "--sizes", "64", "--n-requests", "10",
                     "--max-bucket", "4", "--no-csv", *CPU_ARGS])
    assert rc == 0
    out = capsys.readouterr().out
    assert "serve rowwise 64x64 p=8 b*=4" in out
    assert "compiles=" in out and "+0 " in out
    assert "1 serve configs measured" in out


def test_serve_cli_skips_an_unported_combine(capsys):
    rc = serve.main(["--strategy", "rowwise", "--sizes", "64", "--combine", "psum",
                     "--n-requests", "5", "--max-bucket", "4", "--no-csv", *CPU_ARGS])
    assert rc == 0
    out = capsys.readouterr().out
    assert "skip rowwise 64x64 p=8" in out and "0 serve configs measured" in out


def test_sweep_op_serve_delegates(tmp_path):
    from matvec_mpi_multiplier_torch.bench.sweep import main

    rc = main(["--op", "serve", "--strategy", "colwise", "--sizes", "64",
               "--n-requests", "8", "--max-bucket", "4", "--promote", "never",
               "--data-root", str(tmp_path), *CPU_ARGS])
    assert rc == 0
    rows = read_csv(serve_csv_path("colwise", tmp_path))
    assert len(rows) == 1 and rows[0]["compiles_steady"] == 0
    assert rows[0]["b_star"] == -1 and rows[0]["kernel"] == "cuda"


# Load mode (--arrival, --concurrency, --coalesce), its chaos flags and the
# multi-tenant mode (--tenants, --poison-tenant) are ported
# (tests/test_torch_serve_load.py, tests/test_torch_serve_multitenant.py);
# with a global-scheduler or drift flag it still raises, in every mode.
@pytest.mark.parametrize("argv", [
    ["--tenants", "2", "--global-sched", "on"],
    ["--tenants", "2", "--demand-weight", "2.0"],
    ["--concurrency", "4", "--decision-jsonl", "decisions.jsonl"],
    ["--coalesce", "on", "--reshard", "auto"],
    ["--fault-spec", "dispatch:device_error:p=0.1", "--tenants", "2", "--reshard", "auto"],
    ["--global-sched", "both"], ["--tenants", "2", "--decision-jsonl", "d.jsonl"],
    ["--reshard", "auto"],
])
def test_unported_serve_modes_raise(argv):
    with pytest.raises(ConfigError, match="ROADMAP.md"):
        serve.main(["--sizes", "64", "--no-csv", *argv, *CPU_ARGS])


def test_serve_cli_cuda_without_card_fails(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ConfigError, match="no CUDA device"):
        serve.main(["--sizes", "64", "--no-csv"])
