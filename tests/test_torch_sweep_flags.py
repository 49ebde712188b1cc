"""The port's sweep flags (``bench/sweep.py``: ``--keep-going``,
``--skip-measured``, ``--label-suffix``, ``--profile-dir``, ``--annotate``,
``--metrics-out``, ``--trace-jsonl``) against the JAX package's
(``tests/test_bench.py:342-555``), on logical CPU shards.

The cases are the JAX package's; the CSVs the port writes are read by both
packages' ``read_csv`` alike, and the usage errors carry the JAX sweep's
messages.
"""

import json

import pytest
import torch

from matvec_mpi_multiplier_tpu.bench.metrics import read_csv as jax_read_csv
from matvec_mpi_multiplier_tpu.bench.sweep import main as jax_sweep_main
from matvec_mpi_multiplier_torch.bench import sweep as sweep_mod
from matvec_mpi_multiplier_torch.bench.metrics import (
    csv_path,
    extended_csv_path,
    read_csv,
)
from matvec_mpi_multiplier_torch.bench.profiling import annotations_enabled, set_annotations
from matvec_mpi_multiplier_torch.bench.sweep import csv_label
from matvec_mpi_multiplier_torch.bench.sweep import main as sweep_main
from matvec_mpi_multiplier_torch.obs.registry import get_registry, reset_registry
from matvec_mpi_multiplier_torch.utils.errors import TimingError

CPU = ["--platform", "cpu", "--host-devices", "2"]
BASE = ["--strategy", "rowwise", "--devices", "2", "--n-reps", "2", *CPU]


def _both_read(path):
    """The port's rows, read by the port and by the JAX package alike."""
    rows = read_csv(path)
    assert rows == jax_read_csv(path)
    return rows


def test_read_csv_takes_both_header_variants(tmp_path):
    spaced = tmp_path / "spaced.csv"
    spaced.write_text("n_rows, n_cols, n_processes, time\n8, 8, 1, 0.500000\n")
    bare = tmp_path / "bare.csv"
    bare.write_text("n_rows,n_cols,n_processes,time\n120,60000,6,0.25\n\n")
    assert _both_read(spaced) == [{"n_rows": 8, "n_cols": 8, "n_processes": 1,
                                   "time": 0.5}]
    assert _both_read(bare) == [{"n_rows": 120, "n_cols": 60000,
                                 "n_processes": 6, "time": 0.25}]
    empty = tmp_path / "empty.csv"
    empty.write_text("\n")
    assert _both_read(empty) == []


def _flaky(monkeypatch, error):
    calls = []
    real = sweep_mod.benchmark_strategy

    def flaky(strategy, mesh, a, x, **kw):
        calls.append(1)
        if len(calls) == 1:
            raise error
        return real(strategy, mesh, a, x, **kw)

    monkeypatch.setattr(sweep_mod, "benchmark_strategy", flaky)
    return calls


def test_keep_going_survives_backend_errors(tmp_path, capsys, monkeypatch):
    """A runtime failure in one config does not abort the sweep under
    --keep-going (exit 5: completed, some config failed); without the flag
    it propagates."""
    monkeypatch.setenv("MATVEC_DATA_DIR", str(tmp_path))
    calls = _flaky(monkeypatch, RuntimeError("CUDA error: launch failure"))
    args = BASE + ["--sizes", "16", "32", "--dtype", "float64"]
    assert sweep_main(args + ["--keep-going"]) == 5
    assert "FAILED" in capsys.readouterr().err
    rows = _both_read(csv_path("rowwise", tmp_path))
    assert len(rows) == 1 and rows[0]["n_rows"] == 32  # the later config landed
    calls.clear()
    with pytest.raises(RuntimeError, match="launch failure"):
        sweep_main(args)


def test_keep_going_skips_unmeasurable(tmp_path, capsys, monkeypatch):
    """TimingError is skippable under --keep-going (exit 3, a soft
    outcome); without the flag it propagates."""
    monkeypatch.setenv("MATVEC_DATA_DIR", str(tmp_path))
    calls = _flaky(monkeypatch, TimingError("slope not measurable"))
    args = BASE + ["--sizes", "16", "32", "--dtype", "float64"]
    assert sweep_main(args + ["--keep-going"]) == 3
    assert "UNMEASURABLE" in capsys.readouterr().err
    rows = _both_read(csv_path("rowwise", tmp_path))
    assert len(rows) == 1 and rows[0]["n_rows"] == 32
    calls.clear()
    with pytest.raises(TimingError):
        sweep_main(args)


def test_keep_going_does_not_swallow_config_errors(tmp_path, monkeypatch):
    """A MatvecError other than TimingError is a config bug: it fails the
    sweep, flag or not."""
    from matvec_mpi_multiplier_torch.utils.errors import ConfigError

    monkeypatch.setenv("MATVEC_DATA_DIR", str(tmp_path))
    _flaky(monkeypatch, ConfigError("bad config"))
    with pytest.raises(ConfigError):
        sweep_main(BASE + ["--sizes", "16", "--keep-going"])


def test_skip_measured_resumes(tmp_path, monkeypatch, capsys):
    """Configs already in the extended CSV are skipped, new ones run, and no
    row is duplicated."""
    monkeypatch.setenv("MATVEC_DATA_DIR", str(tmp_path))
    base = BASE + ["--dtype", "float64", "--measure", "sync"]
    assert sweep_main(base + ["--sizes", "16"]) == 0
    rows1 = _both_read(extended_csv_path(tmp_path))
    assert len(rows1) == 1
    assert sweep_main(base + ["--sizes", "16", "--skip-measured"]) == 0
    out = capsys.readouterr().out
    assert "already measured" in out and "0 configs timed" in out
    assert _both_read(extended_csv_path(tmp_path)) == rows1
    assert sweep_main(base + ["--sizes", "16", "32", "--skip-measured"]) == 0
    assert "1 configs timed" in capsys.readouterr().out
    rows3 = _both_read(extended_csv_path(tmp_path))
    assert sorted(r["n_rows"] for r in rows3) == [16, 32]


def test_skip_measured_distinguishes_label_dtype_and_storage(tmp_path, monkeypatch, capsys):
    """The key holds the label as written (suffix and storage format) and
    the dtype: a measured plain row suppresses none of the others."""
    monkeypatch.setenv("MATVEC_DATA_DIR", str(tmp_path))
    base = BASE + ["--sizes", "16", "--measure", "sync"]
    assert sweep_main(base + ["--dtype", "float64"]) == 0
    assert sweep_main(base + ["--dtype", "float32", "--skip-measured"]) == 0
    assert "1 configs timed" in capsys.readouterr().out
    assert sweep_main(base + ["--dtype", "float64", "--label-suffix", "alt",
                              "--skip-measured"]) == 0
    assert "1 configs timed" in capsys.readouterr().out
    assert sweep_main(base + ["--dtype", "float32", "--dtype-storage", "int8",
                              "--skip-measured"]) == 0
    assert "1 configs timed" in capsys.readouterr().out
    rows = _both_read(extended_csv_path(tmp_path))
    assert sorted((r["strategy"], r["dtype"]) for r in rows) == [
        ("rowwise", "float32"), ("rowwise", "float64"),
        ("rowwise_alt", "float64"), ("rowwise_int8", "float32"),
    ]
    assert sweep_main(base + ["--dtype", "float32", "--dtype-storage", "int8",
                              "--skip-measured"]) == 0
    assert "0 configs timed" in capsys.readouterr().out


@pytest.mark.parametrize("argv", [
    ["--strategy", "rowwise", "--sizes", "16", "--skip-measured"],
    ["--strategy", "rowwise", "--sizes", "16", "--measure", "sync", "--no-csv",
     "--skip-measured"],
    ["--strategy", "rowwise", "--sizes", "16", "--no-csv", "--trace-jsonl", "t.jsonl"],
])
def test_usage_errors_carry_the_jax_messages(argv):
    """--skip-measured with the auto measure or --no-csv, and --trace-jsonl
    outside serve mode, are refused with the JAX sweep's message."""
    with pytest.raises(SystemExit) as jax_err:
        jax_sweep_main(argv + ["--platform", "cpu"])
    with pytest.raises(SystemExit) as port_err:
        sweep_main(argv + CPU)
    assert str(port_err.value) == str(jax_err.value)
    assert str(port_err.value).startswith("--")


def test_label_suffix(tmp_path, monkeypatch):
    """Variant rows land under a suffixed strategy name."""
    monkeypatch.setenv("MATVEC_DATA_DIR", str(tmp_path))
    assert sweep_main(BASE + ["--sizes", "16", "--dtype", "float64",
                              "--label-suffix", "variant"]) == 0
    rows = _both_read(csv_path("rowwise_variant", tmp_path))
    assert rows[0]["n_rows"] == 16
    assert not csv_path("rowwise", tmp_path).exists()


@pytest.mark.parametrize("name,op,suffix,storage,label", [
    ("rowwise", "matvec", None, None, "rowwise"),
    ("rowwise", "matvec", "alt", None, "rowwise_alt"),
    ("colwise", "gemm", None, "native", "gemm_colwise"),
    ("colwise", "gemm", "x", "int8c", "gemm_colwise_int8c_x"),
])
def test_csv_label_is_the_jax_packages(name, op, suffix, storage, label):
    from matvec_mpi_multiplier_tpu.bench.sweep import csv_label as jax_csv_label

    assert csv_label(name, op, suffix, storage) == label
    assert jax_csv_label(name, op, suffix, storage=storage) == label


def _names(trace_dir) -> set[str]:
    (path,) = sorted(trace_dir.glob("*.json"))
    return {e.get("name", "") for e in json.loads(path.read_text())["traceEvents"]}


def test_profile_dir_and_annotate(tmp_path, monkeypatch):
    """--profile-dir writes a trace of the sweep, each config a host span;
    --annotate adds the strategies' spans, scoped to the run."""
    monkeypatch.delenv("MATVEC_ANNOTATE", raising=False)
    set_annotations(None)
    args = ["--strategy", "blockwise", "--devices", "2", "--sizes", "16",
            "--n-reps", "1", "--no-csv", "--measure", "sync", *CPU]
    assert sweep_main(args + ["--profile-dir", str(tmp_path / "plain")]) == 0
    plain = _names(tmp_path / "plain")
    assert "matvec_blockwise_16x16_p2_amortized" in plain  # the config's span
    assert "blockwise/local_gemv" not in plain
    assert sweep_main(args + ["--profile-dir", str(tmp_path / "named"),
                              "--annotate"]) == 0
    assert {"blockwise/local_gemv", "blockwise/combine/psum"} <= _names(tmp_path / "named")
    assert not annotations_enabled()


def test_metrics_out_writes_the_process_registry(tmp_path):
    reset_registry()
    get_registry().counter("sweep_test_total").inc(3)
    out = tmp_path / "m" / "metrics.json"
    assert sweep_main(BASE + ["--sizes", "16", "--n-reps", "1", "--no-csv",
                              "--metrics-out", str(out)]) == 0
    snap = json.loads(out.read_text())
    assert snap == json.loads(json.dumps(get_registry().snapshot()))
    assert snap["counters"]["sweep_test_total"] == 3
    reset_registry()


def test_reset_registry_gives_a_fresh_registry():
    from matvec_mpi_multiplier_tpu.obs import registry as jax_registry

    for mod_get, mod_reset in ((get_registry, reset_registry),
                               (jax_registry.get_registry, jax_registry.reset_registry)):
        first = mod_get()
        assert mod_get() is first
        first.counter("reset_test_total").inc()
        mod_reset()
        fresh = mod_get()
        assert fresh is not first
        assert "reset_test_total" not in fresh.snapshot()["counters"]


def test_sweep_op_serve_takes_annotate_and_metrics_out(tmp_path):
    out = tmp_path / "serve_metrics.json"
    assert sweep_main(["--op", "serve", "--strategy", "rowwise", "--sizes", "16",
                       "--n-requests", "4", "--max-bucket", "4", "--promote", "never",
                       "--devices", "2", "--no-csv", "--annotate",
                       "--metrics-out", str(out), *CPU]) == 0
    assert json.loads(out.read_text())["counters"]["engine_dispatches_total"] > 0
    assert not annotations_enabled()
