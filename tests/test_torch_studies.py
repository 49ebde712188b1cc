"""The eight study CLIs (``bench/*_study.py``) against the JAX package's scripts.

* Each study's ``main`` runs on the CPU at a tiny size into ``tmp_path``;
  its output files, CSV headers and JSON keys equal the JAX script's (its
  committed ``data/<name>_demo/`` outputs, which the JAX scripts wrote at
  their defaults: the keys do not depend on the size). The A/B studies'
  gates are timing claims: a run whose gate does not hold on a loaded CPU
  writes the JAX script's pre-gate outputs and exits 1, and the gate
  functions are held to the JAX scripts' verdicts on fixed inputs instead.
* The pure helpers equal the JAX scripts' on the same seed:
  ``overlap_stats`` at p = 4, n = 64, ``replay_slo``,
  ``spd_with_condition``, ``_measured_counts`` and ``error_study`` on
  native fp32 storage (relative error within 1e-6 of the JAX value; the
  rest exact).
* No default path names a file that existed before the port, every study
  refuses to run without a card unless told ``--platform cpu``, and no port
  module imports anything under ``scripts/``.
"""

import ast
import csv
import importlib
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from matvec_mpi_multiplier_torch.bench import studies
from matvec_mpi_multiplier_torch.obs import registry as obs_registry
from matvec_mpi_multiplier_torch.tuning import reset_cache
from matvec_mpi_multiplier_torch.tuning.cache import CACHE_ENV
from matvec_mpi_multiplier_torch.utils.errors import ConfigError

REPO = Path(__file__).resolve().parent.parent
NAMES = ("overlap", "crossover", "reshard", "gsched", "slo", "quantized", "refine",
         "cost_model")
CPU4 = ["--platform", "cpu", "--host-devices", "4"]


def _study(name):
    return importlib.import_module(f"matvec_mpi_multiplier_torch.bench.{name}_study")


def _jax_script(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}_study", REPO / "scripts" / f"{name}_study.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _json(path):
    return json.loads(Path(path).read_text())


def _header(path):
    with open(path, newline="") as f:
        return next(csv.reader(f))


@pytest.fixture
def isolated(monkeypatch, tmp_path):
    """The tuning cache and the obs registry are process-global: a study
    run gets its own and the test's neighbours get theirs back."""
    monkeypatch.setenv(CACHE_ENV, str(tmp_path / "ambient_cache.json"))
    saved = obs_registry._default
    reset_cache()
    yield tmp_path
    obs_registry._default = saved
    reset_cache()


def _demo(name):
    return REPO / "data" / f"{name}_demo"


# --------------------------------------------------- the runs on the CPU


def test_overlap_study(isolated, capsys):
    report = isolated / "OVERLAP.md"
    assert _study("overlap").main(CPU4 + ["--size", "64", "--n-reps", "2",
                                          "--report", str(report)]) == 0
    text = report.read_text()
    assert "| colwise_ring |" in text and "| colwise_ring_overlap |" in text
    out = capsys.readouterr().out
    assert "'concurrent_pairs': 6" in out and "'concurrent_pairs': 0" in out


def test_crossover_study(isolated):
    rc = _study("crossover").main(CPU4 + [
        "--size", "64", "--n-rhs", "1", "8", "--measure", "sync", "--n-reps", "2",
        "--data-root", str(isolated), "--report", str(isolated / "X.md"), "--no-fig"])
    assert rc == 0
    ext = isolated / "out" / "results_extended.csv"
    assert _header(ext) == _header(REPO / "data" / "out" / "results_extended.csv")
    rows = list(csv.DictReader(open(ext), skipinitialspace=True))
    assert [r["strategy"] for r in rows] == ["gemm_blockwise_xover_r1",
                                             "gemm_blockwise_xover_r8"]
    assert "ridge intensity" in (isolated / "X.md").read_text()


def _timing_only(name, err):
    """A failed run failed only gates over measured times."""
    failed = [ln.strip() for ln in err.split("GATE FAILURES:", 1)[1].splitlines()
              if ln.startswith("  ")]
    assert failed and all(g.startswith(_study(name).TIMING_GATES) for g in failed), failed


def _ab_outputs(name, out, rc, always, summary_csv, err):
    """The pre-gate outputs always; the summary and the CSV (the JAX
    script's post-gate outputs) when the gates held, and only timing gates
    failed when they did not."""
    demo = _demo(name)
    for f in always:
        assert (out / f).exists(), f
    assert _json(out / "metrics.json").keys() == _json(demo / "metrics.json").keys()
    decisions = [json.loads(ln) for ln in (out / "decisions.jsonl").read_text().splitlines()]
    assert decisions and all({"decision", "predicted_s", "reason"} <= d.keys()
                             for d in decisions)
    assert rc in (0, 1)
    if rc == 0:
        summary, jax = _json(out / "summary.json"), _json(demo / "summary.json")
        assert summary.keys() == jax.keys()
        for k in summary:
            if isinstance(summary[k], dict):
                assert summary[k].keys() == jax[k].keys(), k
        assert _header(out / "out" / summary_csv) == _header(demo / "out" / summary_csv)
    else:
        assert not (out / "summary.json").exists()
        _timing_only(name, err)


def test_reshard_study(isolated, capsys):
    out = isolated / "reshard"
    rc = _study("reshard").main(CPU4 + ["--m", "512", "--k", "64", "--n-requests", "120",
                                        "--calib-reps", "2", "--in-process",
                                        "--out", str(out)])
    _ab_outputs("reshard", out, rc, ("tuning_cache.json", "metrics.json", "decisions.jsonl"),
                "reshard_ab.csv", capsys.readouterr().err)
    assert _json(out / "tuning_cache.json").keys() == _json(
        _demo("reshard") / "tuning_cache.json").keys()


def test_gsched_study(isolated, capsys):
    out = isolated / "gsched"
    rc = _study("gsched").main(CPU4 + ["--shape", "64", "--n-requests", "60",
                                       "--calib-reps", "2", "--out", str(out)])
    _ab_outputs("gsched", out, rc, ("tuning_cache.json", "metrics.json", "decisions.jsonl"),
                "serve_tenants_rowwise.csv", capsys.readouterr().err)


def test_slo_study(isolated):
    out = isolated / "slo"
    assert _study("slo").main(CPU4 + ["--shape", "64", "--n-requests", "80",
                                      "--out", str(out)]) == 0
    demo = _demo("slo")
    assert _json(out / "summary.json").keys() == _json(demo / "summary.json").keys()
    assert _json(out / "slo.json").keys() == _json(demo / "slo.json").keys()
    assert _json(out / "metrics.json").keys() == _json(demo / "metrics.json").keys()
    assert sorted(out.glob("flight/flight_*.json"))
    events = [json.loads(ln) for ln in (out / "events.jsonl").read_text().splitlines()]
    assert events and all("request_id" in e or "cause_id" in e for e in events)
    assert "page" in [a["severity"] for a in _json(out / "slo.json")["alerts"]]
    assert (out / "README.md").exists()


def test_quantized_study(isolated):
    out = isolated / "quantized"
    assert _study("quantized").main(CPU4 + ["--sizes", "64", "--n-reps", "2",
                                            "--samples", "1", "--out", str(out)]) == 0
    errors, jax = _json(out / "errors.json"), _json(_demo("quantized") / "errors.json")
    assert errors.keys() == jax.keys() and errors["budgets"] == jax["budgets"]
    jrow = next(iter(jax["configs"].values()))
    for entry in errors["configs"].values():
        assert set(jrow) <= set(entry) | {"fp8"}
        for fmt, row in entry.items():
            assert row.keys() == jrow["native"].keys() and row["within_budget"], (fmt, row)
    assert (out / "tuning_cache.json").exists()


def test_refine_study(isolated, capsys):
    report = isolated / "REFINEMENT.md"
    assert _study("refine").main(CPU4 + ["--size", "32", "--max-iters", "200",
                                         "--report", str(report)]) == 0
    text = report.read_text()
    assert text.count("| 1e+0") == 3 and "refined trips" in text


def test_cost_model_study(isolated, capsys):
    out = isolated / "cost_model"
    rc = _study("cost_model").main(CPU4 + ["--n-reps", "2", "--out", str(out)])
    assert rc in (0, 1)  # the parity capture's verdict: a timing race on a loaded CPU
    demo = _demo("cost_model")
    for f in ("calibration.json", "metrics.json"):
        assert _json(out / f).keys() == _json(demo / f).keys(), f
    for f in ("crossover.csv", "prune_parity.csv"):
        assert _header(out / f) == _header(demo / f), f
    for f in ("exhaustive_cache.json", "pruned_cache.json"):
        assert (out / f).exists()
    if rc:
        err = capsys.readouterr().err
        assert any(ln.startswith(_study("cost_model").TIMING_GATES)
                   for ln in err.splitlines()), err


# ----------------------------------------------------------- the helpers


def test_overlap_stats_equal_the_jax_script_s():
    from matvec_mpi_multiplier_torch.models import get_strategy
    from matvec_mpi_multiplier_torch.parallel.mesh import make_mesh
    from matvec_mpi_multiplier_tpu.models import get_strategy as jget_strategy
    from matvec_mpi_multiplier_tpu.parallel.mesh import make_mesh as jmake_mesh

    jstats = _jax_script("overlap").overlap_stats
    rng = np.random.default_rng(0)
    a, x = rng.standard_normal((64, 64)), rng.standard_normal(64)
    mesh = make_mesh(4, devices=[torch.device("cpu")] * 4)
    for name in ("colwise_ring", "colwise_ring_overlap"):
        port = _study("overlap").overlap_stats(get_strategy(name), mesh,
                                               torch.from_numpy(a), torch.from_numpy(x))
        assert port == jstats(jget_strategy(name).build(jmake_mesh(4)), a, x), name
    assert port == {"n_permute": 3, "n_dot": 4, "hops_with_concurrent_dot": 3,
                    "concurrent_pairs": 6}


@pytest.mark.parametrize("failed", [10, 0])
def test_replay_slo_equals_the_jax_script_s(failed):
    snapshot = {"histograms": {"serve_e2e_latency_ms": {"p99": 73.5}}}
    port = _study("slo").replay_slo(snapshot, failed=failed, offered=200)
    jax = _jax_script("slo").replay_slo(snapshot, failed=failed, offered=200)
    assert port == jax


def test_spd_with_condition_equals_the_jax_script_s():
    port = _study("refine").spd_with_condition(48, 1e4, np.random.default_rng(3))
    jax = _jax_script("refine").spd_with_condition(48, 1e4, np.random.default_rng(3))
    for p, j in zip(port, jax):
        assert np.array_equal(p, j)


def test_measured_counts_equal_the_jax_script_s():
    snapshot = {"counters": {"tuning_gemv_candidates_total": 4,
                             "tuning_combine_candidates_total": 7,
                             "tuning_pruned_candidates_total": 5,
                             "tuning_cache_stale_total": 2}}
    assert _study("cost_model")._measured_counts(snapshot) == \
        _jax_script("cost_model")._measured_counts(snapshot) == (11, 5)


def test_error_study_on_native_storage_equals_the_jax_script_s(monkeypatch):
    """Native fp32 only: the JAX package's quantized programs raise under
    the installed jax, so the quantized rows have no JAX oracle here."""
    from matvec_mpi_multiplier_torch.parallel.mesh import make_mesh
    from matvec_mpi_multiplier_tpu.tuning import search as jsearch
    from matvec_mpi_multiplier_torch.tuning import search as psearch

    monkeypatch.setattr(jsearch, "storage_format_candidates", lambda dtype: ["native"])
    monkeypatch.setattr(psearch, "storage_format_candidates", lambda dtype: ["native"])
    configs = [("rowwise", 64, 256), ("colwise", 64, 256)]
    jax = _jax_script("quantized").error_study(configs, 0)
    import jax as jax_mod

    n = len(jax_mod.devices())
    port = _study("quantized").error_study(configs, 0,
                                           make_mesh(n, devices=[torch.device("cpu")] * n))
    assert port["budgets"] == jax["budgets"]
    for cfg, entry in jax["configs"].items():
        p, j = port["configs"][cfg]["native"], entry["native"]
        assert {k: p[k] for k in ("bytes_ratio", "budget", "within_budget")} == \
            {k: j[k] for k in ("bytes_ratio", "budget", "within_budget")}
        assert abs(p["max_relerr_vs_fp64"] - j["max_relerr_vs_fp64"]) <= 1e-6


def test_gate_functions_hold_the_jax_scripts_verdicts(tmp_path):
    """The reshard and gsched gates on the JAX scripts' committed capture:
    they pass it, and a regressed arm fails them."""
    demo = _demo("reshard")
    summary = _json(demo / "summary.json")
    src = summary["protocol"]["src"]
    m, k = summary["protocol"]["m"], summary["protocol"]["k"]
    gate = _study("reshard").gate_failures
    assert gate(summary["off"], summary["auto"], src, demo, m, k) == []
    worse = dict(summary["auto"], p99_steady_ms=summary["off"]["p99_steady_ms"] + 1)
    assert any("p99" in f for f in gate(summary["off"], worse, src, demo, m, k))
    g = _json(_demo("gsched") / "summary.json")
    ggate = _study("gsched").gate_failures
    assert ggate(g["greedy"], g["scheduled"], _demo("gsched")) == []
    assert any("on-time" in f for f in ggate(g["greedy"], dict(g["scheduled"], on_time=0),
                                             _demo("gsched")))


def test_reshard_csv_writer_matches_the_jax_script_s(tmp_path):
    from matvec_mpi_multiplier_torch.bench.serve import append_reshard_result

    summary = _json(_demo("reshard") / "summary.json")
    for arm in ("off", "auto"):
        append_reshard_result(summary[arm], root=tmp_path)
    assert _header(tmp_path / "out" / "reshard_ab.csv") == _header(
        _demo("reshard") / "out" / "reshard_ab.csv")


# ---------------------------------------------------------- the contract


def _defaults(name) -> dict:
    """Every option default of the study's parser, by dest."""
    import argparse

    mod = _study(name)
    seen = {}
    real = argparse.ArgumentParser.parse_args

    def capture(self, args=None, namespace=None):
        seen.update(vars(real(self, [])))
        raise SystemExit(0)

    argparse.ArgumentParser.parse_args = capture
    try:
        with pytest.raises(SystemExit):
            mod.main([])
    finally:
        argparse.ArgumentParser.parse_args = real
    return seen


@pytest.mark.parametrize("name", NAMES)
def test_defaults_touch_no_file_committed_before_the_port(name):
    defaults = _defaults(name)
    assert defaults["platform"] == "cuda"
    paths = [v for k, v in defaults.items()
             if k in ("out", "data_root", "report", "fig") and v is not None]
    for path in paths:
        assert Path(path).parts[:2] == studies.DEMO_ROOT.parts, (name, path)
    assert defaults.get("report") is None
    # The demo root holds nothing the JAX package committed: it is the
    # port's own, and git ignores what the studies write there.
    assert not any(p.parts[:2] == studies.DEMO_ROOT.parts
                   for p in (REPO / "data").glob("*_demo"))
    assert "data/torch_demo/" in (REPO / ".gitignore").read_text().splitlines()


@pytest.mark.parametrize("name", NAMES)
def test_studies_refuse_to_run_without_a_card(name, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = {"crossover": ["--data-root", str(tmp_path)],
            "overlap": [], "refine": []}.get(name, ["--out", str(tmp_path / name)])
    with pytest.raises(ConfigError):
        _study(name).main(argv)


def test_no_port_module_imports_anything_under_scripts():
    scripts = {p.stem for p in (REPO / "scripts").glob("*.py")} | {"scripts"}
    for path in (REPO / "matvec_mpi_multiplier_torch").rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
                names = [node.module]
            for name in names:
                assert name.split(".")[0] not in scripts, (path, name)
