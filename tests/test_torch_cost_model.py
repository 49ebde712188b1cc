"""The port's calibrated cost model (``tuning/cost_model.py``) and its
symbolic census (``staticcheck/hlo.py``) against the JAX package's
(tests/test_cost_model.py), in-process.

Every prediction is the JAX package's arithmetic, so for equal arguments
the port's values are held EQUAL to the JAX package's (bitwise, not
approximately), case by case and over a hypothesis sweep. Records cross:
a calibration either package writes loads in the other. The pruning
acceptance runs the port's tuner under a deterministic fake timer derived
from the same machine constants (the JAX test's protocol). The solver
tiers' names are each package's own: the port's ``torch`` and
``cuda_fused`` are the JAX package's ``xla`` and ``pallas_fused``.
"""

import csv
import hashlib
import json
import types

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from matvec_mpi_multiplier_tpu.obs.registry import get_registry as jget_registry
from matvec_mpi_multiplier_tpu.obs.registry import reset_registry as jreset_registry
from matvec_mpi_multiplier_tpu.staticcheck import hlo as jhlo
from matvec_mpi_multiplier_tpu.tuning import cache as jcache
from matvec_mpi_multiplier_tpu.tuning import cost_model as jcm
from matvec_mpi_multiplier_torch import obs
from matvec_mpi_multiplier_torch.parallel.mesh import ShardedTensor, make_mesh
from matvec_mpi_multiplier_torch.staticcheck import hlo
from matvec_mpi_multiplier_torch.tuning import cache as tcache
from matvec_mpi_multiplier_torch.tuning import cost_model as cm
from matvec_mpi_multiplier_torch.tuning import search
from matvec_mpi_multiplier_torch.utils.errors import ConfigError

CPU = torch.device("cpu")
FP = "cpu:test:shared-0"
KERNEL_NAMES = {"torch": "xla", "cuda_fused": "pallas_fused"}


@pytest.fixture()
def registry():
    """A fresh process-default registry per test (the tuner and the
    divergence signal write to it)."""
    obs.registry._default = None
    yield obs.get_registry()
    obs.registry._default = None


def port_mesh(p=8):
    return make_mesh(p, devices=[CPU] * p)


def _fields(p):
    return dict(
        flops=8e10, mem_bps=2e10,
        alpha_s={"collective": 5e-4, "permute": 4e-4},
        beta_bps={"collective": 7e8, "permute": 7e8},
        p=p, level="full", probes={"gemv_s": 1e-3},
    )


def _cal(p: int = 8) -> cm.Calibration:
    """The JAX test's constants (the fake timer derives its times from them
    too, so the model is well calibrated by construction)."""
    return cm.Calibration(**_fields(p))


def _models(p: int = 8):
    return cm.CostModel(_cal(p)), jcm.CostModel(jcm.Calibration(**_fields(p)))


def _same(port, jax):
    """Two Predictions (or estimates) equal field for field, bitwise."""
    assert type(port).__name__ == type(jax).__name__
    for name in ("total_s", "compute_s", "wire_s", "latency_s", "flops",
                 "a_bytes", "wire_bytes", "dispatch_s", "queue_s", "swap_s"):
        if hasattr(jax, name):
            assert getattr(port, name) == getattr(jax, name), name


# --------------------------------------------------- calibration record


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_calibration_record_round_trip(tmp_path, writer):
    """Schema v6 (v5 introduced the record): a record written by either
    package survives the file round-trip and rebuilds into the same
    constants in both."""
    path = tmp_path / "tuning_cache.json"
    key = tcache.calibration_key(8, fingerprint=FP)
    assert key == jcache.calibration_key(8, fingerprint=FP)
    if writer == "port":
        cache = tcache.TuningCache.load(path)
        cache.record(key, _cal().to_record())
    else:
        cache = jcache.TuningCache.load(path)
        cache.record(key, jcm.Calibration(**_fields(8)).to_record())
    cache.save()
    assert json.loads(path.read_text())["version"] == tcache.CACHE_VERSION == 6
    port = cm.Calibration.from_record(tcache.TuningCache.load(path).lookup(key))
    jax = jcm.Calibration.from_record(jcache.TuningCache.load(path).lookup(key))
    assert port == _cal() and port.to_record() == jax.to_record()
    model = cm.model_from_cache(tcache.TuningCache.load(path), 8, fingerprint=FP)
    assert isinstance(model, cm.CostModel)


@pytest.mark.parametrize(
    "record",
    [
        None,
        {},
        {"flops": 1e9},                              # missing constants
        {**_cal().to_record(), "flops": -1.0},       # nonsense constants
        {**_cal().to_record(), "alpha_s": {}},       # family map gutted
        {**_cal().to_record(), "flops": "1e11"},     # hand-edited string
        {**_cal().to_record(),
         "beta_bps": {"collective": "fast", "permute": 1e9}},
    ],
    ids=["none", "empty", "partial", "negative", "no-families",
         "string-flops", "string-beta"],
)
def test_malformed_calibration_reads_as_uncalibrated(record):
    assert cm.Calibration.from_record(record) is None
    assert jcm.Calibration.from_record(record) is None


def test_model_from_cache_miss_returns_none(tmp_path):
    cache = tcache.TuningCache.load(tmp_path / "tuning_cache.json")
    assert cm.model_from_cache(cache, 8) is None
    assert cm.any_model_from_cache(cache) is None


def test_any_model_prefers_largest_probed_mesh(tmp_path):
    cache = tcache.TuningCache.load(tmp_path / "tuning_cache.json")
    cache.record(tcache.calibration_key(2, FP), _cal(2).to_record())
    cache.record(tcache.calibration_key(8, FP), _cal(8).to_record())
    model = cm.any_model_from_cache(cache, fingerprint=FP)
    assert model is not None and model.calibration.p == 8
    jmodel = jcm.any_model_from_cache(cache, fingerprint=FP)
    assert jmodel.calibration.to_record() == model.calibration.to_record()


# ------------------------------------------------------- model properties


def test_predicted_time_monotone_in_mk_and_payload():
    """At a fixed config, predicted time is non-decreasing in m·k and in the
    payload bytes (m at fixed k), and equal to the JAX package's."""
    model, jmodel = _models()
    for combine in ("psum", "psum_scatter", "ring", "a2a"):
        prev = None
        for m in (64, 256, 1024, 4096, 16384):
            kw = dict(m=m, k=4096, p=8, dtype="float32")
            pred = model.predict("colwise", combine, **kw)
            _same(pred, jmodel.predict("colwise", combine, **kw))
            assert np.isfinite(pred.total_s) and pred.total_s > 0
            if prev is not None:
                assert pred.total_s >= prev.total_s
                assert pred.wire_bytes >= prev.wire_bytes
            prev = pred
    prev = None
    for k in (256, 1024, 4096):
        pred = model.predict("rowwise", "gather", m=1024, k=k, p=8, dtype="float32")
        if prev is not None:
            assert pred.total_s >= prev.total_s
        prev = pred


def test_quantized_storage_shrinks_predicted_compute_only():
    model, jmodel = _models()
    kw = dict(m=2048, k=2048, p=8, dtype="float32")
    native = model.predict("colwise", "psum_scatter", **kw)
    int8 = model.predict("colwise", "psum_scatter", storage="int8", **kw)
    _same(int8, jmodel.predict("colwise", "psum_scatter", storage="int8", **kw))
    assert int8.wire_s == native.wire_s
    assert int8.latency_s == native.latency_s
    assert int8.a_bytes < 0.30 * native.a_bytes


def test_staging_preserves_total_predicted_transfer():
    """overlap@S: the same census total and predicted wire bytes and time,
    S× the op count."""
    model, _ = _models()
    for strategy in ("rowwise", "colwise", "blockwise"):
        base = model.predict(strategy, "overlap", m=256, k=256, p=8,
                             dtype="float32", stages=1)
        base_census, base_payload = hlo.schedule_formula(
            strategy, "overlap", 1, m=256, p=8, r=2, itemsize=4)
        for s in (2, 4, 8):
            pred = model.predict(strategy, "overlap", m=256, k=256, p=8,
                                 dtype="float32", stages=s)
            assert pred.wire_bytes == pytest.approx(base.wire_bytes)
            assert pred.wire_s == pytest.approx(base.wire_s)
            assert pred.latency_s == pytest.approx(base.latency_s * s)
            census, payload = hlo.schedule_formula(
                strategy, "overlap", s, m=256, p=8, r=2, itemsize=4)
            assert sum(payload.values()) == sum(base_payload.values())
            assert sum(census.values()) == s * sum(base_census.values())
            assert (census, payload) == jhlo.schedule_formula(
                strategy, "overlap", s, m=256, p=8, r=2, itemsize=4)


def test_storage_ratio_formula_matches_golden_table():
    """The port's byte formula against the JAX package's committed golden
    table's artifact-read ratios, and against the JAX formula."""
    golden = json.loads(
        (jhlo.repo_root() / jhlo.GOLDEN_REL).read_text())["configs"]
    checked = 0
    for key, entry in golden.items():
        parts = key.split("|")
        if len(parts) != 4:
            continue  # native config (no storage suffix)
        expected = hlo.storage_bytes_ratio(
            parts[3], hlo.dtype_itemsize(jhlo.AUDIT_DTYPE))
        assert entry["a_bytes_ratio"] == pytest.approx(expected, abs=1e-3), key
        checked += 1
    assert checked >= 3
    for storage in ("native", "int8", "int8c", "fp8"):
        for itemsize in (1, 2, 4, 8):
            assert (hlo.storage_bytes_ratio(storage, itemsize)
                    == jhlo.storage_bytes_ratio(storage, itemsize))
    with pytest.raises(KeyError):
        hlo.storage_bytes_ratio("speculate", 4)
    assert hlo._ITEMSIZE == jhlo._ITEMSIZE


def test_wire_factors():
    assert cm.wire_factor("all-reduce", 8) == pytest.approx(1.75)
    assert cm.wire_factor("reduce-scatter", 8) == pytest.approx(0.875)
    assert cm.wire_factor("collective-permute", 8) == 1.0
    assert cm.wire_factor("all-reduce", 1) == 0.0
    for kind in ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                 "collective-permute"):
        assert cm.family(kind) == jcm.family(kind)
        for p in (1, 2, 3, 8, 64):
            assert cm.wire_factor(kind, p) == jcm.wire_factor(kind, p)


# --------------------------------------------- shared-formula mutation


def test_formula_mutation_reddens_audit_and_model(monkeypatch):
    """Perturbing the port's symbolic census reddens the port's model
    (each prediction imports ``hlo.schedule_formula`` at call time), and
    only the port's: the JAX package's model keeps its own formula."""
    model, jmodel = _models()
    kw = dict(m=64, k=64, p=8, dtype="float32")
    baseline = model.predict("colwise", "psum", **kw)
    _same(baseline, jmodel.predict("colwise", "psum", **kw))
    orig = hlo.schedule_formula

    def perturbed(*args, **kwargs):
        census, payload = orig(*args, **kwargs)
        return census, {k: v * 2 for k, v in payload.items()}

    monkeypatch.setattr(hlo, "schedule_formula", perturbed)
    mutated = model.predict("colwise", "psum", **kw)
    assert mutated.wire_bytes == pytest.approx(2 * baseline.wire_bytes)
    assert jmodel.predict("colwise", "psum", **kw).wire_bytes == baseline.wire_bytes


# --------------------------------------------------- pruning acceptance


def _jitter(label: str) -> float:
    """Deterministic per-candidate perturbation in [0.98, 1.02]."""
    h = int(hashlib.sha256(label.encode()).hexdigest()[:8], 16)
    return 1.0 + 0.04 * (h / 0xFFFFFFFF - 0.5)


def _leaves(operand) -> list[torch.Tensor]:
    shards = operand.shards if isinstance(operand, ShardedTensor) else [operand]
    out = []
    for shard in shards:
        leaves = getattr(shard, "leaves", None)
        out += [t for t in ((shard,) if leaves is None else leaves) if t is not None]
    return out


def _install_fake_timer(monkeypatch, cal: cm.Calibration):
    """Replace the measurement entry points with deterministic times derived
    from the same machine constants the model predicts with."""
    model = cm.CostModel(cal)

    def fake_benchmark(strategy, mesh, a, x, *, dtype=None, combine=None,
                       stages=None, **kwargs):
        name = strategy if isinstance(strategy, str) else strategy.name
        family = "colwise" if name.startswith("colwise") else name
        m, k = a.shape
        p = mesh.size
        b = 1 if x.dim() == 1 else x.shape[1]
        try:
            t = model.predict(family, combine, m=m, k=k, p=p, dtype=dtype,
                              stages=stages, b=b).total_s
        except KeyError:
            t = 1e-3
        t *= _jitter(f"{family}|{combine}|{stages}|{m}x{k}|b{b}")
        return types.SimpleNamespace(times_s=[t], min_time_s=t)

    def fake_measure_fn(fn, args, mesh, *, n_reps, samples, measure="loop"):
        a, rhs = args
        leaves = _leaves(a)
        a_bytes = sum(t.numel() * t.element_size() for t in leaves)
        elems = sum(t.numel() for t in leaves)
        b = 1 if len(rhs.shape) == 1 else rhs.shape[-1]
        t = max(2.0 * elems * b / cal.flops, a_bytes / cal.mem_bps)
        kinds = ",".join(sorted(str(t.dtype) for t in leaves))
        return t * _jitter(f"{a_bytes}|{b}|{kinds}")

    monkeypatch.setattr(search, "benchmark_strategy", fake_benchmark)
    monkeypatch.setattr(search, "benchmark_gemm", fake_benchmark)
    monkeypatch.setattr(search, "_measure_fn", fake_measure_fn)


def _run_all_axes(cache, mesh, *, prune_margin, log):
    """One pass over the tune_* axes for all three strategies."""
    decisions = {}
    kw = dict(n_reps=2, samples=1, min_gain=0.25, log=log,
              prune_margin=prune_margin)
    decisions["gemv"] = search.tune_gemv(8, 64, "float32", cache, **kw)["kernel"]
    decisions["gemm"] = search.tune_gemm(8, 64, 8, "float32", cache, **kw)["kernel"]
    for strategy in ("rowwise", "colwise", "blockwise"):
        d = search.tune_combine(strategy, mesh, 64, 64, "float32", cache,
                                measure="sync", **kw)
        decisions[f"combine/{strategy}"] = d["combine"]
        d = search.tune_overlap(strategy, mesh, 64, 64, "float32", cache,
                                measure="sync", **kw)
        decisions[f"overlap/{strategy}"] = d["stages"]
        d = search.tune_storage(strategy, mesh, 64, 1024, "float32", cache, **kw)
        decisions[f"storage/{strategy}"] = d["storage"]
        d = search.tune_promotion(strategy, mesh, 64, 64, "float32", cache, **kw)
        decisions[f"promotion/{strategy}"] = d["b_star"]
    d = search.tune_gemm_combine("colwise", mesh, 64, 64, 8, "float32", cache,
                                 measure="sync", **kw)
    decisions["gemm_combine/colwise"] = d["combine"]
    return decisions


def test_pruned_tuning_matches_exhaustive_with_fewer_measurements(
    registry, monkeypatch, tmp_path
):
    """prune_margin tuning reaches the exhaustive decisions on every axis
    while measuring at most 0.6 of the candidates, every pruned candidate
    logged and counted, every measured one recording its prediction."""
    mesh = port_mesh(8)
    cal = _cal()
    _install_fake_timer(monkeypatch, cal)

    exhaustive_cache = tcache.TuningCache(tmp_path / "exhaustive.json")
    exhaustive_cache.record(tcache.calibration_key(8), cal.to_record())
    exhaustive = _run_all_axes(exhaustive_cache, mesh, prune_margin=None,
                               log=lambda *_: None)
    n_exhaustive = search.candidates_measured()
    assert obs.get_registry().snapshot()["counters"].get(cm.PRUNED_COUNTER, 0) == 0

    obs.registry._default = None
    logs: list[str] = []
    pruned_cache = tcache.TuningCache(tmp_path / "pruned.json")
    pruned_cache.record(tcache.calibration_key(8), cal.to_record())
    pruned = _run_all_axes(pruned_cache, mesh, prune_margin=0.5, log=logs.append)
    snap = obs.get_registry().snapshot()
    n_pruned = search.candidates_measured()
    n_skipped = snap["counters"][cm.PRUNED_COUNTER]

    assert pruned == exhaustive, "pruned tuning changed a decision"
    assert n_pruned <= 0.6 * n_exhaustive, (n_pruned, n_exhaustive)
    assert n_skipped > 0
    assert sum(": pruned (" in line for line in logs) == n_skipped
    assert snap["histograms"][cm.RATIO_HISTOGRAM]["count"] > 0
    # The combine axes' predictions are the JAX package's.
    jmodel = jcm.CostModel(jcm.Calibration(**_fields(8)))
    for key, decision in pruned_cache.entries.items():
        if "|combine|matvec|" in key:
            strategy = key.split("|")[3]
            family = "colwise" if strategy.startswith("colwise") else strategy
            for cand, t in decision["predicted_s"].items():
                s = 1 if cand in ("overlap", "overlap_ring") else None
                j = jmodel.predict(family, cand, m=64, k=64, p=8, dtype="float32",
                                   stages=s, r=2).total_s
                assert t == j, (key, cand)


def test_uncalibrated_cache_falls_back_to_full_measurement(
    registry, monkeypatch, tmp_path
):
    """prune_margin on a cache with no calibration measures every candidate
    and says so; nothing is pruned."""
    mesh = port_mesh(8)
    _install_fake_timer(monkeypatch, _cal())
    logs: list[str] = []
    cache = tcache.TuningCache(tmp_path / "uncalibrated.json")
    d = search.tune_combine("colwise", mesh, 64, 64, "float32", cache,
                            measure="sync", n_reps=2, samples=1,
                            prune_margin=0.5, log=logs.append)
    from matvec_mpi_multiplier_torch import get_strategy

    assert len(d["candidates"]) == len(get_strategy("colwise").combine_candidates(mesh))
    assert d.get("pruned") is None and d.get("predicted_s") is None
    assert any("uncalibrated" in line for line in logs)
    assert obs.get_registry().snapshot()["counters"].get(cm.PRUNED_COUNTER, 0) == 0


def test_force_remeasure_counts_stale_and_names_axis(registry, monkeypatch, tmp_path):
    mesh = port_mesh(8)
    _install_fake_timer(monkeypatch, _cal())
    cache = tcache.TuningCache(tmp_path / "stale.json")
    kw = dict(n_reps=2, samples=1, log=lambda *_: None)
    search.tune_overlap("rowwise", mesh, 64, 64, "float32", cache,
                        measure="sync", **kw)
    assert obs.get_registry().snapshot()["counters"].get(
        "tuning_cache_stale_total", 0) == 0
    logs: list[str] = []
    search.tune_overlap("rowwise", mesh, 64, 64, "float32", cache, measure="sync",
                        force=True, n_reps=2, samples=1, log=logs.append)
    assert obs.get_registry().snapshot()["counters"]["tuning_cache_stale_total"] == 1
    assert any(line.strip().startswith("overlap:") and "stale" in line
               for line in logs)


# ------------------------------------------------------- obs / health


def test_divergence_health_flags_sustained_divergence(registry):
    jreset_registry()
    try:
        health = cm.divergence_health()
        assert health["samples"] == 0 and not health["divergent"]
        for _ in range(cm.DIVERGENCE_MIN_SAMPLES):
            cm.record_prediction(1.1e-3, 1.0e-3)
            jcm.record_prediction(1.1e-3, 1.0e-3)
        health = cm.divergence_health()
        assert health == jcm.divergence_health()
        assert health["samples"] == cm.DIVERGENCE_MIN_SAMPLES
        assert not health["divergent"]
        for _ in range(3 * cm.DIVERGENCE_MIN_SAMPLES):
            cm.record_prediction(5e-2, 1.0e-3)
            jcm.record_prediction(5e-2, 1.0e-3)
        health = cm.divergence_health()
        assert health == jcm.divergence_health()
        assert health["divergent"]
        assert health["median_abs_log10_ratio"] > cm.DIVERGENCE_LOG10
        snap = obs.get_registry().snapshot()
        assert snap["gauges"][cm.DIVERGENCE_GAUGE] > cm.DIVERGENCE_LOG10
        assert snap["histograms"] == jget_registry().snapshot()["histograms"]
        # Non-positive pairs record nothing, in both.
        cm.record_prediction(0.0, 1.0)
        assert cm.divergence_health()["samples"] == 4 * cm.DIVERGENCE_MIN_SAMPLES
    finally:
        jreset_registry()


def test_engine_health_surfaces_cost_model_divergence(registry):
    from matvec_mpi_multiplier_torch.engine import MatvecEngine

    for _ in range(cm.DIVERGENCE_MIN_SAMPLES):
        cm.record_prediction(1.0, 1e-2)
    a = np.random.default_rng(42).uniform(0, 1, (64, 64)).astype(np.float32)
    engine = MatvecEngine(torch.from_numpy(a), port_mesh(8), strategy="rowwise",
                          promote=None)
    try:
        health = engine.health()
    finally:
        engine.close()
    assert health["cost_model"]["divergent"] is True
    assert health["cost_model"]["samples"] >= cm.DIVERGENCE_MIN_SAMPLES


def test_cost_model_panel_renders(registry):
    from matvec_mpi_multiplier_tpu.obs.__main__ import render_cost_model as jrender
    from matvec_mpi_multiplier_torch.obs.__main__ import (
        render_cost_model,
        render_metrics,
    )

    cm.record_prediction(2e-3, 1e-3)
    obs.get_registry().counter(cm.PRUNED_COUNTER, "").inc(4)
    snap = obs.get_registry().snapshot()
    out = render_metrics(snap)
    assert "cost model:" in out and "4 candidates" in out
    assert render_cost_model(snap) == jrender(snap)
    obs.registry._default = None
    assert "cost model:" not in render_metrics(obs.get_registry().snapshot())


def test_slo_target_reads_the_divergence_gauge(registry):
    """The SLO target cost_model_divergence evaluates the gauge the model
    writes (no_data before any prediction)."""
    from matvec_mpi_multiplier_torch.obs.slo import DEFAULT_TARGETS, SloMonitor

    target = next(t for t in DEFAULT_TARGETS if t.name == "cost_model_divergence")
    assert target.source == cm.DIVERGENCE_GAUGE
    monitor = SloMonitor(obs.get_registry(), (target,))
    monitor.sample()
    assert monitor.evaluate()["targets"]["cost_model_divergence"]["status"] == "no_data"
    for _ in range(cm.DIVERGENCE_MIN_SAMPLES):
        cm.record_prediction(5e-2, 1e-3)
    monitor.sample()
    evaluation = monitor.evaluate()["targets"]["cost_model_divergence"]
    assert evaluation["status"] != "no_data"
    assert evaluation["value"] > cm.DIVERGENCE_LOG10


# --------------------------------------------------------------- CLI


def test_cli_emits_crossover_surface(tmp_path):
    """The CLI's surface CSV under one explicit calibration equals the JAX
    CLI's row for row; the synthetic surface has one winner per cell."""
    from matvec_mpi_multiplier_tpu.tuning.cost_model import main as jmain
    from matvec_mpi_multiplier_torch.tuning.cost_model import main

    cache_path = tmp_path / "cache.json"
    cache = tcache.TuningCache.load(cache_path)
    cache.record(tcache.calibration_key(8), _cal().to_record())
    cache.record(jcache.calibration_key(8, jcache.platform_fingerprint()),
                 _cal().to_record())
    cache.save()
    argv = ["--m", "256", "4096", "--k", "256", "8192", "--p", "2", "4", "8",
            "--dtype", "float32", "bfloat16", "--b", "2", "--cache", str(cache_path)]
    assert main(argv + ["--out", str(tmp_path / "port.csv")]) == 0
    assert jmain(argv + ["--out", str(tmp_path / "jax.csv")]) == 0
    port_rows = list(csv.DictReader((tmp_path / "port.csv").open()))
    jax_rows = list(csv.DictReader((tmp_path / "jax.csv").open()))
    assert port_rows and port_rows == jax_rows

    out = tmp_path / "surface.csv"
    assert main(["--synthetic-calibration", "--m", "256", "4096", "--p", "4", "8",
                 "--dtype", "float32", "--out", str(out),
                 "--cache", str(tmp_path / "empty.json")]) == 0
    rows = list(csv.DictReader(out.open()))
    assert rows and set(rows[0]) == set(cm.SURFACE_COLUMNS)
    groups = {}
    for row in rows:
        t = float(row["predicted_s"])
        assert np.isfinite(t) and t > 0
        cell = (row["m"], row["k"], row["p"], row["dtype"], row["strategy"])
        groups[cell] = groups.get(cell, 0) + int(row["winner"])
    assert all(n == 1 for n in groups.values())
    assert {g[4] for g in groups} == {"rowwise", "colwise", "blockwise"}


def test_cli_without_calibration_fails_loudly(tmp_path, capsys):
    from matvec_mpi_multiplier_torch.tuning.cost_model import main

    assert main(["--cache", str(tmp_path / "empty.json")]) == 1
    assert "no calibration" in capsys.readouterr().err


def test_cli_calibrate_writes_a_record_both_packages_read(tmp_path):
    """``--calibrate quick --platform cpu`` records the constants of this
    platform; the JAX package's cache reads the record back as a model."""
    from matvec_mpi_multiplier_torch.tuning.cost_model import main

    path = tmp_path / "cache.json"
    assert main(["--calibrate", "quick", "--platform", "cpu", "--host-devices", "4",
                 "--m", "256", "--p", "4", "--dtype", "float32",
                 "--out", str(tmp_path / "s.csv"), "--cache", str(path)]) == 0
    record = tcache.TuningCache.load(path).lookup(tcache.calibration_key(4))
    assert record["p"] == 4 and record["level"] == "quick"
    assert jcm.Calibration.from_record(record) is not None
    assert len(list(csv.DictReader((tmp_path / "s.csv").open()))) > 0


# ------------------------------------------------------ solver predictions


def test_predict_solver_scales_by_matvec_count():
    from matvec_mpi_multiplier_torch.solvers import solver_matvec_count

    model, jmodel = _models()
    shape = dict(m=256, k=256, p=8, dtype="float32")
    per = model.predict("rowwise", "gather", **shape)
    for op, kw in [("cg", {}), ("power", {}), ("chebyshev", {}),
                   ("gmres", {"restart": 7}), ("lanczos", {"steps": 16})]:
        pred = model.predict_solver(op, "rowwise", "gather", k_est=25, **shape, **kw)
        _same(pred, jmodel.predict_solver(op, "rowwise", "gather", k_est=25,
                                          **shape, **kw))
        n_mv = solver_matvec_count(op, 25, restart=kw.get("restart", 10),
                                   steps=kw.get("steps", 32))
        launch = 25 * cm.SOLVER_KERNEL_LAUNCHES["torch"] * _cal().alpha_s["collective"]
        assert pred.total_s == pytest.approx(n_mv * per.total_s + launch)
        assert pred.flops == pytest.approx(n_mv * per.flops)
        assert pred.wire_bytes == n_mv * per.wire_bytes
        assert pred.a_bytes == per.a_bytes


def test_predict_solver_rejects_bad_inputs():
    model, _ = _models()
    with pytest.raises(ValueError, match="unknown solver op"):
        model.predict_solver("jacobi", "rowwise", "gather",
                             m=64, k=64, p=8, dtype="float32", k_est=5)
    with pytest.raises(ValueError, match="k_est"):
        model.predict_solver("cg", "rowwise", "gather",
                             m=64, k=64, p=8, dtype="float32", k_est=0)
    with pytest.raises(ValueError, match="kernel"):
        model.predict_solver("cg", "rowwise", "gather", m=64, k=64, p=8,
                             dtype="float32", k_est=5, kernel="warp")


def test_predict_solver_pins_storage_ordering():
    model, jmodel = _models()
    shape = dict(m=4096, k=4096, p=8, dtype="float32", k_est=50)
    native = model.predict_solver("cg", "colwise", "psum", **shape)
    int8c = model.predict_solver("cg", "colwise", "psum", **shape, storage="int8c")
    _same(int8c, jmodel.predict_solver("cg", "colwise", "psum", **shape,
                                       storage="int8c"))
    assert int8c.total_s < native.total_s
    assert int8c.a_bytes < native.a_bytes
    assert int8c.latency_s == native.latency_s


def test_predict_solver_kernel_axis_prices_launch_overhead():
    model, jmodel = _models()
    shape = dict(m=512, k=512, p=8, dtype="float32", k_est=16)
    unfused = model.predict_solver("cg", "rowwise", "gather", **shape)
    fused = model.predict_solver("cg", "rowwise", "gather", **shape,
                                 kernel="cuda_fused")
    for tier, pred in (("torch", unfused), ("cuda_fused", fused)):
        _same(pred, jmodel.predict_solver("cg", "rowwise", "gather", **shape,
                                          kernel=KERNEL_NAMES[tier]))
        assert (cm.SOLVER_KERNEL_LAUNCHES[tier]
                == jcm.SOLVER_KERNEL_LAUNCHES[KERNEL_NAMES[tier]])
    delta = 16 * (cm.SOLVER_KERNEL_LAUNCHES["torch"]
                  - cm.SOLVER_KERNEL_LAUNCHES["cuda_fused"]) * _cal().alpha_s["collective"]
    assert fused.total_s < unfused.total_s
    assert unfused.total_s - fused.total_s == pytest.approx(delta)
    assert fused.flops == unfused.flops
    assert fused.wire_bytes == unfused.wire_bytes
    assert fused.a_bytes == unfused.a_bytes


def test_predict_admission_routes_solver_ops():
    model, jmodel = _models()
    shape = dict(m=64, k=64, p=8, dtype="float32")
    est = model.predict_admission("rowwise", "gather", **shape, queue_s=0.5,
                                  swap_bytes=0, op="cg", k_est=100)
    _same(est, jmodel.predict_admission("rowwise", "gather", **shape, queue_s=0.5,
                                        swap_bytes=0, op="cg", k_est=100))
    direct = model.predict_solver("cg", "rowwise", "gather", **shape, k_est=100)
    assert est.dispatch_s == pytest.approx(direct.total_s)
    assert est.eta_s == pytest.approx(0.5 + direct.total_s)
    with pytest.raises(ValueError, match="needs k_est"):
        model.predict_admission("rowwise", "gather", **shape, op="cg")


def test_speculative_storage_is_not_ported():
    model, _ = _models()
    with pytest.raises(ConfigError, match="queue A 3"):
        model.predict("rowwise", "gather", m=64, k=64, p=8, dtype="float32",
                      storage="speculate")


# ------------------------------------------ every formula equal to JAX's

_COMBINES = {
    "rowwise": ("gather", "psum", "ring", "overlap", "a2a"),
    "colwise": ("psum", "psum_scatter", "ring", "ring_overlap", "a2a", "overlap",
                "overlap_ring", "gather"),
    "blockwise": ("gather", "ring", "overlap", "psum"),
}
_DTYPES = ("float32", "bfloat16", "float16", "float64")
_STORAGES = ("native", "int8", "int8c", "fp8")
_OPS = ("cg", "gmres", "power", "lanczos", "chebyshev")


def _both(port_call, jax_call):
    """Call both; equal results, or the same exception type."""
    try:
        port = port_call()
    except (KeyError, ValueError) as e:
        with pytest.raises(type(e)):
            jax_call()
        return None
    jax = jax_call()
    return port, jax


@settings(max_examples=300, deadline=None)
@given(
    strategy=st.sampled_from(sorted(_COMBINES)),
    combine_i=st.integers(0, 7),
    stages=st.sampled_from([None, 1, 2, 4, 8]),
    m=st.integers(1, 1 << 17), k=st.integers(1, 1 << 17),
    p=st.integers(1, 64), r=st.sampled_from([None, 1, 2, 4, 8]),
    dtype=st.sampled_from(_DTYPES), b=st.integers(1, 128),
    storage=st.sampled_from(_STORAGES), op=st.sampled_from(_OPS),
    k_est=st.integers(1, 500), queue_s=st.floats(0, 10),
    swap_bytes=st.integers(0, 1 << 34),
    dst=st.sampled_from(["rowwise", "colwise", "blockwise"]),
    flops=st.floats(1e6, 1e16), mem=st.floats(1e6, 1e13),
    alpha=st.floats(0, 1e-2), beta=st.floats(1e3, 1e13),
)
def test_every_prediction_equals_jax(strategy, combine_i, stages, m, k, p, r, dtype,
                                     b, storage, op, k_est, queue_s, swap_bytes, dst,
                                     flops, mem, alpha, beta):
    fields = dict(flops=flops, mem_bps=mem,
                  alpha_s={"collective": alpha, "permute": alpha / 2},
                  beta_bps={"collective": beta, "permute": beta * 3},
                  p=p, level="full", probes={})
    model, jmodel = cm.CostModel(cm.Calibration(**fields)), jcm.CostModel(
        jcm.Calibration(**fields))
    combines = _COMBINES[strategy]
    combine = combines[combine_i % len(combines)]
    if r is not None and p % r:
        r = None
    itemsize = hlo.dtype_itemsize(dtype)
    assert itemsize == jhlo.dtype_itemsize(dtype)
    rr = r if r is not None else 1
    got = _both(
        lambda: hlo.schedule_formula(strategy, combine, stages, m=m, p=p, r=rr,
                                     itemsize=itemsize),
        lambda: jhlo.schedule_formula(strategy, combine, stages, m=m, p=p, r=rr,
                                      itemsize=itemsize))
    if got is not None:
        assert got[0] == got[1]
    kw = dict(m=m, k=k, p=p, dtype=dtype, stages=stages, b=b, storage=storage, r=r)
    got = _both(lambda: model.predict(strategy, combine, **kw),
                lambda: jmodel.predict(strategy, combine, **kw))
    if got is not None:
        _same(*got)
    skw = dict(m=m, k=k, p=p, dtype=dtype, stages=stages, storage=storage, r=r,
               k_est=k_est)
    for tier in ("torch", "cuda_fused"):
        got = _both(
            lambda: model.predict_solver(op, strategy, combine, kernel=tier, **skw),
            lambda: jmodel.predict_solver(op, strategy, combine,
                                          kernel=KERNEL_NAMES[tier], **skw))
        if got is not None:
            _same(*got)
    akw = dict(kw, queue_s=queue_s, swap_bytes=swap_bytes)
    got = _both(lambda: model.predict_admission(strategy, combine, **akw),
                lambda: jmodel.predict_admission(strategy, combine, **akw))
    if got is not None:
        _same(*got)
        assert got[0].eta_s == got[1].eta_s
    akw.pop("b")
    got = _both(lambda: model.predict_admission(strategy, combine, op=op,
                                                k_est=k_est, **akw),
                lambda: jmodel.predict_admission(strategy, combine, op=op,
                                                 k_est=k_est, **akw))
    if got is not None:
        _same(*got)
    assert model.restore_s(swap_bytes) == jmodel.restore_s(swap_bytes)
    if p >= 1 and (r is None or p % (r or 1) == 0):
        rkw = dict(m=m, k=k, p=p, dtype=dtype, r=r)
        got = _both(lambda: model.predict_reshard(strategy, dst, **rkw),
                    lambda: jmodel.predict_reshard(strategy, dst, **rkw))
        if got is not None:
            _same(*got)
        rr, cc = (r, p // r) if r is not None else (1, p)
        got = _both(
            lambda: hlo.reshard_formula(strategy, dst, m=m, k=k, p=p, r=rr, c=cc,
                                        itemsize=itemsize),
            lambda: jhlo.reshard_formula(strategy, dst, m=m, k=k, p=p, r=rr, c=cc,
                                         itemsize=itemsize))
        if got is not None:
            assert got[0] == got[1]
    for fmt in _STORAGES:
        assert hlo.storage_bytes_ratio(fmt, itemsize) == jhlo.storage_bytes_ratio(
            fmt, itemsize)


def test_crossover_surface_equals_jax():
    model, jmodel = _models()
    kw = dict(ms=[256, 1024, 4096], ks=[512, 1024, 8192], ps=(2, 4, 8, 16),
              dtypes=("float32", "bfloat16"), b=4)
    assert cm.crossover_surface(model, **kw) == jcm.crossover_surface(jmodel, **kw)
    assert cm.SURFACE_COMBINES == jcm.SURFACE_COMBINES
    assert cm.SURFACE_COLUMNS == jcm.SURFACE_COLUMNS


# ------------------------------------------------------------ calibration


def test_calibrate_quick_on_a_cpu_mesh_gives_positive_constants():
    """The probes run on the CPU mesh through the engine's kernels' plain
    versions (timings are this host's, not compared)."""
    cal = cm.calibrate(port_mesh(4), level="quick", n_reps=2, log=lambda *_: None)
    assert cal.p == 4 and cal.level == "quick"
    assert cal.flops > 0 and cal.mem_bps > 0
    assert all(v > 0 for v in (*cal.alpha_s.values(), *cal.beta_bps.values()))
    assert cal.probes["gemv_m"] == 1024 and cal.probes["collective_p"] == 4
    assert cm.Calibration.from_record(cal.to_record()) == cal
    one = cm.calibrate(port_mesh(1), level="full", n_reps=2, log=lambda *_: None)
    assert one.p == 1 and one.probes["collective_p"] == 2
    assert jcm.Calibration.from_record(one.to_record()) is not None
