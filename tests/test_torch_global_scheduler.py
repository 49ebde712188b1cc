"""The port's global scheduler (``engine/global_scheduler.py``) against the
JAX package's (tests/test_global_scheduler.py, and the scheduler cases of
tests/test_reshard.py), in-process on the CPU mesh.

Each case runs the same seeded trace with the same explicit calibration
through both packages' schedulers and holds the port's decisions to the
JAX package's: the same admit/reject outcomes, the same decision trace
(``decision``, tenant, ``reason``, ``predicted_s`` equal), the same
interleave order and eviction victims. Results are held bitwise to the
port's own solo dispatches (coalesced columns, the on/off A/B) and to the
JAX package's results within fp32 rounding. Fake clocks drive both: the JAX
package's ``clock=``/``rate_clock=`` arguments, the port's ``_clock``
attributes (the port carries no test-only parameters). The predicted
backlog counts dispatches not yet done: on the CPU mesh the port's are done
on return (PyTorch runs synchronously there), so the JAX package's futures
are made to report done once their arrays are ready (``done`` blocks) and
both backlogs read the same.
"""

import ast
import inspect
import json

import numpy as np
import pytest
import torch

import matvec_mpi_multiplier_tpu as mv_jax
from matvec_mpi_multiplier_tpu.bench import serve as jax_serve
from matvec_mpi_multiplier_tpu.engine import GlobalScheduler as JGlobalScheduler
from matvec_mpi_multiplier_tpu.engine import MatrixRegistry as JMatrixRegistry
from matvec_mpi_multiplier_tpu.engine import MatvecEngine as JMatvecEngine
from matvec_mpi_multiplier_tpu.tuning import cost_model as jcm
from matvec_mpi_multiplier_torch.bench import serve
from matvec_mpi_multiplier_torch.engine import GlobalScheduler, MatrixRegistry, MatvecEngine
from matvec_mpi_multiplier_torch.engine import global_scheduler as gs_mod
from matvec_mpi_multiplier_torch.parallel.mesh import make_mesh
from matvec_mpi_multiplier_torch.resilience import is_rejection
from matvec_mpi_multiplier_torch.tuning.cost_model import (
    AdmissionEstimate,
    Calibration,
    CostModel,
)
from matvec_mpi_multiplier_torch.utils.errors import (
    AdmissionRejectedError,
    ConfigError,
    DeadlineExceededError,
)

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(8, devices=[CPU] * 8)


@pytest.fixture(scope="module")
def jmesh(devices):
    return mv_jax.make_mesh(8)


@pytest.fixture(autouse=True)
def cold_cache(tmp_path, monkeypatch):
    """Both packages' tuning caches on an empty temp file."""
    from matvec_mpi_multiplier_tpu import tuning as jtuning
    from matvec_mpi_multiplier_torch import tuning

    monkeypatch.setenv("MATVEC_TUNING_CACHE", str(tmp_path / "cold_cache.json"))
    tuning.reset_cache()
    jtuning.reset_cache()
    yield
    tuning.reset_cache()
    jtuning.reset_cache()


@pytest.fixture(autouse=True)
def jax_done_on_completion(monkeypatch):
    """JAX futures' done(): block until the dispatch's arrays are ready
    (the port's CPU dispatches are complete on return)."""
    import jax

    from matvec_mpi_multiplier_tpu.engine import core as jcore

    def done(self):
        jax.block_until_ready([arr for arr, *_ in self._parts])
        return True

    def solver_done(self):
        if self._res is not None:
            jax.block_until_ready(self._res.x)
        return True

    monkeypatch.setattr(jcore.MatvecFuture, "done", done)
    monkeypatch.setattr(jcore.SolverFuture, "done", solver_done)


def _fields(flops=1e9, mem_bps=1e9, alpha=1e-4, beta=1e9, p=8):
    return dict(flops=flops, mem_bps=mem_bps,
                alpha_s={"collective": alpha, "permute": alpha},
                beta_bps={"collective": beta, "permute": beta},
                p=p, level="synthetic", probes={})


def _cal(**kw):
    """An explicit, deterministic calibration: ms-scale predictions for the
    64x64 test shapes."""
    return Calibration(**_fields(**kw))


def _models(**kw):
    return CostModel(_cal(**kw)), jcm.CostModel(jcm.Calibration(**_fields(**kw)))


def _matrices(n_tenants, m=64, k=64, seed=0, same_payload=False):
    rng = np.random.default_rng(seed)
    shared = rng.standard_normal((m, k)).astype(np.float32)
    return [shared if same_payload else rng.standard_normal((m, k)).astype(np.float32)
            for _ in range(n_tenants)]


def _registries(mesh, jmesh, n_tenants=3, seed=0, same_payload=False, clock=None,
                **kwargs):
    """The same seeded tenants in both packages' registries; ``clock`` (a
    one-element list) drives both packages' demand estimators."""
    mats = _matrices(n_tenants, seed=seed, same_payload=same_payload)
    reg = MatrixRegistry(mesh, strategy="rowwise", promote=None, **kwargs)
    jkw = dict(kwargs)
    if clock is not None:
        reg._clock = lambda: clock[0]
        jkw["rate_clock"] = lambda: clock[0]
    jreg = JMatrixRegistry(jmesh, strategy="rowwise", promote=None, **jkw)
    for i, a in enumerate(mats):
        reg.register(f"t{i}", torch.from_numpy(a))
        jreg.register(f"t{i}", a)
    return reg, jreg


def _schedulers(reg, jreg, model=True, clock=None, **kwargs):
    t = clock if clock is not None else [0.0]
    gs = GlobalScheduler(reg, cost_model=_models()[0] if model is True else model,
                         **kwargs)
    gs._clock = lambda: t[0]
    jmodel = _models()[1] if model is True else (
        None if model is None else jcm.CostModel(jcm.Calibration(
            **{f: getattr(model.calibration, f)
               for f in ("flops", "mem_bps", "alpha_s", "beta_bps", "p", "level",
                         "probes")})))
    jgs = JGlobalScheduler(jreg, cost_model=jmodel, clock=lambda: t[0], **kwargs)
    return gs, jgs


def _trace(gs):
    """The decision ring without its timestamps and process-unique ids."""
    skip = ("t_s", "request_id", "cause_id", "members")
    return [{f: v for f, v in d.items() if f not in skip} for d in gs.decisions()]


def _close(*things):
    for thing in things:
        thing.close()


def _result(fut):
    y = fut.result()
    return y.numpy() if isinstance(y, torch.Tensor) else np.asarray(y)


# ------------------------------------------------------- admission matrix


@pytest.mark.parametrize(
    "calibrated,deadline_ms,queue_s,expect_reject",
    [
        (True, 1e-4, 0.0, True),     # tight, empty queue: dispatch alone misses
        (True, 1e7, 0.0, False),     # loose, empty queue: admitted
        (True, 1e7, 1e6, True),      # loose, deep queue: backlog misses it
        (True, None, 1e6, False),    # no deadline: never rejected
        (False, 1e-4, 0.0, False),   # uncalibrated: never rejects (greedy)
        (False, 1e7, 0.0, False),
    ],
)
def test_admission_matrix(mesh, jmesh, calibrated, deadline_ms, queue_s, expect_reject):
    reg, jreg = _registries(mesh, jmesh)
    logs, jlogs = [], []
    gs, jgs = _schedulers(reg, jreg, model=True if calibrated else None,
                          coalesce=False)
    gs._log, jgs._log = logs.append, jlogs.append
    if not calibrated:
        # The degrade notice is printed at construction: rebuild with the
        # captured sinks.
        gs = GlobalScheduler(reg, cost_model=None, log=logs.append, coalesce=False)
        jgs = JGlobalScheduler(jreg, cost_model=None, log=jlogs.append, coalesce=False)

    class _Busy:
        def done(self):
            return False

    if queue_s:
        gs._outstanding.append((_Busy(), queue_s))
        jgs._outstanding.append((_Busy(), queue_s))
    x = np.ones(64, np.float32)
    fut = gs.submit("t0", x, deadline_ms=deadline_ms)
    jfut = jgs.submit("t0", x, deadline_ms=deadline_ms)
    err, jerr = fut.exception(), jfut.exception()
    if expect_reject:
        assert isinstance(err, AdmissionRejectedError) and is_rejection(err)
        assert type(jerr).__name__ == "AdmissionRejectedError"
        with pytest.raises(AdmissionRejectedError):
            fut.result()
        last = gs.decisions()[-1]
        assert last["decision"] == "reject" and last["predicted_s"] > 0
        assert "predicted eta" in last["reason"]
        if queue_s:
            assert last["queue_s"] >= queue_s
    else:
        gs.flush()
        jgs.flush()
        if not calibrated and deadline_ms is not None and deadline_ms < 1:
            # Greedy hands the deadline to the engine's own gate.
            assert isinstance(fut.exception(), DeadlineExceededError)
            assert not is_rejection(fut.exception())
            assert type(jfut.exception()).__name__ == "DeadlineExceededError"
        else:
            y = _result(fut)
            assert np.array_equal(y, reg._entry("t0").engine.submit(x).result().numpy())
            np.testing.assert_allclose(y, np.asarray(jfut.result()), rtol=1e-5, atol=1e-5)
        admits = [d for d in gs.decisions() if d["decision"] == "admit"]
        assert admits and "reason" in admits[-1] and "predicted_s" in admits[-1]
    assert _trace(gs) == _trace(jgs)
    assert len(logs) == len(jlogs) == (0 if calibrated else 1)
    if not calibrated:
        assert "uncalibrated" in logs[0]
    _close(gs, jgs, reg, jreg)


def test_cold_cache_degrades_to_greedy(mesh, jmesh):
    """cost_model='auto' over an empty tuning cache degrades to greedy: one
    warning, no rejects, the deadline handed to the engine's own gate."""
    reg, jreg = _registries(mesh, jmesh)
    logs, jlogs = [], []
    gs = GlobalScheduler(reg, cost_model="auto", log=logs.append)
    jgs = JGlobalScheduler(jreg, cost_model="auto", log=jlogs.append)
    assert gs.model is None and jgs.model is None
    assert len(logs) == 1 and "uncalibrated" in logs[0] and len(jlogs) == 1
    assert reg.metrics.gauge("gsched_degraded_greedy").value == 1
    x = np.ones(64, np.float32)
    assert gs.submit("t0", x, deadline_ms=1e6).result().shape == (64,)
    stale = gs.submit("t0", x, deadline_ms=-1.0)
    assert isinstance(stale.exception(), DeadlineExceededError)
    assert not is_rejection(stale.exception())
    assert reg.metrics.counter("gsched_rejects_total").value == 0
    jgs.submit("t0", x, deadline_ms=1e6).result()
    jgs.submit("t0", x, deadline_ms=-1.0)
    for d in gs.decisions():
        assert d["predicted_s"] is None and "greedy" in d["reason"]
    assert _trace(gs) == _trace(jgs)
    _close(gs, jgs, reg, jreg)


def test_queue_aware_estimate_composes():
    est = AdmissionEstimate(dispatch_s=0.5, queue_s=2.0, swap_s=0.25)
    assert est.eta_s == pytest.approx(2.75)
    model, jmodel = _models(mem_bps=2e9)
    assert model.restore_s(2 ** 31) == jmodel.restore_s(2 ** 31) == 2 ** 31 / 2e9
    kw = dict(m=64, k=64, p=8, dtype="float32", queue_s=1.0, swap_bytes=2 * 10 ** 9)
    adm = model.predict_admission("rowwise", "gather", **kw)
    jadm = jmodel.predict_admission("rowwise", "gather", **kw)
    assert (adm.dispatch_s, adm.queue_s, adm.swap_s, adm.eta_s) == (
        jadm.dispatch_s, jadm.queue_s, jadm.swap_s, jadm.eta_s)
    solo = model.predict("rowwise", "gather", m=64, k=64, p=8, dtype="float32")
    assert adm.dispatch_s == pytest.approx(solo.total_s)
    assert adm.swap_s == pytest.approx(1.0)
    assert adm.eta_s == pytest.approx(1.0 + 1.0 + solo.total_s)


def test_prediction_config_routes_promotion(mesh, jmesh):
    a = np.random.default_rng(0).standard_normal((64, 64)).astype(np.float32)
    engine = MatvecEngine(torch.from_numpy(a), mesh, strategy="rowwise", promote=4,
                          max_bucket=8)
    jengine = JMatvecEngine(a, jmesh, strategy="rowwise", promote=4, max_bucket=8)
    for b in (1, 3, 4, 6, 8):
        assert engine.prediction_config(b) == jengine.prediction_config(b)
        assert engine.prediction_config(b, rtol=1e-3) == jengine.prediction_config(b)
    one = engine.prediction_config(1)
    assert one["b"] == 1 and one["combine"] == "gather"
    assert one["strategy"] == "rowwise" and one["p"] == 8
    assert engine.prediction_config(6)["b"] == 8  # bucket-padded GEMM path
    assert engine.prediction_config(3)["b"] == 1  # per-column path
    _close(engine, jengine)


# ----------------------------------------------------------- interleaving


def test_interleave_swap_in_enqueued_before_long_dispatch(mesh, jmesh):
    """Ahead of a predicted-long dispatch the hottest evicted tenant is
    swapped in first: decision order pinned (interleave before flush), the
    same trace as the JAX package's."""
    t = [0.0]
    reg, jreg = _registries(mesh, jmesh, hbm_budget=2 * 64 * 64 * 4, clock=t)
    slow = dict(flops=1e3, mem_bps=1e9, beta=1e3)
    gs, jgs = _schedulers(reg, jreg, model=CostModel(_cal(**slow)), clock=t)
    x = np.ones(64, np.float32)
    for r in (reg, jreg):
        r.submit("t0", x).result()
        r.submit("t1", x).result()
    assert not reg._entry("t2").engine.resident
    for _ in range(5):
        t[0] += 0.01
        reg.observe_demand("t2")
        jreg.observe_demand("t2")
    assert reg.demand_rate("t2") == jreg.demand_rate("t2") > 0
    for g in (gs, jgs):
        fut = g.submit("t0", x)
        g.flush()
        fut.result()
    kinds = [d["decision"] for d in gs.decisions()]
    inter = next(d for d in gs.decisions() if d["decision"] == "interleave")
    assert inter["tenant"] == "t2" and inter["under"] == "t0"
    assert inter["predicted_s"] > 0
    assert kinds.index("interleave") < kinds.index("flush")
    assert reg._entry("t2").engine.resident
    assert reg.metrics.counter("gsched_interleaves_total").value == 1
    assert reg.metrics.counter("registry_prefetches_total").value == 1
    assert _trace(gs) == _trace(jgs)
    _close(gs, jgs, reg, jreg)


# ------------------------------------------------- cross-tenant coalescing


def test_cross_tenant_coalescing_same_payload_bitwise(mesh, jmesh):
    reg, jreg = _registries(mesh, jmesh, n_tenants=2, same_payload=True)
    assert reg.coalesce_group("t0") == reg.coalesce_group("t1")
    gs, jgs = _schedulers(reg, jreg)
    rng = np.random.default_rng(7)
    x0 = rng.standard_normal(64).astype(np.float32)
    x1 = rng.standard_normal(64).astype(np.float32)
    ref0 = reg._entry("t0").engine.submit(x0).result().numpy()
    ref1 = reg._entry("t1").engine.submit(x1).result().numpy()
    jreg._entry("t0").engine(x0), jreg._entry("t1").engine(x1)
    f0, f1 = gs.submit("t0", x0), gs.submit("t1", x1)
    j0, j1 = jgs.submit("t0", x0), jgs.submit("t1", x1)
    assert gs.flush() == jgs.flush() == 2
    assert np.array_equal(_result(f0), ref0) and np.array_equal(_result(f1), ref1)
    np.testing.assert_allclose(_result(f0), np.asarray(j0.result()), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_result(f1), np.asarray(j1.result()), rtol=1e-5, atol=1e-5)
    assert reg.metrics.counter("sched_cross_tenant_coalesced_total").value == 2
    flushes = [d for d in gs.decisions() if d["decision"] == "flush"]
    assert len(flushes) == 1 and flushes[0]["n_requests"] == 2
    assert "other tenants" in flushes[0]["reason"]
    assert _trace(gs) == _trace(jgs)
    _close(gs, jgs, reg, jreg)


def test_different_payloads_never_share_a_flush(mesh, jmesh):
    reg, jreg = _registries(mesh, jmesh, n_tenants=2)
    assert reg.coalesce_group("t0") != reg.coalesce_group("t1")
    gs, jgs = _schedulers(reg, jreg)
    x = np.ones(64, np.float32)
    for g in (gs, jgs):
        f0, f1 = g.submit("t0", x), g.submit("t1", x)
        g.flush()
        f0.result(), f1.result()
    assert reg.metrics.counter("sched_cross_tenant_coalesced_total").value == 0
    assert reg.metrics.counter("gsched_flushes_total").value == 2
    assert _trace(gs) == _trace(jgs)
    _close(gs, jgs, reg, jreg)


# ------------------------------------------------------------ A/B exactness


def test_ab_exactness_same_trace_bitwise(mesh, jmesh):
    """Scheduling on vs off: bitwise the same results request for request;
    the scheduled run's decisions are the JAX package's."""
    rng = np.random.default_rng(3)
    trace = [(f"t{rng.integers(0, 3)}", rng.standard_normal(64).astype(np.float32))
             for _ in range(24)]
    reg_off = MatrixRegistry(mesh, strategy="rowwise", promote=None,
                             hbm_budget=2 * 64 * 64 * 4)
    for i, a in enumerate(_matrices(3, seed=11)):
        reg_off.register(f"t{i}", torch.from_numpy(a))
    baseline = [reg_off.submit(tid, x) for tid, x in trace]
    baseline = [_result(f) for f in baseline]
    reg_off.close()

    t = [0.0]
    reg, jreg = _registries(mesh, jmesh, seed=11, hbm_budget=2 * 64 * 64 * 4,
                            demand_weight=2.0, clock=t)
    gs, jgs = _schedulers(reg, jreg, clock=t)
    scheduled = [gs.submit(tid, x) for tid, x in trace]
    gs.flush()
    scheduled = [_result(f) for f in scheduled]
    jscheduled = [jgs.submit(tid, x) for tid, x in trace]
    jgs.flush()
    jscheduled = [np.asarray(f.result()) for f in jscheduled]
    for i, (b, s, j) in enumerate(zip(baseline, scheduled, jscheduled)):
        assert np.array_equal(b, s), f"request {i} diverged bitwise"
        np.testing.assert_allclose(s, j, rtol=1e-5, atol=1e-5)
    assert _trace(gs) == _trace(jgs)
    _close(gs, jgs, reg, jreg)


# ------------------------------------------------- demand-aware eviction


def test_demand_aware_eviction_protects_hot_tenant(mesh, jmesh):
    def run(demand_weight):
        t = [0.0]
        victims = []
        for package in ("port", "jax"):
            reg, jreg = _registries(mesh, jmesh, hbm_budget=2 * 64 * 64 * 4,
                                    demand_weight=demand_weight, clock=t)
            t[0] = 0.0
            r = reg if package == "port" else jreg
            x = np.ones(64, np.float32)
            r.submit("t0", x).result()   # older, but hot demand
            r.submit("t1", x).result()   # newer, idle
            for _ in range(50):
                t[0] += 0.01
                r.observe_demand("t0")
            r.submit("t2", x).result()   # needs a victim
            evicted = [tid for tid, s in r.health()["tenants"].items()
                       if not s["resident"]]
            assert len(evicted) == 1
            victims.append(evicted[0])
            _close(reg, jreg)
        assert victims[0] == victims[1]
        return victims[0]

    assert run(demand_weight=0.0) == "t0"     # pure recency: oldest loses
    assert run(demand_weight=1000.0) == "t1"  # demand protects t0


# -------------------------------------------- accounting & observability


def test_rejected_is_not_failed_in_availability():
    kw = dict(tenant="t0", requests=10, hits=5, evictions=0, evictions_caused=0,
              quota_rejections=0, failed_requests=2, rejected=3, resident_bytes=0,
              pinned=0)
    row, jrow = serve.TenantRow(**kw), jax_serve.TenantRow(**kw)
    assert row.availability == jrow.availability == pytest.approx(0.8)
    assert row.served_rate == jrow.served_rate == pytest.approx(0.5)
    assert is_rejection(AdmissionRejectedError("x"))
    assert not is_rejection(DeadlineExceededError("x"))


def test_decisions_carry_predicted_s_and_reason_and_jsonl(mesh, jmesh, tmp_path):
    path, jpath = tmp_path / "decisions.jsonl", tmp_path / "jax.jsonl"
    reg, jreg = _registries(mesh, jmesh, n_tenants=2, hbm_budget=1 * 64 * 64 * 4)
    gs = GlobalScheduler(reg, cost_model=_models()[0], decision_jsonl=path)
    jgs = JGlobalScheduler(jreg, cost_model=_models()[1], decision_jsonl=jpath,
                           clock=lambda: 0.0)
    gs._clock = lambda: 0.0
    x = np.ones(64, np.float32)
    for g in (gs, jgs):
        g.submit("t0", x).result()
        g.submit("t1", x).result()       # forces an eviction decision too
        g.submit("t0", x, deadline_ms=1e-5)  # a reject
    ring = gs.decisions()
    assert {"admit", "flush", "reject", "evict"} <= {d["decision"] for d in ring}
    for d in ring:
        assert "predicted_s" in d and "reason" in d and "tenant" in d
        if d["decision"] != "flush":
            assert d["predicted_s"] is None or d["predicted_s"] >= 0
    assert _trace(gs) == _trace(jgs)
    _close(gs, jgs, reg, jreg)
    lines = [json.loads(ln) for ln in path.read_text().splitlines()]
    assert [d["decision"] for d in lines] == [d["decision"] for d in ring]
    assert [d["decision"] for d in lines] == [
        json.loads(ln)["decision"] for ln in jpath.read_text().splitlines()]
    snap = reg.metrics.snapshot()["counters"]
    assert snap["gsched_decisions_total"] == len(ring)
    assert snap["gsched_admits_total"] + snap["gsched_rejects_total"] == 3


def test_gsched_obs_panel_renders(mesh, jmesh):
    from matvec_mpi_multiplier_tpu.obs.__main__ import render_gsched as jrender
    from matvec_mpi_multiplier_torch.obs.__main__ import render_gsched, render_metrics

    assert render_gsched({"counters": {}}) is None
    reg, jreg = _registries(mesh, jmesh, n_tenants=2)
    gs, jgs = _schedulers(reg, jreg)
    x = np.ones(64, np.float32)
    gs.submit("t0", x).result()
    gs.submit("t0", x, deadline_ms=1e-5)
    snap = reg.metrics.snapshot()
    panel = render_gsched(snap)
    assert panel is not None and panel.startswith("global scheduler:")
    assert "rejects" in panel and "rejected != failed" in panel
    assert "global scheduler:" in render_metrics(snap)
    assert panel == jrender(snap)
    _close(gs, jgs, reg, jreg)


def test_submit_validation_and_close(mesh, jmesh):
    reg, jreg = _registries(mesh, jmesh, n_tenants=1)
    gs, jgs = _schedulers(reg, jreg)
    with pytest.raises(ConfigError, match="request must be"):
        gs.submit("t0", np.ones(63, np.float32))
    with pytest.raises(ConfigError, match="QoS"):
        gs.submit("t0", np.ones(64, np.float32), qos="nope")
    with pytest.raises(ConfigError, match="unknown tenant"):
        gs.submit("t9", np.ones(64, np.float32))
    with pytest.raises(ConfigError):
        GlobalScheduler(reg, cost_model=None, deadline_margin=0.0, log=lambda _line: None)
    gs.close()
    gs.close()  # a second close is a no-op
    with pytest.raises(ConfigError, match="closed"):
        gs.submit("t0", np.ones(64, np.float32))
    _close(jgs, reg, jreg)


# ------------------------------------------------------- bench integration


def _calibrate_cache(p=8):
    """The explicit calibration in both packages' tuning caches (the bench
    builds its scheduler with cost_model='auto')."""
    from matvec_mpi_multiplier_tpu import tuning as jtuning
    from matvec_mpi_multiplier_tpu.tuning import cache as jcache
    from matvec_mpi_multiplier_torch import tuning
    from matvec_mpi_multiplier_torch.tuning.cache import TuningCache, calibration_key

    cache = TuningCache.load()
    cache.record(calibration_key(p), _cal(p=p).to_record())
    cache.record(jcache.calibration_key(p, jcache.platform_fingerprint()),
                 _cal(p=p).to_record())
    cache.save()
    tuning.reset_cache()
    jtuning.reset_cache()


def test_multitenant_bench_ab_overlay_and_csv(mesh, jmesh, tmp_path, monkeypatch):
    """The --global-sched A/B through the bench body: greedy vs scheduled on
    the same seed, the rejected/expires split in the right columns, no
    engine-gate expiry with scheduling on, the CSV round trip; and, on the
    deadline-free trace, every CSV cell equal to the JAX bench's except the
    timed ones."""
    from matvec_mpi_multiplier_tpu.bench.metrics import read_csv

    _calibrate_cache()
    common = dict(n_tenants=3, zipf_a=1.1, hbm_budget="2x", n_requests=30, seed=0,
                  deadline_ms=2.0, rate=4000.0, max_in_flight=2)
    off = serve.run_serve_multitenant("rowwise", mesh, 64, 64, **common)
    on = serve.run_serve_multitenant(
        "rowwise", mesh, 64, 64, global_sched=True, demand_weight=2.0,
        decision_jsonl=str(tmp_path / "d.jsonl"), **common)
    assert not off.global_sched and on.global_sched
    assert off.rows[-1].rejected == 0
    assert on.deadline_expires == 0
    assert on.rows[-1].failed_requests == 0
    assert 30 - on.rows[-1].rejected >= 1
    if on.rows[-1].rejected:
        assert (tmp_path / "d.jsonl").exists()
    for result in (off, on):
        serve.append_multitenant_result(result, root=tmp_path)
    rows = read_csv(tmp_path / "out" / "serve_tenants_rowwise.csv")
    all_rows = [r for r in rows if r["tenant"] == "ALL"]
    assert sorted(r["global_sched"] for r in all_rows) == [0, 1]
    sched_row = next(r for r in all_rows if r["global_sched"] == 1)
    assert sched_row["rejected"] == on.rows[-1].rejected
    assert sched_row["deadline_expires"] == 0
    assert sched_row["on_time"] == on.on_time

    # Cell for cell against the JAX bench on the deadline-free trace (a
    # calibration whose restores predict far longer than any dispatch, so
    # no swap-in is interleaved on wall-clock demand).
    free = dict(n_tenants=3, zipf_a=1.1, hbm_budget="2x", n_requests=30,
                       seed=0, global_sched=True)
    from matvec_mpi_multiplier_tpu import tuning as jtuning
    from matvec_mpi_multiplier_torch import tuning

    monkeypatch.setenv("MATVEC_TUNING_CACHE", str(tmp_path / "slow_restore.json"))
    tuning.reset_cache()
    jtuning.reset_cache()
    from matvec_mpi_multiplier_tpu.tuning import cache as jcache
    from matvec_mpi_multiplier_torch.tuning.cache import TuningCache, calibration_key

    cache = TuningCache.load()
    slow = Calibration(**_fields(mem_bps=1e3))
    cache.record(calibration_key(8), slow.to_record())
    cache.record(jcache.calibration_key(8, jcache.platform_fingerprint()),
                 slow.to_record())
    cache.save()
    port = serve.run_serve_multitenant("rowwise", mesh, 64, 64, **free)
    jax = jax_serve.run_serve_multitenant("rowwise", jmesh, 64, 64, **free)
    serve.append_multitenant_result(port, root=tmp_path / "p")
    jax_serve.append_multitenant_result(jax, root=tmp_path / "j")
    timed = {"wall_s", "rps"}
    prow = read_csv(tmp_path / "p" / "out" / "serve_tenants_rowwise.csv")
    jrow = read_csv(tmp_path / "j" / "out" / "serve_tenants_rowwise.csv")
    assert len(prow) == len(jrow) == 4
    for p_, j_ in zip(prow, jrow):
        for col in p_:
            if col in timed:
                continue
            pv, jv = p_[col], j_[col]
            if isinstance(pv, float) and pv != pv:
                assert jv != jv, col
            else:
                assert pv == jv, (col, pv, jv)


def test_serve_cli_accepts_gsched_and_prune_flags():
    from matvec_mpi_multiplier_tpu.bench.serve import build_parser as jparser

    argv = ["--tenants", "3", "--global-sched", "both", "--deadline-ms", "10",
            "--max-in-flight", "4", "--demand-weight", "1.5",
            "--decision-jsonl", "d.jsonl", "--tune", "--prune-margin", "0.5",
            "--reshard", "auto"]
    args = serve.build_parser().parse_args(argv)
    jargs = jparser().parse_args(argv)
    for name in ("global_sched", "deadline_ms", "max_in_flight", "demand_weight",
                 "decision_jsonl", "prune_margin", "reshard"):
        assert getattr(args, name) == getattr(jargs, name), name
    assert serve.build_parser().parse_args([]).demand_weight == 2.0
    with pytest.raises(SystemExit):
        serve.build_parser().parse_args(["--global-sched", "maybe"])


# ------------------------------------------------------ solver admission


def _spd_registries(mesh, jmesh, n_tenants=2, n=64):
    reg = MatrixRegistry(mesh, strategy="rowwise", promote=None)
    jreg = JMatrixRegistry(jmesh, strategy="rowwise", promote=None)
    for i in range(n_tenants):
        a = jax_serve.solver_operand(n, "float32", seed=i)
        assert np.array_equal(serve.solver_operand(n, "float32", i), a)
        reg.register(f"t{i}", torch.from_numpy(np.asarray(a)))
        jreg.register(f"t{i}", a)
    return reg, jreg


def test_solver_admit_carries_op_and_predicted_s(mesh, jmesh):
    reg, jreg = _spd_registries(mesh, jmesh)
    gs, jgs = _schedulers(reg, jreg, coalesce=False)
    b = np.ones(64, np.float32)
    res = gs.submit("t0", deadline_ms=1e7, op="cg", rhs=b, rtol=1e-5).result()
    jgs.submit("t0", deadline_ms=1e7, op="cg", rhs=b, rtol=1e-5).result()
    assert res.converged
    last = gs.decisions()[-1]
    assert last["decision"] == "admit" and last["op"] == "cg"
    assert last["predicted_s"] is not None and last["predicted_s"] > 0
    assert "maxiter" in last["reason"]
    matvec_s = gs.model.predict("rowwise", "gather", m=64, k=64, p=8,
                                dtype="float32").total_s
    assert last["predicted_s"] > 10 * matvec_s
    assert _trace(gs) == _trace(jgs)
    _close(gs, jgs, reg, jreg)


def test_solver_tight_deadline_rejects_typed_with_op(mesh, jmesh):
    reg, jreg = _spd_registries(mesh, jmesh)
    gs, jgs = _schedulers(reg, jreg, coalesce=False)
    fut = gs.submit("t0", deadline_ms=1e-4, op="cg", rhs=np.ones(64, np.float32))
    jgs.submit("t0", deadline_ms=1e-4, op="cg", rhs=np.ones(64, np.float32))
    err = fut.exception()
    assert isinstance(err, AdmissionRejectedError) and is_rejection(err)
    last = gs.decisions()[-1]
    assert last["decision"] == "reject" and last["op"] == "cg"
    assert "predicted cg eta" in last["reason"] and last["predicted_s"] > 0
    assert _trace(gs) == _trace(jgs)
    _close(gs, jgs, reg, jreg)


def test_solver_greedy_admits_without_prediction(mesh, jmesh):
    logs = []
    reg, jreg = _spd_registries(mesh, jmesh)
    gs = GlobalScheduler(reg, cost_model=None, log=logs.append, coalesce=False)
    jgs = JGlobalScheduler(jreg, cost_model=None, log=lambda _l: None, coalesce=False)
    res = gs.submit("t1", op="cg", rhs=np.ones(64, np.float32), rtol=1e-5).result()
    jgs.submit("t1", op="cg", rhs=np.ones(64, np.float32), rtol=1e-5).result()
    assert res.converged
    last = gs.decisions()[-1]
    assert last["decision"] == "admit" and last["op"] == "cg"
    assert last["predicted_s"] is None and "greedy" in last["reason"]
    assert logs and "uncalibrated" in logs[0]
    assert _trace(gs) == _trace(jgs)
    _close(gs, jgs, reg, jreg)


# ------------------------------------------------- the reshard trigger


def test_predict_reshard_sanity():
    from matvec_mpi_multiplier_tpu.tuning.cost_model import Calibration as JCal

    model = CostModel(Calibration.synthetic(p=8))
    jmodel = jcm.CostModel(JCal(**Calibration.synthetic(p=8).to_record()))
    kw = dict(m=256, k=512, p=8, dtype="float32")
    one = model.predict_reshard("rowwise", "colwise", **kw)
    two = model.predict_reshard("colwise", "blockwise", **kw)
    assert 0 < one.total_s < two.total_s and one.compute_s == 0.0
    big = model.predict_reshard("rowwise", "colwise", m=256, k=4 * 512, p=8,
                                dtype="float32")
    assert big.wire_bytes == 4 * one.wire_bytes
    for src in ("rowwise", "colwise", "blockwise"):
        for dst in ("rowwise", "colwise", "blockwise"):
            assert (vars(model.predict_reshard(src, dst, **kw))
                    == vars(jmodel.predict_reshard(src, dst, **kw)))


def test_scheduler_auto_reshard_crossover(mesh, jmesh):
    """reshard='auto' migrates a hot tenant out of a predicted-slow layout
    exactly once, records the traced decision with its crossover
    arithmetic, and the migrated engine serves bitwise what a fresh engine
    of the destination layout serves — the same decisions as the JAX
    package's."""
    from matvec_mpi_multiplier_torch.models import get_strategy
    from matvec_mpi_multiplier_torch.parallel.reshard import RESHARD_STRATEGIES

    rng = np.random.default_rng(5)
    a = rng.uniform(0, 1, (256, 512)).astype(np.float32)
    x = rng.uniform(0, 1, 512).astype(np.float32)
    model = CostModel(Calibration.synthetic(p=8))
    jmodel = jcm.CostModel(jcm.Calibration(**Calibration.synthetic(p=8).to_record()))
    times = {s: model.predict(s, get_strategy(s).default_combine(mesh), m=256, k=512,
                              p=8, dtype="float32", b=1).total_s
             for s in RESHARD_STRATEGIES}
    worst = max(times, key=times.get)
    clock = [0.0]
    scheds = []
    for package in ("port", "jax"):
        if package == "port":
            reg = MatrixRegistry(mesh)
            reg.register("hot", torch.from_numpy(a), strategy=worst)
            reg._clock = lambda: clock[0]
            sched = GlobalScheduler(reg, cost_model=model, reshard="auto",
                                    reshard_cooldown_s=300.0, reshard_horizon_s=30.0)
            sched._clock = lambda: clock[0]
        else:
            reg = JMatrixRegistry(mesh=jmesh, rate_clock=lambda: clock[0])
            reg.register("hot", a, strategy=worst)
            sched = JGlobalScheduler(reg, cost_model=jmodel, reshard="auto",
                                     reshard_cooldown_s=300.0, reshard_horizon_s=30.0,
                                     clock=lambda: clock[0])
        clock[0] = 0.0
        for _ in range(25):
            clock[0] += 0.01
            sched.submit("hot", x).result()
        scheds.append((reg, sched))
    (reg, sched), (jreg, jsched) = scheds
    decisions = [d for d in sched.decisions() if d["decision"] == "reshard"]
    assert len(decisions) == 1, decisions
    d = decisions[0]
    assert d["src"] == worst and d["dst"] != worst
    assert d["predicted_s"] > 0 and d["new_s"] < d["old_s"]
    assert "crossover" in d["reason"]
    assert _trace(sched) == _trace(jsched)
    eng = reg._entry("hot").engine
    assert eng.strategy.name == d["dst"]
    fresh = MatvecEngine(torch.from_numpy(a), mesh, strategy=d["dst"])
    assert torch.equal(sched.submit("hot", x).result(), fresh.submit(x).result())
    _close(sched, jsched, reg, jreg, fresh)


def test_scheduler_reshard_off_never_migrates(mesh, jmesh):
    a = np.random.default_rng(6).uniform(0, 1, (256, 512)).astype(np.float32)
    x = np.ones(512, np.float32)
    reg = MatrixRegistry(mesh)
    reg.register("t", torch.from_numpy(a), strategy="blockwise")
    sched = GlobalScheduler(reg, cost_model=CostModel(Calibration.synthetic(p=8)))
    for _ in range(10):
        sched.submit("t", x).result()
    assert not [d for d in sched.decisions() if d["decision"] == "reshard"]
    assert reg._entry("t").engine.strategy.name == "blockwise"
    with pytest.raises(ConfigError):
        GlobalScheduler(reg, cost_model=None, reshard="sometimes")
    _close(sched, reg)


def test_reshard_drift_migrates_and_serves_bitwise(mesh, tmp_path):
    """run_reshard_drift with reshard='auto': the fleet registered in the
    predicted-worst layout for the steady shape migrates during the skip,
    every migration is in the decision file with its crossover arithmetic,
    and 'off' never migrates."""
    from matvec_mpi_multiplier_torch import tuning
    from matvec_mpi_multiplier_torch.models import get_strategy
    from matvec_mpi_multiplier_torch.tuning.cache import TuningCache, calibration_key

    model = CostModel(Calibration.synthetic(p=8))
    cache = TuningCache.load()
    cache.record(calibration_key(8), Calibration.synthetic(p=8).to_record())
    cache.save()
    tuning.reset_cache()
    times = {s: model.predict(s, get_strategy(s).default_combine(mesh), m=64, k=64,
                              p=8, dtype="float32", b=8).total_s
             for s in ("rowwise", "colwise", "blockwise")}
    worst = max(times, key=times.get)
    kw = dict(n_tenants=2, n_requests=40, rollover=4, steady_skip=16, pre_rate=0.0,
              width_steady=8, reshard_horizon_s=30.0, rate_tau_s=5.0)
    path = tmp_path / "drift.jsonl"
    auto = serve.run_reshard_drift(worst, mesh, 64, 64, reshard="auto",
                                   decision_jsonl=str(path), **kw)
    off = serve.run_reshard_drift(worst, mesh, 64, 64, reshard="off", **kw)
    assert auto["reshards"] >= 1 and off["reshards"] == 0
    assert 0 <= auto["last_reshard_at"] < kw["rollover"] + kw["steady_skip"]
    assert set(off["final_strategies"].values()) == {worst}
    assert worst not in set(auto["final_strategies"].values())
    lines = [json.loads(ln) for ln in path.read_text().splitlines()]
    migrations = [d for d in lines if d["decision"] == "reshard"]
    assert len(migrations) == auto["reshards"]
    assert all("crossover" in d["reason"] and d["new_s"] < d["old_s"]
               for d in migrations)
    serve.append_reshard_result(auto, root=tmp_path)
    assert serve.RESHARD_AB_CSV_HEADER == jax_serve.RESHARD_AB_CSV_HEADER
    assert (tmp_path / "out" / "reshard_ab.csv").exists()


# --------------------------------------------- admission never measures


def test_admission_path_never_measures():
    """No timer pair, no device synchronization, no scalar read in the
    scheduler's admission and dispatch path: timing belongs to the tuner
    and the bench."""
    tree = ast.parse(inspect.getsource(gs_mod))
    forbidden = {"perf_counter", "perf_counter_ns", "synchronize", "item",
                 "calibrate", "time_matvec", "benchmark_strategy", "sleep"}
    found = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Attribute) and node.attr in forbidden:
            found.append(node.attr)
        elif isinstance(node, ast.Name) and node.id in forbidden:
            found.append(node.id)
    assert not found, found
    assert gs_mod.DECISIONS == ("admit", "reject", "interleave", "evict", "flush",
                                "reshard")
