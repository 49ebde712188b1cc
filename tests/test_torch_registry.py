"""The multi-tenant matrix registry and the engine's residency hooks:
the port's engine/registry.py and MatvecEngine.ensure_resident /
release_residency / exec_signature against the JAX package's
(tests/test_registry.py, the registry tests of tests/test_reshard.py and
tests/test_solvers.py::test_multitenant_solver_isolation), case by case.

Both packages run in-process on the conftest's 8-device CPU mesh with the
same numpy operands. Within the port, results are held BITWISE where the JAX
test asserts ``array_equal`` (re-admission, isolation, re-registration); the
two packages' results are held to fp32 1e-5 (they sum in another order).
The registry's decisions — which tenant is evicted, in what order, the
ledger's bytes, hit counts, fault tallies — are held EQUAL to the JAX
registry's on the same trace and budget.

One departure is pinned here: the JAX registry shares whole compiled
executables between same-signature tenants (one compile per key); the port
shares only the strategy's built functions, which hold no ``A``, and every
tenant builds and captures its own programs (a captured CUDA graph holds its
tenant's ``A`` address). So no tenant can replay another's program, or one
built over a released ``A``.
"""

import sys
import threading

import numpy as np
import pytest
import torch

import matvec_mpi_multiplier_tpu as mv_jax
from matvec_mpi_multiplier_tpu.bench.serve import lru_hit_floor as jax_lru_hit_floor
from matvec_mpi_multiplier_tpu.resilience import FaultPlan as JaxFaultPlan
from matvec_mpi_multiplier_tpu.resilience import FaultSpec as JaxFaultSpec
from matvec_mpi_multiplier_tpu.resilience import ResiliencePolicy as JaxPolicy
from matvec_mpi_multiplier_tpu.resilience import RetryPolicy as JaxRetry
from matvec_mpi_multiplier_torch import MatrixRegistry, TenantHandle, TenantQuota
from matvec_mpi_multiplier_torch.bench.serve import lru_hit_floor, solver_operand
from matvec_mpi_multiplier_torch.engine import MatvecEngine, registry as registry_mod
from matvec_mpi_multiplier_torch.engine.core import _EagerProgram
from matvec_mpi_multiplier_torch.engine.executables import ExecutableCache
from matvec_mpi_multiplier_torch.obs.__main__ import render_metrics, render_tenants
from matvec_mpi_multiplier_torch.parallel import reshard as reshard_mod
from matvec_mpi_multiplier_torch.parallel.mesh import make_mesh
from matvec_mpi_multiplier_torch.resilience import (
    FaultPlan,
    FaultSpec,
    ResiliencePolicy,
    RetryPolicy,
)
from matvec_mpi_multiplier_torch.utils.errors import (
    ConfigError,
    ResidencyError,
    SolverDivergedError,
    TenantQuotaError,
)

CPU = torch.device("cpu")
M = K = 64
PAYLOAD = M * K * 4  # float32
FP32 = dict(rtol=1e-5, atol=1e-5)


def port_mesh(p=8):
    return make_mesh(p, devices=[CPU] * p)


@pytest.fixture(scope="module")
def jax_mesh(devices):
    return mv_jax.make_mesh(8)


def _mats(n, seed=0):
    rng = np.random.default_rng(seed)
    return {f"t{i}": rng.standard_normal((M, K)).astype(np.float32) for i in range(n)}


def _x(seed=7):
    return np.random.default_rng(seed).standard_normal(K).astype(np.float32)


def _registry(budget_tenants=None, **kw):
    kw.setdefault("strategy", "rowwise")
    kw.setdefault("promote", None)
    budget = budget_tenants * PAYLOAD if budget_tenants else None
    return MatrixRegistry(port_mesh(), hbm_budget=budget, **kw)


def _jax_registry(mesh, budget_tenants=None, **kw):
    kw.setdefault("strategy", "rowwise")
    kw.setdefault("promote", None)
    budget = budget_tenants * PAYLOAD if budget_tenants else None
    return mv_jax.MatrixRegistry(mesh, hbm_budget=budget, **kw)


def _victims(log):
    return lambda victim, caused_by, score, restore: log.append((victim, caused_by))


# ------------------------------------------------------- eviction correctness


@pytest.mark.parametrize("strategy", ["rowwise", "colwise", "blockwise"])
def test_eviction_under_zipf_trace_is_bitwise_exact(jax_mesh, strategy):
    """Budget for 2 of 4 tenants and a Zipf trace forcing continuous
    eviction: every result bitwise the unconstrained single-tenant run's,
    hit statistics equal to the plain-LRU replay, and the same victims in
    the same order as the JAX registry on the same trace."""
    mats = _mats(4)
    xs = [_x(i) for i in range(3)]
    solo = _registry(strategy=strategy)
    ref = {}
    for tid, a in mats.items():
        handle = solo.register(tid, a)
        ref[tid] = [handle(x) for x in xs]
    solo.close()

    victims, jax_victims = [], []
    reg = _registry(2, strategy=strategy, eviction_listener=_victims(victims))
    jreg = _jax_registry(jax_mesh, 2, strategy=strategy,
                         eviction_listener=_victims(jax_victims))
    handles = {tid: reg.register(tid, a) for tid, a in mats.items()}
    jhandles = {tid: jreg.register(tid, a) for tid, a in mats.items()}
    reg.warmup(widths=[1])
    jreg.warmup(widths=[1])
    probs = np.array([1.0, 0.5, 0.25, 0.125])
    seq = np.random.default_rng(42).choice(4, size=80, p=probs / probs.sum())
    for j, t in enumerate(seq):
        tid = f"t{t}"
        y = handles[tid](xs[j % len(xs)])
        assert torch.equal(y, ref[tid][j % len(xs)]), f"request {j} ({tid}) drifted"
        np.testing.assert_allclose(y.numpy(), jhandles[tid](xs[j % len(xs)]), **FP32)
    h, jh = reg.health(), jreg.health()
    hits = sum(s["hits"] for s in h["tenants"].values())
    evictions = sum(s["evictions"] for s in h["tenants"].values())
    assert hits / len(seq) == pytest.approx(lru_hit_floor(seq, capacity=2))
    assert evictions > 0
    assert h["hbm"]["charged_bytes"] <= 2 * PAYLOAD and h["hbm"]["overshoots"] == 0
    assert victims == jax_victims and len(victims) == evictions
    for key in ("hits", "evictions", "evictions_caused", "swap_ins", "resident_bytes"):
        assert {t: s[key] for t, s in h["tenants"].items()} == \
            {t: s[key] for t, s in jh["tenants"].items()}, key
    assert h["hbm"] == jh["hbm"]
    reg.close()
    jreg.close()


def test_eviction_racing_in_flight_dispatch_is_safe():
    """Futures dispatched BEFORE an eviction materialize bitwise-correct
    results AFTER it: the release drops the operands, not the work queued
    on them."""
    mats = _mats(3)
    reg = _registry(1)
    handles = {tid: reg.register(tid, a) for tid, a in mats.items()}
    x = _x()
    futures = {tid: handles[tid].submit(x) for tid in mats}  # each evicts the last
    h = reg.health()
    assert sum(s["resident"] for s in h["tenants"].values()) == 1
    for tid, a in mats.items():
        solo = _registry()
        assert torch.equal(futures[tid].result(), solo.register(tid, a)(x))
        solo.close()
    reg.close()


def test_concurrent_submit_hammer_under_eviction():
    """8 threads × 3 tenants against a budget of 2, with a short switch
    interval: the admission lock, active-window protection and benign
    placement races serve every request bitwise with no torn bookkeeping."""
    mats = _mats(3)
    x = _x()
    solo = _registry()
    ref = {tid: solo.register(tid, a)(x) for tid, a in mats.items()}
    solo.close()
    reg = _registry(2)
    handles = {tid: reg.register(tid, a) for tid, a in mats.items()}
    reg.warmup(widths=[1])
    errors = []

    def client(seed):
        rng = np.random.default_rng(seed)
        try:
            for _ in range(25):
                tid = f"t{rng.integers(3)}"
                if not torch.equal(handles[tid](x), ref[tid]):
                    errors.append(f"{tid} drifted")
        except Exception as e:  # surfaced on the main thread
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=client, args=(s,), daemon=True) for s in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    h = reg.health()
    assert h["hbm"]["charged_bytes"] <= 3 * PAYLOAD
    assert h["hbm"]["charged_bytes"] == sum(
        reg._entry(t).engine.device_resident_bytes for t in mats)
    assert sum(s["requests"] for s in h["tenants"].values()) == 200
    reg.close()


def test_re_registration_after_unregister_is_bitwise_exact():
    mats = _mats(1)
    x = _x()
    reg = _registry()
    y0 = reg.register("t0", mats["t0"])(x)
    reg.unregister("t0")
    assert "t0" not in reg.tenant_ids()
    with pytest.raises(ConfigError):
        reg.submit("t0", x)
    assert torch.equal(reg.register("t0", mats["t0"])(x), y0)
    reg.close()


def test_cost_aware_eviction_protects_expensive_tenants(jax_mesh):
    """Heterogeneous payloads under a high cost weight: the cheap-to-restore
    tenant is evicted although the expensive one is less recent — the same
    choice as the JAX registry's."""
    rng = np.random.default_rng(0)
    big = rng.standard_normal((4 * M, K)).astype(np.float32)
    small = rng.standard_normal((M, K)).astype(np.float32)
    other = rng.standard_normal((M, K)).astype(np.float32)
    x = _x()
    out = []
    for reg in (_registry(cost_weight=10.0), _jax_registry(jax_mesh, cost_weight=10.0)):
        reg.accountant.budget = 5 * PAYLOAD  # big + small fit; + other does not
        hs = [reg.register(t, a) for t, a in (("big", big), ("small", small),
                                              ("other", other))]
        for h in hs:
            h(x)
        tenants = reg.health()["tenants"]
        out.append({t: (s["resident"], s["evictions"]) for t, s in tenants.items()})
        reg.close()
    assert out[0] == out[1]
    assert out[0]["big"] == (True, 0) and out[0]["small"] == (False, 1)


def test_pinned_tenant_never_evicted():
    mats = _mats(3)
    reg = _registry(1)
    handles = {tid: reg.register(tid, a) for tid, a in mats.items()}
    reg.pin("t0")
    x = _x()
    y0 = handles["t0"](x)
    handles["t1"](x)  # soft overshoot: the only resident tenant is pinned
    handles["t2"](x)
    h = reg.health()
    assert h["tenants"]["t0"]["resident"] and h["tenants"]["t0"]["pinned"]
    assert h["tenants"]["t0"]["evictions"] == 0
    assert h["hbm"]["overshoots"] > 0
    reg.unpin("t0")
    handles["t1"](x)
    handles["t2"](x)
    assert reg.health()["tenants"]["t0"]["evictions"] >= 1
    assert torch.equal(handles["t0"](x), y0)
    reg.close()


# ------------------------------------------------------------------ quotas


def test_quota_exceeded_fails_future_typed_and_before_dispatch():
    reg = _registry()
    handle = reg.register("t0", _mats(1)["t0"], quota=TenantQuota(max_in_flight=2))
    x = _x()
    dispatches = reg.metrics.counter("engine_dispatches_total")
    f1, f2 = handle.submit(x), handle.submit(x)
    before = dispatches.value
    f3 = handle.submit(x)
    assert isinstance(f3.exception(), TenantQuotaError)
    with pytest.raises(TenantQuotaError, match="max_in_flight=2"):
        f3.result()
    assert dispatches.value == before
    assert reg.tenant_stats("t0")["quota_rejections"] == 1
    f1.result(), f2.result()  # materializing drains the window
    assert isinstance(handle(x), torch.Tensor)
    reg.close()


def test_quota_burst_cannot_evict_neighbors():
    mats = _mats(3)
    reg = _registry(2)
    handles = {tid: reg.register(tid, a, quota=TenantQuota(max_in_flight=1)
                                 if tid == "t0" else None)
               for tid, a in mats.items()}
    x = _x()
    handles["t1"](x)
    handles["t2"](x)
    held = handles["t0"].submit(x)  # t0 admitted: evicts one neighbor
    evictions = reg.metrics.counter("registry_evictions_total").value
    rejected = [handles["t0"].submit(x) for _ in range(5)]
    assert all(isinstance(f.exception(), TenantQuotaError) for f in rejected)
    assert reg.metrics.counter("registry_evictions_total").value == evictions
    held.result()
    reg.close()


def test_register_refuses_payload_over_quota():
    reg = _registry()
    with pytest.raises(TenantQuotaError, match="over its max_resident_bytes"):
        reg.register("t0", _mats(1)["t0"],
                     quota=TenantQuota(max_resident_bytes=PAYLOAD // 2))
    assert reg.tenant_ids() == []
    reg.close()


# ---------------------------------------------------------------- isolation


def test_chaos_on_one_tenant_leaves_neighbors_at_full_availability(jax_mesh):
    """Persistent retryable faults on t0 (every ladder level) under a
    binding budget: neighbors at 100% availability and bitwise; t0 fails
    every request; the eviction count equals the admission-sequence LRU
    replay, and every count equals the JAX registry's."""
    mats = _mats(4)
    x = _x()
    solo = _registry(kernel="torch")
    ref = {tid: solo.register(tid, a)(x) for tid, a in mats.items()}
    solo.close()
    seq = np.random.default_rng(5).choice(4, size=60, p=[0.4, 0.3, 0.2, 0.1])
    outcome = []
    for make, plan_cls, spec_cls, policy in (
        # The port's torch tier is its safe tier, as "xla" is the JAX
        # package's: both ladders have one level, so the retry tallies agree.
        (lambda **kw: _registry(2, kernel="torch", **kw), FaultPlan, FaultSpec,
         ResiliencePolicy(retry=RetryPolicy(max_attempts=3, seed=3))),
        (lambda **kw: _jax_registry(jax_mesh, 2, **kw), JaxFaultPlan, JaxFaultSpec,
         JaxPolicy(retry=JaxRetry(max_attempts=3, seed=3))),
    ):
        # No backoff sleeps in a test (the port's hook is _sleep).
        setattr(policy, "_sleep" if plan_cls is FaultPlan else "sleep", lambda s: None)
        plan = plan_cls([spec_cls(site="dispatch", kind="device_error", key="t0/*")],
                        seed=3)
        reg = make(fault_plan=plan, resilience=policy)
        handles = {tid: reg.register(tid, a) for tid, a in mats.items()}
        reg.warmup(widths=[1])
        failed = {tid: 0 for tid in mats}
        for t in seq:
            tid = f"t{t}"
            try:
                y = handles[tid](x)
            except Exception:
                failed[tid] += 1
                continue
            y = y.numpy() if isinstance(y, torch.Tensor) else np.asarray(y)
            if plan_cls is FaultPlan:
                assert np.array_equal(y, ref[tid].numpy()), f"{tid} drifted"
            else:
                np.testing.assert_allclose(y, ref[tid].numpy(), **FP32)
        h = reg.health()
        outcome.append({
            "failed": failed,
            "evictions": sum(s["evictions"] for s in h["tenants"].values()),
            "retries": reg.metrics.counter("resil_retries_total").value,
            "matched": plan.summary()["specs"][0]["matched"],
        })
        reg.close()
    port, jax_side = outcome
    assert port["failed"]["t0"] == int(np.sum(seq == 0))
    assert all(port["failed"][t] == 0 for t in ("t1", "t2", "t3"))
    assert port["retries"] > 0
    resident, sim = [], 0
    for t in seq:
        if t in resident:
            resident.remove(t)
        elif len(resident) >= 2:
            resident.pop(0)
            sim += 1
        resident.append(t)
    assert port["evictions"] == sim
    assert port == jax_side


def test_fault_patterns_tenant_scoped_and_base_compat(jax_mesh):
    """``tenant/...`` patterns target one tenant; un-prefixed patterns keep
    matching EVERY tenant through the base label — the same tallies as the
    JAX registry's."""
    mats = _mats(2)
    x = _x()
    for key, failing in (("t1/*", {"t1"}), ("matvec:rowwise:*", {"t0", "t1"})):
        matched = []
        for make, plan_cls, spec_cls in (
            (lambda **kw: _registry(**kw), FaultPlan, FaultSpec),
            (lambda **kw: _jax_registry(jax_mesh, **kw), JaxFaultPlan, JaxFaultSpec),
        ):
            plan = plan_cls([spec_cls(site="dispatch", kind="device_error", key=key)],
                            seed=0)
            reg = make(fault_plan=plan)
            for tid in ("t0", "t1"):
                handle = reg.register(tid, mats[tid])
                if tid in failing:
                    with pytest.raises(Exception, match="injected device error"):
                        handle(x)
                else:
                    handle(x)
            matched.append(plan.summary()["specs"][0]["matched"])
            reg.close()
        assert matched[0] == matched[1] == len(failing)


@pytest.mark.parametrize("key,label,base", [
    ("t1/*", "t1/matvec:rowwise:cuda:default:1:float32", "matvec:rowwise:cuda:default:1:float32"),
    ("t1/*", "t0/matvec:rowwise:cuda:default:1:float32", "matvec:rowwise:cuda:default:1:float32"),
    ("gemm:*", "t0/gemm:colwise:cuda:psum:8:float32", "gemm:colwise:cuda:psum:8:float32"),
    ("gemm:*", "t0/matvec:colwise:cuda:psum:1:float32", "matvec:colwise:cuda:psum:1:float32"),
    ("*int8c", "t2/matvec:rowwise:cuda:default:1:float32:int8c",
     "matvec:rowwise:cuda:default:1:float32:int8c"),
    ("t*/gemm:*", "t3/gemm:rowwise:cuda:default:4:float32", "gemm:rowwise:cuda:default:4:float32"),
    ("gemm:*", "gemm:rowwise:cuda:default:4:float32", None),
    ("t1/*", "matvec:rowwise:cuda:default:1:float32", None),
])
def test_fault_plan_base_label_matches_jax(key, label, base):
    """``FaultPlan.check(base_label=)`` decides as the JAX package's does:
    the spec matches the prefixed label or the base label."""
    port = FaultPlan([FaultSpec(site="dispatch", kind="device_error", key=key)], seed=0)
    ref = JaxFaultPlan([JaxFaultSpec(site="dispatch", kind="device_error", key=key)], seed=0)
    got = port.check("dispatch", label, base_label=base)
    want = ref.check("dispatch", label, base_label=base)
    assert (got is None) == (want is None)
    assert port.summary()["specs"][0]["matched"] == ref.summary()["specs"][0]["matched"]


# ------------------------------------------------------------------ accounting


def test_degraded_dispatch_footprint_is_accounted():
    """The ladder's native safe tier is charged to its tenant: a degraded
    int8c tenant holds payload + native bytes, and eviction releases both.
    The JAX package's own case is a reference-side red (its quantized
    programs raise under the installed jax, ROADMAP.md queue C), so the
    bytes are held against a numpy count of the int8c layout instead:
    two int8 planes of m·k and two fp32 scale planes of m·k/block."""
    a = _mats(1)["t0"]
    x = _x()
    plan = FaultPlan([FaultSpec(site="dispatch", kind="device_error", key="*int8c",
                                retryable=False, times=1)], seed=0)
    policy = ResiliencePolicy(retry=RetryPolicy(max_attempts=1, seed=0))
    reg = _registry(fault_plan=plan, resilience=policy, dtype_storage="int8c")
    handle = reg.register("t0", a)
    y = handle(x)  # the quantized config faults once: the native safe tier serves
    assert torch.isfinite(y).all()
    block = handle.engine.storage_block
    payload = 2 * M * K * np.dtype(np.int8).itemsize + 2 * M * (K // block) * 4
    stats = reg.tenant_stats("t0")
    assert stats["payload_bytes"] == payload < a.nbytes
    assert stats["resident_bytes"] == payload + a.nbytes
    assert reg.health()["tenants"]["t0"]["native_fallback_resident"]
    assert reg.metrics.counter("registry_native_fallback_charges_total").value == 1
    released = handle.engine.release_residency()
    assert released == payload + a.nbytes
    assert reg.tenant_stats("t0")["resident_bytes"] == 0
    assert reg.health()["hbm"]["charged_bytes"] == 0
    solo = _registry(dtype_storage="int8c")
    ref = solo.register("t0", a)(x)
    solo.close()
    assert torch.equal(handle(x), ref)  # re-admitted on the healthy int8c config
    reg.close()


def test_hbm_ledger_follows_actual_placements(jax_mesh):
    mats = _mats(2)
    x = _x()
    ledgers = []
    for reg in (_registry(), _jax_registry(jax_mesh)):
        reg.register("t0", mats["t0"])
        reg.register("t1", mats["t1"])
        steps = [reg.health()["hbm"]["charged_bytes"]]  # lazy admission: 0
        reg.submit("t0", x).result()
        steps.append(reg.health()["hbm"]["charged_bytes"])
        reg.submit("t1", x).result()
        steps.append(dict(reg.health()["hbm"]["per_tenant"]))
        reg.unregister("t0")
        steps.append(reg.health()["hbm"]["charged_bytes"])
        ledgers.append(steps)
        reg.close()
    assert ledgers[0] == ledgers[1] == [0, PAYLOAD, {"t0": PAYLOAD, "t1": PAYLOAD}, PAYLOAD]


def test_ledger_equals_device_resident_bytes_after_every_step():
    """``registry_hbm_charged_bytes`` is the sum of the tenants'
    ``device_resident_bytes`` after every admission, eviction, pin and
    release."""
    mats = _mats(4)
    reg = _registry(2)
    handles = {tid: reg.register(tid, a) for tid, a in mats.items()}
    x = _x()

    def balanced():
        snap = reg.metrics.snapshot()["gauges"]
        want = sum(reg._entry(t).engine.device_resident_bytes for t in mats)
        return snap["registry_hbm_charged_bytes"] == want == reg.accountant.total

    for t in ("t0", "t1", "t2", "t3", "t1"):
        handles[t](x)
        assert balanced()
    reg.pin("t0")
    assert balanced()
    handles["t2"].engine.release_residency()
    assert balanced()
    reg.close()


# ----------------------------------------------------------------- lifecycle


def test_close_idempotent_with_failed_in_flight_futures():
    mats = _mats(3)
    plan = FaultPlan([FaultSpec(site="dispatch", kind="device_error", key="t1/*")], seed=0)
    reg = _registry(2, fault_plan=plan)
    handles = {tid: reg.register(tid, a) for tid, a in mats.items()}
    x = _x()
    ok = handles["t0"].submit(x)
    with pytest.raises(Exception, match="injected"):
        handles["t1"].submit(x)
    held = handles["t2"].submit(x)  # never materialized before close
    reg.close()
    reg.close()  # idempotent
    with pytest.raises(ConfigError):
        reg.submit("t0", x)
    with pytest.raises(ConfigError):
        reg.register("t9", mats["t0"])
    assert torch.isfinite(ok.result()).all()
    assert torch.isfinite(held.result()).all()


def test_shared_functions_build_once_capture_per_tenant(jax_mesh):
    """The JAX registry compiles once across three same-signature tenants;
    the port builds the strategy function once (the same warmup count) and
    then builds one program per tenant and key."""
    mats = _mats(3)
    x = _x()
    counts = []
    for reg in (_registry(), _jax_registry(jax_mesh)):
        for tid, a in mats.items():
            reg.register(tid, a)
        warm = reg.warmup(widths=[1])
        for tid in mats:
            reg.submit(tid, x).result()
        counts.append((warm, reg.metrics.counter("engine_compiles_total").value))
        reg.close()
    assert counts[1] == (1, 1)
    assert counts[0] == (1, 3)


def test_equal_signature_tenants_never_share_programs():
    """The port's departure, pinned: three tenants of one signature and
    different A share the function cache but not a program; each serves
    bitwise its own solo result, through a program over its own A."""
    mats = _mats(3, seed=11)
    x = _x()
    solo = {}
    for tid, a in mats.items():
        eng = MatvecEngine(a, port_mesh(), strategy="rowwise", promote=None)
        solo[tid] = eng(x)
        eng.close()
    reg = _registry()
    handles = {tid: reg.register(tid, a) for tid, a in mats.items()}
    reg.warmup(widths=[1])
    for _ in range(2):
        for tid in mats:
            assert torch.equal(handles[tid](x), solo[tid])
    engines = [handles[t].engine for t in mats]
    assert engines[0].exec_signature() == engines[1].exec_signature() == engines[2].exec_signature()
    assert engines[0]._fns is engines[1]._fns is engines[2]._fns
    programs = [e._cache._executables[e._matvec_key()] for e in engines]
    assert len({id(p) for p in programs}) == 3
    for e, p in zip(engines, programs):
        assert isinstance(p, _EagerProgram) and p.a is e._a
    reg.close()


def test_released_a_is_never_replayed():
    """A release drops every program built over the released A; the next
    dispatch places A again first and builds its program against the new
    placement, bitwise."""
    a = _mats(1)["t0"]
    x = _x()
    eng = MatvecEngine(a, port_mesh(), strategy="blockwise", promote=2, retain_host=True)
    y, yb = eng(x), eng(np.stack([x, 2 * x], axis=1))
    old_a = eng._a
    compiles = eng.stats.compiles
    eng.release_residency()
    assert len(eng._cache) == 0 and not eng.resident
    assert torch.equal(eng(x), y)
    assert torch.equal(eng(np.stack([x, 2 * x], axis=1)), yb)
    assert eng._a is not old_a and eng.stats.compiles == compiles + 2
    for program in eng._cache._executables.values():
        assert program.a is eng._a
    eng.close()


def test_exec_signature_distinguishes_callable_kernels():
    """Two different custom-kernel callables that share a __name__ must not
    share a function cache — a tenant must never run another's kernel."""
    a = _mats(1)["t0"]

    def make_kernel(scale):
        def kernel(a_blk, x_loc):
            return (a_blk * scale) @ x_loc
        return kernel

    reg = _registry()
    e1 = reg.register("t1", a, kernel=make_kernel(1.0)).engine
    e2 = reg.register("t2", a, kernel=make_kernel(2.0)).engine
    assert e1.exec_signature() != e2.exec_signature()
    assert e1._fns is not e2._fns
    e3 = reg.register("t3", a).engine
    e4 = reg.register("t4", a).engine
    assert e3.exec_signature() == e4.exec_signature()
    assert e3._fns is e4._fns
    reg.close()


def test_registration_validation():
    reg = _registry()
    a = _mats(1)["t0"]
    for bad in ("", "a/b", "a:b", "a,b", "a b", 'a"b', "a*"):
        with pytest.raises(ConfigError):
            reg.register(bad, a)
    assert isinstance(reg.register("ok-tenant.1_x", a), TenantHandle)
    with pytest.raises(ConfigError, match="already registered"):
        reg.register("ok-tenant.1_x", a)
    with pytest.raises(ConfigError, match="registry-owned"):
        reg.register("t2", a, metrics=None)
    with pytest.raises(ConfigError, match="registry-owned"):
        MatrixRegistry(port_mesh(), retain_host=True)
    with pytest.raises(ConfigError, match="unknown tenant"):
        reg.submit("nope", _x())
    reg.close()
    assert registry_mod._RESERVED_ENGINE_KWARGS == \
        __import__("matvec_mpi_multiplier_tpu.engine.registry",
                   fromlist=["_"])._RESERVED_ENGINE_KWARGS


def test_quota_validation():
    with pytest.raises(ConfigError):
        TenantQuota(max_in_flight=0)
    with pytest.raises(ConfigError):
        TenantQuota(max_resident_bytes=0)
    with pytest.raises(ConfigError):
        MatrixRegistry(port_mesh(), hbm_budget=0)
    with pytest.raises(ConfigError):
        MatrixRegistry(port_mesh(), cost_weight=-1)


def test_lru_floor_simulation():
    seq = [0, 0, 1, 0, 2, 1, 0]
    assert lru_hit_floor(seq, capacity=2) == pytest.approx(2 / 7)
    assert lru_hit_floor(seq, capacity=None) == pytest.approx(4 / 7)
    assert lru_hit_floor([0, 1, 2, 1], capacity=2, pinned=[0]) == pytest.approx(1 / 4)
    assert lru_hit_floor([0, 1, 0], capacity=0) == 0.0
    assert lru_hit_floor([0, 1, 0], capacity=0, pinned=[0]) == pytest.approx(2 / 3)
    rng = np.random.default_rng(3)
    for _ in range(50):
        seq = rng.integers(0, 6, size=40)
        cap = int(rng.integers(0, 5))
        pinned = list(range(int(rng.integers(0, 3))))
        assert lru_hit_floor(seq, cap, pinned) == jax_lru_hit_floor(seq, cap, pinned)


def test_scheduler_flush_racing_eviction_self_heals():
    """A coalescing scheduler on one tenant's engine bypasses the registry's
    admission; a flush after that tenant's eviction places A again on the
    dispatch path, bitwise, and the placement is charged."""
    from matvec_mpi_multiplier_torch.engine import ArrivalWindowScheduler

    mats = _mats(2)
    reg = _registry(1, promote=4)
    h0 = reg.register("t0", mats["t0"])
    h1 = reg.register("t1", mats["t1"])
    x = _x()
    ref0 = h0(x)
    sched = ArrivalWindowScheduler(h0.engine, window_ms=5.0)
    try:
        h1(x)  # evicts t0
        assert not reg.health()["tenants"]["t0"]["resident"]
        futs = [sched.submit(x) for _ in range(3)]
        assert all(torch.equal(f.result(), ref0) for f in futs)
        h = reg.health()
        assert h["tenants"]["t0"]["resident"]
        assert h["hbm"]["charged_bytes"] == 2 * PAYLOAD
        assert h["hbm"]["overshoots"] >= 1
    finally:
        sched.close()
        reg.close()


# --------------------------------------------------------------------- obs


def test_tenants_panel_renders_registry_metrics(jax_mesh):
    from matvec_mpi_multiplier_tpu.obs.__main__ import render_tenants as jax_render

    mats = _mats(3)
    x = _x()
    panels = []
    for reg in (_registry(2), _jax_registry(jax_mesh, 2)):
        handles = {tid: reg.register(tid, a) for tid, a in mats.items()}
        reg.pin("t0")
        for tid in ("t0", "t1", "t2", "t1", "t0"):
            handles[tid](x)
        snap = reg.metrics.snapshot()
        panels.append((snap, reg.health()))
        reg.close()
    (snap, h), (jsnap, jh) = panels
    panel = render_tenants(snap)
    assert panel is not None and panel.startswith("tenants:")
    assert all(tid in panel for tid in mats)
    assert "hit rate" in panel and "quota rejections" in panel
    assert panel in render_metrics(snap)
    assert panel == jax_render(jsnap)
    assert set(h["tenants"]) == set(jh["tenants"]) == set(mats)
    for tid in mats:
        assert set(h["tenants"][tid]) == set(jh["tenants"][tid])
    assert render_tenants({"counters": {}, "gauges": {}}) is None


# ------------------------------------------------- the engine's residency hooks


@pytest.mark.parametrize("storage", [None, "int8c"])
def test_engine_residency_lifecycle(storage):
    """Deferred placement, ensure/release, the listener's reasons and the
    self-heal, bitwise; a released engine is neither closed nor resident."""
    a = _mats(1)["t0"]
    x = _x()
    notes = []
    eng = MatvecEngine(a, port_mesh(4), strategy="colwise", promote=None,
                       dtype_storage=storage, retain_host=True, defer_placement=True,
                       residency_listener=lambda d, r: notes.append((d, r)))
    assert not eng.resident and eng.device_resident_bytes == 0 and notes == []
    assert eng.ensure_resident() and not eng.ensure_resident()
    payload = eng.resident_bytes
    assert notes == [(payload, "resident")] and eng.device_resident_bytes == payload
    y = eng(x)
    assert eng.release_residency() == payload
    assert notes[-1] == (-payload, "released")
    health = eng.health()["storage"]
    assert not health["resident"] and health["device_resident_bytes"] == 0
    assert eng.metrics.snapshot()["gauges"]["engine_resident_bytes"] == 0
    assert torch.equal(eng(x), y)  # the dispatch path places A again
    assert notes[-1] == (payload, "resident") and len(notes) == 3
    eng.close()
    with pytest.raises(ConfigError, match="closed"):
        eng.ensure_resident()


def test_residency_needs_retained_host():
    a = _mats(1)["t0"]
    with pytest.raises(ConfigError, match="defer_placement needs retain_host"):
        MatvecEngine(a, port_mesh(), defer_placement=True)
    eng = MatvecEngine(a, port_mesh(), promote=None)
    with pytest.raises(ResidencyError, match="retain_host"):
        eng.release_residency()
    assert eng.resident and eng.exec_signature()[1] == "rowwise"
    eng.close()


def test_exec_cache_shares_functions_between_engines():
    """``exec_cache=`` shares the strategy's functions, never a program: two
    engines on one cache build one function and two programs, each over its
    own A."""
    mats = _mats(2, seed=3)
    x = _x()
    shared = ExecutableCache()
    engines = [MatvecEngine(a, port_mesh(), strategy="blockwise", promote=None,
                            exec_cache=shared) for a in mats.values()]
    for eng, a in zip(engines, mats.values()):
        np.testing.assert_allclose(eng(x).numpy(), a @ x, **FP32)
    assert shared.stats.compiles == 1 and len(shared) == 1
    assert [e.stats.compiles for e in engines] == [1, 1]
    for eng in engines:
        eng.close()


def test_prefetch_protect_and_demand_terms(jax_mesh):
    """prefetch admits without pinning and shields ``protect``; the demand
    estimators read the registry's clock; coalesce groups follow the host
    bytes. The victim of the prefetch is the JAX registry's."""
    mats = _mats(3)
    x = _x()
    victims = []
    for reg in (_registry(2), _jax_registry(jax_mesh, 2)):
        log = []
        reg.eviction_listener = _victims(log)
        handles = {tid: reg.register(tid, a) for tid, a in mats.items()}
        handles["t0"](x)
        handles["t1"](x)
        assert reg.prefetch("t2", protect="t0")
        assert not reg.prefetch("t2")
        victims.append(log)
        reg.close()
    assert victims[0] == victims[1] == [("t1", "t2")]

    reg = _registry()
    now = [100.0]
    reg._clock = lambda: now[0]
    reg.register("a", mats["t0"])
    reg.register("b", mats["t0"])
    reg.register("c", mats["t1"])
    for _ in range(5):
        now[0] += 0.1
        reg.submit("a", x).result()
    reg.observe_demand("b", 3)
    assert reg.demand_rate("a") > 0 and reg.demand_rate("c") == 0
    assert reg.coalesce_group("a") == reg.coalesce_group("b") != reg.coalesce_group("c")
    assert reg.metrics.counter("registry_prefetches_total").value == 0
    reg.close()


def test_demand_weight_protects_a_hot_tenant(jax_mesh):
    """With ``demand_weight`` on, a tenant with a high arrival rate outranks
    a more recent idle one — the same victim as the JAX registry's on the
    same fake clock."""
    mats = _mats(3)
    x = _x()
    victims = []
    for jax_side in (False, True):
        now = [0.0]
        log = []
        if jax_side:
            reg = _jax_registry(jax_mesh, 2, demand_weight=50.0,
                                rate_clock=lambda: now[0], eviction_listener=_victims(log))
        else:
            reg = _registry(2, demand_weight=50.0, eviction_listener=_victims(log))
            reg._clock = lambda: now[0]
        handles = {tid: reg.register(tid, a) for tid, a in mats.items()}
        for _ in range(20):  # t0 is hot
            now[0] += 0.05
            handles["t0"](x)
        now[0] += 0.05
        handles["t1"](x)  # t1 is the more recent
        now[0] += 0.05
        handles["t2"](x)
        victims.append(log)
        reg.close()
    assert victims[0] == victims[1] == [("t1", "t2")]


# ------------------------------------------ reshard (tests/test_reshard.py)


def _operands(seed=5):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((M, 2048)).astype(np.float32),
            rng.standard_normal(2048).astype(np.float32))


def test_eviction_racing_reshard_aborts_cleanly(monkeypatch):
    """An eviction between the migration and the commit aborts the copy:
    the configuration moves, the device never holds two footprints, and the
    next dispatch places A in the destination layout."""
    a, x = _operands()
    mesh = port_mesh()
    eng = MatvecEngine(a, mesh, strategy="rowwise", retain_host=True)
    real = reshard_mod.build_reshard

    def racing(*args):
        program = real(*args)

        def run(src):
            out = program(src)
            eng.release_residency()  # the eviction lands mid-migration
            return out
        return run

    monkeypatch.setattr(reshard_mod, "build_reshard", racing)
    res = eng.reshard("colwise")
    assert res["aborted"] and not res["migrated"] and res["bytes_moved"] == 0
    assert not eng.resident and eng.device_resident_bytes == 0
    monkeypatch.setattr(reshard_mod, "build_reshard", real)
    fresh = MatvecEngine(a, mesh, strategy="colwise")
    assert torch.equal(eng(x), fresh(x))
    assert eng.strategy.name == "colwise"
    for s_eng, s_fresh in zip(eng._a.shards, fresh._a.shards):
        assert torch.equal(s_eng, s_fresh)
    eng.close()
    fresh.close()


def test_reshard_ledger_balanced(monkeypatch):
    """The listener's deltas sum to the engine's footprint at every stage of
    migrate → evict mid-migration → self-heal."""
    a, x = _operands()
    ledger = []
    eng = MatvecEngine(a, port_mesh(), strategy="rowwise", retain_host=True,
                       residency_listener=lambda d, r: ledger.append((d, r)))

    def balance():
        return sum(d for d, _ in ledger)

    base = eng.device_resident_bytes
    assert balance() == base  # the construction's placement is reported
    eng.reshard("blockwise")
    assert eng.device_resident_bytes == base and balance() == base
    real = reshard_mod.build_reshard
    monkeypatch.setattr(reshard_mod, "build_reshard", lambda *args: (
        lambda src, program=real(*args): (program(src), eng.release_residency())[0]))
    eng.reshard("colwise")
    monkeypatch.setattr(reshard_mod, "build_reshard", real)
    assert balance() == eng.device_resident_bytes == 0
    eng(x)
    assert balance() == eng.device_resident_bytes == base
    eng.close()


def test_registry_reshard_rehomes_exec_cache():
    """The migrated tenant adopts the destination layout's function cache:
    a same-shaped sibling already serving there makes the migration build
    no function."""
    a, x = _operands()
    mesh = port_mesh()
    reg = MatrixRegistry(mesh)
    reg.register("sib", a, strategy="colwise")
    reg.warmup(widths=(1,))
    h = reg.register("mover", a, strategy="rowwise")
    reg.submit("mover", x).result()
    sib_fns = reg._entry("sib").engine._fns
    before = sib_fns.stats.compiles
    reg.reshard("mover", "colwise", warm_widths=(1,))
    assert h.engine._fns is sib_fns and sib_fns.stats.compiles == before
    fresh = MatvecEngine(a, mesh, strategy="colwise")
    assert torch.equal(h(x), fresh(x))
    st = h.stats()
    assert st["strategy"] == "colwise" and st["reshards"] == 1
    assert reg._c_reshards.value == 1 and reg._c_reshard_bytes.value == a.nbytes
    assert reg.accountant.total == sum(
        reg._entry(t).engine.device_resident_bytes for t in ("sib", "mover"))
    reg.close()
    fresh.close()


def test_registry_reshard_idempotent_and_serialized():
    a, x = _operands()
    reg = MatrixRegistry(port_mesh())
    reg.register("t", a, strategy="rowwise")
    reg.submit("t", x).result()
    assert reg.reshard("t", "rowwise") is None
    assert reg.reshard("t", "colwise")["migrated"]
    assert reg.tenant_stats("t")["strategy"] == "colwise"
    reg.close()


def test_tenants_panel_strategy_column_tracks_migration():
    a, x = _operands()
    reg = MatrixRegistry(port_mesh())
    reg.register("mover", a, strategy="rowwise")
    reg.register("stayer", a, strategy="rowwise")
    for t in ("mover", "stayer"):
        reg.submit(t, x).result()
    reg.reshard("mover", "blockwise")
    panel = render_tenants(reg.metrics.snapshot())
    rows = {ln.split()[0]: ln.split()[1] for ln in panel.splitlines()
            if ln.split() and ln.split()[0] in ("mover", "stayer")}
    assert rows == {"mover": "blockwise", "stayer": "rowwise"}
    reshard_line = next(ln for ln in panel.splitlines() if "reshards" in ln)
    assert reshard_line.split()[1] == "1"
    assert f"{float(a.nbytes):.3e}" in reshard_line
    reg.close()


# ------------------------------------ solvers (tests/test_solvers.py:231)


def test_multitenant_solver_isolation():
    """Solver ops ride the registry: per-tenant operands give per-tenant
    answers, and one tenant's typed divergence leaves its neighbor's solves
    bitwise untouched (the JAX test's tolerance against numpy: 1e-8)."""
    a_good = solver_operand(64, "float64", seed=37)
    a_bad = solver_operand(64, "float64", seed=41)
    reg = _registry(1)  # the two tenants also evict each other
    reg.register("good", a_good)
    reg.register("bad", a_bad)
    b = np.random.default_rng(1).standard_normal(64)
    try:
        before = reg.submit("good", b, op="cg", rtol=1e-10).result()
        with pytest.raises(SolverDivergedError):
            reg.submit("bad", b, op="cg", rtol=1e-14, maxiter=2).result()
        after = reg.submit("good", b, op="cg", rtol=1e-10).result()
        assert torch.equal(before.x, after.x)
        np.testing.assert_allclose(before.x.numpy(), np.linalg.solve(a_good, b), rtol=1e-8)
        assert reg.health()["tenants"]["good"]["evictions"] == 1
    finally:
        reg.close()
