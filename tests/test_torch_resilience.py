"""The port's recovery policy (resilience/policy.py, the engine's ladders,
breakers, retries and ``health()``) against the JAX package's.

The policy half is held to the JAX package decision by decision: the same
exceptions classify the same way, the same seed backs off by the same
delays (exact floats), and the same sequence of breaker calls on two fake
clocks walks the same states and snapshots. The port also classifies its own
vocabulary: an out-of-memory error as exhaustion, a CUDA error a launch
raised as not retryable.

The engine half runs the same requests and fault plans through both
packages' engines on 8 CPU shards. The port's ``cuda`` kernel and its
``torch`` safe tier stand where the JAX package's ``pallas`` kernel and its
``xla`` safe tier stand, so labels are compared after the names are swapped
(``_jax_label``). Counters, ``health()``'s keys, breaker states, the
``degraded`` mapping and the plans' tallies must be equal; results agree
with ``a @ x`` within fp32 rtol 1e-5 (shard sums in another order), and
where a fallback must give the same values as a path of the same engine the
comparison is bitwise. The quantized ladder is held to the numpy fp64 oracle
(the JAX package's quantized programs raise under the installed jax), the
solver ladder to ``np.linalg.solve``.
"""

import inspect
import json
import threading

import numpy as np
import pytest
import torch

import matvec_mpi_multiplier_tpu.resilience as jres
from matvec_mpi_multiplier_tpu import make_mesh as jax_make_mesh
from matvec_mpi_multiplier_tpu.engine import ArrivalWindowScheduler as JaxScheduler
from matvec_mpi_multiplier_tpu.engine import MatvecEngine as JaxEngine
from matvec_mpi_multiplier_tpu.obs import reset_hub as jax_reset_hub
from matvec_mpi_multiplier_tpu.tuning import reset_cache as jax_reset_cache
from matvec_mpi_multiplier_tpu.utils import errors as jerrors
from matvec_mpi_multiplier_torch import tuning
from matvec_mpi_multiplier_torch.bench.serve import solver_operand
from matvec_mpi_multiplier_torch.engine import ArrivalWindowScheduler, MatvecEngine
from matvec_mpi_multiplier_torch.engine.core import SAFE_KERNEL
from matvec_mpi_multiplier_torch.obs import reset_hub
from matvec_mpi_multiplier_torch.parallel.mesh import make_mesh
from matvec_mpi_multiplier_torch.resilience import (
    BREAKER_CLOSED,
    BREAKER_HALF_OPEN,
    BREAKER_OPEN,
    CircuitBreaker,
    CompileFaultError,
    DeviceFaultError,
    FaultPlan,
    FaultSpec,
    ResiliencePolicy,
    ResourceExhaustedError,
    ResultIntegrityError,
    RetryPolicy,
    classify_failure,
    out_of_memory_as_exhausted,
)
from matvec_mpi_multiplier_torch.utils.errors import (
    ConfigError,
    MatvecError,
    SolverDivergedError,
)

CPU = torch.device("cpu")
POISON = 1e30
RTOL = 1e-5  # fp32 shard sums against numpy's, at k = 64


@pytest.fixture(autouse=True)
def cold_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("MATVEC_TUNING_CACHE", str(tmp_path / "tuning_cache.json"))
    tuning.reset_cache()
    jax_reset_cache()
    yield
    tuning.reset_cache()
    jax_reset_cache()
    reset_hub()
    jax_reset_hub()


class FakeClock:
    def __init__(self, t: float = 100.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, s: float) -> None:
        self.t += s


def policies(clock=None, **kwargs):
    """The same policy in both packages, never really sleeping: the JAX
    package's through its test parameters, the port's through the private
    attributes (it has no test-only parameters)."""
    kwargs.setdefault("retry", {"max_attempts": 3})
    retry = kwargs.pop("retry")
    pol = ResiliencePolicy(retry=RetryPolicy(**retry), **kwargs)
    pol._sleep = lambda s: None
    jkw = dict(sleep=lambda s: None)
    if clock is not None:
        pol._clock = clock[0]
        jkw["clock"] = clock[1]
    jpol = jres.ResiliencePolicy(retry=jres.RetryPolicy(**retry), **kwargs, **jkw)
    return pol, jpol


def plans(*specs, seed=0):
    return (FaultPlan([FaultSpec(**s) for s in specs], seed=seed),
            jres.FaultPlan([jres.FaultSpec(**s) for s in specs], seed=seed))


def port_mesh(p=8):
    return make_mesh(p, devices=[CPU] * p)


# The port's kernel for each JAX tier a test names.
KERNEL = {"xla": "torch", "pallas": "cuda"}


def engines(a, strategy="rowwise", jax_kernel="pallas", plan=(None, None),
            policy=(None, None), **kwargs):
    kwargs.setdefault("promote", 2)
    kwargs.setdefault("max_bucket", 8)
    port = MatvecEngine(a, port_mesh(), strategy=strategy, kernel=KERNEL[jax_kernel],
                        fault_plan=plan[0], resilience=policy[0], **kwargs)
    ref = JaxEngine(a, jax_make_mesh(8), strategy=strategy, kernel=jax_kernel,
                    fault_plan=plan[1], resilience=policy[1], **kwargs)
    return port, ref


def _jax_label(label: str) -> str:
    """A port label in the JAX package's words."""
    parts = label.split(":")
    parts[2] = {"cuda": "pallas", "torch": "xla", "cuda_fused": "pallas_fused"}.get(
        parts[2], parts[2])
    return ":".join(parts)


def story(health: dict, port: bool) -> dict:
    """The parts of health() the two packages must agree on, in the JAX
    package's labels."""
    fix = _jax_label if port else (lambda s: s)
    return {
        "resilience": health["resilience"],
        "counters": health["counters"],
        "degraded": {fix(k): fix(v) for k, v in health["degraded"].items()},
        "breakers": {fix(k): {f: v for f, v in snap.items() if f != "open_for_s"}
                     for k, snap in health["breakers"].items()},
        "fault_injection": health["fault_injection"],
    }


def run_both(port, ref, x):
    """Submit to both engines; each outcome is its result or the failure's
    type name (the JAX package's types by name)."""
    out = []
    for eng in (port, ref):
        try:
            y = eng.submit(x).result()
            out.append(np.asarray(y.numpy() if isinstance(y, torch.Tensor) else y))
        except (MatvecError, jerrors.MatvecError) as e:
            out.append(type(e).__name__)
    return out


def assert_same_story(port, ref):
    assert story(port.health(), True) == story(ref.health(), False)


# ------------------------------------------------------------ classify


@pytest.mark.parametrize("make", [
    lambda m: RuntimeError("RESOURCE_EXHAUSTED: oom"),
    lambda m: RuntimeError("UNAVAILABLE: link flap"),
    lambda m: RuntimeError("ABORTED: peer reset"),
    lambda m: RuntimeError("DEADLINE_EXCEEDED: collective"),
    lambda m: ValueError("shape mismatch"),
    lambda m: m.DeviceFaultError("d"),
    lambda m: m.DeviceFaultError("d", retryable=False),
    lambda m: m.DeviceFaultError("p", payload_fault=True, retryable=False),
    lambda m: m.CompileFaultError("c"),
    lambda m: m.ResourceExhaustedError("r"),
])
def test_classify_failure_equals_jax(make):
    import matvec_mpi_multiplier_torch.resilience as pres

    assert classify_failure(make(pres)) == jres.classify_failure(make(jres))


@pytest.mark.parametrize("exc, want", [
    (torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 8 GiB"), (False, True)),
    (RuntimeError("CUDA error: an illegal memory access was encountered"), (False, False)),
    (RuntimeError("gemv kernel launch failed for A (64, 64) torch.bfloat16 on plan: "
                  "UNAVAILABLE launch resources (cudaError 701)"), (False, False)),
    (RuntimeError("gemm kernel launch failed for A (8, 8): unspecified launch failure "
                  "(cudaError 719)"), (False, False)),
    (RuntimeError("CUDA error: device busy, ABORTED"), (False, False)),
])
def test_classify_failure_reads_the_ports_vocabulary(exc, want):
    """Exhaustion by type or message; a CUDA error a launch raised is never
    retried, whatever transient word its text holds."""
    assert classify_failure(exc) == want
    with pytest.raises(ResourceExhaustedError) as info:
        with out_of_memory_as_exhausted("the dispatch"):
            raise torch.cuda.OutOfMemoryError("CUDA out of memory")
    assert classify_failure(info.value) == (False, True)
    accelerator = getattr(torch, "AcceleratorError", None)
    if accelerator is not None:
        try:
            err = accelerator("device-side assert triggered")
        except TypeError:  # a constructor that wants more than a message
            return
        assert classify_failure(err) == (False, False)


# --------------------------------------------------------------- retries


@pytest.mark.parametrize("kwargs", [
    {}, {"backoff_ms": 1.0, "multiplier": 2.0, "max_backoff_ms": 4.0, "jitter": 0.5,
         "seed": 3},
    {"backoff_ms": 0.5, "multiplier": 3.0, "jitter": 1.0, "seed": 19},
    {"jitter": 0.0, "seed": 7},
])
def test_retry_delays_equal_jax(kwargs):
    r, jr = RetryPolicy(**kwargs), jres.RetryPolicy(**kwargs)
    for serial in range(6):
        for attempt in range(1, 6):
            assert r.delay_s(serial, attempt) == jr.delay_s(serial, attempt)
    d1, d2, d3 = (r.delay_s(0, a) for a in (1, 2, 3))
    assert d1 <= d2 <= d3 <= r.max_backoff_ms / 1e3


@pytest.mark.parametrize("kwargs", [
    {"max_attempts": 0}, {"backoff_ms": -1.0}, {"max_backoff_ms": -1.0}, {"jitter": 1.5},
])
def test_retry_policy_refuses_what_jax_refuses(kwargs):
    with pytest.raises(jerrors.ConfigError):
        jres.RetryPolicy(**kwargs)
    with pytest.raises(ConfigError):
        RetryPolicy(**kwargs)


# ------------------------------------------------------- circuit breaker


def breakers(**kwargs):
    clock, jclock = FakeClock(), FakeClock()
    events = {"port": [], "jax": []}
    br = CircuitBreaker(on_open=lambda: events["port"].append("open"),
                        on_close=lambda: events["port"].append("close"), **kwargs)
    br._clock = clock
    jbr = jres.CircuitBreaker(clock=jclock, on_open=lambda: events["jax"].append("open"),
                              on_close=lambda: events["jax"].append("close"), **kwargs)
    return (br, clock), (jbr, jclock), events


OPS = ["failure", "failure", "allow", "failure", "allow", "advance", "allow", "allow",
       "failure", "allow", "advance", "allow", "inconclusive", "allow", "success", "failure",
       "success", "failure", "failure", "failure", "advance", "allow", "success", "allow"]


@pytest.mark.parametrize("threshold, reset", [(3, 10.0), (1, 0.5), (2, 30.0)])
def test_breaker_walks_the_jax_state_machine(threshold, reset):
    (br, clock), (jbr, jclock), events = breakers(failure_threshold=threshold,
                                                  reset_timeout_s=reset)
    for op in OPS:
        if op == "advance":
            clock.advance(reset)
            jclock.advance(reset)
            got = want = None
        elif op == "allow":
            got, want = br.allow(), jbr.allow()
        else:
            getattr(br, f"record_{op}")()
            getattr(jbr, f"record_{op}")()
            got = want = None
        assert got == want, op
        assert br.state == jbr.state, op
        assert br.snapshot() == jbr.snapshot(), op
    assert events["port"] == events["jax"]
    assert BREAKER_OPEN in {"open"} and BREAKER_HALF_OPEN == "half_open"


def test_breaker_state_machine_and_single_probe():
    (br, clock), _, events = breakers(failure_threshold=3, reset_timeout_s=10.0)
    assert br.state == BREAKER_CLOSED
    for _ in range(2):
        assert br.allow()
        br.record_failure()
    assert br.state == BREAKER_CLOSED
    br.record_failure()
    assert br.state == BREAKER_OPEN and events["port"] == ["open"]
    assert not br.allow()
    clock.advance(10.0)
    assert br.state == BREAKER_HALF_OPEN
    assert br.allow() and not br.allow()  # one probe at a time
    br.record_failure()
    assert br.state == BREAKER_OPEN and events["port"] == ["open", "open"]
    clock.advance(10.0)
    assert br.allow()
    br.record_success()
    assert br.state == BREAKER_CLOSED and events["port"][-1] == "close"
    snap = br.snapshot()
    assert snap["failures_total"] == 4 and snap["opens_total"] == 2


def test_breaker_inconclusive_releases_probe_without_transition():
    (br, clock), _, _ = breakers(failure_threshold=2, reset_timeout_s=10.0)
    for _ in range(5):
        br.record_inconclusive()
    assert br.state == BREAKER_CLOSED and br.snapshot()["consecutive_failures"] == 0
    br.record_failure()
    br.record_failure()
    assert br.state == BREAKER_OPEN
    clock.advance(10.0)
    assert br.allow()
    br.record_inconclusive()
    assert br.state == BREAKER_HALF_OPEN and br.allow()
    br.record_success()
    assert br.state == BREAKER_CLOSED


@pytest.mark.parametrize("kwargs", [{"failure_threshold": 0}, {"reset_timeout_s": -1.0}])
def test_breaker_refuses_what_jax_refuses(kwargs):
    with pytest.raises(jerrors.ConfigError):
        jres.CircuitBreaker(**kwargs)
    with pytest.raises(ConfigError):
        CircuitBreaker(**kwargs)


def test_no_test_only_parameters():
    """The JAX package's clock/sleep injection parameters are private
    attributes in the port; every other parameter is the JAX package's."""
    for cls, jcls in ((ResiliencePolicy, jres.ResiliencePolicy),
                      (CircuitBreaker, jres.CircuitBreaker),
                      (RetryPolicy, jres.RetryPolicy)):
        ours = set(inspect.signature(cls).parameters)
        theirs = set(inspect.signature(jcls).parameters)
        assert ours == theirs - {"clock", "sleep"}, cls
    pol = ResiliencePolicy(breaker_failure_threshold=2, breaker_reset_s=4.0)
    pol._clock = FakeClock(7.0)
    br = pol.make_breaker()
    assert (br.failure_threshold, br.reset_timeout_s, br._clock) == (2, 4.0, pol._clock)


# ------------------------------------------------- engine: fault hooks


def test_transient_dispatch_fault_retries_to_success(rng):
    a = rng.uniform(0, 10, (64, 64)).astype(np.float32)
    x = rng.uniform(0, 10, 64).astype(np.float32)
    spec = dict(site="dispatch", kind="device_error", times=2)
    port, ref = engines(a, plan=plans(spec), policy=policies())
    y, jy = run_both(port, ref, x)
    np.testing.assert_allclose(y, a @ x, rtol=RTOL)
    np.testing.assert_allclose(jy, a @ x, rtol=RTOL)
    assert_same_story(port, ref)
    h = port.health()["counters"]
    assert (h["retries"], h["faults_injected"], h["downgrades"], h["dispatch_failures"]) == (
        2, 2, 0, 0)


@pytest.mark.parametrize("jax_kernel", ["xla", "pallas"])
def test_retries_exhausted_raises_and_counts_dispatch_failure(rng, jax_kernel):
    """A fault on every key: each level spends its attempts, then the
    request fails (one level for the safe tier's own engine, two above)."""
    a = rng.uniform(0, 10, (64, 64)).astype(np.float32)
    port, ref = engines(a, jax_kernel=jax_kernel,
                        plan=plans(dict(site="dispatch", kind="device_error")),
                        policy=policies(retry={"max_attempts": 2}))
    out = run_both(port, ref, rng.uniform(0, 10, 64).astype(np.float32))
    assert out == ["DeviceFaultError"] * 2
    assert_same_story(port, ref)
    h = port.health()
    assert h["counters"]["dispatch_failures"] == 1
    assert h["counters"]["retries"] == (1 if jax_kernel == "xla" else 2)
    assert port.tracer.traces()[-1]["status"] == "dispatch_failed"


def test_fault_plan_without_policy_propagates_raw(rng):
    a = rng.uniform(0, 10, (64, 64)).astype(np.float32)
    port, ref = engines(a, plan=plans(dict(site="dispatch", kind="device_error")))
    assert run_both(port, ref, rng.uniform(0, 10, 64).astype(np.float32)) == [
        "DeviceFaultError"] * 2
    assert_same_story(port, ref)
    assert port.health()["counters"]["retries"] == 0
    assert port.health()["resilience"] is False


def test_latency_fault_stalls_but_serves(rng):
    a = rng.uniform(0, 10, (64, 64)).astype(np.float32)
    x = rng.uniform(0, 10, 64).astype(np.float32)
    port, ref = engines(a, plan=plans(dict(site="dispatch", kind="latency", latency_ms=1.0,
                                           times=1)), policy=policies())
    y, _ = run_both(port, ref, x)
    np.testing.assert_allclose(y, a @ x, rtol=RTOL)
    assert_same_story(port, ref)
    assert port.health()["counters"]["faults_injected"] == 1


# ------------------------------------- engine: ladder, breaker, shrink


@pytest.mark.parametrize("jax_kernel", ["xla", "pallas"])
def test_compile_fault_degrades_then_half_open_recovers(rng, jax_kernel):
    """A compile-failure plan on the preferred combine opens its breaker
    while every request is served by the safe tier; the cooldown's probe
    meets the plan's last fault and reopens; the next probe builds and
    restores the preferred config. Both packages, step by step."""
    clocks = (FakeClock(), FakeClock())
    spec = dict(site="compile", kind="compile_error", key="*psum_scatter*", times=4)
    a = rng.uniform(0, 10, (64, 64)).astype(np.float32)
    x = rng.uniform(0, 10, 64).astype(np.float32)
    port, ref = engines(a, "colwise", jax_kernel, plan=plans(spec),
                        policy=policies(clocks, retry={"max_attempts": 2},
                                        breaker_failure_threshold=3, breaker_reset_s=5.0),
                        combine="psum_scatter", promote=None)
    for _ in range(4):
        y, jy = run_both(port, ref, x)
        np.testing.assert_allclose(y, a @ x, rtol=RTOL)
    assert_same_story(port, ref)
    h = port.health()
    pref = f"matvec:colwise:{KERNEL[jax_kernel]}:psum_scatter:1:float32"
    assert h["breakers"][pref]["state"] == BREAKER_OPEN
    assert h["degraded"] == {pref: f"matvec:colwise:{SAFE_KERNEL}:default:1:float32"}
    assert (h["counters"]["breaker_opens"], h["counters"]["downgrades"],
            h["counters"]["dispatch_failures"]) == (1, 4, 0)
    for c in clocks:
        c.advance(6.0)
    run_both(port, ref, x)
    assert_same_story(port, ref)
    assert port.health()["breakers"][pref]["state"] == BREAKER_OPEN
    for c in clocks:
        c.advance(6.0)
    y, _ = run_both(port, ref, x)
    np.testing.assert_allclose(y, a @ x, rtol=RTOL)
    assert_same_story(port, ref)
    h = port.health()
    assert h["breakers"][pref]["state"] == BREAKER_CLOSED and h["degraded"] == {}
    counters = port.metrics.snapshot()["counters"]
    assert (counters["resil_breaker_opens_total"], counters["resil_recoveries_total"]) == (2, 1)
    assert counters["resil_downgrades_total"] == h["counters"]["downgrades"]


def test_open_breaker_skips_preferred_attempts(rng):
    clocks = (FakeClock(), FakeClock())
    a = rng.uniform(0, 10, (64, 64)).astype(np.float32)
    x = rng.uniform(0, 10, 64).astype(np.float32)
    port, ref = engines(a, "colwise", "xla",
                        plan=plans(dict(site="compile", kind="compile_error",
                                        key="*psum_scatter*")),
                        policy=policies(clocks, retry={"max_attempts": 1},
                                        breaker_failure_threshold=2, breaker_reset_s=30.0),
                        combine="psum_scatter", promote=None)
    for _ in range(6):
        run_both(port, ref, x)
    assert port.health()["fault_injection"]["specs"][0]["injected"] == 2
    assert_same_story(port, ref)


def test_resource_exhausted_shrinks_bucket_ladder(rng):
    a = rng.uniform(0, 10, (64, 64)).astype(np.float32)
    blk = rng.uniform(0, 10, (64, 8)).astype(np.float32)
    port, ref = engines(a, plan=plans(dict(site="dispatch", kind="resource_exhausted",
                                           key="gemm:*:8:*")), policy=policies())
    y, jy = run_both(port, ref, blk)
    np.testing.assert_allclose(y, a @ blk, rtol=RTOL)
    assert_same_story(port, ref)
    h = port.health()
    assert h["counters"]["downgrades"] >= 1 and h["counters"]["dispatch_failures"] == 0
    # The 8-wide program was built; its dispatch raised, and the halves ran
    # at bucket 4 (exhaustion skips the safe tier: it needs a smaller program).
    assert {(k.kernel, k.bucket) for k in port._cache.keys() if k.op == "gemm"} == {
        ("cuda", 8), ("cuda", 4)}
    assert "gemm:rowwise:cuda:default:8:float32" in h["breakers"]


def test_gemm_ladder_falls_to_per_column_gemv(rng):
    """Every GEMM level failing degrades the promotion itself: the block is
    served column by column, bitwise the matvec path's own results."""
    a = rng.uniform(0, 10, (64, 64)).astype(np.float32)
    blk = rng.uniform(0, 10, (64, 4)).astype(np.float32)
    port, ref = engines(a, plan=plans(dict(site="dispatch", kind="device_error", key="gemm:*",
                                           retryable=False)), policy=policies())
    y, jy = run_both(port, ref, blk)
    np.testing.assert_allclose(y, a @ blk, rtol=RTOL)
    assert_same_story(port, ref)
    solo = np.stack([port.submit(blk[:, j]).result().numpy() for j in range(4)], axis=1)
    np.testing.assert_array_equal(y, solo)
    assert port.health()["counters"]["dispatch_failures"] == 0


def test_poisoned_payloads_do_not_open_breaker(rng):
    a = rng.uniform(0, 10, (64, 64)).astype(np.float32)
    port, ref = engines(a, plan=plans(dict(site="dispatch", kind="device_error", poison=POISON)),
                        policy=policies(breaker_failure_threshold=3))
    bad = rng.uniform(0, 10, 64).astype(np.float32)
    bad[0] = np.float32(POISON)
    for _ in range(5):
        assert run_both(port, ref, bad) == ["DeviceFaultError"] * 2
    assert_same_story(port, ref)
    for label, snap in port.health()["breakers"].items():
        assert snap["state"] == BREAKER_CLOSED and snap["consecutive_failures"] == 0, label
    good = rng.uniform(0, 10, 64).astype(np.float32)
    np.testing.assert_allclose(run_both(port, ref, good)[0], a @ good, rtol=RTOL)
    h = port.health()
    assert h["degraded"] == {} and h["counters"]["downgrades"] == 0


def test_health_is_safe_under_degradation_churn(rng):
    """health() copies the degraded map while a dispatch thread flips a
    config between degraded and recovered."""
    pol, _ = policies(retry={"max_attempts": 1}, breaker_failure_threshold=10_000)
    plan = FaultPlan([FaultSpec(site="dispatch", kind="device_error", key="*:ring:*", p=0.5,
                                retryable=False)])
    a = rng.uniform(0, 10, (64, 64)).astype(np.float32)
    eng = MatvecEngine(a, port_mesh(), strategy="rowwise", combine="ring", max_bucket=8,
                       promote=None, fault_plan=plan, resilience=pol)
    errors, stop = [], threading.Event()

    def poll():
        try:
            while not stop.is_set():
                eng.health()
        except BaseException as e:
            errors.append(e)

    t = threading.Thread(target=poll)
    t.start()
    try:
        x = rng.uniform(0, 10, 64).astype(np.float32)
        for _ in range(60):
            np.testing.assert_allclose(eng(x).numpy(), a @ x, rtol=RTOL)
    finally:
        stop.set()
        t.join(timeout=10.0)
    assert not errors, errors
    assert eng.health()["counters"]["downgrades"] > 0


# ----------------------------------------------------- health() and clean


def test_health_keys_equal_jax(rng):
    a = rng.uniform(0, 10, (64, 64)).astype(np.float32)
    for pol in (policies(), (None, None)):
        port, ref = engines(a, policy=pol)
        x = rng.uniform(0, 10, 64).astype(np.float32)
        run_both(port, ref, x)
        h, jh = port.health(), ref.health()
        assert set(h) == set(jh)
        for section in ("storage", "counters", "cost_model"):
            assert set(h[section]) == set(jh[section]), section
        assert h["cost_model"] == {**jh["cost_model"], "median_abs_log10_ratio":
                                   h["cost_model"]["median_abs_log10_ratio"]}
        assert h["cost_model"]["samples"] == 0 and h["cost_model"]["divergent"] is False
        assert set(h["slo"]["targets"]) == set(jh["slo"]["targets"]) == {
            "engine_availability", "engine_escalation_rate"}
        assert h["slo"]["targets"]["engine_availability"]["status"] == jh["slo"]["targets"][
            "engine_availability"]["status"]
        assert h["storage"] == {**jh["storage"], "reason": h["storage"]["reason"]}
        assert h["resilience"] is (pol[0] is not None)


def test_resilient_engine_on_clean_traffic_is_the_plain_engine(rng):
    """With no fault the policy changes nothing: the same keys are built,
    the same dispatches made, the results bitwise equal; no retry, no
    downgrade, every breaker closed."""
    a = rng.uniform(0, 10, (64, 64)).astype(np.float32)
    pol, _ = policies()
    plain = MatvecEngine(a, port_mesh(), promote=2, max_bucket=8)
    resilient = MatvecEngine(a, port_mesh(), promote=2, max_bucket=8, resilience=pol)
    for w in (1, 2, 3, 5, 8, 12, 1):
        x = rng.uniform(0, 10, (64, w) if w > 1 else 64).astype(np.float32)
        assert torch.equal(plain(x), resilient(x))
    assert resilient._cache.keys() == plain._cache.keys()
    s, rs = plain.stats, resilient.stats
    assert (s.compiles, s.hits, s.dispatches) == (rs.compiles, rs.hits, rs.dispatches)
    h = resilient.health()
    assert (h["counters"]["retries"], h["counters"]["downgrades"],
            h["counters"]["breaker_opens"]) == (0, 0, 0)
    assert all(b["state"] == BREAKER_CLOSED for b in h["breakers"].values())
    assert h["degraded"] == {} and not h["storage"]["native_fallback_resident"]
    # A plain engine's snapshot carries no resil_* names.
    assert not any(n.startswith("resil_") for n in plain.metrics.snapshot()["counters"])


def test_ladder_events_on_the_timeline_equal_jax(rng):
    """retry, degrade, breaker_open and breaker_close, correlated, in the
    JAX package's order and with its fields (labels swapped)."""
    clocks = (FakeClock(), FakeClock())
    a = rng.uniform(0, 10, (64, 64)).astype(np.float32)
    x = rng.uniform(0, 10, 64).astype(np.float32)
    hub, jhub = reset_hub(), jax_reset_hub()
    port, ref = engines(
        a, plan=plans(dict(site="dispatch", kind="device_error", key="*:pallas:*", times=5),
                      dict(site="dispatch", kind="device_error", key="*:cuda:*", times=5)),
        policy=policies(clocks, retry={"max_attempts": 2}, breaker_failure_threshold=2,
                        breaker_reset_s=5.0), promote=None)
    for i in range(5):
        if i == 3:
            for c in clocks:
                c.advance(6.0)
        run_both(port, ref, x)

    def shape(ev, fix):
        fields = {k: (fix(v) if k in ("key", "preferred", "served") else v)
                  for k, v in ev.items() if k not in ("seq", "t_s", "request_id", "cause_id")}
        return ev["kind"], "request_id" in ev or "cause_id" in ev, json.dumps(fields,
                                                                             sort_keys=True)

    got = [shape(e, _jax_label) for e in hub.events()]
    want = [shape(e, lambda s: s) for e in jhub.events()]
    assert got == want
    kinds = {k for k, _, _ in got}
    assert {"retry", "degrade", "breaker_open", "breaker_close"} <= kinds
    assert all(correlated for _, correlated, _ in got)


# ------------------------------------------- integrity gate & close


def test_nan_fault_with_gate_refuses_then_recovers(rng):
    a = rng.uniform(0, 10, (64, 64)).astype(np.float32)
    x = rng.uniform(0, 10, 64).astype(np.float32)
    port, ref = engines(a, plan=plans(dict(site="dispatch", kind="nan", times=1)),
                        policy=policies(), integrity_gate=True)
    assert run_both(port, ref, x) == ["ResultIntegrityError"] * 2
    assert port.tracer.traces()[-1]["status"] == "integrity_failed"
    y, _ = run_both(port, ref, x)
    np.testing.assert_allclose(y, a @ x, rtol=RTOL)
    assert_same_story(port, ref)
    assert port.health()["counters"]["integrity_failures"] == 1


def test_close_is_idempotent_and_flushes_failed_traces(rng, tmp_path):
    trace = tmp_path / "trace.jsonl"
    a = rng.uniform(0, 10, (64, 64)).astype(np.float32)
    eng = MatvecEngine(a, port_mesh(), promote=2, max_bucket=8, trace_jsonl=str(trace),
                       fault_plan=FaultPlan([FaultSpec(site="dispatch", kind="device_error",
                                                       after=1, retryable=False)]),
                       resilience=policies()[0])
    x = rng.uniform(0, 10, 64).astype(np.float32)
    ok = eng.submit(x)
    with pytest.raises(DeviceFaultError):
        eng.submit(x)
    eng.close()
    eng.close()
    records = [json.loads(line) for line in trace.read_text().splitlines() if line]
    assert [r["status"] for r in records] == ["dispatch_failed"]
    np.testing.assert_allclose(ok.result().numpy(), a @ x, rtol=RTOL)


# ------------------------------------------------------- chaos acceptance


def test_chaos_200_request_coalesced_trace_under_the_policy(rng):
    """200 coalesced requests, 11 poisoned, under transient device faults
    and the policy: every unpoisoned request served bitwise as in the
    unfaulted run, exactly the poisoned ones failed, no breaker opened by
    payload faults, and the counters the JAX package's."""
    n, batch = 200, 8
    a = rng.uniform(0, 10, (64, 64)).astype(np.float32)
    cols = [rng.uniform(0, 10, 64).astype(np.float32) for _ in range(n)]
    poisoned = {int(i) for i in np.random.default_rng(11).choice(n, size=11, replace=False)}
    for i in poisoned:
        cols[i][0] = np.float32(POISON)
    specs = (dict(site="dispatch", kind="device_error", poison=POISON),
             dict(site="dispatch", kind="device_error", p=0.2))

    def run(port: bool, fault: bool):
        plan = plans(*specs, seed=19)[0 if port else 1] if fault else None
        pol = policies()[0 if port else 1]
        if port:
            eng = MatvecEngine(a, port_mesh(), max_bucket=batch, promote=1, fault_plan=plan,
                               resilience=pol)
            sched = ArrivalWindowScheduler(eng, window_ms=1000.0, flush_width=batch)
        else:
            eng = JaxEngine(a, jax_make_mesh(8), kernel="pallas", max_bucket=batch, promote=1,
                            fault_plan=plan, resilience=pol)
            sched = JaxScheduler(eng, window_ms=1000.0, auto_flush=False, flush_width=batch)
        futs = [sched.submit(c) for c in cols]
        sched.flush()
        outs = []
        for f in futs:
            try:
                y = f.result(timeout=30)
                outs.append(np.asarray(y.numpy() if isinstance(y, torch.Tensor) else y))
            except (DeviceFaultError, jres.DeviceFaultError):
                outs.append(None)
        sched.close()
        return outs, eng

    clean, _ = run(True, False)
    chaotic, eng = run(True, True)
    jchaotic, jeng = run(False, True)
    for i in range(n):
        if i in poisoned:
            assert chaotic[i] is None and jchaotic[i] is None, i
        else:
            np.testing.assert_array_equal(chaotic[i], clean[i], err_msg=str(i))
            np.testing.assert_allclose(chaotic[i], a @ cols[i], rtol=RTOL)
    counters = eng.metrics.snapshot()["counters"]
    jcounters = jeng.metrics.snapshot()["counters"]
    names = ("sched_isolated_failures_total", "sched_bisect_splits_total",
             "sched_batch_failures_total", "engine_dispatch_failures_total",
             "resil_faults_injected_total", "resil_retries_total", "resil_downgrades_total",
             "resil_breaker_opens_total")
    assert {k: counters[k] for k in names} == {k: jcounters[k] for k in names}
    assert counters["sched_isolated_failures_total"] == len(poisoned)
    assert counters["resil_retries_total"] > 0 and counters["resil_breaker_opens_total"] == 0


def test_scheduler_integrity_gate_isolates_corrupt_column_under_policy(rng, monkeypatch):
    monkeypatch.setattr(ArrivalWindowScheduler, "_flusher_loop", lambda self: None)
    a = rng.uniform(0, 10, (64, 64)).astype(np.float32)
    eng = MatvecEngine(a, port_mesh(), promote=1, max_bucket=8, integrity_gate=True,
                       fault_plan=FaultPlan([FaultSpec(site="dispatch", kind="nan", times=1)]),
                       resilience=policies()[0])
    sched = ArrivalWindowScheduler(eng, window_ms=1000.0, flush_width=8)
    cols = [rng.uniform(0, 10, 64).astype(np.float32) for _ in range(8)]
    futs = [sched.submit(c) for c in cols]
    sched.flush()
    outcomes = []
    for c, f in zip(cols, futs):
        try:
            np.testing.assert_allclose(f.result(timeout=10).numpy(), a @ c, rtol=RTOL)
            outcomes.append("ok")
        except ResultIntegrityError:
            outcomes.append("refused")
    sched.close()
    assert outcomes.count("refused") == 1
    assert eng.health()["counters"]["integrity_failures"] == 1


# ----------------------------------------------- the native safe tier


@pytest.mark.parametrize("fmt", ["int8", "int8c"])
def test_quantized_ladder_places_the_native_tier_once(rng, fmt):
    """A fault on the quantized keys degrades to the native torch tier: the
    host A is kept, placed on the first degraded dispatch only, counted in
    the resident-bytes gauge and device_resident_bytes, and the degraded
    results are the native GEMV's; a reshard drops the tier and the ladders,
    and the next degraded dispatch places it again in the new layout."""
    a = rng.uniform(0, 10, (64, 64)).astype(np.float32)
    pol, _ = policies(retry={"max_attempts": 1})
    plan = FaultPlan([FaultSpec(site="dispatch", kind="device_error", key=f"*:{fmt}",
                                retryable=False)])
    eng = MatvecEngine(a, port_mesh(), strategy="rowwise", dtype_storage=fmt, promote=2,
                       max_bucket=8, fault_plan=plan, resilience=pol)
    native = MatvecEngine(a, port_mesh(), strategy="rowwise", kernel=SAFE_KERNEL, promote=2,
                          max_bucket=8)
    assert eng._a_host is not None and eng._a_native is None
    resident = eng.resident_bytes
    assert eng.health()["storage"]["device_resident_bytes"] == resident
    x = rng.uniform(0, 10, 64).astype(np.float32)
    blk = rng.uniform(0, 10, (64, 4)).astype(np.float32)
    assert torch.equal(eng(x), native(x))
    placed = eng._a_native
    assert placed is not None
    assert torch.equal(eng(blk), native(blk))
    assert eng._a_native is placed  # placed once
    np.testing.assert_allclose(eng(blk).numpy(), a.astype(np.float64) @ blk, rtol=RTOL)
    h = eng.health()
    assert h["storage"]["native_fallback_resident"] is True
    assert h["storage"]["resident_bytes"] == resident
    assert h["storage"]["device_resident_bytes"] == resident + a.nbytes
    assert eng.metrics.snapshot()["gauges"]["engine_resident_bytes"] == resident + a.nbytes
    assert h["degraded"] == {
        f"matvec:rowwise:cuda:default:1:float32:{fmt}": "matvec:rowwise:torch:default:1:float32",
        f"gemm:rowwise:cuda:default:4:float32:{fmt}": "gemm:rowwise:torch:default:4:float32",
    }
    epoch = eng._layout_epoch
    eng.reshard("colwise")
    assert eng._a_native is None and eng._layout_epoch == epoch + 1
    assert eng.health()["storage"]["device_resident_bytes"] == eng.resident_bytes
    np.testing.assert_allclose(eng(x).numpy(), a.astype(np.float64) @ x, rtol=RTOL)
    assert eng._a_native.spec == eng.strategy.specs(eng.mesh)[0]
    # The old layout's entries stay, as in the JAX package (keyed by label).
    assert eng.health()["degraded"] == {
        f"matvec:rowwise:cuda:default:1:float32:{fmt}": "matvec:rowwise:torch:default:1:float32",
        f"gemm:rowwise:cuda:default:4:float32:{fmt}": "gemm:rowwise:torch:default:4:float32",
        f"matvec:colwise:cuda:default:1:float32:{fmt}": "matvec:colwise:torch:default:1:float32",
    }


def _held(eng) -> list:
    """Weak references to the memory an engine holds: its resident A and its
    native safe tier once placed, with their shards (a built program refers
    to them too; ``close()`` releases it, wherever it is still held)."""
    import weakref

    held = [eng._a] + ([eng._a_native] if eng._a_native is not None else [])
    return [weakref.ref(t) for h in held for t in (h, *h.shards)]


@pytest.mark.parametrize("policy", [False, True])
def test_dropped_engine_is_freed_without_the_cycle_collector(rng, policy):
    """``close()`` frees an engine's resident A, native tier and programs at
    once, with or without a policy that has walked its ladders, opened a
    breaker and placed a native tier: whatever still refers to the engine
    (an error's traceback holds the frames it passed), its memory does not
    wait for the cycle collector. A closed engine refuses new work."""
    import gc

    a = rng.uniform(0, 10, (64, 64)).astype(np.float32)
    pol = policies(retry={"max_attempts": 1}, breaker_failure_threshold=1)[0] if policy else None
    plan = FaultPlan([FaultSpec(site="dispatch", kind="device_error", key="*:int8c",
                                retryable=False)])
    eng = MatvecEngine(a, port_mesh(), dtype_storage="int8c", promote=2, max_bucket=8,
                       fault_plan=plan, resilience=pol)
    for x in (rng.uniform(0, 10, 64), rng.uniform(0, 10, (64, 4))):
        try:
            eng.submit(x.astype(np.float32)).result()
        except DeviceFaultError:
            assert not policy
    if policy:
        assert eng.health()["counters"]["breaker_opens"] == 2 and eng._a_native is not None
    refs = _held(eng)
    assert len(refs) == 9 * (2 if policy else 1)  # A[, native], 8 shards each
    gc.disable()
    try:
        eng.close()
        assert [r() for r in refs] == [None] * len(refs)
        assert not eng.resident and eng.device_resident_bytes == 0
        assert eng.health()["storage"]["device_resident_bytes"] == 0
        for call in (lambda: eng.submit(a[0]), lambda: eng.warmup(),
                     lambda: eng.reshard("rowwise")):
            with pytest.raises(ConfigError, match="closed"):
                call()
    finally:
        gc.enable()


@pytest.mark.parametrize("policy", [False, True])
def test_failed_coalesced_batch_leaves_no_cycle(rng, policy):
    """A poisoned request bisected out of a coalesced batch fails alone and
    its future keeps the error, traceback and all; closing the engine frees
    its memory at once all the same, with no cycle collector to wait for."""
    import gc

    a = rng.uniform(0, 10, (64, 64)).astype(np.float32)
    eng = MatvecEngine(a, port_mesh(), promote=1, max_bucket=8,
                       fault_plan=FaultPlan([FaultSpec(site="dispatch", kind="device_error",
                                                       poison=POISON)]),
                       resilience=policies()[0] if policy else None)
    sched = ArrivalWindowScheduler(eng, window_ms=1000.0, flush_width=8)
    cols = [rng.uniform(0, 10, 64).astype(np.float32) for _ in range(8)]
    cols[3][0] = np.float32(POISON)
    futs = [sched.submit(c) for c in cols]
    sched.flush()
    failed = []
    for i, f in enumerate(futs):
        try:
            f.result(timeout=10)
        except DeviceFaultError:
            failed.append(i)
    sched.close()
    err = futs[3].exception()
    assert failed == [3] and isinstance(err, DeviceFaultError)
    assert err.__traceback__ is not None  # the client's error keeps its traceback
    refs = _held(eng)
    gc.disable()
    try:
        eng.close()
        assert [r() for r in refs] == [None] * len(refs)
        np.testing.assert_allclose(futs[0].result().numpy(), a @ cols[0], rtol=RTOL)
    finally:
        gc.enable()


# ------------------------------------------------------- real errors

# What the port's wrappers raise when a launch fails (ops/cuda_gemv.py).
REAL_LAUNCH_ERROR = ("gemv kernel launch failed for A (8, 64) torch.float32 on "
                     "GemvPlan(...): invalid argument (cudaError 1)")


def _failing_kernels(mp, failing: list):
    """Make the ``cuda`` GEMV and GEMM tiers raise a launch's real error
    while ``failing`` holds True (a program built meanwhile keeps the
    wrapper), and launch the real tiers after."""
    from matvec_mpi_multiplier_torch.ops import gemm_kernels, gemv as gemv_mod

    def kernel(real):
        def run(a, x):
            if failing[0]:
                raise RuntimeError(REAL_LAUNCH_ERROR)
            return real(a, x)
        return run

    mp.setitem(gemv_mod._KERNELS, "cuda", kernel(gemv_mod._KERNELS["cuda"]))
    mp.setitem(gemm_kernels._GEMM_KERNELS, "cuda",
               kernel(gemm_kernels._GEMM_KERNELS["cuda"]))


@pytest.mark.parametrize("op", ["matvec", "gemm", "cg"])
def test_real_kernel_error_reaches_the_caller(rng, monkeypatch, op):
    """Under a recovery policy the ladder routes around injected faults
    only: a hand-written kernel that really fails raises to the caller on
    its first attempt. No retry, no downgrade to the torch tier, no GEMV
    floor, and no breaker fed (no later request skips the kernel for it).
    The port's own rule: the JAX package's ladder takes every error."""
    a = (solver_operand(64, "float32", seed=3) if op == "cg"
         else rng.uniform(0, 10, (64, 64)).astype(np.float32))
    x = rng.uniform(0, 10, (64, 4)).astype(np.float32)
    eng = MatvecEngine(a, port_mesh(), strategy="rowwise", kernel="cuda", promote=2,
                       max_bucket=8, resilience=policies()[0])

    def request():
        if op == "cg":
            return eng.submit(op="cg", rhs=x[:, 0], rtol=1e-6).result().x
        return eng.submit(x[:, 0] if op == "matvec" else x).result()

    failing = [True]
    _failing_kernels(monkeypatch, failing)
    with pytest.raises(RuntimeError, match=r"\(cudaError 1\)"):
        request()
    h = eng.health()
    assert {k: h["counters"][k] for k in ("retries", "downgrades", "breaker_opens",
                                          "dispatch_failures")} == {
        "retries": 0, "downgrades": 0, "breaker_opens": 0, "dispatch_failures": 1}
    assert h["degraded"] == {}
    assert all(b["state"] == BREAKER_CLOSED and b["failures_total"] == 0
               for b in h["breakers"].values())
    assert not any(k.kernel == SAFE_KERNEL for k in eng._cache.keys())
    # The same engine serves through the kernel once it launches.
    failing[0] = False
    y = request()
    want = np.linalg.solve(a.astype(np.float64), x[:, 0]) if op == "cg" else (
        a @ (x[:, 0] if op == "matvec" else x))
    np.testing.assert_allclose(y.numpy(), want, rtol=1e-4 if op == "cg" else RTOL)


def test_floor_matmul_keeps_a_and_takes_one_dtype():
    """The floor's library call (``ops/gemv.py::matmul_acc``) refuses a
    right-hand side in another dtype than A, where it would have to narrow
    it on the card, and on the CPU equals the ``torch`` tier's widened
    product bitwise."""
    from matvec_mpi_multiplier_torch.ops.gemv import gemv_acc, gemv_torch, matmul_acc

    g = torch.Generator().manual_seed(0)
    a = torch.rand(16, 32, generator=g).to(torch.bfloat16)
    x = torch.rand(32, generator=g).to(torch.bfloat16)
    with pytest.raises(ValueError, match="A's dtype"):
        matmul_acc(a, x[:, None].float())
    assert gemv_acc(a, x).dtype == torch.float32
    assert torch.equal(gemv_acc(a, x), gemv_torch(a, x))


def test_real_exhaustion_halves_on_the_kernels(rng, monkeypatch):
    """A real out-of-memory error in the GEMM halves the block's bucket as
    an injected one does, and the halves run on the hand-written kernels:
    exhaustion never reaches the torch tier, nor feeds a breaker."""
    a = rng.uniform(0, 10, (64, 64)).astype(np.float32)
    x = rng.uniform(0, 10, (64, 8)).astype(np.float32)
    eng = MatvecEngine(a, port_mesh(), strategy="rowwise", kernel="cuda", promote=2,
                       max_bucket=8, resilience=policies()[0])
    with monkeypatch.context() as mp:
        from matvec_mpi_multiplier_torch.ops import gemm_kernels

        real = gemm_kernels._GEMM_KERNELS["cuda"]

        def kernel(a_, b):
            if b.shape[1] == 8:
                raise torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate")
            return real(a_, b)

        mp.setitem(gemm_kernels._GEMM_KERNELS, "cuda", kernel)
        y = eng.submit(x).result()
    np.testing.assert_allclose(y.numpy(), a @ x, rtol=RTOL)
    h = eng.health()
    assert h["counters"]["downgrades"] == 1 and h["degraded"] == {}
    assert sorted(k.bucket for k in eng._cache.keys() if k.op == "gemm") == [4, 8]
    assert not any(k.kernel == SAFE_KERNEL for k in eng._cache.keys())
    assert all(b["failures_total"] == 0 for b in h["breakers"].values())


def test_native_tier_placement_restarts_over_a_new_layout(rng, monkeypatch):
    """A placement that a reshard's commit overtakes is placed again in the
    new layout, never installed over it."""
    a = rng.uniform(0, 10, (64, 64)).astype(np.float32)
    eng = MatvecEngine(a, port_mesh(), strategy="rowwise", dtype_storage="int8c", promote=2,
                       max_bucket=8, resilience=policies()[0])
    import matvec_mpi_multiplier_torch.engine.core as core

    placed_specs, real = [], core.shard_operand

    def racing(t, spec, mesh):
        placed_specs.append(spec)
        if len(placed_specs) == 1:
            eng._layout_epoch += 1  # a commit lands mid-placement
        return real(t, spec, mesh)

    monkeypatch.setattr(core, "shard_operand", racing)
    native = eng._a_for("native")
    assert len(placed_specs) == 2 and eng._a_native is native
    assert torch.equal(native.shards[0], torch.from_numpy(a[:8]))


# ------------------------------------------------------------- solvers


@pytest.fixture()
def spd():
    a = solver_operand(96, "float64", seed=19).astype(np.float32)
    b = np.random.default_rng(1).standard_normal(96).astype(np.float32)
    return a, b


def test_solver_ladder_degrades_the_fused_tier(spd):
    """A compile fault on the fused cg key: the solve is served by the
    unfused torch tier, converges (residual recomputed in fp64), and the
    breaker and the degraded map name the fused key."""
    a, b = spd
    eng = MatvecEngine(a, port_mesh(), strategy="rowwise", promote=None,
                       solver_kernel="cuda_fused", resilience=policies()[0],
                       fault_plan=FaultPlan([FaultSpec(site="compile", kind="compile_error",
                                                       key="cg:*:cuda_fused:*")]))
    res = eng.submit(op="cg", rhs=b, rtol=1e-5).result()
    assert res.converged
    x = res.x.double().numpy()
    resid = np.linalg.norm(b.astype(np.float64) - a.astype(np.float64) @ x)
    assert resid <= 1e-4 * np.linalg.norm(b)
    h = eng.health()
    fused = [k for k in h["degraded"] if ":cuda_fused:" in k]
    assert fused and h["degraded"][fused[0]].startswith("cg:rowwise:torch:default:")
    assert h["counters"]["downgrades"] == 1 and h["counters"]["dispatch_failures"] == 0
    assert {k.kernel for k in eng._cache.keys()} == {"torch"}


def test_solver_ladder_walks_to_the_torch_tier_from_int8c(spd):
    a, b = spd
    eng = MatvecEngine(a, port_mesh(), strategy="rowwise", promote=None,
                       dtype_storage="int8c", resilience=policies()[0],
                       fault_plan=FaultPlan([FaultSpec(site="dispatch", kind="device_error",
                                                       key="cg:*:int8c", retryable=False)]))
    res = eng.submit(op="cg", rhs=b, rtol=1e-5).result()
    x = res.x.double().numpy()
    assert res.converged and np.linalg.norm(b - a.astype(np.float64) @ x) <= 1e-4 * np.linalg.norm(b)
    assert eng.health()["storage"]["native_fallback_resident"]


def test_chaos_corruption_is_refused_not_served(spd):
    """A seeded dispatch:nan lands in the answer: both packages refuse it
    with a typed error (no integrity_gate needed), and the next solve
    converges to np.linalg.solve's x."""
    a64 = solver_operand(96, "float64", seed=19)
    b = np.random.default_rng(1).standard_normal(96)
    port = MatvecEngine(a64, port_mesh(), strategy="rowwise", promote=None,
                        fault_plan=FaultPlan([FaultSpec(site="dispatch", kind="nan", times=1)],
                                             seed=0))
    ref = JaxEngine(a64, jax_make_mesh(8), strategy="rowwise", promote=None,
                    fault_plan=jres.FaultPlan([jres.FaultSpec(site="dispatch", kind="nan",
                                                              times=1)], seed=0))
    with pytest.raises(SolverDivergedError, match="non-finite"):
        port.submit(op="cg", rhs=b, rtol=1e-10).result()
    with pytest.raises(jerrors.SolverDivergedError, match="non-finite"):
        ref.submit(op="cg", rhs=b, rtol=1e-10).result()
    res = port.submit(op="cg", rhs=b, rtol=1e-10).result()
    assert res.converged
    np.testing.assert_allclose(res.x.numpy(), np.linalg.solve(a64, b), rtol=1e-8)
