"""The port's fault taxonomy and seeded fault injection against the JAX
package's (resilience/faults.py), and the engine's fault sites.

``parse_fault_spec`` and ``FaultPlan`` are compared with the JAX package's
decision by decision: the same specs and seed over the same sequence of
events (ExecKey labels and payloads, numpy in the JAX package, CPU tensors in
the port) must fire the same specs with the same actions. The engine's
fault sites are held against the JAX engine's on the same requests: the
same injected counts and the same failures. ``torch.cuda.OutOfMemoryError``
(faked here: the CPU build of PyTorch defines the class) raised in a build
or a dispatch reaches the caller as ``ResourceExhaustedError``.
"""

import numpy as np
import pytest
import torch

import matvec_mpi_multiplier_tpu.resilience.faults as jfaults
from matvec_mpi_multiplier_tpu import make_mesh as jax_make_mesh
from matvec_mpi_multiplier_tpu.engine import MatvecEngine as JaxEngine
from matvec_mpi_multiplier_tpu.tuning import reset_cache as jax_reset_cache
from matvec_mpi_multiplier_tpu.utils import errors as jerrors
from matvec_mpi_multiplier_torch import tuning
from matvec_mpi_multiplier_torch.engine import MatvecEngine
from matvec_mpi_multiplier_torch.obs import reset_hub
from matvec_mpi_multiplier_torch.parallel.mesh import make_mesh
from matvec_mpi_multiplier_torch.resilience import faults
from matvec_mpi_multiplier_torch.resilience import (
    CompileFaultError,
    DeviceFaultError,
    FaultError,
    FaultPlan,
    FaultSpec,
    ResourceExhaustedError,
    ResultIntegrityError,
    is_payload_fault,
    is_rejection,
    out_of_memory_as_exhausted,
    parse_fault_spec,
    refuse_nonfinite,
)
from matvec_mpi_multiplier_torch.obs.registry import Counter
from matvec_mpi_multiplier_torch.utils.errors import (
    AdmissionRejectedError,
    ConfigError,
    DeadlineExceededError,
    MatvecError,
)

CPU = torch.device("cpu")
POISON = 1e30
SPECS = [
    "dispatch:device_error:p=0.3",
    "compile:compile_error:key=*gemm*,times=2",
    "dispatch:latency:latency_ms=5,p=0.5;dispatch:nan:times=2,after=1",
    "dispatch:device_error:poison=1e30;dispatch:resource_exhausted:key=matvec:*,p=0.2",
    "dispatch:device_error:retryable=0,p=0.7;compile:resource_exhausted:after=3",
    " dispatch:nan:key=*:4:* ; ",
]
LABELS = [
    "matvec:rowwise:cuda:default:1:float32",
    "gemm:rowwise:cuda:default:4:float32",
    "gemm:colwise:cuda:psum:8:float64",
    "matvec:blockwise:cuda:default:1:bfloat16",
]


@pytest.fixture(autouse=True)
def cold_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("MATVEC_TUNING_CACHE", str(tmp_path / "tuning_cache.json"))
    tuning.reset_cache()
    jax_reset_cache()
    yield
    tuning.reset_cache()
    jax_reset_cache()


def action_view(action) -> tuple | None:
    """An action as the fields the two packages share."""
    if action is None:
        return None
    err = action.error
    return (action.kind, action.spec_index, action.latency_ms, action.corrupt,
            None if err is None else (type(err).__name__, err.retryable, err.injected,
                                      err.payload_fault, str(err)))


def events(rng, n=240):
    """A seeded event sequence: site, label, and a payload whose row 0 is
    poisoned in some events."""
    out = []
    for i in range(n):
        block = rng.uniform(0, 10, (16, int(rng.integers(1, 4)))).astype(np.float32)
        if rng.random() < 0.25:
            block[0, int(rng.integers(0, block.shape[1]))] = np.float32(POISON)
        vector = rng.random() < 0.3
        out.append(("dispatch" if rng.random() < 0.8 else "compile",
                    LABELS[i % len(LABELS)], block[:, 0] if vector else block))
    return out


# ------------------------------------------------------------ spec grammar


@pytest.mark.parametrize("text", SPECS)
@pytest.mark.parametrize("seed", [0, 7])
def test_plan_decisions_equal_jax_event_by_event(rng, text, seed):
    plan = parse_fault_spec(text, seed=seed)
    jplan = jfaults.parse_fault_spec(text, seed=seed)
    assert [s.__dict__ for s in plan.specs] == [
        s.__dict__ for s in jplan.specs]
    for site, label, block in events(rng):
        got = plan.check(site, label, block=torch.from_numpy(block.copy()))
        want = jplan.check(site, label, block=block)
        assert action_view(got) == action_view(want), (site, label)
    assert plan.summary() == jplan.summary()
    assert plan.total_injected == jplan.total_injected


def test_disarm_arm_and_numpy_payloads_match_jax(rng):
    text = "dispatch:device_error:poison=1e30,after=2;dispatch:nan:p=0.4"
    plan, jplan = parse_fault_spec(text, seed=3), jfaults.parse_fault_spec(text, seed=3)
    seq = events(rng, 60)
    for i, (site, label, block) in enumerate(seq):
        if i == 10:
            plan.disarm()
            jplan.disarm()
        if i == 30:
            plan.arm()
            jplan.arm()
        # A numpy payload takes the same path as the JAX package's.
        assert action_view(plan.check(site, label, block=block)) == action_view(
            jplan.check(site, label, block=block))
    assert plan.summary() == jplan.summary()


@pytest.mark.parametrize("text", [
    "", "dispatch", "nowhere:device_error", "dispatch:meltdown",
    "dispatch:device_error:p=2", "dispatch:device_error:p", "dispatch:latency",
    "dispatch:device_error:colour=red", "dispatch:device_error:times=x",
    "dispatch:device_error:times=-1", "compile:compile_error:after=-2",
])
def test_malformed_specs_raise_config_error_as_in_jax(text):
    with pytest.raises(jerrors.ConfigError):
        jfaults.parse_fault_spec(text)
    with pytest.raises(ConfigError):
        parse_fault_spec(text)


def test_fault_vocabulary_and_hash_equal_jax():
    assert faults.FAULT_SITES == jfaults.FAULT_SITES
    assert faults.FAULT_KINDS == jfaults.FAULT_KINDS
    for seed, i, serial in [(0, 0, 0), (7, 3, 99), (2**40, 1, 12345)]:
        assert faults._unit_hash(seed, i, serial) == jfaults._unit_hash(seed, i, serial)
    with pytest.raises(ConfigError):
        FaultPlan([])


def test_poison_reads_host_payloads_only():
    """Row 0 carries the signature, cast to the payload's dtype (bf16 too);
    a payload off the host never matches (reading it would wait for the
    card)."""
    plan = FaultPlan([FaultSpec(site="dispatch", kind="device_error", poison=POISON)])
    block = torch.zeros((4, 3), dtype=torch.bfloat16)
    block[0, 2] = POISON
    assert plan.check("dispatch", "x", block=block).kind == "device_error"
    assert plan.check("dispatch", "x", block=block.T.contiguous()) is None  # not row 0
    assert plan.check("dispatch", "x", block=torch.zeros(4, device="meta")) is None
    assert plan.check("dispatch", "x", block=None) is None


# --------------------------------------------------------------- taxonomy


def test_taxonomy_matches_jax():
    pairs = [(FaultError, jfaults.FaultError), (DeviceFaultError, jfaults.DeviceFaultError),
             (CompileFaultError, jfaults.CompileFaultError),
             (ResourceExhaustedError, jfaults.ResourceExhaustedError)]
    for cls, jcls in pairs:
        assert cls.default_retryable == jcls.default_retryable
        assert [c.__name__ for c in cls.__mro__] == [c.__name__ for c in jcls.__mro__]
        for kwargs in ({}, {"retryable": False}, {"injected": True, "payload_fault": True}):
            e, je = cls("m", **kwargs), jcls("m", **kwargs)
            assert (e.retryable, e.injected, e.payload_fault) == (
                je.retryable, je.injected, je.payload_fault)
            assert is_payload_fault(e) == jfaults.is_payload_fault(je)
            assert is_rejection(e) == jfaults.is_rejection(je) is False
    assert issubclass(ResultIntegrityError, MatvecError)
    assert not issubclass(ResultIntegrityError, FaultError)


def test_payload_fault_and_rejection_predicates():
    assert is_payload_fault(ResultIntegrityError("nan"))
    assert is_payload_fault(DeviceFaultError("p", payload_fault=True))
    assert not is_payload_fault(DeviceFaultError("d"))
    assert not is_payload_fault(RuntimeError("backend down"))
    assert is_rejection(AdmissionRejectedError("late"))
    assert jfaults.is_rejection(jerrors.AdmissionRejectedError("late"))
    for e in (DeadlineExceededError("d"), DeviceFaultError("x"), RuntimeError()):
        assert not is_rejection(e)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.bfloat16])
def test_refuse_nonfinite_counts_once_per_refusal(dtype):
    counter = Counter("refusals")
    jcounter = Counter("jax_refusals")
    ok = torch.arange(6, dtype=dtype).reshape(3, 2)
    assert refuse_nonfinite(ok, counter, "x") is None
    for bad_value in (float("nan"), float("inf"), float("-inf")):
        bad = ok.clone()
        bad[1, 1] = bad_value
        err = refuse_nonfinite(bad, counter, "the block")
        jerr = jfaults.refuse_nonfinite(bad.double().numpy(), jcounter, "the block")
        assert isinstance(err, ResultIntegrityError) and str(err) == str(jerr)
    assert counter.value == jcounter.value == 3
    assert refuse_nonfinite(ok.numpy() if dtype != torch.bfloat16 else ok.float().numpy(),
                            counter, "x") is None


def test_out_of_memory_maps_to_resource_exhausted():
    with pytest.raises(ResourceExhaustedError, match="the dispatch") as info:
        with out_of_memory_as_exhausted("the dispatch"):
            raise torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 8 GiB")
    assert isinstance(info.value.__cause__, torch.cuda.OutOfMemoryError)
    assert not info.value.retryable and not is_payload_fault(info.value)
    with pytest.raises(ValueError):  # anything else passes through
        with out_of_memory_as_exhausted("x"):
            raise ValueError("no")


# ------------------------------------------------------ the engine's sites


def port_engine(a, **kwargs):
    kwargs.setdefault("promote", 4)
    kwargs.setdefault("max_bucket", 8)
    return MatvecEngine(a, make_mesh(8, devices=[CPU] * 8), strategy="rowwise", **kwargs)


def jax_engine(a, **kwargs):
    kwargs.setdefault("promote", 4)
    kwargs.setdefault("max_bucket", 8)
    return JaxEngine(a, jax_make_mesh(8), strategy="rowwise", **kwargs)


@pytest.mark.parametrize("text", [
    "dispatch:device_error:p=0.5",
    "compile:compile_error:key=gemm:*",
    "dispatch:device_error:poison=1e30",
    "dispatch:resource_exhausted:key=gemm:*:8:*,times=1;dispatch:device_error:after=9,p=0.5",
])
def test_engine_fault_sites_match_jax(rng, text):
    """The same plan on both engines over the same requests: the same
    requests fail with the same error, and the plans' tallies agree (the
    compile site fires only for a key not built yet)."""
    a = rng.uniform(0, 10, (64, 64)).astype(np.float32)
    blocks = []
    for i in range(24):
        x = rng.uniform(0, 10, (64, [1, 2, 5, 8][i % 4])).astype(np.float32)
        if i % 7 == 3:
            x[0, 0] = np.float32(POISON)
        blocks.append(x[:, 0] if x.shape[1] == 1 else x)
    plan, jplan = parse_fault_spec(text, seed=5), jfaults.parse_fault_spec(text, seed=5)
    port, ref = port_engine(a, fault_plan=plan), jax_engine(a, fault_plan=jplan)
    for x in blocks:
        outcome = []
        for eng in (port, ref):
            try:
                eng.submit(x).result()
                outcome.append(None)
            except MatvecError as e:
                outcome.append((type(e).__name__, str(e)))
            except jerrors.MatvecError as e:
                outcome.append((type(e).__name__, str(e)))
        assert outcome[0] == outcome[1]
    assert plan.summary() == jplan.summary()
    counters = port.metrics.snapshot()["counters"]
    assert counters["resil_faults_injected_total"] == plan.total_injected
    assert counters["engine_dispatch_failures_total"] == ref.metrics.snapshot()[
        "counters"]["engine_dispatch_failures_total"]


def test_engine_nan_fault_and_integrity_gate(rng):
    """A "nan" action corrupts element [0] of the part: served as NaN
    without the gate, refused (ResultIntegrityError, counted, on the
    timeline) with it — as the JAX engine does."""
    a = rng.uniform(0, 10, (64, 64)).astype(np.float32)
    x = rng.uniform(0, 10, (64, 3)).astype(np.float32)
    spec = "dispatch:nan:times=1"
    port = port_engine(a, fault_plan=parse_fault_spec(spec))
    ref = jax_engine(a, fault_plan=jfaults.parse_fault_spec(spec))
    y, jy = port.submit(x).result().numpy(), np.asarray(ref.submit(x).result())
    assert np.isnan(y[0, 0]) and np.isnan(jy[0, 0])
    assert np.isnan(y).sum() == np.isnan(jy).sum() == 1
    hub = reset_hub()  # the engine emits on the process hub
    gated = port_engine(a, fault_plan=parse_fault_spec(spec), integrity_gate=True)
    fut = gated.submit(x)
    with pytest.raises(ResultIntegrityError):
        fut.result()
    with pytest.raises(ResultIntegrityError):  # cached, counted once
        fut.result()
    assert gated.metrics.snapshot()["counters"]["engine_integrity_failures_total"] == 1
    assert [e["kind"] for e in hub.events()] == ["submit", "integrity_refused"]
    assert gated.tracer.traces()[-1]["status"] == "integrity_failed"
    assert torch.isfinite(gated.submit(x).result()).all()  # times=1: healthy again


def test_engine_latency_fault_stalls_the_dispatch(rng):
    a = rng.uniform(0, 10, (64, 64)).astype(np.float32)
    eng = port_engine(a, fault_plan=parse_fault_spec("dispatch:latency:latency_ms=30"))
    x = rng.uniform(0, 10, 64).astype(np.float32)
    eng.submit(x).result()  # builds
    trace = eng.submit(x)._trace
    dispatch = [s for s in trace._roots[0].children if s.name == "dispatch"]
    assert dispatch  # the stall happens before the dispatch span opens
    submit_ms = trace._roots[0].duration_ms
    assert submit_ms >= 30.0


@pytest.mark.parametrize("where", ["build", "dispatch"])
def test_engine_out_of_memory_is_resource_exhausted(rng, monkeypatch, where):
    """A torch.cuda.OutOfMemoryError raised while a program is built (on the
    card: captured) or run reaches the caller as ResourceExhaustedError; the
    request's trace closes as dispatch_failed and the timeline says so."""
    a = rng.uniform(0, 10, (64, 64)).astype(np.float32)
    hub = reset_hub()
    eng = port_engine(a)

    def oom(*args, **kwargs):
        raise torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB")

    if where == "build":
        monkeypatch.setattr(eng, "_build_matvec", oom)
    else:
        monkeypatch.setattr(eng, "_build_matvec", lambda: oom)
    with pytest.raises(ResourceExhaustedError, match=f"the {where} of matvec:rowwise"):
        eng.submit(rng.uniform(0, 10, 64).astype(np.float32))
    assert eng.tracer.traces()[-1]["status"] == "dispatch_failed"
    failed = [e for e in hub.events() if e["kind"] == "dispatch_failed"]
    assert failed and failed[0]["error"] == "ResourceExhaustedError"
    assert eng.metrics.snapshot()["counters"]["engine_dispatch_failures_total"] == 1
