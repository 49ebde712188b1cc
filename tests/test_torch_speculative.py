"""Speculative dispatch in the port (``ops/speculative.py`` and the engine's
two-tier path) against the JAX package (``ops/speculative.py``,
tests/test_speculative.py).

The pure functions are held bitwise to the JAX package's. The check's
arithmetic is held to the JAX formula (``solvers/common.py``'s
``residual_norm``, ``convergence_threshold`` and ``above_tolerance`` on the
same arrays): on operands whose products are exact in fp32 the estimate is
within 1 ulp and the verdict equal; on random operands within 1e-4
relative, the verdict equal away from the threshold.

The JAX package's speculative engine cannot be the engine oracle here:
under the installed jax its quantized ``shard_map`` programs raise a
``TypeError`` and the JAX engine serves native (ROADMAP.md, queue C). So the
ten contracts of tests/test_speculative.py run on the port's engine against
the numpy fp64 product and the port's plain engine, on rowwise, colwise and
blockwise at p = 8 and on the 2x2 mesh; where the JAX engine's own test
passes here (rtol None, a sub-floor rtol, a non-positive rtol, a poisoned
candidate) both packages run and their outcomes are compared.
"""

import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import matvec_mpi_multiplier_tpu as mv_jax
from matvec_mpi_multiplier_tpu import tuning as jtuning
from matvec_mpi_multiplier_tpu.engine import MatvecEngine as JMatvecEngine
from matvec_mpi_multiplier_tpu.ops import quantize as jq
from matvec_mpi_multiplier_tpu.ops import speculative as jspec
from matvec_mpi_multiplier_tpu.resilience import FaultPlan as JFaultPlan
from matvec_mpi_multiplier_tpu.resilience import FaultSpec as JFaultSpec
from matvec_mpi_multiplier_tpu.resilience import ResultIntegrityError as JResultIntegrityError
from matvec_mpi_multiplier_tpu.solvers import common as jcommon
from matvec_mpi_multiplier_tpu.tuning import cache as jcache
from matvec_mpi_multiplier_tpu.tuning import cost_model as jcm
from matvec_mpi_multiplier_tpu.utils.errors import ConfigError as JConfigError
from matvec_mpi_multiplier_torch import get_strategy, tuning
from matvec_mpi_multiplier_torch.bench import serve
from matvec_mpi_multiplier_torch.engine import GlobalScheduler, MatrixRegistry, MatvecEngine
from matvec_mpi_multiplier_torch.engine import core
from matvec_mpi_multiplier_torch.obs.__main__ import render_storage
from matvec_mpi_multiplier_torch.obs.registry import MetricsRegistry
from matvec_mpi_multiplier_torch.obs.slo import DEFAULT_TARGETS, SloMonitor
from matvec_mpi_multiplier_torch.ops import quantize as tq
from matvec_mpi_multiplier_torch.ops import speculative as spec
from matvec_mpi_multiplier_torch.parallel.mesh import make_mesh, shard, unshard
from matvec_mpi_multiplier_torch.resilience import (
    FaultPlan,
    FaultSpec,
    ResiliencePolicy,
    ResultIntegrityError,
    parse_fault_spec,
)
from matvec_mpi_multiplier_torch.tuning.cost_model import Calibration, CostModel
from matvec_mpi_multiplier_torch.utils.convert import from_numpy
from matvec_mpi_multiplier_torch.utils.errors import ConfigError, ResidencyError

CPU = torch.device("cpu")
M, K = 64, 256
RTOL = 1e-3
# (strategy, p): p = 8 is the 2x4 mesh, p = 4 the 2x2 mesh.
CONFIGS = [("rowwise", 8), ("colwise", 8), ("blockwise", 8),
           ("rowwise", 4), ("colwise", 4), ("blockwise", 4)]
CONFIG_IDS = [f"{s}-p{p}" for s, p in CONFIGS]
# The JAX engine beside the port's: the p = 8 configs.
JAX_CONFIGS = CONFIGS[:3]
# fp32 products of k >= 256 terms in another order than the plain engine's:
# the numpy fp64 oracle holds a native result to this.
NATIVE_RTOL = 1e-5


@pytest.fixture(autouse=True)
def cold_cache(tmp_path, monkeypatch):
    """Both packages' tuning caches on an empty temp file."""
    monkeypatch.setenv("MATVEC_TUNING_CACHE", str(tmp_path / "tuning_cache.json"))
    tuning.reset_cache()
    jtuning.reset_cache()
    yield
    tuning.reset_cache()
    jtuning.reset_cache()


def port_mesh(p=8):
    return make_mesh(p, devices=[CPU] * p)


def _well_conditioned(seed=0):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.0, 10.0, (M, K)).astype(np.float32)
    x = rng.uniform(0.0, 10.0, K).astype(np.float32)
    return a, x


def _adversarial(seed=3):
    """JAX's operand the int8c tier cannot serve within RTOL: A's rows
    projected orthogonal to x, so A x nearly cancels while the quantization
    error stays at the grid's scale."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((M, K)).astype(np.float64)
    x = rng.standard_normal(K).astype(np.float64)
    a = a - np.outer(a @ x, x) / float(x @ x)
    return a.astype(np.float32), x.astype(np.float32)


def _engine(a, strategy="rowwise", p=8, **kw):
    kw.setdefault("promote", 2)
    kw.setdefault("max_bucket", 8)
    return MatvecEngine(a, port_mesh(p), strategy=strategy, dtype_storage="speculate", **kw)


def _plain(a, strategy="rowwise", p=8, **kw):
    kw.setdefault("promote", 2)
    kw.setdefault("max_bucket", 8)
    return MatvecEngine(a, port_mesh(p), strategy=strategy, **kw)


def _jax_engine(a, strategy="rowwise", p=8, **kw):
    kw.setdefault("promote", 2)
    kw.setdefault("max_bucket", 8)
    return JMatvecEngine(a, mv_jax.make_mesh(p), strategy=strategy,
                         dtype_storage="speculate", **kw)


def _oracle(a, x):
    return a.astype(np.float64) @ x.astype(np.float64)


def _rel(y, oracle) -> float:
    y = y.numpy() if isinstance(y, torch.Tensor) else np.asarray(y)
    return float(np.linalg.norm(y - oracle) / np.linalg.norm(oracle))


# ------------------------------------------- pure functions, bitwise JAX


def test_constants_are_the_jax_packages():
    for name in ("SPEC_SEED", "SPEC_MARGIN", "SPEC_RTOL_FLOOR", "MIN_PROBES",
                 "MAX_PROBES", "_CHERNOFF_RATE"):
        assert getattr(spec, name) == getattr(jspec, name), name
    assert spec.SPEC_RTOL_FLOOR == tq.INT8C_EPS == jq.INT8C_EPS
    assert core.SPECULATE == "speculate" and core.SPEC_STORAGE == "int8c"


RTOL_GRID = [1e-12, 1e-9, 1e-7, jspec.SPEC_RTOL_FLOOR / 10, jspec.SPEC_RTOL_FLOOR,
             jspec.SPEC_RTOL_FLOOR * (1 + 2**-52), 1e-4, 1e-3, 0.01, 0.1, 0.5,
             0.999999, 1.0, 2.0, 1e9]


@pytest.mark.parametrize("rtol", RTOL_GRID)
def test_eligible_and_probe_count_equal_jax(rtol):
    assert spec.eligible(rtol) == jspec.eligible(rtol)
    assert spec.probe_count(rtol) == jspec.probe_count(rtol)
    assert spec.MIN_PROBES <= spec.probe_count(rtol) <= spec.MAX_PROBES


@pytest.mark.parametrize("rtol", [0.0, -1e-3, float("nan")])
def test_probe_count_refuses_what_jax_refuses(rtol):
    with pytest.raises(ValueError, match="rtol must be > 0"):
        spec.probe_count(rtol)
    with pytest.raises(ValueError, match="rtol must be > 0"):
        jspec.probe_count(rtol)
    assert spec.eligible(None) is jspec.eligible(None) is False


@pytest.mark.parametrize("s, m", [(33, 64), (8, 1), (128, 300), (33, 4096)])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_probe_matrix_is_the_jax_packages(s, m, dtype):
    u = spec.probe_matrix(s, m, dtype)
    assert u.dtype == dtype and u.shape == (s, m)
    np.testing.assert_array_equal(u, jspec.probe_matrix(s, m, dtype))
    t = spec.probe_matrix(s, m, torch.float32 if dtype == np.float32 else torch.float64)
    np.testing.assert_array_equal(t.numpy(), u)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_project_probes_is_the_jax_packages(dtype):
    rng = np.random.default_rng(5)
    a = rng.standard_normal((96, 200)).astype(dtype)
    u = jspec.probe_matrix(33, 96, dtype)
    want = jspec.project_probes(u, a, dtype)
    np.testing.assert_array_equal(spec.project_probes(u, a, dtype), want)
    # Torch operands on the CPU: the same numpy product, bitwise.
    got = spec.project_probes(torch.from_numpy(u), torch.from_numpy(a))
    assert got.dtype == torch.from_numpy(a).dtype
    np.testing.assert_array_equal(got.numpy(), want)


def test_bf16_probes_and_projection_round_like_jax():
    import ml_dtypes

    bf16 = ml_dtypes.bfloat16
    rng = np.random.default_rng(6)
    a = rng.standard_normal((32, 64)).astype(bf16)
    u_j = jspec.probe_matrix(33, 32, bf16)
    u_t = spec.probe_matrix(33, 32, torch.bfloat16)
    np.testing.assert_array_equal(u_t.float().numpy(), u_j.astype(np.float32))
    p_j = jspec.project_probes(u_j, a, bf16)
    p_t = spec.project_probes(u_t, from_numpy(a, "cpu"), torch.bfloat16)
    assert p_t.dtype == torch.bfloat16
    np.testing.assert_array_equal(p_t.float().numpy(), p_j.astype(np.float32))


# ------------------------------------------------ the check's arithmetic


def _jax_check(px, uy, y_hat, rtol, probes):
    """The JAX package's check (ops/speculative.py, build_speculative's
    spec_fn) from its two products, with solvers/common.py's functions."""
    import jax

    diff = jnp.asarray(px) - jnp.asarray(uy)
    y_hat = jnp.asarray(y_hat)
    scale = 1.0 / jnp.sqrt(jnp.asarray(float(probes), diff.dtype))
    if y_hat.ndim == 1:
        est = jcommon.residual_norm(diff) * scale
        y_norm = jcommon.residual_norm(y_hat)
    else:
        est = jax.vmap(jcommon.residual_norm, in_axes=1)(diff) * scale
        y_norm = jax.vmap(jcommon.residual_norm, in_axes=1)(y_hat)
    threshold = jcommon.convergence_threshold(
        jnp.asarray(jspec.SPEC_MARGIN, est.dtype) * jnp.float32(rtol), y_norm)
    miss = jcommon.above_tolerance(est, threshold)
    est_rel = jnp.max(jnp.where(y_norm > 0, est / jnp.where(y_norm > 0, y_norm, 1), est))
    return float(est_rel), bool(~jnp.any(miss))


def _port_check(px, uy, y_hat, rtol, probes):
    est, accept = spec.verdict(torch.from_numpy(px), torch.from_numpy(uy),
                               torch.from_numpy(y_hat), torch.tensor(rtol, dtype=torch.float32),
                               probes)
    assert est.dtype == torch.float32 and accept.dtype == torch.bool and accept.dim() == 0
    return float(est), bool(accept)


def _exact_operands(face: str, seed: int):
    """Small-integer P, U, x and y_hat: every product and sum is exact in
    fp32 whatever the order, so both packages see the same px and uy."""
    rng = np.random.default_rng(seed)
    s, k, m = 33, 48, 40
    p = rng.integers(-3, 4, (s, k)).astype(np.float32)
    u = rng.integers(-3, 4, (s, m)).astype(np.float32)
    shape = (k,) if face == "vector" else (k, 4)
    x = rng.integers(-2, 3, shape).astype(np.float32)
    y = rng.integers(-9, 10, (m,) if face == "vector" else (m, 4)).astype(np.float32)
    if face == "padded":  # the last column is a zero pad column
        x[:, -1] = 0
        y[:, -1] = 0
    return p, u, x, y, p @ x, u @ y


@pytest.mark.parametrize("face", ["vector", "block", "padded"])
@pytest.mark.parametrize("seed", range(4))
def test_check_equals_the_jax_formula_on_exact_operands(face, seed):
    """est within 1 ulp of fp32, accept equal, at tolerances on both sides
    of the estimate and at its threshold exactly (strict ``>``)."""
    _, _, _, y, px, uy = _exact_operands(face, seed)
    est, _ = _jax_check(px, uy, y, 1.0, 33)
    assert est > 0
    for rtol in (est * 0.5, est * 2 * (1 - 1e-6), est * 2, est * 2 * (1 + 1e-6), est * 4, 1e-3):
        rtol = float(np.float32(rtol))
        j_est, j_ok = _jax_check(px, uy, y, rtol, 33)
        t_est, t_ok = _port_check(px, uy, y, rtol, 33)
        assert abs(t_est - j_est) <= np.spacing(np.float32(j_est)), (t_est, j_est)
        assert t_ok == j_ok, rtol
    if face == "padded":
        # The pad column alone: est 0 against a threshold of 0, a pass.
        assert _port_check(px[:, -1:], uy[:, -1:], y[:, -1:], 1e-9, 33) == (0.0, True)


@pytest.mark.parametrize("face", ["vector", "block"])
def test_check_equals_the_jax_formula_on_random_operands(face):
    """Gaussian operands, products in each package's own order: est within
    1e-4 relative (the products differ in their last bits), the verdict
    equal at tolerances 10% away from the estimate."""
    rng = np.random.default_rng(11)
    s, k, m = 33, 256, 64
    p = rng.standard_normal((s, k)).astype(np.float32)
    u = rng.standard_normal((s, m)).astype(np.float32)
    x = rng.standard_normal((k,) if face == "vector" else (k, 3)).astype(np.float32)
    y = rng.standard_normal((m,) if face == "vector" else (m, 3)).astype(np.float32)
    px_t = (torch.from_numpy(p) @ torch.from_numpy(x)).numpy()
    uy_t = (torch.from_numpy(u) @ torch.from_numpy(y)).numpy()
    j_est, _ = _jax_check(np.asarray(jnp.asarray(p) @ jnp.asarray(x)),
                          np.asarray(jnp.asarray(u) @ jnp.asarray(y)), y, 1.0, s)
    t_est, _ = _port_check(px_t, uy_t, y, 1.0, s)
    assert t_est == pytest.approx(j_est, rel=1e-4)
    for factor in (0.45, 0.55, 1.8, 2.2):
        rtol = float(j_est * factor)
        assert _port_check(px_t, uy_t, y, rtol, s)[1] == _jax_check(
            np.asarray(jnp.asarray(p) @ jnp.asarray(x)),
            np.asarray(jnp.asarray(u) @ jnp.asarray(y)), y, rtol, s)[1]


@pytest.mark.parametrize("name,p", CONFIGS, ids=CONFIG_IDS)
@pytest.mark.parametrize("face", [None, 4])
def test_build_speculative_matches_the_jax_check(name, p, face):
    """The fused program on the CPU mesh: the candidate is the strategy's
    int8c program, bitwise, and accept is the JAX formula's on the same
    candidate, P, U and x. Both estimates are dominated by the products'
    rounding, which the shards sum in their own order: the adversarial
    operand misses, its estimate within 1e-2 relative of the formula's (A x
    cancels, and so does P x); the well-conditioned one passes, its
    estimate (a residual near fp32's rounding of P x) within a quarter of
    the formula's."""
    strat, mesh = get_strategy(name), port_mesh(p)
    s = spec.probe_count(spec.SPEC_RTOL_FLOOR)
    fn = spec.build_speculative(strat, mesh, probes=s, b=face)
    for (a, x0), want in ((_well_conditioned(), True), (_adversarial(), False)):
        x = x0 if face is None else np.stack([x0, 2 * x0, x0 + 0.25, 0 * x0], 1).astype(np.float32)
        at = from_numpy(a, "cpu")
        qa = tq.quantize_matrix(at, "int8c", contraction_shards=strat.contraction_shards(mesh))
        u = spec.probe_matrix(s, M, torch.float32)
        pm = spec.project_probes(u, at)
        place = strat.place_batched if face is not None else strat.place
        qa_p, x_p = place(qa, from_numpy(x, "cpu"), mesh)
        rtol = torch.tensor(RTOL, dtype=torch.float32)
        y, est, accept = fn(qa_p, shard(pm, spec.probe_spec(strat, mesh), mesh), u, x_p, rtol)
        ref = strat.build_batched(mesh, dtype_storage="int8c") if face is not None else \
            strat.build(mesh, dtype_storage="int8c")
        assert torch.equal(y, ref(qa, from_numpy(x, "cpu")))
        px = np.asarray(jnp.asarray(pm.numpy()) @ jnp.asarray(x))
        uy = np.asarray(jnp.asarray(u.numpy()) @ jnp.asarray(y.numpy()))
        j_est, j_ok = _jax_check(px, uy, y.numpy(), RTOL, s)
        assert float(est) == pytest.approx(j_est, rel=1e-2 if not want else 0.25)
        assert bool(accept) == j_ok == want


# ------------------------------------------- the engine's ten contracts


@pytest.mark.parametrize("name,p", CONFIGS, ids=CONFIG_IDS)
def test_well_conditioned_stream_never_escalates(name, p):
    a, x = _well_conditioned()
    engine = _engine(a, name, p)
    oracle = _oracle(a, x)
    for _ in range(5):
        assert _rel(engine.submit(x, rtol=RTOL).result(), oracle) <= RTOL
    h = engine.health()
    assert h["counters"]["speculative_dispatches"] == 5
    assert h["counters"]["escalations"] == 0
    assert h["storage"]["escalation_rate"] == 0.0
    assert h["storage"]["speculative"] is True


@pytest.mark.parametrize("name,p", CONFIGS, ids=CONFIG_IDS)
def test_adversarial_operand_escalates_and_answer_is_native(name, p):
    a, x = _adversarial()
    armed, plain = _engine(a, name, p), _plain(a, name, p)
    y = armed.submit(x, rtol=RTOL).result()
    h = armed.health()
    assert h["counters"]["speculative_dispatches"] == 1
    assert h["counters"]["escalations"] == 1
    assert h["storage"]["escalation_rate"] == 1.0
    assert torch.equal(y, plain.submit(x).result())
    materialize = armed.tracer.traces()[-1]["spans"][-1]
    escalate = materialize["children"][0]
    assert (materialize["name"], escalate["name"]) == ("materialize", "escalate")
    assert escalate["attrs"] == {"op": "matvec", "kind": "escalate"}
    assert [c["name"] for c in escalate["children"]] == ["exec_lookup", "dispatch"]


@pytest.mark.parametrize("name,p", CONFIGS, ids=CONFIG_IDS)
def test_gemm_block_escalates_per_chunk(name, p):
    """Two chunks of the widest bucket (8 + 3 columns): each escalates as a
    whole, the answer bitwise the plain engine's."""
    a, x = _adversarial()
    armed, plain = _engine(a, name, p), _plain(a, name, p)
    xb = np.stack([x * (1 + j / 8) for j in range(11)], 1).astype(np.float32)
    y = armed.submit(xb, rtol=RTOL).result()
    assert tuple(y.shape) == (M, 11)
    h = armed.health()["counters"]
    assert h["speculative_dispatches"] == 2 and h["escalations"] == 2
    assert torch.equal(y, plain.submit(xb).result())


@pytest.mark.parametrize("name,p", CONFIGS, ids=CONFIG_IDS)
def test_rtol_none_is_bitwise_native(name, p):
    a, x = _well_conditioned(seed=1)
    armed, plain = _engine(a, name, p), _plain(a, name, p)
    xb = np.stack([x, 2 * x, x + 1], 1).astype(np.float32)
    for req in (x, xb):
        assert torch.equal(armed.submit(req).result(), plain.submit(req).result())
    h = armed.health()["counters"]
    assert h["speculative_dispatches"] == 0 and h["storage_fallbacks"] == 0
    if (name, p) in JAX_CONFIGS:
        jeng = _jax_engine(a, name, p)
        np.testing.assert_allclose(armed.submit(x).result().numpy(), jeng.submit(x).result(),
                                   rtol=NATIVE_RTOL)
        jh = jeng.health()["counters"]
        assert (jh["speculative_dispatches"], jh["storage_fallbacks"]) == (0, 0)


@pytest.mark.parametrize("name,p", CONFIGS, ids=CONFIG_IDS)
def test_sub_floor_rtol_serves_native(name, p):
    a, x = _well_conditioned(seed=2)
    armed = _engine(a, name, p)
    tight = spec.SPEC_RTOL_FLOOR / 10.0
    assert not spec.eligible(tight)
    y = armed.submit(x, rtol=tight).result()
    h = armed.health()["counters"]
    assert h["speculative_dispatches"] == 0 and h["storage_fallbacks"] == 1
    np.testing.assert_allclose(y.numpy(), _oracle(a, x), rtol=NATIVE_RTOL)
    assert torch.equal(y, _plain(a, name, p).submit(x).result())
    if (name, p) in JAX_CONFIGS:
        jeng = _jax_engine(a, name, p)
        np.testing.assert_allclose(y.numpy(), jeng.submit(x, rtol=tight).result(),
                                   rtol=NATIVE_RTOL)
        jh = jeng.health()["counters"]
        assert (jh["speculative_dispatches"], jh["storage_fallbacks"]) == (0, 1)


@pytest.mark.parametrize("name,p", CONFIGS, ids=CONFIG_IDS)
def test_nonpositive_rtol_rejected(name, p):
    a, x = _well_conditioned(seed=2)
    armed = _engine(a, name, p)
    jeng = _jax_engine(a, name, p) if (name, p) in JAX_CONFIGS else None
    for bad in (0.0, -1e-3):
        with pytest.raises(ConfigError, match="rtol must be > 0"):
            armed.submit(x, rtol=bad)
        if jeng is not None:
            with pytest.raises(JConfigError):
                jeng.submit(x, rtol=bad)
    assert armed.stats.dispatches == 0


def test_probe_set_is_seeded_and_shared():
    s = spec.probe_count(spec.SPEC_RTOL_FLOOR)
    np.testing.assert_array_equal(spec.probe_matrix(s, M, np.float32),
                                  spec.probe_matrix(s, M, np.float32))
    a, _ = _well_conditioned()
    e1, e2 = _engine(a), _engine(a)
    for t1, t2 in zip(e1._spec[1:], e2._spec[1:]):
        t1 = unshard(t1) if not isinstance(t1, torch.Tensor) else t1
        t2 = unshard(t2) if not isinstance(t2, torch.Tensor) else t2
        assert torch.equal(t1, t2)


@pytest.mark.parametrize("name,p", CONFIGS, ids=CONFIG_IDS)
def test_verdicts_deterministic_across_engines(name, p):
    for (a, x), esc in ((_adversarial(), 1), (_well_conditioned(), 0)):
        e1, e2 = _engine(a, name, p), _engine(a, name, p)
        assert torch.equal(e1.submit(x, rtol=RTOL).result(), e2.submit(x, rtol=RTOL).result())
        assert e1.health()["counters"]["escalations"] == esc
        assert e2.health()["counters"]["escalations"] == esc


@pytest.mark.parametrize("name,p", CONFIGS, ids=CONFIG_IDS)
def test_poisoned_candidate_fails_typed_never_served(name, p):
    """A ``nan`` fault at dispatch with the gate off: ResultIntegrityError,
    the refusal cached, the stream recovering; the JAX engine refuses too."""
    a, x = _well_conditioned()
    armed = _engine(a, name, p, fault_plan=FaultPlan([FaultSpec(site="dispatch", kind="nan",
                                                                times=1)]))
    assert armed.integrity_gate is False
    fut = armed.submit(x, rtol=RTOL)
    with pytest.raises(ResultIntegrityError):
        fut.result()
    assert armed.health()["counters"]["integrity_failures"] == 1
    with pytest.raises(ResultIntegrityError):
        fut.result()
    assert armed.health()["counters"]["integrity_failures"] == 1
    assert armed.health()["counters"]["speculative_dispatches"] == 1
    assert torch.isfinite(armed.submit(x, rtol=RTOL).result()).all()
    if (name, p) in JAX_CONFIGS:
        jeng = _jax_engine(a, name, p, fault_plan=JFaultPlan(
            [JFaultSpec(site="dispatch", kind="nan", times=1)]))
        jfut = jeng.submit(x, rtol=RTOL)
        with pytest.raises(JResultIntegrityError):
            jfut.result()
        assert jeng.health()["counters"]["integrity_failures"] == 1
        assert np.all(np.isfinite(jeng.submit(x, rtol=RTOL).result()))


@pytest.mark.parametrize("name,p", CONFIGS, ids=CONFIG_IDS)
def test_mixed_stream_compiles_nothing_after_warmup(name, p):
    a, _ = _well_conditioned()
    engine = _engine(a, name, p)
    widths = (1, 2, 3, 4, 6, 8)
    engine.warmup(widths)
    rng = np.random.default_rng(7)
    pool = {w: rng.uniform(0.0, 10.0, (K, w)).astype(np.float32) for w in widths}
    warm = []
    for w in widths:
        xw = pool[w][:, 0] if w == 1 else pool[w]
        warm.append(engine.submit(xw))
        warm.append(engine.submit(xw, rtol=RTOL))
    for f in warm:
        f.result()
    compiles = engine.stats.compiles
    futures = []
    for i, w in enumerate(rng.choice(widths, size=200)):
        xw = pool[w][:, 0] if w == 1 else pool[w]
        futures.append(engine.submit(xw, rtol=RTOL if i % 2 else None))
    for f in futures:
        f.result()
    h = engine.health()["counters"]
    assert engine.stats.compiles == compiles
    assert h["speculative_dispatches"] > 0 and h["escalations"] == 0


def test_escalations_build_nothing_after_warmup():
    """An escalation re-dispatches through the native programs warmup
    built: a warmed engine under adversarial traffic builds nothing."""
    a, x = _adversarial()
    engine = _engine(a)
    engine.warmup((1, 3, 8))
    compiles = engine.stats.compiles
    for req in (x, np.stack([x, x, x], 1), np.stack([x] * 8, 1)):
        engine.submit(req.astype(np.float32), rtol=RTOL).result()
    assert engine.stats.compiles == compiles
    # b* = 2: the vector, then each block as one chunk.
    assert engine.health()["counters"]["escalations"] == 3


# ------------------------------------------------------------ residency


@pytest.mark.parametrize("name,p", CONFIGS, ids=CONFIG_IDS)
def test_speculative_set_is_accounted_placed_and_released(name, p):
    a, x = _well_conditioned()
    listened = []
    armed = _engine(a, name, p, retain_host=True,
                    residency_listener=lambda d, r: listened.append((d, r)))
    strat = get_strategy(name)
    qa = jq.quantize_matrix(a, "int8c", contraction_shards=strat.contraction_shards(port_mesh(p)))
    spec_bytes = qa.nbytes + 33 * (M + K) * 4
    assert armed.spec_resident_bytes == spec_bytes
    assert armed.resident_bytes == a.nbytes + spec_bytes
    first = armed.submit(x, rtol=RTOL).result()
    released = armed.release_residency()
    assert released == listened[0][0] and armed.device_resident_bytes == 0
    assert armed._spec is None and armed.n_executables == 0
    # A dispatch places both again, bitwise, and captures again.
    assert torch.equal(armed.submit(x, rtol=RTOL).result(), first)
    assert [r for _, r in listened] == ["resident", "released", "resident"]
    assert armed.exec_signature()[-2:] == ("speculate", 33)
    assert len(_plain(a, name, p).exec_signature()) == len(armed.exec_signature()) - 2


def test_registry_accounts_the_speculative_set():
    a, x = _well_conditioned()
    b = a[::-1].copy()
    probe = _engine(a)
    reg = MatrixRegistry(port_mesh(), hbm_budget=probe.resident_bytes, strategy="rowwise",
                         promote=2, max_bucket=8, dtype_storage="speculate")
    reg.register("t0", a)
    reg.register("t1", b)
    y0 = reg.submit("t0", x, rtol=RTOL).result()
    reg.submit("t1", x, rtol=RTOL).result()  # evicts t0: a budget of one
    assert not reg._entry("t0").engine.resident
    assert torch.equal(reg.submit("t0", x, rtol=RTOL).result(), y0)
    h = reg.health()["hbm"]
    assert h["charged_bytes"] == probe.resident_bytes and h["overshoots"] == 0
    assert h["per_tenant"] == {"t0": probe.resident_bytes}
    reg.close()


def test_a_tiling_strategy_refuses_speculation():
    a, _ = _well_conditioned()
    with pytest.raises(ConfigError, match="A-tiling"):
        MatvecEngine(a, port_mesh(), strategy="colwise_overlap", dtype_storage="speculate")
    with pytest.raises(KeyError, match="quantized-storage kernel"):
        MatvecEngine(a, port_mesh(), dtype_storage="speculate", kernel="auto")


def test_bf16_engine_stores_p_in_bf16_and_serves():
    import ml_dtypes

    rng = np.random.default_rng(9)
    a = rng.uniform(0.0, 10.0, (M, K)).astype(ml_dtypes.bfloat16)
    x = rng.uniform(0.0, 10.0, K).astype(ml_dtypes.bfloat16)
    armed = _engine(a)
    assert armed._spec[1].dtype == torch.bfloat16 and armed._spec[2].dtype == torch.bfloat16
    y = armed.submit(x, rtol=1e-2).result()
    assert y.dtype == torch.bfloat16
    assert _rel(y.float(), _oracle(a.astype(np.float32), x.astype(np.float32))) <= 1e-2
    assert armed.health()["counters"]["speculative_dispatches"] == 1


# -------------------------------------------------------------- reshard


PAIRS = [("rowwise", "colwise"), ("colwise", "blockwise"), ("blockwise", "rowwise"),
         ("rowwise", "blockwise")]


@pytest.mark.parametrize("src,dst", PAIRS)
@pytest.mark.parametrize("p", [8, 4])
def test_reshard_of_an_armed_engine_is_a_fresh_armed_engine(src, dst, p):
    a, x = _well_conditioned()
    xb = np.stack([x, 2 * x, x + 1, x - 1], 1).astype(np.float32)
    armed = _engine(a, src, p, retain_host=True)
    armed.submit(x, rtol=RTOL).result()
    out = armed.reshard(dst, warm_widths=(1, 4))
    assert out["migrated"] and armed.strategy.name == dst
    fresh = _engine(a, dst, p)
    for st_a, st_b in zip(armed._spec[:2], fresh._spec[:2]):
        for sa, sb in zip(st_a.shards, st_b.shards):
            leaves = zip(sa.leaves, sb.leaves) if hasattr(sa, "leaves") else ((sa, sb),)
            for la, lb in leaves:
                assert (la is None and lb is None) or torch.equal(la, lb)
    assert armed.spec_storage_block == fresh.spec_storage_block
    assert armed.resident_bytes == fresh.resident_bytes
    assert armed.device_resident_bytes == fresh.device_resident_bytes
    for req in (x, xb):
        assert torch.equal(armed.submit(req, rtol=RTOL).result(),
                           fresh.submit(req, rtol=RTOL).result())
    assert armed.health()["counters"]["escalations"] == 0


def test_reshard_that_changes_the_block_needs_the_host_a():
    a, _ = _well_conditioned()
    armed = _engine(a, "rowwise", 8)
    with pytest.raises(ResidencyError, match="retain_host"):
        armed.reshard("colwise")
    assert armed.strategy.name == "rowwise"


# ------------------------------------------------------------ consumers


def test_prediction_config_and_predict_equal_jax():
    a, _ = _well_conditioned()
    fields = dict(flops=8e10, mem_bps=2e10, alpha_s={"collective": 5e-4, "permute": 4e-4},
                  beta_bps={"collective": 7e8, "permute": 7e8}, p=8, level="full", probes={})
    model, jmodel = CostModel(Calibration(**fields)), jcm.CostModel(jcm.Calibration(**fields))
    for name in ("rowwise", "colwise", "blockwise"):
        for armed in (True, False):
            kw = dict(dtype_storage="speculate") if armed else {}
            eng = MatvecEngine(a, port_mesh(), strategy=name, promote=2, max_bucket=8, **kw)
            jeng = JMatvecEngine(a, mv_jax.make_mesh(8), strategy=name, promote=2,
                                 max_bucket=8, **kw)
            for b in (1, 2, 3, 5, 8):
                for rtol in (None, spec.SPEC_RTOL_FLOOR / 2, spec.SPEC_RTOL_FLOOR, 1e-3):
                    cfg = eng.prediction_config(b, rtol)
                    assert cfg == jeng.prediction_config(b, rtol)
                    assert (cfg["storage"] == "speculate") == (armed and spec.eligible(rtol))
                    got, want = model.predict(**cfg), jmodel.predict(**cfg)
                    assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_a_speculate_winner_arms_the_engine_from_either_package(writer, tmp_path):
    """A tuning-cache record with a ``speculate`` winner, written by either
    package under the other's key, loads in both: it arms the port's engine
    and the JAX package's."""
    a, x = _well_conditioned()
    path = tmp_path / "tuning_cache.json"
    keys = (tuning.storage_key("rowwise", M, K, 8, "float32"),
            jtuning.storage_key("rowwise", M, K, 8, "float32"))
    cache = (tuning.TuningCache if writer == "port" else jcache.TuningCache).load(path)
    for key in keys:
        cache.record(key, {"storage": "speculate", "time_s": 1e-4})
    cache.save()
    tuning.reset_cache()
    jtuning.reset_cache()
    eng = MatvecEngine(a, port_mesh(), strategy="rowwise", dtype_storage="auto")
    assert (eng.storage, eng.storage_reason, eng.speculative) == ("native", "tuned", True)
    assert _rel(eng.submit(x, rtol=RTOL).result(), _oracle(a, x)) <= RTOL
    assert eng.health()["counters"]["speculative_dispatches"] == 1
    jeng = JMatvecEngine(a, mv_jax.make_mesh(8), strategy="rowwise", dtype_storage="auto")
    assert (jeng.storage_reason, jeng.speculative) == ("tuned", True)


@pytest.mark.parametrize("case", ["none", "sub_floor", "auto_degraded", "unarmed_rtol"])
def test_storage_fallbacks_counter_equals_jax(case, tmp_path):
    """``health()``'s ``storage_fallbacks`` is the engine_storage_fallbacks_total
    counter, equal to the JAX engine's on the cases that serve under this
    jax."""
    a, x = _well_conditioned()
    kw = dict(strategy="rowwise", promote=2, max_bucket=8)
    if case == "auto_degraded":
        cache = tuning.TuningCache.load(tmp_path / "tuning_cache.json")
        cache.record(tuning.storage_key("rowwise", M, K, 8, "float32"), {"storage": "int3"})
        cache.save()
        jc = jcache.TuningCache.load(tmp_path / "tuning_cache.json")
        jc.record(jtuning.storage_key("rowwise", M, K, 8, "float32"), {"storage": "int3"})
        jc.save()
        tuning.reset_cache()
        jtuning.reset_cache()
        kw["dtype_storage"] = "auto"
    elif case != "unarmed_rtol":
        kw["dtype_storage"] = "speculate"
    eng = MatvecEngine(a, port_mesh(), **kw)
    jeng = JMatvecEngine(a, mv_jax.make_mesh(8), **kw)
    rtol = {"none": None, "sub_floor": spec.SPEC_RTOL_FLOOR / 4}.get(case, RTOL)
    for _ in range(2):
        eng.submit(x, rtol=rtol).result()
        jeng.submit(x, rtol=rtol).result()
    got, want = eng.health()["counters"], jeng.health()["counters"]
    for name in ("storage_fallbacks", "speculative_dispatches", "escalations"):
        assert got[name] == want[name], name
    snap = eng.metrics.snapshot()["counters"]
    assert ("engine_storage_fallbacks_total" in snap) == (case != "unarmed_rtol")


def test_breaker_stands_the_tier_down_after_an_escalation_storm():
    """Three misses open the speculative breaker: later rtol requests serve
    native at submit, counted as storage fallbacks, until the cooldown."""
    a, x = _adversarial()
    policy = ResiliencePolicy(breaker_reset_s=3600.0)
    armed = _engine(a, resilience=policy)
    plain = _plain(a)
    want = plain.submit(x).result()
    for _ in range(3):
        assert torch.equal(armed.submit(x, rtol=RTOL).result(), want)
    h = armed.health()
    assert h["counters"]["escalations"] == 3 and h["counters"]["breaker_opens"] == 1
    label = armed._spec_matvec_key().label()
    assert label.endswith(":speculate") and h["breakers"][label]["state"] == "open"
    for _ in range(2):
        assert torch.equal(armed.submit(x, rtol=RTOL).result(), want)
    h = armed.health()["counters"]
    assert h["speculative_dispatches"] == 3 and h["storage_fallbacks"] == 2


def test_injected_fault_falls_back_and_counts():
    a, x = _well_conditioned()
    plan = parse_fault_spec("compile:compile_error:key=*:speculate")
    armed = _engine(a, fault_plan=plan, resilience=ResiliencePolicy())
    y = armed.submit(x, rtol=RTOL).result()
    assert torch.equal(y, _plain(a).submit(x).result())
    h = armed.health()["counters"]
    assert h["storage_fallbacks"] == 1 and h["speculative_dispatches"] == 0
    assert h["faults_injected"] == 1


@pytest.mark.parametrize("where", ["kernel", "check"])
def test_a_real_kernel_error_reaches_the_caller(where, monkeypatch):
    """An error that no fault plan injected — the candidate's quantized
    kernel, or the check — raises out of submit, under a recovery policy
    too: nothing falls back, nothing counts as a fallback."""
    def broken(*args, **kwargs):
        raise RuntimeError(f"the {where} failed")

    if where == "kernel":
        monkeypatch.setitem(tq._STORAGE_KERNELS, "cuda", broken)
    else:
        monkeypatch.setattr(spec, "verdict", broken)
    a, x = _well_conditioned()
    for policy in (None, ResiliencePolicy()):
        armed = _engine(a, resilience=policy)
        with pytest.raises(RuntimeError, match=f"the {where} failed"):
            armed.submit(x, rtol=RTOL)
        h = armed.health()["counters"]
        assert h["storage_fallbacks"] == 0 and h["dispatch_failures"] == 1
        assert h["breaker_opens"] == 0 and h["downgrades"] == 0


def test_global_scheduler_prices_an_armed_rtol_request_as_speculate():
    a, x = _well_conditioned()
    fields = dict(flops=1e9, mem_bps=1e9, alpha_s={"collective": 1e-4, "permute": 1e-4},
                  beta_bps={"collective": 1e9, "permute": 1e9}, p=8, level="synthetic",
                  probes={})
    model = CostModel(Calibration(**fields))
    reg = MatrixRegistry(port_mesh(), strategy="rowwise", promote=2, max_bucket=8)
    reg.register("armed", a, dtype_storage="speculate")
    reg.register("plain", a)
    gs = GlobalScheduler(reg, cost_model=model, coalesce=True)
    cfg = reg._entry("armed").engine.prediction_config(1, RTOL)
    assert cfg["storage"] == "speculate"
    spec_s = model.predict(**cfg).total_s
    native_s = model.predict(**dict(cfg, storage="native")).total_s
    assert gs._predict_dispatch_s(reg._entry("armed").engine, 1, RTOL) == spec_s
    assert gs._predict_dispatch_s(reg._entry("plain").engine, 1, RTOL) == native_s
    y = gs.submit("armed", x, rtol=RTOL).result()
    assert _rel(y, _oracle(a, x)) <= RTOL
    assert reg._entry("armed").engine.health()["counters"]["speculative_dispatches"] == 1
    admits = [d for d in gs.decisions() if d["decision"] == "admit"]
    assert admits[-1]["predicted_s"] == spec_s
    gs.close()
    reg.close()


def test_serve_row_columns(monkeypatch):
    """run_serve with --dtype-storage speculate --spec-rtol 1e-3: every
    steady dispatch speculative, no escalation, and the bandwidth ratio
    the JAX package's formula on its own int8c payload's bytes."""
    recorded = []
    submit = MatvecEngine.submit

    def recording(self, x=None, **kw):
        fut = submit(self, x, **kw)
        if kw.get("rtol") is not None:
            recorded.append(x.shape[1] if x.dim() == 2 else 1)
        return fut

    monkeypatch.setattr(MatvecEngine, "submit", recording)
    res = serve.run_serve("rowwise", port_mesh(), M, K, n_requests=20, max_bucket=8,
                          promote=4, promo_reps=1, dtype_storage="speculate", rtol=1e-3)
    dispatches = sum(w if w < 4 else len(core.split_widths(w, 8)) for w in recorded)
    assert len(recorded) == 20 and res.speculated == dispatches
    assert res.escalation_rate == 0.0 and res.compiles_steady == 0
    qa = jq.quantize_matrix(np.zeros((M, K), np.float32), "int8c", contraction_shards=1)
    native = M * K * 4
    assert res.spec_bandwidth_ratio == (qa.nbytes + 33 * (M + K) * 4 + 0.0 * native) / native
    plain = serve.run_serve("rowwise", port_mesh(), M, K, n_requests=4, max_bucket=8,
                            promo_reps=1)
    assert plain.speculated == 0 and math.isnan(plain.spec_bandwidth_ratio)


def test_slo_targets_and_obs_panel_read_speculative_data():
    a, x = _adversarial()
    armed = _engine(a)
    assert armed.health()["slo"]["targets"]["engine_escalation_rate"]["value"] == 0.0
    armed.submit(x, rtol=RTOL).result()
    assert armed.health()["slo"]["targets"]["engine_escalation_rate"]["value"] == 1.0
    monitor = SloMonitor(armed.metrics, DEFAULT_TARGETS)
    monitor.sample()
    assert monitor.evaluate()["targets"]["escalation_rate"]["value"] == 1.0
    panel = render_storage(armed.metrics.snapshot())
    assert "speculative     1 dispatches, 1 escalations (rate 1.0000" in panel
    assert "fallbacks       0" in panel
    plain_metrics = MetricsRegistry()
    _plain(a, metrics=plain_metrics).submit(x).result()
    assert "speculative" not in render_storage(plain_metrics.snapshot())
    assert _plain(a).health()["slo"]["targets"]["engine_escalation_rate"]["value"] is None
