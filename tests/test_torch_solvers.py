"""The port's served solvers against the JAX package's (solvers/, engine).

Mirrors tests/test_solvers.py. The same seeded operands
(``bench.serve.solver_operand``, ``gershgorin_interval``, numpy seeds) go
through the JAX package's ``MatvecEngine.submit(op=...)`` on the conftest's
8-device CPU mesh and through the port's on 8 logical CPU shards, whose
``cuda`` GEMV and fused ``cuda_fused`` step compute their plain versions on
CPU tensors. A JAX fused solve runs as its own tests run it: ``pallas_fused``
in interpret mode.

Tolerances: fp64 solves agree with the JAX engine's to 1e-10 of the
solution's largest element with equal iteration counts (both loops run the
same recurrence, summing in another order); fp32 solves, and fused against
unfused, to 1e-3 (the JAX package's own tier-against-tier tolerance). The
quantized fused tier is held against the numpy fp64 oracle ``dequantize(qa)``:
the JAX package's quantized ``shard_map`` solve raises under the installed
jax, so it is no oracle.

Not ported, with what they need: the chaos test (fault plans) and the
multi-tenant test (the registry).
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

import matvec_mpi_multiplier_tpu as mv_jax
from matvec_mpi_multiplier_tpu import solvers as jax_solvers
from matvec_mpi_multiplier_tpu.bench import serve as jax_serve
from matvec_mpi_multiplier_tpu.bench.metrics import read_csv
from matvec_mpi_multiplier_tpu.engine import MatvecEngine as JaxEngine
from matvec_mpi_multiplier_tpu.engine.core import DEFAULT_SOLVER_MAXITER as JAX_MAXITER
from matvec_mpi_multiplier_tpu.ops import quantize as jq
from matvec_mpi_multiplier_tpu.utils import errors as jax_errors
from matvec_mpi_multiplier_torch import get_strategy, solvers
from matvec_mpi_multiplier_torch.bench import serve
from matvec_mpi_multiplier_torch.engine import (
    DEFAULT_SOLVER_MAXITER,
    MatvecEngine,
    SolverFuture,
)
from matvec_mpi_multiplier_torch.ops.cuda_solver import solver_step_cuda
from matvec_mpi_multiplier_torch.parallel.mesh import make_mesh
from matvec_mpi_multiplier_torch.solvers import device_loop
from matvec_mpi_multiplier_torch.solvers.ops import _build_solver, solver_loop
from matvec_mpi_multiplier_torch.utils.errors import (
    ConfigError,
    DeadlineExceededError,
    ShardingError,
    SolverDivergedError,
)

CPU = torch.device("cpu")
N = 96  # divisible by 8 (rowwise/colwise shards) and by the 2x4 grid
CPU_ARGS = ["--platform", "cpu", "--host-devices", "8", "--devices", "8"]
# The JAX package's tier names and the port's counterparts.
TIERS = {"xla": "torch", "pallas": "cuda", "pallas_fused": "cuda_fused"}


@pytest.fixture(scope="module")
def jax_mesh():
    return mv_jax.make_mesh(8)


@pytest.fixture()
def cache_path(tmp_path, monkeypatch):
    """The JAX engine's solver_kernel="auto" consults its tuning cache:
    point it at an empty one, so it takes its miss default as the port
    does."""
    from matvec_mpi_multiplier_tpu.tuning import reset_cache

    monkeypatch.setenv("MATVEC_TUNING_CACHE", str(tmp_path / "tuning_cache.json"))
    reset_cache()
    yield
    reset_cache()


def port_engine(a, strategy="rowwise", **kw):
    return MatvecEngine(a, make_mesh(8, devices=[CPU] * 8), strategy=strategy,
                        promote=None, **kw)


def jax_engine(jax_mesh, a, strategy="rowwise", **kw):
    return JaxEngine(a, jax_mesh, strategy=strategy, promote=None, **kw)


def rhs(n=N, seed=1, dtype="float64"):
    return np.random.default_rng(seed).standard_normal(n).astype(dtype)


def assert_same_solve(port, ref, tol):
    """x within ``tol`` of the reference's largest element, as numpy."""
    x = port.x.numpy()
    assert x.dtype == ref.x.dtype and x.shape == ref.x.shape
    np.testing.assert_allclose(x, ref.x, rtol=tol, atol=tol * np.abs(ref.x).max())


# ------------------------------------------ numerics against the JAX engine


@pytest.mark.parametrize("strategy", ["rowwise", "colwise", "blockwise"])
def test_cg_matches_jax_engine(jax_mesh, strategy):
    a, b = serve.solver_operand(N, "float64", seed=3), rhs()
    res = port_engine(a, strategy).submit(op="cg", rhs=b, rtol=1e-12).result()
    ref = jax_engine(jax_mesh, a, strategy).submit(op="cg", rhs=b, rtol=1e-12).result()
    assert res.converged and ref.converged
    assert res.n_iters == ref.n_iters
    assert_same_solve(res, ref, 1e-10)
    np.testing.assert_allclose(res.x.numpy(), np.linalg.solve(a, b), rtol=1e-8, atol=1e-10)
    # The reported residual is the TRUE one of the returned iterate.
    assert res.residual_norm == pytest.approx(
        np.linalg.norm(b - a @ res.x.numpy()), rel=1e-6, abs=1e-12)
    assert isinstance(res.residual_norm, float) and isinstance(res.n_iters, int)
    assert np.isnan(res.value) and res.x.device.type == "cpu"


def test_gmres_matches_jax_engine_on_nonsymmetric(jax_mesh):
    rng = np.random.default_rng(5)  # the operand of tests/test_solvers.py
    a = rng.uniform(-1.0, 1.0, (N, N))
    np.fill_diagonal(a, np.abs(a).sum(axis=1) + 1.0)
    b = rhs()
    res = port_engine(a).submit(op="gmres", rhs=b, rtol=1e-12).result()
    ref = jax_engine(jax_mesh, a).submit(op="gmres", rhs=b, rtol=1e-12).result()
    assert res.converged and res.n_iters == ref.n_iters
    assert_same_solve(res, ref, 1e-10)
    np.testing.assert_allclose(res.x.numpy(), np.linalg.solve(a, b), rtol=1e-8, atol=1e-10)


def test_chebyshev_matches_jax_engine(jax_mesh):
    a, b = serve.solver_operand(N, "float64", seed=7), rhs()
    kw = dict(op="chebyshev", rhs=b, rtol=1e-10, interval=serve.gershgorin_interval(a))
    res = port_engine(a, "colwise").submit(**kw).result()
    ref = jax_engine(jax_mesh, a, "colwise").submit(**kw).result()
    assert res.converged and res.n_iters == ref.n_iters
    assert_same_solve(res, ref, 1e-10)
    np.testing.assert_allclose(res.x.numpy(), np.linalg.solve(a, b), rtol=1e-6, atol=1e-8)


def test_power_and_lanczos_match_jax_engine(jax_mesh):
    a, v0 = serve.solver_operand(N, "float64", seed=11), rhs(seed=2)
    lam = np.linalg.eigvalsh(a)[-1]
    port, ref = port_engine(a), jax_engine(jax_mesh, a)
    for kw in (dict(op="power", maxiter=5000), dict(op="lanczos")):
        res = port.submit(rhs=v0, rtol=1e-9, **kw).result()
        want = ref.submit(rhs=v0, rtol=1e-9, **kw).result()
        assert res.converged and res.n_iters == want.n_iters
        assert res.value == pytest.approx(want.value, rel=1e-10)
        assert res.value == pytest.approx(lam, rel=1e-7)
        # An eigenvector's sign is free (eigh picks one): compare up to it.
        x = res.x.numpy() * np.sign(res.x.numpy() @ want.x)
        np.testing.assert_allclose(x, want.x, rtol=1e-8, atol=1e-8)
        assert np.linalg.norm(a @ x - res.value * x) < 1e-5 * abs(res.value)


def test_solves_are_bitwise_deterministic_across_engines():
    a, b = serve.solver_operand(N, "float64", seed=13), rhs()

    def solve(engine):
        return engine.submit(op="cg", rhs=b, rtol=1e-10).result()

    e1 = port_engine(a, "colwise")
    r1, r2, r3 = solve(e1), solve(e1), solve(port_engine(a, "colwise"))
    for other in (r2, r3):
        assert torch.equal(r1.x, other.x) and r1.n_iters == other.n_iters
        assert np.float64(r1.residual_norm).tobytes() == np.float64(
            other.residual_norm).tobytes()


# ------------------------------------ typed failure, never a silently wrong x


def test_cap_exhaustion_is_typed_counted_and_recovers():
    a = serve.solver_operand(N, "float64", seed=17)
    engine = port_engine(a)
    fut = engine.submit(op="cg", rhs=rhs(), rtol=1e-14, maxiter=2)
    assert isinstance(fut, SolverFuture) and fut.done()
    with pytest.raises(SolverDivergedError, match="maxiter") as exc:
        fut.result()
    assert "(2)" in str(exc.value) and fut.retired
    counters = engine.metrics.snapshot()["counters"]
    assert counters["solver_divergences_total"] == 1
    assert counters["solver_requests_total"] == 1
    assert engine.submit(op="cg", rhs=rhs(), rtol=1e-8).result().converged


def test_nonfinite_answer_is_refused():
    a = serve.solver_operand(N, "float64", seed=19)
    a[5, 7] = np.nan
    with pytest.raises(SolverDivergedError, match="non-finite"):
        port_engine(a).submit(op="cg", rhs=rhs(), rtol=1e-10, maxiter=20).result()


def test_submit_validation_is_typed_with_the_jax_messages(jax_mesh):
    a = serve.solver_operand(N, "float64", seed=23)
    rect = np.random.default_rng(0).standard_normal((N, 2 * N))
    port, ref = port_engine(a), jax_engine(jax_mesh, a)
    port_rect, ref_rect = port_engine(rect), jax_engine(jax_mesh, rect)
    cases = [
        (port, ref, (np.ones(N),), dict(op="cg", rhs=np.ones(N))),
        (port, ref, (), dict(op="cg", rhs=np.ones((N, 2)))),
        (port, ref, (), dict(op="chebyshev", rhs=np.ones(N))),
        (port, ref, (), dict(op="cg", rhs=np.ones(N), rtol=0.0)),
        (port, ref, (), dict(op="cg", rhs=np.ones(N), rtol=-1e-3)),
        (port, ref, (), dict(op="cg", rhs=np.ones(N), maxiter=0)),
        (port, ref, (), dict(op="qr", rhs=np.ones(N))),
        (port_rect, ref_rect, (), dict(op="cg", rhs=np.ones(2 * N))),
    ]
    for interval in ((10.0, 0.5), (3.0, 3.0), (0.0, 5.0)):
        cases.append((port, ref, (), dict(op="chebyshev", rhs=np.ones(N), interval=interval)))
    for port_eng, ref_eng, args, kw in cases:
        with pytest.raises(ConfigError) as got:
            port_eng.submit(*args, **kw)
        with pytest.raises(jax_errors.ConfigError) as want:
            ref_eng.submit(*args, **kw)
        # The JAX message may point at its docs; the port's stops before.
        assert str(want.value).startswith(str(got.value).replace("'lanczos')", "'lanczos'")), kw
    assert port.stats.dispatches == 0


def test_deadline_and_backpressure_gate_solver_submits():
    a = serve.solver_operand(N, "float64", seed=23)
    engine = port_engine(a, max_in_flight=2)
    fut = engine.submit(op="cg", rhs=rhs(), deadline_ms=-1.0)
    assert fut.done() and fut.exception() is not None
    with pytest.raises(DeadlineExceededError, match="deadline of -1.0 ms"):
        fut.result()
    assert engine.stats.deadline_failures == 1 and engine.stats.dispatches == 0
    for _ in range(4):
        assert engine.submit(op="cg", rhs=rhs(), deadline_ms=60_000.0).result().converged
    assert engine.stats.in_flight <= 2


# ---------------------------------------------------- serving inheritance


def test_compiles_flat_hammer():
    """50 solves sweeping rtol and maxiter share one built loop."""
    a = serve.solver_operand(64, "float32", seed=29)
    engine = MatvecEngine(a, make_mesh(8, devices=[CPU] * 8), strategy="rowwise",
                          promote=None)
    rng = np.random.default_rng(31)
    engine.submit(op="cg", rhs=rng.standard_normal(64), rtol=1e-5).result()
    compiles, hits = engine.stats.compiles, engine.stats.hits
    for i in range(50):
        res = engine.submit(
            op="cg", rhs=rng.standard_normal(64).astype("float32"),
            rtol=(1e-3, 1e-4, 1e-5)[i % 3], maxiter=(50, 200, 1000)[i % 3],
        ).result()
        assert res.converged
    assert engine.stats.compiles == compiles, "steady-phase build"
    assert engine.stats.hits == hits + 50


def test_solver_metrics_are_the_jax_engines(jax_mesh):
    a, b = serve.solver_operand(64, "float64", seed=29), rhs(64)
    port = MatvecEngine(a, make_mesh(8, devices=[CPU] * 8), promote=None)
    ref = JaxEngine(a, jax_mesh, promote=None)
    for engine in (port, ref):
        engine.submit(op="cg", rhs=b, rtol=1e-8).result()

    def solver_names(snap):
        return {kind: sorted(k for k in snap.get(kind, {}) if k.startswith("solver_"))
                for kind in ("counters", "gauges", "histograms")}

    assert solver_names(port.metrics.snapshot()) == solver_names(ref.metrics.snapshot())
    snap = port.metrics.snapshot()
    assert snap["histograms"]["solver_iterations"]["count"] == 1
    assert snap["gauges"]["solver_residual_norm"] > 0


# ------------------------------------------------------ fused iteration tier


@pytest.mark.parametrize("op", ["cg", "chebyshev"])
@pytest.mark.parametrize("strategy", ["rowwise", "colwise"])
def test_fused_tier_matches_unfused_and_jax_fused(jax_mesh, op, strategy):
    a, b = serve.solver_operand(N, "float32", seed=43), rhs(dtype="float32")
    kw = {"interval": serve.gershgorin_interval(a)} if op == "chebyshev" else {}
    before = solver_step_cuda.launches
    res = {tier: port_engine(a, strategy, solver_kernel=tier).submit(
        op=op, rhs=b, rtol=1e-5, **kw).result() for tier in ("torch", "cuda_fused")}
    assert solver_step_cuda.launches == before  # CPU tensors: the plain version
    ref = jax_engine(jax_mesh, a, strategy, solver_kernel="pallas_fused").submit(
        op=op, rhs=b, rtol=1e-5, **kw).result()
    fused, unfused = res["cuda_fused"], res["torch"]
    assert fused.converged and unfused.converged and ref.converged
    assert fused.n_iters == ref.n_iters
    np.testing.assert_allclose(fused.x.numpy(), unfused.x.numpy(), rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(fused.x.numpy(), ref.x, rtol=1e-3, atol=1e-5)
    exact = np.linalg.solve(a.astype("float64"), b.astype("float64"))
    np.testing.assert_allclose(fused.x.numpy(), exact, rtol=1e-2, atol=1e-3)
    assert fused.residual_norm == pytest.approx(
        np.linalg.norm(b - a @ fused.x.numpy()), rel=1e-3, abs=1e-5)


@pytest.mark.parametrize("fmt", ["int8", "int8c", "fp8"])
def test_fused_quantized_tier_against_the_dequantized_oracle(fmt):
    """Both tiers solve the SAME quantized operator: they agree tightly,
    and each lands on the fp64 solve of ``dequantize(qa)``."""
    a, b = serve.solver_operand(N, "float32", seed=47), rhs(dtype="float32")
    res = {tier: port_engine(a, "colwise", solver_kernel=tier, dtype_storage=fmt).submit(
        op="cg", rhs=b, rtol=1e-5).result() for tier in ("torch", "cuda_fused")}
    fused, unfused = res["cuda_fused"], res["torch"]
    assert fused.converged and unfused.converged
    np.testing.assert_allclose(fused.x.numpy(), unfused.x.numpy(), rtol=1e-3, atol=1e-4)
    qa = jq.quantize_matrix(a, fmt, contraction_shards=8)
    deq = np.asarray(jq.dequantize(qa)).astype(np.float64)
    oracle = np.linalg.solve(deq, b.astype(np.float64))
    for r in (fused, unfused):
        np.testing.assert_allclose(r.x.numpy(), oracle, rtol=1e-3,
                                   atol=1e-3 * np.abs(oracle).max())
        assert r.residual_norm == pytest.approx(
            np.linalg.norm(b - deq @ r.x.numpy()), rel=1e-2, abs=1e-5)
    if fmt == "int8c":
        exact = np.linalg.solve(a.astype("float64"), b.astype("float64"))
        np.testing.assert_allclose(fused.x.numpy(), exact, rtol=5e-2, atol=1e-2)


def test_fused_tier_errors_are_typed():
    a = serve.solver_operand(N, "float32", seed=53)
    with pytest.raises(ShardingError, match="flat-axis"):
        port_engine(a, "blockwise", solver_kernel="cuda_fused")
    with pytest.raises(ShardingError, match="owns the solve body's"):
        port_engine(a, "colwise", solver_kernel="cuda_fused", combine="psum_scatter")
    with pytest.raises(ConfigError, match="solver_kernel"):
        port_engine(a, "rowwise", solver_kernel="warp")
    with pytest.raises(ConfigError, match="solver_kernel"):
        port_engine(a, "rowwise", solver_kernel="pallas_fused")
    engine = port_engine(a, "rowwise", solver_kernel="cuda_fused")
    with pytest.raises(ConfigError, match="fixed-recurrence"):
        engine.submit(op="gmres", rhs=rhs(dtype="float32"))
    assert engine.stats.dispatches == 0
    # "auto" has no tuning cache yet: the unfused tier, for every op.
    auto = port_engine(a, "rowwise", solver_kernel="auto")
    assert auto.submit(op="cg", rhs=rhs(dtype="float32"), rtol=1e-5).result().converged
    assert {k.kernel for k in auto._cache.keys()} == {"cuda"}


@pytest.mark.parametrize("tier", ["torch", "cuda_fused"])
def test_chebyshev_interval_edges_are_typed(tier):
    a, b = serve.solver_operand(N, "float32", seed=59), rhs(dtype="float32")
    engine = port_engine(a, "colwise", solver_kernel=tier)
    for interval in ((10.0, 0.5), (3.0, 3.0), (0.0, 5.0)):
        with pytest.raises(ConfigError, match="interval"):
            engine.submit(op="chebyshev", rhs=b, interval=interval)
    # The spectrum lies above lambda_max = 10: the recurrence blows up and
    # the growth predicate exits typed long before the cap.
    fut = engine.submit(op="chebyshev", rhs=b, rtol=1e-5, interval=(1.0, 10.0))
    with pytest.raises(SolverDivergedError):
        fut.result()
    assert fut._res.n_iters < DEFAULT_SOLVER_MAXITER
    res = engine.submit(op="chebyshev", rhs=b, rtol=1e-5,
                        interval=serve.gershgorin_interval(a)).result()
    assert res.converged


# ------------------------------------------------ the JAX package's names


def test_solver_vocabulary_is_the_jax_packages():
    assert solvers.SOLVER_OPS == jax_solvers.SOLVER_OPS
    assert solvers.EIGEN_OPS == jax_solvers.EIGEN_OPS
    assert (solvers.DEFAULT_RESTART, solvers.DEFAULT_STEPS) == (
        jax_solvers.DEFAULT_RESTART, jax_solvers.DEFAULT_STEPS)
    assert solvers.DIVERGENCE_GROWTH == jax_solvers.DIVERGENCE_GROWTH
    assert DEFAULT_SOLVER_MAXITER == JAX_MAXITER == 1000
    assert sorted(solvers.__all__) == sorted(jax_solvers.__all__)
    assert [f.name for f in dataclasses.fields(solvers.SolverResult)] == [
        f.name for f in dataclasses.fields(jax_solvers.SolverResult)]
    for op in solvers.SOLVER_OPS:
        for k in (1, 7, 49, 50, 120):
            for restart, steps in ((10, 32), (3, 5)):
                kw = dict(restart=restart, steps=steps)
                assert solvers.solver_matvec_count(op, k, **kw) == \
                    jax_solvers.solver_matvec_count(op, k, **kw)
                assert solvers.solver_bucket(op, **kw) == jax_solvers.solver_bucket(op, **kw)


def test_common_predicates():
    t = torch.tensor
    assert solvers.residual_norm(t([3.0, 4.0])).item() == 5.0
    assert solvers.host_norm(t([3.0, 4.0])) == 5.0
    assert bool(solvers.above_tolerance(t(1.0), t(0.5)))
    assert not bool(solvers.above_tolerance(t(0.5), t(0.5)))  # <= counts as converged
    assert bool(solvers.keep_iterating(t(1.0), t(0.5), 3, 4))
    assert not bool(solvers.keep_iterating(t(1.0), t(0.5), 4, 4))
    assert solvers.convergence_threshold(t(1e-3), t(2.0)).item() == pytest.approx(2e-3)
    assert bool(solvers.diverged(t(float("nan")), t(1.0)))
    assert bool(solvers.diverged(t(2e12), t(1.0)))
    assert not bool(solvers.diverged(t(1e12), t(1.0)))


@pytest.mark.parametrize("jax_kernel,jax_solver_kernel,strategy", [
    ("xla", "xla", "rowwise"), ("pallas", "xla", "blockwise"),
    ("xla", "pallas_fused", "colwise"), ("xla", "auto", "rowwise"),
])
def test_solver_exec_key_labels_match_jax(jax_mesh, cache_path, jax_kernel, jax_solver_kernel, strategy):
    a = serve.solver_operand(64, "float32", seed=61)
    b = rhs(64, dtype="float32")
    port = MatvecEngine(a, make_mesh(8, devices=[CPU] * 8), strategy=strategy,
                        promote=None, kernel=TIERS[jax_kernel],
                        solver_kernel=TIERS.get(jax_solver_kernel, jax_solver_kernel))
    ref = JaxEngine(a, jax_mesh, strategy=strategy, promote=None, kernel=jax_kernel,
                    solver_kernel=jax_solver_kernel)
    ops = [dict(op="cg"), dict(op="chebyshev", interval=serve.gershgorin_interval(a))]
    if jax_solver_kernel != "pallas_fused":
        ops += [dict(op="gmres", restart=3), dict(op="lanczos", steps=4), dict(op="power")]
    for kw in ops:
        for engine in (port, ref):
            engine.submit(rhs=b, rtol=1e-2, maxiter=3, **kw)

    def mapped(label):
        op, strat, kernel, *rest = label.split(":")
        return ":".join([op, strat, TIERS[kernel], *rest])

    assert sorted(k.label() for k in port._cache.keys()) == sorted(
        mapped(k.label()) for k in ref._cache.keys())


# ------------------------------------------------------------- serve bench


def test_solver_operand_is_the_jax_packages_and_its_device_family():
    for dtype in ("float64", "float32"):
        got = serve.solver_operand(40, dtype, seed=5)
        assert got.tobytes() == jax_serve.solver_operand(40, dtype, 5).tobytes()
        assert serve.gershgorin_interval(got) == jax_serve.gershgorin_interval(got)
        # The same interval from a tensor, read in row chunks.
        lo, hi = serve.gershgorin_interval(torch.from_numpy(got))
        want = jax_serve.gershgorin_interval(got)
        assert lo == pytest.approx(want[0], rel=1e-6) and hi == pytest.approx(want[1], rel=1e-6)
    # The device path: the same family, other draws, seeded.
    dev = serve.solver_operand(40, "float32", seed=5, device="cpu")
    assert dev.dtype == torch.float32 and tuple(dev.shape) == (40, 40)
    assert torch.equal(dev, dev.T) and torch.equal(dev, serve.solver_operand(
        40, torch.float32, seed=5, device=CPU))
    off_diag = dev.abs().sum(1) - dev.diagonal().abs()
    assert bool((dev.diagonal() - off_diag >= 0.99).all())  # Gershgorin discs in [1, .]
    assert dev[0, 0] > dev.diagonal()[1:].max()  # the boosted entry
    assert float(dev.abs().max()) < 60
    assert not torch.equal(dev, serve.solver_operand(40, "float32", seed=6, device="cpu"))


def test_run_serve_solver_fields_csv_and_zero_steady_builds(tmp_path):
    res = serve.run_serve_solver("rowwise", make_mesh(8, devices=[CPU] * 8), 64, op="cg",
                                 rtol_sweep=(1e-3, 1e-5), n_solves=6, maxiter=200)
    assert [f.name for f in dataclasses.fields(res)] == [
        f.name for f in dataclasses.fields(jax_serve.SolverServeResult)]
    assert res.compiles_steady == 0 and res.compiles_warmup == 1
    assert res.divergences == 0 and res.iterations > 0 and res.rtol == 1e-5
    assert res.solve_p50_ms <= res.solve_p99_ms and res.time_per_iter_ms > 0
    assert (res.dtype, res.combine, res.solver_kernel, res.maxiter) == (
        "float32", "default", "torch", 200)
    assert serve.SOLVER_CSV_HEADER == jax_serve.SOLVER_CSV_HEADER
    path = serve.append_solver_result(res, tmp_path / "port")
    jax_path = jax_serve.append_solver_result(
        jax_serve.SolverServeResult(**dataclasses.asdict(res)), tmp_path / "jax")
    assert path.name == "serve_solver_rowwise.csv"
    assert path.read_bytes() == jax_path.read_bytes()


@pytest.mark.parametrize("op,extra", [
    ("cg", ["--solver-kernel", "cuda_fused"]),
    ("chebyshev", ["--rtol-sweep", "1e-3", "1e-4"]),
    ("power", ["--maxiter", "4000"]),
    ("lanczos", ["--steps", "16", "--rtol", "1e-4"]),
    ("gmres", ["--restart", "4"]),
])
def test_serve_cli_op(tmp_path, capsys, op, extra):
    rc = serve.main(["--op", op, "--strategy", "colwise", "--sizes", "64",
                     "--n-requests", "3", "--data-root", str(tmp_path), *extra, *CPU_ARGS])
    assert rc == 0
    out = capsys.readouterr().out
    assert f"serve-solver {op} colwise 64x64 p=8" in out and "compiles=1+0" in out
    rows = read_csv(serve.solver_csv_path("colwise", tmp_path))
    assert len(rows) == 1 and rows[0]["compiles_steady"] == 0 and rows[0]["divergences"] == 0
    assert rows[0]["op"] == op and rows[0]["n_solves"] == 3
    header = serve.solver_csv_path("colwise", tmp_path).read_text().splitlines()[0]
    assert header == jax_serve.SOLVER_CSV_HEADER


# ------------------------------------------ the device loop (masked chunks)


def _jax_solve(p, strategy, tier, op, a, b, **kw):
    engine = JaxEngine(a, mv_jax.make_mesh(p), strategy=strategy, promote=None,
                       solver_kernel="pallas_fused" if tier == "cuda_fused" else "xla")
    return engine.submit(op=op, rhs=b, **kw).result()


@pytest.mark.parametrize("p", [1, 4])
@pytest.mark.parametrize("op", ["cg", "chebyshev"])
@pytest.mark.parametrize("tier,strategy", [
    ("torch", "rowwise"), ("torch", "colwise"), ("torch", "blockwise"),
    ("cuda_fused", "rowwise"), ("cuda_fused", "colwise"),
])
def test_device_loop_is_bitwise_the_host_stepped_loop(p, op, tier, strategy, monkeypatch):
    """cg and chebyshev in masked chunks of 5 iterations, run eagerly,
    against the host-stepped loop: the same x, n_iters and result fields
    bitwise, at a cap that is not a multiple of the chunk (13) and to
    convergence; the converged solve holds the JAX engine's tolerance (fp64:
    equal iterations, x within 1e-10 of its largest element)."""
    a, b = serve.solver_operand(N, "float64", seed=3), rhs()
    interval = serve.gershgorin_interval(a) if op == "chebyshev" else (0.0, 0.0)
    mesh = make_mesh(p, devices=[CPU] * p)
    kernel = "cuda_fused" if tier == "cuda_fused" else "cuda"
    at, bt = torch.from_numpy(a), torch.from_numpy(b)
    monkeypatch.setattr(device_loop, "DEFAULT_CHUNK", 5)
    fns = {loop: _build_solver(op, get_strategy(strategy), mesh, loop, dtype=at.dtype,
                               kernel=kernel)
           for loop in ("host", "device")}
    assert {loop: fn.loop for loop, fn in fns.items()} == {"host": "host", "device": "device"}
    for maxiter in (13, 1000):
        got = {loop: fn(at, bt, 1e-10, maxiter, *interval) for loop, fn in fns.items()}
        for field in dataclasses.fields(got["host"]):
            h, d = (getattr(got[k], field.name) for k in ("host", "device"))
            torch.testing.assert_close(h, d, rtol=0, atol=0, equal_nan=True)
    res = got["device"]
    assert bool(res.converged)
    ref = _jax_solve(p, strategy, tier, op, a, b, rtol=1e-10, maxiter=1000,
                     **({"interval": interval} if op == "chebyshev" else {}))
    assert int(res.n_iters) == ref.n_iters
    np.testing.assert_allclose(res.x.numpy(), ref.x, rtol=1e-10,
                               atol=1e-10 * np.abs(ref.x).max())


@pytest.mark.parametrize("op", ["cg", "chebyshev"])
def test_device_loop_refreshes_where_the_host_loop_does(op, monkeypatch):
    """Every shard GEMV the host-stepped loop runs, the device loop runs, and
    no more: a cap of 123 at an unreachable tolerance puts CG's periodic
    refresh at iterations 50 and 100, and chebyshev at rtol 1e-9 refreshes
    where the recurrence is about to stop."""
    a, b = serve.solver_operand(N, "float64", seed=3), rhs()
    interval = serve.gershgorin_interval(a) if op == "chebyshev" else (0.0, 0.0)
    rtol = 1e-300 if op == "cg" else 1e-9
    mesh = make_mesh(4, devices=[CPU] * 4)
    monkeypatch.setattr(device_loop, "DEFAULT_CHUNK", 8)
    counts = {}
    for loop in ("host", "device"):
        calls = []

        def kernel(a_, x_):
            calls.append(1)
            return a_ @ x_

        fn = _build_solver(op, get_strategy("rowwise"), mesh, loop,
                           dtype=torch.float64, kernel=kernel)
        res = fn(torch.from_numpy(a), torch.from_numpy(b), rtol, 123, *interval)
        counts[loop] = (len(calls), int(res.n_iters))
    assert counts["host"] == counts["device"]
    if op == "cg":
        # 123 iterations, refreshes at 50 and 100, two verifications; x 4 shards.
        assert counts["host"] == (4 * (123 + 2 + 2), 123)


def test_solver_loop_choice():
    """The public builders take the device loop only where its chunks are
    captured: one CUDA device and every kernel of the iteration predicated.
    On the CPU they build the host-stepped loop, and the device loop only
    where the caller names it (cg and chebyshev); anything else is
    refused."""
    mesh = make_mesh(2, devices=[CPU] * 2)
    strategy = get_strategy("rowwise")
    for op in solvers.SOLVER_OPS:
        assert solvers.build_solver(op, strategy, mesh, dtype=torch.float64).loop == "host"
        assert _build_solver(op, strategy, mesh, "device", dtype=torch.float64).loop == (
            "device" if op in ("cg", "chebyshev") else "host")
        assert _build_solver(op, strategy, mesh, "host", dtype=torch.float64).loop == "host"
    with pytest.raises(ValueError, match="loop must be"):
        _build_solver("cg", strategy, mesh, "graph", dtype=torch.float64)
    card = types.SimpleNamespace(devices=[torch.device("cuda", 0)] * 4)
    cards = types.SimpleNamespace(devices=[torch.device("cuda", 0), torch.device("cuda", 1)])
    cases = [
        # (loop asked for, op, mesh, every kernel predicated) -> loop built
        ((None, "cg", card, True), "device"),
        (("device", "chebyshev", card, True), "device"),
        ((None, "cg", card, False), "host"),
        (("device", "cg", card, False), "host"),
        (("host", "cg", card, True), "host"),
        ((None, "gmres", card, True), "host"),
        ((None, "cg", cards, True), "host"),
        (("device", "cg", cards, True), "device"),
        ((None, "chebyshev", mesh, True), "host"),
    ]
    for (loop, op, on, predicated), want in cases:
        assert solver_loop(loop, op, on, predicated=predicated) == want, (loop, op)
