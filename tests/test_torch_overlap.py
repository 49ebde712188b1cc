"""The port's combine schedules through its entry points, against the JAX package's.

Mirrors tests/test_overlap.py, tests/test_ring.py and tests/test_a2a.py,
minus the tuner. The same seeded numpy operands go through the JAX
package's ``build`` / ``build_batched`` / ``build_gemm`` / ``MatvecEngine``
on the conftest's 8-device CPU mesh and through the port's on p logical CPU
shards (the ``cuda`` tier computes its plain versions on CPU tensors):

* every colwise combine and every registry name, matvec and GEMM;
* rowwise's and blockwise's gather family (``gather``, ``ring``, the staged
  ``overlap``, ``gather_output="ring"``);
* stage clamping and the cache-miss default S;
* quantized storage refused for the A-tiling schedules;
* the engine's ``overlap@S`` and ``pallas_ring`` executables;
* the sweep's and the serve bench's ``--combine`` / ``--stages``.

Tolerances: fp64 rtol 1e-12 (tests/test_overlap.py:528), fp32 rtol 1e-5
(:549, with atol 2e-4 against the JAX engine as tests/test_torch_engine.py),
a bf16 y cast back from sums in another order one ulp (2^-7).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import matvec_mpi_multiplier_tpu as mv_jax
from matvec_mpi_multiplier_tpu.engine import MatvecEngine as JaxEngine
from matvec_mpi_multiplier_tpu.models import gemm as jax_gemm
from matvec_mpi_multiplier_tpu.models.base import (
    DEFAULT_OVERLAP_STAGES as JAX_DEFAULT_OVERLAP_STAGES,
)
from matvec_mpi_multiplier_tpu.models.colwise import COLWISE_COMBINES as JAX_COMBINES
from matvec_mpi_multiplier_tpu.tuning import reset_cache
from matvec_mpi_multiplier_torch import get_strategy
from matvec_mpi_multiplier_torch.bench import serve, sweep
from matvec_mpi_multiplier_torch.engine import MatvecEngine
from matvec_mpi_multiplier_torch.models import available_strategies
from matvec_mpi_multiplier_torch.models.base import DEFAULT_OVERLAP_STAGES
from matvec_mpi_multiplier_torch.models.colwise import (
    COLWISE_COMBINES,
    OVERLAP_COMBINES,
    SCATTER_COMBINES,
)
from matvec_mpi_multiplier_torch.models.gemm import build_gemm, gemm_combine_candidates
from matvec_mpi_multiplier_torch.ops.quantize import quantize_matrix
from matvec_mpi_multiplier_torch.parallel import ring
from matvec_mpi_multiplier_torch.parallel.mesh import ShardedTensor, make_1d_mesh, make_mesh
from matvec_mpi_multiplier_torch.utils.convert import from_numpy
from matvec_mpi_multiplier_torch.utils.errors import ConfigError, ShardingError

from conftest import FIXTURE_MATRIX, FIXTURE_PRODUCT, FIXTURE_VECTOR

CPU = torch.device("cpu")
PS = [1, 2, 4, 8]
# The schedules that batch (pallas_ring is matvec-only, and 1-D only).
BATCHED_COMBINES = [c for c in COLWISE_COMBINES if c != "pallas_ring"]
REGISTRY = ["blockwise", "colwise", "colwise_a2a", "colwise_overlap", "colwise_ring",
            "colwise_ring_overlap", "rowwise"]
TOL = {"float64": dict(rtol=1e-12, atol=0), "float32": dict(rtol=1e-5, atol=2e-4)}


@pytest.fixture()
def cache_path(tmp_path, monkeypatch):
    """The JAX package's auto tiers consult its tuning cache: point it at
    an empty one, so it takes its miss defaults as the port does."""
    monkeypatch.setenv("MATVEC_TUNING_CACHE", str(tmp_path / "tuning_cache.json"))
    reset_cache()
    yield
    reset_cache()


def port_mesh(p, kind="2d"):
    if kind == "1d":
        return make_1d_mesh(p, devices=[CPU] * p)
    return make_mesh(p, devices=[CPU] * p)


def jax_mesh(p, kind="2d"):
    return mv_jax.make_1d_mesh(p) if kind == "1d" else mv_jax.make_mesh(p)


def uniform(shape, seed=0, dtype="float64"):
    return np.random.default_rng(seed).uniform(0, 10, shape).astype(dtype)


def both_build(name, p, a, x, kind="2d", batched=False, strategy_kwargs=None, **kwargs):
    """y from the JAX package's build and from the port's, as float64."""
    kw = strategy_kwargs or {}
    jstrat, tstrat = mv_jax.get_strategy(name, **kw), get_strategy(name, **kw)
    jbuild = jstrat.build_batched if batched else jstrat.build
    tbuild = tstrat.build_batched if batched else tstrat.build
    y_j = jbuild(jax_mesh(p, kind), **kwargs)(jnp.asarray(a), jnp.asarray(x))
    y_t = tbuild(port_mesh(p, kind), **kwargs)(torch.from_numpy(a), torch.from_numpy(x))
    return np.asarray(y_j).astype(np.float64), y_t.double().numpy()


# ------------------------------------------------------------ colwise family


def test_combine_families_match_jax():
    assert COLWISE_COMBINES == JAX_COMBINES
    assert set(SCATTER_COMBINES) == set(COLWISE_COMBINES) - {"psum"}
    assert OVERLAP_COMBINES == ("overlap", "overlap_ring")
    assert DEFAULT_OVERLAP_STAGES == JAX_DEFAULT_OVERLAP_STAGES == 2


@pytest.mark.parametrize("p", PS)
@pytest.mark.parametrize("combine", COLWISE_COMBINES)
def test_colwise_combine_matches_jax(devices, cache_path, combine, p):
    kind = "1d" if combine == "pallas_ring" else "2d"
    a, x = uniform((64, 32), seed=1), uniform(32, seed=2)
    y_j, y_t = both_build("colwise", p, a, x, kind, combine=combine, stages=2)
    np.testing.assert_allclose(y_t, y_j, **TOL["float64"])
    np.testing.assert_allclose(y_t, a @ x, rtol=1e-12)


@pytest.mark.parametrize("combine", COLWISE_COMBINES)
def test_colwise_combine_float32_and_sharded_output(devices, cache_path, combine):
    """fp32 at p=4, and the native output layout: row chunks for the scatter
    family, the whole y for psum."""
    kind = "1d" if combine == "pallas_ring" else "2d"
    a, x = uniform((32, 32), seed=3, dtype="float32"), uniform(32, seed=4, dtype="float32")
    y_j, y_t = both_build("colwise", 4, a, x, kind, combine=combine, stages=4)
    np.testing.assert_allclose(y_t, y_j, **TOL["float32"])
    mesh = port_mesh(4, kind)
    y = get_strategy("colwise").build(mesh, combine=combine, gather_output=False)(
        torch.from_numpy(a), torch.from_numpy(x))
    assert isinstance(y, ShardedTensor) and y.dtype == torch.float32
    if combine == "psum":
        assert y.spec == () and all(tuple(s.shape) == (32,) for s in y.shards)
    else:
        assert y.spec == (mesh.axis_names,)
        assert all(tuple(s.shape) == (8,) for s in y.shards)


@pytest.mark.parametrize("combine", ["ring", "overlap", "pallas_ring"])
def test_colwise_bfloat16_within_one_ulp_of_jax(devices, cache_path, combine):
    kind = "1d" if combine == "pallas_ring" else "2d"
    a = np.asarray(jnp.asarray(uniform((32, 32), seed=5), jnp.bfloat16))
    x = np.asarray(jnp.asarray(uniform(32, seed=6), jnp.bfloat16))
    y_j = mv_jax.get_strategy("colwise").build(jax_mesh(4, kind), combine=combine)(a, x)
    y_t = get_strategy("colwise").build(port_mesh(4, kind), combine=combine)(
        from_numpy(a, "cpu"), from_numpy(x, "cpu"))
    assert y_t.dtype == torch.bfloat16
    np.testing.assert_allclose(y_t.float().numpy(), np.asarray(y_j, np.float32),
                               rtol=2 ** -7)


@pytest.mark.parametrize("p", [2, 8])
@pytest.mark.parametrize("combine", BATCHED_COMBINES)
def test_colwise_combine_batched_matches_jax(devices, cache_path, combine, p):
    a, b = uniform((64, 32), seed=7), uniform((32, 5), seed=8)
    c_j, c_t = both_build("colwise", p, a, b, batched=True, combine=combine, stages=4)
    np.testing.assert_allclose(c_t, c_j, **TOL["float64"])
    np.testing.assert_allclose(c_t, a @ b, rtol=1e-12)


@pytest.mark.parametrize("combine", COLWISE_COMBINES)
def test_fixture_4x8_every_combine(devices, cache_path, combine):
    """The committed fixture through every schedule (4 rows over 2 shards:
    the overlap ladder clamps S=4 down to 2)."""
    kind = "1d" if combine == "pallas_ring" else "2d"
    y_j, y_t = both_build("colwise", 2, FIXTURE_MATRIX, FIXTURE_VECTOR, kind,
                          combine=combine, stages=4)
    np.testing.assert_allclose(y_t, FIXTURE_PRODUCT, rtol=1e-12)
    np.testing.assert_allclose(y_t, y_j, **TOL["float64"])


@pytest.mark.parametrize("p", [2, 8])
@pytest.mark.parametrize("name", REGISTRY)
def test_registry_names_match_jax(devices, cache_path, name, p):
    assert available_strategies() == sorted(mv_jax.available_strategies())
    a, x = uniform((64, 64), seed=9), uniform(64, seed=10)
    y_j, y_t = both_build(name, p, a, x)
    np.testing.assert_allclose(y_t, y_j, **TOL["float64"])
    strat, jstrat = get_strategy(name), mv_jax.get_strategy(name)
    assert getattr(strat, "combine", None) == getattr(jstrat, "combine", "gather")
    mesh, jmesh = port_mesh(p), jax_mesh(p)
    assert strat.default_combine(mesh) == jstrat.default_combine(jmesh)
    assert strat.combine_candidates(mesh) == jstrat.combine_candidates(jmesh)
    assert strat.combine_candidates_batched(mesh) == jstrat.combine_candidates_batched(jmesh)
    for combine in ("gather", "ring", "overlap", "a2a", "pallas_ring", "bogus", None, "auto"):
        assert strat.supports_combine(combine) == jstrat.supports_combine(combine)
        assert (strat.supports_combine_batched(combine)
                == jstrat.supports_combine_batched(combine))


@pytest.mark.parametrize("p", [2, 8])
@pytest.mark.parametrize("name", REGISTRY)
def test_build_gemm_matches_jax(devices, cache_path, name, p):
    a, b = uniform((64, 32), seed=11), uniform((32, 6), seed=12)
    c_j = jax_gemm.build_gemm(name, mv_jax.make_mesh(p))(jnp.asarray(a), jnp.asarray(b))
    c_t = build_gemm(name, port_mesh(p))(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), **TOL["float64"])
    assert (gemm_combine_candidates(name, port_mesh(p))
            == jax_gemm.gemm_combine_candidates(name, mv_jax.make_mesh(p)))


@pytest.mark.parametrize("combine,stages", [("overlap", 2), ("overlap", 4),
                                            ("ring", None), ("a2a", None)])
def test_build_gemm_combine_matches_jax(devices, cache_path, combine, stages):
    a, b = uniform((64, 64), seed=13), uniform((64, 8), seed=14)
    c_j = jax_gemm.build_gemm("colwise", mv_jax.make_mesh(8), combine=combine,
                              stages=stages)(jnp.asarray(a), jnp.asarray(b))
    c_t = build_gemm("colwise", port_mesh(8), combine=combine, stages=stages)(
        torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), **TOL["float64"])
    c_t = build_gemm("colwise_overlap", port_mesh(8), stages=stages)(
        torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(c_t.numpy(), a @ b, rtol=1e-12)
    with pytest.raises(ValueError, match="batched combine"):
        build_gemm("colwise", port_mesh(8, "1d"), combine="pallas_ring")


def test_explicit_stages_reaches_bound_combine(monkeypatch):
    """build(stages=N) on colwise_overlap (the schedule from the binding,
    not the combine= argument) runs at N."""
    calls = []
    real = ring.staged_overlap_scatter

    def spy(*args, **kwargs):
        calls.append(args[5])
        return real(*args, **kwargs)

    monkeypatch.setattr(ring, "staged_overlap_scatter", spy)
    a, x = torch.from_numpy(uniform((64, 64))), torch.from_numpy(uniform(64, seed=1))
    y = get_strategy("colwise_overlap").build(port_mesh(8), stages=8)(a, x)
    np.testing.assert_allclose(y.numpy(), (a @ x).numpy(), rtol=1e-12)
    assert calls == [8]
    calls.clear()
    get_strategy("colwise_overlap").build_batched(port_mesh(8), stages=4)(a, a[:, :3])
    assert calls == [4]


def test_colwise_constructor_guards():
    with pytest.raises(ValueError, match="combine must be one of"):
        get_strategy("colwise", combine="gather")
    strat = get_strategy("colwise", combine="auto")
    assert strat.requested_combine == "auto" and strat.combine == "psum"
    assert get_strategy("colwise", scatter_output=True).combine == "psum_scatter"
    with pytest.raises(ShardingError, match="n_rows"):
        get_strategy("colwise_ring").validate(30, 32, port_mesh(4))


# ------------------------------------------------------------ gather family


@pytest.mark.parametrize("p", PS)
@pytest.mark.parametrize("combine", ["gather", "ring", "overlap"])
@pytest.mark.parametrize("name", ["rowwise", "blockwise"])
def test_gather_family_matches_jax(devices, cache_path, name, combine, p):
    a, x = uniform((64, 32), seed=15), uniform(32, seed=16)
    y_j, y_t = both_build(name, p, a, x, combine=combine, stages=4)
    np.testing.assert_allclose(y_t, y_j, **TOL["float64"])
    np.testing.assert_allclose(y_t, a @ x, rtol=1e-12)


@pytest.mark.parametrize("name", ["rowwise", "blockwise", "colwise", "colwise_ring"])
def test_gather_output_ring_matches_jax(devices, cache_path, name):
    a, x = uniform((64, 32), seed=17), uniform(32, seed=18)
    y_j, y_t = both_build(name, 8, a, x, gather_output="ring")
    np.testing.assert_allclose(y_t, y_j, **TOL["float64"])
    np.testing.assert_allclose(y_t, a @ x, rtol=1e-12)


def test_gather_family_contracts(devices, cache_path):
    """gather_output=False survives a gather-schedule combine; the gather
    family has no batched face; an unknown gather_output string raises."""
    a, x = torch.from_numpy(uniform((64, 64))), torch.from_numpy(uniform(64, seed=1))
    mesh = port_mesh(8)
    y = get_strategy("rowwise").build(mesh, combine="overlap", gather_output=False)(a, x)
    assert isinstance(y, ShardedTensor) and y.spec == (mesh.axis_names,)
    for name in ("rowwise", "blockwise"):
        for combine in ("ring", "overlap"):
            with pytest.raises(ValueError, match="batched combine"):
                get_strategy(name).build_batched(mesh, combine=combine)
        with pytest.raises(ValueError, match="no combine schedule"):
            get_strategy(name).build(mesh, combine="a2a")
    with pytest.raises(ValueError, match="True, False or 'ring'"):
        get_strategy("rowwise").build(mesh, gather_output="tree")
    assert not get_strategy("rowwise").supports_combine("overlap_ring")
    assert get_strategy("blockwise").overlap_reduce_axes(mesh) == "cols"
    assert get_strategy("rowwise").overlap_reduce_axes(mesh) is None


# ------------------------------------------------------------ stages


def test_stage_clamping_matches_jax(devices, cache_path):
    """A requested S that doesn't divide the per-device chunk clamps DOWN
    the ladder, as in JAX."""
    mesh, jmesh = port_mesh(8), mv_jax.make_mesh(8)
    strat, jstrat = get_strategy("colwise"), mv_jax.get_strategy("colwise")
    for m, s in ((48, 8), (48, 1), (64, 8), (64, 3), (64, None), (64, "auto")):
        assert (strat.resolve_stages(m, 32, mesh, s, 8, "float32")
                == jstrat.resolve_stages(m, 32, jmesh, s, 8, "float32"))
    with pytest.raises(ValueError, match="stages"):
        strat.resolve_stages(64, 32, mesh, 0, 8, "float32")
    with pytest.raises(ShardingError):
        strat.resolve_stages(60, 32, mesh, 2, 8, "float32")
    a, x = uniform((48, 32), seed=19), uniform(32, seed=20)
    y_j, y_t = both_build("colwise", 8, a, x, combine="overlap", stages=8)
    np.testing.assert_allclose(y_t, y_j, **TOL["float64"])


def test_default_stages_on_a_miss(devices, cache_path):
    mesh = port_mesh(8)
    for name in ("rowwise", "colwise", "blockwise"):
        strat, jstrat = get_strategy(name), mv_jax.get_strategy(name)
        chunk = strat.overlap_chunk_devices(mesh)
        assert chunk == jstrat.overlap_chunk_devices(mv_jax.make_mesh(8))
        assert strat.resolve_stages(64, 64, mesh, None, chunk, "float32") == 2


# ------------------------------------------------------------ storage


@pytest.mark.parametrize("combine", ["overlap", "overlap_ring", "ring_overlap", "pallas_ring"])
def test_quantized_storage_refused_for_a_tiling_combines(devices, cache_path, combine):
    with pytest.raises(Exception) as jax_err:
        mv_jax.get_strategy("colwise").build(
            mv_jax.make_mesh(8), combine=combine, dtype_storage="int8")
    prefix = str(jax_err.value).split(";")[0]
    assert "tiles A inside its schedule body" in prefix
    with pytest.raises(ConfigError) as err:
        get_strategy("colwise").build(port_mesh(8), combine=combine, dtype_storage="int8")
    assert str(err.value).split(";")[0] == prefix
    a = np.random.default_rng(0).uniform(0, 10, (64, 64)).astype(np.float32)
    with pytest.raises(ConfigError, match="tiles A inside its schedule body"):
        MatvecEngine(a, port_mesh(8), strategy="colwise", combine=combine,
                     dtype_storage="int8")


@pytest.mark.parametrize("combine", ["ring", "a2a"])
def test_quantized_storage_through_unstaged_combines(devices, combine):
    """The un-staged ring and a2a consume a payload like psum does."""
    rng = np.random.default_rng(21)
    a = torch.from_numpy(rng.uniform(0, 10, (64, 64)).astype(np.float32))
    x = torch.from_numpy(rng.uniform(0, 10, 64).astype(np.float32))
    mesh = port_mesh(8)
    strat = get_strategy("colwise")
    qa = quantize_matrix(a, "int8c", contraction_shards=strat.contraction_shards(mesh))
    y = strat.build(mesh, combine=combine, dtype_storage="int8c")(qa, x)
    ref = strat.build(mesh, dtype_storage="int8c")(qa, x)
    np.testing.assert_allclose(y.numpy(), ref.numpy(), rtol=1e-5)
    y = strat.build(mesh, gather_output="ring", dtype_storage="int8c")(qa, x)
    np.testing.assert_allclose(y.numpy(), ref.numpy(), rtol=1e-5)


# ------------------------------------------------------------ engine


def engine_pair(a, strategy="colwise", kind="2d", **kwargs):
    kwargs.setdefault("promote", 2)
    kwargs.setdefault("max_bucket", 8)
    return (MatvecEngine(a, port_mesh(8, kind), strategy=strategy, **kwargs),
            JaxEngine(a, jax_mesh(8, kind), strategy=strategy, **kwargs))


def labels(eng):
    return sorted(k.label() for k in eng._cache.keys())


def jax_labels(eng):
    def mapped(label):
        op, strat, kernel, *rest = label.split(":")
        return ":".join([op, strat, {"xla": "cuda"}.get(kernel, kernel), *rest])

    return sorted(mapped(k.label()) for k in eng._cache.keys())


def test_engine_overlap_stages(devices, rng, cache_path):
    """S pinned at construction and baked into the keys (overlap@4) for
    matvec and GEMM, as in the JAX engine; no build after warmup."""
    a = rng.uniform(0, 10, (64, 64)).astype(np.float32)
    eng, jeng = engine_pair(a, combine="overlap", stages=4)
    assert eng.stages == jeng.stages == 4
    assert eng._matvec_key().combine == "overlap@4"
    assert eng._gemm_key(8).combine == "overlap@4"
    x = rng.uniform(0, 10, 64).astype(np.float32)
    blk = rng.uniform(0, 10, (64, 5)).astype(np.float32)
    np.testing.assert_allclose(eng(x).numpy(), jeng(x), **TOL["float32"])
    np.testing.assert_allclose(eng(blk).numpy(), jeng(blk), **TOL["float32"])
    np.testing.assert_allclose(eng(blk).numpy(), a @ blk, rtol=1e-4)
    assert eng.warmup() == jeng.warmup()
    assert labels(eng) == jax_labels(jeng)
    baseline = eng.stats.compiles
    for w in (1, 3, 5, 8, 2):
        eng.submit(blk[:, :w]).result()
    assert eng.stats.compiles == baseline


@pytest.mark.parametrize("kwargs", [{"stages": 2}, {"combine": "ring"}, {"combine": "auto"}])
def test_engine_combine_and_stages_arguments(devices, rng, cache_path, kwargs):
    """The arguments an earlier slice refused: each builds, serves the JAX
    engine's results and holds the JAX engine's keys after warmup."""
    a = rng.uniform(0, 10, (64, 64)).astype(np.float32)
    eng, jeng = engine_pair(a, **kwargs)
    assert eng.stages == jeng.stages
    blk = rng.uniform(0, 10, (64, 5)).astype(np.float32)
    np.testing.assert_allclose(eng(blk).numpy(), jeng(blk), **TOL["float32"])
    np.testing.assert_allclose(eng(blk[:, 0]).numpy(), jeng(blk[:, 0]), **TOL["float32"])
    assert eng.warmup([1, 3, 5]) == jeng.warmup([1, 3, 5])
    assert labels(eng) == jax_labels(jeng)


@pytest.mark.parametrize("strategy,combine", [
    ("rowwise", "ring"), ("rowwise", "overlap"), ("blockwise", "overlap"),
    ("colwise", "a2a"), ("colwise", "ring_overlap"),
])
def test_engine_labels_match_jax(devices, rng, cache_path, strategy, combine):
    a = rng.uniform(0, 10, (64, 64)).astype(np.float32)
    eng, jeng = engine_pair(a, strategy, combine=combine)
    assert eng.warmup() == jeng.warmup()
    assert labels(eng) == jax_labels(jeng)
    x = rng.uniform(0, 10, 64).astype(np.float32)
    np.testing.assert_allclose(eng(x).numpy(), jeng(x), **TOL["float32"])


def test_engine_strategy_bound_overlap(devices, rng, cache_path):
    a = rng.uniform(0, 10, (64, 64)).astype(np.float32)
    eng, jeng = engine_pair(a, "colwise_overlap", stages=4)
    assert eng.stages == 4
    assert eng._matvec_key().combine == "overlap@4"
    assert eng.warmup() == jeng.warmup()
    assert labels(eng) == jax_labels(jeng)
    eng2 = MatvecEngine(a, port_mesh(8), strategy="colwise", promote=None)
    assert eng2.stages is None


def test_engine_pallas_ring(devices, rng, cache_path):
    """Vectors through the ring walk, promoted blocks through the default
    batched combine; the keys read pallas_ring and default, as in JAX."""
    a = rng.uniform(0, 10, (64, 64)).astype(np.float32)
    eng, jeng = engine_pair(a, kind="1d", combine="pallas_ring")
    assert eng._matvec_key().combine == "pallas_ring"
    assert eng._gemm_key(8).combine is None
    x = rng.uniform(0, 10, 64).astype(np.float32)
    blk = rng.uniform(0, 10, (64, 6)).astype(np.float32)
    np.testing.assert_allclose(eng(x).numpy(), jeng(x), **TOL["float32"])
    np.testing.assert_allclose(eng(blk).numpy(), jeng(blk), **TOL["float32"])
    assert eng.warmup() == jeng.warmup()
    assert labels(eng) == jax_labels(jeng)


def test_engine_rejects_unknown_combine(devices, rng):
    a = rng.uniform(0, 10, (64, 64)).astype(np.float32)
    with pytest.raises(ConfigError, match="no combine schedule"):
        MatvecEngine(a, port_mesh(8), strategy="rowwise", combine="a2a")


# ------------------------------------------------------------ CLIs


def test_sweep_cli_combine_and_stages(devices, tmp_path, capsys):
    base = ["--platform", "cpu", "--host-devices", "4", "--sizes", "64", "--n-reps", "2",
            "--measure", "sync", "--data-root", str(tmp_path), "--devices", "4"]
    assert sweep.main(base + ["--combine", "overlap", "--stages", "4",
                              "--strategy", "colwise", "rowwise"]) == 0
    assert "2 configs timed, 0 skipped" in capsys.readouterr().out
    assert sweep.main(base + ["--combine", "psum_scatter", "--strategy", "rowwise",
                              "colwise"]) == 0
    assert "skip rowwise 64x64: no combine schedule 'psum_scatter'" in capsys.readouterr().out
    assert sweep.main(base + ["--combine", "pallas_ring", "--strategy", "colwise"]) == 0
    out = capsys.readouterr().out  # the sweep's 2-D mesh has no 1-D ring
    assert "skip colwise 64x64 p=4" in out and "single-axis" in out
    assert sweep.main(base + ["--op", "gemm", "--n-rhs", "4", "--combine", "ring",
                              "--strategy", "colwise_a2a"]) == 0
    assert "gemm_colwise_a2a 64x64 p=4" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="matvec-only"):
        sweep.main(base + ["--combine", "gather", "--op", "gemm"])


def test_serve_cli_combine_and_stages(devices, tmp_path, capsys):
    argv = ["--platform", "cpu", "--host-devices", "8", "--devices", "8", "--sizes", "64",
            "--n-requests", "6", "--strategy", "colwise", "--combine", "overlap",
            "--stages", "4", "--data-root", str(tmp_path)]
    assert serve.main(argv) == 0
    out = capsys.readouterr().out
    assert "serve colwise 64x64 p=8" in out and "compiles=5+0" in out
    rows = (tmp_path / "out" / "serve_colwise.csv").read_text().splitlines()
    assert rows[-1].split(", ")[6] == "overlap"
    res = serve.run_serve("colwise", port_mesh(4, "1d"), 64, 64, combine="pallas_ring",
                          n_requests=6, promo_reps=2)
    assert res.combine == "pallas_ring" and res.compiles_steady == 0
