"""The port's three strategies against the JAX package's, on CPU meshes.

The same numpy operands go through the JAX strategy on the conftest's
8-device CPU mesh (``kernel="xla"`` and ``kernel="pallas"``, the latter in
interpret mode off-TPU) and through the port's strategy on p logical CPU
shards with its default ``kernel="cuda"`` (the plain version on CPU
tensors). Operands are uniform [0, 10), the reference's range: positive
terms, so relative tolerances are meaningful.

Tolerances: fp64 rtol 1e-12. fp32 rtol 2e-5, atol 2e-4
(tests/test_pallas.py:33). bf16 at the strategy level: y is cast back to
bf16 after an fp32 sum taken in another order, so the two may round to
neighbouring values — rtol 2^-7, one bf16 ulp (fp16: 2^-10).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding

import matvec_mpi_multiplier_tpu as mv_jax
import matvec_mpi_multiplier_torch as mv_torch
from matvec_mpi_multiplier_tpu.ops import pallas_gemv  # noqa: F401 (registers pallas)
from matvec_mpi_multiplier_tpu.ops.pallas_gemv import default_tiles
from matvec_mpi_multiplier_tpu.parallel.mesh import make_1d_mesh as jax_1d_mesh
from matvec_mpi_multiplier_tpu.utils.errors import ShardingError as JaxShardingError
from matvec_mpi_multiplier_torch.parallel.mesh import make_1d_mesh, make_mesh
from matvec_mpi_multiplier_torch.utils.convert import from_numpy
from matvec_mpi_multiplier_torch.utils.errors import ConfigError, ShardingError

from conftest import FIXTURE_MATRIX, FIXTURE_PRODUCT, FIXTURE_VECTOR

STRATEGIES = ["rowwise", "colwise", "blockwise"]
CPU = torch.device("cpu")
JAX_DTYPES = {"float64": jnp.float64, "float32": jnp.float32,
              "bfloat16": jnp.bfloat16, "float16": jnp.float16}
TOL = {
    "float64": dict(rtol=1e-12, atol=0),
    "float32": dict(rtol=2e-5, atol=2e-4),
    "bfloat16": dict(rtol=2 ** -7, atol=0),
    "float16": dict(rtol=2 ** -10, atol=0),
}


def port_mesh(p):
    return make_mesh(p, devices=[CPU] * p)


def uniform(shape, seed=0):
    rng = np.random.default_rng(seed)
    return rng.uniform(0, 10, shape), rng.uniform(0, 10, shape[1])


def run_both(name, p, a, x, dtype="float64", kernel="xla",
             strategy_kwargs=None, **build_kwargs):
    """y from the JAX strategy and from the port's, both as float64 numpy."""
    kw = strategy_kwargs or {}
    a_j = jnp.asarray(a, JAX_DTYPES[dtype])
    x_j = jnp.asarray(x, JAX_DTYPES[dtype])
    y_j = mv_jax.get_strategy(name, **kw).build(
        mv_jax.make_mesh(p), kernel=kernel, **build_kwargs
    )(a_j, x_j)
    a_t = from_numpy(np.asarray(a_j), "cpu")
    x_t = from_numpy(np.asarray(x_j), "cpu")
    y_t = mv_torch.get_strategy(name, **kw).build(port_mesh(p), **build_kwargs)(a_t, x_t)
    assert y_t.dtype == a_t.dtype
    return (np.asarray(y_j.astype(jnp.float64)),
            y_t.to(torch.float64).numpy())


@pytest.mark.parametrize("p", [1, 2, 4, 8])
@pytest.mark.parametrize("name", STRATEGIES)
def test_fixture_4x8(devices, name, p):
    """The committed fixture; where the guard refuses the mesh (e.g. 4 rows
    over 8 devices), the port refuses it with the JAX package's message."""
    try:
        mv_jax.get_strategy(name).validate(4, 8, mv_jax.make_mesh(p))
    except JaxShardingError as e:
        with pytest.raises(ShardingError) as port_err:
            mv_torch.get_strategy(name).validate(4, 8, port_mesh(p))
        assert str(port_err.value) == str(e)
        return
    y_j, y_t = run_both(name, p, FIXTURE_MATRIX, FIXTURE_VECTOR)
    np.testing.assert_allclose(y_t, FIXTURE_PRODUCT, rtol=1e-12)
    np.testing.assert_allclose(y_t, y_j, rtol=1e-12)


@pytest.mark.parametrize("kernel", ["xla", "pallas"])
@pytest.mark.parametrize("shape", [(8, 8), (16, 24), (24, 16)])
@pytest.mark.parametrize("p", [1, 2, 4, 8])
@pytest.mark.parametrize("name", STRATEGIES)
def test_random_oracle(devices, name, p, shape, kernel):
    a, x = uniform(shape, seed=p)
    y_j, y_t = run_both(name, p, a, x, kernel=kernel)
    np.testing.assert_allclose(y_t, y_j, rtol=1e-12)
    np.testing.assert_allclose(y_t, a @ x, rtol=1e-12)


# Local blocks at (128, 1024): every strategy's block tiles, so the JAX
# side really runs the Pallas kernel rather than its XLA fallback.
LOCAL_BLOCKS = {
    ("rowwise", 8): (16, 1024),
    ("colwise", 8): (128, 128),
    ("blockwise", 8): (64, 256),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("p", [1, 2, 4, 8])
@pytest.mark.parametrize("name", STRATEGIES)
def test_matches_pallas_where_it_tiles(devices, name, p, dtype):
    a, x = uniform((128, 1024), seed=7)
    strat = mv_torch.get_strategy(name)
    a_p, _ = strat.place(torch.from_numpy(a), torch.from_numpy(x), port_mesh(p))
    local = tuple(a_p.shards[0].shape)
    assert LOCAL_BLOCKS.get((name, p), local) == local
    assert default_tiles(*local, 2 if dtype == "bfloat16" else 4) is not None
    y_j, y_t = run_both(name, p, a, x, dtype=dtype, kernel="pallas")
    np.testing.assert_allclose(y_t, y_j, **TOL[dtype])


@pytest.mark.parametrize("name", STRATEGIES)
def test_asymmetric_long_contraction(devices, name):
    """The reference's asymmetric regime (few rows, long contraction),
    scaled down."""
    a, x = uniform((16, 4096), seed=3)
    y_j, y_t = run_both(name, 8, a, x)
    np.testing.assert_allclose(y_t, y_j, rtol=1e-12)


@pytest.mark.parametrize(
    "name,kw",
    [("rowwise", {}), ("colwise", {}), ("colwise", {"scatter_output": True}),
     ("blockwise", {})],
)
def test_sharded_output_layout_matches_jax(devices, name, kw):
    """gather_output=False: the port's per-device y blocks equal the JAX
    result's addressable shards, device by device."""
    a, x = uniform((16, 16), seed=5)
    jmesh = mv_jax.make_mesh(8)
    y_j = mv_jax.get_strategy(name, **kw).build(jmesh, gather_output=False)(
        jnp.asarray(a), jnp.asarray(x)
    )
    y_t = mv_torch.get_strategy(name, **kw).build(
        port_mesh(8), gather_output=False
    )(torch.from_numpy(a), torch.from_numpy(x))
    order = {d: f for f, d in enumerate(jmesh.devices.flat)}
    assert len(y_j.addressable_shards) == len(y_t.shards) == 8
    for shard in y_j.addressable_shards:
        mine = y_t.shards[order[shard.device]].numpy()
        assert mine.shape == shard.data.shape
        np.testing.assert_allclose(mine, np.asarray(shard.data), rtol=1e-12)


@pytest.mark.parametrize("p", [2, 4, 8])
def test_colwise_psum_scatter(devices, p):
    a, x = uniform((16, 24), seed=p)
    y_j, y_t = run_both("colwise", p, a, x,
                        strategy_kwargs={"scatter_output": True})
    np.testing.assert_allclose(y_t, y_j, rtol=1e-12)
    # Naming the instance's own schedule in build() changes nothing.
    y_j, y_t = run_both("colwise", p, a, x, combine="psum_scatter",
                        strategy_kwargs={"scatter_output": True})
    np.testing.assert_allclose(y_t, y_j, rtol=1e-12)


@pytest.mark.parametrize(
    "name,kw,shape",
    [("rowwise", {}, (10, 8)), ("colwise", {}, (8, 10)),
     ("colwise", {"scatter_output": True}, (10, 8)),
     ("blockwise", {}, (8, 6)), ("blockwise", {}, (3, 8))],
)
def test_guards_match_jax_messages(devices, name, kw, shape):
    with pytest.raises(JaxShardingError) as jax_err:
        mv_jax.get_strategy(name, **kw).validate(*shape, mv_jax.make_mesh(8))
    with pytest.raises(ShardingError) as port_err:
        mv_torch.get_strategy(name, **kw).validate(*shape, port_mesh(8))
    assert str(port_err.value) == str(jax_err.value)
    # build() validates on every call, before any placement.
    fn = mv_torch.get_strategy(name, **kw).build(port_mesh(8))
    with pytest.raises(ShardingError, match="n_rows|n_cols"):
        fn(torch.ones(*shape), torch.ones(shape[1]))


def test_blockwise_needs_2d_mesh(devices):
    with pytest.raises(JaxShardingError) as jax_err:
        mv_jax.BlockwiseStrategy().validate(8, 8, jax_1d_mesh(4))
    with pytest.raises(ShardingError) as port_err:
        mv_torch.BlockwiseStrategy().validate(
            8, 8, make_1d_mesh(4, devices=[CPU] * 4)
        )
    assert str(port_err.value) == str(jax_err.value)


@pytest.mark.parametrize("p", [1, 8])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("name", STRATEGIES)
def test_reduced_precision(devices, name, dtype, p):
    """Accumulation is fp32 whatever the storage dtype; y comes back in
    the storage dtype, within one ulp of the JAX package's."""
    a, x = uniform((16, 32), seed=11)
    y_j, y_t = run_both(name, p, a, x, dtype=dtype)
    np.testing.assert_allclose(y_t, y_j, **TOL[dtype])


def test_placed_operands_reused_and_checked():
    """build()'s matvec takes placed operands; operands placed for another
    strategy are refused, never silently re-cut."""
    mesh = port_mesh(4)
    a, x = torch.from_numpy(uniform((8, 8))[0]), torch.ones(8, dtype=torch.float64)
    row = mv_torch.get_strategy("rowwise")
    placed = row.place(a, x, mesh)
    np.testing.assert_allclose(row.build(mesh)(*placed).numpy(),
                               (a @ x).numpy(), rtol=1e-12)
    with pytest.raises(ShardingError, match="placed for another"):
        mv_torch.get_strategy("colwise").build(mesh)(*placed)
    with pytest.raises(ShardingError, match="both placed"):
        row.build(mesh)(placed[0], x)


@pytest.mark.parametrize(
    "kwargs",
    [{"combine": "ring"}, {"combine": "auto"}, {"stages": 2},
     {"combine": "overlap"}, {"gather_output": "ring"}],
)
def test_later_slice_arguments_raise(kwargs):
    with pytest.raises(ConfigError, match="ROADMAP.md"):
        mv_torch.get_strategy("colwise").build(port_mesh(2), **kwargs)


@pytest.mark.parametrize(
    "scatter_output,combine",
    [(False, "psum_scatter"), (True, "psum"), (False, "a2a"), (True, "a2a")],
)
def test_unported_colwise_schedule_raises(scatter_output, combine):
    """scatter_output is the one way to choose colwise's schedule; build()
    refuses any other name than the instance's own."""
    strat = mv_torch.ColwiseStrategy(scatter_output=scatter_output)
    with pytest.raises(ConfigError, match="ROADMAP.md"):
        strat.build(port_mesh(2), combine=combine)
    strat.build(port_mesh(2), combine=strat.combine)


def test_registry():
    assert mv_torch.available_strategies() == ["blockwise", "colwise", "rowwise"]
    with pytest.raises(KeyError, match="unknown strategy"):
        mv_torch.get_strategy("diagonal")


def test_jax_side_placement_matches(devices):
    """The port's placement cuts A and x exactly as NamedSharding does."""
    a, x = uniform((16, 24), seed=2)
    jmesh = mv_jax.make_mesh(8)
    order = {d: f for f, d in enumerate(jmesh.devices.flat)}
    for name in STRATEGIES:
        sh_a, sh_x = mv_jax.get_strategy(name).shardings(jmesh)
        a_p, x_p = mv_torch.get_strategy(name).place(
            torch.from_numpy(a), torch.from_numpy(x), port_mesh(8)
        )
        for arr, sh, placed in ((a, sh_a, a_p), (x, sh_x, x_p)):
            assert isinstance(sh, NamedSharding)
            for shard in jax.device_put(arr, sh).addressable_shards:
                np.testing.assert_array_equal(
                    placed.shards[order[shard.device]].numpy(),
                    np.asarray(shard.data),
                )


@pytest.mark.parametrize("name,spans", [
    ("rowwise", ["rowwise/local_gemv"]),
    ("colwise", ["colwise/local_gemv", "colwise/combine/psum"]),
    ("blockwise", ["blockwise/local_gemv", "blockwise/combine/psum"]),
])
def test_named_spans_reach_the_profiler(name, spans):
    """With annotations on, each phase shows in a profiler capture under
    the JAX package's span name; off (the default), none does."""
    from matvec_mpi_multiplier_torch.obs.annotations import annotations

    fn = mv_torch.get_strategy(name).build(port_mesh(4))
    a, x = torch.ones(8, 8), torch.ones(8)
    for enabled in (True, False):
        with annotations(enabled), torch.profiler.profile() as prof:
            fn(a, x)
        names = {e.name for e in prof.events()}
        assert all((s in names) == enabled for s in spans)
