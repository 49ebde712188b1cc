"""The port's GEMM tier and GEMM strategies against the JAX package's.

The same seeded numpy operands (uniform [0, 10), the reference's range, so
relative tolerances mean something) go through the JAX package's
``matmul_pallas`` (interpret mode on the CPU, falling back to ``matmul_xla``
where no aligned tiling exists) and ``build_gemm`` on the conftest's
8-device CPU mesh, and through the port's ``gemm_cuda`` — which, given CPU
tensors, computes its plain version — and ``build_gemm`` on p logical CPU
shards. The CUDA kernel itself runs only on the card (chip_smoke.py holds it
against the plain version there).

Tolerances: fp64 rtol 1e-12; fp32 rtol 2e-5, atol 2e-4
(tests/test_pallas.py:33); the kernels' fp32 output of bf16 input is held
to the fp32 tolerance (a bf16 product is exact in fp32); a strategy's
output cast back to bf16 is one ulp apart at most (rtol 2^-7).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import matvec_mpi_multiplier_tpu as mv_jax
from matvec_mpi_multiplier_tpu.bench.metrics import read_csv
from matvec_mpi_multiplier_tpu.models import gemm as jax_gemm
from matvec_mpi_multiplier_tpu.ops.gemm_kernels import matmul_xla
from matvec_mpi_multiplier_tpu.ops.pallas_gemm import default_gemm_tiles, matmul_pallas
from matvec_mpi_multiplier_tpu.utils.errors import ShardingError as JaxShardingError
from matvec_mpi_multiplier_torch.bench import metrics, sweep
from matvec_mpi_multiplier_torch.bench.timing import benchmark_gemm
from matvec_mpi_multiplier_torch.models import gemm
from matvec_mpi_multiplier_torch.ops import (
    available_gemm_kernels,
    gemm_kernel_name_for,
    get_gemm_kernel,
)
from matvec_mpi_multiplier_torch.ops import cuda_gemm
from matvec_mpi_multiplier_torch.ops.cuda_gemm import gemm_cuda, gemm_plain
from matvec_mpi_multiplier_torch.ops.gemm_kernels import gemm_torch
from matvec_mpi_multiplier_torch.parallel.mesh import make_1d_mesh, make_mesh, shard
from matvec_mpi_multiplier_torch.utils.convert import from_numpy
from matvec_mpi_multiplier_torch.utils.errors import ShardingError

from conftest import FIXTURE_MATRIX

CPU = torch.device("cpu")
STRATEGIES = ["rowwise", "colwise", "blockwise"]
JAX_DTYPES = {"float64": jnp.float64, "float32": jnp.float32,
              "bfloat16": jnp.bfloat16, "float16": jnp.float16}
KERNEL_TOL = {"float64": dict(rtol=1e-12, atol=0),
              "float32": dict(rtol=2e-5, atol=2e-4),
              "bfloat16": dict(rtol=2e-5, atol=2e-4)}
CAST_TOL = {"float64": dict(rtol=1e-12, atol=0),
            "float32": dict(rtol=2e-5, atol=2e-4),
            "bfloat16": dict(rtol=2 ** -7, atol=0),
            "float16": dict(rtol=2 ** -10, atol=0)}


def port_mesh(p):
    return make_mesh(p, devices=[CPU] * p)


def operands(m, k, n, dtype="float64", seed=0):
    """(a, b) as JAX arrays and as the port's CPU tensors, bit-identical."""
    rng = np.random.default_rng(seed)
    a = FIXTURE_MATRIX if (m, k) == (4, 8) else rng.uniform(0, 10, (m, k))
    b = rng.uniform(0, 10, (k, n))
    a_j, b_j = jnp.asarray(a, JAX_DTYPES[dtype]), jnp.asarray(b, JAX_DTYPES[dtype])
    return (a_j, b_j, from_numpy(np.asarray(a_j), "cpu"),
            from_numpy(np.asarray(b_j), "cpu"))


def as_f64(y):
    if isinstance(y, torch.Tensor):
        return y.to(torch.float64).numpy()
    return np.asarray(jnp.asarray(y).astype(jnp.float64))


# ------------------------------------------------------------ registries


def test_gemm_strategy_registry():
    """The JAX package's names, the ring/overlap bindings included; an
    unknown name raises KeyError as in JAX."""
    assert gemm.available_gemm_strategies() == jax_gemm.available_gemm_strategies()
    with pytest.raises(KeyError, match="unknown gemm strategy"):
        gemm.build_gemm("diagonal", port_mesh(1))


@pytest.mark.parametrize(
    "name", ["colwise_ring", "colwise_ring_overlap", "colwise_a2a", "colwise_overlap"]
)
def test_ring_names_are_not_ported(devices, name):
    """The ring/overlap GEMM names (ported by the ring/overlap slice):
    build_gemm agrees with the JAX package's, validate_gemm refuses what
    it refuses, and gemm_shardings cuts C's rows over the ring."""
    a_j, b_j, a_t, b_t = operands(16, 16, 8, seed=14)
    c_j = jax_gemm.build_gemm(name, mv_jax.make_mesh(2))(a_j, b_j)
    c_t = gemm.build_gemm(name, port_mesh(2))(a_t, b_t)
    np.testing.assert_allclose(as_f64(c_t), as_f64(c_j), rtol=1e-12)
    gemm.validate_gemm(name, 16, 16, 8, port_mesh(2))
    with pytest.raises(ShardingError, match="m \\(rows of A\\)"):
        gemm.validate_gemm(name, 15, 16, 8, port_mesh(2))
    with pytest.raises(JaxShardingError, match="m \\(rows of A\\)"):
        jax_gemm.validate_gemm(name, 15, 16, 8, mv_jax.make_mesh(2))
    mesh = port_mesh(2)
    assert gemm.gemm_shardings(name, mesh) == ((None, mesh.axis_names),
                                               (mesh.axis_names, None))


def test_gemm_kernel_registry():
    # The host C++ tier registers once its library is built (ops/native_gemm.py).
    from matvec_mpi_multiplier_torch.ops import native_gemm

    native = ["native"] if native_gemm.register_if_available(build=True) else []
    assert available_gemm_kernels() == sorted(["auto", "cuda", "ozaki", "ozaki6", "torch",
                                               *native])
    assert get_gemm_kernel("cuda") is gemm_cuda
    assert get_gemm_kernel(gemm_torch) is gemm_torch
    # The one alias, as the JAX package maps xla_colwise -> xla.
    assert gemm_kernel_name_for("torch_colwise") == "torch"
    assert gemm_kernel_name_for("cuda") == "cuda"
    assert gemm_kernel_name_for("nope") == "nope"
    with pytest.raises(KeyError, match="unknown gemm kernel"):
        get_gemm_kernel("nope")
    with pytest.raises(KeyError, match="unknown gemm kernel"):
        get_gemm_kernel("pallas")


# ------------------------------------------------------------ the kernel


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(32, 256, 128), (64, 512, 256)])
def test_gemm_cuda_matches_pallas_where_it_tiles(shape, dtype):
    m, k, n = shape
    assert default_gemm_tiles(m, n, k, 2 if dtype == "bfloat16" else 4) is not None
    a_j, b_j, a_t, b_t = operands(m, k, n, dtype, seed=1)
    want = np.asarray(matmul_pallas(a_j, b_j))
    for fn in (gemm_cuda, gemm_plain):
        c = fn(a_t, b_t)
        assert c.dtype == torch.float32
        np.testing.assert_allclose(c.numpy(), want, **KERNEL_TOL[dtype])


@pytest.mark.parametrize("dtype", ["float64", "float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(4, 8, 3), (7, 13, 5), (33, 100, 1)])
def test_gemm_cuda_matches_xla_where_pallas_cannot_tile(shape, dtype):
    """Unaligned shapes: the Pallas tier falls back to XLA; the port's cuda
    tier has no fallback and covers them itself."""
    a_j, b_j, a_t, b_t = operands(*shape, dtype, seed=2)
    want = np.asarray(matmul_xla(a_j, b_j))
    np.testing.assert_allclose(np.asarray(matmul_pallas(a_j, b_j)), want, rtol=1e-6)
    np.testing.assert_allclose(gemm_cuda(a_t, b_t).numpy(), want, **KERNEL_TOL[dtype])


@pytest.mark.parametrize("dtype,itemsize", [(torch.bfloat16, 2), (torch.float32, 4)])
@pytest.mark.parametrize("shape", [(4, 8, 3), (7, 13, 5), (33, 100, 1), (32, 256, 128),
                                   (64, 512, 256)])
def test_gemm_tiles_cover_what_pallas_cannot_tile(shape, dtype, itemsize):
    """The JAX package's default_gemm_tiles has no tiling for unaligned
    shapes (its kernel falls back to XLA); the port's plan covers every
    shape with a route of its own kernel, whose k-block is the dtype's."""
    m, k, n = shape
    jax_tiles = default_gemm_tiles(m, n, k, itemsize)
    plan = cuda_gemm.default_gemm_tiles(m, n, k, dtype)
    assert plan.route in cuda_gemm.ROUTE_CODES
    assert plan.bk == (64 if itemsize == 2 else 32)
    if jax_tiles is None:
        assert (m, k, n) in [(4, 8, 3), (7, 13, 5), (33, 100, 1)]
    else:
        assert plan.bn >= min(n, 128) and plan.route in ("wgmma_tma", "ffma")


def test_gemm_plain_row_chunks_are_exact(monkeypatch):
    """Chunking the rows changes no row's sum: bitwise equal results."""
    _, _, a, b = operands(96, 128, 8, "bfloat16")
    whole = gemm_plain(a, b)
    monkeypatch.setattr(cuda_gemm, "PLAIN_CHUNK_BYTES", 5 * 128 * 4)
    assert torch.equal(gemm_plain(a, b), whole)


@pytest.mark.parametrize("kernel", [gemm_plain, gemm_cuda, gemm_torch])
def test_gemm_accumulator_contract(kernel):
    for dtype, acc in [(torch.bfloat16, torch.float32), (torch.float16, torch.float32),
                       (torch.float32, torch.float32), (torch.float64, torch.float64)]:
        c = kernel(torch.ones(8, 8, dtype=dtype), torch.ones(8, 3, dtype=dtype))
        assert c.dtype == acc
        assert torch.equal(c, torch.full((8, 3), 8.0, dtype=acc))


def test_gemm_cpu_call_launches_nothing():
    before = gemm_cuda.launches
    gemm_cuda(torch.ones(4, 8), torch.ones(8, 2))
    assert gemm_cuda.launches == before


def test_gemm_wrapper_rejects_what_the_kernel_does_not_take():
    a = torch.ones(4, 8)
    with pytest.raises(ValueError, match="matrix and a"):
        gemm_cuda(a, torch.ones(7, 2))
    with pytest.raises(ValueError, match="matrix and a"):
        gemm_cuda(a, torch.ones(8))
    with pytest.raises(ValueError, match="one dtype"):
        gemm_cuda(a, torch.ones(8, 2, dtype=torch.float64))
    with pytest.raises(ValueError, match="contiguous"):
        gemm_cuda(a, torch.ones(2, 8).t())


# ------------------------------------------------------------ strategies


def run_both(name, p, a_j, b_j, a_t, b_t, kernel="xla", **kwargs):
    c_j = mv_jax.models.gemm.build_gemm(name, mv_jax.make_mesh(p), kernel=kernel,
                                        **kwargs)(a_j, b_j)
    c_t = gemm.build_gemm(name, port_mesh(p), **kwargs)(a_t, b_t)
    return c_j, c_t


@pytest.mark.parametrize("kernel", ["xla", "pallas"])
@pytest.mark.parametrize("p", [1, 2, 4, 8])
@pytest.mark.parametrize("name", STRATEGIES)
def test_build_gemm_matches_jax(devices, name, p, kernel):
    """fp64 against the JAX package's build_gemm with its xla and pallas
    tiers; the port runs its default cuda tier (the plain version here)."""
    a_j, b_j, a_t, b_t = operands(64, 512, 128, "float64", seed=p)
    c_j, c_t = run_both(name, p, a_j, b_j, a_t, b_t, kernel=kernel)
    assert c_t.dtype == torch.float64 and tuple(c_t.shape) == (64, 128)
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), rtol=1e-12)
    np.testing.assert_allclose(c_t.numpy(), a_t.numpy() @ b_t.numpy(), rtol=1e-12)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("name", STRATEGIES)
def test_build_gemm_reduced_precision(devices, name, dtype):
    """fp32 accumulation whatever the storage dtype; C comes back in the
    storage dtype, within one ulp of the JAX package's."""
    a_j, b_j, a_t, b_t = operands(16, 32, 8, dtype, seed=3)
    c_j, c_t = run_both(name, 8, a_j, b_j, a_t, b_t)
    assert c_t.dtype == a_t.dtype
    np.testing.assert_allclose(as_f64(c_t), as_f64(c_j), **CAST_TOL[dtype])


@pytest.mark.parametrize("name", STRATEGIES)
def test_gemm_sharded_output_matches_jax(devices, name):
    """gather_output=False: the port's per-device C blocks equal the JAX
    result's addressable shards, device by device."""
    a_j, b_j, a_t, b_t = operands(16, 16, 8, seed=4)
    jmesh = mv_jax.make_mesh(8)
    c_j = mv_jax.models.gemm.build_gemm(name, jmesh, gather_output=False)(a_j, b_j)
    c_t = gemm.build_gemm(name, port_mesh(8), gather_output=False)(a_t, b_t)
    order = {d: f for f, d in enumerate(jmesh.devices.flat)}
    assert len(c_t.shards) == 8
    for s in c_j.addressable_shards:
        mine = c_t.shards[order[s.device]].numpy()
        assert mine.shape == s.data.shape
        np.testing.assert_allclose(mine, np.asarray(s.data), rtol=1e-12)


@pytest.mark.parametrize("name,shape", [
    ("rowwise", (12, 16, 8)), ("colwise", (16, 12, 8)),
    ("blockwise", (16, 10, 8)), ("blockwise", (3, 16, 8)),
])
def test_gemm_guards_match_jax_messages(devices, name, shape):
    with pytest.raises(JaxShardingError) as jax_err:
        jax_gemm.validate_gemm(name, *shape, mv_jax.make_mesh(8))
    with pytest.raises(ShardingError) as port_err:
        gemm.validate_gemm(name, *shape, port_mesh(8))
    assert str(port_err.value) == str(jax_err.value)


def test_blockwise_gemm_needs_2d_mesh(devices):
    from matvec_mpi_multiplier_tpu.parallel.mesh import make_1d_mesh as jax_1d_mesh

    with pytest.raises(JaxShardingError) as jax_err:
        jax_gemm.validate_gemm("blockwise", 8, 8, 4, jax_1d_mesh(4))
    with pytest.raises(ShardingError) as port_err:
        gemm.validate_gemm("blockwise", 8, 8, 4, make_1d_mesh(4, devices=[CPU] * 4))
    assert str(port_err.value) == str(jax_err.value)


@pytest.mark.parametrize("name", STRATEGIES)
def test_gemm_placement_matches_jax(devices, name):
    """gemm_shardings cuts A and B exactly as the JAX package's
    NamedShardings do, and build_gemm takes the placed operands."""
    a_j, b_j, a_t, b_t = operands(16, 24, 8, seed=5)
    jmesh, mesh = mv_jax.make_mesh(8), port_mesh(8)
    order = {d: f for f, d in enumerate(jmesh.devices.flat)}
    spec_a, spec_b = gemm.gemm_shardings(name, mesh)
    placed = (shard(a_t, spec_a, mesh), shard(b_t, spec_b, mesh))
    for arr, sh, mine in zip((a_j, b_j), jax_gemm.gemm_shardings(name, jmesh), placed):
        for s in jax.device_put(arr, sh).addressable_shards:
            np.testing.assert_array_equal(mine.shards[order[s.device]].numpy(),
                                          np.asarray(s.data))
    c = gemm.build_gemm(name, mesh)(*placed)
    np.testing.assert_allclose(c.numpy(), a_t.numpy() @ b_t.numpy(), rtol=1e-12)
    with pytest.raises(ShardingError, match="placed for another"):
        other = "colwise" if name != "colwise" else "rowwise"
        gemm.build_gemm(other, mesh)(*placed)


def test_build_batched_maps_gemv_tier_names():
    """A GEMV tier name builds its GEMM face; combine and stages build."""
    from matvec_mpi_multiplier_torch import get_strategy

    a_t = torch.from_numpy(np.random.default_rng(6).uniform(0, 10, (8, 8)))
    b_t = torch.from_numpy(np.random.default_rng(7).uniform(0, 10, (8, 3)))
    for kernel in ("torch_colwise", "torch", "cuda"):
        c = get_strategy("rowwise").build_batched(port_mesh(2), kernel=kernel)(a_t, b_t)
        np.testing.assert_allclose(c.numpy(), a_t.numpy() @ b_t.numpy(), rtol=1e-12)
    with pytest.raises(KeyError, match="unknown gemm kernel"):
        get_strategy("rowwise").build_batched(port_mesh(2), kernel="pallas")
    # The colwise schedules (ported by the ring/overlap slice) batch too.
    a_c = torch.from_numpy(np.random.default_rng(8).uniform(0, 10, (8, 8)))
    for kwargs in ({"combine": "ring"}, {"stages": 2}, {"combine": "overlap"}):
        c = get_strategy("colwise").build_batched(port_mesh(2), **kwargs)(a_c, b_t)
        np.testing.assert_allclose(c.numpy(), a_c.numpy() @ b_t.numpy(), rtol=1e-12)
    with pytest.raises(ValueError, match="True or False"):
        get_strategy("colwise").build_batched(port_mesh(2), gather_output="ring")


# ------------------------------------------------------------ timing, sweep


def test_benchmark_gemm_result(devices, tmp_path):
    _, _, a_t, b_t = operands(16, 16, 8, seed=8)
    res = benchmark_gemm("blockwise", port_mesh(8), a_t.numpy(), b_t.numpy(),
                         n_reps=2, measure="sync")
    assert res.strategy == "gemm_blockwise"
    assert (res.n_rows, res.n_cols, res.n_devices, res.n_rhs) == (16, 16, 8, 8)
    assert res.gflops == pytest.approx(2 * 16 * 16 * 8 / res.mean_time_s / 1e9)
    path = metrics.append_result(res, tmp_path)
    assert path == metrics.csv_path("gemm_blockwise", tmp_path)
    assert read_csv(path)[0]["n_rows"] == 16


def test_sweep_cli_gemm(tmp_path, capsys):
    rc = sweep.main([
        "--op", "gemm", "--strategy", "blockwise", "rowwise", "--sizes", "16",
        "--platform", "cpu", "--host-devices", "8", "--devices", "8",
        "--n-rhs", "8", "--n-reps", "2", "--measure", "sync",
        "--data-root", str(tmp_path),
    ])
    assert rc == 0
    assert "2 configs timed, 0 skipped" in capsys.readouterr().out
    for name in ("blockwise", "rowwise"):
        rows = read_csv(tmp_path / "out" / f"gemm_{name}.csv")
        assert (rows[0]["n_rows"], rows[0]["n_cols"], rows[0]["n_processes"]) == (16, 16, 8)
        assert rows[0]["time"] > 0
    ext = read_csv(tmp_path / "out" / "results_extended.csv")
    assert {r["strategy"] for r in ext} == {"gemm_blockwise", "gemm_rowwise"}
    assert all(r["n_rhs"] == 8 for r in ext)


@pytest.mark.parametrize("argv,match", [
    (["--op", "gemm", "--use-files", "--sizes", "16"], "matvec-only"),
    (["--op", "gemm", "--kernel", "torch_colwise", "--sizes", "16"], "unknown gemm kernel"),
    (["--kernel", "nope", "--sizes", "16"], "unknown matvec kernel"),
])
def test_sweep_cli_gemm_rejects(argv, match):
    with pytest.raises(SystemExit, match=match):
        sweep.main(argv + ["--platform", "cpu"])
