"""The port's ring GEMV and ``combine="pallas_ring"`` against the JAX package's.

``ops/cuda_ring.py::ring_gemv_plain`` is the arithmetic of the port's
hand-written ring kernel (``csrc/ring_gemv.cu``): the p-step walk of
``ops/pallas_collective.py::_ring_gemv_kernel``. Here it, and
``ops/collective.py::collective_ring_gemv`` (which takes it for CPU
tensors), meet the JAX package's ``collective_ring_gemv`` under
``shard_map``, in interpret mode, as the JAX package's own tests run it on
the CPU, at its test's 64×32 shape, for p ∈ {1, 2, 4, 8}. Tolerances: fp64
rtol 1e-12; fp32 and bf16 (whose products are exact in the fp32
accumulator) 1e-5. Through ``build``, y is cast back to the storage dtype.

The kernel itself runs only on the card: its test is marked ``cuda`` and
skips here; ``chip_smoke.py`` holds it against the plain version there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import matvec_mpi_multiplier_tpu as mv_jax
from matvec_mpi_multiplier_tpu.ops.pallas_collective import (
    collective_ring_gemv as jax_collective_ring_gemv,
)
from matvec_mpi_multiplier_tpu.parallel.mesh import make_1d_mesh as jax_1d_mesh
from matvec_mpi_multiplier_tpu.utils.compat import shard_map
from matvec_mpi_multiplier_tpu.utils.errors import ShardingError as JaxShardingError
from matvec_mpi_multiplier_torch import get_strategy
from matvec_mpi_multiplier_torch.ops import collective
from matvec_mpi_multiplier_torch.ops.collective import (
    collective_ring_gemv,
    pallas_ring_supported,
    ring_gemv_plain,
)
from matvec_mpi_multiplier_torch.ops.cuda_ring import MAX_RING_RANKS, ring_gemv_cuda
from matvec_mpi_multiplier_torch.parallel.mesh import make_1d_mesh, make_mesh, shard
from matvec_mpi_multiplier_torch.utils.convert import from_numpy
from matvec_mpi_multiplier_torch.utils.errors import ShardingError

CPU = torch.device("cpu")
JAX_DTYPES = {"float64": jnp.float64, "float32": jnp.float32, "bfloat16": jnp.bfloat16}
RTOL = {"float64": 1e-12, "float32": 1e-5, "bfloat16": 1e-5}


def operands(m, k, dtype, seed=0):
    """(a, x) as JAX arrays and as the port's CPU tensors, bit-identical."""
    rng = np.random.default_rng(seed)
    a_j = jnp.asarray(rng.uniform(0, 10, (m, k)), JAX_DTYPES[dtype])
    x_j = jnp.asarray(rng.uniform(0, 10, k), JAX_DTYPES[dtype])
    return a_j, x_j, from_numpy(np.asarray(a_j), "cpu"), from_numpy(np.asarray(x_j), "cpu")


def jax_ring(a_j, x_j, p):
    mesh = jax_1d_mesh(p, axis_name="d")
    return np.asarray(jax.jit(shard_map(
        lambda ap, xs: jax_collective_ring_gemv(ap, xs, "d"),
        mesh=mesh, in_specs=(P(None, "d"), P("d")), out_specs=P("d"),
        check_vma=False,
    ))(a_j, x_j)).astype(np.float64)


def panels(a_t, x_t, p):
    mesh = make_1d_mesh(p, devices=[CPU] * p)
    return (list(shard(a_t, (None, mesh.axis_names), mesh).shards),
            list(shard(x_t, (mesh.axis_names,), mesh).shards), mesh)


@pytest.mark.parametrize("dtype", ["float64", "float32", "bfloat16"])
@pytest.mark.parametrize("p", [1, 2, 4, 8])
def test_plain_walk_matches_jax_kernel(devices, p, dtype):
    a_j, x_j, a_t, x_t = operands(64, 32, dtype)
    want = jax_ring(a_j, x_j, p)
    pa, xs, mesh = panels(a_t, x_t, p)
    acc = torch.float64 if dtype == "float64" else torch.float32
    for got in (ring_gemv_plain(pa, xs),
                collective_ring_gemv(pa, xs, mesh, mesh.axis_names),
                ring_gemv_cuda(pa, xs)):
        assert [g.dtype for g in got] == [acc] * p
        assert [tuple(g.shape) for g in got] == [(64 // p,)] * p
        np.testing.assert_allclose(torch.cat(got).double().numpy(), want,
                                   rtol=RTOL[dtype])


def test_plain_walk_sums_in_ring_order():
    """Chunk d is ((t_{d+1} + t_{d+2}) + ...) + t_d: with tiles chosen so
    that the order shows in fp32, the walk matches that sum exactly."""
    p, big = 4, 2.0 ** 24
    # Rank d's panel is all ones times its segment value v[d]: tile t_d(c)
    # is v[d] for every row of every chunk.
    v = [big, 1.0, -big, 1.0]
    pa = [torch.ones((8, 1), dtype=torch.float32) for _ in range(p)]
    xs = [torch.tensor([val], dtype=torch.float32) for val in v]
    got = ring_gemv_plain(pa, xs)
    for d in range(p):
        want = np.float32(v[(d + 1) % p])
        for j in range(2, p + 1):
            want = np.float32(want + np.float32(v[(d + j) % p]))
        np.testing.assert_array_equal(got[d].numpy(), np.full(2, want, np.float32))


@pytest.mark.parametrize("p,dtype", [(8, "float64"), (4, "float32"), (2, "bfloat16")])
def test_build_pallas_ring_matches_jax(devices, p, dtype):
    a_j, x_j, a_t, x_t = operands(64, 64, dtype, seed=1)
    y_j = mv_jax.get_strategy("colwise").build(
        mv_jax.make_1d_mesh(p), combine="pallas_ring")(a_j, x_j)
    strat = get_strategy("colwise")
    mesh = make_1d_mesh(p, devices=[CPU] * p)
    y_t = strat.build(mesh, combine="pallas_ring")(a_t, x_t)
    assert y_t.dtype == a_t.dtype
    rtol = 2 ** -7 if dtype == "bfloat16" else RTOL[dtype]
    np.testing.assert_allclose(y_t.double().numpy(),
                               np.asarray(y_j.astype(jnp.float64)), rtol=rtol)
    y_s = strat.build(mesh, combine="pallas_ring", gather_output=False)(a_t, x_t)
    assert y_s.spec == ((mesh.axis_names),) and len(y_s.shards) == p


def test_pallas_ring_needs_1d_mesh(devices):
    """A 2-D mesh has no single-link ring: ShardingError at validate, with
    the JAX package's message, as in JAX."""
    jax_strat = mv_jax.get_strategy("colwise", combine="pallas_ring")
    with pytest.raises(JaxShardingError) as jax_err:
        jax_strat.validate(64, 64, mv_jax.make_mesh(8))
    strat = get_strategy("colwise", combine="pallas_ring")
    mesh = make_mesh(8, devices=[CPU] * 8)
    with pytest.raises(ShardingError) as err:
        strat.validate(64, 64, mesh)
    assert str(err.value) == str(jax_err.value)
    a = torch.ones((64, 64), dtype=torch.float64)
    with pytest.raises(ShardingError, match="single-axis"):
        strat.build(mesh)(a, torch.ones(64, dtype=torch.float64))
    with pytest.raises(ValueError, match="single-axis"):
        collective._resolve_ring_axis(("rows", "cols"))
    assert collective._resolve_ring_axis(("rows",)) == "rows"
    assert not pallas_ring_supported(mesh)
    assert pallas_ring_supported(make_1d_mesh(8, devices=[CPU] * 8))


def test_pallas_ring_is_matvec_only(devices):
    mesh = make_1d_mesh(4, devices=[CPU] * 4)
    with pytest.raises(ValueError, match="batched combine"):
        get_strategy("colwise").build_batched(mesh, combine="pallas_ring")
    assert not get_strategy("colwise").supports_combine_batched("pallas_ring")
    assert not mv_jax.get_strategy("colwise").supports_combine_batched("pallas_ring")
    pa, xs, _ = panels(torch.ones((8, 8)), torch.ones(8), 4)
    with pytest.raises(ValueError, match="matvec-only"):
        collective_ring_gemv(pa, [x[:, None] for x in xs], mesh, mesh.axis_names)
    with pytest.raises(ValueError, match="rows not divisible"):
        collective_ring_gemv([t[:6] for t in pa], xs, mesh, mesh.axis_names)


def test_ring_gemv_wrapper_checks():
    pa, xs, _ = panels(torch.ones((32, 32)), torch.ones(32), 4)
    with pytest.raises(ValueError, match="one x segment per panel"):
        ring_gemv_cuda(pa, xs[:3])
    with pytest.raises(ValueError, match="one dtype"):
        ring_gemv_cuda(pa, [x.double() for x in xs])
    with pytest.raises(ValueError, match="one shape"):
        ring_gemv_cuda(pa[:3] + [pa[3][:, :4].contiguous()], xs)
    with pytest.raises(ValueError, match="contiguous"):
        ring_gemv_cuda([t.t().contiguous().t() for t in pa], xs)
    many = [torch.ones((MAX_RING_RANKS + 1, 1))] * (MAX_RING_RANKS + 1)
    with pytest.raises(ShardingError, match="thread block cluster"):
        ring_gemv_cuda(many, [torch.ones(1)] * (MAX_RING_RANKS + 1))


def test_pallas_ring_candidate_gating(devices, monkeypatch):
    """Offered only where it runs as a kernel: a single-axis mesh of CUDA
    devices, or a CPU one with MATVEC_TUNE_PALLAS=1; never batched."""
    strat = get_strategy("colwise")
    mesh_1d = make_1d_mesh(8, devices=[CPU] * 8)
    mesh_2d = make_mesh(8, devices=[CPU] * 8)
    on_card = make_1d_mesh(4, devices=[torch.device("cuda", 0)] * 4)
    monkeypatch.delenv("MATVEC_TUNE_PALLAS", raising=False)
    assert "pallas_ring" not in strat.combine_candidates(mesh_1d)
    assert "pallas_ring" in strat.combine_candidates(on_card)
    monkeypatch.setenv("MATVEC_TUNE_PALLAS", "1")
    assert "pallas_ring" in strat.combine_candidates(mesh_1d)
    assert "pallas_ring" not in strat.combine_candidates(mesh_2d)
    assert "pallas_ring" not in strat.combine_candidates_batched(mesh_1d)
    assert "pallas_ring" not in strat.combine_candidates_batched(on_card)


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run `python -m pytest -m cuda "
                    "tests/test_torch_ring_gemv.py` on the chip")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("p", [1, 2, 4, 8])
def test_ring_kernel_matches_plain_on_card(card, p):
    """The kernel against its plain version, bitwise repeatable, at a
    ragged shape (1003 rows per chunk and unaligned rows at p = 8)."""
    gen = torch.Generator(device=card).manual_seed(p)
    a = torch.rand((8024, 6168), generator=gen, device=card) * 10
    x = torch.rand(6168, generator=gen, device=card) * 10
    mesh = make_1d_mesh(p, devices=[card] * p)
    pa = list(shard(a, (None, mesh.axis_names), mesh).shards)
    xs = list(shard(x, (mesh.axis_names,), mesh).shards)
    before = ring_gemv_cuda.launches
    y1, y2 = ring_gemv_cuda(pa, xs), ring_gemv_cuda(pa, xs)
    ref = ring_gemv_plain(pa, xs)
    torch.cuda.synchronize(card)
    assert ring_gemv_cuda.launches == before + 2
    for u, v, r in zip(y1, y2, ref):
        assert torch.equal(u, v)
        torch.testing.assert_close(u, r, rtol=1e-4, atol=0)
