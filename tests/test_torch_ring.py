"""The port's ring collectives against the JAX package's ``parallel/ring.py``.

The same seeded numpy operands go through each JAX function under
``shard_map`` on the conftest's 8-device CPU mesh and through its port
counterpart, which takes and returns per-shard lists, on p logical CPU
shards: p ∈ {1, 2, 4, 8}, on a 1-D mesh and over the flat axes of a 2-D
one. The walks are the same, so each chunk is summed in the same order;
tolerance fp64 rtol 1e-12 (tests/test_overlap.py), fp32 1e-5.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import matvec_mpi_multiplier_tpu as mv_jax
from matvec_mpi_multiplier_tpu.ops.gemv import gemv_xla
from matvec_mpi_multiplier_tpu.parallel import ring as jring
from matvec_mpi_multiplier_tpu.parallel.mesh import make_1d_mesh as jax_1d_mesh
from matvec_mpi_multiplier_tpu.utils.compat import shard_map
from matvec_mpi_multiplier_torch.ops.cuda_gemv import gemv_cuda
from matvec_mpi_multiplier_torch.ops.gemm_kernels import gemm_torch
from matvec_mpi_multiplier_torch.parallel import ring
from matvec_mpi_multiplier_torch.parallel.mesh import (
    all_to_all,
    make_1d_mesh,
    make_mesh,
    ppermute,
    shard,
)

CPU = torch.device("cpu")
PS = [1, 2, 4, 8]
KINDS = ["1d", "2d"]


def meshes(p, kind):
    """The JAX mesh and the port's, with the axes the ring runs over."""
    if kind == "1d":
        jmesh, tmesh = jax_1d_mesh(p), make_1d_mesh(p, devices=[CPU] * p)
    else:
        jmesh, tmesh = mv_jax.make_mesh(p), make_mesh(p, devices=[CPU] * p)
    assert tuple(jmesh.axis_names) == tmesh.axis_names
    return jmesh, tmesh, tmesh.axis_names


def jax_map(body, jmesh, in_specs, out_spec):
    return jax.jit(shard_map(body, mesh=jmesh, in_specs=in_specs,
                             out_specs=out_spec, check_vma=False))


def cut(array, spec, tmesh):
    """The port's per-shard blocks of a numpy array placed by ``spec``."""
    return list(shard(torch.from_numpy(np.ascontiguousarray(array)), spec, tmesh).shards)


def partials(p, n, seed):
    """One full-length partial per device (shape (p, n)), fp64."""
    return np.random.default_rng(seed).standard_normal((p, n))


# ------------------------------------------------------------ collectives


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("p", PS)
def test_ppermute_and_all_to_all_match_lax(devices, p, kind):
    jmesh, tmesh, axes = meshes(p, kind)
    x = partials(p, 4 * p, seed=1)
    perm = [(i, (i + 1) % p) for i in range(p)]
    want = jax_map(lambda v: jax.lax.ppermute(v, axes, perm), jmesh, (P(axes),),
                   P(axes))(jnp.asarray(x))
    got = ppermute(cut(x, (axes,), tmesh), tmesh, axes, perm)
    np.testing.assert_array_equal(torch.cat(got).numpy(), np.asarray(want))
    want = jax_map(
        lambda v: jax.lax.all_to_all(v[0].reshape(p, 4), axes, 0, 0, tiled=True)[None],
        jmesh, (P(axes),), P(axes))(jnp.asarray(x))
    got = all_to_all([b[0] for b in cut(x, (axes,), tmesh)], tmesh, axes)
    np.testing.assert_array_equal(
        torch.stack(got).numpy(), np.asarray(want).reshape(p, 4 * p))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("p", PS)
@pytest.mark.parametrize("name", ["ring_psum_scatter", "a2a_psum_scatter"])
def test_reduce_scatter_matches_jax(devices, name, p, kind):
    jmesh, tmesh, axes = meshes(p, kind)
    x = partials(p, 16 * p, seed=2)
    want = jax_map(lambda v: getattr(jring, name)(v[0], axes), jmesh, (P(axes),),
                   P(axes))(jnp.asarray(x))
    got = getattr(ring, name)([b[0] for b in cut(x, (axes,), tmesh)], tmesh, axes)
    assert [tuple(g.shape) for g in got] == [(16,)] * p
    np.testing.assert_allclose(torch.cat(got).numpy(), np.asarray(want), rtol=1e-12)
    np.testing.assert_allclose(torch.cat(got).numpy(), x.sum(0), rtol=1e-12)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("p", PS)
def test_ring_all_gather_matches_jax(devices, p, kind):
    jmesh, tmesh, axes = meshes(p, kind)
    chunks = np.random.default_rng(3).standard_normal((p * 8, 3))
    want = np.asarray(jax_map(lambda v: jring.ring_all_gather(v, axes), jmesh,
                              (P(axes),), P())(jnp.asarray(chunks)))
    got = ring.ring_all_gather(cut(chunks, (axes,), tmesh), tmesh, axes)
    for g in got:  # every device holds the whole, axis-ordered
        np.testing.assert_array_equal(g.numpy(), want)
    np.testing.assert_array_equal(want, chunks)


def test_ring_all_gather_over_one_axis_of_2d(devices):
    """Gathering over 'rows' alone: each 'cols' group runs its own ring
    (blockwise's output gather)."""
    jmesh, tmesh, _ = meshes(8, "2d")
    y = np.random.default_rng(4).standard_normal(16)
    want = np.asarray(jax_map(lambda v: jring.ring_all_gather(v, "rows"), jmesh,
                              (P("rows"),), P())(jnp.asarray(y)))
    for g in ring.ring_all_gather(cut(y, ("rows",), tmesh), tmesh, "rows"):
        np.testing.assert_array_equal(g.numpy(), want)


@pytest.mark.parametrize("dtype,rtol", [("float64", 1e-12), ("float32", 1e-5)])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("p", PS)
def test_ring_matvec_matches_jax(devices, p, kind, dtype, rtol):
    jmesh, tmesh, axes = meshes(p, kind)
    rng = np.random.default_rng(5)
    a = rng.uniform(0, 10, (64, 32)).astype(dtype)
    x = rng.uniform(0, 10, 32).astype(dtype)
    want = jax_map(lambda ap, xs: jring.ring_matvec(ap, xs, axes, gemv_xla), jmesh,
                   (P(None, axes), P(axes)), P(axes))(jnp.asarray(a), jnp.asarray(x))
    got = ring.ring_matvec(cut(a, (None, axes), tmesh), cut(x, (axes,), tmesh),
                           tmesh, axes, gemv_cuda)
    assert got[0].dtype == (torch.float64 if dtype == "float64" else torch.float32)
    np.testing.assert_allclose(torch.cat(got).numpy(), np.asarray(want), rtol=rtol)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("p", PS)
def test_ring_matmul_matches_jax(devices, p, kind):
    jmesh, tmesh, axes = meshes(p, kind)
    rng = np.random.default_rng(6)
    a, b = rng.standard_normal((64, 32)), rng.standard_normal((32, 5))
    want = jax_map(lambda ap, bs: jring.ring_matmul(ap, bs, axes, lambda u, v: u @ v),
                   jmesh, (P(None, axes), P(axes, None)), P(axes, None))(
        jnp.asarray(a), jnp.asarray(b))
    got = ring.ring_matmul(cut(a, (None, axes), tmesh), cut(b, (axes, None), tmesh),
                           tmesh, axes, gemm_torch)
    np.testing.assert_allclose(torch.cat(got).numpy(), np.asarray(want), rtol=1e-12)
    np.testing.assert_allclose(torch.cat(got).numpy(), a @ b, rtol=1e-10)


@pytest.mark.parametrize(
    "m,p", [(64, 8), (48, 8), (60, 8), (8, 8), (64, 1), (96, 4), (8024, 8)]
)
def test_stage_ladder_matches_jax(m, p):
    assert ring.stage_ladder(m, p) == jring.stage_ladder(m, p)
    assert ring.stage_ladder(m, p, (4, 2)) == jring.stage_ladder(m, p, (4, 2))


# ------------------------------------------------------------ staged overlap


@pytest.mark.parametrize("step", ["psum_scatter", "ring"])
@pytest.mark.parametrize("stages", [1, 2, 4])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("p", PS)
def test_staged_overlap_scatter_matches_jax(devices, p, kind, stages, step):
    jmesh, tmesh, axes = meshes(p, kind)
    rng = np.random.default_rng(7)
    a, x = rng.standard_normal((64, 32)), rng.standard_normal(32)
    want = jax_map(
        lambda ap, xs: jring.staged_overlap_scatter(ap, xs, axes, gemv_xla, stages, step),
        jmesh, (P(None, axes), P(axes)), P(axes))(jnp.asarray(a), jnp.asarray(x))
    got = ring.staged_overlap_scatter(
        cut(a, (None, axes), tmesh), cut(x, (axes,), tmesh), tmesh, axes,
        gemv_cuda, stages, step)
    np.testing.assert_allclose(torch.cat(got).numpy(), np.asarray(want), rtol=1e-12)
    np.testing.assert_allclose(torch.cat(got).numpy(), a @ x, rtol=1e-10)


@pytest.mark.parametrize("stages", [1, 2, 4])
def test_staged_overlap_scatter_batched_matches_jax(devices, stages):
    """The walk is rank-agnostic: a (k/p, b) block rides it unchanged."""
    jmesh, tmesh, axes = meshes(8, "1d")
    rng = np.random.default_rng(8)
    a, b = rng.standard_normal((64, 32)), rng.standard_normal((32, 5))
    want = jax_map(
        lambda ap, bs: jring.staged_overlap_scatter(ap, bs, axes, lambda u, v: u @ v,
                                                    stages, "ring"),
        jmesh, (P(None, axes), P(axes, None)), P(axes, None))(jnp.asarray(a), jnp.asarray(b))
    got = ring.staged_overlap_scatter(
        cut(a, (None, axes), tmesh), cut(b, (axes, None), tmesh), tmesh, axes,
        gemm_torch, stages, "ring")
    np.testing.assert_allclose(torch.cat(got).numpy(), np.asarray(want), rtol=1e-12)


@pytest.mark.parametrize("stages", [1, 2, 4])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("p", PS)
def test_staged_overlap_gather_matches_jax(devices, p, kind, stages):
    """Rowwise's face: rows over the flat axes, x whole, no reduce."""
    jmesh, tmesh, axes = meshes(p, kind)
    rng = np.random.default_rng(9)
    a, x = rng.standard_normal((64, 32)), rng.standard_normal(32)
    want = np.asarray(jax_map(
        lambda ab, xf: jring.staged_overlap_gather(ab, xf, axes, gemv_xla, stages),
        jmesh, (P(axes, None), P()), P())(jnp.asarray(a), jnp.asarray(x)))
    got = ring.staged_overlap_gather(cut(a, (axes, None), tmesh), cut(x, (), tmesh),
                                     tmesh, axes, gemv_cuda, stages)
    for g in got:
        np.testing.assert_allclose(g.numpy(), want, rtol=1e-12)
    np.testing.assert_allclose(want, a @ x, rtol=1e-10)


@pytest.mark.parametrize("stages", [1, 2, 4])
@pytest.mark.parametrize("p", PS)
def test_staged_overlap_gather_with_reduce_axes_matches_jax(devices, p, stages):
    """Blockwise's face: each stage's partial summed over 'cols', then
    ring-gathered over 'rows'."""
    jmesh, tmesh, _ = meshes(p, "2d")
    rng = np.random.default_rng(10)
    a, x = rng.standard_normal((64, 32)), rng.standard_normal(32)
    spec_a = ("rows", "cols")
    want = np.asarray(jax_map(
        lambda ab, xs: jring.staged_overlap_gather(ab, xs, "rows", gemv_xla, stages, "cols"),
        jmesh, (P(*spec_a), P("cols")), P())(jnp.asarray(a), jnp.asarray(x)))
    got = ring.staged_overlap_gather(cut(a, spec_a, tmesh), cut(x, ("cols",), tmesh),
                                     tmesh, "rows", gemv_cuda, stages, "cols")
    for g in got:
        np.testing.assert_allclose(g.numpy(), want, rtol=1e-12)
    np.testing.assert_allclose(want, a @ x, rtol=1e-10)


# ------------------------------------------------------------ guards


def _jax_error(fn, *arrays, in_specs, out_spec, jmesh):
    with pytest.raises(ValueError) as info:
        jax_map(fn, jmesh, in_specs, out_spec)(*map(jnp.asarray, arrays))
    return re.escape(str(info.value))


def test_guard_messages_match_jax(devices):
    """Indivisible rows, stages < 1 and an unknown step raise the JAX
    package's ValueError messages."""
    jmesh, tmesh, axes = meshes(8, "1d")
    part = np.ones((8, 12))
    msg = _jax_error(lambda v: jring.ring_psum_scatter(v[0], axes), part,
                     in_specs=(P(axes),), out_spec=P(axes), jmesh=jmesh)
    with pytest.raises(ValueError, match=msg):
        ring.ring_psum_scatter([b[0] for b in cut(part, (axes,), tmesh)], tmesh, axes)
    msg = _jax_error(lambda v: jring.a2a_psum_scatter(v[0], axes), part,
                     in_specs=(P(axes),), out_spec=P(axes), jmesh=jmesh)
    with pytest.raises(ValueError, match=msg):
        ring.a2a_psum_scatter([b[0] for b in cut(part, (axes,), tmesh)], tmesh, axes)
    a, x = np.ones((48, 16)), np.ones(16)
    panels, segs = cut(a, (None, axes), tmesh), cut(x, (axes,), tmesh)
    specs = dict(in_specs=(P(None, axes), P(axes)), out_spec=P(axes), jmesh=jmesh)
    msg = _jax_error(lambda ap, xs: jring.ring_matvec(ap[:44], xs, axes, gemv_xla),
                     a, x, **specs)
    with pytest.raises(ValueError, match=msg):
        ring.ring_matvec([pa[:44] for pa in panels], segs, tmesh, axes, gemv_cuda)
    for stages, step in ((4, "ring"), (0, "ring"), (2, "tree")):
        msg = _jax_error(
            lambda ap, xs: jring.staged_overlap_scatter(ap, xs, axes, gemv_xla, stages, step),
            a, x, **specs)
        with pytest.raises(ValueError, match=msg):
            ring.staged_overlap_scatter(panels, segs, tmesh, axes, gemv_cuda, stages, step)
    rows = cut(a, (axes, None), tmesh)  # 6 local rows
    for stages in (4, 0):
        msg = _jax_error(
            lambda ab, xf: jring.staged_overlap_gather(ab, xf, axes, gemv_xla, stages),
            a, x, in_specs=(P(axes, None), P()), out_spec=P(), jmesh=jmesh)
        with pytest.raises(ValueError, match=msg):
            ring.staged_overlap_gather(rows, cut(x, (), tmesh), tmesh, axes, gemv_cuda,
                                       stages)
