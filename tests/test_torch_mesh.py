"""The port's mesh against the JAX package's (parallel/mesh.py).

The port's mesh is a single controller over a list of torch devices; the
tests pass ``devices=[cpu] * p`` (p logical CPU shards), the analog of the
conftest's 8-device virtual CPU mesh.
"""

import pytest
import torch

from matvec_mpi_multiplier_tpu.parallel import mesh as jax_mesh
from matvec_mpi_multiplier_torch.parallel import mesh as tmesh
from matvec_mpi_multiplier_torch.utils.errors import ConfigError

CPU = torch.device("cpu")


@pytest.mark.parametrize("n", range(1, 65))
def test_most_square_factors_matches_jax(n):
    assert tmesh.most_square_factors(n) == jax_mesh.most_square_factors(n)


@pytest.mark.parametrize(
    "n,grid",
    [(1, (1, 1)), (2, (1, 2)), (4, (2, 2)), (6, (2, 3)), (8, (2, 4)),
     (12, (3, 4)), (24, (4, 6))],
)
def test_make_mesh_reference_grid(n, grid):
    mesh = tmesh.make_mesh(n, devices=[CPU] * n)
    assert mesh.grid == grid
    assert mesh.shape == {"rows": grid[0], "cols": grid[1]}
    assert tmesh.mesh_grid_shape(mesh) == grid
    assert mesh.size == n


def test_make_mesh_matches_jax_grid(devices):
    for n in (1, 2, 4, 8):
        jm = jax_mesh.make_mesh(n)
        tm = tmesh.make_mesh(n, devices=[CPU] * n)
        assert tmesh.mesh_grid_shape(tm) == jax_mesh.mesh_grid_shape(jm)
        assert tm.axis_names == tuple(jm.axis_names)


def test_make_mesh_shape_and_errors():
    assert tmesh.make_mesh(shape=(4, 2), devices=[CPU] * 8).grid == (4, 2)
    with pytest.raises(ConfigError, match="only 2 available"):
        tmesh.make_mesh(4, devices=[CPU] * 2)
    with pytest.raises(ConfigError, match="does not cover"):
        tmesh.make_mesh(8, shape=(3, 3), devices=[CPU] * 8)
    with pytest.raises(ConfigError, match="positive"):
        tmesh.most_square_factors(0)


def test_make_1d_mesh():
    mesh = tmesh.make_1d_mesh(4, devices=[CPU] * 4)
    assert mesh.axis_names == ("rows",)
    assert tmesh.mesh_grid_shape(mesh) == (1, 4)


def test_make_mesh_without_cuda_raises(monkeypatch):
    """No quiet CPU mesh: without CUDA and without devices=, it raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ConfigError, match="no CUDA device"):
        tmesh.make_mesh()
    with pytest.raises(ConfigError, match="no CUDA device"):
        tmesh.make_1d_mesh()


def test_shard_unshard_roundtrip_and_collectives():
    """Placement cuts like NamedSharding; psum sums in shard order."""
    mesh = tmesh.make_mesh(8, devices=[CPU] * 8)  # 2x4
    t = torch.arange(8 * 12, dtype=torch.float64).reshape(8, 12)
    st = tmesh.shard(t, ("rows", "cols"), mesh)
    assert [tuple(s.shape) for s in st.shards] == [(4, 3)] * 8
    assert all(s.is_contiguous() for s in st.shards)
    assert torch.equal(st.shards[5], t[4:8, 3:6])  # device (1, 1)
    assert torch.equal(tmesh.unshard(st), t)
    blocks = [torch.full((4,), float(f)) for f in range(8)]
    summed = tmesh.psum(blocks, mesh, "cols")
    assert torch.equal(summed[0], torch.full((4,), 0.0 + 1 + 2 + 3))
    assert torch.equal(summed[7], torch.full((4,), 4.0 + 5 + 6 + 7))
    rows = torch.arange(8, dtype=torch.float64)
    scattered = tmesh.psum_scatter(
        [rows * (f + 1) for f in range(8)], mesh, ("rows", "cols")
    )
    total = rows * sum(range(1, 9))
    assert all(torch.equal(s, total[f:f + 1]) for f, s in enumerate(scattered))


# ------------------------------------------------------------ all_to_all axes


def _all_to_all_meshes(p, kind):
    import matvec_mpi_multiplier_tpu as mv_jax

    if kind == "1d":
        return jax_mesh.make_1d_mesh(p), tmesh.make_1d_mesh(p, devices=[CPU] * p)
    return mv_jax.make_mesh(p), tmesh.make_mesh(p, devices=[CPU] * p)


@pytest.mark.parametrize("split,concat", [(0, 0), (1, 0), (0, 1)])
@pytest.mark.parametrize("kind", ["1d", "2d"])
@pytest.mark.parametrize("p", [2, 4, 8])
def test_all_to_all_axes_match_lax(devices, p, kind, split, concat):
    """all_to_all(split_axis, concat_axis) against lax.all_to_all(tiled=True)
    over the flat axes, and on 2-D meshes over the single "cols" axis."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import PartitionSpec as P

    from matvec_mpi_multiplier_tpu.utils.compat import shard_map

    jmesh, mesh = _all_to_all_meshes(p, kind)
    flat = tuple(mesh.axis_names)
    x = np.random.default_rng(p).standard_normal((p, 2 * p, 3 * p, 2))
    blocks = list(tmesh.shard(torch.from_numpy(x), (flat,), mesh).shards)
    for axes in [flat] + ([mesh.axis_names[1]] if kind == "2d" else []):
        want = jax.jit(shard_map(
            lambda v: jax.lax.all_to_all(v[0], axes, split, concat, tiled=True)[None],
            mesh=jmesh, in_specs=(P(flat),), out_specs=P(flat), check_vma=False,
        ))(jnp.asarray(x))
        got = tmesh.all_to_all([b[0] for b in blocks], mesh, axes, split_axis=split,
                               concat_axis=concat)
        np.testing.assert_array_equal(torch.stack(got).numpy(), np.asarray(want))


def test_all_to_all_keeps_dtype_and_gradient():
    """Chunks travel in their own dtype, and autograd sees through the
    exchange (on one device it is slicing and concatenation)."""
    mesh = tmesh.make_mesh(4, devices=[CPU] * 4)
    bf16 = [torch.ones(8, 4, dtype=torch.bfloat16) * f for f in range(4)]
    out = tmesh.all_to_all(bf16, mesh, mesh.axis_names, split_axis=1, concat_axis=0)
    assert [tuple(o.shape) for o in out] == [(32, 1)] * 4
    assert {o.dtype for o in out} == {torch.bfloat16}
    leaves = [torch.randn(8, 4, requires_grad=True) for _ in range(4)]
    out = tmesh.all_to_all(leaves, mesh, mesh.axis_names, split_axis=1, concat_axis=0)
    weights = [torch.full((32, 1), float(j + 1)) for j in range(4)]
    grads = torch.autograd.grad(sum((o * w).sum() for o, w in zip(out, weights)), leaves)
    # Column j of every block went to device j, which weighs it by j + 1.
    want = torch.arange(1.0, 5.0).expand(8, 4)
    assert all(torch.equal(g, want) for g in grads)


def test_all_to_all_names_the_indivisible_axis():
    mesh = tmesh.make_mesh(4, devices=[CPU] * 4)
    with pytest.raises(ValueError, match="split_axis 1 of a block of shape \\(8, 6\\) is "
                       "not divisible by the 4 devices of axes \\('rows', 'cols'\\)"):
        tmesh.all_to_all([torch.zeros(8, 6)] * 4, mesh, mesh.axis_names, split_axis=1)
