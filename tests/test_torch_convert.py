"""Carrying operands from the JAX package into the port, bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import matvec_mpi_multiplier_tpu as mv_jax
import matvec_mpi_multiplier_torch as mv_torch
from matvec_mpi_multiplier_torch.parallel.mesh import make_mesh
from matvec_mpi_multiplier_torch.utils.convert import (
    dtype_name,
    from_numpy,
    place_operands,
    torch_dtype,
)

CPU = torch.device("cpu")
DTYPES = ["bfloat16", "float16", "float32", "float64"]
# Integer views of each element size, to compare bit patterns.
INTS = {2: (np.int16, torch.int16), 4: (np.int32, torch.int32),
        8: (np.int64, torch.int64)}


@pytest.mark.parametrize("dtype", DTYPES)
def test_jax_array_to_tensor_is_bit_identical(dtype):
    rng = np.random.default_rng(0)
    arr = np.asarray(jnp.asarray(rng.standard_normal((33, 17)) * 100, dtype))
    t = from_numpy(arr, "cpu")
    assert t.dtype == torch_dtype(dtype) and dtype_name(t.dtype) == dtype
    np_int, t_int = INTS[t.element_size()]
    np.testing.assert_array_equal(t.view(t_int).numpy(), arr.view(np_int))


def test_from_numpy_copies_a_read_only_array():
    arr = np.asarray(jnp.arange(4.0))
    assert not arr.flags.writeable
    t = from_numpy(arr, "cpu")
    t[0] = 7.0
    assert arr[0] == 0.0


def test_torch_dtype_rejects_unknown():
    with pytest.raises(ValueError, match="unsupported dtype"):
        torch_dtype("int8")


@pytest.mark.parametrize("name", ["rowwise", "colwise", "blockwise"])
def test_place_operands_then_matvec_equals_jax(devices, name):
    rng = np.random.default_rng(1)
    a, x = rng.uniform(0, 10, (16, 32)), rng.uniform(0, 10, 32)
    jmesh = mv_jax.make_mesh(8)
    jstrat = mv_jax.get_strategy(name)
    sh_a, sh_x = jstrat.shardings(jmesh)
    y_j = jstrat.build(jmesh)(jax.device_put(a, sh_a), jax.device_put(x, sh_x))
    mesh = make_mesh(8, devices=[CPU] * 8)
    strat = mv_torch.get_strategy(name)
    y_t = strat.build(mesh)(*place_operands(strat, mesh, a, x))
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), rtol=1e-12)
