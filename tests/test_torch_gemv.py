"""The port's GEMV tiers against the JAX package's.

The same numpy operands (uniform [0, 10), the reference's range) go through
the JAX package's ``gemv_pallas`` (interpret mode on the CPU, as
tests/test_pallas.py runs it; falling back to XLA where no aligned tiling
exists, e.g. the 4x8 fixture and 33x100) and ``gemv_xla``, and through the
port's ``gemv_plain`` and ``gemv_cuda`` — which, given CPU tensors, computes
the plain version. The CUDA kernel itself runs only on the card
(chip_smoke.py holds it against the plain version there).

Tolerances: fp64 rtol 1e-12 (positive terms, no cancellation); fp32 rtol
2e-5, atol 2e-4 (tests/test_pallas.py:33). bf16: the output is the fp32
accumulator and a bf16 x bf16 product is exact in fp32, so the fp32
tolerance holds.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matvec_mpi_multiplier_tpu.ops.gemv import gemv_xla
from matvec_mpi_multiplier_tpu.ops.pallas_gemv import gemv_pallas
from matvec_mpi_multiplier_torch.ops import _build, available_kernels, get_kernel
from matvec_mpi_multiplier_torch.ops import cuda_gemv
from matvec_mpi_multiplier_torch.ops.cuda_gemv import gemv_cuda, gemv_plain
from matvec_mpi_multiplier_torch.ops.gemv import (
    acc_dtype,
    gemv_colwise_torch,
    gemv_torch,
)
from matvec_mpi_multiplier_torch.utils.convert import from_numpy

from conftest import FIXTURE_MATRIX, FIXTURE_PRODUCT, FIXTURE_VECTOR

SHAPES = [(256, 1024), (16, 128), (48, 256), (512, 2048), (32, 4096),
          (4, 8), (33, 100)]
JAX_DTYPES = {"float32": jnp.float32, "float64": jnp.float64,
              "bfloat16": jnp.bfloat16}


def operands(shape, dtype, seed=0):
    """(a, x) as JAX arrays and as the port's CPU tensors, bit-identical."""
    if shape == (4, 8):
        a, x = FIXTURE_MATRIX, FIXTURE_VECTOR
    else:
        rng = np.random.default_rng(seed)
        a, x = rng.uniform(0, 10, shape), rng.uniform(0, 10, shape[1])
    a_j = jnp.asarray(a, JAX_DTYPES[dtype])
    x_j = jnp.asarray(x, JAX_DTYPES[dtype])
    return a_j, x_j, from_numpy(np.asarray(a_j), "cpu"), from_numpy(np.asarray(x_j), "cpu")


def tolerance(dtype):
    if dtype == "float64":
        return dict(rtol=1e-12, atol=0)
    return dict(rtol=2e-5, atol=2e-4)


@pytest.mark.parametrize("dtype", ["float32", "float64", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_gemv_matches_jax(shape, dtype):
    a_j, x_j, a_t, x_t = operands(shape, dtype)
    y_pallas = np.asarray(gemv_pallas(a_j, x_j))
    y_xla = np.asarray(gemv_xla(a_j, x_j))
    for fn in (gemv_plain, gemv_cuda):
        y = fn(a_t, x_t)
        assert y.dtype == acc_dtype(a_t.dtype)
        np.testing.assert_allclose(y.numpy(), y_pallas, **tolerance(dtype))
        np.testing.assert_allclose(y.numpy(), y_xla, **tolerance(dtype))
    if shape == (4, 8) and dtype == "float64":
        np.testing.assert_allclose(gemv_cuda(a_t, x_t).numpy(), FIXTURE_PRODUCT,
                                   rtol=1e-12)


def test_gemv_plain_row_chunks_are_exact(monkeypatch):
    """Chunking the rows changes no row's sum: bitwise equal results."""
    _, _, a, x = operands((256, 1024), "bfloat16")
    whole = gemv_plain(a, x)
    monkeypatch.setattr(cuda_gemv, "PLAIN_CHUNK_BYTES", 3 * 1024 * 4)
    assert torch.equal(gemv_plain(a, x), whole)


@pytest.mark.parametrize(
    "kernel", [gemv_plain, gemv_cuda, gemv_torch, gemv_colwise_torch]
)
def test_accumulator_contract(kernel):
    """Every tier returns the accumulator dtype: fp32 for bf16/fp16/fp32,
    fp64 for fp64 (ops/gemv.py)."""
    for dtype, acc in [(torch.bfloat16, torch.float32),
                       (torch.float16, torch.float32),
                       (torch.float32, torch.float32),
                       (torch.float64, torch.float64)]:
        y = kernel(torch.ones(8, 8, dtype=dtype), torch.ones(8, dtype=dtype))
        assert y.dtype == acc
        assert torch.equal(y, torch.full((8,), 8.0, dtype=acc))
    with pytest.raises(ValueError, match="bf16, fp16, fp32 or fp64"):
        acc_dtype(torch.int32)


def test_registry():
    assert available_kernels() == ["cuda", "torch", "torch_colwise"]
    assert get_kernel("cuda") is gemv_cuda
    assert get_kernel(gemv_torch) is gemv_torch
    with pytest.raises(KeyError, match="unknown gemv kernel"):
        get_kernel("pallas")


@pytest.mark.parametrize("name", ["torch", "torch_colwise"])
def test_library_tiers_match_jax_xla(name):
    a_j, x_j, a_t, x_t = operands((48, 256), "float64")
    np.testing.assert_allclose(
        get_kernel(name)(a_t, x_t).numpy(), np.asarray(gemv_xla(a_j, x_j)),
        rtol=1e-12,
    )


def test_cpu_call_launches_nothing():
    before = gemv_cuda.launches
    gemv_cuda(torch.ones(4, 8), torch.ones(8))
    assert gemv_cuda.launches == before


def test_wrapper_rejects_what_the_kernel_does_not_take():
    a = torch.ones(4, 8)
    with pytest.raises(ValueError, match="matrix and a"):
        gemv_cuda(a, torch.ones(7))
    with pytest.raises(ValueError, match="one dtype"):
        gemv_cuda(a, torch.ones(8, dtype=torch.float64))
    with pytest.raises(ValueError, match="one dtype"):
        gemv_cuda(a.to(torch.int32), torch.ones(8, dtype=torch.int32))
    with pytest.raises(ValueError, match="contiguous"):
        gemv_cuda(torch.ones(8, 4).t(), torch.ones(8))


def test_missing_nvcc_raises_and_nothing_falls_back(monkeypatch, tmp_path):
    """Without nvcc the build raises a clear error naming every source, and
    a non-CPU tensor never falls back to the plain version or a library
    call — for the GEMV, the GEMM, the block-scaled GEMV (which also
    never reaches the scan tier or a dequantized A) and the fused solver
    step."""
    from matvec_mpi_multiplier_torch.ops import cuda_gemm, cuda_quant, cuda_solver, quantize

    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    _build.load_library.cache_clear()
    assert [s.name for s in _build.SOURCES] == ["gemm.cu", "gemv.cu", "quant_gemv.cu",
                                                "ring_gemv.cu", "solver_step.cu"]
    with pytest.raises(RuntimeError, match="nvcc not found.*gemm.cu, gemv.cu, quant_gemv.cu, "
                       "ring_gemv.cu, solver_step.cu"):
        _build.find_nvcc()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build_library()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load_library()
    calls = []
    for module, plain in ((cuda_gemv, "gemv_plain"), (cuda_gemm, "gemm_plain"),
                          (cuda_quant, "quant_gemv_plain"),
                          (cuda_quant, "_dequantized_rows"),
                          (quantize, "matvec_quantized"), (quantize, "dequantize"),
                          (cuda_solver, "solver_step_plain"), (cuda_solver, "gemv_plain"),
                          (cuda_solver, "quant_gemv_plain")):
        monkeypatch.setattr(module, plain, lambda *args: calls.append(args))
    monkeypatch.setattr(torch, "matmul", lambda *args: calls.append(args))
    kernels = (gemv_cuda, cuda_gemm.gemm_cuda, cuda_quant.quant_gemv_cuda,
               cuda_solver.solver_step_cuda)
    before = [k.launches for k in kernels]
    a = torch.ones(4, 8, device="meta")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        gemv_cuda(a, torch.ones(8, device="meta"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_gemm.gemm_cuda(a, torch.ones(8, 3, device="meta"))
    for fmt in ("int8", "int8c", "fp8"):
        payload = torch.float8_e4m3fn if fmt == "fp8" else torch.int8
        leaves = [torch.zeros(4, 8, dtype=payload, device="meta"),
                  torch.ones(4, 2, device="meta")]
        if fmt == "int8c":
            leaves += [torch.zeros(4, 8, dtype=torch.int8, device="meta"),
                       torch.ones(4, 2, device="meta")]
        qa = quantize.QuantizedMatrix(*leaves, fmt=fmt, block=4, out_dtype=torch.float32)
        for x in (torch.ones(8, device="meta"), torch.ones(8, 3, device="meta")):
            with pytest.raises(RuntimeError, match="nvcc not found"):
                cuda_quant.quant_gemv_cuda(qa, x)
        vectors = [torch.ones(8, device="meta") for _ in range(4)]
        for op, width in (("cg", 1), ("chebyshev", 4)):
            s_in = torch.ones(width, device="meta")
            for shard in (a, qa):
                with pytest.raises(RuntimeError, match="nvcc not found"):
                    cuda_solver.solver_step_cuda(op, shard, 0, *vectors, s_in)
    assert [k.launches for k in kernels] == before
    assert calls == []
    assert not (tmp_path / "build").exists()
