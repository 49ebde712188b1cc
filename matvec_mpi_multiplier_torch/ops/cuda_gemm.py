"""The hand-written CUDA GEMM tier (``csrc/gemm.cu``) and its plain version.

Replaces the JAX package's Pallas kernel
(``matvec_mpi_multiplier_tpu/ops/pallas_gemm.py::_mm_kernel``). At the
engine's bucket widths the kernel is bound by the HBM bytes of A; one block
spans all n <= 128 columns so A is read once per dispatch. bf16/fp16 run on
``mma.sync`` with fp32 accumulate, fp32 on FFMA (IEEE, never TF32), fp64 on
DFMA. The source describes the design.

:func:`gemm_cuda` launches the kernel for a CUDA tensor, or raises: a
missing ``nvcc``, a failed build or a refused launch is an error, never a
quiet switch to another tier. Unlike the Pallas tier there is no fallback
for unaligned shapes: the kernel covers every shape. For a tensor on the
CPU, and only there, it computes :func:`gemm_plain`.
``gemm_cuda.launches`` counts the kernel's launches (nothing else adds to
it).
"""

from __future__ import annotations

import torch

from . import _build
from .gemm_kernels import register_gemm_kernel
from .gemv import acc_dtype
from .cuda_gemv import _DTYPE_CODES, PLAIN_CHUNK_BYTES


def gemm_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a.to(acc) @ b.to(acc)`` in row chunks, on ``a``'s device: it never
    holds an fp32 copy of a multi-GB bf16 A."""
    acc = acc_dtype(a.dtype)
    m, k = a.shape
    c = torch.empty((m, b.shape[1]), dtype=acc, device=a.device)
    ba = b.to(acc)
    rows = max(1, PLAIN_CHUNK_BYTES // max(1, k * acc.itemsize))
    for i in range(0, m, rows):
        c[i:i + rows] = a[i:i + rows].to(acc) @ ba
    return c


def _check(a: torch.Tensor, b: torch.Tensor) -> None:
    if a.dim() != 2 or b.dim() != 2 or b.shape[0] != a.shape[1]:
        raise ValueError(
            f"gemm needs a (m, k) matrix and a (k, n) matrix, got "
            f"{tuple(a.shape)} and {tuple(b.shape)}"
        )
    if a.dtype != b.dtype or a.dtype not in _DTYPE_CODES:
        raise ValueError(
            f"gemm needs A and B of one dtype among bf16/fp16/fp32/fp64, got "
            f"{a.dtype} and {b.dtype}"
        )
    if a.device != b.device:
        raise ValueError(f"A is on {a.device} but B is on {b.device}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("gemm needs contiguous A and B (row-major)")


def gemm_cuda(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``C = A @ B`` by the CUDA kernel (plain version for CPU tensors)."""
    _check(a, b)
    if a.device.type == "cpu":
        return gemm_plain(a, b)
    lib = _build.load_library()
    if a.device.type != "cuda":
        raise ValueError(f"gemm_cuda runs on CUDA or CPU tensors, got {a.device}")
    m, k = a.shape
    n = b.shape[1]
    c = torch.empty((m, n), dtype=acc_dtype(a.dtype), device=a.device)
    if m == 0 or n == 0:
        return c
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.matvec_gemm(
            _DTYPE_CODES[a.dtype], a.data_ptr(), b.data_ptr(), c.data_ptr(),
            m, n, k, stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"gemm kernel launch failed for A {tuple(a.shape)} B "
            f"{tuple(b.shape)} {a.dtype}: "
            f"{lib.matvec_error_string(rc).decode()} (cudaError {rc})"
        )
    gemm_cuda.launches += 1
    return c


gemm_cuda.launches = 0  # type: ignore[attr-defined]

register_gemm_kernel("cuda", gemm_cuda)
