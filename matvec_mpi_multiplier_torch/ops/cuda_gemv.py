"""The hand-written CUDA GEMV tier (``csrc/gemv.cu``) and its plain version.

Replaces the JAX package's Pallas kernel
(``matvec_mpi_multiplier_tpu/ops/pallas_gemv.py::_gemv_kernel``). The kernel
is bound by HBM bytes (``m·k·itemsize + k·itemsize + m·acc_itemsize``); its
design — one warp per row, 16-byte coalesced loads of A, fixed-order sums —
is described in the source.

:func:`gemv_cuda` launches the kernel for a CUDA tensor, or raises: a
missing ``nvcc``, a failed build or a refused launch is an error, never a
quiet switch to another tier. For a tensor on the CPU, and only there, it
computes :func:`gemv_plain`, so the CPU tests reach every line around the
kernel. ``gemv_cuda.launches`` counts the kernel's launches (nothing else
adds to it), so a run can show that its path went through the kernel.
"""

from __future__ import annotations

import torch

from . import _build
from .gemv import acc_dtype, register_kernel

# The C entry's dtype codes (csrc/gemv.cu::matvec_gemv).
_DTYPE_CODES = {
    torch.bfloat16: 0, torch.float16: 1, torch.float32: 2, torch.float64: 3,
}

# Rows of A the plain version widens to the accumulator dtype at a time: it
# must never hold an fp32 copy of a multi-GB bf16 A.
PLAIN_CHUNK_BYTES = 256 << 20


def gemv_plain(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``(a.to(acc) * x.to(acc)).sum(1)`` in row chunks, on ``a``'s device."""
    acc = acc_dtype(a.dtype)
    m, k = a.shape
    y = torch.empty(m, dtype=acc, device=a.device)
    xa = x.to(acc)
    rows = max(1, PLAIN_CHUNK_BYTES // max(1, k * acc.itemsize))
    for i in range(0, m, rows):
        y[i:i + rows] = (a[i:i + rows].to(acc) * xa).sum(1)
    return y


def _check(a: torch.Tensor, x: torch.Tensor) -> None:
    if a.dim() != 2 or x.dim() != 1 or x.shape[0] != a.shape[1]:
        raise ValueError(
            f"gemv needs a (m, k) matrix and a (k,) vector, got "
            f"{tuple(a.shape)} and {tuple(x.shape)}"
        )
    if a.dtype != x.dtype or a.dtype not in _DTYPE_CODES:
        raise ValueError(
            f"gemv needs A and x of one dtype among bf16/fp16/fp32/fp64, got "
            f"{a.dtype} and {x.dtype}"
        )
    if a.device != x.device:
        raise ValueError(f"A is on {a.device} but x is on {x.device}")
    if not (a.is_contiguous() and x.is_contiguous()):
        raise ValueError("gemv needs contiguous A and x (row pitch = k)")


def gemv_cuda(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``y = A @ x`` by the CUDA kernel (plain version for CPU tensors)."""
    _check(a, x)
    if a.device.type == "cpu":
        return gemv_plain(a, x)
    lib = _build.load_library()
    if a.device.type != "cuda":
        raise ValueError(f"gemv_cuda runs on CUDA or CPU tensors, got {a.device}")
    m, k = a.shape
    y = torch.empty(m, dtype=acc_dtype(a.dtype), device=a.device)
    if m == 0:
        return y
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.matvec_gemv(
            _DTYPE_CODES[a.dtype], a.data_ptr(), x.data_ptr(), y.data_ptr(),
            m, k, stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"gemv kernel launch failed for A {tuple(a.shape)} {a.dtype}: "
            f"{lib.matvec_error_string(rc).decode()} (cudaError {rc})"
        )
    gemv_cuda.launches += 1
    return y


gemv_cuda.launches = 0  # type: ignore[attr-defined]

register_kernel("cuda", gemv_cuda)
