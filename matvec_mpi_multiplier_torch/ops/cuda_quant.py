"""The hand-written CUDA block-scaled GEMV (``csrc/quant_gemv.cu``) and its
plain version: the ``cuda`` tier for quantized storage.

Replaces the JAX package's Pallas kernel
(``matvec_mpi_multiplier_tpu/ops/pallas_quant.py::_quant_gemv_kernel``).
One launch computes ``deq(A) @ x`` over an int8 / int8c / fp8
:class:`~.quantize.QuantizedMatrix` for ``x`` of shape ``(k,)`` or
``(k, n)``, converting each payload element in registers: the dequantized
``A`` never exists in device memory. int8c's two levels run in the same
pass. The source says what bounds it and how.

:func:`quant_gemv_cuda` launches the kernel for CUDA tensors, or raises: a
missing ``nvcc``, a failed build or a refused launch is an error, never a
quiet switch to another tier. For tensors on the CPU, and only there, it
computes :func:`quant_gemv_plain`. ``quant_gemv_cuda.launches`` counts the
kernel's launches (nothing else adds to it).
"""

from __future__ import annotations

import torch

from . import _build
from .cuda_gemv import _DTYPE_CODES, PLAIN_CHUNK_BYTES
from .gemv import acc_dtype
from .quantize import QuantizedMatrix, register_storage_kernel

# The C entry's format codes (csrc/quant_gemv.cu::matvec_quant_gemv).
_FORMAT_CODES = {"int8": 0, "int8c": 1, "fp8": 2}


def _dequantized_rows(qa: QuantizedMatrix, rows: slice, acc: torch.dtype) -> torch.Tensor:
    """Rows of deq(A) in ``acc``: fl(s1*q1) (+ fl(s2*q2)), each product and
    the sum rounded once, as the kernel computes them in registers."""
    q = qa.q[rows]
    m, k = q.shape
    nb = k // qa.block

    def level(q, scales):
        return (q.to(acc).view(m, nb, qa.block) * scales.to(acc)[:, :, None]).view(m, k)

    out = level(q, qa.scales[rows])
    if qa.q2 is not None:
        out = out + level(qa.q2[rows], qa.scales2[rows])
    return out


def quant_gemv_plain(qa: QuantizedMatrix, x: torch.Tensor) -> torch.Tensor:
    """``deq(A) @ x`` in the accumulator dtype, in row chunks on ``qa``'s
    device: it dequantizes a chunk of rows at a time, never a full-width
    ``A``. Rank-agnostic in ``x``."""
    acc = acc_dtype(qa.dtype)
    m, k = qa.shape
    xa = x.to(acc).reshape(k, -1)
    y = torch.empty((m, xa.shape[1]), dtype=acc, device=qa.device)
    rows = max(1, PLAIN_CHUNK_BYTES // max(1, k * acc.itemsize))
    for i in range(0, m, rows):
        sl = slice(i, min(m, i + rows))
        y[sl] = _dequantized_rows(qa, sl, acc) @ xa
    return y.reshape((m, *x.shape[1:]))


def _check(qa: QuantizedMatrix, x: torch.Tensor) -> None:
    if not isinstance(qa, QuantizedMatrix):
        raise ValueError(f"quant_gemv needs a QuantizedMatrix, got {type(qa).__name__}")
    m, k = qa.shape
    if x.dim() not in (1, 2) or x.shape[0] != k:
        raise ValueError(
            f"quant_gemv needs x of shape ({k},) or ({k}, n) for a ({m}, {k}) "
            f"payload, got {tuple(x.shape)}"
        )
    if x.dtype != qa.dtype or x.dtype not in _DTYPE_CODES:
        raise ValueError(
            f"quant_gemv needs x in the payload's logical dtype among "
            f"bf16/fp16/fp32/fp64, got {x.dtype} for {qa.dtype}"
        )
    if qa.fmt not in _FORMAT_CODES or (qa.fmt == "int8c") != (qa.q2 is not None):
        raise ValueError(f"quant_gemv takes int8, int8c or fp8 storage, got {qa.fmt!r}")
    if k % qa.block or tuple(qa.scales.shape) != (m, k // qa.block):
        raise ValueError(
            f"scales {tuple(qa.scales.shape)} do not match a ({m}, {k}) payload "
            f"in blocks of {qa.block}"
        )
    leaves = [leaf for leaf in qa.leaves if leaf is not None]
    if any(leaf.device != x.device for leaf in leaves):
        raise ValueError(f"the payload is on {qa.device} but x is on {x.device}")
    if not all(t.is_contiguous() for t in (*leaves, x)):
        raise ValueError("quant_gemv needs contiguous payload, scales and x")


def quant_gemv_cuda(qa: QuantizedMatrix, x: torch.Tensor) -> torch.Tensor:
    """``deq(A) @ x`` by the CUDA kernel (plain version for CPU tensors)."""
    _check(qa, x)
    if x.device.type == "cpu":
        return quant_gemv_plain(qa, x)
    lib = _build.load_library()
    if x.device.type != "cuda":
        raise ValueError(f"quant_gemv_cuda runs on CUDA or CPU tensors, got {x.device}")
    m, k = qa.shape
    n = 1 if x.dim() == 1 else x.shape[1]
    y = torch.empty((m, *x.shape[1:]), dtype=acc_dtype(qa.dtype), device=x.device)
    if m == 0 or n == 0:
        return y
    q2 = None if qa.q2 is None else qa.q2.data_ptr()
    s2 = None if qa.scales2 is None else qa.scales2.data_ptr()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.matvec_quant_gemv(
            _FORMAT_CODES[qa.fmt], _DTYPE_CODES[qa.dtype], qa.q.data_ptr(),
            qa.scales.data_ptr(), q2, s2, x.data_ptr(), y.data_ptr(),
            m, k, n, qa.block, stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"quant_gemv kernel launch failed for a {qa.fmt} ({m}, {k}) payload, "
            f"x {tuple(x.shape)} {x.dtype}: "
            f"{lib.matvec_error_string(rc).decode()} (cudaError {rc})"
        )
    quant_gemv_cuda.launches += 1
    return y


quant_gemv_cuda.launches = 0  # type: ignore[attr-defined]

register_storage_kernel("cuda", quant_gemv_cuda)
