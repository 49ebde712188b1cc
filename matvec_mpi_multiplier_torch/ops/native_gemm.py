"""Native C++ GEMM tier: the rank-2 face of the native kernel path.

The port's counterpart of the JAX package's ``ops/native_gemm.py``, on its
own ``native/gemm.cc``: :func:`gemm_ctypes` (numpy in and out, the oracle)
and :func:`gemm_native` (CPU tensors, the GEMM tier ``"native"``), with the
contract of ``ops/native_gemv.py``: float32/float64 only (``TypeError``
otherwise), and a tensor on a CUDA device raises ``ConfigError``.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .gemm_kernels import register_gemm_kernel
from .native_gemv import _CTYPES, _ptr, _require, host_operands, native_available


def native_gemm_available() -> bool:
    """True when the native library is built (or could be built now): one
    library holds the GEMV and the GEMM."""
    return native_available()


def gemm_ctypes(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Host-side native GEMM, numpy in and out: the oracle path."""
    lib = _require()
    a = np.ascontiguousarray(a)
    b = np.ascontiguousarray(b, dtype=a.dtype)
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
        # The C kernel trusts its dims: a mismatch would read out of bounds.
        raise ValueError(f"gemm shape mismatch: a {a.shape} @ b {b.shape}")
    ctype = _CTYPES.get(a.dtype)
    if ctype is None:
        raise TypeError(f"native gemm supports float32/float64, got {a.dtype}")
    m, k = a.shape
    n = b.shape[1]
    c = np.empty((m, n), dtype=a.dtype)
    fn = lib.matvec_gemm_f32 if a.dtype == np.float32 else lib.matvec_gemm_f64
    ptr = lambda arr: arr.ctypes.data_as(ctypes.POINTER(ctype))  # noqa: E731
    fn(ptr(a), ptr(b), ptr(c), m, k, n)
    return c


def gemm_native(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The C++ GEMM on CPU tensors (the ``"native"`` GEMM tier), in A's
    dtype."""
    a, b, ctype = host_operands(a, b, "gemm")
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(
            f"gemm shape mismatch: a {tuple(a.shape)} @ b {tuple(b.shape)}")
    lib = _require()
    m, k = a.shape
    n = b.shape[1]
    c = torch.empty((m, n), dtype=a.dtype)
    fn = lib.matvec_gemm_f32 if a.dtype == torch.float32 else lib.matvec_gemm_f64
    fn(_ptr(a, ctype), _ptr(b, ctype), _ptr(c, ctype), m, k, n)
    return c


def register_if_available(build: bool = False) -> bool:
    """Put ``"native"`` in the GEMM registry when the library is there
    (``build=True`` builds it first; see ``native_gemv``)."""
    from ..utils.native_lib import load_library

    available = native_available() if build else load_library() is not None
    if available:
        register_gemm_kernel("native", gemm_native)
    return available


register_if_available()
