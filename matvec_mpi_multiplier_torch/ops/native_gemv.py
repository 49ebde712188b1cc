"""Native C++ GEMV tier: the ctypes oracle and the ``native`` kernel.

Reference analog: the reference's whole compute path is native C compiled by
``mpicc`` (``multiply_std_rowwise``, ``src/matr_utils.c:86-96``). The port's
counterpart of the JAX package's ``ops/native_gemv.py``, on its own sources
(``native/gemv.cc``, built by ``utils/native_lib.py``):

* :func:`gemv_ctypes` — the C++ kernel on numpy arrays, the CPU oracle the
  tests and ``chip_smoke.py`` hold the card's kernels to;
* :func:`gemv_native` — the same kernel on CPU tensors through their
  ``data_ptr()``, registered as the GEMV tier ``"native"``
  (:func:`register_if_available`). It is a host kernel: a tensor on a CUDA
  device raises :class:`~..utils.errors.ConfigError` (the JAX tier is a
  CPU-platform custom call); nothing is copied to the host for it.

The kernel accumulates in its storage dtype, float32 or float64 only, where
storage is the accumulator of every other tier anyway; any other dtype
raises ``TypeError``.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .gemv import register_kernel
from ..utils.errors import ConfigError

_CTYPES = {np.dtype(np.float32): ctypes.c_float,
           np.dtype(np.float64): ctypes.c_double}
_TORCH = {torch.float32: ctypes.c_float, torch.float64: ctypes.c_double}
_SIGS_DECLARED = None  # the CDLL the argtypes were declared on


def _load() -> ctypes.CDLL | None:
    """The library, built first if needed, with the GEMV and GEMM argtypes
    declared; None where there is no compiler and no earlier build."""
    global _SIGS_DECLARED
    from ..utils.native_lib import declare_ctypes_sig, library

    lib = library()
    if lib is None:
        return None
    # Keyed to the handle: a rebuild swaps it, and the new one needs its
    # own declarations.
    if _SIGS_DECLARED is not lib:
        for op, n_ints in (("gemv", 2), ("gemm", 3)):
            declare_ctypes_sig(lib, f"matvec_{op}_f32", ctypes.c_float, 3, n_ints)
            declare_ctypes_sig(lib, f"matvec_{op}_f64", ctypes.c_double, 3, n_ints)
        _SIGS_DECLARED = lib
    return lib


def _require() -> ctypes.CDLL:
    from ..utils.native_lib import lib_path

    lib = _load()
    if lib is None:
        raise RuntimeError(
            f"native library not found at {lib_path()} and no C++ compiler "
            "to build it (g++, or $CXX)"
        )
    return lib


def native_available() -> bool:
    """True when the native library is built (or could be built now)."""
    return _load() is not None


def host_operands(a, b, what: str):
    """Check two tensors for a native kernel: on the CPU (a CUDA tensor
    raises ``ConfigError``, with no copy to the host), float32/float64
    (``TypeError`` otherwise); returns them contiguous, ``b`` in A's dtype,
    and the ctypes scalar."""
    for t in (a, b):
        if t.device.type != "cpu":
            raise ConfigError(
                f"the native {what} is a host kernel and takes CPU tensors; "
                f"got one on {t.device} (use kernel='cuda' on the card)"
            )
    ctype = _TORCH.get(a.dtype)
    if ctype is None:
        raise TypeError(f"native {what} supports float32/float64, got {a.dtype}")
    return a.contiguous(), b.to(a.dtype).contiguous(), ctype


def _ptr(t: torch.Tensor, ctype):
    return ctypes.cast(t.data_ptr(), ctypes.POINTER(ctype))


def gemv_ctypes(a: np.ndarray, x: np.ndarray) -> np.ndarray:
    """Host-side native GEMV, numpy in and out: the oracle path."""
    lib = _require()
    a = np.ascontiguousarray(a)
    x = np.ascontiguousarray(x, dtype=a.dtype)
    ctype = _CTYPES.get(a.dtype)
    if ctype is None:
        raise TypeError(f"native gemv supports float32/float64, got {a.dtype}")
    if a.ndim != 2 or x.shape != (a.shape[1],):
        # The C kernel trusts its dims: a mismatch would read out of bounds.
        raise ValueError(f"gemv shape mismatch: a {a.shape} @ x {x.shape}")
    m, k = a.shape
    y = np.empty((m,), dtype=a.dtype)
    fn = lib.matvec_gemv_f32 if a.dtype == np.float32 else lib.matvec_gemv_f64
    ptr = lambda arr: arr.ctypes.data_as(ctypes.POINTER(ctype))  # noqa: E731
    fn(ptr(a), ptr(x), ptr(y), m, k)
    return y


def gemv_native(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The C++ GEMV on CPU tensors (the ``"native"`` tier): ``y = A x`` in
    A's dtype, which for float32/float64 is the registry's accumulator
    contract (``ops/gemv.py``)."""
    a, x, ctype = host_operands(a, x, "gemv")
    if a.dim() != 2 or tuple(x.shape) != (a.shape[1],):
        raise ValueError(
            f"gemv shape mismatch: a {tuple(a.shape)} @ x {tuple(x.shape)}")
    lib = _require()
    m, k = a.shape
    y = torch.empty((m,), dtype=a.dtype)
    fn = lib.matvec_gemv_f32 if a.dtype == torch.float32 else lib.matvec_gemv_f64
    fn(_ptr(a, ctype), _ptr(x, ctype), _ptr(y, ctype), m, k)
    return y


def register_if_available(build: bool = False) -> bool:
    """Put ``"native"`` in the GEMV registry when the library is there.
    ``build=True`` builds it first where it is absent or stale (the sweep's
    ``--kernel native`` and the tests); without it nothing is compiled, so
    importing ``ops`` never runs ``g++``."""
    from ..utils.native_lib import load_library

    if build:
        available = native_available()
    else:
        available = load_library() is not None
    if available:
        register_kernel("native", gemv_native)
    return available


register_if_available()
