"""Compute kernels. Importing the package registers every GEMV, GEMM and
quantized-storage tier, the accuracy tiers (``compensated``, ``ozaki``,
``ozaki6``, ``ozaki_i8``) included; the CUDA kernels themselves are built
only when a CUDA tensor first reaches one. The host C++ tier ``native``
registers when its library has been built (``ops/native_gemv.py``)."""

from .gemv import available_kernels, get_kernel, register_kernel
from .gemm_kernels import (
    available_gemm_kernels,
    gemm_kernel_name_for,
    get_gemm_kernel,
    register_gemm_kernel,
)
from .quantize import get_storage_kernel, register_storage_kernel
from . import cuda_gemm, cuda_gemv, cuda_quant  # noqa: F401  (register "cuda")
from . import compensated, ozaki, ozaki_gemm  # noqa: F401  (the accuracy tiers)
# The host C++ tier: registered as "native" when its library is built
# (register_if_available(build=True) builds it; importing compiles nothing).
from . import native_gemm, native_gemv  # noqa: F401

__all__ = [
    "available_kernels", "get_kernel", "register_kernel",
    "available_gemm_kernels", "gemm_kernel_name_for", "get_gemm_kernel",
    "register_gemm_kernel", "get_storage_kernel", "register_storage_kernel",
]
