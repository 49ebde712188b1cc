"""Compute kernels. Importing the package registers every GEMV and GEMM
tier; the CUDA kernels themselves are built only when a CUDA tensor first
reaches one."""

from .gemv import available_kernels, get_kernel, register_kernel
from .gemm_kernels import (
    available_gemm_kernels,
    gemm_kernel_name_for,
    get_gemm_kernel,
    register_gemm_kernel,
)
from . import cuda_gemm, cuda_gemv  # noqa: F401  (register "cuda")

__all__ = [
    "available_kernels", "get_kernel", "register_kernel",
    "available_gemm_kernels", "gemm_kernel_name_for", "get_gemm_kernel",
    "register_gemm_kernel",
]
