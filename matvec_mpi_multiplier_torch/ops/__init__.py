"""Compute kernels. Importing the package registers every GEMV tier; the
CUDA kernel itself is built only when a CUDA tensor first reaches it."""

from .gemv import available_kernels, get_kernel, register_kernel
from . import cuda_gemv  # noqa: F401  (registers "cuda")

__all__ = ["available_kernels", "get_kernel", "register_kernel"]
