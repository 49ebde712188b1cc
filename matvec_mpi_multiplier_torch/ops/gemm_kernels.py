"""Local GEMM kernels: the per-device matmul tier.

The port's counterpart of the JAX package's ``ops/gemm_kernels.py``: the
kernel-registry pattern of ``ops/gemv.py`` extended to a rank-2 right-hand
side. Tiers:

* ``torch`` — ``torch.matmul`` on operands widened to the accumulator (the
  ``xla`` tier's counterpart: ``preferred_element_type``);
* ``cuda`` — the hand-written kernel (``ops/cuda_gemm.py``; ``pallas``'s),
  registered when ``ops`` is imported.

All kernels share the signature ``matmul(a, b) -> c`` with ``a: (m, k)``,
``b: (k, n)``, ``c: (m, n)`` and the GEMV tier's accumulator contract: they
return the *accumulator* dtype (fp32 for bf16/fp16/fp32, fp64 for fp64).
The tuned ``auto`` tier waits for the tuning slice (ROADMAP.md).
"""

from __future__ import annotations

from typing import Callable, Protocol

import torch

from .gemv import acc_dtype


class GemmKernel(Protocol):
    def __call__(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor: ...


def gemm_torch(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Library matmul on operands widened to the accumulator dtype."""
    acc = acc_dtype(a.dtype)
    return torch.matmul(a.to(acc), b.to(acc))


_GEMM_KERNELS: dict[str, GemmKernel] = {"torch": gemm_torch}


def register_gemm_kernel(name: str, fn: GemmKernel) -> None:
    _GEMM_KERNELS[name] = fn


# GEMV tier names with no literal GEMM registry entry, mapped to the tier
# that implements the same choice for a rank-2 right-hand side: the
# scale-then-sum formulation has no rank-2 face, so its promotion IS the
# plain matmul (the JAX package maps xla_colwise -> xla the same way).
_GEMV_NAME_ALIASES = {"torch_colwise": "torch"}


def gemm_kernel_name_for(name: str) -> str:
    """The GEMM registry name implementing a (possibly GEMV-tier) kernel
    name for a rank-2 right-hand side. Every GEMV tier of the port has a
    GEMM face, so only the alias above maps; any other name passes through
    and an unknown one raises ``KeyError`` in :func:`get_gemm_kernel`."""
    return _GEMV_NAME_ALIASES.get(name, name)


def get_gemm_kernel(name: str | Callable) -> GemmKernel:
    if callable(name):
        return name
    try:
        return _GEMM_KERNELS[name]
    except KeyError:
        raise KeyError(
            f"unknown gemm kernel {name!r}; available: {sorted(_GEMM_KERNELS)}"
        ) from None


def available_gemm_kernels() -> list[str]:
    return sorted(_GEMM_KERNELS)
