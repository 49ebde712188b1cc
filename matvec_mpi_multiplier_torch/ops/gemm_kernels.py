"""Local GEMM kernels: the per-device matmul tier.

The port's counterpart of the JAX package's ``ops/gemm_kernels.py``: the
kernel-registry pattern of ``ops/gemv.py`` extended to a rank-2 right-hand
side. Tiers:

* ``torch`` — ``torch.matmul`` on operands widened to the accumulator (the
  ``xla`` tier's counterpart: ``preferred_element_type``);
* ``cuda`` — the hand-written kernel (``ops/cuda_gemm.py``; ``pallas``'s),
  registered when ``ops`` is imported;
* ``auto`` — the measured choice (``gemm_auto``): the tuning cache's winner
  for the local shape, ``torch`` or ``cuda`` on given tiles, and the
  ``cuda`` tier's own plan on a miss;
* ``ozaki`` / ``ozaki6`` — the int8 split-matrix accuracy tiers
  (``ops/ozaki_gemm.py``), registered when ``ops`` is imported.

All kernels share the signature ``matmul(a, b) -> c`` with ``a: (m, k)``,
``b: (k, n)``, ``c: (m, n)`` and the GEMV tier's accumulator contract: they
return the *accumulator* dtype (fp32 for bf16/fp16/fp32, fp64 for fp64).
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


def gemm_auto(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Measured selection for the GEMM (the JAX package's ``matmul_auto``):
    the tuning cache's decision for this LOCAL (m, k, n, dtype)
    (:func:`resolve_gemm`), the ``cuda`` tier's default plan on a miss or an
    unregistered winner."""
    from ..tuning import lookup_gemm
    from ..utils.convert import dtype_name

    decision = lookup_gemm(a.shape[0], a.shape[1], b.shape[1], dtype_name(a.dtype))
    return resolve_gemm(decision)(a, b)


def resolve_gemm(decision: dict | None) -> GemmKernel:
    """The kernel a recorded GEMM decision names: ``{"kernel": "cuda",
    "route": r, "bn": w, "stages": s}`` the CUDA kernel on those tiles
    (``cuda_gemm.gemm_with_tiles``), ``{"kernel": name}`` a registered
    tier; None or an unknown name the ``cuda`` tier."""
    default = _GEMM_KERNELS["cuda"]
    if decision is None:
        return default
    name = decision.get("kernel")
    if name == "cuda" and decision.get("bn") is not None:
        from .cuda_gemm import gemm_with_tiles

        return gemm_with_tiles(decision["route"], int(decision["bn"]),
                               int(decision["stages"]))
    fn = _GEMM_KERNELS.get(name)
    return default if fn is None or fn is gemm_auto else fn


_GEMM_KERNELS: dict[str, GemmKernel] = {"torch": gemm_torch, "auto": gemm_auto}


def register_gemm_kernel(name: str, fn: GemmKernel) -> None:
    _GEMM_KERNELS[name] = fn


# GEMV tier names with no literal GEMM registry entry, mapped to the tier
# that implements the same choice for a rank-2 right-hand side: the
# scale-then-sum formulation has no rank-2 face, so its promotion IS the
# plain matmul (the JAX package maps xla_colwise -> xla the same way).
_GEMV_NAME_ALIASES = {"torch_colwise": "torch"}


def gemm_kernel_name_for(name: str) -> str:
    """The GEMM registry name implementing a (possibly GEMV-tier) kernel
    name for a rank-2 right-hand side. A registered GEMV tier with no GEMM
    face (``compensated``, ``ozaki_i8``) promotes to the library tier
    ``torch``, as the JAX package's go to ``xla``: a batched promotion is
    never less available than the matvec path it replaces. A name unknown
    to both registries passes through, so :func:`get_gemm_kernel` raises
    its ``KeyError``."""
    name = _GEMV_NAME_ALIASES.get(name, name)
    if name in _GEMM_KERNELS:
        return name
    from .gemv import available_kernels

    return "torch" if name in available_kernels() else name


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
