"""Local GEMV kernels: the per-device compute tier.

Reference analog: ``multiply_std_rowwise`` (``src/matr_utils.c:86-96``) and
the fused scale+partial-sum colwise kernel (``src/multiplier_colwise.c:105-129``).
The port's counterpart of the JAX package's ``ops/gemv.py``. Tiers:

* ``torch`` — a rank-2 ``torch.matmul``, the library tier (the ``xla`` tier's
  counterpart);
* ``torch_colwise`` — explicit scale-then-sum (``xla_colwise``'s);
* ``cuda`` — the hand-written kernel (``ops/cuda_gemv.py``; ``pallas``'s),
  registered when ``ops`` is imported and the default of every strategy;
* ``auto`` — the measured choice (``gemv_auto``): the tuning cache's winner
  for the local shape, ``torch`` or ``cuda`` on a given route, and the
  ``cuda`` tier's own plan on a miss.

All kernels share the signature ``gemv(a, x) -> y`` with ``a: (m, k)``,
``x: (k,)``, ``y: (m,)``, and return their *accumulator* dtype — fp32 for
bf16/fp16/fp32 inputs, fp64 for fp64 — not the storage dtype. The
strategies combine across devices on the accumulator and cast back to
storage only at the end.
"""

from __future__ import annotations

from typing import Callable, Protocol

import torch

_ACC = {
    torch.bfloat16: torch.float32,
    torch.float16: torch.float32,
    torch.float32: torch.float32,
    torch.float64: torch.float64,
}


class GemvKernel(Protocol):
    def __call__(self, a: torch.Tensor, x: torch.Tensor) -> torch.Tensor: ...


def acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """The accumulator (and output) dtype of every kernel for ``dtype`` input."""
    try:
        return _ACC[dtype]
    except KeyError:
        raise ValueError(
            f"gemv takes bf16, fp16, fp32 or fp64 operands, got {dtype}"
        ) from None


def gemv_torch(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Library GEMV: a rank-2 matmul against ``x`` as a (k, 1) column, on
    operands widened to the accumulator dtype (what ``preferred_element_type``
    does for the JAX package's ``gemv_xla``)."""
    acc = acc_dtype(a.dtype)
    return torch.matmul(a.to(acc), x.to(acc)[:, None])[:, 0]


def matmul_acc(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in the accumulator dtype without a widened copy of A: the
    library call of the engine's degradation floor (``engine/core.py``),
    registered as no tier. On the card a 16-bit A is read as it is and
    cuBLAS writes fp32 (``out_dtype``); the ``torch`` tier's widening would
    hold an fp32 copy of A, 17 GB for a 65536² bf16 A, for the life of
    every captured floor program. Elsewhere the operands are widened.
    ``b`` must have A's dtype (the engine's requests do)."""
    if b.dtype != a.dtype:
        raise ValueError(f"matmul_acc takes b in A's dtype {a.dtype}, got {b.dtype}")
    acc = acc_dtype(a.dtype)
    if a.is_cuda and a.dtype != acc:
        return torch.mm(a, b, out_dtype=acc)
    return torch.matmul(a.to(acc), b.to(acc))


def gemv_acc(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """:func:`matmul_acc` against ``x`` as a (k, 1) column."""
    return matmul_acc(a, x[:, None])[:, 0]


def gemv_colwise_torch(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Colwise-style local kernel: scale column ``j`` by ``x_j``, then sum
    each row (``multiply_colwise``, ``src/multiplier_colwise.c:107-122``)."""
    acc = acc_dtype(a.dtype)
    return (a.to(acc) * x.to(acc)[None, :]).sum(1)


def gemv_auto(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Measured selection (the JAX package's ``gemv_auto``): the tuning
    cache's decision for this LOCAL (m, k, dtype) on this platform
    (``tuning/``), which names a tier and, for ``cuda``, the route
    (:func:`resolve_gemv`). A miss, or a winner that is not registered,
    takes the static default, the ``cuda`` tier on ``gemv_plan``'s route,
    so ``kernel="auto"`` is never less informed than ``kernel="cuda"``."""
    from ..tuning import lookup_gemv
    from ..utils.convert import dtype_name

    decision = lookup_gemv(a.shape[0], a.shape[1], dtype_name(a.dtype))
    return resolve_gemv(decision)(a, x)


def resolve_gemv(decision: dict | None) -> GemvKernel:
    """The kernel a recorded GEMV decision names: ``{"kernel": "cuda",
    "route": r, "blocks_per_sm": b}`` the CUDA kernel forced onto that
    route (``cuda_gemv.gemv_route``, which raises ``ValueError`` for a route
    or grid the kernel lacks), ``{"kernel": name}`` a registered tier; None
    or an unknown name the ``cuda`` tier."""
    default = _KERNELS["cuda"]
    if decision is None:
        return default
    name = decision.get("kernel")
    if name == "cuda" and decision.get("route") is not None:
        from .cuda_gemv import BLOCKS_PER_SM, gemv_route

        return gemv_route(decision["route"],
                          decision.get("blocks_per_sm", BLOCKS_PER_SM))
    fn = _KERNELS.get(name)
    return default if fn is None or fn is gemv_auto else fn


_KERNELS: dict[str, GemvKernel] = {
    "torch": gemv_torch,
    "torch_colwise": gemv_colwise_torch,
    "auto": gemv_auto,
}


def register_kernel(name: str, fn: GemvKernel) -> None:
    _KERNELS[name] = fn


def get_kernel(name: str | Callable) -> GemvKernel:
    if callable(name):
        return name
    try:
        return _KERNELS[name]
    except KeyError:
        raise KeyError(
            f"unknown gemv kernel {name!r}; available: {sorted(_KERNELS)}"
        ) from None


def available_kernels() -> list[str]:
    return sorted(_KERNELS)
