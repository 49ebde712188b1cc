"""The hand-written CUDA ring GEMV (``csrc/ring_gemv.cu``) and its plain version.

Replaces the JAX package's Pallas kernel
(``matvec_mpi_multiplier_tpu/ops/pallas_collective.py::_ring_gemv_kernel``):
the p-step ring reduce-scatter matvec of colwise's ``combine="pallas_ring"``
in one kernel. The p logical ranks are the CTAs of one thread block cluster
on one card, each hop a store into the right neighbour's shared memory; the
source describes the design. It moves the bytes of one GEMV of the whole A.

:func:`ring_gemv_cuda` launches the kernel for CUDA tensors, or raises: a
missing ``nvcc``, a failed build, a refused launch or panels on more than
one card is an error, never a quiet switch to another schedule. For tensors
on the CPU, and only there, it computes :func:`ring_gemv_plain`.
``ring_gemv_cuda.launches`` counts the kernel's launches (nothing else adds
to it).
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from ..utils.errors import ShardingError
from . import _build
from .graphs import refuse_predicate
from .cuda_gemv import _DTYPE_CODES, gemv_plain
from .gemv import acc_dtype

# Ranks of one ring: a thread block cluster holds at most 16 CTAs (8
# portably; the kernel asks for the non-portable size above 8).
MAX_RING_RANKS = 16


def ring_gemv_plain(
    panels: Sequence[torch.Tensor], x_segs: Sequence[torch.Tensor]
) -> list[torch.Tensor]:
    """The ``_ring_gemv_kernel`` walk in plain PyTorch: rank d's tile for
    chunk c is ``(a_tile.to(acc) * x.to(acc)).sum(1)`` over rows
    ``[c·m/p, (c+1)·m/p)`` of its panel, and chunk d is summed in the ring's
    order, ``((t_{d+1} + t_{d+2}) + ...) + t_d``. ``p == 1`` is the plain
    tile of the whole panel."""
    p = len(panels)
    rows = panels[0].shape[0] // p

    def tile(d: int, c: int) -> torch.Tensor:
        return gemv_plain(panels[d][c * rows:(c + 1) * rows], x_segs[d])

    acc = [tile(d, (d - 1) % p) for d in range(p)]
    for s in range(1, p):
        acc = [acc[(d - 1) % p] for d in range(p)]  # one hop to the right
        acc = [v + tile(d, (d - 1 - s) % p) for d, v in enumerate(acc)]
    return acc


def _check(panels: Sequence[torch.Tensor], x_segs: Sequence[torch.Tensor]) -> None:
    p = len(panels)
    if p < 1 or len(x_segs) != p:
        raise ValueError(
            f"ring gemv needs one x segment per panel, got {p} panels and "
            f"{len(x_segs)} segments"
        )
    if p > MAX_RING_RANKS:
        raise ShardingError(
            f"the ring gemv runs its {p} ranks as one thread block cluster, "
            f"which holds at most {MAX_RING_RANKS} CTAs (8 portably); use the "
            "'ring' or 'overlap' schedules on larger meshes"
        )
    a0 = panels[0]
    if a0.dim() != 2:
        raise ValueError(f"ring gemv needs (m, k/p) panels, got {tuple(a0.shape)}")
    if a0.dtype not in _DTYPE_CODES:
        raise ValueError(f"ring gemv takes bf16/fp16/fp32/fp64 panels, got {a0.dtype}")
    for a, x in zip(panels, x_segs):
        if a.shape != a0.shape or x.dim() != 1 or x.shape[0] != a0.shape[1]:
            raise ValueError(
                f"ring gemv needs (m, k/p) panels of one shape and (k/p,) "
                f"segments, got {tuple(a.shape)} and {tuple(x.shape)}"
            )
        if a.dtype != a0.dtype or x.dtype != a0.dtype:
            raise ValueError(
                f"ring gemv needs panels and segments of one dtype, got "
                f"{a.dtype} and {x.dtype}"
            )
        if a.device != a0.device or x.device != a0.device:
            raise ValueError(
                f"ring gemv runs its ranks on one device, got {a.device} and "
                f"{x.device} beside {a0.device}: a ring across cards needs "
                "peer memory, not ported yet"
            )
        if not (a.is_contiguous() and x.is_contiguous()):
            raise ValueError("ring gemv needs contiguous panels and segments")
    if a0.shape[0] % p:
        raise ValueError(f"collective_ring_gemv: {a0.shape[0]} rows not divisible by {p}")


def ring_gemv_cuda(
    panels: Sequence[torch.Tensor], x_segs: Sequence[torch.Tensor]
) -> list[torch.Tensor]:
    """Chunk d of ``y`` for every rank d, by the CUDA kernel (the plain
    version for CPU tensors)."""
    _check(panels, x_segs)
    a0 = panels[0]
    if a0.device.type == "cpu":
        return ring_gemv_plain(panels, x_segs)
    if a0.device.type != "cuda":
        raise ValueError(f"ring_gemv_cuda runs on CUDA or CPU tensors, got {a0.device}")
    refuse_predicate("ring_gemv_cuda")
    lib = _build.load_library()
    p = len(panels)
    m, k = a0.shape
    y = torch.empty((p, m // p), dtype=acc_dtype(a0.dtype), device=a0.device)
    outs = list(y.unbind(0))

    def pointers(ts):
        return (ctypes.c_void_p * p)(*(t.data_ptr() for t in ts))

    with torch.cuda.device(a0.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.matvec_ring_gemv(
            _DTYPE_CODES[a0.dtype], p, pointers(panels), pointers(x_segs),
            pointers(outs), m, k, stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"ring gemv kernel launch failed for {p} panels {tuple(a0.shape)} "
            f"{a0.dtype}: {lib.matvec_error_string(rc).decode()} (cudaError {rc})"
        )
    ring_gemv_cuda.launches += 1
    return outs


ring_gemv_cuda.launches = 0  # type: ignore[attr-defined]
