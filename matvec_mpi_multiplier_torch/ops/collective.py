"""Fused collective GEMV: colwise's ring matvec as ONE kernel.

The port's counterpart of the JAX package's ``ops/pallas_collective.py``.
The ring schedules of ``parallel/ring.py`` run the walk as a sequence of
GEMV tiles and hops; ``combine="pallas_ring"`` runs the whole p-step walk
inside one kernel instead: the hand-written CUDA ring GEMV
(``ops/cuda_ring.py``, ``csrc/ring_gemv.cu``), whose p ranks are the CTAs
of one thread block cluster on one card. The schedule keeps its JAX name
(``pallas_ring``): CSV labels, ExecKeys and the sweep's ``--combine`` spell
it so.

Semantics match ``parallel.ring.ring_matvec`` (device ``i`` ends holding
chunk ``i`` of ``y``, the accumulator dtype) and therefore
``psum_scatter(kernel(a_panel, x_seg))`` up to the order of summation.
The ring needs a single named mesh axis, and handles matvec only.
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..obs.annotations import named_span
from ..parallel.mesh import Mesh
from .cuda_ring import ring_gemv_cuda, ring_gemv_plain

__all__ = [
    "collective_ring_gemv", "pallas_ring_supported", "ring_gemv_plain",
]


def _resolve_ring_axis(axis_name) -> str:
    """The single mesh axis the ring runs over. A 1-tuple unwraps; a
    multi-axis flat tuple is rejected (no single-link neighbor ring exists
    over a flattened 2-D mesh)."""
    if isinstance(axis_name, str):
        return axis_name
    axes = tuple(axis_name)
    if len(axes) != 1:
        raise ValueError(
            "pallas_ring needs a single-axis (1-D) mesh for its neighbor "
            f"ring; got axes {axes!r} — use the XLA 'overlap'/'ring' "
            "schedules on multi-axis meshes"
        )
    return axes[0]


def collective_ring_gemv(
    panels: Sequence[torch.Tensor],
    x_segs: Sequence[torch.Tensor],
    mesh: Mesh,
    axes,
) -> list[torch.Tensor]:
    """Fused ring matvec over a single mesh axis. ``panels`` are the
    devices' ``(m, k/p)`` column panels, ``x_segs`` their ``(k/p,)`` x
    segments; device ``i`` gets chunk ``i`` of ``y`` (length ``m/p``,
    accumulator dtype). CUDA tensors go through the ring kernel, CPU
    tensors through its plain version. Matvec-only (one RHS column).
    """
    if x_segs[0].dim() != 1:
        raise ValueError(
            "pallas_ring is matvec-only (rank-1 x); use the XLA "
            f"'overlap'/'ring' schedules for batched RHS, got rank "
            f"{x_segs[0].dim()}"
        )
    axis = _resolve_ring_axis(axes)
    p = mesh.shape[axis]
    m = panels[0].shape[0]
    if m % p != 0:
        raise ValueError(f"collective_ring_gemv: {m} rows not divisible by {p}")
    with named_span(f"pallas_ring/ring_walk@p{p}"):
        return ring_gemv_cuda(panels, x_segs)


def pallas_ring_supported(mesh: Mesh) -> bool:
    """True when the mesh admits the fused kernel's neighbor ring: exactly
    one named axis."""
    return len(mesh.axis_names) == 1
