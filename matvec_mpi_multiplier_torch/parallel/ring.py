"""Ring collectives over mesh axes: explicit neighbor-ring reduce-scatter.

The port's counterpart of the JAX package's ``parallel/ring.py``. The
reference's colwise strategy reduces full-length partial vectors through
the root in one blocking ``MPI_Reduce(MPI_SUM)``
(``src/multiplier_colwise.c:124``). This module gives the explicit ring
formulation beside ``parallel.mesh.psum_scatter``: p−1 ``ppermute`` hops
around the ring of each group of devices, each hop moving one accumulated
chunk to the right neighbor while the local chunk is added; the balanced
all-to-all (:func:`a2a_psum_scatter`); the ring all-gather; and the staged
``overlap`` pipelines.

Every function takes and returns per-shard lists in flat mesh order, as the
strategies' ``local_body`` bodies do, with the mesh and the axes the ring
runs over (a name or a tuple of names, taken together row-major). On one
card every shard lies on the same device, so a hop is a list rotation and a
"collective" is a device-local add or copy; the program order (and so each
chunk's order of summation) is the JAX package's. Nothing here overlaps
compute with communication on one card: that waits for multi-card meshes.

Order of summation: after step s the accumulator of ring index ``idx``
holds chunk ``idx-1-s``, so chunk c is summed as
``((t_{c+1} + t_{c+2}) + ...) + t_c`` — not ``psum_scatter``'s ``t_0 + ... +
t_{p-1}``. Results agree with it to the rounding of that reordering.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from ..obs.annotations import named_span
from .mesh import (
    Mesh,
    _axes,
    _axes_size,
    _reduce_groups,
    all_to_all,
    ppermute,
    psum,
    psum_scatter,
)

Blocks = Sequence[torch.Tensor]


def _ring_perm(p: int) -> list[tuple[int, int]]:
    """Right-neighbor ring permutation on a size-p axis."""
    return [(i, (i + 1) % p) for i in range(p)]


def _ring_index(mesh: Mesh, axes: tuple[str, ...]) -> list[int]:
    """Each device's index along ``axes`` (its place in its ring)."""
    index = [0] * mesh.size
    for members in _reduce_groups(mesh, axes):
        for i, f in members:
            index[f] = i
    return index


def _ring_reduce(chunk_fn: Callable[[int, int], torch.Tensor], mesh: Mesh,
                 axes) -> list[torch.Tensor]:
    """The shared ring-reduce walk: after step ``s`` the accumulator holds
    the partial sum for chunk ``idx - 1 - s``, so after ``p - 1`` hops device
    ``idx`` ends holding chunk ``idx`` summed across the whole ring.

    ``chunk_fn(f, i)`` produces device ``f``'s contribution to logical chunk
    ``i mod p``. Callers handle ``p == 1`` themselves.
    """
    axes = _axes(axes)
    p = _axes_size(mesh, axes)
    idx = _ring_index(mesh, axes)
    perm = _ring_perm(p)
    acc = [chunk_fn(f, (idx[f] - 1) % p) for f in range(mesh.size)]
    for s in range(1, p):
        acc = ppermute(acc, mesh, axes, perm)
        acc = [a + chunk_fn(f, (idx[f] - 1 - s) % p) for f, a in enumerate(acc)]
    return acc


def ring_psum_scatter(blocks: Blocks, mesh: Mesh, axes) -> list[torch.Tensor]:
    """Ring reduce-scatter over ``axes``, chunking along dim 0.

    Each device contributes a full partial (any rank: a length-n vector for
    matvec, an (m, n) partial C for GEMM); device ``i`` returns chunk ``i``
    of the elementwise sum (leading dim ``shape[0] // p``), the contract of
    ``psum_scatter``. Requires ``shape[0] % p == 0``.
    """
    p = _axes_size(mesh, _axes(axes))
    if p == 1:
        return list(blocks)
    n = blocks[0].shape[0]
    if n % p != 0:
        raise ValueError(f"ring_psum_scatter: length {n} not divisible by {p}")
    rows = n // p
    return _ring_reduce(lambda f, i: blocks[f][i * rows:(i + 1) * rows], mesh, axes)


def ring_matvec(a_panels: Blocks, x_segs: Blocks, mesh: Mesh, axes,
                kernel: Callable) -> list[torch.Tensor]:
    """Overlapped ring matvec: compute rides the ring with the accumulator.

    Where :func:`ring_psum_scatter` first forms the full-length local
    partial and then reduces it around the ring, this never forms it: at
    each of the p steps a device computes only the ``(m/p, k/p)`` tile of
    its column panel feeding the chunk its accumulator holds (a contiguous
    row range: no copy of A). Device ``i`` returns chunk ``i`` of ``y``
    (length ``m/p``, the kernel's accumulator dtype), the contract of
    ``ring_psum_scatter(kernel(a_panel, x_seg), ...)``. Requires
    ``m % p == 0``.
    """
    p = _axes_size(mesh, _axes(axes))
    if p == 1:
        return [kernel(a, x) for a, x in zip(a_panels, x_segs)]
    m = a_panels[0].shape[0]
    if m % p != 0:
        raise ValueError(f"ring_matvec: {m} rows not divisible by {p}")
    rows = m // p

    def tile_gemv(f, i):
        # Rows of this panel contributing to output chunk i.
        return kernel(a_panels[f][i * rows:(i + 1) * rows], x_segs[f])

    return _ring_reduce(tile_gemv, mesh, axes)


def ring_matmul(a_panels: Blocks, b_segs: Blocks, mesh: Mesh, axes,
                kernel: Callable) -> list[torch.Tensor]:
    """Overlapped ring matmul: :func:`ring_matvec` with a rank-2 RHS (the
    walk is rank-agnostic; device ``i`` returns rows ``i`` of C)."""
    return ring_matvec(a_panels, b_segs, mesh, axes, kernel)


def a2a_psum_scatter(blocks: Blocks, mesh: Mesh, axes) -> list[torch.Tensor]:
    """Reduce-scatter as ONE balanced all-to-all plus a local reduce (the
    Ulysses-style schedule): each device splits its full partial into p
    leading chunks, chunk j goes to device j, and the sum over the p
    received contributions (in ring-index order of the senders) yields
    this device's chunk. Same contract and constraint as
    :func:`ring_psum_scatter`."""
    p = _axes_size(mesh, _axes(axes))
    if p == 1:
        return list(blocks)
    n = blocks[0].shape[0]
    if n % p != 0:
        raise ValueError(f"a2a_psum_scatter: length {n} not divisible by {p}")
    recv = all_to_all(blocks, mesh, axes)
    return [r.reshape(p, n // p, *r.shape[1:]).sum(0) for r in recv]


def ring_all_gather(blocks: Blocks, mesh: Mesh, axes) -> list[torch.Tensor]:
    """Ring all-gather: each device's chunk circulates p−1 hops; every
    device ends with the axis-ordered concatenation (the contract of
    ``lax.all_gather(..., tiled=True)``). Rank-agnostic. Each device writes
    the pieces into one preallocated output as they arrive.
    """
    axes = _axes(axes)
    p = _axes_size(mesh, axes)
    if p == 1:
        return list(blocks)
    idx = _ring_index(mesh, axes)
    perm = _ring_perm(p)
    n = blocks[0].shape[0]
    out = [torch.empty((p * n, *b.shape[1:]), dtype=b.dtype, device=b.device)
           for b in blocks]
    piece = list(blocks)
    # After s hops, `piece` is the chunk first owned by ring index idx - s.
    for s in range(p):
        if s:
            piece = ppermute(piece, mesh, axes, perm)
        for f, (o, v) in enumerate(zip(out, piece)):
            j = (idx[f] - s) % p
            o[j * n:(j + 1) * n] = v
    return out


# --------------------------------------------------------------- overlap
#
# The staged `overlap` family: split the local GEMV into S stages and issue
# stage s's combine (a chunked psum_scatter, a ring walk, or a chunked ring
# gather) before stage s+1's compute, the JAX package's program order. Stage
# s covers sub-chunk s of EVERY device chunk, so each stage's combine moves
# 1/S of the bytes, and concatenating the S per-stage results reassembles
# each device's contiguous chunk. A stage's GEMV runs as one kernel call per
# contiguous (m/(p·S), k/p) cell of the panel: its rows are not contiguous
# as a whole, and the port never copies A to make them so.


def stage_ladder(m: int, p: int, ladder=(8, 4, 2, 1)) -> list[int]:
    """Stage counts from ``ladder`` that evenly divide the per-device chunk
    ``m // p`` (largest first; ``1`` always qualifies when ``m % p == 0``).
    Dispatch clamps a requested S down to the first valid entry."""
    if m % p != 0:
        return []
    chunk = m // p
    return [s for s in sorted(set(ladder), reverse=True) if chunk % s == 0]


def _pipeline_stages(compute: Callable[[int], list],
                     combine: Callable[[list], list], stages: int) -> list:
    """The software pipeline shared by the staged schedules: stage s's
    combine is issued before stage s+1's compute. Returns the S combined
    per-shard lists in stage order. Each half carries its named span
    (``stage{s}/compute`` / ``stage{s}/combine``)."""

    def _compute(s):
        with named_span(f"stage{s}/compute"):
            return compute(s)

    def _combine(s, v):
        with named_span(f"stage{s}/combine"):
            return combine(v)

    pieces = []
    prev = _compute(0)
    for s in range(1, stages):
        in_flight = _combine(s - 1, prev)  # stage s-1's combine, issued...
        prev = _compute(s)                 # ...before stage s's GEMV
        pieces.append(in_flight)
    pieces.append(_combine(stages - 1, prev))
    return pieces


def _concat_stages(pieces: list) -> list[torch.Tensor]:
    """Per shard, the S stage results one after another along dim 0."""
    return [torch.cat(parts) for parts in zip(*pieces)]


def staged_overlap_scatter(
    a_panels: Blocks,
    x_segs: Blocks,
    mesh: Mesh,
    axes,
    kernel: Callable,
    stages: int,
    step: str = "psum_scatter",
) -> list[torch.Tensor]:
    """Pipelined colwise combine: S-stage local GEMV, each stage's chunked
    reduce-scatter issued before the next stage's compute.

    ``a_panels`` are the devices' ``(m, k/p)`` column panels, ``x_segs``
    their x segments (rank-1 vectors or rank-2 ``(k/p, b)`` blocks); device
    ``i`` returns chunk ``i`` of the combined result (leading dim ``m/p``,
    the kernel's accumulator dtype), the contract of
    ``ring_psum_scatter(kernel(a_panel, x_seg), ...)``. ``step`` picks the
    per-stage combine: ``"psum_scatter"`` (one chunked ``psum_scatter``) or
    ``"ring"`` (the neighbor-ring walk, :func:`ring_psum_scatter`).

    Stage s computes rows ``i·(m/p) + s·(m/(p·S)) ...`` for every device
    chunk i, one kernel call per chunk on its contiguous cell, outputs
    concatenated device-major. Requires ``m % (p·S) == 0``.
    """
    axes = _axes(axes)
    p = _axes_size(mesh, axes)
    if stages < 1:
        raise ValueError(f"staged_overlap_scatter: stages must be >= 1, got {stages}")
    if step not in ("psum_scatter", "ring"):
        raise ValueError(
            f"staged_overlap_scatter: unknown step {step!r} "
            "(expected 'psum_scatter' or 'ring')"
        )
    m = a_panels[0].shape[0]
    if p == 1:
        # Degenerate ring: no combine exists; stage the compute anyway so
        # S>1 runs the same staged program shape it does on p>1.
        if m % stages != 0:
            raise ValueError(
                f"staged_overlap_scatter: {m} rows not divisible by "
                f"stages={stages}"
            )
        sub = m // stages
        pieces = _pipeline_stages(
            lambda s: [kernel(a[s * sub:(s + 1) * sub], x)
                       for a, x in zip(a_panels, x_segs)],
            lambda v: v, stages,
        )
        return _concat_stages(pieces)
    if m % (p * stages) != 0:
        raise ValueError(
            f"staged_overlap_scatter: {m} rows not divisible by "
            f"p*stages={p}*{stages}"
        )
    sub = m // (p * stages)  # rows per (device chunk, stage) cell
    chunk = m // p

    def compute(s):
        # Stage s's slab: sub-chunk s of every device chunk, device-major.
        return [
            torch.cat([kernel(a[i * chunk + s * sub:i * chunk + (s + 1) * sub], x)
                       for i in range(p)])
            for a, x in zip(a_panels, x_segs)
        ]

    if step == "ring":
        combine = lambda v: ring_psum_scatter(v, mesh, axes)  # noqa: E731
    else:
        combine = lambda v: psum_scatter(v, mesh, axes)  # noqa: E731  # overlap-ok: chunked (each stage's slab is m/S rows of the partial)
    return _concat_stages(_pipeline_stages(compute, combine, stages))


def staged_overlap_gather(
    a_blks: Blocks,
    x_locs: Blocks,
    mesh: Mesh,
    gather_axes,
    kernel: Callable,
    stages: int,
    reduce_axes=None,
) -> list[torch.Tensor]:
    """Pipelined output gather for the sharded-output strategies: S-stage
    local GEMV, each stage's chunked ring all-gather (and, for blockwise,
    its chunked psum over ``reduce_axes``) issued before the next stage's
    compute.

    ``a_blks`` are the devices' local row blocks ``(m_loc, k_loc)``,
    ``x_locs`` their local right-hand sides; every device returns the FULL
    result (``(m,)`` / ``(m, b)``, accumulator dtype), the value of
    gathering ``kernel(a_blk, x_loc)`` over ``gather_axes``. Requires
    ``m_loc % S == 0``.
    """
    if stages < 1:
        raise ValueError(f"staged_overlap_gather: stages must be >= 1, got {stages}")
    m_loc = a_blks[0].shape[0]
    if m_loc % stages != 0:
        raise ValueError(
            f"staged_overlap_gather: {m_loc} local rows not divisible by "
            f"stages={stages}"
        )
    sub = m_loc // stages
    p = _axes_size(mesh, _axes(gather_axes))

    def compute(s):
        parts = [kernel(a[s * sub:(s + 1) * sub], x) for a, x in zip(a_blks, x_locs)]
        if reduce_axes is not None:
            # Chunked reduce-over-grid-columns: m_loc/S rows per psum.
            parts = psum(parts, mesh, reduce_axes)  # overlap-ok: chunked (m_loc/S rows per stage)
        return parts

    pieces = _pipeline_stages(
        compute, lambda v: ring_all_gather(v, mesh, gather_axes), stages
    )
    if stages == 1:
        return pieces[0]
    # Each gathered piece is (p·sub, ...) device-major for ONE stage:
    # stage-major (S, p, sub, ...) -> device-major (p, S, sub, ...).
    out = []
    for parts in zip(*pieces):
        tail = parts[0].shape[1:]
        stacked = torch.stack(parts).reshape(stages, p, sub, *tail)
        out.append(stacked.transpose(0, 1).reshape(p * stages * sub, *tail))
    return out
