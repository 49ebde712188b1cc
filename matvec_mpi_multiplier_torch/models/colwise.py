"""Strategy P2 — colwise: 1-D contraction-dimension sharding.

Reference: ``src/multiplier_colwise.c``. Each rank owns ``n_cols/p`` columns
and the matching x segment, forms per-row partial sums
(``multiply_colwise``, ``:105-129``), and the partial vectors are summed to
the root with ``MPI_Reduce(MPI_SUM)`` (``:124``).

Port: A's columns and x over the flat mesh, a local partial GEMV per shard,
then one of the JAX package's **combine schedules**:

* ``"psum"`` — every shard gets the full y, summed in shard order (the
  ``MPI_Reduce`` analog; the plain-colwise default);
* ``"psum_scatter"`` — the same sum split by rows, y row-sharded (the
  scatter default);
* ``"ring"`` — explicit neighbor-ring reduce-scatter
  (``parallel.ring.ring_psum_scatter``: p−1 hops);
* ``"ring_overlap"`` — the GEMV rides the ring (``ring_matvec``): each step
  computes only the tile feeding the chunk its accumulator holds;
* ``"a2a"`` — one balanced all-to-all plus a local reduce;
* ``"overlap"`` — the staged pipeline
  (``parallel.ring.staged_overlap_scatter``): the local GEMV in S stages,
  each stage's chunked psum_scatter issued before the next stage's GEMV;
* ``"overlap_ring"`` — the same pipeline with each stage's combine as the
  neighbor-ring walk;
* ``"pallas_ring"`` — the whole ring walk inside one kernel: the
  hand-written CUDA ring GEMV (``ops/collective.py``), whose ranks are the
  CTAs of one thread block cluster. Matvec-only, single-axis meshes only.
  The name is the JAX package's, kept for CSV labels and the CLIs.

On one card every "collective" is a device-local add or copy, so nothing
overlaps: each schedule costs what its program does, extra launches
included. The registry names ``colwise_ring`` / ``colwise_ring_overlap`` /
``colwise_a2a`` / ``colwise_overlap`` are thin bindings of these schedules;
``ColwiseStrategy(combine=...)`` is the single implementation, and
``combine="auto"`` is the JAX package's tuning-cache miss (the static
default for the output form).

Constraint preserved: ``n_cols % p == 0`` (``src/multiplier_colwise.c:151-154``,
message fixed per quirk Q2). The scatter-family schedules additionally
require ``n_rows % p == 0``.
"""

from __future__ import annotations

import os
from typing import Callable

from .base import Body, MatvecStrategy
from ..obs.annotations import named_span
from ..parallel.mesh import Mesh, psum, psum_scatter
from ..utils.errors import ShardingError, check_divisible

# Schedules whose output is row-sharded (the scatter family). "psum" is the
# only replicated-output schedule. "overlap" / "overlap_ring" are the two
# step flavors of the staged pipeline.
SCATTER_COMBINES = (
    "psum_scatter", "ring", "ring_overlap", "a2a", "overlap",
    "overlap_ring", "pallas_ring",
)
COLWISE_COMBINES = ("psum",) + SCATTER_COMBINES
# The staged-pipeline pair: both thread the stage count S.
OVERLAP_COMBINES = ("overlap", "overlap_ring")


class ColwiseStrategy(MatvecStrategy):
    name = "colwise"

    def __init__(
        self,
        scatter_output: bool = False,
        combine: str | None = None,
        stages: int | str | None = None,
    ):
        # scatter_output=True selects the scatter family: y comes out
        # row-sharded (requires n_rows % p == 0 as well). ``combine`` names
        # the schedule directly (COLWISE_COMBINES) or asks for "auto"; None
        # keeps the static default for the output form. ``stages`` pins the
        # overlap schedules' stage count (MatvecStrategy.resolve_stages).
        if combine == "auto":
            self.requested_combine = "auto"
            combine = None
        elif combine is not None and combine not in COLWISE_COMBINES:
            raise ValueError(
                f"combine must be one of {COLWISE_COMBINES} or 'auto'; "
                f"got {combine!r}"
            )
        if combine is None:
            combine = "psum_scatter" if scatter_output else "psum"
        self.combine = combine
        self.stages = stages
        self.scatter_output = combine in SCATTER_COMBINES

    def with_combine(
        self, combine: str, *, stages: int | str | None = None
    ) -> "ColwiseStrategy":
        bound = ColwiseStrategy(
            combine=combine,
            stages=stages if stages is not None else self.stages,
        )
        bound.name = self.name  # keep the registry/CSV label stable
        return bound

    def combine_candidates(self, mesh: Mesh) -> tuple[str, ...]:
        # pallas_ring only where it runs as a kernel: a single-axis mesh of
        # CUDA devices, or with MATVEC_TUNE_PALLAS=1 (its plain version on
        # CPU meshes), the JAX package's tile-ladder gating rule.
        from ..ops.collective import pallas_ring_supported

        on_card = any(d.type == "cuda" for d in mesh.devices)
        if pallas_ring_supported(mesh) and (
            on_card or os.environ.get("MATVEC_TUNE_PALLAS") == "1"
        ):
            return COLWISE_COMBINES
        return tuple(c for c in COLWISE_COMBINES if c != "pallas_ring")

    def combine_candidates_batched(self, mesh: Mesh) -> tuple[str, ...]:
        # The fused ring kernel is rank-1 only; everything else batches.
        return tuple(
            c for c in self.combine_candidates(mesh) if c != "pallas_ring"
        )

    def supports_combine_batched(self, combine: str | None) -> bool:
        if combine == "pallas_ring":
            return False
        return super().supports_combine_batched(combine)

    def build(self, mesh: Mesh, *, combine=None, stages=None, **kwargs):
        # An explicit ``stages`` must reach the body even when the overlap
        # combine comes from THIS instance's binding (colwise_overlap,
        # ColwiseStrategy(combine=...)) rather than the ``combine=``
        # argument: rebind the instance's own combine so the base machinery
        # threads stages through with_combine.
        if combine is None and stages is not None \
                and self.requested_combine is None:
            combine = self.combine
        return super().build(mesh, combine=combine, stages=stages, **kwargs)

    def build_batched(self, mesh: Mesh, *, combine=None, stages=None,
                      **kwargs):
        if combine is None and stages is not None \
                and self.requested_combine is None:
            combine = self.combine
        return super().build_batched(
            mesh, combine=combine, stages=stages, **kwargs
        )

    def default_combine(self, mesh: Mesh) -> str:
        # The static default for this instance's output form.
        return self.combine

    def specs(self, mesh: Mesh) -> tuple[tuple, tuple, tuple]:
        axes = mesh.axis_names
        spec_y = (axes,) if self.scatter_output else ()
        return (None, axes), (axes,), spec_y

    def local_body(self, mesh: Mesh, kernel: Callable) -> Body:
        from ..ops.collective import collective_ring_gemv
        from ..parallel.ring import (
            a2a_psum_scatter,
            ring_matvec,
            ring_psum_scatter,
            staged_overlap_scatter,
        )

        axes = mesh.axis_names
        combine = self.combine
        p = mesh.size

        def body(a_panels, x_segs):
            # Full-length partial y from each shard's column panel, combined
            # across shards by the selected schedule on the accumulator
            # dtype, cast back afterwards. Schedules that fuse compute INTO
            # the combine (overlap, ring_overlap, pallas_ring) carry one
            # combine span; the staged pipeline adds per-stage names.
            if combine in OVERLAP_COMBINES:
                s = self.resolve_stages(
                    a_panels[0].shape[0], x_segs[0].shape[0] * p, mesh,
                    self.stages, p, a_panels[0].dtype,
                )
                with named_span(f"colwise/combine/{combine}"):
                    ys = staged_overlap_scatter(
                        a_panels, x_segs, mesh, axes, kernel, s,
                        step="ring" if combine == "overlap_ring"
                        else "psum_scatter",
                    )
            elif combine == "pallas_ring":
                with named_span("colwise/combine/pallas_ring"):
                    ys = collective_ring_gemv(a_panels, x_segs, mesh, axes)
            elif combine == "ring_overlap":
                with named_span("colwise/combine/ring_overlap"):
                    ys = ring_matvec(a_panels, x_segs, mesh, axes, kernel)
            else:
                with named_span("colwise/local_gemv"):
                    partials = [kernel(a, x) for a, x in zip(a_panels, x_segs)]
                with named_span(f"colwise/combine/{combine}"):
                    if combine == "ring":
                        ys = ring_psum_scatter(partials, mesh, axes)
                    elif combine == "a2a":
                        ys = a2a_psum_scatter(partials, mesh, axes)
                    elif combine == "psum_scatter":
                        ys = psum_scatter(partials, mesh, axes)
                    else:  # "psum"
                        ys = psum(partials, mesh, axes)
            return [y.to(a_panels[0].dtype) for y in ys]

        return body

    def validate(self, n_rows: int, n_cols: int, mesh: Mesh) -> None:
        p = mesh.size
        check_divisible(n_cols, p, "n_cols", "number of devices")
        if self.scatter_output:
            check_divisible(n_rows, p, "n_rows", "number of devices")
        if self.combine == "pallas_ring" and len(mesh.axis_names) != 1:
            # A ShardingError (not the kernel's ValueError) so sweep and
            # engine callers skip or fail fast at the validate layer.
            raise ShardingError(
                "combine='pallas_ring' needs a single-axis (1-D) mesh for "
                f"its neighbor ring; got axes {mesh.axis_names} — use the "
                "XLA 'overlap'/'ring' schedules on multi-axis meshes"
            )


class ColwiseRingStrategy(ColwiseStrategy):
    """Colwise with the combine bound to the explicit neighbor-ring
    reduce-scatter (``combine="ring"``). Output is always row-sharded.
    ``overlap=True`` binds ``"ring_overlap"``: the GEMV rides the ring
    (``parallel.ring.ring_matvec``)."""

    name = "colwise_ring"

    def __init__(self, overlap: bool = False):
        super().__init__(combine="ring_overlap" if overlap else "ring")


class ColwiseRingOverlapStrategy(ColwiseRingStrategy):
    """The overlapped ring schedule as a named registry entry."""

    name = "colwise_ring_overlap"

    def __init__(self):
        super().__init__(overlap=True)


class ColwiseAllToAllStrategy(ColwiseStrategy):
    """Colwise with the combine bound to the balanced all-to-all + local
    reduce schedule (``combine="a2a"``). Output is always row-sharded;
    matches ``psum_scatter`` up to reduction order."""

    name = "colwise_a2a"

    def __init__(self):
        super().__init__(combine="a2a")


class ColwiseOverlapStrategy(ColwiseStrategy):
    """Colwise with the combine bound to the staged pipeline
    (``combine="overlap"``). Output is always row-sharded. ``stages`` pins
    S; the default is the cache miss, ``DEFAULT_OVERLAP_STAGES``."""

    name = "colwise_overlap"

    def __init__(self, stages: int | str | None = None):
        super().__init__(combine="overlap", stages=stages)
