"""Strategy P1 — rowwise: 1-D output-dimension sharding.

Reference: ``src/multiplier_rowwise.c``. Each of p ranks owns ``n_rows/p``
contiguous matrix rows and the full vector (``MPI_Scatter`` + ``MPI_Bcast``,
``:12-51``), computes full local dot products (``src/matr_utils.c:86-96``),
and the root concatenates exact y-slices (``MPI_Gather``, ``:141``).

Port: A's rows over the flat mesh, x replicated, a local GEMV per shard; each
shard's y is its exact slice, and the optional gather is a concatenation.
Constraint preserved: ``n_rows % p == 0`` (``src/multiplier_rowwise.c:72-75``).
"""

from __future__ import annotations

from typing import Callable

from .base import Body, MatvecStrategy
from ..obs.annotations import named_span
from ..parallel.mesh import Mesh
from ..utils.errors import check_divisible


class RowwiseStrategy(MatvecStrategy):
    name = "rowwise"

    def specs(self, mesh: Mesh) -> tuple[tuple, tuple, tuple]:
        # All mesh axes as one flat axis: the reference's MPI_COMM_WORLD.
        axes = mesh.axis_names
        return (axes, None), (), (axes,)

    def local_body(self, mesh: Mesh, kernel: Callable) -> Body:
        def body(a_blks, x_blks):
            # Each shard's GEMV IS its exact slice of y (no collective). The
            # kernel returns its accumulator dtype; cast back to storage.
            with named_span("rowwise/local_gemv"):
                return [kernel(a, x).to(a.dtype) for a, x in zip(a_blks, x_blks)]

        return body

    def validate(self, n_rows: int, n_cols: int, mesh: Mesh) -> None:
        check_divisible(n_rows, mesh.size, "n_rows", "number of devices")
