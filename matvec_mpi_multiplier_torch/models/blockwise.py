"""Strategy P3 — blockwise: 2-D mesh sharding (SUMMA-style).

Reference: ``src/multiplier_blockwise.c``. The process count is factored into
the most-square grid ``(r, c)`` (``src/utils.c:26-37``); rank ``k`` at grid
cell ``(k/c, k%c)`` owns block ``(i, j)`` of A and x-segment ``j``, computes
a plain local GEMV (``:367``), and the root reduces over grid columns and
concatenates over grid rows (``gather_local_results``, ``:144-210``).

Port: A over ``('rows', 'cols')``, x over ``'cols'``; a local GEMV per shard,
a sum over the grid columns in shard order (the psum), leaving y over
``'rows'``; the optional gather concatenates the row blocks. Constraints:
``n_rows % r == 0`` and ``n_cols % c == 0`` — the *correct* guard (quirk Q3).
"""

from __future__ import annotations

from typing import Callable

from .base import Body, MatvecStrategy
from ..obs.annotations import named_span
from ..parallel.mesh import Mesh, mesh_grid_shape, psum
from ..utils.constants import MESH_AXIS_COLS, MESH_AXIS_ROWS
from ..utils.errors import ShardingError, check_divisible


class BlockwiseStrategy(MatvecStrategy):
    name = "blockwise"

    def _check_mesh(self, mesh: Mesh) -> None:
        if MESH_AXIS_ROWS not in mesh.axis_names or MESH_AXIS_COLS not in mesh.axis_names:
            raise ShardingError(
                f"blockwise needs a 2-D mesh with axes "
                f"({MESH_AXIS_ROWS!r}, {MESH_AXIS_COLS!r}); got {mesh.axis_names}"
            )

    def specs(self, mesh: Mesh) -> tuple[tuple, tuple, tuple]:
        self._check_mesh(mesh)
        return (
            (MESH_AXIS_ROWS, MESH_AXIS_COLS), (MESH_AXIS_COLS,), (MESH_AXIS_ROWS,)
        )

    def local_body(self, mesh: Mesh, kernel: Callable) -> Body:
        def body(a_blks, x_segs):
            # Partial y for each shard's grid row (reference :367), then the
            # reduce over grid columns (reference :144-210) on the kernel's
            # accumulator dtype, cast back after.
            with named_span("blockwise/local_gemv"):
                partials = [kernel(a, x) for a, x in zip(a_blks, x_segs)]
            with named_span("blockwise/combine/psum"):
                ys = psum(partials, mesh, MESH_AXIS_COLS)
            return [y.to(a_blks[0].dtype) for y in ys]

        return body

    def overlap_reduce_axes(self, mesh: Mesh):
        # The staged overlap gather (combine="overlap", models/base.py) sums
        # each stage's partial over the grid columns — the reference's
        # reduce-over-grid-columns (:144-210), 1/S of the rows at a time —
        # then ring-gathers over 'rows'.
        return MESH_AXIS_COLS

    def validate(self, n_rows: int, n_cols: int, mesh: Mesh) -> None:
        self._check_mesh(mesh)
        r, c = mesh_grid_shape(mesh)
        check_divisible(n_rows, r, "n_rows", "mesh rows")
        check_divisible(n_cols, c, "n_cols", "mesh cols")
