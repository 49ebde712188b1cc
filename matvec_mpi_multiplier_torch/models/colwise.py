"""Strategy P2 — colwise: 1-D contraction-dimension sharding.

Reference: ``src/multiplier_colwise.c``. Each rank owns ``n_cols/p`` columns
and the matching x segment, forms per-row partial sums
(``multiply_colwise``, ``:105-129``), and the partial vectors are summed to
the root with ``MPI_Reduce(MPI_SUM)`` (``:124``).

Port: A's columns and x over the flat mesh, a local partial GEMV per shard,
then one of two combine schedules:

* ``"psum"`` — every shard gets the full y, summed in shard order (the
  ``MPI_Reduce`` analog; the default);
* ``"psum_scatter"`` — the same sum split by rows, y row-sharded
  (``scatter_output=True``; also needs ``n_rows % p == 0``).

The JAX package's ring/a2a/overlap/pallas_ring schedules and their
``colwise_*`` registry names wait for a later slice (ROADMAP.md).
Constraint preserved: ``n_cols % p == 0`` (``src/multiplier_colwise.c:151-154``,
message fixed per quirk Q2).
"""

from __future__ import annotations

from typing import Callable

from .base import Body, MatvecStrategy
from ..obs.annotations import named_span
from ..parallel.mesh import Mesh, psum, psum_scatter
from ..utils.errors import check_divisible


class ColwiseStrategy(MatvecStrategy):
    name = "colwise"

    def __init__(self, scatter_output: bool = False):
        self.scatter_output = scatter_output
        self.combine = "psum_scatter" if scatter_output else "psum"

    def specs(self, mesh: Mesh) -> tuple[tuple, tuple, tuple]:
        axes = mesh.axis_names
        spec_y = (axes,) if self.scatter_output else ()
        return (None, axes), (axes,), spec_y

    def local_body(self, mesh: Mesh, kernel: Callable) -> Body:
        axes = mesh.axis_names
        combine = psum_scatter if self.scatter_output else psum

        def body(a_panels, x_segs):
            # Full-length partial y from each shard's column panel, summed
            # across shards on the accumulator dtype, cast back afterwards.
            with named_span("colwise/local_gemv"):
                partials = [kernel(a, x) for a, x in zip(a_panels, x_segs)]
            with named_span(f"colwise/combine/{self.combine}"):
                ys = combine(partials, mesh, axes)
            return [y.to(a_panels[0].dtype) for y in ys]

        return body

    def validate(self, n_rows: int, n_cols: int, mesh: Mesh) -> None:
        p = mesh.size
        check_divisible(n_cols, p, "n_cols", "number of devices")
        if self.scatter_output:
            check_divisible(n_rows, p, "n_rows", "number of devices")
