"""Distributed dense matrix–matrix multiply: the same sharding ladder.

The port's counterpart of the JAX package's ``models/gemm.py``. The three
partitioning strategies applied to a rank-2 right-hand side (``C = A @ B``)
give the canonical distributed matmul decompositions:

* ``rowwise``   — A row-sharded, B replicated, C row-sharded;
* ``colwise``   — A and B contraction-sharded, partial C's summed (psum);
* ``blockwise`` — A block-sharded on the 2-D mesh, B sharded over 'cols' on
  its contraction axis, psum over 'cols', C sharded over 'rows';
* ``colwise_ring`` / ``colwise_ring_overlap`` / ``colwise_a2a`` /
  ``colwise_overlap`` — the colwise decomposition with C row-sharded and the
  combine as the neighbor-ring reduce-scatter, the ring-SUMMA walk (each
  step's GEMM tile feeding the chunk in flight), the balanced all-to-all,
  or the staged pipeline (``parallel/ring.py``).

Implementation: each strategy's own ``build_batched`` (models/base.py), so
GEMM and matvec share one compute/combine path per strategy.
"""

from __future__ import annotations

from typing import Callable

from ..parallel.mesh import Mesh, mesh_grid_shape
from ..utils.constants import MESH_AXIS_COLS, MESH_AXIS_ROWS
from ..utils.errors import ShardingError, check_divisible

# The JAX package's GEMM names; each is the matvec registry's strategy of
# the same name, whose batched specs place (A, B, C): the colwise_* four
# scatter C's rows over the ring.
GEMM_STRATEGIES = (
    "blockwise", "colwise", "colwise_a2a", "colwise_overlap", "colwise_ring",
    "colwise_ring_overlap", "rowwise",
)


def available_gemm_strategies() -> list[str]:
    return list(GEMM_STRATEGIES)


def _known(name: str) -> None:
    if name not in GEMM_STRATEGIES:
        raise KeyError(
            f"unknown gemm strategy {name!r}; available: "
            f"{available_gemm_strategies()}"
        )


def validate_gemm(name: str, m: int, k: int, n: int, mesh: Mesh) -> None:
    """Divisibility guards, with the JAX package's messages."""
    _known(name)
    if name == "rowwise":
        check_divisible(m, mesh.size, "m (rows of A)", "number of devices")
    elif name == "colwise":
        check_divisible(k, mesh.size, "k (contraction dim)", "number of devices")
    elif name.startswith("colwise_"):
        check_divisible(k, mesh.size, "k (contraction dim)", "number of devices")
        # They scatter C's rows: each device ends with m/p of them.
        check_divisible(m, mesh.size, "m (rows of A)", "number of devices")
    else:  # blockwise
        if MESH_AXIS_ROWS not in mesh.axis_names or MESH_AXIS_COLS not in mesh.axis_names:
            raise ShardingError(
                f"blockwise gemm needs a 2-D mesh with axes "
                f"({MESH_AXIS_ROWS!r}, {MESH_AXIS_COLS!r}); got {mesh.axis_names}"
            )
        r, c = mesh_grid_shape(mesh)
        check_divisible(m, r, "m (rows of A)", "mesh rows")
        check_divisible(k, c, "k (contraction dim)", "mesh cols")


def gemm_shardings(name: str, mesh: Mesh) -> tuple[tuple, tuple]:
    """Placement specs for (A, B) — the distribute_data analog for GEMM
    (``shard(a, spec_a, mesh)`` places A)."""
    from . import get_strategy

    _known(name)
    spec_a, spec_b, _ = get_strategy(name).batched_specs(mesh)
    return spec_a, spec_b


def build_gemm(
    name: str,
    mesh: Mesh,
    *,
    kernel: str | Callable = "cuda",
    gather_output: bool = True,
    combine: str | None = None,
    stages: int | str | None = None,
    dtype_storage: str | None = None,
) -> Callable:
    """Return ``matmul(a, b) -> c`` for one strategy on ``mesh``.

    ``kernel`` names a local-matmul tier from the GEMM registry
    (``ops/gemm_kernels.py``): ``"cuda"`` (the default, the hand-written
    kernel) or ``"torch"``. ``combine`` selects the combine schedule by
    name, as ``MatvecStrategy.build`` does for matvec: for the colwise
    family ``"psum"``, ``"psum_scatter"``, ``"ring"``, ``"ring_overlap"``,
    ``"a2a"``, ``"overlap"`` or ``"overlap_ring"``; ``"auto"`` is the
    tuning-cache miss (the static default); the rank-1-only
    ``"pallas_ring"`` is rejected. ``stages`` pins the overlap stage count.
    The other arguments follow ``MatvecStrategy.build_batched``: the
    registry names ``colwise_ring`` & co. are the matvec registry's
    bindings of the same schedules.
    """
    from . import get_strategy

    _known(name)
    return get_strategy(name).build_batched(
        mesh, kernel=kernel, gather_output=gather_output, combine=combine,
        stages=stages, dtype_storage=dtype_storage,
    )


def gemm_combine_candidates(name: str, mesh: Mesh) -> tuple[str, ...]:
    """Combine schedules one GEMM strategy offers: the in-body family only
    (``MatvecStrategy.combine_candidates_batched``); empty for strategies
    whose combine is the output gather."""
    from . import get_strategy

    _known(name)
    return get_strategy(name).combine_candidates_batched(mesh)
