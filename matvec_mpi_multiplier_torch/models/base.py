"""Strategy interface: named placements for distributed dense matvec.

The port's counterpart of the JAX package's ``models/base.py``. The reference
implements each strategy as a standalone MPI executable sharing a
``distribute → compute → combine`` skeleton; here a strategy is a small
object that knows

* how ``A`` and ``x`` are cut over the mesh (:meth:`specs`, in
  ``PartitionSpec`` form; :meth:`place` does the cutting — the
  ``device_put``-with-``NamedSharding`` analog, which amortized timing runs
  before the timed region);
* the per-shard compute and the combine (:meth:`local_body`: the local GEMV
  on every shard, then explicit collectives from ``parallel/mesh.py``);
* its divisibility constraints (the reference's guards, Q2/Q3 fixed).

:meth:`build` returns ``matvec(a, x) -> y`` closed over the mesh. It takes
placed operands, or plain tensors, which it places itself, and runs
:meth:`validate` on every call. :meth:`build_batched` is the same program
for a block ``B`` of right-hand sides (one column per request) with a GEMM
kernel: the specs gain an unsharded trailing batch axis
(:meth:`batched_specs`) and the shard bodies are rank-agnostic.
"""

from __future__ import annotations

import abc
from typing import Callable, Sequence

import torch

from ..ops import gemm_kernel_name_for, get_gemm_kernel, get_kernel
from ..parallel.mesh import Mesh, ShardedTensor, shard, unshard
from ..utils.errors import ConfigError, ShardingError

Body = Callable[[Sequence[torch.Tensor], Sequence[torch.Tensor]], list]


def not_ported(what: str) -> ConfigError:
    """The error for an argument of the JAX package's ``build`` whose
    machinery this slice of the port does not have yet."""
    return ConfigError(
        f"{what} is not ported yet: it waits for a later slice of the "
        "PyTorch port (ROADMAP.md, queue A)"
    )


class MatvecStrategy(abc.ABC):
    """One named partitioning strategy for ``y = A @ x``."""

    name: str = "abstract"
    # The combine schedule this instance runs; build(combine=) accepts only it.
    combine: str = "gather"

    @abc.abstractmethod
    def specs(self, mesh: Mesh) -> tuple[tuple, tuple, tuple]:
        """Placement specs for (A, x, y). y's spec is the *native* output
        layout before any optional final all-gather."""

    @abc.abstractmethod
    def local_body(self, mesh: Mesh, kernel: Callable) -> Body:
        """Per-shard compute plus combine: takes every device's local block
        of (A, x) in flat mesh order, returns every device's block of y."""

    @abc.abstractmethod
    def validate(self, n_rows: int, n_cols: int, mesh: Mesh) -> None:
        """Raise ShardingError if the shape cannot be evenly sharded."""

    def place(
        self, a: torch.Tensor, x: torch.Tensor, mesh: Mesh
    ) -> tuple[ShardedTensor, ShardedTensor]:
        """Cut A and x into per-shard contiguous tensors on their devices."""
        if a.dim() != 2 or x.dim() != 1 or x.shape[0] != a.shape[1]:
            raise ValueError(
                f"matvec needs a (m, k) matrix and a (k,) vector, got "
                f"{tuple(a.shape)} and {tuple(x.shape)}"
            )
        self.validate(a.shape[0], a.shape[1], mesh)
        spec_a, spec_x, _ = self.specs(mesh)
        return shard(a, spec_a, mesh), shard(x, spec_x, mesh)

    # ---- batched (multi-RHS) machinery ----

    def batched_specs(self, mesh: Mesh) -> tuple[tuple, tuple, tuple]:
        """Specs for (A, B, C) of the batched ``C = A @ B``: A keeps its
        matvec placement, B and C gain an unsharded trailing batch axis
        (each column of B is one right-hand side, cut exactly as x)."""
        spec_a, spec_x, spec_y = self.specs(mesh)
        return spec_a, _append_batch_axis(spec_x), _append_batch_axis(spec_y)

    def place_batched(
        self, a: torch.Tensor, b: torch.Tensor, mesh: Mesh
    ) -> tuple[ShardedTensor, ShardedTensor]:
        """Cut A and a (k, n_rhs) block B for :meth:`build_batched`."""
        if a.dim() != 2 or b.dim() != 2 or b.shape[0] != a.shape[1]:
            raise ValueError(
                f"batched matvec needs a (m, k) matrix and a (k, n) block, "
                f"got {tuple(a.shape)} and {tuple(b.shape)}"
            )
        self.validate(a.shape[0], a.shape[1], mesh)
        spec_a, spec_b, _ = self.batched_specs(mesh)
        return shard(a, spec_a, mesh), shard(b, spec_b, mesh)

    def _check_build_args(self, combine, stages, dtype_storage) -> None:
        if combine not in (None, self.combine):
            raise not_ported(f"combine={combine!r} for {self.name}")
        if stages is not None:
            raise not_ported("stages (the staged overlap schedules)")
        if dtype_storage not in (None, "native"):
            raise not_ported(f"dtype_storage={dtype_storage!r}")

    def build(
        self,
        mesh: Mesh,
        *,
        kernel: str | Callable = "cuda",
        gather_output: bool = True,
        combine: str | None = None,
        stages: int | str | None = None,
        dtype_storage: str | None = None,
    ) -> Callable:
        """Return ``matvec(a, x) -> y`` for this strategy on ``mesh``.

        ``kernel`` names the local GEMV tier (``ops/gemv.py``); the default
        is the hand-written CUDA kernel. ``gather_output=True`` returns the
        full ``y`` on the mesh's first device (the reference's root-side
        gather/reduce); ``gather_output=False`` returns a
        :class:`ShardedTensor` of per-device y blocks in the strategy's
        native layout. ``combine`` may name only this instance's own
        schedule (:attr:`combine`; colwise chooses it by ``scatter_output``);
        the ring/overlap/auto schedules, ``stages`` and ``dtype_storage``
        wait for later slices and raise ``ConfigError``.
        """
        self._check_build_args(combine, stages, dtype_storage)
        if gather_output == "ring":
            raise not_ported("gather_output='ring'")
        if not isinstance(gather_output, bool):
            raise ValueError(
                f"gather_output must be True or False; got {gather_output!r}"
            )
        return self._build_plain(
            mesh, get_kernel(kernel), gather_output, batched=False
        )

    def build_batched(
        self,
        mesh: Mesh,
        *,
        kernel: str | Callable = "cuda",
        gather_output: bool = True,
        combine: str | None = None,
        stages: int | str | None = None,
        dtype_storage: str | None = None,
    ) -> Callable:
        """Return ``matmul(a, b) -> c`` for a BLOCK of right-hand sides:
        ``b`` is ``(k, n_rhs)``, one column per request, and the whole block
        rides this strategy's program as one GEMM per shard (the promotion
        of n_rhs GEMVs). ``kernel`` names a GEMM tier
        (``ops/gemm_kernels.py``); a GEMV tier name maps to its rank-2 face
        (``gemm_kernel_name_for``). The other arguments follow
        :meth:`build`; ``gather_output`` takes bools only.
        """
        self._check_build_args(combine, stages, dtype_storage)
        if not isinstance(gather_output, bool):
            raise ValueError(
                "batched gather_output must be True or False (the explicit "
                f"ring gather is matvec-only); got {gather_output!r}"
            )
        if isinstance(kernel, str):
            kernel = gemm_kernel_name_for(kernel)
        return self._build_plain(
            mesh, get_gemm_kernel(kernel), gather_output, batched=True
        )

    def _build_plain(
        self, mesh: Mesh, kern: Callable, gather_output: bool, *, batched: bool
    ) -> Callable:
        specs = self.batched_specs if batched else self.specs
        place = self.place_batched if batched else self.place
        spec_a, spec_x, spec_y = specs(mesh)
        body = self.local_body(mesh, kern)

        def run(a, x):
            placed = isinstance(a, ShardedTensor)
            if placed != isinstance(x, ShardedTensor):
                raise ShardingError(
                    "pass A and x both placed (strategy.place) or both plain"
                )
            self.validate(a.shape[0], a.shape[1], mesh)
            if not placed:
                a, x = place(a, x, mesh)
            elif (a.mesh, a.spec, x.spec) != (mesh, spec_a, spec_x):
                raise ShardingError(
                    f"operands were placed for another strategy or mesh "
                    f"(specs {a.spec}, {x.spec}; {self.name} needs "
                    f"{spec_a}, {spec_x})"
                )
            shape = (a.shape[0], *x.shape[1:])
            y = ShardedTensor(tuple(body(a.shards, x.shards)), shape, spec_y, mesh)
            return unshard(y) if gather_output else y

        return run


def _append_batch_axis(spec: tuple) -> tuple:
    """Extend a rank-1 spec with an unsharded trailing batch axis. ``()``
    (fully replicated) already covers any rank and stays as it is."""
    return spec + (None,) if spec else spec
