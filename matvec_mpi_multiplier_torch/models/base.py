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

``dtype_storage`` (int8, int8c, fp8; ``ops/quantize.py``) makes the built
function take a :class:`~..ops.quantize.QuantizedMatrix` in A's place: each
leaf (payload, scales, and the int8c pair) is cut with A's own spec, and the
local kernel becomes the quantized one (``"cuda"``: the hand-written
block-scaled GEMV, for both ranks of the right-hand side).
"""

from __future__ import annotations

import abc
from typing import Callable, Sequence

import torch

from ..ops import gemm_kernel_name_for, get_gemm_kernel, get_kernel
from ..ops.quantize import (
    NATIVE,
    QuantizedMatrix,
    get_storage_kernel,
    normalize_storage,
)
from ..parallel.mesh import Mesh, ShardedTensor, shard, unshard
from ..utils.errors import ConfigError, ShardingError

Body = Callable[[Sequence[torch.Tensor], Sequence[torch.Tensor]], list]

# Combine schedules of the JAX package that tile A inside their own bodies,
# so they cannot consume a quantized payload (none is ported yet; the names
# keep the check in place for when they are).
STORAGE_INCOMPATIBLE_COMBINES = frozenset(
    ("overlap", "overlap_ring", "ring_overlap", "pallas_ring")
)


def shard_operand(a, spec: tuple, mesh: Mesh) -> ShardedTensor:
    """Place A by ``spec``: a tensor as it is, a :class:`QuantizedMatrix`
    leaf by leaf with the same spec (one per-shard ``QuantizedMatrix`` per
    device). The scale planes' columns split with A's because every shard
    holds whole blocks (``default_block``)."""
    if not isinstance(a, QuantizedMatrix):
        return shard(a, spec, mesh)
    leaves = [None if leaf is None else shard(leaf, spec, mesh).shards
              for leaf in a.leaves]
    shards = tuple(
        QuantizedMatrix(*(None if cut is None else cut[f] for cut in leaves),
                        fmt=a.fmt, block=a.block, out_dtype=a.dtype)
        for f in range(mesh.size)
    )
    return ShardedTensor(shards, a.shape, tuple(spec), mesh)


def storage_of(a) -> str:
    """The storage format of an operand, placed or not: ``"native"`` for a
    tensor, the payload's format for a QuantizedMatrix."""
    if isinstance(a, ShardedTensor):
        a = a.shards[0]
    return a.fmt if isinstance(a, QuantizedMatrix) else NATIVE


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
        self, a, x: torch.Tensor, mesh: Mesh
    ) -> tuple[ShardedTensor, ShardedTensor]:
        """Cut A (a tensor or a QuantizedMatrix) and x into per-shard
        contiguous tensors on their devices."""
        if len(a.shape) != 2 or x.dim() != 1 or x.shape[0] != a.shape[1]:
            raise ValueError(
                f"matvec needs a (m, k) matrix and a (k,) vector, got "
                f"{tuple(a.shape)} and {tuple(x.shape)}"
            )
        self._check_operand(a, mesh)
        spec_a, spec_x, _ = self.specs(mesh)
        return shard_operand(a, spec_a, mesh), shard(x, spec_x, mesh)

    def _check_operand(self, a, mesh: Mesh) -> None:
        self.validate(a.shape[0], a.shape[1], mesh)
        if isinstance(a, QuantizedMatrix):
            shards = self.contraction_shards(mesh)
            if (a.shape[1] // shards) % a.block:
                raise ShardingError(
                    f"a {a.fmt} payload in blocks of {a.block} does not cut "
                    f"into {shards} contraction shards of whole blocks; "
                    f"quantize it with contraction_shards={shards}"
                )

    # ---- quantized-storage machinery ----

    def contraction_shards(self, mesh: Mesh) -> int:
        """Devices A's contraction (column) axis is sharded across — the
        denominator of the quantization block choice
        (``ops.quantize.default_block``)."""
        spec_a = self.specs(mesh)[0]
        k_axes = spec_a[1] if len(spec_a) > 1 else None
        if k_axes is None:
            return 1
        names = (k_axes,) if isinstance(k_axes, str) else tuple(k_axes)
        shards = 1
        for name in names:
            shards *= mesh.shape[name]
        return shards

    def storage_combine_ok(self, combine: str | None) -> bool:
        """True when ``combine`` composes with quantized storage: the
        un-staged family only (:data:`STORAGE_INCOMPATIBLE_COMBINES`)."""
        if combine in (None, "auto"):
            combine = self.combine
        return combine not in STORAGE_INCOMPATIBLE_COMBINES

    def _check_storage_combine(self, combine: str | None) -> None:
        if not self.storage_combine_ok(combine):
            effective = combine if combine not in (None, "auto") else self.combine
            raise ConfigError(
                f"combine {effective!r} tiles A inside its schedule body "
                "and cannot compose with quantized dtype_storage; use the "
                "un-staged family or native storage"
            )

    # ---- batched (multi-RHS) machinery ----

    def batched_specs(self, mesh: Mesh) -> tuple[tuple, tuple, tuple]:
        """Specs for (A, B, C) of the batched ``C = A @ B``: A keeps its
        matvec placement, B and C gain an unsharded trailing batch axis
        (each column of B is one right-hand side, cut exactly as x)."""
        spec_a, spec_x, spec_y = self.specs(mesh)
        return spec_a, _append_batch_axis(spec_x), _append_batch_axis(spec_y)

    def place_batched(
        self, a, b: torch.Tensor, mesh: Mesh
    ) -> tuple[ShardedTensor, ShardedTensor]:
        """Cut A (a tensor or a QuantizedMatrix) and a (k, n_rhs) block B
        for :meth:`build_batched`."""
        if len(a.shape) != 2 or b.dim() != 2 or b.shape[0] != a.shape[1]:
            raise ValueError(
                f"batched matvec needs a (m, k) matrix and a (k, n) block, "
                f"got {tuple(a.shape)} and {tuple(b.shape)}"
            )
        self._check_operand(a, mesh)
        spec_a, spec_b, _ = self.batched_specs(mesh)
        return shard_operand(a, spec_a, mesh), shard(b, spec_b, mesh)

    def _check_build_args(self, combine, stages, dtype_storage) -> str:
        """Validate the build arguments; return the canonical storage."""
        storage = normalize_storage(dtype_storage)
        if storage != NATIVE:
            self._check_storage_combine(combine)
        if combine not in (None, self.combine):
            raise not_ported(f"combine={combine!r} for {self.name}")
        if stages is not None:
            raise not_ported("stages (the staged overlap schedules)")
        return storage

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
        the ring/overlap/auto schedules and ``stages`` wait for later slices
        and raise ``ConfigError``.

        ``dtype_storage`` selects the storage format of ``A``: None or
        ``"native"`` is the plain tensor path; ``"int8"``/``"int8c"``/
        ``"fp8"`` make the built function take a QuantizedMatrix (quantized
        with ``contraction_shards=self.contraction_shards(mesh)``) in ``a``'s
        place, and ``kernel`` then names a quantized-storage tier
        (``ops.quantize.get_storage_kernel``). Other names raise
        ``ConfigError``.
        """
        storage = self._check_build_args(combine, stages, dtype_storage)
        if gather_output == "ring":
            raise not_ported("gather_output='ring'")
        if not isinstance(gather_output, bool):
            raise ValueError(
                f"gather_output must be True or False; got {gather_output!r}"
            )
        kern = get_kernel(kernel) if storage == NATIVE else get_storage_kernel(kernel)
        return self._build_plain(mesh, kern, gather_output, storage, batched=False)

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
        :meth:`build`; ``gather_output`` takes bools only. Under quantized
        ``dtype_storage`` the quantized kernel serves the block as it is
        (it is rank-agnostic), so the GEMM promotion keeps the format.
        """
        storage = self._check_build_args(combine, stages, dtype_storage)
        if not isinstance(gather_output, bool):
            raise ValueError(
                "batched gather_output must be True or False (the explicit "
                f"ring gather is matvec-only); got {gather_output!r}"
            )
        if storage != NATIVE:
            kern = get_storage_kernel(kernel)
        else:
            if isinstance(kernel, str):
                kernel = gemm_kernel_name_for(kernel)
            kern = get_gemm_kernel(kernel)
        return self._build_plain(mesh, kern, gather_output, storage, batched=True)

    def _build_plain(
        self, mesh: Mesh, kern: Callable, gather_output: bool, storage: str,
        *, batched: bool,
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
                if storage_of(a) != storage:
                    raise ConfigError(
                        f"this {self.name} program serves {storage} storage "
                        f"and got a {storage_of(a)} A (quantize A with "
                        "ops.quantize.quantize_matrix, or build for its format)"
                    )
                a, x = place(a, x, mesh)
            elif (a.mesh, a.spec, x.spec, storage_of(a)) != (
                    mesh, spec_a, spec_x, storage):
                raise ShardingError(
                    f"operands were placed for another strategy, mesh or "
                    f"storage (specs {a.spec}, {x.spec}, {storage_of(a)} A; "
                    f"{self.name} needs {spec_a}, {spec_x}, {storage} A)"
                )
            shape = (a.shape[0], *x.shape[1:])
            y = ShardedTensor(tuple(body(a.shards, x.shards)), shape, spec_y, mesh)
            return unshard(y) if gather_output else y

        return run


def _append_batch_axis(spec: tuple) -> tuple:
    """Extend a rank-1 spec with an unsharded trailing batch axis. ``()``
    (fully replicated) already covers any rank and stays as it is."""
    return spec + (None,) if spec else spec
