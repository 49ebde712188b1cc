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
  on every shard, then explicit collectives from ``parallel/mesh.py`` and
  ``parallel/ring.py``);
* its divisibility constraints (the reference's guards, Q2/Q3 fixed).

``build(combine=...)`` picks the combine schedule by name: colwise rebinds
itself to one of its in-body reductions (:meth:`with_combine`), and the
sharded-output strategies choose how y is gathered (``"gather"``, the
neighbor ``"ring"``, the staged ``"overlap"``). ``combine="auto"`` reads
the tuning cache (``tuning/``) per operand shape at call time, and
``stages=None`` per overlap program; each takes the static default on a
miss.

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
from ..ops.gemv import acc_dtype
from ..ops.quantize import (
    NATIVE,
    QuantizedMatrix,
    get_storage_kernel,
    normalize_storage,
)
from ..obs.annotations import named_span
from ..parallel.mesh import Mesh, ShardedTensor, shard, unshard
from ..parallel.ring import ring_all_gather, stage_ladder, staged_overlap_gather
from ..utils.errors import ConfigError, ShardingError

Body = Callable[[Sequence[torch.Tensor], Sequence[torch.Tensor]], list]

# Static stage count of the staged `overlap` schedules when none is pinned
# and the tuning cache has no decision (S=1 is the degenerate un-pipelined
# schedule; deeper ladders are the tuner's call).
DEFAULT_OVERLAP_STAGES = 2

# Combine schedules that tile/slice A inside their own bodies (the staged
# row pipelines, the ring-resident GEMV, the fused ring kernel), so they
# cannot consume a quantized payload.
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


def local_kernel(mesh: Mesh, kern: Callable) -> Callable:
    """``kern`` for a body's per-shard calls. Over several processes
    another process's block is a placeholder (``parallel/mesh.py``), and its
    output is the placeholder of the kernel's result: ``(m, *rhs.shape[1:])``
    in the accumulator dtype. A world of one gets ``kern`` itself."""
    if not mesh.spans_processes:
        return kern

    def run(a, b):
        if a.device.type == "meta":
            return torch.empty((a.shape[0], *b.shape[1:]),
                               dtype=acc_dtype(a.dtype), device="meta")
        return kern(a, b)

    return run


def _check_processes(mesh: Mesh, storage: str) -> None:
    if mesh.spans_processes and storage != NATIVE:
        raise ConfigError(
            f"{storage} storage is not served on a mesh over several "
            "processes: its payload leaves have no cross-process placement; "
            "use native storage"
        )


def storage_of(a) -> str:
    """The storage format of an operand, placed or not: ``"native"`` for a
    tensor, the payload's format for a QuantizedMatrix."""
    if isinstance(a, ShardedTensor):
        a = a.shards[0]
    return a.fmt if isinstance(a, QuantizedMatrix) else NATIVE


def not_ported(what: str) -> ConfigError:
    """The error for an argument of the JAX package's API whose machinery
    the port does not have yet."""
    return ConfigError(
        f"{what} is not ported yet: it waits for a later slice of the "
        "PyTorch port (ROADMAP.md, queue A)"
    )


class MatvecStrategy(abc.ABC):
    """One named partitioning strategy for ``y = A @ x``."""

    name: str = "abstract"
    # The combine schedule this instance runs when build() names none.
    combine: str = "gather"
    # Set by constructors that accept combine="auto" (colwise): build()
    # picks it up when no explicit combine argument is passed.
    requested_combine: str | None = None

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

    # ---- combine-schedule machinery ----

    def with_combine(self, combine: str, *, stages: int | str | None = None):
        """Return a rebound strategy instance implementing ``combine`` as an
        in-body schedule, or None when this strategy has no in-body combine
        (the base: rowwise/blockwise, whose combine IS the output gather,
        handled by :meth:`build`). ``stages`` pins the staged ``overlap``
        schedule's stage count on the bound instance."""
        return None

    def combine_candidates(self, mesh: Mesh) -> tuple[str, ...]:
        """Combine schedules this strategy offers. The base family is the
        output-gather triple: the concatenating gather, the explicit
        neighbor ring, and the staged ``overlap`` gather; strategies owning
        an in-body combine (colwise) override."""
        if self.specs(mesh)[2] == ():
            return ()
        return ("gather", "ring", "overlap")

    def overlap_reduce_axes(self, mesh: Mesh):
        """Mesh axes the staged overlap gather must psum each stage's
        partial over before gathering (blockwise's reduce-over-grid-columns;
        None for strategies whose local block is already an exact y
        slice)."""
        return None

    def default_combine(self, mesh: Mesh) -> str:
        """The static default ``combine="auto"`` falls back to on a
        tuning-cache miss. Valid wherever ``self.validate`` is."""
        return "gather"

    def supports_combine(self, combine: str | None) -> bool:
        """True when :meth:`build` accepts this ``combine`` value — the
        the sweep's skip predicate for (strategy, --combine) pairs."""
        if combine in (None, "auto"):
            return True
        try:
            bound = self.with_combine(combine)
        except ValueError:
            return False
        return bound is not None or combine in ("gather", "ring", "overlap")

    def supports_combine_batched(self, combine: str | None) -> bool:
        """:meth:`supports_combine` for :meth:`build_batched`: the in-body
        family only (the gather pair is matvec-only)."""
        if combine in (None, "auto"):
            return True
        try:
            return self.with_combine(combine) is not None
        except ValueError:
            return False

    def combine_candidates_batched(self, mesh: Mesh) -> tuple[str, ...]:
        """Combine schedules valid on the batched path: the in-body family
        only (colwise); the base gather pair is matvec-only."""
        if self.with_combine(self.default_combine(mesh)) is None:
            return ()
        return self.combine_candidates(mesh)

    def _resolve_combine(self, combine: str | None, storage: str,
                         mesh: Mesh) -> str | None:
        """The schedule a build runs: the argument, else the instance's own
        ``combine="auto"`` request (``"auto"`` then builds
        :meth:`_build_auto_combine`). None keeps the instance's binding."""
        if combine is None:
            combine = self.requested_combine
        if storage != NATIVE:
            self._check_storage_combine(combine)
        return combine

    def _build_auto_combine(self, mesh: Mesh, *, batched: bool, dtype_storage: str,
                            **build_kwargs) -> Callable:
        """``combine="auto"``: at each call, the tuning cache's schedule for
        the operand's GLOBAL shape (``tuning.lookup_combine``, under
        ``op="gemm"`` for the batched face), among the schedules this
        strategy offers and the shape admits; the static default on a miss.
        Each chosen schedule is built once. A quantized build never takes a
        schedule that tiles A (:data:`STORAGE_INCOMPATIBLE_COMBINES`), so a
        native-storage decision cannot break it."""
        from ..tuning import lookup_combine
        from ..utils.convert import dtype_name

        candidates = (self.combine_candidates_batched(mesh) if batched
                      else self.combine_candidates(mesh))
        if dtype_storage != NATIVE:
            candidates = tuple(c for c in candidates
                               if c not in STORAGE_INCOMPATIBLE_COMBINES)
        built: dict[str, Callable] = {}

        def choose(m: int, k: int, dtype) -> str:
            choice = lookup_combine(op="gemm" if batched else "matvec",
                                    strategy=self.name, m=m, k=k, p=mesh.size,
                                    dtype=dtype_name(dtype))
            if choice in candidates:
                try:
                    (self.with_combine(choice) or self).validate(m, k, mesh)
                    return choice
                except ShardingError:
                    pass  # a schedule this shape does not divide into
            return self.default_combine(mesh)

        def run(a, x):
            choice = choose(a.shape[0], a.shape[1], a.dtype)
            if choice not in built:
                built[choice] = self._build_combine(
                    mesh, choice, batched=batched, dtype_storage=dtype_storage,
                    **build_kwargs)
            return built[choice](a, x)

        return run

    def _build_combine(
        self, mesh: Mesh, combine: str, *, batched: bool, kernel,
        gather_output, stages, dtype_storage: str,
    ) -> Callable:
        """Build the concrete matvec (or batched matmul) for one resolved
        combine schedule."""
        kwargs = dict(kernel=kernel, gather_output=gather_output,
                      dtype_storage=dtype_storage)
        bound = self.with_combine(combine, stages=stages)
        if bound is not None:
            if batched:
                if not self.supports_combine_batched(combine):
                    # e.g. pallas_ring: the fused kernel is rank-1 only.
                    raise ValueError(
                        f"strategy {self.name!r} has no batched combine "
                        f"schedule {combine!r}"
                    )
                return bound.build_batched(mesh, **kwargs)
            return bound.build(mesh, **kwargs)
        if batched:
            if combine != "gather":
                # The gather family (ring/overlap) is matvec-only: the
                # batched output gather is the plain concatenation.
                raise ValueError(
                    f"strategy {self.name!r} has no batched combine "
                    f"schedule {combine!r}"
                )
            return self._build_batched(mesh, kernel, gather_output, dtype_storage)
        if combine in ("ring", "overlap"):
            # Gather-schedule knob: only meaningful when the output is being
            # gathered. gather_output=False keeps the caller's sharded y.
            if gather_output:
                if combine == "overlap":
                    return self._build_overlap_gather(
                        mesh, kernel=kernel, stages=stages,
                        dtype_storage=dtype_storage,
                    )
                kwargs["gather_output"] = "ring"
        elif combine != "gather":
            raise ValueError(
                f"strategy {self.name!r} has no combine schedule "
                f"{combine!r}; candidates: {self.combine_candidates(mesh)}"
            )
        return self._build_matvec(mesh, **kwargs)

    # ---- staged-overlap machinery ----

    def overlap_chunk_devices(self, mesh: Mesh) -> int:
        """The number of devices one output chunk is divided across — the
        denominator of the stage ladder (S must divide ``m /
        chunk_devices``): the product of the axes in the overlap-bound
        strategy's native y spec (the flat mesh for the 1-D strategies,
        the 'rows' axis alone for blockwise)."""
        bound = self.with_combine("overlap") or self
        y_axes = bound.specs(mesh)[2][0]
        names = (y_axes,) if isinstance(y_axes, str) else tuple(y_axes)
        chunk_devices = 1
        for name in names:
            chunk_devices *= mesh.shape[name]
        return chunk_devices

    def resolve_stages(
        self,
        m: int,
        k: int,
        mesh: Mesh,
        stages: int | str | None,
        chunk_devices: int,
        dtype,
    ) -> int:
        """The concrete stage count S one overlap program uses.

        ``stages=None``/``"auto"`` reads the tuning cache's stage count for
        this strategy, GLOBAL shape, mesh size and dtype
        (``tuning.lookup_overlap``), :data:`DEFAULT_OVERLAP_STAGES` on a
        miss. The result is clamped DOWN to the
        largest entry of the shape's valid stage ladder
        (``parallel.ring.stage_ladder``: S must divide the ``m /
        chunk_devices`` per-device chunk), so a requested S degrades to a
        coarser pipeline on a shape it doesn't divide and never crashes a
        shape ``validate`` accepts.
        """
        ladder = stage_ladder(m, chunk_devices)
        if not ladder:
            raise ShardingError(
                f"overlap schedule needs n_rows divisible by "
                f"{chunk_devices} (got {m})"
            )
        if stages in (None, "auto"):
            from ..tuning import lookup_overlap
            from ..utils.convert import dtype_name

            decision = lookup_overlap(strategy=self.name, m=m, k=k, p=mesh.size,
                                      dtype=dtype_name(dtype))
            stages = (decision or {}).get("stages") or DEFAULT_OVERLAP_STAGES
        stages = int(stages)
        if stages < 1:
            raise ValueError(f"stages must be >= 1, got {stages}")
        for cand in ladder:  # descending; 1 is always present
            if cand <= stages:
                return cand
        return ladder[-1]

    def _build_overlap_gather(
        self, mesh: Mesh, *, kernel, stages, dtype_storage: str,
    ) -> Callable:
        """The ``combine="overlap"`` face for sharded-output strategies:
        the local GEMV split into S row-stages, each stage's chunked ring
        all-gather (plus, for blockwise, its chunked psum over the grid
        columns) issued before the next stage's compute
        (``parallel.ring.staged_overlap_gather``). Returns the full y on the
        mesh's first device, as ``gather_output=True`` does."""
        kern = local_kernel(mesh, get_kernel(kernel))
        y_axes = self.specs(mesh)[2][0]
        reduce_axes = self.overlap_reduce_axes(mesh)
        chunk_devices = self.overlap_chunk_devices(mesh)

        def matvec(a, x):
            a, x = self._operands(a, x, mesh, dtype_storage, batched=False)
            s = self.resolve_stages(
                a.shape[0], a.shape[1], mesh, stages, chunk_devices, a.dtype
            )
            # One combine span for the whole staged program; each stage
            # carries its own stage{i}/compute|combine names inside.
            with named_span(f"{self.name}/combine/overlap@{s}"):
                ys = staged_overlap_gather(
                    a.shards, x.shards, mesh, y_axes, kern, s, reduce_axes
                )
            return ys[mesh.first_local].to(a.dtype)

        return matvec

    # ---- builders ----

    def build(
        self,
        mesh: Mesh,
        *,
        kernel: str | Callable = "cuda",
        gather_output: bool | str = True,
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
        native layout; ``gather_output="ring"`` returns the same full ``y``
        through the explicit neighbor-ring all-gather
        (``parallel.ring.ring_all_gather``), and for a strategy whose native
        output is already whole (plain colwise) behaves like True.

        ``combine`` selects the combine schedule by name: for the colwise
        family a reduction schedule (``"psum"``, ``"psum_scatter"``,
        ``"ring"``, ``"ring_overlap"``, ``"a2a"``, the staged ``"overlap"``
        and ``"overlap_ring"``, the fused ``"pallas_ring"``), for the
        sharded-output strategies a gather schedule (``"gather"``,
        ``"ring"``, the staged ``"overlap"`` gather). ``combine="auto"``
        reads the tuning cache per operand shape at call time and takes the
        strategy's static default on a miss (:meth:`_build_auto_combine`).

        ``stages`` pins the ``overlap`` schedules' stage count S (ignored by
        every other schedule): None/``"auto"`` reads the tuning cache
        (``DEFAULT_OVERLAP_STAGES`` on a miss); an int is clamped down to
        the largest valid ladder entry for the shape (:meth:`resolve_stages`).

        ``dtype_storage`` selects the storage format of ``A``: None or
        ``"native"`` is the plain tensor path; ``"int8"``/``"int8c"``/
        ``"fp8"`` make the built function take a QuantizedMatrix (quantized
        with ``contraction_shards=self.contraction_shards(mesh)``) in ``a``'s
        place, and ``kernel`` then names a quantized-storage tier
        (``ops.quantize.get_storage_kernel``). Combine schedules that slice
        A inside their bodies (:data:`STORAGE_INCOMPATIBLE_COMBINES`) are
        refused with it.
        """
        storage = normalize_storage(dtype_storage)
        combine = self._resolve_combine(combine, storage, mesh)
        if combine == "auto":
            return self._build_auto_combine(
                mesh, batched=False, dtype_storage=storage, kernel=kernel,
                gather_output=gather_output, stages=stages,
            )
        if combine is not None:
            return self._build_combine(
                mesh, combine, batched=False, kernel=kernel,
                gather_output=gather_output, stages=stages,
                dtype_storage=storage,
            )
        return self._build_matvec(mesh, kernel=kernel,
                                  gather_output=gather_output,
                                  dtype_storage=storage)

    def _build_matvec(self, mesh: Mesh, *, kernel, gather_output,
                      dtype_storage: str) -> Callable:
        """The concrete (combine-resolved) builder behind :meth:`build`."""
        if not isinstance(gather_output, bool) and gather_output != "ring":
            raise ValueError(
                f"gather_output must be True, False or 'ring'; "
                f"got {gather_output!r}"
            )
        if dtype_storage == NATIVE:
            kern = get_kernel(kernel)
        else:
            kern = get_storage_kernel(kernel)
        return self._build_plain(mesh, kern, gather_output, dtype_storage,
                                 batched=False)

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
        (``gemm_kernel_name_for``). ``combine`` follows :meth:`build` minus
        the matvec-only ``"ring"``/``"overlap"`` output gathers and the
        rank-1 ``"pallas_ring"`` kernel (colwise's in-body schedules are
        rank-agnostic and batch); ``stages`` follows :meth:`build`;
        ``gather_output`` takes bools only. Under quantized
        ``dtype_storage`` the quantized kernel serves the block as it is
        (it is rank-agnostic), so the GEMM promotion keeps the format.
        """
        storage = normalize_storage(dtype_storage)
        combine = self._resolve_combine(combine, storage, mesh)
        if combine == "auto":
            return self._build_auto_combine(
                mesh, batched=True, dtype_storage=storage, kernel=kernel,
                gather_output=gather_output, stages=stages,
            )
        if combine is not None:
            return self._build_combine(
                mesh, combine, batched=True, kernel=kernel,
                gather_output=gather_output, stages=stages,
                dtype_storage=storage,
            )
        return self._build_batched(mesh, kernel, gather_output, storage)

    def _build_batched(self, mesh: Mesh, kernel, gather_output,
                       storage: str) -> Callable:
        """The concrete batched builder: :meth:`_build_plain` with the GEMM
        registry (or the rank-agnostic quantized kernel)."""
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

    def _operands(self, a, x, mesh: Mesh, storage: str, *, batched: bool):
        """Validate the shape and return (A, x) placed for this strategy:
        placed operands are checked, plain ones placed here."""
        spec_a, spec_x, _ = (self.batched_specs if batched else self.specs)(mesh)
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
            place = self.place_batched if batched else self.place
            return place(a, x, mesh)
        if (a.mesh, a.spec, x.spec, storage_of(a)) != (
                mesh, spec_a, spec_x, storage):
            raise ShardingError(
                f"operands were placed for another strategy, mesh or "
                f"storage (specs {a.spec}, {x.spec}, {storage_of(a)} A; "
                f"{self.name} needs {spec_a}, {spec_x}, {storage} A)"
            )
        return a, x

    def _build_plain(
        self, mesh: Mesh, kern: Callable, gather_output: bool | str,
        storage: str, *, batched: bool,
    ) -> Callable:
        _check_processes(mesh, storage)
        spec_y = (self.batched_specs if batched else self.specs)(mesh)[2]
        body = self.local_body(mesh, local_kernel(mesh, kern))
        # The axes y is sharded over (its leading spec entry): the flat mesh
        # for the 1-D strategies, 'rows' alone for blockwise, where devices
        # along 'cols' hold replicas and run identical independent rings.
        ring_axes = spec_y[0] if gather_output == "ring" and spec_y != () else None

        def run(a, x):
            a, x = self._operands(a, x, mesh, storage, batched=batched)
            shape = (a.shape[0], *x.shape[1:])
            ys = body(a.shards, x.shards)
            if ring_axes is not None:
                with named_span(f"{self.name}/combine/ring_gather"):
                    return ring_all_gather(ys, mesh, ring_axes)[mesh.first_local]
            y = ShardedTensor(tuple(ys), shape, spec_y, mesh)
            return unshard(y, boundary=True) if gather_output else y

        return run


def _append_batch_axis(spec: tuple) -> tuple:
    """Extend a rank-1 spec with an unsharded trailing batch axis. ``()``
    (fully replicated) already covers any rank and stays as it is."""
    return spec + (None,) if spec else spec
