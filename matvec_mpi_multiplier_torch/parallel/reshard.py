"""Online resharding: migrate a resident operand between strategies.

The port's counterpart of the JAX package's ``parallel/reshard.py``. A
layout change is a redistribution of the same bytes over the same devices,
so the migration between two partitionings is a short ``all_to_all`` /
``ppermute`` program over the mesh's shard list (``parallel/mesh.py``),
never a gather of the whole operand.

The per-pair programs, on an ``(r, c)`` grid with ``p = r * c`` shards in
the flat order ``d = i * c + j``:

==========  ==========  ==================================================
src         dst         program
==========  ==========  ==================================================
rowwise     colwise     all_to_all over the flat axis (split 1, concat 0)
colwise     rowwise     all_to_all over the flat axis (split 0, concat 1)
rowwise     blockwise   all_to_all over 'cols' (split 1, concat 0)
blockwise   rowwise     all_to_all over 'cols' (split 0, concat 1)
colwise     blockwise   grid-transpose ppermute, then all_to_all over
                        'rows' (split 0, concat 1)
blockwise   colwise     all_to_all over 'rows' (split 1, concat 0), then
                        inverse grid-transpose ppermute
==========  ==========  ==================================================

:func:`reshard_program` is the symbolic step table (degenerate steps
elided) and :func:`build_reshard` runs it. The built callable maps a
:class:`~.mesh.ShardedTensor` of a native ``A`` or of a quantized
resident's :class:`~..ops.quantize.QuantizedMatrix` shards (payload and
scales move leaf by leaf with the same program), so per-block scales move
bitwise whenever the block size agrees between the two layouts.

**What a migration copies.** Where logical shards share one device (p
shards on one card), a ``ppermute`` moves no bytes: it reorders the shard
list. An ``all_to_all`` builds every destination shard as a fresh copy
(``torch.cat`` of its chunks), so each one copies the whole payload once
(:func:`copy_bytes`); every program holds at most one. The peak is the
source shards plus the destination shards of the leaf in flight: twice the
payload's bytes for a native ``A``.
"""

from __future__ import annotations

from typing import Callable

from ..utils.constants import MESH_AXIS_COLS, MESH_AXIS_ROWS
from ..utils.errors import ConfigError
from .mesh import Mesh, ShardedTensor, all_to_all, mesh_grid_shape, ppermute

__all__ = [
    "RESHARD_STRATEGIES",
    "payload_spec",
    "reshard_program",
    "build_reshard",
    "validate_reshard",
    "copy_bytes",
]

#: The strategies the migration covers, in canonical order.
RESHARD_STRATEGIES = ("rowwise", "colwise", "blockwise")

_FLAT = (MESH_AXIS_ROWS, MESH_AXIS_COLS)


def _check_name(name: str) -> None:
    if name not in RESHARD_STRATEGIES:
        raise ConfigError(f"reshard covers {RESHARD_STRATEGIES}, got {name!r}")


def payload_spec(strategy: str) -> tuple:
    """The spec (``PartitionSpec`` form) a strategy's resident ``A`` lives
    under on a 2-D mesh, as the JAX package spells it; every leaf of a
    quantized resident shares it."""
    _check_name(strategy)
    if strategy == "rowwise":
        return (_FLAT, None)
    if strategy == "colwise":
        return (None, _FLAT)
    return (MESH_AXIS_ROWS, MESH_AXIS_COLS)


def _transpose_perm(r: int, c: int) -> list[tuple[int, int]]:
    # Flat-order grid transpose: d = i*c + j -> (d % r) * c + d // r.
    return [(d, (d % r) * c + d // r) for d in range(r * c)]


def _transpose_inv_perm(r: int, c: int) -> list[tuple[int, int]]:
    return [(e, (e % c) * r + e // c) for e in range(r * c)]


def _perm(which: str, r: int, c: int) -> list[tuple[int, int]]:
    return _transpose_perm(r, c) if which == "t" else _transpose_inv_perm(r, c)


def reshard_program(src: str, dst: str, r: int, c: int) -> tuple[tuple, ...]:
    """The step sequence migrating ``src`` -> ``dst`` on an ``(r, c)`` grid:
    ``("a2a", axis, split, concat)`` and ``("perm", which)`` tuples, with
    size-1 collective groups and fixed-point permutes elided. Equal, tuple
    for tuple, to the JAX package's."""
    _check_name(src)
    _check_name(dst)
    if src == dst:
        return ()
    programs = {
        ("rowwise", "colwise"): (("a2a", "flat", 1, 0),),
        ("colwise", "rowwise"): (("a2a", "flat", 0, 1),),
        ("rowwise", "blockwise"): (("a2a", "cols", 1, 0),),
        ("blockwise", "rowwise"): (("a2a", "cols", 0, 1),),
        ("colwise", "blockwise"): (("perm", "t"), ("a2a", "rows", 0, 1)),
        ("blockwise", "colwise"): (("a2a", "rows", 1, 0), ("perm", "t_inv")),
    }
    sizes = {"flat": r * c, "rows": r, "cols": c}
    steps = []
    for step in programs[(src, dst)]:
        if step[0] == "a2a" and sizes[step[1]] == 1:
            continue  # size-1 group: the all_to_all is an identity
        if step[0] == "perm" and all(a == b for a, b in _perm(step[1], r, c)):
            continue  # degenerate grid: the transpose is a no-op
        steps.append(step)
    return tuple(steps)


def validate_reshard(shape, mesh: Mesh, *, what: str = "A") -> None:
    """Every step splits a local shard by a collective-group size, so both
    global dims divisible by ``p`` suffice for every pair. Raises
    :class:`ConfigError` naming the operand (the engine then requantizes a
    scale plane from the host instead of moving it)."""
    p = mesh.size
    m, k = int(shape[0]), int(shape[1])
    if m % p or k % p:
        raise ConfigError(
            f"reshard needs both dims of {what} divisible by the device "
            f"count: shape=({m}, {k}), p={p}"
        )


def _axes(mesh: Mesh, name: str) -> tuple[str, ...]:
    if name == "flat":
        return tuple(mesh.axis_names)
    return ((MESH_AXIS_ROWS,) if name == "rows" else (MESH_AXIS_COLS,))


def _leaves(shard) -> tuple:
    """A shard's tensors: itself, or a QuantizedMatrix's leaves."""
    leaves = getattr(shard, "leaves", None)
    return (shard,) if leaves is None else leaves


def _nbytes(t) -> int:
    return 0 if t is None else t.numel() * t.element_size()


def copy_bytes(mesh: Mesh, src: str, dst: str, st: ShardedTensor) -> int:
    """Bytes the migration of ``st`` copies: the whole payload (every leaf,
    every shard) for an ``all_to_all`` step, and for a ``ppermute`` step
    only the shards that cross to another device (none where the shards
    share one card)."""
    r, c = mesh_grid_shape(mesh)
    total = 0
    for step in reshard_program(src, dst, r, c):
        if step[0] == "a2a":
            total += sum(_nbytes(t) for s in st.shards for t in _leaves(s))
        else:
            devices = mesh.devices
            total += sum(
                sum(_nbytes(t) for t in _leaves(st.shards[a]))
                for a, b in _perm(step[1], r, c) if devices[a] != devices[b]
            )
    return total


def build_reshard(mesh: Mesh, src: str, dst: str) -> Callable[[ShardedTensor], ShardedTensor]:
    """Build the migration ``src`` -> ``dst`` on ``mesh``.

    Returns ``migrate(st)``: ``st`` is a native ``A`` or a quantized
    resident placed by ``src``'s strategy (``shard_operand``); the result
    holds the same values placed by ``dst``'s, each destination shard equal
    to what ``shard`` of the full operand in the destination layout holds.
    ``src == dst`` builds an identity."""
    from ..models import get_strategy

    r, c = mesh_grid_shape(mesh)
    steps = reshard_program(src, dst, r, c)
    src_spec = get_strategy(src).specs(mesh)[0]
    dst_spec = get_strategy(dst).specs(mesh)[0]

    def migrate_leaf(blocks: list) -> list:
        for step in steps:
            if step[0] == "a2a":
                blocks = all_to_all(blocks, mesh, _axes(mesh, step[1]),
                                    split_axis=step[2], concat_axis=step[3])
            else:
                blocks = ppermute(blocks, mesh, _axes(mesh, "flat"),
                                  _perm(step[1], r, c))
        return blocks

    def migrate(st: ShardedTensor) -> ShardedTensor:
        if st.mesh != mesh or tuple(st.spec) != tuple(src_spec):
            raise ConfigError(
                f"reshard {src} -> {dst}: the operand is placed by {st.spec} "
                f"on another mesh or spec; {src} places A by {src_spec}"
            )
        first = st.shards[0]
        if not hasattr(first, "leaves"):
            shards = tuple(migrate_leaf(list(st.shards)))
        else:
            moved = [
                None if leaf is None
                else migrate_leaf([s.leaves[i] for s in st.shards])
                for i, leaf in enumerate(first.leaves)
            ]
            shards = tuple(
                type(first)(*(None if cut is None else cut[f] for cut in moved),
                            fmt=first.fmt, block=first.block,
                            out_dtype=first.dtype)
                for f in range(mesh.size)
            )
        return ShardedTensor(shards, tuple(st.shape), tuple(dst_spec), mesh)

    return migrate
