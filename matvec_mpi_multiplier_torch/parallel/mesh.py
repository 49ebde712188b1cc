"""Device mesh and its collectives: the single-controller process grid.

Reference analog: ``get_2_most_closest_multipliers`` (``src/utils.c:26-37``)
factors the process count into the most-square 2-D grid ``(r, c)`` with
``r <= c``; the blockwise executable places rank ``k`` at grid cell
``(k / c, k % c)`` (``src/multiplier_blockwise.c:299-303``). Mapping: 1→1×1,
2→1×2, 4→2×2, 6→2×3, 8→2×4, 12→3×4, 24→4×6 — the same as the JAX package's
``parallel/mesh.py``.

The port's mesh is a single controller, as the JAX package's is: one Python
process holds p logical shards over a list of ``torch.device`` s (repeats
allowed — p shards on one card are p logical devices). A placement spec is
a tuple in ``PartitionSpec`` form, one entry per tensor dimension: ``None``
(whole), an axis name, or a tuple of axis names (split over their product,
row-major). The collectives are explicit tensor ops:

* all-gather (:func:`unshard`) is a ``torch.cat`` onto the mesh's first device;
* :func:`psum` sums over the reduced axes in shard-index order 0…n−1, so the
  result is deterministic;
* :func:`psum_scatter` is that sum split by rows;
* :func:`ppermute` moves each shard's block to the shard its permutation
  names (on one card, a list rotation: nothing is copied);
* :func:`all_to_all` sends chunk j of shard i (cut along ``split_axis``) to
  shard j, which concatenates what it gets along ``concat_axis``.

No collective here reads a value back to the host.

**A mesh over several processes** (``parallel/distributed.py``, joined with
``initialize``): :func:`make_mesh` lays the processes' local device lists
out in rank order, and ``Mesh.owners`` names the process that owns each
flat index. Each process runs the same program over every flat index, as
the reference's ranks run one ``main``; a block another process owns is a
``meta`` tensor here, a placeholder with its shape and dtype and no data.
:func:`shard` keeps only the local shards. Each collective first moves the
blocks it needs between processes (:func:`_exchange`: point-to-point gloo
messages, staged through host memory), then computes as on one process: a
sum runs over every member in the same fixed shard order, so a result is
bitwise the one-process mesh's on the same grid. The gathered y of
:func:`unshard` lands on every process. A world of one takes the code path
it always took (``owners`` is None).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch

from ..utils.constants import MESH_AXIS_COLS, MESH_AXIS_ROWS
from ..utils.errors import ConfigError


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A grid of devices: ``devices`` flat in row-major grid order."""

    devices: tuple[torch.device, ...]
    grid: tuple[int, ...]
    axis_names: tuple[str, ...] = (MESH_AXIS_ROWS, MESH_AXIS_COLS)
    # Over several processes: the rank that owns each flat index, and this
    # process's rank. None: this one process owns every index.
    owners: tuple[int, ...] | None = None
    rank: int = 0

    def __post_init__(self):
        if len(self.grid) != len(self.axis_names):
            raise ConfigError(
                f"mesh grid {self.grid} does not match axes {self.axis_names}"
            )
        if math.prod(self.grid) != len(self.devices):
            raise ConfigError(
                f"mesh grid {self.grid} does not cover {len(self.devices)} devices"
            )

    @property
    def shape(self) -> dict[str, int]:
        """Axis name -> size, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.grid))

    @property
    def size(self) -> int:
        return len(self.devices)

    def coords(self, flat: int) -> dict[str, int]:
        """Grid coordinates of the ``flat``-th device."""
        out = {}
        for name, n in zip(reversed(self.axis_names), reversed(self.grid)):
            flat, out[name] = divmod(flat, n)
        return out

    @property
    def spans_processes(self) -> bool:
        return self.owners is not None

    @property
    def first_local(self) -> int:
        """The first flat index this process holds (0 in a world of one):
        where a result every shard holds is read."""
        return 0 if self.owners is None else self.owners.index(self.rank)

    def is_local(self, flat: int) -> bool:
        """Whether this process holds the ``flat``-th shard."""
        return self.owners is None or self.owners[flat] == self.rank

    def distinct_devices(self) -> list[torch.device]:
        """The devices this process computes on (all of them in a world of
        one)."""
        return list(dict.fromkeys(
            d for f, d in enumerate(self.devices) if self.is_local(f)))


def most_square_factors(n: int) -> tuple[int, int]:
    """Factor ``n`` into ``(r, c)`` with ``r <= c`` and ``r*c == n``, maximally square.

    Exact semantics of ``get_2_most_closest_multipliers`` (``src/utils.c:26-37``):
    scan ``r`` downward from ``floor(sqrt(n))`` until ``n % r == 0``.
    """
    if n <= 0:
        raise ConfigError(f"device count must be positive, got {n}")
    r = int(math.isqrt(n))
    while n % r != 0:
        r -= 1
    return r, n // r


def _default_devices() -> list[torch.device]:
    # Never a quiet CPU mesh: an entry point that meant to run on the card
    # and found none must say so.
    if not torch.cuda.is_available():
        raise ConfigError(
            "no CUDA device is visible: make_mesh() builds its mesh over the "
            "CUDA devices; pass devices=[torch.device('cpu')] * p for a "
            "CPU mesh"
        )
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _take(devices: Sequence[torch.device], n_devices: int) -> dict:
    """The mesh's first ``n_devices`` devices of the global list, and their
    owners where the world has several processes: each passes its own
    local list, the same length everywhere, and the global list is those
    lists in rank order (the names of another process's devices are this
    one's at the same local index)."""
    from .distributed import process_count, process_index

    world = process_count()
    local = [torch.device(d) for d in devices]
    if n_devices > len(local) * world:
        raise ConfigError(
            f"requested {n_devices} devices but only {len(local) * world} "
            "available"
        )
    taken = tuple((local * world)[:n_devices])
    if world == 1:
        return {"devices": taken}
    owners = tuple(f // len(local) for f in range(n_devices))
    if len(set(owners)) != world:
        raise ConfigError(
            f"a mesh of {n_devices} devices leaves some of the {world} "
            f"processes without one ({len(local)} local devices each): every "
            "process of the world must own a shard"
        )
    return {"devices": taken, "owners": owners, "rank": process_index()}


def make_mesh(
    n_devices: int | None = None,
    *,
    shape: tuple[int, int] | None = None,
    devices: Sequence[torch.device] | None = None,
) -> Mesh:
    """Build a 2-D mesh over the first ``n_devices`` devices.

    * ``shape=(r, c)`` pins the grid; otherwise the most-square factorization
      of ``n_devices`` is used (reference ``src/utils.c:26-37``).
    * ``devices`` overrides the device list — the CUDA devices by default.
      Repeating a device gives logical shards on it (tests pass
      ``[torch.device("cpu")] * p``).
    * In a world of several processes ``devices`` is this process's local
      list; the mesh runs over the processes' lists in rank order.
    """
    if devices is None:
        devices = _default_devices()
    if n_devices is None:
        if shape is not None:
            n_devices = math.prod(shape)
        else:
            from .distributed import process_count

            n_devices = len(devices) * process_count()
    taken = _take(devices, n_devices)
    if shape is None:
        shape = most_square_factors(n_devices)
    r, c = shape
    if r * c != n_devices:
        raise ConfigError(f"mesh shape {shape} does not cover {n_devices} devices")
    return Mesh(grid=(r, c), **taken)


def make_1d_mesh(
    n_devices: int | None = None,
    *,
    devices: Sequence[torch.device] | None = None,
) -> Mesh:
    """A flat 1-D mesh, the analog of the reference's flat MPI_COMM_WORLD
    used by rowwise/colwise (``src/multiplier_rowwise.c:68-69``)."""
    if devices is None:
        devices = _default_devices()
    if n_devices is None:
        from .distributed import process_count

        n_devices = len(devices) * process_count()
    return Mesh(grid=(n_devices,), axis_names=(MESH_AXIS_ROWS,),
                **_take(devices, n_devices))


def mesh_grid_shape(mesh: Mesh) -> tuple[int, int]:
    """Return the (rows, cols) grid shape of a 1-D or 2-D mesh."""
    if len(mesh.axis_names) == 1:
        return 1, mesh.size
    return mesh.grid[0], mesh.grid[1]


# ---- placement ----

def _axes(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _axes_size(mesh: Mesh, axes: tuple[str, ...]) -> int:
    return math.prod(mesh.shape[a] for a in axes)


def _axis_index(mesh: Mesh, flat: int, axes: tuple[str, ...]) -> int:
    """Index of device ``flat`` along ``axes`` taken together, row-major."""
    coords = mesh.coords(flat)
    index = 0
    for a in axes:
        index = index * mesh.shape[a] + coords[a]
    return index


@dataclasses.dataclass(frozen=True)
class ShardedTensor:
    """A global tensor held as one shard per mesh device (flat mesh order)."""

    shards: tuple[torch.Tensor, ...]
    shape: tuple[int, ...]
    spec: tuple
    mesh: Mesh

    @property
    def dtype(self) -> torch.dtype:
        return self.shards[0].dtype


def shard(t: torch.Tensor, spec: tuple, mesh: Mesh) -> ShardedTensor:
    """Cut ``t`` by ``spec`` into one contiguous shard per mesh device.

    The ``device_put``-with-``NamedSharding`` analog. A replicated block is
    copied once per distinct device, not once per logical shard. Over
    several processes only the local shards are cut; another process's
    shard is its ``meta`` placeholder.
    """
    if len(spec) > t.dim():
        raise ConfigError(f"spec {spec} has more entries than {t.dim()} dims")
    copies: dict[tuple, torch.Tensor] = {}
    shards = []
    for f, dev in enumerate(mesh.devices):
        index = []
        for d, entry in enumerate(spec):
            axes = _axes(entry)
            if not axes:
                index.append(slice(None))
                continue
            size = t.shape[d] // _axes_size(mesh, axes)
            i = _axis_index(mesh, f, axes)
            index.append(slice(i * size, (i + 1) * size))
        if not mesh.is_local(f):
            shards.append(_placeholder(t[tuple(index)]))
            continue
        key = (tuple((s.start, s.stop) for s in index), dev)
        if key not in copies:
            copies[key] = t[tuple(index)].contiguous().to(dev)
        shards.append(copies[key])
    return ShardedTensor(tuple(shards), tuple(t.shape), tuple(spec), mesh)


def unshard(st: ShardedTensor) -> torch.Tensor:
    """The global tensor on the mesh's first device (the all-gather). Over
    several processes every process gets it, on its first device (the
    names of the global list's first devices are every process's own)."""
    mesh = st.mesh
    dev0 = mesh.devices[0]
    counts = [_axes_size(mesh, _axes(e)) for e in st.spec]
    counts += [1] * (len(st.shape) - len(counts))
    blocks: dict[tuple, torch.Tensor] = {}
    keys = [
        tuple(_axis_index(mesh, f, _axes(e)) for e in st.spec)
        + (0,) * (len(st.shape) - len(st.spec))
        for f in range(mesh.size)
    ]
    if mesh.spans_processes:
        blocks = _gather_blocks(st.shards, mesh, keys)
    else:
        for f, key in enumerate(keys):
            blocks.setdefault(key, st.shards[f])

    def assemble(prefix: tuple, d: int) -> torch.Tensor:
        if d == len(counts):
            return blocks[prefix].to(dev0)
        parts = [assemble(prefix + (i,), d + 1) for i in range(counts[d])]
        return parts[0] if len(parts) == 1 else torch.cat(parts, dim=d)

    return assemble((), 0)


# ---- exchange between processes ----

def _placeholder(t: torch.Tensor) -> torch.Tensor:
    """Another process's block: its shape and dtype, no data."""
    return torch.empty(t.shape, dtype=t.dtype, device="meta")


def _cut(t: torch.Tensor, cut) -> torch.Tensor:
    """``cut`` of a block: None (the whole block) or ``(dim, start, length)``."""
    return t if cut is None else t.narrow(*cut)


def _exchange(blocks: Sequence[torch.Tensor], mesh: Mesh, wants) -> dict:
    """Move the pieces a collective needs between processes.

    ``wants`` lists ``(f, q, cut)``: process ``q`` needs ``cut`` of block
    ``f``. Every process passes the same list in the same order (it is a
    function of the mesh and the shapes alone). The owner of ``f`` sends
    the piece, staged through host memory, and ``q`` receives it into a
    buffer sized from its placeholder; pairs within one process move
    nothing. Returns ``{(f, cut): piece}`` for the pieces this process
    received, on its first device."""
    import torch.distributed as dist

    me = mesh.rank
    sends, recvs = [], []
    for tag, (f, q, cut) in enumerate(wants):
        src = mesh.owners[f]
        if src == q:
            continue
        if src == me:
            buf = _cut(blocks[f], cut).detach().to("cpu").contiguous()
            sends.append((dist.isend(buf, dst=q, tag=tag), buf))
        elif q == me:
            like = _cut(blocks[f], cut)
            buf = torch.empty(like.shape, dtype=like.dtype)
            recvs.append(((f, cut), dist.irecv(buf, src=src, tag=tag), buf))
    got = {}
    for key, work, buf in recvs:
        work.wait()
        got[key] = buf.to(mesh.devices[0])
    for work, _ in sends:
        work.wait()
    return got


def _piece(blocks, got: dict, mesh: Mesh, f: int, cut=None) -> torch.Tensor:
    """``cut`` of block ``f``: the local block's, or the received copy."""
    return _cut(blocks[f], cut) if mesh.is_local(f) else got[(f, cut)]


def _gather_blocks(shards, mesh: Mesh, keys: list) -> dict:
    """Every distinct block of a sharded tensor on this process (unshard's
    exchange): a local replica where there is one, else a copy received
    from the first index that holds the block."""
    first: dict[tuple, int] = {}
    held: dict[tuple, set] = {}
    for f, key in enumerate(keys):
        first.setdefault(key, f)
        held.setdefault(key, set()).add(mesh.owners[f])
    procs = sorted(set(mesh.owners))
    wants = [(f, q, None) for key, f in first.items()
             for q in procs if q not in held[key]]
    got = _exchange(shards, mesh, wants)
    blocks = {}
    for key, f in first.items():
        local = [g for g, k in enumerate(keys) if k == key and mesh.is_local(g)]
        blocks[key] = shards[local[0]] if local else got[(f, None)]
    return blocks


# ---- collectives ----

def _reduce_groups(mesh: Mesh, axes: tuple[str, ...]):
    """Devices that reduce together, each group in reduced-index order."""
    groups: dict[tuple, list[tuple[int, int]]] = {}
    for f in range(mesh.size):
        coords = mesh.coords(f)
        key = tuple(coords[a] for a in mesh.axis_names if a not in axes)
        groups.setdefault(key, []).append((_axis_index(mesh, f, axes), f))
    return [sorted(members) for members in groups.values()]


def _ordered_sum(parts: list[torch.Tensor], device: torch.device) -> torch.Tensor:
    total = parts[0].to(device)
    for part in parts[1:]:
        total = total + part.to(device)
    return total


def psum(blocks: Sequence[torch.Tensor], mesh: Mesh, axes) -> list[torch.Tensor]:
    """``lax.psum`` over ``axes``: every device gets the sum of its group,
    taken in shard-index order 0…n−1."""
    axes = _axes(axes)
    if mesh.spans_processes:
        return _psum_processes(blocks, mesh, axes, scatter=False)
    out: list[torch.Tensor] = [None] * mesh.size  # type: ignore[list-item]
    for members in _reduce_groups(mesh, axes):
        first = members[0][1]
        total = _ordered_sum([blocks[f] for _, f in members], mesh.devices[first])
        for _, f in members:
            out[f] = total.to(mesh.devices[f])
    return out


def _psum_processes(blocks, mesh: Mesh, axes: tuple[str, ...], *,
                    scatter: bool) -> list[torch.Tensor]:
    """:func:`psum` / :func:`psum_scatter` over several processes: each
    process receives its groups' blocks (for the scatter, only the row
    chunks of its own members), then sums every member's contribution in
    shard-index order, as one process does. A group with no local member
    yields placeholders."""
    n = _axes_size(mesh, axes)
    groups = _reduce_groups(mesh, axes)

    def cut(members, i):
        if not scatter:
            return None
        rows = blocks[members[0][1]].shape[0] // n
        return (0, i * rows, rows)

    wants = list(dict.fromkeys(
        (fj, mesh.owners[fi], cut(members, i))
        for members in groups for i, fi in members for _, fj in members
    ))
    got = _exchange(blocks, mesh, wants)
    out: list[torch.Tensor] = [None] * mesh.size  # type: ignore[list-item]
    for members in groups:
        totals: dict = {}
        for i, fi in members:
            c = cut(members, i)
            if not mesh.is_local(fi):
                parts = [_cut(blocks[fj], c).to("meta") for _, fj in members]
                out[fi] = _ordered_sum(parts, torch.device("meta"))
                continue
            if c not in totals:
                parts = [_piece(blocks, got, mesh, fj, c) for _, fj in members]
                totals[c] = _ordered_sum(parts, mesh.devices[fi])
            out[fi] = totals[c].to(mesh.devices[fi])
    return out


def psum_scatter(
    blocks: Sequence[torch.Tensor], mesh: Mesh, axes
) -> list[torch.Tensor]:
    """``lax.psum_scatter(..., tiled=True)`` over ``axes``: the group sum,
    split into equal row chunks, chunk i to the device of reduced index i."""
    axes = _axes(axes)
    if mesh.spans_processes:
        return _psum_processes(blocks, mesh, axes, scatter=True)
    n = _axes_size(mesh, axes)
    out: list[torch.Tensor] = [None] * mesh.size  # type: ignore[list-item]
    for members in _reduce_groups(mesh, axes):
        first = members[0][1]
        total = _ordered_sum([blocks[f] for _, f in members], mesh.devices[first])
        rows = total.shape[0] // n
        for i, f in members:
            out[f] = total[i * rows:(i + 1) * rows].to(mesh.devices[f])
    return out


def ppermute(
    blocks: Sequence[torch.Tensor], mesh: Mesh, axes, perm
) -> list[torch.Tensor]:
    """``lax.ppermute`` over ``axes``: within each group of devices that
    share their other coordinates, the block of reduced index ``src`` goes
    to reduced index ``dst`` for every ``(src, dst)`` in ``perm``. A device
    that receives nothing gets zeros, as in JAX."""
    axes = _axes(axes)
    if mesh.spans_processes:
        return _ppermute_processes(blocks, mesh, axes, perm)
    out: list[torch.Tensor] = [None] * mesh.size  # type: ignore[list-item]
    for members in _reduce_groups(mesh, axes):
        flat = dict(members)  # reduced index -> flat device index
        for src, dst in perm:
            out[flat[dst]] = blocks[flat[src]].to(mesh.devices[flat[dst]])
    return [torch.zeros_like(b) if o is None else o for o, b in zip(out, blocks)]


def _ppermute_processes(blocks, mesh: Mesh, axes: tuple[str, ...],
                        perm) -> list[torch.Tensor]:
    """:func:`ppermute` over several processes: a block whose destination
    another process owns is sent there."""
    groups = [dict(members) for members in _reduce_groups(mesh, axes)]
    got = _exchange(blocks, mesh, [
        (flat[src], mesh.owners[flat[dst]], None)
        for flat in groups for src, dst in perm
    ])
    out: list[torch.Tensor] = [None] * mesh.size  # type: ignore[list-item]
    for flat in groups:
        for src, dst in perm:
            fs, fd = flat[src], flat[dst]
            out[fd] = (_piece(blocks, got, mesh, fs).to(mesh.devices[fd])
                       if mesh.is_local(fd) else _placeholder(blocks[fs]))
    return [torch.zeros_like(b) if o is None else o for o, b in zip(out, blocks)]


def all_to_all(
    blocks: Sequence[torch.Tensor], mesh: Mesh, axes, split_axis: int = 0,
    concat_axis: int = 0,
) -> list[torch.Tensor]:
    """``lax.all_to_all(..., split_axis, concat_axis, tiled=True)`` over
    ``axes``: each block is cut along ``split_axis`` into n equal chunks, and
    device j gets chunk j of every device of its group, concatenated along
    ``concat_axis`` in reduced-index order. Each chunk keeps its dtype."""
    axes = _axes(axes)
    n = _axes_size(mesh, axes)
    if mesh.spans_processes:
        return _all_to_all_processes(blocks, mesh, axes, n, split_axis,
                                     concat_axis)
    out: list[torch.Tensor] = [None] * mesh.size  # type: ignore[list-item]
    for members in _reduce_groups(mesh, axes):
        size = _chunk(blocks[members[0][1]], split_axis, n, axes)
        for j, fj in members:
            dev = mesh.devices[fj]
            out[fj] = torch.cat(
                [blocks[fi].narrow(split_axis, j * size, size).to(dev)
                 for _, fi in members],
                dim=concat_axis,
            )
    return out


def _chunk(block: torch.Tensor, split_axis: int, n: int, axes) -> int:
    if block.shape[split_axis] % n:
        raise ValueError(
            f"all_to_all: split_axis {split_axis} of a block of shape "
            f"{tuple(block.shape)} is not divisible by the {n} devices of "
            f"axes {axes}"
        )
    return block.shape[split_axis] // n


def _all_to_all_processes(blocks, mesh: Mesh, axes: tuple[str, ...], n: int,
                          split_axis: int, concat_axis: int) -> list[torch.Tensor]:
    """:func:`all_to_all` over several processes: each process receives
    the chunks its own members take from the other processes' blocks."""
    groups = [(members, _chunk(blocks[members[0][1]], split_axis, n, axes))
              for members in _reduce_groups(mesh, axes)]
    got = _exchange(blocks, mesh, [
        (fi, mesh.owners[fj], (split_axis, j * size, size))
        for members, size in groups for j, fj in members for _, fi in members
    ])
    out: list[torch.Tensor] = [None] * mesh.size  # type: ignore[list-item]
    for members, size in groups:
        for j, fj in members:
            cut = (split_axis, j * size, size)
            if mesh.is_local(fj):
                parts = [_piece(blocks, got, mesh, fi, cut).to(mesh.devices[fj])
                         for _, fi in members]
            else:
                parts = [_cut(blocks[fi], cut).to("meta") for _, fi in members]
            out[fj] = torch.cat(parts, dim=concat_axis)
    return out
