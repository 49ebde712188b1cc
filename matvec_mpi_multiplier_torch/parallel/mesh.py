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
* :func:`all_to_all` sends row chunk j of shard i to shard j.

No collective here reads a value back to the host.
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

    def distinct_devices(self) -> list[torch.device]:
        return list(dict.fromkeys(self.devices))


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


def _take(devices: Sequence[torch.device], n_devices: int) -> tuple:
    if n_devices > len(devices):
        raise ConfigError(
            f"requested {n_devices} devices but only {len(devices)} available"
        )
    return tuple(torch.device(d) for d in devices[:n_devices])


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
    """
    if devices is None:
        devices = _default_devices()
    if n_devices is None:
        n_devices = math.prod(shape) if shape is not None else len(devices)
    taken = _take(devices, n_devices)
    if shape is None:
        shape = most_square_factors(n_devices)
    r, c = shape
    if r * c != n_devices:
        raise ConfigError(f"mesh shape {shape} does not cover {n_devices} devices")
    return Mesh(taken, (r, c))


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
        n_devices = len(devices)
    return Mesh(_take(devices, n_devices), (n_devices,), (MESH_AXIS_ROWS,))


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
    copied once per distinct device, not once per logical shard.
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
        key = (tuple((s.start, s.stop) for s in index), dev)
        if key not in copies:
            copies[key] = t[tuple(index)].contiguous().to(dev)
        shards.append(copies[key])
    return ShardedTensor(tuple(shards), tuple(t.shape), tuple(spec), mesh)


def unshard(st: ShardedTensor) -> torch.Tensor:
    """The global tensor on the mesh's first device (the all-gather)."""
    mesh = st.mesh
    dev0 = mesh.devices[0]
    counts = [_axes_size(mesh, _axes(e)) for e in st.spec]
    counts += [1] * (len(st.shape) - len(counts))
    blocks: dict[tuple, torch.Tensor] = {}
    for f in range(mesh.size):
        key = tuple(
            _axis_index(mesh, f, _axes(e)) for e in st.spec
        ) + (0,) * (len(st.shape) - len(st.spec))
        blocks.setdefault(key, st.shards[f])

    def assemble(prefix: tuple, d: int) -> torch.Tensor:
        if d == len(counts):
            return blocks[prefix].to(dev0)
        parts = [assemble(prefix + (i,), d + 1) for i in range(counts[d])]
        return parts[0] if len(parts) == 1 else torch.cat(parts, dim=d)

    return assemble((), 0)


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
    out: list[torch.Tensor] = [None] * mesh.size  # type: ignore[list-item]
    for members in _reduce_groups(mesh, axes):
        first = members[0][1]
        total = _ordered_sum([blocks[f] for _, f in members], mesh.devices[first])
        for _, f in members:
            out[f] = total.to(mesh.devices[f])
    return out


def psum_scatter(
    blocks: Sequence[torch.Tensor], mesh: Mesh, axes
) -> list[torch.Tensor]:
    """``lax.psum_scatter(..., tiled=True)`` over ``axes``: the group sum,
    split into equal row chunks, chunk i to the device of reduced index i."""
    axes = _axes(axes)
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
    out: list[torch.Tensor] = [None] * mesh.size  # type: ignore[list-item]
    for members in _reduce_groups(mesh, axes):
        flat = dict(members)  # reduced index -> flat device index
        for src, dst in perm:
            out[flat[dst]] = blocks[flat[src]].to(mesh.devices[flat[dst]])
    return [torch.zeros_like(b) if o is None else o for o, b in zip(out, blocks)]


def all_to_all(
    blocks: Sequence[torch.Tensor], mesh: Mesh, axes
) -> list[torch.Tensor]:
    """``lax.all_to_all(..., split_axis=0, concat_axis=0, tiled=True)`` over
    ``axes``: each block is cut into n equal row chunks, and device j gets
    chunk j of every device of its group, concatenated in reduced-index
    order."""
    axes = _axes(axes)
    n = _axes_size(mesh, axes)
    out: list[torch.Tensor] = [None] * mesh.size  # type: ignore[list-item]
    for members in _reduce_groups(mesh, axes):
        rows = blocks[members[0][1]].shape[0] // n
        for j, fj in members:
            dev = mesh.devices[fj]
            out[fj] = torch.cat(
                [blocks[fi][j * rows:(j + 1) * rows].to(dev) for _, fi in members]
            )
    return out
