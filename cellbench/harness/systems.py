"""What the generator drives: the program's entries, behind one interface.

A system turns a request payload into an answer:

- ``prepare(payload)`` once per payload of the pool, in set-up;
- ``warm(prepared)`` runs every shape the traffic will use, in set-up;
- ``request(prepared)`` starts one request and returns a handle;
- ``finish(handle)`` waits for it and returns an :class:`Answer`, or raises
  :class:`RequestFailed` for a typed failure of the program;
- ``counters()`` reads the program's own counters; ``close()`` frees it.

A system is built over the cell's cards and A. On one card A is a whole
tensor and a grid of p shards is p logical shards on that card. On several
cards the grid holds one shard a card, and A comes as its row-block source
(``operands.operand_rows``): each card's block is filled from it, so A is
never whole on one card.

The program is imported here only, inside the constructors, so the
reference and the tests of the yardstick never load it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Iterable, Sequence

import torch

from . import operands
from .spec import SpecError


@dataclass
class Payload:
    pid: int            # index in the pool: the reference keys on it
    value: torch.Tensor
    width: int          # columns the request asks for (1 for a vector)


@dataclass
class Answer:
    value: torch.Tensor
    iters: int | None = None


class RequestFailed(Exception):
    """A request that the program refused or could not answer."""


def program_mesh(cfg: dict, cards: Sequence[torch.device]):
    """The configuration's grid over the cell's cards: all its shards on
    the one card of a one-card cell, one shard a card otherwise."""
    from matvec_mpi_multiplier_torch.parallel.mesh import make_mesh

    r, c = cfg["grid"]
    if len(cards) == 1:
        devices = list(cards) * (r * c)
    elif r * c == len(cards):
        devices = list(cards)
    else:
        raise SpecError(f"a {r}x{c} grid does not cover the cell's {len(cards)} cards, "
                        "one shard a card")
    return make_mesh(r * c, shape=(r, c), devices=devices)


def block_ranges(spec: tuple, shape: tuple, mesh) -> list[tuple[slice, ...]]:
    """Each mesh device's index into a tensor of ``shape`` placed by
    ``spec``, cut as ``parallel/mesh.py::shard`` cuts it: a dimension split
    over mesh axes into equal parts, the device's part by its row-major
    index along those axes."""
    out = []
    for f in range(mesh.size):
        coords = mesh.coords(f)
        index = []
        for d, size in enumerate(shape):
            entry = spec[d] if d < len(spec) else None
            axes = () if entry is None else (entry,) if isinstance(entry, str) else entry
            parts, i = 1, 0
            for axis in axes:
                parts *= mesh.shape[axis]
                i = i * mesh.shape[axis] + coords[axis]
            step = size // parts
            index.append(slice(i * step, (i + 1) * step))
        out.append(tuple(index))
    return out


def place_rows(rows: Iterable, spec: tuple, shape: tuple, dtype: torch.dtype, mesh):
    """A placed by ``spec`` from its row blocks ``(row0, block)``: each
    device's contiguous block allocated on its device and filled from every
    row block's slice, the row block freed after. A replicated block is
    made once a device, as ``shard`` makes it."""
    from matvec_mpi_multiplier_torch.parallel.mesh import ShardedTensor

    keys = [(tuple((s.start, s.stop) for s in index), dev)
            for index, dev in zip(block_ranges(spec, shape, mesh), mesh.devices)]
    blocks = {}
    for key in keys:
        if key not in blocks:
            blocks[key] = torch.empty([stop - start for start, stop in key[0]],
                                      dtype=dtype, device=key[1])
    for row0, chunk in rows:
        row1 = row0 + chunk.shape[0]
        for ((rows_at, cols_at), _), blk in blocks.items():
            lo, hi = max(row0, rows_at[0]), min(row1, rows_at[1])
            if lo < hi:
                blk[lo - rows_at[0]:hi - rows_at[0]].copy_(
                    chunk[lo - row0:hi - row0, cols_at[0]:cols_at[1]])
        del chunk
    return ShardedTensor(tuple(blocks[key] for key in keys), tuple(shape), tuple(spec), mesh)


class StrategyStream:
    """The strategy's matvec entry, the one ``bench/sweep.py`` times:
    ``strategy.build(mesh)`` called on placed operands, no sync a call.
    A whole A is placed by ``strategy.place``; A's row-block source is
    placed by the strategy's A spec straight onto the cards, and x by the
    program's ``shard``."""

    def __init__(self, cfg: dict, traffic: dict, cards: Sequence[torch.device], a):
        from matvec_mpi_multiplier_torch.models import get_strategy

        self.mesh = program_mesh(cfg, cards)
        self.strategy = get_strategy(cfg["strategy"])
        self.fn = self.strategy.build(self.mesh)
        self.cards = cards
        self.device = cards[0]
        self.a = self.a_placed = None
        if isinstance(a, torch.Tensor):
            self.a = a
        else:
            shape = (cfg["m"], cfg["k"])
            self.strategy.validate(*shape, self.mesh)
            self.a_placed = place_rows(a, self.strategy.specs(self.mesh)[0], shape,
                                       operands.torch_dtype(cfg["dtype"]), self.mesh)

    def prepare(self, payload: Payload) -> Any:
        from matvec_mpi_multiplier_torch.parallel.mesh import shard

        x = payload.value.reshape(-1).to(self.device)
        if self.a is None:
            return shard(x, self.strategy.specs(self.mesh)[1], self.mesh)
        a_placed, x_placed = self.strategy.place(self.a, x, self.mesh)
        self.a_placed = a_placed
        return x_placed

    def warm(self, prepared: list) -> None:
        for x in prepared:
            self.fn(self.a_placed, x)
        synchronize(self.cards)

    def request(self, x) -> torch.Tensor:
        return self.fn(self.a_placed, x)

    def finish(self, y: torch.Tensor) -> Answer:
        return Answer(y)

    def counters(self) -> dict:
        return {}

    def close(self) -> None:
        self.fn = self.a = self.a_placed = None


class _EngineSystem:
    def __init__(self, cfg: dict, traffic: dict, cards: Sequence[torch.device], a):
        if not isinstance(a, torch.Tensor):
            raise SpecError(f"the engine takes a whole A, which a cell on {len(cards)} cards "
                            "never holds on one card: an engine entry runs on one card")
        from matvec_mpi_multiplier_torch.engine import MatvecEngine
        from matvec_mpi_multiplier_torch.utils.errors import MatvecError

        self.failure_types = (MatvecError,)
        self.engine = MatvecEngine(a, program_mesh(cfg, cards),
                                   strategy=cfg["strategy"], **traffic.get("engine", {}))
        self.cards = cards

    def prepare(self, payload: Payload) -> Any:
        return payload.value

    def counters(self) -> dict:
        stats = self.engine.stats
        return {"builds": stats.compiles, "hits": stats.hits,
                "dispatches": stats.dispatches, "cols": stats.cols}

    def close(self) -> None:
        self.engine.close()
        self.engine = None


class EngineMatvec(_EngineSystem):
    """``MatvecEngine.submit(X).result()``: blocks of right-hand sides
    routed by the engine (per column below ``b*``, bucketed GEMMs above)."""

    def warm(self, prepared: list) -> None:
        self.engine.warmup(sorted({1 if x.dim() == 1 else x.shape[1] for x in prepared}))
        for x in prepared:
            self.engine.submit(x).result()
        synchronize(self.cards)

    def request(self, x):
        try:
            return self.engine.submit(x)
        except self.failure_types as exc:
            raise RequestFailed(repr(exc)) from exc

    def finish(self, fut) -> Answer:
        try:
            return Answer(fut.result())
        except self.failure_types as exc:
            raise RequestFailed(repr(exc)) from exc


class EngineSolve(_EngineSystem):
    """``MatvecEngine.submit(op=..., rhs=b, rtol=...).result()``: a served
    solve on the engine's default solver tier and ``maxiter``."""

    def __init__(self, cfg: dict, traffic: dict, cards: Sequence[torch.device], a):
        super().__init__(cfg, traffic, cards, a)
        self.op = traffic["op"]
        self.rtol = cfg["rtol"]

    def warm(self, prepared: list) -> None:
        # The warm solve's job is the build: a typed failure counts in the
        # window's solves, not here (as ``run_serve_solver`` tolerates it).
        try:
            self.finish(self.request(prepared[0]))
        except RequestFailed:
            pass
        synchronize(self.cards)

    def request(self, b):
        try:
            return self.engine.submit(op=self.op, rhs=b, rtol=self.rtol)
        except self.failure_types as exc:
            raise RequestFailed(repr(exc)) from exc

    def finish(self, fut) -> Answer:
        try:
            res = fut.result()
        except self.failure_types as exc:
            raise RequestFailed(repr(exc)) from exc
        return Answer(res.x, iters=int(res.n_iters))


PROGRAMS = {
    ("strategy", "matvec"): StrategyStream,
    ("engine", "matvec"): EngineMatvec,
    ("engine", "cg"): EngineSolve,
}


def program_system(cfg: dict, traffic: dict, cards: Sequence[torch.device], a):
    key = (traffic["entry"], traffic["op"])
    if key not in PROGRAMS:
        raise ValueError(f"no program entry for {key}; known: {sorted(PROGRAMS)}")
    return PROGRAMS[key](cfg, traffic, cards, a)


def synchronize(cards: Sequence[torch.device]) -> None:
    """Wait for the work queued on each of the cell's cards."""
    for card in cards:
        if card.type == "cuda":
            torch.cuda.synchronize(card)
