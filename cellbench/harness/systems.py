"""What the generator drives: the program's entries, behind one interface.

A system turns a request payload into an answer:

- ``prepare(payload)`` once per payload of the pool, in set-up;
- ``warm(prepared)`` runs every shape the traffic will use, in set-up;
- ``request(prepared)`` starts one request and returns a handle;
- ``finish(handle)`` waits for it and returns an :class:`Answer`, or raises
  :class:`RequestFailed` for a typed failure of the program;
- ``counters()`` reads the program's own counters; ``close()`` frees it.

The program is imported here only, inside the constructors, so the
reference and the tests of the yardstick never load it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch


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


def program_mesh(cfg: dict, device: torch.device):
    from matvec_mpi_multiplier_torch.parallel.mesh import make_mesh

    r, c = cfg["grid"]
    return make_mesh(r * c, shape=(r, c), devices=[device] * (r * c))


class StrategyStream:
    """The strategy's matvec entry, the one ``bench/sweep.py`` times:
    ``strategy.build(mesh)`` called on placed operands, no sync a call."""

    def __init__(self, cfg: dict, traffic: dict, device: torch.device, a: torch.Tensor):
        from matvec_mpi_multiplier_torch.models import get_strategy

        self.mesh = program_mesh(cfg, device)
        self.strategy = get_strategy(cfg["strategy"])
        self.fn = self.strategy.build(self.mesh)
        self.a = a
        self.a_placed = None
        self.device = device

    def prepare(self, payload: Payload) -> Any:
        x = payload.value.reshape(-1).to(self.device)
        a_placed, x_placed = self.strategy.place(self.a, x, self.mesh)
        self.a_placed = a_placed
        return x_placed

    def warm(self, prepared: list) -> None:
        for x in prepared:
            self.fn(self.a_placed, x)
        synchronize(self.device)

    def request(self, x) -> torch.Tensor:
        return self.fn(self.a_placed, x)

    def finish(self, y: torch.Tensor) -> Answer:
        return Answer(y)

    def counters(self) -> dict:
        return {}

    def close(self) -> None:
        self.fn = self.a = self.a_placed = None


class _EngineSystem:
    def __init__(self, cfg: dict, traffic: dict, device: torch.device, a: torch.Tensor):
        from matvec_mpi_multiplier_torch.engine import MatvecEngine
        from matvec_mpi_multiplier_torch.utils.errors import MatvecError

        self.failure_types = (MatvecError,)
        self.engine = MatvecEngine(a, program_mesh(cfg, device),
                                   strategy=cfg["strategy"], **traffic.get("engine", {}))
        self.device = device

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
        synchronize(self.device)

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

    def __init__(self, cfg: dict, traffic: dict, device: torch.device, a: torch.Tensor):
        super().__init__(cfg, traffic, device, a)
        self.op = traffic["op"]
        self.rtol = cfg["rtol"]

    def warm(self, prepared: list) -> None:
        # The warm solve's job is the build: a typed failure counts in the
        # window's solves, not here (as ``run_serve_solver`` tolerates it).
        try:
            self.finish(self.request(prepared[0]))
        except RequestFailed:
            pass
        synchronize(self.device)

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


def program_system(cfg: dict, traffic: dict, device: torch.device, a: torch.Tensor):
    key = (traffic["entry"], traffic["op"])
    if key not in PROGRAMS:
        raise ValueError(f"no program entry for {key}; known: {sorted(PROGRAMS)}")
    return PROGRAMS[key](cfg, traffic, device, a)


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
