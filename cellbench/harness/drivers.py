"""The general generator: builds a traffic mix's payloads from its data
file and drives a system with them for ``seconds``.

Two drivers, chosen by the traffic file's ``driver``:

- ``stream``: one caller starts requests back to back, with no wait a
  request, and the window closes with a synchronize of each of the cell's
  cards. ``ms_per_call``
  is the whole window (first call to the closing synchronize) over the
  calls made.
- ``closed_loop``: ``clients`` threads, each ``request`` then ``finish`` and
  again (the serve bench's ``_closed_loop``, bounded by time instead of by
  a count). A client starts no request after the close and finishes the one
  it holds. Rates are all the work over all the time, from the open to the
  last answer; tails are over every request of the window.

Request ``i`` takes pool entry ``order[i % len(order)]``; client ``t``
takes requests ``t, t + clients, ...``. Answers of the requests that the
seeded sample picks are kept for the check.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field

import numpy as np

from . import operands
from .stats import percentile
from .systems import Payload, RequestFailed, synchronize

# Requests drawn ahead: the order and the sample wrap around after this.
ORDER_LENGTH = 1 << 17


@dataclass
class Pool:
    payloads: list          # Payload
    warm_extra: list        # Payload: set-up warms with these, or the pool
    order: np.ndarray       # pool index of request i (modulo its length)
    keep: np.ndarray        # bool: request i's answer is checked


def make_pool(traffic: dict, cfg: dict, seed: int) -> Pool:
    """The traffic's payloads, made on the host from the seed (the serve
    bench's seed offsets: payloads ``seed + 1``, their order ``seed + 2``;
    the check's sample ``seed + 3``)."""
    spec = traffic["payload"]
    dtype = operands.torch_dtype(cfg["dtype"])
    k = cfg["k"]
    if spec["draw"] == "uniform_0_10":
        blocks = operands.request_pool(k, spec["widths"], dtype, seed + 1)
        if spec.get("split_columns"):
            (block,) = blocks.values()
            payloads = [Payload(j, block[:, j].clone(), 1) for j in range(block.shape[1])]
        else:
            payloads = [Payload(j, blk, w) for j, (w, blk) in enumerate(blocks.items())]
        warm_extra = []
    elif spec["draw"] == "standard_normal":
        vecs = operands.rhs_pool(k, spec["pool"] + 1, dtype, seed + 1)
        payloads = [Payload(j, v, 1) for j, v in enumerate(vecs[:-1])]
        warm_extra = [Payload(len(payloads), vecs[-1], 1)]
    else:
        raise ValueError(f"unknown payload draw {spec['draw']!r}")
    if spec.get("order") == "balanced":
        order = balanced_order(len(payloads), traffic.get("clients", 1), ORDER_LENGTH, seed + 2)
    else:
        order = np.arange(ORDER_LENGTH) % len(payloads)
    rng = np.random.default_rng(operands.norm_seed(seed + 3))
    keep = rng.random(ORDER_LENGTH) < 1.0 / traffic.get("check_one_in", 1)
    return Pool(payloads, warm_extra, order, keep)


def balanced_order(n: int, clients: int, length: int, seed: int) -> np.ndarray:
    """Pool indices for ``length`` requests such that every client's run of
    ``n`` consecutive requests (client ``t`` takes ``t, t + clients, ...``)
    holds each payload once, in an order drawn from the seed. So every seed
    asks for the same mix of work, whatever window a run reaches."""
    rng = np.random.default_rng(operands.norm_seed(seed))
    per_client = -(-length // clients)
    rounds = -(-per_client // n)
    seqs = np.stack([np.concatenate([rng.permutation(n) for _ in range(rounds)])[:per_client]
                     for _ in range(clients)])
    return seqs.T.reshape(-1)[:length]


@dataclass
class Record:
    """What a window did: one entry a request, in start order per client."""
    index: list = field(default_factory=list)
    pid: list = field(default_factory=list)
    width: list = field(default_factory=list)
    start: list = field(default_factory=list)
    submitted: list = field(default_factory=list)
    done: list = field(default_factory=list)
    iters: list = field(default_factory=list)
    failed: int = 0
    failures: list = field(default_factory=list)
    kept: list = field(default_factory=list)   # (index, pid, Answer)
    opened: float = 0.0
    closed: float = 0.0

    @property
    def attempted(self) -> int:
        return len(self.index) + self.failed

    def quantities(self) -> dict:
        """The window's end-to-end quantities, by the names a traffic file's
        ``report`` maps metrics to: all the work over all the time, and the
        tail over every request."""
        n = len(self.index)
        span = self.closed - self.opened
        if n == 0 or span <= 0:
            return {}
        out = {"ms_per_call": span * 1e3 / n, "cols_per_s": sum(self.width) / span}
        if self.done:
            out["latency_p95_ms"] = percentile(
                [(d - s) * 1e3 for s, d in zip(self.start, self.done)], 95)
        return out


def _stream(system, prepared: list, pool: Pool, seconds: float, cards, span) -> Record:
    rec = Record()
    order, keep, n_order = pool.order, pool.keep, len(pool.order)
    calls = []
    with span("cellbench.window"):
        rec.opened = t_close = time.perf_counter()
        t_close += seconds
        i = 0
        with span("cellbench.enqueue"):
            while time.perf_counter() < t_close:
                pid = int(order[i % n_order])
                y = system.request(prepared[pid])
                if keep[i % n_order]:
                    rec.kept.append((i, pid, system.finish(y)))
                calls.append(pid)
                i += 1
        with span("cellbench.synchronize"):
            synchronize(cards)
        rec.closed = time.perf_counter()
    rec.index = list(range(len(calls)))
    rec.pid = calls
    rec.width = [pool.payloads[p].width for p in calls]
    return rec


def _closed_loop(system, prepared: list, pool: Pool, seconds: float, clients: int,
                 span) -> Record:
    order, keep, n_order = pool.order, pool.keep, len(pool.order)
    per_client = [Record() for _ in range(clients)]
    errors: list[BaseException] = []
    barrier = threading.Barrier(clients + 1)
    t_close = [0.0]

    def client(t: int) -> None:
        rec = per_client[t]
        try:
            barrier.wait()
            i = t
            while time.perf_counter() < t_close[0]:
                pid = int(order[i % n_order])
                t0 = time.perf_counter()
                try:
                    with span("cellbench.submit"):
                        handle = system.request(prepared[pid])
                    t1 = time.perf_counter()
                    with span("cellbench.result"):
                        answer = system.finish(handle)
                except RequestFailed as exc:
                    rec.failed += 1
                    rec.failures.append(str(exc))
                    i += clients
                    continue
                t2 = time.perf_counter()
                rec.index.append(i)
                rec.pid.append(pid)
                rec.width.append(pool.payloads[pid].width)
                rec.start.append(t0)
                rec.submitted.append(t1)
                rec.done.append(t2)
                rec.iters.append(answer.iters)
                if keep[i % n_order]:
                    rec.kept.append((i, pid, answer))
                i += clients
        except BaseException as exc:  # surfaced on the calling thread
            errors.append(exc)

    threads = [threading.Thread(target=client, args=(t,), daemon=True)
               for t in range(clients)]
    for th in threads:
        th.start()
    with span("cellbench.window"):
        opened = time.perf_counter()
        t_close[0] = opened + seconds
        barrier.wait()
        for th in threads:
            th.join()
    if errors:
        raise errors[0]
    rec = Record(opened=opened)
    for r in per_client:
        for name in ("index", "pid", "width", "start", "submitted", "done", "iters",
                     "failures", "kept"):
            getattr(rec, name).extend(getattr(r, name))
        rec.failed += r.failed
    rec.closed = max(rec.done, default=opened)
    return rec


def drive(traffic: dict, system, prepared: list, pool: Pool, seconds: float,
          cards: list, span) -> Record:
    """Run the traffic's driver for ``seconds`` over the cell's ``cards``;
    ``span(name)`` is a context manager that marks the harness's phases (a
    no-op when not traced)."""
    if traffic["driver"] == "stream":
        return _stream(system, prepared, pool, seconds, cards, span)
    if traffic["driver"] == "closed_loop":
        return _closed_loop(system, prepared, pool, seconds, traffic["clients"], span)
    raise ValueError(f"unknown driver {traffic['driver']!r}")


def prepare_all(system, pool: Pool) -> tuple[list, list]:
    """The system's prepared payloads, and those set-up warms with."""
    prepared = [system.prepare(p) for p in pool.payloads]
    return prepared, [system.prepare(p) for p in pool.warm_extra] or prepared

