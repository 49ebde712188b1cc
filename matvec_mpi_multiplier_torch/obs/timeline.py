"""Correlated event timeline: one causally ordered stream for the stack.

The port's copy of the JAX package's ``obs/timeline.py``. Request span trees
(``tracing.py``), scheduler decisions and dispatch failures each tell their
own story; this module is the shared key plus the shared stream:

* **Correlation ids.** :func:`next_request_id` hands out process-unique
  request ids; :func:`bind_request` binds one to the current thread so
  every event emitted anywhere below the binding (the engine's dispatch,
  the events fired from inside it) carries it without call-site plumbing.
  The engine's tracer adopts a bound id for its trace records too, so the
  span tree and the event stream share the key.

* **The hub.** :class:`TimelineHub` is a bounded in-memory ring plus an
  optional JSONL sink plus zero or more in-process subscribers (the flight
  recorder, ``flight.py``). Emission is safe on the dispatch path: one
  dict, one ``deque.append`` and, with a sink, one ``SimpleQueue.put`` —
  no locks, no file handles, no host sync (``sink.py`` owns the file I/O).

* **The contract.** Every event carries ``request_id`` (the request it
  belongs to) or ``cause_id`` (the request that triggered a background
  action). Batch events also carry ``members`` (the coalesced request ids),
  which is how a member finds the batch it rode in
  (:func:`related_events`).

Event vocabulary (open; the kinds the port emits today): ``submit``,
``bypass``, ``coalesce``, ``retry``, ``degrade``, ``breaker_open``,
``breaker_close``, ``deadline_failed``, ``dispatch_failed``,
``integrity_refused``, ``solver_diverged``, ``batch_failure``,
``isolated_failure``, ``bisect``.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from collections import deque
from typing import Any, Callable, Iterable

__all__ = [
    "FAILURE_KINDS",
    "TimelineHub",
    "bind_request",
    "bound_request_id",
    "get_hub",
    "next_request_id",
    "related_events",
    "reset_hub",
]

# The typed-failure kinds: the flight recorder (``flight.py``) dumps on these.
FAILURE_KINDS = frozenset({
    "breaker_open",
    "solver_diverged",
    "batch_failure",
    "isolated_failure",
    "integrity_refused",
    "deadline_failed",
    "dispatch_failed",
})

# Process-unique request ids: ONE counter for every layer. The scheduler
# allocates at admission; the engine allocates for direct (unscheduled)
# submits; a bare RequestTracer outside an engine falls back to its own
# local numbering.
_request_ids = itertools.count(1)

_tls = threading.local()


def next_request_id() -> int:
    """A process-unique correlation id (``itertools.count`` — GIL-atomic,
    safe from any thread)."""
    return next(_request_ids)


def bound_request_id() -> int | None:
    """The request id bound to the current thread, or None."""
    return getattr(_tls, "rid", None)


@contextlib.contextmanager
def bind_request(request_id: int | None):
    """Bind ``request_id`` to the current thread for the duration of the
    block. Everything emitted below the binding — nested dispatches,
    retries, breaker callbacks fired synchronously from inside the
    dispatch — picks the id up via :func:`bound_request_id` without any
    argument threading. Bindings nest (the previous binding is restored
    on exit); binding ``None`` is a no-op passthrough."""
    prev = getattr(_tls, "rid", None)
    _tls.rid = request_id if request_id is not None else prev
    try:
        yield request_id
    finally:
        _tls.rid = prev


# Events the hub's in-memory ring keeps (the sink, when armed, keeps all).
HUB_CAPACITY = 4096


class TimelineHub:
    """The unified event stream: bounded ring + optional JSONL sink +
    in-process subscribers.

    ``emit`` is called from dispatch paths, so it stays bookkeeping
    only: no locks of its own, no I/O, no host sync. Subscribers are called
    on the emitting thread, often the dispatch path, so they share that
    contract: O(1) work and no I/O (the flight recorder's subscriber is one
    ``deque.append`` plus, on a failure kind, one ``SimpleQueue.put``)."""

    def __init__(self, *, sink=None):
        self._events: deque[dict] = deque(maxlen=HUB_CAPACITY)
        self._sink = sink
        self._count = itertools.count()
        self._emitted = 0
        # Copy-on-write subscriber tuple: emit iterates a snapshot, so
        # subscribing never races an emission in progress.
        self._subscribers: tuple[Callable[[dict], None], ...] = ()

    def subscribe(self, fn: Callable[[dict], None]) -> None:
        """Call ``fn(event)`` on every later emission, on the emitting
        thread (O(1) work and no I/O: see the class docstring)."""
        self._subscribers = self._subscribers + (fn,)

    def emit(
        self,
        kind: str,
        *,
        request_id: int | None = None,
        cause_id: int | None = None,
        **fields: Any,
    ) -> dict:
        """Append one event. ``request_id`` defaults to the thread's
        bound id (:func:`bind_request`); background actions pass
        ``cause_id`` instead. Returns the event dict (callers may not
        mutate it after emission — the ring and sink share it)."""
        if request_id is None and cause_id is None:
            request_id = bound_request_id()
        event: dict[str, Any] = {
            "seq": next(self._count),
            "t_s": time.time(),
            "kind": kind,
        }
        if request_id is not None:
            event["request_id"] = request_id
        if cause_id is not None:
            event["cause_id"] = cause_id
        event.update(fields)
        self._events.append(event)
        self._emitted += 1
        sink = self._sink
        if sink is not None:
            sink.put(event)
        for fn in self._subscribers:
            fn(event)
        return event

    def events(self) -> list[dict]:
        """A snapshot of the ring, oldest first."""
        return list(self._events)

    @property
    def emitted(self) -> int:
        """Total events emitted (the ring bounds memory, not this)."""
        return self._emitted

    def flush(self, timeout: float = 5.0) -> bool:
        """Confirm the sink drained (True when there is no sink)."""
        return self._sink.flush(timeout=timeout) if self._sink else True

    def close(self) -> None:
        if self._sink is not None:
            self._sink.close()


def related_events(
    events: Iterable[dict], request_id: int
) -> list[dict]:
    """The causal slice for one request: events carrying the id as
    ``request_id`` or ``cause_id``, batch events listing it in
    ``members``, and — one hop out — events whose ``request_id`` is a
    batch the request was coalesced into (so a member's timeline shows
    the batch's dispatch and failures too)."""
    events = list(events)
    keys = {request_id}
    for ev in events:
        if request_id in ev.get("members", ()):
            if ev.get("request_id") is not None:
                keys.add(ev["request_id"])
            if ev.get("cause_id") is not None:
                keys.add(ev["cause_id"])
    out = []
    for ev in events:
        if (
            ev.get("request_id") in keys
            or ev.get("cause_id") in keys
            or request_id in ev.get("members", ())
        ):
            out.append(ev)
    out.sort(key=lambda ev: (ev.get("t_s", 0.0), ev.get("seq", 0)))
    return out


# ------------------------------------------------------- process default
#
# Same shape as obs.registry.get_registry(): one always-on hub per
# process so subsystems correlate without plumbing, replaceable to arm a
# sink (the serve bench's --events-jsonl).

_default_hub: TimelineHub | None = None
_default_lock = threading.Lock()


def get_hub() -> TimelineHub:
    global _default_hub
    with _default_lock:
        if _default_hub is None:
            _default_hub = TimelineHub()
        return _default_hub


def reset_hub(*, sink=None) -> TimelineHub:
    """Replace the process hub (arming a sink; tests). Closes the previous
    hub's sink."""
    global _default_hub
    with _default_lock:
        old = _default_hub
        _default_hub = TimelineHub(sink=sink)
        hub = _default_hub
    if old is not None:
        old.close()  # after release: close joins the sink writer thread
    return hub
