"""Request-lifecycle tracing: one structured span tree per engine request.

The port's copy of the JAX package's ``obs/tracing.py``. The tracer records
where inside a single request the host time went — submit → backpressure
gate → bucket/pad → program lookup (hit|compile) → dispatch →
materialize — as a tree of named spans with ``perf_counter`` timestamps:
host spans, as in the JAX package (the device's own time is the kernels'
timing, not the tracer's). Finished traces land in an in-memory ring buffer
and, when a sink is attached, on the sink thread's JSONL file
(``sink.py``).

Dispatch-path discipline: recording a span is list mutation plus two
``perf_counter`` calls; finishing a trace is a ``deque.append`` (ring) and a
``SimpleQueue.put`` (sink hand-off) — no locks, no file handles, no host
sync with the card.

Threading model: one :class:`ActiveTrace` is built by the submitting
thread and later completed (materialize span + finish) by whichever thread
materializes the future — sequential hand-off, not concurrent mutation.
``finish`` is idempotent: only the first call emits.

The device trace's clock: while a ``torch.profiler`` records, each span
also opens a ``record_function`` range named ``engine/<name>``
(``engine/submit``, ``engine/gate``, ``engine/bucket_pad``,
``engine/exec_lookup``, ``engine/dispatch``, ``engine/materialize``,
``engine/escalate``; ``obs/annotations.py::profiler_span``), so the
profiler's trace holds the phases beside the kernels they launch. A range
closes where its span ends, on the thread that opened it: when ``finish``
ends a span from another thread it closes no range, and the opening
thread's ``__exit__`` closes it. The tracer's own records keep their
``perf_counter`` times, ring and sink whether a profiler records or not.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from typing import TYPE_CHECKING

from .annotations import NOT_RECORDING, profiler_span
from .timeline import bound_request_id

if TYPE_CHECKING:  # import cycle guard only; sink.py imports nothing back
    from .sink import JsonlSink

# The profiler ranges' names: ``engine/`` and the span's name.
ENGINE_PREFIX = "engine/"


class Span:
    """One named, timed region. ``attrs`` carry phase facts (bucket width,
    cache outcome); ``children`` nest (dispatch inside submit)."""

    __slots__ = ("name", "attrs", "children", "t0", "t1", "_range")

    def __init__(self, name: str, attrs: dict | None = None):
        self.name = name
        self.attrs = attrs or {}
        self.children: list[Span] = []
        self.t0 = time.perf_counter()
        self.t1: float | None = None
        # (profiler range, opening thread) while a profiler records.
        self._range: tuple | None = None

    def end(self) -> None:
        if self.t1 is None:
            self.t1 = time.perf_counter()

    def _open_range(self) -> None:
        rng = profiler_span(ENGINE_PREFIX + self.name)
        if rng is not NOT_RECORDING:
            rng.__enter__()
            self._range = (rng, threading.get_ident())

    def _close_range(self) -> None:
        """Close the profiler range on the thread that opened it; elsewhere
        leave it to that thread."""
        if self._range is not None and self._range[1] == threading.get_ident():
            rng, self._range = self._range[0], None
            rng.__exit__(None, None, None)

    @property
    def duration_ms(self) -> float:
        end = self.t1 if self.t1 is not None else time.perf_counter()
        return (end - self.t0) * 1e3

    def to_dict(self, base: float) -> dict:
        d = {
            "name": self.name,
            "start_ms": (self.t0 - base) * 1e3,
            "dur_ms": self.duration_ms,
        }
        if self.attrs:
            d["attrs"] = self.attrs
        if self.children:
            d["children"] = [c.to_dict(base) for c in self.children]
        return d


class _SpanContext:
    """Context-manager handle ``ActiveTrace.span`` returns: ends the span
    and pops it off the open stack on exit (exception included — a span
    abandoned by a raise must not swallow its siblings)."""

    __slots__ = ("_trace", "span")

    def __init__(self, trace: "ActiveTrace", span: Span):
        self._trace = trace
        self.span = span

    def __enter__(self) -> Span:
        return self.span

    def __exit__(self, *exc) -> None:
        self.span.end()
        self.span._close_range()
        stack = self._trace._stack
        if stack and stack[-1] is self.span:
            stack.pop()
        return None


class ActiveTrace:
    """One in-flight request's span tree, finished exactly once."""

    __slots__ = (
        "request_id", "attrs", "status", "_tracer", "_t0", "_wall",
        "_roots", "_stack", "_finished",
    )

    def __init__(self, tracer: "RequestTracer", request_id: int, attrs: dict):
        self.request_id = request_id
        self.attrs = attrs
        self.status = "ok"
        self._tracer = tracer
        self._t0 = time.perf_counter()
        self._wall = time.time()
        self._roots: list[Span] = []
        self._stack: list[Span] = []
        self._finished = False

    def span(self, name: str, **attrs) -> _SpanContext:
        """Open a named child span (nested under the innermost open span,
        or at the root). Use as a context manager."""
        span = Span(name, attrs or None)
        span._open_range()
        (self._stack[-1].children if self._stack else self._roots).append(
            span
        )
        self._stack.append(span)
        return _SpanContext(self, span)

    def finish(self, status: str = "ok") -> None:
        """Close the trace: end any still-open spans, build the record,
        push it to the ring buffer and the sink. Idempotent — a repeated
        ``result()`` call must not emit the request twice."""
        if self._finished:
            return
        self._finished = True
        self.status = status
        for span in self._stack:
            span.end()
        for span in reversed(self._stack):
            span._close_range()
        self._stack.clear()
        record = {
            "request_id": self.request_id,
            "ts": self._wall,
            "dur_ms": (time.perf_counter() - self._t0) * 1e3,
            "status": status,
            "attrs": self.attrs,
            "spans": [s.to_dict(self._t0) for s in self._roots],
        }
        self._tracer._emit(record)


class RequestTracer:
    """Ring buffer of finished request traces + optional JSONL sink."""

    def __init__(self, capacity: int = 256, sink: "JsonlSink | None" = None):
        self._ring: deque[dict] = deque(maxlen=capacity)
        self._sink = sink
        self._ids = itertools.count()

    def start(self, **attrs) -> ActiveTrace:
        """Open a trace. When the thread carries a bound correlation id
        (``obs.timeline.bind_request`` — the scheduler binds one around
        the synchronous submit chain), the trace adopts it, so the span tree and the event timeline share the key;
        otherwise the tracer's own counter numbers the request."""
        rid = bound_request_id()
        return ActiveTrace(
            self, next(self._ids) if rid is None else rid, attrs
        )

    def _emit(self, record: dict) -> None:
        self._ring.append(record)  # GIL-atomic; no lock on the hot path
        if self._sink is not None:
            self._sink.put(record)

    def traces(self) -> list[dict]:
        """The retained recent records, oldest first."""
        return list(self._ring)

    def flush(self, timeout: float = 5.0) -> bool:
        """Block until the sink has written everything emitted so far.
        Returns False when the sink could not confirm (dead writer thread
        — e.g. an unwritable path killed it — or timeout); True otherwise,
        including the no-sink case (nothing to flush). Caller and test code
        only — never the dispatch path."""
        if self._sink is not None:
            return self._sink.flush(timeout=timeout)
        return True

    def close(self) -> None:
        if self._sink is not None:
            self._sink.close()
