"""Always-on flight recorder: the last N events + metric snapshots,
auto-dumped as a post-mortem bundle on typed failures.

When a breaker opens at 3 a.m., the question is "what were the last
five hundred things the stack did" — and by the time anyone asks, the
ring buffers have wrapped. The flight recorder is the bounded,
always-on answer: it subscribes to the :class:`~.timeline.TimelineHub`
(one ``deque.append`` per event — GIL-atomic, hot-path-safe per the
obs doctrine), keeps periodic metric snapshots, and on any typed
failure event (:data:`~.timeline.FAILURE_KINDS`: breaker open, solver
divergence, systemic batch failure, integrity refusal, ...) hands the
event to its own writer thread, which dumps a JSON bundle:

* the trigger event,
* the event ring at that moment (causally ordered, correlation IDs
  intact — ``obs timeline`` can replay any request in the bundle),
* the retained metric snapshots (before/after deltas),
* the SLO evaluation, when a monitor is attached.

All file I/O happens on the writer thread via :func:`~.sink.dump_json`
(obs/sink.py owns every file handle in obs); the hub-facing subscriber
does exactly one deque append and — on failure kinds — one
``SimpleQueue.put``. Dumps are rate-limited (``min_interval_s``) and
capped (``max_dumps``) so a failure storm cannot fill a disk.
``obs dump <bundle.json>`` renders a bundle; ``dump()`` writes one on
demand.

The port's copy of the JAX package's ``obs/flight.py``. The clock is
``time.time``; no caller of the port sets another, so it is not a
parameter (tests set ``recorder._clock``, and ``snapshot_metrics(now=)``
takes a time).
"""

from __future__ import annotations

import itertools
import queue
import threading
import time
from collections import deque
from pathlib import Path
from .sink import dump_json
from .timeline import FAILURE_KINDS, TimelineHub

__all__ = ["FlightRecorder"]

_CLOSE = object()


class FlightRecorder:
    """Bounded black box over one hub (and optionally one registry and
    one SLO monitor)."""

    def __init__(
        self,
        hub: TimelineHub,
        registry=None,
        *,
        slo=None,
        capacity: int = 512,
        snapshots: int = 8,
        dump_dir: str | Path | None = None,
        auto_dump: bool = True,
        max_dumps: int = 4,
        min_interval_s: float = 0.5,
    ):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.registry = registry
        self.slo = slo
        self.dump_dir = Path(dump_dir) if dump_dir is not None else None
        self._clock = time.time
        self._ring: deque[dict] = deque(maxlen=capacity)
        self._snaps: deque[dict] = deque(maxlen=snapshots)
        self._auto = bool(auto_dump) and self.dump_dir is not None
        self._max_dumps = max_dumps
        self._min_interval_s = float(min_interval_s)
        self._dump_seq = itertools.count()
        self._dumped: list[Path] = []
        self._last_dump_t: float | None = None
        self._q: queue.SimpleQueue = queue.SimpleQueue()
        self._writer: threading.Thread | None = None
        if self._auto:
            self._writer = threading.Thread(
                target=self._run_writer, daemon=True, name="obs-flight"
            )
            self._writer.start()
        hub.subscribe(self._on_event)

    # ----------------------------------------------------------- hot path

    def _on_event(self, event: dict) -> None:
        """Hub subscriber: one append; on typed failures, one queue put.
        Nothing here may lock, allocate a file handle, or block — it
        runs inside ``TimelineHub.emit``, which runs inside dispatch."""
        self._ring.append(event)
        if self._auto and event.get("kind") in FAILURE_KINDS:
            self._q.put(event)

    # -------------------------------------------------------- bookkeeping

    def snapshot_metrics(self, now: float | None = None) -> None:
        """Retain one metric snapshot (call periodically — the serve
        bench samples between phases; a caller may run it on a timer)."""
        if self.registry is None:
            return
        self._snaps.append({
            "t_s": now if now is not None else self._clock(),
            "snapshot": self.registry.snapshot(),
        })

    def events(self) -> list[dict]:
        return list(self._ring)

    @property
    def dumped(self) -> list[Path]:
        """Bundles written so far (auto + manual)."""
        return list(self._dumped)

    # ------------------------------------------------------------ dumping

    def bundle(self, trigger: dict | None = None) -> dict:
        """The post-mortem payload, assembled from the retained rings."""
        payload = {
            "t_s": self._clock(),
            "trigger": trigger,
            "events": list(self._ring),
            "metric_snapshots": list(self._snaps),
        }
        if self.registry is not None:
            payload["metrics"] = self.registry.snapshot()
        if self.slo is not None:
            payload["slo"] = self.slo.evaluate()
        return payload

    def dump(
        self, path: str | Path | None = None, trigger: dict | None = None
    ) -> Path:
        """Write one bundle now (the ``obs dump``/caller face — runs on
        the caller's thread, never the dispatch path)."""
        if path is None:
            if self.dump_dir is None:
                raise ValueError(
                    "no dump path given and no dump_dir configured"
                )
            path = self._next_path(trigger)
        out = dump_json(path, self.bundle(trigger))
        self._dumped.append(out)
        return out

    def _next_path(self, trigger: dict | None) -> Path:
        kind = (trigger or {}).get("kind", "manual")
        seq = next(self._dump_seq)
        return self.dump_dir / f"flight_{seq:03d}_{kind}.json"

    def _run_writer(self) -> None:
        while True:
            trigger = self._q.get()
            if trigger is _CLOSE:
                return
            now = self._clock()
            if len(self._dumped) >= self._max_dumps:
                continue
            if (
                self._last_dump_t is not None
                and now - self._last_dump_t < self._min_interval_s
            ):
                continue
            self._last_dump_t = now
            try:
                self.dump(trigger=trigger)
            except OSError:
                # An unwritable dump_dir must never take down the
                # writer (the ring keeps recording; manual dump()
                # surfaces the error on the caller's thread).
                continue

    def close(self, timeout: float = 5.0) -> None:
        """Stop the writer thread (pending auto-dumps drain first). The
        hub subscription stays — the ring keeps recording, only
        auto-dumping stops."""
        if self._writer is not None:
            self._q.put(_CLOSE)
            self._writer.join(timeout)
            self._auto = False
