"""Process-local metrics registry: counters, gauges, latency histograms.

The port's copy of the part of the JAX package's ``obs/registry.py`` that
the engine's :class:`~..engine.EngineStats` and the serve bench read:

* **atomic under threads** — every metric guards its state with one small
  mutex, so a snapshot never reads a half-applied update;
* **no I/O** — exporting a snapshot is the caller's job (``bench/serve.py``);
* **exact percentiles over a bounded window** — the histogram keeps fixed
  cumulative buckets and a bounded window of raw observations;
  ``percentile`` is ``np.percentile`` over the window.

The default process registry (:func:`get_registry`) holds the events of
subsystems with no instance of their own: the tuner's per-candidate
measurements. The rate estimator, the EWMA gauge and the Prometheus text
wait for the observability slice (ROADMAP.md).
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Iterable

import numpy as np

# Default bucket upper bounds, in milliseconds (tens of microseconds through
# seconds). The terminal +Inf bucket is implicit.
DEFAULT_BUCKETS_MS = (
    0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
    25.0, 50.0, 100.0, 250.0, 500.0, 1000.0,
)

# Raw observations retained for exact percentiles.
DEFAULT_WINDOW = 8192


class Counter:
    """Monotone counter; ``inc`` and ``value`` take one mutex."""

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._value = 0

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> int:
        with self._lock:
            return self._value


class Gauge:
    """Last-write-wins instantaneous value."""

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Histogram:
    """Fixed-bucket latency histogram with exact windowed percentiles
    (Prometheus semantics: bucket ``le`` counts observations ``<= le``)."""

    def __init__(
        self,
        name: str,
        help: str = "",
        buckets: Iterable[float] = DEFAULT_BUCKETS_MS,
        window: int = DEFAULT_WINDOW,
    ):
        self.name = name
        self.help = help
        self.buckets = tuple(sorted(float(b) for b in buckets))
        if not self.buckets:
            raise ValueError(f"histogram {name!r} needs at least one bucket")
        self._lock = threading.Lock()
        self._counts = [0] * (len(self.buckets) + 1)  # last = +Inf
        self._sum = 0.0
        self._count = 0
        self._window: deque[float] = deque(maxlen=window)

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self._count += 1
            self._sum += v
            self._counts[np.searchsorted(self.buckets, v, side="left")] += 1
            self._window.append(v)

    def percentile(self, q: float) -> float:
        """``np.percentile`` over the retained window (NaN when empty)."""
        with self._lock:
            if not self._window:
                return float("nan")
            return float(np.percentile(np.asarray(self._window), q))

    def summary(self) -> dict:
        with self._lock:
            window = np.asarray(self._window) if self._window else None
            counts = list(self._counts)
            total, s = self._count, self._sum
        if window is None:
            p50 = p95 = p99 = float("nan")
        else:
            p50, p95, p99 = (float(np.percentile(window, q)) for q in (50, 95, 99))
        cumulative = []
        running = 0
        for le, c in zip(self.buckets, counts):
            running += c
            cumulative.append([le, running])
        cumulative.append(["+Inf", running + counts[-1]])
        return {"count": total, "sum": s, "p50": p50, "p95": p95, "p99": p99,
                "buckets": cumulative}


class MetricsRegistry:
    """Named metrics, get-or-create. One registry per engine (isolated
    counters per serving instance), plus the process default
    (:func:`get_registry`)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}
        self._histograms: dict[str, Histogram] = {}

    def counter(self, name: str, help: str = "") -> Counter:
        with self._lock:
            c = self._counters.get(name)
            if c is None:
                c = self._counters[name] = Counter(name, help)
            return c

    def gauge(self, name: str, help: str = "") -> Gauge:
        with self._lock:
            g = self._gauges.get(name)
            if g is None:
                g = self._gauges[name] = Gauge(name, help)
            return g

    def histogram(
        self,
        name: str,
        help: str = "",
        buckets: Iterable[float] = DEFAULT_BUCKETS_MS,
        window: int = DEFAULT_WINDOW,
    ) -> Histogram:
        with self._lock:
            h = self._histograms.get(name)
            if h is None:
                h = self._histograms[name] = Histogram(
                    name, help, buckets=buckets, window=window
                )
            return h

    def snapshot(self) -> dict:
        """JSON-able view of every metric (atomic per metric)."""
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            histograms = dict(self._histograms)
        return {
            "counters": {n: c.value for n, c in sorted(counters.items())},
            "gauges": {n: g.value for n, g in sorted(gauges.items())},
            "histograms": {n: h.summary() for n, h in sorted(histograms.items())},
        }


_default: MetricsRegistry | None = None
_default_lock = threading.Lock()


def get_registry() -> MetricsRegistry:
    """The process's default registry, made on first use: where the
    tuner's per-candidate measurement events land."""
    global _default
    with _default_lock:
        if _default is None:
            _default = MetricsRegistry()
        return _default
