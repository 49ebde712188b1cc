"""Process-local metrics registry: counters, gauges, latency histograms.

The port's copy of the part of the JAX package's ``obs/registry.py`` that
the engine's :class:`~..engine.EngineStats` and the serve bench read:

* **atomic under threads** — every metric guards its state with one small
  mutex, so a snapshot never reads a half-applied update;
* **no I/O** — exporting a snapshot is the caller's job (``bench/serve.py``);
* **exact percentiles over a bounded window** — the histogram keeps fixed
  cumulative buckets and a bounded window of raw observations;
  ``percentile`` is ``np.percentile`` over the window.

Plus :class:`RateEstimator`, the windowed EWMA arrival rate (req/s) the
batching scheduler (``engine/scheduler.py``) sizes its coalescing window
from; it exports as a gauge in snapshots. Its callers pass ``now=`` (the
scheduler, on its own clock); without it the estimator reads
``time.monotonic``.

The default process registry (:func:`get_registry`) holds the events of
subsystems with no instance of their own: the tuner's per-candidate
measurements. :func:`prometheus_text` is the one Prometheus text serializer
(a live registry's :meth:`MetricsRegistry.to_prometheus` and the obs CLI's
``metrics --prometheus`` over a snapshot file); :func:`label` builds a
labeled metric name with its values escaped. :class:`EwmaGauge`, a
time-decayed average of an observation stream, holds the cost model's
divergence signal (``tuning/cost_model.py::record_prediction``).
"""

from __future__ import annotations

import math
import threading
import time
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

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

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


class RateEstimator:
    """Windowed EWMA arrival-rate estimator: events in, req/s out.

    ``observe()`` records one (or ``n`` simultaneous) arrivals;
    ``rate_per_s()`` reports an exponentially weighted moving average of the
    instantaneous arrival rate with time constant ``tau_s``. Arrivals that
    share one clock reading accumulate and enter the average as
    ``count / gap`` at the next distinct timestamp (a thread stampede reads
    as a high rate, not a division by zero), and ``rate_per_s`` discounts
    the average by the time since the last arrival (``exp(-idle/tau)``), so
    a stream that stops reads as a falling rate.
    """

    def __init__(
        self,
        name: str,
        help: str = "",
        tau_s: float = 1.0,
    ):
        if tau_s <= 0:
            raise ValueError(f"rate estimator {name!r} needs tau_s > 0")
        self.name = name
        self.help = help
        self.tau_s = float(tau_s)
        self._clock = time.monotonic
        self._lock = threading.Lock()
        self._rate = 0.0
        self._last: float | None = None
        self._burst = 0  # arrivals at the last timestamp, not yet averaged
        self._count = 0

    def observe(self, n: int = 1, now: float | None = None) -> None:
        if now is None:
            now = self._clock()
        with self._lock:
            self._count += n
            if self._last is None:
                self._last = now
                self._burst = n
                return
            dt = now - self._last
            if dt <= 0:  # same (or regressed) clock reading: accumulate
                self._burst += n
                return
            w = math.exp(-dt / self.tau_s)
            self._rate = w * self._rate + (1.0 - w) * (self._burst / dt)
            self._last = now
            self._burst = n

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    def rate_per_s(self, now: float | None = None) -> float:
        """The EWMA arrival rate, discounted for idle time since the last
        arrival (0.0 before any event)."""
        if now is None:
            now = self._clock()
        with self._lock:
            if self._last is None:
                return 0.0
            return self._rate * math.exp(-max(0.0, now - self._last) / self.tau_s)


class EwmaGauge:
    """Time-decayed windowed average of an observation stream.

    ``observe(x)`` folds one observation into a pair of decayed accumulators
    (weighted sum and weight), each discounted by ``exp(-dt/tau_s)`` since
    the previous observation; ``value`` is their ratio, an exponentially
    weighted average in which an observation ``age`` seconds old carries
    weight ``exp(-age/tau_s)``. It is recent rather than lifetime, burst-safe
    (observations sharing one clock reading all enter with full weight) and
    idle-stable (silence decays numerator and denominator alike, so the value
    holds over a quiet period). The cost model's divergence gauge is one.
    It reads ``_clock`` (``time.monotonic``), which tests set.

    Exported by the registry snapshot as a plain gauge value.
    """

    def __init__(self, name: str, help: str = "", tau_s: float = 60.0):
        if tau_s <= 0:
            raise ValueError(f"ewma gauge {name!r} needs tau_s > 0")
        self.name = name
        self.help = help
        self.tau_s = float(tau_s)
        self._clock = time.monotonic
        self._lock = threading.Lock()
        self._num = 0.0
        self._den = 0.0
        self._last: float | None = None
        self._count = 0

    def observe(self, x: float, now: float | None = None) -> None:
        if now is None:
            now = self._clock()
        with self._lock:
            if self._last is not None:
                w = math.exp(-max(0.0, now - self._last) / self.tau_s)
                self._num *= w
                self._den *= w
            self._num += float(x)
            self._den += 1.0
            self._last = now
            self._count += 1

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def value(self) -> float:
        """The decayed average (0.0 before any observation)."""
        with self._lock:
            if self._den <= 0.0:
                return 0.0
            return self._num / self._den


class MetricsRegistry:
    """Named metrics, get-or-create. One registry per engine (isolated
    counters per serving instance), plus the process default
    (:func:`get_registry`)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}
        self._histograms: dict[str, Histogram] = {}
        self._rates: dict[str, RateEstimator] = {}
        self._ewmas: dict[str, EwmaGauge] = {}

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

    def rate_estimator(
        self,
        name: str,
        help: str = "",
        tau_s: float = 1.0,
    ) -> RateEstimator:
        with self._lock:
            r = self._rates.get(name)
            if r is None:
                r = self._rates[name] = RateEstimator(name, help, tau_s=tau_s)
            return r

    def ewma_gauge(self, name: str, help: str = "", tau_s: float = 60.0) -> EwmaGauge:
        with self._lock:
            e = self._ewmas.get(name)
            if e is None:
                e = self._ewmas[name] = EwmaGauge(name, help, tau_s=tau_s)
            return e

    def snapshot(self) -> dict:
        """JSON-able view of every metric (atomic per metric). Rate
        estimators and EWMA gauges export as gauges, sampled at snapshot
        time."""
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            histograms = dict(self._histograms)
            rates = dict(self._rates)
            ewmas = dict(self._ewmas)
        gauge_values = {n: g.value for n, g in gauges.items()}
        gauge_values.update({n: r.rate_per_s() for n, r in rates.items()})
        gauge_values.update({n: e.value for n, e in ewmas.items()})
        return {
            "counters": {n: c.value for n, c in sorted(counters.items())},
            "gauges": dict(sorted(gauge_values.items())),
            "histograms": {n: h.summary() for n, h in sorted(histograms.items())},
        }


    def to_prometheus(self) -> str:
        """Prometheus text exposition of the registry (counters, gauges,
        histograms with cumulative ``le`` buckets)."""
        return prometheus_text(self.snapshot())


def label(name: str, **labels: object) -> str:
    """A labeled metric name, ``name{k="v",...}``, with the label values
    escaped per the Prometheus text exposition rules (backslash, double
    quote, newline). The registry stores a labeled metric under its full
    name, so the escaping happens here. Keyword order is kept and the
    separator is a bare comma, the JAX package's grammar."""
    if not labels:
        return name
    parts = ",".join(
        f'{k}="{escape_label_value(str(v))}"' for k, v in labels.items()
    )
    return f"{name}{{{parts}}}"


def escape_label_value(v: str) -> str:
    """Prometheus label-value escaping: ``\\`` → ``\\\\``, ``"`` →
    ``\\"``, newline → ``\\n``."""
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def prometheus_text(snapshot: dict) -> str:
    """Prometheus text exposition of a :meth:`MetricsRegistry.snapshot`
    dict — the one serializer, shared by live registries and the obs CLI
    (which renders snapshots read back from ``--metrics-out`` files)."""
    lines: list[str] = []
    for name, value in snapshot.get("counters", {}).items():
        lines.append(f"# TYPE {name} counter")
        lines.append(f"{name} {value}")
    for name, value in snapshot.get("gauges", {}).items():
        lines.append(f"# TYPE {name} gauge")
        lines.append(f"{name} {_fmt(value)}")
    for name, summ in snapshot.get("histograms", {}).items():
        lines.append(f"# TYPE {name} histogram")
        for le, cum in summ.get("buckets", []):
            le_s = "+Inf" if le == "+Inf" else _fmt(le)
            lines.append(f'{name}_bucket{{le="{le_s}"}} {cum}')
        lines.append(f"{name}_sum {_fmt(summ.get('sum', 0))}")
        lines.append(f"{name}_count {summ.get('count', 0)}")
    return "\n".join(lines) + "\n"


def _fmt(v: float) -> str:
    if isinstance(v, float) and (math.isinf(v) or math.isnan(v)):
        return str(v)
    return repr(float(v)) if isinstance(v, float) else str(v)


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


def reset_registry() -> None:
    """Drop the process default registry, so the next :func:`get_registry`
    makes a fresh one (tests)."""
    global _default
    with _default_lock:
        _default = None
