"""Telemetry: metrics registry, request tracing, the event timeline, named
trace spans.

The port's counterpart of the JAX package's ``obs/``:

* **metrics registry** (``registry.py``) — counters, gauges, latency
  histograms with exact windowed percentiles, the arrival-rate
  estimator the batching scheduler sizes its window from, and the
  time-decayed EWMA gauge of the cost model's divergence;
  ``EngineStats`` is a view over the engine's registry;
* **request-lifecycle tracer** (``tracing.py``) — one span tree per engine
  request (submit → gate → bucket/pad → program lookup → dispatch →
  materialize) into a ring buffer, with an optional JSONL sink
  (``sink.py``, the one module that writes files);
* **correlated event timeline** (``timeline.py``) — one stream of engine
  and scheduler events correlated by ``request_id``/``cause_id`` through a
  thread-local binding (``bind_request``);
* **SLO burn rates** (``slo.py``) — declared targets over the registry's
  counters, gauges and histograms, evaluated with multi-window burn-rate
  alerts (``engine.health()["slo"]``, the serve bench's ``--slo-out``);
* **flight recorder** (``flight.py``) — a bounded ring over the event
  timeline that dumps a post-mortem bundle on typed failures;
* **named trace spans** (``annotations.py``) — ``record_function`` (and
  NVTX) ranges around each strategy's local GEMV and combine.

``python -m matvec_mpi_multiplier_torch.obs`` renders their files
(``__main__.py``: ``metrics``, ``trace``, ``timeline``, ``slo``, ``dump``).
"""

from .annotations import (
    annotations,
    annotations_enabled,
    named_span,
    set_annotations,
)
from .flight import FlightRecorder
from .registry import (
    Counter,
    EwmaGauge,
    Gauge,
    Histogram,
    MetricsRegistry,
    RateEstimator,
    get_registry,
    label,
    prometheus_text,
    reset_registry,
)
from .sink import JsonlSink
from .slo import DEFAULT_TARGETS, ENGINE_TARGETS, SloMonitor, SloTarget
from .timeline import (
    FAILURE_KINDS,
    TimelineHub,
    bind_request,
    bound_request_id,
    get_hub,
    next_request_id,
    related_events,
    reset_hub,
)
from .tracing import RequestTracer, Span

__all__ = [
    "Counter",
    "EwmaGauge",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "RateEstimator",
    "get_registry",
    "reset_registry",
    "label",
    "prometheus_text",
    "SloTarget",
    "SloMonitor",
    "DEFAULT_TARGETS",
    "ENGINE_TARGETS",
    "FlightRecorder",
    "RequestTracer",
    "Span",
    "JsonlSink",
    "FAILURE_KINDS",
    "TimelineHub",
    "bind_request",
    "bound_request_id",
    "get_hub",
    "next_request_id",
    "related_events",
    "reset_hub",
    "named_span",
    "annotations",
    "annotations_enabled",
    "set_annotations",
]
