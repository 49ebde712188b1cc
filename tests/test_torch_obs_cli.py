"""The port's obs CLI (obs/__main__.py) and Prometheus text
(obs/registry.py) against the JAX package's.

Every render function of the port is fed the same input as the JAX
package's — a metrics snapshot, a request trace, an event stream, an SLO
evaluation, a flight bundle — and must print the same text, character for
character (the panels are the same format strings over the same numbers).
The inputs are the port's own captures (a chaos load run, its engine's
traces and events) and hand-built snapshots carrying every panel's
vocabulary. ``prometheus_text`` must give the JAX package's exposition of
the same snapshot, and ``label`` its escaping.
"""

import json
import math

import numpy as np
import pytest
import torch

import matvec_mpi_multiplier_tpu.obs as jobs
import matvec_mpi_multiplier_tpu.obs.__main__ as jcli
from matvec_mpi_multiplier_tpu.obs.registry import escape_label_value as jescape
from matvec_mpi_multiplier_torch import obs, tuning
from matvec_mpi_multiplier_torch.bench.serve import run_serve_load
from matvec_mpi_multiplier_torch.engine import MatvecEngine
from matvec_mpi_multiplier_torch.obs import (
    FlightRecorder,
    MetricsRegistry,
    RequestTracer,
    SloMonitor,
    TimelineHub,
    label,
    prometheus_text,
)
from matvec_mpi_multiplier_torch.obs import __main__ as cli
from matvec_mpi_multiplier_torch.obs.registry import escape_label_value
from matvec_mpi_multiplier_torch.parallel.mesh import make_mesh

CPU = torch.device("cpu")
RENDERERS = ["render_metrics", "render_storage", "render_batching", "render_resilience",
             "render_solvers", "render_tenants", "render_gsched", "render_cost_model"]


@pytest.fixture(autouse=True)
def isolated(tmp_path, monkeypatch):
    monkeypatch.setenv("MATVEC_TUNING_CACHE", str(tmp_path / "tuning_cache.json"))
    tuning.reset_cache()
    yield
    tuning.reset_cache()
    obs.reset_hub()


@pytest.fixture(scope="module")
def chaos_capture(tmp_path_factory):
    """A port chaos load run's files: metrics snapshot, trace, events, SLO
    evaluation and flight bundles."""
    d = tmp_path_factory.mktemp("chaos")
    run_serve_load("rowwise", make_mesh(8, devices=[CPU] * 8), 64, 64, n_requests=40,
                   max_bucket=8, promote=1, concurrency=4, seed=0, poison_rate=0.1,
                   fault_spec="dispatch:device_error:p=0.2", fault_seed=19,
                   metrics_out=str(d / "metrics.json"), trace_jsonl=str(d / "trace.jsonl"),
                   events_jsonl=str(d / "events.jsonl"), slo_out=str(d / "slo.json"),
                   flight_dir=str(d / "flight"))
    obs.reset_hub()
    return d


def full_snapshot() -> dict:
    """A snapshot carrying every panel's vocabulary, the port's and what
    the port does not emit yet."""
    reg = MetricsRegistry()
    for name, n in [("engine_requests_total", 12), ("engine_dispatches_total", 9),
                    ("sched_requests_total", 12), ("sched_batches_total", 3),
                    ("sched_coalesced_requests_total", 9), ("sched_bypass_total", 1),
                    ("sched_deadline_failures_total", 2), ("sched_amortized_bytes_total", 4096),
                    ("resil_faults_injected_total", 5), ("resil_retries_total", 3),
                    ("resil_downgrades_total", 2), ("resil_breaker_opens_total", 1),
                    ("serve_failed_requests_total", 1), ("serve_requests_total", 40),
                    ("solver_requests_total", 4), ("solver_divergences_total", 1),
                    ("engine_storage_fallbacks_total", 1), ("gsched_decisions_total", 7),
                    ("gsched_admits_total", 5), ("gsched_rejects_total", 2),
                    ("registry_requests_total", 10), ("registry_hits_total", 8),
                    ('tenant_requests_total{tenant="a"}', 6)]:
        reg.counter(name).inc(n)
    for name, v in [("engine_in_flight", 1), ("engine_resident_bytes", 9216),
                    ('engine_storage_format{format="int8c",dtype="float32",reason="explicit"}', 1),
                    ("sched_coalesce_window_ms", 1.25), ("sched_arrival_req_per_s", 500.0),
                    ("resil_breakers_open", 1), ("solver_residual_norm", 3.5e-7),
                    ("registry_tenants", 2), ("registry_hbm_budget_bytes", 1e9),
                    ('tenant_resident_bytes{tenant="a"}', 4096),
                    ('tenant_strategy{tenant="a",strategy="rowwise"}', 1),
                    ("tuning_cost_model_divergence", 0.4)]:
        reg.gauge(name).set(v)
    for name, values in [("sched_batch_width", (2, 3, 4)), ("solver_iterations", (12, 20)),
                         ("solver_iteration_time", (0.5, 0.7)),
                         ("serve_e2e_latency_ms", (0.4, 1.2, 30.0)),
                         ("tuning_predicted_vs_measured_ratio", (0.9, 1.1, 2.0)),
                         ("gsched_predicted_dispatch_ms", (0.3,))]:
        h = reg.histogram(name, buckets=(1, 2, 4, 8))
        for v in values:
            h.observe(v)
    return reg.snapshot()


def same_text(name, *args, **kwargs):
    got = getattr(cli, name)(*args, **kwargs)
    assert got == getattr(jcli, name)(*args, **kwargs), name
    return got


@pytest.mark.parametrize("renderer", RENDERERS)
def test_panels_equal_jax_on_every_vocabulary(renderer, chaos_capture):
    snapshots = [full_snapshot(), MetricsRegistry().snapshot(),
                 json.loads((chaos_capture / "metrics.json").read_text())]
    for snap in snapshots:
        same_text(renderer, snap)
    if renderer == "render_metrics":
        for snap in snapshots:
            same_text(renderer, snap, prometheus=True)
        text = same_text(renderer, snapshots[2])
        assert "resilience:" in text and "batching:" in text and "storage:" in text


def test_chaos_capture_renders_its_availability(chaos_capture):
    snap = json.loads((chaos_capture / "metrics.json").read_text())
    text = cli.render_resilience(snap)
    c = snap["counters"]
    rate = (c["serve_requests_total"] - c["serve_failed_requests_total"]) / c["serve_requests_total"]
    assert f"availability      {rate:.4f}" in text and rate == 0.9


def test_trace_summary_equals_jax(chaos_capture):
    records = cli.load_trace(chaos_capture / "trace.jsonl")
    assert records == jcli.load_trace(chaos_capture / "trace.jsonl")
    for top in (1, 5):
        same_text("summarize_trace", records, top=top)
    assert same_text("summarize_trace", []) == "(empty trace)"
    tracer = RequestTracer()
    for _ in range(4):
        t = tracer.start()
        with t.span("submit"):
            with t.span("dispatch"):
                pass
        t.finish()
    same_text("summarize_trace", tracer.traces(), top=2)


def test_timeline_render_equals_jax(chaos_capture):
    events = cli.load_events(chaos_capture / "events.jsonl")
    assert events == jcli.load_events(chaos_capture / "events.jsonl")
    ids = sorted({e["request_id"] for e in events if "request_id" in e})
    for rid in ids[:10] + [10 ** 9]:
        same_text("render_timeline", events, rid)
        same_text("render_timeline", events, rid, since=events[len(events) // 2]["t_s"])
    kinds = {e["kind"] for e in events}
    assert {"submit", "coalesce", "retry"} <= kinds


def test_slo_and_dump_render_equal_jax(chaos_capture):
    evaluation = json.loads((chaos_capture / "slo.json").read_text())
    text = same_text("render_slo", evaluation)
    assert "[   page]" in text and "ALERT [page] availability" in text
    assert same_text("render_slo", {"targets": {}}) == "(no SLO targets)"
    bundles = sorted((chaos_capture / "flight").iterdir())
    assert bundles and all(b.name.startswith("flight_") for b in bundles)
    for path in bundles:
        bundle = json.loads(path.read_text())
        assert bundle["trigger"]["kind"] in obs.FAILURE_KINDS
        same_text("render_dump", bundle)
        assert cli.load_events(path) == jcli.load_events(path)
    hub = TimelineHub()
    rec = FlightRecorder(hub, MetricsRegistry(), slo=SloMonitor(MetricsRegistry()),
                         auto_dump=False)
    hub.emit("submit", request_id=1)
    hub.emit("dispatch_failed", request_id=1, error="DeviceFaultError")
    same_text("render_dump", rec.bundle(trigger=hub.events()[-1]))
    same_text("render_dump", rec.bundle())


@pytest.mark.parametrize("argv, expect", [
    (["metrics", "{d}/metrics.json"], "resilience:"),
    (["metrics", "{d}/metrics.json", "--prometheus"], "# TYPE serve_requests_total counter"),
    (["trace", "{d}/trace.jsonl", "--top", "3"], "per-phase breakdown"),
    (["trace", "{d}/trace.jsonl", "--since", "1e12"], "(empty trace)"),
    (["slo", "{d}/slo.json"], "slo:"),
])
def test_cli_main_equals_jax(argv, expect, chaos_capture, capsys):
    argv = [a.format(d=chaos_capture) for a in argv]
    assert cli.main(argv) == 0
    out = capsys.readouterr().out
    assert jcli.main(argv) == 0
    assert out == capsys.readouterr().out and expect in out


def test_cli_timeline_dump_and_misses(chaos_capture, capsys):
    events = cli.load_events(chaos_capture / "events.jsonl")
    rid = next(e["request_id"] for e in events if e["kind"] == "submit")
    assert cli.main(["timeline", str(chaos_capture / "events.jsonl"), str(rid)]) == 0
    assert f"request {rid}:" in capsys.readouterr().out
    assert cli.main(["timeline", str(chaos_capture / "events.jsonl"), "999999999"]) == 1
    bundle = sorted((chaos_capture / "flight").iterdir())[0]
    assert cli.main(["dump", str(bundle)]) == 0
    assert "flight bundle:" in capsys.readouterr().out
    assert cli.main(["metrics", str(chaos_capture / "missing.json")]) == 1


def test_cli_watch_rerenders_until_interrupted(tmp_path, capsys, monkeypatch):
    path = tmp_path / "metrics.json"
    path.write_text(json.dumps(MetricsRegistry().snapshot()))
    sleeps = []

    def sleep(s):
        sleeps.append(s)
        if len(sleeps) == 2:
            raise KeyboardInterrupt

    monkeypatch.setattr(cli.time, "sleep", sleep)
    assert cli.main(["metrics", str(path), "--watch", "0.5"]) == 130
    assert capsys.readouterr().out.count("\x1b[2J") == 2 and sleeps == [0.5, 0.5]


# ------------------------------------------------------------ Prometheus


def test_prometheus_text_equals_jax():
    for snap in (full_snapshot(), MetricsRegistry().snapshot()):
        assert prometheus_text(snap) == jobs.prometheus_text(snap)
    reg = MetricsRegistry()
    h = reg.histogram("lat", buckets=(1.0, 5.0, 25.0))
    for v in (0.5, 0.5, 3.0, 30.0, 100.0):
        h.observe(v)
    reg.counter("reqs").inc(3)
    reg.gauge("nan_gauge").set(math.nan)
    text = reg.to_prometheus()
    assert text == prometheus_text(reg.snapshot()) == jobs.prometheus_text(reg.snapshot())
    assert [ln for ln in text.splitlines() if ln.startswith("lat_bucket")] == [
        'lat_bucket{le="1.0"} 2', 'lat_bucket{le="5.0"} 3', 'lat_bucket{le="25.0"} 3',
        'lat_bucket{le="+Inf"} 5']
    assert "# TYPE reqs counter\nreqs 3" in text and "nan_gauge nan" in text


@pytest.mark.parametrize("value", ['a"b', "a\\b", "a\nb", 'evil"\\tenant\nx', "plain"])
def test_label_escaping_equals_jax(value):
    assert escape_label_value(value) == jescape(value)
    assert label("m", tenant=value, b="1") == jobs.label("m", tenant=value, b="1")
    assert label("m") == "m"
    reg = MetricsRegistry()
    reg.counter(label("tenant_requests_total", tenant=value)).inc(2)
    assert f'{label("tenant_requests_total", tenant=value)} 2' in reg.to_prometheus()


def test_engine_snapshot_renders_as_jax(rng):
    """A plain engine's snapshot (no panels but storage) and a quantized one."""
    a = rng.uniform(0, 10, (64, 64)).astype(np.float32)
    for storage in (None, "int8c"):
        eng = MatvecEngine(a, make_mesh(8, devices=[CPU] * 8), dtype_storage=storage,
                           promote=2, max_bucket=8)
        eng.submit(rng.uniform(0, 10, (64, 3)).astype(np.float32)).result()
        eng.health()
        same_text("render_metrics", eng.metrics.snapshot())
