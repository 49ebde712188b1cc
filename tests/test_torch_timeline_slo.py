"""The port's SLO burn-rate monitor (obs/slo.py), flight recorder
(obs/flight.py) and the timeline hub's subscribers against the JAX
package's.

Both packages' monitors sample the same counter histories on fake clocks
(the port's through its private ``_clock``: it has no clock parameter) and
must give the same evaluation, float for float — the burn arithmetic is the
same Python on the same numbers — and export the same ``slo_*`` gauges.
The flight recorders see the same emissions and must write bundles with the
same trigger, events (by kind and fields) and metric sections; their
rate limit and cap run on fake clocks too. ``engine.health()["slo"]`` is
held to the JAX engine's on the same requests.
"""

import json

import numpy as np
import pytest
import torch

import matvec_mpi_multiplier_tpu.obs as jobs
from matvec_mpi_multiplier_tpu import make_mesh as jax_make_mesh
from matvec_mpi_multiplier_tpu.engine import MatvecEngine as JaxEngine
from matvec_mpi_multiplier_tpu.obs.slo import WINDOWS_S as JAX_WINDOWS
from matvec_mpi_multiplier_torch import obs
from matvec_mpi_multiplier_torch.engine import MatvecEngine
from matvec_mpi_multiplier_torch.obs import (
    DEFAULT_TARGETS,
    ENGINE_TARGETS,
    FAILURE_KINDS,
    FlightRecorder,
    MetricsRegistry,
    SloMonitor,
    SloTarget,
    TimelineHub,
)
from matvec_mpi_multiplier_torch.obs.slo import ALERT_POLICIES, WINDOWS_S
from matvec_mpi_multiplier_torch.parallel.mesh import make_mesh

CPU = torch.device("cpu")
AVAILABILITY = dict(name="availability", kind="availability", objective=0.999,
                    total=("serve_requests_total",), bad=("serve_failed_requests_total",))


@pytest.fixture(autouse=True)
def fresh_hubs():
    obs.reset_hub()
    jobs.reset_hub()
    yield
    obs.reset_hub()
    jobs.reset_hub()


def monitors(targets=None):
    """One monitor per package over its own registry, on one shared fake
    clock."""
    clock = {"t": 0.0}
    out = []
    for mod, target in ((obs, SloTarget), (jobs, jobs.SloTarget)):
        reg = mod.MetricsRegistry()
        total = reg.counter("serve_requests_total")
        bad = reg.counter("serve_failed_requests_total")
        tgts = tuple(target(**t) for t in (targets or [AVAILABILITY]))
        if mod is obs:
            mon = SloMonitor(reg, tgts)
            mon._clock = lambda: clock["t"]
        else:
            mon = jobs.SloMonitor(reg, tgts, clock=lambda: clock["t"])
        out.append((reg, total, bad, mon))
    return clock, out


def run_history(clock, pair, *, until, step, rps, fail_frac):
    while clock["t"] < until:
        clock["t"] += step
        n = int(rps * step)
        for _, total, bad, mon in pair:
            total.inc(n)
            bad.inc(int(n * fail_frac))
            mon.sample()


def same_evaluation(pair) -> dict:
    (reg, _, _, mon), (jreg, _, _, jmon) = pair
    ev, jev = mon.evaluate(), jmon.evaluate()
    assert ev == jev
    assert reg.snapshot()["gauges"] == jreg.snapshot()["gauges"]
    return ev


def test_vocabulary_equals_jax():
    assert WINDOWS_S == JAX_WINDOWS
    assert ALERT_POLICIES == jobs.slo.ALERT_POLICIES
    assert FAILURE_KINDS == jobs.FAILURE_KINDS
    for ours, theirs in ((DEFAULT_TARGETS, jobs.DEFAULT_TARGETS),
                         (ENGINE_TARGETS, jobs.ENGINE_TARGETS)):
        assert [t.__dict__ for t in ours] == [t.__dict__ for t in theirs]
        assert [t.budget_fraction for t in ours] == [t.budget_fraction for t in theirs]


@pytest.mark.parametrize("phases, status", [
    # 6 h clean, then 10 minutes at 50 %: both fast windows burn -> page.
    ([(6 * 3600, 60, 0.0), (6 * 3600 + 600, 60, 0.5)], "page"),
    # One bad minute in an hour: the 1 h window vetoes a page on the 5 m
    # blip, though the slow pair (1 h and 6 h both over 6x) files a ticket.
    ([(3600, 60, 0.0), (3660, 60, 0.5)], "ticket"),
    # A 1 % leak for 5 h, then 10 clean minutes: ticket, not page.
    ([(5 * 3600, 60, 0.01), (5 * 3600 + 600, 60, 0.0)], "ticket"),
    # Steady 0.05 % failures: under budget.
    ([(2 * 3600, 30, 0.0005)], "ok"),
])
def test_burn_rate_alerts_equal_jax(phases, status):
    clock, pair = monitors()
    for until, step, frac in phases:
        run_history(clock, pair, until=until, step=step, rps=10, fail_frac=frac)
        same_evaluation(pair)
    ev = same_evaluation(pair)
    assert ev["targets"]["availability"]["status"] == status
    if status == "page":
        page = next(a for a in ev["alerts"] if a["severity"] == "page")
        assert page["burn_short"] > 14.4 and page["burn_long"] > 14.4
    if phases[-1][2] == 0.5 and status != "page":
        t = ev["targets"]["availability"]
        assert t["burn"]["5m"] > 14.4 > t["burn"]["1h"]
        assert not any(a["severity"] == "page" for a in ev["alerts"])


def test_slo_no_data_and_gauge_export():
    clock, pair = monitors()
    ev = same_evaluation(pair)
    assert ev["targets"]["availability"]["status"] == "no_data"
    assert pair[0][0].snapshot()["gauges"]["slo_availability_alert"] == -1.0
    run_history(clock, pair, until=600, step=60, rps=10, fail_frac=0.0)
    same_evaluation(pair)
    gauges = pair[0][0].snapshot()["gauges"]
    assert gauges["slo_availability_alert"] == 0.0
    assert all(f"slo_availability_burn_{w}" in gauges for w in WINDOWS_S)


def test_threshold_slo_breach_fraction_equals_jax():
    clock = {"t": 0.0}
    target = dict(name="escalation", kind="threshold", objective=0.05,
                  source="engine_escalation_rate", budget=0.1)
    reg, jreg = MetricsRegistry(), jobs.MetricsRegistry()
    mon = SloMonitor(reg, (SloTarget(**target),))
    mon._clock = lambda: clock["t"]
    jmon = jobs.SloMonitor(jreg, (jobs.SloTarget(**target),), clock=lambda: clock["t"])
    for i in range(10):
        clock["t"] += 30.0
        for r in (reg, jreg):
            r.gauge("engine_escalation_rate").set(0.5 if i >= 5 else 0.0)
        mon.sample()
        jmon.sample()
    ev = mon.evaluate()
    assert ev == jmon.evaluate()
    t = ev["targets"]["escalation"]
    assert t["value"] == 0.5 and t["errors"]["5m"] == pytest.approx(0.5)
    assert t["burn"]["5m"] == pytest.approx(5.0)


def test_threshold_slo_histogram_percentile_source_equals_jax():
    target = dict(name="p99", kind="threshold", objective=50.0,
                  source="serve_e2e_latency_ms", percentile=99, budget=0.05)
    evs = []
    for mod in (obs, jobs):
        reg = mod.MetricsRegistry()
        for v in (1.0, 2.0, 100.0):
            reg.histogram("serve_e2e_latency_ms").observe(v)
        mon = mod.SloMonitor(reg, (mod.SloTarget(**target),))
        mon.sample(now=600.0)
        evs.append(mon.evaluate(now=600.0))
    assert evs[0] == evs[1]
    assert evs[0]["targets"]["p99"]["value"] > 50.0
    assert evs[0]["targets"]["p99"]["errors"]["5m"] == 1.0


@pytest.mark.parametrize("kwargs", [
    dict(name="x", kind="availability", objective=1.5, total=("t",), bad=("b",)),
    dict(name="x", kind="availability", objective=0.99),
    dict(name="x", kind="threshold", objective=1.0),
    dict(name="x", kind="nonsense", objective=0.5),
])
def test_slo_target_validation_equals_jax(kwargs):
    with pytest.raises(ValueError):
        jobs.SloTarget(**kwargs)
    with pytest.raises(ValueError):
        SloTarget(**kwargs)


def test_duplicate_targets_refused():
    with pytest.raises(ValueError):
        SloMonitor(MetricsRegistry(), (DEFAULT_TARGETS[0],) * 2)
    import inspect

    ours = set(inspect.signature(SloMonitor).parameters)
    assert ours == set(inspect.signature(jobs.SloMonitor).parameters) - {"clock"}
    ours = set(inspect.signature(FlightRecorder).parameters)
    assert ours == set(inspect.signature(jobs.FlightRecorder).parameters) - {"clock"}


def test_engine_health_reports_slo_as_jax(rng):
    a = rng.uniform(0, 10, (32, 32)).astype(np.float32)
    port = MatvecEngine(a, make_mesh(4, devices=[CPU] * 4), strategy="rowwise", max_bucket=4)
    ref = JaxEngine(a, jax_make_mesh(4), strategy="rowwise", max_bucket=4)
    x = rng.uniform(0, 10, 32).astype(np.float32)
    port.submit(x).result()
    ref.submit(x).result()
    slo, jslo = port.health()["slo"], ref.health()["slo"]
    strip = lambda ev: {n: {k: v for k, v in t.items()} for n, t in ev["targets"].items()}
    assert strip(slo) == strip(jslo) and slo["alerts"] == jslo["alerts"] == []
    assert "slo_engine_availability_alert" in port.metrics.snapshot()["gauges"]
    # A plain engine's snapshot carries no slo_* names until health() runs.
    fresh = MatvecEngine(a, make_mesh(4, devices=[CPU] * 4), strategy="rowwise")
    assert not any(n.startswith("slo_") for n in fresh.metrics.snapshot()["gauges"])


# --------------------------------------------------------- timeline hub


def test_hub_subscriber_sees_every_event_on_the_emitting_thread():
    hub = TimelineHub()
    seen = []
    hub.subscribe(seen.append)
    hub.emit("submit", request_id=1)
    hub.emit("retry", request_id=1, attempt=1)
    assert [e["kind"] for e in seen] == ["submit", "retry"]
    assert seen == hub.events()
    late = []
    hub.subscribe(late.append)
    hub.emit("degrade", request_id=1)
    assert [e["kind"] for e in late] == ["degrade"] and len(seen) == 3


# ------------------------------------------------------ flight recorder


def bundles_equal(path, jpath):
    def shape(bundle):
        ev = [{k: v for k, v in e.items() if k not in ("seq", "t_s")}
              for e in bundle["events"]]
        trig = {k: v for k, v in (bundle["trigger"] or {}).items() if k not in ("seq", "t_s")}
        return ev, trig, bundle.get("metrics"), sorted(bundle)

    assert shape(json.loads(path.read_text())) == shape(json.loads(jpath.read_text()))


def test_flight_recorder_auto_dumps_on_failure_kind_as_jax(tmp_path):
    recs = []
    for mod in (obs, jobs):
        hub, reg = mod.TimelineHub(), mod.MetricsRegistry()
        reg.counter("engine_requests_total").inc(3)
        rec = mod.FlightRecorder(hub, reg, dump_dir=tmp_path / mod.__name__)
        hub.emit("submit", request_id=1)
        hub.emit("retry", request_id=1, attempt=1)  # not a failure kind
        hub.emit("breaker_open", request_id=1, key="k")
        rec.close()  # drains the pending dump
        recs.append(rec)
    (dump,), (jdump,) = recs[0].dumped, recs[1].dumped
    assert dump.name == jdump.name == "flight_000_breaker_open.json"
    bundles_equal(dump, jdump)
    bundle = json.loads(dump.read_text())
    assert [e["kind"] for e in bundle["events"]] == ["submit", "retry", "breaker_open"]
    assert bundle["metrics"]["counters"]["engine_requests_total"] == 3


def test_flight_recorder_rate_limits_and_caps(tmp_path):
    clock = {"t": 0.0}
    hub = TimelineHub()
    rec = FlightRecorder(hub, dump_dir=tmp_path, max_dumps=2, min_interval_s=10.0)
    rec._clock = lambda: clock["t"]
    hub.emit("dispatch_failed", request_id=1)
    hub.emit("dispatch_failed", request_id=2)  # inside min_interval
    rec.close()
    assert len(rec.dumped) == 1
    clock["t"] = 100.0
    rec2 = FlightRecorder(hub, dump_dir=tmp_path, max_dumps=2, min_interval_s=0.0)
    rec2._clock = lambda: clock["t"]
    for i in range(5):
        clock["t"] += 1.0
        hub.emit("dispatch_failed", request_id=10 + i)
    rec2.close()
    assert len(rec2.dumped) == 2


def test_flight_recorder_manual_dump_and_bundle_as_jax(tmp_path):
    outs = []
    for mod in (obs, jobs):
        hub, reg = mod.TimelineHub(), mod.MetricsRegistry()
        if mod is obs:
            mon = SloMonitor(reg, DEFAULT_TARGETS)
            mon._clock = lambda: 0.0
        else:
            mon = jobs.SloMonitor(reg, jobs.DEFAULT_TARGETS, clock=lambda: 0.0)
        rec = mod.FlightRecorder(hub, reg, slo=mon, auto_dump=False, capacity=3, snapshots=2)
        for i in range(5):
            hub.emit("submit", request_id=i)
        for t in (1.0, 2.0, 3.0):
            rec.snapshot_metrics(now=t)
        with pytest.raises(ValueError):
            rec.dump()  # no path, no dump_dir
        outs.append(rec.dump(tmp_path / f"{mod.__name__}.json"))
    bundles_equal(*outs)
    bundle, jbundle = (json.loads(p.read_text()) for p in outs)
    assert len(bundle["events"]) == 3 and len(bundle["metric_snapshots"]) == 2
    assert bundle["trigger"] is None
    assert bundle["slo"]["targets"] == jbundle["slo"]["targets"]
    assert [s["t_s"] for s in bundle["metric_snapshots"]] == [2.0, 3.0]


def test_flight_recorder_survives_unwritable_dump_dir(tmp_path):
    target = tmp_path / "blocked"
    target.write_text("a file, not a directory")
    hub = TimelineHub()
    rec = FlightRecorder(hub, dump_dir=target / "sub")
    hub.emit("dispatch_failed", request_id=1)
    rec.close()
    assert rec.dumped == [] and hub.events()


def test_flight_recorder_dumps_an_engine_breaker_open(tmp_path, rng):
    """The engine's breaker_open reaches a recorder on the process hub."""
    from matvec_mpi_multiplier_torch.resilience import ResiliencePolicy, RetryPolicy, parse_fault_spec

    rec = FlightRecorder(obs.get_hub(), dump_dir=tmp_path)
    pol = ResiliencePolicy(retry=RetryPolicy(max_attempts=1), breaker_failure_threshold=1)
    pol._sleep = lambda s: None
    a = rng.uniform(0, 10, (64, 64)).astype(np.float32)
    eng = MatvecEngine(a, make_mesh(8, devices=[CPU] * 8), promote=None, resilience=pol,
                       fault_plan=parse_fault_spec("dispatch:device_error:key=*:cuda:*"))
    x = rng.uniform(0, 10, 64).astype(np.float32)
    np.testing.assert_allclose(eng(x).numpy(), a @ x, rtol=1e-5)
    rec.close()
    (dump,) = rec.dumped
    bundle = json.loads(dump.read_text())
    assert bundle["trigger"]["kind"] == "breaker_open"
    assert bundle["trigger"]["key"] == "matvec:rowwise:cuda:default:1:float32"
    assert "cause_id" in bundle["trigger"]
