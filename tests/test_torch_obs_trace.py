"""The port's request tracer, event timeline, JSONL sink and rate estimator
against the JAX package's (obs/).

The same request sequence goes through both packages' engines (and
schedulers): each request's span tree — span names, nesting and attributes,
without timings — and each trace's status and attributes must be the JAX
engine's. Correlation ids come from each package's own process counter, so
they are compared after renaming each id to the order it first appears in;
every event's kind, fields, ``request_id``/``cause_id`` and a batch's
``members`` must then match. Exact equality throughout: these are host
records, no arithmetic. The rate estimator runs on a fake clock in both
packages and must give the same floats (rel 1e-12).
"""

import json
import math
import threading

import numpy as np
import pytest
import torch

import matvec_mpi_multiplier_tpu.obs as jobs
from matvec_mpi_multiplier_tpu import make_mesh as jax_make_mesh
from matvec_mpi_multiplier_tpu.engine import ArrivalWindowScheduler as JaxScheduler
from matvec_mpi_multiplier_tpu.engine import MatvecEngine as JaxEngine
from matvec_mpi_multiplier_tpu.resilience import FaultPlan as JaxFaultPlan
from matvec_mpi_multiplier_tpu.resilience import FaultSpec as JaxFaultSpec
from matvec_mpi_multiplier_tpu.tuning import reset_cache as jax_reset_cache
from matvec_mpi_multiplier_torch import obs, tuning
from matvec_mpi_multiplier_torch.engine import ArrivalWindowScheduler, MatvecEngine
from matvec_mpi_multiplier_torch.parallel.mesh import make_mesh
from matvec_mpi_multiplier_torch.resilience import FaultPlan, FaultSpec

CPU = torch.device("cpu")
POISON = 1e30
TIMING = {"seq", "t_s", "ts", "dur_ms", "start_ms"}


@pytest.fixture(autouse=True)
def cold_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("MATVEC_TUNING_CACHE", str(tmp_path / "tuning_cache.json"))
    tuning.reset_cache()
    jax_reset_cache()
    yield
    tuning.reset_cache()
    jax_reset_cache()


@pytest.fixture()
def manual(monkeypatch):
    """Port schedulers without the flusher thread (flush() drives them)."""
    monkeypatch.setattr(ArrivalWindowScheduler, "_flusher_loop", lambda self: None)


class Ids:
    """Renames correlation ids to the order they first appear in."""

    def __init__(self):
        self.map = {}

    def __call__(self, rid):
        if rid is None:
            return None
        return self.map.setdefault(rid, len(self.map))


def span_shape(span: dict) -> tuple:
    return (span["name"], json.dumps(span.get("attrs", {}), sort_keys=True),
            tuple(span_shape(c) for c in span.get("children", ())))


def trace_shape(rec: dict, ids: Ids) -> tuple:
    return (ids(rec["request_id"]), rec["status"],
            json.dumps(rec["attrs"], sort_keys=True),
            tuple(span_shape(s) for s in rec["spans"]))


def event_shape(ev: dict, ids: Ids) -> tuple:
    fields = {k: v for k, v in ev.items()
              if k not in TIMING | {"request_id", "cause_id", "members"}}
    return (ev["kind"], ids(ev.get("request_id")), ids(ev.get("cause_id")),
            tuple(ids(m) for m in ev.get("members", ())),
            json.dumps(fields, sort_keys=True))


def both_engines(a, tmp_path, **kwargs):
    """One engine per package with a trace sink each and a hub each."""
    kwargs.setdefault("promote", 4)
    kwargs.setdefault("max_bucket", 8)
    jplan = kwargs.pop("jax_fault_plan", None)
    hub, jhub = obs.reset_hub(), jobs.TimelineHub()  # the port's engine takes the process hub
    port = MatvecEngine(a, make_mesh(8, devices=[CPU] * 8), strategy="rowwise",
                        trace_jsonl=str(tmp_path / "port.jsonl"), **kwargs)
    if "fault_plan" in kwargs:
        kwargs["fault_plan"] = jplan
    ref = JaxEngine(a, jax_make_mesh(8), strategy="rowwise",
                    trace_jsonl=str(tmp_path / "jax.jsonl"), timeline=jhub, **kwargs)
    return port, ref, hub, jhub


def read_jsonl(path):
    return [json.loads(line) for line in path.read_text().splitlines()]


# ------------------------------------------------------------------ tracer


def test_engine_span_trees_equal_jax(rng, tmp_path):
    """Cold and warm vectors, a block below b*, a promoted block, a block
    wider than the widest bucket, a stale request and a served solve: the
    same span trees, statuses and attributes, request by request, in the
    ring and in the JSONL file after flush."""
    n = 64
    g = rng.uniform(-1, 1, (n, n))
    a = (g + g.T) / 2
    np.fill_diagonal(a, np.abs(a).sum(axis=1) + 1.0)
    a = a.astype(np.float32)
    port, ref, _, _ = both_engines(a, tmp_path)
    X = rng.uniform(0, 10, (n, 11)).astype(np.float32)
    for eng in (port, ref):
        eng.submit(X[:, 0]).result()  # cold: compile
        eng.submit(X[:, 0]).result()  # warm: hit
        eng.submit(X[:, :3]).result()  # per column
        eng.submit(X[:, :8]).result()  # promoted: pad + gemm
        eng.submit(X).result()  # 8 + 3: two buckets
        with pytest.raises(Exception, match="deadline"):
            eng.submit(X[:, 1], deadline_ms=0).result()
        eng.submit(op="cg", rhs=X[:, 2], rtol=1e-6).result()
    ids, jids = Ids(), Ids()
    got = [trace_shape(r, ids) for r in port.tracer.traces()]
    want = [trace_shape(r, jids) for r in ref.tracer.traces()]
    assert got == want
    assert [r[1] for r in got] == ["ok"] * 5 + ["deadline_failed", "ok"]
    assert port.flush_traces() and ref.flush_traces()
    ids, jids = Ids(), Ids()
    assert ([trace_shape(r, ids) for r in read_jsonl(tmp_path / "port.jsonl")]
            == [trace_shape(r, jids) for r in read_jsonl(tmp_path / "jax.jsonl")])
    port.close()
    ref.close()
    port.close()  # idempotent


def test_failed_dispatch_closes_its_trace(rng, tmp_path):
    """A dispatch failure finishes the request's trace as dispatch_failed
    and puts dispatch_failed on the timeline, as in the JAX engine."""
    a = rng.uniform(0, 10, (64, 64)).astype(np.float32)
    plan = FaultPlan([FaultSpec(site="dispatch", kind="device_error", poison=POISON)])
    jplan = JaxFaultPlan([JaxFaultSpec(site="dispatch", kind="device_error", poison=POISON)])
    port, ref, hub, jhub = both_engines(a, tmp_path, fault_plan=plan, jax_fault_plan=jplan)
    x = rng.uniform(0, 10, 64).astype(np.float32)
    x[0] = np.float32(POISON)
    for eng in (port, ref):
        with pytest.raises(Exception, match="poisoned payload"):
            eng.submit(x)
    ids, jids = Ids(), Ids()
    assert ([trace_shape(r, ids) for r in port.tracer.traces()]
            == [trace_shape(r, jids) for r in ref.tracer.traces()])
    assert port.tracer.traces()[-1]["status"] == "dispatch_failed"
    ids, jids = Ids(), Ids()
    assert ([event_shape(e, ids) for e in hub.events()]
            == [event_shape(e, jids) for e in jhub.events()])


def test_tracer_ring_and_finish_semantics():
    """The copy's ring bounds memory, finish is idempotent and closes open
    spans, and a bound id is adopted — as the JAX tracer does."""
    tracer, jtracer = obs.RequestTracer(capacity=3), jobs.RequestTracer(capacity=3)
    for t in (tracer, jtracer):
        for i in range(5):
            tr = t.start(i=i)
            with tr.span("submit", w=i):
                with tr.span("dispatch"):
                    pass
                tr.span("left_open")
            tr.finish()
            tr.finish("never")  # idempotent
    ids, jids = Ids(), Ids()
    assert ([trace_shape(r, ids) for r in tracer.traces()]
            == [trace_shape(r, jids) for r in jtracer.traces()])
    assert len(tracer.traces()) == 3
    with obs.bind_request(4242):
        assert tracer.start().request_id == 4242


# ---------------------------------------------------------------- timeline


def scheduler_scenario(sched, eng, cols, clock):
    """Direct submits, a coalesced flush, a bypass, a stale request, a
    deadline expiring in the window, and a poisoned batch that bisects."""
    eng.submit(cols[0]).result()
    futs = [sched.submit(c) for c in cols[:3]]
    sched.flush()
    for f in futs:
        f.result()
    # Bypass: the deadline is inside the 50 ms window, and far enough out
    # that the engine's own gate never fails it on a loaded host.
    sched.submit(cols[3], deadline_ms=45.0).result()
    with pytest.raises(Exception, match="deadline"):
        sched.submit(cols[3], deadline_ms=-1).result()
    doomed = sched.submit(cols[4], deadline_ms=80.0)
    kept = sched.submit(cols[5])
    clock.advance_ms(100.0)
    sched.flush()
    with pytest.raises(Exception, match="deadline"):
        doomed.result()
    kept.result()
    poisoned = [c.copy() for c in cols[:4]]
    poisoned[2][0] = np.float32(POISON)
    futs = [sched.submit(c) for c in poisoned]
    sched.flush()
    outcomes = []
    for f in futs:
        try:
            f.result()
            outcomes.append("ok")
        except Exception as e:
            outcomes.append(type(e).__name__)
    return outcomes


class FakeClock:
    def __init__(self, t=100.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance_ms(self, ms):
        self.t += ms / 1e3


def test_scheduler_and_engine_events_equal_jax(manual, rng, tmp_path):
    """Event by event: kinds, fields, request_id/cause_id and a batch's
    members, ids renamed by first appearance. Every event carries an id."""
    a = rng.uniform(0, 10, (64, 64)).astype(np.float32)
    cols = [rng.uniform(0, 10, 64).astype(np.float32) for _ in range(6)]
    plan = FaultPlan([FaultSpec(site="dispatch", kind="device_error", poison=POISON)])
    jplan = JaxFaultPlan([JaxFaultSpec(site="dispatch", kind="device_error", poison=POISON)])
    port, ref, hub, jhub = both_engines(a, tmp_path, promote=1, fault_plan=plan,
                                        jax_fault_plan=jplan)
    clock, jclock = FakeClock(), FakeClock()
    sched = ArrivalWindowScheduler(port, window_ms=50.0, flush_width=8)
    sched._clock = clock
    jsched = JaxScheduler(ref, auto_flush=False, window_ms=50.0, flush_width=8,
                          clock=jclock)
    outcomes = scheduler_scenario(sched, port, cols, clock)
    assert outcomes == scheduler_scenario(jsched, ref, cols, jclock)
    assert outcomes == ["ok", "ok", "DeviceFaultError", "ok"]
    ids, jids = Ids(), Ids()
    got = [event_shape(e, ids) for e in hub.events()]
    assert got == [event_shape(e, jids) for e in jhub.events()]
    kinds = {g[0] for g in got}
    assert {"submit", "coalesce", "bypass", "deadline_failed", "bisect",
            "isolated_failure", "dispatch_failed"} <= kinds
    for ev in hub.events():
        assert "request_id" in ev or "cause_id" in ev, ev
    # A member's causal slice reaches the batch's engine submit.
    coalesce = next(e for e in hub.events() if e["kind"] == "coalesce")
    related = obs.related_events(hub.events(), coalesce["members"][0])
    jcoalesce = next(e for e in jhub.events() if e["kind"] == "coalesce")
    jrelated = jobs.related_events(jhub.events(), jcoalesce["members"][0])
    ids, jids = Ids(), Ids()
    assert [event_shape(e, ids) for e in related] == [event_shape(e, jids) for e in jrelated]
    assert "submit" in {e["kind"] for e in related}


def test_events_jsonl_sink_equals_ring(tmp_path, monkeypatch):
    """The hub's sink writes the ring's events, in order, after flush();
    a sink on an unwritable path reports False, as in the JAX package."""
    path = tmp_path / "events.jsonl"
    monkeypatch.setattr(obs.timeline, "HUB_CAPACITY", 4)  # a constant in the port
    hub = obs.TimelineHub(sink=obs.JsonlSink(path))
    jhub = jobs.TimelineHub(capacity=4, sink=jobs.JsonlSink(tmp_path / "jax.jsonl"))
    # Literal ids far above either process counter's, so that none equals
    # the id bound above (a fresh counter hands out 1, 2, ...).
    big = 10 ** 9
    for h in (hub, jhub):
        with h_bind(h) as rid:
            h.emit("submit", cols=1)
            h.emit("dispatch_failed", error="X")
        h.emit("bisect", cause_id=big + 7, members=[big + 1, big + 2], split_at=1)
        h.emit("coalesce", request_id=big + 9, members=[big + 3], width=1)
        h.emit("flush")
        assert rid is not None
    assert hub.flush() and jhub.flush()
    ids, jids = Ids(), Ids()
    written = read_jsonl(path)
    assert ([event_shape(e, ids) for e in written]
            == [event_shape(e, jids) for e in read_jsonl(tmp_path / "jax.jsonl")])
    assert len(written) == 5 == hub.emitted and len(hub.events()) == 4
    assert written[1:] == hub.events()
    hub.close()
    jhub.close()
    blocked = tmp_path / "file"
    blocked.write_text("")
    dead = obs.JsonlSink(blocked / "sub" / "x.jsonl")  # a file is in the way
    dead._thread.join(timeout=5)
    assert dead.flush(timeout=0.5) is False


class h_bind:
    """Binds a fresh id from the hub's package for the block."""

    def __init__(self, hub):
        self.mod = obs if isinstance(hub, obs.TimelineHub) else jobs

    def __enter__(self):
        self.ctx = self.mod.bind_request(self.mod.next_request_id())
        return self.ctx.__enter__()

    def __exit__(self, *exc):
        return self.ctx.__exit__(*exc)


def test_bindings_nest_and_are_thread_local():
    assert obs.FAILURE_KINDS == jobs.FAILURE_KINDS
    with obs.bind_request(5):
        with obs.bind_request(None):
            assert obs.bound_request_id() == 5
        with obs.bind_request(6):
            assert obs.bound_request_id() == 6
        seen = []
        t = threading.Thread(target=lambda: seen.append(obs.bound_request_id()))
        t.start()
        t.join(timeout=10)
        assert not t.is_alive() and seen == [None]
        assert obs.bound_request_id() == 5
    assert obs.bound_request_id() is None
    ids = set()
    lock = threading.Lock()

    def take():
        got = [obs.next_request_id() for _ in range(200)]
        with lock:
            ids.update(got)

    threads = [threading.Thread(target=take) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    assert len(ids) == 1600


def test_reset_hub_replaces_the_process_hub(tmp_path):
    old = obs.get_hub()
    new = obs.reset_hub(sink=obs.JsonlSink(tmp_path / "e.jsonl"))
    try:
        assert obs.get_hub() is new is not old
        new.emit("submit", request_id=1)
        assert new.flush()
    finally:
        obs.reset_hub()
    assert read_jsonl(tmp_path / "e.jsonl")[0]["kind"] == "submit"


# -------------------------------------------------------------- registry


class Clock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t


def test_rate_estimator_equals_jax_on_a_fake_clock():
    clock, jclock = Clock(), Clock()
    r = obs.MetricsRegistry().rate_estimator("r", tau_s=0.25)
    r._clock = clock  # the port's estimator has no clock parameter
    j = jobs.MetricsRegistry().rate_estimator("r", tau_s=0.25, clock=jclock)
    rng = np.random.default_rng(1)
    for step in range(400):
        dt = float(rng.exponential(1 / 800)) if step % 50 else 0.0  # bursts share a tick
        clock.t += dt
        jclock.t += dt
        r.observe()
        j.observe()
        assert r.rate_per_s() == pytest.approx(j.rate_per_s(), rel=1e-12)
    assert 400 < r.rate_per_s() < 1600 and r.count == j.count == 400
    clock.t += 1.0
    jclock.t += 1.0
    assert r.rate_per_s() == pytest.approx(j.rate_per_s(), rel=1e-12)
    assert r.rate_per_s() < 800 * math.exp(-3)
    with pytest.raises(ValueError):
        obs.RateEstimator("bad", tau_s=0)


def test_registry_exports_rates_and_histogram_totals():
    reg, jreg = obs.MetricsRegistry(), jobs.MetricsRegistry()
    reg.rate_estimator("sched_arrival_req_per_s")._clock = lambda: 5.0
    jreg.rate_estimator("sched_arrival_req_per_s", clock=lambda: 5.0)
    for m in (reg, jreg):
        m.rate_estimator("sched_arrival_req_per_s").observe(now=5.0)
        h = m.histogram("w", buckets=(1, 2, 4, 8))
        for v in (1, 3, 8, 9):
            h.observe(v)
    snap, jsnap = reg.snapshot(), jreg.snapshot()
    assert snap["gauges"] == jsnap["gauges"] == {"sched_arrival_req_per_s": 0.0}
    assert snap["histograms"] == jsnap["histograms"]
    h = reg.histogram("w")
    assert (h.count, h.sum) == (4, 21.0)
