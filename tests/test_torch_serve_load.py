"""The port's load protocol (bench/serve.py ``run_serve_load`` and the CLI's
load mode) against the JAX package's.

The request stream is the JAX bench's, exactly: the same widths, payloads
(fp32, bitwise) and width sequence from ``_request_pool`` for one seed, and
the same gaps from ``_arrival_gaps``. ``run_serve_load`` runs closed- and
open-loop, coalesced and not, at 64² on 8 logical CPU shards. Where the
flushes do not depend on timing (every coalesced flush is a full bucket:
``flush_width`` = ``max_bucket`` = the clients or the burst, and a 60 s
window), its counts — columns, builds, program hits, batch width, coalesce
ratio, trace records, events by kind — equal the JAX package's run of the
same config; elsewhere the tests check the protocol, never a speed (these
are CPU timings of tiny shapes).
"""

import dataclasses
import json
from collections import Counter

import numpy as np
import pytest
import torch

from matvec_mpi_multiplier_tpu import make_mesh as jax_make_mesh
from matvec_mpi_multiplier_tpu.bench import serve as jax_serve
from matvec_mpi_multiplier_tpu.bench.metrics import read_csv
from matvec_mpi_multiplier_tpu.obs import reset_hub as jax_reset_hub
from matvec_mpi_multiplier_tpu.tuning import reset_cache as jax_reset_cache
from matvec_mpi_multiplier_tpu.utils import errors as jerrors
from matvec_mpi_multiplier_torch import tuning
from matvec_mpi_multiplier_torch.bench import serve
from matvec_mpi_multiplier_torch.bench.serve import (
    LOAD_WIDTH_MIX,
    SERVE_CSV_HEADER,
    _arrival_gaps,
    _request_pool,
    run_serve_load,
    serve_csv_path,
)
from matvec_mpi_multiplier_torch.obs import reset_hub
from matvec_mpi_multiplier_torch.parallel.mesh import make_mesh
from matvec_mpi_multiplier_torch.utils.errors import ConfigError, MatvecError

CPU = torch.device("cpu")
CPU_ARGS = ["--platform", "cpu", "--host-devices", "8", "--devices", "8"]


@pytest.fixture(autouse=True)
def cold_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("MATVEC_TUNING_CACHE", str(tmp_path / "tuning_cache.json"))
    tuning.reset_cache()
    jax_reset_cache()
    yield
    tuning.reset_cache()
    jax_reset_cache()
    reset_hub()
    jax_reset_hub()


def port_mesh(p=8):
    return make_mesh(p, devices=[CPU] * p)


# ------------------------------------------------------- the request stream


@pytest.mark.parametrize("widths", [serve.DEFAULT_WIDTH_MIX, LOAD_WIDTH_MIX, (1, 2, 3, 8)])
@pytest.mark.parametrize("seed", [0, 5])
def test_request_pool_and_sequence_equal_jax(widths, seed):
    """The same payloads (fp32, bitwise) and the same width sequence."""
    pool = _request_pool(32, widths, torch.float32, seed=seed + 1)
    jpool = jax_serve._request_pool(32, widths, np.float32, seed=seed + 1)
    assert list(pool) == list(jpool)
    for w in pool:
        assert np.array_equal(pool[w].numpy(), jpool[w])
    seq = np.random.default_rng(seed + 2).choice(list(pool), size=50)
    jseq = np.random.default_rng(seed + 2).choice(list(jpool), size=50)
    assert np.array_equal(seq, jseq)
    assert LOAD_WIDTH_MIX == jax_serve.LOAD_WIDTH_MIX


@pytest.mark.parametrize("arrival, rate, burst", [
    ("poisson", 500.0, 8), ("poisson", 40.0, 1), ("burst", 500.0, 8), ("burst", 1200.0, 3),
])
def test_arrival_gaps_equal_jax(arrival, rate, burst):
    gaps = _arrival_gaps(arrival, 40, rate, burst, np.random.default_rng(3))
    jgaps = jax_serve._arrival_gaps(arrival, 40, rate, burst, np.random.default_rng(3))
    assert gaps == jgaps
    if arrival == "burst":
        assert sum(g > 0 for g in gaps) == -(-40 // burst)


@pytest.mark.parametrize("args", [
    ("poisson", 0.0, 8), ("burst", 100.0, 0), ("uniform", 100.0, 8),
])
def test_arrival_gaps_refuse_what_jax_refuses(args):
    arrival, rate, burst = args
    with pytest.raises(jerrors.MatvecError):
        jax_serve._arrival_gaps(arrival, 4, rate, burst, np.random.default_rng(0))
    with pytest.raises(MatvecError):
        _arrival_gaps(arrival, 4, rate, burst, np.random.default_rng(0))


# ----------------------------------------------------------------- the runs


def deterministic_config(tmp_path, tag, concurrency=4, arrival="closed", coalesce=True):
    """Every coalesced flush is a full bucket of ``concurrency`` (closed
    loop) or ``burst`` (open loop) requests: no flush depends on timing."""
    return dict(n_requests=24, max_bucket=concurrency, promote=2,
                concurrency=concurrency, coalesce=coalesce, arrival=arrival,
                rate=4000.0, burst=concurrency, window_ms=60_000.0,
                flush_width=concurrency, seed=1,
                trace_jsonl=str(tmp_path / f"{tag}_trace.jsonl"),
                events_jsonl=str(tmp_path / f"{tag}_events.jsonl"),
                metrics_out=str(tmp_path / f"{tag}_metrics.json"))


def counts(result, tmp_path, tag):
    events = [json.loads(line) for line in
              (tmp_path / f"{tag}_events.jsonl").read_text().splitlines()]
    traces = (tmp_path / f"{tag}_trace.jsonl").read_text().splitlines()
    return dict(
        n_requests=result.n_requests, total_cols=result.total_cols,
        compiles_warmup=result.compiles_warmup, compiles_steady=result.compiles_steady,
        hits_steady=result.hits_steady, b_star=result.b_star,
        mean_batch_width=result.mean_batch_width, coalesce_ratio=result.coalesce_ratio,
        arrival=result.arrival, concurrency=result.concurrency, coalesce=result.coalesce,
        trace_records=len(traces),
        events=dict(Counter(e["kind"] for e in events)),
    )


@pytest.mark.parametrize("arrival, coalesce", [
    ("closed", False), ("closed", True), ("burst", False), ("burst", True),
])
def test_run_serve_load_counts_equal_jax(tmp_path, arrival, coalesce):
    port = run_serve_load("rowwise", port_mesh(), 64, 64,
                          **deterministic_config(tmp_path, "port", arrival=arrival,
                                                 coalesce=coalesce))
    ref = jax_serve.run_serve_load("rowwise", jax_make_mesh(8), 64, 64, kernel="xla",
                                   **deterministic_config(tmp_path, "jax", arrival=arrival,
                                                          coalesce=coalesce))
    got, want = counts(port, tmp_path, "port"), counts(ref, tmp_path, "jax")
    nan = ("mean_batch_width", "coalesce_ratio")
    for k in nan:
        assert (np.isnan(got.pop(k)) and np.isnan(want.pop(k))) if not coalesce else (
            got.pop(k) == want.pop(k))
    assert got == want
    assert port.compiles_steady == 0
    if coalesce:
        assert port.mean_batch_width == 4.0 and port.coalesce_ratio == 1.0
    assert (port.kernel, port.dtype, port.dtype_storage) == ("cuda", "float32", "native")
    assert port.wall_s > 0 and 0 < port.p50_dispatch_ms <= port.p99_dispatch_ms
    snapshot = json.loads((tmp_path / "port_metrics.json").read_text())
    assert snapshot["histograms"]["serve_e2e_latency_ms"]["count"] == 24


@pytest.mark.parametrize("coalesce", [False, True])
def test_poisson_open_loop_serves_every_request(coalesce):
    res = run_serve_load("blockwise", port_mesh(4), 64, 64, n_requests=30, max_bucket=8,
                         promote=4, arrival="poisson", rate=3000.0, coalesce=coalesce,
                         seed=2, integrity_gate=True, deadline_ms=60_000.0,
                         max_in_flight=4)
    assert res.compiles_steady == 0 and res.n_requests == 30
    assert res.total_cols == 30 and res.rate_req_s == 3000.0
    assert res.arrival == "poisson" and res.coalesce == int(coalesce)
    assert (res.coalesce_ratio >= 0) if coalesce else np.isnan(res.coalesce_ratio)


def test_closed_loop_adaptive_window(tmp_path):
    """The default adaptive window and tuned flush width under 8 clients:
    every request served, no steady build, widths within the ladder."""
    res = run_serve_load("rowwise", port_mesh(), 64, 64, n_requests=40, max_bucket=8,
                         concurrency=8, seed=3)
    assert res.compiles_steady == 0 and res.b_star == 4
    assert 1.0 <= res.mean_batch_width <= 8.0 and 0 <= res.coalesce_ratio <= 1


# The chaos and SLO overlays are ported (the chaos cases below), and so is
# speculative storage: its case (match None) now serves the load protocol
# from an armed engine, whose exact requests ride native. Malformed overlay
# inputs fail up front, as in the JAX package, before any engine is built.
@pytest.mark.parametrize("kwargs, match", [
    ({"dtype_storage": "speculate"}, None),
    ({"poison_rate": -0.1}, "poison_rate"), ({"poison_rate": 1.5}, "poison_rate"),
    ({"fault_spec": "dispatch:explode"}, "explode"),
    ({"fault_spec": "teleport:device_error"}, "teleport"),
    ({"arrival": "uniform"}, "uniform"),
])
def test_unported_load_overlays_raise(kwargs, match):
    if match is None:
        res = run_serve_load("rowwise", port_mesh(), 64, 64, n_requests=4,
                             max_bucket=8, concurrency=2, **kwargs)
        assert res.n_requests == 4 and res.compiles_steady == 0
        assert res.dtype_storage == "native" and res.failed_requests == 0
        return
    with pytest.raises(ConfigError, match=match):
        run_serve_load("rowwise", port_mesh(), 64, 64, n_requests=4, **kwargs)


def test_run_serve_load_signature_covers_the_jax_one():
    """Every parameter of the JAX run_serve_load is the port's; the port
    adds the engine's deadline and backpressure."""
    import inspect

    ours = set(inspect.signature(run_serve_load).parameters)
    theirs = set(inspect.signature(jax_serve.run_serve_load).parameters)
    assert theirs - ours == set()
    assert ours - theirs == {"deadline_ms", "max_in_flight"}


# ----------------------------------------------------------------------- CLI


def test_load_cli_writes_the_jax_header(tmp_path, capsys):
    # Four clients against a full bucket of four and a 60 s window: every
    # coalesced flush is the fourth client's (fewer clients would wait the
    # window out).
    argv = ["--strategy", "rowwise", "--sizes", "64", "--n-requests", "16",
            "--max-bucket", "4", "--concurrency", "4", "--coalesce", "both",
            "--window-ms", "60000", "--flush-width", "4", "--data-root", str(tmp_path),
            *CPU_ARGS]
    assert serve.main(argv) == 0
    out = capsys.readouterr().out
    assert out.count("serve-load rowwise 64x64 p=8 closed c=4") == 2
    assert "2 serve configs measured" in out
    path = serve_csv_path("rowwise", tmp_path)
    assert path.read_text().splitlines()[0] == SERVE_CSV_HEADER == jax_serve.SERVE_CSV_HEADER
    rows = read_csv(path)
    assert [(r["concurrency"], r["coalesce"]) for r in rows] == [(4, 0), (4, 1)]
    assert all(r["compiles_steady"] == 0 for r in rows)
    assert rows[-1]["mean_batch_width"] == 4.0 and rows[-1]["coalesce_ratio"] == 1.0


def test_open_loop_cli_and_sequential_default(capsys):
    assert serve.main(["--strategy", "rowwise", "--sizes", "64", "--n-requests", "16",
                       "--max-bucket", "8", "--arrival", "burst", "--rate", "4000",
                       "--burst", "8", "--no-csv", *CPU_ARGS]) == 0
    assert "serve-load rowwise 64x64 p=8 burst c=1 coalesce=on" in capsys.readouterr().out
    # No load flag: the sequential protocol, promotion check included.
    assert serve.main(["--strategy", "rowwise", "--sizes", "64", "--n-requests", "8",
                       "--max-bucket", "8", "--no-csv", *CPU_ARGS]) == 0
    assert "promo x" in capsys.readouterr().out


@pytest.mark.parametrize("flag, value", [
    ("global_sched", "both"), ("demand_weight", "1.5"), ("decision_jsonl", "d.jsonl"),
    ("reshard", "auto"), ("dtype_storage", "speculate"),
])
def test_every_later_flag_is_refused(flag, value, tmp_path, capsys):
    """No flag is refused any more (the name is the refusal test's): the
    global scheduler's flags run a --tenants trace, and so does
    ``--dtype-storage speculate``, its tenants armed."""
    assert not hasattr(serve, "_LATER_FLAGS")
    if flag == "decision_jsonl":
        value = str(tmp_path / value)
    argv = ["--sizes", "64", "--no-csv", "--tenants", "2", "--n-requests", "4",
            f"--{flag.replace('_', '-')}", value, *CPU_ARGS]
    if flag != "global_sched":
        argv += ["--global-sched", "on"]
    assert serve.main(argv) == 0
    out = capsys.readouterr().out
    assert "gsched=on" in out
    assert ("gsched=off" in out) == (flag == "global_sched")


def test_serve_result_fields_unchanged():
    assert [f.name for f in dataclasses.fields(serve.ServeResult)] == [
        f.name for f in dataclasses.fields(jax_serve.ServeResult)]


# ------------------------------------------------------------- chaos mode


def test_poison_signature_and_serve_counters_equal_jax():
    assert serve.POISON_SIGNATURE == jax_serve.POISON_SIGNATURE


@pytest.mark.parametrize("coalesce, concurrency, n_poisoned", [
    (True, 4, 4), (False, 2, 2),
])
def test_chaos_poison_counts_failures_exactly(tmp_path, coalesce, concurrency, n_poisoned):
    """A seeded poison set fails exactly the poisoned requests (bisection
    isolates them when coalesced; submit() raises them when not), as the
    JAX package's run of the same config does; the availability columns,
    the counters and the CSV row carry it, and the obs panel's availability
    is the CSV's success rate."""
    from matvec_mpi_multiplier_torch.obs.__main__ import render_metrics

    n = 40 if coalesce else 20
    common = dict(n_requests=n, max_bucket=8, promote=1, concurrency=concurrency,
                  coalesce=coalesce, seed=0, poison_rate=0.1, fault_seed=3)
    port = run_serve_load("rowwise", port_mesh(), 64, 64,
                          metrics_out=str(tmp_path / "m.json"), **common)
    ref = jax_serve.run_serve_load("rowwise", jax_make_mesh(8), 64, 64, kernel="pallas",
                                   metrics_out=str(tmp_path / "jm.json"), **common)
    assert port.failed_requests == ref.failed_requests == n_poisoned
    assert port.success_rate == ref.success_rate == pytest.approx(1 - n_poisoned / n)
    snap = json.loads((tmp_path / "m.json").read_text())
    jsnap = json.loads((tmp_path / "jm.json").read_text())
    c, jc = snap["counters"], jsnap["counters"]
    for name in ("serve_failed_requests_total", "serve_requests_total",
                 "resil_breaker_opens_total"):
        assert c[name] == jc[name], name
    if coalesce:
        assert c["sched_isolated_failures_total"] == jc["sched_isolated_failures_total"] == n_poisoned
    assert c["serve_requests_total"] == n
    if not coalesce:  # the engine counts warmup's submits too
        assert c["engine_requests_total"] > n
    assert c["resil_faults_injected_total"] >= n_poisoned and "resil_retries_total" in c
    assert f"availability      {port.success_rate:.4f}" in render_metrics(snap)
    path = serve.append_serve_result(port, tmp_path)
    row = read_csv(path)[0]
    assert row["failed_requests"] == n_poisoned and 0.0 < row["success_rate"] < 1.0
    assert row["retries"] == port.retries and row["downgrades"] == port.downgrades


def test_chaos_uncoalesced_open_loop_counts_submit_failures():
    res = run_serve_load("rowwise", port_mesh(), 64, 64, n_requests=20, max_bucket=8,
                         promote=1, coalesce=False, arrival="poisson", rate=2000.0, seed=0,
                         poison_rate=0.1, fault_seed=3)
    ref = jax_serve.run_serve_load("rowwise", jax_make_mesh(8), 64, 64, n_requests=20,
                                   max_bucket=8, promote=1, coalesce=False, arrival="poisson",
                                   rate=2000.0, seed=0, poison_rate=0.1, fault_seed=3)
    assert res.failed_requests == ref.failed_requests == 2
    assert res.success_rate == pytest.approx(0.9)


def test_chaos_transient_faults_fully_recover_as_jax():
    """Retryable transient faults cost retries, not availability. One
    client: the fault ordinals are sequential, and seed 19 at p = 0.2 draws
    no run of 3 fires (the JAX package's case), so the counts are its."""
    common = dict(n_requests=30, max_bucket=8, promote=1, concurrency=1, coalesce=True,
                  seed=0, fault_spec="dispatch:device_error:p=0.2", fault_seed=19)
    port = run_serve_load("rowwise", port_mesh(), 64, 64, **common)
    ref = jax_serve.run_serve_load("rowwise", jax_make_mesh(8), 64, 64, kernel="pallas",
                                   **common)
    assert port.failed_requests == ref.failed_requests == 0
    assert port.success_rate == 1.0
    assert (port.retries, port.downgrades) == (ref.retries, ref.downgrades)
    assert port.retries > 0


def test_chaos_writes_slo_and_flight_files(tmp_path):
    """slo_out holds the run's burn-rate evaluation (its alert gauges in the
    snapshot agree) and flight_dir a bundle per typed failure, up to the
    recorder's cap; resilience=False serves the same plan without the
    policy."""
    res = run_serve_load("rowwise", port_mesh(), 64, 64, n_requests=40, max_bucket=8,
                         promote=1, concurrency=4, seed=0, poison_rate=0.1, fault_seed=3,
                         slo_out=str(tmp_path / "slo.json"),
                         flight_dir=str(tmp_path / "flight"),
                         metrics_out=str(tmp_path / "m.json"),
                         events_jsonl=str(tmp_path / "events.jsonl"))
    evaluation = json.loads((tmp_path / "slo.json").read_text())
    gauges = json.loads((tmp_path / "m.json").read_text())["gauges"]
    level = {"no_data": -1.0, "ok": 0.0, "ticket": 1.0, "page": 2.0}
    for name, target in evaluation["targets"].items():
        assert gauges[f"slo_{name}_alert"] == level[target["status"]]
    assert evaluation["targets"]["availability"]["status"] == "page"  # 10 % failed
    dumps = sorted((tmp_path / "flight").iterdir())
    assert 1 <= len(dumps) <= 4
    for path in dumps:
        bundle = json.loads(path.read_text())
        assert bundle["trigger"]["kind"] in obs_failure_kinds()
        assert "slo" in bundle and bundle["events"]
    events = [json.loads(ln) for ln in (tmp_path / "events.jsonl").read_text().splitlines()]
    assert all("request_id" in e or "cause_id" in e for e in events)
    assert res.failed_requests == 4
    plain = run_serve_load("rowwise", port_mesh(), 64, 64, n_requests=40, max_bucket=8,
                           promote=1, concurrency=4, seed=0, poison_rate=0.1, fault_seed=3,
                           resilience=False)
    assert plain.failed_requests == 4 and (plain.retries, plain.downgrades) == (0, 0)


def obs_failure_kinds():
    from matvec_mpi_multiplier_torch.obs import FAILURE_KINDS

    return FAILURE_KINDS


def test_chaos_cli_flags(tmp_path, capsys):
    """The six chaos flags through the CLI: load mode engages, the row and
    the summary carry the availability columns, and the obs CLI renders the
    SLO file and a bundle."""
    from matvec_mpi_multiplier_torch.obs.__main__ import main as obs_main

    argv = ["--strategy", "rowwise", "--sizes", "64", "--n-requests", "20",
            "--max-bucket", "8", "--promote", "1", "--fault-spec",
            "dispatch:device_error:p=0.1", "--fault-seed", "19", "--poison-rate", "0.1",
            "--breaker-reset-s", "1.5", "--slo-out", str(tmp_path / "slo.json"),
            "--flight-dir", str(tmp_path / "flight"), "--data-root", str(tmp_path),
            *CPU_ARGS]
    assert serve.main(argv) == 0
    out = capsys.readouterr().out
    assert "serve-load rowwise 64x64 p=8 closed c=1 coalesce=on" in out
    assert " ok=0.900 failed=2 retries=" in out
    rows = read_csv(serve_csv_path("rowwise", tmp_path))
    assert len(rows) == 1 and rows[0]["failed_requests"] == 2
    assert obs_main(["slo", str(tmp_path / "slo.json")]) == 0
    bundle = sorted((tmp_path / "flight").iterdir())[0]
    assert obs_main(["dump", str(bundle)]) == 0
    assert "flight bundle:" in capsys.readouterr().out
    args = serve.build_parser().parse_args(argv)
    assert (args.fault_seed, args.breaker_reset_s) == (19, 1.5)


@pytest.mark.parametrize("kwargs", [
    {"coalesce": True}, {"coalesce": False}, {"arrival": "poisson", "rate": 2000.0},
])
def test_chaos_run_frees_its_engine(monkeypatch, kwargs):
    """The run closes its engine, so its resident A is freed once the run
    returns, although failed requests' errors (whose tracebacks hold the
    frames they passed) may still refer to the engine: device memory never
    waits for the cycle collector."""
    import gc
    import weakref

    from matvec_mpi_multiplier_torch.engine import core

    made, init = [], core.MatvecEngine.__init__

    def tracked(self, *args, **kw):
        init(self, *args, **kw)
        made.extend(weakref.ref(t) for t in (self._a, *self._a.shards))

    monkeypatch.setattr(core.MatvecEngine, "__init__", tracked)
    gc.disable()
    try:
        res = run_serve_load("rowwise", port_mesh(), 64, 64, n_requests=40, max_bucket=8,
                             promote=1, concurrency=4, seed=0, poison_rate=0.1,
                             fault_seed=3, **kwargs)
        assert res.failed_requests == 4
        assert len(made) == 9 and [r() for r in made] == [None] * 9
    finally:
        gc.enable()
