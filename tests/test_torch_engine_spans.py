"""The engine's and the solver's spans on the profiler's clock
(``obs/tracing.py``, ``obs/annotations.py::profiler_span``,
``solvers/device_loop.py::host_read``) and the benchmark's reduction of them
(``cellbench/harness/program_spans.py``).

While a ``torch.profiler`` records, every request-tracer span is also an
``engine/<name>`` range, the event wait of a result's copy is
``engine/host_copy_wait``, a solver's loop is one ``solver/loop`` range and
each of its device->host reads one ``solver/host_read``; with no profiler,
``record_function`` is never entered. The reduction hands each idle gap of
the card to the thread that launched the work ending it, and each instant
to the innermost program span open there.
"""

import json
import threading

import numpy as np
import pytest
import torch

from cellbench.harness import program_spans
from cellbench.harness.program_spans import OUTSIDE, UNATTRIBUTED, attribute
from matvec_mpi_multiplier_torch import get_strategy
from matvec_mpi_multiplier_torch.engine import MatvecEngine
from matvec_mpi_multiplier_torch.engine.core import _host_copy
from matvec_mpi_multiplier_torch.obs import RequestTracer
from matvec_mpi_multiplier_torch.parallel.mesh import make_mesh
from matvec_mpi_multiplier_torch.solvers.ops import _build_solver

CPU = torch.device("cpu")
N = 64


def spd(seed: int = 0, n: int = N) -> np.ndarray:
    g = np.random.default_rng(seed).uniform(-1, 1, (n, n))
    a = (g + g.T) / 2
    np.fill_diagonal(a, np.abs(a).sum(axis=1) + 1.0)
    return a.astype(np.float32)


def profiled(fn, tmp_path, **kw) -> list[dict]:
    """The ``engine/*`` and ``solver/*`` ranges ``fn()`` records on the CPU
    profiler, in start order."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU], **kw) as p:
        fn()
    path = tmp_path / "trace.json"
    p.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return sorted((e for e in events if e.get("ph") == "X"
                   and e["name"].startswith(("engine/", "solver/"))),
                  key=lambda e: (e["ts"], -e["dur"]))


def inside(inner: dict, outer: dict) -> bool:
    return (inner["tid"] == outer["tid"] and outer["ts"] <= inner["ts"]
            and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"])


def children(events: list[dict], outer: dict) -> list[str]:
    return [e["name"] for e in events if e is not outer and inside(e, outer)]


# ------------------------------------------------------------ the program


def test_engine_phases_and_solver_reads_reach_the_profiler(tmp_path):
    a = spd()
    eng = MatvecEngine(a, make_mesh(2, devices=[CPU] * 2), strategy="rowwise",
                       promote=4, max_bucket=8)
    x = torch.ones(N)
    eng.submit(x).result()  # the builds, before the profile
    eng.submit(torch.ones(N, 8)).result()
    eng.submit(op="cg", rhs=x, rtol=1e-6).result()

    def requests():
        eng.submit(x).result()
        eng.submit(torch.ones(N, 8)).result()
        res = eng.submit(op="cg", rhs=x, rtol=1e-6).result()
        assert res.converged

    events = profiled(requests, tmp_path)
    submits = [e for e in events if e["name"] == "engine/submit"]
    results = [e for e in events if e["name"] == "engine/materialize"]
    assert len(submits) == len(results) == 3
    for submit in submits:
        assert {"engine/gate", "engine/exec_lookup", "engine/dispatch"} <= set(
            children(events, submit))
        assert "engine/materialize" not in children(events, submit)
    assert "engine/bucket_pad" in children(events, submits[1])
    # The solve: one loop inside the dispatch, reads inside the loop, and
    # the result's two reads (the iterate and the stacked scalars).
    (dispatch,) = [e for e in events
                   if e["name"] == "engine/dispatch" and inside(e, submits[2])]
    (loop,) = [e for e in events if e["name"] == "solver/loop"]
    assert inside(loop, dispatch)
    reads = [e for e in events if e["name"] == "solver/host_read"]
    assert reads and all(inside(r, loop) or inside(r, results[2]) for r in reads)
    assert children(events, results[2]) == ["solver/host_read"] * 2
    # The CPU copies without an event: no wait span.
    assert not any(e["name"] == "engine/host_copy_wait" for e in events)
    eng.close()


def test_tracer_trees_are_the_same_with_and_without_a_profiler(tmp_path):
    a = spd(1)
    eng = MatvecEngine(a, make_mesh(2, devices=[CPU] * 2), strategy="rowwise",
                       promote=4, max_bucket=8)

    def requests():
        eng.submit(torch.ones(N)).result()
        eng.submit(torch.ones(N, 3)).result()
        eng.submit(op="cg", rhs=torch.ones(N), rtol=1e-6).result()

    def shape(span):
        return (span["name"], json.dumps(span.get("attrs", {}), sort_keys=True),
                tuple(shape(c) for c in span.get("children", ())))

    requests()  # the builds
    warm = len(eng.tracer.traces())
    requests()
    plain = [tuple(shape(s) for s in r["spans"]) for r in eng.tracer.traces()[warm:]]
    profiled(requests, tmp_path)
    traced = [tuple(shape(s) for s in r["spans"])
              for r in eng.tracer.traces()[warm + len(plain):]]
    assert traced == plain
    eng.close()


@pytest.mark.parametrize("op", ["cg", "chebyshev"])
def test_device_loop_reads_are_its_host_read_spans(tmp_path, op):
    """A device-loop solve (eager off the card: whole chunks, two ``when``
    reads an iteration) counts every read it makes, one span each."""
    a = torch.from_numpy(spd(2))
    fn = _build_solver(op, get_strategy("rowwise"), make_mesh(1, devices=[CPU]), "device",
                       dtype=torch.float32)
    args = (a, torch.ones(N), 1e-6, 100, 1.0, float(2 * N))
    fn(*args)
    before = fn.device_loops.reads()
    out = []
    events = profiled(lambda: out.append(fn(*args)), tmp_path)
    reads = fn.device_loops.reads() - before
    chunks = -(-int(out[0].n_iters) // 16)
    # read() once and once a chunk; each of a chunk's 16 iterations reads
    # its two when() flags.
    assert reads == 1 + chunks * (1 + 2 * 16)
    assert sum(e["name"] == "solver/host_read" for e in events) == reads
    assert sum(e["name"] == "solver/loop" for e in events) == 1


@pytest.mark.parametrize("op", ["cg", "gmres", "power", "lanczos", "chebyshev"])
def test_every_host_stepped_solve_has_one_loop_span(tmp_path, op):
    a = torch.from_numpy(spd(3))
    fn = _build_solver(op, get_strategy("rowwise"), make_mesh(1, devices=[CPU]), "host",
                       dtype=torch.float32)
    args = (a, torch.ones(N), 1e-6, 50, 1.0, float(2 * N))
    events = profiled(lambda: fn(*args), tmp_path)
    (loop,) = [e for e in events if e["name"] == "solver/loop"]
    reads = [e for e in events if e["name"] == "solver/host_read"]
    assert all(inside(r, loop) for r in reads)
    assert (len(reads) == 0) == (op == "lanczos")


def test_no_profiler_enters_no_record_function(monkeypatch):
    a = spd(4)
    eng = MatvecEngine(a, make_mesh(2, devices=[CPU] * 2), strategy="rowwise",
                       promote=4, max_bucket=8)
    fn = _build_solver("cg", get_strategy("rowwise"), make_mesh(1, devices=[CPU]), "device",
                       dtype=torch.float32)
    monkeypatch.setattr(
        torch.profiler, "record_function",
        lambda name: (_ for _ in ()).throw(AssertionError("entered")),
    )
    eng.submit(torch.ones(N)).result()
    eng.submit(torch.ones(N, 8)).result()
    eng.submit(op="cg", rhs=torch.ones(N), rtol=1e-6).result()
    fn(torch.from_numpy(a), torch.ones(N), 1e-6, 100, 0.0, 0.0)
    eng.close()


def test_a_range_closes_on_the_thread_that_opened_it(tmp_path):
    """``finish`` from another thread leaves a span's range to its opener;
    ``finish`` on the opener's thread closes what is still open."""
    tracer = RequestTracer()
    tids = {}

    def run():
        trace = tracer.start()
        ctx = trace.span("materialize")
        worker = threading.Thread(target=trace.finish)
        worker.start()
        worker.join()
        ctx.__exit__(None, None, None)
        other = tracer.start()
        other.span("left_open")  # never exited: finish closes it
        other.finish()
        tids["main"] = threading.get_native_id()

    events = profiled(run, tmp_path)
    assert [e["name"] for e in events] == ["engine/materialize", "engine/left_open"]
    assert {e["tid"] for e in events} == {tids["main"]}
    assert [r["spans"][0]["name"] for r in tracer.traces()] == ["materialize", "left_open"]


def test_a_client_thread_is_recorded_where_the_profiler_records_every_thread(tmp_path):
    """The profiler records the spans of the threads it profiles: a client
    thread's only under ``profile_all_threads``."""
    config = pytest.importorskip("torch._C._profiler")._ExperimentalConfig
    eng = MatvecEngine(spd(5), make_mesh(2, devices=[CPU] * 2), strategy="rowwise")
    eng.submit(torch.ones(N)).result()

    def client():
        worker = threading.Thread(target=lambda: eng.submit(torch.ones(N)).result())
        worker.start()
        worker.join()

    assert profiled(client, tmp_path) == []
    try:
        every = config(profile_all_threads=True)
    except TypeError:
        pytest.skip("this torch has no profile_all_threads")
    names = {e["name"] for e in profiled(client, tmp_path, experimental_config=every)}
    assert {"engine/submit", "engine/dispatch", "engine/materialize"} <= names
    eng.close()


@pytest.mark.cuda
def test_card_copy_wait_and_solve_reads(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run `python -m pytest --noconftest -m cuda "
                    "tests/test_torch_engine_spans.py` on the chip")
    card = torch.device("cuda", 0)
    y = torch.arange(8.0, device=card)
    events = profiled(lambda: _host_copy(y), tmp_path)
    assert [e["name"] for e in events] == ["engine/host_copy_wait"]
    fn = _build_solver("cg", get_strategy("rowwise"), make_mesh(1, devices=[card]), None,
                       dtype=torch.float32)
    a = torch.from_numpy(spd(6, 1024)).to(card)
    b = torch.ones(1024, device=card)
    fn(a, b, 1e-6, 100, 0.0, 0.0)
    before = fn.device_loops.reads()
    events = profiled(lambda: fn(a, b, 1e-6, 100, 0.0, 0.0), tmp_path)
    reads = fn.device_loops.reads() - before
    assert fn.loop == "device" and reads > 0
    assert sum(e["name"] == "solver/host_read" for e in events) == reads


# ----------------------------------------------------------- the reduction


def X(name, cat, ts, dur, tid=1, **args):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "pid": 1, "tid": tid}
    if args:
        e["args"] = args
    return e


def two_thread_trace() -> dict:
    """A window of 100 us; kernels at [10, 30), [50, 60) and [80, 90).

    - gap [0, 10): kernel 1 was launched by thread 1 (correlation 1), which
      was in engine/submit over [0, 4) and engine/dispatch inside it over
      [4, 10): 4 us submit, 6 us dispatch.
    - gap [30, 50): kernel 2 was launched by thread 2, in
      engine/materialize over [25, 40) with engine/host_copy_wait inside it
      over [28, 35), and in no span over [40, 50): 5 us wait, 5 us
      materialize, 10 us outside.
    - gap [60, 80): kernel 3 carries no correlation; the last launch before
      80 is thread 1's at 70, whose solver/loop is open over [55, 95): 20 us
      loop.
    - gap [90, 100): no op ends it; the last launch before 100 is thread
      1's at 70: 5 us loop (to 95), 5 us outside.
    Thread 2's engine/submit over [0, 10) is not the launcher's: it takes
    nothing.
    """
    ev = [
        X("cellbench.window", "user_annotation", 0, 100, tid=9),
        X("engine/submit", "user_annotation", 0, 10, tid=1),
        X("engine/dispatch", "user_annotation", 4, 6, tid=1),
        X("engine/submit", "user_annotation", 0, 10, tid=2),
        X("engine/materialize", "user_annotation", 25, 15, tid=2),
        X("engine/host_copy_wait", "user_annotation", 28, 7, tid=2),
        X("solver/loop", "user_annotation", 55, 40, tid=1),
        X("solver/host_read", "user_annotation", 56, 2, tid=1),
        X("cudaLaunchKernel", "cuda_runtime", 8, 1, tid=1, correlation=1),
        X("cudaLaunchKernel", "cuda_runtime", 45, 1, tid=2, correlation=2),
        X("cudaLaunchKernel", "cuda_runtime", 70, 1, tid=1, correlation=3),
        X("cudaEventSynchronize", "cuda_runtime", 75, 5, tid=2, correlation=4),
        X("gemv", "kernel", 10, 20, tid=7, correlation=1),
        X("gemv", "kernel", 50, 10, tid=7, correlation=2),
        X("gemv", "kernel", 80, 10, tid=7),
    ]
    return {"traceEvents": ev}


def two_thread_trace_without_launches() -> dict:
    """A gap that no thread launched anything into: (unattributed)."""
    ev = [X("cellbench.window", "user_annotation", 0, 50, tid=9),
          X("engine/submit", "user_annotation", 0, 50, tid=1),
          X("gemv", "kernel", 20, 10, tid=7)]
    return {"traceEvents": ev}


def test_idle_gaps_go_to_the_launching_threads_spans():
    got = attribute(two_thread_trace())
    want_us = {"engine/submit": 4, "engine/dispatch": 6, "engine/host_copy_wait": 5,
               "engine/materialize": 5, OUTSIDE: 15, "solver/loop": 25}
    assert got.window_s == pytest.approx(100e-6)
    assert got.idle_s == pytest.approx(60e-6)
    assert got.by_span == pytest.approx({k: v * 1e-6 for k, v in want_us.items()})
    assert sum(got.by_span.values()) == pytest.approx(got.idle_s)
    assert got.under == pytest.approx({"engine/submit": 10e-6, "engine/dispatch": 6e-6,
                                       "engine/materialize": 10e-6,
                                       "engine/host_copy_wait": 5e-6, "solver/loop": 25e-6})
    assert got.idle_share_under("engine/materialize") == pytest.approx(10.0)
    assert got.count("solver/host_read") == 1
    assert got.count("engine/escalate") is None
    assert got.idle_share_under("engine/escalate") is None


def test_a_gap_without_a_launch_is_unattributed():
    got = attribute(two_thread_trace_without_launches())
    assert got.by_span == pytest.approx({UNATTRIBUTED: 40e-6})
    assert sum(got.by_span.values()) == pytest.approx(got.idle_s)


def test_this_runs_trace_is_found_by_workload_and_seed(tmp_path, monkeypatch):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    monkeypatch.setattr("tempfile.tempdir", None)
    path = program_spans.trace_path("cg_fp32.solve", 5)
    path.parent.mkdir(parents=True)
    path.write_text(json.dumps(two_thread_trace()))
    other = program_spans.trace_path("cg_fp32.solve", 6)
    other.write_text(json.dumps(two_thread_trace_without_launches()))
    argv = ["--workload", "cg_fp32.solve", "--seed", "5", "--seconds", "10", "--trace", "1"]
    assert program_spans.this_run(argv) == path
    assert program_spans.read_this_run(argv).count("solver/host_read") == 1
    argv[3] = "6"
    assert program_spans.this_run(argv) == other
    assert program_spans.read_this_run(argv).count("solver/host_read") is None
    assert program_spans.this_run(["--workload", "cg_fp32.solve", "--seed", "7"]) is None
    assert program_spans.this_run(["--seed", "5"]) is None
    monkeypatch.setattr("sys.argv", ["cellbench/run.py", *argv])
    assert program_spans.this_run() == other
