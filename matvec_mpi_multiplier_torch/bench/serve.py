"""Serve-throughput benchmark: the request-stream face of the suite.

The port's counterpart of the JAX package's ``bench/serve.py``, its
sequential protocol. Where ``bench.sweep`` measures one matvec at a time,
this drives the serving engine (``engine/``) with a mixed-width stream of
right-hand-side blocks against a resident sharded ``A`` and reports:

* **requests/sec** and **columns/sec** over the steady phase;
* **p50/p99 dispatch latency** — ``submit()`` entry to return: the host's
  cost of one request, which on the card includes the request's pageable
  host→device copy but not the device's execution (the stream drains once
  at the end). Percentiles come from the obs histogram;
* **compile counts** per phase — after warmup covers the widths,
  ``compiles_steady`` must be 0 across the mixed-width replay;
* the **GEMV→GEMM promotion check** — one block of ``b*`` columns against
  ``b*`` single-column dispatches, through the same warm engine under the
  same wall-clock protocol.

**Load mode** (:func:`run_serve_load`) drives the *continuous-batching*
face instead: a closed-loop ``--concurrency`` axis (N clients, each
submit→materialize→repeat) or an open-loop arrival process (``--arrival
poisson|burst --rate``), optionally through the arrival-window scheduler
(``engine/scheduler.py``, ``--coalesce on|off|both``). Load rows report
requests/sec under offered load, **end-to-end** p50/p99 latency (submit
entry to materialized result, in the latency columns), the mean batch width
and the coalesce ratio (NaN uncoalesced). ``--coalesce both`` measures each
config uncoalesced, then coalesced, on the same seeded trace.

**Chaos mode** (the load protocol under seeded faults): ``--fault-spec``
arms a :class:`~..resilience.FaultPlan` (``--fault-seed`` seeds it and the
retry jitter), ``--poison-rate`` plants :data:`POISON_SIGNATURE` in row 0 of
a seeded share of the requests with a persistent poison fault keyed on it,
and the engine serves under a :class:`~..resilience.ResiliencePolicy`
(``--breaker-reset-s`` is its breakers' cooldown). Rows then carry the
availability columns (``success_rate``, ``failed_requests``, ``retries``,
``downgrades``); the plan is disarmed through warmup. ``--slo-out`` writes
the run's SLO burn-rate evaluation and ``--flight-dir`` arms a flight
recorder that dumps a bundle on each typed failure (render both with
``python -m matvec_mpi_multiplier_torch.obs slo|dump``).

Rows land in ``data/out/serve_<strategy>.csv`` under the JAX package's
header, byte for byte. ``--dtype-storage int8|int8c|fp8`` serves from a
quantized resident (the row records the resolved format and the engine's
resident bytes). ``--dtype-storage speculate --spec-rtol R`` arms the
speculative tier and sends every steady request with ``rtol=R``: the row's
``speculated`` counts the requests the int8c tier served,
``escalation_rate`` is the engine's gauge and ``spec_bandwidth_ratio`` the
resident bytes a request streams against native, ``(speculative set +
rate x native) / native``.

**Multi-tenant trace mode** (:func:`run_serve_multitenant`, ``--tenants
N``): N seeded tenant matrices registered in a
:class:`~..engine.MatrixRegistry` against ``--hbm-budget`` (bytes, or a
payload multiple like ``2x``), driven by a Zipf(``--zipf-a``)
tenant-popularity trace of ``--n-requests`` vector requests, with
``--pin-hot K`` warm-pinned tenants and ``--tenant-quota`` admission
quotas. The chaos overlay applies per tenant: ``--fault-spec`` patterns may
target one tenant (``key=tenant-1/*``) and ``--poison-tenant`` confines
``--poison-rate`` to one tenant's requests. ``--deadline-ms`` paces the
trace at ``--rate`` req/s with deadlines anchored at each request's
scheduled arrival, and ``--max-in-flight`` arms each tenant engine's
backpressure gate. One row per tenant plus an ``ALL`` row land in
``serve_tenants_<strategy>.csv`` under the JAX package's header.
``--global-sched on|off|both`` routes the trace through the cost-model-driven
global scheduler (``both``: greedy first, then scheduled, on the same seeded
trace; rejected requests in the ``rejected`` column), with
``--demand-weight``, ``--decision-jsonl`` and ``--reshard auto`` (its
crossover trigger). :func:`run_reshard_drift` is the drifting-shape A/B of
that trigger.

``--op cg|gmres|power|lanczos|chebyshev`` serves ANSWERS instead
(:func:`run_serve_solver`): each request is one solve against the seeded SPD
:func:`solver_operand`, ``--n-requests`` is the steady solve count, and rows
land in ``serve_solver_<strategy>.csv`` under the JAX package's header.
``--solver-kernel torch|cuda_fused|auto`` picks the iteration tier.

Usage::

    python -m matvec_mpi_multiplier_torch.bench.serve --strategy blockwise \\
        --sizes 65536 --dtype bfloat16 --promote 4
    python -m matvec_mpi_multiplier_torch.bench.serve --platform cpu \\
        --host-devices 8 --sizes 64 --n-requests 20
    python -m matvec_mpi_multiplier_torch.bench.serve --op cg \\
        --strategy rowwise --sizes 65536 --solver-kernel cuda_fused --rtol 1e-5
    python -m matvec_mpi_multiplier_torch.bench.serve --strategy blockwise \\
        --sizes 65536 --dtype bfloat16 --concurrency 1 8 32 --coalesce both
    python -m matvec_mpi_multiplier_torch.bench.serve --strategy blockwise \\
        --sizes 65536 --dtype bfloat16 --concurrency 8 \\
        --fault-spec 'dispatch:device_error:p=0.05' --poison-rate 0.02 \\
        --slo-out slo.json --flight-dir flight/
    python -m matvec_mpi_multiplier_torch.bench.serve --strategy blockwise \\
        --sizes 65536 --dtype bfloat16 --devices 1 --tenants 4 --zipf-a 1.1 \\
        --hbm-budget 2x --pin-hot 1 --n-requests 120
    python -m matvec_mpi_multiplier_torch.bench.serve --strategy blockwise \\
        --sizes 65536 --dtype bfloat16 --devices 1 --tenants 3 --zipf-a 1.1 \\
        --hbm-budget 2x --deadline-ms 50 --rate 200 --global-sched both \\
        --decision-jsonl decisions.jsonl

    # or through the sweep CLI:
    python -m matvec_mpi_multiplier_torch.bench.sweep --op serve ...

This is timing code: host syncs are deliberate protocol fences here.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import queue
import sys
import threading
import time
from pathlib import Path
from typing import Sequence

import numpy as np
import torch

from ..engine.core import DEFAULT_SOLVER_MAXITER, SOLVER_KERNELS, MatvecEngine
from ..engine.registry import MatrixRegistry, TenantQuota
from ..engine.scheduler import DEFAULT_MAX_WINDOW_MS, ArrivalWindowScheduler
from ..models import available_strategies
from ..obs.flight import FlightRecorder
from ..obs.registry import MetricsRegistry
from ..obs.sink import JsonlSink, dump_json
from ..obs.slo import DEFAULT_TARGETS, SloMonitor
from ..obs.timeline import get_hub, reset_hub
from ..parallel.mesh import Mesh
from ..resilience import (
    FaultPlan,
    FaultSpec,
    ResiliencePolicy,
    RetryPolicy,
    parse_fault_spec,
)
from ..solvers import SOLVER_OPS
from ..utils.convert import dtype_name, from_numpy, torch_dtype
from ..utils.errors import (
    AdmissionRejectedError,
    ConfigError,
    DeadlineExceededError,
    MatvecError,
    SolverDivergedError,
)

# The payload signature --poison-rate plants in row 0 of a poisoned request
# (and the matching FaultSpec(poison=...) keys on): far outside the
# uniform [0, 10) request distribution, exactly representable in every
# served float dtype.
POISON_SIGNATURE = 1e30

# Default request-width mix: single vectors through full buckets, with
# off-bucket widths (3, 6, 12, 24) so the pad/unpad path is always
# exercised. Clipped to --max-bucket.
DEFAULT_WIDTH_MIX = (1, 2, 3, 4, 6, 8, 12, 16, 24, 32)

# Load-mode width mix: single-column traffic, the workload coalescing exists
# for (every lone dispatch reads all of A for one output column).
LOAD_WIDTH_MIX = (1,)

SERVE_CSV_HEADER = (
    "n_rows, n_cols, n_devices, strategy, dtype, kernel, combine, "
    "b_star, max_bucket, n_requests, total_cols, wall_s, rps, cols_per_s, "
    "p50_dispatch_ms, p99_dispatch_ms, compiles_warmup, compiles_steady, "
    "hits_steady, promo_b, promo_gemm_s, promo_seq_s, promo_speedup, "
    "arrival, rate_req_s, concurrency, coalesce, mean_batch_width, "
    "coalesce_ratio, success_rate, failed_requests, retries, downgrades, "
    "dtype_storage, resident_bytes, speculated, escalation_rate, "
    "spec_bandwidth_ratio"
)


@dataclasses.dataclass(frozen=True)
class ServeResult:
    """One serve-bench measurement (one CSV row)."""

    n_rows: int
    n_cols: int
    n_devices: int
    strategy: str
    dtype: str
    kernel: str
    combine: str
    b_star: int | None
    max_bucket: int
    n_requests: int
    total_cols: int
    wall_s: float
    p50_dispatch_ms: float
    p99_dispatch_ms: float
    compiles_warmup: int
    compiles_steady: int
    hits_steady: int
    # Promotion check: one b-wide GEMM dispatch vs b sequential single-RHS
    # dispatches, per-request wall seconds (NaN when promotion is off).
    promo_b: int
    promo_gemm_s: float
    promo_seq_s: float
    # Load-mode columns (run_serve_load): the traffic shape offered and the
    # batching achieved; the sequential protocol's rows carry the defaults.
    # In load rows the latency columns above are end to end.
    arrival: str = "closed"
    rate_req_s: float = float("nan")
    concurrency: int = 1
    coalesce: int = 0
    mean_batch_width: float = float("nan")
    coalesce_ratio: float = float("nan")
    # Availability columns (chaos mode): failed_requests counts fault
    # failures — requests whose result() raised something other than a
    # deadline (those stay in the *_deadline_failures counters);
    # retries/downgrades are the recovery policy's tallies.
    failed_requests: int = 0
    retries: int = 0
    downgrades: int = 0
    dtype_storage: str = "native"
    resident_bytes: int = 0
    speculated: int = 0
    escalation_rate: float = float("nan")
    spec_bandwidth_ratio: float = float("nan")

    @property
    def success_rate(self) -> float:
        if self.n_requests == 0:
            return float("nan")
        return (self.n_requests - self.failed_requests) / self.n_requests

    @property
    def rps(self) -> float:
        return self.n_requests / self.wall_s

    @property
    def cols_per_s(self) -> float:
        return self.total_cols / self.wall_s

    @property
    def promo_speedup(self) -> float:
        """How many times faster the promoted block GEMM serves its batch
        than sequential dispatch would (>1 = promotion pays)."""
        if not (self.promo_gemm_s > 0):
            return float("nan")
        return self.promo_seq_s / self.promo_gemm_s


def serve_csv_path(strategy: str, root=None):
    from .metrics import out_dir

    return out_dir(root) / f"serve_{strategy}.csv"


def append_serve_result(result: ServeResult, root=None):
    from ..parallel.distributed import is_main_process
    from .metrics import _append_row

    path = serve_csv_path(result.strategy, root)
    if not is_main_process():
        return path
    row = (
        f"{result.n_rows}, {result.n_cols}, {result.n_devices}, "
        f"{result.strategy}, {result.dtype}, {result.kernel}, "
        f"{result.combine}, "
        f"{result.b_star if result.b_star is not None else -1}, "
        f"{result.max_bucket}, {result.n_requests}, {result.total_cols}, "
        f"{result.wall_s:.6f}, {result.rps:.2f}, {result.cols_per_s:.2f}, "
        f"{result.p50_dispatch_ms:.4f}, {result.p99_dispatch_ms:.4f}, "
        f"{result.compiles_warmup}, {result.compiles_steady}, "
        f"{result.hits_steady}, {result.promo_b}, "
        f"{result.promo_gemm_s:.6f}, {result.promo_seq_s:.6f}, "
        f"{result.promo_speedup:.3f}, {result.arrival}, "
        f"{result.rate_req_s:.2f}, {result.concurrency}, "
        f"{result.coalesce}, {result.mean_batch_width:.3f}, "
        f"{result.coalesce_ratio:.3f}, {result.success_rate:.4f}, "
        f"{result.failed_requests}, {result.retries}, {result.downgrades}, "
        f"{result.dtype_storage}, {result.resident_bytes}, "
        f"{result.speculated}, {result.escalation_rate:.4f}, "
        f"{result.spec_bandwidth_ratio:.4f}"
    )
    _append_row(path, SERVE_CSV_HEADER, row)
    return path


def resident_matrix(
    m: int, k: int, dtype: torch.dtype, device: torch.device, seed: int
) -> torch.Tensor:
    """A seeded uniform [0, 10) (m, k) matrix made on ``device`` in row
    chunks (the reference's range), so that no float64 host copy of a
    full-width A is ever held (65536² would be 34 GB)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    out = torch.empty((m, k), dtype=dtype, device=device)
    rows = max(1, (1 << 28) // max(1, k))
    for i in range(0, m, rows):
        n = min(rows, m - i)
        out[i:i + n] = torch.rand((n, k), generator=gen, device=device) * 10
    return out


def _request_pool(
    k: int, widths: Sequence[int], dtype: torch.dtype, seed: int
) -> dict[int, torch.Tensor]:
    """One seeded host block per distinct width — generated once so the
    timed loop measures dispatch, not the RNG. Drawn in float64 with numpy
    and cast by torch, so every dtype (bf16 included) works without numpy
    knowing it. The widths are drawn in the JAX package's order (a set's
    iteration order), so one seed gives both packages the same payloads and
    the same width sequence."""
    rng = np.random.default_rng(seed)
    return {
        w: torch.from_numpy(rng.uniform(0, 10, (k, w))).to(dtype)
        for w in set(widths)
    }


def _drain(futures) -> None:
    """Protocol fence: materialize every outstanding result."""
    for fut in futures:
        fut.result()


def measure_promotion(
    engine: MatvecEngine, pool: dict[int, torch.Tensor], *, n_reps: int = 20
) -> tuple[int, float, float]:
    """One promoted block dispatch vs the same columns served one by one,
    through the SAME warm engine and the same wall-clock protocol (submit
    everything, drain once). Returns per-request seconds
    ``(b, t_gemm, t_seq)``, or ``(0, nan, nan)`` when promotion is off."""
    if engine.b_star is None:
        return 0, float("nan"), float("nan")
    b = max(2, min(engine.b_star, engine.max_bucket))
    block = pool.get(b)
    if block is None:
        block = _request_pool(engine.k, [b], engine.dtype, seed=7)[b]
    cols = [block[:, j].contiguous() for j in range(b)]

    # Warm both paths (build + first-run costs out of the timed region).
    _drain([engine.submit(block)])
    _drain([engine.submit(c) for c in cols])

    start = time.perf_counter()
    _drain([engine.submit(block) for _ in range(n_reps)])
    t_gemm = (time.perf_counter() - start) / n_reps

    start = time.perf_counter()
    futures = []
    for _ in range(n_reps):
        futures.extend(engine.submit(c) for c in cols)
    _drain(futures)
    t_seq = (time.perf_counter() - start) / n_reps
    return b, t_gemm, t_seq


def run_serve(
    strategy_name: str,
    mesh: Mesh,
    m: int,
    k: int,
    *,
    dtype: str = "float32",
    kernel: str = "cuda",
    combine: str | None = None,
    stages: int | None = None,
    n_requests: int = 200,
    max_bucket: int = 32,
    widths: Sequence[int] | None = None,
    promote: str | int | None = "auto",
    donate: bool = True,
    seed: int = 0,
    promo_reps: int = 20,
    metrics_out: str | None = None,
    dtype_storage: str | None = None,
    rtol: float | None = None,
) -> ServeResult:
    """Run the serve protocol for one (strategy, shape, mesh) config.

    A is made on the mesh's first device (:func:`resident_matrix`) and
    placed by the engine; with ``dtype_storage`` the engine quantizes it
    there and drops it, so the card holds the payload alone while serving.
    ``combine`` and ``stages`` go to the engine (``MatvecEngine``).
    ``metrics_out`` writes the run's metrics snapshot (engine counters + the
    steady-phase dispatch-latency histogram, one registry) as JSON.
    ``rtol`` goes with every steady-phase request: with
    ``dtype_storage="speculate"`` it routes the stream through the int8c
    speculative tier (escalating on a failed check); None keeps every
    request exact.
    """
    if widths is None:
        widths = [w for w in DEFAULT_WIDTH_MIX if w <= max_bucket]
    registry = MetricsRegistry()
    engine = MatvecEngine(
        resident_matrix(m, k, torch_dtype(dtype), mesh.devices[0], seed),
        mesh, strategy=strategy_name, kernel=kernel, combine=combine,
        stages=stages, max_bucket=max_bucket, promote=promote, donate=donate,
        metrics=registry, dtype_storage=dtype_storage,
    )
    latency_hist = registry.histogram(
        "serve_dispatch_latency_ms",
        "steady-phase submit() entry-to-return host time",
        # Sized to the run: percentiles exact over the whole steady phase.
        window=max(n_requests, 1),
    )
    pool = _request_pool(k, widths, engine.dtype, seed=seed + 1)

    # ---- warmup: cover the program set, then fence ----
    engine.warmup(widths)
    _drain([engine.submit(pool[w]) for w in sorted(set(widths))])
    warm_stats = engine.stats
    compiles_warmup = warm_stats.compiles

    # ---- steady phase: mixed-width replay, drain once ----
    rng = np.random.default_rng(seed + 2)
    sequence = rng.choice(list(pool), size=n_requests)
    futures = []
    start = time.perf_counter()
    for w in sequence:
        t0 = time.perf_counter()
        futures.append(engine.submit(pool[int(w)], rtol=rtol))
        latency_hist.observe((time.perf_counter() - t0) * 1e3)
    _drain(futures)
    wall = time.perf_counter() - start
    steady_stats = engine.stats
    # Read after the drain: escalations settle at result().
    speculated, esc_rate, spec_ratio = speculative_columns(engine, m, k)

    promo_b, promo_gemm, promo_seq = measure_promotion(
        engine, pool, n_reps=promo_reps
    )
    if metrics_out is not None:
        _ = engine.stats  # refresh the in_flight gauge before exporting
        path = Path(metrics_out)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(registry.snapshot(), indent=2) + "\n")
    engine.close()
    return ServeResult(
        n_rows=m,
        n_cols=k,
        n_devices=mesh.size,
        strategy=strategy_name,
        dtype=dtype_name(engine.dtype),
        kernel=kernel if isinstance(kernel, str) else "custom",
        combine=combine or "default",
        b_star=engine.b_star,
        max_bucket=max_bucket,
        n_requests=n_requests,
        total_cols=int(sum(int(w) for w in sequence)),
        wall_s=wall,
        p50_dispatch_ms=latency_hist.percentile(50),
        p99_dispatch_ms=latency_hist.percentile(99),
        compiles_warmup=compiles_warmup,
        compiles_steady=steady_stats.compiles - compiles_warmup,
        hits_steady=steady_stats.hits - warm_stats.hits,
        promo_b=promo_b,
        promo_gemm_s=promo_gemm,
        promo_seq_s=promo_seq,
        dtype_storage=engine.storage,
        resident_bytes=engine.resident_bytes,
        speculated=speculated,
        escalation_rate=esc_rate,
        spec_bandwidth_ratio=spec_ratio,
    )


def speculative_columns(engine, m: int, k: int) -> tuple[int, float, float]:
    """The serve row's speculative columns, the JAX package's formula:
    requests the int8c tier served, the engine's escalation rate, and the
    resident bytes a request streams against native, ``(speculative set +
    rate x native A) / native A``. NaN for the last two on an engine that is
    not armed."""
    health = engine.health()
    speculated = int(health["counters"]["speculative_dispatches"])
    if not engine.spec_resident_bytes:
        return speculated, float("nan"), float("nan")
    rate = float(health["storage"]["escalation_rate"])
    native = int(m) * int(k) * torch.empty((), dtype=engine.dtype).element_size()
    return speculated, rate, (engine.spec_resident_bytes + rate * native) / native


# ------------------------------------------------------------------ load


def _arrival_gaps(arrival: str, n: int, rate: float, burst: int, rng) -> list[float]:
    """Inter-arrival gaps (seconds) for the open-loop processes: Poisson
    (exponential gaps at ``rate`` req/s) or bursty (groups of ``burst``
    simultaneous arrivals, one group per ``burst/rate`` seconds — the same
    offered rate, coalescable at once). The JAX package's draws, gap for
    gap."""
    if rate <= 0:
        raise MatvecError(f"open-loop arrival needs rate > 0, got {rate}")
    if arrival == "poisson":
        return list(rng.exponential(1.0 / rate, size=n))
    if arrival == "burst":
        if burst < 1:
            raise MatvecError(f"burst size must be >= 1, got {burst}")
        return [(burst / rate) if i % burst == 0 else 0.0 for i in range(n)]
    raise MatvecError(f"unknown arrival process {arrival!r}")


def _closed_loop(submit, blocks: Sequence[torch.Tensor], concurrency: int, hist,
                 fail_counter=None) -> float:
    """Closed-loop load: ``concurrency`` client threads, each
    submit→materialize→repeat over its slice of the request trace. Returns
    the steady phase's wall seconds; each request's END-TO-END latency lands
    in ``hist``. A deadline failure is counted by the gates and the client
    moves on. With ``fail_counter`` (chaos mode) a request failing with a
    framework fault (an injected error, an integrity refusal) is counted and
    the client moves on; any other failure aborts the run (a bench bug must
    not read as downtime)."""
    barrier = threading.Barrier(concurrency + 1)
    errors: list[BaseException] = []

    def client(tid: int) -> None:
        try:
            barrier.wait()
            for i in range(tid, len(blocks), concurrency):
                t0 = time.perf_counter()
                try:
                    # An uncoalesced poisoned dispatch raises from submit()
                    # itself; a coalesced one from result().
                    submit(blocks[i]).result()
                except DeadlineExceededError:
                    continue  # tallied by the gates' deadline counters
                except MatvecError:
                    if fail_counter is None:
                        raise
                    fail_counter.inc()
                    continue
                hist.observe((time.perf_counter() - t0) * 1e3)
        except BaseException as e:  # surface on the calling thread
            errors.append(e)

    threads = [threading.Thread(target=client, args=(t,), daemon=True)
               for t in range(concurrency)]
    for t in threads:
        t.start()
    barrier.wait()
    start = time.perf_counter()
    for t in threads:
        t.join()
    wall = time.perf_counter() - start
    if errors:
        raise errors[0]
    return wall


def _open_loop(submit, blocks: Sequence[torch.Tensor], gaps: Sequence[float], hist,
               flush=None, fail_counter=None) -> float:
    """Open-loop load: requests arrive on the precomputed gap schedule
    whatever completes (one thread paces arrivals; a drainer thread
    materializes in order and records arrival→result latency). Returns wall
    seconds from the first arrival to the last result. ``fail_counter`` as
    in :func:`_closed_loop`: chaos-mode fault failures are counted,
    tolerated and kept out of the latency histogram."""
    results: queue.Queue = queue.Queue()
    errors: list[BaseException] = []

    def drainer() -> None:
        while True:
            item = results.get()
            if item is None:
                return
            t_arrival, fut = item
            try:
                fut.result()
            except DeadlineExceededError:
                continue  # tallied by the gates' deadline counters
            except MatvecError as e:
                if fail_counter is None:
                    errors.append(e)
                else:
                    fail_counter.inc()
                continue
            except BaseException as e:
                errors.append(e)
                continue
            hist.observe((time.perf_counter() - t_arrival) * 1e3)

    drain_thread = threading.Thread(target=drainer, daemon=True)
    drain_thread.start()
    start = time.perf_counter()
    next_at = start
    try:
        for x, gap in zip(blocks, gaps):
            next_at += gap
            while True:
                now = time.perf_counter()
                if now >= next_at:
                    break
                time.sleep(min(next_at - now, 5e-4))
            try:
                results.put((time.perf_counter(), submit(x)))
            except MatvecError as e:
                # An uncoalesced poisoned dispatch raises at submit() on the
                # pacing thread: chaos mode counts it and keeps the arrival
                # schedule.
                if fail_counter is None:
                    errors.append(e)
                else:
                    fail_counter.inc()
        if flush is not None:
            flush()  # fence the open window so the drain is prompt
    finally:
        results.put(None)
        drain_thread.join()
    wall = time.perf_counter() - start
    if errors:
        raise errors[0]
    return wall


def run_serve_load(
    strategy_name: str,
    mesh: Mesh,
    m: int,
    k: int,
    *,
    dtype: str = "float32",
    kernel: str = "cuda",
    combine: str | None = None,
    stages: int | None = None,
    dtype_storage: str | None = None,
    n_requests: int = 200,
    max_bucket: int = 32,
    widths: Sequence[int] | None = None,
    promote: str | int | None = "auto",
    donate: bool = True,
    concurrency: int = 8,
    coalesce: bool = True,
    arrival: str = "closed",
    rate: float = 500.0,
    burst: int = 8,
    window_ms: str | float = "auto",
    max_window_ms: float = DEFAULT_MAX_WINDOW_MS,
    flush_width: str | int = "auto",
    deadline_ms: float | None = None,
    max_in_flight: int | None = None,
    seed: int = 0,
    metrics_out: str | None = None,
    trace_jsonl: str | None = None,
    events_jsonl: str | None = None,
    integrity_gate: bool = False,
    slo_out: str | None = None,
    flight_dir: str | None = None,
    fault_spec: str | None = None,
    fault_seed: int = 0,
    poison_rate: float = 0.0,
    resilience: bool | None = None,
    breaker_reset_s: float = 30.0,
) -> ServeResult:
    """Run the load protocol for one (strategy, shape, mesh, traffic)
    config: concurrent (closed-loop) or open-loop traffic, coalesced through
    the arrival-window scheduler or not. The request trace (widths, payloads
    and gaps, seeded as the JAX package seeds them) is the same for a
    coalesced and an uncoalesced run of one config.

    A is made on the mesh's first device (:func:`resident_matrix`, the
    serve protocol's A). Warmup builds (and on one card captures) the
    whole bucket ladder and runs every program once, so that no steady
    request pays a build: ``compiles_steady`` must be 0. ``deadline_ms``
    gives every request that deadline (the scheduler bypasses the window
    for one it cannot hold); ``max_in_flight`` is the engine's backpressure
    mark; ``integrity_gate`` arms the NaN/Inf gate (per request slice when
    coalesced). ``trace_jsonl`` streams one span tree per request and
    ``events_jsonl`` the event timeline (the process hub's sink, replaced
    for the run).

    Chaos mode (module docstring): ``fault_spec`` arms a seeded FaultPlan
    (``fault_seed``); ``poison_rate`` marks a seeded share of the requests
    with :data:`POISON_SIGNATURE` and appends a persistent poison fault
    spec; ``resilience`` (default: on whenever faults are armed) serves
    under the engine's retry/breaker/ladder policy with ``breaker_reset_s``
    cooldowns. ``slo_out`` arms a burn-rate monitor over the run's
    registry (sampled around the steady phase) and writes its evaluation
    JSON; ``flight_dir`` arms a flight recorder that dumps post-mortem
    bundles there on typed failures."""
    if arrival not in ("closed", "poisson", "burst"):
        raise ConfigError(f"unknown arrival process {arrival!r}")
    if not (0.0 <= poison_rate <= 1.0):
        raise ConfigError(f"poison_rate must be in [0, 1], got {poison_rate}")
    if widths is None:
        widths = [w for w in LOAD_WIDTH_MIX if w <= max_bucket]
    registry = MetricsRegistry()
    # Arm the observability overlays BEFORE the engine exists, so warmup and
    # the scheduler's decisions land on the same hub.
    hub = reset_hub(sink=JsonlSink(events_jsonl)) if events_jsonl is not None else None
    slo_monitor = SloMonitor(registry, DEFAULT_TARGETS) if slo_out is not None else None
    recorder = (
        FlightRecorder(hub if hub is not None else get_hub(), registry,
                       slo=slo_monitor, dump_dir=flight_dir)
        if flight_dir is not None else None
    )
    chaos = fault_spec is not None or poison_rate > 0
    plan = None
    if chaos:
        specs = (parse_fault_spec(fault_spec, seed=fault_seed).specs
                 if fault_spec is not None else ())
        if poison_rate > 0:
            specs = specs + (FaultSpec(site="dispatch", kind="device_error",
                                       poison=POISON_SIGNATURE),)
        plan = FaultPlan(specs, seed=fault_seed)
    if resilience is None:
        resilience = chaos
    policy = (ResiliencePolicy(retry=RetryPolicy(seed=fault_seed),
                               breaker_reset_s=breaker_reset_s)
              if resilience else None)
    engine = MatvecEngine(
        resident_matrix(m, k, torch_dtype(dtype), mesh.devices[0], seed),
        mesh, strategy=strategy_name, kernel=kernel, combine=combine,
        stages=stages, dtype_storage=dtype_storage, max_bucket=max_bucket,
        promote=promote, donate=donate, max_in_flight=max_in_flight,
        metrics=registry, trace_jsonl=trace_jsonl, integrity_gate=integrity_gate,
        fault_plan=plan, resilience=policy,
    )
    latency_hist = registry.histogram(
        "serve_e2e_latency_ms",
        "steady-phase submit-entry to materialized-result host time",
        window=max(n_requests, 1),
    )
    fail_counter = req_counter = None
    if chaos:
        fail_counter = registry.counter(
            "serve_failed_requests_total",
            "steady-phase requests whose result() raised a fault "
            "(deadline failures counted separately)",
        )
        # The availability denominator: the steady phase's offered requests
        # (engine_requests_total also counts warmup's submits).
        req_counter = registry.counter(
            "serve_requests_total",
            "steady-phase offered requests (the availability denominator)",
        )
    pool = _request_pool(k, widths, engine.dtype, seed=seed + 1)
    rng = np.random.default_rng(seed + 2)
    sequence = [int(w) for w in rng.choice(list(pool), size=n_requests)]
    blocks = [pool[w] if pool[w].shape[1] > 1 else pool[w][:, 0] for w in sequence]
    if poison_rate > 0:
        # The seeded poison set: copies (the pool's blocks are shared) with
        # the signature in row 0, where the poison fault spec looks.
        poison_rng = np.random.default_rng(seed + 4)
        n_poisoned = max(1, int(round(poison_rate * n_requests)))
        for i in poison_rng.choice(n_requests, size=n_poisoned, replace=False):
            block = blocks[i].clone()
            block[0] = POISON_SIGNATURE
            blocks[i] = block

    scheduler = (
        ArrivalWindowScheduler(engine, window_ms=window_ms,
                               max_window_ms=max_window_ms, flush_width=flush_width)
        if coalesce else None
    )
    if scheduler is not None:
        def submit(x):
            return scheduler.submit(x, deadline_ms=deadline_ms)
    else:
        def submit(x):
            return engine.submit(x, deadline_ms=deadline_ms)
    try:
        # ---- warmup: the whole ladder — coalesced widths are emergent, so
        # every bucket a flush could land on is built (captured) and run
        # once. Chaos spares warmup: the plan is disarmed here and armed
        # for the steady phase, so fault ordinals start at a deterministic
        # point ----
        from ..engine.buckets import bucket_ladder

        if plan is not None:
            plan.disarm()
        engine.warmup()
        _drain([engine.submit(pool[w]) for w in sorted(set(sequence))])
        if engine.b_star is not None:
            warm_rng = np.random.default_rng(seed + 9)
            _drain([
                engine.submit(torch.from_numpy(warm_rng.uniform(0, 10, (k, b)))
                              .to(engine.dtype))
                for b in bucket_ladder(max_bucket) if b >= engine.b_star
            ])
        warm_stats = engine.stats
        compiles_warmup = warm_stats.compiles
        if plan is not None:
            plan.arm()
        if slo_monitor is not None:
            # The window's baseline, sampled before the offered-request
            # counter moves so the steady window sees the whole delta.
            slo_monitor.sample()
        if recorder is not None:
            recorder.snapshot_metrics()
        if req_counter is not None:
            req_counter.inc(n_requests)

        # ---- steady phase under load ----
        if arrival == "closed":
            wall = _closed_loop(submit, blocks, concurrency, latency_hist,
                                fail_counter=fail_counter)
        else:
            gaps = _arrival_gaps(arrival, n_requests, rate, burst,
                                 np.random.default_rng(seed + 3))
            wall = _open_loop(submit, blocks, gaps, latency_hist,
                              flush=scheduler.flush if scheduler is not None else None,
                              fail_counter=fail_counter)
        steady_stats = engine.stats
        if scheduler is not None:
            sched_stats = scheduler.stats
            mean_batch_width = sched_stats.mean_batch_width
            coalesce_ratio = sched_stats.coalesce_ratio
        else:
            mean_batch_width = coalesce_ratio = float("nan")
    finally:
        if scheduler is not None:
            scheduler.close()
        if trace_jsonl is not None and not engine.flush_traces():
            print(f"WARNING: trace sink could not confirm {trace_jsonl} — the "
                  "file is missing or incomplete", file=sys.stderr)
        engine.close()
        if recorder is not None:
            recorder.close()  # pending dumps drain first
        if hub is not None:
            if not hub.flush():
                print(f"WARNING: event sink could not confirm {events_jsonl} — "
                      "the file is missing or incomplete", file=sys.stderr)
            hub.close()
    if plan is not None:
        for spec in plan.summary()["specs"]:
            if spec["site"] == "compile" and spec["matched"] == 0:
                # Warmup builds every preferred key while the plan is
                # disarmed: a compile spec aimed at one never fires.
                print(f"WARNING: compile fault spec (key={spec['key']!r}) matched "
                      "0 events — warmup builds the preferred configs; compile "
                      "faults fire only for programs first built in the steady "
                      "phase (fallback tiers, halved buckets)", file=sys.stderr)
    if slo_monitor is not None:
        slo_monitor.sample()  # the post-steady observation
        dump_json(slo_out, slo_monitor.evaluate())
    if recorder is not None:
        recorder.snapshot_metrics()
    snap_counters = registry.snapshot()["counters"]
    if metrics_out is not None:
        if policy is not None or plan is not None:
            engine.health()  # refresh the breaker gauge before exporting
        path = Path(metrics_out)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(registry.snapshot(), indent=2) + "\n")
    return ServeResult(
        n_rows=m,
        n_cols=k,
        n_devices=mesh.size,
        strategy=strategy_name,
        dtype=dtype_name(engine.dtype),
        kernel=kernel if isinstance(kernel, str) else "custom",
        combine=combine or "default",
        b_star=engine.b_star,
        max_bucket=max_bucket,
        n_requests=n_requests,
        total_cols=int(sum(sequence)),
        wall_s=wall,
        p50_dispatch_ms=latency_hist.percentile(50),
        p99_dispatch_ms=latency_hist.percentile(99),
        compiles_warmup=compiles_warmup,
        compiles_steady=steady_stats.compiles - compiles_warmup,
        hits_steady=steady_stats.hits - warm_stats.hits,
        promo_b=0,
        promo_gemm_s=float("nan"),
        promo_seq_s=float("nan"),
        arrival=arrival,
        rate_req_s=rate if arrival != "closed" else float("nan"),
        concurrency=concurrency,
        coalesce=int(coalesce),
        mean_batch_width=mean_batch_width,
        coalesce_ratio=coalesce_ratio,
        failed_requests=snap_counters.get("serve_failed_requests_total", 0),
        retries=snap_counters.get("resil_retries_total", 0),
        downgrades=snap_counters.get("resil_downgrades_total", 0),
        dtype_storage=engine.storage,
        resident_bytes=engine.resident_bytes,
    )


# ---------------------------------------------------------------- solvers

SOLVER_CSV_HEADER = (
    "n, n_devices, strategy, dtype, combine, op, solver_kernel, rtol, "
    "maxiter, n_solves, iterations, final_residual, final_value, "
    "time_per_iter_ms, solve_p50_ms, solve_p99_ms, wall_s, "
    "solves_per_s, compiles_warmup, compiles_steady, divergences"
)


@dataclasses.dataclass(frozen=True)
class SolverServeResult:
    """One solver-serve measurement (one CSV row).

    ``iterations``/``final_residual``/``final_value`` are the LAST converged
    solve's telemetry; ``time_per_iter_ms`` is steady-phase wall time over
    total iterations, both summed over CONVERGED solves only — a diverged
    solve burns its full cap and would flatter the per-iteration number.
    Divergences are counted, never folded in."""

    n: int
    n_devices: int
    strategy: str
    dtype: str
    combine: str
    op: str
    solver_kernel: str
    rtol: float
    maxiter: int
    n_solves: int
    iterations: int
    final_residual: float
    final_value: float
    time_per_iter_ms: float
    solve_p50_ms: float
    solve_p99_ms: float
    wall_s: float
    compiles_warmup: int
    compiles_steady: int
    divergences: int

    @property
    def solves_per_s(self) -> float:
        if not (self.wall_s > 0):
            return float("nan")
        return self.n_solves / self.wall_s


def solver_csv_path(strategy: str, root=None):
    from .metrics import out_dir

    return out_dir(root) / f"serve_solver_{strategy}.csv"


def append_solver_result(result: SolverServeResult, root=None):
    from ..parallel.distributed import is_main_process
    from .metrics import _append_row

    path = solver_csv_path(result.strategy, root)
    if not is_main_process():
        return path
    row = (
        f"{result.n}, {result.n_devices}, {result.strategy}, "
        f"{result.dtype}, {result.combine}, {result.op}, "
        f"{result.solver_kernel}, "
        f"{result.rtol:g}, {result.maxiter}, {result.n_solves}, "
        f"{result.iterations}, {result.final_residual:.6e}, "
        f"{result.final_value:.6e}, {result.time_per_iter_ms:.4f}, "
        f"{result.solve_p50_ms:.4f}, {result.solve_p99_ms:.4f}, "
        f"{result.wall_s:.6f}, {result.solves_per_s:.2f}, "
        f"{result.compiles_warmup}, {result.compiles_steady}, "
        f"{result.divergences}"
    )
    _append_row(path, SOLVER_CSV_HEADER, row)
    return path


def solver_operand(n: int, dtype, seed: int, *, device=None):
    """Seeded symmetric diagonally-dominant SPD operand: uniform(-1, 1)
    symmetrized, diagonal set to the absolute row sum plus one. Every
    Gershgorin disc then sits in [1, ·]: SPD with a bounded condition regime,
    valid for all five served ops. One diagonal entry is boosted 1.5× to
    isolate the dominant eigenvalue for the eigen ops.

    With ``device=None`` this is the JAX package's numpy construction, bit
    for bit, returned as a numpy array (the CPU tests hold the two packages
    against each other on it). With a ``device``, it is the SAME FAMILY WITH
    DIFFERENT DRAWS: the uniforms come from a ``torch.Generator`` on that
    device, in float32, and the matrix is built there in row chunks, so a
    full-width A (65536² fp32, 17 GB) never passes through host memory and
    the card holds at most the draws plus the result (2× A) and one
    float64 chunk. Returns a tensor of ``dtype`` on ``device``."""
    if device is None:
        rng = np.random.default_rng(seed)
        g = rng.uniform(-1.0, 1.0, (n, n))
        a = (g + g.T) / 2.0
        np.fill_diagonal(a, np.abs(a).sum(axis=1) + 1.0)
        a[0, 0] *= 1.5
        return a.astype(dtype)
    device = torch.device(device)
    dt = dtype if isinstance(dtype, torch.dtype) else torch_dtype(str(np.dtype(dtype)))
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    g = torch.empty((n, n), dtype=torch.float32, device=device)
    rows = max(1, (1 << 25) // n)  # 128 MiB of float32 per draw chunk
    for i in range(0, n, rows):
        j = min(n, i + rows)
        g[i:j] = torch.rand((j - i, n), generator=gen, device=device) * 2 - 1
    a = torch.empty((n, n), dtype=dt, device=device)
    for i in range(0, n, rows):
        j = min(n, i + rows)
        blk = (g[i:j].double() + g[:, i:j].T.double()) / 2.0
        diag = torch.arange(j - i, device=device)
        blk[diag, diag + i] = blk.abs().sum(dim=1) + 1.0
        if i == 0:
            blk[0, 0] *= 1.5
        a[i:j] = blk.to(dt)
        del blk
    del g
    return a


def gershgorin_interval(a) -> tuple[float, float]:
    """Enclosing spectral interval from Gershgorin discs: chebyshev's
    required ``interval=(λ_min, λ_max)`` without an eigendecomposition.
    Bounds, not estimates: a wider interval costs iterations, never
    correctness. A numpy array takes the JAX package's formula as it is; a
    tensor is read in float64 row chunks on its own device."""
    if not isinstance(a, torch.Tensor):
        d = np.abs(np.diag(a)).astype(np.float64)
        r = np.abs(a).astype(np.float64).sum(axis=1) - d
        return float((np.diag(a) - r).min()), float((np.diag(a) + r).max())
    n = a.shape[0]
    rows = max(1, (1 << 25) // max(1, a.shape[1]))
    lo, hi = [], []
    for i in range(0, n, rows):
        blk = a[i:i + rows].double()
        d = blk.diagonal(offset=i)
        r = blk.abs().sum(dim=1) - d.abs()
        lo.append((d - r).min())
        hi.append((d + r).max())
    return float(torch.stack(lo).min()), float(torch.stack(hi).max())


def run_serve_solver(
    strategy_name: str,
    mesh: Mesh,
    n: int,
    *,
    op: str,
    dtype: str = "float32",
    kernel: str = "cuda",
    solver_kernel: str = "torch",
    combine: str | None = None,
    stages: int | None = None,
    dtype_storage: str | None = None,
    rtol: float = 1e-6,
    rtol_sweep: Sequence[float] | None = None,
    maxiter: int | None = None,
    restart: int | None = None,
    steps: int | None = None,
    n_solves: int = 20,
    donate: bool = True,
    seed: int = 0,
    metrics_out: str | None = None,
) -> SolverServeResult:
    """Run the solver-serve protocol for one (op, strategy, n, mesh) config:
    one warmup solve (the build), then ``n_solves`` steady solves with fresh
    seeded right-hand sides (start vectors for the eigen ops), each
    materialized at once — a solve's latency IS submit-to-answer.

    The operand is :func:`solver_operand`: the JAX package's numpy draws on
    a CPU mesh, the device-built family on a CUDA mesh (made on the mesh's
    first device). rtol and maxiter are per-call arguments, every steady
    solve hits the warm executable, and ``compiles_steady`` must be 0.
    ``SolverDivergedError`` is counted and tolerated; any other failure
    aborts the run. ``rtol_sweep`` cycles the steady solves across a
    tolerance ladder (the CSV's rtol column records the tightest).
    """
    if op not in SOLVER_OPS:
        raise ConfigError(f"unknown solver op {op!r}; served ops: {SOLVER_OPS}")
    dev0 = mesh.devices[0]
    if dev0.type == "cpu":
        a = from_numpy(solver_operand(n, "float64", seed), "cpu").to(torch_dtype(dtype))
    else:
        a = solver_operand(n, dtype, seed, device=dev0)
    interval = gershgorin_interval(a) if op == "chebyshev" else None
    registry = MetricsRegistry()
    engine = MatvecEngine(
        a, mesh, strategy=strategy_name, kernel=kernel,
        solver_kernel=solver_kernel, combine=combine, stages=stages,
        dtype_storage=dtype_storage, dtype=dtype,
        donate=donate, metrics=registry,
    )
    del a  # a quantized engine holds the payload alone
    solve_hist = registry.histogram(
        "serve_solve_latency_ms",
        "steady-phase submit-entry to materialized-answer host time",
        window=max(n_solves, 1),
    )
    rng = np.random.default_rng(seed + 1)
    rhs_pool = [
        torch.from_numpy(rng.standard_normal(n)).to(engine.dtype)
        for _ in range(n_solves + 1)
    ]
    rtols = tuple(rtol_sweep) if rtol_sweep else (rtol,)

    def solve(b, i=0):
        return engine.submit(
            op=op, rhs=b, rtol=rtols[i % len(rtols)], maxiter=maxiter,
            restart=restart, steps=steps, interval=interval,
        ).result()

    # ---- warmup: one solve builds the loop; tolerate divergence the same
    # way the steady phase does (warmup's job is the executable).
    try:
        solve(rhs_pool[-1])
    except SolverDivergedError:
        pass
    warm_stats = engine.stats
    compiles_warmup = warm_stats.compiles

    # ---- steady phase: every solve must hit the warm executable ----
    divergences = 0
    total_iters = 0
    converged_s = 0.0
    last_iters, last_resid, last_value = 0, float("nan"), float("nan")
    start = time.perf_counter()
    for i in range(n_solves):
        t0 = time.perf_counter()
        try:
            res = solve(rhs_pool[i], i)
        except SolverDivergedError:
            divergences += 1
            continue
        dt = time.perf_counter() - t0
        solve_hist.observe(dt * 1e3)
        converged_s += dt
        total_iters += res.n_iters
        last_iters = res.n_iters
        last_resid = res.residual_norm
        last_value = res.value
    wall = time.perf_counter() - start
    steady_stats = engine.stats
    if metrics_out is not None:
        path = Path(metrics_out)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(registry.snapshot(), indent=2) + "\n")
    engine.close()
    return SolverServeResult(
        n=n,
        n_devices=mesh.size,
        strategy=strategy_name,
        dtype=dtype_name(engine.dtype),
        combine=combine or "default",
        op=op,
        solver_kernel=solver_kernel,
        rtol=min(rtols),
        maxiter=DEFAULT_SOLVER_MAXITER if maxiter is None else int(maxiter),
        n_solves=n_solves,
        iterations=last_iters,
        final_residual=last_resid,
        final_value=last_value,
        time_per_iter_ms=(
            converged_s * 1e3 / total_iters if total_iters else float("nan")
        ),
        solve_p50_ms=solve_hist.percentile(50),
        solve_p99_ms=solve_hist.percentile(99),
        wall_s=wall,
        compiles_warmup=compiles_warmup,
        compiles_steady=steady_stats.compiles - compiles_warmup,
        divergences=divergences,
    )


# ---- multi-tenant trace mode (engine/registry.py) ----

MULTITENANT_CSV_HEADER = (
    "n_rows, n_cols, n_devices, strategy, dtype, n_tenants, zipf_a, "
    "hbm_budget, budget_tenants, n_requests, wall_s, rps, hit_rate, "
    "lru_floor, global_sched, deadline_ms, deadline_expires, on_time, "
    "p50_e2e_ms, p99_e2e_ms, tenant, requests, hits, tenant_hit_rate, "
    "evictions, evictions_caused, quota_rejections, failed_requests, "
    "rejected, availability, resident_bytes, pinned"
)


@dataclasses.dataclass(frozen=True)
class TenantRow:
    """Per-tenant outcome of one multi-tenant trace (one CSV row)."""

    tenant: str
    requests: int
    hits: int
    evictions: int
    evictions_caused: int
    quota_rejections: int
    failed_requests: int
    resident_bytes: int
    pinned: int
    # Requests the global scheduler's predicted-time admission refused
    # (typed AdmissionRejectedError, pre-dispatch). Rejected ≠ failed: a
    # rejection used no device time and is retryable, so it has its own
    # column and does not count against availability.
    rejected: int = 0

    @property
    def hit_rate(self) -> float:
        return self.hits / self.requests if self.requests else float("nan")

    @property
    def availability(self) -> float:
        """Share of this tenant's offered requests that neither faulted nor
        expired (quota rejections, deadline expires and fault failures all
        count against it — the tenant-visible downtime). Admission
        rejections do not: they are typed, pre-dispatch scheduling
        outcomes (the ``rejected`` column)."""
        if self.requests == 0:
            return float("nan")
        return (self.requests - self.failed_requests) / self.requests

    @property
    def served_rate(self) -> float:
        """Share of offered requests that returned a result (failures and
        rejections both subtracted): a scheduler cannot buy availability by
        rejecting everything without this collapsing."""
        if self.requests == 0:
            return float("nan")
        return (self.requests - self.failed_requests - self.rejected) / self.requests


@dataclasses.dataclass(frozen=True)
class MultiTenantResult:
    """One multi-tenant trace: run-level fields plus the per-tenant rows
    (``rows`` ends with the aggregate ``ALL`` row)."""

    n_rows: int
    n_cols: int
    n_devices: int
    strategy: str
    dtype: str
    n_tenants: int
    zipf_a: float
    hbm_budget: int           # 0 = unlimited
    budget_tenants: int       # payloads that fit (a sub-payload budget is 0)
    n_requests: int
    wall_s: float
    hit_rate: float           # registry-wide: hits / submits
    lru_floor: float          # plain-LRU replay of the same trace
    rows: tuple[TenantRow, ...]
    # The deadline overlay's columns: deadline_expires counts requests that
    # expired in an engine's gate; p50/p99 are end to end (scheduled arrival
    # to materialized result) over served requests, NaN without deadlines.
    # global_sched: the run went through the global scheduler.
    global_sched: bool = False
    deadline_ms: float = float("nan")
    deadline_expires: int = 0
    p50_e2e_ms: float = float("nan")
    p99_e2e_ms: float = float("nan")
    # Served requests whose end-to-end latency landed inside the deadline.
    on_time: int = 0

    @property
    def rps(self) -> float:
        return self.n_requests / self.wall_s if self.wall_s > 0 else float("nan")


def multitenant_csv_path(strategy: str, root=None):
    from .metrics import out_dir

    return out_dir(root) / f"serve_tenants_{strategy}.csv"


def append_multitenant_result(result: MultiTenantResult, root=None):
    from ..parallel.distributed import is_main_process
    from .metrics import _append_row

    path = multitenant_csv_path(result.strategy, root)
    if not is_main_process():
        return path
    prefix = (
        f"{result.n_rows}, {result.n_cols}, {result.n_devices}, "
        f"{result.strategy}, {result.dtype}, {result.n_tenants}, "
        f"{result.zipf_a:.3f}, {result.hbm_budget}, "
        f"{result.budget_tenants}, {result.n_requests}, "
        f"{result.wall_s:.6f}, {result.rps:.2f}, {result.hit_rate:.4f}, "
        f"{result.lru_floor:.4f}, {int(result.global_sched)}, "
        f"{result.deadline_ms:.3f}, {result.deadline_expires}, "
        f"{result.on_time}, "
        f"{result.p50_e2e_ms:.4f}, {result.p99_e2e_ms:.4f}"
    )
    for row in result.rows:
        _append_row(
            path, MULTITENANT_CSV_HEADER,
            f"{prefix}, {row.tenant}, {row.requests}, {row.hits}, "
            f"{row.hit_rate:.4f}, {row.evictions}, {row.evictions_caused}, "
            f"{row.quota_rejections}, {row.failed_requests}, "
            f"{row.rejected}, {row.availability:.4f}, "
            f"{row.resident_bytes}, {row.pinned}",
        )
    return path


def parse_hbm_budget(text: str | None, payload_bytes: int) -> int | None:
    """``--hbm-budget`` grammar: plain bytes (``2097152``), or a payload
    multiple (``2.5x`` = room for 2.5 tenants of this run's shape). None/0
    = unlimited."""
    if text is None:
        return None
    text = str(text).strip()
    if text.endswith(("x", "X")):
        budget = int(float(text[:-1]) * payload_bytes)
    else:
        budget = int(float(text))
    if budget < 0:
        raise ConfigError(f"hbm budget must be >= 0, got {text!r}")
    return budget or None


def parse_tenant_quota(text: str | None) -> dict[str, int] | int | None:
    """``--tenant-quota`` grammar: a bare int (every tenant's
    ``max_in_flight``) or ``tenant-0=4,tenant-3=8`` (named tenants only —
    the chaos overlay's quota pressure on one tenant)."""
    if text is None:
        return None
    text = text.strip()
    if "=" not in text:
        return int(text)
    quotas: dict[str, int] = {}
    for item in text.split(","):
        if "=" not in item:
            raise ConfigError(
                f"tenant quota item {item!r} must be tenant=max_in_flight"
            )
        tid, value = (part.strip() for part in item.split("=", 1))
        quotas[tid] = int(value)
    return quotas


def _zipf_probs(n_tenants: int, zipf_a: float) -> np.ndarray:
    """Bounded Zipf over tenant ranks: ``p(i) ∝ (i+1)^-a`` — rank 0 is the
    hottest tenant."""
    ranks = np.arange(1, n_tenants + 1, dtype=np.float64)
    probs = ranks ** -float(zipf_a)
    return probs / probs.sum()


def lru_hit_floor(
    tenant_seq: Sequence[int], capacity: int | None,
    pinned: Sequence[int] = (),
) -> float:
    """Replay the tenant sequence through plain LRU with ``capacity``
    resident slots (None = unlimited; 0 = a real budget too small for one
    payload — every unpinned access misses) and a pre-admitted pinned set
    (pins take slots and always hit) — the hit-rate floor the registry's
    cost-aware policy must meet on the same trace. For homogeneous tenants
    the registry's score reduces to exactly LRU, so measured == floor
    there."""
    if not len(tenant_seq):
        return float("nan")
    pinned_set = set(pinned)
    slots = None if capacity is None else max(0, capacity - len(pinned_set))
    resident: list[int] = []  # LRU order: least recent first
    hits = 0
    for t in tenant_seq:
        if t in pinned_set:
            hits += 1
            continue
        if t in resident:
            hits += 1
            resident.remove(t)
        elif slots is not None and slots == 0:
            continue  # every slot pinned: a perpetual (counted) overshoot
        elif slots is not None and len(resident) >= slots:
            resident.pop(0)
        resident.append(t)
    return hits / len(tenant_seq)


def run_serve_multitenant(
    strategy_name: str,
    mesh: Mesh,
    m: int,
    k: int,
    *,
    dtype: str = "float32",
    kernel: str = "cuda",
    combine: str | None = None,
    stages: int | None = None,
    dtype_storage: str | None = None,
    n_tenants: int = 8,
    zipf_a: float = 1.1,
    hbm_budget: str | int | None = None,
    pin_hot: int = 0,
    tenant_quota: str | int | dict | None = None,
    n_requests: int = 200,
    max_bucket: int = 32,
    promote: str | int | None = None,
    donate: bool = True,
    seed: int = 0,
    metrics_out: str | None = None,
    fault_spec: str | None = None,
    fault_seed: int = 0,
    poison_rate: float = 0.0,
    poison_tenant: str | None = None,
    integrity_gate: bool = False,
    resilience: bool | None = None,
    breaker_reset_s: float = 30.0,
    deadline_ms: float | None = None,
    rate: float | None = None,
    max_in_flight: int | None = None,
    on_result=None,
    global_sched: bool = False,
    demand_weight: float = 0.0,
    decision_jsonl: str | None = None,
    reshard: str = "off",
) -> MultiTenantResult:
    """Run the multi-tenant trace protocol for one (strategy, shape, mesh)
    config: ``n_tenants`` seeded matrices (:func:`resident_matrix` on the
    mesh's first device, seeds ``seed + i``) registered against
    ``hbm_budget``, driven by a Zipf(``zipf_a``) tenant-popularity trace of
    ``n_requests`` vector requests (the JAX package's trace, draw for
    draw). Submits are issued in trace order and materialized at the end —
    outstanding futures are what the ``max_in_flight`` quotas meter, and
    eviction under work already queued is what releasable residency must
    survive. ``on_result(tenant_id, x, y)`` is called for every served
    request after the timed phase, with the host request and result.

    Chaos overlay: ``fault_spec`` patterns may target one tenant
    (``key=tenant-0/*``), ``tenant_quota`` may throttle one tenant, and
    ``poison_rate``/``poison_tenant`` plant the poison signature on a
    seeded share of one tenant's requests (every tenant's when
    ``poison_tenant`` is None).

    With ``deadline_ms`` the trace becomes an SLO overlay: arrivals are
    paced at ``rate`` req/s (a burst when None), each request's deadline is
    anchored at its SCHEDULED arrival, results are drained concurrently,
    and the result carries end-to-end p50/p99 over served requests.
    ``max_in_flight`` arms the engines' backpressure gate.

    Global-scheduler A/B (``global_sched``): every submit goes through a
    :class:`~..engine.GlobalScheduler` over the same registry
    (``cost_model="auto"``: the tuning cache's calibration, greedy without
    one) — predicted-time admission, cross-tenant interleaving and
    coalescing, demand-aware eviction (``demand_weight``) — against the
    greedy baseline on the same seeded trace. A request the admission
    refuses counts in ``rejected``, not in ``failed_requests``. The
    ``hits`` column counts dispatches, so in the deadline-free protocol a
    coalesced flush of b requests is one hit. ``reshard="auto"`` arms the
    scheduler's crossover trigger (:func:`run_reshard_drift` is its
    dedicated A/B); ``decision_jsonl`` mirrors every decision to a file."""
    if reshard not in ("auto", "off"):
        raise ConfigError(f"reshard must be 'auto' or 'off', got {reshard!r}")
    if n_tenants < 1:
        raise ConfigError(f"n_tenants must be >= 1, got {n_tenants}")
    if not (0 <= pin_hot <= n_tenants):
        raise ConfigError(f"pin_hot must be in [0, {n_tenants}], got {pin_hot}")
    if not (0.0 <= poison_rate <= 1.0):
        raise ConfigError(f"poison_rate must be in [0, 1], got {poison_rate}")
    tenant_ids = [f"tenant-{i}" for i in range(n_tenants)]
    if poison_tenant is not None and poison_tenant not in tenant_ids:
        raise ConfigError(
            f"poison_tenant {poison_tenant!r} is not one of the "
            f"{n_tenants} registered tenants"
        )
    registry_metrics = MetricsRegistry()
    chaos = fault_spec is not None or poison_rate > 0
    specs = (parse_fault_spec(fault_spec, seed=fault_seed).specs
             if fault_spec is not None else ())
    if poison_rate > 0:
        # Poison faults stay payload-scoped (they never open breakers); the
        # key narrows the blast radius to the targeted tenant's labels.
        specs = specs + (FaultSpec(
            site="dispatch", kind="device_error", poison=POISON_SIGNATURE,
            key=f"{poison_tenant}/*" if poison_tenant else "*",
        ),)
    plan = FaultPlan(specs, seed=fault_seed) if specs else None
    if resilience is None:
        resilience = chaos
    policy = (ResiliencePolicy(retry=RetryPolicy(seed=fault_seed),
                               breaker_reset_s=breaker_reset_s)
              if resilience else None)
    tdtype = torch_dtype(dtype)
    # Budget multiples are in NATIVE payloads; quantized tenants' real
    # payload bytes land in the accountant either way.
    native_payload = m * k * torch.empty((), dtype=tdtype).element_size()
    budget = parse_hbm_budget(hbm_budget, native_payload)
    quotas = (parse_tenant_quota(tenant_quota) if isinstance(tenant_quota, str)
              else tenant_quota)

    registry = MatrixRegistry(
        mesh, hbm_budget=budget, demand_weight=demand_weight,
        metrics=registry_metrics, fault_plan=plan,
        resilience=policy, integrity_gate=integrity_gate,
        strategy=strategy_name, kernel=kernel, combine=combine, stages=stages,
        dtype_storage=dtype_storage, dtype=tdtype, max_bucket=max_bucket,
        promote=promote, donate=donate, max_in_flight=max_in_flight,
    )
    payload_bytes = 0
    served: list[tuple[str, object, object]] = []
    try:
        for i, tid in enumerate(tenant_ids):
            q = quotas.get(tid) if isinstance(quotas, dict) else quotas
            registry.register(
                tid, resident_matrix(m, k, tdtype, mesh.devices[0], seed + i),
                quota=TenantQuota(max_in_flight=q) if q else None,
            )
            if i == 0:
                payload_bytes = registry.tenant_stats(tid)["payload_bytes"]

        # ---- warmup: the shared functions once (no placement), spared
        # from the chaos plan ----
        if plan is not None:
            plan.disarm()
        registry.warmup(widths=[1])
        if plan is not None:
            plan.arm()
        for i in range(pin_hot):
            registry.pin(tenant_ids[i])

        # ---- the Zipf trace (the JAX package's draws) ----
        rng = np.random.default_rng(seed + 2)
        tenant_seq = rng.choice(n_tenants, size=n_requests,
                                p=_zipf_probs(n_tenants, zipf_a))
        xpool = [torch.from_numpy(rng.standard_normal(k)).to(tdtype) for _ in range(4)]
        poison_idx: set[int] = set()
        if poison_rate > 0:
            target = [j for j, t in enumerate(tenant_seq)
                      if poison_tenant is None or tenant_ids[t] == poison_tenant]
            if target:
                prng = np.random.default_rng(seed + 4)
                n_poison = min(len(target), max(1, round(poison_rate * len(target))))
                poison_idx = {int(j) for j in
                              prng.choice(target, size=n_poison, replace=False)}
        gs = None
        if global_sched:
            from ..engine.global_scheduler import GlobalScheduler

            gs = GlobalScheduler(registry, cost_model="auto",
                                 decision_jsonl=decision_jsonl, reshard=reshard)
        submit = gs.submit if gs is not None else registry.submit
        failed = [0] * n_tenants
        rejected = [0] * n_tenants
        e2e_hist = registry_metrics.histogram(
            "serve_e2e_latency_ms",
            "scheduled-arrival to materialized-result host time over served "
            "requests (deadline overlay)",
            window=max(n_requests, 1),
        )
        on_time = [0]

        def request(j: int):
            x = xpool[j % len(xpool)]
            if j in poison_idx:
                x = x.clone()
                x[0] = POISON_SIGNATURE
            return x

        def consume(t: int, x, fut, arrival: float | None) -> None:
            try:
                y = fut.result()
            except AdmissionRejectedError:
                rejected[t] += 1  # typed, pre-dispatch: rejected != failed
                return
            except MatvecError:
                failed[t] += 1
                return
            if arrival is not None:
                lat_ms = (time.perf_counter() - arrival) * 1e3
                e2e_hist.observe(lat_ms)
                if deadline_ms is not None and lat_ms <= deadline_ms:
                    on_time[0] += 1  # SLO goodput, not just served
            if on_result is not None:
                served.append((tenant_ids[t], x, y))

        start = time.perf_counter()
        if deadline_ms is None:
            # Submit in trace order, materialize once.
            futures = []
            for j, t in enumerate(tenant_seq):
                x = request(j)
                try:
                    futures.append((int(t), x, submit(tenant_ids[t], x)))
                except MatvecError:
                    # Uncoalesced dispatch faults surface at submit; the
                    # trace goes on — availability is the measurement.
                    failed[t] += 1
            if gs is not None:
                gs.flush()  # close the open coalescing batch before the drain
            for t, x, fut in futures:
                consume(t, x, fut, None)
        else:
            # Paced arrivals, deadlines anchored at the SCHEDULED arrival
            # (loop lag consumes deadline budget), results drained
            # concurrently so end-to-end latency is per request.
            gap_s = (1.0 / rate) if rate else 0.0
            results: queue.Queue = queue.Queue()

            def drainer() -> None:
                while (item := results.get()) is not None:
                    consume(*item)

            drain_thread = threading.Thread(target=drainer, daemon=True)
            drain_thread.start()
            try:
                for j, t in enumerate(tenant_seq):
                    x = request(j)
                    arrival = start + j * gap_s
                    while (now := time.perf_counter()) < arrival:
                        time.sleep(min(arrival - now, 5e-4))
                    remaining = (arrival + deadline_ms / 1e3 - time.perf_counter()) * 1e3
                    try:
                        fut = submit(tenant_ids[t], x, deadline_ms=remaining)
                    except MatvecError:
                        failed[t] += 1
                        continue
                    results.put((int(t), x, fut, arrival))
            finally:
                results.put(None)
                drain_thread.join()
        wall = time.perf_counter() - start
        if gs is not None:
            gs.close()

        health = registry.health()
        if metrics_out is not None:
            dump_json(metrics_out, registry_metrics.snapshot())
    finally:
        registry.close()
    if on_result is not None:
        for tid, x, y in served:
            on_result(tid, x, y)

    # capacity 0 with a budget set is a REAL (sub-payload) budget, not
    # unlimited: the floor and the summary line keep the two apart.
    capacity = (budget // payload_bytes) if budget else 0
    floor = lru_hit_floor(tenant_seq, capacity if budget else None,
                          pinned=range(pin_hot))
    offered = np.bincount(tenant_seq, minlength=n_tenants)
    rows = []
    for i, tid in enumerate(tenant_ids):
        stat = health["tenants"][tid]
        rows.append(TenantRow(
            tenant=tid, requests=int(offered[i]), hits=stat["hits"],
            evictions=stat["evictions"], evictions_caused=stat["evictions_caused"],
            quota_rejections=stat["quota_rejections"], failed_requests=failed[i],
            rejected=rejected[i], resident_bytes=stat["resident_bytes"],
            pinned=int(stat["pinned"]),
        ))
    rows.append(TenantRow(
        tenant="ALL", requests=n_requests, hits=sum(r.hits for r in rows),
        evictions=sum(r.evictions for r in rows),
        evictions_caused=sum(r.evictions_caused for r in rows),
        quota_rejections=sum(r.quota_rejections for r in rows),
        failed_requests=sum(r.failed_requests for r in rows),
        rejected=sum(r.rejected for r in rows),
        resident_bytes=health["hbm"]["charged_bytes"], pinned=pin_hot,
    ))
    counters = registry_metrics.snapshot()["counters"]
    return MultiTenantResult(
        n_rows=m, n_cols=k, n_devices=mesh.size, strategy=strategy_name,
        dtype=dtype, n_tenants=n_tenants, zipf_a=float(zipf_a),
        hbm_budget=budget or 0, budget_tenants=capacity, n_requests=n_requests,
        wall_s=wall,
        hit_rate=rows[-1].hits / n_requests if n_requests else float("nan"),
        lru_floor=floor, rows=tuple(rows), global_sched=global_sched,
        deadline_ms=float(deadline_ms) if deadline_ms is not None else float("nan"),
        # Engine-gate deadline failures; warmup submits carry no deadlines.
        deadline_expires=counters.get("engine_deadline_failures_total", 0),
        on_time=on_time[0],
        p50_e2e_ms=e2e_hist.percentile(50), p99_e2e_ms=e2e_hist.percentile(99),
    )


# ---- the drifting-shape online-resharding A/B ----

RESHARD_AB_CSV_HEADER = (
    "m, k, p, strategy, dtype, reshard, n_tenants, zipf_a, n_requests, "
    "rollover, steady_skip, width_steady, wall_s, p50_pre_ms, "
    "p99_pre_ms, p50_steady_ms, p99_steady_ms, reshards, reshard_bytes, "
    "compiles_total, compiles_steady, last_reshard_at, final_strategies"
)


def reshard_csv_path(root=None):
    from .metrics import out_dir

    return out_dir(root) / "reshard_ab.csv"


def append_reshard_result(result: dict, root=None):
    from ..parallel.distributed import is_main_process
    from .metrics import _append_row

    path = reshard_csv_path(root)
    if not is_main_process():
        return path
    r = result
    finals = "|".join(f"{tid}:{s}" for tid, s in sorted(r["final_strategies"].items()))
    _append_row(
        path, RESHARD_AB_CSV_HEADER,
        f"{r['m']}, {r['k']}, {r['p']}, {r['strategy']}, {r['dtype']}, "
        f"{r['reshard']}, {r['n_tenants']}, {r['zipf_a']:.3f}, "
        f"{r['n_requests']}, {r['rollover']}, {r['steady_skip']}, "
        f"{r['width_steady']}, {r['wall_s']:.6f}, "
        f"{r['p50_pre_ms']:.4f}, {r['p99_pre_ms']:.4f}, "
        f"{r['p50_steady_ms']:.4f}, {r['p99_steady_ms']:.4f}, "
        f"{r['reshards']}, {r['reshard_bytes']}, {r['compiles_total']}, "
        f"{r['compiles_steady']}, {r['last_reshard_at']}, {finals}",
    )
    return path


def run_reshard_drift(
    strategy_name: str,
    mesh: Mesh,
    m: int,
    k: int,
    *,
    dtype: str = "float32",
    kernel: str = "cuda",
    n_tenants: int = 3,
    zipf_a: float = 1.1,
    n_requests: int = 200,
    rollover: int = 24,
    width_steady: int = 8,
    pre_rate: float = 6.0,
    steady_skip: int = 48,
    seed: int = 0,
    reshard: str = "off",
    reshard_cooldown_s: float = 30.0,
    reshard_horizon_s: float = 0.5,
    rate_tau_s: float = 0.1,
    metrics_out: str | None = None,
    decision_jsonl: str | None = None,
) -> dict:
    """The ``reshard="auto"|"off"`` A/B protocol: a Zipf fleet registered in
    ``strategy_name`` (seeded :func:`resident_matrix` tenants, seeds
    ``seed + i``) serves, through a :class:`~..engine.GlobalScheduler`, a
    trace whose shape drifts at the ``rollover`` index — width-1 vector
    requests trickling at ``pre_rate`` req/s before it, closed-loop
    ``width_steady``-column blocks after it. Registered in a layout the cost
    model scores poorly for the steady shape, the fleet lands on the wrong
    side of the crossover when the shape drifts; with ``reshard="auto"`` the
    scheduler migrates each tenant on the card once its demand amortizes the
    collectives, with ``"off"`` the fleet stays in its registered layout —
    the same seeded trace, so the steady percentiles compare directly.

    Every request is closed-loop (submit then materialize), so its latency
    is service time. The steady window opens ``steady_skip`` requests after
    the rollover, wide enough that the one-time migration (and its
    ``warm_widths`` builds) lands inside the skip; ``compiles_steady`` counts
    the program builds inside the window. ``last_reshard_at`` is the request
    index of the last migration (-1 when none). At ``pre_rate`` below ``1 /
    reshard_horizon_s`` the amortization damper holds the trigger off before
    the drift."""
    if reshard not in ("auto", "off"):
        raise ConfigError(f"reshard must be 'auto' or 'off', got {reshard!r}")
    if not (0 < rollover < n_requests):
        raise ConfigError(f"rollover must be in (0, {n_requests}), got {rollover}")
    if rollover + steady_skip >= n_requests:
        raise ConfigError(
            f"steady window is empty: rollover={rollover} + "
            f"steady_skip={steady_skip} >= n_requests={n_requests}"
        )
    from ..engine.global_scheduler import GlobalScheduler

    tdtype = torch_dtype(dtype)
    registry_metrics = MetricsRegistry()
    registry = MatrixRegistry(
        mesh, metrics=registry_metrics, rate_tau_s=rate_tau_s,
        strategy=strategy_name, kernel=kernel, dtype=tdtype,
        max_bucket=max(width_steady, 1),
    )
    tenant_ids = [f"tenant-{i}" for i in range(n_tenants)]
    gs = None
    try:
        for i, tid in enumerate(tenant_ids):
            registry.register(
                tid, resident_matrix(m, k, tdtype, mesh.devices[0], seed + i))
        # Both trace widths in the registered layout, so the frozen arm's
        # wide builds land here, not in its steady window.
        registry.warmup(widths=[1, width_steady])
        gs = GlobalScheduler(
            registry, cost_model="auto", decision_jsonl=decision_jsonl,
            reshard=reshard, reshard_cooldown_s=reshard_cooldown_s,
            reshard_horizon_s=reshard_horizon_s,
        )
        rng = np.random.default_rng(seed + 2)
        tenant_seq = rng.choice(n_tenants, size=n_requests,
                                p=_zipf_probs(n_tenants, zipf_a))
        xpool = [torch.from_numpy(rng.standard_normal(k)).to(tdtype) for _ in range(4)]
        xbpool = [torch.from_numpy(rng.standard_normal((k, width_steady))).to(tdtype)
                  for _ in range(4)]
        compiles_warm = registry_metrics.snapshot()["counters"].get(
            "engine_compiles_total", 0)
        compiles_at_window = None
        lat_ms = np.zeros(n_requests)
        reshards_seen = 0
        last_reshard_at = -1
        gap_s = (1.0 / pre_rate) if pre_rate else 0.0
        start = time.perf_counter()
        for j, t in enumerate(tenant_seq):
            if j < rollover:
                # The pre-drift trickle: paced arrivals hold the demand
                # estimate below the amortization threshold.
                arrival = start + j * gap_s
                while (now := time.perf_counter()) < arrival:
                    time.sleep(min(arrival - now, 5e-4))
                x = xpool[j % len(xpool)]
            else:
                x = xbpool[j % len(xbpool)]
            if j == rollover + steady_skip:
                compiles_at_window = registry_metrics.snapshot()["counters"].get(
                    "engine_compiles_total", 0)
            t0 = time.perf_counter()
            gs.submit(tenant_ids[t], x).result()  # closed loop: e2e is service time
            lat_ms[j] = (time.perf_counter() - t0) * 1e3
            n_resh = registry_metrics.snapshot()["counters"].get(
                "registry_reshards_total", 0)
            if n_resh > reshards_seen:
                reshards_seen = n_resh
                last_reshard_at = j
        wall = time.perf_counter() - start
        counters = registry_metrics.snapshot()["counters"]
        compiles_total = counters.get("engine_compiles_total", 0) - compiles_warm
        if compiles_at_window is None:  # degenerate: window at trace end
            compiles_at_window = counters.get("engine_compiles_total", 0)
        health = registry.health()
        finals = {tid: health["tenants"][tid]["strategy"] for tid in tenant_ids}
        if metrics_out is not None:
            dump_json(metrics_out, registry_metrics.snapshot())
    finally:
        if gs is not None:
            gs.close()
        registry.close()

    pre = lat_ms[:rollover]
    steady = lat_ms[rollover + steady_skip:]
    return {
        "m": m, "k": k, "p": mesh.size, "strategy": strategy_name,
        "dtype": dtype, "reshard": reshard, "n_tenants": n_tenants,
        "zipf_a": float(zipf_a), "n_requests": n_requests,
        "rollover": rollover, "steady_skip": steady_skip,
        "width_steady": width_steady, "wall_s": wall,
        "p50_pre_ms": float(np.percentile(pre, 50)),
        "p99_pre_ms": float(np.percentile(pre, 99)),
        "p50_steady_ms": float(np.percentile(steady, 50)),
        "p99_steady_ms": float(np.percentile(steady, 99)),
        "reshards": counters.get("registry_reshards_total", 0),
        "reshard_bytes": counters.get("reshard_bytes_total", 0),
        "compiles_total": compiles_total,
        "compiles_steady": counters.get("engine_compiles_total", 0) - compiles_at_window,
        "last_reshard_at": last_reshard_at,
        "final_strategies": finals,
    }


def _run_tenants_config(args, name: str, mesh: Mesh, m: int, k: int, promote) -> bool:
    """One ``--tenants`` config of the CLI: run the trace (``--global-sched
    both``: the greedy baseline, then the scheduled run on the same seeded
    trace), append its rows, print its summary. False when the config
    cannot run here."""
    modes = {None: (False,), "off": (False,), "on": (True,),
             "both": (False, True)}[getattr(args, "global_sched", None)]
    return all([_run_tenants_mode(args, name, mesh, m, k, promote, on)
                for on in modes])


def _run_tenants_mode(args, name: str, mesh: Mesh, m: int, k: int, promote,
                      gsched_on: bool) -> bool:
    try:
        result = run_serve_multitenant(
            name, mesh, m, k, dtype=args.dtype, kernel=args.kernel,
            combine=getattr(args, "combine", None),
            stages=getattr(args, "stages", None),
            dtype_storage=getattr(args, "dtype_storage", None),
            n_tenants=args.tenants, zipf_a=args.zipf_a,
            hbm_budget=args.hbm_budget, pin_hot=args.pin_hot,
            tenant_quota=args.tenant_quota, n_requests=args.n_requests,
            max_bucket=args.max_bucket, promote=promote, seed=args.seed,
            metrics_out=getattr(args, "metrics_out", None),
            fault_spec=getattr(args, "fault_spec", None),
            fault_seed=getattr(args, "fault_seed", 0),
            poison_rate=getattr(args, "poison_rate", 0.0) or 0.0,
            poison_tenant=args.poison_tenant,
            integrity_gate=getattr(args, "integrity_gate", False),
            breaker_reset_s=getattr(args, "breaker_reset_s", 30.0),
            deadline_ms=getattr(args, "deadline_ms", None),
            rate=(getattr(args, "rate", None)
                  if getattr(args, "deadline_ms", None) is not None else None),
            max_in_flight=getattr(args, "max_in_flight", None),
            global_sched=gsched_on,
            demand_weight=(getattr(args, "demand_weight", 0.0) or 0.0) if gsched_on else 0.0,
            decision_jsonl=getattr(args, "decision_jsonl", None) if gsched_on else None,
            reshard=getattr(args, "reshard", "off") if gsched_on else "off",
        )
    except MatvecError as e:
        print(f"skip {name} {m}x{k} p={mesh.size}: {e}")
        return False
    path = None if args.no_csv else append_multitenant_result(result, args.data_root)
    all_row = result.rows[-1]
    deadline_suffix = ""
    if getattr(args, "deadline_ms", None) is not None:
        deadline_suffix = (f" deadline={result.deadline_ms:.1f}ms "
                           f"expires={result.deadline_expires} "
                           f"rejected={all_row.rejected} "
                           f"p99={result.p99_e2e_ms:.2f}ms")
    print(
        f"serve-tenants {name} {m}x{k} p={mesh.size} "
        f"tenants={result.n_tenants} zipf_a={result.zipf_a} "
        f"budget={result.budget_tenants if result.hbm_budget else 'inf'} "
        f"gsched={'on' if gsched_on else 'off'} "
        f"{result.rps:.1f} req/s hit={result.hit_rate:.3f} "
        f"(lru floor {result.lru_floor:.3f}) evictions={all_row.evictions} "
        f"quota_rej={all_row.quota_rejections} ok={all_row.availability:.3f}"
        + deadline_suffix
    )
    if path is not None:
        print(f"CSV: {path}")
    return True


def _run_solver_config(args, name: str, mesh: Mesh, n: int) -> bool:
    """One ``--op <solver>`` config of :func:`run_serve_sweep`: run, write
    the row, print the summary. False when the config was skipped."""
    try:
        result = run_serve_solver(
            name, mesh, n, op=args.solver_op, dtype=args.dtype,
            kernel=args.kernel, combine=getattr(args, "combine", None),
            stages=getattr(args, "stages", None),
            dtype_storage=getattr(args, "dtype_storage", None),
            solver_kernel=getattr(args, "solver_kernel", "torch") or "torch",
            rtol=getattr(args, "rtol", 1e-6),
            rtol_sweep=getattr(args, "rtol_sweep", None),
            maxiter=getattr(args, "maxiter", None),
            restart=getattr(args, "restart", None),
            steps=getattr(args, "steps", None),
            n_solves=args.n_requests, seed=args.seed,
            metrics_out=getattr(args, "metrics_out", None),
        )
    except MatvecError as e:
        print(f"skip {name} {n}x{n} p={mesh.size}: {e}")
        return False
    path = None if args.no_csv else append_solver_result(result, args.data_root)
    print(
        f"serve-solver {result.op} {name} {n}x{n} "
        f"p={mesh.size} tier={result.solver_kernel} "
        f"solves={result.n_solves} "
        f"iters={result.iterations} "
        f"resid={result.final_residual:.3e} "
        f"t/iter={result.time_per_iter_ms:.3f}ms "
        f"p50={result.solve_p50_ms:.2f}ms "
        f"p99={result.solve_p99_ms:.2f}ms "
        f"compiles={result.compiles_warmup}+"
        f"{result.compiles_steady} "
        f"div={result.divergences}"
    )
    if path is not None:
        print(f"CSV: {path}")
    return True


def _run_load_configs(args, name: str, mesh: Mesh, m: int, k: int, promote,
                      concurrency: Sequence[int], coalesce_arg: str | None) -> int:
    """The load-mode configs of :func:`run_serve_sweep` for one (strategy,
    shape, mesh): every client count of ``--concurrency``, each uncoalesced
    then coalesced under ``--coalesce both`` (so ``--metrics-out`` keeps the
    coalesced run's snapshot). Writes the rows, prints the summaries, and
    returns the number of configs measured."""
    coalesce_modes = {None: (True,), "on": (True,), "off": (False,),
                      "both": (False, True)}[coalesce_arg]
    window_ms = getattr(args, "window_ms", "auto")
    if window_ms not in (None, "auto"):
        window_ms = float(window_ms)
    flush_width = getattr(args, "flush_width", "auto")
    if flush_width not in (None, "auto"):
        flush_width = int(flush_width)
    fault_spec = getattr(args, "fault_spec", None)
    poison_rate = getattr(args, "poison_rate", 0.0) or 0.0
    n_done = 0
    for n_clients in concurrency:
        for coalesce in coalesce_modes:
            try:
                result = run_serve_load(
                    name, mesh, m, k, dtype=args.dtype, kernel=args.kernel,
                    combine=getattr(args, "combine", None),
                    stages=getattr(args, "stages", None),
                    dtype_storage=getattr(args, "dtype_storage", None),
                    n_requests=args.n_requests, max_bucket=args.max_bucket,
                    promote=promote, concurrency=n_clients, coalesce=coalesce,
                    arrival=args.arrival, rate=args.rate, burst=args.burst,
                    window_ms=window_ms, max_window_ms=args.max_window_ms,
                    flush_width=flush_width, deadline_ms=args.deadline_ms,
                    max_in_flight=args.max_in_flight, seed=args.seed,
                    metrics_out=getattr(args, "metrics_out", None),
                    trace_jsonl=args.trace_jsonl, events_jsonl=args.events_jsonl,
                    integrity_gate=args.integrity_gate,
                    slo_out=getattr(args, "slo_out", None),
                    flight_dir=getattr(args, "flight_dir", None),
                    fault_spec=fault_spec, fault_seed=getattr(args, "fault_seed", 0),
                    poison_rate=poison_rate,
                    breaker_reset_s=getattr(args, "breaker_reset_s", 30.0),
                )
            except MatvecError as e:
                print(f"skip {name} {m}x{k} p={mesh.size} c={n_clients}: {e}")
                continue
            path = None if args.no_csv else append_serve_result(result, args.data_root)
            chaos_suffix = (
                f" ok={result.success_rate:.3f} failed={result.failed_requests} "
                f"retries={result.retries} downgrades={result.downgrades}"
                if fault_spec is not None or poison_rate > 0 else ""
            )
            print(
                f"serve-load {name} {m}x{k} p={mesh.size} {result.arrival} "
                f"c={n_clients} coalesce={'on' if coalesce else 'off'} "
                f"{result.rps:.1f} req/s p50={result.p50_dispatch_ms:.3f}ms "
                f"p99={result.p99_dispatch_ms:.3f}ms "
                f"width={result.mean_batch_width:.2f} "
                f"ratio={result.coalesce_ratio:.2f} "
                f"compiles={result.compiles_warmup}+{result.compiles_steady}"
                + chaos_suffix
            )
            if path is not None:
                print(f"CSV: {path}")
            n_done += 1
    return n_done


def _check_flags(args: argparse.Namespace) -> None:
    if getattr(args, "poison_tenant", None) is not None and not getattr(args, "tenants", None):
        raise ConfigError("--poison-tenant names a tenant of --tenants mode; "
                          "pass --tenants N")


def tune_serve(
    strategies, sizes, meshes, dtype: str, *, max_bucket: int,
    kernel: str = "cuda", measure: str = "auto", min_gain: float | None = None,
    prune_margin: float | None = None, seed: int = 0, log=print,
) -> None:
    """The ``--tune`` pre-pass: fill every tuning axis a serve config reads
    at engine construction — the kernels, stages and combine of the matvec
    and the GEMM path (the GEMM at the widest bucket), the storage format,
    the solver tier and the promotion crossover over the bucket ladder —
    then drop the dispatch singleton so the engines read the fresh
    decisions."""
    from ..engine.buckets import bucket_ladder
    from ..tuning import TuningCache, reset_cache
    from ..tuning.search import TUNE_MIN_GAIN, tune_config, tune_promotion

    if min_gain is None:
        min_gain = TUNE_MIN_GAIN
    # kernel='auto' would read the cache being filled: race on the default.
    kernel = "cuda" if kernel == "auto" else kernel
    cache = TuningCache.load()
    log(f"serve tuning pre-pass -> {cache.path}")
    buckets = tuple(b for b in bucket_ladder(max_bucket) if b >= 2)
    for m, k in sizes:
        for mesh in meshes:
            for name in strategies:
                common = dict(kernel=kernel, min_gain=min_gain,
                              prune_margin=prune_margin, seed=seed, log=log)
                tune_config(name, mesh, m, k, dtype, cache, op="matvec",
                            measure=measure, **common)
                tune_config(name, mesh, m, k, dtype, cache, op="gemm",
                            n_rhs=max_bucket, measure=measure, **common)
                tune_promotion(name, mesh, m, k, dtype, cache, buckets=buckets,
                               **common)
            cache.save()
    cache.save()
    reset_cache()


def run_serve_sweep(args: argparse.Namespace) -> int:
    """The ``--op serve`` body shared by this module's CLI and
    ``bench.sweep``: the sequential protocol for every (size, strategy,
    device count). ``--annotate`` scopes the named-span override to this
    run (an in-process caller must not find the process-wide flag flipped
    afterwards)."""
    from ..obs.annotations import annotations

    if getattr(args, "annotate", False):
        with annotations(True):  # named spans in every program run below
            return _run_serve_sweep(args)
    return _run_serve_sweep(args)


def _run_serve_sweep(args: argparse.Namespace) -> int:
    from ..parallel.mesh import make_mesh
    from .sweep import (
        SQUARE_SIZES,
        device_counts_available,
        platform_devices,
        resolve_strategies,
    )

    _check_flags(args)
    # Solver mode: --op selects a served solver; the namespace attribute is
    # solver_op because bench.sweep forwards its own args.op ("serve").
    solver_op = getattr(args, "solver_op", "matvec") or "matvec"
    devices = platform_devices(args.platform, args.host_devices)
    strategies = resolve_strategies(args.strategy)
    counts = args.devices or device_counts_available(len(devices))
    sizes = (
        [(s, s) for s in args.sizes] if args.sizes
        else [(s, s) for s in SQUARE_SIZES]
    )
    meshes = {n: make_mesh(n, devices=devices) for n in counts}
    if getattr(args, "tune", False) and solver_op == "matvec":
        tune_serve(
            strategies, sizes, [meshes[n] for n in counts], args.dtype,
            max_bucket=args.max_bucket, kernel=args.kernel,
            measure=getattr(args, "measure", "auto") or "auto",
            min_gain=getattr(args, "min_gain", None),
            prune_margin=getattr(args, "prune_margin", None), seed=args.seed,
        )
    promote = args.promote
    if promote == "never":
        promote = None
    elif promote not in (None, "auto"):
        promote = int(promote)
    metrics_out = getattr(args, "metrics_out", None)
    # Load mode engages when the traffic shape asks for it: an open-loop
    # arrival process, offered concurrency or an explicit --coalesce. The
    # bare invocation stays on the sequential protocol (promotion check
    # included).
    arrival = getattr(args, "arrival", "closed") or "closed"
    concurrency = getattr(args, "concurrency", None) or [1]
    coalesce_arg = getattr(args, "coalesce", None)
    # Chaos is a load-protocol feature: the loops there tolerate
    # per-request failures.
    load_mode = (arrival != "closed" or any(c > 1 for c in concurrency)
                 or coalesce_arg is not None
                 or getattr(args, "fault_spec", None) is not None
                 or (getattr(args, "poison_rate", 0.0) or 0.0) > 0)
    n_done = 0
    for m, k in sizes:
        for name in strategies:
            for n_dev in counts:
                if solver_op != "matvec":
                    n_done += _run_solver_config(args, name, meshes[n_dev], m)
                    continue
                if getattr(args, "tenants", None):
                    # Multi-tenant trace mode takes precedence over the
                    # load and sequential protocols.
                    n_done += _run_tenants_config(args, name, meshes[n_dev], m, k,
                                                  promote)
                    continue
                if load_mode:
                    n_done += _run_load_configs(args, name, meshes[n_dev], m, k,
                                                promote, concurrency, coalesce_arg)
                    continue
                try:
                    result = run_serve(
                        name, meshes[n_dev], m, k, dtype=args.dtype,
                        kernel=args.kernel, combine=getattr(args, "combine", None),
                        stages=getattr(args, "stages", None),
                        n_requests=args.n_requests,
                        max_bucket=args.max_bucket, promote=promote,
                        seed=args.seed, metrics_out=metrics_out,
                        dtype_storage=getattr(args, "dtype_storage", None),
                        rtol=getattr(args, "spec_rtol", None),
                    )
                except MatvecError as e:
                    print(f"skip {name} {m}x{k} p={n_dev}: {e}")
                    continue
                path = None if args.no_csv else append_serve_result(
                    result, args.data_root
                )
                storage_suffix = (
                    f" storage={result.dtype_storage} "
                    f"resident={result.resident_bytes / 1e6:.2f}MB"
                    if result.dtype_storage != "native" else ""
                )
                if result.speculated:
                    storage_suffix += (
                        f" spec={result.speculated} "
                        f"esc_rate={result.escalation_rate:.4f} "
                        f"bw_ratio={result.spec_bandwidth_ratio:.3f}"
                    )
                print(
                    f"serve {name} {m}x{k} p={n_dev} "
                    f"b*={result.b_star} {result.rps:.1f} req/s "
                    f"{result.cols_per_s:.1f} cols/s "
                    f"p50={result.p50_dispatch_ms:.3f}ms "
                    f"p99={result.p99_dispatch_ms:.3f}ms "
                    f"compiles={result.compiles_warmup}+"
                    f"{result.compiles_steady} "
                    f"promo x{result.promo_speedup:.2f} @b={result.promo_b}"
                    f"{storage_suffix}"
                )
                if path is not None:
                    print(f"CSV: {path}")
                n_done += 1
    if n_done and metrics_out is not None:
        print(f"metrics: {metrics_out}")
    print(f"{n_done} serve configs measured")
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m matvec_mpi_multiplier_torch.bench.serve",
        description="Serve-throughput benchmark: mixed-width request "
        "stream against a resident sharded A through the serving engine "
        "(engine/): the sequential protocol, or load mode (closed- and "
        "open-loop traffic, optionally coalesced by the arrival-window "
        "scheduler).",
    )
    p.add_argument(
        "--strategy", nargs="+", default=["all"],
        help=f"strategies to serve: {available_strategies()} or 'all'",
    )
    p.add_argument("--devices", nargs="+", type=int, default=None)
    p.add_argument("--sizes", nargs="+", type=int, default=None)
    p.add_argument("--dtype", default="float32")
    p.add_argument("--kernel", default="cuda")
    p.add_argument(
        "--combine", default=None,
        help="combine schedule (or 'auto': the tuning cache's, the static "
        "default on a miss)",
    )
    p.add_argument(
        "--stages", type=int, default=None,
        help="with --combine overlap: pin the staged schedule's stage "
        "count S (default: the tuning cache's, 2 on a miss; clamped per "
        "shape)",
    )
    p.add_argument("--n-requests", type=int, default=200,
                   help="steady-phase request count")
    p.add_argument("--max-bucket", type=int, default=32,
                   help="widest batch bucket (power-of-two ladder below it)")
    p.add_argument(
        "--promote", default="auto",
        help="GEMV->GEMM crossover b*: 'auto' (the tuning cache's, 4 on a "
        "miss), an int, or 'never'",
    )
    p.add_argument("--metrics-out", default=None, metavar="FILE",
                   help="write the metrics snapshot after each config")
    p.add_argument(
        "--dtype-storage", dest="dtype_storage", default=None,
        choices=["native", "int8", "int8c", "fp8", "auto", "speculate"],
        help="resident-A storage format (ops/quantize.py): quantize A once "
        "at residency and serve from the low-bit payload; 'auto' takes the "
        "tuning cache's format (native on a miss); 'speculate' arms the "
        "int8c speculative tier beside native (requests opt in with "
        "--spec-rtol). CSV rows record the resolved format + resident bytes",
    )
    p.add_argument(
        "--spec-rtol", dest="spec_rtol", type=float, default=None,
        help="per-request relative tolerance of the matvec serve protocol: "
        "with --dtype-storage speculate every steady request is served from "
        "the int8c tier behind the check on the card, escalating to native "
        "only on a miss (ops/speculative.py). Default: exact, native",
    )
    p.add_argument(
        "--op", dest="solver_op", default="matvec",
        choices=["matvec"] + list(SOLVER_OPS),
        help="serve answers instead of multiplies (solvers/): each request is "
        "one solve of A x = b (cg/gmres/chebyshev) or an eigenpair estimate "
        "(power/lanczos) against a seeded SPD operand; --n-requests becomes "
        "the steady solve count and rows land in serve_solver_<strategy>.csv",
    )
    p.add_argument(
        "--solver-kernel", default="torch", choices=list(SOLVER_KERNELS),
        help="with --op cg|chebyshev: the iteration tier — the unfused "
        "PyTorch loop, the fused CUDA step (ops/cuda_solver.py), or 'auto' "
        "(the tuning cache's tier, the unfused one on a miss)",
    )
    p.add_argument(
        "--rtol", type=float, default=1e-6,
        help="with --op <solver>: relative convergence tolerance (a per-call "
        "argument — changing it never builds again)",
    )
    p.add_argument(
        "--rtol-sweep", nargs="+", type=float, default=None,
        help="with --op <solver>: cycle steady solves across this rtol "
        "ladder instead of one fixed --rtol — shows compiles_steady=0 "
        "across the whole ladder",
    )
    p.add_argument(
        "--maxiter", type=int, default=None,
        help="with --op <solver>: iteration cap (per-call; default: the "
        "engine's DEFAULT_SOLVER_MAXITER)",
    )
    p.add_argument(
        "--restart", type=int, default=None,
        help="with --op gmres: restart length (part of the executable's "
        "bucket key)",
    )
    p.add_argument(
        "--steps", type=int, default=None,
        help="with --op lanczos: Krylov steps (part of the executable's "
        "bucket key)",
    )
    p.add_argument(
        "--arrival", choices=["closed", "poisson", "burst"], default="closed",
        help="traffic shape: closed-loop clients (--concurrency) or an "
        "open-loop arrival process at --rate req/s (load mode)",
    )
    p.add_argument("--rate", type=float, default=500.0,
                   help="with --arrival poisson|burst: offered request rate (req/s)")
    p.add_argument("--burst", type=int, default=8,
                   help="with --arrival burst: simultaneous arrivals per burst")
    p.add_argument(
        "--concurrency", nargs="+", type=int, default=None,
        help="closed-loop client counts to sweep (any value above 1 engages "
        "load mode)",
    )
    p.add_argument(
        "--coalesce", choices=["on", "off", "both"], default=None,
        help="serve through the arrival-window scheduler (engine/scheduler.py); "
        "'both' measures each config uncoalesced, then coalesced, on the same "
        "trace. Any value engages load mode",
    )
    p.add_argument(
        "--window-ms", default="auto",
        help="coalescing window: 'auto' (adaptive from the arrival-rate "
        "estimator) or a fixed window in ms",
    )
    p.add_argument("--max-window-ms", type=float, default=DEFAULT_MAX_WINDOW_MS,
                   help="adaptive coalescing window cap (ms)")
    p.add_argument(
        "--flush-width", default="auto",
        help="batch width that flushes the window at the first lull: 'auto' "
        "(the tuned promotion point b*) or an int",
    )
    p.add_argument(
        "--deadline-ms", type=float, default=None,
        help="(load mode) every request's deadline: it fails typed rather than "
        "dispatch late, and one the window cannot hold bypasses it",
    )
    p.add_argument(
        "--max-in-flight", type=int, default=None,
        help="(load mode) the engine's backpressure mark: outstanding "
        "dispatches before a submit drains the oldest",
    )
    p.add_argument(
        "--integrity-gate", action="store_true",
        help="(load mode) refuse NaN/Inf results at materialization "
        "(engine_integrity_failures_total; per request slice when coalesced)",
    )
    p.add_argument(
        "--trace-jsonl", default=None, metavar="FILE",
        help="(load mode) stream one request span tree per request "
        "(submit->gate->bucket_pad->exec_lookup->dispatch->materialize) to FILE",
    )
    p.add_argument(
        "--events-jsonl", default=None, metavar="FILE",
        help="(load mode) stream the correlated event timeline (submits, "
        "coalesces, bypasses, failures, with request_id/cause_id) to FILE",
    )
    p.add_argument(
        "--fault-spec", default=None, metavar="SPEC",
        help="chaos mode: a seeded fault-injection plan, e.g. "
        "'dispatch:device_error:p=0.05;dispatch:nan:times=2' (grammar: "
        "resilience/faults.py); engages load mode and, by default, the "
        "retry/breaker recovery policy. Compile-site specs fire only for "
        "programs first built in the steady phase (fallback tiers, halved "
        "buckets): warmup builds the preferred ones",
    )
    p.add_argument(
        "--fault-seed", type=int, default=0,
        help="seed of the fault plan's draws and the retry policy's jitter",
    )
    p.add_argument(
        "--poison-rate", type=float, default=0.0,
        help="chaos mode: share of the requests (a seeded choice) marked "
        "with the poison signature; each fails its dispatch, exercising the "
        "scheduler's batch bisection",
    )
    p.add_argument(
        "--breaker-reset-s", type=float, default=30.0,
        help="chaos mode: the circuit breakers' open -> half-open cooldown",
    )
    p.add_argument(
        "--slo-out", default=None, metavar="FILE",
        help="(load mode) evaluate the declared SLOs (obs/slo.py "
        "DEFAULT_TARGETS) over the run and write the burn-rate evaluation "
        "JSON; render with `python -m matvec_mpi_multiplier_torch.obs slo FILE`",
    )
    p.add_argument(
        "--flight-dir", default=None, metavar="DIR",
        help="(load mode) arm the flight recorder: dump a post-mortem bundle "
        "(last events, metric snapshots, SLO state) into DIR on each typed "
        "failure; render with `python -m matvec_mpi_multiplier_torch.obs dump "
        "BUNDLE`",
    )
    p.add_argument(
        "--annotate", action="store_true",
        help="enable named spans (each strategy's local GEMV and combine, the "
        "overlap stages' stage{i}/compute|combine) in every program this run "
        "runs; pair with a torch.profiler capture (bench/profiling.py). A "
        "captured program's spans are recorded at its capture only",
    )
    p.add_argument(
        "--tenants", type=int, default=None,
        help="multi-tenant trace mode (engine/registry.py): register N seeded "
        "tenant matrices in a matrix registry and drive a Zipf-popularity "
        "trace against --hbm-budget; one CSV row per tenant plus an ALL row "
        "in serve_tenants_<strategy>.csv. Takes precedence over the load and "
        "sequential protocols",
    )
    p.add_argument(
        "--zipf-a", type=float, default=1.1,
        help="with --tenants: Zipf popularity exponent (p(rank) ∝ rank^-a; "
        "higher = more skew toward hot tenants)",
    )
    p.add_argument(
        "--hbm-budget", default=None, metavar="BYTES|Nx",
        help="with --tenants: resident-payload budget — plain bytes, or a "
        "payload multiple like '2.5x' (room for 2.5 tenants of this shape). "
        "Omit for unlimited (accounting still runs)",
    )
    p.add_argument(
        "--pin-hot", type=int, default=0,
        help="with --tenants: warm-pin the K most popular tenants "
        "(eviction-exempt) before the trace",
    )
    p.add_argument(
        "--tenant-quota", default=None, metavar="N|tenant-i=N,...",
        help="with --tenants: max_in_flight admission quota — a bare int for "
        "every tenant, or 'tenant-0=4' to throttle named tenants only",
    )
    p.add_argument(
        "--poison-tenant", default=None, metavar="TENANT",
        help="with --tenants and --poison-rate: plant the poison signature "
        "only in this tenant's requests",
    )
    p.add_argument(
        "--global-sched", choices=["on", "off", "both"], default=None,
        dest="global_sched",
        help="with --tenants: route submits through the cost-model-driven "
        "global scheduler (engine/global_scheduler.py): predicted-time "
        "admission, cross-tenant interleaving and coalescing, demand-aware "
        "eviction. 'both' runs the greedy baseline, then the scheduled run "
        "on the same seeded trace",
    )
    p.add_argument(
        "--reshard", choices=["auto", "off"], default="off",
        help="with --tenants --global-sched on: arm the scheduler's online-"
        "resharding trigger (a tenant migrates on the card when the cost "
        "model predicts another layout wins by more than the migration "
        "amortized over its demand horizon); 'off' keeps every tenant in "
        "its registered layout",
    )
    p.add_argument(
        "--demand-weight", type=float, default=2.0, dest="demand_weight",
        help="with --global-sched on|both: weight of the predicted-demand "
        "term in the registry's eviction score (0 = recency+cost)",
    )
    p.add_argument(
        "--decision-jsonl", default=None, metavar="FILE", dest="decision_jsonl",
        help="with --global-sched: mirror every scheduling decision "
        "(admit/reject/interleave/evict/flush/reshard, each with "
        "predicted_s and reason) to FILE",
    )
    p.add_argument(
        "--tune", action="store_true",
        help="pre-pass: measure the kernels, stages, combines (matvec and "
        "gemm), storage, solver tier and promotion crossover of every "
        "config and keep them in the tuning cache",
    )
    p.add_argument("--min-gain", type=float, default=None,
                   help="with --tune: hysteresis margin (default 0.05)")
    p.add_argument("--prune-margin", type=float, default=None,
                   dest="prune_margin",
                   help="with --tune: cost-model pruning — measure only the "
                   "candidates predicted within this margin of the predicted "
                   "winner (a calibrated cache; exhaustive with a log line "
                   "without one)")
    p.add_argument("--measure", choices=["auto", "loop", "chain", "sync"],
                   default="auto", help="with --tune: the races' timing method")
    p.add_argument("--data-root", default=None)
    p.add_argument("--no-csv", action="store_true")
    p.add_argument(
        "--platform", choices=["cuda", "cpu"], default="cuda",
        help="devices to mesh over: the CUDA devices (default) or CPU shards",
    )
    p.add_argument("--host-devices", type=int, default=None)
    p.add_argument("--seed", type=int, default=0)
    return p


def main(argv: list[str] | None = None) -> int:
    return run_serve_sweep(build_parser().parse_args(argv))


if __name__ == "__main__":
    sys.exit(main())
