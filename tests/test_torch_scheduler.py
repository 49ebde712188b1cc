"""The port's arrival-window scheduler against the JAX package's
(engine/scheduler.py).

Mirrors the cases of tests/test_scheduler.py. The same seeded numpy A and
requests go through the JAX package's scheduler on the conftest's 8-device
CPU mesh and through the port's on 8 logical CPU shards, whose kernels run
their plain versions on CPU tensors.

Bars against the JAX package (the engine tests'): each element within
1e-12 (fp64), 1e-5 (fp32) or 2^-7 (bf16) of |A|·|x| at that element. Within
the port, coalesced columns are BITWISE the same request alone through the
same bucket program. Counts (engine dispatches, batches, coalesced
requests, bisection splits) must equal the JAX package's where the flushes
are deterministic: flushes here come from the widest bucket (inline),
``flush()``, ``close()`` and deadlines already past, never from the window's
timing. The port's tests that must not see the flusher thread monkeypatch
it away (``manual``); the clock is replaced on the instance (``_clock``).
"""

import threading

import numpy as np
import pytest
import torch

from matvec_mpi_multiplier_tpu import make_mesh as jax_make_mesh
from matvec_mpi_multiplier_tpu.engine import ArrivalWindowScheduler as JaxScheduler
from matvec_mpi_multiplier_tpu.engine import MatvecEngine as JaxEngine
from matvec_mpi_multiplier_tpu.engine.scheduler import (
    SYSTEMIC_FAILURE_THRESHOLD as JAX_SYSTEMIC,
)
from matvec_mpi_multiplier_tpu.resilience import FaultPlan as JaxFaultPlan
from matvec_mpi_multiplier_tpu.resilience import FaultSpec as JaxFaultSpec
from matvec_mpi_multiplier_tpu.tuning import reset_cache as jax_reset_cache
from matvec_mpi_multiplier_tpu.utils.errors import (
    DeadlineExceededError as JaxDeadlineExceededError,
)
from matvec_mpi_multiplier_torch import tuning
from matvec_mpi_multiplier_torch.engine import (
    DEFAULT_PROMOTE_B,
    SYSTEMIC_FAILURE_THRESHOLD,
    ArrivalWindowScheduler,
    MatvecEngine,
    bucket_for,
    pad_columns,
    split_widths,
)
from matvec_mpi_multiplier_torch.parallel.mesh import make_mesh
from matvec_mpi_multiplier_torch.resilience import (
    DeviceFaultError,
    FaultPlan,
    FaultSpec,
    ResultIntegrityError,
)
from matvec_mpi_multiplier_torch.utils.errors import ConfigError, DeadlineExceededError

CPU = torch.device("cpu")
BARS = {"float64": 1e-12, "float32": 1e-5, "bfloat16": 2.0 ** -7}
POISON = 1e30


class FakeClock:
    """Deterministic monotonic clock (seconds)."""

    def __init__(self, t: float = 100.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance_ms(self, ms: float) -> None:
        self.t += ms / 1e3


@pytest.fixture()
def manual(monkeypatch):
    """Port schedulers without the flusher thread: flushes come only from
    width, flush(), close() and interactive requests."""
    monkeypatch.setattr(ArrivalWindowScheduler, "_flusher_loop", lambda self: None)


@pytest.fixture(autouse=True)
def cold_cache(tmp_path, monkeypatch):
    """Both packages read an empty tuning cache: flush_width="auto" and
    promote="auto" take their static defaults."""
    monkeypatch.setenv("MATVEC_TUNING_CACHE", str(tmp_path / "tuning_cache.json"))
    tuning.reset_cache()
    jax_reset_cache()
    yield tmp_path / "tuning_cache.json"
    tuning.reset_cache()
    jax_reset_cache()


def port_mesh(p=8):
    return make_mesh(p, devices=[CPU] * p)


def host(y) -> np.ndarray:
    """A port result as float64 numpy."""
    return y.double().numpy() if isinstance(y, torch.Tensor) else np.asarray(y, np.float64)


def assert_close(got, want, a, x, dtype):
    """Within the engine tests' bar of |A|·|x|, element by element."""
    scale = np.abs(np.asarray(a, np.float64)) @ np.abs(np.asarray(x, np.float64))
    err = np.abs(host(got) - np.asarray(want, np.float64))
    assert np.all(err <= BARS[dtype] * scale), float(np.max(err / scale))


def engines(a, strategy="rowwise", fault_plan=None, jax_fault_plan=None, **kwargs):
    """The same A in both packages' engines, same configuration (each
    package's own fault plan)."""
    kwargs.setdefault("promote", 4)
    kwargs.setdefault("max_bucket", 8)
    port = MatvecEngine(a, port_mesh(), strategy=strategy, fault_plan=fault_plan, **kwargs)
    ref = JaxEngine(a, jax_make_mesh(8), strategy=strategy, fault_plan=jax_fault_plan,
                    **kwargs)
    return port, ref


def scheds(port, ref, **kwargs):
    """One scheduler per package; the JAX one without its flusher thread
    (its own tests' protocol), the port's as the test's fixtures left it."""
    kwargs.setdefault("window_ms", 50.0)
    kwargs.setdefault("flush_width", 8)
    clock = kwargs.pop("clock", None)
    s = ArrivalWindowScheduler(port, **kwargs)
    j = JaxScheduler(ref, auto_flush=False, **({"clock": clock} if clock else {}), **kwargs)
    if clock is not None:
        s._clock = clock
    return s, j


def uniform(rng, shape, dtype="float32"):
    return rng.uniform(0, 10, shape).astype(dtype)


# ------------------------------------------------------------- coalescing


def test_coalesces_into_one_engine_request(manual, rng):
    a = uniform(rng, (64, 64))
    port, ref = engines(a)
    s, j = scheds(port, ref, flush_width=4)
    X = uniform(rng, (64, 4))
    futs = [s.submit(X[:, c]) for c in range(3)]
    jfuts = [j.submit(X[:, c]) for c in range(3)]
    assert port.stats.requests == 0 and all(not f.done() for f in futs)
    assert s.flush() == j.flush() == 3
    for c, (f, jf) in enumerate(zip(futs, jfuts)):
        assert_close(f.result(), jf.result(), a, X[:, c], "float32")
        assert f.coalesced and f.batch_width == 3 and f.offset == c
        assert (f.batch_width, f.offset) == (jf.batch_width, jf.offset)
    assert port.stats.requests == ref.stats.requests == 1
    assert port.stats.dispatches == ref.stats.dispatches
    assert s.stats.batches == j.stats.batches == 1
    assert s.stats.coalesced_requests == j.stats.coalesced_requests == 3


def test_lull_flush_threshold_triggers_via_flusher(rng):
    """Reaching flush_width arms the settle-lull flush on the flusher
    thread: four submits dispatch without waiting out a 10 s window. The
    outcome (one engine request) does not depend on the timing."""
    a = uniform(rng, (64, 64))
    port = MatvecEngine(a, port_mesh(), strategy="rowwise", promote=4, max_bucket=8)
    with ArrivalWindowScheduler(port, window_ms=10_000.0, flush_width=4) as sched:
        X = uniform(rng, (64, 4))
        futs = [sched.submit(X[:, c]) for c in range(4)]
        for c, f in enumerate(futs):
            assert_close(f.result(timeout=30.0), a @ X[:, c], a, X[:, c], "float32")
        assert port.stats.requests == 1


def test_widest_bucket_flushes_inline(manual, rng):
    a = uniform(rng, (64, 64))
    port, ref = engines(a)
    s, j = scheds(port, ref, flush_width=8)
    X = uniform(rng, (64, 8))
    futs = [s.submit(X[:, c]) for c in range(8)]
    jfuts = [j.submit(X[:, c]) for c in range(8)]
    assert all(f._event.is_set() for f in futs)  # resolved without flush()
    Y = torch.stack([f.result() for f in futs], dim=1)
    assert_close(Y, np.stack([jf.result() for jf in jfuts], axis=1), a, X, "float32")
    assert port.stats.requests == ref.stats.requests == 1
    assert port.stats.dispatches == ref.stats.dispatches == 1


def test_block_requests_coalesce_and_split_exactly(manual):
    """Mixed-width blocks stack in arrival order; width 3+1+5 = 9 reaches the
    widest bucket (8) and flushes inline as chunks 8 + 1, the tail flushes
    explicitly, and every request unpads to exactly its own columns."""
    rng2 = np.random.default_rng(3)
    a = rng2.uniform(0, 10, (64, 64))
    port, ref = engines(a, promote=2, dtype="float64")
    s, j = scheds(port, ref, flush_width=32)
    blocks = [rng2.uniform(0, 10, (64, w)) for w in (3, 1, 5, 2)]
    vec = rng2.uniform(0, 10, (64,))
    futs = [s.submit(b) for b in blocks] + [s.submit(vec)]
    jfuts = [j.submit(b) for b in blocks] + [j.submit(vec)]
    assert s.flush() == j.flush() == 2
    for b, f, jf in zip(blocks + [vec], futs, jfuts):
        y = f.result()
        assert tuple(y.shape) == b.shape
        assert_close(y, jf.result(), a, b, "float64")
    assert port.stats.requests == ref.stats.requests == 2
    assert port.stats.dispatches == ref.stats.dispatches
    assert futs[0].batch_width == 9 and futs[-1].batch_width == 3


def test_empty_flush_and_pending_width(manual, rng):
    a = uniform(rng, (64, 64))
    port = MatvecEngine(a, port_mesh(), strategy="rowwise", promote=4, max_bucket=8)
    sched = ArrivalWindowScheduler(port, window_ms=50.0, flush_width=8)
    assert sched.flush() == 0
    sched.submit(uniform(rng, (64, 2)))
    assert sched.pending_width == 2
    assert sched.flush() == 1
    assert sched.pending_width == 0


def test_request_validation_mirrors_engine(manual, rng):
    a = uniform(rng, (64, 64))
    port = MatvecEngine(a, port_mesh(), strategy="rowwise", promote=4, max_bucket=8)
    sched = ArrivalWindowScheduler(port, window_ms=50.0, flush_width=8)
    for bad in (np.ones(32, np.float32), np.ones((32, 3), np.float32),
                np.ones((64, 0), np.float32)):
        with pytest.raises(ConfigError):
            sched.submit(bad)
    with pytest.raises(ConfigError):
        sched.submit(np.ones(64, np.float32), qos="nope")
    # The port stacks on the host: a request on another device is refused.
    with pytest.raises(ConfigError, match="host"):
        sched.submit(torch.ones(64, device="meta"))
    assert sched.pending_width == 0  # rejected requests never queue


# ---------------------------------------------------------------- exactness


@pytest.mark.parametrize("dtype", ["float32", "float64", "bfloat16"])
def test_coalesced_bitwise_equals_alone_same_bucket(manual, dtype):
    """Every coalesced result is bit-identical to the request dispatched
    alone through the same bucket program (promote=1 rides the GEMM path
    always), across mixed widths and a bucket-boundary split; and within the
    bar of the JAX scheduler's on the same requests."""
    rng2 = np.random.default_rng(11)
    a = rng2.uniform(0, 10, (64, 64))
    blocks = [rng2.uniform(0, 10, (64, w)) for w in (3, 1, 5, 2)]
    np_dtype = "float32" if dtype == "bfloat16" else dtype
    tdt = getattr(torch, dtype)

    def cast(arr):  # bf16 through fp32, as ml_dtypes rounds the JAX side's
        return torch.from_numpy(arr.astype(np_dtype)).to(tdt)

    port = MatvecEngine(cast(a), port_mesh(), strategy="colwise", promote=2,
                        max_bucket=8)
    sched = ArrivalWindowScheduler(port, window_ms=50.0, flush_width=32)
    tb = [cast(b) for b in blocks]
    futs = [sched.submit(b) for b in tb]
    sched.flush()
    got = [f.result() for f in futs]
    assert {f.batch_width for f in futs} == {9, 2}
    solo = MatvecEngine(cast(a), port_mesh(), strategy="colwise", promote=1,
                        max_bucket=8)
    for b, f, y in zip(tb, futs, got):
        chunk_widths = split_widths(f.batch_width, port.max_bucket)
        chunk_starts = np.cumsum([0] + chunk_widths[:-1])
        for c in range(b.shape[1]):
            col_at = f.offset + c
            ci = max(i for i, st in enumerate(chunk_starts) if st <= col_at)
            bucket = bucket_for(chunk_widths[ci], port.max_bucket)
            alone = solo.submit(pad_columns(b[:, c:c + 1], bucket)).result()
            assert torch.equal(y[:, c] if y.dim() == 2 else y, alone[:, 0]), (
                f"width={b.shape[1]} col={c} bucket={bucket}")
    if dtype == "bfloat16":
        # The JAX package's bf16 operands: the same values, cast by ml_dtypes.
        import ml_dtypes

        jdt = ml_dtypes.bfloat16
        ja = a.astype(np.float32).astype(jdt)
        jblocks = [b.astype(np.float32).astype(jdt) for b in blocks]
    else:
        ja, jblocks = a.astype(np_dtype), [b.astype(np_dtype) for b in blocks]
    ref = JaxEngine(ja, jax_make_mesh(8), strategy="colwise", promote=2, max_bucket=8)
    j = JaxScheduler(ref, auto_flush=False, window_ms=50.0, flush_width=32)
    jfuts = [j.submit(b) for b in jblocks]
    j.flush()
    for b, y, jf in zip(jblocks, got, jfuts):
        assert_close(y, np.asarray(jf.result(), np.float64), np.asarray(ja, np.float64),
                     np.asarray(b, np.float64), dtype)


def test_sub_promotion_batch_bitwise_equals_solo_vectors(manual):
    """A flushed batch below b* rides the per-column matvec path — the SAME
    program a solo vector submit uses: bitwise equal, three dispatches in
    both packages."""
    rng2 = np.random.default_rng(5)
    a = rng2.uniform(0, 10, (64, 64))
    port, ref = engines(a, promote=4, dtype="float64")
    s, j = scheds(port, ref, flush_width=8)
    X = rng2.uniform(0, 10, (64, 3))
    futs = [s.submit(X[:, c]) for c in range(3)]
    jfuts = [j.submit(X[:, c]) for c in range(3)]
    s.flush()
    j.flush()
    assert port.stats.dispatches == ref.stats.dispatches == 3
    for c, (f, jf) in enumerate(zip(futs, jfuts)):
        assert torch.equal(f.result(), port.submit(X[:, c]).result())
        assert_close(f.result(), jf.result(), a, X[:, c], "float64")


def test_coalesced_matches_serial_oracle_mixed_dtypes(manual):
    """Requests of mixed dtypes normalize to the engine dtype at the door,
    as in the JAX package."""
    rng2 = np.random.default_rng(7)
    a = rng2.uniform(0, 10, (64, 64))
    port, ref = engines(a, promote=2, dtype="float64")
    s, j = scheds(port, ref, flush_width=32)
    futs, jfuts, xs = [], [], []
    for w, dt in [(1, np.float64), (3, np.float32), (2, np.int32), (5, np.float64)]:
        X = rng2.uniform(0, 10, (64, w)).astype(dt)
        xs.append(X.astype(np.float64))
        futs.append(s.submit(X))
        jfuts.append(j.submit(X))
    s.flush()
    j.flush()
    for f, jf, X in zip(futs, jfuts, xs):
        assert_close(f.result().reshape(64, -1), np.asarray(jf.result()).reshape(64, -1),
                     a, X, "float64")


# ----------------------------------------------------- deadlines and QoS


def test_stale_on_arrival_fails_without_touching_window(manual, rng):
    a = uniform(rng, (64, 64))
    port, ref = engines(a)
    s, j = scheds(port, ref)
    x = uniform(rng, (64,))
    for sched, error in ((s, DeadlineExceededError), (j, JaxDeadlineExceededError)):
        fut = sched.submit(x, deadline_ms=-1.0)
        assert fut.done() and isinstance(fut.exception(), error)
        with pytest.raises(error):
            fut.result()
        assert sched.pending_width == 0 and sched.stats.deadline_failures == 1
    assert port.stats.requests == ref.stats.requests == 0


def test_tight_deadline_bypasses_the_window(manual, rng):
    """A deadline that cannot survive the window dispatches at once, alone,
    with the deadline intact; it neither waits nor flushes the open batch."""
    a = uniform(rng, (64, 64))
    port, ref = engines(a)
    s, j = scheds(port, ref, window_ms=20.0, clock=FakeClock())
    x_wait, x_rush = uniform(rng, (64,)), uniform(rng, (64,))
    results = []
    for sched, eng in ((s, port), (j, ref)):
        waiting = sched.submit(x_wait)  # opens the 20 ms window
        rushed = sched.submit(x_rush, deadline_ms=19.0)  # 19 < 20: bypass
        results.append(rushed.result())
        assert not rushed.coalesced and not waiting.done()
        assert sched.stats.bypass == 1 and eng.stats.requests == 1
        sched.flush()
        results.append(waiting.result())
    assert_close(results[0], results[2], a, x_rush, "float32")
    assert_close(results[1], results[3], a, x_wait, "float32")


def test_deadline_expiry_in_window_fails_without_poisoning_batch(manual, rng):
    """A request whose deadline has passed when its window flushes fails
    BEFORE dispatch; its batchmates dispatch as if it had never queued —
    bitwise a width-2 submit of the survivors."""
    a = uniform(rng, (64, 64))
    clock = FakeClock()
    port, ref = engines(a)
    s, j = scheds(port, ref, window_ms=50.0, clock=clock)
    x_ok1, x_doomed, x_ok2 = uniform(rng, (64,)), uniform(rng, (64, 2)), uniform(rng, (64,))
    futs = [s.submit(x_ok1), s.submit(x_doomed, deadline_ms=60.0), s.submit(x_ok2)]
    jfuts = [j.submit(x_ok1), j.submit(x_doomed, deadline_ms=60.0), j.submit(x_ok2)]
    clock.advance_ms(100.0)  # past the doomed deadline
    s.flush()
    j.flush()
    with pytest.raises(DeadlineExceededError):
        futs[1].result()
    with pytest.raises(JaxDeadlineExceededError):
        jfuts[1].result()
    assert s.stats.deadline_failures == j.stats.deadline_failures == 1
    assert futs[0].batch_width == futs[2].batch_width == jfuts[0].batch_width == 2
    assert port.stats.dispatches == ref.stats.dispatches
    direct = port.submit(np.stack([x_ok1, x_ok2], axis=1)).result()
    assert torch.equal(futs[0].result(), direct[:, 0])
    assert torch.equal(futs[2].result(), direct[:, 1])
    assert_close(futs[0].result(), jfuts[0].result(), a, x_ok1, "float32")
    assert_close(futs[2].result(), jfuts[2].result(), a, x_ok2, "float32")


def test_queued_deadline_pulls_flush_forward(manual, rng):
    """A queued deadline caps the batch's planned flush time, as the JAX
    scheduler plans it."""
    a = uniform(rng, (64, 64))
    clock = FakeClock()
    port, ref = engines(a)
    s, j = scheds(port, ref, window_ms=50.0, clock=clock)
    x = uniform(rng, (64,))
    for deadline in (None, 60.0, 55.0):
        s.submit(x, deadline_ms=deadline)
        j.submit(x, deadline_ms=deadline)
        assert s._flush_at == pytest.approx(j._flush_at)
    assert s._flush_at <= clock() + 55.0 / 1e3
    s.flush()
    j.flush()


def test_interactive_qos_flushes_pending_now(manual, rng):
    a = uniform(rng, (64, 64))
    port, ref = engines(a)
    s, j = scheds(port, ref, flush_width=8)
    x1, x2 = uniform(rng, (64,)), uniform(rng, (64,))
    f1, f2 = s.submit(x1), s.submit(x2, qos="interactive")
    jf1, jf2 = j.submit(x1), j.submit(x2, qos="interactive")
    assert f1._event.is_set() and f2._event.is_set()
    assert f1.coalesced and f2.coalesced and f2.batch_width == jf2.batch_width == 2
    assert_close(f2.result(), jf2.result(), a, x2, "float32")
    assert port.stats.requests == ref.stats.requests == 1


def test_bulk_qos_waits_the_full_cap(manual, rng):
    a = uniform(rng, (64, 64))
    clock = FakeClock()
    port, ref = engines(a)
    s, j = scheds(port, ref, window_ms="auto", max_window_ms=10.0, clock=clock)
    x = uniform(rng, (64,))
    for sched in (s, j):
        sched.submit(x, qos="bulk")
        assert sched._flush_at == pytest.approx(clock() + 0.010)
        sched.submit(x)  # standard at an estimated zero rate: window ~ 0
        assert sched._flush_at < clock() + 0.001
        sched.flush()


# --------------------------------------------------------- adaptive window


def test_adaptive_window_grows_with_rate(manual, rng):
    """~0 at a low arrival rate, toward the cap under load, decaying when
    traffic stops — the JAX scheduler's window on the same clock, to the
    float."""
    a = uniform(rng, (64, 64))
    clock = FakeClock()
    port, ref = engines(a)
    s, j = scheds(port, ref, window_ms="auto", max_window_ms=2.0, clock=clock)
    assert s.current_window_ms() == j.current_window_ms() == 0.0
    x = uniform(rng, (64,))
    for _ in range(300):  # ~2000 req/s: lambda = 4 -> w = 1.6 ms
        clock.advance_ms(0.5)
        for sched in (s, j):
            sched.submit(x)
            if sched.pending_width >= 8:
                sched.flush()
        assert s.current_window_ms() == pytest.approx(j.current_window_ms(), rel=1e-12)
    assert 1.0 < s.current_window_ms() < 2.0
    clock.advance_ms(2000.0)
    assert s.current_window_ms() < 0.1
    assert s.current_window_ms() == pytest.approx(j.current_window_ms(), rel=1e-12)
    s.flush()
    j.flush()


def test_fixed_window_zero_flushes_every_submit_via_flusher(rng):
    """window_ms=0: a lone request's batch is due at once; the flusher
    dispatches it without partners."""
    a = uniform(rng, (64, 64))
    port = MatvecEngine(a, port_mesh(), strategy="rowwise", promote=4, max_bucket=8)
    with ArrivalWindowScheduler(port, window_ms=0.0, flush_width=8) as sched:
        x = uniform(rng, (64,))
        fut = sched.submit(x)
        assert_close(fut.result(timeout=30.0), a @ x, a, x, "float32")
        assert not fut.coalesced


# ------------------------------------------- tuned flush threshold (b*)


def seed_promotion(path, decision):
    cache = tuning.TuningCache.load(path)
    cache.record(tuning.promote_key("rowwise", 64, 64, 8, "float32"), decision)
    cache.save()
    tuning.reset_cache()


@pytest.mark.parametrize("decision, want", [
    (None, DEFAULT_PROMOTE_B),  # cold cache: the static default
    ({"b_star": 6}, 6),
    ({"b_star": None}, 8),  # promotion never won: accumulate to max_bucket
    ({"b_star": 999}, 8),  # clamped to max_bucket
])
def test_flush_width_auto_reads_the_promotion_decision(manual, rng, cold_cache,
                                                       decision, want):
    if decision is not None:
        seed_promotion(cold_cache, decision)
    a = uniform(rng, (64, 64))
    port = MatvecEngine(a, port_mesh(), strategy="rowwise", promote=4, max_bucket=8)
    assert ArrivalWindowScheduler(port, flush_width="auto").flush_width == want
    with pytest.raises(ConfigError):
        ArrivalWindowScheduler(port, flush_width=0)


# ------------------------------------------------- backpressure & metrics


def test_backpressure_applies_to_whole_batches(manual, rng):
    """A flush is one engine.submit, so max_in_flight counts and drains
    whole batches."""
    a = uniform(rng, (64, 64))
    port, ref = engines(a, max_in_flight=1)
    s, j = scheds(port, ref, flush_width=2)
    X = uniform(rng, (64, 6))
    futs, jfuts = [], []
    for c in range(0, 6, 2):
        for sched, out in ((s, futs), (j, jfuts)):
            out.append(sched.submit(X[:, c]))
            out.append(sched.submit(X[:, c + 1]))
            sched.flush()
    for c, (f, jf) in enumerate(zip(futs, jfuts)):
        assert_close(f.result(), jf.result(), a, X[:, c], "float32")
    assert port.stats.requests == ref.stats.requests == 3
    assert port.stats.in_flight <= 1


def test_scheduler_metrics_and_amortized_bytes(manual, rng):
    """The scheduler's counters equal the JAX package's on the same flush."""
    a = uniform(rng, (64, 64))  # 64x64 f32: A = 16384 bytes
    port, ref = engines(a)
    s, j = scheds(port, ref, flush_width=8)
    X = uniform(rng, (64, 4))
    for sched in (s, j):
        futs = [sched.submit(X[:, c]) for c in range(4)]
        sched.flush()
        for f in futs:
            f.result()
    snap, jsnap = port.metrics.snapshot(), ref.metrics.snapshot()
    names = ("sched_requests_total", "sched_batches_total",
             "sched_coalesced_requests_total", "sched_amortized_bytes_total",
             "sched_bypass_total", "sched_deadline_failures_total")
    assert {n: snap["counters"][n] for n in names} == {n: jsnap["counters"][n] for n in names}
    assert snap["counters"]["sched_amortized_bytes_total"] == 3 * 64 * 64 * 4
    h, jh = snap["histograms"]["sched_batch_width"], jsnap["histograms"]["sched_batch_width"]
    assert (h["count"], h["sum"], h["buckets"]) == (jh["count"], jh["sum"], jh["buckets"])
    assert {"sched_arrival_req_per_s", "sched_coalesce_window_ms"} <= set(snap["gauges"])
    assert s.stats.mean_batch_width == j.stats.mean_batch_width == 4.0
    assert s.stats.coalesce_ratio == j.stats.coalesce_ratio == 1.0


def test_concurrent_closed_loop_hammer(rng):
    """Eight client threads submit->result->repeat through one scheduler
    with the flusher on. With flush_width = max_bucket = 8 and a 60 s window
    every flush is the eighth client's inline one: six batches of eight,
    every result exact, no build in the steady stream."""
    rng2 = np.random.default_rng(13)
    a = rng2.uniform(0, 10, (64, 64)).astype(np.float32)
    port = MatvecEngine(a, port_mesh(), strategy="rowwise", promote=2, max_bucket=8)
    port.warmup()
    baseline = port.stats.compiles
    sched = ArrivalWindowScheduler(port, window_ms=60_000.0, flush_width=8)
    X = rng2.uniform(0, 10, (64, 8)).astype(np.float32)
    errors = []

    def client(c):
        try:
            for _ in range(6):
                y = sched.submit(X[:, c]).result(timeout=60.0)
                assert_close(y, a @ X[:, c], a, X[:, c], "float32")
        except BaseException as e:
            errors.append(e)

    threads = [threading.Thread(target=client, args=(c,)) for c in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120.0)
        assert not t.is_alive()
    sched.close()
    assert not errors, errors
    assert port.stats.compiles == baseline, "steady coalesced stream built"
    assert sched.stats.requests == 48 and sched.stats.batches == 6
    assert sched.stats.mean_batch_width == 8.0


# ------------------------------------------------------------- lifecycle


def test_close_flushes_pending_and_refuses_new(manual, rng):
    a = uniform(rng, (64, 64))
    port, ref = engines(a)
    s, j = scheds(port, ref)
    x = uniform(rng, (64,))
    fut, jfut = s.submit(x), j.submit(x)
    s.close()
    j.close()
    assert_close(fut.result(), jfut.result(), a, x, "float32")
    for deadline in (None, 0.001, -1.0):  # every admission path refuses
        with pytest.raises(ConfigError, match="closed"):
            s.submit(x, deadline_ms=deadline)
    assert port.stats.requests == ref.stats.requests == 1
    s.close()  # idempotent


def poison_plans():
    return (FaultPlan([FaultSpec(site="dispatch", kind="device_error", poison=POISON)]),
            JaxFaultPlan([JaxFaultSpec(site="dispatch", kind="device_error",
                                       poison=POISON)]))


def test_bisection_isolates_poisoned_request(manual, rng):
    """A failed coalesced dispatch bisects: only the request that fails
    ALONE fails its caller, in both packages, with the same counts; its
    batchmates are bitwise what the unfaulted batch gives (the halves ride
    the original bucket's program: no build)."""
    a = uniform(rng, (64, 64))
    cols = [uniform(rng, (64,)) for _ in range(8)]
    cols[5][0] = np.float32(POISON)

    def run(fault):
        plan, jplan = poison_plans() if fault else (None, None)
        port, ref = engines(a, promote=1, fault_plan=plan, jax_fault_plan=jplan)
        s, j = scheds(port, ref, flush_width=8)
        out = []
        for sched in (s, j):
            futs = [sched.submit(c) for c in cols]  # the 8th flushes inline
            res = []
            for f in futs:
                try:
                    res.append(f.result(timeout=10))
                except Exception as e:  # the packages' own DeviceFaultError
                    assert type(e).__name__ == "DeviceFaultError"
                    res.append(None)
            sched.close()
            out.append(res)
        return out, port, ref

    (clean, _), _, _ = run(fault=False)
    (port_out, jax_out), port, ref = run(fault=True)
    assert [i for i, y in enumerate(port_out) if y is None] == [5]
    assert [i for i, y in enumerate(jax_out) if y is None] == [5]
    for i in range(8):
        if i != 5:
            assert torch.equal(port_out[i], clean[i])
            assert_close(port_out[i], jax_out[i], a, cols[i], "float32")
    names = ("sched_isolated_failures_total", "sched_bisect_splits_total",
             "sched_batch_failures_total", "sched_batches_total")
    got = {n: port.metrics.snapshot()["counters"][n] for n in names}
    assert got == {n: ref.metrics.snapshot()["counters"][n] for n in names}
    assert got["sched_isolated_failures_total"] == 1
    assert got["sched_bisect_splits_total"] == 3  # 8 -> 4 -> 2 -> 1
    assert port.stats.compiles == ref.stats.compiles == 1


def test_bisection_below_promotion_keeps_per_column_exactness(manual, rng):
    """A sub-b* flush rides the per-column path; bisection dispatches the
    halves at natural width and the survivors stay bitwise solo submits."""
    a = uniform(rng, (64, 64))
    plan, jplan = poison_plans()
    port, ref = engines(a, promote=None, fault_plan=plan, jax_fault_plan=jplan)
    solo = MatvecEngine(a, port_mesh(), strategy="rowwise", max_bucket=8, promote=None)
    s, j = scheds(port, ref, flush_width=8)
    cols = [uniform(rng, (64,)) for _ in range(3)]
    cols[1][0] = np.float32(POISON)
    futs, jfuts = [s.submit(c) for c in cols], [j.submit(c) for c in cols]
    s.flush()
    j.flush()
    with pytest.raises(DeviceFaultError):
        futs[1].result(timeout=10)
    with pytest.raises(Exception, match="poisoned payload"):
        jfuts[1].result(timeout=10)
    for i in (0, 2):
        assert torch.equal(futs[i].result(timeout=10), solo(cols[i]))
        assert_close(futs[i].result(), jfuts[i].result(), a, cols[i], "float32")
    assert (port.metrics.snapshot()["counters"]["sched_bisect_splits_total"]
            == ref.metrics.snapshot()["counters"]["sched_bisect_splits_total"])


def test_failed_dispatch_fails_every_future_in_batch(manual, rng, monkeypatch):
    """engine.submit raising at flush time fails the whole batch's futures
    (no client hangs in result()) and leaves the scheduler serving."""
    a = uniform(rng, (64, 64))
    port = MatvecEngine(a, port_mesh(), strategy="rowwise", promote=4, max_bucket=8)
    sched = ArrivalWindowScheduler(port, window_ms=50.0, flush_width=8)
    x = uniform(rng, (64,))
    f1, f2 = sched.submit(x), sched.submit(x)

    def boom(*args, **kwargs):
        raise RuntimeError("backend exploded")

    with monkeypatch.context() as m:
        m.setattr(port, "submit", boom)
        sched.flush()
    for f in (f1, f2):
        assert f.done()
        with pytest.raises(RuntimeError, match="backend exploded"):
            f.result()
    f3 = sched.submit(x)
    sched.flush()
    assert_close(f3.result(), a @ x, a, x, "float32")


def test_bisection_declares_systemic_failure_and_stops_splitting(manual, rng):
    """A batch-independent outage (every dispatch fails, no payload scope)
    stops bisecting after the offered flush and its two halves: the rest of
    the batch fails at once, counted as batch failures, as in the JAX
    package."""
    assert SYSTEMIC_FAILURE_THRESHOLD == JAX_SYSTEMIC == 3
    a = uniform(rng, (64, 64))
    port, ref = engines(a)
    s, j = scheds(port, ref, flush_width=8)
    x = uniform(rng, (64,))
    counters = []
    for sched, eng in ((s, port), (j, ref)):
        futs = [sched.submit(x) for _ in range(7)]
        attempts = []

        def down(*args, **kwargs):
            attempts.append(args[0].shape)
            raise RuntimeError("backend down")

        real = eng.submit
        eng.submit = down
        try:
            sched.flush()
        finally:
            eng.submit = real
        for f in futs:
            with pytest.raises(RuntimeError, match="backend down"):
                f.result()
        assert len(attempts) == 3
        snap = eng.metrics.snapshot()["counters"]
        counters.append({n: snap.get(n, 0) for n in (
            "sched_isolated_failures_total", "sched_batch_failures_total",
            "sched_bisect_splits_total", "sched_batches_total",
            "sched_amortized_bytes_total")})
    assert counters[0] == counters[1]
    assert counters[0]["sched_batch_failures_total"] == 7
    assert counters[0]["sched_bisect_splits_total"] == 2
    assert counters[0]["sched_batches_total"] == 0


def test_integrity_gate_applies_per_request_slice(manual, rng):
    """Under the engine's integrity gate a request whose payload carries a
    NaN fails ITS caller with ResultIntegrityError; its batchmates (one
    dispatch, no bisection) succeed, bitwise the clean batch's."""
    a = uniform(rng, (64, 64))
    port = MatvecEngine(a, port_mesh(), strategy="rowwise", promote=4, max_bucket=8,
                        integrity_gate=True)
    sched = ArrivalWindowScheduler(port, window_ms=50.0, flush_width=8)
    cols = [uniform(rng, (64,)) for _ in range(4)]
    futs = [sched.submit(c) for c in cols]
    sched.flush()
    clean = [f.result() for f in futs]
    cols[2] = cols[2].copy()
    cols[2][7] = np.nan
    futs = [sched.submit(c) for c in cols]
    sched.flush()
    with pytest.raises(ResultIntegrityError):
        futs[2].result()
    for i in (0, 1, 3):
        assert torch.equal(futs[i].result(), clean[i])
    counters = port.metrics.snapshot()["counters"]
    assert counters["engine_integrity_failures_total"] == 1
    assert counters["sched_bisect_splits_total"] == 0


def test_context_manager_timeout_and_call(manual, rng):
    a = uniform(rng, (64, 64))
    port = MatvecEngine(a, port_mesh(), strategy="rowwise", promote=4, max_bucket=8)
    x = uniform(rng, (64,))
    with ArrivalWindowScheduler(port, window_ms=50.0, flush_width=8) as sched:
        fut = sched.submit(x)
        with pytest.raises(TimeoutError):
            fut.result(timeout=0.01)
    assert_close(fut.result(), a @ x, a, x, "float32")  # close() flushed it
    with ArrivalWindowScheduler(port, window_ms=50.0, flush_width=1) as sched:
        assert_close(sched(np.stack([x] * 8, axis=1)), a @ np.stack([x] * 8, axis=1),
                     a, np.stack([x] * 8, axis=1), "float32")
