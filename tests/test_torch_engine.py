"""The port's serving engine against the JAX package's (engine/).

Mirrors tests/test_engine.py and tests/test_engine_backpressure.py, minus
tuning (the combine schedules are in tests/test_torch_overlap.py). The same seeded numpy A and requests go
through the JAX package's ``MatvecEngine`` on the conftest's 8-device CPU
mesh and through the port's on 8 logical CPU shards, whose default ``cuda``
tier computes the kernels' plain versions on CPU tensors.

Bitwise doctrine (as in the JAX package): a vector request and a block
below ``b*`` are served by the SAME program a direct ``strategy.build``
returns, and a promoted block by the same program ``build_batched`` returns
for its bucket, so those comparisons are exact. Against the JAX engine the
sums run in another order: fp64 rtol 1e-12, fp32 rtol 2e-5 / atol 2e-4.
"""

import time

import numpy as np
import pytest
import torch

import matvec_mpi_multiplier_tpu as mv_jax
from matvec_mpi_multiplier_tpu.engine import DEFAULT_PROMOTE_B as JAX_DEFAULT_PROMOTE_B
from matvec_mpi_multiplier_tpu.engine import MatvecEngine as JaxEngine
from matvec_mpi_multiplier_tpu.engine import bucket_ladder as jax_bucket_ladder
from matvec_mpi_multiplier_tpu.engine import split_widths as jax_split_widths
from matvec_mpi_multiplier_tpu.tuning import reset_cache
from matvec_mpi_multiplier_torch import get_strategy
from matvec_mpi_multiplier_torch.engine import (
    DEFAULT_PROMOTE_B,
    ExecKey,
    MatvecEngine,
    bucket_for,
    bucket_ladder,
    pad_columns,
    split_widths,
)
from matvec_mpi_multiplier_torch.parallel.mesh import make_mesh
from matvec_mpi_multiplier_torch.utils.errors import ConfigError, DeadlineExceededError

CPU = torch.device("cpu")
STRATEGIES = ["blockwise", "colwise", "rowwise"]
TOL = {"float64": dict(rtol=1e-12, atol=0), "float32": dict(rtol=2e-5, atol=2e-4)}
# The JAX package's kernel names and the port's counterparts.
KERNEL_LABELS = {"xla": "torch", "pallas": "cuda"}


@pytest.fixture()
def cache_path(tmp_path, monkeypatch):
    """The JAX engine's promote="auto" consults its tuning cache: point it
    at an empty one, so it takes its miss default as the port does."""
    monkeypatch.setenv("MATVEC_TUNING_CACHE", str(tmp_path / "tuning_cache.json"))
    reset_cache()
    yield
    reset_cache()


def port_mesh(p=8):
    return make_mesh(p, devices=[CPU] * p)


def make_operands(rng, m=64, k=64, dtype="float32", width=11):
    return (rng.uniform(0, 10, (m, k)).astype(dtype),
            rng.uniform(0, 10, (k, width)).astype(dtype))


def engine(a, strategy="rowwise", **kwargs):
    kwargs.setdefault("promote", 2)
    kwargs.setdefault("max_bucket", 8)
    return MatvecEngine(a, port_mesh(), strategy=strategy, **kwargs)


# ---------------------------------------------------------------- buckets


def test_bucket_ladder_and_quantization():
    for mb in (1, 8, 16, 24, 32):
        assert bucket_ladder(mb) == jax_bucket_ladder(mb)
    assert bucket_ladder(24) == (1, 2, 4, 8, 16, 24)
    assert (bucket_for(1, 16), bucket_for(5, 16), bucket_for(16, 16)) == (1, 8, 16)
    for bad in (17, 0):
        with pytest.raises(ConfigError):
            bucket_for(bad, 16)
    with pytest.raises(ConfigError, match="max_bucket"):
        bucket_ladder(0)
    for width in (40, 16, 3, 1, 33):
        assert split_widths(width, 16) == jax_split_widths(width, 16)
    with pytest.raises(ConfigError):
        split_widths(0)


@pytest.mark.parametrize("kind", ["numpy", "tensor"])
def test_pad_columns_zero_fills(kind):
    block = np.ones((4, 3), np.float32)
    if kind == "tensor":
        block = torch.from_numpy(block)
    padded = pad_columns(block, 8)
    assert tuple(padded.shape) == (4, 8) and type(padded) is type(block)
    np.testing.assert_array_equal(np.asarray(padded[:, :3]), 1.0)
    np.testing.assert_array_equal(np.asarray(padded[:, 3:]), 0.0)
    assert pad_columns(block, 3) is block  # already at width: no copy
    with pytest.raises(ConfigError):
        pad_columns(block, 2)


# ----------------------------------------------------- correctness matrix


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_engine_matches_its_own_builds_and_jax(devices, rng, cache_path, strategy, dtype):
    """Vector and sub-b* requests are bitwise the port's own ``build``;
    a promoted block (11 columns -> 8 + 3 padded to bucket 4) is bitwise
    its own ``build_batched`` on each padded chunk; all of it agrees with
    the JAX engine and with a loop of single matvecs."""
    a, X = make_operands(rng, dtype=dtype)
    a_t, X_t = torch.from_numpy(a), torch.from_numpy(X)
    eng = engine(a, strategy, promote=4)
    jax_eng = JaxEngine(a, mv_jax.make_mesh(8), strategy=strategy, promote=4,
                        max_bucket=8)
    direct = get_strategy(strategy).build(port_mesh())
    batched = get_strategy(strategy).build_batched(port_mesh())

    y = eng.submit(X[:, 0]).result()
    assert y.dtype == a_t.dtype and tuple(y.shape) == (64,)
    assert torch.equal(y, direct(a_t, X_t[:, 0].contiguous()))
    np.testing.assert_allclose(y.numpy(), jax_eng.submit(X[:, 0]).result(), **TOL[dtype])

    Y3 = eng.submit(X[:, :3]).result()  # b=3 < b*=4: per column
    loop = torch.stack([direct(a_t, X_t[:, j].contiguous()) for j in range(3)], 1)
    assert torch.equal(Y3, loop)
    np.testing.assert_allclose(Y3.numpy(), jax_eng.submit(X[:, :3]).result(), **TOL[dtype])

    Y = eng.submit(X).result()  # promoted: bucket 8 + (3 -> bucket 4)
    assert tuple(Y.shape) == (64, 11)
    assert torch.equal(Y[:, :8], batched(a_t, X_t[:, :8]))
    assert torch.equal(Y[:, 8:], batched(a_t, pad_columns(X_t[:, 8:], 4))[:, :3])
    np.testing.assert_allclose(Y.numpy(), jax_eng.submit(X).result(), **TOL[dtype])
    np.testing.assert_allclose(Y.numpy(), a @ X, rtol=1e-5 if dtype == "float32" else 1e-12)


def test_bfloat16_batches_within_one_ulp_of_jax(devices, rng, cache_path):
    """bf16 requests as tensors (the port's host form for dtypes numpy
    lacks): the results, cast to bf16, are within one ulp of the JAX
    engine's on the same bf16 operands."""
    import jax.numpy as jnp

    a = np.asarray(jnp.asarray(rng.uniform(0, 1, (64, 64)), jnp.bfloat16))
    X = np.asarray(jnp.asarray(rng.uniform(0, 1, (64, 6)), jnp.bfloat16))
    from matvec_mpi_multiplier_torch.utils.convert import from_numpy

    eng = engine(from_numpy(a, "cpu"), promote=2)
    Y = eng.submit(from_numpy(X, "cpu")).result()
    assert Y.dtype == torch.bfloat16 and tuple(Y.shape) == (64, 6)
    want = JaxEngine(a, mv_jax.make_mesh(8), strategy="rowwise", promote=2).submit(X).result()
    np.testing.assert_allclose(Y.float().numpy(), np.asarray(want, np.float32), rtol=2 ** -7)


# ------------------------------------------------------- padding isolation


def test_bucket_padding_never_leaks(rng):
    """A width-5 request rides the bucket-8 program: its 5 columns are
    bitwise those of any other request sharing them, and no pad column
    surfaces."""
    a, X = make_operands(rng)
    eng = engine(a)
    Y5, Y8 = eng.submit(X[:, :5]).result(), eng.submit(X[:, :8]).result()
    assert tuple(Y5.shape) == (64, 5)
    assert torch.equal(Y5, Y8[:, :5])
    assert Y8[:, 5:].abs().min() > 0


def test_split_request_spans_buckets(rng):
    a, X = make_operands(rng, width=21)  # 8 + 8 + 5 -> 8
    eng = engine(a)
    Y = eng.submit(X).result()
    assert tuple(Y.shape) == (64, 21)
    np.testing.assert_allclose(Y.numpy(), a @ X, rtol=1e-5)
    assert eng.n_executables == 1  # every chunk hit the bucket-8 program


# ------------------------------------------------- executable-cache state


@pytest.mark.parametrize("jax_kernel", ["xla", "pallas"])
@pytest.mark.parametrize("strategy,promote,widths", [
    ("rowwise", 2, None), ("colwise", 4, [1, 2, 3, 5]),
    ("blockwise", 2, [3, 4, 11]), ("rowwise", None, [1, 8]),
])
def test_exec_key_labels_match_jax(devices, rng, cache_path, jax_kernel,
                                   strategy, promote, widths):
    """After warmup(widths) both engines hold the same keys (labels equal
    with the kernel name mapped) and report the same build count."""
    a, _ = make_operands(rng)
    eng = engine(a, strategy, promote=promote, kernel=KERNEL_LABELS[jax_kernel])
    jax_eng = JaxEngine(a, mv_jax.make_mesh(8), strategy=strategy, promote=promote,
                        max_bucket=8, kernel=jax_kernel)
    assert eng.warmup(widths) == jax_eng.warmup(widths)

    def mapped(label):
        op, strat, kernel, *rest = label.split(":")
        return ":".join([op, strat, KERNEL_LABELS[kernel], *rest])

    assert sorted(k.label() for k in eng._cache.keys()) == sorted(
        mapped(k.label()) for k in jax_eng._cache.keys())


def test_exec_key_label_spelling():
    key = ExecKey("gemm", "colwise", "cuda", None, 8, "float32")
    assert key.label() == "gemm:colwise:cuda:default:8:float32"
    assert ExecKey("matvec", "colwise", "cuda", "psum", 1, "bfloat16").label() == (
        "matvec:colwise:cuda:psum:1:bfloat16")


def test_compile_count_flat_across_mixed_replay(rng):
    a, X = make_operands(rng)
    eng = engine(a, "colwise")
    assert eng.warmup() == 1 + len(bucket_ladder(8))  # matvec + buckets 1..8
    assert eng.warmup() == 0  # idempotent
    baseline = eng.stats.compiles
    futures = [eng.submit(X[:, :w]) for w in (1, 2, 3, 5, 8, 11, 7, 4, 6, 2)]
    for f in futures:
        f.result()
    stats = eng.stats
    assert stats.compiles == baseline, "steady-state stream built a program"
    assert stats.hits > 0 and stats.requests == 10


def test_warmup_widths_subset_and_routing(rng):
    a, X = make_operands(rng)
    assert engine(a, promote=2, max_bucket=16).warmup(widths=[3, 4]) == 2
    eng = engine(a, promote=4, max_bucket=16)
    assert eng.warmup(widths=[1, 2, 3, 5]) == 2  # matvec + bucket-8 gemm
    baseline = eng.stats.compiles
    for w in (1, 2, 3, 5):
        eng.submit(X[:, :w]).result()
    assert eng.stats.compiles == baseline


def test_no_promotion_uses_single_executable(rng):
    a, X = make_operands(rng)
    eng = engine(a, promote=None)
    np.testing.assert_allclose(eng.submit(X[:, :6]).result().numpy(), a @ X[:, :6], rtol=1e-5)
    assert eng.n_executables == 1 and eng.stats.dispatches == 6


def test_promote_auto_is_the_static_default(devices, rng, cache_path):
    """No tuning cache yet: "auto" takes the JAX package's miss default."""
    a, _ = make_operands(rng)
    assert DEFAULT_PROMOTE_B == JAX_DEFAULT_PROMOTE_B == 4
    assert engine(a, promote="auto").b_star == 4
    assert JaxEngine(a, mv_jax.make_mesh(8), promote="auto").b_star == 4
    with pytest.raises(ConfigError, match="promote"):
        engine(a, promote=0)


def test_donation_flag_off_still_correct(rng):
    a, X = make_operands(rng)
    np.testing.assert_allclose(
        engine(a, donate=False).submit(X[:, :4]).result().numpy(), a @ X[:, :4], rtol=1e-5)


# -------------------------------------------------------- future semantics


def test_future_values_then_done(rng):
    a, X = make_operands(rng)
    fut = engine(a).submit(X[:, :3])
    vals = fut.device_values()
    assert vals and all(tuple(v.shape) == (64, 4) for v in vals)  # padded view
    assert fut.exception() is None
    y = fut.result()
    assert y.device.type == "cpu" and tuple(y.shape) == (64, 3)
    assert fut.done() and fut.retired


def test_sharded_output_engine(rng):
    """gather_output=False keeps the strategy's layout on the device;
    result() assembles it."""
    a, X = make_operands(rng)
    eng = engine(a, "blockwise", gather_output=False)
    np.testing.assert_allclose(eng.submit(X[:, :5]).result().numpy(), a @ X[:, :5], rtol=1e-5)
    np.testing.assert_allclose(eng.submit(X[:, 0]).result().numpy(), a @ X[:, 0], rtol=1e-5)
    with pytest.raises(ConfigError, match="True or False"):
        engine(a, gather_output="ring")


def test_request_validation(rng):
    a, _ = make_operands(rng)
    eng = engine(a)
    for bad in (np.ones(32, np.float32), np.ones((32, 3), np.float32),
                np.ones((64, 0), np.float32)):
        with pytest.raises(ConfigError):
            eng.submit(bad)
    with pytest.raises(ConfigError, match="rank 2"):
        MatvecEngine(np.ones(8, np.float32), port_mesh())


# stages= and combine= (ring, auto) are ported: their cases are in
# tests/test_torch_overlap.py::test_engine_combine_and_stages_arguments;
# retain_host= is ported with reshard (tests/test_torch_reshard.py).
@pytest.mark.parametrize("kwargs", [
    {"dtype_storage": "speculate"}, {"resilience": object()},
    {"fault_plan": object()}, {"integrity_gate": True}, {"trace_jsonl": "t.jsonl"},
    {"defer_placement": True}, {"label_prefix": "tenant-1/"}, {"exec_cache": object()},
])
def test_later_slice_arguments_raise(rng, kwargs):
    a, _ = make_operands(rng)
    with pytest.raises(ConfigError, match="ROADMAP.md"):
        engine(a, "colwise", **kwargs)


def test_later_slice_submits_raise(rng):
    a, X = make_operands(rng)
    eng = engine(a)
    for kwargs in ({"rtol": 1e-3}, {"integrity": True}):
        with pytest.raises(ConfigError, match="ROADMAP.md"):
            eng.submit(X[:, 0], **kwargs)
    assert eng.stats.dispatches == 0
    with pytest.raises(TypeError, match="unexpected keyword"):
        engine(a, bogus=1)
    # The strategy's own combine builds on both paths.
    eng = engine(a, "colwise", combine="psum")
    np.testing.assert_allclose(eng.submit(X[:, :5]).result().numpy(), a @ X[:, :5], rtol=1e-5)
    assert {k.combine for k in eng._cache.keys()} == {"psum"}


# ------------------------------------------------------------ backpressure


class FakeOutstanding:
    """A never-ready dispatch handle: exercises the drain path
    deterministically (on a CPU mesh real work is done on return)."""

    def __init__(self, wait_s=0.0):
        self.synced = 0
        self.ready = False
        self.wait_s = wait_s

    def query(self):
        return self.ready

    def synchronize(self):
        time.sleep(self.wait_s)
        self.synced += 1
        self.ready = True


def test_in_flight_window_bounded(rng):
    a, _ = make_operands(rng)
    eng = engine(a, max_in_flight=2)
    x = rng.uniform(0, 10, 64).astype(np.float32)
    futures = [eng.submit(x) for _ in range(12)]
    assert eng.stats.in_flight <= 2
    for f in futures:
        np.testing.assert_allclose(f.result().numpy(), a @ x, rtol=1e-5)
    assert eng.stats.in_flight == 0 and eng.stats.requests == 12


def test_high_water_drains_oldest(rng):
    a, _ = make_operands(rng)
    eng = engine(a, max_in_flight=2)
    first, second = FakeOutstanding(), FakeOutstanding()
    eng._outstanding.extend([first, second])
    x = rng.uniform(0, 10, 64).astype(np.float32)
    np.testing.assert_allclose(eng.submit(x).result().numpy(), a @ x, rtol=1e-5)
    assert (first.synced, second.synced) == (1, 0)  # FIFO: oldest drained
    assert eng.stats.drains == 1


def test_unbounded_by_default(rng):
    a, _ = make_operands(rng)
    eng = engine(a)
    assert eng.max_in_flight is None
    for f in [eng.submit(a[0]) for _ in range(20)]:
        f.result()
    assert eng.stats.drains == 0 and eng.stats.deadline_failures == 0
    with pytest.raises(ConfigError, match="max_in_flight"):
        engine(a, max_in_flight=0)


def test_expired_deadline_fails_future_without_dispatch(rng):
    a, _ = make_operands(rng)
    eng = engine(a)
    fut = eng.submit(a[0], deadline_ms=-1.0)
    assert fut.done() and isinstance(fut.exception(), DeadlineExceededError)
    assert fut.device_values() == []
    with pytest.raises(DeadlineExceededError, match="deadline of -1.0 ms"):
        fut.result()
    s = eng.stats
    assert (s.dispatches, s.deadline_failures, s.requests) == (0, 1, 1)


def test_deadline_fires_when_drain_outlasts_it(rng):
    a, _ = make_operands(rng)
    eng = engine(a, max_in_flight=1)
    eng._outstanding.append(FakeOutstanding(wait_s=0.02))
    fut = eng.submit(a[0], deadline_ms=1.0)  # 1 ms < the 20 ms drain
    with pytest.raises(DeadlineExceededError):
        fut.result()
    assert eng.stats.deadline_failures == 1 and eng.stats.drains == 1


def test_stale_on_arrival_skips_the_drain(rng):
    a, _ = make_operands(rng)
    eng = engine(a, max_in_flight=1)
    pending = FakeOutstanding()
    eng._outstanding.append(pending)
    with pytest.raises(DeadlineExceededError):
        eng.submit(a[0], deadline_ms=0).result()
    assert pending.synced == 0 and eng.stats.drains == 0
    eng.close()
    assert len(eng._outstanding) == 0


def test_generous_deadline_dispatches_normally(rng):
    a, _ = make_operands(rng)
    eng = engine(a, max_in_flight=4)
    fut = eng.submit(a[0], deadline_ms=60_000.0)
    assert fut.exception() is None
    np.testing.assert_allclose(fut.result().numpy(), a @ a[0], rtol=1e-5)
    assert eng.stats.deadline_failures == 0


# ------------------------------------------------------ bucket-ladder edges


def test_request_width_above_max_bucket(rng):
    a, X = make_operands(rng, width=19)  # 8 + 8 + 3 -> 4
    eng = engine(a)
    Y = eng.submit(X).result()
    np.testing.assert_allclose(Y.numpy(), a @ X, rtol=1e-5)
    assert torch.equal(Y[:, :8], eng.submit(X[:, :8]).result())


@pytest.mark.parametrize("promote", [1, None])
def test_b1_block_both_promotion_modes(promote):
    rng = np.random.default_rng(7)
    a, X1 = make_operands(rng, width=1)
    eng = engine(a, promote=promote)
    y_block = eng.submit(X1).result()
    assert tuple(y_block.shape) == (64, 1)
    np.testing.assert_allclose(y_block[:, 0].numpy(), eng.submit(X1[:, 0]).result().numpy(),
                               rtol=1e-6)
    np.testing.assert_allclose(y_block[:, 0].numpy(), a @ X1[:, 0], rtol=1e-5)


def test_mixed_dtype_stream_normalizes_exactly(rng):
    """Requests in other dtypes (numpy or tensors) are cast to the engine's
    at the door: the result equals serving the pre-cast request."""
    a, _ = make_operands(rng)
    eng = engine(a)
    X = rng.uniform(0, 10, (64, 5))
    for req in (X, X.astype(np.float32), X.astype(np.int32), torch.from_numpy(X)):
        Y = eng.submit(req).result()
        ref = eng.submit(np.asarray(req, dtype=np.float32)).result()
        assert torch.equal(Y, ref) and Y.dtype == torch.float32


def test_mixed_width_mixed_dtype_replay_exact(rng):
    """A float64 engine serving widths 1..11 in f64/f32 requests: every
    result within fp64 rtol of the oracle."""
    rng2 = np.random.default_rng(11)
    a = rng2.uniform(0, 10, (64, 64))
    eng = engine(a, "colwise", max_in_flight=4)
    assert eng.dtype == torch.float64
    futures, oracles = [], []
    for w, dt in [(1, np.float64), (3, np.float32), (8, np.float64),
                  (11, np.float32), (2, np.float64)]:
        X = rng2.uniform(0, 10, (64, w)).astype(dt)
        futures.append(eng.submit(X))
        oracles.append(a @ X.astype(np.float64))
    for fut, want in zip(futures, oracles):
        np.testing.assert_allclose(fut.result().numpy(), want, rtol=1e-12)
    assert eng.stats.in_flight <= 4
