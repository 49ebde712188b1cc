"""Online reshard: the port's parallel/reshard.py and MatvecEngine.reshard
against the JAX package's (tests/test_reshard.py).

A migration moves the same bytes between layouts (``all_to_all`` and
``ppermute`` compute nothing), so every destination shard must be bitwise
the JAX package's ``build_reshard`` output for that device, and an engine
after ``reshard`` bitwise a fresh engine in the destination layout. The
JAX package's quantized reshard is a reference-side red (ROADMAP.md, queue
C), so quantized residents are held to the numpy fp64 oracle
``dequantize(qa) @ x`` (tests/test_torch_engine_quantized.py's budget).
"""

import weakref

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding

import matvec_mpi_multiplier_tpu as mv_jax
from matvec_mpi_multiplier_tpu.parallel import reshard as jax_reshard
from matvec_mpi_multiplier_tpu.utils.errors import ConfigError as JaxConfigError
from matvec_mpi_multiplier_torch import get_strategy
from matvec_mpi_multiplier_torch.engine import MatvecEngine
from matvec_mpi_multiplier_torch.ops import quantize as tq
from matvec_mpi_multiplier_torch.parallel import reshard
from matvec_mpi_multiplier_torch.parallel.mesh import make_mesh, shard
from matvec_mpi_multiplier_torch.utils.convert import from_numpy
from matvec_mpi_multiplier_torch.utils.errors import ConfigError

CPU = torch.device("cpu")
PAIRS = [(s, d) for s in reshard.RESHARD_STRATEGIES
         for d in reshard.RESHARD_STRATEGIES if s != d]
GRIDS = [(r, c) for r in range(1, 9) for c in range(1, 9) if r * c <= 8]
M, K = 64, 2048
TOL = dict(rtol=1e-4, atol=1e-5)


def port_mesh(p=8):
    return make_mesh(p, devices=[CPU] * p)


def operands(seed, m=M, k=K, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((m, k)).astype(dtype),
            rng.standard_normal(k).astype(dtype),
            rng.standard_normal((k, 8)).astype(dtype))


def bits(t: torch.Tensor) -> np.ndarray:
    """A tensor's values as their bit patterns (bf16 included)."""
    t = t.contiguous()
    return t.view(torch.int16 if t.element_size() == 2 else
                  torch.int32 if t.element_size() == 4 else torch.int64).numpy()


# ---- the programs (parallel/reshard.py) ----


@pytest.mark.parametrize("r,c", GRIDS)
def test_program_matches_jax(r, c):
    """The step table, with its degenerate steps elided, equals the JAX
    package's tuple for tuple on every pair and grid of up to 8 shards."""
    for src in reshard.RESHARD_STRATEGIES:
        for dst in reshard.RESHARD_STRATEGIES:
            assert reshard.reshard_program(src, dst, r, c) == \
                jax_reshard.reshard_program(src, dst, r, c), (src, dst)


def test_payload_spec_and_names_match_jax():
    for name in reshard.RESHARD_STRATEGIES:
        assert reshard.payload_spec(name) == tuple(jax_reshard.payload_spec(name))
    for bad in ("colwise_ring", "nope"):
        with pytest.raises(ConfigError):
            reshard.payload_spec(bad)
        with pytest.raises(JaxConfigError):
            jax_reshard.payload_spec(bad)


@pytest.mark.parametrize("shape", [(63, K), (M, 63), (M, K), (8, 8)])
def test_validate_raises_like_jax(devices, shape):
    jax_err = port_err = None
    try:
        jax_reshard.validate_reshard(shape, mv_jax.make_mesh(8))
    except JaxConfigError as e:
        jax_err = e
    try:
        reshard.validate_reshard(shape, port_mesh())
    except ConfigError as e:
        port_err = e
    assert (jax_err is None) == (port_err is None)
    if jax_err is not None:
        assert str(port_err) == str(jax_err)


@pytest.mark.parametrize("dtype", ["float64", "float32", "bfloat16"])
@pytest.mark.parametrize("p", [2, 4, 8])
@pytest.mark.parametrize("src,dst", PAIRS)
def test_shards_bitwise_jax(devices, src, dst, p, dtype):
    """Every destination shard is bitwise the JAX package's build_reshard
    output shard of the same flat device, and bitwise ``shard()`` of A in
    the destination layout."""
    rng = np.random.default_rng(p)
    a = rng.standard_normal((32, 64)).astype(np.float64)
    a_jax = jax.numpy.asarray(a, dtype=dtype)
    jmesh = mv_jax.make_mesh(p)
    placed = jax.device_put(a_jax, NamedSharding(jmesh, jax_reshard.payload_spec(src)))
    out = jax_reshard.build_reshard(jmesh, src, dst)(placed)
    by_device = {s.device: np.asarray(s.data) for s in out.addressable_shards}
    want = [by_device[d] for d in jmesh.devices.flat]

    mesh = port_mesh(p)
    a_t = from_numpy(np.asarray(a_jax), "cpu")
    st = shard(a_t, get_strategy(src).specs(mesh)[0], mesh)
    got = reshard.build_reshard(mesh, src, dst)(st)
    assert got.spec == tuple(get_strategy(dst).specs(mesh)[0])
    fresh = shard(a_t, get_strategy(dst).specs(mesh)[0], mesh)
    for f, (g, w, s) in enumerate(zip(got.shards, want, fresh.shards)):
        assert tuple(g.shape) == w.shape, (f, g.shape, w.shape)
        assert np.array_equal(bits(g), bits(from_numpy(w, "cpu"))), f
        assert torch.equal(g, s), f


def test_copy_bytes_counts_only_what_moves():
    """An all_to_all copies the payload; a ppermute among shards of one
    device is a reordering and copies nothing; a degenerate grid's program
    is empty."""
    mesh = port_mesh(8)
    a = torch.arange(64 * 64, dtype=torch.float32).reshape(64, 64)
    for src, dst in PAIRS:
        st = shard(a, get_strategy(src).specs(mesh)[0], mesh)
        assert reshard.copy_bytes(mesh, src, dst, st) == a.numel() * 4, (src, dst)
    st = shard(a, get_strategy("colwise").specs(mesh)[0], mesh)
    perm_only = reshard.ppermute(list(st.shards), mesh, mesh.axis_names,
                                 reshard._transpose_perm(2, 4))
    assert {t.data_ptr() for t in perm_only} == {t.data_ptr() for t in st.shards}
    tall = make_mesh(4, shape=(4, 1), devices=[CPU] * 4)
    assert reshard.reshard_program("rowwise", "blockwise", 4, 1) == ()
    st = shard(a, get_strategy("rowwise").specs(tall)[0], tall)
    assert reshard.copy_bytes(tall, "rowwise", "blockwise", st) == 0


def test_build_reshard_refuses_an_operand_of_another_layout():
    mesh = port_mesh(8)
    st = shard(torch.zeros(64, 64), get_strategy("colwise").specs(mesh)[0], mesh)
    with pytest.raises(ConfigError, match="placed by"):
        reshard.build_reshard(mesh, "rowwise", "colwise")(st)


# ---- the engine migration ----


@pytest.mark.parametrize("src,dst", PAIRS)
def test_engine_reshard_bitwise_vs_fresh(src, dst):
    """Matvec and promoted-block results after a migration are bitwise a
    fresh engine's in the destination layout, and so is every shard."""
    a, x, xb = operands(1)
    mesh = port_mesh()
    eng = MatvecEngine(a, mesh, strategy=src, retain_host=True)
    eng.submit(x).result()  # serve once in the source layout
    res = eng.reshard(dst, warm_widths=(1,))
    assert res == dict(src=src, dst=dst, migrated=True, aborted=False,
                       requantized=False, bytes_moved=a.nbytes)
    fresh = MatvecEngine(a, mesh, strategy=dst)
    assert eng.strategy.name == dst
    for s_eng, s_fresh in zip(eng._a.shards, fresh._a.shards):
        assert torch.equal(s_eng, s_fresh)
    assert torch.equal(eng.submit(x).result(), fresh.submit(x).result())
    assert torch.equal(eng.submit(xb).result(), fresh.submit(xb).result())
    assert [k.strategy for k in eng._cache.keys()] == [dst, dst]
    counters = eng.metrics.snapshot()["counters"]
    assert counters["engine_reshards_total"] == 1
    assert counters["engine_reshard_bytes_total"] == a.nbytes


def test_in_flight_dispatch_unaffected():
    """Futures dispatched before the migration give the old layout's answer;
    submits after it the new one's."""
    a, x, xb = operands(2)
    mesh = port_mesh()
    eng = MatvecEngine(a, mesh, strategy="rowwise")
    ref = MatvecEngine(a, mesh, strategy="rowwise")
    in_flight = [eng.submit(x), eng.submit(xb)]
    eng.reshard("colwise")
    assert torch.equal(in_flight[0].result(), ref.submit(x).result())
    assert torch.equal(in_flight[1].result(), ref.submit(xb).result())
    fresh = MatvecEngine(a, mesh, strategy="colwise")
    assert torch.equal(eng.submit(x).result(), fresh.submit(x).result())


def test_zero_steady_recompiles_after_warm_reshard():
    a, x, _ = operands(3)
    eng = MatvecEngine(a, port_mesh(), strategy="rowwise")
    eng.warmup(widths=(1,))
    eng.reshard("blockwise", warm_widths=(1,))
    before = eng.stats.compiles
    for _ in range(5):
        eng.submit(x).result()
    assert eng.stats.compiles == before
    assert eng.stats.dropped == 1  # the rowwise matvec program


@pytest.mark.parametrize("src,dst", PAIRS)
def test_old_layout_programs_and_loop_states_are_dropped(monkeypatch, src, dst):
    """The commit drops every program built over the old shards, the
    solvers' device-loop states included (they keep their operand): a
    weakref to an old shard dies with them."""
    from matvec_mpi_multiplier_torch.bench.serve import solver_operand
    from matvec_mpi_multiplier_torch.solvers import ops as solver_ops

    # The device loop (captured chunks on a card) runs its chunks eagerly
    # here; the engine takes it where solver_loop says so.
    monkeypatch.setattr(
        solver_ops, "solver_loop",
        lambda loop, op, mesh, predicated: (
            "device" if op in solver_ops.DEVICE_LOOP_OPS else "host"))
    a = solver_operand(64, "float64", 4)
    eng = MatvecEngine(a, port_mesh(), strategy=src)
    b = np.random.default_rng(4).standard_normal(64)
    res = eng.submit(op="cg", rhs=b, rtol=1e-8).result()
    assert res.converged
    eng.submit(b[:, None].repeat(4, 1)).result()
    old = weakref.ref(eng._a.shards[1])
    assert len(eng._cache) == 2
    eng.reshard(dst)
    assert old() is None, "the old layout outlived the commit"
    assert len(eng._cache) == 0 and eng.stats.dropped == 2
    again = eng.submit(op="cg", rhs=b, rtol=1e-8).result()
    fresh = MatvecEngine(a, port_mesh(), strategy=dst).submit(op="cg", rhs=b, rtol=1e-8)
    assert torch.equal(again.x, fresh.result().x)


def test_identity_and_unknown_strategies():
    a, x, _ = operands(5)
    eng = MatvecEngine(a, port_mesh(), strategy="rowwise")
    res = eng.reshard("rowwise")
    assert not res["migrated"] and res["bytes_moved"] == 0
    with pytest.raises(ConfigError, match="online reshard covers"):
        eng.reshard("colwise_ring")


def test_reshard_reresolves_the_configuration():
    """An explicit combine the destination has no spelling for falls back to
    the destination's default; promotion and stages resolve again."""
    a, x, xb = operands(6)
    mesh = port_mesh()
    eng = MatvecEngine(a, mesh, strategy="colwise", combine="a2a", promote=2)
    assert eng._matvec_combine == "a2a"
    eng.reshard("rowwise")
    assert (eng._matvec_combine, eng._gemm_combine, eng.b_star) == (None, None, 2)
    fresh = MatvecEngine(a, mesh, strategy="rowwise", promote=2)
    assert torch.equal(eng.submit(xb).result(), fresh.submit(xb).result())
    eng.reshard("colwise")
    assert eng._matvec_combine == "a2a"


# ---- quantized residents ----


def _oracle(qa, x):
    return tq.dequantize(qa).double().numpy() @ x.astype(np.float64)


@pytest.mark.parametrize("k,moves", [(K, True), (512, False)], ids=["same_block", "new_block"])
@pytest.mark.parametrize("dst", ["colwise", "blockwise"])
def test_quantized_reshard(dst, k, moves):
    """int8c from rowwise: where the block size is the same in both layouts
    the payload and scales move bitwise; where the destination changes it,
    A is quantized again from the retained host copy. Either way the
    resident is bitwise a fresh engine's in the destination layout, and the
    results hold the numpy oracle's budget."""
    a, x, xb = operands(7, k=k)
    mesh = port_mesh()
    eng = MatvecEngine(a, mesh, strategy="rowwise", dtype_storage="int8c",
                       retain_host=True)
    res = eng.reshard(dst)
    assert res["migrated"] and res["requantized"] is not moves
    assert (res["bytes_moved"] > 0) is moves
    fresh = MatvecEngine(a, mesh, strategy=dst, dtype_storage="int8c")
    assert eng.storage_block == fresh.storage_block
    assert eng.resident_bytes == fresh.resident_bytes
    for s_eng, s_fresh in zip(eng._a.shards, fresh._a.shards):
        for l_eng, l_fresh in zip(s_eng.leaves, s_fresh.leaves):
            assert torch.equal(l_eng, l_fresh)
    qa = tq.quantize_matrix(from_numpy(a, "cpu"), "int8c",
                            contraction_shards=get_strategy(dst).contraction_shards(mesh))
    assert torch.equal(eng.submit(x).result(), fresh.submit(x).result())
    np.testing.assert_allclose(eng.submit(x).result().numpy(), _oracle(qa, x), **TOL)
    np.testing.assert_allclose(eng.submit(xb).result().numpy(), _oracle(qa, xb), **TOL)


def test_retain_host_is_needed_only_to_requantize():
    """A same-block migration and every native one need no host copy; a
    block-changing one without it raises the JAX package's message."""
    a, x, _ = operands(8, k=512)
    mesh = port_mesh()
    eng = MatvecEngine(a, mesh, strategy="rowwise", dtype_storage="int8c")
    with pytest.raises(ConfigError, match="reshard needs the host A to recompute "
                       "per-block scales, and this engine retains none"):
        eng.reshard("colwise")
    assert eng.strategy.name == "rowwise"  # nothing changed
    same = MatvecEngine(operands(8)[0], mesh, strategy="rowwise", dtype_storage="int8c")
    assert same.reshard("colwise")["migrated"]
    native = MatvecEngine(a, mesh, strategy="rowwise", retain_host=True)
    assert native._a_host is None  # a native resident never requantizes
    assert native.reshard("blockwise")["migrated"]


def test_a_plan_that_raises_commits_nothing(monkeypatch):
    """The destination's combine, stages and b* are planned before the
    commit: a resolver that raises leaves the engine whole in its old
    layout, serving as before."""
    a, x, xb = operands(10)
    eng = MatvecEngine(a, port_mesh(), strategy="rowwise", promote=2)
    want = eng.submit(x).result(), eng.submit(xb).result()
    names = ("_a", "strategy", "_matvec_combine", "_gemm_combine", "stages",
             "b_star", "_spec_x", "_spec_b")
    before = {name: getattr(eng, name) for name in names}

    def boom(promote, strategy):
        raise OSError("tuning cache unreadable")

    monkeypatch.setattr(eng, "_resolve_promotion", boom)
    with pytest.raises(OSError):
        eng.reshard("colwise")
    assert all(getattr(eng, name) is before[name] for name in names)
    assert len(eng._cache) == 2 and eng.stats.dropped == 0
    assert torch.equal(eng.submit(x).result(), want[0])
    assert torch.equal(eng.submit(xb).result(), want[1])
    monkeypatch.undo()
    assert eng.reshard("colwise")["migrated"] and eng.b_star == 2


def test_submits_racing_reshards_see_one_layout():
    """Threads submitting while another reshards back and forth: every
    result is bitwise one layout's answer (rowwise and colwise sum in other
    orders, so a dispatch that mixed the two would match neither), and no
    submit fails."""
    import sys
    import threading

    a, x, _ = operands(9)
    mesh = port_mesh()
    want = {name: MatvecEngine(a, mesh, strategy=name).submit(x).result()
            for name in ("rowwise", "colwise")}
    assert not torch.equal(want["rowwise"], want["colwise"])
    eng = MatvecEngine(a, mesh, strategy="rowwise")
    results, errors = [], []

    def client():
        try:
            for _ in range(15):
                results.append(eng.submit(x).result())
        except Exception as e:  # noqa: BLE001 - reported by the assert below
            errors.append(e)

    def migrator():
        try:
            for dst in ("colwise", "rowwise") * 3:
                eng.reshard(dst)
        except Exception as e:  # noqa: BLE001 - reported by the assert below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=client) for _ in range(12)]
        threads.append(threading.Thread(target=migrator))
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert len(results) == 12 * 15
    assert all(torch.equal(y, want["rowwise"]) or torch.equal(y, want["colwise"])
               for y in results)
    assert eng.metrics.snapshot()["counters"]["engine_reshards_total"] == 6


def test_commit_waits_for_a_dispatch_in_progress():
    """The commit takes the lock every dispatch holds while it enqueues: a
    reshard started while a dispatch is enqueueing commits only after it,
    and that dispatch runs whole on the old layout."""
    import threading

    a, x, _ = operands(10)
    mesh = port_mesh()
    want = MatvecEngine(a, mesh, strategy="rowwise").submit(x).result()
    eng = MatvecEngine(a, mesh, strategy="rowwise")
    entered, release = threading.Event(), threading.Event()
    dispatch = eng._dispatch_request

    def held(request):
        entered.set()
        assert release.wait(timeout=60)
        return dispatch(request)

    eng._dispatch_request = held
    out = {}
    submitter = threading.Thread(target=lambda: out.update(y=eng.submit(x).result()))
    migrator = threading.Thread(target=lambda: out.update(res=eng.reshard("colwise")))
    submitter.start()
    try:
        assert entered.wait(timeout=60)
        migrator.start()
        migrator.join(timeout=0.5)
        committed_early = not migrator.is_alive() or eng.strategy.name != "rowwise"
    finally:
        release.set()
    for t in (submitter, migrator):
        t.join(timeout=60)
        assert not t.is_alive()
    assert not committed_early, "the commit did not wait for the dispatch"
    assert torch.equal(out["y"], want) and out["res"]["migrated"]
    assert eng.strategy.name == "colwise"
