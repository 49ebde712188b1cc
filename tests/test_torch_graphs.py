"""CUDA-graph capture (``ops/graphs.py``), the device loop's machinery
(``solvers/device_loop.py``) and the engine's captured dispatch.

On the CPU: the launch counters' bookkeeping, the launch predicate's scope,
``when``/``commit`` and the chunked loop's reads, run eagerly. The tests
marked ``cuda`` capture on the card and hold every replay bitwise equal to
the eager call; they skip without one. This file imports no JAX, so on a
machine with a card they run alone:
``python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_graphs.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from matvec_mpi_multiplier_torch import get_strategy
from matvec_mpi_multiplier_torch.engine import MatvecEngine, bucket_for, pad_columns
from matvec_mpi_multiplier_torch.ops import graphs
from matvec_mpi_multiplier_torch.ops.cuda_gemv import gemv_cuda
from matvec_mpi_multiplier_torch.ops.cuda_quant import quant_gemv_cuda
from matvec_mpi_multiplier_torch.ops.quantize import quantize_matrix
from matvec_mpi_multiplier_torch.parallel.mesh import make_mesh, shard
from matvec_mpi_multiplier_torch.solvers import build_solver, device_loop
from matvec_mpi_multiplier_torch.solvers.device_loop import ChunkedLoop, commit, when
from matvec_mpi_multiplier_torch.solvers.ops import _build_solver, placed_operand
from matvec_mpi_multiplier_torch.utils.errors import ConfigError

CPU = torch.device("cpu")


def test_launch_counts_cover_every_wrapper_and_round_trip():
    """Every kernel wrapper's counters are in the snapshot; a delta added
    and taken back leaves them as they were (what a capture does)."""
    before = graphs.launch_counts()
    names = {name for name, _, _ in before}
    assert names == {"gemv_cuda", "gemm_cuda", "quant_gemv_cuda", "solver_step_cuda",
                     "ring_gemv_cuda", "flash_partial_cuda"}
    delta = {("gemv_cuda", "launches", None): 3, ("gemv_cuda", "route_launches", "split"): 3}
    graphs.add_launches(delta, 2)
    after = graphs.launch_counts()
    assert graphs.count_delta(after, before) == {k: 2 * n for k, n in delta.items()}
    graphs.add_launches(delta, -2)
    assert graphs.count_delta(graphs.launch_counts(), before) == {}
    if not before.get(("gemv_cuda", "route_launches", "split")):
        del gemv_cuda.route_launches["split"]  # the zero entry the round trip left


def test_single_cuda_device():
    assert graphs.single_cuda_device([CPU] * 4) is None
    assert graphs.single_cuda_device([torch.device("cuda", 0)] * 4) == torch.device("cuda", 0)
    assert graphs.single_cuda_device(["cuda:0", "cuda:1"]) is None


def test_launch_predicate_scope():
    """Inside the block the GEMV reads the flag's address and the kernels
    that take no predicate refuse; outside, neither."""
    flag = torch.ones((), dtype=torch.bool)
    assert graphs.predicate_ptr(CPU) is None
    graphs.refuse_predicate("quant_gemv_cuda")
    with graphs.launch_predicate(flag):
        assert graphs.predicate_ptr(CPU) == flag.data_ptr()
        with pytest.raises(ConfigError, match="takes no launch predicate"):
            graphs.refuse_predicate("quant_gemv_cuda")
        with pytest.raises(ValueError, match="one torch.bool"):
            with graphs.launch_predicate(torch.ones(2, dtype=torch.bool)):
                graphs.predicate_ptr(CPU)
    assert graphs.predicate_ptr(CPU) is None


def test_when_and_commit_eagerly():
    """Eagerly ``when`` runs one side by the flag's value, and ``commit``
    writes new values only where the flag holds, bitwise."""
    calls = []
    on, off = torch.tensor(True), torch.tensor(False)
    assert when(on, lambda: calls.append("body") or 1, lambda: 2) == 1
    assert when(off, lambda: calls.append("body") or 1, lambda: 2) == 2
    assert calls == ["body"]
    old = torch.arange(4.0)
    commit(off, ((old, old * 7),))
    assert torch.equal(old, torch.arange(4.0))
    commit(on, ((old, old * 7),))
    assert torch.equal(old, torch.arange(4.0) * 7)


@pytest.mark.parametrize("stop,chunk", [(13, 5), (10, 5), (1, 16), (0, 4)])
def test_chunked_loop_reads_once_per_chunk(stop, chunk, monkeypatch):
    """A loop that stops after ``stop`` iterations runs ceil(stop/chunk)
    chunks (one read each, plus the first); masked iterations past the stop
    change nothing."""
    k = torch.zeros((), dtype=torch.int64)
    go = torch.tensor(stop > 0)
    ran = []

    def iteration():
        ran.append(bool(go))
        k_new = k + 1
        go_new = k_new < stop
        commit(go, ((k, k_new),))
        torch.logical_and(go, go_new, out=go)

    monkeypatch.setattr(device_loop, "DEFAULT_CHUNK", chunk)
    loop = ChunkedLoop(iteration, go, k, None)
    reads = []
    real_read = loop.read
    monkeypatch.setattr(loop, "read", lambda: reads.append(1) or real_read())
    assert loop.run() == stop
    chunks = -(-stop // chunk)
    assert len(ran) == chunks * chunk and sum(ran) == stop
    assert len(reads) == chunks + 1


def test_engine_dispatches_eagerly_on_the_cpu():
    """The CPU mesh dispatches eagerly; stats say so."""
    a = np.random.default_rng(0).standard_normal((16, 16))
    eng = MatvecEngine(a, make_mesh(4, devices=[CPU] * 4), strategy="blockwise")
    x = np.random.default_rng(1).standard_normal(16)
    np.testing.assert_allclose(eng.submit(x).result().numpy(), a @ x, rtol=1e-12)
    assert eng.stats.dispatch == "eager"


# ------------------------------------------------------------ on the card


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run `python -m pytest --noconftest -m cuda "
                    "tests/test_torch_graphs.py` on the chip")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k", [(120, 6000), (1200, 4096)])
def test_captured_gemv_replays_bitwise_and_counts(card, m, k):
    """A captured GEMV (split and rows) replays bitwise equal to the eager
    call; the capture adds no launches and every replay adds its one."""
    rng = np.random.default_rng(m)
    a = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32)).to(card)
    x = torch.from_numpy(rng.standard_normal(k).astype(np.float32)).to(card)
    want = gemv_cuda(a, x)
    graph, y = graphs.capture(lambda: gemv_cuda(a, x), card)
    before = gemv_cuda.launches
    graph.replay(3)
    torch.cuda.synchronize(card)
    assert gemv_cuda.launches == before + 3
    assert torch.equal(y, want)


@pytest.mark.cuda
def test_predicated_gemv_skips_under_capture(card):
    """Under capture with a launch predicate, a False flag leaves y as it
    was and a True one computes it; quant_gemv_cuda refuses the predicate."""
    rng = np.random.default_rng(2)
    a = torch.from_numpy(rng.standard_normal((256, 4096)).astype(np.float32)).to(card)
    x = torch.from_numpy(rng.standard_normal(4096).astype(np.float32)).to(card)
    flag = torch.zeros((), dtype=torch.bool, device=card)
    out = torch.full((256,), 7.0, device=card)

    def program():
        with graphs.launch_predicate(flag):
            y = gemv_cuda(a, x)
        out.copy_(torch.where(flag, y, out))

    graph, _ = graphs.capture(program, card, warm=False)
    graph.replay()
    torch.cuda.synchronize(card)
    assert (out == 7.0).all()
    flag.fill_(True)
    graph.replay()
    torch.cuda.synchronize(card)
    assert torch.equal(out, gemv_cuda(a, x))
    qa = quantize_matrix(a, "int8")
    with pytest.raises(ConfigError, match="no launch predicate"):
        with graphs.launch_predicate(flag):
            quant_gemv_cuda(qa, x)


@pytest.mark.cuda
@pytest.mark.parametrize("strategy,p", [("rowwise", 1), ("colwise", 4), ("blockwise", 4)])
def test_engine_graph_dispatch_is_bitwise_the_eager_one(card, strategy, p):
    """Captured dispatch gives the y of the strategy's program called
    eagerly, bitwise, for vectors and promoted blocks; two futures never
    share a buffer; no build after warmup."""
    rng = np.random.default_rng(p)
    a = torch.from_numpy(rng.standard_normal((1024, 1024)).astype(np.float32)).to(card)
    mesh = make_mesh(p, devices=[card] * p)
    engine = MatvecEngine(a, mesh, strategy=strategy)
    assert engine.stats.dispatch == "graph"
    engine.warmup([1, 4])
    compiles = engine.stats.compiles
    strat = get_strategy(strategy)
    placed = shard(a, strat.specs(mesh)[0], mesh)
    matvec = strat.build(mesh, kernel="cuda", gather_output=True)
    gemm = strat.build_batched(mesh, kernel="cuda", gather_output=True)
    bucket = bucket_for(4, engine.max_bucket)

    def eager(x):
        x = x.to(card)
        if x.shape[1] == 1:
            return matvec(placed, shard(x[:, 0], strat.specs(mesh)[1], mesh)).cpu()[:, None]
        y = gemm(placed, shard(pad_columns(x, bucket), strat.batched_specs(mesh)[1], mesh))
        return y[:, :x.shape[1]].cpu()

    xs = [torch.from_numpy(rng.standard_normal((1024, w)).astype(np.float32))
          for w in (1, 1, 4)]
    futures = [engine.submit(x[:, 0] if x.shape[1] == 1 else x) for x in xs]
    for future, x in zip(futures, xs):
        assert torch.equal(future.result().reshape(1024, -1), eager(x))
    assert not torch.equal(futures[0].result(), futures[1].result())
    assert engine.stats.compiles == compiles


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["cg", "chebyshev"])
@pytest.mark.parametrize("kernel,strategy,p,combine", [
    ("cuda", "rowwise", 1, None), ("cuda", "colwise", 4, "psum"),
    ("cuda", "colwise", 4, "ring"), ("cuda", "colwise", 4, "a2a"),
    ("cuda", "colwise", 4, "overlap"), ("cuda", "blockwise", 4, None),
    ("cuda_fused", "rowwise", 1, None), ("cuda_fused", "colwise", 4, None),
])
def test_captured_solver_loop_is_bitwise_the_host_stepped_one(card, op, kernel, strategy,
                                                              p, combine):
    """The device loop's captured chunks against the host-stepped loop on
    the card, on one shard and on 4 logical ones: the same result bitwise,
    for a solve capped at 60 iterations at an unreachable tolerance (the
    first chunk eager, then replays of the captured chunk; cg's periodic
    refresh at 50 under its predicate) and one at rtol 1e-5, for two
    right-hand sides. The solver operand gets 0..5000 added along its
    diagonal (condition number about 30, not 1.3), so that neither solve
    ends inside the first chunk."""
    from matvec_mpi_multiplier_torch.bench.serve import gershgorin_interval, solver_operand

    a = solver_operand(512, "float32", 0, device=card)
    a.diagonal().add_(torch.linspace(0.0, 5e3, 512, device=card))
    interval = gershgorin_interval(a) if op == "chebyshev" else (0.0, 0.0)
    mesh = make_mesh(p, devices=[card] * p)
    a = placed_operand(get_strategy(strategy), mesh, a)  # one placement, one capture
    fns = {loop: _build_solver(op, get_strategy(strategy), mesh, loop, dtype=torch.float32,
                               kernel=kernel, combine=combine,
                               stages=2 if combine == "overlap" else None)
           for loop in ("host", "device")}
    assert {loop: fn.loop for loop, fn in fns.items()} == {"host": "host", "device": "device"}
    assert build_solver(op, get_strategy(strategy), mesh, dtype=torch.float32, kernel=kernel,
                        combine=combine).loop == "device"
    for seed in (1, 2):
        b = torch.from_numpy(np.random.default_rng(seed).standard_normal(512)
                             .astype(np.float32)).to(card)
        for rtol, maxiter in ((1e-30, 60), (1e-5, 1000)):
            res = {loop: fn(a, b, rtol, maxiter, *interval) for loop, fn in fns.items()}
            assert int(res["host"].n_iters) > device_loop.DEFAULT_CHUNK
            for field in dataclasses.fields(res["host"]):
                h, d = (getattr(res[loop], field.name) for loop in ("host", "device"))
                torch.testing.assert_close(h, d, rtol=0, atol=0, equal_nan=True)
