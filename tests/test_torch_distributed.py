"""The port's multi-process world: ``parallel/distributed.py`` and a mesh
that spans processes, against the one-process port and the JAX package.

The reference is an MPI program: its time is the max over ranks
(``MPI_Reduce(MPI_MAX)``, ``src/multiplier_rowwise.c:147``) and only the root
writes CSVs (``:159-170``). ``tests/test_distributed_real.py`` runs the JAX
package's multi-process programs; here two real worker processes join a
gloo world on localhost, one CPU device each, and run the port's:

* the rowwise, colwise (psum, psum_scatter, a2a) and blockwise matvecs, and
  colwise_ring with the ring all-gather, each bitwise the one-process port's
  y on the same grid, and within the JAX test's bar of the JAX package's;
* ring and Ulysses attention (both tiers) against the dense oracle;
* the ``loop`` and ``sync`` measures in lockstep (equal ``times_s``);
* the max reduce and the coordinator-only CSV;
* the tuning cache's coordinator decisions on both processes.

The workers import only the port. One pair runs every case (a module
fixture), with a 120 s limit and a free port.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from matvec_mpi_multiplier_torch import get_strategy
from matvec_mpi_multiplier_torch.bench import timing
from matvec_mpi_multiplier_torch.parallel import distributed
from matvec_mpi_multiplier_torch.parallel.attention import (
    build_ring_attention,
    build_ulysses_attention,
)
from matvec_mpi_multiplier_torch.parallel.mesh import make_1d_mesh, make_mesh
from matvec_mpi_multiplier_torch.tuning.cache import TuningCache, broadcast_decisions
from matvec_mpi_multiplier_torch.utils.errors import ConfigError

REPO = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")

# (label, strategy, grid, build kwargs): the cases both the workers and the
# one-process oracle run.
MATVECS = [
    ("rowwise", "rowwise", None, {}),
    ("colwise", "colwise", None, {}),
    ("colwise-psum_scatter", "colwise", None, {"combine": "psum_scatter"}),
    ("colwise-a2a", "colwise", None, {"combine": "a2a"}),
    ("blockwise-2x1", "blockwise", (2, 1), {}),
    ("blockwise-1x2", "blockwise", (1, 2), {}),
    ("colwise_ring-ring_gather", "colwise_ring", None, {"gather_output": "ring"}),
    ("rowwise-native", "rowwise", None, {"kernel": "native"}),
]
CACHE_ENTRIES = ({"gemv|rank0": {"kernel": "torch"}},
                 {"gemv|rank1": {"kernel": "cuda"}})

WORKER = """
import json, os, sys

idx, port, root = int(sys.argv[1]), sys.argv[2], sys.argv[3]
os.environ["MATVEC_TUNING_CACHE"] = os.path.join(root, f"cache_{idx}.json")

import numpy as np
import torch

from matvec_mpi_multiplier_torch.parallel import distributed

distributed.initialize(f"127.0.0.1:{port}", 2, idx)

from matvec_mpi_multiplier_torch import get_strategy
from matvec_mpi_multiplier_torch.bench import metrics
from matvec_mpi_multiplier_torch.bench.timing import (
    TimingResult, _max_across_processes, benchmark_strategy)
from matvec_mpi_multiplier_torch.ops import native_gemv
from matvec_mpi_multiplier_torch.parallel.attention import (
    build_ring_attention, build_ulysses_attention)
from matvec_mpi_multiplier_torch.parallel.mesh import make_1d_mesh, make_mesh
from matvec_mpi_multiplier_torch.tuning import get_cache

CPU = torch.device("cpu")
MATVECS = json.loads(sys.argv[4])
out = {"idx": idx, "process_count": distributed.process_count(),
       "device_count": distributed.device_count(),
       "local_device_count": distributed.local_device_count(),
       "backend": distributed.backend(), "main": distributed.is_main_process()}

native_gemv.register_if_available(build=True)
rng = np.random.default_rng(5)
a = torch.from_numpy(rng.standard_normal((16, 8)))
x = torch.from_numpy(rng.standard_normal(8))
out["ys"] = {}
for label, name, grid, kw in MATVECS:
    mesh = make_mesh(2, shape=grid and tuple(grid), devices=[CPU])
    out["ys"][label] = get_strategy(name).build(mesh, **kw)(a, x).tolist()

mesh = make_1d_mesh(devices=[CPU])
g = np.random.default_rng(13)
q, k, v = (torch.from_numpy(g.standard_normal((32, 2, 8)).astype(np.float32))
           for _ in range(3))
out["att"] = {n: b(mesh, causal=True, gather_output=True)(q, k, v).tolist()
              for n, b in (("ring", build_ring_attention),
                           ("ulysses", build_ulysses_attention))}
g = np.random.default_rng(17)
q, k, v = (torch.from_numpy(g.standard_normal((256, 128)).astype(np.float32))
           for _ in range(3))
for tier in ("xla", "flash"):
    out["att"][f"ring-{tier}-256"] = build_ring_attention(
        mesh, causal=True, gather_output=True, kernel=tier)(q, k, v).tolist()

mesh = make_mesh(2, devices=[CPU])
g = np.random.default_rng(7)
a2, x2 = g.standard_normal((32, 16)), g.standard_normal(16)
out["loop"] = list(benchmark_strategy(
    get_strategy("rowwise"), mesh, a2, x2, dtype="float64", n_reps=4,
    measure="loop", chain_samples=2).times_s)
out["sync"] = list(benchmark_strategy(
    get_strategy("colwise"), mesh, a2, x2, dtype="float64", n_reps=3,
    measure="sync").times_s)

out["max"] = _max_across_processes(1.5 if idx == 0 else 3.5)
result = TimingResult(n_rows=4, n_cols=8, n_devices=distributed.device_count(),
                      strategy="rowwise", dtype="float64", mode="amortized",
                      measure="sync", mean_time_s=out["max"],
                      times_s=(out["max"],), n_reps=1)
out["csv"] = str(metrics.append_result(result, root))
out["cache"] = get_cache().entries
print(json.dumps(out))
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def workers(tmp_path_factory) -> dict:
    """Run the worker pair once; their JSON outputs by process index."""
    root = tmp_path_factory.mktemp("world")
    for i, entries in enumerate(CACHE_ENTRIES):
        (root / f"cache_{i}.json").write_text(json.dumps(
            {"version": _cache_version(), "entries": entries}))
    worker_py = root / "worker.py"
    worker_py.write_text(WORKER)
    env = dict(os.environ, PYTHONPATH=str(REPO))
    env.pop("MATVEC_TUNING_CACHE", None)
    port = _free_port()
    procs = [
        subprocess.Popen(
            [sys.executable, str(worker_py), str(i), str(port), str(root),
             json.dumps(MATVECS)],
            cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True,
        )
        for i in range(2)
    ]
    outs = {}
    try:
        for p in procs:
            out, err = p.communicate(timeout=120)
            assert p.returncode == 0, f"worker failed:\n{out}\n{err}"
            o = json.loads(out.strip().splitlines()[-1])
            outs[o["idx"]] = o
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    outs["root"] = root
    return outs


def _cache_version() -> int:
    from matvec_mpi_multiplier_torch.tuning.cache import CACHE_VERSION

    return CACHE_VERSION


# ------------------------------------------------------------ one process

def test_distributed_single_process():
    """A world of one: the identities, with nothing initialized."""
    assert distributed.process_count() == 1
    assert distributed.process_index() == 0
    assert distributed.is_main_process()
    assert distributed.local_device_count() == 1  # the CPU, no CUDA here
    assert distributed.device_count() == 1
    assert distributed.backend() is None
    distributed.initialize()  # a no-op, not a raise
    assert not distributed.is_initialized()
    assert distributed.process_count() == 1


def test_one_process_paths_are_unchanged():
    mesh = make_mesh(4, devices=[CPU] * 4)
    assert mesh.owners is None and not mesh.spans_processes
    assert mesh.first_local == 0 and all(mesh.is_local(f) for f in range(4))
    assert timing._max_across_processes(0.25) == 0.25
    cache = TuningCache("unused.json")
    cache.entries = {"k": {"kernel": "torch"}}
    assert broadcast_decisions(cache) is cache
    assert cache.entries == {"k": {"kernel": "torch"}}


@pytest.mark.parametrize("env", [
    {"SLURM_JOB_ID": "7"},                        # an allocation of one task
    {"SLURM_JOB_ID": "7", "SLURM_NTASKS": "1"},
    {"MASTER_ADDR": "127.0.0.1", "WORLD_SIZE": "1", "RANK": "0"},
])
def test_initialize_is_a_no_op_in_a_launched_world_of_one(monkeypatch, env):
    import torch.distributed as dist

    calls = []
    monkeypatch.setattr(dist, "init_process_group", lambda *a, **k: calls.append(k))
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    distributed.initialize()
    assert calls == []


def test_initialize_reads_the_launcher_and_names_gloo(monkeypatch):
    import torch.distributed as dist

    calls = []
    monkeypatch.setattr(dist, "init_process_group", lambda **k: calls.append(k))
    monkeypatch.setattr(dist, "get_world_size", lambda: 4)
    monkeypatch.setattr(dist, "all_gather_object",
                        lambda out, obj: out.__setitem__(slice(None), [obj] * 4))
    monkeypatch.setattr(distributed, "_local_counts", None)
    for name, value in {"MASTER_ADDR": "10.0.0.2", "MASTER_PORT": "1234",
                        "WORLD_SIZE": "4", "RANK": "3"}.items():
        monkeypatch.setenv(name, value)
    distributed.initialize()
    assert calls == [{"backend": "gloo", "init_method": "tcp://10.0.0.2:1234",
                      "world_size": 4, "rank": 3}]
    assert distributed._local_counts == [1, 1, 1, 1]


def test_initialize_refuses_partial_arguments_and_a_launcher_without_address(
        monkeypatch):
    with pytest.raises(ConfigError, match="together"):
        distributed.initialize("127.0.0.1:1234")
    monkeypatch.setenv("OMPI_COMM_WORLD_SIZE", "2")
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    with pytest.raises(ConfigError, match="MASTER_ADDR"):
        distributed.initialize()


def test_a_mesh_must_give_every_process_a_shard(monkeypatch):
    monkeypatch.setattr(distributed, "process_count", lambda: 2)
    monkeypatch.setattr(distributed, "process_index", lambda: 1)
    mesh = make_mesh(4, devices=[CPU] * 2)
    assert mesh.owners == (0, 0, 1, 1) and mesh.rank == 1
    assert mesh.first_local == 2
    assert [mesh.is_local(f) for f in range(4)] == [False, False, True, True]
    assert make_mesh(devices=[CPU] * 2).size == 4
    with pytest.raises(ConfigError, match="every process"):
        make_mesh(2, devices=[CPU] * 2)
    with pytest.raises(ConfigError, match="only 4 available"):
        make_mesh(6, devices=[CPU] * 2)


def test_engine_and_quantized_storage_refuse_a_mesh_over_processes(monkeypatch):
    from matvec_mpi_multiplier_torch.engine import MatvecEngine

    monkeypatch.setattr(distributed, "process_count", lambda: 2)
    monkeypatch.setattr(distributed, "process_index", lambda: 0)
    mesh = make_mesh(2, devices=[CPU])
    with pytest.raises(ConfigError, match="one process"):
        MatvecEngine(torch.ones(4, 4), mesh)
    with pytest.raises(ConfigError, match="int8c storage"):
        get_strategy("rowwise").build(mesh, dtype_storage="int8c")
    from matvec_mpi_multiplier_torch.utils.errors import ShardingError

    with pytest.raises(ShardingError, match="several processes"):
        get_strategy("colwise").build(make_1d_mesh(devices=[CPU]),
                                      combine="pallas_ring")(
            torch.ones(4, 4), torch.ones(4))


# ------------------------------------------------------------ two processes

def test_world_identity(workers):
    for i in (0, 1):
        o = workers[i]
        assert o["process_count"] == 2
        assert o["device_count"] == 2 and o["local_device_count"] == 1
        assert o["backend"] == "gloo"
        assert o["main"] is (i == 0)


def _operands():
    rng = np.random.default_rng(5)
    return rng.standard_normal((16, 8)), rng.standard_normal(8)


@pytest.mark.parametrize("label,name,grid,kw", MATVECS, ids=[m[0] for m in MATVECS])
def test_matvec_is_the_one_process_ports_bitwise(workers, devices, label, name,
                                                 grid, kw):
    import jax.numpy as jnp
    import matvec_mpi_multiplier_tpu as mv_jax

    a, x = _operands()
    mesh = make_mesh(2, shape=grid, devices=[CPU] * 2)
    want = get_strategy(name).build(mesh, **kw)(torch.from_numpy(a),
                                                torch.from_numpy(x)).numpy()
    jax_kw = dict(kw, kernel="native" if kw.get("kernel") == "native" else "xla")
    jax_y = np.asarray(mv_jax.get_strategy(name).build(
        mv_jax.make_mesh(2, shape=grid), **jax_kw)(jnp.asarray(a), jnp.asarray(x)))
    for i in (0, 1):
        got = np.asarray(workers[i]["ys"][label])
        np.testing.assert_array_equal(got, want)
        assert float(np.max(np.abs(got - jax_y))) < 1e-12  # the JAX test's bar
        assert float(np.max(np.abs(got - a @ x))) < 1e-12


def _dense_causal(q, k, v):
    s, _, dh = q.shape
    sc = np.einsum("qhd,khd->hqk", q, k) / np.sqrt(dh)
    r = np.arange(s)
    sc = np.where((r[None, :] <= r[:, None])[None], sc, -np.inf)
    w = np.exp(sc - sc.max(-1, keepdims=True))
    return np.einsum("hqk,khd->qhd", w / w.sum(-1, keepdims=True), v)


@pytest.mark.parametrize("schedule", ["ring", "ulysses"])
def test_attention_schedules_across_processes(workers, schedule):
    g = np.random.default_rng(13)
    q, k, v = (g.standard_normal((32, 2, 8)).astype(np.float32) for _ in range(3))
    oracle = _dense_causal(q.astype(np.float64), k.astype(np.float64),
                           v.astype(np.float64))
    build = build_ring_attention if schedule == "ring" else build_ulysses_attention
    one = build(make_1d_mesh(2, devices=[CPU] * 2), causal=True, gather_output=True)(
        *(torch.from_numpy(t) for t in (q, k, v))).numpy()
    for i in (0, 1):
        got = np.asarray(workers[i]["att"][schedule], np.float32)
        assert float(np.max(np.abs(got - oracle))) < 5e-6  # the JAX test's bar
        np.testing.assert_array_equal(got, one)


def test_flash_tier_across_processes(workers):
    g = np.random.default_rng(17)
    q, k, v = (torch.from_numpy(g.standard_normal((256, 128)).astype(np.float32))
               for _ in range(3))
    one = build_ring_attention(make_1d_mesh(2, devices=[CPU] * 2), causal=True,
                               gather_output=True, kernel="flash")(q, k, v).numpy()
    for i in (0, 1):
        flash = np.asarray(workers[i]["att"]["ring-flash-256"], np.float32)
        xla = np.asarray(workers[i]["att"]["ring-xla-256"], np.float32)
        assert float(np.max(np.abs(flash - xla))) < 5e-6  # the JAX test's bar
        np.testing.assert_array_equal(flash, one)


@pytest.mark.parametrize("measure", ["loop", "sync"])
def test_measure_runs_in_lockstep(workers, measure):
    """Every time a decision reads is max-reduced first, so both processes
    time the same programs and report the same samples."""
    assert workers[0][measure] == workers[1][measure]
    assert np.median(workers[0][measure]) > 0


def test_max_reduce_and_coordinator_csv(workers):
    assert workers[0]["max"] == 3.5 and workers[1]["max"] == 3.5
    csv = workers["root"] / "out" / "rowwise.csv"
    lines = csv.read_text().strip().splitlines()
    assert lines[0] == "n_rows, n_cols, n_processes, time"
    assert len(lines) == 2, f"expected 1 data row, got {lines[1:]}"
    assert lines[1] == "4, 8, 2, 3.500000"
    ext = (workers["root"] / "out" / "results_extended.csv").read_text()
    assert len(ext.strip().splitlines()) == 2


def test_coordinator_decisions_reach_every_process(workers):
    """Only process 0 read its file; process 1 holds its entries, not the
    ones in its own file."""
    assert workers[0]["cache"] == CACHE_ENTRIES[0]
    assert workers[1]["cache"] == CACHE_ENTRIES[0]
