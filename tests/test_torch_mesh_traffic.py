"""Traffic between mesh shards (``parallel/mesh.py``): the ``mesh/psum``
and ``mesh/gather`` profiler spans open where a collective moves a block
from one shard to another, and the default registry counts the copies and
bytes, by the formula the module's docstring gives. CPU only: logical
shards on one device count as cards do."""

import pytest
import torch

from matvec_mpi_multiplier_torch import get_strategy
from matvec_mpi_multiplier_torch.obs.registry import get_registry, label, reset_registry
from matvec_mpi_multiplier_torch.ops import get_kernel
from matvec_mpi_multiplier_torch.ops.gemv import acc_dtype
from matvec_mpi_multiplier_torch.parallel.mesh import (
    SHARD_BYTES,
    SHARD_COPIES,
    make_mesh,
    psum_scatter,
)

CPU = torch.device("cpu")
SPANS = ("mesh/psum", "mesh/gather")


@pytest.fixture
def registry():
    reset_registry()
    yield get_registry()
    reset_registry()


def cpu_mesh(r, c):
    return make_mesh(r * c, shape=(r, c), devices=[CPU] * (r * c))


def operands(m, k, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    a = (torch.rand(m, k, generator=g, dtype=torch.float64) * 10).to(dtype)
    x = (torch.rand(k, generator=g, dtype=torch.float64) * 10).to(dtype)
    return a, x


def moved(registry, collective):
    counters = registry.snapshot()["counters"]
    return (counters.get(label(SHARD_COPIES, collective=collective), 0),
            counters.get(label(SHARD_BYTES, collective=collective), 0))


def span_counts(prof):
    names = [e.name for e in prof.events()]
    return {s: names.count(s) for s in SPANS}


@pytest.mark.parametrize("dtype", [torch.float64, torch.bfloat16])
@pytest.mark.parametrize("grid", [(1, 1), (1, 2), (2, 1), (2, 2)])
def test_blockwise_bytes_a_call_follow_the_formula(registry, grid, dtype):
    """2r(c - 1) partials of m/r accumulator elements in the psum, r - 1 row
    blocks of m/r elements of A's dtype in the output gather."""
    r, c = grid
    m, k = 64, 32
    fn = get_strategy("blockwise").build(cpu_mesh(r, c))
    a, x = operands(m, k, dtype)
    calls = 3
    for _ in range(calls):
        fn(a, x)
    acc = torch.empty((), dtype=acc_dtype(dtype)).element_size()
    out = torch.empty((), dtype=dtype).element_size()
    assert moved(registry, "psum") == (calls * 2 * r * (c - 1),
                                       calls * 2 * (c - 1) * m * acc)
    assert moved(registry, "gather") == (calls * (r - 1), calls * (r - 1) * (m // r) * out)
    assert moved(registry, "psum_scatter") == (0, 0)


def test_the_papers_deployment_moves_five_blocks_a_call(registry):
    """2x2 in float64: four partials in the psum and one row block to the
    first device, m/2 elements each (2,621,440 bytes at m = 131072)."""
    m = 256
    fn = get_strategy("blockwise").build(cpu_mesh(2, 2))
    fn(*operands(m, 128, torch.float64))
    copies = sum(moved(registry, c)[0] for c in ("psum", "gather"))
    nbytes = sum(moved(registry, c)[1] for c in ("psum", "gather"))
    assert (copies, nbytes) == (5, 5 * (m // 2) * 8)
    assert 5 * (131072 // 2) * 8 == 2_621_440


def test_psum_scatter_counts_blocks_in_and_chunks_out(registry):
    """A group of four: three blocks to the first shard, three row chunks of
    a quarter of the sum back out."""
    mesh = make_mesh(4, shape=(1, 4), devices=[CPU] * 4)
    blocks = [torch.full((8, 3), float(i)) for i in range(4)]
    with torch.profiler.profile() as prof:
        out = psum_scatter(blocks, mesh, "cols")
    assert all(torch.equal(o, torch.full((2, 3), 6.0)) for o in out)
    assert moved(registry, "psum_scatter") == (6, 3 * 8 * 3 * 4 + 3 * 2 * 3 * 4)
    assert span_counts(prof) == {"mesh/psum": 1, "mesh/gather": 0}


@pytest.mark.parametrize("grid,want", [
    ((2, 2), {"mesh/psum": 1, "mesh/gather": 1}),
    ((1, 2), {"mesh/psum": 1, "mesh/gather": 0}),
    ((2, 1), {"mesh/psum": 0, "mesh/gather": 1}),
    ((1, 1), {"mesh/psum": 0, "mesh/gather": 0}),
])
def test_spans_open_where_blocks_move_between_shards(registry, grid, want):
    fn = get_strategy("blockwise").build(cpu_mesh(*grid))
    a, x = operands(32, 16, torch.float64)
    with torch.profiler.profile() as prof:
        fn(a, x)
    assert span_counts(prof) == want


def test_no_span_opens_without_a_profiler(registry, monkeypatch):
    opened = []
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: opened.append(name))
    get_strategy("blockwise").build(cpu_mesh(2, 2))(*operands(32, 16, torch.float64))
    assert opened == []


def test_blockwise_2x2_answer_is_bitwise_the_plain_composition(registry):
    """The spans and the counter leave every value as it was: each shard's
    GEMV, the psum in shard order, the row blocks concatenated, with a
    profiler recording and without."""
    m, k = 48, 40
    a, x = operands(m, k, torch.float64, seed=3)
    kern = get_kernel("cuda")
    h, w = m // 2, k // 2
    part = [[kern(a[i * h:(i + 1) * h, j * w:(j + 1) * w].contiguous(), x[j * w:(j + 1) * w])
             for j in range(2)] for i in range(2)]
    want = torch.cat([part[0][0] + part[0][1], part[1][0] + part[1][1]])
    fn = get_strategy("blockwise").build(cpu_mesh(2, 2))
    plain = fn(a, x)
    with torch.profiler.profile():
        traced = fn(a, x)
    assert torch.equal(plain, want) and torch.equal(traced, want)
