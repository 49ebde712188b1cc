"""The GEMM's tile plan (``ops/cuda_gemm.py::default_gemm_tiles``) and, on
a card, its routes against the plain version.

The plan is a pure function of the shape, the dtype and the alignment, so
the CPU reads it: the route depends on A alone (never on n or B), the
engine's buckets take the byte face with one tile spanning n, wider n the
operation face, every plan fits the H100's shared memory, and there is no
split-K. The tests marked ``cuda`` hold each route of ``csrc/gemm.cu``
against ``gemm_plain`` (the tolerances of ``chip_smoke.py``'s phase 6),
bitwise repeatable and independent of pad columns and of row slices of A;
they skip without a card. This file imports no JAX, so on a machine with a
card and no JAX they run alone:
``python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_gemm_plan.py``.
"""

import pytest
import torch

from matvec_mpi_multiplier_torch.engine.buckets import bucket_ladder
from matvec_mpi_multiplier_torch.ops.cuda_gemm import (
    ROUTE_CODES,
    SMEM_LIMIT,
    GemmPlan,
    default_gemm_tiles,
    gemm_cuda,
    gemm_plain,
    gemm_tile_ladder,
    gemm_with_tiles,
)

DTYPES = [torch.bfloat16, torch.float16, torch.float32, torch.float64]
WIDTHS = [1, 3, 4, 5, 8, 16, 31, 32, 33, 64, 100, 128, 129, 131, 256, 300, 2048, 4096]
# Shared memory of one SM (228 KB), of which 1 KB is reserved per block.
SM_SMEM = 233472


def plans(m, k, dtype, aligned=True, b_aligned=True):
    return {n: default_gemm_tiles(m, n, k, dtype, aligned, b_aligned) for n in WIDTHS}


def test_engine_buckets_take_the_byte_face():
    """Every promoted bucket at the 65536² bf16 north star: wgmma_tma, one
    128-row tile that spans all n columns (A streams once), B transposed
    first (two launches)."""
    for width in bucket_ladder():
        if width < 4:
            continue
        plan = default_gemm_tiles(65536, width, 65536, torch.bfloat16)
        assert plan.route == "wgmma_tma" and plan.face == "bytes"
        assert plan.bm == 128 and width <= plan.bn <= 128
        assert -(-width // plan.bn) == 1
        assert plan.b_load == "transposed" and plan.launches == 2


@pytest.mark.parametrize("n", [129, 131, 256, 300, 2048, 4096])
def test_wide_n_takes_the_operation_face(n):
    plan = default_gemm_tiles(4096, n, 4096, torch.bfloat16)
    assert (plan.route, plan.face, plan.bm, plan.bn) == ("wgmma_tma", "operations", 256, 128)
    # B goes straight to TMA where its rows are a multiple of 16 bytes.
    assert plan.b_load == ("tma" if n % 8 == 0 else "transposed")
    assert plan.launches == (1 if n % 8 == 0 else 2)
    unaligned_b = default_gemm_tiles(4096, n, 4096, torch.bfloat16, b_aligned=False)
    assert unaligned_b.b_load == "transposed" and unaligned_b.route == "wgmma_tma"
    for dtype in (torch.float32, torch.float64):
        plan = default_gemm_tiles(4096, n, 4096, dtype)
        assert plan.face == "operations" and plan.bn == 128


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("k,aligned", [(3001, True), (4097, True), (4100, True),
                                       (4096, False), (8, False)])
def test_a_tma_cannot_describe_takes_mma_sync(dtype, k, aligned):
    """A row pitch that is not a multiple of 16 bytes (k % 8 != 0) or an
    unaligned base: the mma_sync route, at every n."""
    for n, plan in plans(1000, k, dtype, aligned).items():
        assert plan.route == "mma_sync", n
        assert plan.b_load == "registers" and plan.launches == 1


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m,k", [(4, 8), (1000, 3001), (1000, 4096), (4096, 4104),
                                 (65536, 65536), (16384, 16384)])
def test_route_never_depends_on_n_or_b(dtype, m, k):
    for aligned in (True, False):
        routes = {p.route for b_aligned in (True, False)
                  for p in plans(m, k, dtype, aligned, b_aligned).values()}
        assert len(routes) == 1, routes
        route = routes.pop()
        if dtype in (torch.bfloat16, torch.float16):
            assert route == ("wgmma_tma" if k % 8 == 0 and aligned else "mma_sync")
        else:
            assert route == {torch.float32: "ffma", torch.float64: "dfma"}[dtype]


@pytest.mark.parametrize("dtype", DTYPES)
def test_plans_fit_shared_memory(dtype):
    """Every plan fits the 227 KB a block may opt into; the ffma byte
    face's narrow tiles leave room for two blocks per SM."""
    for k in (8, 3001, 4096, 65536):
        for aligned in (True, False):
            for n, plan in plans(4096, k, dtype, aligned).items():
                assert plan.smem_bytes <= SMEM_LIMIT, (n, plan)
                assert plan.stages >= 1
                if plan.route in ("wgmma_tma", "ffma"):
                    assert plan.stages >= 2
                if plan.route == "ffma" and plan.bn <= 32:
                    assert 2 * (plan.smem_bytes + 1024) <= SM_SMEM, plan
                if plan.route == "wgmma_tma":
                    stage = (plan.bm + plan.bn) * plan.bk * 2
                    assert plan.smem_bytes == 1024 + plan.stages * (stage + 16)


@pytest.mark.parametrize("dtype", DTYPES)
def test_k_blocks_depend_on_the_dtype_alone_and_no_split_k(dtype):
    """One fresh partial per k-block of the dtype's depth, summed in k
    order: no split-K, so no chunk boundary depends on anything but k."""
    depth = {torch.bfloat16: 64, torch.float16: 64, torch.float32: 32,
             torch.float64: 16}[dtype]
    for m, k in [(4, 8), (1000, 3001), (65536, 65536)]:
        for aligned in (True, False):
            for plan in plans(m, k, dtype, aligned).values():
                assert plan.bk == depth
                # One pass over k: no second launch sums k chunks.
                assert plan.launches == (2 if plan.b_load == "transposed" else 1)


def test_plan_fields_and_refusals():
    plan = default_gemm_tiles(65536, 32, 65536, torch.bfloat16)
    assert isinstance(plan, GemmPlan) and plan.route in ROUTE_CODES
    assert (plan.bm, plan.bn, plan.bk) == (128, 32, 64)
    assert plan.stages == 8 and plan.smem_bytes <= SMEM_LIMIT
    assert default_gemm_tiles(16384, 8, 16384, torch.float32).b_load == "cp.async"
    with pytest.raises(ValueError, match="bf16/fp16/fp32/fp64"):
        default_gemm_tiles(8, 8, 8, torch.int8)


def test_cpu_call_counts_no_route():
    before = dict(gemm_cuda.route_launches)
    c = gemm_cuda(torch.ones(4, 8, dtype=torch.bfloat16), torch.ones(8, 2, dtype=torch.bfloat16))
    assert torch.equal(c, torch.full((4, 2), 8.0))
    assert dict(gemm_cuda.route_launches) == before


def test_empty_contraction_is_zero():
    """k = 0: C is zeros, on the CPU as on the card (no kernel runs)."""
    c = gemm_cuda(torch.ones(3, 0), torch.ones(0, 5))
    assert torch.equal(c, torch.zeros(3, 5))


# ------------------------------------------------------------ on the card


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run `python -m pytest --noconftest -p "
                    "no:cacheprovider -m cuda tests/test_torch_gemm_plan.py` on one")
    return torch.device("cuda", 0)


# (m, k, n): the fixture's shape, a ragged k (mma_sync for 16-bit A), a
# bucket-4 B with a ragged m, a k not a multiple of 64, a bucket, and the
# operation face with n = 256 and a ragged n.
CARD_SHAPES = [(4, 8, 3), (1000, 3001, 5), (1000, 4096, 4), (4096, 4104, 8),
               (4096, 4096, 32), (2048, 2048, 256), (2048, 2048, 300)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", CARD_SHAPES)
def test_gemm_kernel_matches_plain_on_card(card, shape, dtype):
    m, k, n = shape
    gen = torch.Generator(device=card).manual_seed(m + k + n)
    a = (torch.rand((m, k), generator=gen, device=card) * 10).to(dtype)
    b = (torch.rand((k, n), generator=gen, device=card) * 10).to(dtype)
    plan = default_gemm_tiles(m, n, k, dtype, a.data_ptr() % 16 == 0, b.data_ptr() % 16 == 0)
    before = dict(gemm_cuda.route_launches)
    c1, c2 = gemm_cuda(a, b), gemm_cuda(a, b)
    ref = gemm_plain(a, b)
    torch.cuda.synchronize(card)
    assert gemm_cuda.route_launches[plan.route] == before.get(plan.route, 0) + 2
    rtol = 1e-12 if dtype == torch.float64 else (1e-5 if k <= 4096 else 1e-4)
    assert ((c1 - ref).abs() / ref.abs()).max().item() <= rtol
    assert torch.equal(c1, c2)
    # Pad columns (zeros or random) change no real column, across a tile
    # width too; rows of A alone give the rows of the whole product.
    width = n + 3
    for fill in (torch.zeros, torch.ones):
        block = fill((k, width), dtype=dtype, device=card) * 7
        block[:, :n] = b
        assert torch.equal(gemm_cuda(a, block)[:, :n], c1)
    r0, r1 = (1, m - 1) if m < 8 else (3, m - 2)
    assert torch.equal(gemm_cuda(a[r0:r1], b), c1[r0:r1])


@pytest.mark.cuda
def test_gemm_routes_on_card(card):
    """The route each A takes on the card, by the launch counts."""
    cases = [((256, 256, 64), torch.bfloat16, "wgmma_tma"),
             ((256, 3001, 64), torch.float16, "mma_sync"),
             ((256, 256, 64), torch.float32, "ffma"),
             ((256, 256, 64), torch.float64, "dfma")]
    for (m, k, n), dtype, route in cases:
        before = gemm_cuda.route_launches[route]
        gemm_cuda(torch.ones((m, k), dtype=dtype, device=card),
                  torch.ones((k, n), dtype=dtype, device=card))
        assert gemm_cuda.route_launches[route] == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_tile_ladder_bitwise_on_card(card, dtype):
    """Every plan of the tuner's tile ladder gives C bitwise the default
    plan's, whatever order they run in: a kernel launched with fewer stages
    between two launches with more keeps its shared-memory opt-in."""
    m, k, n = 4096, 4096, 16
    gen = torch.Generator(device=card).manual_seed(7)
    a = (torch.rand((m, k), generator=gen, device=card) * 10).to(dtype)
    b = (torch.rand((k, n), generator=gen, device=card) * 10).to(dtype)
    want = gemm_cuda(a, b)
    ladder = gemm_tile_ladder(m, n, k, dtype)
    for plan in ladder + ladder[::-1]:
        c = gemm_with_tiles(plan.route, plan.bn, plan.stages)(a, b)
        assert torch.equal(c, want), plan


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tile_ladder_from_two_threads_on_card(card, dtype):
    """Launches from threads other than the one that planned a kernel
    first. The shared-memory opt-in belongs to the kernel, for the whole
    process: one thread's launch with fewer stages, after another thread
    opted the kernel in for more, does not lower it under the other's next
    launch. And a thread whose plan was already in the table, so that it
    made no runtime call before encoding its TMA maps, still has a context
    to encode them in."""
    import threading

    m, k, n = 4096, 4096, 16
    gen = torch.Generator(device=card).manual_seed(8)
    a = (torch.rand((m, k), generator=gen, device=card) * 10).to(dtype)
    b = (torch.rand((k, n), generator=gen, device=card) * 10).to(dtype)
    want = gemm_cuda(a, b)
    ladder = gemm_tile_ladder(m, n, k, dtype)
    big, small = ladder[0], ladder[-1]  # the default plan, then half its stages
    assert (small.route, small.bn) == (big.route, big.bn) and small.stages < big.stages
    results, errors = [], []
    turn = [threading.Event() for _ in range(3)]

    def launch(plan):
        c = gemm_with_tiles(plan.route, plan.bn, plan.stages)(a, b)
        torch.cuda.synchronize(card)
        results.append((plan, c))

    def run(steps):
        try:
            for wait, plan, done in steps:
                if wait is not None:
                    assert turn[wait].wait(60)
                launch(plan)
                turn[done].set()
        except Exception as e:  # noqa: BLE001 - reported by the assert below
            errors.append(e)
            for event in turn:
                event.set()

    # Thread one launches the large ring, thread two then the small one,
    # then thread one the large ring again.
    one = threading.Thread(target=run, args=([(None, big, 0), (1, big, 2)],))
    two = threading.Thread(target=run, args=([(0, small, 1)],))
    one.start()
    two.start()
    one.join()
    two.join()
    assert not errors, errors
    assert [plan for plan, _ in results] == [big, small, big]
    for plan, c in results:
        assert torch.equal(c, want), plan

