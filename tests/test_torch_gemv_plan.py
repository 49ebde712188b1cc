"""The GEMV's plan (``ops/cuda_gemv.py::gemv_plan``) and, on a card, each of
its routes against the plain version.

The plan is a pure function of the shape, the dtypes and the SM count, so
the CPU reads it: every shape of the reference's sweeps (``bench/sweep.py``'s
``ASYMMETRIC_SIZES`` and ``SQUARE_SIZES``) gets grids the card takes and
keeps the stated loads in flight (``IN_FLIGHT_TARGET`` wherever A holds that
much); short m takes ``split`` and m of four warps an SM ``rows``; the slab
length depends on the dtype alone; the split's runs of slabs cover every
(row, slab) once, in runs that differ by at most one. Both routes cut a row
into the same slabs and sum them in slab order, so on the card (tests marked
``cuda``, which skip without one) every route and grid gives the same y
bitwise, and a row slice of A gives the full call's rows bitwise although
the two calls take different routes. This file imports no JAX, so on a
machine with a card and no JAX the card tests run alone:
``python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_gemv_plan.py``.
"""

import numpy as np
import pytest
import torch

from matvec_mpi_multiplier_torch.bench.sweep import ASYMMETRIC_SIZES, SQUARE_SIZES
from matvec_mpi_multiplier_torch.ops.cuda_gemv import (
    BLOCKS_PER_SM,
    GRID_LIMIT,
    IN_FLIGHT_TARGET,
    ROWS_MIN_WARPS_PER_SM,
    SLAB_BYTES,
    WARP_BYTES_IN_FLIGHT,
    WARPS,
    _launch,
    _layout,
    gemv_cuda,
    gemv_plain,
    gemv_plan,
    plan_scratch,
)
from matvec_mpi_multiplier_torch.ops.cuda_solver import solver_step_cuda, solver_step_plain
from matvec_mpi_multiplier_torch.ops.gemv import acc_dtype

SMS = 132  # an H100 SXM's SMs
ROWS_LINE = SMS * ROWS_MIN_WARPS_PER_SM  # 528
DTYPES = (torch.float32, torch.bfloat16, torch.float64)
SWEEP_SHAPES = list(ASYMMETRIC_SIZES) + [(s, s) for s in SQUARE_SIZES]
SUM_THREADS = 256  # csrc/gemv.cu's kSumThreads: the split's second launch


def slabs_of(k: int, dtype: torch.dtype) -> int:
    return -(-k // (SLAB_BYTES // dtype.itemsize))


def card_takes(plan, m: int, k: int, dtype: torch.dtype, sms: int = SMS) -> bool:
    """What ``csrc/gemv.cu::check_plan`` accepts, with grids in range."""
    slabs = slabs_of(k, dtype)
    common = (plan.warps == WARPS and plan.splits == slabs
              and plan.slab == SLAB_BYTES // dtype.itemsize and 1 <= plan.grid <= GRID_LIMIT)
    if plan.route == "rows":
        return (common and plan.grid == -(-m // WARPS) and plan.launches == 1
                and plan.scratch == 0 and plan.slabs_per_warp == slabs)
    warps = plan.grid * WARPS
    return (common and k > 0 and plan.launches == 2 and plan.scratch == m * slabs
            and plan.slabs_per_warp == -(-m * slabs // warps)
            and -(-m // SUM_THREADS) <= GRID_LIMIT)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("shape", SWEEP_SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_sweep_shapes_get_a_plan_the_card_takes(shape, dtype):
    """Every sweep shape: a plan the kernels and the card take, with the
    stated loads in flight wherever A holds that much."""
    m, k = shape
    plan = gemv_plan(m, k, dtype, dtype, SMS)
    assert card_takes(plan, m, k, dtype)
    if m * k * dtype.itemsize >= IN_FLIGHT_TARGET:
        assert plan.bytes_in_flight >= IN_FLIGHT_TARGET
    # x in the accumulator dtype (the fused solver step) plans alike.
    assert gemv_plan(m, k, dtype, acc_dtype(dtype), SMS) == plan


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("m", [1, 7, 120, 123, 480, ROWS_LINE - 1])
def test_short_m_takes_split(m, dtype):
    """Rows too few to stream well one warp each spread their slabs over
    every resident warp: 120 x 60000 bf16 keeps 960 warps (3.75 MiB) in
    flight where one warp per row kept 120."""
    plan = gemv_plan(m, 60000, dtype, dtype, SMS)
    assert plan.route == "split" and plan.grid == SMS * BLOCKS_PER_SM
    assert card_takes(plan, m, 60000, dtype)
    if m >= 120:
        assert plan.bytes_in_flight >= IN_FLIGHT_TARGET
    if m == 120 and dtype == torch.bfloat16:
        assert plan.bytes_in_flight == 960 * WARP_BYTES_IN_FLIGHT


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("shape", [(ROWS_LINE, 60000), (600, 60000), (1200, 60000),
                                   (8192, 60000), (16384, 16384), (32768, 32768),
                                   (65536, 65536), (600, 600), (1200, 100), (120, 1)])
def test_rows_enough_or_one_slab_takes_rows(shape, dtype):
    """m of at least four warps an SM takes one warp per row, as does a row
    of one slab, whatever m."""
    m, k = shape
    plan = gemv_plan(m, k, dtype, dtype, SMS)
    assert plan.route == "rows"
    assert card_takes(plan, m, k, dtype)


def test_fewer_sms_move_the_line():
    """The line between the routes is the card's: four warps an SM."""
    assert gemv_plan(ROWS_LINE, 60000, torch.float32, torch.float32, SMS).route == "rows"
    assert gemv_plan(ROWS_LINE, 60000, torch.float32, torch.float32, SMS + 1).route == "split"
    assert gemv_plan(120, 60000, torch.float32, torch.float32, 30).route == "rows"


@pytest.mark.parametrize("dtype", (*DTYPES, torch.float16), ids=str)
def test_slab_depends_on_dtype_alone(dtype):
    """The slab (the unit of the association) is SLAB_BYTES of A, never a
    function of m, k, the SMs or the route, so no plan changes y."""
    slabs = {gemv_plan(m, k, dtype, dtype, sms).slab
             for m in (1, 120, 1200, 2112, 65536) for k in (8, 3001, 60000)
             for sms in (66, 132)}
    assert slabs == {SLAB_BYTES // dtype.itemsize}
    for route in ("rows", "split"):
        for blocks in (1, 2):
            assert (_layout(route, 120, 60000, dtype, SMS, blocks).slab
                    == SLAB_BYTES // dtype.itemsize)


@pytest.mark.parametrize("blocks_per_sm", [1, 2])
@pytest.mark.parametrize("m, k, sms", [(1, 60000, SMS), (120, 60000, SMS), (1200, 60001, SMS),
                                       (123, 60000, 7), (5, 100000, 1)])
def test_split_runs_cover_every_unit_once(m, k, sms, blocks_per_sm):
    """The kernel's cut of the m * slabs units (warp w takes [U w / W,
    U (w + 1) / W)): contiguous runs that cover each unit once and differ
    in length by at most one, the longest the plan's slabs_per_warp."""
    plan = _layout("split", m, k, torch.bfloat16, sms, blocks_per_sm)
    assert card_takes(plan, m, k, torch.bfloat16, sms)
    units, warps = plan.scratch, plan.grid * WARPS
    bounds = [units * w // warps for w in range(warps + 1)]
    assert bounds[0] == 0 and bounds[-1] == units
    lengths = [b - a for a, b in zip(bounds, bounds[1:])]
    assert min(lengths) >= 0 and max(lengths) - min(lengths) <= 1
    assert max(lengths) == plan.slabs_per_warp


def test_split_takes_any_k():
    """The split keeps its partials in device memory, so no k is too long."""
    k = 10**8
    plan = gemv_plan(4, k, torch.float32, torch.float32, SMS)
    assert plan.route == "split" and plan.scratch == 4 * slabs_of(k, torch.float32)
    assert card_takes(plan, 4, k, torch.float32)


def test_plan_scratch_is_the_splits_alone():
    rows = gemv_plan(8192, 60000, torch.bfloat16, torch.bfloat16, SMS)
    split = gemv_plan(120, 60000, torch.bfloat16, torch.bfloat16, SMS)
    assert plan_scratch(rows, torch.bfloat16, "cpu") is None
    scratch = plan_scratch(split, torch.bfloat16, "cpu")
    assert scratch.dtype == torch.float32 and scratch.shape == (120 * 8,)
    assert plan_scratch(gemv_plan(120, 60000, torch.float64, torch.float64, SMS),
                        torch.float64, "cpu").dtype == torch.float64


def test_plan_refuses_what_no_route_takes():
    with pytest.raises(ValueError, match="bf16/fp16/fp32/fp64"):
        gemv_plan(8, 8, torch.int32, torch.int32, SMS)
    with pytest.raises(ValueError, match="accumulator"):
        gemv_plan(8, 8, torch.bfloat16, torch.float16, SMS)
    with pytest.raises(ValueError, match="accumulator"):
        gemv_plan(8, 8, torch.float32, torch.float64, SMS)
    for m, k, sms in ((0, 8, SMS), (8, -1, SMS), (8, 8, 0)):
        with pytest.raises(ValueError, match="no gemv plan"):
            gemv_plan(m, k, torch.float32, torch.float32, sms)
    with pytest.raises(ValueError, match="grid's limit"):
        gemv_plan(2**40, 8, torch.float32, torch.float32, SMS)


def test_empty_row_plans_rows():
    plan = gemv_plan(5, 0, torch.float32, torch.float32, SMS)
    assert plan.route == "rows" and plan.bytes_in_flight == 0


def test_cpu_call_counts_no_route():
    """On the CPU the wrapper and the solver step compute their plain
    versions and count nothing, by launch or by route."""
    before = (gemv_cuda.launches, dict(gemv_cuda.route_launches),
              solver_step_cuda.launches, dict(solver_step_cuda.gemv_route_launches))
    a, x = torch.ones(120, 9000), torch.ones(9000)
    assert torch.equal(gemv_cuda(a, x), torch.full((120,), 9000.0))
    vec = torch.ones(9000)
    solver_step_cuda("cg", a, 0, vec, vec, vec, vec, torch.ones(1))
    assert (gemv_cuda.launches, dict(gemv_cuda.route_launches),
            solver_step_cuda.launches, dict(solver_step_cuda.gemv_route_launches)) == before


# ------------------------------------------------------------ on the card


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run `python -m pytest --noconftest -m cuda "
                    "tests/test_torch_gemv_plan.py` on the chip")
    return torch.device("cuda", 0)


def operands(m, k, dtype, device, seed=0, x_dtype=None):
    rng = np.random.default_rng(seed)
    a = torch.from_numpy(rng.random((m, k), dtype=np.float32) * 10).to(device, dtype)
    x = torch.from_numpy(rng.random(k, dtype=np.float32) * 10).to(device, x_dtype or dtype)
    return a, x


def rtol(k, dtype):
    """The kernel's bar against the plain version: fp64 sums agree to
    ~k eps64; fp32 sums in another order to ~sqrt(k) eps32."""
    return 1e-12 if dtype == torch.float64 else (1e-5 if k <= 4096 else 1e-4)


# m = 1, ragged m on both routes, k shorter than a slab, a misaligned bf16
# row (k odd), and the reference's asymmetric shape.
CARD_SHAPES = [(1, 60000), (123, 60000), (120, 60001), (2501, 999), (4, 8),
               (1000, 3001), (120, 60000)]
CARD_DTYPES = (torch.bfloat16, torch.float16, torch.float32, torch.float64)


def forced_plans(m, k, dtype):
    """Every route on this shape: rows, and split on grids of 1 and 2
    blocks an SM, on 132 SMs and on 7 (few warps, long runs)."""
    return [_layout("rows", m, k, dtype, SMS)] + [
        _layout("split", m, k, dtype, sms, blocks)
        for sms in (SMS, 7) for blocks in (1, 2) if k > 0]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", CARD_DTYPES, ids=str)
@pytest.mark.parametrize("shape", CARD_SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_every_route_matches_plain_and_each_other_on_card(card, shape, dtype):
    """The planned route against the plain version at the bar, bitwise
    repeatable, and every other route and split bitwise equal to it."""
    m, k = shape
    a, x = operands(m, k, dtype, card, seed=m + k)
    plan = gemv_plan(m, k, dtype, dtype, SMS)
    before = gemv_cuda.route_launches[plan.route]
    y1, y2 = gemv_cuda(a, x), gemv_cuda(a, x)
    torch.cuda.synchronize(card)
    assert gemv_cuda.route_launches[plan.route] == before + 2
    assert torch.equal(y1, y2)
    ref = gemv_plain(a, x)
    assert ((y1 - ref).abs() / ref.abs()).max().item() <= rtol(k, dtype)
    for other in forced_plans(m, k, dtype):
        assert torch.equal(_launch(a, x, other), y1), other


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", (torch.bfloat16, torch.float32), ids=str)
def test_row_slice_equals_full_call_across_routes_on_card(card, dtype):
    """The first 120 rows of an 8192 x 60000 A (rows) equal, bitwise, the
    120-row slice's own call (split), as do rows 1000:1123."""
    m, k = 8192, 60000
    a, x = operands(m, k, dtype, card, seed=7)
    assert gemv_plan(m, k, dtype, dtype, SMS).route == "rows"
    assert gemv_plan(120, k, dtype, dtype, SMS).route == "split"
    full = gemv_cuda(a, x)
    assert torch.equal(gemv_cuda(a[:120], x), full[:120])
    assert torch.equal(gemv_cuda(a[1000:1123], x), full[1000:1123])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", (torch.bfloat16, torch.float32, torch.float64), ids=str)
@pytest.mark.parametrize("m", [120, 4096])
def test_acc_x_face_through_the_solver_step_on_card(card, m, dtype):
    """The fused step's GEMV (x in the accumulator dtype) on the route the
    plan names for its shard, against the plain step."""
    k, n, off = 20000, 24000, 3000
    acc = acc_dtype(dtype)
    a, _ = operands(m, k, dtype, card, seed=m)
    rng = np.random.default_rng(1)
    x, r, p, ap = (torch.from_numpy(rng.random(n) + 0.5).to(card, acc) for _ in range(4))
    s_in = torch.ones(1, dtype=acc, device=card)
    route = gemv_plan(m, k, dtype, acc, SMS).route
    assert route == ("split" if m == 120 else "rows")
    before = solver_step_cuda.gemv_route_launches[route]
    got = solver_step_cuda("cg", a, off, x, r, p, ap, s_in)
    want = solver_step_plain("cg", a, off, x, r, p, ap, s_in)
    torch.cuda.synchronize(card)
    assert solver_step_cuda.gemv_route_launches[route] == before + 1
    # p2 has both signs: the bar is a share of |A|·|p2's segment|.
    partial, ref = got[-1], want[-1]
    scale = gemv_plain(a.abs(), want[2][off:off + k].abs())
    assert ((partial - ref).abs() <= rtol(k, dtype) * scale).all()
    again = solver_step_cuda("cg", a, off, x, r, p, ap, s_in)[-1]
    assert torch.equal(again, partial)
