"""The hand-written CUDA GEMV tier (``csrc/gemv.cu``) and its plain version.

Replaces the JAX package's Pallas kernel
(``matvec_mpi_multiplier_tpu/ops/pallas_gemv.py::_gemv_kernel``). The kernel
is bound by HBM bytes (``m·k·itemsize + k·itemsize + m·acc_itemsize``), and
meeting that rate takes megabytes of A's loads in flight across the card.
:func:`gemv_plan` (a pure function of the shape, the dtypes and the SM
count) picks one of two routes for that:

* ``rows``: one warp per row, eight rows per block, for m of at least
  four warps an SM;
* ``split``: for short m, every row's slabs spread over the card's
  resident warps, each slab's partial into a scratch the wrapper
  allocates, then a second launch sums each row's partials in slab order
  (no atomics).

Either way a row is cut into slabs of :data:`SLAB_BYTES` of A whose length
depends on the dtype alone, and y is the slab partials summed in slab
order, so the result is bitwise the same whatever the route or split. The
source describes the design.

:func:`gemv_cuda` launches the kernel for a CUDA tensor, or raises: a
missing ``nvcc``, a failed build or a refused launch is an error, never a
quiet switch to another tier. For a tensor on the CPU, and only there, it
computes :func:`gemv_plain`, so the CPU tests reach every line around the
kernel. ``gemv_cuda.launches`` counts the wrapper's calls on the card (a
``split`` call is two kernel launches; nothing else adds to it), so a run
can show that its path went through the kernel, and
``gemv_cuda.route_launches`` the same calls by route. Inside
``ops.graphs.launch_predicate`` the launch reads the predicate on the card
and returns at once where it is False (y is then left unwritten).
"""

from __future__ import annotations

import ctypes
import functools
from collections import Counter
from typing import NamedTuple

import torch

from . import _build
from .gemv import acc_dtype, register_kernel
from .graphs import predicate_ptr

# The C entry's dtype codes (csrc/gemv.cu::matvec_gemv).
_DTYPE_CODES = {
    torch.bfloat16: 0, torch.float16: 1, torch.float32: 2, torch.float64: 3,
}
# Route codes of ``matvec_gemv`` (``csrc/gemv.cu``'s ``Route``).
ROUTE_CODES = {"rows": 0, "split": 1}
# The kernel's constants (csrc/gemv.cu): bytes of A per slab, whatever the
# dtype; 16-byte loads of A a lane keeps in flight; warps per block; blocks
# of 128-register threads an SM holds.
SLAB_BYTES = 16384
BATCH_LOADS = 8
WARPS = 8
BLOCKS_PER_SM = 2
# Bytes of A one warp has in flight: 32 lanes x BATCH_LOADS x 16 bytes.
WARP_BYTES_IN_FLIGHT = 32 * BATCH_LOADS * 16
# One warp per row streams well from ROWS_MIN_WARPS_PER_SM warps an SM (m >=
# 528 on 132 SMs: 2.1 MB in flight); below it the split route keeps every
# resident warp streaming. The line is the card's measurement (PERF.md):
# rows ran faster from 600 rows of 60000 in fp32 and from 840 in bf16, the
# split below 480.
ROWS_MIN_WARPS_PER_SM = 4
# Loads of A the plan keeps in flight wherever A holds that much.
IN_FLIGHT_TARGET = 2 << 20
GRID_LIMIT = 2**31 - 1


class GemvPlan(NamedTuple):
    """How ``csrc/gemv.cu`` computes one (m, k) GEMV."""

    route: str            # rows or split
    slab: int             # elements of A per slab: SLAB_BYTES / itemsize
    splits: int           # partials of a row summed in slab order: its slabs
    warps: int            # warps per block
    grid: int             # blocks of the (first) launch
    slabs_per_warp: int   # the most slabs one warp streams
    scratch: int          # accumulators of partials the wrapper allocates
    bytes_in_flight: int  # A's loads in flight across the card at once
    launches: int         # kernel launches per call

    @property
    def codes(self) -> tuple[int, int, int]:
        """The C entry's ``int plan[3]``."""
        return (ROUTE_CODES[self.route], self.grid, self.warps)


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _layout(route: str, m: int, k: int, dtype: torch.dtype, sms: int,
            blocks_per_sm: int = BLOCKS_PER_SM) -> GemvPlan:
    """The plan of ``route`` (split: on ``blocks_per_sm`` blocks an SM).
    Every route and grid gives the same y; :func:`gemv_plan` picks."""
    slab = SLAB_BYTES // dtype.itemsize
    slabs = _ceil_div(k, slab)
    per_warp = min(WARP_BYTES_IN_FLIGHT, min(slab, k) * dtype.itemsize)
    resident = sms * BLOCKS_PER_SM * WARPS
    if route == "rows":
        grid = _ceil_div(m, WARPS)
        return GemvPlan("rows", slab, slabs, WARPS, grid, slabs, 0,
                        min(m, resident) * per_warp, 1)
    grid = sms * blocks_per_sm
    warps = grid * WARPS
    units = m * slabs
    return GemvPlan("split", slab, slabs, WARPS, grid, _ceil_div(units, warps), units,
                    min(units, warps, resident) * per_warp, 2)


@functools.lru_cache(maxsize=1024)
def gemv_plan(m: int, k: int, dtype: torch.dtype, x_dtype: torch.dtype,
              sms: int) -> GemvPlan:
    """The plan :func:`gemv_cuda` (x of A's dtype) and the fused solver
    step (x in the accumulator dtype) take for an (m, k) A of ``dtype`` on
    a card of ``sms`` SMs.

    ``rows`` when there are rows enough (m >= sms x ROWS_MIN_WARPS_PER_SM)
    or a row is one slab; else ``split``, every row's slabs spread over two
    blocks of warps an SM. The slab length depends on the dtype alone, so
    the choice never changes y. Raises ``ValueError`` for what no route
    takes."""
    if dtype not in _DTYPE_CODES:
        raise ValueError(f"gemv_plan takes bf16/fp16/fp32/fp64 A, got {dtype}")
    if x_dtype not in (dtype, acc_dtype(dtype)):
        raise ValueError(
            f"gemv_plan takes x in A's dtype {dtype} or the accumulator "
            f"{acc_dtype(dtype)}, got {x_dtype}"
        )
    if m < 1 or k < 0 or sms < 1:
        raise ValueError(f"no gemv plan for an ({m}, {k}) A on {sms} SMs")
    slabs = _ceil_div(k, SLAB_BYTES // dtype.itemsize)
    route = "rows" if m >= sms * ROWS_MIN_WARPS_PER_SM or slabs <= 1 else "split"
    plan = _layout(route, m, k, dtype, sms)
    if plan.grid > GRID_LIMIT:
        raise ValueError(f"an ({m}, {k}) A needs {plan.grid} blocks, over the grid's limit")
    return plan


@functools.cache
def sm_count(device: torch.device) -> int:
    """The card's SM count, what :func:`gemv_plan` fills."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def plan_codes(plan: GemvPlan):
    """The plan as the C entries take it, ``int plan[3]``."""
    return (ctypes.c_int * 3)(*plan.codes)


def plan_scratch(plan: GemvPlan, dtype: torch.dtype, device) -> torch.Tensor | None:
    """The split route's partials (``plan.scratch`` accumulators), or None."""
    if not plan.scratch:
        return None
    return torch.empty(plan.scratch, dtype=acc_dtype(dtype), device=device)


# Rows of A the plain version widens to the accumulator dtype at a time: it
# must never hold an fp32 copy of a multi-GB bf16 A.
PLAIN_CHUNK_BYTES = 256 << 20


def gemv_plain(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``(a.to(acc) * x.to(acc)).sum(1)`` in row chunks, on ``a``'s device."""
    acc = acc_dtype(a.dtype)
    m, k = a.shape
    y = torch.empty(m, dtype=acc, device=a.device)
    xa = x.to(acc)
    rows = max(1, PLAIN_CHUNK_BYTES // max(1, k * acc.itemsize))
    for i in range(0, m, rows):
        y[i:i + rows] = (a[i:i + rows].to(acc) * xa).sum(1)
    return y


def _check(a: torch.Tensor, x: torch.Tensor) -> None:
    if a.dim() != 2 or x.dim() != 1 or x.shape[0] != a.shape[1]:
        raise ValueError(
            f"gemv needs a (m, k) matrix and a (k,) vector, got "
            f"{tuple(a.shape)} and {tuple(x.shape)}"
        )
    if a.dtype != x.dtype or a.dtype not in _DTYPE_CODES:
        raise ValueError(
            f"gemv needs A and x of one dtype among bf16/fp16/fp32/fp64, got "
            f"{a.dtype} and {x.dtype}"
        )
    if a.device != x.device:
        raise ValueError(f"A is on {a.device} but x is on {x.device}")
    if not (a.is_contiguous() and x.is_contiguous()):
        raise ValueError("gemv needs contiguous A and x (row pitch = k)")


def _launch(a: torch.Tensor, x: torch.Tensor, plan: GemvPlan,
            pred: int | None = None) -> torch.Tensor:
    """One launch of ``csrc/gemv.cu`` on ``plan``, for CUDA tensors ``a``
    and ``x`` that passed :func:`_check`. Any plan of :func:`_layout` gives
    the same y; :func:`gemv_cuda` launches :func:`gemv_plan`'s. ``pred``:
    a launch predicate's address (``ops/graphs.py``), or None."""
    lib = _build.load_library()
    y = torch.empty(a.shape[0], dtype=acc_dtype(a.dtype), device=a.device)
    scratch = plan_scratch(plan, a.dtype, a.device)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.matvec_gemv(
            _DTYPE_CODES[a.dtype], plan_codes(plan), a.data_ptr(), x.data_ptr(),
            y.data_ptr(), None if scratch is None else scratch.data_ptr(),
            a.shape[0], a.shape[1], stream, pred,
        )
    if rc != 0:
        raise RuntimeError(
            f"gemv kernel launch failed for A {tuple(a.shape)} {a.dtype} on {plan}: "
            f"{lib.matvec_error_string(rc).decode()} (cudaError {rc})"
        )
    return y


def _gemv(a: torch.Tensor, x: torch.Tensor, plan_of) -> torch.Tensor:
    """``y = A @ x`` by the kernel on the plan ``plan_of(m, k, dtype, sms)``
    returns (the plain version for CPU tensors), counted in
    ``gemv_cuda.launches``."""
    _check(a, x)
    if a.device.type == "cpu":
        return gemv_plain(a, x)
    _build.load_library()
    if a.device.type != "cuda":
        raise ValueError(f"gemv_cuda runs on CUDA or CPU tensors, got {a.device}")
    m, k = a.shape
    if m == 0:
        return torch.empty(0, dtype=acc_dtype(a.dtype), device=a.device)
    plan = plan_of(m, k, a.dtype, sm_count(a.device))
    y = _launch(a, x, plan, predicate_ptr(a.device))
    gemv_cuda.launches += 1
    gemv_cuda.route_launches[plan.route] += 1
    return y


def gemv_cuda(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``y = A @ x`` by the CUDA kernel on the route :func:`gemv_plan`
    picks (plain version for CPU tensors)."""
    return _gemv(a, x, lambda m, k, dtype, sms: gemv_plan(m, k, dtype, dtype, sms))


# The splits a forced ``split`` route may take: one or two blocks an SM.
SPLIT_BLOCKS_PER_SM = (1, BLOCKS_PER_SM)


def route_label(route: str, blocks_per_sm: int = BLOCKS_PER_SM) -> str:
    """The name of a forced route, as the tuner's candidates spell it."""
    return "cuda[rows]" if route == "rows" else f"cuda[split@{blocks_per_sm}]"


@functools.lru_cache(maxsize=None)
def gemv_route(route: str, blocks_per_sm: int = BLOCKS_PER_SM):
    """A GEMV on ``route`` (split: on ``blocks_per_sm`` blocks an SM) in
    place of :func:`gemv_plan`'s: the measured tuner's candidates and the
    ``auto`` tier's winners (``ops/gemv.py``). Every route and grid gives
    bitwise the same y, so the choice never changes a result. Launches
    count in ``gemv_cuda.launches`` and ``gemv_cuda.route_launches``."""
    if route not in ROUTE_CODES:
        raise ValueError(f"gemv routes are {tuple(ROUTE_CODES)}, got {route!r}")
    if route == "split" and blocks_per_sm not in SPLIT_BLOCKS_PER_SM:
        raise ValueError(
            f"split takes {SPLIT_BLOCKS_PER_SM} blocks an SM, got {blocks_per_sm}")

    def plan_of(m, k, dtype, sms):
        plan = _layout(route, m, k, dtype, sms, blocks_per_sm)
        if plan.grid > GRID_LIMIT:
            raise ValueError(f"an ({m}, {k}) A needs {plan.grid} blocks on "
                             f"{route}, over the grid's limit")
        return plan

    def gemv(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        return _gemv(a, x, plan_of)

    gemv.__name__ = route_label(route, blocks_per_sm)
    return gemv


gemv_cuda.launches = 0  # type: ignore[attr-defined]
gemv_cuda.route_launches = Counter()  # type: ignore[attr-defined]

register_kernel("cuda", gemv_cuda)
