"""The hand-written CUDA GEMM tier (``csrc/gemm.cu``) and its plain version.

Replaces the JAX package's Pallas kernel
(``matvec_mpi_multiplier_tpu/ops/pallas_gemm.py::_mm_kernel``). At the
engine's bucket widths the kernel is bound by the HBM bytes of A; one tile
spans all n <= 128 columns so A is read once per dispatch. Its routes
(:func:`default_gemm_tiles` plans them from A alone): bf16/fp16 on ``wgmma``
fed by TMA (``wgmma_tma``, two launches: B's transpose, then the GEMM), or
on ``mma.sync`` where TMA cannot describe A (``mma_sync``); fp32 on FFMA
(``ffma``, IEEE, never TF32); fp64 on DFMA (``dfma``). The source describes
the design.

:func:`gemm_cuda` launches the kernel for a CUDA tensor, or raises: a
missing ``nvcc``, a failed build or a refused launch is an error, never a
quiet switch to another tier or route. Unlike the Pallas tier there is no
fallback for unaligned shapes: the kernel covers every shape. For a tensor
on the CPU, and only there, it computes :func:`gemm_plain`.
``gemm_cuda.launches`` counts the wrapper's kernel calls (nothing else adds
to it) and ``gemm_cuda.route_launches`` the same calls by route.
"""

from __future__ import annotations

import ctypes
import functools
from collections import Counter
from typing import NamedTuple

import torch

from . import _build
from .graphs import refuse_predicate
from .gemm_kernels import register_gemm_kernel
from .gemv import acc_dtype
from .cuda_gemv import _DTYPE_CODES, PLAIN_CHUNK_BYTES


# Route codes of ``matvec_gemm`` (``csrc/gemm.cu``'s ``Route``).
ROUTE_CODES = {"wgmma_tma": 0, "mma_sync": 1, "ffma": 2, "dfma": 3}
# Shared memory one block may use on an H100 (227 KB, opted in above 48 KB).
SMEM_LIMIT = 232448
# Tile widths: n <= 128 takes the smallest that covers it (one tile spans
# every column, A streams once); wider n tiles over 128 columns.
TILE_WIDTHS = (8, 16, 32, 64, 128)
WGMMA_MAX_STAGES = 8
FFMA_MAX_STAGES = 6


class GemmPlan(NamedTuple):
    """How ``csrc/gemm.cu`` computes one (m, k) x (k, n) product."""

    route: str          # wgmma_tma, mma_sync, ffma or dfma
    bm: int             # rows per tile
    bn: int             # columns per tile
    bk: int             # k-block depth: one fresh partial per k-block
    stages: int         # shared-memory ring depth (1: register double buffer)
    face: str           # "bytes" (n <= 128: one tile spans n) or "operations"
    b_load: str         # how B reaches the tile: "tma" (as it is, MN-major),
                        # "transposed" (a pre-pass, then TMA), "cp.async",
                        # "registers"
    smem_bytes: int     # shared memory per block, dynamic or static
    launches: int       # kernel launches per call (with "transposed": 2)


def _tile_width(n: int) -> int:
    return next((w for w in TILE_WIDTHS if w >= n), TILE_WIDTHS[-1])


@functools.lru_cache(maxsize=256)
def default_gemm_tiles(m: int, n: int, k: int, dtype: torch.dtype,
                       aligned: bool = True, b_aligned: bool = True) -> GemmPlan:
    """The static plan for ``gemm_cuda`` on an (m, k) A of ``dtype`` and a
    (k, n) B: the Hopper counterpart of the JAX package's
    ``default_gemm_tiles`` (``ops/pallas_gemm.py:86``). ``aligned`` and
    ``b_aligned`` say whether A's and B's base addresses are 16-byte
    aligned.

    The route depends on A alone (dtype, k, alignment), never on n or B:
    16-bit A goes to ``wgmma_tma`` when TMA can describe it (its row pitch
    ``2k`` and its base 16-byte aligned), else to ``mma_sync``. n picks the
    tile, and B's pitch and alignment only how B reaches it (on
    ``wgmma_tma``'s operation face TMA reads B as it is where its rows are a
    multiple of 16 bytes, else a pre-pass transposes it); every tile and B
    path of a route computes each element with the same instructions in
    the same order. The k-block depth is the dtype's (64, 32, 16) and there
    is no split-K."""
    return gemm_tiles(m, n, k, dtype, aligned, b_aligned)


def gemm_route(dtype: torch.dtype, k: int, aligned: bool = True) -> str:
    """The route :func:`default_gemm_tiles` takes, from A alone."""
    if dtype not in _DTYPE_CODES:
        raise ValueError(f"gemm takes bf16/fp16/fp32/fp64, got {dtype}")
    if dtype in (torch.bfloat16, torch.float16):
        return "wgmma_tma" if k % 8 == 0 and aligned else "mma_sync"
    return "ffma" if dtype == torch.float32 else "dfma"


def gemm_tiles(m: int, n: int, k: int, dtype: torch.dtype, aligned: bool = True,
               b_aligned: bool = True, bn: int | None = None,
               stages: int | None = None) -> GemmPlan:
    """The plan of :func:`gemm_route`'s route with tiles ``bn`` columns wide
    (default: the smallest width that covers n) and a ring of ``stages``
    (default: the most that fit), the tuner's tile ladder
    (:func:`gemm_tile_ladder`). Raises ``ValueError`` for what the route
    cannot take."""
    del m
    route = gemm_route(dtype, k, aligned)
    face = "bytes" if n <= TILE_WIDTHS[-1] else "operations"
    bn = _tile_width(n) if bn is None else bn
    if bn not in TILE_WIDTHS:
        raise ValueError(f"gemm tiles are {TILE_WIDTHS} columns wide, got {bn}")
    if route == "wgmma_tma":
        # The operation face takes 256-row tiles: 3/4 of the L2 bytes per
        # flop of 128 x 128.
        bm = 128 if face == "bytes" or bn != 128 else 256
        direct = face == "operations" and bm == 256 and n % 8 == 0 and b_aligned
        stage = (bm + bn) * 64 * 2
        top = min(WGMMA_MAX_STAGES, (SMEM_LIMIT - 1024 - 16 * WGMMA_MAX_STAGES) // stage)
        stages = top if stages is None else stages
        if not 2 <= stages <= top:
            raise ValueError(f"wgmma_tma takes 2..{top} stages at bn={bn}, got {stages}")
        return GemmPlan("wgmma_tma", bm, bn, 64, stages, face,
                        "tma" if direct else "transposed",
                        1024 + stages * stage + 16 * stages, 1 if direct else 2)
    if route == "ffma":
        # Tiles up to 32 wide take at most half the shared memory, so two
        # blocks share an SM (1 KB of each SM's is reserved per block).
        stage = (128 + bn) * 32 * 4
        budget = SMEM_LIMIT if bn >= 64 else SMEM_LIMIT // 2 - 1024
        top = min(FFMA_MAX_STAGES, (budget - 1024 - 8 * FFMA_MAX_STAGES) // stage)
        stages = top if stages is None else stages
        if not 2 <= stages <= top:
            raise ValueError(f"ffma takes 2..{top} stages at bn={bn}, got {stages}")
        return GemmPlan("ffma", 128, bn, 32, stages, face, "cp.async",
                        1024 + stages * stage + 8 * stages, 1)
    if stages not in (None, 1):
        raise ValueError(f"{route} has no shared-memory ring, got stages={stages}")
    if route == "mma_sync":
        return GemmPlan("mma_sync", 128, bn, 64, 1, face, "registers",
                        (128 + bn) * 72 * 2, 1)
    return GemmPlan("dfma", 64, bn, 16, 1, face, "registers", (64 * 17 + 16 * bn) * 8, 1)


def gemm_tile_ladder(m: int, n: int, k: int, dtype: torch.dtype,
                     aligned: bool = True, b_aligned: bool = True) -> list[GemmPlan]:
    """The plans the tuner races for one shape, the static default first:
    the default tile's neighbours in :data:`TILE_WIDTHS` (on the byte face,
    where one tile spans n), each with the most stages that fit, and the
    default tile with half its stages where the route has a ring. Every
    plan computes each element the same way, so the choice never changes C."""
    default = default_gemm_tiles(m, n, k, dtype, aligned, b_aligned)
    plans = [default]
    widths = TILE_WIDTHS.index(default.bn)
    if default.face == "bytes":
        for i in (widths - 1, widths + 1):
            if 0 <= i < len(TILE_WIDTHS):
                plans.append(gemm_tiles(m, n, k, dtype, aligned, b_aligned,
                                        bn=TILE_WIDTHS[i]))
    if default.stages >= 4:
        plans.append(gemm_tiles(m, n, k, dtype, aligned, b_aligned,
                                bn=default.bn, stages=default.stages // 2))
    return list(dict.fromkeys(plans))


def gemm_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a.to(acc) @ b.to(acc)`` in row chunks, on ``a``'s device: it never
    holds an fp32 copy of a multi-GB bf16 A."""
    acc = acc_dtype(a.dtype)
    m, k = a.shape
    c = torch.empty((m, b.shape[1]), dtype=acc, device=a.device)
    ba = b.to(acc)
    rows = max(1, PLAIN_CHUNK_BYTES // max(1, k * acc.itemsize))
    for i in range(0, m, rows):
        c[i:i + rows] = a[i:i + rows].to(acc) @ ba
    return c


def _check(a: torch.Tensor, b: torch.Tensor) -> None:
    if a.dim() != 2 or b.dim() != 2 or b.shape[0] != a.shape[1]:
        raise ValueError(
            f"gemm needs a (m, k) matrix and a (k, n) matrix, got "
            f"{tuple(a.shape)} and {tuple(b.shape)}"
        )
    if a.dtype != b.dtype or a.dtype not in _DTYPE_CODES:
        raise ValueError(
            f"gemm needs A and B of one dtype among bf16/fp16/fp32/fp64, got "
            f"{a.dtype} and {b.dtype}"
        )
    if a.device != b.device:
        raise ValueError(f"A is on {a.device} but B is on {b.device}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("gemm needs contiguous A and B (row-major)")


def _gemm(a: torch.Tensor, b: torch.Tensor, plan_of) -> torch.Tensor:
    """``C = A @ B`` by the kernel on the plan ``plan_of(m, n, k, dtype,
    aligned, b_aligned)`` returns (the plain version for CPU tensors),
    counted in ``gemm_cuda.launches``."""
    _check(a, b)
    if a.device.type == "cpu":
        return gemm_plain(a, b)
    refuse_predicate("gemm_cuda")
    lib = _build.load_library()
    if a.device.type != "cuda":
        raise ValueError(f"gemm_cuda runs on CUDA or CPU tensors, got {a.device}")
    m, k = a.shape
    n = b.shape[1]
    c = torch.empty((m, n), dtype=acc_dtype(a.dtype), device=a.device)
    if m == 0 or n == 0:
        return c
    if k == 0:
        return c.zero_()
    plan = plan_of(m, n, k, a.dtype, a.data_ptr() % 16 == 0, b.data_ptr() % 16 == 0)
    # The pre-pass's scratch: B transposed, so both operands are K-major.
    bt = (torch.empty((n, k), dtype=a.dtype, device=a.device)
          if plan.b_load == "transposed" else None)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.matvec_gemm(
            _DTYPE_CODES[a.dtype], ROUTE_CODES[plan.route], plan.bm, plan.bn,
            plan.stages, a.data_ptr(), b.data_ptr(), None if bt is None else bt.data_ptr(),
            c.data_ptr(), m, n, k, stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"gemm kernel launch failed for A {tuple(a.shape)} B "
            f"{tuple(b.shape)} {a.dtype} ({plan.route}): "
            f"{lib.matvec_error_string(rc).decode()} (cudaError {rc})"
        )
    gemm_cuda.launches += 1
    gemm_cuda.route_launches[plan.route] += 1
    return c


def gemm_cuda(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``C = A @ B`` by the CUDA kernel (plain version for CPU tensors)."""
    return _gemm(a, b, default_gemm_tiles)


@functools.lru_cache(maxsize=None)
def gemm_with_tiles(route: str, bn: int, stages: int):
    """A GEMM on tiles ``bn`` wide with a ring of ``stages`` in place of
    :func:`default_gemm_tiles`'s: the tuner's candidates and the ``auto``
    tier's winners (``ops/gemm_kernels.py``), each recorded for one local
    shape. A call whose A does not take ``route`` (the route depends on A's
    dtype, k and alignment), or whose face cannot take the tiles, raises
    ``ValueError``: the plan never quietly becomes another. Launches count
    in ``gemm_cuda.launches``."""
    def plan_of(m, n, k, dtype, aligned, b_aligned):
        taken = gemm_route(dtype, k, aligned)
        if taken != route:
            raise ValueError(f"tiles recorded for the {route} route, but an "
                             f"({m}, {k}) {dtype} A takes {taken}")
        return gemm_tiles(m, n, k, dtype, aligned, b_aligned, bn=bn, stages=stages)

    def gemm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return _gemm(a, b, plan_of)

    gemm.__name__ = f"cuda[{route}:{bn}s{stages}]"
    gemm.plan_of = plan_of
    return gemm


def launch_info(plan: GemmPlan, m: int, n: int, dtype: torch.dtype) -> dict:
    """The launch ``gemm_cuda`` makes for ``plan`` at (m, n) on the current
    card: CTAs, registers per thread (the built kernel's), shared memory and
    threads per CTA."""
    out = (ctypes.c_int * 5)()
    lib = _build.load_library()
    rc = lib.matvec_gemm_launch_info(_DTYPE_CODES[dtype], ROUTE_CODES[plan.route],
                                     plan.bm, plan.bn, plan.stages,
                                     int(plan.b_load == "tma"), m, n, out)
    if rc != 0:
        raise RuntimeError(f"no launch for {plan} at ({m}, {n}): "
                           f"{lib.matvec_error_string(rc).decode()}")
    return {"grid": out[0], "registers": out[1], "dynamic_smem_bytes": out[2],
            "static_smem_bytes": out[3], "threads": out[4]}


gemm_cuda.launches = 0  # type: ignore[attr-defined]
gemm_cuda.route_launches = Counter()  # type: ignore[attr-defined]

register_gemm_kernel("cuda", gemm_cuda)
