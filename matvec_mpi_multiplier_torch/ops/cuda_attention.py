"""The hand-written CUDA flash-attention partial (``csrc/flash_attention.cu``)
and its plain version.

Replaces the JAX package's Pallas kernel
(``matvec_mpi_multiplier_tpu/ops/pallas_attention.py::_flash_kernel``): the
partial ``(o_unnorm, m, l)`` of a pre-scaled Q against one KV block, with the
causal mask by global positions, scores and online softmax never leaving the
SM. It is bound by its operations (4·d per unmasked (q, k) pair). Its
routes (:func:`flash_route` plans them from k's dtype and d alone):
``wgmma_split`` (bf16 k and v, d up to 128: q and the softmax weights split
into three bf16 parts on the tensor cores, K and V fed by TMA) and
``ffma`` (fp32 k and v, or d above 128: fp32 FFMA). The source describes
the design.

The kernel walks d in chunks of :data:`D_CHUNK` columns. A head dim that is
not a multiple of it (16, 64, 200) is zero-padded to the next multiple by
the wrapper, in a padded copy of q, k and v, and o's padded columns are
dropped: zero columns add nothing to q·kᵀ (q comes pre-scaled, so d never
enters the arithmetic), and the padded columns of o are P·0. The result is
exact; the cost is the copies and the kernel's work at the padded width
(at d = 64, twice the operations of d = 64 itself).

:func:`flash_partial_cuda` launches the kernel for CUDA tensors, or raises:
a missing ``nvcc``, a failed build or a refused launch is an error, never a
quiet switch to the plain version or another route. For tensors on the CPU,
and only there, it computes :func:`flash_partial_plain`. ``flash_partial_cuda.launches``
counts the kernel's launches (nothing else adds to it), and
``flash_partial_cuda.route_launches`` the same launches by route.
"""

from __future__ import annotations

import ctypes
from collections import Counter

import torch

from . import _build
from .graphs import refuse_predicate
from .attention import reference_partial
from .cuda_gemv import _DTYPE_CODES

# The kernel's head-dim chunk: the wrapper pads d to a multiple of it.
D_CHUNK = 128
# Route codes of ``matvec_flash_partial`` (``csrc/flash_attention.cu``'s
# ``Route``).
ROUTE_CODES = {"wgmma_split": 0, "ffma": 1}
# The (padded) head dim of the wgmma_split route: every attention path's
# d_head, and any smaller one.
SPLIT_D = 128


def padded_head_dim(d: int) -> int:
    """The head dim the kernel runs at: ``d`` rounded up to a multiple of
    :data:`D_CHUNK`."""
    return -(-d // D_CHUNK) * D_CHUNK


def pad_head_dim(x: torch.Tensor, d_pad: int) -> torch.Tensor:
    """``x`` (..., d) as a contiguous (..., d_pad) copy, zero beyond d (or
    ``x`` itself, contiguous, when d is d_pad already)."""
    d = x.shape[-1]
    if d == d_pad:
        return x.contiguous()
    return torch.nn.functional.pad(x, (0, d_pad - d))


def flash_route(k_dtype: torch.dtype, d: int) -> str:
    """The route ``flash_partial_cuda`` takes for k and v of ``k_dtype`` and
    head dim ``d``: ``wgmma_split`` for bf16 whose padded head dim is 128
    (d from 1 to 128), ``ffma`` for the rest (another float dtype is cast to
    fp32 first). Planned from these two alone, never after a failure."""
    if k_dtype == torch.bfloat16 and padded_head_dim(d) == SPLIT_D:
        return "wgmma_split"
    return "ffma"


def flash_partial_plain(q, k, v, q_pos, k_pos, *, causal: bool):
    """The kernel's plain version: :func:`reference_partial` with its two
    sums over the keys in fp64, rounded once."""
    return reference_partial(q, k, v, q_pos, k_pos, causal=causal,
                             sum_dtype=torch.float64)


def _check(q, k, v, q_pos, k_pos) -> None:
    if q.dim() != 3 or k.dim() != 3 or k.shape != v.shape:
        raise ValueError(
            f"flash partial needs q (h, sq, d) and k, v (h, sk, d), got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    h, sq, d = q.shape
    if k.shape[0] != h or k.shape[2] != d:
        raise ValueError(
            f"flash partial: q {tuple(q.shape)} and k {tuple(k.shape)} differ "
            "in heads or head dim"
        )
    if q_pos.shape != (sq,) or k_pos.shape != (k.shape[1],):
        raise ValueError(
            f"flash partial needs q_pos ({sq},) and k_pos ({k.shape[1]},), got "
            f"{tuple(q_pos.shape)} and {tuple(k_pos.shape)}"
        )
    if not all(x.dtype.is_floating_point for x in (q, k, v)) or k.dtype != v.dtype:
        raise ValueError(
            f"flash partial needs float q and k, v of one dtype, got {q.dtype}, "
            f"{k.dtype}, {v.dtype}"
        )
    if any(x.device != q.device for x in (k, v, q_pos, k_pos)):
        raise ValueError("flash partial needs q, k, v and the positions on one device")


def flash_partial_cuda(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    q_pos: torch.Tensor, k_pos: torch.Tensor, causal: bool,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(o_unnorm, m, l)`` by the CUDA kernel (the plain version for CPU
    tensors). q, k and v of another float dtype than the kernel's (q fp32;
    k, v bf16 or fp32) are cast to fp32 first, the cast the kernel makes on
    load; a head dim that is not a multiple of :data:`D_CHUNK` is padded
    with zeros (:func:`pad_head_dim`), and o comes back at d columns (a
    view of the padded result)."""
    _check(q, k, v, q_pos, k_pos)
    if q.device.type == "cpu":
        return flash_partial_plain(q, k, v, q_pos, k_pos, causal=causal)
    h, sq, d = q.shape
    sk = k.shape[1]
    if sq == 0 or sk == 0 or d == 0:
        raise ValueError(
            f"the flash kernel takes sq, sk, d >= 1, got q {tuple(q.shape)} and "
            f"k {tuple(k.shape)}"
        )
    refuse_predicate("flash_partial_cuda")
    lib = _build.load_library()
    if q.device.type != "cuda":
        raise ValueError(f"flash_partial_cuda runs on CUDA or CPU tensors, got {q.device}")
    route = flash_route(k.dtype, d)
    d_pad = padded_head_dim(d)
    if k.dtype not in (torch.bfloat16, torch.float32):
        k, v = k.float(), v.float()
    q, k, v = (pad_head_dim(x, d_pad) for x in (q.float(), k, v))
    q_pos = q_pos.to(torch.int32).contiguous()
    k_pos = k_pos.to(torch.int32).contiguous()
    if any(x.data_ptr() % 16 for x in (q, k, v)):
        raise ValueError("the flash kernel needs 16-byte aligned q, k and v")
    o = torch.empty((h, sq, d_pad), dtype=torch.float32, device=q.device)
    m = torch.empty((h, sq), dtype=torch.float32, device=q.device)
    l = torch.empty((h, sq), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.matvec_flash_partial(
            ROUTE_CODES[route], _DTYPE_CODES[k.dtype], q.data_ptr(), k.data_ptr(),
            v.data_ptr(), q_pos.data_ptr(), k_pos.data_ptr(), o.data_ptr(),
            m.data_ptr(), l.data_ptr(), h, sq, sk, d_pad, int(causal), stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"flash partial kernel launch failed for q {tuple(q.shape)}, k "
            f"{tuple(k.shape)} {k.dtype} on {route}: "
            f"{lib.matvec_error_string(rc).decode()} (cudaError {rc})"
        )
    flash_partial_cuda.launches += 1
    flash_partial_cuda.route_launches[route] += 1
    return (o if d_pad == d else o[..., :d]), m, l


flash_partial_cuda.launches = 0  # type: ignore[attr-defined]
flash_partial_cuda.route_launches = Counter()  # type: ignore[attr-defined]


def launch_info(route: str, k_dtype: torch.dtype) -> dict:
    """The kernel ``flash_partial_cuda`` launches on ``route`` for k and v of
    ``k_dtype`` (bf16 or fp32), on the current card: registers per thread
    (the built kernel's), shared memory, threads and q rows per CTA."""
    out = (ctypes.c_int * 5)()
    lib = _build.load_library()
    rc = lib.matvec_flash_launch_info(ROUTE_CODES[route], _DTYPE_CODES[k_dtype], out)
    if rc != 0:
        raise RuntimeError(f"no flash launch for {route} with {k_dtype}: "
                           f"{lib.matvec_error_string(rc).decode()}")
    return {"registers": out[0], "dynamic_smem_bytes": out[1],
            "static_smem_bytes": out[2], "threads": out[3], "q_rows_per_cta": out[4]}
