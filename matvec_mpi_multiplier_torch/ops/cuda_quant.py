"""The hand-written CUDA block-scaled GEMV (``csrc/quant_gemv.cu``) and its
plain version: the ``cuda`` tier for quantized storage.

Replaces the JAX package's Pallas kernel
(``matvec_mpi_multiplier_tpu/ops/pallas_quant.py::_quant_gemv_kernel``).
One call computes ``deq(A) @ x`` over an int8 / int8c / fp8
:class:`~.quantize.QuantizedMatrix` for ``x`` of shape ``(k,)`` or
``(k, n)``, converting each payload element in registers: the dequantized
``A`` never exists in device memory. It is bound by the payload's bytes.
Its routes (:func:`quant_route` plans them from the format, x's dtype, k,
the block and the payload's alignment, never from x's values):

* ``wgmma`` (bf16 or fp16 x) and ``wgmma_split`` (fp32 x, split by a
  pre-pass into :data:`SPLIT_PARTS` bf16 parts): the payload streams
  through TMA, is converted exactly to the 16-bit operand type and meets
  x on the tensor cores, A from registers. Each quantization block's
  partial is fresh in fp32 and scaled once per row and block, summed in
  block order, int8c's levels apart and then added: the JAX package's
  association (``ops/quantize.py::matvec_quantized``). int8's vector face
  (n = 1) sums the same partials in fp32 FMA on the CUDA cores, x exact,
  where it measured faster.
* ``fma``: fp64 x, and any shape TMA or ``wgmma`` cannot take (``k % 16``,
  ``block % 16``, a payload not 16-byte aligned): FMA on the CUDA cores,
  each element dequantized as fl(s1·q1) (+ fl(s2·q2)).

The source says what bounds each route and how.

:func:`quant_gemv_cuda` launches the planned route for CUDA tensors, or
raises: a missing ``nvcc``, a failed build or a refused launch is an error,
never a quiet switch to another route or tier. For tensors on the CPU, and
only there, it computes :func:`quant_gemv_plain`.
``quant_gemv_cuda.launches`` counts its calls on the card (nothing else adds
to it; a tensor-core call is two kernel launches, the pre-pass and the
GEMV, but for int8's vector face), and ``quant_gemv_cuda.route_launches``
the same calls by route.
"""

from __future__ import annotations

from collections import Counter

import torch

from . import _build
from .graphs import refuse_predicate
from .cuda_gemv import _DTYPE_CODES, PLAIN_CHUNK_BYTES
from .gemv import acc_dtype
from .quantize import QuantizedMatrix, register_storage_kernel

# The C entry's format codes (csrc/quant_gemv.cu::matvec_quant_gemv).
_FORMAT_CODES = {"int8": 0, "int8c": 1, "fp8": 2}
# Route codes of ``matvec_quant_gemv`` (``csrc/quant_gemv.cu``'s ``Route``).
ROUTE_CODES = {"wgmma": 0, "wgmma_split": 1, "fma": 2}
# bf16 parts of fp32 x on wgmma_split: x = x0 + x1 + r, |r| <= 2^-16 |x|,
# holds 1e-5 of |deq(A)|·|x| at every check shape (the rounding errors'
# signs differ: at most 0.1 of the bar); one part misses it
# (tests/test_torch_quant_route.py).
SPLIT_PARTS = 2
# 16-bit parts of x a route's pre-pass writes (its scratch).
ROUTE_PARTS = {"wgmma": 1, "wgmma_split": SPLIT_PARTS, "fma": 0}
# k and the block must be multiples of wgmma's depth (16 values), and the
# payload's base 16-byte aligned, for TMA and wgmma; TMA's coordinates are
# 32-bit.
TC_K = 16
TC_MAX_DIM = 2**31 - 1


def quant_route(fmt: str, dtype: torch.dtype, m: int, k: int, n: int, block: int,
                aligned: bool) -> str:
    """The route :func:`quant_gemv_cuda` takes for a ``fmt`` payload of
    shape (m, k) in blocks of ``block``, 16-byte aligned or not, against x
    of ``dtype`` with ``n`` columns: ``wgmma`` for bf16 and fp16 x,
    ``wgmma_split`` for fp32, ``fma`` for fp64 and for a shape the tensor
    cores cannot take (k or the block not a multiple of 16, an unaligned
    payload, m or k past 2^31 - 1). Planned from these alone, never after
    a failure; m and n do not change it (the kernel sets its tile by
    them)."""
    if fmt not in _FORMAT_CODES:
        raise ValueError(f"quant_route takes int8, int8c or fp8, got {fmt!r}")
    if dtype not in _DTYPE_CODES:
        raise ValueError(f"quant_route takes bf16/fp16/fp32/fp64 x, got {dtype}")
    if m < 1 or n < 1 or k < 1 or block < 1 or k % block:
        raise ValueError(f"no route for a ({m}, {k}) payload in blocks of {block}, n = {n}")
    if (dtype == torch.float64 or k % TC_K or block % TC_K or not aligned
            or max(m, k) > TC_MAX_DIM):
        return "fma"
    return "wgmma_split" if dtype == torch.float32 else "wgmma"


def payload_aligned(qa: QuantizedMatrix) -> bool:
    """Whether every payload level's base is 16-byte aligned (TMA's rule)."""
    return all(q.data_ptr() % 16 == 0 for q in (qa.q, qa.q2) if q is not None)


def route_scratch(route: str, k: int, n: int, device) -> torch.Tensor | None:
    """The pre-pass's scratch for x's parts on ``route``: (n, parts, k)
    16-bit values (unused by int8's vector face, which reads x itself), or
    None on ``fma``."""
    parts = ROUTE_PARTS[route]
    if not parts:
        return None
    return torch.empty((n, parts, k), dtype=torch.int16, device=device)


def _dequantized_rows(qa: QuantizedMatrix, rows: slice, acc: torch.dtype) -> torch.Tensor:
    """Rows of deq(A) in ``acc``: fl(s1*q1) (+ fl(s2*q2)), each product and
    the sum rounded once, as the kernel computes them in registers."""
    q = qa.q[rows]
    m, k = q.shape
    nb = k // qa.block

    def level(q, scales):
        return (q.to(acc).view(m, nb, qa.block) * scales.to(acc)[:, :, None]).view(m, k)

    out = level(q, qa.scales[rows])
    if qa.q2 is not None:
        out = out + level(qa.q2[rows], qa.scales2[rows])
    return out


def quant_gemv_plain(qa: QuantizedMatrix, x: torch.Tensor) -> torch.Tensor:
    """``deq(A) @ x`` in the accumulator dtype, in row chunks on ``qa``'s
    device: it dequantizes a chunk of rows at a time, never a full-width
    ``A``. Rank-agnostic in ``x``."""
    acc = acc_dtype(qa.dtype)
    m, k = qa.shape
    xa = x.to(acc).reshape(k, -1)
    y = torch.empty((m, xa.shape[1]), dtype=acc, device=qa.device)
    rows = max(1, PLAIN_CHUNK_BYTES // max(1, k * acc.itemsize))
    for i in range(0, m, rows):
        sl = slice(i, min(m, i + rows))
        y[sl] = _dequantized_rows(qa, sl, acc) @ xa
    return y.reshape((m, *x.shape[1:]))


def _check(qa: QuantizedMatrix, x: torch.Tensor) -> None:
    if not isinstance(qa, QuantizedMatrix):
        raise ValueError(f"quant_gemv needs a QuantizedMatrix, got {type(qa).__name__}")
    m, k = qa.shape
    if x.dim() not in (1, 2) or x.shape[0] != k:
        raise ValueError(
            f"quant_gemv needs x of shape ({k},) or ({k}, n) for a ({m}, {k}) "
            f"payload, got {tuple(x.shape)}"
        )
    if x.dtype != qa.dtype or x.dtype not in _DTYPE_CODES:
        raise ValueError(
            f"quant_gemv needs x in the payload's logical dtype among "
            f"bf16/fp16/fp32/fp64, got {x.dtype} for {qa.dtype}"
        )
    if qa.fmt not in _FORMAT_CODES or (qa.fmt == "int8c") != (qa.q2 is not None):
        raise ValueError(f"quant_gemv takes int8, int8c or fp8 storage, got {qa.fmt!r}")
    if k % qa.block or tuple(qa.scales.shape) != (m, k // qa.block):
        raise ValueError(
            f"scales {tuple(qa.scales.shape)} do not match a ({m}, {k}) payload "
            f"in blocks of {qa.block}"
        )
    leaves = [leaf for leaf in qa.leaves if leaf is not None]
    if any(leaf.device != x.device for leaf in leaves):
        raise ValueError(f"the payload is on {qa.device} but x is on {x.device}")
    if not all(t.is_contiguous() for t in (*leaves, x)):
        raise ValueError("quant_gemv needs contiguous payload, scales and x")


def quant_gemv_cuda(qa: QuantizedMatrix, x: torch.Tensor) -> torch.Tensor:
    """``deq(A) @ x`` by the CUDA kernel on the route :func:`quant_route`
    plans (plain version for CPU tensors)."""
    _check(qa, x)
    if x.device.type == "cpu":
        return quant_gemv_plain(qa, x)
    refuse_predicate("quant_gemv_cuda")
    lib = _build.load_library()
    if x.device.type != "cuda":
        raise ValueError(f"quant_gemv_cuda runs on CUDA or CPU tensors, got {x.device}")
    m, k = qa.shape
    n = 1 if x.dim() == 1 else x.shape[1]
    y = torch.empty((m, *x.shape[1:]), dtype=acc_dtype(qa.dtype), device=x.device)
    if m == 0 or n == 0:
        return y
    route = quant_route(qa.fmt, x.dtype, m, k, n, qa.block, payload_aligned(qa))
    xs = route_scratch(route, k, n, x.device)
    q2 = None if qa.q2 is None else qa.q2.data_ptr()
    s2 = None if qa.scales2 is None else qa.scales2.data_ptr()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.matvec_quant_gemv(
            ROUTE_CODES[route], _FORMAT_CODES[qa.fmt], _DTYPE_CODES[qa.dtype],
            qa.q.data_ptr(), qa.scales.data_ptr(), q2, s2, x.data_ptr(), y.data_ptr(),
            None if xs is None else xs.data_ptr(), m, k, n, qa.block, stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"quant_gemv kernel launch failed for a {qa.fmt} ({m}, {k}) payload, "
            f"x {tuple(x.shape)} {x.dtype} on {route}: "
            f"{lib.matvec_error_string(rc).decode()} (cudaError {rc})"
        )
    quant_gemv_cuda.launches += 1
    quant_gemv_cuda.route_launches[route] += 1
    return y


quant_gemv_cuda.launches = 0  # type: ignore[attr-defined]
quant_gemv_cuda.route_launches = Counter()  # type: ignore[attr-defined]

register_storage_kernel("cuda", quant_gemv_cuda)
