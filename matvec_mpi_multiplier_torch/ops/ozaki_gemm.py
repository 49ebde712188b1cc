"""Ozaki-style split-matrix GEMM: fp64-parity accumulation on int8 products.

The port's counterpart of the JAX package's ``ops/ozaki_gemm.py``: the
rank-2 face of ``ops/ozaki.py``, rebuilt around integer products, which
change the exactness budget:

* Operands are sliced along the contraction axis into ``s`` addends of at
  most **7 bits** against a shared per-row (A) / per-column (B)
  power-of-two scale, rounded to nearest: each slice is an int8 array
  (``|q| <= 127``) and ``a ≈ sum_i q_i * 2^(E - 7(i+1))`` down to
  ``2^(E - 7s)`` of the row max.
* Each slice-pair product is one ``int8 × int8 → int32`` product
  (``torch._int_mm``): integer arithmetic, exact as long as
  ``k * 127² < 2^31``, which holds through ``k = 2^17``; longer contractions
  are cut into chunks of :data:`_I8_BLOCK` whose partials fold like the rest.
* Each int32 partial splits exactly into two fp32 halves (high and low 16
  bits), which are folded per pair in integer space, rescaled by the
  original row/column exponents (``2^(ea + eb - 7(i+j+2))``; the window
  prescale cancels algebraically) and folded into a running double-float
  accumulator.

``torch._int_mm`` wants, on the card, more than 16 rows of A, and a
contraction and a B width that are multiples of 8 (a row-major A and a
column-major B); :func:`_int8_matmul` zero-pads to that, which is exact,
and does the same on the CPU so both run one path. ``torch.matmul`` on int8
tensors would keep int8 and wrap.

Accuracy (finite fp32 inputs): bits below ``2^(E_row - 7s)`` of each
row/column max are rounded away; everything kept is exact up to the
double-float combine (~2^-48 of the contraction magnitude). ``ozaki``
(s = 4) gives 28-bit windows, ``ozaki6`` 42-bit ones. Rows/columns whose max
lies below ``2^-78`` are exactly prescaled into range. fp64 inputs take the
plain fp64 product.

The GEMV registry gets the same machinery as ``ozaki_i8`` (``x`` as a
one-column B, padded to 8). A is worked through in row chunks
(``compensated.row_chunks``), each bitwise what the whole would give.
"""

from __future__ import annotations

from functools import partial

import torch
import torch.nn.functional as F

from . import compensated
from .compensated import df_add, ldexp, pow2
from .gemm_kernels import register_gemm_kernel
from .gemv import acc_dtype, register_kernel

_I8_BITS = 7
# Longest exactly-accumulable contraction: k * 127^2 < 2^31 allows 2^17;
# one power of two of margin. Read at call time (tests shrink it).
_I8_BLOCK = 1 << 16
# Per-line exponent window (as ops/ozaki.py's _EXP_LO: keeps every slice
# scale a normal fp32 number for s up to 6).
_EXP_LO = -78

# What torch._int_mm takes on the card: A with more than _INT_MM_MIN_ROWS
# rows, a contraction and a B width that are multiples of _INT_MM_ALIGN.
_INT_MM_MIN_ROWS = 16
_INT_MM_ALIGN = 8


def _split_int8(v: torch.Tensor, n_slices: int, axis: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Slice ``v`` (fp32) into int8 addends against per-line scales.

    ``axis`` is the contraction axis (reduced for the line max: scales are
    per row of A / per column of B). Returns ``(slices, exp)``: ``slices``
    (n_slices, *v.shape) int8 and ``exp`` the ORIGINAL line max exponents
    (keepdims), with ``v ≈ sum_i slices[i] * 2^(exp - 7(i+1))`` down to
    ``2^(exp - 7s)`` (window-prescaled lines cancel the shift
    algebraically). All-zero lines give zero slices."""
    line_max = v.abs().amax(dim=axis, keepdim=True)
    _, exp = torch.frexp(line_max)  # line_max = f * 2^exp, f in [0.5, 1)
    shift = exp.clamp(min=_EXP_LO) - exp  # >= 0; 0 for normal data
    v = v * pow2(shift, v.dtype)
    exp_w = exp + shift
    slices = []
    r = v
    for i in range(n_slices):
        scale_exp = exp_w - _I8_BITS * (i + 1)
        # Round to NEAREST (truncation is signed-biased and accumulates
        # linearly over k); a carry to ±128 is clipped to ±127, and its
        # residual (< scale) is absorbed by the next slice.
        q = torch.round(r * pow2(-scale_exp, r.dtype)).clamp(-127.0, 127.0)
        slices.append(q.to(torch.int8))
        r = r - q * pow2(scale_exp, r.dtype)
    return torch.stack(slices), exp


def _int32_halves(p: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Split int32 into exactly representable fp32 (high, low) 16-bit parts."""
    hi = p >> 16
    lo = p - (hi << 16)
    return hi.to(torch.float32) * 65536.0, lo.to(torch.float32)


def _int8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` for int8 (m, k) and (k, n), exactly, as int32: ``torch._int_mm``
    on operands zero-padded to the shapes it takes on the card, B handed
    column-major."""
    m, k = a.shape
    n = b.shape[1]
    pad_m = max(0, _INT_MM_MIN_ROWS + 1 - m)
    pad_k = (-k) % _INT_MM_ALIGN
    pad_n = (-n) % _INT_MM_ALIGN
    if pad_m or pad_k:
        a = F.pad(a, (0, pad_k, 0, pad_m))
    b = F.pad(b, (0, pad_n, 0, pad_k)).t().contiguous().t()
    return torch._int_mm(a.contiguous(), b)[:m, :n]


def _matmul_ozaki_i8(a: torch.Tensor, b: torch.Tensor, n_slices: int) -> torch.Tensor:
    acc = acc_dtype(torch.promote_types(a.dtype, b.dtype))
    if acc == torch.float64:
        # The plain fp64 product IS the reference's accumulation.
        return torch.matmul(a.to(acc), b.to(acc))
    f32 = torch.float32
    x_vector = b.dim() == 1
    if x_vector:
        b = b[:, None]
    b = b.to(f32)
    m, k = a.shape
    n = b.shape[1]
    c = torch.zeros((m, n), dtype=f32, device=a.device)
    if k == 0:
        return c[:, 0] if x_vector else c
    b_s, eb = _split_int8(b, n_slices, axis=0)  # (s, k, n), (1, n)
    starts = range(0, k, _I8_BLOCK)
    for rows in compensated.row_chunks(m, k * 4):
        a_s, ea = _split_int8(a[rows].to(f32), n_slices, axis=1)  # (s, mc, k), (mc, 1)
        # A running double-float accumulator per output element, over the
        # slice pairs and k-chunks: each product is one exact int32 matmul,
        # split into fp32 halves, rescaled by the pair's power of two, folded.
        hi_acc = torch.zeros((a_s.shape[1], n), dtype=f32, device=a.device)
        lo_acc = torch.zeros_like(hi_acc)
        for i in range(n_slices):
            for j in range(n_slices):
                e_pair = ea + eb - _I8_BITS * (i + j + 2)  # (mc, n) by broadcast
                # Chunk partials fold in unscaled integer space first: the
                # cross-chunk cancellation happens before the pair's
                # rescale, so a transiently huge chunk partial cannot
                # overflow where the full-k pair value is representable.
                hi_p = torch.zeros_like(hi_acc)
                lo_p = torch.zeros_like(hi_acc)
                for s0 in starts:
                    sl = slice(s0, min(s0 + _I8_BLOCK, k))
                    p_hi, p_lo = _int32_halves(_int8_matmul(a_s[i][:, sl], b_s[j][sl, :]))
                    hi_p, lo_p = df_add(hi_p, lo_p, p_hi, p_lo)
                # ldexp: e_pair reaches below -126 for deeply subnormal
                # lines, where a plain 2^e factor would flush to zero.
                hi_acc, lo_acc = df_add(hi_acc, lo_acc, ldexp(hi_p, e_pair),
                                        ldexp(lo_p, e_pair))
        c[rows] = hi_acc + lo_acc
    return c[:, 0] if x_vector else c


matmul_ozaki = partial(_matmul_ozaki_i8, n_slices=4)
matmul_ozaki6 = partial(_matmul_ozaki_i8, n_slices=6)

register_gemm_kernel("ozaki", matmul_ozaki)
register_gemm_kernel("ozaki6", matmul_ozaki6)
# The GEMV face of the int8 formulation (b arrives as a vector).
register_kernel("ozaki_i8", matmul_ozaki)
