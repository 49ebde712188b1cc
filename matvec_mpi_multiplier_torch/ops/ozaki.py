"""Ozaki-style split-matrix GEMV: fp64-grade accumulation, as one batched product.

The port's counterpart of the JAX package's ``ops/ozaki.py``. The
``compensated`` tier (``ops/compensated.py``) answers the reference's
fp64-end-to-end accumulation (``src/matr_utils.c:86-96``) with elementwise
work only; this tier moves the bulk of the arithmetic into one batched
matrix product and keeps a combine about ``b / s²`` times smaller than the
compensated tier's per-element pipeline:

1. **Block** the contraction axis into chunks of ``b = 256``.
2. **Slice** each operand into ``s`` addends of at most 8 significand bits,
   aligned to a shared per-(row, block) power-of-two scale:
   ``a_i = q_i * 2^(E-8(i+1))`` with ``|q_i| <= 2^8`` an integer. Each slice
   is exact in bfloat16 and in fp32.
3. **Multiply** all ``s × s`` slice pairs in one batched contraction with
   fp32 accumulation. Every term is an integer multiple of a common scale
   bounded by ``2^16``, so each partial sum of up to 256 terms is at most
   ``2^24`` of it: exact in fp32, in any order. Every pair, not an
   ``i + j`` cut-off: under deep cancellation a dropped low cross term would
   be the largest surviving contribution.
4. **Combine** the ``s² × (k/b)`` exact per-block partials per output row
   with the double-float tree of ``ops/compensated.py``: per block first
   (still in the block's prescaled space), then across blocks once the
   exponent-window shifts are undone.

The product's route: on the CPU the slices stay fp32 and ``torch.bmm``
accumulates in fp32, as the JAX package does off the TPU. On the card the
slices are bf16 (the tensor-core analog of the MXU path) and
``torch.bmm(..., out_dtype=torch.float32)`` returns the fp32 sums; a bf16
output would round every partial. Both are exact, so the card's result is
bitwise the CPU's.

The result is the exact dot of the sliced representations: the error is
the operand bits below ``2^(E_block - 8s)`` of each block max plus ~2^-48
of the running partial magnitudes from the double-float combine. ``ozaki``
(s = 4) captures every block whose elements lie within ``2^8`` of each
other exactly; ``ozaki6`` (s = 6) widens the window to 48 bits. fp64 inputs
take the plain fp64 product, which already is the reference's
accumulation. Blocks whose max lies outside ``[2^-79, 2^96)`` are exactly
prescaled into the window by a power of two, undone on the block dots, so
the whole finite fp32 range runs without inf or NaN.

A is worked through in row chunks (``compensated.row_chunks``): the slices
and their transposed copy are a few times one chunk, never four times A,
and the result is bitwise the unchunked one.
"""

from __future__ import annotations

from functools import partial

import torch
import torch.nn.functional as F

from . import compensated
from .compensated import _df_reduce_lastaxis, ldexp, pow2
from .gemv import acc_dtype, register_kernel

# Contraction block length. Exactness needs b * (2^8)^2 <= 2^24, i.e.
# b <= 256: every partial sum of slice products stays an integer multiple
# of the block scale below 2^24, hence exact in fp32.
_BLOCK = 256
# Bits per slice = bf16 significand.
_SLICE_BITS = 8

# Block exponents are confined to this window before slicing. The low end
# keeps every slice scale normal (smallest: 2^(EXP_LO - 8*6) = 2^-126 at
# s = 6); the high end keeps the q = ±2^8 carry slice (value 2^exp) finite
# in bf16/fp32. Blocks outside the window are exactly prescaled by the
# out-of-window shift, and the power-of-two correction is applied to the
# block partials instead.
_EXP_LO, _EXP_HI = -78, 96


def _split_blocked(v: torch.Tensor, n_slices: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Slice ``v`` (..., nb, b) into ``n_slices`` bf16-exact addends.

    Returns ``(slices, shift)``: (n_slices, ..., nb, b) in ``v``'s dtype
    with ``sum_i slices[i] ≈ v * 2^shift`` (exact up to the sub-``2^(E-8s)``
    residual), where ``E`` is the per-(..., nb) block max exponent and
    ``shift`` (..., nb, 1) int32 is the exponent-window prescale, zero for
    blocks whose max lies in ``[2^(_EXP_LO-1), 2^_EXP_HI)``. All-zero blocks
    give all-zero slices (frexp(0) = (0, 0))."""
    block_max = v.abs().amax(dim=-1, keepdim=True)
    _, exp = torch.frexp(block_max)  # block_max = f * 2^exp, f in [0.5, 1)
    shift = exp.clamp(_EXP_LO, _EXP_HI) - exp
    # A per-block power of two (always normal: |shift| is bounded), almost
    # always 2^0: an exact broadcast multiply, not ldexp over the array.
    v = v * pow2(shift, v.dtype)
    exp = exp + shift
    slices = []
    r = v
    for i in range(n_slices):
        scale = pow2(exp - _SLICE_BITS * (i + 1), v.dtype)
        q = torch.round(r / scale)  # integer, |q| <= 2^8 (incl. the carry case)
        s = q * scale  # exact: 8-bit int times a power of two
        slices.append(s)
        r = r - s  # exact: s matches r's leading bits
    return torch.stack(slices), shift


def _block_partials(lhs: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """The exact per-block products ``lhs @ rhs`` (batched over blocks) in
    fp32: on the card bf16 slices on the tensor cores with fp32 accumulation
    and output (``bmm`` has no ``out_dtype`` kernel on the CPU), elsewhere
    fp32 slices."""
    if lhs.is_cuda:
        return torch.bmm(lhs, rhs, out_dtype=torch.float32)
    return torch.bmm(lhs, rhs)


def _gemv_ozaki(a: torch.Tensor, x: torch.Tensor, n_slices: int) -> torch.Tensor:
    acc = acc_dtype(a.dtype)
    if acc == torch.float64:
        # The plain fp64 product already is the reference's accumulation
        # (src/matr_utils.c:86-96); slicing would only lose bits.
        return torch.matmul(a.to(acc), x.to(acc))
    f32 = torch.float32
    # The slices' dtype in the product: bf16 on the card, fp32 elsewhere
    # (both hold every slice exactly).
    slice_dtype = torch.bfloat16 if a.is_cuda else f32
    m, k = a.shape
    out = torch.zeros((m,), dtype=f32, device=a.device)
    if k == 0:
        return out
    pad = (-k) % _BLOCK
    nb = (k + pad) // _BLOCK
    x = F.pad(x.to(f32), (0, pad))  # exact zeros: identity terms
    x_s, x_shift = _split_blocked(x.reshape(nb, _BLOCK), n_slices)
    rhs = x_s.to(slice_dtype).permute(1, 2, 0)  # (nb, b, s)
    for rows in compensated.row_chunks(m, k * 4):
        mc = rows.stop - rows.start
        a_c = F.pad(a[rows].to(f32), (0, pad))
        a_s, a_shift = _split_blocked(a_c.reshape(mc, nb, _BLOCK), n_slices)
        del a_c
        # All s×s slice pairs in one batched contraction, block index as the
        # batch: each batch element is a (s·mc, b) @ (b, s) product.
        lhs = a_s.to(slice_dtype).permute(2, 0, 1, 3).reshape(nb, n_slices * mc, _BLOCK)
        del a_s
        partials = _block_partials(lhs, rhs)
        del lhs
        # (mc, nb, s·s): this block's s² exact partials, prescaled.
        s2 = (partials.reshape(nb, n_slices, mc, n_slices).permute(2, 0, 1, 3)
              .reshape(mc, nb, n_slices * n_slices))
        # Combine per block first, in the prescaled space (a single slice
        # partial may overshoot the range once corrected, the block total
        # does not), then undo the window shifts and combine across blocks.
        hi_b, lo_b = _df_reduce_lastaxis(s2, torch.zeros_like(s2))
        total_shift = a_shift[:, :, 0] + x_shift[:, 0][None, :]  # (mc, nb)
        hi_b = ldexp(hi_b, -total_shift)
        lo_b = ldexp(lo_b, -total_shift)
        hi, lo = _df_reduce_lastaxis(hi_b, lo_b)
        out[rows] = hi + lo
    return out


gemv_ozaki = partial(_gemv_ozaki, n_slices=4)
gemv_ozaki6 = partial(_gemv_ozaki, n_slices=6)

register_kernel("ozaki", gemv_ozaki)
register_kernel("ozaki6", gemv_ozaki6)
