"""Compensated (double-float) GEMV: fp64-grade accumulation without fp64.

The port's counterpart of the JAX package's ``ops/compensated.py``. The
reference computes in C ``double`` end-to-end (``multiply_std_rowwise``,
``src/matr_utils.c:86-96``); plain fp32 accumulation drifts by about
sqrt(k)·eps_f32 over a length-``k`` contraction and collapses under
cancellation. This tier tracks every product and every addition as an
unevaluated double-float pair ``(hi, lo)`` through error-free
transformations, about 2·24 bits of mantissa for fp32 data, with IEEE fp32
elementwise ops only:

* ``two_sum(a, b)``   — branch-free exact sum: ``a + b = s + err`` exactly;
* ``split(a)``        — Dekker's split of one fp32 into two 12-bit halves;
* ``two_prod(a, b)``  — exact product ``a*b = p + err`` from four half
  products (Dekker's split, not ``fma(a, b, -p)``: the validity filter
  below is calibrated on the split's behaviour at the ends of the exponent
  range);
* ``df_add``          — double-float addition with renormalization;
* a pairwise **tree reduction** over the contraction axis in double-float
  arithmetic, ``log2(k)`` elementwise levels; odd lengths pad with exact
  zeros.

Every function here is eager PyTorch, one operation per kernel, so each
``+``, ``-`` and ``*`` rounds once in IEEE order: nothing contracts a
multiply and an add into an FMA or reassociates a sum, which the
transformations need to stay exact. On normal-range fp32 data the results
are bitwise the JAX package's on the CPU. (XLA on the CPU flushes
subnormals to zero and PyTorch does not, so where inputs or partials reach
subnormals the two may differ; the port keeps IEEE's gradual underflow, as
the card does.)

Rows are independent (per-row products, a per-row tree), so the tier works
through A in row chunks of at most :data:`ROW_CHUNK_BYTES` of accumulator
data: the intermediates are a few times one chunk, never a few times A,
and the result is bitwise the unchunked one. The accuracy tiers of
``ops/ozaki.py`` and ``ops/ozaki_gemm.py`` chunk the same way.

Registered as ``"compensated"``: ``strategy.build(mesh,
kernel="compensated")`` runs every local partial in double-float and
returns the ``hi + lo`` sum in the accumulator dtype, so the cross-device
``psum`` adds values that are each correctly rounded to fp32. bf16/fp16
inputs are upcast to fp32 first (their values embed exactly); fp64 inputs
run the same algorithm in fp64 pairs.

:func:`ldexp` is the exact two-step ``x * 2**e`` the ozaki tiers rescale
with: ``torch.ldexp`` builds ``2**e`` in the operand's dtype, which flushes
to zero below 2^-149 and overflows above 2^127 in fp32, zeroing results
that are representable.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .gemv import acc_dtype, register_kernel

# Dekker split constant for radix-2 precision p: 2^ceil(p/2) + 1.
# fp32: p=24 -> 2^12 + 1; fp64: p=53 -> 2^27 + 1.
_SPLITTERS = {torch.float32: 4097.0, torch.float64: 134217729.0}

# Bytes of one (rows, k) accumulator-dtype array per row chunk of the
# accuracy tiers (this module, ops/ozaki.py, ops/ozaki_gemm.py): each tier's
# scratch is a small multiple of it (ozaki6's, the most, about 17 of it).
# At 65536² fp32 a chunk is 1024 rows. Read at call time: tests shrink it
# to a few rows.
ROW_CHUNK_BYTES = 1 << 28

# (mantissa bits, exponent bias) of the float dtypes pow2 builds by bits.
_FLOAT_BITS = {torch.float32: (23, 127, torch.int32),
               torch.float64: (52, 1023, torch.int64)}


def row_chunks(m: int, row_bytes: int) -> list[slice]:
    """Row slices of an (m, ·) operand whose rows take ``row_bytes`` each,
    every slice at most :data:`ROW_CHUNK_BYTES` (at least one row)."""
    rows = max(1, ROW_CHUNK_BYTES // max(1, row_bytes))
    return [slice(i, min(i + rows, m)) for i in range(0, m, rows)]


def pow2(e: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``2**e`` in ``dtype`` for integer ``e`` in the dtype's normal range,
    built from its bits: exact, where ``2.0 ** e`` goes through ``exp2``."""
    mant, bias, itype = _FLOAT_BITS[dtype]
    return ((e.to(itype) + bias) << mant).view(dtype)


def ldexp(x: torch.Tensor, e) -> torch.Tensor:
    """``x * 2**e``, exact even where ``2**e`` itself is not a normal number.

    The JAX package's ``utils/compat.py::ldexp``: the first factor's
    exponent is clamped to the normal range, the rest applied by a second
    factor, so each factor is an exact normal power of two and only the
    last multiply rounds (exactly, or into a subnormal). A third step takes
    what the second could not; any exponent the tiers produce fits in the
    three."""
    mant, bias, _ = _FLOAT_BITS[x.dtype]
    lo, hi = 1 - bias, bias
    rest = torch.as_tensor(e, device=x.device)  # fp64-ok: e is an integer exponent (a Python int or an integer tensor), never a float array
    out = x
    for _ in range(3):
        step = rest.clamp(lo, hi)
        out = out * pow2(step, x.dtype)
        rest = rest - step
    return out


def two_sum(a: torch.Tensor, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Knuth's branch-free TwoSum: returns (s, err) with a + b == s + err."""
    s = a + b
    bp = s - a
    err = (a - (s - bp)) + (b - bp)
    return s, err


def fast_two_sum(a: torch.Tensor, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Dekker's FastTwoSum, valid when |a| >= |b| (used after df renorm)."""
    s = a + b
    err = b - (s - a)
    return s, err


def split(a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Dekker split: a == hi + lo with hi, lo each fitting in half a mantissa."""
    c = a * _SPLITTERS[a.dtype]
    hi = c - (c - a)
    return hi, a - hi


def two_prod(a: torch.Tensor, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact product: returns (p, err) with a * b == p + err.

    Dekker's split is exact only in the interior of the exponent range; at
    both ends the computed ``err`` is garbage, and those lanes degrade to
    (p, 0), plain-product accuracy: above ~2^emax/splitter (fp32: ~8.3e34)
    the split overflows and ``err`` is NaN/inf while ``p`` is finite; where
    the half products land in subnormals the residual no longer cancels. A
    genuine rounding error satisfies |err| <= eps·|p|, so any ``err`` larger
    than 16·eps·|p| (or non-finite) is zeroed. Overflow or NaN in ``p``
    itself propagates."""
    p = a * b
    ah, al = split(a)
    bh, bl = split(b)
    err = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    tol = 16.0 * torch.finfo(p.dtype).eps
    valid = torch.isfinite(err) & (err.abs() <= p.abs() * tol)
    err = torch.where(valid, err, torch.zeros_like(err))
    return p, err


def df_add(hi1: torch.Tensor, lo1: torch.Tensor, hi2: torch.Tensor,
           lo2: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Double-float addition (Joldes/Muller 'accurate' variant): adds two
    (hi, lo) pairs, renormalizing so |lo| <= ulp(hi)/2."""
    s, e = two_sum(hi1, hi2)
    t, f = two_sum(lo1, lo2)
    e = e + t
    s, e = fast_two_sum(s, e)
    e = e + f
    return fast_two_sum(s, e)


def _df_reduce_lastaxis(hi: torch.Tensor, lo: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Pairwise tree-sum of (hi, lo) pairs along the last axis: log2(k)
    levels of elementwise df_add; odd lengths are padded with exact zeros
    (the identity of double-float addition)."""
    while hi.shape[-1] > 1:
        if hi.shape[-1] % 2:
            hi = F.pad(hi, (0, 1))
            lo = F.pad(lo, (0, 1))
        hi, lo = df_add(hi[..., 0::2], lo[..., 0::2], hi[..., 1::2], lo[..., 1::2])
    return hi[..., 0], lo[..., 0]


def gemv_compensated(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Double-float GEMV: y_i = sum_j a_ij * x_j with EFT products and a
    double-float tree reduction, row chunk by row chunk. Returns the
    accumulator dtype (fp32 for bf16/fp16/fp32 storage, fp64 for fp64), per
    the kernel contract (``ops/gemv.py``)."""
    acc = acc_dtype(a.dtype)
    m, k = a.shape
    x = x.to(acc)
    out = torch.zeros((m,), dtype=acc, device=a.device)
    if k == 0:
        return out  # empty contraction: zeros, as the other tiers give
    for rows in row_chunks(m, k * out.element_size()):
        p, e = two_prod(a[rows].to(acc), x[None, :])
        hi, lo = _df_reduce_lastaxis(p, e)
        # hi is the double-float sum correctly rounded to `acc`; adding lo
        # (|lo| <= ulp(hi)/2) keeps it, as the JAX package writes it.
        out[rows] = hi + lo
    return out


register_kernel("compensated", gemv_compensated)
