"""Quantized-storage formats: per-block-scaled low-precision resident ``A``.

The port's counterpart of the JAX package's ``ops/quantize.py``. Distributed
matvec is bound by the HBM bytes of ``A``, so ``A`` may be quantized ONCE at
residency into a low-bit payload plus per-(row, k-block) float32 scales, and
every later matvec reads the payload instead of ``A``. No kernel ever holds
a dequantized full-width ``A``: the hand-written kernel
(``csrc/quant_gemv.cu``) converts each payload element in registers, and the
scan tier here upcasts one (m, block) tile at a time. Both sum one partial
per k-block, scaled once per row and block, in block order, and int8c's
levels apart before adding them (the kernel's ``fma`` route, for fp64 x and
shapes the tensor cores cannot take, scales each element instead).

Formats (:data:`STORAGE_FORMATS`):

* ``int8``  — symmetric round-to-nearest int8 against ``s = max|a_block| /
  127``. Payload ~0.25x the fp32 bytes (+ scales, ``4/block`` per element).
* ``int8c`` — ``int8`` plus the residual ``A - Q(A)`` (computed in float64,
  so it is the true quantization error) quantized again into a second int8
  operand with its own scales. ~0.5x the fp32 bytes.
* ``fp8``   — ``float8_e4m3fn`` against ``s = max|a_block| / 448``.

The quantizer runs in torch on ``A``'s own device, in row chunks widened to
float64 (no full-width float64 copy is ever held), and reproduces the JAX
package's numpy quantizer operation by operation, so payloads and scales are
bitwise the same (``tests/test_torch_quantize.py``). A fused quantizer kernel
would break that: it would turn the int8c residual's ``q*s`` then ``-`` into
one FMA.

``native`` (or None) everywhere means the unquantized path.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..utils.convert import from_numpy
from ..utils.errors import ConfigError
from .gemv import acc_dtype

# The storage formats beside "native". Order is the documentation order.
STORAGE_FORMATS = ("int8", "int8c", "fp8")
NATIVE = "native"

# Default per-(row, block) group length along the contraction axis, before
# the divisibility clamp (default_block): scale planes add 4/128 = 3% to the
# payload.
DEFAULT_BLOCK = 128

_INT8_MAX = 127.0
_FP8_MAX = 448.0  # float8_e4m3fn finite max

# The error budget, as the JAX package states it. Per-element representation
# error relative to the element's own BLOCK max:
#   int8  : |a - s*q|           <= s/2       = amax/(2*127)
#   int8c : |a - s1*q1 - s2*q2| <= s2/2     <= amax/(2*127^2)
# The matvec budget composes the element bound through the contraction:
# |dy_i| <= k * eps * amax_i * max|x|. FP32_LEVEL_RELERR is the normwise seat
# the compensated format must clear on well-scaled data.
INT8_EPS = 1.0 / (2.0 * _INT8_MAX)
INT8C_EPS = 1.0 / (2.0 * _INT8_MAX * _INT8_MAX)
FP32_LEVEL_RELERR = 1e-4

# Rows of A widened to float64 at a time by the quantizer (and by the plain
# version of the kernel): 256 MiB of float64 per chunk.
CHUNK_BYTES = 256 << 20


def normalize_storage(fmt: str | None) -> str:
    """Canonical storage-format name: None and "native" both mean the
    unquantized path; anything else must be a known format."""
    if fmt is None or fmt == NATIVE:
        return NATIVE
    if fmt not in STORAGE_FORMATS:
        raise ConfigError(
            f"unknown dtype_storage {fmt!r}; available: "
            f"{(NATIVE,) + STORAGE_FORMATS} (or 'auto' where a tuner-backed "
            "caller resolves it)"
        )
    return fmt


def fp8_supported() -> bool:
    """True when this torch build has ``float8_e4m3fn``."""
    return hasattr(torch, "float8_e4m3fn")


def default_block(k: int, contraction_shards: int = 1) -> int:
    """The per-(row, block) group length for a (., k) matrix whose
    contraction axis is sharded ``contraction_shards`` ways.

    Largest power of two <= :data:`DEFAULT_BLOCK` such that every shard holds
    a whole number of blocks (the scales then shard with exactly ``A``'s
    spec) and at least TWO of them; a single block per shard only when the
    local width admits nothing smaller.
    """
    if k <= 0 or contraction_shards <= 0 or k % contraction_shards:
        raise ConfigError(
            f"quantized storage needs k divisible by the contraction "
            f"shards; got k={k}, shards={contraction_shards}"
        )
    k_local = k // contraction_shards
    block = DEFAULT_BLOCK
    while block > 1:
        if k_local % block == 0 and k_local // block >= 2:
            return block
        block //= 2
    return 1


class QuantizedMatrix:
    """One quantized resident ``A``: payload + per-block scales (+ the
    compensated-correction pair for int8c).

    ``q``       — (m, k) payload tensor (int8 or float8_e4m3fn).
    ``scales``  — (m, k/block) float32 per-(row, block) scales.
    ``q2``/``scales2`` — the quantized residual operand (int8c) or None.

    ``shape``/``ndim``/``dtype`` present the LOGICAL matrix, so the strategy
    bodies (``validate``, ``kernel(a, x).to(a.dtype)``) run unchanged;
    ``dtype`` is the original operand's ``torch.dtype``.
    """

    def __init__(self, q, scales, q2=None, scales2=None, *, fmt, block,
                 out_dtype):
        self.q = q
        self.scales = scales
        self.q2 = q2
        self.scales2 = scales2
        self.fmt = fmt
        self.block = int(block)
        self.out_dtype = out_dtype

    @property
    def leaves(self) -> tuple:
        """``(q, scales, q2, scales2)``, None where absent."""
        return self.q, self.scales, self.q2, self.scales2

    def map(self, fn: Callable) -> "QuantizedMatrix":
        """The same format with ``fn`` applied to every present leaf."""
        return QuantizedMatrix(
            *(None if leaf is None else fn(leaf) for leaf in self.leaves),
            fmt=self.fmt, block=self.block, out_dtype=self.out_dtype,
        )

    def to(self, device) -> "QuantizedMatrix":
        return self.map(lambda leaf: leaf.to(device))

    @property
    def device(self) -> torch.device:
        return self.q.device

    @property
    def shape(self) -> tuple[int, int]:
        return tuple(self.q.shape)

    @property
    def ndim(self) -> int:
        return 2

    @property
    def dtype(self) -> torch.dtype:
        return self.out_dtype

    @property
    def nbytes(self) -> int:
        """Resident payload bytes: payload and scales (both levels)."""
        return sum(leaf.numel() * leaf.element_size()
                   for leaf in self.leaves if leaf is not None)


def _block_quantize_int8(a64: torch.Tensor, block: int, residual: bool = True):
    """One int8 level over a (rows, k) float64 chunk, grouped (rows, nb,
    block). Returns (q int8 (rows, k), scales f32 (rows, nb), the float64
    residual (rows, k) or None)."""
    m, k = a64.shape
    grouped = a64.view(m, k // block, block)
    scales = (grouped.abs().amax(dim=2) / _INT8_MAX).to(torch.float32)
    # Zero blocks: scale 0 with an all-zero payload round-trips exactly;
    # divide by a stand-in 1 to keep the quotient finite.
    safe = torch.where(scales == 0, 1.0, scales).to(torch.float64)[:, :, None]
    # torch.round rounds half to even, as np.rint does.
    q = (grouped / safe).round_().clamp_(-_INT8_MAX, _INT8_MAX).to(torch.int8)
    if not residual:
        return q.view(m, k), scales, None
    # Two separate operations (q*s is exact in float64), as numpy does them.
    rest = grouped - q.to(torch.float64) * safe
    return q.view(m, k), scales, rest.view(m, k)


def quantize_matrix(
    a, fmt: str, block: int | None = None, contraction_shards: int = 1,
) -> QuantizedMatrix:
    """Quantize an (m, k) matrix into ``fmt`` storage on ``a``'s device —
    the once-at-residency step. ``a`` is a tensor on any device (or a host
    array). ``block`` defaults to :func:`default_block` for the given
    contraction sharding, so the scale plane shards wherever ``A`` does.
    """
    fmt = normalize_storage(fmt)
    if fmt == NATIVE:
        raise ConfigError("quantize_matrix needs a quantized format; "
                          "'native' storage is the unquantized path")
    if not isinstance(a, torch.Tensor):
        a = from_numpy(np.asarray(a), "cpu")
    if a.dim() != 2:
        raise ConfigError(f"A must be rank 2, got shape {tuple(a.shape)}")
    if not a.is_floating_point():
        raise ConfigError(f"quantized storage needs float A, got {a.dtype}")
    m, k = a.shape
    if block is None:
        block = default_block(k, contraction_shards)
    if k == 0 or block <= 0 or k % block:
        raise ConfigError(
            f"block {block} must evenly divide k={k} (and k > 0)"
        )
    if fmt == "fp8" and not fp8_supported():
        raise ConfigError(
            "dtype_storage='fp8' needs torch.float8_e4m3fn, which this torch "
            "build does not provide; use 'int8'/'int8c' or 'native'"
        )
    nb = k // block
    dev = a.device
    payload = torch.float8_e4m3fn if fmt == "fp8" else torch.int8
    q = torch.empty((m, k), dtype=payload, device=dev)
    scales = torch.empty((m, nb), dtype=torch.float32, device=dev)
    q2 = scales2 = None
    if fmt == "int8c":
        q2 = torch.empty((m, k), dtype=torch.int8, device=dev)
        scales2 = torch.empty((m, nb), dtype=torch.float32, device=dev)
    rows = max(1, CHUNK_BYTES // (k * 8))
    for i in range(0, m, rows):
        sl = slice(i, min(m, i + rows))
        a64 = a[sl].to(torch.float64)
        if fmt == "fp8":
            grouped = a64.view(-1, nb, block)
            s = (grouped.abs().amax(dim=2) / _FP8_MAX).to(torch.float32)
            safe = torch.where(s == 0, 1.0, s).to(torch.float64)[:, :, None]
            q[sl] = (grouped / safe).to(torch.float32).to(payload).view(-1, k)
            scales[sl] = s
            continue
        q[sl], scales[sl], rest = _block_quantize_int8(
            a64, block, residual=fmt == "int8c")
        if fmt == "int8c":
            q2[sl], scales2[sl], _ = _block_quantize_int8(rest, block, residual=False)
    return QuantizedMatrix(q, scales, q2, scales2, fmt=fmt, block=block,
                           out_dtype=a.dtype)


def dequantize(qa: QuantizedMatrix) -> torch.Tensor:
    """The full dequantized matrix in ``qa``'s dtype, computed in float32 as
    the JAX package's ``dequantize`` does — a TEST helper only: nothing on a
    serving or timing path calls it."""
    m, k = qa.shape
    nb = k // qa.block

    def level(q, scales):
        grouped = q.to(torch.float32).view(m, nb, qa.block)
        return (grouped * scales.to(torch.float32)[:, :, None]).view(m, k)

    out = level(qa.q, qa.scales)
    if qa.q2 is not None:
        out = out + level(qa.q2, qa.scales2)
    return out.to(qa.out_dtype)


# ----------------------------------------------------------------- kernels


def _contract_level(q, scales, x, block: int, acc: torch.dtype) -> torch.Tensor:
    """One storage level's contraction ``sum_j scales[:, j] * (q_j @ x_j)``
    over k-blocks, upcasting ONE (m, block) tile per step. Rank-agnostic in
    ``x`` ((k,) vector or (k, n) block of right-hand sides)."""
    m, k = q.shape
    y = torch.zeros((m, *x.shape[1:]), dtype=acc, device=q.device)
    xa = x.to(acc)
    for j in range(k // block):
        cols = slice(j * block, (j + 1) * block)
        p = q[:, cols].to(acc) @ xa[cols]
        s = scales[:, j].to(acc)
        y = y + (s if p.dim() == 1 else s[:, None]) * p
    return y


def matvec_quantized(qa: QuantizedMatrix, x: torch.Tensor) -> torch.Tensor:
    """The scan tier (the JAX package's XLA tier for quantized storage):
    contract the payload tile by tile against ``x``, then the compensated
    residual operand when present, in the accumulator dtype (the kernel
    contract of ops/gemv.py). A Python loop over k-blocks."""
    acc = acc_dtype(qa.out_dtype)
    y = _contract_level(qa.q, qa.scales, x, qa.block, acc)
    if qa.q2 is not None:
        y = y + _contract_level(qa.q2, qa.scales2, x, qa.block, acc)
    return y


# Tier name -> quantized-storage kernel. "cuda" (ops/cuda_quant.py) registers
# itself when ops is imported; the library tiers map to the scan tier, as the
# JAX package sends every tier but "pallas" to its scan kernel.
_STORAGE_KERNELS: dict[str, Callable] = {
    "torch": matvec_quantized,
    "torch_colwise": matvec_quantized,
}


def register_storage_kernel(name: str, fn: Callable) -> None:
    _STORAGE_KERNELS[name] = fn


def get_storage_kernel(kernel: str | Callable) -> Callable:
    """The local kernel for quantized storage: a callable passes through,
    ``"cuda"`` is the hand-written block-scaled GEMV (both ranks of ``x``),
    ``"torch"``/``"torch_colwise"`` the scan tier; any other name raises
    ``KeyError``."""
    if callable(kernel):
        return kernel
    try:
        return _STORAGE_KERNELS[kernel]
    except KeyError:
        raise KeyError(
            f"unknown quantized-storage kernel {kernel!r}; available: "
            f"{sorted(_STORAGE_KERNELS)}"
        ) from None
