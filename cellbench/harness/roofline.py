"""The least time the card could take for the work a window asked for.

Peaks are NVIDIA's published figures for one H100 SXM (dense, no
sparsity), at its full 700 W: a share is stated against them, with the
card's power limit printed beside the run. Work is counted from the
operation's shapes, whatever kernels implement it: each input byte read
once, each output byte written once, and the operations the mathematics
needs. So a later change may replace a kernel, and its share still reads
against the same yardstick.
"""

from __future__ import annotations

from dataclasses import dataclass

HBM_BYTES_PER_S = 3.35e12

# Operations per second by the dtype of the operands. Float32 is the CUDA
# cores' FFMA rate (the program's float32 GEMV and GEMM run there); float64
# the DFMA rate.
PEAK_FLOPS = {
    "bfloat16": 989e12,
    "float16": 989e12,
    "float32": 67e12,
    "float64": 34e12,
}

ITEMSIZE = {"bfloat16": 2, "float16": 2, "float32": 4, "float64": 8}


@dataclass(frozen=True)
class Work:
    bytes: float
    flops: float
    dtype: str

    def least_seconds(self) -> float:
        """The larger of the byte bound and the operation bound."""
        return max(self.bytes / HBM_BYTES_PER_S, self.flops / PEAK_FLOPS[self.dtype])

    def bound(self) -> str:
        """Which of the two bounds the least time: ``"bytes"`` or ``"flops"``."""
        return ("bytes" if self.bytes / HBM_BYTES_PER_S
                >= self.flops / PEAK_FLOPS[self.dtype] else "flops")


def matvec_work(m: int, k: int, dtype: str) -> Work:
    """``y = A·x``: A and x read once, y written once; 2·m·k operations."""
    return block_work(m, k, 1, dtype)


def block_work(m: int, k: int, w: int, dtype: str) -> Work:
    """``Y = A·X`` for a block of ``w`` columns: A once, X (k, w) once, Y
    (m, w) once; 2·m·k·w operations. ``w`` is the request's own width, not
    a padded bucket's."""
    size = ITEMSIZE[dtype]
    return Work(bytes=float(m * k + k * w + m * w) * size,
                flops=2.0 * m * k * w, dtype=dtype)


def cg_iteration_work(n: int, dtype: str) -> Work:
    """One conjugate-gradient iteration on an (n, n) operand: A read once
    for ``A·p``; p read for it and ``A·p`` written; x, r and p each read
    and written once by the updates (n² + 8n elements). Operations: the
    product's 2n², two dot products and three axpys (10n)."""
    size = ITEMSIZE[dtype]
    return Work(bytes=float(n * n + 8 * n) * size,
                flops=2.0 * n * n + 10.0 * n, dtype=dtype)


def share_percent(least_s: float, device_s: float) -> float | None:
    """``100 · least / device``; None where no device time was read."""
    if device_s <= 0:
        return None
    return 100.0 * least_s / device_s
