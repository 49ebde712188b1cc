"""Bucket ladder: shape-canonicalization for the request stream.

The port's copy of the JAX package's ``engine/buckets.py``. Request widths
quantize to a power-of-two ladder, so at most ``log2(max_bucket) + 1``
executables ever exist per (strategy, kernel, combine, dtype) and every
request after warmup hits a cached one.

Padding is host-side (the request is on its way to the device anyway) and
the pad columns are zeros; the matching unpad is a slice of the result
columns at materialization (``MatvecFuture.result``). Zero columns cannot
perturb the real ones — each output element is a dot product over its own
column only, summed in an order fixed by k alone (``csrc/gemm.cu``) — so
padded results are bitwise what the same program computes with any other
pad content.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.errors import ConfigError

# Widest batch one executable serves; wider requests split into chunks.
DEFAULT_MAX_BUCKET = 128


def bucket_ladder(max_bucket: int = DEFAULT_MAX_BUCKET) -> tuple[int, ...]:
    """The power-of-two bucket widths up to ``max_bucket`` inclusive
    (``max_bucket`` itself is appended when it is not a power of two)."""
    if max_bucket < 1:
        raise ConfigError(f"max_bucket must be >= 1, got {max_bucket}")
    ladder = []
    b = 1
    while b <= max_bucket:
        ladder.append(b)
        b *= 2
    if ladder[-1] != max_bucket:
        ladder.append(max_bucket)
    return tuple(ladder)


def bucket_for(width: int, max_bucket: int = DEFAULT_MAX_BUCKET) -> int:
    """The bucket a request of ``width`` columns is padded to: the smallest
    ladder entry >= width. Callers split requests wider than ``max_bucket``
    into chunks first (``split_widths``)."""
    if width < 1:
        raise ConfigError(f"request width must be >= 1, got {width}")
    if width > max_bucket:
        raise ConfigError(
            f"request width {width} exceeds max_bucket {max_bucket}; "
            "split it first (split_widths)"
        )
    for b in bucket_ladder(max_bucket):
        if b >= width:
            return b
    raise AssertionError("unreachable: ladder ends at max_bucket")


def split_widths(width: int, max_bucket: int = DEFAULT_MAX_BUCKET) -> list[int]:
    """Chunk widths for a request of ``width`` columns: full ``max_bucket``
    chunks plus the remainder (which then pads to its own bucket)."""
    if width < 1:
        raise ConfigError(f"request width must be >= 1, got {width}")
    chunks = [max_bucket] * (width // max_bucket)
    if width % max_bucket:
        chunks.append(width % max_bucket)
    return chunks


def pad_columns(block, bucket: int):
    """Zero-pad a host (k, b) block — a numpy array or a CPU tensor — to
    (k, bucket) columns (returned as is when already at bucket width)."""
    k, b = block.shape
    if b == bucket:
        return block
    if b > bucket:
        raise ConfigError(f"block width {b} exceeds bucket {bucket}")
    if isinstance(block, torch.Tensor):
        padded = torch.zeros((k, bucket), dtype=block.dtype, device=block.device)
    else:
        padded = np.zeros((k, bucket), dtype=block.dtype)
    padded[:, :b] = block
    return padded
