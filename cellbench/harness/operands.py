"""The benchmark's inputs, made from ``--seed``: frozen copies.

Each function here is a copy of the program's own construction, so that
the yardstick stays put whatever a later change does to the program:

- :func:`resident_matrix` of ``bench/serve.py::resident_matrix`` (uniform
  [0, 10), the paper's data range, drawn on the device in row chunks);
- :func:`solver_operand` of the device branch of
  ``bench/serve.py::solver_operand`` (the SPD family: uniform(-1, 1)
  symmetrized in float64, diagonal = |row sum| + 1, a[0, 0] boosted 1.5x);
- :func:`request_pool` of ``bench/serve.py::_request_pool``;
- :func:`rhs_pool` of ``run_serve_solver``'s right-hand sides.

The row-block generators (:func:`resident_rows`, :func:`solver_rows`) give
the same matrices a block at a time, for the reference, which never holds
a second whole A. Nothing here imports the program.
"""

from __future__ import annotations

from typing import Iterator, Sequence

import numpy as np
import torch

# Seeds reach numpy and torch reduced into [0, 2**63): numpy refuses a
# negative seed, and ``--seed`` takes any whole number.
SEED_MODULUS = 1 << 63


def norm_seed(seed: int) -> int:
    return int(seed) % SEED_MODULUS


def torch_dtype(name: str) -> torch.dtype:
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


def _resident_chunk_rows(k: int) -> int:
    return max(1, (1 << 28) // max(1, k))


def resident_rows(m: int, k: int, dtype: torch.dtype, device, seed: int
                  ) -> Iterator[tuple[int, torch.Tensor]]:
    """``(row0, block)`` of the uniform [0, 10) matrix, in the draw order of
    :func:`resident_matrix`."""
    gen = torch.Generator(device=device)
    gen.manual_seed(norm_seed(seed))
    rows = _resident_chunk_rows(k)
    for i in range(0, m, rows):
        n = min(rows, m - i)
        yield i, (torch.rand((n, k), generator=gen, device=device) * 10).to(dtype)


def resident_matrix(m: int, k: int, dtype: torch.dtype, device, seed: int) -> torch.Tensor:
    """A seeded uniform [0, 10) (m, k) matrix made on ``device``."""
    out = torch.empty((m, k), dtype=dtype, device=device)
    for i, blk in resident_rows(m, k, dtype, device, seed):
        out[i:i + blk.shape[0]] = blk
        del blk
    return out


def _spd_chunk_rows(n: int) -> int:
    return max(1, (1 << 25) // n)  # 128 MiB of float32 per draw chunk


def _spd_draws(n: int, device, seed: int) -> torch.Tensor:
    gen = torch.Generator(device=device)
    gen.manual_seed(norm_seed(seed))
    g = torch.empty((n, n), dtype=torch.float32, device=device)
    rows = _spd_chunk_rows(n)
    for i in range(0, n, rows):
        j = min(n, i + rows)
        g[i:j] = torch.rand((j - i, n), generator=gen, device=device) * 2 - 1
    return g


def _spd_blocks(g: torch.Tensor, dtype: torch.dtype
                ) -> Iterator[tuple[int, torch.Tensor]]:
    n = g.shape[0]
    rows = _spd_chunk_rows(n)
    for i in range(0, n, rows):
        j = min(n, i + rows)
        blk = (g[i:j].double() + g[:, i:j].T.double()) / 2.0
        diag = torch.arange(j - i, device=g.device)
        blk[diag, diag + i] = blk.abs().sum(dim=1) + 1.0
        if i == 0:
            blk[0, 0] *= 1.5
        yield i, blk.to(dtype)
        del blk


def solver_rows(n: int, dtype: torch.dtype, device, seed: int
                ) -> Iterator[tuple[int, torch.Tensor]]:
    """``(row0, block)`` of the SPD operand of :func:`solver_operand`. Holds
    the float32 draws (one A's worth in float32) while it runs."""
    g = _spd_draws(n, device, seed)
    try:
        yield from _spd_blocks(g, dtype)
    finally:
        del g


def solver_operand(n: int, dtype: torch.dtype, device, seed: int) -> torch.Tensor:
    """The seeded SPD operand, built on ``device`` in row chunks: at most
    the draws plus the result (2x A) and one float64 chunk."""
    a = torch.empty((n, n), dtype=dtype, device=device)
    for i, blk in solver_rows(n, dtype, device, seed):
        a[i:i + blk.shape[0]] = blk
        del blk
    return a


OPERANDS = {
    "uniform_0_10": lambda cfg, dtype, device, seed: resident_matrix(
        cfg["m"], cfg["k"], dtype, device, seed),
    "spd": lambda cfg, dtype, device, seed: solver_operand(
        cfg["m"], dtype, device, seed),
}

OPERAND_ROWS = {
    "uniform_0_10": lambda cfg, dtype, device, seed: resident_rows(
        cfg["m"], cfg["k"], dtype, device, seed),
    "spd": lambda cfg, dtype, device, seed: solver_rows(cfg["m"], dtype, device, seed),
}


def make_operand(cfg: dict, device, seed: int) -> torch.Tensor:
    """A of a configuration (its ``operand`` family, ``m``, ``k``, ``dtype``)."""
    if cfg["operand"] == "spd" and cfg["m"] != cfg["k"]:
        raise ValueError("the spd operand is square: m must equal k")
    return OPERANDS[cfg["operand"]](cfg, torch_dtype(cfg["dtype"]), device, seed)


def operand_rows(cfg: dict, device, seed: int) -> Iterator[tuple[int, torch.Tensor]]:
    """A of a configuration again, one row block at a time."""
    return OPERAND_ROWS[cfg["operand"]](cfg, torch_dtype(cfg["dtype"]), device, seed)


def request_pool(k: int, widths: Sequence[int], dtype: torch.dtype, seed: int
                 ) -> dict[int, torch.Tensor]:
    """One seeded host block (k, w) per distinct width, uniform [0, 10):
    drawn in float64 with numpy in the iteration order of ``set(widths)``
    and cast by torch."""
    rng = np.random.default_rng(norm_seed(seed))
    return {
        w: torch.from_numpy(rng.uniform(0, 10, (k, w))).to(dtype)
        for w in set(widths)
    }


def rhs_pool(n: int, count: int, dtype: torch.dtype, seed: int) -> list[torch.Tensor]:
    """``count`` seeded standard-normal host vectors of length ``n``."""
    rng = np.random.default_rng(norm_seed(seed))
    return [torch.from_numpy(rng.standard_normal(n)).to(dtype) for _ in range(count)]
