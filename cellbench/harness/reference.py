"""The plain reference, and the comparison that decides ``correct``.

Plain PyTorch in float64, over the matrix the benchmark made, made again
from the seed a row block at a time (``operands``): it imports nothing of
the program and takes nothing the program made. It runs once the window
has closed and the program's state is freed.

Two numbers, each with the limit the configuration states:

- ``max_gap`` (a multiply's answers): for every checked answer column,
  ``max_i (|y_i - ref_i| - ulp(y_i)/2) / max_i |ref_i|``, with the ulp of the
  configuration's dtype taken at the smaller of ``|y_i|`` and ``|ref_i|``.
  It is the error left once the answer's own rounding to its dtype is
  allowed for: what the accumulation and the inputs' handling added.
- ``max_residual`` (a solve's answers): ``||b - A x|| / ||b||`` in float64
  for every checked solution ``x``, against the configuration's ``rtol``.
"""

from __future__ import annotations

import math

import torch

from . import operands


def reference_product(cfg: dict, seed: int, device, x64: torch.Tensor) -> torch.Tensor:
    """``A @ X`` in float64, A made again from ``seed`` by row blocks."""
    out = torch.empty((cfg["m"], x64.shape[1]), dtype=torch.float64, device=device)
    for i, blk in operands.operand_rows(cfg, device, seed):
        out[i:i + blk.shape[0]] = blk.double() @ x64
        del blk
    return out


def half_ulp(mag: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Half a unit in the last place of ``dtype`` at each magnitude."""
    _, exp = torch.frexp(mag)
    tiny = torch.finfo(dtype).tiny
    return torch.where(mag > 0, torch.ldexp(torch.full_like(mag, torch.finfo(dtype).eps / 2),
                                            exp - 1), torch.full_like(mag, tiny))


def gap_beyond_rounding(y: torch.Tensor, ref: torch.Tensor, dtype: torch.dtype) -> float:
    """``max_gap`` of one answer block ``y`` against ``ref`` (both (m, c))."""
    y = y.double()
    if not bool(torch.isfinite(y).all()):
        return math.inf
    excess = (y - ref).abs() - half_ulp(torch.minimum(y.abs(), ref.abs()), dtype)
    scale = ref.abs().amax(dim=0).clamp_min(torch.finfo(torch.float64).tiny)
    return float((excess / scale).max())


def check_products(cfg: dict, seed: int, device, payloads: list, kept: list) -> dict:
    """``max_gap`` over the kept answers of multiply requests; every
    payload's columns go through the reference once."""
    k, m = cfg["k"], cfg["m"]
    dtype = operands.torch_dtype(cfg["dtype"])
    cols, offset = [], {}
    at = 0
    for p in payloads:
        block = p.value.reshape(k, -1)
        offset[p.pid] = (at, block.shape[1])
        at += block.shape[1]
        cols.append(block)
    ref = reference_product(cfg, seed, device, torch.cat(cols, dim=1).to(device).double())
    worst, wrong_shape = -math.inf, 0
    for _, pid, answer in kept:
        at, w = offset[pid]
        y = answer.value.to(device)
        if y.numel() != m * w:
            wrong_shape += 1
            continue
        worst = max(worst, gap_beyond_rounding(y.reshape(m, w), ref[:, at:at + w], dtype))
    return {"max_gap": worst, "wrong_shape": wrong_shape}


def check_solutions(cfg: dict, seed: int, device, payloads: list, kept: list) -> dict:
    """``max_residual`` over the kept solutions."""
    n = cfg["k"]
    by_pid = {p.pid: p.value for p in payloads}
    wrong_shape = sum(1 for _, _, ans in kept if ans.value.numel() != n)
    good = [(pid, ans) for _, pid, ans in kept if ans.value.numel() == n]
    if not good:
        return {"max_residual": math.inf, "wrong_shape": wrong_shape}
    b = torch.stack([by_pid[pid].reshape(n) for pid, _ in good], dim=1).to(device).double()
    x = torch.stack([ans.value.reshape(n) for _, ans in good], dim=1).to(device).double()
    if not bool(torch.isfinite(x).all()):
        return {"max_residual": math.inf, "wrong_shape": wrong_shape}
    r = b - reference_product(cfg, seed, device, x)
    rel = r.norm(dim=0) / b.norm(dim=0)
    return {"max_residual": float(rel.max()), "wrong_shape": wrong_shape}


CHECKS = {"matvec": check_products, "cg": check_solutions}


def check(cfg: dict, traffic: dict, seed: int, device, payloads: list, record) -> dict:
    """Every number compared, as ``{name: (value, limit)}``, and whether all
    hold."""
    readings = CHECKS[traffic["op"]](cfg, seed, device, payloads, record.kept)
    readings["failed"] = record.failed
    readings["checked"] = len(record.kept)
    limits = dict(cfg["limits"], failed=0, wrong_shape=0)
    compared = {name: (readings[name], limits[name]) for name in limits}
    ok = (len(record.kept) > 0
          and all(value <= limit for value, limit in compared.values()))
    compared["checked"] = (readings["checked"], 1)
    return {"compared": compared, "correct": ok}
