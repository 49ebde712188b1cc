"""The controls: the reference put in the program's place, computed one
precision below what the configuration states, to show that the check
fails it.

- A multiply's control answers every request of the window from its own
  table, each after the least time the card could take for it
  (``roofline``), so that a window checks about as many answers as a run
  of the program does. The table is A @ X one precision below the
  configuration's dtype, rounded to that dtype (:data:`PRODUCTS`): for
  bfloat16 or float16, int8 (A quantized by rows and X by columns,
  symmetric, scale = max|v| / 127, round to nearest; the integer products
  summed exactly, the sum scaled back); for float32 with TF32 off, TF32 (A
  and X rounded to 10 mantissa bits, float32 sums); for float64, float32.
- A float32 solve's control is TF32 (the configuration states float32
  with TF32 off): plain conjugate gradients whose products round A and the
  vector to TF32's 10-bit mantissa first (round to nearest even) and sum in
  float32, stopping on the same ``rtol``.

Run on the card at a cell's own size, on several seeds, with

    python3 -m cellbench.harness.control --workload northstar_bf16.matvec \\
        --seeds 11 12 13 --seconds 3

which drives the cell's traffic through the control and prints each run's
compared numbers. The benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from . import operands, roofline
from .spec import SpecError
from .systems import Answer

INT8_MAX = 127
TF32_DROP_BITS = 13  # float32's 23 mantissa bits less TF32's 10


def int8_product(a: torch.Tensor, x: torch.Tensor, out_dtype: torch.dtype,
                 rows: int = 4096) -> torch.Tensor:
    """``A @ X`` in int8 (A by rows, X by columns), exact integer sums,
    rounded to ``out_dtype``."""
    x32 = x.float()
    sx = x32.abs().amax(dim=0).clamp_min(torch.finfo(torch.float32).tiny) / INT8_MAX
    qx = torch.round(x32 / sx).clamp(-INT8_MAX, INT8_MAX).double()
    out = torch.empty((a.shape[0], x.shape[1]), dtype=out_dtype, device=a.device)
    for i in range(0, a.shape[0], rows):
        blk = a[i:i + rows].float()
        sa = blk.abs().amax(dim=1, keepdim=True).clamp_min(torch.finfo(torch.float32).tiny) / INT8_MAX
        qa = torch.round(blk / sa).clamp(-INT8_MAX, INT8_MAX).double()
        out[i:i + rows] = ((qa @ qx) * sa.double() * sx.double()).to(out_dtype)
        del blk, qa
    return out


def tf32_product(a: torch.Tensor, x: torch.Tensor, out_dtype: torch.dtype,
                 rows: int = 4096) -> torch.Tensor:
    """``A @ X`` with A and X rounded to TF32 and float32 sums, rounded to
    ``out_dtype``."""
    x32 = tf32_round_(x.to(torch.float32, copy=True).contiguous())
    out = torch.empty((a.shape[0], x.shape[1]), dtype=out_dtype, device=a.device)
    for i in range(0, a.shape[0], rows):
        out[i:i + rows] = (tf32_round_(a[i:i + rows].to(torch.float32, copy=True)) @ x32
                           ).to(out_dtype)
    return out


def fp32_product(a: torch.Tensor, x: torch.Tensor, out_dtype: torch.dtype,
                 rows: int = 4096) -> torch.Tensor:
    """``A @ X`` in float32 (A, X and the sums), rounded to ``out_dtype``."""
    x32 = x.float()
    out = torch.empty((a.shape[0], x.shape[1]), dtype=out_dtype, device=a.device)
    for i in range(0, a.shape[0], rows):
        out[i:i + rows] = (a[i:i + rows].float() @ x32).to(out_dtype)
    return out


# A multiply's product one precision below the configuration's dtype.
PRODUCTS = {"bfloat16": int8_product, "float16": int8_product,
            "float32": tf32_product, "float64": fp32_product}


def tf32_round_(t: torch.Tensor, rows: int = 4096) -> torch.Tensor:
    """Round a float32 tensor to TF32 in place (nearest, ties to even)."""
    flat = t.view(-1, t.shape[-1]) if t.dim() > 1 else t.view(1, -1)
    for i in range(0, flat.shape[0], rows):
        bits = flat[i:i + rows].view(torch.int32)
        lsb = (bits >> TF32_DROP_BITS) & 1
        bits.add_(((1 << (TF32_DROP_BITS - 1)) - 1) + lsb)
        bits.bitwise_and_(~((1 << TF32_DROP_BITS) - 1))
    return t


def plain_cg(matvec, b: torch.Tensor, rtol: float, maxiter: int) -> tuple[torch.Tensor, int]:
    """Conjugate gradients from x0 = 0, stopping when ||r|| <= rtol·||b||."""
    x = torch.zeros_like(b)
    r = b.clone()
    p = r.clone()
    rr = torch.dot(r, r)
    threshold = rtol * float(torch.sqrt(torch.dot(b, b)))
    it = 0
    while it < maxiter and float(torch.sqrt(rr)) > threshold:
        ap = matvec(p)
        alpha = rr / torch.dot(p, ap)
        x += alpha * p
        r -= alpha * ap
        rr_new = torch.dot(r, r)
        p = r + (rr_new / rr) * p
        rr = rr_new
        it += 1
    return x, it


class ProductControl:
    """In place of a multiply entry: answers from a table of every
    payload's product one precision below (:data:`PRODUCTS`), made in
    set-up from A whole or from its row blocks (a cell on several cards),
    one block of rows at a time."""

    def __init__(self, cfg: dict, traffic: dict, cards, a):
        self.a, self.device = a, cards[0]
        self.cfg = cfg
        self.dtype = operands.torch_dtype(cfg["dtype"])
        self.product = PRODUCTS[cfg["dtype"]]
        self.table = {}

    def prepare(self, payload):
        return payload

    def warm(self, prepared: list) -> None:
        m = self.cfg["m"]
        rows = [(0, self.a)] if isinstance(self.a, torch.Tensor) else self.a
        xs = {p.pid: p.value.reshape(p.value.shape[0], -1).to(self.device) for p in prepared}
        out = {pid: torch.empty((m, x.shape[1]), dtype=self.dtype, device=self.device)
               for pid, x in xs.items()}
        # Each product takes A by rows and X by columns: a block of A's rows
        # gives those rows of every answer, as A whole does.
        for row0, blk in rows:
            for pid, x in xs.items():
                out[pid][row0:row0 + blk.shape[0]] = self.product(blk, x, self.dtype)
            del blk
        self.table = {p.pid: out[p.pid].reshape((m,) + tuple(p.value.shape[1:]))
                      for p in prepared}
        self.a = None

    def request(self, payload):
        time.sleep(roofline.block_work(self.cfg["m"], self.cfg["k"], payload.width,
                                       self.cfg["dtype"]).least_seconds())
        return self.table[payload.pid]

    def finish(self, y) -> Answer:
        return Answer(y)

    def counters(self) -> dict:
        return {}

    def close(self) -> None:
        self.table = {}


class Tf32CgControl:
    """In place of a served solve: plain CG on TF32-rounded products."""

    def __init__(self, cfg: dict, traffic: dict, cards, a):
        if not isinstance(a, torch.Tensor):
            raise SpecError("the TF32 control takes a whole A: it runs on one card")
        if a.dtype != torch.float32:
            raise ValueError("the TF32 control is for a float32 configuration")
        self.a = tf32_round_(a)
        self.device = cards[0]
        self.rtol = cfg["rtol"]
        self.maxiter = cfg.get("maxiter", 1000)

    def prepare(self, payload):
        return payload

    def warm(self, prepared: list) -> None:
        for p in prepared:
            self.finish(self.request(p))

    def _matvec(self, v: torch.Tensor) -> torch.Tensor:
        return self.a @ tf32_round_(v.clone())

    def request(self, payload):
        b = payload.value.to(self.device, torch.float32)
        return plain_cg(self._matvec, b, self.rtol, self.maxiter)

    def finish(self, handle) -> Answer:
        x, it = handle
        return Answer(x.cpu(), iters=it)

    def counters(self) -> dict:
        return {}

    def close(self) -> None:
        self.a = None


CONTROLS = {"matvec": ProductControl, "cg": Tf32CgControl}


def control_system(cfg: dict, traffic: dict, cards, a):
    return CONTROLS[traffic["op"]](cfg, traffic, cards, a)


def main(argv: list[str] | None = None) -> int:
    from .runner import run_cell

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    args = p.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    for seed in args.seeds:
        result = run_cell(args.workload, seed, args.seconds, trace=False, system="control")
        print(json.dumps({"workload": args.workload, "seed": seed, "system": "control",
                          "correct": result["correct"], "checks": result["checks"]}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
