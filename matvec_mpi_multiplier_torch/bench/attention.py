"""Long-context attention study: ring vs Ulysses vs replicated, measured.

The port's counterpart of the JAX package's ``scripts/attention_study.py``.
It times the replicated dense attention (no sequence parallelism) and the
four schedule × tier variants of ``parallel/attention.py`` over a
sequence-length ladder. Every variant is held against the replicated dense
result before it is timed; a variant that disagrees raises (a speed table
for an operator that diverged would be worse than none). Timing is the
device-looped slope (``bench/timing.py::time_fn_looped``, as the JAX study
times): dependent reps ``fn(q, kv)`` with k and v stacked as the carry,
replays of CUDA graphs on one card (eager reps, host clock, on a CPU mesh),
the median of its samples.

Cells marked ``†`` have block shapes that the JAX package's predicate
(:func:`flash_path_available`) refuses: its flash tier runs its plain
fallback there. The port's kernel takes them and runs all the same.

Usage::

    python -m matvec_mpi_multiplier_torch.bench.attention --shards 4 \\
        --seqs 4096 16384
    python -m matvec_mpi_multiplier_torch.bench.attention --platform cpu \\
        --host-devices 4 --seqs 256 --heads 4 --n-reps 3

It prints the table; ``--report PATH`` also writes it to PATH.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..ops.attention import flash_path_available
from ..parallel.attention import build_ring_attention, build_ulysses_attention
from ..parallel.mesh import Mesh, make_mesh
from ..utils.convert import torch_dtype
from ..utils.errors import TimingError
from .sweep import platform_devices
from .timing import time_fn_looped

COLUMNS = ("dense_replicated", "ring", "ring_flash", "ulysses", "ulysses_flash")


def dense_attention(q, k, v, *, causal: bool) -> torch.Tensor:
    """The replicated baseline: dense multi-head attention over the whole
    sequence on one device, fp32 statistics ((s, h, d) in, fp32 out)."""
    d = q.shape[-1]
    scores = torch.einsum("qhd,khd->hqk", q.float(), k.float()) * (1.0 / (d ** 0.5))
    if causal:
        rows = torch.arange(q.shape[0], device=q.device)
        scores = torch.where((rows[None, :] <= rows[:, None])[None], scores, -torch.inf)
    m = scores.amax(dim=-1, keepdim=True)
    w = torch.exp(scores - m)
    o = torch.einsum("hqk,khd->qhd", w, v.float())
    return o / w.sum(dim=-1).transpose(0, 1)[..., None]


def predicate_refused(s: int, p: int, d_head: int) -> set[str]:
    """The ``*_flash`` variants whose blocks the JAX package's predicate
    refuses at this s (there its Pallas tier falls back): the ring's per-hop
    blocks are (s/p, s/p), Ulysses' local step sees the whole sequence."""
    out = set()
    if not flash_path_available(s // p, s // p, d_head):
        out.add("ring_flash")
    if not flash_path_available(s, s, d_head):
        out.add("ulysses_flash")
    return out


def run_attention_study(
    mesh: Mesh, seqs, heads: int = 8, d_head: int = 128,
    dtype: str = "bfloat16", causal: bool = False, n_reps: int = 10,
    seed: int = 0, samples: int = 5,
) -> list[dict]:
    """One row per sequence length: ``{"s", "refused", <column>: {"ms",
    "gflops"} or None (unmeasurable), ...}`` for :data:`COLUMNS`.

    q, k and v are standard normal ``(s, heads, d_head)`` from ``seed``,
    stored in ``dtype``. The GFLOP/s count 4·s²·h·d (half of it causal).
    """
    dev = mesh.devices[0]
    p = mesh.size
    store = torch_dtype(dtype)
    rng = np.random.default_rng(seed)
    schedules = {
        "ring": build_ring_attention(mesh, causal=causal),
        "ring_flash": build_ring_attention(mesh, causal=causal, kernel="flash"),
        "ulysses": build_ulysses_attention(mesh, causal=causal),
        "ulysses_flash": build_ulysses_attention(mesh, causal=causal, kernel="flash"),
    }
    tol = 2e-2 if store == torch.bfloat16 else 2e-5
    rows = []
    for s in seqs:
        q, k, v = (
            torch.from_numpy(rng.standard_normal((s, heads, d_head))).to(dev, store)
            for _ in range(3)
        )
        entry = {"s": s, "refused": predicate_refused(s, p, d_head)}
        flops = 4.0 * s * s * heads * d_head * (0.5 if causal else 1.0)
        with torch.no_grad():
            oracle = dense_attention(q, k, v, causal=causal)
            timed = {"dense_replicated":
                     lambda q_, kv_: dense_attention(q_, kv_[0], kv_[1], causal=causal)}
            for name, fn in schedules.items():
                # assert_allclose(rtol=tol, atol=tol), shard by shard.
                for g, o in zip(fn(q, k, v).shards, oracle.chunk(p)):
                    excess = ((g - o).abs() - tol * o.abs()).max().item()
                    if not excess <= tol:
                        raise RuntimeError(
                            f"attention study s={s}: {name} differs from the "
                            f"replicated dense result beyond rtol = atol = {tol}")
                timed[name] = lambda q_, kv_, fn=fn: fn(q_, kv_[0], kv_[1])
            del oracle
            kv = torch.stack((k, v))  # the carry the looped reps thread
            for name, fn in timed.items():
                try:
                    t = float(np.median(time_fn_looped(
                        fn, (q, kv), mesh, n_reps=n_reps, samples=samples)))
                    entry[name] = {"ms": t * 1e3, "gflops": flops / t / 1e9}
                except TimingError:
                    entry[name] = None
        rows.append(entry)
    return rows


def report(rows: list[dict], mesh: Mesh, *, heads: int, d_head: int, dtype: str,
           causal: bool, n_reps: int) -> str:
    """The study as a markdown table (``†``: the JAX package's predicate
    refuses the block shape)."""
    dev = mesh.devices[0]
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    lines = [
        "# Long-context attention schedules",
        "",
        f"Device: **{name}**, {mesh.size} shards over "
        f"{len(mesh.distinct_devices())} device(s), mesh {list(mesh.grid)}; "
        f"multi-head attention h={heads}, d_head={d_head}, {dtype} storage / "
        f"fp32 statistics, causal={causal}; device-looped timing ({n_reps} reps, "
        "median of the samples; `bench/attention.py`). Every timed cell "
        "matched the replicated dense result first. `†`: the JAX package's "
        "flash predicate refuses the block shape (the kernel ran all the "
        "same). `unmeasurable`: the looped "
        "slope carried no signal.",
        "",
        "| seq len | dense (replicated) ms | ring ms | ring_flash ms "
        "| ulysses ms | ulysses_flash ms |",
        "|---|---|---|---|---|---|",
    ]
    for r in rows:
        cells = [
            (f"{r[c]['ms']:.3f}" + ("†" if c in r["refused"] else ""))
            if r.get(c) else "unmeasurable"
            for c in COLUMNS
        ]
        lines.append(f"| {r['s']} | " + " | ".join(cells) + " |")
    return "\n".join(lines) + "\n"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--platform", choices=["cuda", "cpu"], default="cuda",
                   help="cuda (the default) fails without a card")
    p.add_argument("--host-devices", type=int, default=None,
                   help="with --platform cpu: number of CPU devices")
    p.add_argument("--shards", type=int, default=None,
                   help="logical shards, cycling over the devices (default: "
                        "one per device); 4 on one card is the 2x2 mesh")
    p.add_argument("--seqs", nargs="+", type=int, default=[1024, 4096])
    p.add_argument("--heads", type=int, default=8)
    p.add_argument("--d-head", type=int, default=128,
                   help="128: the kernel takes d_head a multiple of 128")
    p.add_argument("--dtype", default="bfloat16",
                   help="storage dtype (statistics are always fp32)")
    p.add_argument("--causal", action="store_true")
    p.add_argument("--n-reps", type=int, default=10)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--report", default=None, help="also write the table here")
    return p


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    devices = platform_devices(args.platform, args.host_devices)
    shards = args.shards or len(devices)
    mesh = make_mesh(shards, devices=[devices[i % len(devices)] for i in range(shards)])
    rows = run_attention_study(mesh, args.seqs, args.heads, args.d_head, args.dtype,
                               args.causal, args.n_reps, args.seed)
    text = report(rows, mesh, heads=args.heads, d_head=args.d_head, dtype=args.dtype,
                  causal=args.causal, n_reps=args.n_reps)
    print(text)
    if args.report:
        with open(args.report, "w") as f:
            f.write(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
