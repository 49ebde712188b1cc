"""Overlap-schedule study: colwise ``ring`` against ``ring_overlap``, with evidence.

The port's counterpart of the JAX package's ``scripts/overlap_study.py``:

1. **Dependency analysis** of each variant's program as the port runs it:
   one matvec recorded eagerly, every operation a node with the tensors it
   read and wrote, each local GEMV and each ``ppermute`` hop one node
   (:func:`overlap_stats`). A hop and a GEMV may run concurrently iff
   neither is an ancestor of the other. ``ring_overlap``
   (``parallel/ring.py::ring_matvec``) reads each step's tile from the
   resident panel, so every hop has a tile GEMV it does not depend on;
   ``ring`` permutes the output of one local GEMV, so no pair is
   independent. The counts are taken on one rank's GEMVs, the JAX
   package's per-device program.
2. **Timing**: the benchmark protocol (``sync`` measure) on the same mesh.
3. Optionally a ``torch.profiler`` trace of both (``--profile-dir``).

The JAX study also counts ``collective-permute-start``/``-done`` pairs in
the TPU's compiled HLO. The port's ring runs its hops on one stream of one
card, so that evidence has no counterpart here: the structural count and
the timing are the port's evidence.

Usage::

    python -m matvec_mpi_multiplier_torch.bench.overlap_study --devices 8
    python -m matvec_mpi_multiplier_torch.bench.overlap_study --platform cpu \\
        --host-devices 4 --size 64 --n-reps 3 --report /tmp/OVERLAP.md
"""

from __future__ import annotations

import argparse
import contextlib
import sys
from pathlib import Path

import torch

from .studies import add_platform_args, platform_label, study_mesh

VARIANTS = ("colwise_ring", "colwise_ring_overlap")


class _DepGraph:
    """Nodes of one eager run: ``(kind, rank, input tensors, output
    tensors)``. Every ATen call outside an opaque region is an ``op`` node;
    the local GEMV and the hop are added whole. Tensors are kept alive for
    the run, so their ids name them."""

    def __init__(self, ranks: list[int]):
        self.ranks = ranks  # storage address of each rank's panel
        self.nodes: list[tuple] = []
        self.keep: list = []
        self.depth = 0
        self._mode = None

    @contextlib.contextmanager
    def opaque(self):
        self.depth += 1
        try:
            yield
        finally:
            self.depth -= 1

    def add(self, kind: str, inputs, outputs, rank: int | None = None) -> None:
        ins = [t for t in inputs if isinstance(t, torch.Tensor)]
        outs = [t for t in outputs if isinstance(t, torch.Tensor)]
        self.keep.extend(ins + outs)
        self.nodes.append((kind, rank, [id(t) for t in ins], [id(t) for t in outs]))

    def rank_of(self, t: torch.Tensor) -> int | None:
        ptr = t.untyped_storage().data_ptr()
        return self.ranks.index(ptr) if ptr in self.ranks else None

    def __enter__(self):
        from torch.utils._pytree import tree_leaves
        from torch.utils._python_dispatch import TorchDispatchMode

        graph = self

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                out = func(*args, **(kwargs or {}))
                if graph.depth == 0:
                    graph.add("op", tree_leaves((args, kwargs or {})), tree_leaves(out))
                return out

        self._mode = Mode()
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        self._mode.__exit__(*exc)

    def ancestors(self) -> list[set]:
        produced: dict[int, int] = {}
        deps: list[set] = []
        for i, (_, _, ins, outs) in enumerate(self.nodes):
            d: set = set()
            for t in ins:
                j = produced.get(t)
                if j is not None:
                    d.add(j)
                    d |= deps[j]
            deps.append(d)
            for t in outs:
                produced[t] = i
        return deps


def overlap_stats(strategy, mesh, a, x, kernel="cuda") -> dict:
    """Dependency analysis of one matvec of ``strategy`` (a ring variant)
    on ``mesh``: ``n_permute`` hops, ``n_dot`` local GEMVs of rank 0, the
    hops with a rank-0 GEMV independent of them, and the independent (hop,
    GEMV) pairs; the JAX package's counts for the same schedule."""
    from ..ops.gemv import get_kernel
    from ..parallel import ring as ring_mod

    local = get_kernel(kernel) if isinstance(kernel, str) else kernel
    pa, px = strategy.place(a, x, mesh)
    graph = _DepGraph([s.untyped_storage().data_ptr() for s in pa.shards])

    def dot(a_tile, x_seg):
        with graph.opaque():
            y = local(a_tile, x_seg)
        graph.add("dot", (a_tile, x_seg), (y,), graph.rank_of(a_tile))
        return y

    real = ring_mod.ppermute

    def hop(blocks, hop_mesh, axes, perm):
        with graph.opaque():
            out = real(blocks, hop_mesh, axes, perm)
        graph.add("permute", blocks, out)
        return out

    fn = strategy.build(mesh, kernel=dot)
    ring_mod.ppermute = hop
    try:
        with graph:
            fn(pa, px)
    finally:
        ring_mod.ppermute = real
    deps = graph.ancestors()
    permutes = [i for i, n in enumerate(graph.nodes) if n[0] == "permute"]
    dots = [i for i, n in enumerate(graph.nodes) if n[0] == "dot" and n[1] == 0]
    concurrent = {p: [d for d in dots if p not in deps[d] and d not in deps[p]]
                  for p in permutes}
    return {
        "n_permute": len(permutes),
        "n_dot": len(dots),
        "hops_with_concurrent_dot": sum(1 for v in concurrent.values() if v),
        "concurrent_pairs": sum(len(v) for v in concurrent.values()),
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_platform_args(p, devices=8)
    p.add_argument("--size", type=int, default=4096)
    p.add_argument("--dtype", default="float32")
    p.add_argument("--n-reps", type=int, default=25)
    p.add_argument("--profile-dir", default=None)
    p.add_argument("--report", default=None,
                   help="write the markdown report here (nothing is written otherwise)")
    p.add_argument("--no-report", action="store_true")
    args = p.parse_args(argv)

    import numpy as np

    from ..models import get_strategy
    from .profiling import annotate, trace
    from .timing import time_matvec

    mesh = study_mesh(args)
    n_dev = mesh.size
    if n_dev < 2:
        print("overlap study needs >= 2 devices (ring has no hops at p=1); "
              "nothing to measure on this mesh — skipping", file=sys.stderr)
        return 0
    n = args.size
    rng = np.random.default_rng(7)
    dtype = getattr(torch, args.dtype)
    a = torch.from_numpy(rng.standard_normal((n, n))).to(dtype)
    x = torch.from_numpy(rng.standard_normal(n)).to(dtype)

    rows = []
    for name in VARIANTS:
        strat = get_strategy(name)
        stats = overlap_stats(strat, mesh, a, x)
        fn = strat.build(mesh)
        with trace(args.profile_dir, enabled=args.profile_dir is not None):
            with annotate(name):
                times = time_matvec(
                    fn, a, x, place=lambda a_, x_, s=strat: s.place(a_, x_, mesh),
                    mesh=mesh, n_reps=args.n_reps, measure="sync")
        mean_s = float(np.mean(times))
        rows.append((name, mean_s, stats))
        print(f"{name}: {mean_s * 1e3:.3f} ms  {stats}")

    base, over = rows
    ratio = over[1] / base[1]
    report = [
        "# Overlap schedule study: `colwise_ring` vs `colwise_ring_overlap`",
        "",
        f"Device: **{platform_label(mesh)}**, {n_dev} logical shards "
        f"{tuple(mesh.shape.values())}, size {n}² {args.dtype}, sync measure, "
        f"{args.n_reps} reps (generated by "
        "`python -m matvec_mpi_multiplier_torch.bench.overlap_study`).",
        "",
        "| variant | time (ms) | permute hops | rank-0 GEMVs | hops with an "
        "independent GEMV | independent (hop, GEMV) pairs |",
        "|---|---|---|---|---|---|",
    ]
    for name, mean_s, stats in rows:
        report.append(
            f"| {name} | {mean_s * 1e3:.3f} | {stats['n_permute']} | {stats['n_dot']} | "
            f"{stats['hops_with_concurrent_dot']} | {stats['concurrent_pairs']} |")
    report += [
        "",
        f"Overlapped/non-overlapped time ratio: **{ratio:.2f}×** "
        f"({'overlap wins' if ratio < 1 else 'overlap loses'} on this mesh).",
        "",
        "**What the columns show.** A hop and a GEMV can run concurrently iff "
        "neither is an ancestor of the other in the recorded program "
        "(`overlap_stats`). `colwise_ring_overlap` reads each step's tile from "
        "the resident panel, so every hop has GEMVs it does not wait for; "
        "`colwise_ring` permutes the output of its one local GEMV, so no pair is "
        "independent. The logical shards share one card and one stream, so the "
        "timing shows the schedule's cost (p steps of small tiles) and none of "
        "the overlap, which needs links that run beside the compute.",
    ]
    text = "\n".join(report) + "\n"
    print("\n" + text)
    if args.report and not args.no_report:
        out = Path(args.report)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(text)
        print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
