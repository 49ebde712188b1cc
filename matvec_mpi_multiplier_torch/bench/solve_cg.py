"""Distributed Krylov solver CLI (``models/cg.py``, ``models/gmres.py``).

The port's counterpart of the JAX package's ``scripts/solve_cg.py``, with
its flags and its output line. Solves ``A x = b`` with the matrix placed by
any strategy (never replicated). ``--method cg`` (the default) takes an SPD
``A = GᵀG/n + I``; ``--method gmres`` runs restarted GMRES on a
deliberately NONSYMMETRIC ``A = G/sqrt(n) + 2I``; ``--refine`` wraps either
in mixed-precision iterative refinement (fp64-parity ``ozaki`` residuals,
a double-float x). The operands are made on the mesh's first device from
``--seed`` (``torch.Generator``; the JAX script draws them with numpy on
the host, so the two solve different systems of the same family).

Usage::

    python -m matvec_mpi_multiplier_torch.bench.solve_cg --size 16384 \\
        --strategy rowwise
    python -m matvec_mpi_multiplier_torch.bench.solve_cg --size 1024 \\
        --method gmres --restart 40
    python -m matvec_mpi_multiplier_torch.bench.solve_cg --size 64 \\
        --strategy rowwise --devices 4 --refine --platform cpu

It runs on the CUDA devices unless ``--platform cpu`` is given, solves
once (the kernels' first launches and builds), then times a second solve
(host clock, synchronized), and exits 0 when that solve converged.
"""

from __future__ import annotations

import argparse
import math
import sys
import time

import torch


def operands(n: int, method: str, seed: int, device: torch.device):
    """``(a, b, x_true)`` in fp32 on ``device``: SPD ``GᵀG/n + I`` for cg,
    nonsymmetric ``G/sqrt(n) + 2I`` for gmres, ``b = A x_true``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    g = torch.randn((n, n), generator=gen, dtype=torch.float32, device=device)
    eye = torch.eye(n, dtype=torch.float32, device=device)
    if method == "gmres":
        a = g / math.sqrt(n) + 2.0 * eye
    else:
        a = g.T @ g / n + eye
    del g
    x_true = torch.randn((n,), generator=gen, dtype=torch.float32, device=device)
    return a, a @ x_true, x_true


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="matvec-torch-solve-cg",
                                description=__doc__.split("\n")[0])
    p.add_argument("--size", type=int, default=1024, help="n for the n x n system")
    p.add_argument("--strategy", default="blockwise")
    p.add_argument("--method", choices=["cg", "gmres"], default="cg",
                   help="cg: SPD systems; gmres: general (nonsymmetric) "
                   "systems via restarted CGS2-Arnoldi")
    p.add_argument("--restart", type=int, default=40,
                   help="GMRES(m) basis size (ignored for cg)")
    p.add_argument("--kernel", default="cuda",
                   help="local GEMV tier (cuda | torch | compensated | ozaki | "
                   "ozaki6 | ozaki_i8 | ...: the fp64-parity tiers matter for "
                   "ill-conditioned systems)")
    p.add_argument("--tol", type=float, default=1e-6,
                   help="relative tolerance: stop at ||r|| <= tol * ||b||")
    p.add_argument("--max-iters", type=int, default=None,
                   help="cg iteration cap (default 1000; cg-only: gmres is "
                   "bounded by --max-restarts)")
    p.add_argument("--max-restarts", type=int, default=50,
                   help="GMRES outer-cycle cap (ignored for cg)")
    p.add_argument("--precondition", choices=["none", "jacobi"], default="none",
                   help="jacobi: the diag(A) preconditioner")
    p.add_argument("--refine", action="store_true",
                   help="mixed-precision iterative refinement: fp32 corrections "
                   "by the chosen --method, fp64-parity (ozaki) residuals and "
                   "a double-float x")
    p.add_argument("--devices", type=int, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--platform", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("--host-devices", type=int, default=None,
                   help="logical CPU devices with --platform cpu (default: "
                   "--devices)")
    return p


def main(argv=None) -> int:
    p = build_parser()
    args = p.parse_args(argv)
    if args.method == "gmres" and (args.precondition != "none"
                                   or args.max_iters is not None):
        p.error("--precondition/--max-iters are cg-only options "
                "(gmres is bounded by --max-restarts)")

    from ..models import get_strategy
    from ..models.cg import build_cg, build_refined
    from ..models.gmres import build_gmres
    from ..parallel import distributed
    from ..parallel.mesh import make_mesh
    from .sweep import platform_devices

    # The MPI_Init analog: joins a launcher's world (torchrun, SLURM, Open
    # MPI), a no-op in a world of one.
    distributed.initialize()
    host = args.host_devices
    if args.platform == "cpu" and host is None:
        host = args.devices
    mesh = make_mesh(args.devices, devices=platform_devices(args.platform, host))
    dev0 = mesh.devices[0]
    a, b, x_true = operands(args.size, args.method, args.seed, dev0)

    strategy = get_strategy(args.strategy)
    precondition = False if args.precondition == "none" else args.precondition
    max_iters = 1000 if args.max_iters is None else args.max_iters
    if args.method == "gmres" and args.refine:
        run = build_refined(strategy, mesh, inner="gmres", kernel=args.kernel,
                            tol=args.tol, restart=args.restart,
                            max_restarts=args.max_restarts)
        label = f"{args.kernel}/gmres({args.restart})+refine(ozaki)"
    elif args.method == "gmres":
        run = build_gmres(strategy, mesh, kernel=args.kernel, tol=args.tol,
                          restart=args.restart, max_restarts=args.max_restarts)
        label = f"{args.kernel}/gmres({args.restart})"
    elif args.refine:
        # --kernel drives the inner CG; the residual runs the ozaki tier.
        run = build_refined(strategy, mesh, kernel=args.kernel, tol=args.tol,
                            max_iters=max_iters, precondition=precondition)
        label = f"{args.kernel}+refine(ozaki)"
    else:
        run = build_cg(strategy, mesh, kernel=args.kernel, tol=args.tol,
                       max_iters=max_iters, precondition=precondition)
        label = args.kernel

    def synchronize() -> None:
        if dev0.type == "cuda":
            torch.cuda.synchronize(dev0)

    res = run(a, b)  # first launches and builds
    synchronize()
    t0 = time.perf_counter()
    res = run(a, b)
    synchronize()
    dt = time.perf_counter() - t0

    err = float(torch.max(torch.abs(res.x.to(x_true.dtype) - x_true)))
    if distributed.is_main_process():
        print(
            f"{args.method}[{args.strategy}/{label}] n={args.size} p={mesh.size}: "
            f"converged={bool(res.converged)} iters={int(res.n_iters)} "
            f"||r||={float(res.residual_norm):.3e} max|x-x_true|={err:.3e} "
            f"{dt * 1e3:.1f} ms",
            flush=True,
        )
    return 0 if bool(res.converged) else 1


if __name__ == "__main__":
    sys.exit(main())
