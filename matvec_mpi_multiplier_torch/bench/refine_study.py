"""Iterative-refinement evidence: forward error against conditioning, measured.

The port's counterpart of the JAX package's ``scripts/refine_study.py``.
``models/cg.py`` says plain fp32 CG floors at about ``cond(A)·eps`` forward
error, while mixed-precision refinement (fp32 CG corrections, fp64-parity
ozaki residuals, a double-float x) recovers about fp32-ulp solutions. Per
condition number of a ladder: one SPD system with a prescribed spectrum
(:func:`spd_with_condition`), solved three ways — plain fp32 CG, fp32 PCG
(Jacobi, no help for spectral conditioning, the control) and the refined
solve. Reported: the relative forward error against the fp64 direct
solution of the rounded system, iterations or trips, and the warm wall
time. The report is printed, and written where ``--report`` names a path.

Usage::

    python -m matvec_mpi_multiplier_torch.bench.refine_study
    python -m matvec_mpi_multiplier_torch.bench.refine_study --platform cpu \\
        --host-devices 8 --size 64 --max-iters 400
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

from .studies import add_platform_args, platform_label, study_mesh

CONDS = (1e2, 1e4, 1e6)


def spd_with_condition(n: int, cond: float, rng):
    """``(A, x_true, b)``: ``A = Q diag(logspace(0, log10 cond)) Qᵀ`` with a
    seeded orthogonal Q, in float64 (the JAX study's draws)."""
    import numpy as np

    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    a = (q * np.logspace(0, np.log10(cond), n)) @ q.T
    x_true = rng.standard_normal(n)
    return a, x_true, a @ x_true


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_platform_args(p, devices=None)
    p.add_argument("--size", type=int, default=512)
    p.add_argument("--strategy", default="rowwise")
    p.add_argument("--max-iters", type=int, default=20000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--report", default=None,
                   help="write the markdown report here (nothing is written otherwise)")
    p.add_argument("--no-report", action="store_true")
    args = p.parse_args(argv)

    import numpy as np
    import torch

    from ..models import get_strategy
    from ..models.cg import build_cg, build_refined

    mesh = study_mesh(args)
    dev0 = mesh.devices[0]
    strat = get_strategy(args.strategy)
    rng = np.random.default_rng(args.seed)
    n = args.size

    def fence() -> None:
        if dev0.type == "cuda":
            torch.cuda.synchronize(dev0)

    rows = []
    for cond in CONDS:
        a64, _, b64 = spd_with_condition(n, cond, rng)
        a = torch.from_numpy(a64).to(torch.float32)
        b = torch.from_numpy(b64).to(torch.float32)
        # The oracle: the fp64 direct solve of the rounded system, exactly
        # the problem the fp32 solver is handed.
        xs = np.linalg.solve(a.double().numpy(), b.double().numpy())  # fp64-ok: the fp64 oracle
        xs_scale = np.max(np.abs(xs))
        a, b = a.to(dev0), b.to(dev0)

        def rel_err(x) -> float:
            return float(np.max(np.abs(x.to("cpu", torch.float64).numpy() - xs)) / xs_scale)  # fp64-ok: compared with the fp64 oracle

        entry: dict = {"cond": cond}
        solvers = {
            "cg_fp32": build_cg(strat, mesh, tol=1e-7, max_iters=args.max_iters),
            "pcg_jacobi": build_cg(strat, mesh, tol=1e-7, max_iters=args.max_iters,
                                   precondition="jacobi"),
            "refined": build_refined(strat, mesh, max_iters=args.max_iters),
        }
        for name, solver in solvers.items():
            solver(a, b)  # warm
            fence()
            t0 = time.perf_counter()
            res = solver(a, b)
            fence()
            dt = time.perf_counter() - t0
            entry[name] = {"err": rel_err(res.x), "iters": int(res.n_iters),
                           "ms": dt * 1e3, "converged": bool(res.converged)}
            print(f"cond={cond:.0e} {name:10s}: rel err {entry[name]['err']:.2e}, "
                  f"iters={entry[name]['iters']}, {dt * 1e3:.1f} ms")
        rows.append(entry)

    gains = [r["cg_fp32"]["err"] / r["refined"]["err"] for r in rows
             if r["refined"]["err"] > 0]
    report = [
        "# Mixed-precision iterative refinement: measured evidence",
        "",
        f"Device: **{platform_label(mesh)}**, {mesh.size}-shard mesh, {n}×{n} fp32 SPD "
        f"systems with prescribed spectral condition numbers (strategy "
        f"`{args.strategy}`; generated by "
        "`python -m matvec_mpi_multiplier_torch.bench.refine_study`). Forward error "
        "is against the fp64 direct solution of the rounded system; times are warm.",
        "",
        "| cond(A) | fp32 CG err | PCG(jacobi) err | refined err | CG iters | "
        "refined trips | CG ms | refined ms |",
        "|---|---|---|---|---|---|---|---|",
    ]
    marks = {"budget": False, "floor": False, "refined": False}

    def _ctl(r: dict, name: str) -> tuple[str, str]:
        if r[name]["converged"]:
            mark = ""
        elif r[name]["iters"] >= args.max_iters:
            mark, marks["budget"] = "\\*", True
        else:
            mark, marks["floor"] = "†", True
        return f"{r[name]['err']:.2e}{mark}", f"{r[name]['iters']}{mark}"

    for r in rows:
        cg_err, cg_iters = _ctl(r, "cg_fp32")
        pcg_err, _ = _ctl(r, "pcg_jacobi")
        ref_mark = "" if r["refined"]["converged"] else "‡"
        marks["refined"] |= bool(ref_mark)
        report.append(
            f"| {r['cond']:.0e} | {cg_err} | {pcg_err} | {r['refined']['err']:.2e}{ref_mark} "
            f"| {cg_iters} | {r['refined']['iters']} | {r['cg_fp32']['ms']:.1f} "
            f"| {r['refined']['ms']:.1f} |")
    if marks["budget"]:
        report += ["", f"\\* exhausted the `--max-iters` budget ({args.max_iters}) without "
                   "meeting `tol`: a truncated run, not a converged one."]
    if marks["floor"]:
        report += ["", "† stopped short of `tol` with budget to spare: fp32 CG's recurrence "
                   "stagnated at its attainable floor (about cond(A)·eps of ‖b‖)."]
    if marks["refined"]:
        report += ["", "‡ the refined solve stopped without certifying its target residual; "
                   "its error cell is still a direct measurement against the fp64 oracle."]
    report += [
        "",
        (f"Refinement improves forward error by **{min(gains):.0f}–{max(gains):.0f}×** over "
         "plain fp32 CG on this ladder" if gains
         else "Refinement gain not measurable on this ladder")
        + ": plain fp32 CG floors at about cond(A)·eps, the refined solve "
        "(`models/cg.py::build_refined`) holds about fp32-ulp accuracy until cond(A)·eps "
        "approaches 1. Jacobi PCG is the control: a diagonal preconditioner does not see "
        "spectral conditioning.",
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
