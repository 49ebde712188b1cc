"""Roofline-crossover study: where GEMV becomes GEMM on the card.

The port's counterpart of the JAX package's ``scripts/crossover_study.py``.
The reference's whole scope is ``n_rhs = 1``, the memory-bound corner of
the roofline. This study adds right-hand sides to the same blockwise
strategy (``bench/timing.py::benchmark_gemm``, the hand-written GEMM
``csrc/gemm.cu`` on every shard) and reports, per r: the measured time, its
excess over the bandwidth model anchored at the measured r = 1 row (the
measured-knee criterion), the effective GB/s against the HBM roof and the
achieved TFLOP/s against the compute roof. Every row is appended to the
extended CSV under its own ``gemm_blockwise_xover_r<r>`` label.

Roofs: the H100's data-sheet HBM3 rate and dense bf16 tensor-core peak
(the fp32 rate outside the tensor cores for fp32), times the mesh size;
``--hbm-peak-gbps`` and ``--mxu-peak-gflops`` override them per card.

Usage::

    python -m matvec_mpi_multiplier_torch.bench.crossover_study
    python -m matvec_mpi_multiplier_torch.bench.crossover_study --platform cpu \\
        --host-devices 8 --size 512 --n-rhs 1 8 64 --measure sync \\
        --data-root /tmp/x
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
from pathlib import Path

from .studies import DEMO_ROOT, add_platform_args, platform_label, study_mesh

DEFAULT_RHS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024)
# The measured knee: the first r whose time exceeds the anchored bandwidth
# prediction by this factor.
KNEE_EXCESS = 1.5


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_platform_args(p, devices=1)
    p.add_argument("--size", type=int, default=8192)
    p.add_argument("--n-rhs", type=int, nargs="*", default=list(DEFAULT_RHS))
    p.add_argument("--dtype", default="bfloat16")
    p.add_argument("--n-reps", type=int, default=20)
    p.add_argument("--measure", default="loop", choices=("loop", "sync", "chain"))
    p.add_argument("--data-root", default=str(DEMO_ROOT / "crossover"))
    p.add_argument("--no-csv", action="store_true")
    p.add_argument("--hbm-peak-gbps", type=float, default=None,
                   help="per-card HBM roof, scaled by the mesh size like the default")
    p.add_argument("--mxu-peak-gflops", type=float, default=None,
                   help="per-card compute roof, scaled by the mesh size like the default")
    p.add_argument("--report", default=None,
                   help="write the markdown report here (nothing is written otherwise)")
    p.add_argument("--no-report", action="store_true")
    p.add_argument("--fig", default=None, help="draw the roofline figure here")
    p.add_argument("--no-fig", action="store_true")
    args = p.parse_args(argv)

    import numpy as np

    from ..utils import constants
    from ..utils.errors import TimingError
    from .metrics import append_result
    from .timing import benchmark_gemm

    mesh = study_mesh(args)
    n_dev = mesh.size
    hbm = (constants.H100_HBM_PEAK_GBPS if args.hbm_peak_gbps is None
           else args.hbm_peak_gbps) * n_dev
    roof = (constants.H100_TENSOR_BF16_GFLOPS if args.dtype in ("bfloat16", "float16")
            else constants.H100_FP32_GFLOPS)
    mxu = (roof if args.mxu_peak_gflops is None else args.mxu_peak_gflops) * n_dev
    ridge = mxu / hbm
    itemsize = constants.DTYPE_ITEMSIZE[args.dtype]
    n = args.size
    rng = np.random.default_rng(7)
    a = rng.standard_normal((n, n)).astype(np.float32)

    rows = []
    for r in sorted(set(args.n_rhs)):
        b = rng.standard_normal((n, r)).astype(np.float32)
        res = None
        for attempt in (1, 2):
            try:
                res = benchmark_gemm("blockwise", mesh, a, b, dtype=args.dtype,
                                     n_reps=args.n_reps, measure=args.measure)
                break
            except TimingError as e:
                print(f"n_rhs={r} attempt {attempt}: UNMEASURABLE ({e})", file=sys.stderr)
        if res is None:
            rows.append((r, None))
            continue
        if not args.no_csv:
            # One label per r: the per-strategy CSV's consumers average rows
            # that share (strategy, m, n, p).
            append_result(dataclasses.replace(res, strategy=f"gemm_blockwise_xover_r{r}"),
                          args.data_root)
        bytes_r = itemsize * (res.n_rows * res.n_cols + res.n_cols * res.n_rhs
                              + res.n_rows * res.n_rhs)
        intensity = 2.0 * res.n_rows * res.n_cols * res.n_rhs / bytes_r
        mfu = res.gflops / mxu
        rows.append((r, dict(time_ms=res.mean_time_s * 1e3, gbps=res.gbps,
                             gflops=res.gflops, mfu=mfu, intensity=intensity,
                             hbm_frac=res.gbps / hbm, bytes=bytes_r)))
        print(f"n_rhs={r:5d}: {res.mean_time_s * 1e3:9.3f} ms  {res.gbps:8.2f} GB/s "
              f"({res.gbps / hbm:5.1%} HBM)  {res.gflops / 1e3:9.2f} TFLOP/s "
              f"(of roof {mfu:6.2%})")

    measured = [(r, m) for r, m in rows if m is not None]
    knee = None
    anchor_state = ("ok" if measured and measured[0][0] == 1
                    else "unmeasurable" if rows and rows[0][0] == 1 else "not swept")
    if anchor_state == "ok":
        t1, b1 = measured[0][1]["time_ms"], measured[0][1]["bytes"]
        for r, m in measured[1:]:
            m["excess"] = m["time_ms"] / (t1 * m["bytes"] / b1)
            if knee is None and m["excess"] >= KNEE_EXCESS:
                knee = r

    report = [
        "# GEMV→GEMM roofline crossover (measured)",
        "",
        f"Device: **{platform_label(mesh)}**, {n_dev}-shard mesh, blockwise strategy, "
        f"A {n}×{n} {args.dtype}, B {n}×r, measure={args.measure}, {args.n_reps} reps "
        "(generated by `python -m matvec_mpi_multiplier_torch.bench.crossover_study`).",
        "",
        f"Roofs used: HBM {hbm:.0f} GB/s, compute {mxu / 1e3:.0f} TFLOP/s → ridge "
        f"intensity {ridge:.0f} FLOP/byte; the model I(r) ≈ 2r/{itemsize} for r ≪ n "
        f"puts the knee near r ≈ {ridge * itemsize / 2:.0f}.",
        "",
        "| n_rhs | I(r) FLOP/B | time (ms) | t/t_bw(r) | GB/s | %HBM | TFLOP/s | % of roof |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for r, m in rows:
        if m is None:
            report.append(f"| {r} | — | unmeasurable | — | — | — | — | — |")
            continue
        excess = (f"{m['excess']:.2f}" if "excess" in m
                  else "1 (anchor)" if r == 1 else "—")
        report.append(
            f"| {r} | {m['intensity']:.1f} | {m['time_ms']:.3f} | {excess} | "
            f"{m['gbps']:.1f} | {m['hbm_frac']:.1%} | {m['gflops'] / 1e3:.2f} | "
            f"{m['mfu']:.2%} |")
    report += [
        "",
        "t/t_bw(r) is the measured time over the bandwidth model anchored at the "
        "measured r = 1 row (bytes(r)/bytes(1) × t(1)); the %HBM and % of roof "
        "columns share one measured time.",
        "",
        (f"Measured knee (first r with t/t_bw ≥ {KNEE_EXCESS}): **r = {knee}** against "
         f"the data-sheet ridge r ≈ {ridge * itemsize / 2:.0f}." if knee is not None
         else "No measured knee inside the swept range: every row tracks the "
         "bandwidth model." if anchor_state == "ok"
         else "t/t_bw needs the r = 1 anchor, which was unmeasurable: no knee."
         if anchor_state == "unmeasurable"
         else "t/t_bw needs the r = 1 anchor: add 1 to --n-rhs."),
    ]
    if args.fig and not args.no_fig:
        try:
            from ..analysis.plots import plot_crossover_roofline

            fig_path = plot_crossover_roofline(
                [(r, m["intensity"], m["gflops"]) for r, m in measured],
                args.fig, hbm_peak_gbps=hbm, mxu_peak_gflops=mxu)
        except ImportError as e:
            print(f"figure skipped: {e}", file=sys.stderr)
            fig_path = None
        if fig_path is not None:
            report += ["", f"Figure: `{fig_path}`."]
            print(f"figure: {fig_path}")
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
