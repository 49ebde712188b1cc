"""Two checkouts of the port on one card: the GEMM and the serve cells.

    python3 matvec_mpi_multiplier_torch/bench/compare_checkouts.py [--quant|--gemv|--graphs|--load] ROOT [ROOT ...]

Runs each ROOT (a checkout, or an unpacked ``git archive``) in a process of
its own, in the order given (``parent change change parent`` is the fair
order), and prints one JSON line per run: ``gemm_cuda``'s time at
``chip_smoke.py``'s GEMM shapes (CUDA events, 20 launches), its host cost
per call on a tiny product, and ``run_serve`` at ``chip_smoke.py``'s serve
cells (req/s, p50/p99 dispatch ms, promotion speedup). With ``--quant`` it
runs the quantized side instead: ``quant_gemv_cuda``'s time at 65536² fp32
for each format and width 1, 4 and 32 (CUDA events, 10 launches), and
``run_serve`` at ``chip_smoke.py``'s two quantized serve cells. With
``--gemv`` it times the GEMV: ``gemv_cuda`` at the sweep's asymmetric
shapes (``bench/sweep.py``'s ``ASYMMETRIC_SIZES``, fp32 and bf16, one launch
at a time after overwriting 4x the L2, median of 20, as ``chip_smoke.py``'s
``asymmetric`` phase), at ``chip_smoke.py``'s ``KERNEL_SHAPES`` (CUDA
events, 50 launches) and the fused cg step at 65536² fp32 (20 launches).
With ``--graphs`` it runs what a checkout's dispatch and loop choices move:
``run_serve`` at the serve cells, chebyshev at 65536² fp32 through the
engine on both solver tiers (ms per iteration) and ``run_serve_solver``'s
20 cg solves on both tiers (solves/s). With ``--load`` it runs
``run_serve_load`` at ``chip_smoke.py``'s load cell (blockwise 65536² bf16,
200 requests, closed loop at 8 and 32 clients, coalescing off and on):
req/s, p50/p99 request ms, mean batch width, and the steady flushes with
the wall time per flush (a checkout whose serve bench has no load mode
cannot run it).
Each ROOT builds its own kernels. Needs a CUDA card; numbers from two runs compare
only when they come from one command on one card.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

GEMM_SHAPES = [(65536, 65536, n, "bfloat16") for n in (4, 8, 16, 32, 64, 128)] + [
    (16384, 16384, n, "float32") for n in (4, 8, 16, 32)] + [
    (4096, 4096, 4096, "bfloat16"), (4096, 4096, 4096, "float32")]
# (label, strategy, n, dtype, shards on cuda:0, mesh kind, combine, stages,
# requests): chip_smoke.py's SERVE_CONFIGS and RING_SERVE_CONFIGS.
SERVE_CELLS = [
    ("65536_bf16", "blockwise", 65536, "bfloat16", 1, "2d", None, None, 200),
    ("2x2_32768_fp32", "blockwise", 32768, "float32", 4, "2d", None, None, 40),
    ("colwise_pallas_ring", "colwise", 65536, "bfloat16", 4, "1d", "pallas_ring", None, 200),
    ("colwise_overlap@4", "colwise", 65536, "bfloat16", 4, "1d", "overlap", 4, 40),
]
# (label, strategy, n, dtype, shards on cuda:0, storage, requests):
# chip_smoke.py's QUANT_SERVE_CONFIGS.
QUANT_SERVE_CELLS = [
    ("65536_fp32_int8c", "blockwise", 65536, "float32", 1, "int8c", 200),
    ("2x2_32768_fp32_int8", "blockwise", 32768, "float32", 4, "int8", 40),
]
QUANT_N = 65536
QUANT_WIDTHS = (1, 4, 32)
# chip_smoke.py's KERNEL_SHAPES and its fused step's width.
GEMV_SQUARE = [(16384, "float32"), (32768, "bfloat16"), (65536, "bfloat16")]
GEMV_STEP_N = 65536
MODES = ("--quant", "--gemv", "--graphs", "--load")
# chip_smoke.py's load cell: LOAD_N, LOAD_REQUESTS, the closed loops'
# client counts, and b* = flush width.
LOAD_N, LOAD_REQUESTS, LOAD_CLIENTS, LOAD_PROMOTE = 65536, 200, (8, 32), 4
# chip_smoke.py's served solvers: chebyshev's rtol, cap and width.
SOLVER_N, CHEBYSHEV_RTOL, CHEBYSHEV_MAXITER = 65536, 1e-4, 3000


def measure(root: Path, mode: str | None = None) -> dict:
    """This process's measurements of the port under ``root``: the GEMM and
    the serve cells, or with ``--quant`` the quantized GEMV and serve cells,
    or with ``--gemv`` the GEMV and the fused step."""
    here = Path(__file__).resolve().parent  # not an import root
    sys.path[:] = [str(root)] + [p for p in sys.path if Path(p or ".").resolve() != here]
    import torch

    from matvec_mpi_multiplier_torch import make_1d_mesh, make_mesh
    from matvec_mpi_multiplier_torch.bench.serve import run_serve
    from matvec_mpi_multiplier_torch.ops.cuda_gemm import gemm_cuda

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)

    def uniform(shape, dtype):
        return (torch.rand(shape, generator=gen, device=dev) * 10).to(dtype)

    def event_ms(fn, reps=20):
        fn(), fn()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize(dev)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize(dev)
        return start.elapsed_time(end) / reps

    if mode == "--quant":
        return measure_quant(root, dev, uniform, event_ms)
    if mode == "--gemv":
        return measure_gemv(root, dev, uniform, event_ms)
    if mode == "--load":
        return measure_load(root, dev, make_mesh)
    out = {"root": str(root), "gemm_ms": {}, "serve": {}}
    if mode == "--graphs":
        out = {"root": str(root), "serve": serve_cells(dev, make_mesh, make_1d_mesh, run_serve)}
        out.update(measure_solvers(dev, make_mesh))
        return out
    held = {}
    for m, k, n, name in GEMM_SHAPES:
        dtype = getattr(torch, name)
        if held.get("key") != (m, k, name):
            held.clear()
            torch.cuda.empty_cache()
            held.update(key=(m, k, name), a=uniform((m, k), dtype))
        b = uniform((k, n), dtype)
        out["gemm_ms"][f"{m}x{k}x{n}_{name}"] = event_ms(lambda: gemm_cuda(held["a"], b))
    held.clear()
    torch.cuda.empty_cache()
    a, b = uniform((128, 64), torch.bfloat16), uniform((64, 8), torch.bfloat16)
    event_ms(lambda: gemm_cuda(a, b))
    t0 = time.perf_counter()
    for _ in range(2000):
        gemm_cuda(a, b)
    torch.cuda.synchronize(dev)
    out["host_us_per_call_128x64x8"] = (time.perf_counter() - t0) / 2000 * 1e6
    out["serve"] = serve_cells(dev, make_mesh, make_1d_mesh, run_serve)
    return out


def serve_cells(dev, make_mesh, make_1d_mesh, run_serve) -> dict:
    """``run_serve`` at :data:`SERVE_CELLS`: req/s, p50/p99 dispatch ms,
    promotion speedup."""
    import torch

    out = {}
    for label, strategy, n, dtype, shards, kind, combine, stages, requests in SERVE_CELLS:
        devices = [dev] * shards
        mesh = (make_1d_mesh(shards, devices=devices) if kind == "1d"
                else make_mesh(1) if shards == 1 else make_mesh(shards, devices=devices))
        res = run_serve(strategy, mesh, n, n, dtype=dtype, kernel="cuda", combine=combine,
                        stages=stages, max_bucket=32, promote=4, n_requests=requests, seed=0)
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        out[label] = {"req_per_s": res.rps, "p50_dispatch_ms": res.p50_dispatch_ms,
                      "p99_dispatch_ms": res.p99_dispatch_ms,
                      "promo_speedup": res.promo_speedup}
    return out


def measure_load(root: Path, dev, make_mesh) -> dict:
    """``run_serve_load`` at the load cell, coalescing off and on, for the
    port under ``root``."""
    import tempfile

    import torch

    from matvec_mpi_multiplier_torch.bench.serve import run_serve_load

    out = {"root": str(root), "load": {}}
    for clients in LOAD_CLIENTS:
        for coalesce in (False, True):
            with tempfile.TemporaryDirectory() as tmp:
                snap = Path(tmp) / "metrics.json"
                res = run_serve_load(
                    "blockwise", make_mesh(1), LOAD_N, LOAD_N, dtype="bfloat16",
                    kernel="cuda", n_requests=LOAD_REQUESTS, max_bucket=32,
                    promote=LOAD_PROMOTE, flush_width=LOAD_PROMOTE, seed=0,
                    concurrency=clients, coalesce=coalesce, metrics_out=str(snap))
                counters = json.loads(snap.read_text())["counters"]
            torch.cuda.synchronize(dev)
            torch.cuda.empty_cache()
            flushes = counters.get("sched_batches_total")
            out["load"][f"c{clients}_{'on' if coalesce else 'off'}"] = {
                "req_per_s": res.rps, "p50_request_ms": res.p50_dispatch_ms,
                "p99_request_ms": res.p99_dispatch_ms,
                "mean_batch_width": res.mean_batch_width, "flushes": flushes,
                "ms_per_flush": res.wall_s * 1e3 / flushes if flushes else None}
    return out


def measure_solvers(dev, make_mesh) -> dict:
    """Chebyshev at 65536² fp32 rowwise through the engine on both tiers
    (host clock around submit and result, ms per iteration), then
    ``run_serve_solver``'s 20 cg solves on both tiers."""
    import numpy as np
    import torch

    from matvec_mpi_multiplier_torch.bench.serve import (
        gershgorin_interval,
        run_serve_solver,
        solver_operand,
    )
    from matvec_mpi_multiplier_torch.engine import MatvecEngine

    mesh = make_mesh(1)
    a = solver_operand(SOLVER_N, "float32", 0, device=dev)
    interval = gershgorin_interval(a)
    b = torch.from_numpy(np.random.default_rng(1).standard_normal(SOLVER_N)
                         .astype(np.float32))
    out = {"chebyshev": {}, "serve_solver_cg": {}}
    for tier in ("torch", "cuda_fused"):
        engine = MatvecEngine(a, mesh, strategy="rowwise", promote=None, solver_kernel=tier)
        for _ in range(2):  # the first solve builds the loop
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            res = engine.submit(op="chebyshev", rhs=b, rtol=CHEBYSHEV_RTOL,
                                maxiter=CHEBYSHEV_MAXITER, interval=interval).result()
            ms = (time.perf_counter() - t0) * 1e3
        out["chebyshev"][tier] = {"n_iters": res.n_iters, "solve_ms": ms,
                                  "ms_per_iter": ms / res.n_iters}
        del engine
    del a
    torch.cuda.empty_cache()
    for tier in ("torch", "cuda_fused"):
        res = run_serve_solver("rowwise", mesh, SOLVER_N, op="cg", solver_kernel=tier,
                               rtol=1e-5, n_solves=20, seed=0)
        out["serve_solver_cg"][tier] = {"solves_per_s": res.solves_per_s,
                                        "solve_p50_ms": res.solve_p50_ms,
                                        "time_per_iter_ms": res.time_per_iter_ms}
        torch.cuda.empty_cache()
    return out


def measure_quant(root: Path, dev, uniform, event_ms) -> dict:
    """``quant_gemv_cuda`` at 65536² fp32 per format and width, then the
    quantized serve cells, for the port under ``root``."""
    import torch

    from matvec_mpi_multiplier_torch import make_mesh
    from matvec_mpi_multiplier_torch.bench.serve import run_serve
    from matvec_mpi_multiplier_torch.ops.cuda_quant import quant_gemv_cuda
    from matvec_mpi_multiplier_torch.ops.quantize import quantize_matrix

    out = {"root": str(root), "quant_gemv_ms": {}, "serve": {}}
    a = uniform((QUANT_N, QUANT_N), torch.float32)
    for fmt in ("int8", "int8c", "fp8"):
        qa = quantize_matrix(a, fmt)
        for w in QUANT_WIDTHS:
            x = uniform((QUANT_N,) if w == 1 else (QUANT_N, w), torch.float32)
            out["quant_gemv_ms"][f"{QUANT_N}x{QUANT_N}_{fmt}_n{w}"] = event_ms(
                lambda: quant_gemv_cuda(qa, x), reps=10)
        del qa
        torch.cuda.empty_cache()
    del a
    torch.cuda.empty_cache()
    for label, strategy, n, dtype, shards, storage, requests in QUANT_SERVE_CELLS:
        mesh = make_mesh(1) if shards == 1 else make_mesh(shards, devices=[dev] * shards)
        res = run_serve(strategy, mesh, n, n, dtype=dtype, kernel="cuda", max_bucket=32,
                        promote=4, n_requests=requests, seed=0, dtype_storage=storage)
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        out["serve"][label] = {"req_per_s": res.rps, "p50_dispatch_ms": res.p50_dispatch_ms,
                               "p99_dispatch_ms": res.p99_dispatch_ms,
                               "promo_speedup": res.promo_speedup}
    return out


def measure_gemv(root: Path, dev, uniform, event_ms) -> dict:
    """``gemv_cuda`` at the asymmetric shapes (cold L2) and the square ones,
    then the fused cg step at 65536² fp32, for the port under ``root``."""
    import torch

    from matvec_mpi_multiplier_torch.bench.sweep import ASYMMETRIC_SIZES
    from matvec_mpi_multiplier_torch.ops.cuda_gemv import gemv_cuda
    from matvec_mpi_multiplier_torch.ops.cuda_solver import solver_step_cuda
    from matvec_mpi_multiplier_torch.utils.constants import H100_L2_BYTES

    flush = torch.empty(4 * H100_L2_BYTES // 4, dtype=torch.float32, device=dev)

    def cold_ms(fn, reps=20):
        fn()
        pairs = []
        for _ in range(reps):
            flush.zero_()
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            fn()
            end.record()
            pairs.append((start, end))
        torch.cuda.synchronize(dev)
        return statistics.median(s.elapsed_time(e) for s, e in pairs)

    out = {"root": str(root), "asymmetric_ms": {}, "square_ms": {}}
    for m, k in ASYMMETRIC_SIZES:
        for name in ("float32", "bfloat16"):
            a, x = uniform((m, k), getattr(torch, name)), uniform((k,), getattr(torch, name))
            out["asymmetric_ms"][f"{m}x{k}_{name}"] = cold_ms(lambda: gemv_cuda(a, x))
    del flush
    for n, name in GEMV_SQUARE:
        torch.cuda.empty_cache()
        a, x = uniform((n, n), getattr(torch, name)), uniform((n,), getattr(torch, name))
        out["square_ms"][f"{n}x{n}_{name}"] = event_ms(lambda: gemv_cuda(a, x), reps=50)
        del a, x
    torch.cuda.empty_cache()
    n = GEMV_STEP_N
    a = uniform((n, n), torch.float32)
    x = torch.zeros(n, device=dev)
    r, p, ap = (uniform((n,), torch.float32) for _ in range(3))
    s_in = torch.sum(r * r).reshape(1)
    out["cg_step_ms"] = event_ms(lambda: solver_step_cuda("cg", a, 0, x, r, p, ap, s_in),
                                 reps=20)
    out["gemv_routes"] = dict(getattr(gemv_cuda, "route_launches", {}))
    return out


def main(argv: list[str]) -> int:
    mode = argv[0] if argv and argv[0] in MODES else None
    if mode:
        argv = argv[1:]
    if len(argv) == 2 and argv[0] == "--one":
        print(json.dumps(measure(Path(argv[1]).resolve(), mode)), flush=True)
        return 0
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    for root in argv:
        flags = [mode] if mode else []
        proc = subprocess.run([sys.executable, __file__, *flags, "--one", root], check=False)
        if proc.returncode:
            return proc.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
