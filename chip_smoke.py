#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--seed N]

Builds the hand-written CUDA kernels (``csrc/gemv.cu``, ``csrc/gemm.cu``,
``csrc/quant_gemv.cu``, ``csrc/solver_step.cu``, ``csrc/ring_gemv.cu``; one
``nvcc`` each, in parallel) from the checkout's sources, holds each against its plain
PyTorch version, and drives the port's paths at full size, each with the
kernels' launch counts set to 0 just before it and read just after:

* the three strategies through ``build(..., kernel="cuda")`` and the
  reference timing protocol (the GEMV);
* the serving engine through ``bench.serve.run_serve``: a mixed-width
  request stream at 65536² bf16 on one card and at 32768² fp32 on a 2x2
  logical mesh, narrow blocks through the GEMV and promoted blocks through
  the GEMM;
* the GEMM through the sweep's entry point, ``benchmark_gemm``;
* quantized storage (int8, int8c, fp8): the quantizer on the card against
  the CPU, ``benchmark_strategy(..., dtype_storage=...)`` at 65536² fp32
  and colwise 32768² on 4 logical shards, and ``run_serve`` from an int8c
  resident at 65536² fp32 and an int8 one on a 2x2 mesh, every matvec and
  promoted block through the block-scaled GEMV;
* served solvers through ``MatvecEngine.submit(op=...)`` on the seeded SPD
  ``solver_operand`` built on the card: cg and chebyshev at 65536² fp32
  rowwise on both iteration tiers (``torch``, and ``cuda_fused``, one fused
  step per iteration), gmres, power and lanczos on the ``torch`` tier,
  fused cg on colwise 32768² over 4 logical shards and from an int8c
  resident at 65536², and ``bench.serve.run_serve_solver`` (20 cg solves
  at 65536² on both tiers);
* colwise's combine schedules on 4 logical shards at 65536² bf16: the ring
  GEMV against its plain version (p = 1, 2, 4, 8, 16), ``benchmark_strategy``
  with every colwise combine (``pallas_ring`` through the ring GEMV, the
  others through the GEMV) and rowwise/blockwise's ``ring``/``overlap``
  gathers, each held against ``psum`` and to no panel-sized allocation, and
  ``run_serve`` with ``pallas_ring`` and ``overlap@4``.

It checks the answers and times each kernel beside its bound, its plain
version and the library call. Every phase prints one JSON line; any failed
check raises, and the script exits non-zero. The line before the last is
``{"kernels": [...]}``; the last is ``{"ok": true, "device": {...}}``.

Needs a CUDA device and ``nvcc``; without a card it exits non-zero and
prints no result. Writes no CSV (``benchmark_*`` and ``run_serve`` write
none) and imports nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import json
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

N_REPS = 100
CHAIN_SAMPLES = 5

# The committed 4x8 correctness fixture (data/matrix_4_8.txt, vector_8.txt)
# and its product.
FIXTURE_MATRIX = [
    [2.4, 2.1, 8.4, 4.1, 5.0, 6.0, 7.0, 8.0],
    [9.4, 1.2, 3.45, 0.1, 5.0, 6.0, 7.0, 8.0],
    [1.4, 4.6, 0.99, 1.0, 5.0, 6.0, 7.0, 8.0],
    [0.1, 2.5, 4.6, 10.0, 5.0, 6.0, 7.0, 8.0],
]
FIXTURE_VECTOR = [1.0, 2.0, 3.0, 4.0, 5.0, 6.0, 7.0, 8.0]
FIXTURE_PRODUCT = [222.2, 196.55, 191.57, 232.9]

CHECK_SHAPES = [(4, 8), (1000, 3001), (4096, 4096), (120, 60000)]
# (strategy, n, dtype, logical shards on cuda:0)
MAIN_CONFIGS = [
    ("blockwise", 65536, "bfloat16", 1),
    ("rowwise", 32768, "bfloat16", 1),
    ("colwise", 32768, "bfloat16", 1),
    ("blockwise", 32768, "bfloat16", 1),
    # fp32 at p=1 beside the 2x2 logical mesh: the same dtype and bytes,
    # so the difference between the two is the combine and the 3 extra
    # launches.
    ("blockwise", 32768, "float32", 1),
    ("blockwise", 32768, "float32", 4),
]
# The shapes and dtypes the main path hands the kernel: the p=1 bf16
# matrices, and the 16384² fp32 blocks of the 2x2 mesh. The last is the
# head of the kernels line.
KERNEL_SHAPES = [(16384, "float32"), (32768, "bfloat16"), (65536, "bfloat16")]
# The fp32 output against the plain version at those shapes: sums of
# k >= 16384 positive terms in another order differ by about sqrt(k)·eps32.
MAIN_SHAPE_RTOL = 1e-4
ASYMMETRIC_SHAPES = [(120, 60000), (1200, 60000)]
# Peak fp32 rate outside the tensor cores (H100 SXM data sheet): the
# GEMV's 2·m·k flops run there, as do the GEMM's for fp32 (FFMA) and fp64
# (DFMA, the same 67 TFLOP/s).
FP32_PEAK_FLOPS = 67e12
# Dense bf16/fp16 tensor-core peak (H100 SXM data sheet): the GEMM's
# 16-bit route (mma.sync).
TENSOR_PEAK_FLOPS = 989e12

# (m, k, n): the 4x8 fixture, a ragged shape, the engine's widths at 4096²,
# and a square GEMM that tiles n.
GEMM_CHECK_SHAPES = [(4, 8, 3), (1000, 3001, 5), (4096, 4096, 1),
                     (4096, 4096, 4), (4096, 4096, 32), (4096, 4096, 128),
                     (2048, 2048, 2048)]
# (label, strategy, n, dtype, logical shards on cuda:0, steady requests)
SERVE_CONFIGS = [
    ("65536_bf16", "blockwise", 65536, "bfloat16", 1, 200),
    ("2x2_32768_fp32", "blockwise", 32768, "float32", 4, 40),
]
SERVE_MAX_BUCKET = 32
SERVE_PROMOTE = 4
# (m, k, n, dtype): the engine's promoted buckets at 65536² bf16, the 2x2
# mesh's 16384² fp32 shard at width 8, and the sweep's square GEMM. The
# kernels line reports GEMM_HEAD, the widest bucket of the full-width cell.
GEMM_TIME_SHAPES = [(65536, 65536, 4, "bfloat16"), (65536, 65536, 8, "bfloat16"),
                    (65536, 65536, 16, "bfloat16"), (65536, 65536, 32, "bfloat16"),
                    (16384, 16384, 8, "float32"), (4096, 4096, 4096, "bfloat16"),
                    (4096, 4096, 4096, "float32")]
GEMM_HEAD = 3

# Quantized storage. (m, k, block): the 4x8 fixture's shape, JAX's block-48
# test shape, a ragged shape, a square one and the asymmetric regime, whose
# default block at k = 60000 is 32.
QUANT_CHECK_SHAPES = [(4, 8, 4), (6, 96, 48), (1000, 3008, 64), (4096, 4096, 128),
                      (120, 60000, 32)]
QUANT_FORMATS = ("int8", "int8c", "fp8")
QUANT_WIDTHS = (None, 4, 32)  # x as (k,), (k, 4), (k, 32)
# (strategy, n, format, logical shards on cuda:0); native rows are the
# comparison at the same A.
QUANT_MAIN_CONFIGS = [
    ("blockwise", 65536, "native", 1), ("blockwise", 65536, "int8", 1),
    ("blockwise", 65536, "int8c", 1), ("blockwise", 65536, "fp8", 1),
    ("colwise", 32768, "int8c", 4),
]
# (label, strategy, n, dtype, format, logical shards on cuda:0, requests)
QUANT_SERVE_CONFIGS = [
    ("65536_fp32_int8c", "blockwise", 65536, "float32", "int8c", 1, 200),
    ("2x2_32768_fp32_int8", "blockwise", 32768, "float32", "int8", 4, 40),
]
# (n, format, width): the shapes the quantized path hands the kernel; the
# last row is the 2x2 mesh's 16384² int8 shard. QUANT_HEAD is the kernels
# line's head: the int8c vector at full width, the serve cell's GEMV.
QUANT_TIME_SHAPES = [(65536, f, w) for f in QUANT_FORMATS for w in (1, 4, 32)] + [
    (16384, "int8", 1)]
QUANT_HEAD = 3

# Served solvers. The fused step against its plain version, (m_loc, k_loc,
# n, off): rowwise shards (off = 0, all of p) and a colwise segment at
# off > 0; a payload's k rounds up to a multiple of 8 (whole scale blocks).
# The full-width case is SOLVER_N below.
SOLVER_CHECK_SHAPES = [(4, 8, 8, 0), (96, 96, 96, 0), (1000, 3001, 3001, 0),
                       (4096, 4096, 4096, 0), (4096, 1024, 4096, 2048)]
SOLVER_CHECK_STORAGE = ("float32", "float64", "bfloat16", "int8", "int8c", "fp8")
SOLVER_OPS_FUSED = ("cg", "chebyshev")
SOLVER_N = 65536  # rowwise, p = 1, fp32, solver_operand built on the card
SOLVER_COLWISE_N = 32768  # colwise on 4 logical shards
SOLVER_RTOL = 1e-5
# power and lanczos in fp32: the eigenresidual's rounding floor at this
# width sits near 1e-5 of lambda, so they stop at 1e-4.
SOLVER_EIGEN_RTOL = 1e-4
# The Gershgorin interval [1, 5.5e4] is wide against the spectrum
# [2.1e4, 3.3e4]: about 1200 Chebyshev iterations at rtol 1e-4. At 1e-5 the
# fp32 recurrence stalls: on an H100 it ended 3000 iterations at a relative
# residual of 1.26e-5 (PERF.md), the floor its rounding leaves at this width.
CHEBYSHEV_RTOL = 1e-4
CHEBYSHEV_MAXITER = 3000
SOLVER_SERVE_SOLVES = 20

# The ring GEMV and the combine schedules. (m, k) checked for p = 1, 2, 4, 8:
# a square shape and a ragged one (1003 rows per chunk and 1542-byte bf16
# rows at p = 8); p = 16 (a non-portable cluster) at the first.
RING_CHECK_SHAPES = [(4096, 4096), (8024, 6168)]
RING_CHECK_DTYPES = ("float32", "bfloat16", "float64")
RING_N = 65536  # bf16, the north-star shape
RING_TIME_P = (4, 8)  # the kernels line's head is the first
# (strategy, combine, stages, mesh) at RING_N bf16 on 4 logical shards of
# cuda:0; "1d" is make_1d_mesh(4), "2x2" make_mesh(4).
RING_MAIN_CONFIGS = [
    ("colwise", "psum", None, "1d"), ("colwise", "psum_scatter", None, "1d"),
    ("colwise", "ring", None, "1d"), ("colwise", "ring_overlap", None, "1d"),
    ("colwise", "a2a", None, "1d"), ("colwise", "overlap", None, "1d"),
    ("colwise", "overlap", 8, "1d"), ("colwise", "overlap_ring", None, "1d"),
    ("colwise", "pallas_ring", None, "1d"),
    ("rowwise", "ring", None, "1d"), ("rowwise", "overlap", None, "1d"),
    ("blockwise", "ring", None, "2x2"), ("blockwise", "overlap", None, "2x2"),
]
# (combine, stages, steady requests) for run_serve, colwise on the 1-D mesh.
RING_SERVE_CONFIGS = [("pallas_ring", None, 200), ("overlap", 4, 40)]


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[1])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this test runs "
              "on a CUDA card only", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import numpy as np

    from matvec_mpi_multiplier_torch import get_strategy, make_1d_mesh, make_mesh
    from matvec_mpi_multiplier_torch.bench.serve import (
        DEFAULT_WIDTH_MIX,
        _request_pool,
        gershgorin_interval,
        resident_matrix,
        run_serve,
        run_serve_solver,
        solver_operand,
    )
    from matvec_mpi_multiplier_torch.bench.timing import (
        benchmark_gemm,
        benchmark_strategy,
    )
    from matvec_mpi_multiplier_torch.engine import MatvecEngine, bucket_for
    from matvec_mpi_multiplier_torch.models.gemm import build_gemm
    from matvec_mpi_multiplier_torch.parallel.mesh import (
        ShardedTensor,
        psum_scatter,
        unshard,
    )
    from matvec_mpi_multiplier_torch.ops import _build
    from matvec_mpi_multiplier_torch.ops.cuda_gemm import gemm_cuda, gemm_plain
    from matvec_mpi_multiplier_torch.ops.cuda_gemv import gemv_cuda, gemv_plain
    from matvec_mpi_multiplier_torch.ops.cuda_quant import (
        quant_gemv_cuda,
        quant_gemv_plain,
    )
    from matvec_mpi_multiplier_torch.ops.cuda_ring import (
        ring_gemv_cuda,
        ring_gemv_plain,
    )
    from matvec_mpi_multiplier_torch.ops.cuda_solver import (
        solver_step_cuda,
        solver_step_plain,
    )
    from matvec_mpi_multiplier_torch.ops.quantize import (
        CHUNK_BYTES,
        FP32_LEVEL_RELERR,
        INT8_EPS,
        INT8C_EPS,
        QuantizedMatrix,
        quantize_matrix,
    )
    from matvec_mpi_multiplier_torch.utils.constants import (
        H100_HBM_PEAK_GBPS,
        H100_L2_BYTES,
    )
    from matvec_mpi_multiplier_torch.utils.convert import torch_dtype

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)

    def uniform(shape, dtype):
        """Operands on the card, uniform [0, 10) (the reference's range),
        made in row chunks so no full-size fp32 copy is ever held."""
        out = torch.empty(shape, dtype=dtype, device=dev)
        flat = out.view(-1, shape[-1]) if len(shape) > 1 else out.view(1, -1)
        rows = max(1, (1 << 28) // flat.shape[1])
        for i in range(0, flat.shape[0], rows):
            n = min(rows, flat.shape[0] - i)
            flat[i:i + n] = torch.rand(
                (n, flat.shape[1]), generator=gen, device=dev
            ) * 10
        return out

    def event_ms(fn, reps: int, warmup: int = 2) -> float:
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize(dev)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize(dev)
        return start.elapsed_time(end) / reps

    def check_serve_replay(strategy, mesh, n, dtype, n_requests) -> dict:
        """run_serve's steady stream (the same seeded A, pool and width
        sequence) replayed through a fresh engine: the kernels are bitwise
        deterministic, so these are run_serve's results. Every result must
        be finite and of the right shape, and one request of each width
        must match the plain version after the cast to the storage dtype."""
        a = resident_matrix(n, n, dtype, dev, args.seed)
        engine = MatvecEngine(a, mesh, strategy=strategy, kernel="cuda",
                              max_bucket=SERVE_MAX_BUCKET, promote=SERVE_PROMOTE)
        widths = [w for w in DEFAULT_WIDTH_MIX if w <= SERVE_MAX_BUCKET]
        pool = _request_pool(n, widths, dtype, seed=args.seed + 1)
        sequence = np.random.default_rng(args.seed + 2).choice(
            list(pool), size=n_requests)
        # bf16: one ulp after the cast; fp32: sums in another order.
        rtol = 2 ** -7 if dtype == torch.bfloat16 else 1e-4
        rel = {}
        for w in map(int, sequence):
            y = engine.submit(pool[w]).result()
            check(tuple(y.shape) == (n, w) and bool(torch.isfinite(y).all()),
                  f"serve replay: a width-{w} result is not {n}x{w} finite values")
            if w not in rel:
                ref = gemm_plain(a, pool[w].to(dev)).to(dtype).cpu().float()
                rel[w] = ((y.float() - ref).abs() / ref.abs()).max().item()
                check(rel[w] <= rtol, f"serve replay width {w}: rel err {rel[w]} > {rtol}")
        del engine, a
        return {"requests": len(sequence), "all_finite": True, "rtol": rtol,
                "max_rel_err_by_width": {str(w): rel[w] for w in sorted(rel)}}

    # ---- 1. env ----
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    nvcc = _build.find_nvcc()
    nvcc_version = subprocess.run(
        [nvcc, "--version"], capture_output=True, text=True, check=True,
        timeout=60,
    ).stdout.strip().splitlines()[-1]
    emit({"phase": "env", "torch": torch.__version__, "cuda": torch.version.cuda,
          "capability": list(torch.cuda.get_device_capability(dev)),
          "device": torch.cuda.get_device_name(dev), "nvcc": nvcc_version,
          "nvidia_smi": smi, "allow_tf32": False})
    print(smi, flush=True)

    # ---- 2. build, from the sources, with no prior build directory ----
    shutil.rmtree(_build.BUILD_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    log = _build.build_library()
    build_s = time.perf_counter() - t0
    _build.load_library()
    root = Path(__file__).resolve().parent
    # ptxas reports each kernel as "Compiling entry function '<name>'"
    # followed by its "Used N registers, ..." line.
    ptxas, entry = [], None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            entry = ln.split("'")[1]
        elif "Used" in ln and entry is not None:
            ptxas.append({"kernel": entry, "used": ln.split(":", 1)[-1].strip()})
    emit({"phase": "build",
          "sources": [str(s.relative_to(root)) for s in _build.SOURCES],
          "seconds": round(build_s, 3), "ptxas": ptxas,
          "spills": sorted({ln.split(":", 1)[-1].strip() for ln in log.splitlines()
                            if "spill" in ln}),
          "warnings": [ln.strip() for ln in log.splitlines() if "warning" in ln]})

    # ---- 3. kernel against its plain version ----
    for m, k in CHECK_SHAPES:
        for name in ("bfloat16", "float16", "float32", "float64"):
            dtype = torch_dtype(name)
            if (m, k) == (4, 8):
                a = torch.tensor(FIXTURE_MATRIX, dtype=torch.float64).to(dev, dtype)
                x = torch.tensor(FIXTURE_VECTOR, dtype=torch.float64).to(dev, dtype)
            else:
                a, x = uniform((m, k), dtype), uniform((k,), dtype)
            y1, y2 = gemv_cuda(a, x), gemv_cuda(a, x)
            ref = gemv_plain(a, x)
            torch.cuda.synchronize(dev)
            # fp64 sums agree to ~k·eps64. The fp32 accumulator of
            # bf16/fp16/fp32 input, summed in another order, differs by
            # about sqrt(k)·eps32: 1e-5 up to k = 4096, 1e-4 at k >= 32768.
            rtol = 1e-12 if dtype == torch.float64 else (1e-5 if k <= 4096 else 1e-4)
            rel = ((y1 - ref).abs() / ref.abs()).max().item()
            check(rel <= rtol, f"gemv {m}x{k} {name}: rel err {rel} > {rtol}")
            check(torch.equal(y1, y2), f"gemv {m}x{k} {name}: two runs differ")
            if (m, k) == (4, 8) and dtype == torch.float64:
                expect = torch.tensor(FIXTURE_PRODUCT, dtype=torch.float64, device=dev)
                check(torch.allclose(y1, expect, rtol=1e-12, atol=0),
                      f"fixture product {y1.tolist()} != {FIXTURE_PRODUCT}")
            emit({"phase": "kernel_vs_plain", "kernel": "gemv", "shape": [m, k],
                  "dtype": name, "max_abs_err": (y1 - ref).abs().max().item(),
                  "max_rel_err": rel, "rtol": rtol, "bitwise_repeatable": True})
            del a, x, y1, y2, ref

    # ---- 4. main path through the entry points ----
    n1 = max(1, N_REPS // 10)
    calls_per_config = 1 + CHAIN_SAMPLES * (2 * n1 + N_REPS) + 1  # + the check
    gemv_cuda.launches = 0
    expected = 0
    operands: dict = {}
    for strategy, n, name, shards in MAIN_CONFIGS:
        dtype = torch_dtype(name)
        if operands.get("key") != (n, name):
            operands.clear()
            torch.cuda.empty_cache()
            operands.update(key=(n, name), a=uniform((n, n), dtype),
                            x=uniform((n,), dtype))
        a, x = operands["a"], operands["x"]
        mesh = make_mesh(1) if shards == 1 else make_mesh(shards, devices=[dev] * shards)
        strat = get_strategy(strategy)
        before = gemv_cuda.launches
        res = benchmark_strategy(strat, mesh, a, x, n_reps=N_REPS,
                                 mode="amortized", measure="chain",
                                 kernel="cuda", chain_samples=CHAIN_SAMPLES)
        y = strat.build(mesh, kernel="cuda")(*strat.place(a, x, mesh))
        ref = gemv_plain(a, x).to(dtype)
        torch.cuda.synchronize(dev)
        launched = gemv_cuda.launches - before
        expected += calls_per_config * shards
        check(launched == calls_per_config * shards,
              f"{strategy} {n}² {name} p={shards}: {launched} kernel launches, "
              f"expected {calls_per_config * shards}")
        # y and the plain product, both cast back to the storage dtype: one
        # bf16 ulp (2^-7) apart at most; fp32 sums in another order, 1e-4.
        rtol = 2 ** -7 if dtype == torch.bfloat16 else 1e-4
        rel = ((y.float() - ref.float()).abs() / ref.float().abs()).max().item()
        check(y.shape == (n,) and bool(torch.isfinite(y).all()),
              f"{strategy}: y is not {n} finite values")
        check(rel <= rtol, f"{strategy} {n}² {name} p={shards}: rel err {rel} > {rtol}")
        ms = res.mean_time_s * 1e3
        bound_ms = res.gbps * res.mean_time_s / H100_HBM_PEAK_GBPS * 1e3
        emit({"phase": "main", "strategy": strategy, "shape": [n, n],
              "dtype": name, "mesh": list(mesh.grid), "shards_on_cuda0": shards,
              "kernel": "cuda", "mode": res.mode, "measure": res.measure,
              "n_reps": N_REPS, "ms": ms, "gbps": res.gbps,
              "bound_ms": bound_ms, "share_of_bound": bound_ms / ms,
              "launches": launched, "max_rel_err": rel, "rtol": rtol})
        del y, ref
    main_launches = gemv_cuda.launches
    check(main_launches == expected and main_launches > 0,
          f"main path launched the kernel {main_launches} times, expected {expected}")
    operands.clear()
    torch.cuda.empty_cache()

    # ---- 5. kernels: time, bound, plain, library ----
    probe = torch.empty(1 << 30, dtype=torch.int16, device=dev)  # 2 GiB
    probe_dst = torch.empty_like(probe)
    copy_ms = event_ms(lambda: probe_dst.copy_(probe), reps=10)
    probe_gbps = 2 * probe.numel() * 2 / (copy_ms * 1e-3) / 1e9
    del probe, probe_dst
    at = {}
    for n, name in KERNEL_SHAPES:
        dtype = torch_dtype(name)
        a, x = uniform((n, n), dtype), uniform((n,), dtype)
        y, ref = gemv_cuda(a, x), gemv_plain(a, x)
        rel = ((y - ref).abs() / ref.abs()).max().item()
        check(rel <= MAIN_SHAPE_RTOL,
              f"gemv {n}² {name}: rel err {rel} > {MAIN_SHAPE_RTOL}")
        nbytes = (n * n + n) * a.element_size() + n * y.element_size()
        bytes_ms = nbytes / (H100_HBM_PEAK_GBPS * 1e9) * 1e3
        ops_ms = 2 * n * n / FP32_PEAK_FLOPS * 1e3
        at[f"{n}x{n}"] = {
            "dtype": name,
            "ms": event_ms(lambda: gemv_cuda(a, x), reps=50),
            "plain_ms": event_ms(lambda: gemv_plain(a, x), reps=5, warmup=1),
            "library_ms": event_ms(lambda: torch.matmul(a, x[:, None]), reps=50),
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bound_ms_probe": nbytes / (probe_gbps * 1e9) * 1e3,
            "max_abs_err": (y - ref).abs().max().item(),
            "max_rel_err": rel, "rtol": MAIN_SHAPE_RTOL,
        }
        del a, x, y, ref
        torch.cuda.empty_cache()

    # The reference's asymmetric regime: few rows, k = 60000. One warp per
    # row leaves most of the card idle here; timed one launch at a time
    # after overwriting 4x the L2, so A comes from HBM as in a cold call.
    flush = torch.empty(4 * H100_L2_BYTES // 4, dtype=torch.float32, device=dev)

    def cold_ms(fn, reps: int = 20) -> float:
        fn()
        pairs = []
        for _ in range(reps):
            flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            pairs.append((start, end))
        torch.cuda.synchronize(dev)
        return statistics.median(s.elapsed_time(e) for s, e in pairs)

    for m, k in ASYMMETRIC_SHAPES:
        for name in ("bfloat16", "float32"):
            dtype = torch_dtype(name)
            a, x = uniform((m, k), dtype), uniform((k,), dtype)
            ms = cold_ms(lambda: gemv_cuda(a, x))
            nbytes = (m * k + k) * a.element_size() + m * 4
            bound_ms = nbytes / (H100_HBM_PEAK_GBPS * 1e9) * 1e3
            emit({"phase": "asymmetric", "kernel": "gemv", "shape": [m, k],
                  "dtype": name, "warps": m, "l2": "flushed", "ms": ms,
                  "library_ms": cold_ms(lambda: torch.matmul(a, x[:, None])),
                  "bound_ms": bound_ms, "share_of_bound": bound_ms / ms})
    del flush, a, x
    torch.cuda.empty_cache()

    # ---- 6. gemm against its plain version ----
    for m, k, n in GEMM_CHECK_SHAPES:
        for name in ("bfloat16", "float16", "float32", "float64"):
            dtype = torch_dtype(name)
            if (m, k) == (4, 8):
                a = torch.tensor(FIXTURE_MATRIX, dtype=torch.float64).to(dev, dtype)
            else:
                a = uniform((m, k), dtype)
            b = uniform((k, n), dtype)
            c1, c2 = gemm_cuda(a, b), gemm_cuda(a, b)
            ref = gemm_plain(a, b)
            # Pad independence: the real columns of a bucket are bitwise the
            # same whether its pad columns hold zeros or random values (and
            # the same as with no pad at all).
            width = bucket_for(n) if n < 128 and bucket_for(n) > n else n + 3
            padded = {"zeros": torch.zeros((k, width), dtype=dtype, device=dev),
                      "random": uniform((k, width), dtype)}
            pad_ok = True
            for block in padded.values():
                block[:, :n] = b
                pad_ok &= torch.equal(gemm_cuda(a, block)[:, :n], c1)
            torch.cuda.synchronize(dev)
            rtol = 1e-12 if dtype == torch.float64 else (1e-5 if k <= 4096 else 1e-4)
            rel = ((c1 - ref).abs() / ref.abs()).max().item()
            check(rel <= rtol, f"gemm {m}x{k}x{n} {name}: rel err {rel} > {rtol}")
            check(torch.equal(c1, c2), f"gemm {m}x{k}x{n} {name}: two runs differ")
            check(pad_ok, f"gemm {m}x{k}x{n} {name}: pad columns changed a real one")
            emit({"phase": "kernel_vs_plain", "kernel": "gemm", "shape": [m, k, n],
                  "dtype": name, "max_abs_err": (c1 - ref).abs().max().item(),
                  "max_rel_err": rel, "rtol": rtol, "bitwise_repeatable": True,
                  "pad_independent": {"width": width, "pads": list(padded)}})
            del a, b, c1, c2, ref, padded
    torch.cuda.empty_cache()

    # ---- 7, 8. serve: this slice's path, at full width and on a 2x2 mesh ----
    launches_by_path = {"gemv": {"strategies": main_launches}, "gemm": {}}
    with tempfile.TemporaryDirectory() as tmp:
        for label, strategy, n, name, shards, n_requests in SERVE_CONFIGS:
            dtype = torch_dtype(name)
            mesh = make_mesh(1) if shards == 1 else make_mesh(shards, devices=[dev] * shards)
            snapshot = Path(tmp) / f"{label}.json"
            gemv_cuda.launches = gemm_cuda.launches = 0
            res = run_serve(strategy, mesh, n, n, dtype=name, kernel="cuda",
                            max_bucket=SERVE_MAX_BUCKET, promote=SERVE_PROMOTE,
                            n_requests=n_requests, seed=args.seed,
                            metrics_out=str(snapshot))
            torch.cuda.synchronize(dev)
            launched = {"gemv": gemv_cuda.launches, "gemm": gemm_cuda.launches}
            dispatches = json.loads(snapshot.read_text())["counters"][
                "engine_dispatches_total"]
            # Each engine dispatch runs its kernel once per shard.
            check(launched["gemv"] > 0 and launched["gemm"] > 0
                  and launched["gemv"] + launched["gemm"] == dispatches * shards,
                  f"serve {label}: launches {launched}, {dispatches} dispatches "
                  f"x {shards} shards")
            check(res.compiles_steady == 0,
                  f"serve {label}: {res.compiles_steady} steady-phase builds")
            for kernel_name, count in launched.items():
                launches_by_path[kernel_name][f"serve_{label}"] = count
            torch.cuda.empty_cache()
            checked = check_serve_replay(strategy, mesh, n, dtype, n_requests)
            emit({"phase": "serve", "config": label, "strategy": strategy,
                  "shape": [n, n], "dtype": name, "mesh": list(mesh.grid),
                  "shards_on_cuda0": shards, "kernel": "cuda",
                  "max_bucket": SERVE_MAX_BUCKET, "b_star": res.b_star,
                  "n_requests": res.n_requests, "total_cols": res.total_cols,
                  "wall_s": res.wall_s, "req_per_s": res.rps,
                  "cols_per_s": res.cols_per_s,
                  "p50_dispatch_ms": res.p50_dispatch_ms,
                  "p99_dispatch_ms": res.p99_dispatch_ms,
                  "compiles_warmup": res.compiles_warmup,
                  "compiles_steady": res.compiles_steady,
                  "hits_steady": res.hits_steady, "promo_b": res.promo_b,
                  "promo_gemm_s": res.promo_gemm_s, "promo_seq_s": res.promo_seq_s,
                  "promo_speedup": res.promo_speedup, "dispatches": dispatches,
                  "launches": launched, "replay_check": checked})
            torch.cuda.empty_cache()

    # ---- 9. gemm through the sweep's entry point ----
    a, b = uniform((4096, 4096), torch.bfloat16), uniform((4096, 4096), torch.bfloat16)
    mesh = make_mesh(1)
    gemm_cuda.launches = 0
    res = benchmark_gemm("blockwise", mesh, a, b, n_reps=N_REPS, mode="amortized",
                         measure="chain", kernel="cuda", chain_samples=CHAIN_SAMPLES)
    c = build_gemm("blockwise", mesh, kernel="cuda")(a, b)
    ref = gemm_plain(a, b).to(torch.bfloat16)
    torch.cuda.synchronize(dev)
    check(gemm_cuda.launches == calls_per_config,
          f"benchmark_gemm launched the kernel {gemm_cuda.launches} times, "
          f"expected {calls_per_config}")
    launches_by_path["gemm"]["benchmark_gemm"] = gemm_cuda.launches
    rel = ((c.float() - ref.float()).abs() / ref.float().abs()).max().item()
    check(c.shape == (4096, 4096) and rel <= 2 ** -7,
          f"benchmark_gemm's program: rel err {rel} after the bf16 cast")
    emit({"phase": "benchmark_gemm", "strategy": res.strategy, "shape": [4096, 4096],
          "n_rhs": res.n_rhs, "dtype": res.dtype, "mode": res.mode,
          "measure": res.measure, "n_reps": N_REPS, "ms": res.mean_time_s * 1e3,
          "tflops": res.gflops / 1e3, "launches": gemm_cuda.launches,
          "max_rel_err": rel, "rtol": 2 ** -7})
    del a, b, c, ref
    torch.cuda.empty_cache()

    # ---- 10. gemm: time, bound, plain, library ----
    gemm_at = {}
    held = {}
    for m, k, n, name in GEMM_TIME_SHAPES:
        dtype = torch_dtype(name)
        if held.get("key") != (m, k, name):
            held.clear()
            torch.cuda.empty_cache()
            held.update(key=(m, k, name), a=uniform((m, k), dtype))
        a = held["a"]
        b = uniform((k, n), dtype)
        c, ref = gemm_cuda(a, b), gemm_plain(a, b)
        rtol = 1e-5 if k <= 4096 else 1e-4
        rel = ((c - ref).abs() / ref.abs()).max().item()
        check(rel <= rtol, f"gemm {m}x{k}x{n} {name}: rel err {rel} > {rtol}")
        nbytes = (m * k + k * n) * a.element_size() + m * n * c.element_size()
        bytes_ms = nbytes / (H100_HBM_PEAK_GBPS * 1e9) * 1e3
        peak = TENSOR_PEAK_FLOPS if a.element_size() == 2 else FP32_PEAK_FLOPS
        ops_ms = 2 * m * k * n / peak * 1e3
        gemm_at[f"{m}x{k}x{n}_{name}"] = {
            "dtype": name,
            "route": "mma.sync" if a.element_size() == 2 else "ffma",
            "ms": event_ms(lambda: gemm_cuda(a, b), reps=20),
            "plain_ms": event_ms(lambda: gemm_plain(a, b), reps=3, warmup=1),
            "library_ms": event_ms(lambda: torch.matmul(a, b), reps=20),
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "max_abs_err": (c - ref).abs().max().item(),
            "max_rel_err": rel, "rtol": rtol,
        }
        del b, c, ref
    held.clear()
    torch.cuda.empty_cache()

    # ---- quantized storage: helpers ----
    def payload_abs(qa):
        """|payload| leaf by leaf (e4m3's sign bit cleared), so that
        quant_gemv_plain(payload_abs(qa), |x|) bounds |deq(A)|·|x|."""
        def clear_sign(leaf):
            if leaf.dtype == torch.int8:
                return leaf.abs()
            if leaf.dtype == torch.float32:  # the scales, >= 0
                return leaf
            return (leaf.view(torch.uint8) & 0x7F).view(leaf.dtype)
        return qa.map(clear_sign)

    def quant_bound(qa, n: int, nbytes: int):
        """The larger of the payload's bytes over the HBM rate and the
        flops (2·m·k·n of the contraction plus the dequantization's
        multiply, and add for int8c) over the FFMA peak."""
        m, k = qa.shape
        levels = 2 if qa.fmt == "int8c" else 1
        bytes_ms = nbytes / (H100_HBM_PEAK_GBPS * 1e9) * 1e3
        ops_ms = (2 * m * k * n + (2 * levels - 1) * m * k) / FP32_PEAK_FLOPS * 1e3
        return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"

    def engine_payload(engine) -> QuantizedMatrix:
        """The engine's resident payload, its shards gathered leaf by leaf."""
        st = engine._a
        first = st.shards[0]

        def gather(attr):
            if getattr(first, attr) is None:
                return None
            parts = tuple(getattr(s, attr) for s in st.shards)
            return unshard(ShardedTensor(parts, (engine.m, -1), st.spec, st.mesh))

        return QuantizedMatrix(*(gather(f) for f in ("q", "scales", "q2", "scales2")),
                               fmt=first.fmt, block=first.block, out_dtype=first.dtype)

    def check_quant_serve_replay(strategy, mesh, n, dtype, fmt, n_requests) -> dict:
        """run_serve's steady stream replayed through a fresh quantized
        engine (A dropped once quantized): every result finite and of the
        right shape, and one request of each width within 1e-4 of
        |deq(A)|·|x| of quant_gemv_plain on the engine's own payload."""
        engine = MatvecEngine(resident_matrix(n, n, dtype, dev, args.seed), mesh,
                              strategy=strategy, kernel="cuda", dtype_storage=fmt,
                              max_bucket=SERVE_MAX_BUCKET, promote=SERVE_PROMOTE)
        payload = engine_payload(engine)
        widths = [w for w in DEFAULT_WIDTH_MIX if w <= SERVE_MAX_BUCKET]
        pool = _request_pool(n, widths, dtype, seed=args.seed + 1)
        sequence = np.random.default_rng(args.seed + 2).choice(list(pool), size=n_requests)
        worst = {}
        for w in map(int, sequence):
            y = engine.submit(pool[w]).result()
            check(tuple(y.shape) == (n, w) and bool(torch.isfinite(y).all()),
                  f"quant serve replay: a width-{w} result is not {n}x{w} finite values")
            if w not in worst:
                xw = pool[w].to(dev)
                ref = quant_gemv_plain(payload, xw).cpu()
                scale = quant_gemv_plain(payload_abs(payload), xw.abs()).cpu()
                worst[w] = ((y.double() - ref.double()).abs() / scale.double()).max().item()
                check(worst[w] <= 1e-4, f"quant serve replay width {w}: {worst[w]} of "
                      "|deq(A)|·|x| > 1e-4")
        del engine, payload
        return {"requests": len(sequence), "all_finite": True, "tol_of_scale": 1e-4,
                "max_err_over_scale_by_width": {str(w): worst[w] for w in sorted(worst)}}

    # ---- 11. quant_gemv against its plain version ----
    for m, k, block in QUANT_CHECK_SHAPES:
        for name in ("bfloat16", "float16", "float32", "float64"):
            dtype = torch_dtype(name)
            a = (uniform((m, k), torch.float32) - 5).to(dtype)  # both signs
            tol = 1e-12 if dtype == torch.float64 else (1e-5 if k <= 4096 else 1e-4)
            for fmt in QUANT_FORMATS:
                qa = quantize_matrix(a, fmt, block=block)
                worst, max_abs, pads_equal_unpadded = 0.0, 0.0, True
                for w in QUANT_WIDTHS:
                    x = uniform((k,) if w is None else (k, w), dtype)
                    y1, y2 = quant_gemv_cuda(qa, x), quant_gemv_cuda(qa, x)
                    ref = quant_gemv_plain(qa, x)
                    scale = quant_gemv_plain(payload_abs(qa), x)
                    torch.cuda.synchronize(dev)
                    err = (y1 - ref).abs()
                    check(bool((err <= tol * scale).all()),
                          f"quant_gemv {m}x{k}/{block} {fmt} {name} n={w}: error over "
                          f"{tol} of |deq(A)|·|x|")
                    check(torch.equal(y1, y2),
                          f"quant_gemv {m}x{k} {fmt} {name} n={w}: two runs differ")
                    worst = max(worst, (err / scale.clamp_min(1e-300)).max().item())
                    max_abs = max(max_abs, err.max().item())
                    if w is None:
                        continue
                    # The real columns, whether the pad columns hold zeros or
                    # random values (the engine pads to its buckets).
                    width = bucket_for(w) if bucket_for(w) > w else w + 3
                    real = []
                    for pad in ("zeros", "random"):
                        block_x = (torch.zeros((k, width), dtype=dtype, device=dev)
                                   if pad == "zeros" else uniform((k, width), dtype))
                        block_x[:, :w] = x
                        real.append(quant_gemv_cuda(qa, block_x)[:, :w])
                    check(torch.equal(real[0], real[1]),
                          f"quant_gemv {m}x{k} {fmt} {name} n={w}: pad columns changed "
                          "a real one")
                    pads_equal_unpadded &= torch.equal(real[0], y1)
                emit({"phase": "quant_vs_plain", "kernel": "quant_gemv", "shape": [m, k],
                      "block": block, "format": fmt, "dtype": name,
                      "widths": [1 if w is None else w for w in QUANT_WIDTHS],
                      "max_abs_err": max_abs, "max_err_over_scale": worst, "tol": tol,
                      "bitwise_repeatable": True, "pad_independent": True,
                      "padded_equals_unpadded": pads_equal_unpadded})
                del qa
            del a
    torch.cuda.empty_cache()

    # ---- 12. the quantizer on the card against the CPU ----
    for name in ("float32", "bfloat16"):
        dtype = torch_dtype(name)
        spread = torch.empty((1000, 1), device=dev).uniform_(-8, 8, generator=gen).exp()
        a = (torch.randn((1000, 3008), generator=gen, device=dev) * spread).to(dtype)
        for fmt in QUANT_FORMATS:
            on_card, on_host = quantize_matrix(a, fmt), quantize_matrix(a.cpu(), fmt)
            same = all(
                (c is None and h is None)
                or torch.equal(c.cpu().view(torch.uint8), h.view(torch.uint8))
                for c, h in zip(on_card.leaves, on_host.leaves))
            check(same and on_card.block == on_host.block,
                  f"quantize_matrix {name} {fmt}: the card's payload or scales differ "
                  "from the CPU's")
            emit({"phase": "quantizer", "shape": [1000, 3008], "dtype": name,
                  "format": fmt, "block": on_card.block, "bitwise_equal_cpu": True})

    # ---- 13. strategies at full width from quantized storage ----
    quant_launches = {}
    held = {}
    for strategy, n, fmt, shards in QUANT_MAIN_CONFIGS:
        if held.get("n") != n:
            held.clear()
            torch.cuda.empty_cache()
            a, x = uniform((n, n), torch.float32), uniform((n,), torch.float32)
            # The fp64 oracle, |A|·|x| and each row's max, in row chunks.
            xd = x.double()
            exact, absprod, amax = [], [], []
            rows = max(1, CHUNK_BYTES // (n * 8))
            for i in range(0, n, rows):
                c = a[i:i + rows].double()
                exact.append(c @ xd)
                absprod.append(c.abs() @ xd.abs())
                amax.append(c.abs().amax(1))
                del c
            held.update(n=n, a=a, x=x, exact=torch.cat(exact), absprod=torch.cat(absprod),
                        amax=torch.cat(amax))
        a, x = held["a"], held["x"]
        mesh = make_mesh(1) if shards == 1 else make_mesh(shards, devices=[dev] * shards)
        strat = get_strategy(strategy)
        storage = None if fmt == "native" else fmt
        quant_gemv_cuda.launches = gemv_cuda.launches = 0
        res = benchmark_strategy(strat, mesh, a, x, n_reps=N_REPS, mode="amortized",
                                 measure="chain", kernel="cuda",
                                 chain_samples=CHAIN_SAMPLES, dtype_storage=storage)
        quantize_s = None
        if storage is None:
            y = strat.build(mesh, kernel="cuda")(*strat.place(a, x, mesh))
            nbytes = (n * n + n) * 4 + n * 4
        else:
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            qa = quantize_matrix(a, fmt, contraction_shards=strat.contraction_shards(mesh))
            torch.cuda.synchronize(dev)
            quantize_s = time.perf_counter() - t0
            y = strat.build(mesh, kernel="cuda", dtype_storage=fmt)(qa, x)
            nbytes = qa.nbytes + n * 4 + n * 4
            del qa
        torch.cuda.synchronize(dev)
        launched = {"quant_gemv": quant_gemv_cuda.launches, "gemv": gemv_cuda.launches}
        kernel_name = "gemv" if storage is None else "quant_gemv"
        check(launched[kernel_name] == calls_per_config * shards
              and sum(launched.values()) == launched[kernel_name],
              f"{strategy} {n}² {fmt} p={shards}: launches {launched}, expected "
              f"{calls_per_config * shards} of {kernel_name}")
        if storage is not None:
            quant_launches[f"{strategy}_{n}_{fmt}_p{shards}"] = launched["quant_gemv"]
        err = (y.double() - held["exact"]).abs()
        check(y.shape == (n,) and bool(torch.isfinite(y).all()),
              f"{strategy} {fmt}: y is not {n} finite values")
        normwise = (err.max() / held["exact"].abs().max()).item()
        slack = (torch.finfo(torch.float32).eps * n * held["amax"].max()
                 * x.abs().max().double())
        budget = {}
        if fmt in ("int8", "int8c"):
            eps = INT8_EPS if fmt == "int8" else INT8C_EPS
            bound = n * eps * held["amax"] * x.abs().max().double() + slack
            budget["worst_case"] = bool((err <= bound).all())
            check(budget["worst_case"], f"{strategy} {n}² {fmt}: over the worst-case budget")
        if fmt == "int8c":
            budget["normwise"] = normwise <= FP32_LEVEL_RELERR
            check(budget["normwise"], f"{strategy} {n}² int8c: normwise {normwise} > "
                  f"{FP32_LEVEL_RELERR}")
        if fmt == "fp8":
            budget["elementwise_2^-4"] = bool((err <= 2.0 ** -4 * held["absprod"]).all())
            check(budget["elementwise_2^-4"], f"{strategy} {n}² fp8: over 2^-4 |A|·|x|")
        if fmt == "native":
            budget["rel_1e-4"] = normwise <= 1e-4
            check(budget["rel_1e-4"], f"{strategy} {n}² native: rel err {normwise}")
        ms = res.mean_time_s * 1e3
        bound_ms = nbytes / (H100_HBM_PEAK_GBPS * 1e9) * 1e3
        emit({"phase": "quant_main", "strategy": strategy, "shape": [n, n],
              "dtype": "float32", "format": fmt, "mesh": list(mesh.grid),
              "shards_on_cuda0": shards, "kernel": "cuda", "measure": res.measure,
              "n_reps": N_REPS, "ms": ms, "bytes": nbytes, "bound_ms": bound_ms,
              "share_of_bound": bound_ms / ms, "quantize_s": quantize_s,
              "launches": launched, "max_abs_err": err.max().item(),
              "normwise_rel_err": normwise, "budget": budget})
        del y, err
    held.clear()
    torch.cuda.empty_cache()

    # ---- 14. serve from a quantized resident ----
    with tempfile.TemporaryDirectory() as tmp:
        for label, strategy, n, name, fmt, shards, n_requests in QUANT_SERVE_CONFIGS:
            dtype = torch_dtype(name)
            mesh = make_mesh(1) if shards == 1 else make_mesh(shards, devices=[dev] * shards)
            snapshot = Path(tmp) / f"{label}.json"
            quant_gemv_cuda.launches = gemv_cuda.launches = gemm_cuda.launches = 0
            res = run_serve(strategy, mesh, n, n, dtype=name, kernel="cuda",
                            max_bucket=SERVE_MAX_BUCKET, promote=SERVE_PROMOTE,
                            n_requests=n_requests, seed=args.seed,
                            metrics_out=str(snapshot), dtype_storage=fmt)
            torch.cuda.synchronize(dev)
            launched = {"quant_gemv": quant_gemv_cuda.launches, "gemv": gemv_cuda.launches,
                        "gemm": gemm_cuda.launches}
            dispatches = json.loads(snapshot.read_text())["counters"][
                "engine_dispatches_total"]
            check(launched["quant_gemv"] == dispatches * shards
                  and launched["gemv"] == launched["gemm"] == 0,
                  f"serve {label}: launches {launched}, {dispatches} dispatches x {shards}")
            check(res.compiles_steady == 0 and res.dtype_storage == fmt,
                  f"serve {label}: {res.compiles_steady} steady builds, storage "
                  f"{res.dtype_storage}")
            quant_launches[f"serve_{label}"] = launched["quant_gemv"]
            torch.cuda.empty_cache()
            checked = check_quant_serve_replay(strategy, mesh, n, dtype, fmt, n_requests)
            native_bytes = n * n * dtype.itemsize
            emit({"phase": "quant_serve", "config": label, "strategy": strategy,
                  "shape": [n, n], "dtype": name, "format": fmt, "mesh": list(mesh.grid),
                  "shards_on_cuda0": shards, "kernel": "cuda",
                  "max_bucket": SERVE_MAX_BUCKET, "b_star": res.b_star,
                  "n_requests": res.n_requests, "total_cols": res.total_cols,
                  "wall_s": res.wall_s, "req_per_s": res.rps,
                  "cols_per_s": res.cols_per_s,
                  "p50_dispatch_ms": res.p50_dispatch_ms,
                  "p99_dispatch_ms": res.p99_dispatch_ms,
                  "compiles_warmup": res.compiles_warmup,
                  "compiles_steady": res.compiles_steady,
                  "hits_steady": res.hits_steady, "promo_b": res.promo_b,
                  "promo_gemm_s": res.promo_gemm_s, "promo_seq_s": res.promo_seq_s,
                  "promo_speedup": res.promo_speedup, "dispatches": dispatches,
                  "launches": launched, "resident_bytes": res.resident_bytes,
                  "resident_over_native": res.resident_bytes / native_bytes,
                  "replay_check": checked})
            torch.cuda.empty_cache()

    # ---- 15. quant_gemv: time, bound, plain, the native GEMV ----
    quant_at = {}
    held = {}
    for n, fmt, w in QUANT_TIME_SHAPES:
        if held.get("n") != n:
            held.clear()
            torch.cuda.empty_cache()
            held["n"], held["a"] = n, uniform((n, n), torch.float32)
        a = held["a"]
        if held.get("fmt") != fmt:
            held.pop("qa", None)
            held["fmt"], held["qa"] = fmt, quantize_matrix(a, fmt)
        qa = held["qa"]
        x = uniform((n,) if w == 1 else (n, w), torch.float32)
        y, ref = quant_gemv_cuda(qa, x), quant_gemv_plain(qa, x)
        scale = quant_gemv_plain(payload_abs(qa), x)
        err = (y - ref).abs()
        check(bool((err <= 1e-4 * scale).all()),
              f"quant_gemv {n}² {fmt} n={w}: error over 1e-4 of |deq(A)|·|x|")
        bound_ms, bound_by = quant_bound(qa, w, qa.nbytes + (x.numel() + y.numel()) * 4)
        native = (lambda: gemv_cuda(a, x)) if w == 1 else (lambda: gemm_cuda(a, x))
        quant_at[f"{n}x{n}_{fmt}_n{w}"] = {
            "format": fmt, "width": w, "block": qa.block, "payload_bytes": qa.nbytes,
            "ms": event_ms(lambda: quant_gemv_cuda(qa, x), reps=20 if w == 1 else 10),
            "plain_ms": event_ms(lambda: quant_gemv_plain(qa, x), reps=2, warmup=1),
            "library_ms": None,
            "native_ms": event_ms(native, reps=10),
            "native_call": "gemv_cuda(a, x)" if w == 1 else "gemm_cuda(a, x)",
            "bound_ms": bound_ms, "bound_by": bound_by,
            "max_abs_err": err.max().item(),
            "max_err_over_scale": (err / scale.clamp_min(1e-300)).max().item(),
        }
        del x, y, ref, scale, err
    held.clear()
    torch.cuda.empty_cache()

    # ---- served solvers: helpers ----
    def step_inputs(op, n, acc, kf):
        """Seeded step operands: ap = p·(1 + u), so pᵀap > 0 without
        cancellation; Chebyshev on the interval [1, 100] at step index kf."""
        def vec():
            return torch.randn(n, generator=gen, device=dev).to(acc)

        x, r, p = vec(), vec(), vec()
        ap = p * (1 + torch.rand(n, generator=gen, device=dev).to(acc))
        if op == "cg":
            s_in = torch.sum(r * r).reshape(1)
        else:
            d, c = 50.5, 49.5
            s_in = torch.tensor([1 / d, kf, d, c * c], dtype=acc, device=dev)
        return x, r, p, ap, s_in

    def abs_product(a_local, v):
        """|A|·|v| (|deq(A)|·|v| for a payload), row chunks of |A| at a time."""
        if isinstance(a_local, QuantizedMatrix):
            return quant_gemv_plain(payload_abs(a_local), v.abs())
        rows = max(1, CHUNK_BYTES // (a_local.shape[1] * 8))
        return torch.cat([gemv_plain(a_local[i:i + rows].abs(), v.abs())
                          for i in range(0, a_local.shape[0], rows)])

    def step_check(op, a_local, off, inputs, tol, what) -> dict:
        """The step twice on the card and once plain: bitwise repeatable,
        and within tol (of each vector's largest element, of the scalars,
        of |A|·|p2| for the partial)."""
        out1 = solver_step_cuda(op, a_local, off, *inputs)
        out2 = solver_step_cuda(op, a_local, off, *inputs)
        ref = solver_step_plain(op, a_local, off, *inputs)
        torch.cuda.synchronize(dev)
        check(all(torch.equal(u, v) for u, v in zip(out1, out2)),
              f"solver_step {what}: two runs differ")
        seg = ref[2][off:off + a_local.shape[1]]
        err = {
            "vectors": max(((o - w).abs().max() / w.abs().max()).item()
                           for o, w in zip(out1[:3], ref[:3])),
            "scalars": ((out1[3] - ref[3]).abs() / ref[3].abs()).max().item(),
            "partial": ((out1[4] - ref[4]).abs() / abs_product(a_local, seg)).max().item(),
        }
        check(all(e <= tol for e in err.values()), f"solver_step {what}: errors {err} > {tol}")
        return {**err, "max_abs_err": max((o - w).abs().max().item() for o, w in zip(out1, ref))}

    wrappers = {"gemv": gemv_cuda, "gemm": gemm_cuda, "quant_gemv": quant_gemv_cuda,
                "solver_step": solver_step_cuda}
    solver_paths = {name: {} for name in wrappers}

    def drive(label, fn):
        """One solver path, with every launch count set to 0 just before it
        and read just after; a solver path runs no GEMM (promote=None)."""
        for wrapper in wrappers.values():
            wrapper.launches = 0
        out = fn()
        torch.cuda.synchronize(dev)
        counts = {name: wrapper.launches for name, wrapper in wrappers.items()}
        check(counts["gemm"] == 0, f"{label}: the GEMM ran {counts['gemm']} times")
        for name, count in counts.items():
            if count:
                solver_paths[name][label] = count
        return out, counts

    def timed_solve(engine, **kw):
        """submit(op=...).result() on the host clock: the host-stepped loop,
        its verification matvecs and the copy of x."""
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        res = engine.submit(**kw).result()
        return res, (time.perf_counter() - t0) * 1e3

    def rel_residual(a, b, x) -> float:
        """||b − A x|| / ||b||, recomputed on the card in fp64 row chunks."""
        xd, bd = x.to(dev, torch.float64), b.to(dev, torch.float64)
        rows = max(1, CHUNK_BYTES // (a.shape[1] * 8))
        r = torch.cat([bd[i:i + rows] - a[i:i + rows].double() @ xd
                       for i in range(0, a.shape[0], rows)])
        return (r.norm() / bd.norm()).item()

    def rel_diff(x, ref) -> float:
        return ((x - ref).abs().max() / ref.abs().max()).item()

    def seeded_rhs(n):
        return torch.from_numpy(
            np.random.default_rng(args.seed + 1).standard_normal(n).astype(np.float32))

    # The recomputed residual may exceed the engine's fp32 one by the fp32
    # rounding of A x (about 1e-7 of |A|·|x| per element): 10% slack.
    residual_bound = 1.1 * SOLVER_RTOL

    # ---- 16. solver_step against its plain version ----
    for m, k, n, off in SOLVER_CHECK_SHAPES:
        for storage in SOLVER_CHECK_STORAGE:
            quant = storage in QUANT_FORMATS
            k_s = -(-k // 8) * 8 if quant else k
            n_s = k_s if off == 0 else n
            dtype = torch.float32 if quant else torch_dtype(storage)
            acc = torch.float64 if dtype == torch.float64 else torch.float32
            a = (uniform((m, k_s), torch.float32) - 5).to(dtype)  # both signs
            a_local = quantize_matrix(a, storage) if quant else a
            tol = 1e-12 if acc == torch.float64 else (1e-5 if k_s <= 4096 else 1e-4)
            for i, op in enumerate(SOLVER_OPS_FUSED):
                inputs = step_inputs(op, n_s, acc, kf=3.0 * i)
                err = step_check(op, a_local, off, inputs, tol,
                                 f"{op} {m}x{k_s}@{off} n={n_s} {storage}")
                emit({"phase": "solver_step_vs_plain", "kernel": "solver_step", "op": op,
                      "shape": [m, k_s], "n": n_s, "off": off, "storage": storage,
                      "tol": tol, "errors": err, "bitwise_repeatable": True})
            del a, a_local
    torch.cuda.empty_cache()

    # At full width: the check, then the times. unfused_ms is one iteration
    # of the torch tier's body on the same A (gemv_cuda plus its vector ops,
    # without the strategy's placement and the predicate read).
    n = SOLVER_N
    a = uniform((n, n), torch.float32)
    step_at = {}
    for op in SOLVER_OPS_FUSED:
        inputs = step_inputs(op, n, torch.float32, kf=3.0)
        err = step_check(op, a, 0, inputs, 1e-4, f"{op} {n}² fp32")
        emit({"phase": "solver_step_vs_plain", "kernel": "solver_step", "op": op,
              "shape": [n, n], "n": n, "off": 0, "storage": "float32", "tol": 1e-4,
              "errors": err, "bitwise_repeatable": True})
        x, r, p, ap, s_in = inputs
        thr = SOLVER_RTOL * torch.sqrt(torch.sum(r * r))
        if op == "cg":
            rz = s_in[0]
            x_best, rr_best = x.clone(), rz.clone()

            def unfused():
                ap2 = gemv_cuda(a, p)
                pap = torch.sum(p * ap2)
                safe = pap > 0
                alpha = torch.where(safe, rz / torch.where(safe, pap, 1.0), 0.0)
                x2 = x + alpha * p
                r2 = r - alpha * ap2
                rr = torch.sum(r2 * r2)
                beta = torch.where(safe, rr / torch.where(rz != 0, rz, 1.0), 0.0)
                better = rr < rr_best
                return (r2 + beta * p, torch.where(better, x2, x_best),
                        torch.where(better, rr, rr_best), torch.sqrt(rr) <= thr)
        else:
            d, c = torch.tensor(50.5, device=dev), torch.tensor(49.5, device=dev)
            b_rr = torch.sum(r * r)

            def unfused():
                factor = 0.25 * c * c * s_in[0]
                alpha_new = 1.0 / (d - factor)
                p2 = r + factor * s_in[0] * p
                ap2 = gemv_cuda(a, p2)
                x2 = x + alpha_new * p2
                r2 = r - alpha_new * ap2
                rr = torch.sum(r2 * r2)
                return x2, torch.stack((torch.sqrt(rr) <= thr, ~torch.isfinite(rr)
                                        | (rr > b_rr * 1e12)))
        nbytes = n * n * 4 + 8 * n * 4  # A; x, r, p, ap read; x2, r2, p2, partial written
        bytes_ms = nbytes / (H100_HBM_PEAK_GBPS * 1e9) * 1e3
        ops_ms = (2 * n * n + 10 * n) / FP32_PEAK_FLOPS * 1e3
        step_at[op] = {
            "shape": [n, n], "storage": "float32",
            "ms": event_ms(lambda: solver_step_cuda(op, a, 0, *inputs), reps=20),
            "plain_ms": event_ms(lambda: solver_step_plain(op, a, 0, *inputs), reps=3,
                                 warmup=1),
            "unfused_ms": event_ms(unfused, reps=20),
            "gemv_ms": event_ms(lambda: gemv_cuda(a, p), reps=20),
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "max_abs_err": err["max_abs_err"],
        }
        del inputs, x, r, p, ap, s_in, unfused
    del a
    torch.cuda.empty_cache()

    # ---- 17. served solvers at 65536² fp32, rowwise, p=1, both tiers ----
    n = SOLVER_N
    mesh1 = make_mesh(1)
    t0 = time.perf_counter()
    a = solver_operand(n, "float32", args.seed, device=dev)
    interval = gershgorin_interval(a)
    torch.cuda.synchronize(dev)
    operand_s = time.perf_counter() - t0
    b = seeded_rhs(n)
    engines = {tier: MatvecEngine(a, mesh1, strategy="rowwise", promote=None,
                                  solver_kernel=tier) for tier in ("torch", "cuda_fused")}
    solver_main, native_x = {}, {}
    for op, kw in (("cg", {"rtol": SOLVER_RTOL}),
                   ("chebyshev", {"rtol": CHEBYSHEV_RTOL, "interval": interval,
                                  "maxiter": CHEBYSHEV_MAXITER})):
        for tier, engine in engines.items():
            label = f"solver_{op}_{tier}"
            (res, ms), counts = drive(label, lambda: timed_solve(
                engine, op=op, rhs=b, **kw))
            rel = rel_residual(a, b, res.x)
            check(res.converged and rel <= 1.1 * kw["rtol"],
                  f"{label}: residual {rel} of ||b|| > {1.1 * kw['rtol']}")
            if tier == "cuda_fused":
                # One step per iteration; the prologue and the verification
                # are the unfused GEMV.
                check(counts["solver_step"] == res.n_iters and counts["gemv"] == 2,
                      f"{label}: launches {counts}, {res.n_iters} iterations")
            else:
                check(counts["solver_step"] == 0 and counts["gemv"] > res.n_iters,
                      f"{label}: launches {counts}, {res.n_iters} iterations")
            native_x[op, tier] = res.x
            solver_main[label] = {
                "op": op, "tier": tier, "rtol": kw["rtol"], "n_iters": res.n_iters,
                "solve_ms": ms,
                "ms_per_iter": ms / res.n_iters, "residual_norm": res.residual_norm,
                "rel_residual_recomputed": rel, "launches": counts}
        diff = rel_diff(native_x[op, "cuda_fused"], native_x[op, "torch"])
        check(diff <= 1e-3, f"{op}: fused and unfused x differ by {diff} > 1e-3")
        solver_main[f"solver_{op}_cuda_fused"]["x_rel_diff_to_torch"] = diff
    eigen = {}
    for op, rtol in (("gmres", SOLVER_RTOL), ("power", SOLVER_EIGEN_RTOL),
                     ("lanczos", SOLVER_EIGEN_RTOL)):
        label = f"solver_{op}_torch"
        (res, ms), counts = drive(label, lambda: timed_solve(
            engines["torch"], op=op, rhs=b, rtol=rtol))
        check(res.converged and counts["solver_step"] == 0 and counts["gemv"] > 0,
              f"{label}: launches {counts}")
        if op == "gmres":
            rel = rel_residual(a, b, res.x)
            check(rel <= residual_bound, f"{label}: residual {rel} > {residual_bound}")
        else:
            eigen[op] = res.value
        solver_main[label] = {"op": op, "tier": "torch", "rtol": rtol, "n_iters": res.n_iters,
                              "solve_ms": ms, "value": res.value,
                              "residual_norm": res.residual_norm, "launches": counts}
    lam_diff = abs(eigen["power"] - eigen["lanczos"]) / abs(eigen["lanczos"])
    check(lam_diff <= SOLVER_EIGEN_RTOL, f"power and lanczos lambda_1 differ by {lam_diff}")
    # Host share: each loop iteration's wall time beyond its device work
    # (the step, or the unfused body), from chebyshev's long run.
    host = {}
    for tier, device_ms in (("cuda_fused", step_at["chebyshev"]["ms"]),
                            ("torch", step_at["chebyshev"]["unfused_ms"])):
        per_iter = solver_main[f"solver_chebyshev_{tier}"]["ms_per_iter"]
        host[tier] = {"ms_per_iter": per_iter, "device_ms_per_iter": device_ms,
                      "host_ms_per_iter": per_iter - device_ms,
                      "host_share": (per_iter - device_ms) / per_iter}
    emit({"phase": "solver_main", "shape": [n, n], "dtype": "float32", "strategy": "rowwise",
          "mesh": list(mesh1.grid), "interval": list(interval),
          "operand_s": operand_s, "solves": solver_main,
          "lambda_1": eigen, "lambda_rel_diff": lam_diff, "host": host})
    del engines

    # ---- 18. fused cg from an int8c resident at 65536² fp32 ----
    q_engines = {tier: MatvecEngine(a, mesh1, strategy="rowwise", promote=None,
                                    solver_kernel=tier, dtype_storage="int8c")
                 for tier in ("torch", "cuda_fused")}
    del a  # the engines hold the payload alone
    torch.cuda.empty_cache()
    quant_solve, q_x = {}, {}
    for tier, engine in q_engines.items():
        label = f"solver_cg_int8c_{tier}"
        (res, ms), counts = drive(label, lambda: timed_solve(
            engine, op="cg", rhs=b, rtol=SOLVER_RTOL))
        check(res.converged and counts["gemv"] == 0, f"{label}: launches {counts}")
        if tier == "cuda_fused":
            check(counts["solver_step"] == res.n_iters and counts["quant_gemv"] == 2,
                  f"{label}: launches {counts}, {res.n_iters} iterations")
        else:
            check(counts["solver_step"] == 0 and counts["quant_gemv"] > res.n_iters,
                  f"{label}: launches {counts}, {res.n_iters} iterations")
        q_x[tier] = res.x
        quant_solve[label] = {"n_iters": res.n_iters, "solve_ms": ms,
                              "ms_per_iter": ms / res.n_iters,
                              "residual_norm": res.residual_norm, "launches": counts,
                              "resident_bytes": engine.resident_bytes}
    tiers_diff = rel_diff(q_x["cuda_fused"], q_x["torch"])
    check(tiers_diff <= 1e-3, f"int8c: fused and unfused x differ by {tiers_diff}")
    # The JAX package's budget for an int8c solve against the native one
    # (tests/test_solvers.py:327): 5e-2.
    native_diff = rel_diff(q_x["cuda_fused"], native_x["cg", "torch"])
    check(native_diff <= 5e-2, f"int8c: x differs from the native solve by {native_diff}")
    emit({"phase": "solver_int8c", "shape": [n, n], "dtype": "float32",
          "strategy": "rowwise", "storage": "int8c", "rtol": SOLVER_RTOL,
          "solves": quant_solve, "x_rel_diff_tiers": tiers_diff,
          "x_rel_diff_to_native": native_diff, "native_budget": 5e-2})
    del q_engines, q_x, native_x
    torch.cuda.empty_cache()

    # ---- 19. fused cg, colwise 32768² fp32 on 4 logical shards ----
    n = SOLVER_COLWISE_N
    a = solver_operand(n, "float32", args.seed, device=dev)
    b = seeded_rhs(n)
    mesh4 = make_mesh(4, devices=[dev] * 4)
    colwise, col_x = {}, {}
    for tier in ("torch", "cuda_fused"):
        engine = MatvecEngine(a, mesh4, strategy="colwise", promote=None, solver_kernel=tier)
        label = f"solver_cg_colwise4_{tier}"
        (res, ms), counts = drive(label, lambda: timed_solve(
            engine, op="cg", rhs=b, rtol=SOLVER_RTOL))
        rel = rel_residual(a, b, res.x)
        check(res.converged and rel <= residual_bound, f"{label}: residual {rel}")
        if tier == "cuda_fused":
            check(counts["solver_step"] == res.n_iters * 4 and counts["gemv"] == 2 * 4,
                  f"{label}: launches {counts}, {res.n_iters} iterations x 4 shards")
        col_x[tier] = res.x
        colwise[label] = {"n_iters": res.n_iters, "solve_ms": ms,
                          "ms_per_iter": ms / res.n_iters, "rel_residual_recomputed": rel,
                          "launches": counts}
        del engine
    diff = rel_diff(col_x["cuda_fused"], col_x["torch"])
    check(diff <= 1e-3, f"colwise: fused and unfused x differ by {diff}")
    emit({"phase": "solver_colwise", "shape": [n, n], "dtype": "float32",
          "strategy": "colwise", "mesh": list(mesh4.grid), "shards_on_cuda0": 4,
          "solves": colwise, "x_rel_diff_tiers": diff})
    del a, b, col_x
    torch.cuda.empty_cache()

    # ---- 20. run_serve_solver: 20 cg solves at 65536² fp32, both tiers ----
    with tempfile.TemporaryDirectory() as tmp:
        for tier in ("torch", "cuda_fused"):
            snapshot = Path(tmp) / f"solver_{tier}.json"
            label = f"serve_solver_cg_{tier}"
            res, counts = drive(label, lambda: run_serve_solver(
                "rowwise", mesh1, SOLVER_N, op="cg", solver_kernel=tier, rtol=SOLVER_RTOL,
                n_solves=SOLVER_SERVE_SOLVES, seed=args.seed, metrics_out=str(snapshot)))
            iters = int(json.loads(snapshot.read_text())["histograms"][
                "solver_iterations"]["sum"])  # warmup and steady solves
            check(res.compiles_steady == 0 and res.divergences == 0,
                  f"{label}: {res.compiles_steady} steady builds, "
                  f"{res.divergences} divergences")
            if tier == "cuda_fused":
                check(counts["solver_step"] == iters,
                      f"{label}: {counts['solver_step']} steps for {iters} iterations")
            else:
                check(counts["solver_step"] == 0 and counts["gemv"] > iters,
                      f"{label}: launches {counts}, {iters} iterations")
            emit({"phase": "serve_solver", "op": "cg", "solver_kernel": tier,
                  "shape": [SOLVER_N, SOLVER_N], "dtype": res.dtype,
                  "strategy": res.strategy, "rtol": res.rtol, "n_solves": res.n_solves,
                  "iterations_last": res.iterations, "iterations_total": iters,
                  "final_residual": res.final_residual,
                  "time_per_iter_ms": res.time_per_iter_ms,
                  "solve_p50_ms": res.solve_p50_ms, "solve_p99_ms": res.solve_p99_ms,
                  "solves_per_s": res.solves_per_s, "wall_s": res.wall_s,
                  "compiles_warmup": res.compiles_warmup,
                  "compiles_steady": res.compiles_steady, "launches": counts})
            torch.cuda.empty_cache()
    launches_by_path["gemv"].update(solver_paths["gemv"])
    quant_launches.update(solver_paths["quant_gemv"])

    # ---- 21. ring_gemv against its plain version ----
    def ring_mesh(kind: str, p: int = 4):
        return make_1d_mesh(p, devices=[dev] * p) if kind == "1d" else make_mesh(
            p, devices=[dev] * p)

    def ring_operands(a, x, p):
        """Rank d's column panel and x segment, as colwise places them."""
        st_a, st_x = get_strategy("colwise").place(a, x, ring_mesh("1d", p))
        return list(st_a.shards), list(st_x.shards)

    def ring_check(a, x, p, what) -> dict:
        """The ring GEMV twice on the card and once plain: bitwise
        repeatable, and within the GEMV's tolerance of |A|·|x| (the
        operands are positive, so that is the plain result itself)."""
        panels, segs = ring_operands(a, x, p)
        y1, y2 = ring_gemv_cuda(panels, segs), ring_gemv_cuda(panels, segs)
        ref = ring_gemv_plain(panels, segs)
        torch.cuda.synchronize(dev)
        k = a.shape[1]
        tol = 1e-12 if a.dtype == torch.float64 else (1e-5 if k <= 4096 else 1e-4)
        check(all(torch.equal(u, v) for u, v in zip(y1, y2)),
              f"ring_gemv {what} p={p}: two runs differ")
        rel = max(((u - r).abs() / r.abs()).max().item() for u, r in zip(y1, ref))
        check(rel <= tol, f"ring_gemv {what} p={p}: rel err {rel} > {tol}")
        return {"max_abs_err": max((u - r).abs().max().item() for u, r in zip(y1, ref)),
                "max_rel_err": rel, "rtol": tol}

    for m, k in RING_CHECK_SHAPES:
        for name in RING_CHECK_DTYPES:
            dtype = torch_dtype(name)
            a, x = uniform((m, k), dtype), uniform((k,), dtype)
            for p in (1, 2, 4, 8, 16) if (m, k) == RING_CHECK_SHAPES[0] else (1, 2, 4, 8):
                err = ring_check(a, x, p, f"{m}x{k} {name}")
                emit({"phase": "ring_vs_plain", "kernel": "ring_gemv", "shape": [m, k],
                      "dtype": name, "p": p, "bitwise_repeatable": True, **err})
            del a, x
    n = RING_N
    a, x = uniform((n, n), torch.bfloat16), uniform((n,), torch.bfloat16)
    ring_at = {}
    for p in RING_TIME_P:
        err = ring_check(a, x, p, f"{n}x{n} bfloat16")
        emit({"phase": "ring_vs_plain", "kernel": "ring_gemv", "shape": [n, n],
              "dtype": "bfloat16", "p": p, "bitwise_repeatable": True, **err})
        panels, segs = ring_operands(a, x, p)
        mesh = ring_mesh("1d", p)
        nbytes = (n * n + n) * a.element_size() + n * 4
        bytes_ms = nbytes / (H100_HBM_PEAK_GBPS * 1e9) * 1e3
        ops_ms = 2 * n * n / FP32_PEAK_FLOPS * 1e3
        ring_at[f"{n}x{n}_p{p}"] = {
            "dtype": "bfloat16", "p": p,
            "ms": event_ms(lambda: ring_gemv_cuda(panels, segs), reps=50),
            "plain_ms": event_ms(lambda: ring_gemv_plain(panels, segs), reps=3, warmup=1),
            "library_ms": event_ms(lambda: torch.matmul(a, x[:, None]), reps=50),
            "psum_scatter_ms": event_ms(lambda: psum_scatter(
                [gemv_cuda(pa, s) for pa, s in zip(panels, segs)], mesh,
                mesh.axis_names), reps=50),
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            **err,
        }
        del panels, segs
    torch.cuda.empty_cache()

    # ---- 22. every combine through benchmark_strategy, 65536² bf16, 4 shards ----
    ring_launches = {}
    ref_y = None
    for strategy, combine, stages, kind in RING_MAIN_CONFIGS:
        mesh = ring_mesh(kind)
        p = mesh.size
        strat = get_strategy(strategy)
        s = None
        if combine.startswith("overlap"):
            s = strat.resolve_stages(n, n, mesh, stages, strat.overlap_chunk_devices(mesh),
                                     torch.bfloat16)
        # Kernel launches per matvec: one GEMV per shard, per ring tile
        # (ring_overlap), or per (chunk, stage) cell (colwise overlap) or
        # stage (the overlap gathers); one ring GEMV for pallas_ring.
        per_call = {"ring_overlap": p * p, "pallas_ring": 0}.get(combine, p)
        if combine.startswith("overlap"):
            per_call = p * p * s if strategy == "colwise" else p * s
        gemv_cuda.launches = ring_gemv_cuda.launches = 0
        torch.cuda.synchronize(dev)
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        res = benchmark_strategy(strat, mesh, a, x, n_reps=N_REPS, mode="amortized",
                                 measure="chain", kernel="cuda",
                                 chain_samples=CHAIN_SAMPLES, combine=combine, stages=stages)
        torch.cuda.synchronize(dev)
        peak_extra = torch.cuda.max_memory_allocated(dev) - base
        y = strat.build(mesh, kernel="cuda", combine=combine, stages=stages)(
            *strat.place(a, x, mesh))
        torch.cuda.synchronize(dev)
        launched = {"gemv": gemv_cuda.launches, "ring_gemv": ring_gemv_cuda.launches}
        label = f"{strategy}_{combine}" + (f"@{s}" if s else "")
        expect = {"gemv": calls_per_config * per_call,
                  "ring_gemv": calls_per_config if combine == "pallas_ring" else 0}
        check(launched == expect, f"{label}: launches {launched}, expected {expect}")
        if combine == "pallas_ring":
            ring_launches[f"ring_main_{label}"] = launched["ring_gemv"]
        # Beyond A itself: its shards (at most A's bytes) and O(m) per shard;
        # a copy of a panel (or of 1/S of one) would be 1-2 GB per shard.
        slack = p * 64 * n * 4
        check(peak_extra <= n * n * a.element_size() + slack,
              f"{label}: allocated {peak_extra} bytes beyond A, more than its "
              f"shards and {slack} bytes")
        if ref_y is None:
            ref_y = y  # colwise psum, the first config
            plain = gemv_plain(a, x).to(torch.bfloat16)
            rel_plain = ((y.float() - plain.float()).abs() / plain.float().abs()).max().item()
            check(rel_plain <= 2 ** -7, f"{label}: rel err {rel_plain} against the plain GEMV")
            del plain
        # bf16 outputs of fp32 sums taken in other orders: one bf16 ulp.
        rel = ((y.float() - ref_y.float()).abs() / ref_y.float().abs()).max().item()
        check(y.shape == (n,) and bool(torch.isfinite(y).all()) and rel <= 2 ** -7,
              f"{label}: rel err {rel} against psum > 2^-7")
        ms = res.mean_time_s * 1e3
        bound_ms = res.gbps * res.mean_time_s / H100_HBM_PEAK_GBPS * 1e3
        emit({"phase": "ring_main", "strategy": strategy, "combine": combine,
              "stages": s, "shape": [n, n], "dtype": "bfloat16", "mesh": list(mesh.grid),
              "shards_on_cuda0": p, "measure": res.measure, "n_reps": N_REPS, "ms": ms,
              "bound_ms": bound_ms, "share_of_bound": bound_ms / ms,
              "launches": launched, "launches_per_matvec": per_call or 1,
              "peak_bytes_beyond_a": peak_extra, "max_rel_err_vs_psum": rel,
              "rtol": 2 ** -7})
        del y
    del a, x, ref_y
    torch.cuda.empty_cache()

    # ---- 23. run_serve through pallas_ring and overlap@4 ----
    with tempfile.TemporaryDirectory() as tmp:
        mesh = ring_mesh("1d")
        p = mesh.size
        for combine, stages, n_requests in RING_SERVE_CONFIGS:
            label = combine + (f"@{stages}" if stages else "")
            snapshot = Path(tmp) / f"ring_{label}.json"
            gemv_cuda.launches = gemm_cuda.launches = ring_gemv_cuda.launches = 0
            res = run_serve("colwise", mesh, n, n, dtype="bfloat16", kernel="cuda",
                            combine=combine, stages=stages, max_bucket=SERVE_MAX_BUCKET,
                            promote=SERVE_PROMOTE, n_requests=n_requests,
                            seed=args.seed, metrics_out=str(snapshot))
            torch.cuda.synchronize(dev)
            launched = {"gemv": gemv_cuda.launches, "gemm": gemm_cuda.launches,
                        "ring_gemv": ring_gemv_cuda.launches}
            dispatches = json.loads(snapshot.read_text())["counters"][
                "engine_dispatches_total"]
            if combine == "pallas_ring":
                # Vectors through the ring kernel, promoted blocks through
                # the GEMM on each shard (the default batched psum).
                ok = (launched["gemv"] == 0 and launched["ring_gemv"] > 0
                      and launched["gemm"] > 0 and launched["gemm"] % p == 0
                      and launched["ring_gemv"] + launched["gemm"] // p == dispatches)
                ring_launches[f"serve_{label}"] = launched["ring_gemv"]
            else:
                cells = p * p * stages  # per dispatch, vector or block
                ok = (launched["ring_gemv"] == 0 and launched["gemv"] > 0
                      and launched["gemm"] > 0
                      and launched["gemv"] + launched["gemm"] == dispatches * cells)
            check(ok, f"serve {label}: launches {launched}, {dispatches} dispatches")
            check(res.compiles_warmup == 5 and res.compiles_steady == 0,
                  f"serve {label}: builds {res.compiles_warmup} + {res.compiles_steady}")
            torch.cuda.empty_cache()
            # One request of each width through a fresh engine of the same
            # configuration: its labels, and its results against the plain GEMM.
            engine = MatvecEngine(resident_matrix(n, n, torch.bfloat16, dev, args.seed),
                                  mesh, strategy="colwise", kernel="cuda", combine=combine,
                                  stages=stages, max_bucket=SERVE_MAX_BUCKET,
                                  promote=SERVE_PROMOTE)
            labels = {"matvec": engine._matvec_key().label(),
                      "gemm": engine._gemm_key(SERVE_MAX_BUCKET).label()}
            check(labels["matvec"].split(":")[3] == label,
                  f"serve {label}: matvec ExecKey {labels['matvec']}")
            a_ref = resident_matrix(n, n, torch.bfloat16, dev, args.seed)
            widths = [w for w in DEFAULT_WIDTH_MIX if w <= SERVE_MAX_BUCKET]
            pool = _request_pool(n, widths, torch.bfloat16, seed=args.seed + 1)
            rel = {}
            for w in widths:
                y = engine.submit(pool[w]).result()
                ref = gemm_plain(a_ref, pool[w].to(dev)).to(torch.bfloat16).cpu().float()
                rel[str(w)] = ((y.float() - ref).abs() / ref.abs()).max().item()
                check(tuple(y.shape) == (n, w) and rel[str(w)] <= 2 ** -7,
                      f"serve {label} width {w}: rel err {rel[str(w)]}")
            del engine, a_ref, pool
            torch.cuda.empty_cache()
            emit({"phase": "ring_serve", "strategy": "colwise", "combine": combine,
                  "stages": stages, "shape": [n, n], "dtype": "bfloat16",
                  "mesh": list(mesh.grid), "shards_on_cuda0": p, "kernel": "cuda",
                  "max_bucket": SERVE_MAX_BUCKET, "b_star": res.b_star,
                  "n_requests": res.n_requests, "total_cols": res.total_cols,
                  "wall_s": res.wall_s, "req_per_s": res.rps,
                  "cols_per_s": res.cols_per_s,
                  "p50_dispatch_ms": res.p50_dispatch_ms,
                  "p99_dispatch_ms": res.p99_dispatch_ms,
                  "compiles_warmup": res.compiles_warmup,
                  "compiles_steady": res.compiles_steady,
                  "promo_speedup": res.promo_speedup, "dispatches": dispatches,
                  "launches": launched, "exec_keys": labels,
                  "replay_max_rel_err_by_width": rel, "rtol": 2 ** -7})

    # ---- 24. the kernels line ----
    head = at["{0}x{0}".format(KERNEL_SHAPES[-1][0])]
    gemm_head = gemm_at["{0}x{1}x{2}_{3}".format(*GEMM_TIME_SHAPES[GEMM_HEAD])]
    quant_head = quant_at["{0}x{0}_{1}_n{2}".format(*QUANT_TIME_SHAPES[QUANT_HEAD])]
    ring_head = ring_at[f"{RING_N}x{RING_N}_p{RING_TIME_P[0]}"]
    emit({"kernels": [{
        "name": "gemv", "route": "cuda",
        "source": "matvec_mpi_multiplier_torch/csrc/gemv.cu",
        "replaces": "matvec_mpi_multiplier_tpu/ops/pallas_gemv.py:61",
        "launches": sum(launches_by_path["gemv"].values()),
        "launches_by_path": launches_by_path["gemv"],
        "max_abs_err": max(v["max_abs_err"] for v in at.values()),
        "ms": head["ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": head["library_ms"],
        "library_call": "torch.matmul(a, x[:, None]) in a's dtype, allow_tf32=False",
        "hbm_probe_gbps": probe_gbps, "hbm_nominal_gbps": H100_HBM_PEAK_GBPS,
        "at": at,
    }, {
        "name": "gemm", "route": "cuda",
        "source": "matvec_mpi_multiplier_torch/csrc/gemm.cu",
        "replaces": "matvec_mpi_multiplier_tpu/ops/pallas_gemm.py:48",
        "launches": sum(launches_by_path["gemm"].values()),
        "launches_by_path": launches_by_path["gemm"],
        "max_abs_err": gemm_head["max_abs_err"],
        "ms": gemm_head["ms"], "plain_ms": gemm_head["plain_ms"],
        "bound_ms": gemm_head["bound_ms"], "bound_by": gemm_head["bound_by"],
        "library_ms": gemm_head["library_ms"],
        "library_call": "torch.matmul(a, b) in a's dtype, allow_tf32=False",
        "at": gemm_at,
    }, {
        "name": "quant_gemv", "route": "cuda",
        "source": "matvec_mpi_multiplier_torch/csrc/quant_gemv.cu",
        "replaces": "matvec_mpi_multiplier_tpu/ops/pallas_quant.py:42",
        "launches": sum(quant_launches.values()),
        "launches_by_path": quant_launches,
        "max_abs_err": quant_head["max_abs_err"],
        "ms": quant_head["ms"], "plain_ms": quant_head["plain_ms"],
        "bound_ms": quant_head["bound_ms"], "bound_by": quant_head["bound_by"],
        # No PyTorch call computes a block-scaled GEMV; native_ms is the
        # port's own GEMV on the same A in fp32, what quantizing must beat.
        "library_ms": None, "native_ms": quant_head["native_ms"],
        "native_call": quant_head["native_call"],
        "at": quant_at,
    }, {
        "name": "solver_step", "route": "cuda",
        "source": "matvec_mpi_multiplier_torch/csrc/solver_step.cu",
        "replaces": "matvec_mpi_multiplier_tpu/ops/pallas_solver.py:190",
        # Each step call is two kernel launches: the update, then the GEMV.
        "launches": sum(solver_paths["solver_step"].values()),
        "kernel_launches_per_call": 2,
        "launches_by_path": solver_paths["solver_step"],
        "max_abs_err": step_at["cg"]["max_abs_err"],
        "ms": step_at["cg"]["ms"], "plain_ms": step_at["cg"]["plain_ms"],
        "bound_ms": step_at["cg"]["bound_ms"], "bound_by": step_at["cg"]["bound_by"],
        # No single PyTorch call computes a solver iteration; unfused_ms is
        # one iteration of the torch tier's body on the same A.
        "library_ms": None, "unfused_ms": step_at["cg"]["unfused_ms"],
        "at": step_at,
    }, {
        "name": "ring_gemv", "route": "cuda",
        "source": "matvec_mpi_multiplier_torch/csrc/ring_gemv.cu",
        "replaces": "matvec_mpi_multiplier_tpu/ops/pallas_collective.py:67",
        "launches": sum(ring_launches.values()),
        "launches_by_path": ring_launches,
        "max_abs_err": ring_head["max_abs_err"],
        "ms": ring_head["ms"], "plain_ms": ring_head["plain_ms"],
        "bound_ms": ring_head["bound_ms"], "bound_by": ring_head["bound_by"],
        # No PyTorch call computes a ring reduce-scatter GEMV over p panels;
        # the yardstick is one matmul of the unsharded A, and psum_scatter_ms
        # the un-fused schedule (gemv_cuda per panel, then psum_scatter).
        "library_ms": ring_head["library_ms"],
        "library_call": "torch.matmul(a, x[:, None]) on the unsharded A",
        "psum_scatter_ms": ring_head["psum_scatter_ms"],
        "at": ring_at,
    }]})

    # ---- 25. result ----
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
