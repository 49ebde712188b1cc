#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--seed N]

Builds the hand-written CUDA kernels (``csrc/gemv.cu``, ``csrc/gemm.cu``,
``csrc/quant_gemv.cu``, ``csrc/solver_step.cu``, ``csrc/ring_gemv.cu``,
``csrc/flash_attention.cu``; one ``nvcc`` each, in parallel) from the checkout's sources, holds each against its plain
PyTorch version, and drives the port's paths at full size, each with the
kernels' launch counts set to 0 just before it and read just after:

* the three strategies through ``build(..., kernel="cuda")`` and the
  reference timing protocol (the GEMV, on its ``rows`` route), and
  ``bench/sweep.py``'s asymmetric cells (120..1200 x 60000 fp32, each
  strategy at p = 1 through ``benchmark_strategy``), whose short rows take
  the GEMV's ``split`` route, each timed under both measures: ``loop`` (the
  default, dependent reps as replays of captured CUDA graphs) and
  ``chain``, with the loop's bump timed on its own and the cells whose A
  fits the L2 marked ``l2_resident``;
* the serving engine through ``bench.serve.run_serve``: a mixed-width
  request stream at 65536² bf16 on one card and at 32768² fp32 on a 2x2
  logical mesh, narrow blocks through the GEMV and promoted blocks through
  the GEMM, every key's program captured once as a CUDA graph and replayed
  (launches = (dispatches + captures) x shards);
* the GEMM through the sweep's entry point, ``benchmark_gemm``;
* quantized storage (int8, int8c, fp8): the quantizer on the card against
  the CPU, ``benchmark_strategy(..., dtype_storage=...)`` at 65536² fp32
  and colwise 32768² on 4 logical shards, and ``run_serve`` from an int8c
  resident at 65536² fp32 and an int8 one on a 2x2 mesh, every matvec and
  promoted block through the block-scaled GEMV on the route ``quant_route``
  plans (``wgmma_split`` for fp32 x; each call's route is counted and
  checked);
* served solvers through ``MatvecEngine.submit(op=...)`` on the seeded SPD
  ``solver_operand`` built on the card: cg and chebyshev at 65536² fp32
  rowwise on both iteration tiers (``torch``, and ``cuda_fused``, one fused
  step per iteration), gmres, power and lanczos on the ``torch`` tier,
  fused cg on colwise 32768² over 4 logical shards and from an int8c
  resident at 65536², and ``bench.serve.run_serve_solver`` (20 cg solves
  at 65536² on both tiers); cg and chebyshev as a device loop of captured
  chunks against the host-stepped loop at 65536² fp32, both tiers, equal
  iterations and x bitwise;
* colwise's combine schedules on 4 logical shards at 65536² bf16: the ring
  GEMV against its plain version (p = 1, 2, 4, 8, 16), ``benchmark_strategy``
  with every colwise combine (``pallas_ring`` through the ring GEMV, the
  others through the GEMV) and rowwise/blockwise's ``ring``/``overlap``
  gathers under both measures, each held against ``psum`` and to no
  panel-sized allocation, and ``run_serve`` with ``pallas_ring`` and
  ``overlap@4``;
* sequence-parallel attention: the flash-attention partial against its
  plain version (JAX's test shapes, a fully masked block, a ragged q-tile,
  d = 256, a ragged KV tile, the ring's hop and Ulysses' local shape), each
  on the route ``flash_route`` plans (``wgmma_split`` for bf16 k/v at d =
  128, ``ffma`` for the rest), rows 37:203 of the hop shape alone bitwise
  the full call's, then
  ``build_ring_attention`` and ``build_ulysses_attention`` on both tiers,
  causal and not, at s = 16384, h = 8, d_head = 128 bf16 on a 2x2 logical
  mesh (flash against xla, the xla tier on fp32 inputs against an fp64
  dense oracle, the multichip dryrun's checks) and at s = 4000, where the
  JAX package's predicate refuses every block and the kernel runs all the
  same; a gradient through the flash ring against the xla ring's, and
  each tier's gradient cost at s = 16384; both flash schedules at d_head =
  16 and 64 (the wrapper pads d) against the fp64 oracle at 2e-5;
  ``bench.attention.run_attention_study`` at s = 4096 and 16384 (looped
  timing). Every flash launch on bf16 inputs at d_head 128 must take
  ``wgmma_split``, every one on fp32 inputs ``ffma``;
* CUDA graphs: every kernel route captured and replayed, each replay
  bitwise equal to its eager launch (the GEMV's ``rows`` and ``split``; the
  GEMM's four routes; the block-scaled GEMV's three; the fused step for cg
  and chebyshev; the ring GEMV at p = 2, 4, 8; the flash partial on both
  routes, at d = 16 and 64 too, against its plain version at 2e-5).
* online reshard: every (src, dst) pair of ``parallel/reshard.py`` at
  65536² bf16 on a 2x2 logical mesh, each destination shard bitwise
  ``shard()`` of A in the destination layout, timed beside its copy bound
  (bytes copied read and written over the device-copy probe's rate) with
  its peak allocation; ``MatvecEngine.reshard`` under run_serve-style
  traffic, rowwise -> blockwise -> rowwise, every result bitwise a fresh
  engine's, no steady build after a warm reshard, memory back within one
  panel after each commit, dispatches queued just before the commit right;
  an int8c resident at 65536² fp32 moving its payload bitwise, and at
  65536 x 512 quantized again from the retained host A (numpy oracle);
* the tuning cache: ``tuning.search`` fills a temporary cache (the sweep's
  asymmetric GEMV cells in bf16 and fp32, the 2x2 fp32 serve cell's GEMV,
  GEMM buckets 16 and 32, stage count, combine and promotion crossover, and
  cg's iteration tier at 16384² fp32), keyed by the card's fingerprint; a
  second pass measures nothing, an entry under a JAX fingerprint never
  applies, and an engine with every ``"auto"`` dispatches the winners,
  bitwise what an engine with them named dispatches;
* load serving through the arrival-window scheduler
  (``bench.serve.run_serve_load``): blockwise 65536² bf16 at p = 1, 200
  single-column requests, closed loop at 1, 8 and 32 clients and open-loop
  poisson and burst arrivals, each with coalescing off and on (the GEMV for
  flushes below b*, the GEMM for buckets 4-32), and the int8c resident at
  65536² fp32 (every dispatch through the block-scaled GEMV): no steady
  build, no failure or bisection on clean traffic, every request traced;
  then the scheduler's own checks on the card: 8 coalesced requests bitwise
  equal to each alone through the same bucket and a batch below b* to solo
  vectors (``sched_exact``), a poisoned request isolated by bisection with
  its batchmates bitwise the unfaulted batch's, a NaN request refused by the
  integrity gate alone and an outage declared systemic (``sched_bisect``),
  and 32 client threads waiting on results while the flusher captures
  programs not captured yet (``sched_capture``);
* the recovery policy (``resilience/policy.py`` and the engine's ladders):
  a plain and a resilient engine on the serve cell's 200 requests at
  65536² bf16, bitwise the same results and launches by route, the policy
  off and on timed in one call, five passes each, and the ladder walk's host
  microseconds a dispatch (``resilient_clean``); a GEMV and a GEMM that
  really fail (plans the kernels refuse) raising to the caller under the
  policy, with no retry, downgrade or breaker fed (``resilient_real_error``);
  ``run_serve_load`` under chaos (transient device errors, 2% poisoned
  requests) at 8 and 32 coalescing clients: exactly the poisoned requests
  fail, every other one within 2^-7 of the fp32 product, retries and no
  breaker opened, and the obs CLI renders the SLO file and a flight bundle
  (``chaos_serve``); 64 distinct columns, each a scale of its own, through
  a resilient engine behind the scheduler, with poisoned batchmates,
  transient errors and a batch on the GEMV floor, each served column held
  against the plain GEMM of its own column (``chaos_columns``); a
  compile fault on the cuda GEMM keys opening the breaker, the torch tier
  serving, the half-open probe returning to ``wgmma_tma``, a halved bucket
  and the per-column GEMV floor (``degrade``); the native safe tier of an
  int8c 65536² fp32 resident placed once, timed, with the device memory
  after it (``quant_ladder``); and cg at 65536² fp32 served by the torch
  tier when the fused key fails to build, a ``nan`` fault refused
  (``solver_ladder``);
* multi-tenant residency (``engine/registry.py``), blockwise p = 1 at
  65536² bf16: three tenants under a budget of two payloads, every
  re-admitted result bitwise the tenant's first, each eviction freeing its
  payload's bytes at once, the ledger the sum of the tenants'
  ``device_resident_bytes``, every swap-in timed beside a pinned
  host-to-card copy probe (``multitenant``); ``run_serve_multitenant`` with
  4 tenants, Zipf 1.1, a budget of 2 payloads, the hottest pinned and 120
  requests, every result within 2^-7 of the fp32 product and the hit rate
  the LRU floor (``multitenant_trace``); faults on one tenant and a quota
  on another leaving the rest at availability 1.0
  (``multitenant_isolation``); two int8c 32768² fp32 tenants under a
  budget of one, charged payload and scales, re-admitted bitwise
  (``multitenant_quant``). The section keeps up to 4 tenants' host
  payloads (34.4 GB); the env line prints the host's ``MemTotal``;
* the calibrated cost model and the global scheduler
  (``tuning/cost_model.py``, ``engine/global_scheduler.py``): bf16
  calibration at p = 1 and on the 2x2 logical mesh, every constant positive
  and finite and ``mem_bps`` 0.5-1.05 of the run's copy probe
  (``cost_model_calibration``); predicted against measured for blockwise
  65536² at p = 1 (within 0.5-2x), the GEMM at b = 32 and the three
  strategies at 32768² on the 2x2 mesh, each pair into the divergence signal
  (``cost_model_predictions``); a tune pass with ``prune_margin`` 0.5 against
  an exhaustive one, the same winners from fewer measurements
  (``cost_model_pruning``); the scheduler's A/B on a seeded 3-tenant trace at
  65536² bf16 with deadlines, results bitwise between the arms, rejections
  typed, no expiry with it on, two tenants of one payload sharing a flush
  bitwise, interleaving on and off (``gsched_ab``); a reshard drift on the
  2x2 mesh whose migration is in the decision trace and whose result is
  bitwise a fresh engine's (``reshard_drift``);
* speculative dispatch (``ops/speculative.py``, the engine's two tiers) at
  65536² fp32, rowwise, p = 1: the armed engine's residency, its int8c
  quantization, P = U A on the card and the placement timed, P within 1 ulp
  of fp32 of the host's fp64 product on 64 columns, ``resident_bytes`` native
  plus the speculative set, the device memory (``spec_residency``); 200
  requests of widths 1-32 at rtol 1e-3 on uniform [0, 10) data, no
  escalation, every column within rtol of the fp64 product on the card,
  every speculative dispatch one block-scaled GEMV on ``wgmma_split`` and no
  native launch (``spec_accept``); a speculative submit and its result
  synchronizing as often as an exact one's under
  ``torch.cuda.set_sync_debug_mode("warn")`` (``spec_syncs``); the JAX
  test's adversarial operand at full width, every dispatch escalating,
  answers bitwise the plain engine's, and under a recovery policy the
  breaker standing the tier down (``spec_escalate``, ``spec_breaker``); the
  native, accepted and escalated paths and the check alone timed
  (``spec_times``); ``run_serve`` native against speculate in fp32 and bf16
  (``spec_serve``); an armed blockwise engine at 32768² on the 2x2 mesh
  resharded to rowwise, bitwise a fresh armed one (``spec_reshard``); a
  poisoned candidate refused with the gate off (``spec_poison``);
* the precision tiers and the solver models on them (section 46), rowwise
  at p = 1 on the 65536² fp32 solver operand of section 17: the four GEMV
  tiers (``compensated``, ``ozaki``, ``ozaki6``, ``ozaki_i8``) through
  ``strategy.build(kernel=...)`` against the fp64 product, each timed beside
  ``gemv_cuda`` and the byte bound, with its peak scratch, and its first 256
  rows bitwise the CPU port's (``precision_tiers``); the cancellation stress
  case of ``scripts/compensated_study.py`` at 512 x 4096, ozaki at 0 ulps
  (``precision_stress``); the GEMM tiers at 16384² x 32 beside ``gemm_cuda``
  and ``torch.matmul`` (``precision_gemm``); ``build_cg`` as a device loop
  of captured chunks (``precision_cg``); ``build_refined`` at full width
  with ``[A | b]`` and on a cond-1e5 SPD system at n = 4096 against plain
  fp32 CG (``precision_refined``); ``build_gmres`` on a nonsymmetric
  diagonally dominant 65536² operand, ``spectral_norm`` and
  ``condition_estimate`` (``precision_solvers``); the trainer on the 2x2
  logical mesh, its first steps against fp64, a checkpoint resumed bitwise
  (``precision_trainer``); ``bench.solve_cg`` and ``bench.solve`` in
  processes of their own at 16384 (``precision_clis``);
* the paper's benchmark path (section 47): ``entry.entry()`` on the card
  against numpy's fp64 product and ``entry.dryrun_multichip(4)`` on 4
  logical shards (``bench_entry``); the sweep CLI in-process over the
  asymmetric cells, fp32, the three strategies at p = 1, under ``loop``
  with ``--label-suffix card --metrics-out``, the same command with
  ``--skip-measured`` timing nothing, a ``--keep-going`` run whose first
  config fails (exit 5), then ``--mode reference --measure sync``
  (``bench_sweep``); blockwise 65536² bf16 p = 1 inside
  ``bench.profiling.trace`` with spans on and ``sync`` reps, the Chrome
  trace holding ``blockwise/local_gemv``, ``blockwise/combine/psum`` and
  the GEMV kernel once a call, and ``loop``/``chain`` ms with spans off and
  on (``bench_profile``); ``measure_link`` on the card beside section 43's
  pinned probe and ``bench.hostlink_study``'s derived rows over the
  literal ones (``bench_hostlink``); ``analysis.stats_visualization`` at a
  3350 GB/s peak and ``analysis.results_table`` over the sweep's CSVs
  (``bench_analysis``);
* the runtime remainder (section 48): the native C++ tier built with
  ``g++`` from the port's ``native/*.cc``, ``gemv_cuda`` against its
  ``gemv_ctypes`` oracle at 120 and 1200 x 60000 and 10200² fp64 and
  ``gemm_cuda`` against ``gemm_ctypes`` at 1024³ fp64, both times of each
  (``runtime_native``); the native text loader on a 2400² ``%.4f`` file,
  bitwise numpy's, both times (``runtime_loader``); ``--kernel native
  --platform cuda`` refused before any cell (``runtime_sweep_native``); two
  processes on the card joined by gloo (this script again,
  ``--runtime-worker``), one shard each, rowwise, colwise and blockwise
  (2x1 and 1x2) at 65536² bf16 through the build and
  ``benchmark_strategy(measure="sync")``, every y bitwise one process's on
  the same grid, the same max time on both sides, one CSV row, the times
  beside one process's and the exchange's share (``runtime_multiprocess``;
  the GEMV launches under the ``multiprocess`` path).

Every section prints its seconds (``"phase": "seconds"`` lines, and all of
them before the kernels line).

It checks the answers and times each kernel beside its bound, its plain
version and the library call. The GEMV is held to its plain version on both
of its routes (``rows``, ``split``, planned by ``gemv_plan``), every other
route and grid bitwise equal to the planned one, row slices bitwise equal
to the full call's, and timed with a cold L2 at the sweeps' shapes (all of
``ASYMMETRIC_SIZES`` in fp32 and bf16, two in fp64; ``SQUARE_SIZES`` in
fp32) beside ``torch.matmul``. The GEMM is held to its plain version on each
of its routes (``wgmma_tma``, ``mma_sync``, ``ffma``, ``dfma``), bitwise
repeatable and independent of pad columns and of row slices of A, and its
routes are counted on every path. Every phase prints one JSON line; any failed
check raises, and the script exits non-zero. The line before the last is
``{"kernels": [...]}``; the last is ``{"ok": true, "device": {...}}``.

Needs a CUDA device and ``nvcc``; without a card it exits non-zero and
prints no result. Writes CSVs, traces and figures into temporary
directories only, and imports nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import warnings
from collections import Counter
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

# The GEMV against its plain version, every route and grid bitwise the
# planned one's: the fixture, a misaligned k, a square shape, the
# asymmetric regime, m = 1, an m that is not a multiple of 8 (split), a bf16
# row that is not 16-byte aligned, and k shorter than one slab at a ragged
# m (rows).
CHECK_SHAPES = [(4, 8), (1000, 3001), (4096, 4096), (120, 60000), (1, 60000),
                (123, 60000), (120, 60001), (2501, 999)]
# The GEMV's row slices: rows 0:120 and 1000:1123 of this A (rows route)
# against the slices' own calls (split), bitwise.
GEMV_SLICE_SHAPE = (8192, 60000)
# (strategy, n, dtype, logical shards on cuda:0)
MAIN_CONFIGS = [
    ("blockwise", 65536, "bfloat16", 1),
    ("rowwise", 65536, "bfloat16", 1),
    ("colwise", 65536, "bfloat16", 1),
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
# The asymmetric phase times bench/sweep.py's ASYMMETRIC_SIZES in fp32 and
# bf16, and these in fp64; the square-sweep phase its SQUARE_SIZES in fp32.
ASYMMETRIC_FP64 = [(120, 60000), (1200, 60000)]
# Peak fp32 rate outside the tensor cores (H100 SXM data sheet): the
# GEMV's 2·m·k flops run there, as do the GEMM's for fp32 (FFMA).
FP32_PEAK_FLOPS = 67e12
# Peak fp64 rate outside the tensor cores (H100 SXM data sheet): the GEMM's
# fp64 route (DFMA). 67 TFLOP/s is the fp64 tensor-core (DMMA) rate.
FP64_PEAK_FLOPS = 34e12
# Dense bf16/fp16 tensor-core peak (H100 SXM data sheet): the GEMM's
# 16-bit routes (wgmma, mma.sync).
TENSOR_PEAK_FLOPS = 989e12

# (m, k, n): the 4x8 fixture, a ragged k (mma_sync for 16-bit A), the
# engine's widths at 4096², a ragged m with a bucket-4 B (8-byte rows), a
# k that is a multiple of 8 but not of the 64-deep k-block, and the
# operation face: a square GEMM, n = 256 and a ragged n > 128.
GEMM_CHECK_SHAPES = [(4, 8, 3), (1000, 3001, 5), (4096, 4096, 1),
                     (4096, 4096, 4), (1000, 4096, 4), (4096, 4104, 8),
                     (4096, 4096, 32), (4096, 4096, 128), (2048, 2048, 2048),
                     (2048, 2048, 256), (2048, 2048, 300)]
# (label, strategy, n, dtype, logical shards on cuda:0, steady requests)
SERVE_CONFIGS = [
    ("65536_bf16", "blockwise", 65536, "bfloat16", 1, 200),
    ("2x2_32768_fp32", "blockwise", 32768, "float32", 4, 40),
]
SERVE_MAX_BUCKET = 32
SERVE_PROMOTE = 4
# (m, k, n, dtype): the engine's promoted buckets at 65536² bf16 (4-32 in
# the serve cells, 64 and 128 on the engine's default ladder), the 2x2
# mesh's 16384² fp32 shard at its buckets 4-32, and the sweep's square
# GEMM. The kernels line reports GEMM_HEAD, the widest bucket of the
# full-width cell.
GEMM_TIME_SHAPES = [(65536, 65536, 4, "bfloat16"), (65536, 65536, 8, "bfloat16"),
                    (65536, 65536, 16, "bfloat16"), (65536, 65536, 32, "bfloat16"),
                    (65536, 65536, 64, "bfloat16"), (65536, 65536, 128, "bfloat16"),
                    (16384, 16384, 4, "float32"), (16384, 16384, 8, "float32"),
                    (16384, 16384, 16, "float32"), (16384, 16384, 32, "float32"),
                    (4096, 4096, 4096, "bfloat16"), (4096, 4096, 4096, "float32")]
GEMM_HEAD = 3

# Quantized storage. (m, k, block): the 4x8 fixture's shape, JAX's block-48
# test shape, a ragged shape, a square one, the asymmetric regime, whose
# default block at k = 60000 is 32, and a k and block that are not multiples
# of 16 (every dtype on the fma route). Each dtype takes the route
# quant_route plans: bf16/fp16 x wgmma, fp32 wgmma_split, fp64 fma.
QUANT_CHECK_SHAPES = [(4, 8, 4), (6, 96, 48), (1000, 3008, 64), (4096, 4096, 128),
                      (120, 60000, 32), (100, 1000, 8)]
QUANT_FORMATS = ("int8", "int8c", "fp8")
# x as (k,) and (k, n): every tile of the tensor-core routes (16, 32 and 64
# rows of parts), 33 past one tile of 32 columns, and 128, four tiles.
QUANT_WIDTHS = (None, 2, 4, 8, 16, 32, 33, 128)
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
# (n, format, width, x's dtype): the shapes the quantized path hands the
# kernel, with fp32 x (wgmma_split: int8's vector on its CUDA-core face,
# n = 2 on the tensor cores at the tile a vector takes); bf16 x at n = 4, 32
# (wgmma, one part); the 2x2 mesh's 16384² int8 shard. QUANT_HEAD is the
# kernels line's head: the int8c vector at full width, the serve cell's GEMV.
QUANT_TIME_SHAPES = [(65536, f, w, "float32") for f in QUANT_FORMATS
                     for w in (1, 2, 4, 32)] + [
    (65536, "int8", 4, "bfloat16"), (65536, "int8", 32, "bfloat16"),
    (16384, "int8", 1, "float32")]
QUANT_HEAD = 4

# Served solvers. The fused step against its plain version, (m_loc, k_loc,
# n, off): rowwise shards (off = 0, all of p) and a colwise segment at
# off > 0, and a short shard whose native GEMV takes the split route; a
# payload's k rounds up to a multiple of 8 (whole scale blocks).
# The full-width case is SOLVER_N below.
SOLVER_CHECK_SHAPES = [(4, 8, 8, 0), (96, 96, 96, 0), (1000, 3001, 3001, 0),
                       (4096, 4096, 4096, 0), (4096, 1024, 4096, 2048),
                       (120, 20000, 24000, 3000)]
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
# The device loop against the host-stepped one for cg. On the solver
# operand (condition number about 1.6) cg converges inside one chunk, and
# at a tighter tolerance the fused tier's recurrence residual underflows to
# 0 inside one chunk too. So cg runs on the operand with 0..LOOP_CMP_RAMP
# added along its diagonal (still SPD, condition number about 30) at an
# unreachable tolerance, to a cap that runs the first chunk eagerly,
# replays the captured one and reaches the periodic refresh at 50.
LOOP_CMP_RAMP = 6e5
LOOP_CMP_RTOL = 1e-30
LOOP_CMP_MAXITER = 60
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

# The flash-attention partial: (h, sq, sk, d, q offset, k offset) checked in
# fp32 and bf16 k/v, causal and not. The JAX kernel test's shape with offset
# q positions; a fully masked block (keys all after the queries, causal
# only); sq = 8·25 (a ragged q-tile) with sk = 3·128; d = 256 (two column
# chunks); the ring's hop shape at s = 4000 on 4 shards (sk = 1000: a ragged
# KV tile, and a shape the JAX package's predicate refuses); the ring's hop
# shape at s = 16384 on 4 shards; Ulysses' local step (2 heads of 8 per
# shard, the whole sequence). The kernels line's head is the s = 16384 hop
# shape in bf16, non-causal.
FLASH_CHECK_SHAPES = [(2, 256, 512, 128, 96, 0), (1, 128, 128, 128, 0, 1000),
                      (2, 200, 384, 128, 50, 0), (2, 256, 256, 256, 30, 0),
                      (8, 1000, 1000, 128, 0, 0),
                      (8, 4096, 4096, 128, 0, 0), (2, 16384, 16384, 128, 0, 0)]
FLASH_TOL = 2e-5  # rtol = atol, as the JAX package's kernel test
# bf16 tensor-core passes per product that hold FLASH_TOL: q and P each split
# in three (tests/test_torch_flash_route.py shows two miss). The flash
# partial's bound_ms counts the function's 4·d flops per unmasked pair once
# at TENSOR_PEAK_FLOPS; split3_ceiling_ms, the ceiling of the three-pass
# design, counts them FLASH_SPLIT_PASSES times.
FLASH_SPLIT_PASSES = 3
# The JAX attention study's width (scripts/attention_study.py:38-44) at its
# "real backend" length, on the 2x2 logical mesh of cuda:0.
ATT_S, ATT_H, ATT_D = 16384, 8, 128
ATT_STUDY_SEQS = (4096, 16384)
ATT_GRAD_S = 4096
# A sequence length at which JAX's predicate refuses both flash blocks (the
# ring's (1000, 1000) hops, Ulysses' (4000, 4000) step): the kernel runs.
ATT_REFUSED_S = 4000

# Online reshard: every (src, dst) pair at 65536² bf16 on a 2x2 logical
# mesh of cuda:0; the engine's migration under run_serve-style traffic of
# RESHARD_REQUESTS requests (every width of the serve mix once, then seeded
# draws); the int8c resident at 65536² fp32, whose blocks are the same in
# every layout, and at 65536 x RESHARD_NEW_BLOCK_K, where colwise's 4 shards
# halve the block, so the migration quantizes A again from the host copy.
RESHARD_N = 65536
RESHARD_REQUESTS = 20
RESHARD_NEW_BLOCK_K = 512
# The numpy oracle's budget for a quantized result
# (tests/test_torch_engine_quantized.py): rtol, atol.
QUANT_ORACLE_TOL = (1e-4, 1e-5)

# The tune pass: the sweep's asymmetric GEMV cells in both dtypes, the 2x2
# fp32 serve cell (32768² blockwise: its 16384² GEMV and its GEMM buckets 16
# and 32, its stage count, combine and promotion crossover), and cg's
# iteration tier at 16384² fp32 rowwise on one shard.
TUNE_GEMV_ROWS = (120, 600, 720, 1200)
TUNE_GEMV_K = 60000
TUNE_SERVE_N = 32768
TUNE_GEMM_BUCKETS = (16, 32)
TUNE_SOLVER_N = 16384
# Load serving through the arrival-window scheduler (bench/serve.py
# run_serve_load): blockwise 65536² bf16 at p = 1, LOAD_REQUESTS single-column
# requests (the JAX load bench's width mix), closed loop at each client count
# with coalescing off and on, then open-loop poisson and burst arrivals (burst
# LOAD_BURST) at LOAD_OPEN_RATE_SHARE of the req/s the uncoalesced
# LOAD_RATE_CLIENTS-client run sustained; and the int8c resident at 65536² fp32
# (LOAD_QUANT_CLIENTS clients). promote and flush_width are SERVE_PROMOTE.
LOAD_N = 65536
LOAD_REQUESTS = 200
LOAD_CONCURRENCY = (1, 8, 32)
LOAD_RATE_CLIENTS = 8
LOAD_OPEN_RATE_SHARE = 0.8
LOAD_BURST = 8
LOAD_QUANT_CLIENTS = 8
# The scheduler's checks: 8 coalesced vectors at 65536² bf16 (bucket 8)
# against each alone through the same bucket, 3 below b* against solo
# vectors; bisection and the integrity gate at 4096² fp32; 32 client threads
# of 8 requests each (widths 1-3) at 4096² fp32 against programs not captured
# yet.
SCHED_EXACT_WIDTH = 8
SCHED_SUB_WIDTH = 3
SCHED_BISECT_N = 4096
SCHED_POISON = 1e30
SCHED_CAPTURE_N = 4096
SCHED_CAPTURE_CLIENTS = 32
SCHED_CAPTURE_REQUESTS = 8
SCHED_CAPTURE_RTOL = 1e-5  # fp32 sums at k = 4096 against fp64 (PERF.md §2)
# The recovery policy at 65536² bf16: the serve cell's 200-request width mix
# through a plain and a resilient engine; chaos load serving at 8 and 32
# clients (transient device errors at p = 0.05, 2% of the requests
# poisoned); a compile fault on the cuda GEMM keys that opens a breaker
# after three failures and recovers after the cooldown.
RESIL_REQUESTS = 200
CHAOS_CLIENTS = (8, 32)
CHAOS_FAULT_SPEC = "dispatch:device_error:p=0.05"
CHAOS_POISON_RATE = 0.02
DEGRADE_WIDTH = 8
DEGRADE_FAULTS = 3
DEGRADE_RESET_S = 1.0
# Policy off and on: passes of each after the first pair.
RESIL_PASSES = 4
# 64 distinct columns (column j scaled by 2^(j/8), so any two results differ
# by more than the 2^-7 the check allows) in batches of 8: batch 0 on the
# GEMV floor (both GEMM levels fail once), four batches with a poisoned
# column, transient device errors at p = 0.1 throughout.
CHAOS_COLUMNS = 64
CHAOS_COLUMN_BATCH = 8
CHAOS_COLUMN_POISONED = (13, 29, 45, 61)
# Multi-tenant residency, blockwise p = 1 at 65536² bf16 (8.59 GB a tenant):
# the eviction smoke's tenants and their request order under a budget of
# MT_SMOKE_BUDGET payloads; the trace (run_serve_multitenant) at
# MT_TRACE_TENANTS tenants, Zipf MT_ZIPF_A, a budget of MT_TRACE_BUDGET
# payloads, MT_PIN_HOT pinned and MT_TRACE_REQUESTS vector requests; the
# isolation run's faults on tenant-1 and quota on tenant-2 over
# MT_CHAOS_REQUESTS requests; the int8c tenants at MT_QUANT_N² fp32 under a
# budget of one. The pinned copy probe moves MT_PROBE_BYTES.
MT_N = 65536
MT_SMOKE_TENANTS = 3
MT_SMOKE_BUDGET = 2
MT_SMOKE_ORDER = (0, 1, 2, 0, 1, 2, 0)
MT_TRACE_TENANTS = 4
MT_ZIPF_A = 1.1
MT_TRACE_BUDGET = "2x"
MT_PIN_HOT = 1
MT_TRACE_REQUESTS = 120
MT_CHAOS_REQUESTS = 40
MT_CHAOS_FAULT = "dispatch:device_error:key=tenant-1/*"
MT_CHAOS_QUOTA = "tenant-2=1"
MT_QUANT_N = 32768
MT_QUANT_ORDER = (0, 1, 0, 1)
MT_PROBE_BYTES = 1 << 31

# The cost model and the global scheduler (section 44): calibration on p = 1
# and on the 2x2 logical mesh (bf16, the main path's dtype); predictions of
# blockwise CM["main_n"]² at p = 1, the three strategies at CM["mesh_n"]² on
# the 2x2 mesh and the GEMM bucket at b = CM["gemm_b"]; a tune pass with
# prune_margin 0.5 against an exhaustive one at CM["tune_n"]² (hysteresis
# 0.25 in both, so noise cannot unseat a default); the global scheduler's A/B
# at CM["gs_n"]² (CM["gs_tenants"] tenants, budget CM["gs_budget"], Zipf
# 1.1, CM["gs_requests"] requests paced at CM["gs_rate"] req/s with
# CM["gs_deadline_ms"] ms deadlines) and two tenants of one payload sharing
# a flush; one reshard drift at CM["drift_n"]² on the 2x2 mesh.
CM = {
    "main_n": 65536, "mesh_n": 32768, "gemm_b": 32, "tune_n": 16384,
    "gs_n": 65536, "gs_tenants": 3, "gs_budget": "2x", "gs_requests": 24,
    "gs_rate": 2.0, "gs_deadline_ms": 1000.0, "drift_n": 16384,
    "drift_requests": 60, "drift_rollover": 6, "drift_skip": 24,
    "drift_width": 8, "drift_pre_rate": 6.0, "n_reps": 10,
    # The calibration's reps: the minimum of 10 sync reps of the 256 MB GEMV
    # probe read between 111 and 166 µs from one call to the next (the host's
    # share of a fenced call), 50 keep the minimum at the probe's own time.
    "cal_reps": 50,
    # Interleaving, measured: three tenants at il_n² bf16 under a budget of
    # two, demand moving from tenant 0 to tenant 1 and back after one
    # request of tenant 2, closed loop, the scheduler's interleave always
    # considered (threshold 0) against never (infinite threshold). At
    # 32768² a payload hashes in under 2 s (65536²: 6.5-7.9 s, six times).
    "il_order": (0, 0, 0, 0, 1, 1, 1, 1, 2, 1, 1, 0, 0, 0), "il_n": 32768,
}

# Speculative dispatch (section 45): the residency of an armed rowwise engine
# at SP["n"]² fp32 on one card (P checked on SP["p_cols"] columns against the
# host's fp64 product); a well-conditioned stream of SP["stream"] requests of
# widths 1..SP["max_bucket"] (b* SP["promote"]) at rtol SP["rtol"]; the
# adversarial operand at widths 1 and SP["adv_widths"], then SP[
# "breaker_requests"] vectors under a recovery policy; the times of native,
# the accepted path and the check alone at the widths SP["time_widths"], of
# the escalated path at b = 1 and b = SP["max_bucket"] (SP["time_reps"] calls
# on CUDA events; at b = 1 and SP["max_bucket"] also SP["e2e_reps"] submits on
# the host clock); run_serve native against speculate in each of
# SP["serve_dtypes"] (SP["serve_requests"] requests); an armed blockwise
# engine at SP["reshard_n"]² on the 2x2 mesh resharded to rowwise; a
# poisoned candidate at SP["reshard_n"]².
SP = {
    "n": 65536, "rtol": 1e-3, "max_bucket": 32, "promote": 4, "p_cols": 64,
    "stream": 200, "adv_widths": (2, 8, 32), "breaker_requests": 5,
    "time_reps": 50, "e2e_reps": 20, "time_widths": (1, 4, 8, 16, 32),
    "serve_requests": 200,
    "serve_dtypes": ("float32", "bfloat16"), "reshard_n": 32768,
}

# The precision tiers and the solver models (section 46), rowwise on one
# card: the four GEMV tiers on section 17's operand at PS["n"]² fp32 (each
# against the fp64 product, the card's first PS["slice_rows"] rows bitwise
# the CPU port's), timed over PS["reps"] calls after one; the cancellation
# stress case at PS["stress"]; the GEMM tiers at PS["gemm"] (n, columns) fp32;
# build_cg at rtol PS["cg_rtol"]; refinement at full width, then the
# cond-PS["refine_cond"] SPD system at PS["small_n"] (numpy's seeded QR, as
# tests/conftest.py builds it) against plain fp32 CG at PS["plain_tol"];
# power iteration at PS["spectral_tol"] on section 17's operand; gmres
# (restart PS["gmres_restart"]) on a nonsymmetric diagonally dominant operand
# at PS["n"]²; condition_estimate on a prescribed spectrum (cond PS["cond"])
# at PS["small_n"]; the trainer at PS["n"]² fp32 on the 2x2 logical mesh for
# PS["train_steps"] steps at lr PS["train_lr"], its first PS["train_ref_steps"]
# against fp64; the two CLIs at PS["cli_n"].
PS = {
    "n": 65536, "tiers": ("compensated", "ozaki", "ozaki6", "ozaki_i8"),
    "slice_rows": 256, "reps": 3, "stress": (512, 4096), "gemm": (16384, 32),
    "gemm_slice_rows": 64, "cg_rtol": 1e-5, "small_n": 4096, "refine_cond": 1e5,
    "plain_tol": 1e-7, "plain_max_iters": 5000, "gmres_restart": 40,
    "gmres_rtol": 1e-5, "spectral_tol": 1e-4, "cond": 1e3, "train_steps": 20,
    "train_lr": 1e-2, "train_ref_steps": 3, "cli_n": 16384, "cli_steps": 20,
}

# Section 47, the benchmark path: the dryrun on BP["dryrun_shards"] logical
# shards; the sweep CLI over BP["sweep_sizes"] (BP["sweep_cells"] sizes, the
# three strategies at p = 1, fp32) under loop at BP["sweep_reps"] reps, then
# the reference mode at BP["ref_reps"]; --keep-going over
# BP["keep_going_sizes"] with the first config failing; the profile capture
# at BP["profile_n"]² bf16, blockwise p = 1, BP["profile_reps"] sync reps, and
# the spans' cost at BP["span_reps"]; the host link over the default ladder
# up to BP["link_max_mb"] MB.
BP = {
    "dryrun_shards": 4, "sweep_sizes": ["--sweep", "asymmetric"], "sweep_cells": 10,
    "sweep_reps": 30, "ref_reps": 3, "keep_going_sizes": (2048, 4096),
    "profile_n": 65536, "profile_reps": 5, "span_reps": 50,
    "link_max_mb": 256,
    "table_shape": "asym", "l2_cell": "120×60000",
}

# Section 48, the runtime remainder. The native tier: gemv_cuda against the
# C++ oracle (gemv_ctypes) at the reference's fp64 cells RT["gemv_shapes"],
# gemm_cuda against gemm_ctypes at RT["gemm_shape"] fp64, both at
# RT["oracle_rtol"] elementwise (uniform [0, 10) operands: sums of positive
# terms in another order); the native text loader against numpy on an
# RT["loader_n"]² %.4f file. Two processes on the card (gloo, host-staged)
# at RT["n"]² bf16: every config of RT["mp_configs"] (strategy, grid), one
# shard per process, through build and benchmark_strategy(measure="sync",
# RT["mp_reps"] reps), against one process with the same 2 logical shards.
RT = {
    "gemv_shapes": ((120, 60000), (1200, 60000), (10200, 10200)),
    "gemm_shape": (1024, 1024, 1024), "oracle_rtol": 1e-12, "loader_n": 2400,
    "n": 65536, "mp_reps": 20, "mp_timeout_s": 240,
    "mp_configs": (("rowwise", (1, 2)), ("colwise", (1, 2)), ("blockwise", (2, 1)),
                   ("blockwise", (1, 2))),
}

# An entry as the JAX package would write it for one of the same keys: its
# fingerprint is never the port's, so it must never apply.
JAX_FINGERPRINT = "gpu:NVIDIA_H100_80GB_HBM3:jax-0.4.35"


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def cost_model_section(dev, seed: int, cm: dict) -> dict:
    """Section 44: the calibrated cost model and the global scheduler on
    ``dev`` at the sizes of ``cm``. Emits one JSON line per part and returns
    the kernels' launches by path ({kernel: {path: n}}), each path driven
    with the counts set to 0 just before it and read just after. Runs at a
    small size on a CPU device too (the wrappers' plain versions)."""
    import gc

    import numpy as np
    import torch

    from matvec_mpi_multiplier_torch import get_strategy, make_mesh, tuning
    from matvec_mpi_multiplier_torch.bench.serve import (
        resident_matrix,
        run_reshard_drift,
        run_serve_multitenant,
    )
    from matvec_mpi_multiplier_torch.bench.timing import benchmark_gemm, benchmark_strategy
    from matvec_mpi_multiplier_torch.engine import MatrixRegistry, MatvecEngine
    from matvec_mpi_multiplier_torch.engine import global_scheduler as gs_mod
    from matvec_mpi_multiplier_torch.obs.registry import get_registry
    from matvec_mpi_multiplier_torch.ops.cuda_gemm import gemm_cuda
    from matvec_mpi_multiplier_torch.ops.cuda_gemv import gemv_cuda
    from matvec_mpi_multiplier_torch.ops.cuda_quant import quant_gemv_cuda
    from matvec_mpi_multiplier_torch.tuning import cost_model as cmod
    from matvec_mpi_multiplier_torch.tuning import search
    from matvec_mpi_multiplier_torch.tuning.cache import TuningCache, calibration_key

    on_card = dev.type == "cuda"
    bf16 = torch.bfloat16
    launches: dict = {"gemv": {}, "gemm": {}, "quant_gemv": {}}
    wrappers = (("gemv", gemv_cuda), ("gemm", gemm_cuda), ("quant_gemv", quant_gemv_cuda))

    def sync() -> None:
        if on_card:
            torch.cuda.synchronize(dev)

    def routed(name: str, fn):
        """fn() with the launch counts set to 0 just before it and read just
        after, under the path ``name``."""
        for _, w in wrappers:
            w.launches = 0
            w.route_launches.clear()
        out = fn()
        sync()
        for kernel, w in wrappers:
            if w.launches:
                launches[kernel][name] = launches[kernel].get(name, 0) + w.launches
        return out

    def finite_positive(cal) -> bool:
        values = [cal.flops, cal.mem_bps, *cal.alpha_s.values(), *cal.beta_bps.values()]
        return all(np.isfinite(v) and v > 0 for v in values)

    def cal_line(cal) -> dict:
        return {"p": cal.p, "level": cal.level, "flops": cal.flops,
                "mem_bps": cal.mem_bps, "alpha_s": cal.alpha_s,
                "beta_bps": cal.beta_bps, "probes": cal.probes}

    tune_dir = Path(tempfile.mkdtemp(prefix="cost_model_"))
    os.environ[tuning.CACHE_ENV] = str(tune_dir / "tuning_cache.json")
    tuning.reset_cache()
    swap_s: list[float] = []
    ensure_resident = MatvecEngine.ensure_resident

    def timed_ensure_resident(self):
        sync()
        t0 = time.perf_counter()
        placed = ensure_resident(self)
        sync()
        if placed:
            swap_s.append(time.perf_counter() - t0)
        return placed

    try:
        # (a) Calibration, beside this run's device-copy probe.
        probe = torch.empty(1 << 30 if on_card else 1 << 20, dtype=torch.int16, device=dev)
        probe_dst = torch.empty_like(probe)
        probe_dst.copy_(probe)
        sync()
        t0 = time.perf_counter()
        for _ in range(10):
            probe_dst.copy_(probe)
        sync()
        copy_bps = 2 * probe.numel() * 2 / ((time.perf_counter() - t0) / 10)
        del probe, probe_dst
        mesh1 = make_mesh(1, devices=[dev])
        mesh4 = make_mesh(4, devices=[dev] * 4)
        # Clocks up before the probes: the card idles through the host-bound
        # sections before this one, and the first probe read up to 0.2 below
        # the second without this (uncounted launches of the probe's shape).
        warm = resident_matrix(*cmod.CUDA_PROBES["gemv"], bf16, dev, seed + 39)
        for _ in range(4000 if on_card else 1):
            gemv_cuda(warm, warm[0])
        sync()
        del warm
        cal_log: list[str] = []
        cals = {}
        for name, mesh in (("p1", mesh1), ("2x2", mesh4)):
            cals[name] = routed("calibration", lambda mesh=mesh: cmod.calibrate(
                mesh, dtype="bfloat16", level="full", n_reps=cm["cal_reps"],
                log=cal_log.append))
        for name, cal in cals.items():
            check(finite_positive(cal), f"calibration {name}: {cal}")
            share = cal.mem_bps / copy_bps
            check(not on_card or 0.5 <= share <= 1.05,
                  f"calibration {name}: mem_bps {cal.mem_bps} is {share} of the "
                  f"copy probe's {copy_bps} (the GEMV probe read the L2, or nothing)")
        cache = TuningCache.load()
        for cal in cals.values():
            cache.record(calibration_key(cal.p), cal.to_record())
        cache.save()
        tuning.reset_cache()
        model1, model4 = cmod.CostModel(cals["p1"]), cmod.CostModel(cals["2x2"])
        emit({"phase": "cost_model_calibration", "copy_probe_bps": copy_bps,
              "mem_bps_over_copy": {n: c.mem_bps / copy_bps for n, c in cals.items()},
              "calibrations": {n: cal_line(c) for n, c in cals.items()},
              "log": cal_log})

        # (b) Predicted against measured, each pair into the divergence signal.
        pairs = {}

        def measured_s(result) -> float:
            return float(min(result.times_s))

        n = cm["main_n"]
        a = resident_matrix(n, n, bf16, dev, seed + 40)
        x = resident_matrix(1, n, bf16, dev, seed + 41)[0]
        blk = get_strategy("blockwise")
        res = routed("predictions", lambda: benchmark_strategy(
            blk, mesh1, a, x, n_reps=cm["n_reps"], measure="sync", kernel="cuda"))
        pred = model1.predict("blockwise", blk.default_combine(mesh1), m=n, k=n, p=1,
                              dtype="bfloat16")
        pairs[f"blockwise_{n}_p1"] = (pred.total_s, measured_s(res))
        b = resident_matrix(n, cm["gemm_b"], bf16, dev, seed + 42)
        res = routed("predictions", lambda: benchmark_gemm(
            "blockwise", mesh1, a, b, n_reps=cm["n_reps"], measure="sync", kernel="cuda"))
        pred = model1.predict("blockwise", blk.default_combine(mesh1), m=n, k=n, p=1,
                              dtype="bfloat16", b=cm["gemm_b"])
        pairs[f"gemm_blockwise_{n}_b{cm['gemm_b']}_p1"] = (pred.total_s, measured_s(res))
        del a, b, x
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
        n = cm["mesh_n"]
        a = resident_matrix(n, n, bf16, dev, seed + 43)
        x = resident_matrix(1, n, bf16, dev, seed + 44)[0]
        for name in ("rowwise", "colwise", "blockwise"):
            strat = get_strategy(name)
            res = routed("predictions", lambda strat=strat: benchmark_strategy(
                strat, mesh4, a, x, n_reps=cm["n_reps"], measure="sync", kernel="cuda"))
            pred = model4.predict(name, strat.default_combine(mesh4), m=n, k=n, p=4,
                                  dtype="bfloat16", r=2)
            pairs[f"{name}_{n}_2x2"] = (pred.total_s, measured_s(res))
        del a, x
        gc.collect()
        for predicted, measured in pairs.values():
            cmod.record_prediction(predicted, measured)
        ratios = {k: p_ / m_ for k, (p_, m_) in pairs.items()}
        main_ratio = ratios[f"blockwise_{cm['main_n']}_p1"]
        check(not on_card or 0.5 <= main_ratio <= 2.0,
              f"cost model: the p = 1 GEMV predicted/measured {main_ratio}")
        emit({"phase": "cost_model_predictions",
              "predicted_s": {k: v[0] for k, v in pairs.items()},
              "measured_s": {k: v[1] for k, v in pairs.items()},
              "predicted_over_measured": ratios, "measure": "sync, min of reps",
              "divergence_health": cmod.divergence_health()})

        # (c) Pruning against exhaustive tuning on the same shapes.
        n = cm["tune_n"]
        prune_logs: list[str] = []

        def tune_pass(cache, prune_margin) -> tuple[dict, int, int]:
            before = search.candidates_measured()
            pruned_before = get_registry().snapshot()["counters"].get(cmod.PRUNED_COUNTER, 0)
            kw = dict(measure="sync", n_reps=cm["n_reps"], samples=2, min_gain=0.25,
                      prune_margin=prune_margin, log=prune_logs.append)
            out = {}
            for name in ("rowwise", "colwise", "blockwise"):
                out[f"combine/{name}"] = search.tune_combine(
                    name, mesh4, n, n, "bfloat16", cache, **kw)["combine"]
                out[f"overlap/{name}"] = search.tune_overlap(
                    name, mesh4, n, n, "bfloat16", cache, **kw)["stages"]
            out["storage/rowwise"] = search.tune_storage(
                "rowwise", mesh4, n, n, "bfloat16", cache, **kw)["storage"]
            pruned = get_registry().snapshot()["counters"].get(cmod.PRUNED_COUNTER, 0)
            return out, search.candidates_measured() - before, pruned - pruned_before

        caches = {}
        for arm in ("exhaustive", "pruned"):
            caches[arm] = TuningCache(tune_dir / f"{arm}.json")
            caches[arm].record(calibration_key(4), cals["2x2"].to_record())
        exhaustive, n_exh, pruned_exh = routed("tune_exhaustive", lambda: tune_pass(
            caches["exhaustive"], None))
        pruned, n_pruned, n_skipped = routed("tune_pruned", lambda: tune_pass(
            caches["pruned"], 0.5))
        check(pruned == exhaustive, f"pruning changed a decision: {pruned} vs {exhaustive}")
        check(n_pruned < n_exh and n_skipped > 0 and pruned_exh == 0,
              f"pruning measured {n_pruned} of {n_exh} candidates, skipped {n_skipped}")
        check(sum(": pruned (" in line for line in prune_logs) == n_skipped,
              "every pruned candidate logs one line")
        emit({"phase": "cost_model_pruning", "shape": [n, n], "dtype": "bfloat16",
              "mesh": "2x2 logical", "decisions": pruned,
              "measured_exhaustive": n_exh, "measured_pruned": n_pruned,
              "tuning_pruned_candidates_total": n_skipped,
              "pruned_log": [ln for ln in prune_logs if ": pruned (" in ln]})

        # (d) The global scheduler's A/B on one seeded trace.
        MatvecEngine.ensure_resident = timed_ensure_resident
        n = cm["gs_n"]
        served = {"off": {}, "on": {}}
        runs = {}
        jsonl = tune_dir / "decisions.jsonl"
        for arm in ("off", "on"):
            metrics = tune_dir / f"metrics_{arm}.json"
            swaps_before = len(swap_s)

            def on_result(tid, x, y, arm=arm):
                served[arm].setdefault(
                    (tid, x.view(torch.int16).numpy().tobytes()), []).append(y)

            runs[arm] = routed(f"gsched_{arm}", lambda arm=arm, metrics=metrics:
                               run_serve_multitenant(
                "blockwise", mesh1, n, n, dtype="bfloat16", kernel="cuda",
                n_tenants=cm["gs_tenants"], zipf_a=1.1, hbm_budget=cm["gs_budget"],
                n_requests=cm["gs_requests"], seed=seed, deadline_ms=cm["gs_deadline_ms"],
                rate=cm["gs_rate"], max_in_flight=2, global_sched=arm == "on",
                demand_weight=2.0 if arm == "on" else 0.0,
                decision_jsonl=str(jsonl) if arm == "on" else None,
                metrics_out=str(metrics), on_result=on_result))
            runs[arm] = (runs[arm], json.loads(metrics.read_text())["counters"],
                         swap_s[swaps_before:])
        on, on_counters, on_swaps = runs["on"]
        off, off_counters, off_swaps = runs["off"]
        same = all(torch.equal(y, ys[0]) for arm in served.values()
                   for ys in arm.values() for y in ys)
        same &= all(torch.equal(ys[0], served["off"][key][0])
                    for key, ys in served["on"].items() if key in served["off"])
        check(same, "gsched: a result differs between the greedy and scheduled runs")
        all_on = on.rows[-1]
        check(on.deadline_expires == 0 and all_on.failed_requests == 0,
              f"gsched on: {on.deadline_expires} expires, {all_on.failed_requests} failed")
        check(sum(len(v) for v in served["on"].values())
              == cm["gs_requests"] - all_on.rejected,
              "gsched on: every request served or rejected (AdmissionRejectedError)")
        lines = [json.loads(ln) for ln in jsonl.read_text().splitlines()]
        check(lines and all("predicted_s" in d and "reason" in d for d in lines),
              "gsched: a decision line without predicted_s or reason")
        # The model the scheduler read (the largest calibrated mesh's).
        restore_pred = cmod.any_model_from_cache(TuningCache.load()).restore_s(n * n * 2)

        def arm_line(res, counters, swaps) -> dict:
            row = res.rows[-1]
            return {"on_time": res.on_time, "on_time_share": res.on_time / cm["gs_requests"],
                    "p50_e2e_ms": res.p50_e2e_ms, "p99_e2e_ms": res.p99_e2e_ms,
                    "rejected": row.rejected, "failed": row.failed_requests,
                    "deadline_expires": res.deadline_expires, "hits": row.hits,
                    "evictions": row.evictions, "wall_s": res.wall_s,
                    "interleaves": counters.get("gsched_interleaves_total", 0),
                    "swap_ins_timed": len(swaps),
                    "swap_in_median_s": statistics.median(swaps) if swaps else None}

        # Two tenants of one payload share a flush, each column bitwise its
        # solo result.
        def coalesce() -> dict:
            reg = MatrixRegistry(mesh1, strategy="blockwise", kernel="cuda", promote=None)
            a = resident_matrix(n, n, bf16, dev, seed + 45)
            reg.register("a0", a)
            reg.register("a1", a)
            del a
            t0 = time.perf_counter()
            reg.coalesce_group("a0")
            hash_s = time.perf_counter() - t0
            sched = gs_mod.GlobalScheduler(reg, cost_model=model1)
            xs = [resident_matrix(1, n, bf16, dev, seed + 46 + i)[0].cpu() for i in range(2)]
            solo = [reg._entry(f"a{i}").engine.submit(xs[i]).result() for i in range(2)]
            futs = [sched.submit(f"a{i}", xs[i]) for i in range(2)]
            flushed = sched.flush()
            ys = [f.result() for f in futs]
            flushes = [d for d in sched.decisions() if d["decision"] == "flush"]
            shared = reg.metrics.counter("sched_cross_tenant_coalesced_total").value
            sched.close()
            reg.close()
            check(flushed == 2 and len(flushes) == 1 and shared == 2
                  and all(torch.equal(y, s_) for y, s_ in zip(ys, solo)),
                  f"gsched coalesce: {flushed} flushed, {flushes}, shared {shared}")
            return {"flush": {k: flushes[0][k] for k in ("tenant", "predicted_s", "reason",
                                                        "n_requests", "width")},
                    "columns_bitwise_solo": True, "payload_hash_s": hash_s}

        swaps_before = len(swap_s)
        shared_flush = routed("gsched_coalesce", coalesce)

        # What interleaving costs or saves: the same closed-loop demand shift
        # with the interleave always considered and never.
        def interleave_arm(threshold: float) -> dict:
            n = cm["il_n"]
            reg = MatrixRegistry(mesh1, hbm_budget=2 * n * n * 2, strategy="blockwise",
                                 kernel="cuda", promote=None)
            for i in range(3):
                reg.register(f"i{i}", resident_matrix(n, n, bf16, dev, seed + 50 + i))
            sched = gs_mod.GlobalScheduler(reg, cost_model=model1,
                                           interleave_threshold_s=threshold)
            # The coalesce groups hash each host payload on first use (seconds
            # at this size): hashed here, so the demand estimates in the loop
            # see only the trace's own gaps.
            for i in range(3):
                reg.coalesce_group(f"i{i}")
            x = resident_matrix(1, n, bf16, dev, seed + 53)[0].cpu()
            lat, ys = [], []
            t0 = time.perf_counter()
            for i in cm["il_order"]:
                t1 = time.perf_counter()
                ys.append(sched.submit(f"i{i}", x).result())
                lat.append(time.perf_counter() - t1)
            wall = time.perf_counter() - t0
            counters = reg.metrics.snapshot()["counters"]
            order = [(d["decision"], d["tenant"]) for d in sched.decisions()
                     if d["decision"] in ("interleave", "evict")]
            sched.close()
            reg.close()
            return {"wall_s": wall, "latency_s": lat, "ys": ys, "decisions": order,
                    "interleaves": counters.get("gsched_interleaves_total", 0),
                    "swap_ins": counters.get("registry_swap_ins_total", 0),
                    "evictions": counters.get("registry_evictions_total", 0)}

        arms = {"on": routed("gsched_interleave", lambda: interleave_arm(0.0)),
                "off": routed("gsched_interleave", lambda: interleave_arm(float("inf")))}
        same_il = all(torch.equal(a, b) for a, b in zip(arms["on"].pop("ys"),
                                                        arms["off"].pop("ys")))
        emit({"phase": "gsched_ab", "shape": [n, n], "dtype": "bfloat16",
              "tenants": cm["gs_tenants"], "budget": cm["gs_budget"], "zipf_a": 1.1,
              "requests": cm["gs_requests"], "rate": cm["gs_rate"],
              "deadline_ms": cm["gs_deadline_ms"], "off": arm_line(*runs["off"]),
              "on": arm_line(*runs["on"]), "results_bitwise_off_on": True,
              "rejections_typed": True, "decision_lines": len(lines),
              "decisions": dict(Counter(d["decision"] for d in lines)),
              "restore_predicted_s": restore_pred,
              "swap_in_measured_median_s": statistics.median(off_swaps + on_swaps)
              if off_swaps + on_swaps else None,
              "coalesce": shared_flush,
              "interleave": {"order": list(cm["il_order"]), "shape": [cm["il_n"]] * 2,
                             "threshold_on_s": 0.0,
                             "results_bitwise": same_il, **arms}})
        check(arms["on"]["interleaves"] >= 1 and arms["off"]["interleaves"] == 0 and same_il,
              f"interleave: {arms['on']['interleaves']} on, {arms['off']['interleaves']} "
              "off, or a result differs")
        MatvecEngine.ensure_resident = ensure_resident

        # (e) A reshard drift on the 2x2 logical mesh.
        n, width = cm["drift_n"], cm["drift_width"]
        steady = {s: model4.predict(s, get_strategy(s).default_combine(mesh4), m=n, k=n,
                                    p=4, dtype="bfloat16", b=width, r=2).total_s
                  for s in ("rowwise", "colwise", "blockwise")}
        worst = max(steady, key=steady.get)
        captured: list = []
        submit = gs_mod.GlobalScheduler.submit

        def capturing_submit(self, tenant_id, x=None, **kw):
            fut = submit(self, tenant_id, x, **kw)
            captured.append((tenant_id, x, fut))
            return fut

        gs_mod.GlobalScheduler.submit = capturing_submit
        drift_jsonl = tune_dir / "drift.jsonl"
        try:
            drift = routed("reshard_drift", lambda: run_reshard_drift(
                worst, mesh4, n, n, dtype="bfloat16", kernel="cuda", n_tenants=2,
                n_requests=cm["drift_requests"], rollover=cm["drift_rollover"],
                steady_skip=cm["drift_skip"], width_steady=width,
                pre_rate=cm["drift_pre_rate"], seed=seed, reshard="auto",
                decision_jsonl=str(drift_jsonl)))
        finally:
            gs_mod.GlobalScheduler.submit = submit
        migrations = [json.loads(ln) for ln in drift_jsonl.read_text().splitlines()
                      if json.loads(ln)["decision"] == "reshard"]
        check(drift["reshards"] >= 1 and len(migrations) == drift["reshards"]
              and all("crossover" in d["reason"] for d in migrations),
              f"drift: {drift['reshards']} reshards, decision lines {migrations}")
        moved = [t for t, s_ in drift["final_strategies"].items() if s_ != worst]
        tid, x_last, fut = [c for c in captured if c[0] == moved[0]][-1]
        y_last = fut.result()
        fresh = MatvecEngine(resident_matrix(n, n, bf16, dev, seed + int(tid.split("-")[1])),
                             mesh4, strategy=drift["final_strategies"][tid], kernel="cuda",
                             max_bucket=width)
        y_fresh = routed("reshard_drift_fresh", lambda: fresh.submit(x_last).result())
        fresh.close()
        check(torch.equal(y_last, y_fresh),
              f"drift: {tid}'s result after the migration is not a fresh engine's")
        emit({"phase": "reshard_drift", "shape": [n, n], "dtype": "bfloat16",
              "mesh": "2x2 logical", "registered": worst,
              "predicted_steady_s": steady, **{k: drift[k] for k in (
                  "reshards", "reshard_bytes", "last_reshard_at", "final_strategies",
                  "p50_pre_ms", "p99_pre_ms", "p50_steady_ms", "p99_steady_ms",
                  "compiles_steady", "wall_s")},
              "migrations": [{k: d[k] for k in ("tenant", "src", "dst", "predicted_s",
                                                "old_s", "new_s", "migrate_s",
                                                "horizon_requests", "reason")}
                             for d in migrations],
              "bitwise_fresh_engine": True})
    finally:
        MatvecEngine.ensure_resident = ensure_resident
        shutil.rmtree(tune_dir, ignore_errors=True)
        del os.environ[tuning.CACHE_ENV]
        tuning.reset_cache()
    return launches


def speculative_section(dev, seed: int, sp: dict) -> tuple[dict, dict]:
    """Section 45: speculative dispatch (``ops/speculative.py``, the engine's
    two tiers) on ``dev`` at the sizes of ``sp``. Emits one JSON line per
    part and returns the kernels' launches by path ({kernel: {path: n}},
    each path driven with the counts set to 0 just before it and read just
    after) and each path's launches by route ({kernel: {path: {route: n}}}).
    Runs at a small size on a CPU device too (the wrappers' plain
    versions)."""
    import gc

    import numpy as np
    import torch

    from matvec_mpi_multiplier_torch import make_mesh
    from matvec_mpi_multiplier_torch.bench.serve import resident_matrix, run_serve
    from matvec_mpi_multiplier_torch.engine import MatvecEngine
    from matvec_mpi_multiplier_torch.engine import buckets
    from matvec_mpi_multiplier_torch.engine import core as engine_core
    from matvec_mpi_multiplier_torch.ops import speculative as spec_mod
    from matvec_mpi_multiplier_torch.ops.cuda_gemm import gemm_cuda
    from matvec_mpi_multiplier_torch.ops.cuda_gemv import gemv_cuda
    from matvec_mpi_multiplier_torch.ops.cuda_quant import quant_gemv_cuda
    from matvec_mpi_multiplier_torch.ops.graphs import capture
    from matvec_mpi_multiplier_torch.parallel.mesh import unshard
    from matvec_mpi_multiplier_torch.resilience import (
        FaultPlan, FaultSpec, ResiliencePolicy, ResultIntegrityError,
    )

    on_card = dev.type == "cuda"
    f32 = torch.float32
    n, rtol, bucket_max, promote = sp["n"], sp["rtol"], sp["max_bucket"], sp["promote"]
    s = spec_mod.probe_count(spec_mod.SPEC_RTOL_FLOOR)
    launches: dict = {"gemv": {}, "gemm": {}, "quant_gemv": {}}
    routes: dict = {"gemv": {}, "gemm": {}, "quant_gemv": {}}
    wrappers = (("gemv", gemv_cuda), ("gemm", gemm_cuda), ("quant_gemv", quant_gemv_cuda))
    mesh1 = make_mesh(1, devices=[dev])
    kw = dict(strategy="rowwise", max_bucket=bucket_max, promote=promote)

    def sync() -> None:
        if on_card:
            torch.cuda.synchronize(dev)

    def routed(name: str, fn):
        """fn() with the launch counts set to 0 just before it and read just
        after, under the path ``name``."""
        for _, w in wrappers:
            w.launches = 0
            w.route_launches.clear()
        out = fn()
        sync()
        for kernel, w in wrappers:
            if w.launches:
                launches[kernel][name] = launches[kernel].get(name, 0) + w.launches
                got = routes[kernel].setdefault(name, {})
                for route, k in w.route_launches.items():
                    got[route] = got.get(route, 0) + k
        return out

    def memory() -> dict:
        if not on_card:
            return {}
        free, total = torch.cuda.mem_get_info(dev)
        return {"allocated": torch.cuda.memory_allocated(dev),
                "peak_allocated": torch.cuda.max_memory_allocated(dev),
                "free": free, "total": total}

    def release(*engines) -> None:
        for e in engines:
            e.close()
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)

    def fp64_product(a, xs):
        """A x in float64 on the card, in row chunks of A."""
        x64 = xs.to(dev, torch.float64)
        out = torch.empty((a.shape[0], x64.shape[1]), dtype=torch.float64, device=dev)
        rows = max(1, (1 << 30) // (a.shape[1] * 8))
        for i in range(0, a.shape[0], rows):
            out[i:i + rows] = a[i:i + rows].double() @ x64
        return out

    def dispatches(width: int) -> int:
        """The dispatches submit() makes for a request of ``width`` columns."""
        if width == 1:
            return 1
        if width < promote:
            return width
        return len(buckets.split_widths(width, bucket_max))

    def dev_ms(fn, reps: int) -> float:
        """Mean ms of fn() over ``reps`` calls: CUDA events on the card (the
        device's timeline), the host clock on the CPU."""
        fn()
        sync()
        if on_card:
            with torch.cuda.device(dev):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(reps):
                    fn()
                end.record()
            end.synchronize()
            return start.elapsed_time(end) / reps
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps

    def e2e_ms(fn, reps: int) -> float:
        """Median host ms of fn() (a submit and its result)."""
        fn()
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        return float(statistics.median(times))

    def program(engine, key, build):
        return engine._cache.get(key, build)

    # The check's two products run torch.matmul in fp32: nothing may have
    # enabled TF32.
    check(not torch.backends.cuda.matmul.allow_tf32
          and torch.get_float32_matmul_precision() == "highest",
          "TF32 is enabled for fp32 matmul")

    # ---- (a) residency at n² fp32, rowwise, p = 1 ----
    a = resident_matrix(n, n, f32, dev, seed)
    sync()
    mem_before = memory()
    timed = {"quantize_s": 0.0, "project_s": 0.0, "place_s": 0.0}
    patched = {name: getattr(engine_core, name) for name in ("quantize_matrix", "project_probes")}
    place_spec = MatvecEngine._place_spec

    def timer(field, fn):
        def run(*args, **kwargs):
            sync()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            sync()
            timed[field] += time.perf_counter() - t0
            return out
        return run

    engine_core.quantize_matrix = timer("quantize_s", patched["quantize_matrix"])
    engine_core.project_probes = timer("project_s", patched["project_probes"])
    MatvecEngine._place_spec = timer("place_s", place_spec)
    try:
        t0 = time.perf_counter()
        eng = MatvecEngine(a, mesh1, dtype_storage="speculate", **kw)
        sync()
        build_s = time.perf_counter() - t0
    finally:
        for name, fn in patched.items():
            setattr(engine_core, name, fn)
        MatvecEngine._place_spec = place_spec
    qa, p_st, u = eng._spec
    pm = unshard(p_st)
    rng = np.random.default_rng(seed + 45)
    cols = np.sort(rng.choice(n, size=min(sp["p_cols"], n), replace=False))
    cols_t = torch.from_numpy(cols).to(dev)
    want = u.double().cpu().numpy() @ a[:, cols_t].double().cpu().numpy()
    got = pm[:, cols_t].cpu().numpy().astype(np.float64)
    ulps = np.abs(got - want) / np.spacing(np.abs(want).astype(np.float32)).astype(np.float64)
    check(float(ulps.max()) <= 1.0,
          f"P on the card is {ulps.max()} ulps of fp32 from the host fp64 product")
    int8c_bytes = qa.shards[0].nbytes  # p = 1: the one shard is the payload
    spec_bytes = int8c_bytes + s * (n + n) * 4
    check(eng.spec_resident_bytes == spec_bytes
          and eng.resident_bytes == n * n * 4 + spec_bytes
          and eng.device_resident_bytes == eng.resident_bytes,
          f"resident bytes {eng.resident_bytes} (device {eng.device_resident_bytes}) "
          f"!= native {n * n * 4} + speculative set {spec_bytes}")
    emit({"phase": "spec_residency", "shape": [n, n], "dtype": "float32",
          "strategy": "rowwise", "p": 1, "probes": s, "build_s": build_s, **timed,
          "p_cols_checked": int(len(cols)), "p_max_ulps": float(ulps.max()),
          "resident_bytes": eng.resident_bytes, "native_bytes": n * n * 4,
          "spec_resident_bytes": eng.spec_resident_bytes, "int8c_bytes": int8c_bytes,
          "spec_block": eng.spec_storage_block,
          "device_resident_bytes": eng.device_resident_bytes,
          "memory_before": mem_before, "memory_after": memory()})

    # ---- (b) a well-conditioned stream, mixed widths ----
    widths = [int(w) for w in rng.integers(1, bucket_max + 1, size=sp["stream"])]
    gen = torch.Generator(device=dev).manual_seed(seed + 451)
    xs = torch.rand((n, sum(widths)), generator=gen, device=dev, dtype=f32) * 10
    offsets = np.cumsum([0] + widths)
    reqs = [xs[:, int(o)] if w == 1 else xs[:, int(o):int(o) + w]
            for o, w in zip(offsets[:-1], widths)]
    eng.warmup(sorted(set(widths)))
    for w in sorted(set(widths)):  # every program run once, both tiers
        r = reqs[widths.index(w)]
        eng.submit(r).result()
        eng.submit(r, rtol=rtol).result()
    before = eng.health()["counters"]
    compiles = eng.stats.compiles

    def stream():
        futures = [eng.submit(r, rtol=rtol) for r in reqs]
        return [f.result() for f in futures]

    t0 = time.perf_counter()
    ys = routed("spec_accept", stream)
    stream_s = time.perf_counter() - t0
    after = eng.health()["counters"]
    n_spec = after["speculative_dispatches"] - before["speculative_dispatches"]
    check(n_spec == sum(dispatches(w) for w in widths),
          f"{n_spec} speculative dispatches for {len(widths)} requests")
    check(after["escalations"] == before["escalations"],
          f"{after['escalations'] - before['escalations']} escalations on the "
          "well-conditioned stream")
    check(eng.stats.compiles == compiles, "the warmed stream built a program")
    quant_routes = routes["quant_gemv"].get("spec_accept", {})
    check(not on_card or (launches["quant_gemv"].get("spec_accept", 0) == n_spec
                          and quant_routes == {"wgmma_split": n_spec}),
          f"quant_gemv launches {quant_routes} for {n_spec} speculative dispatches")
    check(not launches["gemv"].get("spec_accept") and not launches["gemm"].get("spec_accept"),
          "the accepted stream launched the native GEMV or GEMM")
    oracle = fp64_product(a, xs).cpu()
    worst = 0.0
    for o, w, y in zip(offsets[:-1], widths, ys):
        ref = oracle[:, int(o):int(o) + w]
        got_y = (y[:, None] if y.dim() == 1 else y).double()
        rel = (torch.linalg.vector_norm(got_y - ref, dim=0)
               / torch.linalg.vector_norm(ref, dim=0)).max().item()
        worst = max(worst, rel)
    check(worst <= rtol, f"an accepted column is {worst} from the fp64 product (rtol {rtol})")
    emit({"phase": "spec_accept", "requests": len(widths), "columns": int(sum(widths)),
          "widths": "1-%d" % bucket_max, "rtol": rtol, "speculative_dispatches": n_spec,
          "escalations": 0, "worst_rel_err": worst, "stream_s": stream_s,
          "quant_routes": quant_routes, "compiles_steady": 0})
    del ys, oracle

    # ---- (e) syncs: a speculative submit against an exact one ----
    syncs: dict = {}
    if on_card:
        vec, block = reqs[widths.index(1)] if 1 in widths else xs[:, 0], xs[:, :bucket_max]
        eng.submit(block).result()
        eng.submit(block, rtol=rtol).result()
        for label, req, r_ in (("exact_vector", vec, None), ("spec_vector", vec, rtol),
                               ("exact_block", block, None), ("spec_block", block, rtol)):
            torch.cuda.set_sync_debug_mode("warn")
            try:
                with warnings.catch_warnings(record=True) as caught:
                    warnings.simplefilter("always")
                    fut = eng.submit(req, rtol=r_)
                n_submit = len(caught)
                with warnings.catch_warnings(record=True) as caught:
                    warnings.simplefilter("always")
                    fut.result()
                n_result = len(caught)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            syncs[label] = {"submit": n_submit, "result": n_result}
        for face in ("vector", "block"):
            check(syncs[f"spec_{face}"] == syncs[f"exact_{face}"],
                  f"a speculative {face} submit synchronizes {syncs[f'spec_{face}']} "
                  f"times against {syncs[f'exact_{face}']}")
        emit({"phase": "spec_syncs", "sync_debug_mode": "warn", "counts": syncs})

    # ---- (d) times of the accepted path, the check and native ----
    times: dict = {}
    rtol_t = torch.full((), rtol, dtype=f32, device=dev)

    def accepted_times():
        for b in sp["time_widths"]:
            x_dev = xs[:, 0] if b == 1 else xs[:, :b].contiguous()
            x_host = x_dev.cpu()
            if b == 1:
                nat = program(eng, eng._matvec_key(), eng._build_matvec)
                spec_p = program(eng, eng._spec_matvec_key(), eng._build_spec)
            else:
                nat = program(eng, eng._gemm_key(b), lambda: eng._build_gemm(b))
                spec_p = program(eng, eng._spec_gemm_key(b), lambda: eng._build_spec(b))
            y = spec_p(x_dev, rtol)[0]
            y = y if b == 1 else y.contiguous()
            p0 = p_st.shards[0]

            def check_only():
                return spec_mod.verdict(p0 @ x_dev, u @ y, y, rtol_t, s)

            if on_card:
                graph, _ = capture(check_only, dev)
                check_call = graph.replay
            else:
                check_call = check_only
            reps = sp["time_reps"]
            times[f"b{b}"] = {
                "native_ms": dev_ms(lambda: nat(x_dev), reps),
                "accepted_ms": dev_ms(lambda: spec_p(x_dev, rtol), reps),
                "check_ms": dev_ms(check_call, reps),
            }
            if b in (1, bucket_max):
                times[f"b{b}"].update(
                    native_e2e_ms=e2e_ms(lambda: eng.submit(x_host).result(), sp["e2e_reps"]),
                    accepted_e2e_ms=e2e_ms(lambda: eng.submit(x_host, rtol=rtol).result(),
                                           sp["e2e_reps"]))

    routed("spec_times", accepted_times)
    release(eng)
    del a, xs, reqs, qa, p_st, u, pm

    # ---- (c) the adversarial operand: rows orthogonal to x ----
    gen = torch.Generator(device=dev).manual_seed(seed + 452)
    a = torch.randn((n, n), generator=gen, device=dev, dtype=f32)
    xv = torch.randn(n, generator=gen, device=dev, dtype=torch.float64)
    rows = max(1, (1 << 30) // (n * 8))
    for i in range(0, n, rows):
        blk = a[i:i + rows].double()
        blk -= torch.outer(blk @ xv, xv) / (xv @ xv)
        a[i:i + rows] = blk.float()
    x = xv.float()
    del xv, blk
    armed = MatvecEngine(a, mesh1, dtype_storage="speculate", **kw)
    plain = MatvecEngine(a, mesh1, **kw)
    adv = [x] + [torch.stack([x * (1 + j / 8) for j in range(w)], 1)
                 for w in sp["adv_widths"]]
    armed.warmup([1] + list(sp["adv_widths"]))
    plain.warmup([1] + list(sp["adv_widths"]))
    for r in adv:  # both tiers' programs run once
        plain.submit(r).result()
    h0 = armed.health()["counters"]
    got_adv = routed("spec_escalate", lambda: [armed.submit(r, rtol=rtol).result() for r in adv])
    h = armed.health()
    n_esc = h["counters"]["escalations"] - h0["escalations"]
    n_spec = h["counters"]["speculative_dispatches"] - h0["speculative_dispatches"]
    check(n_spec == sum(dispatches(r.shape[1] if r.dim() == 2 else 1) for r in adv)
          and n_esc == n_spec, f"{n_esc} escalations of {n_spec} speculative dispatches")
    check(h["storage"]["escalation_rate"] == 1.0,
          f"escalation rate {h['storage']['escalation_rate']} on the adversarial operand")
    want_adv = [plain.submit(r).result() for r in adv]
    check(all(torch.equal(g, w) for g, w in zip(got_adv, want_adv)),
          "an escalated answer is not bitwise the plain engine's")
    emit({"phase": "spec_escalate", "shape": [n, n], "dtype": "float32",
          "widths": [1] + list(sp["adv_widths"]), "speculative_dispatches": n_spec,
          "escalations": n_esc, "escalation_rate": h["storage"]["escalation_rate"],
          "bitwise_plain": True,
          "launches": {k: v.get("spec_escalate", 0) for k, v in launches.items()}})

    def escalated_times():
        for b in (1, bucket_max):
            x_dev = x if b == 1 else torch.stack([x * (1 + j / 8) for j in range(b)], 1)
            x_host = x_dev.cpu()
            if b == 1:
                nat = program(armed, armed._matvec_key(), armed._build_matvec)
                spec_p = program(armed, armed._spec_matvec_key(), armed._build_spec)
            else:
                nat = program(armed, armed._gemm_key(b), lambda: armed._build_gemm(b))
                spec_p = program(armed, armed._spec_gemm_key(b), lambda: armed._build_spec(b))
            times[f"b{b}"].update({
                "escalated_ms": dev_ms(lambda: (spec_p(x_dev, rtol), nat(x_dev)),
                                       sp["time_reps"]),
                "escalated_e2e_ms": e2e_ms(lambda: armed.submit(x_host, rtol=rtol).result(),
                                           sp["e2e_reps"]),
            })

    routed("spec_times", escalated_times)
    emit({"phase": "spec_times", "shape": [n, n], "dtype": "float32", "rtol": rtol,
          "device_ms": "CUDA events around the programs' calls (copy-in, replay, "
                       "copy-out); e2e: host median of submit().result()",
          **times})

    # With a recovery policy, misses open the speculative breaker: the tier
    # stands down to native, and each pass counts as a storage fallback.
    release(armed)
    guarded = MatvecEngine(a, mesh1, dtype_storage="speculate",
                           resilience=ResiliencePolicy(breaker_reset_s=3600.0), **kw)
    want = want_adv[0]
    got_g = routed("spec_breaker", lambda: [guarded.submit(x, rtol=rtol).result()
                                            for _ in range(sp["breaker_requests"])])
    hg = guarded.health()
    label = guarded._spec_matvec_key().label()
    check(all(torch.equal(g, want) for g in got_g), "a guarded answer is not the plain one")
    check(hg["counters"]["escalations"] == 3 and hg["counters"]["breaker_opens"] == 1
          and hg["breakers"][label]["state"] == "open"
          and hg["counters"]["storage_fallbacks"] == sp["breaker_requests"] - 3,
          f"breaker: {hg['counters']}, {hg['breakers'].get(label)}")
    emit({"phase": "spec_breaker", "requests": sp["breaker_requests"],
          "escalations": hg["counters"]["escalations"],
          "breaker_opens": hg["counters"]["breaker_opens"],
          "storage_fallbacks": hg["counters"]["storage_fallbacks"],
          "speculative_dispatches": hg["counters"]["speculative_dispatches"],
          "breaker": hg["breakers"][label]["state"]})
    release(guarded, plain)
    del a, x, adv, got_adv, want_adv, got_g, want

    # ---- (d) the serve bench, speculative against native ----
    serve_rows = {}
    for dtype in sp["serve_dtypes"]:
        for storage, r_ in ((None, None), ("speculate", rtol)):
            name = f"spec_serve_{dtype}_{storage or 'native'}"
            res = routed(name, lambda: run_serve(
                "rowwise", mesh1, n, n, dtype=dtype, n_requests=sp["serve_requests"],
                max_bucket=bucket_max, promote=promote, seed=seed, promo_reps=3,
                dtype_storage=storage, rtol=r_))
            serve_rows[name] = {"req_s": res.rps, "cols_s": res.cols_per_s,
                                "p50_dispatch_ms": res.p50_dispatch_ms,
                                "p99_dispatch_ms": res.p99_dispatch_ms,
                                "compiles_steady": res.compiles_steady,
                                "resident_bytes": res.resident_bytes,
                                "speculated": res.speculated,
                                "escalation_rate": res.escalation_rate,
                                "spec_bandwidth_ratio": res.spec_bandwidth_ratio}
            check(res.compiles_steady == 0, f"{name} built a program in its steady phase")
            if storage is not None:
                check(res.speculated > 0, f"{name} served nothing speculatively")
            if storage is not None and dtype == "float32":
                check(res.escalation_rate == 0.0,
                      f"{name}: escalation rate {res.escalation_rate}")
            gc.collect()
            if on_card:
                torch.cuda.empty_cache()
    emit({"phase": "spec_serve", "shape": [n, n], "requests": sp["serve_requests"],
          "rtol": rtol, "rows": serve_rows})

    # ---- (f) reshard: an armed blockwise engine on the 2x2 mesh ----
    n2 = sp["reshard_n"]
    mesh4 = make_mesh(4, devices=[dev] * 4)
    a = resident_matrix(n2, n2, f32, dev, seed + 1)
    gen = torch.Generator(device=dev).manual_seed(seed + 453)
    xr = torch.rand((n2, bucket_max), generator=gen, device=dev, dtype=f32) * 10
    moved = MatvecEngine(a, mesh4, dtype_storage="speculate",
                         **dict(kw, strategy="blockwise"))

    def reshard_path():
        moved.submit(xr[:, 0], rtol=rtol).result()
        out = moved.reshard("rowwise", warm_widths=(1, bucket_max))
        return out, [moved.submit(r, rtol=rtol).result() for r in (xr[:, 0], xr)]

    out, got_r = routed("spec_reshard", reshard_path)
    fresh = MatvecEngine(a, mesh4, dtype_storage="speculate", **kw)
    want_r = routed("spec_reshard_fresh",
                    lambda: [fresh.submit(r, rtol=rtol).result() for r in (xr[:, 0], xr)])
    same_set = all(torch.equal(la, lb)
                   for sa, sb in zip(moved._spec[0].shards, fresh._spec[0].shards)
                   for la, lb in zip(sa.leaves, sb.leaves) if la is not None)
    check(out["migrated"] and same_set and all(torch.equal(g, w) for g, w in zip(got_r, want_r)),
          f"the resharded armed engine is not a fresh one ({out})")
    emit({"phase": "spec_reshard", "shape": [n2, n2], "dtype": "float32",
          "mesh": "2x2 logical", "src": "blockwise", "dst": "rowwise",
          "bytes_moved": out["bytes_moved"], "requantized": out["requantized"],
          "bitwise_fresh_engine": True,
          "escalations": moved.health()["counters"]["escalations"]})
    release(moved, fresh)

    # ---- (g) a poisoned candidate, the integrity gate off ----
    poisoned = MatvecEngine(a, mesh1, dtype_storage="speculate",
                            fault_plan=FaultPlan([FaultSpec(site="dispatch", kind="nan",
                                                            times=1)]), **kw)

    def poison_path():
        fut = poisoned.submit(xr[:, 0], rtol=rtol)
        try:
            fut.result()
            refused = False
        except ResultIntegrityError:
            refused = True
        return refused, poisoned.submit(xr[:, 0], rtol=rtol).result()

    refused, after_y = routed("spec_poison", poison_path)
    hp = poisoned.health()["counters"]
    check(not poisoned.integrity_gate and refused and hp["integrity_failures"] == 1
          and bool(torch.isfinite(after_y).all()) and hp["speculative_dispatches"] == 2,
          f"the poisoned candidate: refused {refused}, {hp}")
    emit({"phase": "spec_poison", "shape": [n2, n2], "integrity_gate": False,
          "refused": refused, "integrity_failures": hp["integrity_failures"],
          "next_request_finite": True})
    release(poisoned)
    del a, xr
    return launches, routes


def precision_section(dev, seed: int, ps: dict) -> dict:
    """Section 46: the precision tiers (``ops/compensated.py``,
    ``ops/ozaki.py``, ``ops/ozaki_gemm.py``) and the solver models on them
    (``models/cg.py``, ``models/gmres.py``, ``models/spectral.py``,
    ``models/trainer.py`` with ``utils/checkpoint.py``, the two CLIs) on
    ``dev`` at the sizes of ``ps``. Emits one JSON line per part and returns
    the kernels' launches by path ({kernel: {path: n}}, each path driven
    with the counts set to 0 just before it and read just after). Runs at a
    small size on a CPU device too (the wrappers' plain versions; the CLIs
    then take ``--platform cpu``)."""
    import gc

    import numpy as np
    import torch

    from matvec_mpi_multiplier_torch import get_strategy, make_mesh
    from matvec_mpi_multiplier_torch.bench.serve import solver_operand
    from matvec_mpi_multiplier_torch.models import trainer
    from matvec_mpi_multiplier_torch.models.cg import build_cg, build_refined
    from matvec_mpi_multiplier_torch.models.gmres import build_gmres
    from matvec_mpi_multiplier_torch.models.spectral import condition_estimate, spectral_norm
    from matvec_mpi_multiplier_torch.ops.cuda_gemm import gemm_cuda
    from matvec_mpi_multiplier_torch.ops.cuda_gemv import gemv_cuda
    from matvec_mpi_multiplier_torch.ops.gemm_kernels import get_gemm_kernel
    from matvec_mpi_multiplier_torch.ops.gemv import get_kernel
    from matvec_mpi_multiplier_torch.parallel.mesh import shard, unshard
    from matvec_mpi_multiplier_torch.utils import checkpoint
    from matvec_mpi_multiplier_torch.utils.constants import H100_HBM_PEAK_GBPS

    on_card = dev.type == "cuda"
    f32, f64 = torch.float32, torch.float64
    n, tiers = ps["n"], ps["tiers"]
    mesh1 = make_mesh(1, devices=[dev])
    rowwise = get_strategy("rowwise")
    launches: dict = {"gemv": {}}
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 46)
    root = Path(__file__).resolve().parent

    def sync() -> None:
        if on_card:
            torch.cuda.synchronize(dev)

    def counted(name: str, fn):
        """fn() with the GEMV's launch count set to 0 just before it and read
        just after, under the path ``name``; returns (out, launches)."""
        gemv_cuda.launches = 0
        gemv_cuda.route_launches.clear()
        out = fn()
        sync()
        got = gemv_cuda.launches
        if got:
            launches["gemv"][name] = launches["gemv"].get(name, 0) + got
        return out, got

    def allocated() -> int:
        return torch.cuda.memory_allocated(dev) if on_card else 0

    def release() -> None:
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)

    def peak_beyond(before: int) -> int:
        return torch.cuda.max_memory_allocated(dev) - before if on_card else 0

    def event_ms(fn, reps: int) -> float:
        """Mean ms of fn() over ``reps`` calls (the caller has warmed it):
        CUDA events on the card, the host clock on the CPU."""
        if on_card:
            with torch.cuda.device(dev):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(reps):
                    fn()
                end.record()
                end.synchronize()
            return start.elapsed_time(end) / reps
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps

    def seconds(fn):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        return out, time.perf_counter() - t0

    def rows_per(k: int) -> int:
        return max(1, (1 << 28) // (k * 8))  # 256 MiB of fp64 per chunk

    def fp64_matvec(a, x):
        """A x in fp64 on the device, A read in row chunks."""
        x64 = x.to(dev, f64)
        out = torch.empty((a.shape[0], *x64.shape[1:]), dtype=f64, device=dev)
        r = rows_per(a.shape[1])
        for i in range(0, a.shape[0], r):
            out[i:i + r] = a[i:i + r].to(f64) @ x64
        return out

    def fp64_rmatvec(a, v):
        """Aᵀ v in fp64 on the device, A read in row chunks."""
        v64 = v.to(dev, f64)
        out = torch.zeros((a.shape[1],), dtype=f64, device=dev)
        r = rows_per(a.shape[1])
        for i in range(0, a.shape[0], r):
            out += a[i:i + r].to(f64).T @ v64[i:i + r]
        return out

    def ulps(y, ref):
        """Each entry's error in fp32 ulps of the fp64 reference (max, and
        the 99th percentile)."""
        r32 = ref.to(f32).abs()
        spacing = (torch.nextafter(r32, torch.full_like(r32, float("inf"))) - r32).to(f64)
        u = ((y.to(f64) - ref).abs() / spacing).flatten().cpu()
        return float(u.max()), float(torch.quantile(u, 0.99)) if u.numel() <= 1 << 24 else None

    # (tier) -> (slice bits, slices, block): ozaki slices per (row, 256-block)
    # into 8-bit addends, ozaki_i8 per row into 7-bit ones.
    sliced = {"ozaki": (8, 4, 256), "ozaki6": (8, 6, 256), "ozaki_i8": (7, 4, None)}

    def envelope(a, x, ref):
        """Per-row bounds on |y - fp64| from each tier's documented envelope:
        every sliced operand keeps its bits down to 2^(E - bits·s) of its
        block's max (|residual| below that, ops/ozaki.py, ops/ozaki_gemm.py),
        so |Δy_i| <= Σ_blocks 2^(Ea - bits·s)·||x_b||₁ + 2^(Ex - bits·s)·
        ||a_ib||₁ + their product's term; the double-float combine adds
        about 2^-48 of the partial magnitudes (bounded here by 2^-40·Σ|a||x|)
        and the fp32 output one rounding (2^-24·|y|, doubled)."""
        m, k = a.shape
        blk = 256
        pad = (-k) % blk
        nb = (k + pad) // blk
        xa = torch.nn.functional.pad(x.abs().to(f64), (0, pad)).view(nb, blk)
        x_sum_b, x_exp_b = xa.sum(-1), torch.frexp(xa.amax(-1))[1]
        x_sum, x_exp = x_sum_b.sum(), torch.frexp(xa.max())[1]
        out = {t: torch.empty(m, dtype=f64, device=dev) for t in (*sliced, "compensated")}
        r = rows_per(k + pad)
        for i in range(0, m, r):
            ac = torch.nn.functional.pad(a[i:i + r].abs().to(f64), (0, pad)).view(-1, nb, blk)
            a_sum_b, a_exp_b = ac.sum(-1), torch.frexp(ac.amax(-1))[1]
            slack = (ac * xa).sum((-1, -2)) * 2.0 ** -40 + ref[i:i + r].abs() * 2.0 ** -23
            out["compensated"][i:i + r] = slack
            for tier, (bits, n_sl, per_block) in sliced.items():
                if per_block:
                    ea, ex, sa, sx = a_exp_b, x_exp_b, a_sum_b, x_sum_b
                    cnt = blk
                else:  # one scale per row of A and per column (x)
                    ea, ex = a_exp_b.amax(-1, keepdim=True), x_exp
                    sa, sx, cnt = a_sum_b.sum(-1, keepdim=True), x_sum, k
                da = torch.ldexp(torch.ones_like(sa), ea - bits * n_sl)
                dx = torch.ldexp(torch.ones_like(sa), ex - bits * n_sl)
                out[tier][i:i + r] = (da * sx + dx * sa + da * dx * cnt).sum(-1) + slack
        return out

    def rel_residual(a, b, x) -> float:
        """||b - A x|| / ||b|| in fp64."""
        r = b.to(dev, f64) - fp64_matvec(a, x)
        return float(r.norm() / b.to(dev, f64).norm())

    def randn(shape):
        """Standard normal fp32 on the device from the section's generator,
        drawn in row chunks of 128 MiB."""
        out = torch.empty(shape, dtype=f32, device=dev)
        flat = out.view(-1, shape[-1]) if len(shape) > 1 else out.view(1, -1)
        r = max(1, (1 << 25) // flat.shape[1])
        for i in range(0, flat.shape[0], r):
            flat[i:i + r] = torch.randn(flat[i:i + r].shape, generator=gen, device=dev)
        return out

    check(not torch.backends.cuda.matmul.allow_tf32
          and torch.get_float32_matmul_precision() == "highest",
          "TF32 is enabled for fp32 matmul")
    torch.empty(0, device=dev)  # the card's context, before its memory stats
    release()

    # ---- (a) the four GEMV tiers at n² fp32, rowwise, p = 1 ----
    t0 = time.perf_counter()
    a = solver_operand(n, "float32", seed, device=dev)
    x = randn((n,))
    sync()
    operand_s = time.perf_counter() - t0
    ref = fp64_matvec(a, x)
    env = envelope(a, x, ref)
    a_bytes = a.numel() * a.element_size()
    bound_ms = (a_bytes + 8 * n) / (H100_HBM_PEAK_GBPS * 1e9) * 1e3
    y_plain = gemv_cuda(a, x)
    gemv_ms = event_ms(lambda: gemv_cuda(a, x), ps["reps"])
    plain_ulps = ulps(y_plain, ref)
    del y_plain
    rows = ps["slice_rows"]
    a_cpu, x_cpu = a[:rows].cpu(), x.cpu()
    tier_rows = {}
    for tier in tiers:
        fn = rowwise.build(mesh1, kernel=tier)
        release()
        before = allocated()
        (y, first_s) = seconds(lambda: fn(a, x))
        peak = peak_beyond(before)
        ms = event_ms(lambda: fn(a, x), ps["reps"])
        err_max, err_p99 = ulps(y, ref)
        rel = float((y.to(f64) - ref).abs().max() / ref.abs().max())
        env_use = float(((y.to(f64) - ref).abs() / env[tier]).max())
        y_cpu = get_kernel(tier)(a_cpu, x_cpu)
        bitwise = torch.equal(y[:rows].cpu(), y_cpu)
        check(bitwise, f"{tier}: the card's first {rows} rows are not bitwise the CPU port's")
        check(bool(torch.isfinite(y).all()), f"{tier}: non-finite output")
        # Each entry within its tier's documented envelope (envelope()).
        # Ulps are reported, not held: this operand's diagonal blocks span
        # 2^15, past ozaki's exact window of 2^8, ozaki_i8's rows past its
        # 2^4, and outputs near zero read large ulps of a tiny value.
        check(env_use <= 1.0, f"{tier}: error {env_use} of its envelope > 1")
        tier_rows[tier] = {
            "ms": ms, "first_call_s": first_s, "x_gemv_cuda": ms / gemv_ms,
            "x_bound": ms / bound_ms, "max_ulps": err_max, "p99_ulps": err_p99,
            "max_err_rel_scale": rel, "max_share_of_envelope": env_use,
            "peak_bytes_beyond_operands": peak, "cpu_rows_bitwise": bitwise}
        del y, fn
    emit({"phase": "precision_tiers", "shape": [n, n], "dtype": "float32",
          "strategy": "rowwise", "mesh": [1, 1], "operand": "solver_operand",
          "operand_s": operand_s, "reps": ps["reps"], "gemv_cuda_ms": gemv_ms,
          "gemv_cuda_max_ulps": plain_ulps[0], "bound_ms": bound_ms, "bound_by": "bytes",
          "slice_rows": rows, "tiers": tier_rows})
    del a_cpu, x_cpu, ref, env

    # ---- (b) the cancellation stress case, all four tiers and plain fp32 ----
    m_s, k_s = ps["stress"]
    big = torch.rand((m_s, k_s // 2), generator=gen, device=dev) * 9e6 + 1e6
    small = torch.rand((m_s, k_s // 2), generator=gen, device=dev) * 2 - 1
    a_s = torch.empty((m_s, k_s), dtype=f32, device=dev)
    a_s[:, 0::2] = big + small
    a_s[:, 1::2] = -big
    del big, small
    ones = torch.ones(k_s, dtype=f32, device=dev)
    ref_s = fp64_matvec(a_s, ones)
    check(torch.equal(ref_s.to(f32).to(f64), ref_s), "the stress oracle is not exact in fp32")
    stress = {"plain_fp32": ulps(gemv_cuda(a_s, ones), ref_s)[0]}
    for tier in tiers:
        stress[tier] = ulps(get_kernel(tier)(a_s, ones), ref_s)[0]
    check(stress["ozaki"] == 0.0 and stress["ozaki6"] == 0.0,
          f"stress case: ozaki tiers {stress} ulps from fp64, not 0")
    check(stress["compensated"] <= 1.0, f"stress case: compensated {stress['compensated']} ulps")
    check(stress["plain_fp32"] > 1e3, f"stress case: plain fp32 only {stress['plain_fp32']} ulps")
    emit({"phase": "precision_stress", "shape": [m_s, k_s], "max_ulps": stress})
    del a_s, ones, ref_s

    # ---- (c) the GEMM tiers against fp64 torch.matmul ----
    n_g, b_g = ps["gemm"]
    a_g, bm = randn((n_g, n_g)), randn((n_g, b_g))
    ref_g = a_g.to(f64) @ bm.to(f64)
    gemm = {"gemm_cuda_ms": None, "torch_matmul_ms": None}
    gemm_cuda(a_g, bm)
    gemm["gemm_cuda_ms"] = event_ms(lambda: gemm_cuda(a_g, bm), ps["reps"])
    torch.matmul(a_g, bm)
    gemm["torch_matmul_ms"] = event_ms(lambda: torch.matmul(a_g, bm), ps["reps"])
    g_rows = ps["gemm_slice_rows"]
    for tier in ("ozaki", "ozaki6"):
        fn = get_gemm_kernel(tier)
        release()
        before = allocated()
        c = fn(a_g, bm)
        sync()
        peak = peak_beyond(before)
        ms = event_ms(lambda: fn(a_g, bm), ps["reps"])
        err_max, err_p99 = ulps(c, ref_g)
        rel = float((c.to(f64) - ref_g).abs().max() / ref_g.abs().max())
        bitwise = torch.equal(c[:g_rows].cpu(), fn(a_g[:g_rows].cpu(), bm.cpu()))
        check(bitwise, f"gemm {tier}: the card's first {g_rows} rows are not the CPU port's")
        check(rel < 1e-7, f"gemm {tier}: error {rel} of the output's scale >= 1e-7")
        if tier == "ozaki6":
            # tests/test_ozaki_gemm.py's bar: the output's rounding limit.
            check(err_p99 <= 1.0 and err_max <= 64.0,
                  f"gemm ozaki6: {err_p99} ulps at the 99th percentile, {err_max} max")
        gemm[tier] = {"ms": ms, "max_ulps": err_max, "p99_ulps": err_p99,
                      "max_err_rel_scale": rel, "peak_bytes_beyond_operands": peak,
                      "cpu_rows_bitwise": bitwise, "x_gemm_cuda": ms / gemm["gemm_cuda_ms"]}
        del c
    emit({"phase": "precision_gemm", "shape": [n_g, n_g, b_g], "dtype": "float32", **gemm})
    del a_g, bm, ref_g
    release()

    # ---- (d) build_cg on section 17's operand ----
    b = randn((n,))
    cg = build_cg(rowwise, mesh1, kernel="cuda", tol=ps["cg_rtol"])
    check(cg.loop_device == (dev if on_card else None),
          f"build_cg's loop device {cg.loop_device}")
    counted("precision_cg", lambda: cg(a, b))  # first launches, capture
    syncs = None
    if on_card:
        torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            ((res, solve_s), n_launch) = counted("precision_cg", lambda: seconds(lambda: cg(a, b)))
        syncs = len(caught) if on_card else None
    finally:
        if on_card:
            torch.cuda.set_sync_debug_mode(0)
    iters = int(res.n_iters)
    rel = rel_residual(a, b, res.x)
    check(bool(res.converged) and rel <= 1.1 * ps["cg_rtol"],
          f"build_cg: converged {bool(res.converged)}, residual {rel}")
    # (The wrapper counts kernel launches: none for CPU tensors.)
    check(n_launch >= iters or not on_card,
          f"build_cg: {n_launch} GEMV launches for {iters} iterations")
    emit({"phase": "precision_cg", "shape": [n, n], "kernel": "cuda", "rtol": ps["cg_rtol"],
          "loop": "device" if cg.loop_device is not None else "eager chunks",
          "n_iters": iters, "solve_s": solve_s, "ms_per_iter": solve_s * 1e3 / max(1, iters),
          "syncs_a_solve": syncs, "gemv_launches": n_launch, "rel_residual_fp64": rel})
    del cg, res

    # ---- (e) refinement at full width, then the cond-1e5 system ----
    x_true = randn((n,))
    b = fp64_matvec(a, x_true).to(f32)
    plain_cg = build_cg(rowwise, mesh1, tol=ps["plain_tol"])
    (plain, plain_s), _ = counted("precision_refined", lambda: seconds(lambda: plain_cg(a, b)))
    del plain_cg
    refined_fn = build_refined(rowwise, mesh1)
    release()
    before = allocated()
    (ref_res, ref_s), _ = counted("precision_refined", lambda: seconds(lambda: refined_fn(a, b)))
    ref_peak = peak_beyond(before)
    b_norm = float(b.to(f64).norm())
    full = {
        "trips": int(ref_res.n_iters), "converged": bool(ref_res.converged), "seconds": ref_s,
        "reported_rel_residual": float(ref_res.residual_norm) / b_norm,
        "rel_residual_fp64": rel_residual(a, b, ref_res.x),
        "forward_err": float((ref_res.x.to(f64) - x_true.to(f64)).abs().max()
                             / x_true.abs().max()),
        "peak_bytes_beyond_operands": ref_peak, "a_aug_bytes": n * (n + 1) * 4,
        "plain_cg": {"n_iters": int(plain.n_iters), "seconds": plain_s,
                     "rel_residual_fp64": rel_residual(a, b, plain.x),
                     "forward_err": float((plain.x.to(f64) - x_true.to(f64)).abs().max()
                                          / x_true.abs().max())}}
    check(full["converged"] and full["reported_rel_residual"] <= 5e-7,
          f"refinement at full width: {full}")
    del refined_fn, ref_res, plain
    # The cond-1e5 SPD system at small_n, built with numpy (tests/conftest.py's
    # spd_with_spectrum: a seeded QR), against the fp64 solve.
    small_n = ps["small_n"]
    t0 = time.perf_counter()
    q, _ = np.linalg.qr(np.random.default_rng(seed).standard_normal((small_n, small_n)))
    a_ill = (q * np.logspace(0, np.log10(ps["refine_cond"]), small_n)) @ q.T
    xt_ill = np.random.default_rng(seed + 1).standard_normal(small_n)
    a32 = a_ill.astype(np.float32)
    b32 = (a_ill @ xt_ill).astype(np.float32)
    xs = np.linalg.solve(a32.astype(np.float64), b32.astype(np.float64))
    numpy_s = time.perf_counter() - t0
    a32_d, b32_d = torch.from_numpy(a32).to(dev), torch.from_numpy(b32).to(dev)

    def fwd(xv) -> float:
        return float(np.max(np.abs(xv.cpu().double().numpy() - xs)) / np.max(np.abs(xs)))

    (plain, plain_s), _ = counted("precision_refined", lambda: seconds(lambda: build_cg(
        rowwise, mesh1, tol=ps["plain_tol"], max_iters=ps["plain_max_iters"])(a32_d, b32_d)))
    (ill, ill_s), _ = counted("precision_refined", lambda: seconds(lambda: build_refined(
        rowwise, mesh1, max_iters=ps["plain_max_iters"])(a32_d, b32_d)))
    ill_row = {"n": small_n, "cond": ps["refine_cond"], "numpy_build_s": numpy_s,
               "trips": int(ill.n_iters), "seconds": ill_s, "forward_err": fwd(ill.x),
               "plain_cg_forward_err": fwd(plain.x), "plain_cg_n_iters": int(plain.n_iters),
               "plain_cg_seconds": plain_s}
    check(bool(ill.converged) and ill_row["forward_err"] < 1e-5
          and ill_row["forward_err"] * 50 < ill_row["plain_cg_forward_err"],
          f"refinement at cond {ps['refine_cond']}: {ill_row}")
    emit({"phase": "precision_refined", "shape": [n, n], "residual_kernel": "ozaki",
          "inner": "cg", "full_width": full, "ill_conditioned": ill_row})
    del plain, ill, a32_d, b32_d

    # ---- (f) spectral_norm on section 17's operand ----
    (lam, lam_s), n_power = counted("precision_spectral", lambda: seconds(
        lambda: spectral_norm(rowwise, mesh1, a, seed=seed, tol=ps["spectral_tol"])))
    diag = a.diagonal()
    upper = float((a.abs().sum(1)).max())  # Gershgorin's bound, diagonal positive
    # A Rayleigh quotient lies in the spectrum's hull, inside [1, upper]. The
    # estimator stops when the quotient's relative step falls under tol (the
    # JAX package's rule), so on this operand, a cluster near n/3 and one
    # isolated top eigenvalue at least max(diag), it may stop on the cluster
    # before the top eigenvector grows: reported, as the estimate it is.
    check(1.0 <= lam <= upper * (1 + 1e-6), f"spectral_norm {lam} outside [1, {upper}]")
    spectral = {"lambda_estimate": lam, "iterations": n_power, "seconds": lam_s,
                "lambda_max_lower_bound": float(diag.max()), "gershgorin_upper": upper}
    del a, b, x, x_true, diag
    release()

    # gmres (restart 40) on a nonsymmetric, diagonally dominant operand:
    # uniform(-1, 1) off the diagonal, each diagonal entry its row's
    # absolute sum plus one.
    a_ns = torch.empty((n, n), dtype=f32, device=dev)
    r = max(1, (1 << 25) // n)
    for i in range(0, n, r):
        blk = a_ns[i:i + r]
        blk.copy_(torch.rand(blk.shape, generator=gen, device=dev) * 2 - 1)
        idx = torch.arange(i, i + blk.shape[0], device=dev)
        blk[torch.arange(blk.shape[0], device=dev), idx] = 0.0
        blk[torch.arange(blk.shape[0], device=dev), idx] = blk.abs().sum(1) + 1.0
    b_ns = randn((n,))
    gm = build_gmres(rowwise, mesh1, restart=ps["gmres_restart"], tol=ps["gmres_rtol"])
    counted("precision_gmres", lambda: gm(a_ns, b_ns))  # first launches
    (res, gm_s), gm_launch = counted("precision_gmres", lambda: seconds(lambda: gm(a_ns, b_ns)))
    gm_rel = rel_residual(a_ns, b_ns, res.x)
    check(bool(res.converged) and gm_rel <= 2 * ps["gmres_rtol"],
          f"gmres: converged {bool(res.converged)}, fp64 residual {gm_rel}")
    gmres_row = {"restart": ps["gmres_restart"], "rtol": ps["gmres_rtol"],
                 "cycles": int(res.n_iters), "seconds": gm_s, "gemv_launches": gm_launch,
                 "reported_rel_residual": float(res.residual_norm) / float(b_ns.norm()),
                 "rel_residual_fp64": gm_rel, "loop": "host-stepped, one read a cycle"}
    del a_ns, b_ns, gm, res
    release()

    # condition_estimate on a prescribed spectrum at small_n, fp64 (the JAX
    # test's construction and bar: within 10% of the condition number).
    a_c = torch.from_numpy((q * np.logspace(0, np.log10(ps["cond"]), small_n)) @ q.T).to(dev)
    del q, a_ill
    (est, est_s), est_launch = counted("precision_condition", lambda: seconds(
        lambda: condition_estimate(rowwise, mesh1, a_c, tol=1e-6, cg_tol=1e-10)))
    check(abs(est - ps["cond"]) <= 0.1 * ps["cond"],
          f"condition_estimate {est} not within 10% of {ps['cond']}")
    emit({"phase": "precision_solvers", "gmres": {"shape": [n, n], **gmres_row},
          "spectral_norm": {"shape": [n, n], "operand": "solver_operand", "tol":
                            ps["spectral_tol"], "loop": "host-stepped, one read an iteration",
                            **spectral},
          "condition_estimate": {"n": small_n, "dtype": "float64", "cond": ps["cond"],
                                 "estimate": est, "seconds": est_s,
                                 "gemv_launches": est_launch}})
    del a_c
    release()

    # ---- (g) the trainer at n² fp32 on the 2x2 logical mesh ----
    mesh22 = make_mesh(4, devices=[dev] * 4)
    sh = trainer.shardings(mesh22)
    a_t = randn((n, n))
    xt_t = randn((n,))
    b_t = fp64_matvec(a_t, xt_t).to(f32)
    a_p, b_p = shard(a_t, sh["a"], mesh22), shard(b_t, sh["b"], mesh22)
    lr = ps["train_lr"]
    state = trainer.init_state(mesh22, n, learning_rate=lr)
    step = trainer.build_train_step(mesh22)
    # The fp64 reference of the first steps: x <- x - lr·2·Aᵀ(A x - b)/m.
    x64 = torch.zeros(n, dtype=f64, device=dev)
    ref_steps = []
    losses = []
    for _ in range(ps["train_ref_steps"]):
        state, loss = step(state, a_p, b_p)
        r64 = fp64_matvec(a_t, x64) - b_t.to(f64)
        loss64 = float((r64 * r64).mean())
        x64 = x64 - lr * (fp64_rmatvec(a_t, r64) * (2.0 / n))
        xp = unshard(state.x).to(f64)
        ref_steps.append({"loss": float(loss), "loss_fp64": loss64,
                          "loss_rel": abs(float(loss) - loss64) / loss64,
                          "x_rel": float((xp - x64).norm() / x64.norm())})
        losses.append(loss)
    del x64, r64, xp
    timed_steps = ps["train_steps"] - ps["train_ref_steps"]
    sync()
    t0 = time.perf_counter()
    for _ in range(timed_steps):
        state, loss = step(state, a_p, b_p)
        losses.append(loss)  # read after the timed steps
    sync()
    steps_s = timed_steps / (time.perf_counter() - t0)
    losses = [float(v) for v in losses]
    # fp32's bound on a length-k contraction: k·u (u = 2^-24), per step.
    bound = n * 2.0 ** -24
    check(all(s["loss_rel"] <= bound and s["x_rel"] <= bound for s in ref_steps),
          f"trainer: first steps against fp64 {ref_steps}, bound {bound}")
    check(losses[-1] < losses[0] and all(np.isfinite(losses)), f"trainer losses {losses}")
    check(state.x.spec == ("cols",), f"trainer: x's spec {state.x.spec}")
    del a_t, xt_t
    with tempfile.TemporaryDirectory() as tmp:
        path = checkpoint.save_state(state, Path(tmp) / f"step_{int(state.step)}")
        like = trainer.init_state(mesh22, n, learning_rate=lr)
        restored = checkpoint.restore_state(checkpoint.latest_step_dir(tmp), like)
        resumed, _ = step(restored, a_p, b_p)
        direct, _ = step(state, a_p, b_p)
        resume_bitwise = torch.equal(unshard(resumed.x), unshard(direct.x))
        ckpt_bytes = (path / checkpoint.STATE_FILE).stat().st_size
    check(resume_bitwise and int(resumed.step) == int(direct.step),
          "trainer: the resumed step is not bitwise the direct one")
    emit({"phase": "precision_trainer", "shape": [n, n], "dtype": "float32",
          "mesh": list(mesh22.grid), "lr": lr, "steps": ps["train_steps"],
          "steps_per_s": steps_s, "loss_first": losses[0], "loss_last": losses[-1],
          "reference_steps": ref_steps, "fp32_bound": bound, "checkpoint_bytes": ckpt_bytes,
          "resume_bitwise": resume_bitwise})
    del a_p, b_p, state, restored, resumed, direct, like
    release()

    # ---- (h) the two CLIs, each in a process of its own ----
    platform = [] if on_card else ["--platform", "cpu"]
    env = dict(os.environ, PYTHONPATH=str(root))
    cli = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, argv, line in (
                ("solve_cg", ["--size", str(ps["cli_n"]), "--strategy", "rowwise"],
                 "converged=True"),
                ("solve", ["--size", str(ps["cli_n"]), str(ps["cli_n"]), "--steps",
                           str(ps["cli_steps"]), "--ckpt-dir", tmp, "--ckpt-every",
                           str(ps["cli_steps"] // 2)], f"done: steps={ps['cli_steps']}")):
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-m", f"matvec_mpi_multiplier_torch.bench.{name}",
                 *argv, *platform], capture_output=True, text=True, cwd=root, env=env,
                timeout=600)
            out = proc.stdout.strip().splitlines()
            cli[name] = {"rc": proc.returncode, "seconds": time.perf_counter() - t0,
                         "last_line": out[-1] if out else None}
            check(proc.returncode == 0 and line in proc.stdout,
                  f"{name}: rc {proc.returncode}, stdout {proc.stdout[-500:]!r}, "
                  f"stderr {proc.stderr[-500:]!r}")
    emit({"phase": "precision_clis", "size": ps["cli_n"], "runs": cli})
    return launches


def benchmark_path_section(dev, seed: int, bp: dict, pinned_gbps: float | None = None) -> dict:
    """Section 47: the paper's benchmark path end to end on ``dev`` at the
    sizes of ``bp``: the flagship entry and the dryrun (``entry.py``); the
    sweep CLI in-process (``bench/sweep.py``: ``--label-suffix``,
    ``--metrics-out``, ``--skip-measured``, ``--keep-going``, ``--mode
    reference``); a ``torch.profiler`` capture with named spans
    (``bench/profiling.py``) and the spans' cost; the host link
    (``bench/hostlink.py``, ``bench/hostlink_study.py``) beside section 43's
    pinned probe, derived reference rows against the literal ones; the
    analysis CLIs over the sweep's CSVs (``analysis/``). Emits one JSON line
    per part and returns the kernels' launches by path ({kernel: {path:
    n}}, each path driven with the counts set to 0 just before it and read
    just after). Runs at a small size on a CPU device too."""
    import contextlib
    import gc
    import io as stdio

    import numpy as np
    import torch

    from matvec_mpi_multiplier_torch import get_strategy, make_mesh
    from matvec_mpi_multiplier_torch.analysis import results_table, stats_visualization
    from matvec_mpi_multiplier_torch.bench import hostlink_study
    from matvec_mpi_multiplier_torch.bench import sweep as sweep_mod
    from matvec_mpi_multiplier_torch.bench.hostlink import DEFAULT_LADDER_BYTES, measure_link
    from matvec_mpi_multiplier_torch.bench.metrics import extended_csv_path, read_csv
    from matvec_mpi_multiplier_torch.bench.profiling import annotations, trace
    from matvec_mpi_multiplier_torch.bench.timing import benchmark_strategy
    from matvec_mpi_multiplier_torch.entry import dryrun_multichip, entry
    from matvec_mpi_multiplier_torch.ops.cuda_attention import flash_partial_cuda
    from matvec_mpi_multiplier_torch.ops.cuda_gemm import gemm_cuda
    from matvec_mpi_multiplier_torch.ops.cuda_gemv import gemv_cuda
    from matvec_mpi_multiplier_torch.utils.constants import H100_HBM_PEAK_GBPS

    on_card = dev.type == "cuda"
    wrappers = {"gemv": gemv_cuda, "gemm": gemm_cuda, "flash_attention": flash_partial_cuda}
    launches: dict = {k: {} for k in wrappers}
    platform = (["--platform", "cuda"] if on_card
                else ["--platform", "cpu", "--host-devices", "1"])

    def sync() -> None:
        if on_card:
            torch.cuda.synchronize(dev)

    def counted(name: str, fn):
        """fn() with every count set to 0 just before it and read just after,
        under the path ``name``; returns (out, {kernel: launches})."""
        for w in wrappers.values():
            w.launches = 0
            w.route_launches.clear()
        out = fn()
        sync()
        got = {k: w.launches for k, w in wrappers.items()}
        for k, n in got.items():
            if n:
                launches[k][name] = launches[k].get(name, 0) + n
        return out, got

    def cli(main, argv) -> tuple[int, str]:
        """An in-process CLI run: its exit code and its standard output."""
        buf = stdio.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = main(argv)
        return rc, buf.getvalue()

    def timed_configs(out: str) -> int:
        last = [ln for ln in out.splitlines() if "configs timed" in ln][-1]
        return int(last.split()[0])

    with tempfile.TemporaryDirectory(prefix="bench_path_") as tmp:
        tmp = Path(tmp)
        # ---- (a) the entry and the dryrun ----
        t0 = time.perf_counter()

        def run_entry():
            fn, (a, x) = entry(device=dev)
            return fn(a, x), a, x

        (y, a, x), got = counted("bench_entry", run_entry)
        exact = a.double().cpu().numpy() @ x.double().cpu().numpy()
        rel = float(np.max(np.abs(y.double().cpu().numpy() - exact) / np.abs(exact)))
        check(tuple(y.shape) == (512,) and y.dtype == torch.bfloat16 and rel <= 2 ** -7,
              f"entry: shape {tuple(y.shape)}, {y.dtype}, rel err {rel} > 2^-7")
        check(not on_card or got["gemv"] == 1, f"entry: {got['gemv']} GEMV launches, not 1")
        summary, got = counted("bench_dryrun",
                               lambda: dryrun_multichip(bp["dryrun_shards"], device=dev))
        check(not on_card or all(got[k] > 0 for k in wrappers),
              f"dryrun: launches {got}: a face missed its kernel")
        emit({"phase": "bench_entry", "device": str(dev), "entry_max_rel_err": rel,
              "entry_tol": 2 ** -7, "dryrun": summary, "dryrun_launches": got,
              "seconds": time.perf_counter() - t0})

        # ---- (b) the sweep CLI, in-process ----
        t0 = time.perf_counter()
        root = tmp / "data"
        common = ["--strategy", "rowwise", "colwise", "blockwise", "--devices", "1",
                  "--dtype", "float32", "--data-root", str(root), *platform,
                  *bp["sweep_sizes"]]
        metrics = tmp / "metrics.json"
        (rc, out), got = counted("bench_sweep", lambda: cli(sweep_mod.main, common + [
            "--measure", "loop", "--n-reps", str(bp["sweep_reps"]), "--label-suffix",
            "card", "--metrics-out", str(metrics)]))
        n_timed = timed_configs(out)
        n_cells = 3 * bp["sweep_cells"]
        check(rc == 0 and n_timed == n_cells,
              f"sweep: rc {rc}, {n_timed} configs timed of {n_cells}: {out[-800:]}")
        check("counters" in json.loads(metrics.read_text()), "sweep: --metrics-out wrote no snapshot")
        sweep_launches = got["gemv"]
        (rc, out), got = counted("bench_sweep_skip", lambda: cli(sweep_mod.main, common + [
            "--measure", "loop", "--n-reps", str(bp["sweep_reps"]), "--label-suffix",
            "card", "--skip-measured"]))
        skip_timed = timed_configs(out)
        check(rc == 0 and skip_timed == 0 and got["gemv"] == 0,
              f"--skip-measured: rc {rc}, {skip_timed} timed, {got['gemv']} launches")
        calls = []
        real = sweep_mod.benchmark_strategy

        def fails_once(*args, **kw):
            calls.append(1)
            if len(calls) == 1:
                raise RuntimeError("an injected config failure")
            return real(*args, **kw)

        sweep_mod.benchmark_strategy = fails_once
        try:
            with contextlib.redirect_stderr(stdio.StringIO()) as err:
                (rc, out), got = counted("bench_sweep_keep_going", lambda: cli(
                    sweep_mod.main, ["--strategy", "rowwise", "--devices", "1",
                                     "--sizes", *map(str, bp["keep_going_sizes"]),
                                     "--measure", "sync", "--n-reps", "3", "--no-csv",
                                     "--keep-going", *platform]))
        finally:
            sweep_mod.benchmark_strategy = real
        keep_going = {"rc": rc, "timed": timed_configs(out),
                      "failed_line": err.getvalue().strip().splitlines()[0]}
        check(rc == 5 and keep_going["timed"] == len(bp["keep_going_sizes"]) - 1,
              f"--keep-going: {keep_going}")
        (rc, out), got = counted("bench_sweep_reference", lambda: cli(sweep_mod.main, common + [
            "--mode", "reference", "--measure", "sync", "--n-reps", str(bp["ref_reps"]),
            "--label-suffix", "card"]))
        check(rc == 0 and timed_configs(out) == n_cells, f"reference sweep: rc {rc}: {out[-800:]}")
        rows = read_csv(extended_csv_path(root))
        loop_ms = {(r["strategy"], r["n_rows"], r["n_cols"]): r["time"] * 1e3
                   for r in rows if r["mode"] == "amortized"}
        emit({"phase": "bench_sweep", "cells": n_cells, "timed": n_timed,
              "gemv_launches": sweep_launches, "skip_measured_timed": skip_timed,
              "keep_going": keep_going, "reference_timed": n_cells,
              "loop_ms": {f"{s} {m}x{n}": v for (s, m, n), v in sorted(loop_ms.items())},
              "seconds": time.perf_counter() - t0})

        # ---- (c) the profile capture at the north-star shape ----
        t0 = time.perf_counter()
        n = bp["profile_n"]
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed + 47)
        a = torch.empty((n, n), dtype=torch.bfloat16, device=dev)
        rows_at = max(1, (1 << 28) // n)
        for i in range(0, n, rows_at):
            k = min(rows_at, n - i)
            a[i:i + k] = torch.rand((k, n), generator=gen, device=dev) * 10
        x = (torch.rand((n,), generator=gen, device=dev) * 10).to(torch.bfloat16)
        mesh1 = make_mesh(1, devices=[dev])
        strat = get_strategy("blockwise")
        prof_dir = tmp / "profile"

        def profiled():
            with trace(prof_dir), annotations(True):
                return benchmark_strategy(strat, mesh1, a, x, n_reps=bp["profile_reps"],
                                          mode="amortized", measure="sync", kernel="cuda")

        res, got = counted("bench_profile", profiled)
        (path,) = sorted(prof_dir.glob("*.json"))
        events = json.loads(path.read_text())["traceEvents"]
        names = ("blockwise/local_gemv", "blockwise/combine/psum")
        # A span is a host event; the profiler also draws it on the device's
        # row (gpu_user_annotation) around the kernels it launched.
        span_counts = Counter(e["name"] for e in events
                              if e.get("name") in names and e.get("cat") == "user_annotation")
        device_spans = Counter(e["name"] for e in events if e.get("name") in names
                               and e.get("cat") == "gpu_user_annotation")
        kernels = Counter(e["name"] for e in events
                          if e.get("cat") == "kernel" and "gemv" in e.get("name", "").lower())
        calls_made = bp["profile_reps"] + 1  # the warm-up and the reps
        check(span_counts["blockwise/local_gemv"] == calls_made
              and span_counts["blockwise/combine/psum"] == calls_made,
              f"profile: spans {dict(span_counts)}, {calls_made} calls")
        check(not on_card or sum(kernels.values()) == got["gemv"] == calls_made,
              f"profile: GEMV kernels in the trace {dict(kernels)}, launches {got['gemv']}")
        cost = {}
        for measure in ("loop", "chain"):
            for enabled in (False, True):
                with annotations(enabled):
                    r = benchmark_strategy(strat, mesh1, a, x, n_reps=bp["span_reps"],
                                           mode="amortized", measure=measure, kernel="cuda")
                cost[f"{measure}_{'on' if enabled else 'off'}_ms"] = r.mean_time_s * 1e3
        emit({"phase": "bench_profile", "shape": f"{n}x{n}", "dtype": "bfloat16",
              "trace_bytes": path.stat().st_size, "spans": dict(span_counts),
              "device_row_spans": dict(device_spans),
              "gemv_kernels": dict(kernels), "sync_ms": res.mean_time_s * 1e3,
              "span_cost": cost, "seconds": time.perf_counter() - t0})
        del a, x
        gc.collect()

        # ---- (d) the host link, and derived rows against literal ones ----
        t0 = time.perf_counter()
        link = measure_link([b for b in DEFAULT_LADDER_BYTES if b <= bp["link_max_mb"] << 20],
                            device=dev)
        rc, out = cli(hostlink_study.main, ["--data-root", str(root), *platform[:2],
                                            "--max-mb", str(bp["link_max_mb"])])
        check(rc == 0 and "reference-mode rows derived" in out, f"hostlink_study: {out}")
        rows = read_csv(extended_csv_path(root))
        literal = {(r["strategy"], r["n_rows"]): r["time"] for r in rows
                   if r["mode"] == "reference"}
        derived = {(r["strategy"], r["n_rows"]): r["time"] for r in rows
                   if r["mode"] == "reference_derived"}
        check(set(literal) == set(derived) and len(literal) == n_cells,
              f"hostlink: {len(literal)} literal, {len(derived)} derived rows")
        ratio = {f"{s} {m}": derived[(s, m)] / literal[(s, m)] for s, m in sorted(literal)}
        # The JAX package's bound (tests/test_hostlink.py): within a factor of 5.
        check(all(0.2 < v < 5 for v in ratio.values()), f"derived/literal {ratio}")
        emit({"phase": "bench_hostlink", "alpha_ms": link.alpha_s * 1e3,
              "gbps": link.gbps, "samples": [list(s) for s in link.samples],
              "pinned_probe_gbps": pinned_gbps,
              "study_line": out.strip().splitlines()[0],
              "derived_over_literal": ratio, "seconds": time.perf_counter() - t0})

        # ---- (e) the analysis ----
        t0 = time.perf_counter()
        rc, table = cli(stats_visualization.main, [
            "--data-out", str(root / "out"), "--fig-dir", str(tmp / "figures"),
            "--itemsize", "4", "--hbm-peak", str(H100_HBM_PEAK_GBPS), "--cards", "1"])
        check(rc == 0 and all(f"## {s}_card\n" in table
                              for s in ("rowwise", "colwise", "blockwise")),
              f"stats_visualization: rc {rc}: {table[-800:]}")
        if bp["l2_cell"]:
            # The 120-row fp32 cell (28.8 MB) sits in the L2 of the card.
            line = next(ln for ln in table.splitlines()
                        if ln.startswith(f"| rowwise_card | {bp['l2_cell']} | 1 |"))
            check(line.endswith("(L2) |"), f"analysis: {line} is not marked (L2)")
        print(table, flush=True)
        rc, results = cli(results_table.main, ["--data-root", str(root), "--shape",
                                               bp["table_shape"]])
        check(rc == 0 and results.count("\n") == bp["sweep_cells"] + 2,
              f"results_table: rc {rc}: {results}")
        print(results, flush=True)
        figures = sorted(p.name for p in (tmp / "figures").glob("*.png"))
        no_mpl = "matplotlib is not installed" in table
        check(no_mpl or figures, "analysis: matplotlib is installed and no figure was written")
        emit({"phase": "bench_analysis", "hbm_peak_gbps": H100_HBM_PEAK_GBPS,
              "table_lines": table.count("\n"), "figures": figures,
              "matplotlib": not no_mpl, "seconds": time.perf_counter() - t0})
    return launches


def runtime_operand(n: int, seed: int, dev):
    """Section 48's seeded n² bf16 A and its x, uniform [0, 10), made on
    ``dev`` in row chunks: every process of its world makes the same."""
    import torch

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 48)
    a = torch.empty((n, n), dtype=torch.bfloat16, device=dev)
    rows = max(1, (1 << 28) // n)
    for i in range(0, n, rows):
        k = min(rows, n - i)
        a[i:i + k] = torch.rand((k, n), generator=gen, device=dev) * 10
    x = (torch.rand((n,), generator=gen, device=dev) * 10).to(torch.bfloat16)
    return a, x


def runtime_worker(seed: int, rank: str, port: str, out_dir: str, device: str,
                   n: str) -> int:
    """One process of section 48's world of two (``--runtime-worker``): joins
    the gloo world, runs every config of ``world.json`` in ``out_dir`` with
    one shard of the mesh, and writes each y there. Prints one JSON line:
    the launches, the two-process times, the exchange's host time a matvec,
    and the cross-process max of a local time."""
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import torch

    from matvec_mpi_multiplier_torch import get_strategy, make_mesh
    from matvec_mpi_multiplier_torch.bench import metrics
    from matvec_mpi_multiplier_torch.bench.timing import (
        TimingResult,
        _max_across_processes,
        benchmark_strategy,
    )
    from matvec_mpi_multiplier_torch.ops.cuda_gemv import gemv_cuda
    from matvec_mpi_multiplier_torch.parallel import distributed
    from matvec_mpi_multiplier_torch.parallel import mesh as mesh_mod

    rank, n, out = int(rank), int(n), Path(out_dir)
    world = json.loads((out / "world.json").read_text())
    dev = torch.device(device)
    distributed.initialize(f"127.0.0.1:{port}", 2, rank)

    def sync() -> None:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    # The exchange's host time, synchronized at entry so the kernel before
    # it is not counted in it.
    exchange = {"s": 0.0, "calls": 0}
    real_exchange = mesh_mod._exchange

    def timed_exchange(*args, **kw):
        sync()
        t0 = time.perf_counter()
        got = real_exchange(*args, **kw)
        exchange["s"] += time.perf_counter() - t0
        exchange["calls"] += 1
        return got

    mesh_mod._exchange = timed_exchange
    a, x = runtime_operand(n, seed, dev)
    record = {"rank": rank, "backend": distributed.backend(),
              "process_count": distributed.process_count(),
              "device_count": distributed.device_count(), "configs": {}}
    reps = world["reps"]
    first = None
    for name, grid in world["configs"]:
        label = f"{name}_{grid[0]}x{grid[1]}"
        mesh = make_mesh(2, shape=tuple(grid), devices=[dev])
        strat = get_strategy(name)
        gemv_cuda.launches = 0
        fn = strat.build(mesh, kernel="cuda")
        y = fn(a, x)
        sync()
        torch.save(y.cpu(), out / f"y_{label}_{rank}.pt")
        a_placed, x_placed = strat.place(a, x, mesh)
        t0 = time.perf_counter()
        fn(a_placed, x_placed)
        sync()
        local_s = time.perf_counter() - t0
        exchange.update(s=0.0, calls=0)
        res = benchmark_strategy(strat, mesh, a, x, n_reps=reps, mode="amortized",
                                 measure="sync", kernel="cuda")
        sync()
        calls = reps + 1  # the warm-up and the reps
        first = first or res
        record["configs"][label] = {
            "launches": gemv_cuda.launches, "ms": res.mean_time_s * 1e3,
            "times_s": list(res.times_s), "exchanges": exchange["calls"],
            "exchange_ms": exchange["s"] / calls * 1e3,
            "local_s": local_s, "max_s": _max_across_processes(local_s),
            "placed_shards": [f for f in range(mesh.size) if mesh.is_local(f)],
        }
        del a_placed, x_placed, fn, y
    csv_root = out / "csv"
    metrics.append_result(TimingResult(
        n_rows=first.n_rows, n_cols=first.n_cols, n_devices=first.n_devices,
        strategy=first.strategy, dtype=first.dtype, mode=first.mode,
        measure=first.measure, mean_time_s=first.mean_time_s,
        times_s=first.times_s, n_reps=first.n_reps), csv_root)
    distributed.shutdown()
    print(json.dumps(record), flush=True)
    return 0


def runtime_section(dev, seed: int, rt: dict) -> dict:
    """Section 48: the runtime remainder on ``dev`` at the sizes of ``rt``.

    * The native tier (``utils/native_lib.py``): the library built with
      ``g++`` from the port's ``native/*.cc``; ``gemv_cuda`` against the C++
      oracle ``gemv_ctypes`` at the reference's fp64 cells and ``gemm_cuda``
      against ``gemm_ctypes`` (each with both times); the native text loader
      against numpy on a ``%.4f`` file, bitwise, with the loader that ran
      read from ``io.LOADS``; ``--kernel native --platform cuda`` refused
      before any cell, and a card tensor refused by the native tier.
    * Two processes on ``dev`` joined by gloo (``parallel/distributed.py``),
      one shard each (this script again, ``--runtime-worker``): rowwise,
      colwise and blockwise at ``rt["n"]``² bf16 through the strategy's
      build and ``benchmark_strategy(measure="sync")``, each y bitwise the
      one-process y on the same grid, the cross-process max the larger
      local time on both sides, exactly one CSV row, the two-process time
      beside the one-process time and the exchange's share.

    Emits one JSON line per part and returns the kernels' launches by path
    ({kernel: {path: n}}): the one-process run under
    ``runtime_one_process``, the two processes' under ``multiprocess``.
    Runs at a small size on a CPU device too."""
    import gc
    import socket

    import numpy as np
    import torch

    from matvec_mpi_multiplier_torch import get_strategy, make_mesh
    from matvec_mpi_multiplier_torch.bench import sweep as sweep_mod
    from matvec_mpi_multiplier_torch.bench.metrics import read_csv
    from matvec_mpi_multiplier_torch.bench.timing import benchmark_strategy
    from matvec_mpi_multiplier_torch.ops import native_gemm, native_gemv
    from matvec_mpi_multiplier_torch.ops.cuda_gemm import gemm_cuda
    from matvec_mpi_multiplier_torch.ops.cuda_gemv import gemv_cuda
    from matvec_mpi_multiplier_torch.utils import io as port_io
    from matvec_mpi_multiplier_torch.utils import native_lib
    from matvec_mpi_multiplier_torch.utils.errors import ConfigError

    on_card = dev.type == "cuda"
    launches: dict = {"gemv": {}}

    def sync() -> None:
        if on_card:
            torch.cuda.synchronize(dev)

    def card_ms(fn, reps: int) -> float:
        fn()
        sync()
        if not on_card:
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            return (time.perf_counter() - t0) / reps * 1e3
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        sync()
        return start.elapsed_time(end) / reps

    def host_ms(fn, reps: int = 3):
        out = fn()
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            best = min(best, time.perf_counter() - t0)
        return out, best * 1e3

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 480)

    def uniform(shape, dtype):
        return torch.rand(shape, generator=gen, device=dev, dtype=dtype) * 10

    # ---- (a) the native library, built from the port's sources ----
    t0 = time.perf_counter()
    for stale in (native_lib.lib_path(), native_lib._stamp_path()):
        stale.unlink(missing_ok=True)
    native_lib._lib = None
    built = native_lib.ensure_built()
    build_s = time.perf_counter() - t0
    lib = native_lib.lib_path().resolve()
    package = native_lib.PACKAGE_DIR.resolve()
    check(built and native_lib.LIB_ENV not in os.environ
          and lib.is_relative_to(package / "build"),
          f"native build: built {built}, library {lib}")
    check([s.resolve() for s in native_lib.sources()]
          == sorted((package / "native").glob("*.cc")),
          f"native build: sources {native_lib.sources()}")
    cxx = native_lib._compiler()
    compiler = subprocess.run([*cxx, "--version"], capture_output=True, text=True,
                              check=True, timeout=60).stdout.splitlines()[0]
    # The first processor's identity in /proc/cpuinfo (x86 names a "model
    # name"; Arm an implementer and a part), without its feature lists.
    first_cpu = Path("/proc/cpuinfo").read_text().split("\n\n")[0].splitlines()
    cpu_model = {k.strip(): v.strip() for k, v in (ln.split(":", 1) for ln in first_cpu
                                                   if ":" in ln)
                 if k.strip() not in ("flags", "bugs", "Features", "power management")}
    cpu_model["machine"] = os.uname().machine
    check(native_gemv.register_if_available() and native_gemm.register_if_available(),
          "native: the tiers did not register after the build")
    t0 = time.perf_counter()
    gemv_at = {}
    for m, k in rt["gemv_shapes"]:
        a = uniform((m, k), torch.float64)
        x = uniform((k,), torch.float64)
        a_h, x_h = a.cpu().numpy(), x.cpu().numpy()
        y_ref, oracle_ms = host_ms(lambda: native_gemv.gemv_ctypes(a_h, x_h))
        y = gemv_cuda(a, x).cpu().numpy()
        rel = float(np.max(np.abs(y - y_ref) / np.abs(y_ref)))
        check(rel <= rt["oracle_rtol"],
              f"gemv_cuda against gemv_ctypes at {m}x{k} fp64: rel err {rel}")
        gemv_at[f"{m}x{k}"] = {"max_rel_err": rel, "oracle_host_ms": oracle_ms,
                               "ms": card_ms(lambda: gemv_cuda(a, x), 20)}
        del a, x
    m, k, n_rhs = rt["gemm_shape"]
    a, b = uniform((m, k), torch.float64), uniform((k, n_rhs), torch.float64)
    a_h, b_h = a.cpu().numpy(), b.cpu().numpy()
    c_ref, gemm_oracle_ms = host_ms(lambda: native_gemm.gemm_ctypes(a_h, b_h), 1)
    c = gemm_cuda(a, b).cpu().numpy()
    gemm_rel = float(np.max(np.abs(c - c_ref) / np.abs(c_ref)))
    check(gemm_rel <= rt["oracle_rtol"],
          f"gemm_cuda against gemm_ctypes at {m}x{k}x{n_rhs} fp64: rel err {gemm_rel}")
    gemm_at = {"max_rel_err": gemm_rel, "oracle_host_ms": gemm_oracle_ms,
               "ms": card_ms(lambda: gemm_cuda(a, b), 10)}
    if on_card:
        try:
            native_gemv.gemv_native(a, b[:, 0])
            check(False, "native: a card tensor was not refused")
        except ConfigError:
            pass
    del a, b
    emit({"phase": "runtime_native", "library": str(lib.relative_to(package.parent)),
          "build_s": build_s, "compiler": compiler, "cxxflags": list(native_lib.CXXFLAGS),
          "host_cpu": cpu_model, "host_cores": os.cpu_count(),
          "oracle_rtol": rt["oracle_rtol"], "gemv": gemv_at,
          f"gemm_{m}x{k}x{n_rhs}": gemm_at, "seconds": time.perf_counter() - t0})

    # ---- (b) the native text loader against numpy ----
    t0 = time.perf_counter()
    size = rt["loader_n"]
    with tempfile.TemporaryDirectory(prefix="runtime_io_") as tmp:
        ref = port_io.generate_matrix(size, size, seed=seed + 48)
        w0 = time.perf_counter()
        path = port_io.save_matrix(ref, tmp)
        write_s = time.perf_counter() - w0
        before = dict(port_io.LOADS)
        w0 = time.perf_counter()
        via_native = port_io.load_matrix(size, size, tmp)
        native_s = time.perf_counter() - w0
        check(port_io.LOADS["native"] == before.get("native", 0) + 1
              and port_io.LOADS["numpy"] == before.get("numpy", 0),
              f"loader: the native loader did not run ({dict(port_io.LOADS)})")
        os.environ["MATVEC_NATIVE_IO"] = "0"
        try:
            w0 = time.perf_counter()
            via_numpy = port_io.load_matrix(size, size, tmp)
            numpy_s = time.perf_counter() - w0
        finally:
            del os.environ["MATVEC_NATIVE_IO"]
        check(np.array_equal(via_native, via_numpy), "loader: native and numpy differ")
        check(np.allclose(via_native, ref, rtol=0, atol=5e-5), "loader: values off the file's")
        file_bytes = path.stat().st_size
    emit({"phase": "runtime_loader", "shape": [size, size], "file_bytes": file_bytes,
          "write_s": write_s, "native_s": native_s, "numpy_s": numpy_s,
          "numpy_over_native": numpy_s / native_s, "bitwise_equal": True,
          "loads": dict(port_io.LOADS), "seconds": time.perf_counter() - t0})

    # ---- (c) --kernel native is refused on the card before any cell ----
    refusal = None
    try:
        sweep_mod.main(["--kernel", "native", "--platform", "cuda", "--sizes", "64",
                        "--no-csv"])
    except ConfigError as e:
        refusal = str(e)
    check(refusal is not None and "--platform cpu only" in refusal,
          f"--kernel native --platform cuda: {refusal}")
    emit({"phase": "runtime_sweep_native", "refused": refusal})

    # ---- (d) two processes on the card against one ----
    t0 = time.perf_counter()
    n, reps = rt["n"], rt["mp_reps"]
    configs = [(name, list(grid)) for name, grid in rt["mp_configs"]]
    one = {}
    a, x = runtime_operand(n, seed, dev)
    rows = slice(0, 256)
    exact = a[rows].double() @ x.double()
    for name, grid in configs:
        label = f"{name}_{grid[0]}x{grid[1]}"
        strat = get_strategy(name)
        mesh1 = make_mesh(2, shape=tuple(grid), devices=[dev] * 2)
        gemv_cuda.launches = 0
        y1 = strat.build(mesh1, kernel="cuda")(a, x)
        res1 = benchmark_strategy(strat, mesh1, a, x, n_reps=reps, mode="amortized",
                                  measure="sync", kernel="cuda")
        sync()
        launches["gemv"]["runtime_one_process"] = (
            launches["gemv"].get("runtime_one_process", 0) + gemv_cuda.launches)
        rel = float(((y1[rows].double() - exact).abs() / exact.abs()).max())
        check(tuple(y1.shape) == (n,) and bool(torch.isfinite(y1).all()) and rel <= 2 ** -7,
              f"one process {label}: shape {tuple(y1.shape)}, rel err {rel}")
        one[label] = {"y": y1.cpu(), "ms": res1.mean_time_s * 1e3, "rel_err": rel}
    del a, x, y1, exact
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="runtime_world_") as tmp:
        tmp = Path(tmp)
        (tmp / "world.json").write_text(json.dumps({"reps": reps, "configs": configs}))
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        procs = [subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--seed", str(seed),
             "--runtime-worker", str(rank), str(port), str(tmp), str(dev), str(n)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for rank in range(2)]
        records = []
        try:
            for p in procs:
                out, err = p.communicate(timeout=rt["mp_timeout_s"])
                check(p.returncode == 0,
                      f"runtime worker exited {p.returncode}:\n{out[-2000:]}\n{err[-4000:]}")
                records.append(json.loads(out.strip().splitlines()[-1]))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        by_config = {}
        total = 0
        for name, grid in configs:
            label = f"{name}_{grid[0]}x{grid[1]}"
            got = [r["configs"][label] for r in records]
            for rank, g in enumerate(got):
                y2 = torch.load(tmp / f"y_{label}_{rank}.pt")
                check(torch.equal(y2, one[label]["y"]),
                      f"two processes {label}: rank {rank}'s y is not the one-process y")
                # The build's call, the local timing, the warm-up, the reps.
                check(not on_card or g["launches"] == reps + 3,
                      f"two processes {label}: rank {rank} launched {g['launches']} "
                      f"GEMVs, not {reps + 3}")
            locals_ = [g["local_s"] for g in got]
            check(all(g["max_s"] == max(locals_) for g in got),
                  f"two processes {label}: max across processes {[g['max_s'] for g in got]} "
                  f"of locals {locals_}")
            check(got[0]["times_s"] == got[1]["times_s"],
                  f"two processes {label}: the ranks report different times")
            total += sum(g["launches"] for g in got)
            by_config[label] = {
                "one_process_ms": one[label]["ms"], "two_process_ms": got[0]["ms"],
                "exchange_ms_by_rank": [g["exchange_ms"] for g in got],
                "exchange_share_by_rank": [g["exchange_ms"] / g["ms"] for g in got],
                "exchanges_by_rank": [g["exchanges"] for g in got],
                "launches_by_rank": [g["launches"] for g in got],
                "local_s_by_rank": locals_, "max_s": got[0]["max_s"],
                "bitwise_one_process": True, "one_process_rel_err": one[label]["rel_err"],
            }
        csv_rows = read_csv(tmp / "csv" / "out" / "rowwise.csv")
        check(len(csv_rows) == 1, f"two processes: {len(csv_rows)} CSV rows, not 1")
    launches["gemv"]["multiprocess"] = total
    check(not on_card or total > 0, "two processes: no GEMV launched")
    emit({"phase": "runtime_multiprocess", "shape": [n, n], "dtype": "bfloat16",
          "backend": records[0]["backend"], "process_count": records[0]["process_count"],
          "device_count": records[0]["device_count"], "device": str(dev),
          "measure": "sync", "reps": reps, "configs": by_config,
          "csv_rows": len(csv_rows), "gemv_launches": total,
          "seconds": time.perf_counter() - t0})
    return launches


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[1])
    parser.add_argument("--seed", type=int, default=0)
    # Section 48 starts this script again as each process of its world.
    parser.add_argument("--runtime-worker", nargs=5, default=None,
                        metavar=("RANK", "PORT", "OUT_DIR", "DEVICE", "N"),
                        help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.runtime_worker is not None:
        return runtime_worker(args.seed, *args.runtime_worker)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this test runs "
              "on a CUDA card only", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import numpy as np

    from matvec_mpi_multiplier_torch import (
        build_ring_attention,
        build_ulysses_attention,
        get_strategy,
        make_1d_mesh,
        make_mesh,
    )
    from matvec_mpi_multiplier_torch.bench.attention import COLUMNS as ATTENTION_COLUMNS
    from matvec_mpi_multiplier_torch.bench.attention import report as attention_report
    from matvec_mpi_multiplier_torch.bench.attention import run_attention_study
    from matvec_mpi_multiplier_torch.bench.serve import (
        DEFAULT_WIDTH_MIX,
        _request_pool,
        gershgorin_interval,
        resident_matrix,
        run_serve,
        run_serve_load,
        run_serve_multitenant,
        run_serve_solver,
        solver_operand,
    )
    from matvec_mpi_multiplier_torch.bench import timing as timing_mod
    from matvec_mpi_multiplier_torch.bench.sweep import ASYMMETRIC_SIZES, SQUARE_SIZES
    from matvec_mpi_multiplier_torch.bench.timing import (
        benchmark_gemm,
        benchmark_strategy,
    )
    from matvec_mpi_multiplier_torch.ops.graphs import capture
    from matvec_mpi_multiplier_torch.solvers import build_solver
    from matvec_mpi_multiplier_torch.solvers.ops import _build_solver, placed_operand
    from matvec_mpi_multiplier_torch.solvers.device_loop import DEFAULT_CHUNK
    from matvec_mpi_multiplier_torch.engine import (
        ArrivalWindowScheduler,
        MatrixRegistry,
        MatvecEngine,
        bucket_for,
        bucket_ladder,
        pad_columns,
    )
    from matvec_mpi_multiplier_torch.engine import scheduler as scheduler_mod
    from matvec_mpi_multiplier_torch.resilience import (
        DeviceFaultError,
        FaultPlan,
        FaultSpec,
        ResultIntegrityError,
    )
    from matvec_mpi_multiplier_torch.models.gemm import build_gemm
    from matvec_mpi_multiplier_torch.parallel.mesh import (
        ShardedTensor,
        psum_scatter,
        shard,
        unshard,
    )
    from matvec_mpi_multiplier_torch.ops import _build
    from matvec_mpi_multiplier_torch.ops.attention import flash_path_available
    from matvec_mpi_multiplier_torch.ops.cuda_attention import (
        flash_partial_cuda,
        flash_partial_plain,
        flash_route,
    )
    from matvec_mpi_multiplier_torch.ops.cuda_attention import (
        launch_info as flash_launch_info,
    )
    from matvec_mpi_multiplier_torch.ops.cuda_gemm import (
        default_gemm_tiles,
        gemm_cuda,
        gemm_plain,
        launch_info,
    )
    from matvec_mpi_multiplier_torch.ops.cuda_gemv import (
        _launch,
        _layout,
        gemv_cuda,
        gemv_plain,
        gemv_plan,
        sm_count,
    )
    from matvec_mpi_multiplier_torch.ops.cuda_quant import (
        ROUTE_PARTS,
        payload_aligned,
        quant_gemv_cuda,
        quant_gemv_plain,
        quant_route,
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
        default_block,
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

    def gemm_plan(a, b):
        """The plan gemm_cuda takes for A and B (its route, tile and stages)."""
        return default_gemm_tiles(a.shape[0], b.shape[1], a.shape[1], a.dtype,
                                  aligned=a.data_ptr() % 16 == 0,
                                  b_aligned=b.data_ptr() % 16 == 0)

    def reset_gemm() -> None:
        gemm_cuda.launches = 0
        gemm_cuda.route_launches.clear()

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

    # The reps measure="loop" runs: every run of k reps replays k, and the
    # first capture of a loop runs one rep eagerly first. Each rep is one
    # call of the strategy's program, so the kernels' counts follow.
    loop_reps = Counter()
    loop_run, loop_graph = timing_mod._DeviceLoop.run, timing_mod._DeviceLoop.graph

    def counted_run(self, k):
        loop_reps["reps"] += k
        return loop_run(self, k)

    def counted_graph(self, reps):
        if not self.graphs:
            loop_reps["reps"] += 1  # the warm rep before the first capture
        return loop_graph(self, reps)

    timing_mod._DeviceLoop.run = counted_run
    timing_mod._DeviceLoop.graph = counted_graph
    n1 = max(1, N_REPS // 10)
    chain_calls = 1 + CHAIN_SAMPLES * (2 * n1 + N_REPS)  # the warm-up call, the chains

    def both_measures(strat, mesh, a, x, **kw) -> tuple[dict, dict]:
        """benchmark_strategy under chain and under loop on the same
        operands, in one run: the results and the program calls each made."""
        res, calls = {}, {}
        for measure in ("chain", "loop"):
            before = loop_reps["reps"]
            res[measure] = benchmark_strategy(
                strat, mesh, a, x, n_reps=N_REPS, mode="amortized", measure=measure,
                kernel="cuda", chain_samples=CHAIN_SAMPLES, **kw)
            calls[measure] = (chain_calls if measure == "chain"
                              else loop_reps["reps"] - before)
        return res, calls

    def measure_fields(res, calls) -> dict:
        """Both measures' ms, share of the bound and calls, and loop/chain."""
        out = {}
        for measure, r in res.items():
            ms = r.mean_time_s * 1e3
            bound_ms = r.gbps * r.mean_time_s / H100_HBM_PEAK_GBPS * 1e3
            out[measure] = {"ms": ms, "share_of_bound": bound_ms / ms,
                            "samples_ms": [t * 1e3 for t in r.times_s],
                            "program_calls": calls[measure]}
        out["bound_ms"] = bound_ms
        out["loop_over_chain"] = out["loop"]["ms"] / out["chain"]["ms"]
        return out

    def engine_runs(snapshot) -> tuple[int, int]:
        """An engine's (dispatches, captures) from its metrics snapshot: each
        capture of a key's program runs it once eagerly first."""
        counters = json.loads(snapshot.read_text())["counters"]
        return counters["engine_dispatches_total"], counters["engine_compiles_total"]

    # Each section's seconds, printed as it ends (and all of them before
    # the kernels line).
    clock = {"section": None, "t0": time.perf_counter(), "seconds": {}}

    def section(name: str) -> None:
        now = time.perf_counter()
        if clock["section"] is not None:
            seconds = now - clock["t0"]
            clock["seconds"][clock["section"]] = seconds
            emit({"phase": "seconds", "section": clock["section"], "seconds": seconds})
        clock["section"], clock["t0"] = name, now

    # ---- 1. env ----
    section("1. env")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    nvcc = _build.find_nvcc()
    nvcc_version = subprocess.run(
        [nvcc, "--version"], capture_output=True, text=True, check=True,
        timeout=60,
    ).stdout.strip().splitlines()[-1]
    # Host memory: the multi-tenant section keeps up to 4 tenants' host
    # payloads (34.4 GB).
    meminfo = dict(line.split(":", 1) for line in
                   Path("/proc/meminfo").read_text().splitlines() if ":" in line)
    mem_total = meminfo.get("MemTotal", "unknown").strip()
    emit({"phase": "env", "torch": torch.__version__, "cuda": torch.version.cuda,
          "capability": list(torch.cuda.get_device_capability(dev)),
          "device": torch.cuda.get_device_name(dev), "nvcc": nvcc_version,
          "nvidia_smi": smi, "allow_tf32": False, "host_mem_total": mem_total})
    print(smi, flush=True)
    print(f"host MemTotal: {mem_total}", flush=True)

    # ---- 2. build, from the sources, with no prior build directory ----
    section("2. build, from the sources, with no prior build directory")
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
    section("3. kernel against its plain version")
    # The GEMV's plan on this card, and its launches by route on each path
    # (the check shapes here are no path of the kernels line's "launches").
    sms = sm_count(dev)
    gemv_routes = {}
    gemv_cuda.route_launches.clear()

    def other_plans(m, k, dtype):
        """Every route and grid the plan did not pick: rows; split on 1
        and 2 blocks an SM, and on a 7-SM grid (few warps, long runs)."""
        if k == 0:
            return [_layout("rows", m, k, dtype, sms)]
        return [_layout("rows", m, k, dtype, sms), _layout("split", m, k, dtype, sms, 1),
                _layout("split", m, k, dtype, sms, 2), _layout("split", m, k, dtype, 7, 2)]

    for m, k in CHECK_SHAPES:
        for name in ("bfloat16", "float16", "float32", "float64"):
            dtype = torch_dtype(name)
            if (m, k) == (4, 8):
                a = torch.tensor(FIXTURE_MATRIX, dtype=torch.float64).to(dev, dtype)
                x = torch.tensor(FIXTURE_VECTOR, dtype=torch.float64).to(dev, dtype)
            else:
                a, x = uniform((m, k), dtype), uniform((k,), dtype)
            plan = gemv_plan(m, k, dtype, dtype, sms)
            before = gemv_cuda.route_launches[plan.route]
            y1, y2 = gemv_cuda(a, x), gemv_cuda(a, x)
            ref = gemv_plain(a, x)
            torch.cuda.synchronize(dev)
            check(gemv_cuda.route_launches[plan.route] == before + 2,
                  f"gemv {m}x{k} {name}: not on the planned route {plan.route}")
            # One association for every route and grid: bitwise equal.
            for other in other_plans(m, k, dtype):
                check(torch.equal(_launch(a, x, other), y1),
                      f"gemv {m}x{k} {name}: {other} differs from {plan.route}")
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
                  "dtype": name, "route": plan.route, "grid": plan.grid,
                  "max_abs_err": (y1 - ref).abs().max().item(),
                  "max_rel_err": rel, "rtol": rtol, "bitwise_repeatable": True,
                  "bitwise_equal_plans": [[q.route, q.grid]
                                          for q in other_plans(m, k, dtype)]})
            del a, x, y1, y2, ref
    gemv_routes["kernel_vs_plain"] = dict(gemv_cuda.route_launches)
    check(set(gemv_routes["kernel_vs_plain"]) == {"rows", "split"},
          f"gemv check shapes took {gemv_routes['kernel_vs_plain']}, not both routes")
    # A row slice gives the full call's rows bitwise, though the full A
    # takes rows and the slice split.
    m, k = GEMV_SLICE_SHAPE
    for name in ("bfloat16", "float16", "float32", "float64"):
        dtype = torch_dtype(name)
        a, x = uniform((m, k), dtype), uniform((k,), dtype)
        full = gemv_cuda(a, x)
        routes = {"full": gemv_plan(m, k, dtype, dtype, sms).route}
        for lo, hi in ((0, 120), (1000, 1123)):
            routes[f"{lo}:{hi}"] = gemv_plan(hi - lo, k, dtype, dtype, sms).route
            check(torch.equal(gemv_cuda(a[lo:hi], x), full[lo:hi]),
                  f"gemv rows {lo}:{hi} of {m}x{k} {name} differ from the full call's")
        check(routes == {"full": "rows", "0:120": "split", "1000:1123": "split"},
              f"gemv row slices of {m}x{k} {name}: routes {routes}")
        emit({"phase": "gemv_row_slice", "kernel": "gemv", "shape": [m, k], "dtype": name,
              "routes": routes, "bitwise_equal": True})
        del a, x, full
    torch.cuda.empty_cache()

    # ---- 4. main path through the entry points ----
    section("4. main path through the entry points")
    calls_per_config = chain_calls + 1  # + the check
    gemv_cuda.launches = 0
    gemv_cuda.route_launches.clear()
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
        res, calls = both_measures(strat, mesh, a, x)
        y = strat.build(mesh, kernel="cuda")(*strat.place(a, x, mesh))
        ref = gemv_plain(a, x).to(dtype)
        torch.cuda.synchronize(dev)
        launched = gemv_cuda.launches - before
        want = (calls["chain"] + calls["loop"] + 1) * shards
        expected += want
        check(launched == want,
              f"{strategy} {n}² {name} p={shards}: {launched} kernel launches, "
              f"expected {want}")
        # y and the plain product, both cast back to the storage dtype: one
        # bf16 ulp (2^-7) apart at most; fp32 sums in another order, 1e-4.
        rtol = 2 ** -7 if dtype == torch.bfloat16 else 1e-4
        rel = ((y.float() - ref.float()).abs() / ref.float().abs()).max().item()
        check(y.shape == (n,) and bool(torch.isfinite(y).all()),
              f"{strategy}: y is not {n} finite values")
        check(rel <= rtol, f"{strategy} {n}² {name} p={shards}: rel err {rel} > {rtol}")
        times = measure_fields(res, calls)
        emit({"phase": "main", "strategy": strategy, "shape": [n, n],
              "dtype": name, "mesh": list(mesh.grid), "shards_on_cuda0": shards,
              "kernel": "cuda", "mode": "amortized", "measure": "loop",
              "n_reps": N_REPS, "ms": times["loop"]["ms"], "chain_ms": times["chain"]["ms"],
              "bound_ms": times["bound_ms"],
              "share_of_bound": times["loop"]["share_of_bound"],
              "measures": times, "launches": launched, "max_rel_err": rel, "rtol": rtol})
        del y, ref
    main_launches = gemv_cuda.launches
    check(main_launches == expected and main_launches > 0,
          f"main path launched the kernel {main_launches} times, expected {expected}")
    # The main path's square shapes (65536², 32768², the 2x2 mesh's 16384²
    # blocks) fill the card one warp per row.
    gemv_routes["strategies"] = dict(gemv_cuda.route_launches)
    check(gemv_routes["strategies"] == {"rows": main_launches},
          f"main path GEMV routes {gemv_routes['strategies']}, expected rows only")
    operands.clear()
    torch.cuda.empty_cache()

    # ---- 5. kernels: time, bound, plain, library ----
    section("5. kernels: time, bound, plain, library")
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
        plan = gemv_plan(n, n, dtype, dtype, sms)
        at[f"{n}x{n}"] = {
            "dtype": name, "route": plan.route, "grid": plan.grid,
            "bytes_in_flight": plan.bytes_in_flight,
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

    # The reference's sweeps, timed one launch at a time after overwriting
    # 4x the L2, so A comes from HBM as in a cold call: bench/sweep.py's
    # asymmetric cells (few rows, k = 60000; fp32 and bf16, and two in fp64)
    # and its square cells (fp32). Each beside torch.matmul on the same
    # operands and its byte bound; the plan's route for each. The flush
    # writes, so the call also pays for writing back the L2's dirty lines;
    # the *_read_flush fields time the same calls after a flush that reads
    # (clean lines), which shows that share.
    flush = torch.empty(4 * H100_L2_BYTES // 4, dtype=torch.float32, device=dev)

    def cold_ms(fn, reps: int = 20, read_flush: bool = False) -> float:
        fn()
        pairs = []
        for _ in range(reps):
            if read_flush:
                flush.sum()
            else:
                flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            pairs.append((start, end))
        torch.cuda.synchronize(dev)
        return statistics.median(s.elapsed_time(e) for s, e in pairs)

    def cold_line(phase, m, k, name) -> dict:
        dtype = torch_dtype(name)
        a, x = uniform((m, k), dtype), uniform((k,), dtype)
        plan = gemv_plan(m, k, dtype, dtype, sms)
        before = gemv_cuda.route_launches[plan.route]
        y, ref = gemv_cuda(a, x), gemv_plain(a, x)
        torch.cuda.synchronize(dev)
        check(gemv_cuda.route_launches[plan.route] == before + 1,
              f"gemv {m}x{k} {name}: not on the planned route {plan.route}")
        rtol = 1e-12 if dtype == torch.float64 else (1e-5 if k <= 4096 else 1e-4)
        rel = ((y - ref).abs() / ref.abs()).max().item()
        check(rel <= rtol, f"gemv {m}x{k} {name}: rel err {rel} > {rtol}")
        ms = cold_ms(lambda: gemv_cuda(a, x))
        library_ms = cold_ms(lambda: torch.matmul(a, x[:, None]))
        nbytes = (m * k + k) * a.element_size() + m * y.element_size()
        bound_ms = nbytes / (H100_HBM_PEAK_GBPS * 1e9) * 1e3
        line = {"phase": phase, "kernel": "gemv", "shape": [m, k], "dtype": name,
                "route": plan.route, "grid": plan.grid, "launches_per_call": plan.launches,
                "slabs_per_warp": plan.slabs_per_warp,
                "bytes_in_flight": plan.bytes_in_flight, "l2": "flushed", "ms": ms,
                "library_ms": library_ms, "of_library": ms / library_ms,
                "ms_read_flush": cold_ms(lambda: gemv_cuda(a, x), read_flush=True),
                "library_ms_read_flush": cold_ms(lambda: torch.matmul(a, x[:, None]),
                                                 read_flush=True),
                "bound_ms": bound_ms, "bound_by": "bytes", "share_of_bound": bound_ms / ms,
                "max_abs_err": (y - ref).abs().max().item(), "max_rel_err": rel,
                "rtol": rtol}
        emit(line)
        return line

    gemv_cuda.route_launches.clear()
    asym_at = {}
    for name in ("float32", "bfloat16", "float64"):
        for m, k in ASYMMETRIC_FP64 if name == "float64" else ASYMMETRIC_SIZES:
            asym_at[f"{m}x{k}_{name}"] = cold_line("asymmetric", m, k, name)
            torch.cuda.empty_cache()
    square_at = {}
    for n in SQUARE_SIZES:
        square_at[f"{n}x{n}_float32"] = cold_line("square_sweep", n, n, "float32")
    gemv_routes["asymmetric_and_square_timing"] = dict(gemv_cuda.route_launches)
    check(set(gemv_routes["asymmetric_and_square_timing"]) == {"rows", "split"},
          "the sweeps' shapes did not take both GEMV routes: "
          f"{gemv_routes['asymmetric_and_square_timing']}")
    del flush
    torch.cuda.empty_cache()

    # bench/sweep.py's asymmetric cells end to end at p = 1: each strategy
    # through benchmark_strategy (fp32, the sweep's dtype) under both
    # measures, every call one GEMV on the route its shape plans. An A that
    # fits the L2 (l2_resident) stays there from one looped rep to the next:
    # its loop time may read above the HBM byte bound.
    mesh1 = make_mesh(1)
    gemv_cuda.launches = 0
    gemv_cuda.route_launches.clear()
    expect_routes = Counter()
    for m, k in ASYMMETRIC_SIZES:
        a, x = uniform((m, k), torch.float32), uniform((k,), torch.float32)
        route = gemv_plan(m, k, torch.float32, torch.float32, sms).route
        ref = gemv_plain(a, x)
        for strategy in ("rowwise", "colwise", "blockwise"):
            strat = get_strategy(strategy)
            before = gemv_cuda.launches
            res, calls = both_measures(strat, mesh1, a, x)
            y = strat.build(mesh1, kernel="cuda")(*strat.place(a, x, mesh1))
            torch.cuda.synchronize(dev)
            launched = gemv_cuda.launches - before
            want = calls["chain"] + calls["loop"] + 1  # + the check
            expect_routes[route] += want
            check(launched == want,
                  f"sweep {strategy} {m}x{k}: {launched} launches, expected {want}")
            rel = ((y - ref).abs() / ref.abs()).max().item()
            check(tuple(y.shape) == (m,) and rel <= 1e-4,
                  f"sweep {strategy} {m}x{k}: rel err {rel} > 1e-4")
            times = measure_fields(res, calls)
            emit({"phase": "sweep_asymmetric", "strategy": strategy, "shape": [m, k],
                  "dtype": "float32", "mesh": list(mesh1.grid), "kernel": "cuda",
                  "mode": "amortized", "measure": "loop", "n_reps": N_REPS,
                  "route": route, "ms": times["loop"]["ms"],
                  "chain_ms": times["chain"]["ms"], "bound_ms": times["bound_ms"],
                  "share_of_bound": times["loop"]["share_of_bound"],
                  "l2_resident": m * k * 4 <= H100_L2_BYTES,
                  "loop_below_chain": times["loop"]["ms"] < times["chain"]["ms"],
                  "measures": times, "launches": launched, "max_rel_err": rel,
                  "rtol": 1e-4})
        del a, x, ref, y
    sweep_launches = gemv_cuda.launches
    gemv_routes["sweep_asymmetric"] = dict(gemv_cuda.route_launches)
    check(gemv_routes["sweep_asymmetric"] == dict(expect_routes),
          f"sweep GEMV routes {gemv_routes['sweep_asymmetric']}, expected "
          f"{dict(expect_routes)}")
    # The loop's bump on its own (bench/timing.py::_rep with a program that
    # returns a fixed out): Σ out² and the carry's update, a graph of 64
    # bumps replayed, per bump. The out forms the loop meets: the first
    # asymmetric cell's fp32 y (a dot and an addcmul_), the 65536² bf16 y
    # (a cast first) and a 4-shard bf16 y (rowwise without its gather: the
    # shards gathered first, then the cast).
    m, k = ASYMMETRIC_SIZES[0]
    n_sq = 65536
    mesh_b = make_mesh(4, devices=[dev] * 4)
    eps = torch.zeros((), dtype=torch.float32, device=dev)
    bump_cases = (
        ("fp32", [m, k], uniform((m,), torch.float32), uniform((k,), torch.float32)),
        ("bf16", [n_sq, n_sq], uniform((n_sq,), torch.bfloat16),
         uniform((n_sq,), torch.bfloat16)),
        ("bf16_4_shards", [n_sq, n_sq],
         shard(uniform((n_sq,), torch.bfloat16),
               get_strategy("rowwise").specs(mesh_b)[2], mesh_b),
         uniform((n_sq,), torch.bfloat16)),
    )
    for out_form, shape, y, carry in bump_cases:
        bumps, _ = capture(lambda: [timing_mod._rep(lambda _a, _x: y, None, carry,
                                                    [carry], eps)
                                    for _ in range(64)], dev)
        emit({"phase": "loop_bump", "shape": shape, "out": out_form,
              "ms_per_bump": event_ms(bumps.replay, reps=50) / 64})
    del y, carry, bumps, bump_cases
    torch.cuda.empty_cache()

    # ---- 6. gemm against its plain version ----
    section("6. gemm against its plain version")
    # Route launches by path: the check shapes here (not a path: their
    # launches are not counted in the kernels line's "launches"), the serve
    # cells, benchmark_gemm and the combine serve cells below.
    gemm_routes = {}
    reset_gemm()
    for m, k, n in GEMM_CHECK_SHAPES:
        for name in ("bfloat16", "float16", "float32", "float64"):
            dtype = torch_dtype(name)
            if (m, k) == (4, 8):
                a = torch.tensor(FIXTURE_MATRIX, dtype=torch.float64).to(dev, dtype)
            else:
                a = uniform((m, k), dtype)
            b = uniform((k, n), dtype)
            plan = gemm_plan(a, b)
            c1, c2 = gemm_cuda(a, b), gemm_cuda(a, b)
            ref = gemm_plain(a, b)
            # Row-slice independence: rows r0..r1 of A alone give the same
            # bits as the same rows of the whole product; r1 - r0 is not a
            # multiple of the row tile, so the slice's tiles split elsewhere.
            r0, r1 = (1, m - 1) if m < 8 else (3, m - 2)
            check((r1 - r0) % plan.bm != 0, f"gemm {m}x{k}x{n}: slice {r0}:{r1}")
            rows_ok = torch.equal(gemm_cuda(a[r0:r1], b), c1[r0:r1])
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
            check(rows_ok, f"gemm {m}x{k}x{n} {name}: rows {r0}:{r1} of A alone differ "
                  "from the same rows of the whole product")
            emit({"phase": "kernel_vs_plain", "kernel": "gemm", "shape": [m, k, n],
                  "dtype": name, "route": plan.route, "tile": [plan.bm, plan.bn],
                  "b_load": plan.b_load, "max_abs_err": (c1 - ref).abs().max().item(),
                  "max_rel_err": rel, "rtol": rtol, "bitwise_repeatable": True,
                  "pad_independent": {"width": width, "pads": list(padded)},
                  "row_slice_independent": [r0, r1]})
            del a, b, c1, c2, ref, padded
    torch.cuda.synchronize(dev)
    gemm_routes["kernel_vs_plain"] = dict(gemm_cuda.route_launches)
    check(gemm_routes["kernel_vs_plain"].get("mma_sync", 0) > 0,
          "no check shape took the mma_sync route")
    torch.cuda.empty_cache()

    # ---- 7, 8. serve: this slice's path, at full width and on a 2x2 mesh ----
    section("7, 8. serve: this slice's path, at full width and on a 2x2 mesh")
    launches_by_path = {"gemv": {"strategies": main_launches,
                                 "sweep_asymmetric": sweep_launches}, "gemm": {}}
    with tempfile.TemporaryDirectory() as tmp:
        for label, strategy, n, name, shards, n_requests in SERVE_CONFIGS:
            dtype = torch_dtype(name)
            mesh = make_mesh(1) if shards == 1 else make_mesh(shards, devices=[dev] * shards)
            snapshot = Path(tmp) / f"{label}.json"
            gemv_cuda.launches = 0
            gemv_cuda.route_launches.clear()
            reset_gemm()
            res = run_serve(strategy, mesh, n, n, dtype=name, kernel="cuda",
                            max_bucket=SERVE_MAX_BUCKET, promote=SERVE_PROMOTE,
                            n_requests=n_requests, seed=args.seed,
                            metrics_out=str(snapshot))
            torch.cuda.synchronize(dev)
            launched = {"gemv": gemv_cuda.launches, "gemm": gemm_cuda.launches}
            gemm_routes[f"serve_{label}"] = dict(gemm_cuda.route_launches)
            gemv_routes[f"serve_{label}"] = dict(gemv_cuda.route_launches)
            check(gemv_routes[f"serve_{label}"] == {"rows": launched["gemv"]},
                  f"serve {label}: GEMV routes {gemv_routes[f'serve_{label}']}")
            route = "wgmma_tma" if dtype.itemsize == 2 else "ffma"
            check(set(gemm_routes[f"serve_{label}"]) == {route},
                  f"serve {label}: GEMM routes {gemm_routes[f'serve_{label}']}, "
                  f"expected {route} only")
            dispatches, captures = engine_runs(snapshot)
            # Each dispatch (a replay) and each capture's eager run calls
            # the kernel once per shard.
            check(launched["gemv"] > 0 and launched["gemm"] > 0
                  and launched["gemv"] + launched["gemm"]
                  == (dispatches + captures) * shards,
                  f"serve {label}: launches {launched}, {dispatches} dispatches "
                  f"and {captures} captures x {shards} shards")
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
                  "dispatch": "graph", "captures": captures,
                  "launches": launched, "replay_check": checked})
            torch.cuda.empty_cache()

    # ---- 9. gemm through the sweep's entry point ----
    section("9. gemm through the sweep's entry point")
    a, b = uniform((4096, 4096), torch.bfloat16), uniform((4096, 4096), torch.bfloat16)
    mesh = make_mesh(1)
    reset_gemm()
    res = benchmark_gemm("blockwise", mesh, a, b, n_reps=N_REPS, mode="amortized",
                         measure="chain", kernel="cuda", chain_samples=CHAIN_SAMPLES)
    c = build_gemm("blockwise", mesh, kernel="cuda")(a, b)
    ref = gemm_plain(a, b).to(torch.bfloat16)
    torch.cuda.synchronize(dev)
    check(gemm_cuda.launches == calls_per_config,
          f"benchmark_gemm launched the kernel {gemm_cuda.launches} times, "
          f"expected {calls_per_config}")
    launches_by_path["gemm"]["benchmark_gemm"] = gemm_cuda.launches
    gemm_routes["benchmark_gemm"] = dict(gemm_cuda.route_launches)
    check(set(gemm_routes["benchmark_gemm"]) == {"wgmma_tma"},
          f"benchmark_gemm's GEMM routes: {gemm_routes['benchmark_gemm']}")
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
    section("10. gemm: time, bound, plain, library")
    def build_registers(plan, dtype) -> int:
        """Registers per thread of the kernel a GEMM plan launches, from the
        ptxas lines of this run's build log (phase 2)."""
        bf16 = int(dtype == torch.bfloat16)
        if plan.route == "wgmma_tma":
            tag = (f"gemm_wgmma_kernelILb{bf16}ELi{plan.bn}ELi{plan.bm // 128}"
                   f"ELb{int(plan.b_load == 'tma')}E")
        elif plan.route == "mma_sync":
            tag = f"gemm_mma_kernelILb{bf16}ELi{plan.bn}E"
        else:
            tag = f"gemm_{plan.route}_kernelILi{plan.bn}E"
        used = [e["used"] for e in ptxas if tag in e["kernel"]]
        check(len(used) == 1, f"the build log has {len(used)} entries for {tag}")
        return int(used[0].split("Used ")[1].split(" registers")[0])

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
        plan = gemm_plan(a, b)
        c, ref = gemm_cuda(a, b), gemm_plain(a, b)
        rtol = 1e-5 if k <= 4096 else 1e-4
        rel = ((c - ref).abs() / ref.abs()).max().item()
        check(rel <= rtol, f"gemm {m}x{k}x{n} {name}: rel err {rel} > {rtol}")
        nbytes = (m * k + k * n) * a.element_size() + m * n * c.element_size()
        bytes_ms = nbytes / (H100_HBM_PEAK_GBPS * 1e9) * 1e3
        peak = {2: TENSOR_PEAK_FLOPS, 4: FP32_PEAK_FLOPS, 8: FP64_PEAK_FLOPS}[
            a.element_size()]
        ops_ms = 2 * m * k * n / peak * 1e3
        launch = launch_info(plan, m, n, dtype)
        registers = build_registers(plan, dtype)
        check(registers == launch["registers"],
              f"gemm {m}x{k}x{n} {name}: {registers} registers in the build log, "
              f"{launch['registers']} in the loaded kernel")
        gemm_at[f"{m}x{k}x{n}_{name}"] = {
            "dtype": name, "route": plan.route, "face": plan.face,
            "tile": [plan.bm, plan.bn, plan.bk], "stages": plan.stages,
            "b_load": plan.b_load, "kernel_launches_per_call": plan.launches,
            "dynamic_smem_bytes": launch["dynamic_smem_bytes"],
            "static_smem_bytes": launch["static_smem_bytes"],
            "registers": registers, "threads": launch["threads"], "grid": launch["grid"],
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
    section("quantized storage: helpers")
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

    def quant_bound(qa, n: int, nbytes: int, route: str) -> dict:
        """The least time the card could take: the larger of the bytes (the
        payload and scales, x and y, once) over the HBM rate and the
        contraction's 2·m·k·n flops over the tensor cores' 989 TFLOP/s.
        Beside it, ffma_bound_ms, the same flops plus the dequantization's
        multiply (and add for int8c) at the FFMA peak, the CUDA-core design's
        ceiling; and passes_ceiling_ms, the route's passes (x's parts) times
        the levels times 2·m·k·n on the tensor cores."""
        m, k = qa.shape
        levels = 2 if qa.fmt == "int8c" else 1
        bytes_ms = nbytes / (H100_HBM_PEAK_GBPS * 1e9) * 1e3
        ops_ms = 2 * m * k * n / TENSOR_PEAK_FLOPS * 1e3
        ffma_ms = (2 * m * k * n + (2 * levels - 1) * m * k) / FP32_PEAK_FLOPS * 1e3
        passes = max(1, ROUTE_PARTS[route])
        return {"bound_ms": max(bytes_ms, ops_ms),
                "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                "ffma_bound_ms": max(bytes_ms, ffma_ms),
                "passes_ceiling_ms": passes * levels * ops_ms, "passes": passes}

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
    section("11. quant_gemv against its plain version")
    for m, k, block in QUANT_CHECK_SHAPES:
        for name in ("bfloat16", "float16", "float32", "float64"):
            dtype = torch_dtype(name)
            a = (uniform((m, k), torch.float32) - 5).to(dtype)  # both signs
            tol = 1e-12 if dtype == torch.float64 else (1e-5 if k <= 4096 else 1e-4)
            for fmt in QUANT_FORMATS:
                qa = quantize_matrix(a, fmt, block=block)
                worst, max_abs, pads_equal_unpadded = 0.0, 0.0, True
                route = quant_route(fmt, dtype, m, k, 1, block, payload_aligned(qa))
                quant_gemv_cuda.route_launches.clear()
                for w in QUANT_WIDTHS:
                    x = uniform((k,) if w is None else (k, w), dtype)
                    check(quant_route(fmt, dtype, m, k, w or 1, block,
                                      payload_aligned(qa)) == route,
                          f"quant_gemv {m}x{k} {fmt} {name}: the plan depends on n")
                    before = quant_gemv_cuda.route_launches[route]
                    y1, y2 = quant_gemv_cuda(qa, x), quant_gemv_cuda(qa, x)
                    ref = quant_gemv_plain(qa, x)
                    scale = quant_gemv_plain(payload_abs(qa), x)
                    torch.cuda.synchronize(dev)
                    check(quant_gemv_cuda.route_launches[route] == before + 2,
                          f"quant_gemv {m}x{k} {fmt} {name} n={w}: not on the planned "
                          f"route {route}: {dict(quant_gemv_cuda.route_launches)}")
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
                check(set(quant_gemv_cuda.route_launches) == {route},
                      f"quant_gemv {m}x{k} {fmt} {name}: routes "
                      f"{dict(quant_gemv_cuda.route_launches)}, planned {route}")
                emit({"phase": "quant_vs_plain", "kernel": "quant_gemv", "shape": [m, k],
                      "block": block, "format": fmt, "dtype": name, "quant_route": route,
                      "widths": [1 if w is None else w for w in QUANT_WIDTHS],
                      "max_abs_err": max_abs, "max_err_over_scale": worst, "tol": tol,
                      "bitwise_repeatable": True, "pad_independent": True,
                      "padded_equals_unpadded": pads_equal_unpadded})
                del qa
            del a
    torch.cuda.empty_cache()

    # ---- 12. the quantizer on the card against the CPU ----
    section("12. the quantizer on the card against the CPU")
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
    section("13. strategies at full width from quantized storage")
    quant_launches, quant_routes = {}, {}
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
        quant_gemv_cuda.route_launches.clear()
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
            path = f"{strategy}_{n}_{fmt}_p{shards}"
            quant_launches[path] = launched["quant_gemv"]
            quant_routes[path] = dict(quant_gemv_cuda.route_launches)
            check(set(quant_routes[path]) == {"wgmma_split"},
                  f"{path}: quant routes {quant_routes[path]}, planned wgmma_split")
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
    section("14. serve from a quantized resident")
    with tempfile.TemporaryDirectory() as tmp:
        for label, strategy, n, name, fmt, shards, n_requests in QUANT_SERVE_CONFIGS:
            dtype = torch_dtype(name)
            mesh = make_mesh(1) if shards == 1 else make_mesh(shards, devices=[dev] * shards)
            snapshot = Path(tmp) / f"{label}.json"
            quant_gemv_cuda.launches = gemv_cuda.launches = gemm_cuda.launches = 0
            quant_gemv_cuda.route_launches.clear()
            res = run_serve(strategy, mesh, n, n, dtype=name, kernel="cuda",
                            max_bucket=SERVE_MAX_BUCKET, promote=SERVE_PROMOTE,
                            n_requests=n_requests, seed=args.seed,
                            metrics_out=str(snapshot), dtype_storage=fmt)
            torch.cuda.synchronize(dev)
            launched = {"quant_gemv": quant_gemv_cuda.launches, "gemv": gemv_cuda.launches,
                        "gemm": gemm_cuda.launches}
            dispatches, captures = engine_runs(snapshot)
            check(launched["quant_gemv"] == (dispatches + captures) * shards
                  and launched["gemv"] == launched["gemm"] == 0,
                  f"serve {label}: launches {launched}, {dispatches} dispatches and "
                  f"{captures} captures x {shards}")
            check(res.compiles_steady == 0 and res.dtype_storage == fmt,
                  f"serve {label}: {res.compiles_steady} steady builds, storage "
                  f"{res.dtype_storage}")
            quant_launches[f"serve_{label}"] = launched["quant_gemv"]
            quant_routes[f"serve_{label}"] = dict(quant_gemv_cuda.route_launches)
            check(set(quant_routes[f"serve_{label}"]) == {"wgmma_split"},
                  f"serve {label}: quant routes {quant_routes[f'serve_{label}']}")
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
    section("15. quant_gemv: time, bound, plain, the native GEMV")
    quant_at = {}
    held = {}
    for n, fmt, w, name in QUANT_TIME_SHAPES:
        dtype = torch_dtype(name)
        if held.get("key") != (n, name):
            held.clear()
            torch.cuda.empty_cache()
            held["key"], held["a"] = (n, name), uniform((n, n), torch.float32).to(dtype)
        a = held["a"]
        if held.get("fmt") != fmt:
            held.pop("qa", None)
            held["fmt"], held["qa"] = fmt, quantize_matrix(a, fmt)
        qa = held["qa"]
        x = uniform((n,) if w == 1 else (n, w), dtype)
        route = quant_route(fmt, dtype, n, n, w, qa.block, payload_aligned(qa))
        quant_gemv_cuda.route_launches.clear()
        y, ref = quant_gemv_cuda(qa, x), quant_gemv_plain(qa, x)
        check(dict(quant_gemv_cuda.route_launches) == {route: 1},
              f"quant_gemv {n}² {fmt} n={w} {name}: routes "
              f"{dict(quant_gemv_cuda.route_launches)}, planned {route}")
        scale = quant_gemv_plain(payload_abs(qa), x)
        err = (y - ref).abs()
        check(bool((err <= 1e-4 * scale).all()),
              f"quant_gemv {n}² {fmt} n={w} {name}: error over 1e-4 of |deq(A)|·|x|")
        bound = quant_bound(qa, w, qa.nbytes + x.numel() * x.element_size()
                            + y.numel() * y.element_size(), route)
        native = (lambda: gemv_cuda(a, x)) if w == 1 else (lambda: gemm_cuda(a, x))
        quant_at[f"{n}x{n}_{fmt}_n{w}" + ("" if name == "float32" else f"_{name}")] = {
            "format": fmt, "width": w, "x_dtype": name, "block": qa.block,
            "payload_bytes": qa.nbytes, "quant_route": route,
            # int8's vector face on the tensor-core routes runs on the CUDA
            # cores (the kernel's choice, by format).
            "consumer": "fma" if route == "fma" or (w == 1 and fmt == "int8") else "wgmma",
            "ms": event_ms(lambda: quant_gemv_cuda(qa, x), reps=20 if w == 1 else 10),
            "plain_ms": event_ms(lambda: quant_gemv_plain(qa, x), reps=2, warmup=1),
            "library_ms": None,
            "native_ms": event_ms(native, reps=10),
            "native_call": ("gemv_cuda(a, x)" if w == 1 else "gemm_cuda(a, x)")
            + f", a {name}",
            **bound,
            "max_abs_err": err.max().item(),
            "max_err_over_scale": (err / scale.clamp_min(1e-300)).max().item(),
        }
        del x, y, ref, scale, err
    held.clear()
    torch.cuda.empty_cache()

    # ---- served solvers: helpers ----
    section("served solvers: helpers")
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
    # The routes the fused step's quantized and native GEMVs took, by path.
    step_quant_routes = {}
    step_gemv_routes = {}

    def drive(label, fn):
        """One solver path, with every launch count set to 0 just before it
        and read just after; a solver path runs no GEMM (promote=None)."""
        for wrapper in wrappers.values():
            wrapper.launches = 0
        quant_gemv_cuda.route_launches.clear()
        solver_step_cuda.quant_route_launches.clear()
        gemv_cuda.route_launches.clear()
        solver_step_cuda.gemv_route_launches.clear()
        out = fn()
        torch.cuda.synchronize(dev)
        counts = {name: wrapper.launches for name, wrapper in wrappers.items()}
        check(counts["gemm"] == 0, f"{label}: the GEMM ran {counts['gemm']} times")
        for name, count in counts.items():
            if count:
                solver_paths[name][label] = count
        if counts["quant_gemv"]:
            quant_routes[label] = dict(quant_gemv_cuda.route_launches)
        if solver_step_cuda.quant_route_launches:
            step_quant_routes[label] = dict(solver_step_cuda.quant_route_launches)
        if counts["gemv"]:
            gemv_routes[label] = dict(gemv_cuda.route_launches)
            check(sum(gemv_routes[label].values()) == counts["gemv"],
                  f"{label}: GEMV routes {gemv_routes[label]} for {counts['gemv']} launches")
        if solver_step_cuda.gemv_route_launches:
            step_gemv_routes[label] = dict(solver_step_cuda.gemv_route_launches)
        return out, counts

    def steps_match(steps: int, iters: int, shards: int, solves: int = 1) -> bool:
        """The fused step's calls on a device-loop path: one per iteration
        and shard, plus at most DEFAULT_CHUNK - 1 predicated-off ones a
        shard per solve (the masked tail of the last captured chunk)."""
        return (steps % shards == 0
                and iters * shards <= steps <= (iters + (DEFAULT_CHUNK - 1) * solves) * shards)

    def timed_solve(engine, **kw):
        """submit(op=...).result() on the host clock: the loop, its
        verification matvecs and the copy of x."""
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

    def ramp_diagonal(a) -> torch.Tensor:
        """Add 0..LOOP_CMP_RAMP along A's diagonal in place; return the
        diagonal as it was, for the caller to copy back."""
        diagonal = a.diagonal().clone()
        a.diagonal().add_(torch.linspace(0.0, LOOP_CMP_RAMP, a.shape[0], dtype=a.dtype,
                                         device=a.device))
        return diagonal

    def compare_loops(label, op, kern, strategy, mesh, a, b_dev, rtol, maxiter, iv) -> dict:
        """One configuration's device loop (what ``build_solver`` builds
        there) against its host-stepped loop: equal iterations, more than
        one chunk of them, and x, n_iters, residual_norm and converged
        bitwise; the device loop solves twice (the second solve replays
        only) and is timed on its second."""
        check(build_solver(op, get_strategy(strategy), mesh, dtype=torch.float32,
                           kernel=kern).loop == "device",
              f"{label}: build_solver does not build the device loop")
        a = placed_operand(get_strategy(strategy), mesh, a)  # one placement, one capture
        got = {}
        for loop in ("host", "device"):
            fn = _build_solver(op, get_strategy(strategy), mesh, loop, dtype=torch.float32,
                               kernel=kern)
            for _ in range(2 if loop == "device" else 1):
                torch.cuda.synchronize(dev)
                t0 = time.perf_counter()
                res = fn(a, b_dev, rtol, maxiter, *iv)
                n_iters = int(res.n_iters)
                torch.cuda.synchronize(dev)
                got[loop] = (res, n_iters, (time.perf_counter() - t0) * 1e3)
        (h, h_it, h_ms), (d, d_it, d_ms) = got["host"], got["device"]
        same = all(torch.equal(getattr(h, f), getattr(d, f))
                   for f in ("x", "n_iters", "residual_norm", "converged"))
        check(h_it == d_it and h_it > DEFAULT_CHUNK and same,
              f"{label}: the device loop ({d_it} iterations) differs from the "
              f"host-stepped one ({h_it}), or did not capture")
        return {"n_iters": h_it, "rtol": rtol, "maxiter": maxiter, "chunk": DEFAULT_CHUNK,
                "converged": bool(d.converged), "result_bitwise_equal": True,
                "host_ms": h_ms, "device_ms": d_ms,
                "host_ms_per_iter": h_ms / h_it, "device_ms_per_iter": d_ms / d_it}

    def rel_diff(x, ref) -> float:
        return ((x - ref).abs().max() / ref.abs().max()).item()

    def seeded_rhs(n):
        return torch.from_numpy(
            np.random.default_rng(args.seed + 1).standard_normal(n).astype(np.float32))

    # The recomputed residual may exceed the engine's fp32 one by the fp32
    # rounding of A x (about 1e-7 of |A|·|x| per element): 10% slack.
    residual_bound = 1.1 * SOLVER_RTOL

    # ---- 16. solver_step against its plain version ----
    section("16. solver_step against its plain version")
    solver_step_cuda.gemv_route_launches.clear()
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
    step_gemv_routes["solver_step_vs_plain"] = dict(solver_step_cuda.gemv_route_launches)
    check(set(step_gemv_routes["solver_step_vs_plain"]) == {"rows", "split"},
          f"the step's check shapes took GEMV routes {step_gemv_routes['solver_step_vs_plain']}")
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
    section("17. served solvers at 65536² fp32, rowwise, p=1, both tiers")
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
                check(steps_match(counts["solver_step"], res.n_iters, 1)
                      and counts["gemv"] == 2,
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

    # The device loop's captured chunks against the host-stepped loop on
    # both tiers, same A and b: equal iterations and the result bitwise. cg
    # on the ramped operand, capped (LOOP_CMP_RAMP); chebyshev on A itself
    # to convergence (the first chunk eager, then about 70 replays).
    b_dev = b.to(dev)
    loop_cmp = {}
    diagonal = ramp_diagonal(a)
    for tier, kern in (("torch", "cuda"), ("cuda_fused", "cuda_fused")):
        loop_cmp[f"cg_{tier}"] = compare_loops(
            f"cg {tier}", "cg", kern, "rowwise", mesh1, a, b_dev, LOOP_CMP_RTOL,
            LOOP_CMP_MAXITER, (0.0, 0.0))
    a.diagonal().copy_(diagonal)
    del diagonal
    for tier, kern in (("torch", "cuda"), ("cuda_fused", "cuda_fused")):
        loop_cmp[f"chebyshev_{tier}"] = compare_loops(
            f"chebyshev {tier}", "chebyshev", kern, "rowwise", mesh1, a, b_dev,
            CHEBYSHEV_RTOL, CHEBYSHEV_MAXITER, interval)
    emit({"phase": "solver_loop", "shape": [n, n], "dtype": "float32",
          "strategy": "rowwise", "mesh": list(mesh1.grid), "cg_diagonal_ramp": LOOP_CMP_RAMP,
          "solves": loop_cmp})
    del b_dev

    # ---- 18. fused cg from an int8c resident at 65536² fp32 ----
    section("18. fused cg from an int8c resident at 65536² fp32")
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
            check(steps_match(counts["solver_step"], res.n_iters, 1)
                  and counts["quant_gemv"] == 2,
                  f"{label}: launches {counts}, {res.n_iters} iterations")
            check(step_quant_routes.get(label) == {"wgmma_split": counts["solver_step"]},
                  f"{label}: the step's quantized GEMV took "
                  f"{step_quant_routes.get(label)}, planned wgmma_split")
        else:
            check(counts["solver_step"] == 0 and counts["quant_gemv"] > res.n_iters,
                  f"{label}: launches {counts}, {res.n_iters} iterations")
        q_x[tier] = res.x
        quant_solve[label] = {"n_iters": res.n_iters, "solve_ms": ms,
                              "ms_per_iter": ms / res.n_iters,
                              "residual_norm": res.residual_norm, "launches": counts,
                              "quant_routes": quant_routes.get(label, {}),
                              "step_quant_routes": step_quant_routes.get(label, {}),
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
    section("19. fused cg, colwise 32768² fp32 on 4 logical shards")
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
            check(steps_match(counts["solver_step"], res.n_iters, 4)
                  and counts["gemv"] == 2 * 4,
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
    # The captured chunks on 4 logical shards: colwise psum, both tiers, cg
    # on the ramped operand, capped.
    b_dev = b.to(dev)
    ramp_diagonal(a)
    loop_cmp = {f"cg_{tier}": compare_loops(
        f"colwise4 cg {tier}", "cg", kern, "colwise", mesh4, a, b_dev, LOOP_CMP_RTOL,
        LOOP_CMP_MAXITER, (0.0, 0.0)) for tier, kern in (("torch", "cuda"),
                                                         ("cuda_fused", "cuda_fused"))}
    emit({"phase": "solver_loop", "shape": [n, n], "dtype": "float32",
          "strategy": "colwise", "mesh": list(mesh4.grid), "shards_on_cuda0": 4,
          "cg_diagonal_ramp": LOOP_CMP_RAMP, "solves": loop_cmp})
    del a, b, b_dev, col_x
    torch.cuda.empty_cache()

    # ---- 20. run_serve_solver: 20 cg solves at 65536² fp32, both tiers ----
    section("20. run_serve_solver: 20 cg solves at 65536² fp32, both tiers")
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
                check(steps_match(counts["solver_step"], iters, 1, SOLVER_SERVE_SOLVES + 1),
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
    section("21. ring_gemv against its plain version")
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
    section("22. every combine through benchmark_strategy, 65536² bf16, 4 shards")
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
        res, calls = both_measures(strat, mesh, a, x, combine=combine, stages=stages)
        torch.cuda.synchronize(dev)
        peak_extra = torch.cuda.max_memory_allocated(dev) - base
        y = strat.build(mesh, kernel="cuda", combine=combine, stages=stages)(
            *strat.place(a, x, mesh))
        torch.cuda.synchronize(dev)
        launched = {"gemv": gemv_cuda.launches, "ring_gemv": ring_gemv_cuda.launches}
        label = f"{strategy}_{combine}" + (f"@{s}" if s else "")
        program_calls = calls["chain"] + calls["loop"] + 1  # + the check
        expect = {"gemv": program_calls * per_call,
                  "ring_gemv": program_calls if combine == "pallas_ring" else 0}
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
        times = measure_fields(res, calls)
        emit({"phase": "ring_main", "strategy": strategy, "combine": combine,
              "stages": s, "shape": [n, n], "dtype": "bfloat16", "mesh": list(mesh.grid),
              "shards_on_cuda0": p, "measure": "loop", "n_reps": N_REPS,
              "ms": times["loop"]["ms"], "chain_ms": times["chain"]["ms"],
              "bound_ms": times["bound_ms"],
              "share_of_bound": times["loop"]["share_of_bound"], "measures": times,
              "launches": launched, "launches_per_matvec": per_call or 1,
              "peak_bytes_beyond_a": peak_extra, "max_rel_err_vs_psum": rel,
              "rtol": 2 ** -7})
        del y
    del a, x, ref_y
    torch.cuda.empty_cache()

    # ---- 23. run_serve through pallas_ring and overlap@4 ----
    section("23. run_serve through pallas_ring and overlap@4")
    with tempfile.TemporaryDirectory() as tmp:
        mesh = ring_mesh("1d")
        p = mesh.size
        for combine, stages, n_requests in RING_SERVE_CONFIGS:
            label = combine + (f"@{stages}" if stages else "")
            snapshot = Path(tmp) / f"ring_{label}.json"
            gemv_cuda.launches = ring_gemv_cuda.launches = 0
            reset_gemm()
            res = run_serve("colwise", mesh, n, n, dtype="bfloat16", kernel="cuda",
                            combine=combine, stages=stages, max_bucket=SERVE_MAX_BUCKET,
                            promote=SERVE_PROMOTE, n_requests=n_requests,
                            seed=args.seed, metrics_out=str(snapshot))
            torch.cuda.synchronize(dev)
            launched = {"gemv": gemv_cuda.launches, "gemm": gemm_cuda.launches,
                        "ring_gemv": ring_gemv_cuda.launches}
            launches_by_path["gemm"][f"serve_ring_{label}"] = launched["gemm"]
            gemm_routes[f"serve_ring_{label}"] = dict(gemm_cuda.route_launches)
            check(set(gemm_routes[f"serve_ring_{label}"]) == {"wgmma_tma"},
                  f"serve {label}: GEMM routes {gemm_routes[f'serve_ring_{label}']}")
            dispatches, captures = engine_runs(snapshot)
            runs = dispatches + captures  # each capture runs its program once first
            if combine == "pallas_ring":
                # Vectors through the ring kernel, promoted blocks through
                # the GEMM on each shard (the default batched psum).
                ok = (launched["gemv"] == 0 and launched["ring_gemv"] > 0
                      and launched["gemm"] > 0 and launched["gemm"] % p == 0
                      and launched["ring_gemv"] + launched["gemm"] // p == runs)
                ring_launches[f"serve_{label}"] = launched["ring_gemv"]
            else:
                cells = p * p * stages  # per dispatch, vector or block
                ok = (launched["ring_gemv"] == 0 and launched["gemv"] > 0
                      and launched["gemm"] > 0
                      and launched["gemv"] + launched["gemm"] == runs * cells)
            check(ok, f"serve {label}: launches {launched}, {dispatches} dispatches, "
                  f"{captures} captures")
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

    # ---- 24. flash_attention against its plain version ----
    section("24. flash_attention against its plain version")
    def flash_operands(h, sq, sk, d, kdt, q_off, k_off):
        """Pre-scaled standard normal q (fp32), k and v in ``kdt``, and
        global positions starting at the offsets."""
        q = torch.randn((h, sq, d), generator=gen, device=dev) * d ** -0.5
        k, v = (torch.randn((h, sk, d), generator=gen, device=dev).to(kdt)
                for _ in range(2))
        q_pos = torch.arange(sq, dtype=torch.int32, device=dev) + q_off
        k_pos = torch.arange(sk, dtype=torch.int32, device=dev) + k_off
        return q, k, v, q_pos, k_pos

    def flash_check(operands, causal, what):
        """The kernel twice and the plain partial once: bitwise repeatable,
        the same non-finite entries (m = -inf on fully masked rows), and
        o, m, l within rtol = atol = FLASH_TOL. Returns the errors, the
        kernel's partial and the plain one."""
        a, b = (flash_partial_cuda(*operands, causal), flash_partial_cuda(*operands, causal))
        ref = flash_partial_plain(*operands, causal=causal)
        torch.cuda.synchronize(dev)
        check(all(torch.equal(x, y) for x, y in zip(a, b)), f"flash {what}: two runs differ")
        err = {}
        for name, x, r in zip(("o", "m", "l"), a, ref):
            fin = torch.isfinite(r)
            check(torch.equal(torch.isfinite(x), fin) and torch.equal(x[~fin], r[~fin]),
                  f"flash {what}: the non-finite entries of {name} differ")
            dx = (x[fin] - r[fin]).abs()
            excess = (dx - FLASH_TOL * r[fin].abs()).max().item() if dx.numel() else 0.0
            check(excess <= FLASH_TOL, f"flash {what}: {name} beyond rtol = atol = {FLASH_TOL}")
            err[name] = dx.max().item() if dx.numel() else 0.0
        return ({"max_abs_err": max(err.values()), "max_abs_err_by_output": err,
                 "rtol": FLASH_TOL, "atol": FLASH_TOL}, a, ref)

    def unmasked_pairs(q_pos, k_pos, causal) -> int:
        if not causal:
            return q_pos.numel() * k_pos.numel()
        k_sorted = torch.sort(k_pos).values
        return int(torch.searchsorted(k_sorted, q_pos, right=True).sum().item())

    def sdpa_call(q, k, v, causal, dtype):
        """The library yardstick: one scaled_dot_product_attention call on
        (1, h, s, d) in ``dtype`` (normalized output, not a partial), under
        the first backend that takes it, in PyTorch's order."""
        from torch.nn.attention import SDPBackend, sdpa_kernel

        qq, kk, vv = (x.to(dtype)[None] for x in (q, k, v))
        for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
                        SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH):
            def call(backend=backend):
                with sdpa_kernel([backend]):
                    return torch.nn.functional.scaled_dot_product_attention(
                        qq, kk, vv, is_causal=causal, scale=1.0)
            try:
                with warnings.catch_warnings():  # each refusal also warns
                    warnings.simplefilter("ignore")
                    call()
                torch.cuda.synchronize(dev)
            except RuntimeError:
                continue
            return call, backend.name
        raise RuntimeError("no scaled_dot_product_attention backend ran")

    flash_at = {}
    for h, sq, sk, d, q_off, k_off in FLASH_CHECK_SHAPES:
        big = sq >= 4096
        for name in ("float32", "bfloat16"):
            for causal in (False, True) if k_off <= sq else (True,):
                what = f"{h}x{sq}x{sk}x{d} {name} causal={causal} q+{q_off} k+{k_off}"
                operands = flash_operands(h, sq, sk, d, torch_dtype(name), q_off, k_off)
                route = flash_route(torch_dtype(name), d)
                before = flash_partial_cuda.route_launches[route]
                err, (o, m, l), plain = flash_check(operands, causal, what)
                check(flash_partial_cuda.route_launches[route] == before + 2,
                      f"flash {what}: the kernel did not take its planned route {route}")
                line = {"phase": "flash_vs_plain", "kernel": "flash_attention",
                        "shape": [h, sq, sk, d], "kv_dtype": name, "causal": causal,
                        "q_offset": q_off, "k_offset": k_off, "route": route,
                        "bitwise_repeatable": True, **err}
                if (h, sq) == (8, 4096):
                    # Rows 37:203 alone: bitwise the full call's rows.
                    q, k, v, q_pos, k_pos = operands
                    part = flash_partial_cuda(q[:, 37:203], k, v, q_pos[37:203], k_pos,
                                              causal)
                    torch.cuda.synchronize(dev)
                    check(all(torch.equal(x, y[:, 37:203]) for x, y in zip(part, (o, m, l))),
                          f"flash {what}: rows 37:203 alone differ from the full call's")
                    line["row_slice_bitwise"] = [37, 203]
                    del part
                if k_off > sq:
                    check(bool(torch.isneginf(m).all()) and bool((l == 0).all())
                          and bool(torch.isfinite(o).all()),
                          f"flash {what}: fully masked rows not (m=-inf, l=0, finite o)")
                    line["fully_masked_rows"] = "m=-inf, l=0, o finite"
                if big:
                    q, k, v, q_pos, k_pos = operands
                    nbytes = (8 * h * sq * d + 2 * h * sk * d * k.element_size()
                              + 8 * h * sq + 4 * (sq + sk))
                    pairs = unmasked_pairs(q_pos, k_pos, causal)
                    bytes_ms = nbytes / (H100_HBM_PEAK_GBPS * 1e9) * 1e3
                    # The least time of the work: its 4·d flops per unmasked
                    # pair once at the tensor cores' peak. split3_ceiling_ms
                    # is the wgmma_split design's ceiling (three bf16 passes
                    # per product), ffma_bound_ms the ffma route's (fp32 FFMA).
                    ops_ms = 4 * h * d * pairs / TENSOR_PEAK_FLOPS * 1e3
                    split3_ms = FLASH_SPLIT_PASSES * ops_ms
                    ffma_ms = 4 * h * d * pairs / FP32_PEAK_FLOPS * 1e3
                    times = {
                        "ms": event_ms(lambda: flash_partial_cuda(*operands, causal), reps=10),
                        "plain_ms": event_ms(
                            lambda: flash_partial_plain(*operands, causal=causal), reps=3,
                            warmup=1),
                    }
                    diagonal = causal and q_off == k_off and sq == sk
                    if not causal or diagonal:
                        call, backend = sdpa_call(q, k, v, causal, torch.float32)
                        times["library_ms"] = event_ms(call, reps=10)
                        times["library_backend"] = backend
                        call, backend = sdpa_call(q, k, v, causal, k.dtype)
                        times[f"library_{name}_ms"] = event_ms(call, reps=10)
                        times[f"library_{name}_backend"] = backend
                    bound = max(bytes_ms, ops_ms)
                    split3 = max(bytes_ms, split3_ms)
                    ffma_bound = max(bytes_ms, ffma_ms)
                    times.update({
                        "route": route, "bound_ms": bound,
                        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                        "split3_ceiling_ms": split3, "ffma_bound_ms": ffma_bound,
                        "share_of_bound": bound / times["ms"],
                        "share_of_split3_ceiling": split3 / times["ms"],
                        "share_of_ffma_bound": ffma_bound / times["ms"],
                        "unmasked_pairs": pairs})
                    key = f"{h}x{sq}x{sk}x{d}_{name}_causal"
                    if causal and f"{key}0" in flash_at:
                        times["share_of_noncausal_ms"] = (
                            times["ms"] / flash_at[f"{key}0"]["ms"])
                    flash_at[f"{key}{int(causal)}"] = {**times, **err}
                    line.update(times)
                emit(line)
                del operands, o, m, l, plain
            torch.cuda.empty_cache()

    # ---- 25. ring and Ulysses attention at full width, 2x2 logical mesh ----
    section("25. ring and Ulysses attention at full width, 2x2 logical mesh")
    att_mesh = make_mesh(4, devices=[dev] * 4)
    flash_launches, flash_routes = {}, {}

    def reset_flash() -> None:
        flash_partial_cuda.launches = 0
        flash_partial_cuda.route_launches.clear()

    def record_flash(path: str, route: str) -> None:
        """The path's kernel launches since reset_flash(), all on ``route``:
        bf16 inputs take wgmma_split, fp32 inputs ffma."""
        flash_launches[path] = flash_partial_cuda.launches
        flash_routes[path] = dict(flash_partial_cuda.route_launches)
        check(flash_routes[path] == {route: flash_launches[path]},
              f"{path}: flash launches by route {flash_routes[path]}, expected all "
              f"{flash_launches[path]} on {route}")
    att_launches = {"ring": 16, "ulysses": 4}  # 4 shards x 4 hops; 4 local steps
    builders = {"ring": build_ring_attention, "ulysses": build_ulysses_attention}

    def att_inputs(s, dtype):
        return [torch.randn((s, ATT_H, ATT_D), generator=gen, device=dev).to(dtype)
                for _ in range(3)]

    def allclose_excess(got, want, tol) -> float:
        """max(|got - want| - tol·|want|): within tolerance iff <= tol."""
        return ((got - want).abs() - tol * want.abs()).max().item()

    qkv = att_inputs(ATT_S, torch.bfloat16)
    for schedule, build in builders.items():
        for causal in (False, True):
            outs, walls = {}, {}
            for kernel in ("xla", "flash"):
                fn = build(att_mesh, causal=causal, gather_output=True, kernel=kernel)
                reset_flash()
                torch.cuda.synchronize(dev)
                t0 = time.perf_counter()
                with torch.no_grad():
                    outs[kernel] = fn(*qkv)
                torch.cuda.synchronize(dev)
                walls[kernel] = (time.perf_counter() - t0) * 1e3
                launched = flash_partial_cuda.launches
                expect = att_launches[schedule] if kernel == "flash" else 0
                check(launched == expect,
                      f"{schedule} {kernel} causal={causal}: {launched} kernel launches, "
                      f"expected {expect}")
                if kernel == "flash":
                    record_flash(f"{schedule}_causal{int(causal)}", "wgmma_split")
                o = outs[kernel]
                check(tuple(o.shape) == (ATT_S, ATT_H, ATT_D) and o.dtype == torch.float32
                      and bool(torch.isfinite(o).all()),
                      f"{schedule} {kernel}: not {ATT_S}x{ATT_H}x{ATT_D} finite fp32 values")
            excess = allclose_excess(outs["flash"], outs["xla"], 2e-4)
            check(excess <= 2e-4, f"{schedule} causal={causal}: flash differs from xla "
                  "beyond 2e-4")
            emit({"phase": "attention_main", "schedule": schedule, "causal": causal,
                  "shape": [ATT_S, ATT_H, ATT_D], "dtype": "bfloat16",
                  "mesh": list(att_mesh.grid), "shards_on_cuda0": att_mesh.size,
                  "xla_wall_ms": walls["xla"], "flash_wall_ms": walls["flash"],
                  "launches": att_launches[schedule],
                  "flash_route_launches": flash_routes[f"{schedule}_causal{int(causal)}"],
                  "max_abs_diff_flash_vs_xla": (outs["flash"] - outs["xla"]).abs().max().item(),
                  "rtol": 2e-4, "atol": 2e-4})
            del outs
            torch.cuda.empty_cache()
    del qkv

    # Both schedules at a length whose blocks the JAX package's predicate
    # refuses: on the card the flash tier still runs the kernel on every
    # block, never the plain partial.
    s_r, p_r = ATT_REFUSED_S, att_mesh.size
    check(not flash_path_available(s_r // p_r, s_r // p_r, ATT_D)
          and not flash_path_available(s_r, s_r, ATT_D),
          f"s = {s_r}: JAX's predicate takes a block; pick a length it refuses")
    qkv = att_inputs(s_r, torch.bfloat16)
    for schedule, build in builders.items():
        for causal in (False, True):
            outs = {}
            for kernel in ("xla", "flash"):
                reset_flash()
                with torch.no_grad():
                    outs[kernel] = build(att_mesh, causal=causal, gather_output=True,
                                         kernel=kernel)(*qkv)
                torch.cuda.synchronize(dev)
                launched = flash_partial_cuda.launches
                expect = att_launches[schedule] if kernel == "flash" else 0
                check(launched == expect,
                      f"{schedule} {kernel} causal={causal} s={s_r}: {launched} kernel "
                      f"launches, expected {expect}")
                check(bool(torch.isfinite(outs[kernel]).all()),
                      f"{schedule} {kernel} s={s_r}: non-finite output")
            record_flash(f"{schedule}_refused_s{s_r}_causal{int(causal)}", "wgmma_split")
            excess = allclose_excess(outs["flash"], outs["xla"], 2e-4)
            check(excess <= 2e-4, f"{schedule} causal={causal} s={s_r}: flash differs "
                  "from xla beyond 2e-4")
            emit({"phase": "attention_refused_shape", "schedule": schedule,
                  "causal": causal, "shape": [s_r, ATT_H, ATT_D], "dtype": "bfloat16",
                  "mesh": list(att_mesh.grid), "jax_predicate_takes_block": False,
                  "launches": att_launches[schedule],
                  "max_abs_diff_flash_vs_xla": (outs["flash"] - outs["xla"]).abs().max().item(),
                  "rtol": 2e-4, "atol": 2e-4})
            del outs
    del qkv
    torch.cuda.empty_cache()

    # The xla tier on fp32 inputs against the fp64 dense oracle, head by head.
    q32, k32, v32 = att_inputs(ATT_S, torch.float32)
    for causal in (False, True):
        with torch.no_grad():
            outs = {name: build(att_mesh, causal=causal, gather_output=True)(q32, k32, v32)
                    for name, build in builders.items()}
        worst = {name: 0.0 for name in outs}
        for head in range(ATT_H):
            q64, k64, v64 = (x[:, head].double() for x in (q32, k32, v32))
            w = (q64 @ k64.T) / ATT_D ** 0.5
            if causal:
                w.masked_fill_(torch.ones(ATT_S, ATT_S, dtype=torch.bool,
                                          device=dev).triu_(1), -torch.inf)
            w -= w.amax(dim=1, keepdim=True)
            w.exp_()
            w /= w.sum(dim=1, keepdim=True)
            oracle = w @ v64
            del w
            for name, o in outs.items():
                worst[name] = max(worst[name],
                                  allclose_excess(o[:, head].double(), oracle, 2e-5))
        for name in outs:
            check(worst[name] <= 2e-5, f"{name} xla causal={causal}: fp32 output beyond "
                  "2e-5 of the fp64 dense oracle")
        emit({"phase": "attention_oracle", "schedules": sorted(outs), "causal": causal,
              "shape": [ATT_S, ATT_H, ATT_D], "dtype": "float32", "kernel": "xla",
              "oracle": "fp64 dense, head by head", "rtol": 2e-5, "atol": 2e-5,
              "max_excess_by_schedule": worst})
        del outs
        torch.cuda.empty_cache()

    # Both flash schedules at head dims the kernel pads (16 and 64: zero
    # columns to 128), fp32 inputs, against the fp64 dense oracle at 2e-5 as
    # the JAX package's test holds its flash ring at d_head = 16.
    s_small_d = 1024
    for d_small in (16, 64):
        qs, ks, vs = (torch.randn((s_small_d, 4, d_small), generator=gen, device=dev)
                      for _ in range(3))
        worst = {}
        for schedule, build in builders.items():
            reset_flash()
            with torch.no_grad():
                o = build(att_mesh, causal=True, gather_output=True, kernel="flash")(
                    qs, ks, vs)
            torch.cuda.synchronize(dev)
            check(flash_partial_cuda.launches == att_launches[schedule],
                  f"{schedule} flash d_head={d_small}: {flash_partial_cuda.launches} launches")
            record_flash(f"{schedule}_d{d_small}", "ffma")
            worst[schedule] = 0.0
            for head in range(4):
                q64, k64, v64 = (t[:, head].double() for t in (qs, ks, vs))
                w = (q64 @ k64.T) / d_small ** 0.5
                w.masked_fill_(torch.ones(s_small_d, s_small_d, dtype=torch.bool,
                                          device=dev).triu_(1), -torch.inf)
                w = torch.softmax(w, dim=1)
                worst[schedule] = max(worst[schedule],
                                      allclose_excess(o[:, head].double(), w @ v64, 2e-5))
            check(worst[schedule] <= 2e-5, f"{schedule} flash d_head={d_small}: beyond "
                  "2e-5 of the fp64 oracle")
        emit({"phase": "attention_small_head", "d_head": d_small,
              "shape": [s_small_d, 4, d_small], "dtype": "float32", "causal": True,
              "kernel": "flash", "padded_head_dim": 128, "mesh": list(att_mesh.grid),
              "oracle": "fp64 dense, head by head", "rtol": 2e-5, "atol": 2e-5,
              "max_excess_by_schedule": worst})
    del qs, ks, vs, o

    # The multichip dryrun's attention checks (__graft_entry__.py), on the
    # 2x2 mesh of cuda:0: causal single-head ring against a numpy oracle at
    # 1e-4, then the flash tier against the xla tier at d_head = 128.
    s_small, d_small = att_mesh.size * 4, 8
    rng = np.random.default_rng(args.seed)
    qn, kn, vn = (rng.standard_normal((s_small, d_small)).astype(np.float32)
                  for _ in range(3))
    o = build_ring_attention(att_mesh, causal=True, gather_output=True)(
        *(torch.from_numpy(x).to(dev) for x in (qn, kn, vn)))
    scores = (qn.astype(np.float64) @ kn.astype(np.float64).T) / np.sqrt(d_small)
    scores = np.where(np.tril(np.ones((s_small, s_small), bool)), scores, -np.inf)
    w = np.exp(scores - scores.max(axis=1, keepdims=True))
    oracle = (w / w.sum(axis=1, keepdims=True)) @ vn.astype(np.float64)
    np.testing.assert_allclose(o.cpu().numpy(), oracle, rtol=1e-4, atol=1e-4)
    sf = att_mesh.size * 128
    qf, kf, vf = (torch.from_numpy(rng.standard_normal((sf, 128)).astype(np.float32)).to(dev)
                  for _ in range(3))
    o_xla = build_ring_attention(att_mesh, causal=True, gather_output=True)(qf, kf, vf)
    reset_flash()
    o_flash = build_ring_attention(att_mesh, causal=True, gather_output=True,
                                   kernel="flash")(qf, kf, vf)
    torch.cuda.synchronize(dev)
    check(flash_partial_cuda.launches == 16, "dryrun flash ring: launches "
          f"{flash_partial_cuda.launches}, expected 16")
    record_flash("dryrun_ring", "ffma")
    np.testing.assert_allclose(o_flash.cpu().numpy(), o_xla.cpu().numpy(), rtol=1e-4,
                               atol=1e-4)
    emit({"phase": "attention_dryrun", "mesh": list(att_mesh.grid),
          "causal_ring_vs_numpy": {"shape": [s_small, d_small], "rtol": 1e-4},
          "flash_vs_xla": {"shape": [sf, 128], "rtol": 1e-4,
                           "max_abs_diff": (o_flash - o_xla).abs().max().item()}})

    # ---- 26. a gradient step through the flash ring on the card ----
    section("26. a gradient step through the flash ring on the card")
    leaves = att_inputs(ATT_GRAD_S, torch.float32)
    grads = {}
    for kernel in ("xla", "flash"):
        xs = [x.clone().requires_grad_(True) for x in leaves]
        reset_flash()
        o = build_ring_attention(att_mesh, causal=True, gather_output=True,
                                 kernel=kernel)(*xs)
        grads[kernel] = torch.autograd.grad((o ** 2).sum(), xs)
        torch.cuda.synchronize(dev)
        if kernel == "flash":
            check(flash_partial_cuda.launches == 16,
                  f"flash ring gradient: {flash_partial_cuda.launches} launches")
            record_flash("ring_grad", "ffma")
        del o, xs
    excess = max(allclose_excess(f, x, 1e-4) for f, x in zip(grads["flash"], grads["xla"]))
    check(excess <= 1e-4, "flash ring gradients differ from the xla ring's beyond 1e-4")
    emit({"phase": "attention_grad", "schedule": "ring", "causal": True,
          "shape": [ATT_GRAD_S, ATT_H, ATT_D], "dtype": "float32", "loss": "sum(o^2)",
          "max_abs_diff_by_input": [(f - x).abs().max().item()
                                    for f, x in zip(grads["flash"], grads["xla"])],
          "rtol": 1e-4, "atol": 1e-4})
    del grads, leaves
    torch.cuda.empty_cache()

    # What a gradient costs at full length: the wall time and the peak of
    # device memory above the inputs of one forward and backward through
    # each tier's ring on fp32 inputs (the flash backward recomputes each
    # hop's block in fp32; the xla tier keeps every hop's tiles for autograd).
    leaves = att_inputs(ATT_S, torch.float32)
    cost = {}
    for kernel in ("xla", "flash"):
        xs = [x.clone().requires_grad_(True) for x in leaves]
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        reset_flash()
        t0 = time.perf_counter()
        o = build_ring_attention(att_mesh, causal=True, gather_output=True,
                                 kernel=kernel)(*xs)
        g = torch.autograd.grad((o ** 2).sum(), xs)
        torch.cuda.synchronize(dev)
        wall_ms = (time.perf_counter() - t0) * 1e3
        check(all(bool(torch.isfinite(x).all()) for x in g),
              f"{kernel} ring gradient at s={ATT_S}: non-finite")
        if kernel == "flash":
            check(flash_partial_cuda.launches == 16,
                  f"flash ring gradient at s={ATT_S}: {flash_partial_cuda.launches} launches")
            record_flash(f"ring_grad_s{ATT_S}", "ffma")
        cost[kernel] = {"wall_ms": wall_ms,
                        "peak_mib": (torch.cuda.max_memory_allocated(dev) - base) / 2 ** 20}
        del o, g, xs
        torch.cuda.empty_cache()
    emit({"phase": "attention_grad_cost", "schedule": "ring", "causal": True,
          "shape": [ATT_S, ATT_H, ATT_D], "dtype": "float32", "loss": "sum(o^2)",
          "mesh": list(att_mesh.grid), "one_shot": True, **cost})
    del leaves

    # ---- 27. the attention study, 2x2 logical mesh ----
    section("27. the attention study, 2x2 logical mesh")
    reset_flash()
    rows = run_attention_study(att_mesh, ATT_STUDY_SEQS, heads=ATT_H, d_head=ATT_D,
                               dtype="bfloat16", causal=False, n_reps=4,
                               seed=args.seed, samples=3)
    torch.cuda.synchronize(dev)
    record_flash("study", "wgmma_split")
    check(flash_partial_cuda.launches > 0, "the study launched no flash kernel")
    for row in rows:
        check(not row["refused"], f"study s={row['s']}: JAX's predicate refuses "
              f"{row['refused']}")
        check(all(row[c] for c in ATTENTION_COLUMNS), f"study s={row['s']}: unmeasurable")
        emit({"phase": "attention_study", "s": row["s"], "heads": ATT_H, "d_head": ATT_D,
              "dtype": "bfloat16", "causal": False, "mesh": list(att_mesh.grid),
              "measure": "loop", "n_reps": 4, "samples": 3,
              **{f"{c}_ms": row[c]["ms"] for c in ATTENTION_COLUMNS},
              "refused": sorted(row["refused"])})
    print(attention_report(rows, att_mesh, heads=ATT_H, d_head=ATT_D, dtype="bfloat16",
                           causal=False, n_reps=4), flush=True)
    torch.cuda.empty_cache()

    # ---- 28. graphs: every kernel route captured and replayed ----
    section("28. graphs: every kernel route captured and replayed")
    # Each route's call captured as a CUDA graph (one eager launch first),
    # replayed, and held bitwise equal to the eager launch on the same
    # inputs; the wrapper's count grows by one a replay, none for the
    # capture. The small head dims also against the plain partial.
    def flat(out):
        return [t for item in (out if isinstance(out, (tuple, list)) else [out])
                for t in (item if isinstance(item, (tuple, list)) else [item])]

    graph_routes = []

    def graph_check(kernel, route, call, wrapper):
        eager = flat(call())
        graph, outs = capture(call, dev)
        routes = getattr(wrapper, "route_launches", None)
        before = wrapper.launches, (routes[route] if routes is not None else 0)
        graph.replay(2)
        torch.cuda.synchronize(dev)
        check(wrapper.launches == before[0] + 2,
              f"graphs {kernel} {route}: {wrapper.launches - before[0]} launches for 2 replays")
        check(routes is None or routes[route] == before[1] + 2,
              f"graphs {kernel}: the replays were not on {route}")
        same = all(torch.equal(g, e) for g, e in zip(flat(outs), eager))
        check(same, f"graphs {kernel} {route}: a replay differs from the eager launch")
        graph_routes.append({"kernel": kernel, "route": route, "bitwise_equal": same})

    f32, bf16 = torch.float32, torch.bfloat16
    for m, k, route in ((4096, 4096, "rows"), (120, 60000, "split")):
        a_g, x_g = uniform((m, k), f32), uniform((k,), f32)
        check(gemv_plan(m, k, f32, f32, sms).route == route, f"gemv {m}x{k}: not {route}")
        graph_check("gemv", route, lambda: gemv_cuda(a_g, x_g), gemv_cuda)
    for (m, k, n_), dtype, route in (((4096, 4096, 64), bf16, "wgmma_tma"),
                                     ((1000, 3001, 16), bf16, "mma_sync"),
                                     ((2048, 2048, 32), f32, "ffma"),
                                     ((1024, 1024, 16), torch.float64, "dfma")):
        a_g, b_g = uniform((m, k), dtype), uniform((k, n_), dtype)
        check(gemm_plan(a_g, b_g).route == route, f"gemm {m}x{k}x{n_}: not {route}")
        graph_check("gemm", route, lambda: gemm_cuda(a_g, b_g), gemm_cuda)
    for xdt, route in ((bf16, "wgmma"), (f32, "wgmma_split"), (torch.float64, "fma")):
        # The payload of an A in x's dtype, the dtype the kernel takes x in.
        qa = quantize_matrix((uniform((4096, 4096), f32) - 5).to(xdt), "int8")
        x_g = (uniform((4096,), f32) - 5).to(xdt)
        check(quant_route("int8", xdt, 4096, 4096, 1, qa.block, payload_aligned(qa))
              == route, f"quant_gemv {xdt}: not on {route}")
        graph_check("quant_gemv", route, lambda: quant_gemv_cuda(qa, x_g), quant_gemv_cuda)
    a_g = uniform((4096, 4096), f32)
    for op in SOLVER_OPS_FUSED:
        inputs = step_inputs(op, 4096, f32, kf=1.0)
        graph_check("solver_step", op, lambda: solver_step_cuda(op, a_g, 0, *inputs),
                    solver_step_cuda)
    a_g, x_g = uniform((4096, 4096), bf16), uniform((4096,), bf16)
    for p_ring in (2, 4, 8):
        panels, segs = ring_operands(a_g, x_g, p_ring)
        graph_check("ring_gemv", f"p{p_ring}", lambda: ring_gemv_cuda(panels, segs),
                    ring_gemv_cuda)
    del qa, a_g, x_g, panels, segs
    flash_graph = {}
    for kdt, d, route in ((bf16, 128, "wgmma_split"), (f32, 128, "ffma"),
                          (bf16, 16, "wgmma_split"), (bf16, 64, "wgmma_split"),
                          (f32, 64, "ffma")):
        ops_g = flash_operands(2, 256, 512, d, kdt, 96, 0)
        check(flash_route(kdt, d) == route, f"flash {kdt} d={d}: not {route}")
        err, _, _ = flash_check(ops_g, True, f"graphs d={d} {kdt}")
        graph_check("flash_attention", route, lambda: flash_partial_cuda(*ops_g, True),
                    flash_partial_cuda)
        flash_graph[f"{route}_d{d}_{str(kdt).split('.')[-1]}"] = err
    emit({"phase": "graphs", "routes": graph_routes,
          "flash_small_head_vs_plain": flash_graph})
    torch.cuda.empty_cache()

    # ---- 29. reshard: every pair at 65536² bf16 on 4 logical shards ----
    section("29. reshard: every pair at 65536² bf16 on 4 logical shards")
    from matvec_mpi_multiplier_torch.models.base import shard_operand
    from matvec_mpi_multiplier_torch.ops.quantize import dequantize
    from matvec_mpi_multiplier_torch.parallel.reshard import (
        RESHARD_STRATEGIES,
        build_reshard,
        copy_bytes,
        reshard_program,
    )

    rs_mesh = make_mesh(4, devices=[dev] * 4)
    n = RESHARD_N
    a = uniform((n, n), torch.bfloat16)
    payload = a.numel() * a.element_size()
    reshard_at = {}
    for src in RESHARD_STRATEGIES:
        for dst in RESHARD_STRATEGIES:
            if src == dst:
                continue
            steps = reshard_program(src, dst, *rs_mesh.grid)
            src_st = shard(a, get_strategy(src).specs(rs_mesh)[0], rs_mesh)
            migrate = build_reshard(rs_mesh, src, dst)
            times, peaks = [], []
            for _ in range(3):
                out = None
                torch.cuda.synchronize(dev)
                before = torch.cuda.memory_allocated(dev)
                torch.cuda.reset_peak_memory_stats(dev)
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                out = migrate(src_st)
                end.record()
                torch.cuda.synchronize(dev)
                times.append(start.elapsed_time(end))
                peaks.append(torch.cuda.max_memory_allocated(dev) - before)
                if len(times) < 3:
                    del out
            moved = copy_bytes(rs_mesh, src, dst, src_st)
            ref = shard(a, get_strategy(dst).specs(rs_mesh)[0], rs_mesh)
            check(all(torch.equal(o, r) for o, r in zip(out.shards, ref.shards)),
                  f"reshard {src}->{dst}: a shard differs from shard() in {dst}")
            a2a = sum(1 for s in steps if s[0] == "a2a")
            # A ppermute among shards of one card reorders them: no bytes.
            check(moved == a2a * payload,
                  f"reshard {src}->{dst}: {moved} bytes copied, expected {a2a} x {payload}")
            bound_ms = 2 * moved / (probe_gbps * 1e9) * 1e3
            reshard_at[f"{src}->{dst}"] = {
                "steps": [list(s) for s in steps], "ms": min(times),
                "samples_ms": times, "bytes_moved": moved, "bound_ms": bound_ms,
                "share_of_bound": bound_ms / min(times),
                "peak_bytes_beyond_resident": max(peaks)}
            emit({"phase": "reshard", "pair": f"{src}->{dst}", "shape": [n, n],
                  "dtype": "bfloat16", "mesh": list(rs_mesh.grid), "shards_on_cuda0": 4,
                  "bitwise_vs_shard": True, **reshard_at[f"{src}->{dst}"]})
            del src_st, out, ref
            torch.cuda.empty_cache()
    del a
    torch.cuda.empty_cache()

    # ---- 30. engine reshard: traffic, rowwise -> blockwise -> rowwise ----
    section("30. engine reshard: traffic, rowwise -> blockwise -> rowwise")
    rs_widths = [w for w in DEFAULT_WIDTH_MIX if w <= SERVE_MAX_BUCKET]
    rs_pool = _request_pool(n, rs_widths, torch.bfloat16, seed=args.seed + 1)
    rs_sequence = rs_widths + [int(w) for w in np.random.default_rng(args.seed + 2).choice(
        rs_widths, size=RESHARD_REQUESTS - len(rs_widths))]

    def rs_engine(strategy):
        a = resident_matrix(n, n, torch.bfloat16, dev, args.seed + 30)
        return MatvecEngine(a, rs_mesh, strategy=strategy, kernel="cuda",
                            max_bucket=SERVE_MAX_BUCKET, promote=SERVE_PROMOTE)

    def traffic(engine) -> list:
        return [engine.submit(rs_pool[w]).result() for w in rs_sequence]

    rs_want = {}
    for strategy in ("rowwise", "blockwise"):
        fresh = rs_engine(strategy)
        rs_want[strategy] = traffic(fresh)
        del fresh
        torch.cuda.empty_cache()
    panel = n * n * 2 // 4
    gemv_cuda.launches = 0
    gemv_cuda.route_launches.clear()
    reset_gemm()
    eng = rs_engine("rowwise")  # the caller keeps no reference to A
    eng.warmup(widths=rs_widths)
    check(all(torch.equal(g, w) for g, w in zip(traffic(eng), rs_want["rowwise"])),
          "engine reshard: rowwise traffic differs from a fresh rowwise engine")
    rs_steps = []
    for dst in ("blockwise", "rowwise"):
        src = eng.strategy.name
        torch.cuda.synchronize(dev)
        mem_before = torch.cuda.memory_allocated(dev)
        # The fence on the card: dispatches queued on the old layout just
        # before the commit must give the old layout's answers.
        queued = [eng.submit(rs_pool[SERVE_MAX_BUCKET]), eng.submit(rs_pool[1])]
        pending = not all(f.done() for f in queued)
        t0 = time.perf_counter()
        res = eng.reshard(dst, warm_widths=rs_widths)
        reshard_s = time.perf_counter() - t0
        torch.cuda.synchronize(dev)
        mem_after = torch.cuda.memory_allocated(dev)
        want_src = rs_want[src]
        for fut, w in zip(queued, (SERVE_MAX_BUCKET, 1)):
            got = fut.result()
            check(torch.equal(got, want_src[rs_sequence.index(w)]),
                  f"engine reshard {src}->{dst}: a dispatch queued before the "
                  f"commit (width {w}) is wrong")
        check(mem_after <= mem_before + panel,
              f"engine reshard {src}->{dst}: {mem_after - mem_before} bytes more "
              f"allocated after the commit (one panel is {panel})")
        compiles = eng.stats.compiles
        results = traffic(eng)
        check(eng.stats.compiles == compiles,
              f"engine reshard {src}->{dst}: {eng.stats.compiles - compiles} steady builds")
        check(all(torch.equal(g, w) for g, w in zip(results, rs_want[dst])),
              f"engine reshard {src}->{dst}: traffic differs from a fresh {dst} engine")
        step = {"pair": f"{src}->{dst}", "summary": res, "reshard_s": reshard_s,
                "queued_in_flight_at_commit": pending,
                "memory_before": mem_before, "memory_after": mem_after, "panel": panel,
                "compiles_steady": 0, "dropped_total": eng.stats.dropped}
        rs_steps.append(step)
    torch.cuda.synchronize(dev)
    rs_launched = {"gemv": gemv_cuda.launches, "gemm": gemm_cuda.launches}
    check(rs_launched["gemv"] > 0 and rs_launched["gemm"] > 0,
          f"engine reshard launched {rs_launched}")
    for kernel_name, count in rs_launched.items():
        launches_by_path[kernel_name]["engine_reshard"] = count
    gemv_routes["engine_reshard"] = dict(gemv_cuda.route_launches)
    gemm_routes["engine_reshard"] = dict(gemm_cuda.route_launches)
    emit({"phase": "engine_reshard", "shape": [n, n], "dtype": "bfloat16",
          "mesh": list(rs_mesh.grid), "requests_per_layout": len(rs_sequence),
          "steps": rs_steps, "bitwise_vs_fresh": True, "launches": rs_launched})
    del eng, rs_want
    torch.cuda.empty_cache()

    # ---- 31. quantized reshard: int8c, retain_host ----
    section("31. quantized reshard: int8c, retain_host")
    quant_gemv_cuda.launches = 0
    a = uniform((n, n), torch.float32)
    qeng = MatvecEngine(a, rs_mesh, strategy="rowwise", kernel="cuda",
                        dtype_storage="int8c", promote=None, retain_host=True)
    qa_dst = quantize_matrix(a, "int8c", contraction_shards=4)
    x = uniform((n,), torch.float32)
    del a
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    res_same = qeng.reshard("colwise")
    same_s = time.perf_counter() - t0
    check(res_same["migrated"] and not res_same["requantized"]
          and res_same["bytes_moved"] == qeng.resident_bytes,
          f"int8c reshard rowwise->colwise: {res_same}")
    ref_st = shard_operand(qa_dst, get_strategy("colwise").specs(rs_mesh)[0], rs_mesh)
    check(all(torch.equal(u, v) for s_e, s_r in zip(qeng._a.shards, ref_st.shards)
              for u, v in zip(s_e.leaves, s_r.leaves) if u is not None),
          "int8c reshard: the moved payload is not the colwise quantization")
    y = qeng.submit(x).result()
    spec_x = get_strategy("colwise").specs(rs_mesh)[1]
    y_ref = get_strategy("colwise").build(rs_mesh, kernel="cuda", dtype_storage="int8c")(
        ref_st, shard(x, spec_x, rs_mesh)).cpu()
    check(torch.equal(y, y_ref), "int8c reshard: result differs from the colwise payload's")
    del qeng, qa_dst, ref_st, x
    torch.cuda.empty_cache()
    a = uniform((n, RESHARD_NEW_BLOCK_K), torch.float32)
    x = uniform((RESHARD_NEW_BLOCK_K,), torch.float32)
    qeng = MatvecEngine(a, rs_mesh, strategy="rowwise", kernel="cuda",
                        dtype_storage="int8c", promote=None, retain_host=True)
    block_before = qeng.storage_block
    res_new = qeng.reshard("colwise")
    check(res_new["requantized"] and qeng.storage_block < block_before,
          f"int8c reshard at k={RESHARD_NEW_BLOCK_K}: {res_new}, block "
          f"{block_before} -> {qeng.storage_block}")
    qa_cpu = quantize_matrix(a.cpu(), "int8c", contraction_shards=4)
    oracle = dequantize(qa_cpu).double() @ x.cpu().double()
    y = qeng.submit(x).result().double()
    rtol, atol = QUANT_ORACLE_TOL
    err = ((y - oracle).abs() - rtol * oracle.abs()).max().item()
    check(err <= atol, f"int8c requantized reshard: {err} beyond rtol {rtol} atol {atol}")
    torch.cuda.synchronize(dev)
    quant_launches["engine_reshard_int8c"] = quant_gemv_cuda.launches
    check(quant_gemv_cuda.launches > 0, "int8c reshard: the block-scaled GEMV never ran")
    emit({"phase": "quant_reshard", "format": "int8c", "mesh": list(rs_mesh.grid),
          "same_block": {"shape": [n, n], "dtype": "float32", "summary": res_same,
                         "seconds": same_s, "payload_bitwise": True, "result_bitwise": True},
          "new_block": {"shape": [n, RESHARD_NEW_BLOCK_K], "summary": res_new,
                        "block": [block_before, qeng.storage_block],
                        "oracle_excess": err, "rtol": rtol, "atol": atol},
          "launches": quant_gemv_cuda.launches})
    del qeng, a, x
    torch.cuda.empty_cache()

    # ---- 32. tune: fill a cache, read it back, measure nothing again ----
    section("32. tune: fill a cache, read it back, measure nothing again")
    from matvec_mpi_multiplier_torch import tuning
    from matvec_mpi_multiplier_torch.ops.gemm_kernels import resolve_gemm
    from matvec_mpi_multiplier_torch.ops.gemv import resolve_gemv
    from matvec_mpi_multiplier_torch.tuning import search

    tune_dir = Path(tempfile.mkdtemp(prefix="tuning_"))
    os.environ[tuning.CACHE_ENV] = str(tune_dir / "tuning_cache.json")
    tuning.reset_cache()
    tune_mesh = make_mesh(4, devices=[dev] * 4)
    serve_local = TUNE_SERVE_N // 2
    tune_log = []

    def tune_pass(cache) -> dict:
        out = {}
        log = tune_log.append
        for m in TUNE_GEMV_ROWS:
            for name in ("bfloat16", "float32"):
                out[f"gemv {m}x{TUNE_GEMV_K} {name}"] = search.tune_gemv(
                    m, TUNE_GEMV_K, name, cache, log=log)
        out[f"gemv {serve_local}x{serve_local} float32"] = search.tune_gemv(
            serve_local, serve_local, "float32", cache, log=log)
        for b in TUNE_GEMM_BUCKETS:
            out[f"gemm {serve_local}x{serve_local}x{b} float32"] = search.tune_gemm(
                serve_local, serve_local, b, "float32", cache, log=log)
        ov = search.tune_overlap("blockwise", tune_mesh, TUNE_SERVE_N, TUNE_SERVE_N,
                                 "float32", cache, log=log)
        out["overlap blockwise 2x2"] = ov
        out["combine blockwise 2x2"] = search.tune_combine(
            "blockwise", tune_mesh, TUNE_SERVE_N, TUNE_SERVE_N, "float32", cache,
            stages=(ov or {}).get("stages"), log=log)
        out["promotion blockwise 2x2"] = search.tune_promotion(
            "blockwise", tune_mesh, TUNE_SERVE_N, TUNE_SERVE_N, "float32", cache, log=log)
        out[f"solver_kernel cg rowwise {TUNE_SOLVER_N}"] = search.tune_solver_kernel(
            "cg", "rowwise", make_mesh(1), TUNE_SOLVER_N, TUNE_SOLVER_N, "float32",
            cache, log=log)
        cache.save()
        return out

    for wrapper in (gemv_cuda, gemm_cuda, solver_step_cuda):
        wrapper.launches = 0
    gemv_cuda.route_launches.clear()
    reset_gemm()
    cache = tuning.TuningCache.load()
    t0 = time.perf_counter()
    decisions = tune_pass(cache)
    tune_s = time.perf_counter() - t0
    torch.cuda.synchronize(dev)
    tune_launched = {"gemv": gemv_cuda.launches, "gemm": gemm_cuda.launches,
                     "solver_step": solver_step_cuda.launches}
    check(all(v > 0 for v in tune_launched.values()), f"tune pass launched {tune_launched}")
    for kernel_name in ("gemv", "gemm"):
        launches_by_path[kernel_name]["tune"] = tune_launched[kernel_name]
    solver_paths["solver_step"]["tune"] = tune_launched["solver_step"]
    gemv_routes["tune"] = dict(gemv_cuda.route_launches)
    gemm_routes["tune"] = dict(gemm_cuda.route_launches)
    for axis, decision in decisions.items():
        check(decision is not None, f"tune: {axis} recorded no decision")
        emit({"phase": "tune", "axis": axis, "decision": decision})
    fingerprint = tuning.platform_fingerprint()
    check(fingerprint.startswith("torch-cuda:") and "H100" in fingerprint,
          f"tune: fingerprint {fingerprint}")
    check(all(key.startswith(fingerprint + "|") for key in cache.entries),
          "tune: an entry under another fingerprint")
    # A second pass on the filled cache measures nothing.
    before = search.candidates_measured()
    again = tune_pass(tuning.TuningCache.load())
    check(search.candidates_measured() == before and again == decisions,
          "tune: the second pass measured again")
    # The JAX package's entries for the same keys never apply.
    gemv_cell = f"gemv {TUNE_GEMV_ROWS[0]}x{TUNE_GEMV_K} bfloat16"
    shared = tuning.TuningCache.load()
    jax_keys = [tuning.gemv_key(TUNE_GEMV_ROWS[0], TUNE_GEMV_K, "bfloat16",
                                fingerprint=JAX_FINGERPRINT),
                tuning.promote_key("blockwise", TUNE_SERVE_N, TUNE_SERVE_N, 4, "float32",
                                   fingerprint=JAX_FINGERPRINT)]
    shared.record(jax_keys[0], {"kernel": "xla"})
    shared.record(jax_keys[1], {"b_star": 32})
    shared.save()
    tuning.reset_cache()
    check(tuning.lookup_gemv(TUNE_GEMV_ROWS[0], TUNE_GEMV_K, "bfloat16") == decisions[gemv_cell],
          "tune: a JAX entry applied")
    check(all(tuning.TuningCache.load().lookup(k) is not None for k in jax_keys),
          "tune: a save lost the JAX package's entries")

    # An engine with every "auto" dispatches the winners, bitwise what an
    # engine with them named dispatches.
    promo = decisions["promotion blockwise 2x2"]
    comb = decisions["combine blockwise 2x2"]["combine"]
    stages = (decisions["overlap blockwise 2x2"] or {}).get("stages")
    gemv_win = decisions[f"gemv {serve_local}x{serve_local} float32"]
    gemm_win = {b: decisions[f"gemm {serve_local}x{serve_local}x{b} float32"]
                for b in TUNE_GEMM_BUCKETS}

    class NamedWinners:
        """The recorded winners named: the GEMV's, and each tuned bucket's
        GEMM (the cuda tier's default plan at the others)."""

        __name__ = "named_winners"

        def __call__(self, a, x):
            if x.dim() == 1:
                return resolve_gemv(gemv_win)(a, x)
            return resolve_gemm(gemm_win.get(x.shape[1]))(a, x)

    serve_a = resident_matrix(TUNE_SERVE_N, TUNE_SERVE_N, torch.float32, dev, args.seed)
    auto_pool = _request_pool(TUNE_SERVE_N, rs_widths, torch.float32, seed=args.seed + 3)
    runs = {}
    for label, kwargs in (
        ("auto", dict(kernel="auto", combine="auto", promote="auto",
                      dtype_storage="auto")),
        ("named", dict(kernel=NamedWinners(), combine=comb, promote=promo["b_star"],
                       stages=stages)),
    ):
        gemv_cuda.launches = 0
        gemv_cuda.route_launches.clear()
        reset_gemm()
        engine = MatvecEngine(serve_a, tune_mesh, strategy="blockwise",
                              max_bucket=SERVE_MAX_BUCKET, **kwargs)
        outs = [engine.submit(auto_pool[w]).result() for w in rs_sequence]
        torch.cuda.synchronize(dev)
        runs[label] = {
            "outs": outs, "b_star": engine.b_star, "stages": engine.stages,
            "storage": [engine.storage, engine.storage_reason],
            "keys": sorted(k._replace(kernel="").label() for k in engine._cache.keys()),
            "gemv_routes": dict(gemv_cuda.route_launches),
            "gemm_routes": dict(gemm_cuda.route_launches),
            "launches": {"gemv": gemv_cuda.launches, "gemm": gemm_cuda.launches}}
        del engine
        torch.cuda.empty_cache()
    auto, named = runs["auto"], runs["named"]
    check(auto["b_star"] == promo["b_star"] and auto["stages"] == named["stages"],
          f"tune: the auto engine read b*={auto['b_star']}, S={auto['stages']}")
    check(auto["keys"] == named["keys"] and any(
        key.startswith(f"matvec:blockwise::{comb}") for key in auto["keys"]),
          f"tune: the auto engine's keys {auto['keys']} are not the winners' {named['keys']}")
    check(auto["gemv_routes"] == named["gemv_routes"]
          and auto["gemm_routes"] == named["gemm_routes"],
          f"tune: routes {auto['gemv_routes']} {auto['gemm_routes']} against "
          f"{named['gemv_routes']} {named['gemm_routes']}")
    check(all(torch.equal(u, v) for u, v in zip(auto["outs"], named["outs"])),
          "tune: the auto engine differs from the named winners")
    for kernel_name in ("gemv", "gemm"):
        launches_by_path[kernel_name]["tune_auto_engine"] = auto["launches"][kernel_name]
    del serve_a, auto_pool
    torch.cuda.empty_cache()
    solver_win = decisions[f"solver_kernel cg rowwise {TUNE_SOLVER_N}"]["solver_kernel"]
    s_a = solver_operand(TUNE_SOLVER_N, "float32", args.seed, device=dev)
    s_b = np.random.default_rng(args.seed).standard_normal(TUNE_SOLVER_N).astype(np.float32)
    xs = {}
    solver_step_cuda.launches = 0
    for label, tier in (("auto", "auto"), ("named", solver_win)):
        engine = MatvecEngine(s_a, make_mesh(1), strategy="rowwise", solver_kernel=tier,
                              promote=None)
        if label == "auto":
            check(engine._resolve_solver_kernel("cg") == solver_win,
                  f"tune: solver_kernel='auto' took {engine._resolve_solver_kernel('cg')}")
        xs[label] = engine.submit(op="cg", rhs=s_b, rtol=SOLVER_RTOL).result().x
        del engine
    check(torch.equal(xs["auto"], xs["named"]), "tune: the auto solver differs")
    solver_paths["solver_step"]["tune_auto_engine"] = solver_step_cuda.launches
    del s_a
    torch.cuda.empty_cache()
    emit({"phase": "tune_check", "tune_seconds": tune_s, "entries": len(cache),
          "fingerprint": fingerprint, "second_pass_measured": 0,
          "jax_entries_applied": 0, "auto_engine": {
              k: v for k, v in auto.items() if k not in ("outs", "keys")},
          "auto_keys": auto["keys"],
          "solver_kernel": solver_win, "launches": tune_launched,
          "log_tail": tune_log[-40:]})
    shutil.rmtree(tune_dir, ignore_errors=True)
    del os.environ[tuning.CACHE_ENV]
    tuning.reset_cache()

    # ---- 33. load serving through the arrival-window scheduler ----
    section("33. load serving through the arrival-window scheduler")
    load_launches = {"gemv": {}, "gemm": {}, "quant_gemv": {}}
    load_routes = {"gemv": Counter(), "gemm": Counter()}

    def reset_launches() -> None:
        for fn in (gemv_cuda, gemm_cuda, quant_gemv_cuda):
            fn.launches = 0
            fn.route_launches.clear()

    def load_run(phase: str, dtype_name_: str, storage=None, **kw) -> dict:
        """One run_serve_load at 65536² with the kernels' counts set to 0
        just before it; checks and returns its JSON line."""
        reset_launches()
        with tempfile.TemporaryDirectory() as tmp:
            snap, trace = Path(tmp) / "metrics.json", Path(tmp) / "trace.jsonl"
            t0 = time.perf_counter()
            res = run_serve_load(
                "blockwise", make_mesh(1), LOAD_N, LOAD_N, dtype=dtype_name_,
                kernel="cuda", dtype_storage=storage, n_requests=LOAD_REQUESTS,
                max_bucket=SERVE_MAX_BUCKET, promote=SERVE_PROMOTE,
                flush_width=SERVE_PROMOTE, seed=args.seed, metrics_out=str(snap),
                trace_jsonl=str(trace), **kw)
            torch.cuda.synchronize(dev)
            run_s = time.perf_counter() - t0
            snapshot = json.loads(snap.read_text())
            traces = [json.loads(line) for line in trace.read_text().splitlines()]
        records = len(traces)
        # Where an engine request's host time goes, by span (the tracer's
        # perf_counter spans; a flush is one engine request when coalesced).
        span_ms = {}
        stack = [sp for rec in traces for sp in rec["spans"]]
        while stack:
            sp = stack.pop()
            span_ms.setdefault(sp["name"], []).append(sp["dur_ms"])
            stack.extend(sp.get("children", ()))
        span_p50_ms = {name: statistics.median(v) for name, v in sorted(span_ms.items())}
        torch.cuda.empty_cache()
        counters, hists = snapshot["counters"], snapshot["histograms"]
        flushes = counters.get("sched_batches_total")
        dispatches = counters["engine_dispatches_total"]
        captures = counters["engine_compiles_total"]
        launched = {"gemv": gemv_cuda.launches, "gemm": gemm_cuda.launches,
                    "quant_gemv": quant_gemv_cuda.launches}
        routes = {"gemv": dict(gemv_cuda.route_launches),
                  "gemm": dict(gemm_cuda.route_launches),
                  "quant_gemv": dict(quant_gemv_cuda.route_launches)}
        label = (f"{phase} {kw.get('arrival', 'closed')} c={kw.get('concurrency')} "
                 f"coalesce={kw.get('coalesce')}")
        # Each dispatch (a replay) and each capture's eager run calls one
        # kernel at p = 1; every engine request is traced.
        check(sum(launched.values()) == dispatches + captures,
              f"{label}: launches {launched}, {dispatches} dispatches, {captures} captures")
        check(res.compiles_steady == 0, f"{label}: {res.compiles_steady} steady builds")
        check(hists["serve_e2e_latency_ms"]["count"] == LOAD_REQUESTS,
              f"{label}: {hists['serve_e2e_latency_ms']['count']} requests served")
        check(records == counters["engine_requests_total"],
              f"{label}: {records} trace records for {counters['engine_requests_total']} requests")
        failures = {n: counters.get(n, 0) for n in (
            "sched_bisect_splits_total", "sched_isolated_failures_total",
            "sched_batch_failures_total", "engine_dispatch_failures_total",
            "engine_deadline_failures_total", "sched_deadline_failures_total")}
        check(not any(failures.values()), f"{label}: failures on clean traffic {failures}")
        # Warmup: every program captured (one eager run each), one request
        # of each width, and one block of each bucket from b* up.
        ladder_submits = sum(1 for b in bucket_ladder(SERVE_MAX_BUCKET) if b >= SERVE_PROMOTE)
        if storage is None:
            check(launched["quant_gemv"] == 0, f"{label}: quant launches {launched}")
            steady = {"gemv": launched["gemv"] - 2,
                      "gemm": launched["gemm"] - (captures - 1) - ladder_submits}
            check(set(routes["gemv"]) <= {"rows"}
                  and set(routes["gemm"]) <= {"wgmma_tma"},
                  f"{label}: routes {routes}")
        else:
            check(launched["gemv"] == launched["gemm"] == 0
                  and set(routes["quant_gemv"]) == {"wgmma_split"},
                  f"{label}: launches {launched}, routes {routes}")
            steady = {"quant_gemv": launched["quant_gemv"] - captures - 1 - ladder_submits}
        for name, n in launched.items():
            if n:
                load_launches[name][label.replace(" ", "_")] = n
        for name in load_routes:
            load_routes[name].update(routes[name])
        line = {"phase": phase, "strategy": "blockwise", "shape": [LOAD_N, LOAD_N],
                "dtype": dtype_name_, "storage": res.dtype_storage,
                "arrival": res.arrival, "concurrency": res.concurrency,
                "coalesce": bool(res.coalesce),
                "rate_req_s": res.rate_req_s if res.arrival != "closed" else None,
                "burst": kw.get("burst"), "n_requests": res.n_requests,
                "b_star": res.b_star, "max_bucket": SERVE_MAX_BUCKET,
                "flush_width": SERVE_PROMOTE, "req_per_s": res.rps,
                "cols_per_s": res.cols_per_s, "wall_s": res.wall_s,
                "p50_request_ms": res.p50_dispatch_ms,
                "p99_request_ms": res.p99_dispatch_ms,
                # Every engine submit of the run (warmup's few included).
                "p50_dispatch_ms": hists["engine_submit_latency_ms"]["p50"],
                "p99_dispatch_ms": hists["engine_submit_latency_ms"]["p99"],
                "mean_batch_width": res.mean_batch_width,
                "coalesce_ratio": res.coalesce_ratio,
                # The steady phase's flushes (the warmup submits to the
                # engine directly) and its wall time per flush.
                "flushes": flushes,
                "ms_per_flush": res.wall_s * 1e3 / flushes if flushes else None,
                "engine_requests": counters["engine_requests_total"],
                "engine_dispatches": dispatches, "captures": captures,
                "compiles_warmup": res.compiles_warmup,
                "compiles_steady": res.compiles_steady,
                "launches": launched, "steady_launches": steady,
                "route_launches": routes, "trace_records": records,
                "host_span_p50_ms": span_p50_ms,
                "resident_bytes": res.resident_bytes, **failures, "run_s": run_s}
        emit(line)
        return line

    load_lines = {}
    for clients in LOAD_CONCURRENCY:
        for coalesce in (False, True):
            line = load_run("load_serve", "bfloat16", concurrency=clients, coalesce=coalesce)
            load_lines[("closed", clients, coalesce)] = line
            if coalesce and clients >= LOAD_RATE_CLIENTS:
                check(line["steady_launches"]["gemm"] > 0,
                      f"load_serve c={clients}: the coalesced run launched no gemm")
            if not coalesce:
                check(line["steady_launches"] == {"gemv": LOAD_REQUESTS, "gemm": 0},
                      f"load_serve c={clients} uncoalesced: {line['steady_launches']}")
    open_rate = LOAD_OPEN_RATE_SHARE * load_lines[("closed", LOAD_RATE_CLIENTS, False)][
        "req_per_s"]
    for arrival in ("poisson", "burst"):
        for coalesce in (False, True):
            line = load_run("load_serve", "bfloat16", arrival=arrival, rate=open_rate,
                            burst=LOAD_BURST, concurrency=LOAD_RATE_CLIENTS,
                            coalesce=coalesce)
            load_lines[(arrival, LOAD_RATE_CLIENTS, coalesce)] = line
            if coalesce and arrival == "burst":
                check(line["steady_launches"]["gemm"] > 0,
                      "load_serve burst: the coalesced run launched no gemm")

    # ---- 34. load serving from an int8c resident ----
    section("34. load serving from an int8c resident")
    for coalesce in (False, True):
        load_run("load_serve_quant", "float32", storage="int8c",
                 concurrency=LOAD_QUANT_CLIENTS, coalesce=coalesce)

    # ---- 35. the scheduler's exactness on the card ----
    section("35. the scheduler's exactness on the card")
    reset_launches()
    ex_a = resident_matrix(LOAD_N, LOAD_N, torch.bfloat16, dev, args.seed)
    ex_engine = MatvecEngine(ex_a, make_mesh(1), strategy="blockwise", kernel="cuda",
                             max_bucket=SERVE_MAX_BUCKET, promote=SERVE_PROMOTE)
    ex_rng = np.random.default_rng(args.seed + 11)
    ex_cols = [torch.from_numpy(ex_rng.uniform(0, 10, LOAD_N)).to(torch.bfloat16)
               for _ in range(SCHED_EXACT_WIDTH)]
    with ArrivalWindowScheduler(ex_engine, window_ms=60_000.0,
                                flush_width=SERVE_MAX_BUCKET) as ex_sched:
        futs = [ex_sched.submit(c) for c in ex_cols]
        check(ex_sched.flush() == SCHED_EXACT_WIDTH, "sched_exact: the flush")
        coalesced = [f.result() for f in futs]
        check(all(f.coalesced and f.batch_width == SCHED_EXACT_WIDTH for f in futs),
              "sched_exact: the batch")
        bucket = bucket_for(SCHED_EXACT_WIDTH, SERVE_MAX_BUCKET)
        alone = [ex_engine.submit(pad_columns(c[:, None], bucket)).result()[:, 0]
                 for c in ex_cols]
        bitwise = [torch.equal(y, z) for y, z in zip(coalesced, alone)]
        sub = ex_cols[:SCHED_SUB_WIDTH]
        sub_futs = [ex_sched.submit(c) for c in sub]
        ex_sched.flush()
        sub_bitwise = [torch.equal(f.result(), ex_engine.submit(c).result())
                       for f, c in zip(sub_futs, sub)]
    check(all(bitwise), f"sched_exact: coalesced vs alone through bucket {bucket}: {bitwise}")
    check(all(sub_bitwise), f"sched_exact: below b* vs solo vectors: {sub_bitwise}")
    ref = gemm_plain(ex_a, torch.stack(ex_cols, dim=1).to(dev)).to(torch.bfloat16).cpu().float()
    got = torch.stack(coalesced, dim=1).float()
    ex_rel = ((got - ref).abs() / ref.abs()).max().item()
    check(ex_rel <= 2 ** -7, f"sched_exact: rel err {ex_rel} against the plain GEMM")
    exact_launches = {"gemv": gemv_cuda.launches, "gemm": gemm_cuda.launches}
    emit({"phase": "sched_exact", "shape": [LOAD_N, LOAD_N], "dtype": "bfloat16",
          "width": SCHED_EXACT_WIDTH, "bucket": bucket, "bitwise_vs_alone": all(bitwise),
          "sub_promotion_width": SCHED_SUB_WIDTH, "sub_bitwise_vs_solo": all(sub_bitwise),
          "max_rel_err_vs_plain": ex_rel, "rtol": 2 ** -7, "launches": exact_launches,
          "engine_dispatches": ex_engine.stats.dispatches})
    del ex_engine, ex_a, ex_sched
    torch.cuda.empty_cache()

    # ---- 36. the scheduler's bisection and integrity gate on the card ----
    section("36. the scheduler's bisection and integrity gate on the card")
    bi_a = uniform((SCHED_BISECT_N, SCHED_BISECT_N), torch.float32)
    bi_rng = np.random.default_rng(args.seed + 12)
    bi_cols = [torch.from_numpy(bi_rng.uniform(0, 10, SCHED_BISECT_N)).float()
               for _ in range(8)]

    def bisect_engine(plan=None, gate=False):
        return MatvecEngine(bi_a, make_mesh(1), strategy="blockwise", kernel="cuda",
                            max_bucket=8, promote=1, fault_plan=plan, integrity_gate=gate)

    def serve8(engine, cols):
        with ArrivalWindowScheduler(engine, window_ms=60_000.0, flush_width=8) as sched:
            futs = [sched.submit(c) for c in cols]  # the 8th flushes inline
            out = []
            for f in futs:
                try:
                    out.append(f.result())
                except Exception as e:
                    out.append(e)
        return out, engine.metrics.snapshot()["counters"]

    clean, _ = serve8(bisect_engine(), bi_cols)
    poisoned = [c.clone() for c in bi_cols]
    poisoned[5][0] = SCHED_POISON
    plan = FaultPlan([FaultSpec(site="dispatch", kind="device_error", poison=SCHED_POISON)])
    faulted, counters = serve8(bisect_engine(plan), poisoned)
    failed = [i for i, y in enumerate(faulted) if isinstance(y, Exception)]
    check(failed == [5] and isinstance(faulted[5], DeviceFaultError),
          f"sched_bisect: failed {failed}")
    check(all(torch.equal(faulted[i], clean[i]) for i in range(8) if i != 5),
          "sched_bisect: a batchmate differs from the unfaulted batch")
    bisect_counts = {n: counters[n] for n in (
        "sched_bisect_splits_total", "sched_isolated_failures_total",
        "sched_batch_failures_total")}
    check(bisect_counts == {"sched_bisect_splits_total": 3,
                            "sched_isolated_failures_total": 1,
                            "sched_batch_failures_total": 0},
          f"sched_bisect: counts {bisect_counts}")
    nan_cols = [c.clone() for c in bi_cols]
    nan_cols[2][17] = float("nan")
    gated, gate_counters = serve8(bisect_engine(gate=True), nan_cols)
    gate_failed = [i for i, y in enumerate(gated) if isinstance(y, Exception)]
    check(gate_failed == [2] and isinstance(gated[2], ResultIntegrityError),
          f"sched_bisect: the integrity gate failed {gate_failed}")
    check(all(torch.equal(gated[i], clean[i]) for i in range(8) if i != 2),
          "sched_bisect: a batchmate of the NaN request differs")
    down = FaultPlan([FaultSpec(site="dispatch", kind="device_error")])
    systemic, sys_counters = serve8(bisect_engine(down), bi_cols)
    check(all(isinstance(y, DeviceFaultError) for y in systemic)
          and down.total_injected == scheduler_mod.SYSTEMIC_FAILURE_THRESHOLD
          and sys_counters["sched_batch_failures_total"] == 8
          and sys_counters["sched_isolated_failures_total"] == 0,
          f"sched_bisect: systemic {down.summary()}, {sys_counters}")
    emit({"phase": "sched_bisect", "shape": [SCHED_BISECT_N, SCHED_BISECT_N],
          "dtype": "float32", "batch": 8, "poisoned": 5, "failed": failed,
          "batchmates_bitwise": True, **bisect_counts,
          "integrity_gate_failed": gate_failed,
          "integrity_failures": gate_counters["engine_integrity_failures_total"],
          "systemic_dispatches": down.total_injected,
          "systemic_threshold": scheduler_mod.SYSTEMIC_FAILURE_THRESHOLD,
          "systemic_batch_failures": sys_counters["sched_batch_failures_total"]})
    del bi_a
    torch.cuda.empty_cache()

    # ---- 37. captures while client threads wait on results ----
    section("37. captures while client threads wait on results")
    import threading

    cap_a = uniform((SCHED_CAPTURE_N, SCHED_CAPTURE_N), torch.float32)
    cap_a64 = cap_a.double()
    cap_engine = MatvecEngine(cap_a, make_mesh(1), strategy="blockwise", kernel="cuda",
                              max_bucket=SERVE_MAX_BUCKET, promote=SERVE_PROMOTE)
    capture_log = []
    waiting = Counter()
    waiting_lock = threading.Lock()
    program = cap_engine._program
    result = scheduler_mod.CoalescedFuture.result

    def logged_program(*a, **kw):  # who captures, and how many clients wait meanwhile
        capture_log.append({"thread": threading.current_thread().name,
                            "clients_in_result": waiting["n"]})
        return program(*a, **kw)

    def counted_result(self, timeout=None):
        with waiting_lock:
            waiting["n"] += 1
        try:
            return result(self, timeout)
        finally:
            with waiting_lock:
                waiting["n"] -= 1

    cap_engine._program = logged_program
    scheduler_mod.CoalescedFuture.result = counted_result
    cap_rng = np.random.default_rng(args.seed + 13)
    cap_blocks = [[torch.from_numpy(cap_rng.uniform(0, 10, (SCHED_CAPTURE_N, int(w)))).float()
                   for w in cap_rng.integers(1, 4, SCHED_CAPTURE_REQUESTS)]
                  for _ in range(SCHED_CAPTURE_CLIENTS)]
    cap_errors, cap_out = [], []
    start = threading.Barrier(SCHED_CAPTURE_CLIENTS)
    try:
        with ArrivalWindowScheduler(cap_engine) as cap_sched:
            def client(blocks):
                try:
                    start.wait()
                    for x in blocks:
                        y = cap_sched.submit(x[:, 0] if x.shape[1] == 1 else x).result(
                            timeout=120)
                        cap_out.append((x, y))
                except Exception as e:
                    cap_errors.append(repr(e))

            threads = [threading.Thread(target=client, args=(b,), name=f"client-{i}")
                       for i, b in enumerate(cap_blocks)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=300)
            check(not any(t.is_alive() for t in threads), "sched_capture: a client hung")
            cap_stats = cap_sched.stats
    finally:
        scheduler_mod.CoalescedFuture.result = result
    check(not cap_errors, f"sched_capture: {cap_errors[:3]}")
    cap_rel = []
    for x, y in cap_out:  # against torch.matmul in fp64, after the clients
        want = (cap_a64 @ x.double().to(dev)).cpu()
        want = want[:, 0] if x.shape[1] == 1 else want
        cap_rel.append(((y.double() - want).abs() / want.abs()).max().item())
    check(len(cap_rel) == SCHED_CAPTURE_CLIENTS * SCHED_CAPTURE_REQUESTS
          and max(cap_rel) <= SCHED_CAPTURE_RTOL,
          f"sched_capture: {len(cap_rel)} results, max rel err {max(cap_rel, default=None)}")
    flusher_captures = [c for c in capture_log if c["thread"] == "matvec-sched-flusher"]
    emit({"phase": "sched_capture", "shape": [SCHED_CAPTURE_N, SCHED_CAPTURE_N],
          "dtype": "float32", "clients": SCHED_CAPTURE_CLIENTS,
          "requests": len(cap_rel), "capture_error_mode": "thread_local",
          "captures": len(capture_log), "captures_by_flusher": len(flusher_captures),
          "captures_while_clients_waited": sum(c["clients_in_result"] > 0
                                               for c in capture_log),
          "capture_log": capture_log, "max_rel_err_vs_fp64": max(cap_rel),
          "rtol": SCHED_CAPTURE_RTOL, "batches": cap_stats.batches,
          "mean_batch_width": cap_stats.mean_batch_width,
          "coalesce_ratio": cap_stats.coalesce_ratio, "errors": cap_errors})
    del cap_engine, cap_a, cap_a64
    torch.cuda.empty_cache()

    # ---- 38. a resilient engine on clean traffic ----
    section("38. a resilient engine on clean traffic")
    from matvec_mpi_multiplier_torch.bench.serve import POISON_SIGNATURE
    from matvec_mpi_multiplier_torch.resilience import ResiliencePolicy, parse_fault_spec
    from matvec_mpi_multiplier_torch.utils.errors import SolverDivergedError

    res_a = resident_matrix(LOAD_N, LOAD_N, torch.bfloat16, dev, args.seed)
    res_widths = [w for w in DEFAULT_WIDTH_MIX if w <= SERVE_MAX_BUCKET]
    res_pool = _request_pool(LOAD_N, res_widths, torch.bfloat16, seed=args.seed + 1)
    res_seq = [int(w) for w in np.random.default_rng(args.seed + 2).choice(
        list(res_pool), size=RESIL_REQUESTS)]
    resil_launches = {"gemv": {}, "gemm": {}, "quant_gemv": {}}
    resil_routes = {"gemv": Counter(), "gemm": Counter()}

    def routed(label: str, fn):
        """fn() with the GEMV, GEMM and block-scaled GEMV counts set to 0
        just before it; returns its value and the launches by route."""
        reset_launches()
        out = fn()
        torch.cuda.synchronize(dev)
        launched = {"gemv": dict(gemv_cuda.route_launches),
                    "gemm": dict(gemm_cuda.route_launches),
                    "quant_gemv": dict(quant_gemv_cuda.route_launches)}
        for name, wrapper in (("gemv", gemv_cuda), ("gemm", gemm_cuda),
                              ("quant_gemv", quant_gemv_cuda)):
            if wrapper.launches:
                resil_launches[name][label] = (resil_launches[name].get(label, 0)
                                               + wrapper.launches)
        for name in resil_routes:
            resil_routes[name].update(launched[name])
        return out, launched

    def res_engine(policy=None, plan=None, a=None, **kw):
        kw.setdefault("promote", SERVE_PROMOTE)
        kw.setdefault("max_bucket", SERVE_MAX_BUCKET)
        return MatvecEngine(res_a if a is None else a, make_mesh(1), strategy="blockwise",
                            kernel="cuda", resilience=policy, fault_plan=plan, **kw)

    def stream(engine) -> tuple[list, float]:
        """The serve cell's 200 requests, submitted in order and
        materialized after: the results and req/s."""
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        futs = [engine.submit(res_pool[w]) for w in res_seq]
        outs = [f.result() for f in futs]
        return outs, RESIL_REQUESTS / (time.perf_counter() - t0)

    plain_engine, resil_engine = res_engine(), res_engine(ResiliencePolicy())
    runs = {}
    for label, engine in (("plain", plain_engine), ("resilient", resil_engine)):
        (_, (outs, rps)), launched = routed(f"resilient_clean_{label}", lambda: (
            engine.warmup(widths=res_widths), stream(engine)))
        runs[label] = {"outs": outs, "launches": launched, "req_per_s": [rps]}
    check(all(torch.equal(y, z) for y, z in zip(runs["plain"]["outs"],
                                                 runs["resilient"]["outs"])),
          "resilient_clean: a result differs from the plain engine's")
    check(runs["plain"]["launches"] == runs["resilient"]["launches"],
          f"resilient_clean: launches {runs['plain']['launches']} against "
          f"{runs['resilient']['launches']}")
    check(set(runs["plain"]["launches"]["gemv"]) == {"rows"}
          and set(runs["plain"]["launches"]["gemm"]) == {"wgmma_tma"},
          f"resilient_clean: routes {runs['plain']['launches']}")
    # Policy off and on within one call: after the first pair, RESIL_PASSES
    # more of each in the order on, off, off, on, on, off, ...
    for label in ("resilient", "plain", "plain", "resilient") * (RESIL_PASSES // 2):
        engine = resil_engine if label == "resilient" else plain_engine
        runs[label]["req_per_s"].append(stream(engine)[1])
    health = resil_engine.health()
    check(set(health) == {"resilience", "cost_model", "slo", "integrity_gate", "storage",
                          "breakers", "degraded", "fault_injection", "counters"}
          and health["resilience"] and "native_fallback_resident" in health["storage"],
          f"resilient_clean: health() keys {sorted(health)}")
    clean_counts = {k: health["counters"][k] for k in ("retries", "downgrades",
                                                       "breaker_opens", "dispatch_failures")}
    check(not any(clean_counts.values()) and health["degraded"] == {}
          and all(b["state"] == "closed" for b in health["breakers"].values()),
          f"resilient_clean: {clean_counts}, degraded {health['degraded']}")
    submit_p50 = {label: engine.metrics.snapshot()["histograms"]["engine_submit_latency_ms"][
        "p50"] for label, engine in (("plain", plain_engine), ("resilient", resil_engine))}

    # The policy's host cost a dispatch: the ladder walk (made from the
    # current layout, a breaker lookup, allow, record_success) around an
    # attempt that does nothing, against the key and the attempt alone.
    def host_us(fn, n=20000) -> float:
        for _ in range(1000):
            fn()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        return (time.perf_counter() - t0) / n * 1e6

    def noop(key, build):
        return None

    ladder_us = {
        "walk_matvec": host_us(lambda: resil_engine._walk_ladder(
            resil_engine._matvec_levels(), noop)),
        "direct_matvec": host_us(lambda: noop(resil_engine._matvec_key(),
                                              resil_engine._build_matvec)),
        "walk_gemm": host_us(lambda: resil_engine._walk_ladder(
            resil_engine._gemm_levels(8), noop)),
        "direct_gemm": host_us(lambda: noop(resil_engine._gemm_key(8), None)),
    }
    ladder_us["cost_matvec"] = ladder_us["walk_matvec"] - ladder_us["direct_matvec"]
    ladder_us["cost_gemm"] = ladder_us["walk_gemm"] - ladder_us["direct_gemm"]
    emit({"phase": "resilient_clean", "strategy": "blockwise", "shape": [LOAD_N, LOAD_N],
          "dtype": "bfloat16", "requests": RESIL_REQUESTS, "widths": res_widths,
          "bitwise_vs_plain": True, "launches_by_route": runs["plain"]["launches"],
          "launches_equal": True, **clean_counts,
          "breakers": len(health["breakers"]), "health_keys": sorted(health),
          "req_per_s_off": runs["plain"]["req_per_s"],
          "req_per_s_on": runs["resilient"]["req_per_s"],
          "req_per_s_off_mean": statistics.mean(runs["plain"]["req_per_s"]),
          "req_per_s_on_mean": statistics.mean(runs["resilient"]["req_per_s"]),
          "ladder_host_us": ladder_us, "submit_p50_ms": submit_p50, "slo_status": {
              n: t["status"] for n, t in health["slo"]["targets"].items()}})

    # A kernel that really fails reaches the caller under the policy: plans
    # the kernels refuse before they launch anything (cudaErrorInvalidValue,
    # a GEMV with no warps, a GEMM ring deeper than it was built for). The
    # ladder routes around injected faults only.
    import matvec_mpi_multiplier_torch.ops.cuda_gemm as cuda_gemm_mod
    import matvec_mpi_multiplier_torch.ops.cuda_gemv as cuda_gemv_mod

    gemv_plan_of, gemm_plan_of = cuda_gemv_mod.gemv_plan, cuda_gemm_mod.default_gemm_tiles
    real_engine = res_engine(ResiliencePolicy())
    real_reqs = {"matvec": res_pool[1], "gemm": res_pool[DEGRADE_WIDTH]}
    real_errors = {}
    cuda_gemv_mod.gemv_plan = lambda *a: gemv_plan_of(*a)._replace(warps=0)
    cuda_gemm_mod.default_gemm_tiles = lambda *a: gemm_plan_of(*a)._replace(stages=99)
    try:
        for op, req in real_reqs.items():
            try:
                real_engine.submit(req).result()
            except RuntimeError as e:
                real_errors[op] = str(e)
    finally:
        cuda_gemv_mod.gemv_plan, cuda_gemm_mod.default_gemm_tiles = gemv_plan_of, gemm_plan_of
    real_h = real_engine.health()
    real_counts = {k: real_h["counters"][k] for k in ("retries", "downgrades",
                                                      "breaker_opens", "dispatch_failures")}
    check(set(real_errors) == {"matvec", "gemm"}
          and all("(cudaError 1)" in e for e in real_errors.values()),
          f"resilient_real_error: {real_errors}")
    check(real_counts == {"retries": 0, "downgrades": 0, "breaker_opens": 0,
                          "dispatch_failures": 2} and real_h["degraded"] == {}
          and all(b["failures_total"] == 0 for b in real_h["breakers"].values())
          and not any(k.kernel == "torch" for k in real_engine._cache.keys()),
          f"resilient_real_error: {real_counts}, {real_h['degraded']}, "
          f"{real_engine._cache.keys()}")
    # The same engine then serves both through the kernels, bitwise the plain
    # engine's results.
    real_served = {op: torch.equal(real_engine.submit(req).result(),
                                   plain_engine.submit(req).result())
                   for op, req in real_reqs.items()}
    check(all(real_served.values()), f"resilient_real_error: served {real_served}")
    emit({"phase": "resilient_real_error", "shape": [LOAD_N, LOAD_N], "dtype": "bfloat16",
          "errors": real_errors, **real_counts, "degraded": real_h["degraded"],
          "torch_tier_built": False, "then_bitwise_vs_plain": real_served})
    for engine in (plain_engine, resil_engine, real_engine):
        engine.close()
    del plain_engine, resil_engine, real_engine, engine, runs

    # ---- 39. chaos load serving ----
    section("39. chaos load serving")
    chaos_x = _request_pool(LOAD_N, (1,), torch.bfloat16, seed=args.seed + 1)[1][:, 0]
    chaos_ref = gemm_plain(res_a, chaos_x.to(dev)[:, None])[:, 0].float().cpu()
    n_poisoned = max(1, round(CHAOS_POISON_RATE * LOAD_REQUESTS))
    recorded = []
    sched_submit = ArrivalWindowScheduler.submit

    def recording_submit(self, x, *a, **kw):  # every steady request and its future
        fut = sched_submit(self, x, *a, **kw)
        recorded.append((x, fut))
        return fut

    chaos_lines, chaos_retries = [], 0
    obs_dir = Path(tempfile.mkdtemp(prefix="chaos_"))
    ArrivalWindowScheduler.submit = recording_submit
    try:
        for clients in CHAOS_CLIENTS:
            recorded.clear()
            run_dir = obs_dir / f"c{clients}"
            snap = run_dir / "metrics.json"
            torch.cuda.reset_peak_memory_stats(dev)
            t0 = time.perf_counter()
            res, launched = routed(f"chaos_serve_c{clients}", lambda: run_serve_load(
                "blockwise", make_mesh(1), LOAD_N, LOAD_N, dtype="bfloat16", kernel="cuda",
                n_requests=LOAD_REQUESTS, max_bucket=SERVE_MAX_BUCKET, promote=SERVE_PROMOTE,
                flush_width=SERVE_PROMOTE, concurrency=clients, coalesce=True, seed=args.seed,
                fault_spec=CHAOS_FAULT_SPEC, fault_seed=args.seed,
                poison_rate=CHAOS_POISON_RATE, slo_out=str(run_dir / "slo.json"),
                flight_dir=str(run_dir / "flight"), metrics_out=str(snap)))
            run_s = time.perf_counter() - t0
            counters = json.loads(snap.read_text())["counters"]
            # Each steady request's fate: a poisoned one must fail with the
            # injected payload fault, every other one be served.
            fates, rel = Counter(), 0.0
            for x, fut in recorded:
                poisoned = float(x.reshape(-1)[0]) >= POISON_SIGNATURE / 2
                err = fut.exception()
                if err is None:
                    y = fut.result(timeout=60).float()
                    rel = max(rel, ((y - chaos_ref).abs() / chaos_ref.abs()).max().item())
                fates[f"{'poisoned' if poisoned else 'clean'}:"
                      f"{'served' if err is None else type(err).__name__}"] += 1
            cli, bundles = {}, sorted((run_dir / "flight").iterdir())
            for cmd, path in (("slo", run_dir / "slo.json"), ("dump", bundles[:1])):
                if cmd == "dump" and not path:
                    continue
                proc = subprocess.run(
                    [sys.executable, "-m", "matvec_mpi_multiplier_torch.obs", cmd,
                     str(path if cmd == "slo" else path[0])],
                    cwd=str(Path(__file__).resolve().parent), capture_output=True,
                    text=True, timeout=300)
                cli[cmd] = {"rc": proc.returncode, "head": proc.stdout.splitlines()[:8],
                            "stderr": proc.stderr[-400:]}
            slo = json.loads((run_dir / "slo.json").read_text())
            line = {"phase": "chaos_serve", "strategy": "blockwise", "shape": [LOAD_N, LOAD_N],
                    "dtype": "bfloat16", "concurrency": clients, "coalesce": True,
                    "fault_spec": CHAOS_FAULT_SPEC, "poison_rate": CHAOS_POISON_RATE,
                    "n_requests": res.n_requests, "poisoned": n_poisoned,
                    "failed_requests": res.failed_requests, "success_rate": res.success_rate,
                    "served_max_rel_err_vs_fp32": rel, "rtol": 2 ** -7,
                    "retries": res.retries, "downgrades": res.downgrades,
                    "req_per_s": res.rps, "p50_request_ms": res.p50_dispatch_ms,
                    "p99_request_ms": res.p99_dispatch_ms,
                    "mean_batch_width": res.mean_batch_width,
                    "compiles_steady": res.compiles_steady, "launches_by_route": launched,
                    **{k: counters.get(k, 0) for k in (
                        "resil_faults_injected_total", "resil_breaker_opens_total",
                        "sched_bisect_splits_total", "sched_isolated_failures_total",
                        "sched_batch_failures_total")},
                    "slo_status": {n: t["status"] for n, t in slo["targets"].items()},
                    "flight_bundles": [b.name for b in bundles], "obs_cli": cli,
                    "fates": dict(fates),
                    # The torch tier's captured programs hold no copy of A.
                    "peak_device_bytes": torch.cuda.max_memory_allocated(dev),
                    "run_s": run_s}
            emit(line)
            chaos_lines.append(line)
            check(fates == {"clean:served": LOAD_REQUESTS - n_poisoned,
                            "poisoned:DeviceFaultError": n_poisoned} and rel <= 2 ** -7,
                  f"chaos c={clients}: fates {dict(fates)}, rel err {rel}")
            check(res.failed_requests == n_poisoned,
                  f"chaos c={clients}: {res.failed_requests} failed, {n_poisoned} poisoned")
            check(counters.get("resil_breaker_opens_total", 0) == 0,
                  f"chaos c={clients}: a breaker opened {counters}")
            check(bool(bundles) and all(c["rc"] == 0 for c in cli.values()),
                  f"chaos c={clients}: bundles {bundles}, obs CLI {cli}")
            chaos_retries += res.retries
    finally:
        ArrivalWindowScheduler.submit = sched_submit
        shutil.rmtree(obs_dir, ignore_errors=True)
    check(chaos_retries > 0, "chaos: no retry in either run")
    del recorded, x, fut, err, y  # the futures and their results

    # Distinct columns through a resilient engine behind the scheduler: a
    # result handed a batchmate's column would miss its own reference.
    col_rng = np.random.default_rng(args.seed + 16)
    col_xs = [(torch.from_numpy(col_rng.uniform(0, 10, LOAD_N)) * 2 ** (j / 8)).to(
        torch.bfloat16) for j in range(CHAOS_COLUMNS)]
    col_ref = gemm_plain(res_a, torch.stack(col_xs, dim=1).to(dev)).to(
        torch.bfloat16).float().cpu()
    for j in CHAOS_COLUMN_POISONED:
        col_xs[j][0] = POISON_SIGNATURE
    col_plan = FaultPlan([
        FaultSpec(site="dispatch", kind="device_error", key="gemm:*", times=2,
                  retryable=False),  # batch 0's two GEMM levels: the GEMV floor
        FaultSpec(site="dispatch", kind="device_error", poison=POISON_SIGNATURE),
        FaultSpec(site="dispatch", kind="device_error", p=0.1),
    ], seed=args.seed)
    col_engine = res_engine(ResiliencePolicy(), col_plan)
    col_engine.warmup(widths=[1, CHAOS_COLUMN_BATCH])

    def serve_columns() -> dict:
        out = {}
        with ArrivalWindowScheduler(col_engine, window_ms=60_000.0,
                                    flush_width=CHAOS_COLUMN_BATCH) as col_sched:
            futs = [col_sched.submit(c) for c in col_xs]  # every 8th flushes inline
            col_sched.flush()
            for j, f in enumerate(futs):
                try:
                    out[j] = f.result(timeout=120).float()
                except DeviceFaultError as e:
                    out[j] = e
        return out

    col_out, col_launches = routed("chaos_columns", serve_columns)
    col_failed = sorted(j for j, y in col_out.items() if isinstance(y, Exception))
    own_rel, other_rel = 0.0, float("inf")
    for j, y in col_out.items():
        if isinstance(y, Exception):
            continue
        rel = ((y[None, :] - col_ref.T).abs() / col_ref.T.abs()).amax(dim=1)
        own_rel = max(own_rel, rel[j].item())
        other_rel = min(other_rel, torch.cat([rel[:j], rel[j + 1:]]).min().item())
    col_counters = col_engine.metrics.snapshot()["counters"]
    col_counts = {n: col_counters.get(n, 0) for n in (
        "resil_retries_total", "resil_downgrades_total", "resil_breaker_opens_total",
        "sched_bisect_splits_total", "sched_isolated_failures_total",
        "sched_batch_failures_total")}
    col_specs = [s["injected"] for s in col_plan.summary()["specs"]]
    check(col_failed == list(CHAOS_COLUMN_POISONED)
          and all(isinstance(col_out[j], DeviceFaultError) for j in col_failed),
          f"chaos_columns: failed {col_failed}")
    check(own_rel <= 2 ** -7 < other_rel,
          f"chaos_columns: rel err {own_rel} to its own column, {other_rel} to another")
    check(col_specs[0] == 2 and sum(col_launches["gemv"].values()) >= CHAOS_COLUMN_BATCH
          and col_counts["sched_isolated_failures_total"] == len(CHAOS_COLUMN_POISONED),
          f"chaos_columns: floor {col_specs}, {col_launches}, {col_counts}")
    emit({"phase": "chaos_columns", "shape": [LOAD_N, LOAD_N], "dtype": "bfloat16",
          "columns": CHAOS_COLUMNS, "batch": CHAOS_COLUMN_BATCH,
          "poisoned": list(CHAOS_COLUMN_POISONED), "failed": col_failed,
          "max_rel_err_own_column": own_rel, "min_rel_err_other_column": other_rel,
          "rtol": 2 ** -7, "injected_by_spec": col_specs, "launches_by_route": col_launches,
          **col_counts})
    col_engine.close()
    del col_out, col_engine
    torch.cuda.empty_cache()

    # ---- 40. degrade and recover ----
    section("40. degrade and recover")
    deg_rng = np.random.default_rng(args.seed + 14)

    def deg_block(width):
        return torch.from_numpy(deg_rng.uniform(0, 10, (LOAD_N, width))).to(torch.bfloat16)

    def rel_to_plain(y, x) -> float:
        ref = gemm_plain(res_a, x.to(dev)).float().cpu()
        return ((y.float() - ref).abs() / ref.abs()).max().item()

    policy = ResiliencePolicy(breaker_reset_s=DEGRADE_RESET_S)
    deg = res_engine(policy, parse_fault_spec(
        f"compile:compile_error:key=gemm:*:cuda:*,times={DEGRADE_FAULTS}"))
    pref_key = f"gemm:blockwise:cuda:default:{DEGRADE_WIDTH}:bfloat16"
    safe_key = f"gemm:blockwise:torch:default:{DEGRADE_WIDTH}:bfloat16"
    steps, deg_rel = [], 0.0
    for i in range(DEGRADE_FAULTS + 1):  # three failures open it; one more skips it
        x = deg_block(DEGRADE_WIDTH)
        y, launched = routed("degrade", lambda: deg.submit(x).result())
        deg_rel = max(deg_rel, rel_to_plain(y, x))
        h = deg.health()
        steps.append({"request": i, "state": h["breakers"][pref_key]["state"],
                      "degraded": h["degraded"], "gemm_routes": launched["gemm"]})
        check(launched["gemm"] == {} and h["degraded"] == {pref_key: safe_key},
              f"degrade: request {i} left the torch tier {launched}, {h['degraded']}")
    check(steps[DEGRADE_FAULTS - 1]["state"] == "open"
          and h["counters"]["breaker_opens"] == 1
          and h["fault_injection"]["specs"][0]["injected"] == DEGRADE_FAULTS,
          f"degrade: breaker {steps}, {h['fault_injection']}")
    time.sleep(DEGRADE_RESET_S * 1.1)
    x = deg_block(DEGRADE_WIDTH)
    y, launched = routed("degrade", lambda: deg.submit(x).result())
    deg_rel = max(deg_rel, rel_to_plain(y, x))
    h = deg.health()
    check(h["breakers"][pref_key]["state"] == "closed" and h["degraded"] == {}
          and h["counters"]["recoveries"] == 1
          and set(launched["gemm"]) == {"wgmma_tma"},
          f"degrade: the probe {h['breakers'][pref_key]}, {h['degraded']}, {launched}")
    recovered = {"state": h["breakers"][pref_key]["state"], "gemm_routes": launched["gemm"]}
    check(deg_rel <= 2 ** -7, f"degrade: rel err {deg_rel}")
    deg.close()
    # Resource exhaustion at bucket 16 halves the block into two of bucket 8.
    shrink = res_engine(ResiliencePolicy(), parse_fault_spec(
        "dispatch:resource_exhausted:key=gemm:*:16:*,times=1"))
    x = deg_block(16)
    y, shrink_launched = routed("degrade", lambda: shrink.submit(x).result())
    shrink_rel = rel_to_plain(y, x)
    gemm_buckets = sorted({k.bucket for k in shrink._cache.keys() if k.op == "gemm"})
    check(shrink_rel <= 2 ** -7 and gemm_buckets == [8, 16]
          and shrink.health()["counters"]["downgrades"] == 1,
          f"degrade: halving, buckets {gemm_buckets}, rel {shrink_rel}")
    shrink.close()
    # Every GEMM level failing: per-column GEMVs on the `rows` route, bitwise
    # the engine's own vector results.
    floor = res_engine(ResiliencePolicy(), parse_fault_spec(
        "dispatch:device_error:key=gemm:*,retryable=0"))
    x = deg_block(SERVE_PROMOTE)
    y, floor_launched = routed("degrade", lambda: floor.submit(x).result())
    solo = torch.stack([floor.submit(x[:, j].contiguous()).result()
                        for j in range(SERVE_PROMOTE)], dim=1)
    floor_h = floor.health()
    # (The GEMM programs were built and captured before they failed: the
    # capture's warm run is their only launch.)
    check(torch.equal(y, solo) and set(floor_launched["gemv"]) == {"rows"}
          and floor_h["counters"]["downgrades"] == 1
          and floor_h["counters"]["dispatch_failures"] == 0,
          f"degrade: GEMV floor {floor_launched}, {floor_h['counters']}")
    emit({"phase": "degrade", "shape": [LOAD_N, LOAD_N], "dtype": "bfloat16",
          "width": DEGRADE_WIDTH, "compile_faults": DEGRADE_FAULTS,
          "breaker_reset_s": DEGRADE_RESET_S, "steps": steps, "probe": recovered,
          "max_rel_err_vs_plain": deg_rel, "rtol": 2 ** -7,
          "halving": {"buckets": gemm_buckets, "launches": shrink_launched,
                      "rel_err": shrink_rel},
          "gemv_floor": {"launches": floor_launched, "bitwise_vs_vectors": True}})
    floor.close()
    del deg, shrink, floor, res_a
    torch.cuda.empty_cache()

    # ---- 41. the quantized ladder ----
    section("41. the quantized ladder")
    # What the sections before still hold, and what only the cycle
    # collector would free (0 when every engine was freed on its last
    # reference).
    import gc

    torch.cuda.synchronize(dev)
    held_before_gc = torch.cuda.memory_allocated(dev)
    gc.collect()
    torch.cuda.empty_cache()
    held_after_gc = torch.cuda.memory_allocated(dev)
    q_a = resident_matrix(LOAD_N, LOAD_N, torch.float32, dev, args.seed)
    q_rng = np.random.default_rng(args.seed + 15)
    q_x = torch.from_numpy(q_rng.uniform(0, 10, LOAD_N)).float()
    q_blk = torch.from_numpy(q_rng.uniform(0, 10, (LOAD_N, SERVE_PROMOTE))).float()
    q_ref_x = gemv_cuda(q_a, q_x.to(dev)).cpu()
    q_ref_blk = gemm_cuda(q_a, q_blk.to(dev)).cpu()
    t0 = time.perf_counter()
    q_engine = res_engine(ResiliencePolicy(), parse_fault_spec(
        "dispatch:device_error:key=*:int8c,retryable=0"), a=q_a, dtype_storage="int8c",
        max_bucket=8)
    q_build_s = time.perf_counter() - t0
    del q_a
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    mem_before = torch.cuda.memory_allocated(dev)
    t0 = time.perf_counter()
    y_x, q_launched = routed("quant_ladder", lambda: q_engine.submit(q_x).result())
    place_s = time.perf_counter() - t0
    mem_after = torch.cuda.memory_allocated(dev)
    placed = q_engine._a_native
    y_blk, blk_launched = routed("quant_ladder", lambda: q_engine.submit(q_blk).result())
    q_rel = max(((y_x - q_ref_x).abs() / q_ref_x.abs()).max().item(),
                ((y_blk - q_ref_blk).abs() / q_ref_blk.abs()).max().item())
    q_h = q_engine.health()
    check(placed is not None and q_engine._a_native is placed
          and q_h["storage"]["native_fallback_resident"]
          and q_h["storage"]["device_resident_bytes"]
          == q_h["storage"]["resident_bytes"] + LOAD_N * LOAD_N * 4,
          f"quant_ladder: native tier {q_h['storage']}")
    check(q_rel <= 1e-4, f"quant_ladder: rel err {q_rel} against the native GEMV")
    # The quantized programs were built and captured before their dispatch
    # failed: the capture's warm run is their one launch each; the torch
    # tier served both requests.
    check(sum(q_launched["quant_gemv"].values()) == 1
          and sum(blk_launched["quant_gemv"].values()) == 1
          and not q_launched["gemv"] and not blk_launched["gemm"],
          f"quant_ladder: launches {q_launched}, {blk_launched}")
    emit({"phase": "quant_ladder", "shape": [LOAD_N, LOAD_N], "dtype": "float32",
          "storage": "int8c", "engine_build_s": q_build_s,
          "native_place_and_first_dispatch_s": place_s,
          "device_memory_before_bytes": mem_before, "device_memory_after_bytes": mem_after,
          "native_bytes": LOAD_N * LOAD_N * 4, "storage_health": q_h["storage"],
          "degraded": q_h["degraded"], "max_rel_err_vs_native_gemv": q_rel, "rtol": 1e-4,
          "native_placed_once": True, "launches": {"vector": q_launched,
                                                   "block": blk_launched},
          "held_at_start_bytes": held_before_gc,
          "freed_by_cycle_collector_bytes": held_before_gc - held_after_gc})
    q_engine.close()
    del q_engine, placed
    torch.cuda.empty_cache()

    # ---- 42. the solver ladder ----
    section("42. the solver ladder")
    s_a = solver_operand(SOLVER_N, "float32", args.seed, device=dev)
    s_b = seeded_rhs(SOLVER_N)

    def solver_engine(plan):
        return MatvecEngine(s_a, make_mesh(1), strategy="rowwise", promote=None,
                            solver_kernel="cuda_fused", resilience=ResiliencePolicy(),
                            fault_plan=parse_fault_spec(plan))

    s_engine = solver_engine("compile:compile_error:key=cg:*:cuda_fused:*")
    (res, ms), counts = drive("solver_ladder", lambda: timed_solve(
        s_engine, op="cg", rhs=s_b, rtol=SOLVER_RTOL))
    s_rel = rel_residual(s_a, s_b, res.x)
    s_h = s_engine.health()
    # The torch tier runs gemv_torch: no hand-written kernel launches.
    check(res.converged and s_rel <= residual_bound and counts["solver_step"] == 0
          and counts["gemv"] == 0
          and list(s_h["degraded"].values()) == [
              f"cg:rowwise:torch:default:{s_engine._cache.keys()[0].bucket}:float32"],
          f"solver_ladder: {s_rel}, {counts}, {s_h['degraded']}")
    nan_engine = solver_engine("dispatch:nan:times=1")
    refused = None
    try:
        drive("solver_chaos", lambda: nan_engine.submit(op="cg", rhs=s_b,
                                                        rtol=SOLVER_RTOL).result())
    except SolverDivergedError as e:
        refused = str(e)
    (res2, _), counts2 = drive("solver_chaos", lambda: timed_solve(
        nan_engine, op="cg", rhs=s_b, rtol=SOLVER_RTOL))
    s_rel2 = rel_residual(s_a, s_b, res2.x)
    check(refused is not None and "non-finite" in refused and res2.converged
          and s_rel2 <= residual_bound and counts2["solver_step"] > 0,
          f"solver_chaos: refused {refused!r}, then {s_rel2}, {counts2}")
    emit({"phase": "solver_ladder", "op": "cg", "shape": [SOLVER_N, SOLVER_N],
          "dtype": "float32", "fault": "compile:compile_error:key=cg:*:cuda_fused:*",
          "degraded": s_h["degraded"], "n_iters": res.n_iters, "solve_ms": ms,
          "rel_residual_fp64": s_rel, "rtol": SOLVER_RTOL, "launches": counts,
          "nan_refused": refused, "next_solve_rel_residual": s_rel2,
          "next_solve_launches": counts2})
    s_engine.close()
    nan_engine.close()
    del s_engine, nan_engine, s_a
    torch.cuda.empty_cache()

    launches_by_path["gemv"].update(
        {p: n for p, n in resil_launches["gemv"].items()})
    launches_by_path["gemm"].update(
        {p: n for p, n in resil_launches["gemm"].items()})
    quant_launches.update(resil_launches["quant_gemv"])
    gemv_routes["resilience"] = dict(resil_routes["gemv"])
    gemm_routes["resilience"] = dict(resil_routes["gemm"])

    launches_by_path["gemv"]["load_serve"] = sum(load_launches["gemv"].values())
    launches_by_path["gemm"]["load_serve"] = sum(load_launches["gemm"].values())
    quant_launches["load_serve_quant"] = sum(load_launches["quant_gemv"].values())
    quant_routes["load_serve_quant"] = {"wgmma_split": quant_launches["load_serve_quant"]}
    gemv_routes["load_serve"] = dict(load_routes["gemv"])
    gemm_routes["load_serve"] = dict(load_routes["gemm"])

    # ---- 43. multi-tenant residency ----
    section("43. multi-tenant residency")
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    mt_mesh = make_mesh(1)
    mt_payload = MT_N * MT_N * 2
    mt_routes = {"gemv": Counter(), "gemm": Counter(), "quant_gemv": Counter()}
    mt_counts = Counter()

    def mt_routed(name: str, fn):
        """fn() with the launch counts set to 0 just before it and read just
        after; the launches go to the kernels line's multitenant paths."""
        reset_launches()
        out = fn()
        torch.cuda.synchronize(dev)
        for kernel, wrapper in (("gemv", gemv_cuda), ("gemm", gemm_cuda),
                                ("quant_gemv", quant_gemv_cuda)):
            mt_routes[kernel].update(wrapper.route_launches)
            mt_counts[(kernel, name)] += wrapper.launches
        return out

    # The pinned host-to-card copy probe, in this run: what a swap-in from
    # page-locked memory could reach.
    probe_host = torch.empty(MT_PROBE_BYTES, dtype=torch.uint8, pin_memory=True)
    probe_dev = torch.empty(MT_PROBE_BYTES, dtype=torch.uint8, device=dev)
    pinned_ms = event_ms(lambda: probe_dev.copy_(probe_host, non_blocking=True), reps=3)
    pinned_gbps = MT_PROBE_BYTES / (pinned_ms * 1e-3) / 1e9
    del probe_host, probe_dev
    torch.cuda.empty_cache()

    # Every placement a registry makes goes through ensure_resident: time
    # each one that places, from an idle stream to the copy's end.
    swap_s: list[float] = []
    ensure_resident = MatvecEngine.ensure_resident

    def timed_ensure_resident(self):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        placed = ensure_resident(self)
        torch.cuda.synchronize(dev)
        if placed:
            swap_s.append(time.perf_counter() - t0)
        return placed

    MatvecEngine.ensure_resident = timed_ensure_resident

    def swap_stats(seconds: list[float], nbytes: int) -> dict:
        return {"swap_ins_timed": len(seconds), "swap_in_s": seconds,
                "swap_in_median_s": statistics.median(seconds),
                "swap_in_gbps_median": nbytes / statistics.median(seconds) / 1e9,
                "pinned_probe_gbps": pinned_gbps,
                "share_of_pinned_probe": nbytes / statistics.median(seconds) / 1e9
                / pinned_gbps}

    try:
        # (a) The eviction smoke: three tenants under a budget of two.
        mt_x = torch.from_numpy(
            np.random.default_rng(args.seed + 16).uniform(0, 10, MT_N)).to(torch.bfloat16)
        freed: list[dict] = []
        mt_allocated = [0]

        def on_evict(victim, caused_by, score, restore_bytes):
            torch.cuda.synchronize(dev)
            freed.append({"victim": victim, "caused_by": caused_by,
                          "freed_bytes": mt_allocated[0] - torch.cuda.memory_allocated(dev)})

        reg = MatrixRegistry(mt_mesh, hbm_budget=MT_SMOKE_BUDGET * mt_payload,
                             eviction_listener=on_evict, strategy="blockwise",
                             kernel="cuda", promote=None)
        mt_rel = {}
        t0 = time.perf_counter()
        for i in range(MT_SMOKE_TENANTS):
            a = resident_matrix(MT_N, MT_N, torch.bfloat16, dev, args.seed + 20 + i)
            ref = gemv_plain(a, mt_x.to(dev))
            bound = gemv_plain(a, mt_x.to(dev).abs())
            reg.register(f"t{i}", a)
            del a
            mt_rel[f"t{i}"] = (ref.cpu(), bound.cpu())
        register_s = time.perf_counter() - t0
        torch.cuda.empty_cache()
        first, served, ledger_ok = {}, [], True
        swaps_before = len(swap_s)
        for tid in (f"t{i}" for i in MT_SMOKE_ORDER):
            torch.cuda.synchronize(dev)
            mt_allocated[0] = torch.cuda.memory_allocated(dev)
            y = mt_routed("multitenant", lambda: reg.submit(tid, mt_x).result())
            if tid not in first:
                ref, bound = mt_rel[tid]
                err = ((y.float() - ref).abs() / bound).max().item()
                check(err <= 2 ** -7, f"multitenant: {tid}'s result {err} from the fp32 product")
                first[tid] = y
            else:
                check(torch.equal(y, first[tid]),
                      f"multitenant: {tid}'s re-admitted result is not bitwise its first")
            gauges = reg.metrics.snapshot()["gauges"]
            engines = [reg._entry(f"t{i}").engine for i in range(MT_SMOKE_TENANTS)]
            ledger_ok &= (gauges["registry_hbm_charged_bytes"]
                          == sum(e.device_resident_bytes for e in engines))
            served.append(tid)
        check(ledger_ok, "multitenant: registry_hbm_charged_bytes is not the sum of "
              "the tenants' device_resident_bytes")
        check(len(first) == MT_SMOKE_TENANTS
              and not any(torch.equal(first[s], first[t]) for s in first for t in first
                          if s < t),
              "multitenant: two tenants served the same result")
        check(len(freed) == len(MT_SMOKE_ORDER) - MT_SMOKE_BUDGET
              and all(f["freed_bytes"] >= mt_payload for f in freed),
              f"multitenant: evictions {freed} did not each free {mt_payload} bytes")
        check(set(mt_routes["gemv"]) == {"rows"} and not mt_routes["quant_gemv"],
              f"multitenant: GEMV routes {dict(mt_routes['gemv'])}")
        health = reg.health()
        smoke_swaps = swap_s[swaps_before:]
        emit({"phase": "multitenant", "shape": [MT_N, MT_N], "dtype": "bfloat16",
              "strategy": "blockwise", "tenants": MT_SMOKE_TENANTS,
              "budget_payloads": MT_SMOKE_BUDGET, "order": served,
              "register_s": register_s, "evictions": freed,
              "payload_bytes": mt_payload, "readmissions_bitwise": True,
              "ledger_equals_device_resident_bytes": True, "hbm": health["hbm"],
              "gemv_routes": dict(mt_routes["gemv"]),
              "launches": mt_counts[("gemv", "multitenant")],
              **swap_stats(smoke_swaps, mt_payload)})
        reg.close()
        del reg, first, mt_rel, y
        gc.collect()
        torch.cuda.empty_cache()

        # (b) The trace, through the bench's entry point.
        trace_results = []
        swaps_before = len(swap_s)
        metrics_path = Path(tempfile.mkdtemp()) / "multitenant_metrics.json"
        trace = mt_routed("multitenant_trace", lambda: run_serve_multitenant(
            "blockwise", mt_mesh, MT_N, MT_N, dtype="bfloat16", kernel="cuda",
            n_tenants=MT_TRACE_TENANTS, zipf_a=MT_ZIPF_A, hbm_budget=MT_TRACE_BUDGET,
            pin_hot=MT_PIN_HOT, n_requests=MT_TRACE_REQUESTS, seed=args.seed,
            metrics_out=str(metrics_path),
            on_result=lambda tid, x, y: trace_results.append((tid, x, y))))
        trace_swaps = swap_s[swaps_before:]
        counters = json.loads(metrics_path.read_text())["counters"]
        shutil.rmtree(metrics_path.parent, ignore_errors=True)
        all_row = trace.rows[-1]
        check(len(trace_results) == MT_TRACE_REQUESTS and all_row.failed_requests == 0,
              f"multitenant_trace: {len(trace_results)} served, {all_row}")
        check(trace.hit_rate == trace.lru_floor,
              f"multitenant_trace: hit rate {trace.hit_rate} != LRU floor {trace.lru_floor}")
        trace_err = 0.0
        for i in range(MT_TRACE_TENANTS):
            tid = f"tenant-{i}"
            mine = [(x, y) for t, x, y in trace_results if t == tid]
            if not mine:
                continue
            a = resident_matrix(MT_N, MT_N, torch.bfloat16, dev, args.seed + i)
            refs = {}
            for x, y in mine:
                key = x.view(torch.int16).numpy().tobytes()
                if key not in refs:
                    xd = x.to(dev)
                    refs[key] = (gemv_plain(a, xd).cpu(), gemv_plain(a, xd.abs()).cpu())
                ref, bound = refs[key]
                trace_err = max(trace_err, ((y.float() - ref).abs() / bound).max().item())
            del a
        check(trace_err <= 2 ** -7, f"multitenant_trace: {trace_err} from the fp32 product")
        check(set(mt_routes["gemv"]) == {"rows"},
              f"multitenant_trace: GEMV routes {dict(mt_routes['gemv'])}")
        emit({"phase": "multitenant_trace", "shape": [MT_N, MT_N], "dtype": "bfloat16",
              "strategy": "blockwise", "tenants": MT_TRACE_TENANTS, "zipf_a": MT_ZIPF_A,
              "hbm_budget": trace.hbm_budget, "budget_tenants": trace.budget_tenants,
              "pin_hot": MT_PIN_HOT, "requests": MT_TRACE_REQUESTS,
              "hit_rate": trace.hit_rate, "lru_floor": trace.lru_floor,
              "evictions": all_row.evictions,
              "swap_ins": counters.get("registry_swap_ins_total", 0),
              "wall_s": trace.wall_s, "req_per_s": trace.rps,
              "max_err_vs_fp32_product": trace_err, "tolerance": 2 ** -7,
              "per_tenant": {r.tenant: {"requests": r.requests, "hits": r.hits,
                                        "evictions": r.evictions}
                             for r in trace.rows[:-1]},
              "launches": mt_counts[("gemv", "multitenant_trace")],
              **swap_stats(trace_swaps, mt_payload)})
        del trace_results
        gc.collect()
        torch.cuda.empty_cache()

        # (c) Isolation: faults on tenant-1, a quota on tenant-2.
        iso = mt_routed("multitenant_isolation", lambda: run_serve_multitenant(
            "blockwise", mt_mesh, MT_N, MT_N, dtype="bfloat16", kernel="cuda",
            n_tenants=MT_TRACE_TENANTS, zipf_a=MT_ZIPF_A, hbm_budget=MT_TRACE_BUDGET,
            n_requests=MT_CHAOS_REQUESTS, seed=args.seed, fault_spec=MT_CHAOS_FAULT,
            tenant_quota=MT_CHAOS_QUOTA))
        by_tenant = {r.tenant: r for r in iso.rows}
        check(by_tenant["tenant-1"].availability == 0.0
              and by_tenant["tenant-2"].quota_rejections > 0
              and all(by_tenant[t].availability == 1.0 for t in ("tenant-0", "tenant-3")),
              f"multitenant_isolation: {iso.rows}")
        emit({"phase": "multitenant_isolation", "shape": [MT_N, MT_N], "dtype": "bfloat16",
              "fault_spec": MT_CHAOS_FAULT, "tenant_quota": MT_CHAOS_QUOTA,
              "requests": MT_CHAOS_REQUESTS, "wall_s": iso.wall_s,
              "per_tenant": {r.tenant: {"requests": r.requests,
                                        "availability": r.availability,
                                        "failed": r.failed_requests,
                                        "quota_rejections": r.quota_rejections,
                                        "evictions": r.evictions}
                             for r in iso.rows},
              "launches": mt_counts[("gemv", "multitenant_isolation")]})
        gc.collect()
        torch.cuda.empty_cache()

        # (d) Quantized tenants: two int8c residents under a budget of one.
        q_block = default_block(MT_QUANT_N, 1)
        q_bytes = 2 * MT_QUANT_N * MT_QUANT_N + 2 * MT_QUANT_N * (MT_QUANT_N // q_block) * 4
        q_x = torch.from_numpy(
            np.random.default_rng(args.seed + 17).uniform(0, 10, MT_QUANT_N)).float()
        qreg = MatrixRegistry(mt_mesh, hbm_budget=q_bytes, strategy="blockwise",
                              kernel="cuda", promote=None, dtype_storage="int8c")
        for i in range(2):
            qreg.register(f"q{i}", resident_matrix(MT_QUANT_N, MT_QUANT_N, torch.float32,
                                                   dev, args.seed + 30 + i))
        torch.cuda.empty_cache()
        q_first, q_charged = {}, []
        swaps_before = len(swap_s)
        for tid in (f"q{i}" for i in MT_QUANT_ORDER):
            y = mt_routed("multitenant_quant", lambda: qreg.submit(tid, q_x).result())
            engine = qreg._entry(tid).engine
            q_charged.append(qreg.tenant_stats(tid)["resident_bytes"])
            if tid not in q_first:
                plain = quant_gemv_plain(engine_payload(engine), q_x.to(dev)).cpu()
                rel = ((y - plain).abs() / plain.abs()).max().item()
                check(rel <= 1e-4, f"multitenant_quant: {tid} {rel} from its plain version")
                q_first[tid] = y
            else:
                check(torch.equal(y, q_first[tid]),
                      f"multitenant_quant: {tid}'s re-admitted result is not bitwise its first")
        check(all(c == q_bytes for c in q_charged),
              f"multitenant_quant: charged {q_charged}, payload and scales {q_bytes}")
        check(set(mt_routes["quant_gemv"]) == {"wgmma_split"},
              f"multitenant_quant: routes {dict(mt_routes['quant_gemv'])}")
        q_health = qreg.health()
        emit({"phase": "multitenant_quant", "shape": [MT_QUANT_N, MT_QUANT_N],
              "dtype": "float32", "storage": "int8c", "block": q_block,
              "budget_bytes": q_bytes, "charged_bytes": q_charged,
              "payload_and_scales_bytes": q_bytes, "readmissions_bitwise": True,
              "evictions": sum(s["evictions"] for s in q_health["tenants"].values()),
              "quant_routes": dict(mt_routes["quant_gemv"]),
              "launches": mt_counts[("quant_gemv", "multitenant_quant")],
              **swap_stats(swap_s[swaps_before:], q_bytes)})
        qreg.close()
        del qreg, q_first, y
    finally:
        MatvecEngine.ensure_resident = ensure_resident
    gc.collect()
    torch.cuda.empty_cache()
    for (kernel, name), n in mt_counts.items():
        if n:
            if kernel == "quant_gemv":
                quant_launches[name] = n
            else:
                launches_by_path[kernel][name] = n
    gemv_routes["multitenant"] = dict(mt_routes["gemv"])
    quant_routes["multitenant_quant"] = dict(mt_routes["quant_gemv"])

    # ---- 44. the cost model and the global scheduler ----
    section("44. the cost model and the global scheduler")
    gc.collect()
    torch.cuda.empty_cache()
    for kernel, paths in cost_model_section(dev, args.seed, CM).items():
        target = quant_launches if kernel == "quant_gemv" else launches_by_path[kernel]
        for name, n in paths.items():
            target[name] = n

    # ---- 45. speculative dispatch ----
    section("45. speculative dispatch")
    gc.collect()
    torch.cuda.empty_cache()
    spec_launches, spec_routes = speculative_section(dev, args.seed, SP)
    for kernel, paths in spec_launches.items():
        target = quant_launches if kernel == "quant_gemv" else launches_by_path[kernel]
        for name, n in paths.items():
            target[name] = n
    for name, by_route in spec_routes["quant_gemv"].items():
        quant_routes[name] = by_route
    for name, by_route in spec_routes["gemv"].items():
        gemv_routes[name] = by_route
    for name, by_route in spec_routes["gemm"].items():
        gemm_routes[name] = by_route

    # ---- 46. precision tiers and the solver models ----
    section("46. precision tiers and the solver models")
    gc.collect()
    torch.cuda.empty_cache()
    for kernel, paths in precision_section(dev, args.seed, PS).items():
        for name, n in paths.items():
            launches_by_path[kernel][name] = n

    # ---- 47. the benchmark path ----
    section("47. the benchmark path")
    gc.collect()
    torch.cuda.empty_cache()
    for kernel, paths in benchmark_path_section(dev, args.seed, BP, pinned_gbps).items():
        target = flash_launches if kernel == "flash_attention" else launches_by_path[kernel]
        for name, n in paths.items():
            target[name] = n

    # ---- 48. the runtime remainder ----
    section("48. the runtime remainder")
    gc.collect()
    torch.cuda.empty_cache()
    for kernel, paths in runtime_section(dev, args.seed, RT).items():
        for name, n in paths.items():
            launches_by_path[kernel][name] = n

    # ---- 49. the kernels line ----
    section("49. the kernels line")
    emit({"phase": "phase_seconds", "sections": clock["seconds"],
          "total_s": sum(clock["seconds"].values())})
    head = at["{0}x{0}".format(KERNEL_SHAPES[-1][0])]
    gemm_head = gemm_at["{0}x{1}x{2}_{3}".format(*GEMM_TIME_SHAPES[GEMM_HEAD])]
    quant_head = quant_at["{0}x{0}_{1}_n{2}".format(*QUANT_TIME_SHAPES[QUANT_HEAD])]
    ring_head = ring_at[f"{RING_N}x{RING_N}_p{RING_TIME_P[0]}"]
    flash_head = flash_at["8x4096x4096x128_bfloat16_causal0"]
    emit({"kernels": [{
        "name": "gemv", "route": "cuda",
        "source": "matvec_mpi_multiplier_torch/csrc/gemv.cu",
        "replaces": "matvec_mpi_multiplier_tpu/ops/pallas_gemv.py:61",
        "launches": sum(launches_by_path["gemv"].values()),
        "launches_by_path": launches_by_path["gemv"],
        # Routes: rows (one warp per row, m >= 4 warps an SM) and split (every
        # row's slabs over the resident warps, then a second launch that
        # sums them); launches (wrapper calls) by path and route.
        "route_launches_by_path": gemv_routes,
        "max_abs_err": max(v["max_abs_err"] for v in at.values()),
        "ms": head["ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": head["library_ms"],
        "library_call": "torch.matmul(a, x[:, None]) in a's dtype, allow_tf32=False",
        "hbm_probe_gbps": probe_gbps, "hbm_nominal_gbps": H100_HBM_PEAK_GBPS,
        "at": at,
        # Cold-L2 single launches at the sweeps' shapes (see the lines).
        "asymmetric": {key: {f: v[f] for f in ("route", "ms", "library_ms", "bound_ms",
                                                "share_of_bound")}
                       for key, v in asym_at.items()},
        "square_sweep": {key: {f: v[f] for f in ("route", "ms", "library_ms", "bound_ms",
                                                  "share_of_bound")}
                         for key, v in square_at.items()},
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
        # Routes: wgmma_tma (bf16/fp16 A that TMA can describe), mma_sync
        # (other 16-bit A), ffma (fp32), dfma (fp64); a wgmma_tma call whose
        # B is transposed first is two kernel launches (see "at").
        "gemm_route": gemm_head["route"],
        "route_launches_by_path": gemm_routes,
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
        # bound_ms counts the contraction once on the tensor cores;
        # ffma_bound_ms is the CUDA-core design's ceiling, passes_ceiling_ms
        # the route's passes over x's parts (see quant_bound).
        "ffma_bound_ms": quant_head["ffma_bound_ms"],
        "passes_ceiling_ms": quant_head["passes_ceiling_ms"],
        # No PyTorch call computes a block-scaled GEMV; native_ms is the
        # port's own GEMV on the same A in fp32, what quantizing must beat.
        "library_ms": None, "native_ms": quant_head["native_ms"],
        "native_call": quant_head["native_call"],
        # Routes: wgmma (bf16/fp16 x), wgmma_split (fp32 x), fma (fp64 x and
        # shapes TMA or wgmma cannot take); a tensor-core call on a block of
        # columns is two kernel launches (x's parts, then the GEMV).
        "quant_route": quant_head["quant_route"], "consumer": quant_head["consumer"],
        "route_launches_by_path": quant_routes,
        "at": quant_at,
    }, {
        "name": "solver_step", "route": "cuda",
        "source": "matvec_mpi_multiplier_torch/csrc/solver_step.cu",
        "replaces": "matvec_mpi_multiplier_tpu/ops/pallas_solver.py:190",
        # Each step call is two kernel launches: the update, then the GEMV.
        "launches": sum(solver_paths["solver_step"].values()),
        "kernel_launches_per_call": 2,
        "launches_by_path": solver_paths["solver_step"],
        # A native shard's GEMV by the route gemv_plan picks (split: one
        # kernel launch more); by path, and on the check shapes.
        "gemv_route_launches_by_path": step_gemv_routes,
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
    }, {
        "name": "flash_attention", "route": "cuda",
        "source": "matvec_mpi_multiplier_torch/csrc/flash_attention.cu",
        "replaces": "matvec_mpi_multiplier_tpu/ops/pallas_attention.py:59",
        "launches": sum(flash_launches.values()),
        "launches_by_path": flash_launches,
        "max_abs_err": flash_head["max_abs_err"],
        "ms": flash_head["ms"], "plain_ms": flash_head["plain_ms"],
        "bound_ms": flash_head["bound_ms"], "bound_by": flash_head["bound_by"],
        # bound_ms: the work once at the tensor cores' peak; ffma_bound_ms:
        # the same work's ceiling on fp32 FFMA (the ffma route's).
        "ffma_bound_ms": flash_head["ffma_bound_ms"],
        # Routes: wgmma_split (bf16 k/v, d = 128), ffma (fp32 k/v, d = 256).
        "flash_route": flash_head["route"],
        "route_launches_by_path": flash_routes,
        # Registers per thread and shared memory per CTA of each kernel.
        "launch_info": {"wgmma_split": flash_launch_info("wgmma_split", torch.bfloat16),
                        "ffma_bf16": flash_launch_info("ffma", torch.bfloat16),
                        "ffma_fp32": flash_launch_info("ffma", torch.float32)},
        # SDPA returns the normalized output, not the partial; the same q, k
        # and v as (1, h, s, d), fp32 (and bf16: library_bfloat16_ms).
        "library_ms": flash_head["library_ms"],
        "library_call": "torch.nn.functional.scaled_dot_product_attention on "
                        "(1, h, s, d) fp32, scale=1, under the backend named",
        "library_backend": flash_head["library_backend"],
        "at": flash_at,
    }]})

    # ---- 50. result ----
    section("50. result")
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
