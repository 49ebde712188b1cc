"""Benchmark sweep CLI (the port's counterpart of the JAX package's
``bench/sweep.py``: ``--op matvec``, ``gemm`` and ``serve``).

Reference analog: ``test.sh`` — for each strategy it runs
``n_proc ∈ {1,2,6,12,24}`` × ``n ∈ {600,1800,...,10200}`` square sizes
(``test.sh:5,8``), appending to the per-strategy CSV. The asymmetric sweep
(120–1200 × 60000, quirk Q10) is first-class here too.

Usage::

    python -m matvec_mpi_multiplier_torch.bench.sweep --strategy blockwise \\
        --sizes 32768 --dtype bfloat16
    python -m matvec_mpi_multiplier_torch.bench.sweep --platform cpu \\
        --host-devices 4 --sizes 64 --n-reps 3
    python -m matvec_mpi_multiplier_torch.bench.sweep --op gemm \\
        --strategy blockwise --sizes 4096 --n-rhs 4096 --dtype bfloat16
    python -m matvec_mpi_multiplier_torch.bench.sweep --op serve \\
        --strategy blockwise --sizes 65536 --dtype bfloat16 --promote 4

``--platform cuda`` (the default) runs on the CUDA devices and fails when
there are none; ``--platform cpu --host-devices p`` runs on p logical CPU
shards. Operands are generated in memory from ``--seed`` (the numpy
generator of ``utils/io.py``, so both packages time the same data);
``--use-files`` goes through ``./data/matrix_*.txt`` (matvec only). ``--op
gemm`` times ``C = A @ B`` (rows in ``gemm_<strategy>.csv``); ``--op serve``
delegates to ``bench/serve.py``. ``--dtype-storage int8|int8c|fp8`` times
the strategies against a quantized A (rows labelled ``<strategy>_<format>``).
``--combine`` names the combine schedule (strategies without it are
skipped) and ``--stages`` pins the staged ``overlap`` schedules' S.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

import torch

from ..models import available_strategies, get_strategy
from ..models.gemm import available_gemm_strategies, validate_gemm
from ..ops import available_gemm_kernels, available_kernels
from ..parallel.mesh import make_mesh
from ..utils import io
from ..utils.errors import ConfigError, MatvecError
from .metrics import append_result, csv_path
from .timing import (
    MEASURE_METHODS,
    TIMING_MODES,
    benchmark_gemm,
    benchmark_strategy,
)

# The reference's sweeps (test.sh:5,8 and the asymmetric CSVs' sizes).
SQUARE_SIZES = list(range(600, 10201, 1200))
ASYMMETRIC_SIZES = [(r, 60000) for r in range(120, 1201, 120)]


def platform_devices(platform: str, host_devices: int | None) -> list[torch.device]:
    """The device list a sweep meshes over."""
    if platform == "cpu":
        return [torch.device("cpu")] * (host_devices or 1)
    if host_devices is not None:
        raise ConfigError("--host-devices applies to --platform cpu only")
    if not torch.cuda.is_available():
        raise ConfigError(
            "--platform cuda (the default) found no CUDA device; pass "
            "--platform cpu for a CPU run"
        )
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def device_counts_available(n: int) -> list[int]:
    """Power-of-two subset mesh sizes up to ``n`` devices (plus ``n``) — the
    analog of test.sh's {1,2,6,12,24} process list on a fixed machine."""
    counts = []
    c = 1
    while c <= n:
        counts.append(c)
        c *= 2
    if counts[-1] != n:
        counts.append(n)
    return counts


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="matvec-torch-sweep",
        description="Benchmark sweep over strategies x device counts x sizes "
        "(the PyTorch port's replacement for the reference's test.sh).",
    )
    p.add_argument(
        "--strategy", nargs="+", default=["all"],
        help=f"strategies to run: {available_strategies()} or 'all' "
        f"(with --op gemm: {available_gemm_strategies()})",
    )
    p.add_argument(
        "--op", choices=["matvec", "gemm", "serve"], default="matvec",
        help="operation to sweep: matvec (y = A·x), gemm (C = A @ B; rows in "
        "gemm_<strategy>.csv) or serve (a mixed-width request stream through "
        "the serving engine; rows in serve_<strategy>.csv — bench/serve.py)",
    )
    p.add_argument("--n-requests", type=int, default=200,
                   help="with --op serve: steady-phase request count")
    p.add_argument("--max-bucket", type=int, default=32,
                   help="with --op serve: widest batch bucket")
    p.add_argument(
        "--promote", default="auto",
        help="with --op serve: GEMV->GEMM crossover b* — 'auto' (the static "
        "default), an int, or 'never'",
    )
    p.add_argument(
        "--n-rhs", type=int, default=None,
        help="with --op gemm: columns of B (default: square, n_rhs = n_cols)",
    )
    p.add_argument(
        "--devices", nargs="+", type=int, default=None,
        help="device counts to sweep (default: powers of two up to available)",
    )
    p.add_argument(
        "--sweep", choices=["square", "asymmetric", "both"], default="square",
        help="size sweep: square 600..10200 step 1200 (test.sh:8) or "
        "asymmetric 120..1200 x 60000 (the long-contraction regime)",
    )
    p.add_argument(
        "--sizes", nargs="+", type=int, default=None,
        help="explicit square sizes, overriding --sweep",
    )
    p.add_argument("--dtype", default="float32", help="operand dtype")
    p.add_argument(
        "--dtype-storage", dest="dtype_storage", default=None,
        choices=["native", "int8", "int8c", "fp8", "auto"],
        help="resident-A storage format (ops/quantize.py): quantize A per "
        "config and measure the strategy against the low-bit payload. Rows "
        "are labelled <strategy>_<format> so native and quantized "
        "measurements of the same config coexist in the CSVs. --op serve "
        "forwards it to the engine; 'auto' is serve-only",
    )
    p.add_argument(
        "--n-reps", type=int, default=100,
        help="repetitions per config (reference: 100, src/multiplier_rowwise.c:135)",
    )
    p.add_argument(
        "--mode", choices=list(TIMING_MODES) + ["both"], default="amortized",
        help="'amortized': operands resident on the device; 'reference': "
        "host->device transfer timed every rep (quirk Q5 parity)",
    )
    p.add_argument(
        "--kernel", default="cuda",
        help=f"local kernel: {available_kernels()} (with --op gemm: "
        f"{available_gemm_kernels()})",
    )
    p.add_argument(
        "--combine",
        default=None,
        choices=[
            "auto", "psum", "psum_scatter", "ring", "ring_overlap", "a2a",
            "gather", "overlap", "overlap_ring", "pallas_ring",
        ],
        help="combine-schedule override: a concrete schedule name, or "
        "'auto' (no tuning cache yet: the static default) — see "
        "MatvecStrategy.build. 'overlap' is the staged pipeline (stage "
        "count from --stages); 'pallas_ring' the fused ring kernel (1-D "
        "meshes, matvec only). Strategies without the schedule are skipped",
    )
    p.add_argument(
        "--stages",
        type=int,
        default=None,
        help="with --combine overlap: pin the pipeline's stage count S "
        "(default: 2, the tuning cache's miss); clamped down to the "
        "largest valid divisor of the per-device chunk",
    )
    p.add_argument(
        "--measure", choices=list(MEASURE_METHODS), default="auto",
        help="'chain': slope between event-timed call chains (amortized "
        "default); 'sync': literal per-rep fence protocol (reference "
        "default); 'loop' is not ported yet",
    )
    p.add_argument(
        "--chain-samples", type=int, default=None,
        help="independent chain-slope estimates per config (median reported; "
        "default 5)",
    )
    p.add_argument(
        "--use-files", action="store_true",
        help="load operands via the ./data/matrix_*.txt convention",
    )
    p.add_argument("--data-root", default=None, help="data directory override")
    p.add_argument(
        "--platform", choices=["cuda", "cpu"], default="cuda",
        help="devices to mesh over: the CUDA devices (default) or CPU shards",
    )
    p.add_argument(
        "--host-devices", type=int, default=None,
        help="with --platform cpu: number of logical CPU shards, the "
        "reference's 'mpiexec -n p on one machine' analog",
    )
    p.add_argument("--seed", type=int, default=0)
    p.add_argument(
        "--no-csv", action="store_true", help="print results without writing CSVs"
    )
    return p


def resolve_strategies(names: list[str], op: str = "matvec") -> list[str]:
    available = available_gemm_strategies() if op == "gemm" else available_strategies()
    if "all" in names:
        return available
    for n in names:
        if n not in available:
            raise SystemExit(f"unknown strategy {n!r}; available: {available}")
    return names


def operands(n_rows: int, n_cols: int, args):
    if args.use_files:
        return io.ensure_data(n_rows, n_cols, args.data_root, seed=args.seed)
    return (
        io.generate_matrix(n_rows, n_cols, seed=args.seed),
        io.generate_vector(n_cols, seed=args.seed + 1),
    )


def csv_label(name: str, op: str, storage: str | None = None) -> str:
    """The strategy label as CSV rows record it: ``gemm_<name>`` for GEMM
    rows, then ``_<format>`` for quantized storage."""
    label = f"gemm_{name}" if op == "gemm" else name
    return label if storage in (None, "native") else f"{label}_{storage}"


def run_sweep(args: argparse.Namespace) -> int:
    if args.op == "serve":
        # The serve protocol has its own loop (warmup/steady phases,
        # futures, promotion check) — bench/serve.py.
        from .serve import run_serve_sweep

        return run_serve_sweep(args)
    storage = getattr(args, "dtype_storage", None)
    if storage == "auto":
        raise SystemExit(
            "--dtype-storage auto is serve-only (the engine resolves it at "
            "construction); a matvec/gemm sweep measures ONE format per run: "
            "name it (int8/int8c/fp8)"
        )
    gemm = args.op == "gemm"
    if gemm and args.use_files:
        raise SystemExit(
            "--use-files is matvec-only (the reference's vector-file "
            "convention has no rank-2 right-hand side); gemm operands are "
            "generated in memory"
        )
    kernels = available_gemm_kernels() if gemm else available_kernels()
    if args.kernel not in kernels:
        raise SystemExit(
            f"unknown {args.op} kernel {args.kernel!r}; available: {kernels}"
        )
    if gemm and args.combine == "gather":
        raise SystemExit(
            "--combine gather is matvec-only; gemm accepts the in-body "
            "schedules (psum, psum_scatter, ring, ring_overlap, a2a, "
            "overlap, overlap_ring) or auto"
        )
    if args.measure in ("chain", "loop") and args.mode in ("reference", "both"):
        raise SystemExit(
            f"--measure {args.measure} cannot time --mode reference; use "
            "--measure sync or auto"
        )
    devices = platform_devices(args.platform, args.host_devices)
    strategies = resolve_strategies(args.strategy, args.op)
    counts = args.devices or device_counts_available(len(devices))
    if args.sizes:
        sizes = [(s, s) for s in args.sizes]
    elif args.sweep == "square":
        sizes = [(s, s) for s in SQUARE_SIZES]
    elif args.sweep == "asymmetric":
        sizes = list(ASYMMETRIC_SIZES)
    else:
        sizes = [(s, s) for s in SQUARE_SIZES] + list(ASYMMETRIC_SIZES)
    modes = list(TIMING_MODES) if args.mode == "both" else [args.mode]
    meshes = {n: make_mesh(n, devices=devices) for n in counts}

    n_ok = n_skip = 0
    # Sizes outermost: each operand pair is generated once and shared.
    for n_rows, n_cols in sizes:
        n_rhs = (args.n_rhs or n_cols) if gemm else 1
        a = x = None
        for name in strategies:
            strat = get_strategy(name)
            if args.combine is not None and not (
                strat.supports_combine_batched(args.combine) if gemm
                else strat.supports_combine(args.combine)
            ):
                # e.g. --combine psum_scatter under --strategy all: rowwise
                # has no such schedule. A skip, not a crash.
                print(f"skip {name} {n_rows}x{n_cols}: no combine schedule "
                      f"{args.combine!r} for this strategy")
                n_skip += 1
                continue
            # The strategy the schedule binds validates the shape (the
            # scatter family's rows, pallas_ring's 1-D mesh).
            bound = None if args.combine in (None, "auto") else strat.with_combine(args.combine)
            for n_dev in counts:
                mesh = meshes[n_dev]
                try:
                    if gemm:
                        validate_gemm(name, n_rows, n_cols, n_rhs, mesh)
                    (bound or strat).validate(n_rows, n_cols, mesh)
                except MatvecError as e:
                    print(f"skip {name} {n_rows}x{n_cols} p={n_dev}: {e}")
                    n_skip += 1
                    continue
                if a is None and gemm:
                    a = io.generate_matrix(n_rows, n_cols, seed=args.seed)
                    x = io.generate_matrix(n_cols, n_rhs, seed=args.seed + 1)
                elif a is None:
                    a, x = operands(n_rows, n_cols, args)
                for mode in modes:
                    kwargs = dict(
                        dtype=args.dtype, n_reps=args.n_reps, mode=mode,
                        measure=args.measure, kernel=args.kernel,
                    )
                    if args.chain_samples is not None:
                        kwargs["chain_samples"] = args.chain_samples
                    if storage not in (None, "native"):
                        kwargs["dtype_storage"] = storage
                    if args.combine is not None:
                        kwargs["combine"] = args.combine
                    if args.stages is not None:
                        kwargs["stages"] = args.stages
                    if gemm:
                        result = benchmark_gemm(name, mesh, a, x, **kwargs)
                    else:
                        result = benchmark_strategy(strat, mesh, a, x, **kwargs)
                    result = dataclasses.replace(
                        result, strategy=csv_label(name, args.op, storage))
                    if not args.no_csv:
                        append_result(result, args.data_root)
                    print(
                        f"{result.strategy} {n_rows}x{n_cols} p={n_dev} [{mode}] "
                        f"mean={result.mean_time_s:.6f}s "
                        f"{result.gflops:.2f} GFLOP/s {result.gbps:.2f} GB/s"
                    )
                    n_ok += 1
    if not args.no_csv:
        for name in strategies:
            label = csv_label(name, args.op, storage)
            for mode in modes:
                print(f"CSV: {csv_path(label, args.data_root, mode=mode)}")
    print(f"{n_ok} configs timed, {n_skip} skipped")
    return 0


def main(argv: list[str] | None = None) -> int:
    return run_sweep(build_parser().parse_args(argv))


if __name__ == "__main__":
    sys.exit(main())
