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
``--tune`` fills the tuning cache for the grid first (``tuning/``), so that
``--kernel auto`` and ``--combine auto`` read measured decisions.

A long capture: ``--label-suffix`` files kernel-variant rows under their own
label, ``--skip-measured`` resumes a sweep that died (configs already in the
extended CSV are skipped), ``--keep-going`` records a failing config and goes
on (exit 5 when a config failed, 3 when only unmeasurable ones remain),
``--profile-dir`` captures a ``torch.profiler`` trace of the whole sweep
(``bench/profiling.py``) and ``--annotate`` names each strategy's phases in
it; ``--metrics-out`` writes the process metrics registry after the run.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

import torch

from ..models import available_strategies, get_strategy
from ..models.gemm import available_gemm_strategies, validate_gemm
from ..ops import available_gemm_kernels, available_kernels
from ..parallel.mesh import make_mesh
from ..utils import io
from ..utils.errors import ConfigError, MatvecError, TimingError
from .metrics import append_result, csv_path, extended_csv_path, read_csv
from .profiling import annotate, annotations, trace
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
        help="with --op serve: GEMV->GEMM crossover b* — 'auto' (the tuning "
        "cache's, the static 4 on a miss), an int, or 'never'",
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
        "'auto' (the tuning cache's winner per shape, the static default on "
        "a miss; fill it with --tune or the tuning CLI) — see "
        "MatvecStrategy.build. 'overlap' is the staged pipeline (stage "
        "count from --stages); 'pallas_ring' the fused ring kernel (1-D "
        "meshes, matvec only). Strategies without the schedule are skipped",
    )
    p.add_argument(
        "--stages",
        type=int,
        default=None,
        help="with --combine overlap: pin the pipeline's stage count S "
        "(default: the tuning cache's, 2 on a miss); clamped down to the "
        "largest valid divisor of the per-device chunk",
    )
    p.add_argument(
        "--tune", action="store_true",
        help="pre-pass: measure every tuning axis of the grid and keep the "
        "winners in the tuning cache (tuning/) before sweeping",
    )
    p.add_argument(
        "--min-gain", type=float, default=None,
        help="with --tune: hysteresis margin — a non-default candidate must "
        "beat the static default by this fraction (default 0.05)",
    )
    p.add_argument(
        "--measure", choices=list(MEASURE_METHODS), default="auto",
        help="'loop': k dependent reps on the device, replays of CUDA graphs "
        "captured once per config (eager reps on the CPU), timed as one run "
        "(amortized default); 'chain': slope between event-timed call "
        "chains; 'sync': literal per-rep fence protocol (reference default)",
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
    p.add_argument(
        "--label-suffix", default=None, metavar="SUFFIX",
        help="append _SUFFIX to the strategy name in CSV rows (e.g. "
        "--kernel torch --label-suffix torch lands rows in rowwise_torch.csv): "
        "the reference schema has no kernel column, and unlabelled variant "
        "rows would blend into the per-strategy SpeedUp/Efficiency averaging",
    )
    p.add_argument(
        "--skip-measured", action="store_true",
        help="skip any config whose row already exists in the extended CSV "
        "(same strategy label, shape, device count, dtype, mode, measure and "
        "n_rhs), so a capture that died mid-sweep resumes where it stopped; "
        "needs an explicit --measure",
    )
    p.add_argument(
        "--keep-going", action="store_true",
        help="on a runtime error in one config, record it and go on with the "
        "next; exit code 5 = some config failed but the sweep completed "
        "(retry-worthy; with --skip-measured a retry redoes only the "
        "failures), 3 = completed with only unmeasurable (TimingError) "
        "configs skipped. Crashes exit 1 and usage errors 2",
    )
    p.add_argument(
        "--profile-dir", default=None, metavar="DIR",
        help="capture a torch.profiler trace of the whole sweep into DIR "
        "(Chrome-trace JSON: host ops and, with --platform cuda, the card's "
        "kernels; bench/profiling.py)",
    )
    p.add_argument(
        "--annotate", action="store_true",
        help="enable named spans (each strategy's local GEMV and combine, "
        "the overlap stages' stage{i}/compute|combine) in every program this "
        "sweep runs; pair with --profile-dir so the trace reads by phase",
    )
    p.add_argument(
        "--metrics-out", default=None, metavar="FILE",
        help="write an obs metrics snapshot after the run: with --op serve "
        "the engine's counters and latency histograms per config; otherwise "
        "the process registry (e.g. the --tune pre-pass's measurements). "
        "Render with `python -m matvec_mpi_multiplier_torch.obs metrics FILE`",
    )
    p.add_argument(
        "--trace-jsonl", default=None, metavar="FILE",
        help="with --op serve: stream one request span tree per request to "
        "FILE; summarize with `python -m matvec_mpi_multiplier_torch.obs "
        "trace FILE`",
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


def csv_label(name: str, op: str, label_suffix: str | None = None,
              storage: str | None = None) -> str:
    """The strategy label exactly as CSV rows record it: ``gemm_<name>`` for
    GEMM rows, then ``_<format>`` for quantized storage, then
    ``_<label_suffix>``. The one source for the CSV-path printout and the
    ``--skip-measured`` matching: were they to drift apart, a resumed sweep
    would re-run (and duplicate) every config."""
    label = f"gemm_{name}" if op == "gemm" else name
    if storage not in (None, "native"):
        label = f"{label}_{storage}"
    return f"{label}_{label_suffix}" if label_suffix else label


def run_sweep(args: argparse.Namespace) -> int:
    if args.op == "serve":
        # The serve protocol has its own loop (warmup/steady phases,
        # futures, promotion check) — bench/serve.py.
        from .serve import run_serve_sweep

        return run_serve_sweep(args)
    if args.annotate:
        # Scoped to this run: an in-process caller must not find the
        # process-wide flag flipped afterwards.
        with annotations(True):
            return _run_sweep(args)
    return _run_sweep(args)


def _run_sweep(args: argparse.Namespace) -> int:
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
    if args.skip_measured and args.measure == "auto":
        raise SystemExit(
            "--skip-measured needs an explicit --measure: existing rows are "
            "matched by their measure column, and 'auto' resolves per "
            "config AFTER the skip decision would have to be made"
        )
    if args.skip_measured and args.no_csv:
        raise SystemExit(
            "--skip-measured with --no-csv would re-skip forever (new "
            "results are never written back) — drop one of the two"
        )
    if args.trace_jsonl is not None:
        raise SystemExit(
            "--trace-jsonl is request-lifecycle tracing — serve-mode only "
            "(--op serve); matvec/gemm sweeps have no request stream to "
            "trace (use --profile-dir for a device trace)"
        )
    if args.kernel == "native":
        # The host C++ tier takes CPU tensors only; on the card it would
        # raise in the first cell, so refuse before any cell runs.
        if args.platform != "cpu":
            raise ConfigError(
                "--kernel native is the host C++ tier and runs with "
                "--platform cpu only; use --kernel cuda on the card"
            )
        # It registers only once its library exists: build it on demand.
        from ..ops import native_gemm, native_gemv

        native_gemv.register_if_available(build=True)
        native_gemm.register_if_available(build=True)
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
    if args.tune:
        from ..tuning import TuningCache, reset_cache
        from ..tuning.search import TUNE_MIN_GAIN, tune_sweep

        cache = TuningCache.load()
        print(f"tuning pre-pass -> {cache.path}")
        tune_sweep(
            strategies, sizes, [meshes[n] for n in counts], args.dtype, cache,
            op=args.op, n_rhs=args.n_rhs, seed=args.seed,
            # The sweep's own kernel and protocol; kernel='auto' would read
            # the very cache being filled, so the races run on the default.
            kernel="cuda" if args.kernel == "auto" else args.kernel,
            measure=args.measure,
            min_gain=args.min_gain if args.min_gain is not None else TUNE_MIN_GAIN,
        )
        cache.save()
        reset_cache()  # the sweep's auto lookups read the fresh decisions

    # [timed, skipped, unmeasurable, failed]; the last two fill only under
    # --keep-going. Unmeasurable (TimingError) is kept apart from failures
    # because a retry of a failed config may succeed, while a retry of an
    # unmeasurable one meets the same noise floor again.
    counters = [0, 0, 0, 0]
    # The trace stops (and writes its file) on any exit, an exception
    # mid-sweep included.
    with trace(args.profile_dir or "", enabled=args.profile_dir is not None,
               cuda=args.platform == "cuda"):
        _sweep_loop(args, strategies, counts, sizes, modes, meshes, counters)
    n_ok, n_skip, n_unmeasurable, n_failed = counters
    if not args.no_csv:
        for name in strategies:
            label = csv_label(name, args.op, args.label_suffix, storage)
            for mode in modes:
                print(f"CSV: {csv_path(label, args.data_root, mode=mode)}")
    if args.profile_dir is not None:
        print(f"trace: {args.profile_dir}")
    if args.metrics_out is not None:
        from ..obs.registry import get_registry

        out = Path(args.metrics_out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(get_registry().snapshot(), indent=2) + "\n")
        print(f"metrics: {out}")
    print(f"{n_ok} configs timed, {n_skip} skipped, "
          f"{n_unmeasurable} unmeasurable, {n_failed} failed")
    if n_failed:
        # 5, not 1: a completed sweep with recorded config failures is the
        # retry-worthy class; a crash exits 1 through the interpreter.
        return 5
    # 3, not 2: argparse's usage errors exit 2.
    return 3 if n_unmeasurable else 0


def _measured_keys(args) -> set[tuple]:
    """Identity keys of the rows already in the extended CSV, for
    ``--skip-measured``: strategy label as written, shape, device count,
    dtype, mode, measure, n_rhs. A row missing a key column (an old schema,
    a last line cut by a crash) is dropped and simply measured again."""
    path = extended_csv_path(args.data_root)
    if not path.exists():
        return set()
    keys = set()
    for row in read_csv(path):
        try:
            keys.add((
                str(row["strategy"]), int(row["n_rows"]), int(row["n_cols"]),
                int(row["n_devices"]), str(row["dtype"]), str(row["mode"]),
                str(row["measure"]), int(row.get("n_rhs", 1)),
            ))
        except (KeyError, TypeError, ValueError):
            continue
    return keys


def _sweep_loop(args, strategies, counts, sizes, modes, meshes, counters) -> None:
    gemm = args.op == "gemm"
    storage = getattr(args, "dtype_storage", None)
    measured = _measured_keys(args) if args.skip_measured else set()
    # Sizes outermost: each operand pair is generated once, shared, and only
    # when one of its configs runs.
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
                counters[1] += 1
                continue
            label = csv_label(name, args.op, args.label_suffix, storage)
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
                    counters[1] += 1
                    continue
                for mode in modes:
                    if (label, n_rows, n_cols, n_dev, args.dtype, mode,
                            args.measure, n_rhs) in measured:
                        print(f"skip {label} {n_rows}x{n_cols} p={n_dev} "
                              f"[{mode}]: already measured (--skip-measured)")
                        counters[1] += 1
                        continue
                    if a is None and gemm:
                        a = io.generate_matrix(n_rows, n_cols, seed=args.seed)
                        x = io.generate_matrix(n_cols, n_rhs, seed=args.seed + 1)
                    elif a is None:
                        a, x = operands(n_rows, n_cols, args)
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
                    region = f"{args.op}_{name}_{n_rows}x{n_cols}_p{n_dev}_{mode}"
                    try:
                        with annotate(region):
                            if gemm:
                                result = benchmark_gemm(name, mesh, a, x, **kwargs)
                            else:
                                result = benchmark_strategy(strat, mesh, a, x, **kwargs)
                    except TimingError as e:
                        # The noise beat the signal: not a config bug, so
                        # skippable under --keep-going.
                        if not args.keep_going:
                            raise
                        print(f"UNMEASURABLE {region}: {e}", file=sys.stderr)
                        counters[2] += 1
                        continue
                    except MatvecError:
                        raise  # config bugs fail loudly, flag or not
                    except Exception as e:
                        if not args.keep_going:
                            raise
                        # A runtime failure in one config: later configs may
                        # well succeed, and a flushed partial sweep beats an
                        # empty one.
                        print(f"FAILED {region}: {type(e).__name__}: {e}",
                              file=sys.stderr)
                        counters[3] += 1
                        continue
                    result = dataclasses.replace(result, strategy=label)
                    if not args.no_csv:
                        append_result(result, args.data_root)
                    print(
                        f"{result.strategy} {n_rows}x{n_cols} p={n_dev} [{mode}] "
                        f"mean={result.mean_time_s:.6f}s "
                        f"{result.gflops:.2f} GFLOP/s {result.gbps:.2f} GB/s"
                    )
                    counters[0] += 1


def main(argv: list[str] | None = None) -> int:
    return run_sweep(build_parser().parse_args(argv))


if __name__ == "__main__":
    sys.exit(main())
