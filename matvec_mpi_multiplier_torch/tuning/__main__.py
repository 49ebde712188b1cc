"""Fill the tuning cache from the command line.

Usage::

    python -m matvec_mpi_multiplier_torch.tuning --strategy all \\
        --devices 1 --sweep asymmetric --dtype bfloat16

    # CPU (logical CPU shards; the CUDA candidates are not offered):
    python -m matvec_mpi_multiplier_torch.tuning --platform cpu \\
        --host-devices 8 --sizes 64 --strategy colwise rowwise

Measures every axis for every config of the grid (the grid ``bench.sweep``
runs): the local kernel (tier and the CUDA kernels' route or tiles), the
overlap stages, the combine schedule, the storage format and, on square
shapes, the solver iteration tier; and keeps the winners in the JSON cache
(``tuning/cache.py``; ``--cache`` or ``MATVEC_TUNING_CACHE`` picks the
file). ``--platform cuda`` (the default) meshes over the CUDA devices and
fails without one; ``--shards p`` puts p logical shards on the first card.
A later ``bench.sweep --kernel auto`` or ``--combine auto``, or an engine
built with ``"auto"``, reads the cache without measuring again.
``--calibrate full|quick`` runs the cost model's probes on each mesh first
and records their constants; ``--prune-margin M`` then measures only the
candidates predicted within M of each axis's predicted winner.
"""

from __future__ import annotations

import argparse
import os
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m matvec_mpi_multiplier_torch.tuning",
        description="Fill the tuning cache: measure the kernel/tile/combine/"
        "stage/storage/solver-tier candidates of a sweep grid and keep the "
        "winners.",
    )
    p.add_argument("--strategy", nargs="+", default=["all"])
    p.add_argument("--op", choices=["matvec", "gemm"], default="matvec")
    p.add_argument("--n-rhs", type=int, default=None)
    p.add_argument("--devices", nargs="+", type=int, default=None,
                   help="mesh sizes (default: powers of two up to the devices)")
    p.add_argument("--shards", type=int, default=None,
                   help="with --platform cuda: p logical shards on the first "
                   "card instead of one shard per card")
    p.add_argument("--sweep", choices=["square", "asymmetric", "both"],
                   default="square")
    p.add_argument("--sizes", nargs="+", type=int, default=None)
    p.add_argument("--dtype", default="float32")
    p.add_argument("--kernel", default="cuda",
                   help="GEMV tier the combine, stage, promotion and storage "
                   "races run their programs on")
    p.add_argument("--n-reps", type=int, default=None)
    p.add_argument("--samples", type=int, default=None)
    p.add_argument("--measure", choices=["auto", "loop", "chain", "sync"],
                   default="auto",
                   help="timing method of the races (bench/timing.py)")
    p.add_argument("--force", action="store_true",
                   help="measure configs already in the cache again")
    p.add_argument(
        "--min-gain", type=float, default=None,
        help="hysteresis margin: a non-default candidate must beat the "
        "static default by this fraction to be recorded (default 0.05)",
    )
    p.add_argument(
        "--prune-margin", type=float, default=None,
        help="cost-model pruning: measure only candidates predicted within "
        "this relative margin of the predicted winner (needs a calibration "
        "record, see --calibrate; without one every candidate is measured)",
    )
    p.add_argument("--calibrate", choices=["full", "quick"], default=None,
                   help="run the cost model's probes on each mesh first and "
                   "record the calibrations (cache schema v5)")
    p.add_argument("--cache", default=None, help="cache file path override")
    p.add_argument("--platform", choices=["cuda", "cpu"], default="cuda",
                   help="devices to mesh over: the CUDA devices (default) or "
                   "CPU shards")
    p.add_argument("--host-devices", type=int, default=None)
    p.add_argument("--seed", type=int, default=0)
    return p


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    if args.cache is not None:
        # Through the env var, so the dispatch singleton (lookup_gemv & co.)
        # reads the same file in this process and its children.
        os.environ["MATVEC_TUNING_CACHE"] = args.cache

    from ..bench.sweep import (
        ASYMMETRIC_SIZES,
        SQUARE_SIZES,
        device_counts_available,
        platform_devices,
        resolve_strategies,
    )
    from ..parallel.mesh import make_mesh
    from . import reset_cache
    from .cache import TuningCache, platform_fingerprint
    from .search import TUNE_MIN_GAIN, TUNE_N_REPS, TUNE_SAMPLES, tune_sweep

    devices = platform_devices(args.platform, args.host_devices)
    if args.shards is not None:
        devices = [devices[0]] * args.shards
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
    meshes = [make_mesh(n, devices=devices) for n in counts]

    cache = TuningCache.load(args.cache)
    print(f"tuning cache: {cache.path} ({len(cache)} entries)")
    print(f"platform fingerprint: {platform_fingerprint()}")
    if args.calibrate is not None:
        from .cache import calibration_key
        from .cost_model import calibrate

        for mesh in meshes:
            cal = calibrate(mesh, level=args.calibrate)
            cache.record(calibration_key(mesh.size), cal.to_record())
        cache.save()
    tune_sweep(
        strategies, sizes, meshes, args.dtype, cache, op=args.op,
        n_rhs=args.n_rhs, kernel=args.kernel, measure=args.measure,
        n_reps=args.n_reps or TUNE_N_REPS, samples=args.samples or TUNE_SAMPLES,
        force=args.force, seed=args.seed,
        min_gain=args.min_gain if args.min_gain is not None else TUNE_MIN_GAIN,
        prune_margin=args.prune_margin,
    )
    path = cache.save()
    reset_cache()  # callers in this process read the fresh decisions
    print(f"saved {len(cache)} entries to {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
