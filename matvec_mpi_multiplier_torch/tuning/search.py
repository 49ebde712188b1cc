"""Candidate enumeration and measurement for the tuner.

The port's counterpart of the JAX package's ``tuning/search.py``. Eight
axes, one ``tune_*`` function each, every one recording its winner in the
cache (``tuning/cache.py``) under the JAX package's key layout:

* **local GEMV** (``tune_gemv``) — the ``torch`` tier against the ``cuda``
  tier on ``gemv_plan``'s route (the static default) and on the routes it
  did not pick (``rows``, ``split`` on one or two blocks an SM), the
  counterpart of the Pallas tile ladder;
* **local GEMM** (``tune_gemm``) — ``torch`` against the ``cuda`` tier on
  ``default_gemm_tiles`` and its neighbours (``gemm_tile_ladder``);
* **combine schedule** (``tune_combine``, ``tune_gemm_combine``) — the
  strategy's schedules as full distributed matvecs (GEMMs);
* **GEMV→GEMM promotion** (``tune_promotion``) — the bucket width ``b*``
  from which one sharded GEMM beats ``b`` matvec dispatches;
* **overlap stage count** (``tune_overlap``) — S over {1, 2, 4, 8};
* **resident storage** (``tune_storage``) — native, int8, int8c, fp8;
* **solver iteration tier** (``tune_solver_kernel``) — the unfused
  ``torch`` loop against the fused ``cuda_fused`` step, as fixed-iteration
  solves.

The CUDA candidates (the ``cuda`` tier's other routes and tiles, the fused
solver step) are offered only where the operands lie on a CUDA device, as
the JAX package offers its Pallas candidates only on a TPU. A candidate
that fails to build or launch raises: nothing is ever timed in another
candidate's place.

Every time comes from the benchmark's own protocol (``bench/timing.py``):
the device-looped slope (``time_fn_looped``; on one card, replays of
captured CUDA graphs) or, with ``measure="sync"``, the minimum of fenced
single calls. A non-default candidate wins only by beating the static
default by :data:`TUNE_MIN_GAIN` (hysteresis), and an apparent winner is
measured again beside the default before it is recorded.

**Cost-model pruning** (``prune_margin=``): when the cache carries a
calibration record (``cost_model.calibrate``), every axis predicts its
candidates and measures only those within the margin of the predicted
winner, plus the hysteresis default seat (never pruned). Every pruned
candidate is logged and counted (``tuning_pruned_candidates_total``), every
measured candidate records its prediction into the obs registry
(``tuning_predicted_vs_measured_ratio``), and an uncalibrated cache falls
back to measuring everything with a log line. The kernel axes record
predictions but never prune (the model has no kernel-tier resolution);
the promotion axis prunes the buckets after ``b*`` is decided.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Iterable

import numpy as np
import torch

from ..bench.timing import benchmark_gemm, benchmark_strategy, fence, time_fn_looped
from ..models import get_strategy
from ..parallel.mesh import Mesh, make_1d_mesh, mesh_grid_shape
from ..utils.convert import torch_dtype
from ..utils.errors import ConfigError, MatvecError, TimingError
from .cache import (
    TuningCache,
    combine_key,
    gemm_key,
    gemv_key,
    overlap_key,
    promote_key,
    solver_kernel_key,
    storage_key,
)

# A tuning pass measures many candidates per config; the full 100-rep
# protocol would cost more than the sweep it feeds. The slope method widens
# its rep spread until the signal beats dispatch jitter, so a smaller
# request loses no validity.
TUNE_N_REPS = 30
TUNE_SAMPLES = 3

# Hysteresis: a non-default candidate must beat the static default's time by
# this relative margin to be recorded as the winner; inside it, the default
# keeps the seat (a noise-picked winner would break auto's promise of never
# being slower than the default).
TUNE_MIN_GAIN = 0.05

# Fixed-iteration race depth of the solver axis: rtol = 0 never converges,
# so both tiers run exactly this many iterations.
SOLVER_RACE_ITERS = 16

# Stage counts the overlap axis measures (filtered per shape); S = 1, the
# un-pipelined schedule, is the hysteresis default.
OVERLAP_STAGE_LADDER = (1, 2, 4, 8)

def _cuda_offered(device: torch.device) -> bool:
    """Whether the CUDA candidates race for operands on ``device``."""
    return device.type == "cuda"


def _tune_device() -> torch.device:
    """The device a kernel axis measures on when none is given: the first
    card. Never a quiet CPU race: without a card it raises ``ConfigError``
    (pass ``device=torch.device("cpu")`` to measure the CPU)."""
    if not torch.cuda.is_available():
        raise ConfigError(
            "no CUDA device is visible: the kernel tuner measures on the first "
            "card; pass device=torch.device('cpu') to tune on the CPU"
        )
    return torch.device("cuda", 0)


def _uniform(shape: tuple, dtype: str, seed: int, device) -> torch.Tensor:
    """Seeded uniform [0, 10) operands made on ``device``
    (``bench.serve.resident_matrix``: row chunks, no float64 host copy)."""
    from ..bench.serve import resident_matrix

    rows, cols = shape if len(shape) == 2 else (1, shape[0])
    out = resident_matrix(rows, cols, torch_dtype(dtype), device, seed)
    return out if len(shape) == 2 else out[0]


def _measure_fn(fn: Callable, args: tuple, mesh: Mesh, *, n_reps: int,
                samples: int, measure: str = "loop") -> float | None:
    """Per-call time of ``fn(*args)`` on device-resident ``args``: the
    median of the looped slope samples, or None when the backend is too
    noisy for this candidate (an unmeasurable candidate never wins).
    ``measure="sync"`` takes the minimum of fenced single calls instead:
    for programs that read the host in the middle (a solve reads its
    continuation flag) and so cannot run inside a captured rep loop."""
    if measure == "sync":
        fn(*args)  # warm, untimed
        fence(mesh)
        times = []
        for _ in range(max(1, n_reps) * max(1, samples)):
            start = time.perf_counter()
            fn(*args)
            fence(mesh)
            times.append(time.perf_counter() - start)
        return float(np.min(times))
    try:
        times = time_fn_looped(fn, args, mesh, n_reps=n_reps, samples=samples)
    except TimingError:
        return None
    return float(np.median(times))


def _record_candidate(axis: str, t: float | None,
                      predicted: float | None = None) -> None:
    """Count one measured candidate of ``axis`` in the process registry
    (``tuning_<axis>_candidates_total``; unmeasurable ones also in
    ``tuning_<axis>_unmeasurable_total``) and its time in the
    ``tuning_candidate_time_ms`` histogram. ``predicted`` (when a
    calibration exists) records the cost model's prediction against the
    measurement (``cost_model.record_prediction``)."""
    from ..obs.registry import get_registry

    registry = get_registry()
    registry.counter(f"tuning_{axis}_candidates_total",
                     f"{axis}-axis candidates measured").inc()
    if t is None:
        registry.counter(f"tuning_{axis}_unmeasurable_total",
                         f"{axis}-axis candidates the noise floor rejected").inc()
    else:
        registry.histogram("tuning_candidate_time_ms",
                           "measured candidate times").observe(t * 1e3)
        if predicted is not None:
            from .cost_model import record_prediction

            record_prediction(predicted, t)


def candidates_measured() -> int:
    """Candidates measured so far in this process, over every axis (the
    pruned-candidate counter shares the suffix and is left out)."""
    from ..obs.registry import get_registry
    from .cost_model import PRUNED_COUNTER

    counters = get_registry().snapshot()["counters"]
    return sum(v for name, v in counters.items()
               if name.startswith("tuning_") and name.endswith("_candidates_total")
               and name != PRUNED_COUNTER)


def _record_stale(axis: str, key: str, log: Callable[[str], None]) -> None:
    """A cache hit measured again (``force=True``), counted and logged."""
    from ..obs.registry import get_registry

    get_registry().counter(
        "tuning_cache_stale_total",
        "cache hits re-measured because the entry was stale (force)",
    ).inc()
    log(f"  {axis}: stale cache hit re-measured (force): {key}")


def _lookup(cache: TuningCache, axis: str, key: str, force: bool,
            log: Callable[[str], None]) -> dict | None:
    """The recorded decision unless ``force`` asks to measure again."""
    existing = cache.lookup(key)
    if existing is not None and force:
        _record_stale(axis, key, log)
        return None
    return existing


def _plan_pruning(context: str, predictions: dict[str, float], *, keep: set[str],
                  margin: float, log: Callable[[str], None]) -> set[str]:
    """Predicted-time pre-ranking for one axis: keep the hysteresis seat(s)
    in ``keep`` and every candidate predicted within ``margin`` of the
    predicted winner; prune the rest. Every pruned candidate is logged and
    counted, so a wrong prediction stays attributable. Returns the label
    set to measure."""
    from ..obs.registry import get_registry
    from .cost_model import PRUNED_COUNTER

    best = min(predictions.values())
    measure: set[str] = set()
    counter = get_registry().counter(
        PRUNED_COUNTER, "tuning candidates skipped by cost-model pruning")
    for label, t in predictions.items():
        if label in keep or t <= (1.0 + margin) * best:
            measure.add(label)
        else:
            counter.inc()
            log(f"  {context} {label}: pruned (predicted {t * 1e6:.1f} us "
                f"vs predicted best {best * 1e6:.1f} us, margin {margin:.2f})")
    return measure


def _measure_plan(candidates: Iterable, predictions: dict[str, float],
                  measure_set: set[str] | None) -> list:
    """The candidates one axis races after a pruning plan: all of them when
    not pruning (``measure_set`` None), else the kept set plus every
    candidate the model had no prediction for. Prediction keys are the
    str() of the candidate (the overlap ladder's ints by their labels)."""
    return [c for c in candidates
            if measure_set is None or str(c) not in predictions
            or str(c) in measure_set]


def _plan(model, predictions: dict[str, float], *, keep: set[str],
          prune_margin: float | None, context: str,
          log: Callable[[str], None]) -> tuple[set[str] | None, list[str]]:
    """The pruning plan of one axis from its predictions: ``(measure_set,
    pruned)``, ``measure_set`` None when not pruning or uncalibrated (that
    case logged)."""
    if prune_margin is None:
        return None, []
    if model is None:
        log(f"  {context}: cost model uncalibrated - measuring all candidates")
        return None, []
    if not predictions:
        return None, []
    measure_set = _plan_pruning(context, predictions, keep=keep,
                                margin=prune_margin, log=log)
    return measure_set, sorted(set(predictions) - measure_set)


def _predict_combines(
    cache: TuningCache, family: str, candidates: Iterable[str], *, m: int,
    k: int, mesh: Mesh, dtype: str, stages: int | None, keep: set[str],
    prune_margin: float | None, context: str, log: Callable[[str], None],
    b: int = 1,
) -> tuple[dict[str, float], set[str] | None, list[str]]:
    """Shared prediction and pruning plan of the combine axes: predict every
    candidate the formula covers, then (with ``prune_margin``) split them
    into measured and pruned sets. Returns ``(predictions, measure_set,
    pruned)``; candidates without a prediction are never pruned."""
    from .cost_model import model_from_cache

    p = mesh.size
    model = model_from_cache(cache, p)
    predictions: dict[str, float] = {}
    if model is not None:
        r, _c = mesh_grid_shape(mesh)
        for cand in candidates:
            s = stages if cand in ("overlap", "overlap_ring") else None
            try:
                predictions[cand] = model.predict(
                    family, cand, m=m, k=k, p=p, dtype=dtype, stages=s,
                    b=b, r=r,
                ).total_s
            except KeyError:
                continue  # no formula for this schedule: never pruned
    measure_set, pruned = _plan(model, predictions, keep=keep,
                                prune_margin=prune_margin, context=context,
                                log=log)
    return predictions, measure_set, pruned


def _with_predictions(best: dict[str, Any], predictions: dict,
                      pruned: list[str]) -> dict[str, Any]:
    """A decision with the predictions and pruned candidates recorded
    beside it (the JAX package's ``predicted_s`` and ``pruned`` fields)."""
    if predictions:
        best["predicted_s"] = predictions
    if pruned:
        best["pruned"] = pruned
    return best


def _pick_winner(measured: dict[str, float], default: str,
                 min_gain: float = TUNE_MIN_GAIN) -> str | None:
    """The fastest measured candidate, unless the static default is within
    ``min_gain`` of it (then the default). None when nothing was
    measurable."""
    if not measured:
        return None
    winner = min(measured, key=measured.get)
    if (winner != default and default in measured
            and measured[winner] > (1.0 - min_gain) * measured[default]):
        return default
    return winner


def _race(axis: str, context: str, labels: list[str], run: Callable[[str], float | None],
          default: str, min_gain: float, log: Callable[[str], None],
          predictions: dict | None = None) -> tuple[str | None, dict[str, float]]:
    """Measure every label (``run(label)`` -> seconds or None), pick the
    winner with the hysteresis, and where a non-default label wins measure
    it again beside the default (both fully warm, adjacent: free of the
    first pass's order bias) before deciding. ``predictions`` (label ->
    seconds) pairs each first-pass measurement with its prediction."""
    measured: dict[str, float] = {}
    for label in labels:
        t = run(label)
        _record_candidate(axis, t, (predictions or {}).get(label))
        if t is None:
            log(f"  {context} {label}: unmeasurable")
            continue
        measured[label] = t
        log(f"  {context} {label}: {t * 1e6:.1f} us")
    winner = _pick_winner(measured, default, min_gain)
    if winner is not None and winner != default and default in measured:
        for label in (default, winner):
            t = run(label)
            if t is not None:
                measured[label] = t
        winner = _pick_winner(measured, default, min_gain)
        log(f"  {context} confirm -> {winner}")
    return winner, measured


# ---------------------------------------------------------------- kernels


def gemv_candidates(m: int, k: int, dtype: str, device: torch.device | None = None,
                    sms: int | None = None) -> list[dict[str, Any]]:
    """Kernel-axis candidates for one LOCAL (m, k, dtype): the ``cuda`` tier
    on ``gemv_plan``'s route (the static default, first) and on each route
    it did not pick, where the CUDA candidates are offered; the ``torch``
    tier always. ``sms`` defaults to the card's SM count."""
    from ..ops.cuda_gemv import (
        BLOCKS_PER_SM,
        SPLIT_BLOCKS_PER_SM,
        _layout,
        gemv_plan,
        sm_count,
    )

    device = _tune_device() if device is None else torch.device(device)
    cands: list[dict[str, Any]] = []
    if _cuda_offered(device):
        if sms is None:
            sms = sm_count(device)
        dt = torch_dtype(dtype)
        planned = gemv_plan(m, k, dt, dt, sms)
        cands.append({"kernel": "cuda"})
        forced = [("rows", BLOCKS_PER_SM)] + [("split", b) for b in SPLIT_BLOCKS_PER_SM]
        for route, blocks in forced:
            if _layout(route, m, k, dt, sms, blocks) == planned:
                continue  # gemv_plan's own plan: the default candidate
            cand = {"kernel": "cuda", "route": route}
            if route == "split":
                cand["blocks_per_sm"] = blocks
            cands.append(cand)
    cands.append({"kernel": "torch"})
    return cands


def _candidate_label(cand: dict[str, Any]) -> str:
    from ..ops.cuda_gemv import BLOCKS_PER_SM, route_label

    if cand.get("route") is None:
        return cand["kernel"]
    return route_label(cand["route"], cand.get("blocks_per_sm", BLOCKS_PER_SM))


def _candidate_gemv_fn(cand: dict[str, Any]) -> Callable:
    from ..ops.gemv import get_kernel, resolve_gemv

    if cand.get("route") is None:
        return get_kernel(cand["kernel"])
    return resolve_gemv(cand)


def tune_gemv(
    m: int, k: int, dtype: str, cache: TuningCache, *,
    n_reps: int = TUNE_N_REPS, samples: int = TUNE_SAMPLES, force: bool = False,
    seed: int = 0, min_gain: float = TUNE_MIN_GAIN,
    prune_margin: float | None = None, measure: str = "loop",
    device: torch.device | None = None, log: Callable[[str], None] = print,
) -> dict[str, Any] | None:
    """Measure the GEMV candidates for one LOCAL (m, k, dtype) on one device
    and record the winner (``gemv_key``). Returns the decision, cached or
    fresh; None when nothing was measurable. ``prune_margin`` is accepted
    for uniformity: the kernel axis never prunes (every candidate shares one
    local prediction), but each measurement records its prediction."""
    from .cost_model import any_model_from_cache

    del prune_margin
    key = gemv_key(m, k, dtype)
    existing = _lookup(cache, "gemv", key, force, log)
    if existing is not None:
        return existing
    model = any_model_from_cache(cache)
    predicted = model.predict_local(m, k, dtype).total_s if model is not None else None
    device = _tune_device() if device is None else torch.device(device)
    mesh = make_1d_mesh(1, devices=[device])
    a = _uniform((m, k), dtype, seed, device)
    x = _uniform((k,), dtype, seed + 1, device)
    cands = gemv_candidates(m, k, dtype, device)
    by_label = {_candidate_label(c): c for c in cands}
    fns = {label: _candidate_gemv_fn(c) for label, c in by_label.items()}
    # Discarded warm-up: the first measurement in a cold process absorbs
    # one-time costs that would bias the ranking against the default.
    _measure_fn(fns[_candidate_label(cands[0])], (a, x), mesh,
                n_reps=max(1, n_reps // 4), samples=1, measure=measure)
    winner, measured = _race(
        "gemv", f"gemv {m}x{k} {dtype}", list(by_label),
        lambda label: _measure_fn(fns[label], (a, x), mesh, n_reps=n_reps,
                                  samples=samples, measure=measure),
        "cuda", min_gain, log, dict.fromkeys(by_label, predicted))
    if winner is None:
        return None
    best = dict(by_label[winner], time_s=measured[winner], candidates=measured)
    cache.record(key, best)
    return best


def gemm_candidates(m: int, k: int, n: int, dtype: str,
                    device: torch.device | None = None) -> list[dict[str, Any]]:
    """GEMM candidates for one LOCAL (m, k, n, dtype): the ``cuda`` tier on
    ``default_gemm_tiles`` (the static default, first) and on the rest of
    ``gemm_tile_ladder`` where the CUDA candidates are offered; ``torch``
    always."""
    from ..ops.cuda_gemm import gemm_tile_ladder

    device = _tune_device() if device is None else torch.device(device)
    cands: list[dict[str, Any]] = []
    if _cuda_offered(device):
        cands.append({"kernel": "cuda"})
        for plan in gemm_tile_ladder(m, n, k, torch_dtype(dtype))[1:]:
            cands.append({"kernel": "cuda", "route": plan.route, "bn": plan.bn,
                          "stages": plan.stages})
    cands.append({"kernel": "torch"})
    return cands


def _gemm_candidate_label(cand: dict[str, Any]) -> str:
    if cand.get("bn") is None:
        return cand["kernel"]
    return f"cuda[{cand['route']}:{cand['bn']}s{cand['stages']}]"


def _candidate_gemm_fn(cand: dict[str, Any]) -> Callable:
    from ..ops.gemm_kernels import get_gemm_kernel, resolve_gemm

    if cand.get("bn") is None:
        return get_gemm_kernel(cand["kernel"])
    return resolve_gemm(cand)


def tune_gemm(
    m: int, k: int, n: int, dtype: str, cache: TuningCache, *,
    n_reps: int = TUNE_N_REPS, samples: int = TUNE_SAMPLES, force: bool = False,
    seed: int = 0, min_gain: float = TUNE_MIN_GAIN,
    prune_margin: float | None = None, measure: str = "loop",
    device: torch.device | None = None, log: Callable[[str], None] = print,
) -> dict[str, Any] | None:
    """The GEMM face of :func:`tune_gemv`: measure the tier and tile
    candidates for one LOCAL (m, k, n, dtype) and record the winner
    (``gemm_key``); predictions are recorded, never pruned on."""
    from .cost_model import any_model_from_cache

    del prune_margin
    key = gemm_key(m, k, n, dtype)
    existing = _lookup(cache, "gemm", key, force, log)
    if existing is not None:
        return existing
    model = any_model_from_cache(cache)
    predicted = (model.predict_local(m, k, dtype, b=n).total_s
                 if model is not None else None)
    device = _tune_device() if device is None else torch.device(device)
    mesh = make_1d_mesh(1, devices=[device])
    a = _uniform((m, k), dtype, seed, device)
    b = _uniform((k, n), dtype, seed + 1, device)
    cands = gemm_candidates(m, k, n, dtype, device)
    by_label = {_gemm_candidate_label(c): c for c in cands}
    fns = {label: _candidate_gemm_fn(c) for label, c in by_label.items()}
    _measure_fn(fns[_gemm_candidate_label(cands[0])], (a, b), mesh,
                n_reps=max(1, n_reps // 4), samples=1, measure=measure)
    winner, measured = _race(
        "gemm", f"gemm {m}x{k}x{n} {dtype}", list(by_label),
        lambda label: _measure_fn(fns[label], (a, b), mesh, n_reps=n_reps,
                                  samples=samples, measure=measure),
        "cuda", min_gain, log, dict.fromkeys(by_label, predicted))
    if winner is None:
        return None
    best = dict(by_label[winner], time_s=measured[winner], candidates=measured)
    cache.record(key, best)
    return best


# ---------------------------------------------------------------- combine


def _family(strategy_name: str) -> str:
    return "colwise" if strategy_name.startswith("colwise") else strategy_name


def tune_combine(
    strategy_name: str, mesh: Mesh, m: int, k: int, dtype: str,
    cache: TuningCache, *, kernel: str = "cuda", measure: str = "auto",
    n_reps: int = TUNE_N_REPS, samples: int = TUNE_SAMPLES, force: bool = False,
    seed: int = 0, min_gain: float = TUNE_MIN_GAIN, memo: dict | None = None,
    stages: int | None = None, prune_margin: float | None = None,
    log: Callable[[str], None] = print,
) -> dict[str, Any] | None:
    """Measure the combine schedules of one GLOBAL (strategy, m, k, mesh,
    dtype) as full distributed matvecs (``benchmark_strategy``) and record
    the winner (``combine_key("matvec", ...)``). Schedules the shape does
    not divide into are skipped. ``memo`` (shared across one
    :func:`tune_sweep`) measures the colwise registry names' identical
    programs once. ``stages`` is the overlap schedules' S."""
    p = mesh.size
    key = combine_key("matvec", strategy_name, m, k, p, dtype)
    existing = _lookup(cache, "combine", key, force, log)
    if existing is not None:
        return existing
    strat = get_strategy(strategy_name)
    try:
        candidates = strat.combine_candidates(mesh)
    except MatvecError:
        return None  # e.g. blockwise on a mesh without its 2-D axes
    if not candidates:
        return None
    family = _family(strategy_name)
    default = strat.default_combine(mesh)
    context = f"combine {strategy_name} {m}x{k} p={p}"
    predictions, measure_set, pruned = _predict_combines(
        cache, family, candidates, m=m, k=k, mesh=mesh, dtype=dtype,
        stages=stages, keep={default}, prune_margin=prune_margin,
        context=context, log=log)
    runnable = []
    for cand in _measure_plan(candidates, predictions, measure_set):
        try:
            (strat.with_combine(cand) or strat).validate(m, k, mesh)
            runnable.append(cand)
        except MatvecError as e:
            log(f"  {context} {cand}: skip ({e})")
    if not runnable:
        return None
    a = _uniform((m, k), dtype, seed, mesh.devices[0])
    x = _uniform((k,), dtype, seed + 1, mesh.devices[0])

    def bench(cand: str, reps: int, chain_samples: int):
        return benchmark_strategy(
            strat, mesh, a, x, dtype=dtype, n_reps=reps, measure=measure,
            kernel=kernel, combine=cand, chain_samples=chain_samples,
            stages=stages)

    try:  # discarded warm-up (the cold-process rationale of tune_gemv)
        bench(runnable[0], 1, 1)
    except TimingError:
        pass

    def run(cand: str) -> float | None:
        memo_key = (family, cand, m, k, p, dtype, kernel, measure,
                    stages if cand.startswith("overlap") else None)
        if memo is not None and memo_key in memo:
            return memo[memo_key]
        try:
            t = float(min(bench(cand, n_reps, samples).times_s))
        except TimingError:
            return None
        if memo is not None:
            memo[memo_key] = t
        return t

    winner, measured = _race("combine", context, runnable, run, default,
                             min_gain, log, predictions)
    if winner is None:
        return None
    best = _with_predictions(
        {"combine": winner, "time_s": measured[winner], "candidates": measured},
        predictions, pruned)
    cache.record(key, best)
    return best


def tune_gemm_combine(
    strategy_name: str, mesh: Mesh, m: int, k: int, n: int, dtype: str,
    cache: TuningCache, *, kernel: str = "cuda", measure: str = "auto",
    n_reps: int = TUNE_N_REPS, samples: int = TUNE_SAMPLES, force: bool = False,
    seed: int = 0, min_gain: float = TUNE_MIN_GAIN, stages: int | None = None,
    prune_margin: float | None = None, log: Callable[[str], None] = print,
) -> dict[str, Any] | None:
    """The GEMM face of :func:`tune_combine`: the in-body schedules
    (``models.gemm.gemm_combine_candidates``) as full distributed GEMMs at
    ``n`` right-hand sides, recorded under ``combine_key("gemm", ...)``
    (the key carries no n: the engine reads one decision for its whole
    bucket ladder)."""
    from ..models.gemm import gemm_combine_candidates, validate_gemm

    p = mesh.size
    key = combine_key("gemm", strategy_name, m, k, p, dtype)
    existing = _lookup(cache, "gemm_combine", key, force, log)
    if existing is not None:
        return existing
    try:
        candidates = gemm_combine_candidates(strategy_name, mesh)
    except MatvecError:
        return None
    if not candidates:
        return None
    strat = get_strategy(strategy_name)
    default = strat.default_combine(mesh)
    context = f"gemm-combine {strategy_name} {m}x{k}x{n} p={p}"
    predictions, measure_set, pruned = _predict_combines(
        cache, _family(strategy_name), candidates, m=m, k=k, mesh=mesh,
        dtype=dtype, stages=stages, keep={default}, prune_margin=prune_margin,
        context=context, log=log, b=n)
    runnable = []
    for cand in _measure_plan(candidates, predictions, measure_set):
        try:
            (strat.with_combine(cand) or strat).validate(m, k, mesh)
            validate_gemm(strategy_name, m, k, n, mesh)
            runnable.append(cand)
        except MatvecError as e:
            log(f"  {context} {cand}: skip ({e})")
    if not runnable:
        return None
    a = _uniform((m, k), dtype, seed, mesh.devices[0])
    b = _uniform((k, n), dtype, seed + 1, mesh.devices[0])

    def bench(cand: str, reps: int, chain_samples: int):
        return benchmark_gemm(
            strategy_name, mesh, a, b, dtype=dtype, n_reps=reps, measure=measure,
            kernel=kernel, combine=cand, chain_samples=chain_samples,
            stages=stages)

    try:
        bench(runnable[0], 1, 1)
    except TimingError:
        pass

    def run(cand: str) -> float | None:
        try:
            return float(min(bench(cand, n_reps, samples).times_s))
        except TimingError:
            return None

    winner, measured = _race("gemm_combine", context, runnable, run, default,
                             min_gain, log, predictions)
    if winner is None:
        return None
    best = _with_predictions(
        {"combine": winner, "time_s": measured[winner], "candidates": measured,
         "n_rhs": n}, predictions, pruned)
    cache.record(key, best)
    return best


# ----------------------------------------------------------- promotion


def tune_promotion(
    strategy_name: str, mesh: Mesh, m: int, k: int, dtype: str,
    cache: TuningCache, *, buckets: tuple[int, ...] = (2, 4, 8, 16, 32),
    kernel: str = "cuda", combine: str | None = None, measure: str = "loop",
    n_reps: int = TUNE_N_REPS, samples: int = TUNE_SAMPLES, force: bool = False,
    seed: int = 0, min_gain: float = TUNE_MIN_GAIN,
    prune_margin: float | None = None, log: Callable[[str], None] = print,
) -> dict[str, Any] | None:
    """The GEMV→GEMM promotion crossover: for each bucket width ``b``, does
    ONE sharded GEMM over a (k, b) block beat ``b`` single-column matvec
    dispatches of the same strategy? ``b*`` is the smallest bucket whose
    GEMM wins by the hysteresis margin; ``b_star: null`` records that
    promotion never won (the engine then keeps the per-column path, which
    differs from a miss). Both sides are timed per call by the looped
    protocol; the host's per-dispatch cost only widens the GEMM's real
    advantage, so the crossover is conservative. With ``prune_margin`` the
    buckets after the first winner are skipped (they cannot change b*): the
    model itself cannot prune here, since it never predicts one GEMM above
    ``b`` matvecs. Its per-bucket predictions are recorded all the same."""
    from ..obs.registry import get_registry
    from .cost_model import PRUNED_COUNTER, model_from_cache

    p = mesh.size
    key = promote_key(strategy_name, m, k, p, dtype)
    existing = _lookup(cache, "promotion", key, force, log)
    if existing is not None:
        return existing
    strat = get_strategy(strategy_name)
    try:
        strat.validate(m, k, mesh)
    except MatvecError:
        return None
    context = f"promote {strategy_name} {m}x{k} p={p} {dtype}"
    model = model_from_cache(cache, p)
    comb = combine if combine not in (None, "auto") else strat.default_combine(mesh)
    pred_seq: float | None = None
    pred_gemm: dict[int, float] = {}
    if model is not None:
        r_, _c = mesh_grid_shape(mesh)
        try:
            pred_seq = model.predict(_family(strategy_name), comb, m=m, k=k, p=p,
                                     dtype=dtype, r=r_).total_s
            for b in sorted(buckets):
                pred_gemm[b] = model.predict(_family(strategy_name), comb, m=m,
                                             k=k, p=p, dtype=dtype, b=b,
                                             r=r_).total_s
        except KeyError:
            pred_seq, pred_gemm = None, {}  # no formula: measure everything
    dev = mesh.devices[0]
    a = _uniform((m, k), dtype, seed, dev)
    a_placed, x_placed = strat.place(a, _uniform((k,), dtype, seed + 1, dev), mesh)
    matvec = strat.build(mesh, kernel=kernel, combine=combine)
    t_seq = _measure_fn(matvec, (a_placed, x_placed), mesh, n_reps=n_reps,
                        samples=samples, measure=measure)
    _record_candidate("promotion", t_seq, pred_seq)
    if t_seq is None:
        return None
    log(f"  {context} matvec: {t_seq * 1e6:.1f} us")
    gemm = strat.build_batched(mesh, kernel=kernel, combine=combine)
    gemm_times: dict[str, float] = {}
    pruned: list[str] = []
    b_star: int | None = None
    for i, b in enumerate(sorted(buckets)):
        if prune_margin is not None and b_star is not None:
            get_registry().counter(
                PRUNED_COUNTER,
                "tuning candidates skipped by cost-model pruning").inc()
            pruned.append(str(b))
            log(f"  {context} b={b}: pruned (b*={b_star} already decided)")
            continue
        rhs = _uniform((k, b), dtype, seed + 2 + i, dev)
        _, rhs_placed = strat.place_batched(a, rhs, mesh)
        t_gemm = _measure_fn(gemm, (a_placed, rhs_placed), mesh, n_reps=n_reps,
                             samples=samples, measure=measure)
        _record_candidate("promotion", t_gemm, pred_gemm.get(b))
        if t_gemm is None:
            log(f"  {context} b={b}: unmeasurable")
            continue
        gemm_times[str(b)] = t_gemm
        wins = t_gemm < (1.0 - min_gain) * b * t_seq
        log(f"  {context} b={b}: gemm {t_gemm * 1e6:.1f} us vs seq "
            f"{b * t_seq * 1e6:.1f} us{'  <- wins' if wins else ''}")
        if wins and b_star is None:
            b_star = b
    if not gemm_times:
        return None
    best = {"b_star": b_star, "seq_time_s": t_seq, "gemm_times": gemm_times}
    if pred_seq is not None:
        best["predicted_s"] = {"seq": pred_seq,
                               **{str(b): t for b, t in pred_gemm.items()}}
    if pruned:
        best["pruned"] = pruned
    cache.record(key, best)
    return best


# ------------------------------------------------------------- overlap


def tune_overlap(
    strategy_name: str, mesh: Mesh, m: int, k: int, dtype: str,
    cache: TuningCache, *, kernel: str = "cuda", measure: str = "auto",
    n_reps: int = TUNE_N_REPS, samples: int = TUNE_SAMPLES, force: bool = False,
    seed: int = 0, min_gain: float = TUNE_MIN_GAIN,
    prune_margin: float | None = None, log: Callable[[str], None] = print,
) -> dict[str, Any] | None:
    """The staged-overlap stage count: build ``combine="overlap"`` at every
    valid S of :data:`OVERLAP_STAGE_LADDER`, race the full distributed
    matvecs and record the winner (``overlap_key``), which
    ``build(combine="overlap")`` and the engine read when ``stages`` is
    None. S = 1 keeps the seat within the margin. A strategy or shape with
    no staged schedule records nothing."""
    from ..parallel.ring import stage_ladder

    p = mesh.size
    key = overlap_key(strategy_name, m, k, p, dtype)
    existing = _lookup(cache, "overlap", key, force, log)
    if existing is not None:
        return existing
    strat = get_strategy(strategy_name)
    try:
        if "overlap" not in strat.combine_candidates(mesh):
            return None
        (strat.with_combine("overlap") or strat).validate(m, k, mesh)
    except MatvecError:
        return None
    chunk_devices = strat.overlap_chunk_devices(mesh)
    ladder = [s for s in OVERLAP_STAGE_LADDER
              if s in stage_ladder(m, chunk_devices, OVERLAP_STAGE_LADDER)]
    if not ladder:
        return None
    context = f"overlap {strategy_name} {m}x{k} p={p} S="
    # The prediction plan, per-S labels (as _predict_combines).
    from .cost_model import model_from_cache

    model = model_from_cache(cache, p)
    predictions: dict[str, float] = {}
    if model is not None:
        r_, _c = mesh_grid_shape(mesh)
        for s in ladder:
            try:
                predictions[str(s)] = model.predict(
                    _family(strategy_name), "overlap", m=m, k=k, p=p,
                    dtype=dtype, stages=s, r=r_).total_s
            except KeyError:
                break  # no staged formula for this family
    measure_set, pruned = _plan(model, predictions, keep={"1"},
                                prune_margin=prune_margin,
                                context=context.removesuffix("="), log=log)
    ladder = _measure_plan(ladder, predictions, measure_set)
    a = _uniform((m, k), dtype, seed, mesh.devices[0])
    x = _uniform((k,), dtype, seed + 1, mesh.devices[0])

    def bench(s: int, reps: int, chain_samples: int):
        return benchmark_strategy(
            strat, mesh, a, x, dtype=dtype, n_reps=reps, measure=measure,
            kernel=kernel, combine="overlap", stages=s,
            chain_samples=chain_samples)

    try:
        bench(ladder[0], 1, 1)
    except TimingError:
        pass

    def run(label: str) -> float | None:
        try:
            return float(min(bench(int(label), n_reps, samples).times_s))
        except TimingError:
            return None

    # One pass, no confirmation, as in the JAX package's stage axis.
    measured: dict[str, float] = {}
    for label in map(str, ladder):
        t = run(label)
        _record_candidate("overlap", t, predictions.get(label))
        if t is None:
            log(f"  {context}{label}: unmeasurable")
            continue
        measured[label] = t
        log(f"  {context}{label}: {t * 1e6:.1f} us")
    winner = _pick_winner(measured, "1", min_gain)
    if winner is None:
        return None
    best = _with_predictions(
        {"stages": int(winner), "time_s": measured[winner], "candidates": measured},
        predictions, pruned)
    cache.record(key, best)
    return best


# ------------------------------------------------------------- storage


def storage_format_candidates(dtype: str) -> list[str]:
    """The formats the storage axis races: ``native``, the quantized ladder
    (``ops.quantize.STORAGE_FORMATS``), ``fp8`` where this torch has it, and
    ``speculate``: the fused int8c candidate and acceptance check
    (``ops.speculative``), whose race time is the speculative tier's accept
    path. A recorded ``speculate`` winner paid for the check in the race and
    still beat native; the escalation tail is the cost model's ε term."""
    from ..ops.quantize import STORAGE_FORMATS, fp8_supported

    del dtype
    return ["native"] + [f for f in STORAGE_FORMATS
                         if f != "fp8" or fp8_supported()] + ["speculate"]


def tune_storage(
    strategy_name: str, mesh: Mesh, m: int, k: int, dtype: str,
    cache: TuningCache, *, kernel: str = "cuda", n_reps: int = TUNE_N_REPS,
    samples: int = TUNE_SAMPLES, force: bool = False, seed: int = 0,
    min_gain: float = TUNE_MIN_GAIN, prune_margin: float | None = None,
    measure: str = "loop", log: Callable[[str], None] = print,
) -> dict[str, Any] | None:
    """The resident storage format: quantize A into each candidate format,
    place it by the strategy and race the full distributed matvecs; native
    keeps the seat within the margin (a lossy format must win outright).
    Each candidate's resident bytes and achieved bandwidth (resident bytes
    over its time) are recorded beside the winner (``storage_key``), which
    the engine's ``dtype_storage="auto"`` reads.

    Pruning ranks the formats on the predicted compute term alone (the
    resident stream, the formats' whole difference; the shared collective
    cost would drown it); when every challenger is pruned, native keeps the
    seat unmeasured (``predicted_only``)."""
    from ..ops.quantize import quantize_matrix
    from ..staticcheck.hlo import dtype_itemsize
    from .cost_model import model_from_cache

    p = mesh.size
    key = storage_key(strategy_name, m, k, p, dtype)
    existing = _lookup(cache, "storage", key, force, log)
    if existing is not None:
        return existing
    strat = get_strategy(strategy_name)
    try:
        strat.validate(m, k, mesh)
    except MatvecError:
        return None
    if not strat.storage_combine_ok(None):
        return None  # bound to a schedule that tiles A: no quantized face
    context = f"storage {strategy_name} {m}x{k} p={p}"
    formats = storage_format_candidates(dtype)
    predictions: dict[str, float] = {}
    rank_preds: dict[str, float] = {}
    model = model_from_cache(cache, p)
    if model is not None:
        r_, _c = mesh_grid_shape(mesh)
        for fmt in formats:
            try:
                pred = model.predict(
                    _family(strategy_name), strat.default_combine(mesh), m=m,
                    k=k, p=p, dtype=dtype, storage=fmt, r=r_)
            except KeyError:
                break  # no formula for the default schedule
            predictions[fmt] = pred.total_s
            rank_preds[fmt] = pred.compute_s
    measure_set, pruned = _plan(model, rank_preds, keep={"native"},
                                prune_margin=prune_margin, context=context,
                                log=log)
    formats = _measure_plan(formats, rank_preds, measure_set)
    if measure_set is not None and set(formats) == {"native"}:
        # Every challenger pruned: native keeps the seat by construction, and
        # measuring it alone would compare it with nothing.
        log(f"  {context}: all challengers pruned - native keeps the seat, "
            "measurement skipped")
        best = {
            "storage": "native", "time_s": predictions["native"],
            "predicted_only": True, "candidates": {},
            "resident_bytes": {"native": m * k * dtype_itemsize(dtype)},
            "bandwidth_gbps": {}, "predicted_s": predictions, "pruned": pruned,
        }
        cache.record(key, best)
        return best
    dev = mesh.devices[0]
    a = _uniform((m, k), dtype, seed, dev)
    x = _uniform((k,), dtype, seed + 1, dev)
    shards = strat.contraction_shards(mesh)
    resident: dict[str, int] = {}
    programs: dict[str, tuple] = {}

    def candidate(fmt: str) -> tuple:
        if fmt not in programs:
            if fmt == "speculate":
                programs[fmt], resident[fmt] = speculative_candidate()
                return programs[fmt]
            if fmt == "native":
                fn = strat.build(mesh, kernel=kernel)
                op, nbytes = a, a.numel() * a.element_size()
            else:
                op = quantize_matrix(a, fmt, contraction_shards=shards)
                fn = strat.build(mesh, kernel=kernel, dtype_storage=fmt)
                nbytes = op.nbytes
            resident[fmt] = int(nbytes)
            programs[fmt] = (fn, strat.place(op, x, mesh))
        return programs[fmt]

    def speculative_candidate() -> tuple:
        """The fused candidate and check over the int8c resident, P and U,
        in the race's two-argument face. The check's outputs are folded
        into the timed output, so every rep runs the whole program."""
        from ..ops.speculative import (
            SPEC_RTOL_FLOOR, build_speculative, probe_count, probe_matrix,
            probe_spec, project_probes,
        )
        from ..parallel.mesh import shard

        qa = quantize_matrix(a, "int8c", contraction_shards=shards)
        s = probe_count(SPEC_RTOL_FLOOR)
        u = probe_matrix(s, m, a.dtype).to(dev)
        pm = project_probes(u, a, a.dtype, device=dev)
        spec_fn = build_speculative(strat, mesh, probes=s, kernel=kernel, storage="int8c")

        def fn(ops, x_placed):
            y, est, accept = spec_fn(ops[0], ops[1], ops[2], x_placed, ops[3])
            return torch.cat([y, est.reshape(1).to(y.dtype), accept.reshape(1).to(y.dtype)])

        qa_placed, x_placed = strat.place(qa, x, mesh)
        ops = (qa_placed, shard(pm, probe_spec(strat, mesh), mesh), u,
               torch.full((), 1e-3, dtype=torch.float32, device=dev))
        nbytes = qa.nbytes + u.numel() * u.element_size() + pm.numel() * pm.element_size()
        return (fn, (ops, x_placed)), int(nbytes)

    plan = []
    for fmt in formats:
        try:
            candidate(fmt)
            plan.append(fmt)
        except MatvecError as e:
            log(f"  {context} {fmt}: skip ({e})")
    if not plan:
        return None
    fn0, args0 = candidate(plan[0])
    _measure_fn(fn0, args0, mesh, n_reps=max(1, n_reps // 4), samples=1,
                measure=measure)

    def run(fmt: str) -> float | None:
        fn, args = candidate(fmt)
        return _measure_fn(fn, args, mesh, n_reps=n_reps, samples=samples,
                           measure=measure)

    winner, measured = _race("storage", context, plan, run, "native",
                             min_gain, log, predictions)
    if winner is None:
        return None
    best = _with_predictions({
        "storage": winner, "time_s": measured[winner], "candidates": measured,
        "resident_bytes": {f: resident[f] for f in measured},
        "bandwidth_gbps": {f: resident[f] / t / 1e9 for f, t in measured.items()},
    }, predictions, pruned)
    cache.record(key, best)
    return best


# ------------------------------------------------------- solver iteration


def tune_solver_kernel(
    op: str, strategy_name: str, mesh: Mesh, m: int, k: int, dtype: str,
    cache: TuningCache, *, storage: str = "native", kernel: str = "cuda",
    n_reps: int = TUNE_N_REPS, samples: int = TUNE_SAMPLES, force: bool = False,
    seed: int = 0, min_gain: float = TUNE_MIN_GAIN,
    prune_margin: float | None = None, measure: str = "sync",
    log: Callable[[str], None] = print,
) -> dict[str, Any] | None:
    """The solver iteration tier: the unfused ``torch`` loop (the strategy's
    matvec on ``kernel`` plus PyTorch vector ops) against ``cuda_fused``
    (one fused step per shard, ``ops/cuda_solver.py``), as full solves of
    :data:`SOLVER_RACE_ITERS` iterations each (``rtol = 0`` never
    converges) on the seeded SPD operand, so both tiers do equal work. The
    unfused tier keeps the seat within the margin; the engine's
    ``solver_kernel="auto"`` reads the winner (``solver_kernel_key``).

    The default ``measure="sync"``: a solve reads its continuation flag on
    the host, so it cannot run inside a captured rep loop. The fused
    candidate is offered only on a CUDA mesh; with one candidate there is no race, and nothing is recorded (the
    ``auto`` tier's miss already answers ``torch``), as for an (op,
    strategy) pair the fused tier does not serve."""
    from ..bench.serve import gershgorin_interval, solver_operand
    from ..ops.cuda_solver import (
        FUSED_SOLVER_OPS,
        check_fused_solver,
        fused_solver_supported,
    )
    from ..ops.quantize import NATIVE, quantize_matrix
    from ..solvers import build_solver
    from ..solvers.ops import placed_operand

    if op not in FUSED_SOLVER_OPS or m != k:
        return None
    p = mesh.size
    key = solver_kernel_key(op, strategy_name, m, k, p, dtype, storage)
    existing = _lookup(cache, "solver_kernel", key, force, log)
    if existing is not None:
        return existing
    strat = get_strategy(strategy_name)
    try:
        strat.validate(m, k, mesh)
    except MatvecError:
        return None
    if not fused_solver_supported(op, strategy_name, None, mesh):
        return None
    if storage != NATIVE and not strat.storage_combine_ok(None):
        return None
    context = f"solver_kernel {op} {strategy_name} {m}x{k} p={p}"
    dev = mesh.devices[0]
    if not _cuda_offered(dev):
        log(f"  {context}: the fused tier is offered on CUDA meshes - nothing to race")
        return None
    # Both tiers share the matvec terms; only the per-iteration launch count
    # differs (cost_model.SOLVER_KERNEL_LAUNCHES).
    from .cost_model import model_from_cache

    tiers = ["torch", "cuda_fused"]
    predictions: dict[str, float] = {}
    model = model_from_cache(cache, p)
    if model is not None:
        r_, _c = mesh_grid_shape(mesh)
        for tier in tiers:
            comb = (check_fused_solver(op, strategy_name, None, mesh)
                    if tier == "cuda_fused" else strat.default_combine(mesh))
            try:
                predictions[tier] = model.predict_solver(
                    op, strategy_name, comb, m=m, k=k, p=p, dtype=dtype,
                    k_est=SOLVER_RACE_ITERS, storage=storage, r=r_,
                    kernel=tier).total_s
            except KeyError:
                predictions = {}
                break
    measure_set, pruned = (
        _plan(model, predictions, keep={"torch"}, prune_margin=prune_margin,
              context=context, log=log) if predictions else (None, []))
    a = solver_operand(m, dtype, seed, device=dev)
    p0, p1 = gershgorin_interval(a) if op == "chebyshev" else (0.0, 0.0)
    b = _uniform((m,), dtype, seed + 1, dev)
    operand = a if storage == NATIVE else quantize_matrix(
        a, storage, contraction_shards=strat.contraction_shards(mesh))
    a_placed = placed_operand(strat, mesh, operand)
    del a, operand
    fns: dict[str, Callable] = {}
    for tier in _measure_plan(tiers, predictions, measure_set):
        solve = build_solver(
            op, strat, mesh, dtype=torch_dtype(dtype),
            kernel="cuda_fused" if tier == "cuda_fused" else kernel,
            dtype_storage=storage)

        def timed(a_, b_, solve=solve):
            # The iterate alone: a data dependence on the whole loop.
            return solve(a_, b_, 0.0, SOLVER_RACE_ITERS, p0, p1).x

        fns[tier] = timed
    _measure_fn(fns["torch"], (a_placed, b), mesh, n_reps=max(1, n_reps // 4),
                samples=1, measure=measure)
    winner, measured = _race(
        "solver_kernel", context, list(fns),
        lambda tier: _measure_fn(fns[tier], (a_placed, b), mesh, n_reps=n_reps,
                                 samples=samples, measure=measure),
        "torch", min_gain, log, predictions)
    if winner is None:
        return None
    best = _with_predictions({
        "solver_kernel": winner, "time_s": measured[winner],
        "iter_s": measured[winner] / SOLVER_RACE_ITERS,
        "race_iters": SOLVER_RACE_ITERS, "candidates": measured,
    }, predictions, pruned)
    cache.record(key, best)
    return best


# ------------------------------------------------------------ sweep-level


def local_gemv_shapes(strategy_name: str, m: int, k: int,
                      mesh: Mesh) -> set[tuple[int, int]]:
    """The LOCAL per-shard GEMV shapes a strategy gives its kernel for a
    GLOBAL (m, k) on ``mesh``: the shapes the ``auto`` kernel tier looks
    up, so the shapes worth tuning."""
    p = mesh.size
    shapes: set[tuple[int, int]] = set()
    if strategy_name == "rowwise":
        if m % p == 0:
            shapes.add((m // p, k))
    elif strategy_name == "blockwise":
        if len(mesh.axis_names) != 2:
            return shapes  # no grid: blockwise has no local shape here
        r, c = mesh_grid_shape(mesh)
        if m % r == 0 and k % c == 0:
            shapes.add((m // r, k // c))
    elif strategy_name.startswith("colwise"):
        if k % p == 0:
            shapes.add((m, k // p))
            # The overlapped ring calls the kernel on (m/p, k/p) tiles, and
            # an auto combine may resolve to it.
            if m % p == 0:
                shapes.add((m // p, k // p))
    return shapes


def tune_config(
    strategy_name: str, mesh: Mesh, m: int, k: int, dtype: str,
    cache: TuningCache, *, op: str = "matvec", n_rhs: int | None = None,
    kernel: str = "cuda", measure: str = "auto", n_reps: int = TUNE_N_REPS,
    samples: int = TUNE_SAMPLES, force: bool = False, seed: int = 0,
    min_gain: float = TUNE_MIN_GAIN, memo: dict | None = None,
    prune_margin: float | None = None, log: Callable[[str], None] = print,
) -> None:
    """Tune everything one sweep config reads at dispatch: the local kernel
    keys of each per-shard shape, the overlap stages, the combine schedule
    (matvec or gemm), the storage format, and on square shapes the solver
    tier of each fused op (at native storage and at the storage winner)."""
    kernel_measure = "loop" if measure == "auto" else measure
    common = dict(n_reps=n_reps, samples=samples, force=force, seed=seed,
                  min_gain=min_gain, prune_margin=prune_margin, log=log)
    # Stage axis BEFORE the combine axis: the combine race measures
    # "overlap" at the S just recorded (passed explicitly: the dispatch
    # singleton has not read the cache again).
    if op == "gemm":
        n = n_rhs or k
        for lm, lk in sorted(local_gemv_shapes(strategy_name, m, k, mesh)):
            tune_gemm(lm, lk, n, dtype, cache, measure=kernel_measure,
                      device=mesh.devices[0], **common)
        ov = tune_overlap(strategy_name, mesh, m, k, dtype, cache, kernel=kernel,
                          measure=measure, **common)
        tune_gemm_combine(strategy_name, mesh, m, k, n, dtype, cache,
                          kernel=kernel, measure=measure,
                          stages=(ov or {}).get("stages"), **common)
        tune_storage(strategy_name, mesh, m, k, dtype, cache, kernel=kernel,
                     measure=kernel_measure, **common)
        return
    for lm, lk in sorted(local_gemv_shapes(strategy_name, m, k, mesh)):
        tune_gemv(lm, lk, dtype, cache, measure=kernel_measure,
                  device=mesh.devices[0], **common)
    ov = tune_overlap(strategy_name, mesh, m, k, dtype, cache, kernel=kernel,
                      measure=measure, **common)
    tune_combine(strategy_name, mesh, m, k, dtype, cache, kernel=kernel,
                 measure=measure, memo=memo, stages=(ov or {}).get("stages"),
                 **common)
    st = tune_storage(strategy_name, mesh, m, k, dtype, cache, kernel=kernel,
                      measure=kernel_measure, **common)
    if m == k:
        from ..ops.cuda_solver import FUSED_SOLVER_OPS

        # speculate is a dispatch policy, not a format a solver loop holds.
        formats = {"native"}
        if st and st.get("storage") not in (None, "native", "speculate"):
            formats.add(st["storage"])
        for solver_op in FUSED_SOLVER_OPS:
            for fmt in sorted(formats):
                tune_solver_kernel(solver_op, strategy_name, mesh, m, k, dtype,
                                   cache, storage=fmt, kernel=kernel, **common)


def tune_sweep(
    strategies: Iterable[str], sizes: Iterable[tuple[int, int]],
    meshes: Iterable[Mesh], dtype: str, cache: TuningCache, *,
    op: str = "matvec", n_rhs: int | None = None, kernel: str = "cuda",
    measure: str = "auto", n_reps: int = TUNE_N_REPS,
    samples: int = TUNE_SAMPLES, force: bool = False, seed: int = 0,
    min_gain: float = TUNE_MIN_GAIN, prune_margin: float | None = None,
    log: Callable[[str], None] = print,
) -> TuningCache:
    """Fill the cache for a whole sweep grid, saving after each (size, mesh)
    cell so an interrupted pass keeps its progress."""
    strategies = list(strategies)
    meshes = list(meshes)
    memo: dict = {}  # shared candidate measurements (see tune_combine)
    for m, k in sizes:
        for mesh in meshes:
            for name in strategies:
                tune_config(
                    name, mesh, m, k, dtype, cache, op=op, n_rhs=n_rhs,
                    kernel=kernel, measure=measure, n_reps=n_reps,
                    samples=samples, force=force, seed=seed, min_gain=min_gain,
                    memo=memo, prune_margin=prune_margin, log=log,
                )
            cache.save()
    return cache
