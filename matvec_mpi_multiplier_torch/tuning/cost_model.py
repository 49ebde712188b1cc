"""Analytic per-config cost model over the symbolic collective census.

The port's counterpart of the JAX package's ``tuning/cost_model.py``. The
collective cost of a schedule is well predicted by an α–β model over payload
bytes × hops and link bandwidth, and ``staticcheck/hlo.py`` derives every
config's exact per-device transfer bytes. This module turns that census
into a calibrated time model:

    T(cfg, m, k, b, p, dtype) = max(T_compute, T_wire) + T_latency

* **T_compute** — the per-device kernel body: ``2·m·k·b/p`` FLOPs against
  the calibrated achievable FLOP/s, or the resident-A stream
  (``a_bytes_ratio × m·k·itemsize / p``; quantized formats inherit their
  structural byte ratio, ``staticcheck.hlo.storage_bytes_ratio``) against
  the calibrated local bandwidth, whichever binds. The division by ``p``
  assumes p devices at work at once: on p logical shards of one card the
  shards run one after another, and the prediction is that much short.
* **T_wire** — the collective payload each kind moves
  (``staticcheck.hlo.schedule_formula``), scaled by the standard α–β wire
  factor (2(p−1)/p for all-reduce, (p−1)/p for gather/scatter/all-to-all, 1
  for a neighbor permute hop) over the calibrated per-link bandwidth β.
* **T_latency** — op count × the calibrated per-collective launch latency
  α. A staged ``overlap@S`` schedule predicts the same total wire bytes as
  its un-staged form but S× the latency term.

``gather`` combines end in a gather of y the census does not list; the
model adds it explicitly (:func:`implicit_schedule`).

Every prediction is the JAX package's arithmetic: the same floating-point
operations on equal arguments (held bitwise in the tests).

**Calibration** (:func:`calibrate`): ~6 probe measurements under the bench
protocol (``bench/timing.py::time_matvec``) — a local GEMV (resident
bandwidth) and a local GEMM (FLOP/s) through the engine's own kernels
(``gemv_cuda``, ``gemm_cuda``), and small/large psum + ppermute pairs over
the mesh's collectives (per-family α from the small probe, β from the
large pair's difference). On a CUDA mesh the local probes stream well
beyond the card's L2 and the GEMM is compute-bound (:data:`CUDA_PROBES`);
the probe shapes go into ``Calibration.probes``. The constants persist into
the tuning cache as a ``calibration`` record (schema v5,
``cache.calibration_key``), which the JAX package reads too. The ``quick``
level (2 probes) gives crude absolute numbers and the same candidate
ranking.

**Consumers**: the tuner's ``prune_margin`` mode (``search.py`` measures
only candidates predicted within the ambiguity margin of the predicted
winner, logging every pruned candidate); the global scheduler's admission,
interleaving and reshard trigger (``engine/global_scheduler.py``); the
prediction CLI (``python -m matvec_mpi_multiplier_torch.tuning.cost_model``
emits the predicted combine-crossover surface over (m, k, p, dtype) as CSV,
or ``--calibrate full|quick`` runs the probes); and obs
(:func:`record_prediction` feeds the ``tuning_predicted_vs_measured_ratio``
histogram and the divergence gauge; :func:`divergence_health` surfaces
sustained divergence in ``engine.health()``).
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import sys
from typing import Any, Callable, Iterable

import numpy as np

from .cache import TuningCache, calibration_key

# Sustained-divergence regression signal (divergence_health): median
# |log10(predicted/measured)| over the observation window beyond this,
# with at least MIN_SAMPLES observations, marks the model divergent —
# either the machine changed (recalibrate) or a schedule regressed.
DIVERGENCE_LOG10 = 1.0
DIVERGENCE_MIN_SAMPLES = 8

# Prior escalation rate ε of the speculative tier's expected cost; the port
# has no speculative tier yet (ROADMAP.md, queue A 3), so it only stands
# ready for refresh_escalation_rate.
DEFAULT_ESCALATION_RATE = 0.02

# Metric names (the obs `cost model` panel and divergence_health read
# these; search._record_candidate writes them).
RATIO_HISTOGRAM = "tuning_predicted_vs_measured_ratio"
DIVERGENCE_HISTOGRAM = "tuning_cost_model_abs_log10_ratio"
DIVERGENCE_GAUGE = "tuning_cost_model_divergence"
PRUNED_COUNTER = "tuning_pruned_candidates_total"

_PERMUTE = "collective-permute"

# Per-iteration kernel-launch census of the two solver iteration tiers,
# counting only the launches CostModel.predict does not already price: the
# unfused ``torch`` tier dispatches the GEMV plus the vector updates, the
# residual reduction and the scalar recurrence as separate launches (~5
# extra an iteration); the fused ``cuda_fused`` step is one call (1 extra).
# Each is charged at the calibrated collective launch latency α. The
# counts are the JAX package's (its ``xla`` and ``pallas_fused`` tiers).
SOLVER_KERNEL_LAUNCHES = {"torch": 5, "cuda_fused": 1}

# Probe shapes. The JAX package's, sized for a CPU host: a 16 MB fp32 GEMV
# and a 113 MFLOP GEMM. On a CUDA mesh (CUDA_PROBES) the GEMV streams at
# least five times the H100's 50 MB L2 and the GEMM is compute-bound.
# Collective probes are small/large pairs so α and β separate.
_GEMV_SHAPE = (1024, 4096)
_GEMM_SHAPE = (384, 384, 384)
CUDA_PROBES = {"gemv": (8192, 16384), "gemm": (8192, 8192, 8192)}
_COLL_SMALL = 256              # elements: latency-dominated
_COLL_LARGE = 1 << 20          # elements: bandwidth-dominated
_PERM_LARGE = 1 << 18


@dataclasses.dataclass(frozen=True)
class Calibration:
    """The machine constants one probe pass measured (cache schema v5).

    ``alpha_s``/``beta_bps`` are per collective *family*: ``"permute"``
    (one neighbor hop) vs ``"collective"`` (all-reduce, all-gather,
    reduce-scatter, all-to-all). ``probes`` keeps the raw measurements and
    the probe shapes the constants were derived from."""

    flops: float                 # achievable FLOP/s per device
    mem_bps: float               # local resident-stream bytes/s per device
    alpha_s: dict[str, float]    # per-op launch latency by family
    beta_bps: dict[str, float]   # per-link bandwidth by family
    p: int                       # mesh size the calibration ran on
    level: str = "full"          # "full" (6 probes) | "quick" (2)
    probes: dict[str, float] = dataclasses.field(default_factory=dict)

    def to_record(self) -> dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_record(cls, record: dict[str, Any] | None) -> "Calibration | None":
        """Rebuild from a cache record; None for a missing or malformed one
        (an uncalibrated cache reads as 'no model', never crashes)."""
        if not isinstance(record, dict):
            return None
        try:
            cal = cls(**{
                f.name: record[f.name]
                for f in dataclasses.fields(cls)
                if f.name in record
            })
            # Inside the try: a hand-edited string constant passes
            # construction and raises TypeError on the comparisons.
            if not (cal.flops > 0 and cal.mem_bps > 0):
                return None
            for fam in ("collective", "permute"):
                if not (cal.alpha_s[fam] >= 0 and cal.beta_bps[fam] > 0):
                    return None
        except (TypeError, KeyError):
            return None
        return cal

    @classmethod
    def synthetic(cls, p: int = 8) -> "Calibration":
        """Preview constants of one NVIDIA H100 80GB HBM3 at a 700 W power
        limit, from the port's own card records (PERF.md's kernel table and
        findings): 580 TFLOP/s, the 4096³ bf16 GEMM's 0.2368 ms; 3.22 TB/s,
        the 65536² bf16 GEMV's 2.663 ms; β 1.5 TB/s, half the 3.03 TB/s
        on-card copy rate a reshard moves payload at; α 50 µs, the host time
        of one GEMM call (47–54 µs). For the CLI's
        ``--synthetic-calibration``; never persisted."""
        return cls(
            flops=5.8e14, mem_bps=3.22e12,
            alpha_s={"collective": 5.0e-5, "permute": 5.0e-5},
            beta_bps={"collective": 1.5e12, "permute": 1.5e12},
            p=p, level="synthetic", probes={},
        )


def family(kind: str) -> str:
    """Census kind → calibration family."""
    return "permute" if kind == _PERMUTE else "collective"


def wire_factor(kind: str, p: int) -> float:
    """The standard α–β wire-traffic factor: census payload bytes → bytes
    crossing a link per device (ring algorithms)."""
    if p <= 1:
        return 0.0
    if kind == _PERMUTE:
        return 1.0
    if kind == "all-reduce":
        return 2.0 * (p - 1) / p
    # all-gather / reduce-scatter / all-to-all
    return (p - 1) / p


def implicit_schedule(
    strategy: str, combine: str, *, m: int, itemsize: int
) -> tuple[dict[str, int], dict[str, int]]:
    """The collective the census does not list: ``gather`` combines end in
    a gather of the sharded y. The model adds it back so gather-family
    predictions carry their communication."""
    if combine == "gather":
        return {"all-gather": 1}, {"all-gather": m * itemsize}
    return {}, {}


@dataclasses.dataclass(frozen=True)
class Prediction:
    """One predicted config time, decomposed the way the model computed it
    (the CLI's CSV columns)."""

    total_s: float
    compute_s: float
    wire_s: float
    latency_s: float
    flops: float
    a_bytes: int
    wire_bytes: float


@dataclasses.dataclass(frozen=True)
class AdmissionEstimate:
    """The global scheduler's queue-aware admission question, answered
    (:meth:`CostModel.predict_admission`): how long until this request's
    result, counting everything already enqueued.

    ``eta_s = queue_s + swap_s + dispatch_s`` — the predicted backlog of
    outstanding dispatches, the restore transfer if the tenant's ``A`` is
    evicted, and the dispatch itself."""

    dispatch_s: float   # this request's predicted dispatch time
    queue_s: float      # predicted backlog ahead of it (caller-supplied)
    swap_s: float       # predicted restore cost (0 when resident)

    @property
    def eta_s(self) -> float:
        return self.queue_s + self.swap_s + self.dispatch_s


class CostModel:
    """Predict per-config dispatch time from one :class:`Calibration`.

    Predictions are analytic in (m, k, b, p, dtype, storage): the mesh size
    generalizes symbolically (α/β were measured at one p; hop counts and
    wire factors come from the formula)."""

    def __init__(self, calibration: Calibration):
        self.calibration = calibration
        self.escalation_rate = DEFAULT_ESCALATION_RATE

    def refresh_escalation_rate(self, registry=None) -> float:
        """Adopt the measured escalation rate from an obs registry's
        ``engine_escalation_rate`` gauge once
        ``engine_speculative_dispatches_total`` shows speculative traffic
        (the port serves none yet, so the prior stays). Reads via
        ``snapshot()``, which creates nothing. Returns the rate in effect."""
        from ..obs.registry import get_registry

        reg = registry if registry is not None else get_registry()
        snap = reg.snapshot()
        dispatches = snap.get("counters", {}).get(
            "engine_speculative_dispatches_total", 0
        )
        rate = snap.get("gauges", {}).get("engine_escalation_rate")
        if dispatches and rate is not None:
            self.escalation_rate = float(rate)
        return self.escalation_rate

    def predict_local(
        self, m: int, k: int, dtype: str, *, b: int = 1,
        storage: str = "native",
    ) -> Prediction:
        """The compute-only face: one device's GEMV/GEMM body (no mesh, no
        collectives)."""
        return self.predict(
            None, None, m=m, k=k, p=1, dtype=dtype, b=b, storage=storage
        )

    def predict(
        self,
        strategy: str | None,
        combine: str | None,
        *,
        m: int,
        k: int,
        p: int,
        dtype: str,
        stages: int | None = None,
        b: int = 1,
        storage: str = "native",
        r: int | None = None,
    ) -> Prediction:
        """``T(cfg, m, k, b, p, dtype)`` per the module-docstring model.
        ``strategy=None`` (or p=1) predicts the bare local kernel. ``r`` is
        the blockwise grid's row count, most-square from p when omitted."""
        # Imported at call time on purpose: patching hlo.schedule_formula
        # reddens every prediction through the one shared symbol.
        from ..staticcheck import hlo

        if storage == "speculate":
            from ..models.base import not_ported

            raise not_ported(
                "predict(storage='speculate') (speculative dispatch, queue A 3)"
            )

        cal = self.calibration
        itemsize = hlo.dtype_itemsize(dtype)
        census: dict[str, int] = {}
        payload: dict[str, int] = {}
        if strategy is not None and combine is not None and p > 1:
            if r is None:
                from ..parallel.mesh import most_square_factors

                r, _c = most_square_factors(p)
            census, payload = hlo.schedule_formula(
                strategy, combine, stages, m=m, p=p, r=r, itemsize=itemsize
            )
            icensus, ipayload = implicit_schedule(
                strategy, combine, m=m, itemsize=itemsize
            )
            census = {**census, **icensus}
            payload = {**payload, **ipayload}

        latency_s = sum(
            n * cal.alpha_s[family(kind)] for kind, n in census.items()
        )
        wire_bytes = 0.0
        wire_s = 0.0
        for kind, bytes_ in payload.items():
            # A batched dispatch moves the combine's payload once per RHS
            # column: y is (m, b).
            wb = float(bytes_) * b * wire_factor(kind, p)
            wire_bytes += wb
            wire_s += wb / cal.beta_bps[family(kind)]

        a_bytes = int(round(
            m * k * itemsize * hlo.storage_bytes_ratio(storage, itemsize)
        ))
        flops = 2.0 * m * k * b
        compute_s = max(
            (flops / p) / cal.flops,
            (a_bytes / p) / cal.mem_bps,
        )
        total_s = max(compute_s, wire_s) + latency_s
        return Prediction(
            total_s=total_s, compute_s=compute_s, wire_s=wire_s,
            latency_s=latency_s, flops=flops, a_bytes=a_bytes,
            wire_bytes=wire_bytes,
        )

    def predict_solver(
        self,
        op: str,
        strategy: str | None,
        combine: str | None,
        *,
        m: int,
        k: int,
        p: int,
        dtype: str,
        k_est: int,
        stages: int | None = None,
        storage: str = "native",
        r: int | None = None,
        restart: int | None = None,
        steps: int | None = None,
        kernel: str = "torch",
    ) -> Prediction:
        """One served solve (``engine.submit(op="cg"|...)``): ``k_est``
        iterations × the one-matvec prediction, with each op's iteration
        structure supplied by the solvers' own count
        (``solvers.solver_matvec_count``), plus a per-iteration launch
        overhead ``launches(kernel) × α`` (:data:`SOLVER_KERNEL_LAUNCHES`).
        Admission passes the request's ``maxiter`` as ``k_est``: a
        worst-case, hence conservative, ETA."""
        from ..solvers import (
            DEFAULT_RESTART, DEFAULT_STEPS, SOLVER_OPS, solver_matvec_count,
        )

        if op not in SOLVER_OPS:
            raise ValueError(
                f"unknown solver op {op!r}; expected one of {SOLVER_OPS}"
            )
        if k_est < 1:
            raise ValueError(f"k_est must be >= 1, got {k_est}")
        if kernel not in SOLVER_KERNEL_LAUNCHES:
            raise ValueError(
                f"unknown solver kernel {kernel!r}; expected one of "
                f"{tuple(SOLVER_KERNEL_LAUNCHES)}"
            )
        per = self.predict(
            strategy, combine, m=m, k=k, p=p, dtype=dtype, stages=stages,
            b=1, storage=storage, r=r,
        )
        n_mv = solver_matvec_count(
            op, int(k_est),
            restart=restart if restart is not None else DEFAULT_RESTART,
            steps=steps if steps is not None else DEFAULT_STEPS,
        )
        # Charged once per iteration, not per matvec: the launch structure
        # belongs to the loop body.
        launch_s = (
            float(k_est) * SOLVER_KERNEL_LAUNCHES[kernel]
            * self.calibration.alpha_s["collective"]
        )
        return Prediction(
            total_s=n_mv * per.total_s + launch_s,
            compute_s=n_mv * per.compute_s,
            wire_s=n_mv * per.wire_s,
            latency_s=n_mv * per.latency_s + launch_s,
            flops=n_mv * per.flops,
            a_bytes=per.a_bytes,
            wire_bytes=n_mv * per.wire_bytes,
        )

    def restore_s(self, nbytes: int) -> float:
        """Predicted cost of re-placing an evicted resident payload:
        ``nbytes`` over the calibrated resident-stream bandwidth (the
        ``swap_s`` term of :meth:`predict_admission`). On the card a
        swap-in is a pageable host-to-card copy, far slower than the HBM
        stream this prices it at (PERF.md)."""
        return float(nbytes) / self.calibration.mem_bps

    def predict_reshard(
        self, src: str, dst: str, *, m: int, k: int, p: int, dtype: str,
        r: int | None = None,
    ) -> Prediction:
        """Predicted one-time cost of migrating a resident ``A`` from
        ``src`` to ``dst`` layout on a ``p``-device mesh
        (``parallel.reshard``): the migration program's steps priced by the
        calibrated α–β constants, each step moving the device's 1/p shard
        with the wire factor of its own collective group — ``(g-1)/g`` for
        an ``all_to_all`` over a ``g``-device axis, one full-shard hop for
        a permute. No compute term. The amortized-crossover numerator of
        the global scheduler's ``reshard="auto"`` trigger."""
        # Imported at call time on purpose, as in predict().
        from ..staticcheck import hlo
        from ..parallel.mesh import most_square_factors
        from ..parallel.reshard import reshard_program

        if r is None:
            r, _c = most_square_factors(p)
        c = max(1, p // r)
        cal = self.calibration
        itemsize = hlo.dtype_itemsize(dtype)
        census, _payload = hlo.reshard_formula(
            src, dst, m=m, k=k, p=p, r=r, c=c, itemsize=itemsize
        )
        latency_s = sum(
            n * cal.alpha_s[family(kind)] for kind, n in census.items()
        )
        shard_bytes = float((m * k * itemsize) // p) if p else 0.0
        group = {"flat": p, "rows": r, "cols": c}
        wire_bytes = 0.0
        wire_s = 0.0
        for step in reshard_program(src, dst, r, c):
            if step[0] == "a2a":
                g = group[step[1]]
                wb = shard_bytes * (g - 1) / g
                fam = "collective"
            else:
                wb = shard_bytes
                fam = "permute"
            wire_bytes += wb
            wire_s += wb / cal.beta_bps[fam]
        return Prediction(
            total_s=wire_s + latency_s, compute_s=0.0, wire_s=wire_s,
            latency_s=latency_s, flops=0.0, a_bytes=m * k * itemsize,
            wire_bytes=wire_bytes,
        )

    def predict_admission(
        self,
        strategy: str | None,
        combine: str | None,
        *,
        m: int,
        k: int,
        p: int,
        dtype: str,
        stages: int | None = None,
        b: int = 1,
        storage: str = "native",
        r: int | None = None,
        queue_s: float = 0.0,
        swap_bytes: int = 0,
        op: str = "matvec",
        k_est: int | None = None,
        restart: int | None = None,
        steps: int | None = None,
    ) -> AdmissionEstimate:
        """The queue-aware serving face of :meth:`predict`: the ETA of a
        request submitted now, behind ``queue_s`` of predicted backlog and
        the ``swap_bytes`` restore transfer when its tenant's ``A`` is
        evicted. A solver ``op`` routes through :meth:`predict_solver` with
        ``k_est`` iterations."""
        if op != "matvec":
            if k_est is None:
                raise ValueError(
                    f"predict_admission(op={op!r}) needs k_est (the "
                    "iteration estimate — admission passes maxiter)"
                )
            pred = self.predict_solver(
                op, strategy, combine, m=m, k=k, p=p, dtype=dtype,
                k_est=k_est, stages=stages, storage=storage, r=r,
                restart=restart, steps=steps,
            )
        else:
            pred = self.predict(
                strategy, combine, m=m, k=k, p=p, dtype=dtype,
                stages=stages, b=b, storage=storage, r=r,
            )
        return AdmissionEstimate(
            dispatch_s=pred.total_s,
            queue_s=float(queue_s),
            swap_s=self.restore_s(swap_bytes) if swap_bytes else 0.0,
        )


def model_from_cache(
    cache: TuningCache, p: int, fingerprint: str | None = None
) -> CostModel | None:
    """The cached calibration for a p-device mesh of this platform, as a
    model — or None (uncalibrated: pruning falls back to full
    measurement)."""
    cal = Calibration.from_record(
        cache.lookup(calibration_key(p, fingerprint))
    )
    return CostModel(cal) if cal is not None else None


def any_model_from_cache(
    cache: TuningCache, fingerprint: str | None = None
) -> CostModel | None:
    """Any calibration record for this platform (largest calibrated mesh
    wins): the lookup of the local kernel axes and the global scheduler,
    whose compute constants are per-device and mesh-independent."""
    from .cache import platform_fingerprint

    fp = fingerprint if fingerprint is not None else platform_fingerprint()
    prefix = f"{fp}|calibration|"
    best: Calibration | None = None
    for key in sorted(cache.entries):
        if key.startswith(prefix):
            cal = Calibration.from_record(cache.entries[key])
            if cal is not None and (best is None or cal.p > best.p):
                best = cal
    return CostModel(best) if best is not None else None


# ------------------------------------------------------------ calibration


def _probe_local(fn, a, b, mesh, *, n_reps: int, measure: str) -> float:
    """Minimum per-execution time of one local probe under the bench
    protocol (``bench.timing.time_matvec``, the path every tuner
    measurement rides). Min, not mean: calibration wants the machine's
    capability, not its contention."""
    from ..bench.timing import time_matvec

    times = time_matvec(
        fn, a, b, place=lambda a_, b_: (a_, b_), mesh=mesh, n_reps=n_reps,
        mode="amortized", measure=measure, chain_samples=3,
    )
    return float(min(times))


def _collective_probes(mesh):
    """The psum / ppermute probe programs over every axis of ``mesh``: each
    device presents an n-element block to one collective of the mesh
    (``parallel/mesh.py``), the census's payload semantics. Returns
    ``(psum, permute, place)``."""
    from ..parallel.mesh import ShardedTensor, ppermute, psum, shard

    axes = tuple(mesh.axis_names)
    p = mesh.size
    perm = [(i, (i + 1) % p) for i in range(p)]

    def wrap(blocks, x):
        return ShardedTensor(tuple(blocks), x.shape, x.spec, mesh)

    def psum_body(_a, x):
        return wrap(psum(x.shards, mesh, axes), x)

    def permute_body(_a, x):
        return wrap(ppermute(x.shards, mesh, axes, perm), x)

    def place(a, x):
        return a, shard(x, (axes,), mesh)

    return psum_body, permute_body, place


def _operand(rng, shape, dtype: str, device):
    """A uniform [-1, 1) probe operand of ``dtype`` on ``device``: from the
    seeded numpy stream at the JAX package's (CPU) shapes, made on the card
    at the CUDA shapes (no host copy of a gigabyte operand)."""
    import torch

    from ..utils.convert import torch_dtype

    tdtype = torch_dtype(dtype)
    if device.type != "cuda":
        return torch.from_numpy(rng.uniform(-1, 1, shape)).to(tdtype)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(rng.integers(1 << 31)))
    out = torch.empty(shape, dtype=torch.float32, device=device)
    return out.uniform_(-1, 1, generator=gen).to(tdtype)


def calibrate(
    mesh,
    *,
    dtype: str = "float32",
    level: str = "full",
    n_reps: int = 10,
    measure: str = "sync",
    log: Callable[[str], None] = print,
) -> Calibration:
    """Measure the machine constants (~6 probes, ``level="full"``; 2 for
    ``"quick"``) under the bench protocol and return the
    :class:`Calibration`. Persisting is the caller's move
    (``cache.record(calibration_key(p), cal.to_record())``).

    ``measure="sync"`` by default: the per-rep protocol includes dispatch
    cost in α, which is what the tuner's sync-mode races pay per
    collective. The local probes run on the mesh's first device through
    the engine's kernels; on a CUDA device at :data:`CUDA_PROBES`. A mesh
    of one device has no wire, so its collective probes run on two logical
    shards of that device (``probes["collective_p"]``). Raises
    :class:`~..utils.errors.TimingError` when a probe fails to measure or
    the constants would not read back as a model (a record is never one
    that later reads as 'no model')."""
    import torch

    from ..ops.cuda_gemm import gemm_cuda
    from ..ops.cuda_gemv import gemv_cuda
    from ..parallel.mesh import make_1d_mesh
    from ..bench.timing import time_matvec
    from ..staticcheck.hlo import dtype_itemsize
    from ..utils.convert import torch_dtype
    from ..utils.errors import TimingError

    if level not in ("full", "quick"):
        raise ValueError(f"calibration level must be full|quick, got {level!r}")
    p = mesh.size
    itemsize = dtype_itemsize(dtype)
    rng = np.random.default_rng(0)
    probes: dict[str, float] = {}
    dev = torch.device(mesh.devices[0])
    local = make_1d_mesh(1, devices=[dev])
    on_card = dev.type == "cuda"
    gemv_shape = CUDA_PROBES["gemv"] if on_card else _GEMV_SHAPE
    gemm_shape = CUDA_PROBES["gemm"] if on_card else _GEMM_SHAPE

    # Probe 1 — local GEMV: the resident-A stream (memory-bound).
    gm, gk = gemv_shape
    a = _operand(rng, gemv_shape, dtype, dev)
    x = _operand(rng, (gk,), dtype, dev)
    t_gemv = _probe_local(gemv_cuda, a, x, local, n_reps=n_reps, measure=measure)
    del a, x
    probes.update(gemv_s=t_gemv, gemv_m=float(gm), gemv_k=float(gk))
    mem_bps = gm * gk * itemsize / t_gemv
    log(f"  calibrate: gemv {gm}x{gk} {t_gemv * 1e6:.0f} us "
        f"-> {mem_bps / 1e9:.2f} GB/s local stream")

    if level == "full":
        # Probe 2 — local GEMM: achievable FLOP/s (compute-bound).
        mm, mk, mn = gemm_shape
        ga = _operand(rng, (mm, mk), dtype, dev)
        gb = _operand(rng, (mk, mn), dtype, dev)
        t_gemm = _probe_local(gemm_cuda, ga, gb, local, n_reps=n_reps,
                              measure=measure)
        del ga, gb
        probes.update(gemm_s=t_gemm, gemm_m=float(mm), gemm_k=float(mk),
                      gemm_n=float(mn))
        flops = 2.0 * mm * mk * mn / t_gemm
        log(f"  calibrate: gemm {mm}x{mk}x{mn} {t_gemm * 1e6:.0f} us "
            f"-> {flops / 1e9:.2f} GFLOP/s")
    else:
        # Quick: the GEMV probe bounds FLOP/s too (2 FLOPs per element
        # streamed — an underestimate, consistently applied).
        flops = 2.0 * gm * gk / t_gemv

    coll_mesh = mesh
    if p == 1:
        coll_mesh = make_1d_mesh(2, devices=[dev] * 2)
    cp = coll_mesh.size
    probes["collective_p"] = float(cp)
    psum, permute, place = _collective_probes(coll_mesh)
    dummy = torch.zeros((1,), dtype=torch_dtype(dtype))

    def run_collective(fn, n: int) -> float:
        xs = torch.from_numpy(rng.uniform(-1, 1, (cp, n))).to(torch_dtype(dtype))
        times = time_matvec(
            fn, dummy, xs, place=place, mesh=coll_mesh, n_reps=n_reps,
            mode="amortized", measure=measure, chain_samples=3,
        )
        return float(min(times))

    if level == "full":
        # Probes 3-6 — psum and ppermute, small (α) and large (β).
        t_ps = run_collective(psum, _COLL_SMALL)
        t_pl = run_collective(psum, _COLL_LARGE)
        t_qs = run_collective(permute, _COLL_SMALL)
        t_ql = run_collective(permute, _PERM_LARGE)
        probes.update(psum_small_s=t_ps, psum_large_s=t_pl,
                      permute_small_s=t_qs, permute_large_s=t_ql)
        wire_coll = _COLL_LARGE * itemsize * wire_factor("all-reduce", cp)
        wire_perm = _PERM_LARGE * itemsize  # one hop moves the chunk once
        beta_coll = wire_coll / max(t_pl - t_ps, t_pl * 0.1)
        beta_perm = wire_perm / max(t_ql - t_qs, t_ql * 0.1)
        alpha = {"collective": t_ps, "permute": t_qs}
        beta = {"collective": beta_coll, "permute": beta_perm}
        log(f"  calibrate: psum alpha {t_ps * 1e6:.0f} us, "
            f"beta {beta_coll / 1e9:.2f} GB/s; permute alpha "
            f"{t_qs * 1e6:.0f} us, beta {beta_perm / 1e9:.2f} GB/s")
    else:
        # Quick (probe 2 of 2): one bandwidth-dominated psum; its time split
        # evenly between launch latency and wire.
        t_pl = run_collective(psum, _COLL_LARGE)
        probes["psum_large_s"] = t_pl
        wire_coll = _COLL_LARGE * itemsize * wire_factor("all-reduce", cp)
        alpha = {"collective": t_pl / 2, "permute": t_pl / 2}
        beta = {
            "collective": wire_coll / (t_pl / 2),
            "permute": wire_coll / (t_pl / 2),
        }
        log(f"  calibrate(quick): psum {t_pl * 1e6:.0f} us -> alpha "
            f"{t_pl / 2 * 1e6:.0f} us, beta "
            f"{beta['collective'] / 1e9:.2f} GB/s")

    cal = Calibration(
        flops=flops, mem_bps=mem_bps, alpha_s=alpha, beta_bps=beta,
        p=p, level=level, probes=probes,
    )
    constants = [cal.flops, cal.mem_bps, *alpha.values(), *beta.values()]
    if (not all(math.isfinite(v) for v in constants)
            or Calibration.from_record(cal.to_record()) is None):
        raise TimingError(
            f"calibration on {p} device(s) measured unusable constants "
            f"(flops={flops}, mem_bps={mem_bps}, alpha={alpha}, "
            f"beta={beta}; probes {probes})"
        )
    return cal


# ------------------------------------------------------- obs / divergence


def record_prediction(
    predicted_s: float, measured_s: float, registry=None
) -> None:
    """One (predicted, measured) pair into the obs registry: the ratio
    histogram the `cost model` panel renders, the |log10 ratio| histogram
    behind :func:`divergence_health`, and the divergence gauge — a
    time-decayed EWMA of |log10 ratio| (τ = 300 s), so the panel tracks the
    model's recent agreement. Called by the tuner for every measured
    candidate once a calibration exists."""
    if predicted_s <= 0 or measured_s <= 0:
        return
    from ..obs.registry import get_registry

    reg = registry if registry is not None else get_registry()
    ratio = predicted_s / measured_s
    reg.histogram(
        RATIO_HISTOGRAM,
        "predicted / measured time per tuning candidate",
    ).observe(ratio)
    div = reg.histogram(
        DIVERGENCE_HISTOGRAM,
        "|log10(predicted/measured)| per tuning candidate",
    )
    div.observe(abs(math.log10(ratio)))
    reg.ewma_gauge(
        DIVERGENCE_GAUGE,
        "time-decayed |log10(predicted/measured)| over recent "
        f"candidates (τ=300s) — sustained divergence beyond "
        f"{DIVERGENCE_LOG10} is a regression signal",
        tau_s=300.0,
    ).observe(abs(math.log10(ratio)))


def divergence_health(registry=None) -> dict[str, Any]:
    """The sustained-divergence regression signal (``engine.health()``'s
    ``cost_model`` section and the obs panel): the windowed median
    |log10(predicted/measured)| against :data:`DIVERGENCE_LOG10`, marked
    ``divergent`` only past :data:`DIVERGENCE_MIN_SAMPLES` observations (a
    single noisy candidate is not a regression). Reads the process default
    registry (the tuner's emitter) unless given one."""
    from ..obs.registry import get_registry

    reg = registry if registry is not None else get_registry()
    div = reg.histogram(
        DIVERGENCE_HISTOGRAM,
        "|log10(predicted/measured)| per tuning candidate",
    )
    n = div.count
    median = div.percentile(50) if n else float("nan")
    return {
        "samples": n,
        "median_abs_log10_ratio": median,
        "threshold_log10": DIVERGENCE_LOG10,
        "min_samples": DIVERGENCE_MIN_SAMPLES,
        "divergent": bool(
            n >= DIVERGENCE_MIN_SAMPLES and median > DIVERGENCE_LOG10
        ),
    }


# -------------------------------------------------------------- surfaces

# The combine families the crossover surface predicts per strategy, with
# the staged pair at the ladder's S values.
SURFACE_COMBINES: dict[str, tuple[tuple[str, int | None], ...]] = {
    "rowwise": (
        ("gather", None), ("ring", None),
        ("overlap", 1), ("overlap", 2), ("overlap", 4),
    ),
    "colwise": (
        ("psum", None), ("psum_scatter", None), ("ring", None),
        ("ring_overlap", None), ("a2a", None),
        ("overlap", 1), ("overlap", 2), ("overlap", 4),
        ("overlap_ring", 2), ("overlap_ring", 4),
    ),
    "blockwise": (
        ("gather", None), ("ring", None),
        ("overlap", 1), ("overlap", 2), ("overlap", 4),
    ),
}

SURFACE_COLUMNS = (
    "m", "k", "p", "dtype", "strategy", "combine", "stages",
    "predicted_s", "compute_s", "wire_s", "latency_s", "wire_bytes",
    "winner",
)


def _stage_valid(strategy: str, stages: int | None, m: int, p: int, r: int) -> bool:
    """Keep a surface row only when its chunking divides (the whole-chunk
    constraints the strategies' build functions enforce)."""
    s = stages or 1
    if strategy == "blockwise":
        return r > 1 and m % (r * s) == 0
    return m % (p * s) == 0


def crossover_surface(
    model: CostModel,
    *,
    ms: Iterable[int],
    ks: Iterable[int] | None = None,
    ps: Iterable[int] = (2, 4, 8, 16, 64),
    dtypes: Iterable[str] = ("float32", "bfloat16"),
    b: int = 1,
) -> list[dict[str, Any]]:
    """The predicted combine-crossover surface: for every (m, k, p, dtype,
    strategy) cell, each combine family's predicted time with the per-cell
    winner flagged — the CSV the CLI emits."""
    from ..parallel.mesh import most_square_factors

    rows: list[dict[str, Any]] = []
    ms = list(ms)
    ks = list(ks) if ks is not None else None
    if ks is not None and len(ks) != len(ms):
        raise ValueError(
            f"ks pairs with ms positionally: got {len(ks)} k values for "
            f"{len(ms)} m values"
        )
    for i, m in enumerate(ms):
        k = ks[i] if ks is not None else m
        for p in ps:
            r, _c = most_square_factors(p)
            for dtype in dtypes:
                for strategy, combines in SURFACE_COMBINES.items():
                    cell: list[dict[str, Any]] = []
                    for combine, stages in combines:
                        if not _stage_valid(strategy, stages, m, p, r):
                            continue
                        pred = model.predict(
                            strategy, combine, m=m, k=k, p=p, dtype=dtype,
                            stages=stages, b=b, r=r,
                        )
                        cell.append({
                            "m": m, "k": k, "p": p, "dtype": dtype,
                            "strategy": strategy, "combine": combine,
                            "stages": stages if stages is not None else "",
                            "predicted_s": pred.total_s,
                            "compute_s": pred.compute_s,
                            "wire_s": pred.wire_s,
                            "latency_s": pred.latency_s,
                            "wire_bytes": pred.wire_bytes,
                            "winner": 0,
                        })
                    if cell:
                        best = min(cell, key=lambda row: row["predicted_s"])
                        best["winner"] = 1
                        rows.extend(cell)
    return rows


def write_surface_csv(rows: list[dict[str, Any]], path) -> None:
    import csv
    from pathlib import Path

    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=SURFACE_COLUMNS)
        w.writeheader()
        w.writerows(rows)


# ------------------------------------------------------------------- CLI


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m matvec_mpi_multiplier_torch.tuning.cost_model",
        description="Predict the combine-crossover surface from the "
        "calibrated analytic cost model, or run the calibration probes.",
    )
    p.add_argument(
        "--calibrate", choices=["full", "quick"], default=None,
        help="run the probe protocol on the platform's mesh and persist the "
        "calibration record (cache schema v5)",
    )
    p.add_argument("--devices", type=int, default=None,
                   help="mesh size for --calibrate (default: all)")
    p.add_argument("--shards", type=int, default=None,
                   help="with --platform cuda: calibrate p logical shards on "
                   "the first card instead of one shard per card")
    p.add_argument("--platform", choices=["cuda", "cpu"], default="cuda",
                   help="devices --calibrate meshes over: the CUDA devices "
                   "(default) or CPU shards")
    p.add_argument("--host-devices", type=int, default=None)
    p.add_argument("--cache", default=None, help="cache file override")
    p.add_argument(
        "--synthetic-calibration", action="store_true",
        help="predict from the documented H100 preview constants instead of "
        "a cached calibration",
    )
    p.add_argument("--m", nargs="+", type=int,
                   default=[256, 1024, 4096, 16384, 65536])
    p.add_argument("--k", nargs="+", type=int, default=None,
                   help="paired with --m positionally (default: square)")
    p.add_argument("--p", nargs="+", type=int, default=[2, 4, 8, 16, 64])
    p.add_argument("--dtype", nargs="+", default=["float32", "bfloat16"])
    p.add_argument("--b", type=int, default=1, help="RHS columns")
    p.add_argument("--out", default=None, help="CSV path (default stdout)")
    return p


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    if args.cache is not None:
        import os

        os.environ["MATVEC_TUNING_CACHE"] = args.cache

    cache = TuningCache.load(args.cache)
    if args.calibrate is not None:
        from ..bench.sweep import platform_devices
        from ..parallel.mesh import make_mesh

        devices = platform_devices(args.platform, args.host_devices)
        if args.shards is not None:
            devices = [devices[0]] * args.shards
        mesh = make_mesh(args.devices or len(devices), devices=devices)
        cal = calibrate(mesh, level=args.calibrate)
        cache.record(calibration_key(mesh.size), cal.to_record())
        path = cache.save()
        print(f"calibration ({cal.level}) saved to {path}")

    if args.synthetic_calibration:
        model: CostModel | None = CostModel(Calibration.synthetic())
    else:
        # Any cached calibration of this platform serves prediction (the
        # constants are the machine's; p generalizes symbolically).
        model = any_model_from_cache(cache)
    if model is None:
        print(
            "no calibration record in the cache — run with --calibrate "
            "full (or --synthetic-calibration for the preview surface)",
            file=sys.stderr,
        )
        return 1

    rows = crossover_surface(
        model, ms=args.m, ks=args.k, ps=args.p, dtypes=args.dtype, b=args.b,
    )
    if args.out:
        write_surface_csv(rows, args.out)
        print(f"wrote {len(rows)} surface rows to {args.out}")
    else:
        import csv

        w = csv.DictWriter(sys.stdout, fieldnames=SURFACE_COLUMNS)
        w.writeheader()
        w.writerows(rows)
    return 0


if __name__ == "__main__":
    sys.exit(main())
