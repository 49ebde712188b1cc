"""Benchmark timing protocol.

Reference analog: the inline loop in each ``main``
(``src/multiplier_rowwise.c:135-151``) and the protocol at ``README.md:41-52``:
100 repetitions; per-rep fences (``MPI_Barrier`` → ``MPI_Wtime`` → work →
``MPI_Barrier`` → ``MPI_Wtime``); per-run time = max across ranks
(``MPI_Reduce(MPI_MAX)``, ``:147``); reported time = mean over reps (``:168``).
The port's counterpart of the JAX package's ``bench/timing.py``.

The fence is ``torch.cuda.synchronize`` on every distinct CUDA device of the
mesh this process computes on (nothing on a CPU mesh, where PyTorch runs
synchronously). Max across ranks is an all-gather of every process's time
(:func:`_max_across_processes`), the identity in a world of one; every time a
control decision reads is reduced first, so all processes run the same
number of programs.

Two timing modes:

* ``amortized`` — operands placed on their devices before the loop
  (``strategy.place``); measures the distributed matvec itself.
* ``reference`` — host→device placement INSIDE the timed region every
  repetition, reproducing the reference's in-loop ``distribute_data``
  (quirk Q5, ``README.md:42-44``).

Measurement methods (``auto`` resolves to ``loop`` for amortized, ``sync``
for reference):

* ``loop`` — the rep loop runs on the device: k dependent reps
  (:func:`_build_looped`), timed as one run, for two rep counts n1 and n2;
  the per-matvec time is the slope, and the spread grows until it beats the
  measured dispatch jitter (:func:`_loop_slope`). On one CUDA device the k
  reps are replays of CUDA graphs captured once per (function, operands):
  a graph of 64 reps, one of 8 and one of 1, so a run of k reps is
  ``k // 64 + (k % 64) // 8 + k % 8`` replays, timed with CUDA events (the
  host enqueues a run faster than the card executes it). On the CPU, on
  a mesh over more than one CUDA device, and on a mesh over several
  processes (a graph cannot capture a gloo exchange; a line on stderr says
  so), the same reps run eagerly through the same body. For kernels under
  a millisecond a host-paced chain times the dispatch, not the kernel: this
  is the JAX package's reason for the loop, and the port's.
* ``chain`` — N1 and N2 back-to-back calls, each chain timed with CUDA
  events on the card (``perf_counter`` on the CPU); the per-matvec time is
  the slope ``(T(N2) - T(N1)) / (N2 - N1)``, the median of the samples.
* ``sync`` — the literal per-rep protocol, reported as the mean.
"""

from __future__ import annotations

import dataclasses
import sys
import time
from typing import Callable

import numpy as np
import torch

from ..models.base import shard_operand
from ..ops.quantize import NATIVE, normalize_storage, quantize_matrix
from ..ops.graphs import capture, single_cuda_device
from ..parallel.mesh import Mesh, ShardedTensor, shard, unshard
from ..utils.constants import DEFAULT_N_REPS, DTYPE_ITEMSIZE
from ..utils.convert import dtype_name, from_numpy, torch_dtype
from ..utils.errors import ConfigError, TimingError

TIMING_MODES = ("amortized", "reference")
MEASURE_METHODS = ("auto", "loop", "chain", "sync")

# Independent chain-slope estimates per config; the reported time is their
# median, which rejects up to two outliers.
DEFAULT_CHAIN_SAMPLES = 5


@dataclasses.dataclass(frozen=True)
class TimingResult:
    """One benchmark measurement (one CSV row)."""

    n_rows: int
    n_cols: int
    n_devices: int
    strategy: str
    dtype: str
    mode: str
    measure: str
    mean_time_s: float
    # 'sync': per-rep max-across-processes times (n_reps entries);
    # 'chain'/'loop': independent slope estimates of the per-matvec time.
    times_s: tuple[float, ...]
    n_reps: int = DEFAULT_N_REPS
    n_rhs: int = 1

    @property
    def gflops(self) -> float:
        """Aggregate GFLOP/s: 2·m·k·n_rhs FLOPs (BASELINE.md formula)."""
        return (
            2.0 * self.n_rows * self.n_cols * self.n_rhs / self.mean_time_s / 1e9
        )

    @property
    def gbps(self) -> float:
        """Effective GB/s: one read of A and x, one write of y."""
        itemsize = DTYPE_ITEMSIZE[self.dtype]
        elems = self.n_rows * self.n_cols + (self.n_rows + self.n_cols) * self.n_rhs
        return itemsize * elems / self.mean_time_s / 1e9


def _max_across_processes(value: float) -> float:
    """The MPI_Reduce(MPI_MAX) analog (src/multiplier_rowwise.c:147): the
    largest of every process's ``value``, on every process (an all-gather,
    as the JAX package's ``process_allgather``). A world of one returns
    ``value``."""
    from ..parallel.distributed import process_count

    world = process_count()
    if world == 1:
        return value
    import torch.distributed as dist

    mine = torch.tensor([value], dtype=torch.float64)
    every = [torch.empty_like(mine) for _ in range(world)]
    dist.all_gather(every, mine)
    return float(torch.cat(every).max())


def _cuda_devices(mesh: Mesh) -> list[torch.device]:
    return [d for d in mesh.distinct_devices() if d.type == "cuda"]


def fence(mesh: Mesh) -> None:
    """Wait for everything enqueued on any of the mesh's devices."""
    for dev in _cuda_devices(mesh):
        torch.cuda.synchronize(dev)


def _sum_squares(out) -> torch.Tensor:
    """``Σ out²`` as a 0-d tensor, squared and summed in at least fp32 (fp64
    stays fp64), in one ``dot`` (a cast first for a 16-bit out). A sharded
    output is gathered first, so replicated blocks count once, as in the
    JAX package's global sum."""
    if isinstance(out, ShardedTensor):
        out = unshard(out)
    flat = out.reshape(-1).to(torch.promote_types(out.dtype, torch.float32))
    return torch.dot(flat, flat)


def _carry_of(rhs):
    """A private copy of the right-hand side the reps thread through, and
    the tensors a bump must update: a tensor is cloned; a placed
    ShardedTensor is gathered into one buffer and cut again, so on a
    one-device mesh its shards are views of that buffer (one update),
    elsewhere each distinct shard this process holds is updated."""
    if not isinstance(rhs, ShardedTensor):
        carry = rhs.clone()
        return carry, [carry]
    buf = unshard(rhs).clone()
    carry = shard(buf, rhs.spec, rhs.mesh)
    local = [s for f, s in enumerate(carry.shards) if rhs.mesh.is_local(f)]
    root = buf.untyped_storage().data_ptr()
    if all(s.untyped_storage().data_ptr() == root for s in local):
        return carry, [buf]
    distinct = {s.data_ptr(): s for s in local}
    return carry, list(distinct.values())


def _rep(fn: Callable, a, carry, roots, eps: torch.Tensor) -> None:
    """One dependent rep: ``out = fn(a, carry)``, then ``carry += eps·Σout²``
    in place (one ``addcmul_`` per root). ``eps`` is a device tensor holding
    0 at run time, so the carry stays bit-identical, yet every rep needs the
    previous one's output and the whole of ``out``."""
    s = _sum_squares(fn(a, carry))
    for root in roots:
        root.addcmul_(eps.to(root.device), s.to(root.device))


def _build_looped(fn: Callable) -> Callable:
    """``chained(a, rhs, k, eps)``: ``k`` dependent reps of ``fn`` eagerly,
    returning the carried right-hand side (the JAX package's
    ``_build_looped``, without the jit).

    The carry threads the right-hand side through every rep with a runtime
    zero bump, ``carry + eps * sum(out * out)``. The bump must be NONLINEAR
    in ``out``: a linear ``sum(out)`` equals ``dot(colsum(A), x)``, which a
    compiler may hoist out of the loop (the JAX package saw fp32 rows at 2x
    the HBM peak from it); ``sum(out**2) = x'A'Ax`` admits no such
    factoring. PyTorch folds nothing, but the port keeps the reference's
    body, so both packages time the same dependent chain."""

    def chained(a, rhs, k, eps):
        carry, roots = _carry_of(rhs)
        for _ in range(int(k)):
            _rep(fn, a, carry, roots, eps)
        return carry

    return chained


# The rep-count graphs of the device loop, largest first: a run of k reps
# replays each as often as k's digits in this base say (at most k // 64 + 14
# replays), every graph captured at first need.
LOOP_GRAPH_REPS = (64, 8, 1)


class _DeviceLoop:
    """The rep loop on one CUDA device: graphs of :data:`LOOP_GRAPH_REPS`
    reps of :func:`_rep`, captured once for these operands, replayed."""

    def __init__(self, fn: Callable, a, rhs, device: torch.device):
        self.device = device
        eps = torch.zeros((), dtype=torch.float32, device=device)
        carry, roots = _carry_of(rhs)
        self._rep = lambda: _rep(fn, a, carry, roots, eps)
        self.graphs: dict[int, object] = {}

    def graph(self, reps: int):
        if reps not in self.graphs:
            # The first capture runs one rep eagerly first (eps = 0 leaves
            # the carry as it was): the kernels' first launches.
            self.graphs[reps], _ = capture(
                lambda: [self._rep() for _ in range(reps)], self.device,
                warm=not self.graphs)
        return self.graphs[reps]

    def run(self, k: int) -> None:
        for reps in LOOP_GRAPH_REPS:
            count, k = divmod(k, reps)
            if count:
                self.graph(reps).replay(count)


# Bounds for the adaptive rep-spread growth in _loop_slope (the JAX
# package's): a slope over a spread whose device time is smaller than the
# dispatch jitter measures noise, so the spread grows until the endpoint
# delta dominates the measured dispatch overhead.
_LOOP_REP_CAP = 1_000_000
_LOOP_MAX_RUN_S = 2.0
_LOOP_TARGET_FLOOR_S = 0.005
_LOOP_JITTER_FACTOR = 3.0


def _min2(run: Callable[[int], float], k: int) -> float:
    """Min of two runs at ``k`` — min filters dispatch-latency spikes. Both
    runs are always taken, so a single spike cannot halt ``_grow_spread``
    at a jitter-dominated spread."""
    return min(run(k), run(k))


def _grow_spread(
    run: Callable[[int], float], n1: int, delta: int, *,
    target_delta_s: float, rep_cap: int = _LOOP_REP_CAP,
    max_run_s: float = _LOOP_MAX_RUN_S,
) -> tuple[int, float, float]:
    """Widen the rep spread until the timing signal beats dispatch jitter.

    Returns ``(delta, t1, t2)``: the chosen spread and the min-of-2
    endpoint times at it. Growth is driven by measured run times: it stops
    when the endpoint delta reaches ``target_delta_s``, a run reaches
    ``max_run_s``, or the spread reaches ``rep_cap``."""
    if delta <= 0:
        raise ConfigError(f"rep spread must be positive, got {delta}")
    t1 = _min2(run, n1)
    while True:
        t2 = _min2(run, n1 + delta)
        if t2 - t1 >= target_delta_s or t2 >= max_run_s or delta >= rep_cap:
            return delta, t1, t2
        delta = min(delta * 4, rep_cap)


def _dispatch_overhead(run: Callable[[int], float]) -> tuple[float, float]:
    """Dispatch+fence overhead from k=1 and k=2 runs: ``(pure, t_k1)``,
    ``pure`` with the one-rep estimate (k=2 − k=1) taken out, and ``t_k1``,
    the conservative estimate callers floor their jitter target at."""
    t_k1 = _min2(run, 1)
    t_k2 = _min2(run, 2)
    return max(0.0, t_k1 - max(0.0, t_k2 - t_k1)), t_k1


def _loop_runner(fn: Callable, a, rhs, mesh: Mesh) -> Callable[[int], float]:
    """``run(k)``: the seconds one run of k dependent reps takes, max-reduced
    across processes at the source. On one CUDA device the reps are graph
    replays between two CUDA events; elsewhere eager reps between two
    fences (host clock)."""
    cuda = _cuda_devices(mesh)
    device = single_cuda_device(mesh.devices)
    if mesh.spans_processes:
        # A captured graph would hold the exchanges' host copies and none
        # of their gloo messages.
        if device is not None:
            print("measure=loop over several processes: eager reps (a CUDA "
                  "graph cannot capture a gloo exchange)", file=sys.stderr)
        device = None
    if device is not None:
        loop = _DeviceLoop(fn, a, rhs, device)

        def run(k: int) -> float:
            with torch.cuda.device(device):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                loop.run(k)
                end.record()
            end.synchronize()
            return _max_across_processes(start.elapsed_time(end) / 1e3)

        return run
    chained = _build_looped(fn)
    eps = torch.zeros((), dtype=torch.float32,
                      device=cuda[0] if cuda else mesh.devices[0])

    def run(k: int) -> float:
        fence(mesh)
        t0 = time.perf_counter()
        chained(a, rhs, k, eps)
        fence(mesh)
        return _max_across_processes(time.perf_counter() - t0)

    return run


def _loop_slope(
    fn: Callable, a_dev, rhs_dev, mesh: Mesh, n1: int, n2: int, samples: int,
    warmup: int = 0,
) -> list[float]:
    """Per-rep time as the slope between device-looped runs of n1 and n2
    reps; the run's fixed overhead cancels in the difference, as in
    :func:`_chain_slope`. The requested spread ``n2 - n1`` is a lower bound,
    widened (``_grow_spread``) until the endpoint difference is at least
    ``_LOOP_JITTER_FACTOR`` x the measured dispatch overhead, floored at the
    one-rep run time and ``_LOOP_TARGET_FLOOR_S``; each endpoint is the min
    of two runs. ``warmup``: extra n1-rep runs after the first."""
    if samples < 1:
        raise ConfigError(f"chain_samples must be >= 1, got {samples}")
    run = _loop_runner(fn, a_dev, rhs_dev, mesh)
    run(1)  # the first run captures the one-rep graph
    t_dispatch, t_k1 = _dispatch_overhead(run)
    for _ in range(max(0, warmup)):
        run(n1)
    target = max(_LOOP_TARGET_FLOOR_S, _LOOP_JITTER_FACTOR * t_dispatch, t_k1)
    delta, t1, t2 = _grow_spread(run, n1, n2 - n1, target_delta_s=target)
    n2 = n1 + delta
    estimates = [(t2 - t1) / delta]
    while len(estimates) < samples:
        t1 = _min2(run, n1)
        t2 = _min2(run, n2)
        estimates.append((t2 - t1) / delta)
    # Individual samples may be negative (visible noise); a non-positive
    # MEDIAN is a failed measurement — raise, never clamp.
    if float(np.median(estimates)) <= 0.0:
        raise TimingError(
            f"device-looped slope not measurable: median of {samples} "
            f"samples at spread {delta} reps is <= 0 against a "
            f"{t_dispatch * 1e3:.1f} ms dispatch overhead — the backend is "
            "too noisy at this spread (growth stops at "
            f"{_LOOP_MAX_RUN_S:.0f} s/run or {_LOOP_REP_CAP} reps); retry "
            "when the backend is quieter"
        )
    return estimates


def time_fn_looped(
    fn: Callable, args: tuple, mesh: Mesh, *, n_reps: int = DEFAULT_N_REPS,
    samples: int = DEFAULT_CHAIN_SAMPLES, warmup: int = 1,
) -> list[float]:
    """Device-looped slope timing of ``fn(a, rhs)`` on device-resident
    ``args = (a, rhs)`` (the ``measure='loop'`` face of
    :func:`time_fn_chained`): ``rhs`` is the carry the reps thread."""
    a_dev, rhs_dev = args
    n1 = max(1, n_reps // 10)
    return _loop_slope(fn, a_dev, rhs_dev, mesh, n1, n1 + n_reps, samples,
                       warmup=warmup)


def _chain_slope(
    run_once: Callable[[], object], mesh: Mesh, n1: int, n2: int, samples: int
) -> list[float]:
    """Per-execution time as the slope between chains of n1 and n2 runs."""
    if samples < 1:
        raise ConfigError(f"chain_samples must be >= 1, got {samples}")
    cuda = _cuda_devices(mesh)

    def chain(n: int) -> float:
        fence(mesh)
        if cuda:
            # Events on the mesh's first device: every combine ends there
            # (gather/psum land on it), so its stream orders after the rest.
            with torch.cuda.device(cuda[0]):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(n):
                    run_once()
                end.record()
            fence(mesh)
            return _max_across_processes(start.elapsed_time(end) / 1e3)
        t0 = time.perf_counter()
        for _ in range(n):
            run_once()
        return _max_across_processes(time.perf_counter() - t0)

    estimates = []
    for _ in range(samples):
        t1 = chain(n1)
        t2 = chain(n2)
        estimates.append((t2 - t1) / (n2 - n1))
    # Individual slopes may be negative (visible noise); a non-positive
    # MEDIAN means the spread carries no signal — raise, never clamp.
    if float(np.median(estimates)) <= 0.0:
        raise TimingError(
            f"chain slope not measurable: median of {samples} samples over "
            f"a {n2 - n1}-rep spread is <= 0"
        )
    return estimates


def time_fn_chained(
    fn: Callable, args: tuple, mesh: Mesh, *, n_reps: int = DEFAULT_N_REPS,
    samples: int = DEFAULT_CHAIN_SAMPLES, warmup: int = 1,
) -> list[float]:
    """Chain-slope timing of any function on device-resident args."""
    for _ in range(1 + max(0, warmup)):
        fn(*args)
    fence(mesh)
    n1 = max(1, n_reps // 10)
    return _chain_slope(lambda: fn(*args), mesh, n1, n1 + n_reps, samples)


def resolve_measure(mode: str, measure: str) -> str:
    """Validate (mode, measure) and resolve 'auto' to a concrete method."""
    if mode not in TIMING_MODES:
        raise ConfigError(f"mode must be one of {TIMING_MODES}, got {mode!r}")
    if measure not in MEASURE_METHODS:
        raise ConfigError(
            f"measure must be one of {MEASURE_METHODS}, got {measure!r}"
        )
    if measure == "auto":
        # Device-looped reps for amortized; the literal per-rep protocol for
        # reference mode, whose point is the transfer.
        measure = "loop" if mode == "amortized" else "sync"
    if mode == "reference" and measure in ("chain", "loop"):
        raise ConfigError(
            f"measure={measure!r} cannot time mode='reference': the per-rep "
            "host->device transfer is the thing being measured and cannot "
            "ride a device-side execution chain; use measure='sync'"
        )
    return measure


def time_matvec(
    fn: Callable,
    a,
    x,
    *,
    place: Callable,
    mesh: Mesh,
    n_reps: int = DEFAULT_N_REPS,
    mode: str = "amortized",
    measure: str = "auto",
    chain_samples: int = DEFAULT_CHAIN_SAMPLES,
) -> list[float]:
    """Run the reference timing protocol around ``fn(a, x)``.

    ``place(a, x)`` returns the placed operands (``strategy.place`` bound to
    the mesh). Returns per-measurement times in seconds: per-rep times for
    ``sync``, slope estimates for ``chain`` and ``loop``.
    """
    measure = resolve_measure(mode, measure)
    if n_reps < 1:
        raise ConfigError(f"n_reps must be >= 1, got {n_reps}")
    a_dev, x_dev = place(a, x)
    if measure == "loop":
        # Warmed and captured inside _loop_slope.
        n1 = max(1, n_reps // 10)
        return _loop_slope(fn, a_dev, x_dev, mesh, n1, n1 + n_reps, chain_samples)
    if measure == "chain":
        return time_fn_chained(fn, (a_dev, x_dev), mesh, n_reps=n_reps,
                               samples=chain_samples, warmup=0)
    fn(a_dev, x_dev)  # warm-up outside the timed region
    fence(mesh)

    times: list[float] = []
    for _ in range(n_reps):
        if mode == "reference":
            # Host->device distribution inside the timed region (quirk Q5);
            # drop the device copies first so placement really transfers.
            del a_dev, x_dev
            fence(mesh)
            start = time.perf_counter()
            a_dev, x_dev = place(a, x)
            fn(a_dev, x_dev)
        else:
            fence(mesh)
            start = time.perf_counter()
            fn(a_dev, x_dev)
        fence(mesh)
        times.append(_max_across_processes(time.perf_counter() - start))
    return times


def _prepare_operands(a, x, dtype: str | None) -> tuple[torch.Tensor, torch.Tensor]:
    """Tensors in the benchmark dtype; numpy arrays land on the host (CPU),
    where reference mode's timed placement starts from."""
    if not isinstance(a, torch.Tensor):
        a = from_numpy(a, "cpu")
    if not isinstance(x, torch.Tensor):
        x = from_numpy(x, "cpu")
    if dtype is not None:
        a, x = a.to(torch_dtype(dtype)), x.to(torch_dtype(dtype))
    return a, x


def benchmark_strategy(
    strategy,
    mesh: Mesh,
    a,
    x,
    *,
    dtype: str | None = None,
    n_reps: int = DEFAULT_N_REPS,
    mode: str = "amortized",
    measure: str = "auto",
    kernel: str | Callable = "cuda",
    gather_output: bool = True,
    chain_samples: int = DEFAULT_CHAIN_SAMPLES,
    combine: str | None = None,
    stages: int | str | None = None,
    dtype_storage: str | None = None,
) -> TimingResult:
    """Benchmark one (strategy, mesh, size) configuration — the body of the
    reference's per-config run (``src/multiplier_rowwise.c:54-176``) minus
    the CSV write (see bench.metrics).

    ``a``/``x`` are numpy arrays (host data) or tensors (which may already
    live on the card, so multi-GB operands never cross the host link).
    Reported time: mean over reps for ``sync``, median of the slope
    samples for ``chain`` and ``loop``. ``combine`` selects the combine schedule by name
    and ``stages`` pins the staged ``overlap`` schedules' stage count (see
    ``MatvecStrategy.build``). ``dtype_storage`` measures the quantized
    residency: A is quantized outside the timed region (:func:`_maybe_quantize`)
    and the strategy runs against the payload. The result's ``gbps`` still
    counts native bytes, so the CSVs stay comparable across formats.
    """
    measure = resolve_measure(mode, measure)
    a, x = _prepare_operands(a, x, dtype)
    strategy.validate(a.shape[0], a.shape[1], mesh)
    fn = strategy.build(mesh, kernel=kernel, gather_output=gather_output,
                        combine=combine, stages=stages,
                        dtype_storage=dtype_storage)
    a = _maybe_quantize(a, dtype_storage, strategy, mesh, mode)
    return _run_benchmark(
        fn, a, x, place=lambda a_, x_: strategy.place(a_, x_, mesh),
        mesh=mesh, strategy_name=strategy.name, n_rhs=1, n_reps=n_reps,
        mode=mode, measure=measure, chain_samples=chain_samples,
    )


def _maybe_quantize(a: torch.Tensor, dtype_storage, strategy, mesh: Mesh, mode: str):
    """Quantize the benchmark operand when a storage format is requested —
    the once-at-residency step, here once per config. Amortized mode
    quantizes on the mesh's first device, where the payload is timed;
    reference mode where A is, so its timed placement moves the payload."""
    if normalize_storage(dtype_storage) == NATIVE:
        return a
    if mode == "amortized":
        a = a.to(mesh.devices[0])
    return quantize_matrix(
        a, dtype_storage, contraction_shards=strategy.contraction_shards(mesh),
    )


def _run_benchmark(
    fn: Callable, a, rhs: torch.Tensor, *, place: Callable,
    mesh: Mesh, strategy_name: str, n_rhs: int, n_reps: int, mode: str,
    measure: str, chain_samples: int,
) -> TimingResult:
    """The protocol around one built function, reduced to one result."""
    times = time_matvec(
        fn, a, rhs, place=place, mesh=mesh, n_reps=n_reps, mode=mode,
        measure=measure, chain_samples=chain_samples,
    )
    reported = np.median(times) if measure in ("chain", "loop") else np.mean(times)
    return TimingResult(
        n_rows=a.shape[0],
        n_cols=a.shape[1],
        n_devices=mesh.size,
        strategy=strategy_name,
        dtype=dtype_name(a.dtype),
        mode=mode,
        measure=measure,
        mean_time_s=float(reported),
        times_s=tuple(times),
        n_reps=n_reps,
        n_rhs=n_rhs,
    )


def benchmark_gemm(
    name: str,
    mesh: Mesh,
    a,
    b,
    *,
    dtype: str | None = None,
    n_reps: int = DEFAULT_N_REPS,
    mode: str = "amortized",
    measure: str = "auto",
    kernel: str | Callable = "cuda",
    gather_output: bool = True,
    chain_samples: int = DEFAULT_CHAIN_SAMPLES,
    combine: str | None = None,
    stages: int | str | None = None,
    dtype_storage: str | None = None,
) -> TimingResult:
    """Benchmark one GEMM (strategy, mesh, size) configuration.

    Same protocol as :func:`benchmark_strategy` with a rank-2 right-hand
    side; the result's strategy is recorded as ``gemm_<name>`` so GEMM rows
    land in their own per-strategy CSVs, and ``n_rhs`` is ``b``'s columns.
    ``combine``, ``stages`` and ``dtype_storage`` follow ``build_gemm`` and
    :func:`benchmark_strategy`.
    """
    from ..models import get_strategy
    from ..models.gemm import build_gemm, gemm_shardings, validate_gemm

    measure = resolve_measure(mode, measure)
    a, b = _prepare_operands(a, b, dtype)
    validate_gemm(name, a.shape[0], a.shape[1], b.shape[1], mesh)
    fn = build_gemm(name, mesh, kernel=kernel, gather_output=gather_output,
                    combine=combine, stages=stages, dtype_storage=dtype_storage)
    spec_a, spec_b = gemm_shardings(name, mesh)
    a = _maybe_quantize(a, dtype_storage, get_strategy(name), mesh, mode)
    return _run_benchmark(
        fn, a, b,
        place=lambda a_, b_: (shard_operand(a_, spec_a, mesh), shard(b_, spec_b, mesh)),
        mesh=mesh, strategy_name=f"gemm_{name}", n_rhs=b.shape[1],
        n_reps=n_reps, mode=mode, measure=measure,
        chain_samples=chain_samples,
    )
