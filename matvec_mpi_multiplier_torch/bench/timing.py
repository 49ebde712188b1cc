"""Benchmark timing protocol.

Reference analog: the inline loop in each ``main``
(``src/multiplier_rowwise.c:135-151``) and the protocol at ``README.md:41-52``:
100 repetitions; per-rep fences (``MPI_Barrier`` → ``MPI_Wtime`` → work →
``MPI_Barrier`` → ``MPI_Wtime``); per-run time = max across ranks
(``MPI_Reduce(MPI_MAX)``, ``:147``); reported time = mean over reps (``:168``).
The port's counterpart of the JAX package's ``bench/timing.py``.

The fence is ``torch.cuda.synchronize`` on every distinct CUDA device of the
mesh (nothing on a CPU mesh, where PyTorch runs synchronously). Max across
ranks is the identity: the port's mesh is one process.

Two timing modes:

* ``amortized`` — operands placed on their devices before the loop
  (``strategy.place``); measures the distributed matvec itself.
* ``reference`` — host→device placement INSIDE the timed region every
  repetition, reproducing the reference's in-loop ``distribute_data``
  (quirk Q5, ``README.md:42-44``).

Measurement methods (``auto`` resolves to ``chain`` for amortized, ``sync``
for reference):

* ``chain`` — N1 and N2 back-to-back calls, each chain timed with CUDA
  events on the card (``perf_counter`` on the CPU); the per-matvec time is
  the slope ``(T(N2) - T(N1)) / (N2 - N1)``, the median of the samples.
* ``sync`` — the literal per-rep protocol, reported as the mean.
* ``loop`` — a device-side rep loop; on CUDA that is a captured graph, which
  comes with the CUDA-graph slice. Asking for it raises ``ConfigError``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np
import torch

from ..models.base import shard_operand
from ..ops.quantize import NATIVE, normalize_storage, quantize_matrix
from ..parallel.mesh import Mesh, shard
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
    # 'chain': independent slope estimates of the per-matvec time.
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
    identity, since the port's single-controller mesh is one process."""
    return value


def _cuda_devices(mesh: Mesh) -> list[torch.device]:
    return [d for d in mesh.distinct_devices() if d.type == "cuda"]


def fence(mesh: Mesh) -> None:
    """Wait for everything enqueued on any of the mesh's devices."""
    for dev in _cuda_devices(mesh):
        torch.cuda.synchronize(dev)


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
    if measure == "loop":
        raise ConfigError(
            "measure='loop' needs a device-side rep loop, which on CUDA is a "
            "captured CUDA graph; it comes with the CUDA-graph slice of the "
            "port (ROADMAP.md, queue A 3b). Use measure='chain' or 'sync'"
        )
    if measure == "auto":
        measure = "chain" if mode == "amortized" else "sync"
    if mode == "reference" and measure == "chain":
        raise ConfigError(
            "measure='chain' cannot time mode='reference': the per-rep "
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
    ``sync``, slope estimates for ``chain``.
    """
    measure = resolve_measure(mode, measure)
    if n_reps < 1:
        raise ConfigError(f"n_reps must be >= 1, got {n_reps}")
    a_dev, x_dev = place(a, x)
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
    dtype_storage: str | None = None,
) -> TimingResult:
    """Benchmark one (strategy, mesh, size) configuration — the body of the
    reference's per-config run (``src/multiplier_rowwise.c:54-176``) minus
    the CSV write (see bench.metrics).

    ``a``/``x`` are numpy arrays (host data) or tensors (which may already
    live on the card, so multi-GB operands never cross the host link).
    Reported time: mean over reps for ``sync``, median of the slope
    samples for ``chain``. ``dtype_storage`` measures the quantized
    residency: A is quantized outside the timed region (:func:`_maybe_quantize`)
    and the strategy runs against the payload. The result's ``gbps`` still
    counts native bytes, so the CSVs stay comparable across formats.
    """
    measure = resolve_measure(mode, measure)
    a, x = _prepare_operands(a, x, dtype)
    strategy.validate(a.shape[0], a.shape[1], mesh)
    fn = strategy.build(mesh, kernel=kernel, gather_output=gather_output,
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
    reported = np.median(times) if measure == "chain" else np.mean(times)
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
    dtype_storage: str | None = None,
) -> TimingResult:
    """Benchmark one GEMM (strategy, mesh, size) configuration.

    Same protocol as :func:`benchmark_strategy` with a rank-2 right-hand
    side; the result's strategy is recorded as ``gemm_<name>`` so GEMM rows
    land in their own per-strategy CSVs, and ``n_rhs`` is ``b``'s columns.
    ``dtype_storage`` follows :func:`benchmark_strategy`.
    """
    from ..models import get_strategy
    from ..models.gemm import build_gemm, gemm_shardings, validate_gemm

    measure = resolve_measure(mode, measure)
    a, b = _prepare_operands(a, b, dtype)
    validate_gemm(name, a.shape[0], a.shape[1], b.shape[1], mesh)
    fn = build_gemm(name, mesh, kernel=kernel, gather_output=gather_output,
                    dtype_storage=dtype_storage)
    spec_a, spec_b = gemm_shardings(name, mesh)
    a = _maybe_quantize(a, dtype_storage, get_strategy(name), mesh, mode)
    return _run_benchmark(
        fn, a, b,
        place=lambda a_, b_: (shard_operand(a_, spec_a, mesh), shard(b_, spec_b, mesh)),
        mesh=mesh, strategy_name=f"gemm_{name}", n_rhs=b.shape[1],
        n_reps=n_reps, mode=mode, measure=measure,
        chain_samples=chain_samples,
    )
