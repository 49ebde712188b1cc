"""Host→device link measurement and derived reference-mode timing.

The port's counterpart of the JAX package's ``bench/hostlink.py``. The
reference times its data distribution INSIDE the benchmark loop (quirk Q5:
``README.md:42-44`` requires each repetition to start with data resident
only on the main process; the scatter at ``src/multiplier_rowwise.c:139``
is inside the ``MPI_Wtime`` fences at ``:136-144``). The port's ``reference``
mode times that literally (``bench/timing.py``: ``place(a, x)`` every rep,
a pageable host tensor ``.to(device)``, then a synchronize). This module
measures the same copy once over a growing ladder of sizes, fits
``t(bytes) = α + bytes/β`` and *derives* reference-mode rows from amortized
ones:

    t_reference(size) ≈ t_link(bytes(A) + bytes(x)) + t_amortized(size)

The copy is pageable, not pinned, on purpose: a derived row models the
transfer a literal row measures. Derived rows carry
``mode="reference_derived"`` (their own per-strategy CSV file) and
``measure="derived"``, so they never mix with literal measurements.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Sequence

import numpy as np
import torch

from ..utils.errors import ConfigError
from .timing import TimingResult

# Transfer ladder: 1 MB → 256 MB, ×4 per step. Bounded, increasing (a
# failure mid-ladder loses the big steps, not the measurement), and spanning
# ~2.5 decades for a stable line fit.
DEFAULT_LADDER_BYTES = tuple(2**20 * 4**i for i in range(5))


@dataclasses.dataclass(frozen=True)
class LinkModel:
    """Fitted host→device transfer-time model ``t(bytes) = alpha_s + bytes/bps``."""

    alpha_s: float  # fixed per-transfer latency
    bps: float      # asymptotic bandwidth, bytes/second
    samples: tuple[tuple[int, float], ...]  # (bytes, seconds) raw points

    def transfer_time_s(self, n_bytes: int) -> float:
        return self.alpha_s + n_bytes / self.bps

    @property
    def gbps(self) -> float:
        return self.bps / 1e9


def _link_device(device) -> torch.device:
    """The device the link ends at: ``cuda:0`` unless the caller names one."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise ConfigError(
            "measure_link() times the host-to-card copy and found no CUDA "
            "device; pass device='cpu' for a CPU run"
        )
    return torch.device("cuda", 0)


def measure_link(
    ladder: Sequence[int] = DEFAULT_LADDER_BYTES,
    *,
    reps: int = 3,
    device=None,
) -> LinkModel:
    """Measure host→device placement time over a size ladder; fit (α, β).

    Each rep copies a pageable host tensor to ``device`` (``cuda:0`` by
    default) and synchronizes, the copy the ``reference`` mode times per
    rep; on the CPU a real copy too. ``reps`` per size, minimum kept (the
    transfer floor; interference only adds time).
    """
    ladder = [int(b) for b in ladder]
    if not ladder or any(b < 4 for b in ladder):
        raise ConfigError(
            f"measurement ladder must hold sizes >= 4 bytes, got {ladder}"
        )
    if reps < 1:
        raise ConfigError(f"reps must be >= 1, got {reps}")
    dev = _link_device(device)

    def fence() -> None:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    points: list[tuple[int, float]] = []
    for n_bytes in ladder:
        host = torch.empty(n_bytes // 4, dtype=torch.float32)
        host.fill_(1.0)
        best = np.inf
        for _ in range(reps):
            fence()
            start = time.perf_counter()
            arr = host.to(dev, copy=True)
            fence()
            best = min(best, time.perf_counter() - start)
            del arr
        points.append((n_bytes, float(best)))

    xs = np.array([p[0] for p in points], np.float64)
    ys = np.array([p[1] for p in points], np.float64)
    if len(points) < 2:
        # One size cannot separate latency from bandwidth: attribute the
        # whole time to bandwidth (a conservative per-transfer estimate).
        slope, alpha = float(ys[0] / xs[0]), 0.0
    else:
        # Least-squares line, weighted by 1/bytes so the small-transfer
        # points pin alpha while the big ones pin the bandwidth slope.
        w = 1.0 / xs
        coeffs = np.polyfit(xs, ys, 1, w=np.sqrt(w))
        slope, alpha = float(coeffs[0]), float(coeffs[1])
    slope = max(slope, 1e-15)  # degenerate fit guard (instant transfers)
    return LinkModel(
        alpha_s=max(alpha, 0.0), bps=1.0 / slope, samples=tuple(points)
    )


def operand_bytes(result: TimingResult) -> int:
    """Bytes re-distributed per repetition in reference mode: A plus the
    right-hand side (x, or B for GEMM), the reference's in-loop
    scatter+bcast payload (``src/multiplier_rowwise.c:16-47``)."""
    itemsize = 2 if result.dtype == "bfloat16" else np.dtype(result.dtype).itemsize
    return itemsize * (
        result.n_rows * result.n_cols + result.n_cols * result.n_rhs
    )


def derive_reference_result(
    amortized: TimingResult, link: LinkModel
) -> TimingResult:
    """Synthesize a reference-mode row from an amortized one and the link
    model: the modeled host→device distribution of A and x plus the
    measured amortized time, as ``mode="reference_derived"``,
    ``measure="derived"`` (its own ``<strategy>_reference_derived.csv``)."""
    if amortized.mode != "amortized":
        raise ValueError(
            f"derive_reference_result needs an amortized input, got "
            f"mode={amortized.mode!r}"
        )
    t = link.transfer_time_s(operand_bytes(amortized)) + amortized.mean_time_s
    return dataclasses.replace(
        amortized,
        mode="reference_derived",
        measure="derived",
        mean_time_s=t,
        times_s=(t,),
    )
