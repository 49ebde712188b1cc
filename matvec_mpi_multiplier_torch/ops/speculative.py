"""Speculative quantized dispatch: the acceptance check on the device.

The port's counterpart of the JAX package's ``ops/speculative.py``. The
compensated int8 resident (``ops/quantize.py``, ``int8c``) streams half the
bytes of an fp32 ``A`` at about 1e-6 normwise error. A caller who declares a
relative tolerance (``MatvecEngine.submit(x, rtol=...)``) may be served from
it, provided a cheap check on the card verifies the candidate against that
tolerance; a miss escalates the request to the native program.

The check is a **sampled-projection residual**. For a candidate
``y_hat ≈ A x`` draw ``s`` fixed Gaussian probes ``U`` (``s x m``, seeded, so
two engines draw the same probes and reach the same verdicts) and hold
``P = U A`` (``s x k``), computed once at residency from the native operand in
float64 and stored in the serving dtype. Per request::

    est = || P x - U y_hat ||_2 / sqrt(s)

an estimate of ``||A x - y_hat||_2`` (each probe row gives
``u_i . r ~ N(0, ||r||^2)``) at ``O(s (k + m))`` operations against the
native ``O(m k)``. ``P`` is cut like ``x`` along the contraction axis, so
``P x`` is a local product on each shard plus one sum of ``s`` scalars over
the contraction shards (rowwise contracts locally and adds none).

The candidate is accepted when ``NOT above_tolerance(est,
convergence_threshold(SPEC_MARGIN * rtol, ||y_hat||))``: the one tolerance
comparison every solver stops on (``solvers/common.py``). With
``SPEC_MARGIN = 1/2`` a wrong answer is served only if the estimate
under-reports ``||r||`` by more than 2x; the chi-square lower tail bounds
that by ``exp(-s * _CHERNOFF_RATE)``, and :func:`probe_count` sizes ``s`` so
the bound is at most ``rtol``.

The candidate (the strategy's int8c program, the hand-written block-scaled
GEMV ``csrc/quant_gemv.cu`` on every shard), the projection, the norms and
the accept predicate are one program (:func:`build_speculative`): on one
card the engine captures it as one CUDA graph, and the predicate stays on
the card until ``result()`` reads it. The check's two small products (``s``
rows) are ``torch.matmul`` in the serving dtype, as they are plain XLA
products in the JAX package; nothing here enables TF32.

:data:`SPEC_SEED`, the clamps, :func:`eligible`, :func:`probe_count`,
:func:`probe_matrix` and :func:`project_probes` on host arrays are the JAX
package's, bitwise. :func:`project_probes` on a CUDA device accumulates in
float64 on the card, in row chunks of ``A``: the host product would need a
float64 copy of ``A`` (34 GB at 65536² fp32).
"""

from __future__ import annotations

import functools
import math
from typing import Callable

import numpy as np
import torch

from ..parallel.mesh import ShardedTensor, psum, unshard
from ..solvers.common import above_tolerance, convergence_threshold, residual_norm
from .quantize import CHUNK_BYTES, INT8C_EPS, normalize_storage

# Fixed probe seed: the sampled projection is a pure function of (seed, s,
# m), so independent engines, and a restarted one, reach the same verdicts.
SPEC_SEED = 0x5BEC

# Acceptance headroom: the estimate must clear half the caller's budget.
SPEC_MARGIN = 0.5

# Eligibility floor: the compensated format's own per-element budget. A
# tolerance below it would escalate almost always, so it rides native.
SPEC_RTOL_FLOOR = INT8C_EPS

# Probe-count clamp: 8 probes bound the check's cost from below, 128 the
# resident P/U footprint from above.
MIN_PROBES = 8
MAX_PROBES = 128

# Chernoff exponent of the chi-square lower tail at eps = SPEC_MARGIN^2:
# (eps - 1 - ln eps) / 2 per probe.
_CHERNOFF_RATE = (SPEC_MARGIN**2 - 1 - 2 * math.log(SPEC_MARGIN)) / 2.0


def eligible(rtol: float | None) -> bool:
    """True when a declared tolerance admits the speculative tier: one is
    declared and it is at least :data:`SPEC_RTOL_FLOOR`."""
    return rtol is not None and float(rtol) >= SPEC_RTOL_FLOOR


def probe_count(rtol: float) -> int:
    """Probes that hold the false-accept probability to at most ``rtol``:
    ``s >= ln(1 / rtol) / _CHERNOFF_RATE``, clamped to [:data:`MIN_PROBES`,
    :data:`MAX_PROBES`]."""
    rtol = float(rtol)
    if not (rtol > 0.0):
        raise ValueError(f"rtol must be > 0, got {rtol}")
    if rtol >= 1.0:
        return MIN_PROBES
    s = math.ceil(math.log(1.0 / rtol) / _CHERNOFF_RATE)
    return max(MIN_PROBES, min(MAX_PROBES, s))


def probe_matrix(n_probes: int, m: int, dtype=np.float32):
    """The seeded ``(s, m)`` Gaussian probe matrix ``U``, independent of A.
    A numpy dtype gives the JAX package's array, bitwise; a torch dtype a
    CPU tensor of the same draws, rounded once from float64."""
    rng = np.random.default_rng(SPEC_SEED)
    draws = rng.standard_normal((int(n_probes), int(m)))
    if isinstance(dtype, torch.dtype):
        return torch.from_numpy(draws).to(dtype)
    return draws.astype(dtype)


def _float64_numpy(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().to("cpu", torch.float64).numpy()  # fp64-ok: the acceptance check's reference P = U A is float64 by design (it measures the quantization error)
    return np.asarray(t, np.float64)


def project_probes(u, a, dtype=None, device=None):
    """``P = U A``, accumulated in float64 off the native operand (the check
    measures the quantization error, so its reference cannot be quantized)
    and stored in ``dtype`` (default: ``a``'s): ``(s, k)``.

    Host arrays give the JAX package's numpy product, bitwise, as does a
    torch ``a`` computed on the CPU (``device`` None or CPU; the result is
    then a CPU tensor). On a CUDA ``device`` the product runs there in
    float64, ``a`` taken in row chunks of :data:`CHUNK_BYTES` as float64
    (``a`` may lie on the host or the card), and P stays on the card."""
    if not isinstance(a, torch.Tensor):
        dtype = np.dtype(dtype if dtype is not None else a.dtype)
        return (np.asarray(u, np.float64) @ np.asarray(a, np.float64)).astype(dtype)
    dtype = a.dtype if dtype is None else dtype
    device = a.device if device is None else torch.device(device)
    if device.type == "cpu":
        p = _float64_numpy(u) @ _float64_numpy(a)
        return torch.from_numpy(p).to(dtype)
    m, k = a.shape
    u64 = torch.as_tensor(u).to(device, torch.float64)  # fp64-ok: float64 reference projection, as above
    acc = torch.zeros((u64.shape[0], k), dtype=torch.float64, device=device)  # fp64-ok: float64 accumulator of the reference projection
    rows = max(1, CHUNK_BYTES // (k * 8))
    for i in range(0, m, rows):
        acc.addmm_(u64[:, i:i + rows], a[i:i + rows].to(device, torch.float64))  # fp64-ok: float64 reference projection, one row chunk at a time
    return acc.to(dtype)


@functools.lru_cache(maxsize=None)
def probe_scale(probes: int, dtype: torch.dtype) -> float:
    """``1 / sqrt(s)`` rounded as the JAX package's check rounds it: the
    square root and the division each in ``dtype``."""
    return float(1.0 / torch.sqrt(torch.tensor(float(probes), dtype=dtype)))


def verdict(px: torch.Tensor, uy: torch.Tensor, y_hat: torch.Tensor,
            rtol: torch.Tensor, probes: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The acceptance check from its two products: ``px = P x`` and ``uy =
    U y_hat`` (``(s,)``, or ``(s, b)`` on the block face), the gathered
    candidate ``y_hat`` and ``rtol`` (a float32 device scalar). Returns
    ``(est_rel, accept)``: the worst estimated relative residual over the
    columns and one device bool, True only when every column passes. A zero
    column (bucket padding) has ``est = 0`` against a threshold of 0 and
    passes. No host read."""
    diff = px - uy
    scale = probe_scale(probes, diff.dtype)
    if y_hat.dim() == 1:
        est = residual_norm(diff) * scale
        y_norm = residual_norm(y_hat)
    else:
        est = torch.sqrt(torch.sum(diff * diff, dim=0)) * scale
        y_norm = torch.sqrt(torch.sum(y_hat * y_hat, dim=0))
    # The JAX check compares in the serving dtype promoted with float32 rtol.
    tdt = torch.promote_types(est.dtype, torch.float32)
    threshold = convergence_threshold((SPEC_MARGIN * rtol).to(tdt), y_norm.to(tdt))
    miss = above_tolerance(est.to(tdt), threshold)
    positive = y_norm > 0
    est_rel = torch.where(positive, est / torch.where(positive, y_norm, torch.ones_like(y_norm)),
                          est).max()
    return est_rel, torch.logical_not(miss.any())


def _sharded_axes(spec) -> tuple[str, ...]:
    """Mesh axis names a placement spec shards over (flattened)."""
    names: list[str] = []
    for entry in tuple(spec):
        if entry is None:
            continue
        names.extend((entry,) if isinstance(entry, str) else tuple(entry))
    return tuple(names)


def probe_spec(strategy, mesh) -> tuple:
    """P's placement: its k axis cut like the request's, so each shard
    contracts its own slab of x."""
    return (None, *tuple(strategy.specs(mesh)[1]))


def build_speculative(
    strategy,
    mesh,
    *,
    probes: int,
    kernel: str | Callable = "cuda",
    combine: str | None = None,
    stages: int | None = None,
    storage: str = "int8c",
    gather_output: bool = True,
    b: int | None = None,
) -> Callable:
    """The fused speculative program of one strategy config:
    ``fn(aq, p, u, x, rtol) -> (y_hat, est_rel, accept)``.

    ``aq`` is the placed quantized resident, ``p`` the projection placed by
    :func:`probe_spec`, ``u`` the probes on the mesh's first device, ``x``
    the placed request (``(k,)``, or ``(k, b)`` when ``b`` is given: the
    engine's bucket-padded block face) and ``rtol`` a float32 scalar on the
    mesh's first device (a new tolerance rebuilds and recaptures nothing).
    ``y_hat`` is what the strategy's ``storage`` program returns;
    ``est_rel`` and ``accept`` come from :func:`verdict` on the gathered
    candidate. Nothing here reads the card from the host."""
    storage = normalize_storage(storage)
    build = strategy.build_batched if b is not None else strategy.build
    inner = build(mesh, kernel=kernel, gather_output=gather_output,
                  combine=combine, stages=stages, dtype_storage=storage)
    axes = _sharded_axes(strategy.specs(mesh)[1])
    dev0 = mesh.devices[0]

    def project_x(p: ShardedTensor, x: ShardedTensor) -> torch.Tensor:
        if not axes:  # rowwise: x and P whole on every shard
            return p.shards[0] @ x.shards[0]
        blocks = [pf @ xf for pf, xf in zip(p.shards, x.shards)]
        return psum(blocks, mesh, axes)[0]

    def spec_fn(aq, p, u, x, rtol):
        y_hat = inner(aq, x)
        y = unshard(y_hat) if isinstance(y_hat, ShardedTensor) else y_hat
        est_rel, accept = verdict(project_x(p, x).to(dev0), u @ y, y, rtol, probes)
        return y_hat, est_rel, accept

    return spec_fn
