"""Fused solver step: one CG/Chebyshev iteration per shard in one C call.

The port's counterpart of the JAX package's ``ops/pallas_solver.py``. The
served solvers (``solvers/ops.py``) run each iteration as separate
operations: the local GEMV, the combine, two axpys and two dot-reductions.
This module is the fused tier: the whole fixed-recurrence iteration — the
vector updates, the residual reduction and the next local GEMV — is one
call of the hand-written ``csrc/solver_step.cu`` per shard, which enqueues
an update kernel and a row GEMV back to back. The source says why two
launches cost nothing here that one fused launch would save.

The loop is the JAX package's rotation: the carry holds the combined
``ap = A@p`` of the previous step, so each step applies the pending
update and then multiplies the fresh ``p`` by the local shard; the
partial leaves the step uncombined and meets the iteration's single
combine — ``psum`` for colwise shards, a gather for rowwise. A prologue
matvec seeds ``ap``; the exit is verified by a TRUE residual after the
loop. As in ``solvers/ops.py`` the loop runs on the device in masked chunks
where they are captured (one card, native storage: one read per chunk, each
chunk a CUDA graph), host-stepped elsewhere (one predicate read per
iteration).

:func:`solver_step_cuda` launches the kernels for CUDA tensors, or raises:
a missing ``nvcc``, a failed build or a refused launch is an error, never a
quiet switch to another tier. For CPU tensors, and only there, it computes
:func:`solver_step_plain`. ``solver_step_cuda.launches`` counts step calls
(each is two kernel launches, three on a quantized shard's tensor-core
route or a native shard's split GEMV); nothing else adds to it. ``solver_step_cuda.quant_route_launches``
counts the quantized shards' steps by the route their GEMV took
(``ops/cuda_quant.py::quant_route``), ``solver_step_cuda.gemv_route_launches``
the native shards' steps by theirs (``ops/cuda_gemv.py::gemv_plan``).
"""

from __future__ import annotations

from collections import Counter
from typing import Callable

import torch

from ..models.base import MatvecStrategy
from ..parallel.mesh import Mesh, ShardedTensor, kernel_entered, psum, unshard
from ..solvers.common import (
    SolverResult,
    convergence_threshold,
    diverged,
    keep_iterating,
    residual_norm,
)
from ..obs.annotations import profiler_span
from ..solvers.device_loop import LOOP_SPAN, ChunkedLoop, commit, host_read, when
from ..solvers.ops import DeviceLoops, f32_scalar, placed_operand, solver_loop
from ..utils.errors import ConfigError, ShardingError
from . import _build
from .cuda_gemv import (
    _DTYPE_CODES,
    gemv_plain,
    gemv_plan,
    plan_codes,
    plan_scratch,
    sm_count,
)
from .cuda_quant import (
    _FORMAT_CODES,
    ROUTE_CODES,
    payload_aligned,
    quant_gemv_plain,
    quant_route,
    route_scratch,
)
from .gemv import acc_dtype, get_kernel
from .graphs import predicate_ptr, single_cuda_device
from .quantize import NATIVE, QuantizedMatrix, get_storage_kernel, normalize_storage

# The fixed-recurrence ops the fused tier serves. GMRES's Arnoldi and
# Lanczos's reorthogonalization need the whole basis in the body; power's
# body is already one matvec plus O(n) vector work.
FUSED_SOLVER_OPS: tuple[str, ...] = ("cg", "chebyshev")

# strategy name -> the combine the fused body owns: one psum for colwise
# shards, one gather for rowwise. Only that request (or the defaults
# None/"auto", which defer) validates.
_FUSED_COMBINES: dict[str, str] = {"rowwise": "gather", "colwise": "psum"}

# The C entry's op codes (csrc/solver_step.cu::matvec_solver_step); the
# format code of native storage is -1.
_OP_CODES = {"cg": 0, "chebyshev": 1}
_NATIVE_FORMAT = -1


def fused_solver_supported(
    op: str, strategy_name: str, combine: str | None, mesh: Mesh
) -> bool:
    """True when the fused tier can serve (op, strategy, combine) on this
    mesh — the ``kernel="auto"`` gate."""
    try:
        check_fused_solver(op, strategy_name, combine, mesh)
        return True
    except (ConfigError, ShardingError):
        return False


def check_fused_solver(
    op: str, strategy_name: str, combine: str | None, mesh: Mesh
) -> str:
    """Validate a fused-tier request; return the resolved combine label.

    Raises :class:`ConfigError` for an op outside the fixed-recurrence pair
    and :class:`ShardingError` for a strategy/combine pair the fused body
    cannot spell, with the JAX package's messages (tier names mapped)."""
    if op not in FUSED_SOLVER_OPS:
        raise ConfigError(
            f"kernel='cuda_fused' serves the fixed-recurrence ops "
            f"{FUSED_SOLVER_OPS}; got op={op!r}. Use kernel='torch' (or "
            f"'auto', which falls back) for the basis-building ops."
        )
    canonical = _FUSED_COMBINES.get(strategy_name)
    if canonical is None:
        raise ShardingError(
            f"kernel='cuda_fused' supports the flat-axis "
            f"{tuple(_FUSED_COMBINES)} strategies; got strategy="
            f"{strategy_name!r} (blockwise's 2-D shards split the "
            f"direction vector across both mesh axes — no single-kernel "
            f"spelling exists)."
        )
    if combine not in (None, "auto", canonical):
        raise ShardingError(
            f"kernel='cuda_fused' owns the solve body's combine — "
            f"{strategy_name} runs exactly one {canonical!r} hop per "
            f"iteration; combine={combine!r} has no fused spelling. "
            f"Request combine=None/'auto'/{canonical!r} or kernel='torch'."
        )
    return canonical


# ------------------------------------------------------------ the step


def solver_step_plain(op, a_local, off, x, r, p, ap, s_in):
    """The step in plain PyTorch: ``(x2, r2, p2, s_out, partial)``.

    ``x, r, p, ap`` are ``(n,)`` in the accumulator dtype; ``s_in`` is
    ``[rz]`` for cg and ``[alpha, k, d, c²]`` for chebyshev. The rotated
    update (the JAX package's ``_write_update``):

    * cg: ``α = pᵀap > 0 ? rz/pᵀap : 0``, ``x2 = x + αp``, ``r2 = r − α·ap``,
      ``rz2 = Σ r2²``, ``β = pᵀap > 0 ? rz2/(rz ≠ 0 ? rz : 1) : 0``,
      ``p2 = r2 + βp``, ``s_out = [rz2]``;
    * chebyshev: ``x2``, ``r2`` as above with the given α,
      ``factor = (k = 0 ? ½ : ¼)·c²·α``, ``p2 = r2 + factor·α·p``,
      ``s_out = [1/(d − factor), Σ r2²]``;

    then ``partial = A_local · p2[off : off + k_loc]`` with ``p2`` in the
    accumulator dtype (the fused kernel reads it so, where the unfused
    tier casts ``p`` to A's dtype first), or ``deq(A_local) · p2[...]`` for
    a quantized shard."""
    if op == "cg":
        rz = s_in[0]
        pap = torch.sum(p * ap)
        safe = pap > 0
        alpha = torch.where(safe, rz / torch.where(safe, pap, 1.0), 0.0)
        x2 = x + alpha * p
        r2 = r - alpha * ap
        rz2 = torch.sum(r2 * r2)
        beta = torch.where(safe, rz2 / torch.where(rz != 0, rz, 1.0), 0.0)
        p2 = r2 + beta * p
        s_out = rz2.reshape(1)
    else:
        alpha, kf, d, c2 = s_in[0], s_in[1], s_in[2], s_in[3]
        x2 = x + alpha * p
        r2 = r - alpha * ap
        # Saad Alg. 12.1 with the β/α division folded away, rotated one
        # step: this applies step k's α and builds direction k+1.
        factor = torch.where(kf == 0, 0.5, 0.25).to(x.dtype) * c2 * alpha
        alpha_next = 1.0 / (d - factor)
        beta = factor * alpha
        p2 = r2 + beta * p
        s_out = torch.stack((alpha_next, torch.sum(r2 * r2)))
    seg = p2[off:off + a_local.shape[1]]
    if isinstance(a_local, QuantizedMatrix):
        partial = quant_gemv_plain(a_local, seg)
    else:
        partial = gemv_plain(a_local, seg)
    return x2, r2, p2, s_out, partial


def _check(op, a_local, off, x, r, p, ap, s_in) -> None:
    if op not in FUSED_SOLVER_OPS:
        raise ValueError(f"solver_step serves {FUSED_SOLVER_OPS}, got op={op!r}")
    quant = isinstance(a_local, QuantizedMatrix)
    if quant:
        if a_local.fmt not in _FORMAT_CODES or (
                (a_local.fmt == "int8c") != (a_local.q2 is not None)):
            raise ValueError(f"solver_step takes int8, int8c or fp8 storage, got {a_local.fmt!r}")
        leaves = [leaf for leaf in a_local.leaves if leaf is not None]
    else:
        leaves = [a_local]
    if len(a_local.shape) != 2 or a_local.dtype not in _DTYPE_CODES:
        raise ValueError(
            f"solver_step needs a 2-D A (or payload) of logical dtype "
            f"bf16/fp16/fp32/fp64, got {tuple(a_local.shape)} {a_local.dtype}"
        )
    m_loc, k_loc = a_local.shape
    acc = acc_dtype(a_local.dtype)
    n = x.shape[0]
    vectors = (x, r, p, ap)
    if any(v.dim() != 1 or v.shape[0] != n for v in vectors):
        raise ValueError(
            f"solver_step needs x, r, p, ap of one shape (n,), got "
            f"{[tuple(v.shape) for v in vectors]}"
        )
    width = 1 if op == "cg" else 4
    if tuple(s_in.shape) != (width,):
        raise ValueError(f"{op} takes s_in of shape ({width},), got {tuple(s_in.shape)}")
    if any(t.dtype != acc for t in (*vectors, s_in)):
        raise ValueError(
            f"solver_step needs x, r, p, ap and s_in in the accumulator dtype "
            f"{acc} of a {a_local.dtype} A"
        )
    if not (0 <= off and off + k_loc <= n and m_loc > 0 and k_loc > 0):
        raise ValueError(
            f"the ({m_loc}, {k_loc}) shard at column offset {off} does not fit "
            f"vectors of length {n}"
        )
    if quant and (k_loc % a_local.block
                  or tuple(a_local.scales.shape) != (m_loc, k_loc // a_local.block)):
        raise ValueError(
            f"scales {tuple(a_local.scales.shape)} do not match a ({m_loc}, {k_loc}) "
            f"payload in blocks of {a_local.block}"
        )
    tensors = (*leaves, *vectors, s_in)
    if any(t.device != x.device for t in tensors):
        raise ValueError("solver_step needs A, the vectors and s_in on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("solver_step needs contiguous A, vectors and s_in")


def solver_step_cuda(op, a_local, off, x, r, p, ap, s_in):
    """One fused step by ``csrc/solver_step.cu`` (the plain version for CPU
    tensors): the update kernel, then the row GEMV of the shard against
    ``p2[off : off + k_loc]``, both on the current stream. Under a recorder
    that stands the kernels in it returns zeros of the outputs' shapes."""
    if kernel_entered("solver_step", a_local, x):
        return (torch.zeros_like(x), torch.zeros_like(r), torch.zeros_like(p),
                torch.zeros(1 if op == "cg" else 2, dtype=x.dtype, device=x.device),
                torch.zeros(a_local.shape[0], dtype=x.dtype, device=x.device))
    _check(op, a_local, off, x, r, p, ap, s_in)
    if x.device.type == "cpu":
        return solver_step_plain(op, a_local, off, x, r, p, ap, s_in)
    lib = _build.load_library()
    if x.device.type != "cuda":
        raise ValueError(f"solver_step_cuda runs on CUDA or CPU tensors, got {x.device}")
    m_loc, k_loc = a_local.shape
    x2, r2, p2 = torch.empty_like(x), torch.empty_like(r), torch.empty_like(p)
    s_out = torch.empty(1 if op == "cg" else 2, dtype=x.dtype, device=x.device)
    partial = torch.empty(m_loc, dtype=x.dtype, device=x.device)
    route, xs, gplan, gscratch = None, None, None, None
    if isinstance(a_local, QuantizedMatrix):
        fmt, block = _FORMAT_CODES[a_local.fmt], a_local.block
        leaves = [None if leaf is None else leaf.data_ptr() for leaf in a_local.leaves]
        # The GEMV's x is p2's segment in the accumulator dtype.
        route = quant_route(a_local.fmt, x.dtype, m_loc, k_loc, 1, block,
                            payload_aligned(a_local))
        xs = route_scratch(route, k_loc, 1, x.device)
    else:
        fmt, block = _NATIVE_FORMAT, 0
        leaves = [a_local.data_ptr(), None, None, None]
        # The GEMV's x is p2's segment in the accumulator dtype.
        gplan = gemv_plan(m_loc, k_loc, a_local.dtype, x.dtype, sm_count(x.device))
        gscratch = plan_scratch(gplan, a_local.dtype, x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.matvec_solver_step(
            _OP_CODES[op], fmt, _DTYPE_CODES[a_local.dtype], *leaves, block,
            ROUTE_CODES[route] if route else 0, None if xs is None else xs.data_ptr(),
            None if gplan is None else plan_codes(gplan),
            None if gscratch is None else gscratch.data_ptr(),
            x.data_ptr(), r.data_ptr(), p.data_ptr(), ap.data_ptr(), s_in.data_ptr(),
            x2.data_ptr(), r2.data_ptr(), p2.data_ptr(), s_out.data_ptr(),
            partial.data_ptr(), x.shape[0], m_loc, k_loc, off, stream,
            predicate_ptr(x.device),
        )
    if rc != 0:
        raise RuntimeError(
            f"solver_step kernel launch failed for {op} on a "
            f"{getattr(a_local, 'fmt', 'native')} ({m_loc}, {k_loc}) shard at offset "
            f"{off}, n={x.shape[0]}: {lib.matvec_error_string(rc).decode()} "
            f"(cudaError {rc})"
        )
    solver_step_cuda.launches += 1
    if route:
        solver_step_cuda.quant_route_launches[route] += 1
    else:
        solver_step_cuda.gemv_route_launches[gplan.route] += 1
    return x2, r2, p2, s_out, partial


solver_step_cuda.launches = 0  # type: ignore[attr-defined]
solver_step_cuda.quant_route_launches = Counter()  # type: ignore[attr-defined]
solver_step_cuda.gemv_route_launches = Counter()  # type: ignore[attr-defined]


# ------------------------------------------------------------ the loop


def build_fused_solver(
    op: str,
    strategy: MatvecStrategy,
    mesh: Mesh,
    *,
    dtype: torch.dtype,
    combine: str | None = None,
    dtype_storage=None,
) -> Callable[..., SolverResult]:
    """The fused tier's counterpart of ``solvers.ops.build_solver``: the same
    signature ``fn(a, b, rtol, maxiter, p0, p1)`` and SolverResult contract.

    Each shard keeps its own copy of the replicated vectors on its device
    and runs one :func:`solver_step_cuda` per iteration (p shards: p step
    calls); the partials meet the iteration's one combine. The prologue and
    the verification matvecs are the unfused local GEMV (``gemv_cuda`` /
    ``quant_gemv_cuda`` on ``p`` cast to A's dtype), as in the JAX package.

    On one CUDA device with native storage the iterations run in masked
    chunks on the device (``solvers/device_loop.py``; the steps of an
    inactive iteration take a launch predicate of False). Quantized storage
    runs host-stepped: the step's quantized GEMV takes no predicate. Both
    loops give the same iterate bitwise."""
    return _build_fused_solver(op, strategy, mesh, None, dtype=dtype, combine=combine,
                               dtype_storage=dtype_storage)


def _build_fused_solver(
    op: str,
    strategy: MatvecStrategy,
    mesh: Mesh,
    loop: str | None,
    *,
    dtype: torch.dtype,
    combine: str | None = None,
    dtype_storage=None,
) -> Callable[..., SolverResult]:
    """:func:`build_fused_solver` with the loop named by the caller
    (``solvers/ops.py::solver_loop``)."""
    combine_r = check_fused_solver(op, strategy.name, combine, mesh)
    storage = normalize_storage(dtype_storage)
    loop = solver_loop(loop, op, mesh, predicated=storage == NATIVE)
    acc = acc_dtype(dtype)
    kern = get_kernel("cuda") if storage == NATIVE else get_storage_kernel("cuda")
    colwise = strategy.name == "colwise"
    spec_y = strategy.specs(mesh)[2]
    devices = mesh.devices
    dev0 = devices[0]

    def keep(rr, k, cap, threshold, b_rr):
        """The loop's continuation predicate (a device bool)."""
        ok = keep_iterating(torch.sqrt(rr), threshold, k, cap)
        if op == "chebyshev":
            # Early divergence exit (solvers/common.py).
            ok = ok & ~diverged(rr, b_rr)
        return ok

    states = DeviceLoops(lambda step: _FusedState(
        step, keep, acc, devices, op, single_cuda_device(devices)))

    def fn(a, b, rtol, maxiter, p0, p1):
        placed = placed_operand(strategy, mesh, a)
        shards = placed.shards
        k_loc = shards[0].shape[1]
        offs = [f * k_loc if colwise else 0 for f in range(mesh.size)]

        def combine_parts(parts):
            """The iteration's one hop: every shard gets the combined vector."""
            if combine_r == "psum":
                return psum(parts, mesh, mesh.axis_names)
            full = unshard(ShardedTensor(tuple(parts), (b.shape[0],), spec_y, mesh))
            return [full.to(dev) for dev in devices]

        def full_mv(vs):
            # The unfused local partials (prologue and verification).
            return combine_parts([
                kern(shards[f], vs[f][offs[f]:offs[f] + k_loc].to(dtype)).to(acc)
                for f in range(mesh.size)
            ])

        def per_shard(t):
            return [t.to(dev) for dev in devices]

        def step(xs, rs, ps, aps, scal, dc2, k):
            """One iteration's p step calls and its one combine."""
            outs = []
            for f in range(mesh.size):
                if op == "cg":
                    s_in = scal[f]
                else:
                    kf = (torch.full((1,), k, dtype=acc, device=devices[f])
                          if isinstance(k, int) else k.to(device=devices[f], dtype=acc)
                          .reshape(1))
                    s_in = torch.cat((scal[f][:1], kf, dc2[f]))
                outs.append(solver_step_cuda(
                    op, shards[f], offs[f], xs[f], rs[f], ps[f], aps[f], s_in))
            xs, rs, ps, scal, parts = (list(col) for col in zip(*outs))
            return xs, rs, ps, scal, combine_parts(parts)  # the ONE combine

        b_acc = b.to(device=dev0, dtype=acc)
        b_rr = torch.sum(b_acc * b_acc)
        threshold = convergence_threshold(f32_scalar(rtol, acc, dev0), torch.sqrt(b_rr))
        bs = per_shard(b_acc)
        aps = full_mv(bs)  # prologue matvec seeds the rotation
        if op == "cg":
            scal = per_shard(b_rr.reshape(1))
            dc2 = None
        else:
            lmin = f32_scalar(p0, acc, dev0)
            lmax = f32_scalar(p1, acc, dev0)
            d = (lmax + lmin) / 2
            c2 = ((lmax - lmin) / 2) ** 2
            scal = per_shard((1.0 / d).reshape(1))  # alpha of step 0
            dc2 = per_shard(torch.stack((d, c2)))

        if loop == "host":
            xs = [torch.zeros_like(v) for v in bs]
            rs, ps = bs, bs
            rr, k = b_rr, 0
            with profiler_span(LOOP_SPAN):
                while True:
                    with host_read():
                        go = bool(keep(rr, k, maxiter, threshold, b_rr))
                    if not go:
                        break
                    xs, rs, ps, scal, aps = step(xs, rs, ps, aps, scal, dc2, k)
                    rr = scal[0][0] if op == "cg" else scal[0][1]
                    k += 1
            x_out = xs
        else:
            state = states.get(placed, b_acc, step)
            k = state.solve(threshold, b_rr, bs, aps, scal, dc2, maxiter)
            x_out = [x.clone() for x in state.xs]
        # Verified exit: the TRUE residual of the returned iterate.
        rnorm = residual_norm(b_acc - full_mv(x_out)[0])
        return SolverResult(
            x=x_out[0],
            value=torch.full((), float("nan"), dtype=acc, device=dev0),
            n_iters=torch.tensor(k, dtype=torch.int32),
            residual_norm=rnorm,
            converged=rnorm <= threshold,
        )

    fn.loop = loop
    fn.device_loops = states
    return fn


class _FusedState:
    """The fused loop's state in fixed tensors on the device, one set per
    resident operand, and its masked iteration (``solvers/device_loop.py``):
    the steps run through :func:`when` on the device flag, so under capture
    they take it as their launch predicate."""

    def __init__(self, step, keep, acc, devices, op, device: torch.device | None):
        self._step, self._keep, self.op = step, keep, op
        self.acc, self.devices = acc, devices
        self._device = device
        self.loop = None

    def _alloc(self, n: int) -> None:
        acc, devices, op = self.acc, self.devices, self.op
        dev0 = devices[0]
        self.xs, self.rs, self.ps, self.aps = (
            [torch.zeros(n, dtype=acc, device=dev) for dev in devices] for _ in range(4))
        width = 1 if op == "cg" else 2
        self.scal = [torch.zeros(width, dtype=acc, device=dev) for dev in devices]
        self.dc2 = None if op == "cg" else [
            torch.zeros(2, dtype=acc, device=dev) for dev in devices]
        self.threshold, self.b_rr, self.rr = (
            torch.zeros((), dtype=acc, device=dev0) for _ in range(3))
        self.k, self.maxiter = (torch.zeros((), dtype=torch.int64, device=dev0)
                                for _ in range(2))
        self.go = torch.zeros((), dtype=torch.bool, device=dev0)
        self.loop = ChunkedLoop(self.iteration, self.go, self.k, self._device)

    def iteration(self) -> None:
        go, k = self.go, self.k
        old = (self.xs, self.rs, self.ps, self.scal, self.aps)
        new = when(go, lambda: self._step(*old[:3], self.aps, self.scal, self.dc2, k),
                   lambda: old)
        rr = new[3][0][0] if self.op == "cg" else new[3][0][1]
        k_new = k + 1
        go_new = self._keep(rr, k_new, self.maxiter, self.threshold, self.b_rr)
        for olds, news in zip(old, new):
            for o, n_ in zip(olds, news):
                commit(go.to(o.device), ((o, n_),))
        commit(go, ((self.rr, rr), (self.k, k_new)))
        torch.logical_and(go, go_new, out=go)

    def solve(self, threshold, b_rr, bs, aps, scal, dc2, maxiter) -> int:
        """Load one solve's start into the state and run the loop; return
        the iteration count."""
        if self.loop is None:
            self._alloc(bs[0].shape[0])
        self.threshold.copy_(threshold)
        self.b_rr.copy_(b_rr)
        for f, b in enumerate(bs):
            self.xs[f].zero_()
            self.rs[f].copy_(b)
            self.ps[f].copy_(b)
            self.aps[f].copy_(aps[f])
            # chebyshev's step returns [alpha, rr]: the width-2 slot's first
            # entry is what the next step reads.
            self.scal[f][:scal[f].shape[0]].copy_(scal[f])
            if dc2 is not None:
                self.dc2[f].copy_(dc2[f])
        self.rr.copy_(b_rr)
        self.k.zero_()
        self.maxiter.fill_(maxiter)
        self.go.copy_(self._keep(self.rr, self.k, self.maxiter, self.threshold, self.b_rr))
        return self.loop.run()
