"""Executable cache: build once, dispatch forever.

The port's counterpart of the JAX package's ``engine/executables.py``.
PyTorch runs eagerly, so there is no lowering to compile: a "compile" here
is one build of the key's strategy function (``MatvecStrategy.build`` or
``build_batched``) and, on a mesh that lies on one CUDA device, the capture
of its program as a CUDA graph (``engine/core.py``), held under an explicit
key (op × strategy × kernel × combine × bucket × dtype × storage) with
compile and hit counters the serve bench reports — a flat ``compiles``
across a warm stream is the zero-recompilation criterion.

**Build fingerprints** are the port's reading of the JAX package's lowering
fingerprint (``staticcheck/hlo.py::lowering_fingerprint``): the cache
records, for each key it builds, a sha256 over the key, the collective
schedule the key's program issues, the local shapes it runs on and the
route each local kernel plans (:func:`build_fingerprint`). The schedule and
the kernel calls come from :func:`trace_program`, which runs the key's
strategy function once under the collective recorder with A as data-less
``meta`` shards and a stand-in kernel that records each call's shapes (the
real kernel's planner gives its route) and returns CPU zeros: y-sized host
work, no device work, no launch. A solver key's program is traced the same
way for one loop trip, with its loop kind (:func:`trace_solver`), a
speculative key's candidate and check (:func:`trace_speculative`); the
fused step and the ring GEMV are stood in by the recorder itself
(``parallel/mesh.py::kernel_entered``). The same key must give the same
fingerprint on every fresh build (``staticcheck/hlo.py``'s fingerprint
gate; ``chip_smoke.py`` sections 49 and 50 across two engines on the card).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Any, Callable, NamedTuple

from ..obs.registry import Counter


class ExecKey(NamedTuple):
    """Identity of one built program in the cache."""

    op: str  # "matvec" | "gemm"
    strategy: str
    kernel: str
    combine: str | None
    bucket: int  # RHS columns (1 for the matvec path)
    dtype: str
    # Resident-A storage format: "native", or int8/int8c/fp8 (ops/quantize.py).
    storage: str = "native"

    def label(self) -> str:
        """Canonical ``op:strategy:kernel:combine:bucket:dtype[:storage]``
        string, as the JAX package spells it (a None combine reads as
        ``default``; the storage suffix appears only for non-native
        storage)."""
        combine = self.combine if self.combine is not None else "default"
        base = (
            f"{self.op}:{self.strategy}:{self.kernel}:{combine}:"
            f"{self.bucket}:{self.dtype}"
        )
        return base if self.storage == "native" else f"{base}:{self.storage}"


@dataclasses.dataclass
class ExecStats:
    """Counters the serve bench reports (a point-in-time view of the
    cache's registry counters)."""

    compiles: int = 0
    hits: int = 0


class ExecutableCache:
    """Built programs keyed by :class:`ExecKey`.

    ``get(key, build)`` returns the cached program or makes it with
    ``build()``, which returns the callable. Counting goes through obs
    counters: pass the engine's registry counters to share one source of
    truth with its metrics snapshot, or let the cache own private ones.
    """

    def __init__(
        self,
        compile_counter: Counter | None = None,
        hit_counter: Counter | None = None,
    ) -> None:
        self._executables: dict[ExecKey, Any] = {}
        self._compiles = compile_counter or Counter("compiles")
        self._hits = hit_counter or Counter("hits")
        # ExecKey -> build fingerprint, recorded at a key's first build that
        # passes a fingerprint function and kept across clear(): a key
        # built again (after a release) is the same program.
        self.fingerprints: dict[ExecKey, str] = {}

    @property
    def stats(self) -> ExecStats:
        return ExecStats(compiles=self._compiles.value, hits=self._hits.value)

    def get(self, key: ExecKey, build: Callable[[], Callable],
            fingerprint: Callable[[], str] | None = None) -> Callable:
        exe = self._executables.get(key)
        if exe is not None:
            self._hits.inc()
            return exe
        exe = build()
        if fingerprint is not None and key not in self.fingerprints:
            self.fingerprints[key] = fingerprint()
        self._executables[key] = exe
        self._compiles.inc()
        return exe

    def clear(self) -> list:
        """Drop every built program (the engine's reshard: programs close
        over the old layout's shards) and return them, so the caller decides
        when their buffers may go. The compile counter keeps counting
        builds: a key built again counts again."""
        dropped = list(self._executables.values())
        self._executables.clear()
        return dropped

    def keys(self) -> list[ExecKey]:
        """The ExecKeys built so far (insertion order)."""
        return list(self._executables)

    def __len__(self) -> int:
        return len(self._executables)

    def __contains__(self, key: ExecKey) -> bool:
        return key in self._executables


# ------------------------------------------------------------ fingerprints


def build_fingerprint(key: ExecKey, schedule, local_shapes, routes,
                      loop: str | None = None) -> str:
    """sha256 over the key, its collective schedule (a list of records, or
    None where the program was not traced), its local shapes, its kernel
    routes and, for a solver, the loop it runs, in one canonical JSON
    encoding."""
    payload = {
        "key": key.label(),
        "schedule": None if schedule is None else [
            [r.kind, r.op, list(r.axes), list(r.shape), r.dtype,
             r.payload_bytes, r.boundary] for r in schedule
        ],
        "local_shapes": local_shapes,
        "routes": routes,
    }
    if loop is not None:
        payload["loop"] = loop
    text = json.dumps(payload, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(text.encode()).hexdigest()


def kernel_route(kernel, storage: str, a_shape: tuple, a_dtype, x_shape: tuple,
                 device, block: int | None = None) -> str:
    """The route the local kernel ``kernel`` plans for one call on a
    ``device`` tensor: the hand-written kernels' planners on a card
    (``gemv_plan``, ``default_gemm_tiles``, ``quant_route``; base addresses
    are taken 16-byte aligned, as the caching allocator gives every shard),
    ``plain`` for their plain versions on the CPU, and the tier's name for
    the library tiers."""
    import torch

    name = kernel if isinstance(kernel, str) else getattr(kernel, "__name__", "custom")
    if name != "cuda":
        return name
    if torch.device(device).type != "cuda":
        return "plain"
    m, k = a_shape
    n = 1 if len(x_shape) == 1 else x_shape[1]
    if storage != "native":
        from ..ops.cuda_quant import quant_route

        return quant_route(storage, a_dtype, m, k, n, block, True)
    if len(x_shape) == 1:
        from ..ops.cuda_gemv import gemv_plan, sm_count

        return repr(gemv_plan(m, k, a_dtype, a_dtype, sm_count(torch.device(device))))
    from ..ops.cuda_gemm import default_gemm_tiles

    return repr(default_gemm_tiles(m, n, k, a_dtype, True, True))


def _wrapper_routes(kernels, device, dtype, block) -> list[str]:
    """One route per distinct wrapper call a stand-in run noted
    (``parallel/mesh.py::KernelCall``): the GEMV wrappers' and the fused
    step's GEMV by :func:`kernel_route`, the ring GEMV by its ranks."""
    routes = set()
    for call in kernels:
        shapes = f"{call.name}:{list(call.a_shape)}x{list(call.x_shape)}:"
        if call.name == "ring_gemv":
            routes.add(shapes + f"ring[{call.ranks} ranks, {call.ranks} steps]")
        else:
            routes.add(shapes + kernel_route("cuda", call.storage, call.a_shape, dtype,
                                             call.x_shape, device, block))
    return sorted(routes)


class _Trace(NamedTuple):
    """The host copies of a mesh a trace runs on, the stand-in kernel and
    the calls it saw."""

    meta_mesh: Any
    host_mesh: Any
    kern: Callable
    calls: list


def _trace_setup(mesh) -> _Trace:
    """A copy of ``mesh`` on ``meta`` devices (A's shards) and one on the
    CPU (everything else), and a stand-in kernel that records each call's
    shapes and returns CPU zeros of the partial's shape."""
    import torch

    from ..ops.gemv import acc_dtype

    p = mesh.size
    meta_mesh = dataclasses.replace(mesh, devices=(torch.device("meta"),) * p,
                                    owners=None, rank=0)
    host_mesh = dataclasses.replace(meta_mesh, devices=(torch.device("cpu"),) * p)
    calls: list = []

    def kern(a, x):
        calls.append((tuple(a.shape), tuple(x.shape)))
        return torch.zeros((a.shape[0], *x.shape[1:]), dtype=acc_dtype(a.dtype))

    return _Trace(meta_mesh, host_mesh, kern, calls)


def _meta_operand(trace: _Trace, spec_a, storage: str, a_shape: tuple, dtype, block):
    """A as data-less ``meta`` shards cut by ``spec_a``, held on the host
    mesh, and its shard leaves' shapes."""
    import torch

    from ..models.base import shard_operand
    from ..ops.quantize import NATIVE, quantized_struct
    from ..parallel.mesh import ShardedTensor

    m, k = a_shape
    if storage == NATIVE:
        a = torch.empty((m, k), dtype=dtype, device="meta")
    else:
        a = quantized_struct(m, k, storage, dtype, block)
    meta_a = shard_operand(a, spec_a, trace.meta_mesh)
    leaves = [
        [list(t.shape), str(t.dtype)]
        for s in meta_a.shards
        for t in ((s,) if storage == NATIVE else s.leaves) if t is not None
    ]
    return ShardedTensor(meta_a.shards, meta_a.shape, meta_a.spec, trace.host_mesh), leaves


def _call_routes(trace: _Trace, kernel, storage, dtype, device, block) -> list[str]:
    return sorted({
        f"{list(ash)}x{list(xsh)}:"
        + kernel_route(kernel, storage, ash, dtype, xsh, device, block)
        for ash, xsh in trace.calls
    })


def trace_program(strategy, mesh, *, batched: bool, kernel, combine, stages,
                  gather_output, storage: str, a_shape: tuple, dtype, rhs_cols: int = 1,
                  block: int | None = None) -> dict:
    """Run ``strategy``'s built function once under the collective
    recorder on a copy of ``mesh`` whose shards all lie on the CPU: A's
    shards are data-less ``meta`` tensors cut by A's spec, the right-hand
    side and every partial are CPU zeros of their real shapes (the stand-in
    kernel makes them, and the recorder stands in the ring GEMV of
    ``pallas_ring``), so the trace costs y-sized host work and moves no
    A. Returns ``schedule`` (the records), ``local_shapes`` (A's shard
    leaves and the RHS shards) and ``routes`` (one per distinct local kernel
    call, from :func:`kernel_route` on the real mesh's first device; the
    ring GEMV's by its ranks)."""
    import torch

    from ..ops.quantize import NATIVE
    from ..parallel.mesh import CollectiveRecorder, shard

    trace = _trace_setup(mesh)
    build = strategy.build_batched if batched else strategy.build
    fn = build(trace.host_mesh, kernel=trace.kern, gather_output=gather_output,
               combine=combine, stages=stages,
               dtype_storage=None if storage == NATIVE else storage)
    spec_a, spec_x, _ = (strategy.batched_specs if batched else strategy.specs)(
        trace.host_mesh)
    placed_a, leaves = _meta_operand(trace, spec_a, storage, a_shape, dtype, block)
    k = a_shape[1]
    rhs = torch.zeros((k, rhs_cols) if batched else (k,), dtype=dtype)
    placed_x = shard(rhs, spec_x, trace.host_mesh)
    with CollectiveRecorder(stand_in=True) as rec:
        fn(placed_a, placed_x)
    device = mesh.devices[0]
    local_shapes = {"a": leaves, "rhs": [list(t.shape) for t in placed_x.shards]}
    routes = sorted(_call_routes(trace, kernel, storage, dtype, device, block)
                    + _wrapper_routes(rec.kernels, device, dtype, block))
    return {"schedule": rec.records, "local_shapes": local_shapes, "routes": routes}


def trip_records(shorter: list, longer: list) -> list:
    """The records of ``longer`` that ``shorter`` lacks, as multisets, in
    ``longer``'s order: the collectives (or kernel calls) of the trips one
    run made beyond another's."""
    from collections import Counter as Multiset

    left = Multiset(shorter)
    out = []
    for r in longer:
        if left[r]:
            left[r] -= 1
        else:
            out.append(r)
    return out


def trace_solver(strategy, mesh, *, op: str, kernel, combine, stages, storage: str,
                 a_shape: tuple, dtype, restart: int, steps: int,
                 block: int | None = None) -> dict:
    """The solver twin of :func:`trace_program`: the op's program built on
    the host copy of ``mesh`` (A as ``meta`` shards, the stand-in kernel for
    the local GEMV, the recorder standing in the fused step and its GEMVs),
    run from a right-hand side of ones with ``maxiter`` 0 and 1. Returns
    ``schedule`` (one trip's collectives: what the second run issued beyond
    the first), ``loop`` (``solvers/ops.py::solver_loop``'s decision for the
    real mesh), ``local_shapes`` and ``routes``."""
    import torch

    from ..ops.quantize import NATIVE
    from ..parallel.mesh import CollectiveRecorder
    from ..solvers.ops import _build_solver, build_solver

    trace = _trace_setup(mesh)
    fused = kernel == "cuda_fused"
    dtype_storage = None if storage == NATIVE else storage
    common = dict(dtype=dtype, combine=combine, stages=stages,
                  dtype_storage=dtype_storage, restart=restart, steps=steps)
    fn = _build_solver(op, strategy, trace.host_mesh, "host",
                       kernel="cuda_fused" if fused else trace.kern, **common)
    loop = build_solver(op, strategy, mesh, kernel=kernel, **common).loop
    placed_a, leaves = _meta_operand(trace, strategy.specs(trace.host_mesh)[0], storage,
                                     a_shape, dtype, block)
    b = torch.ones((a_shape[0],), dtype=dtype)
    runs = []
    for maxiter in (0, 1):
        with CollectiveRecorder(stand_in=True) as rec:
            fn(placed_a, b, 1e-6, maxiter, 1.0, 2.0)
        runs.append(rec)
    device = mesh.devices[0]
    routes = sorted(_call_routes(trace, "cuda" if fused else kernel, storage, dtype,
                                 device, block)
                    + _wrapper_routes(runs[1].kernels, device, dtype, block))
    return {"schedule": trip_records(runs[0].records, runs[1].records), "loop": loop,
            "local_shapes": {"a": leaves, "rhs": [[a_shape[0]]]}, "routes": routes}


def trace_speculative(strategy, mesh, *, kernel, combine, gather_output, a_shape: tuple,
                      dtype, probes: int, bucket: int | None, block: int | None) -> dict:
    """The speculative twin of :func:`trace_program`: the candidate and the
    check built on the host copy of ``mesh``, the int8c payload as ``meta``
    shards, P, U, x and the tolerance as CPU zeros; ``bucket`` is the block
    face's width (None for the vector face). Returns ``schedule`` (the
    candidate's collectives and the check's reduction), ``local_shapes``
    and ``routes``."""
    import torch

    from ..ops.speculative import build_speculative, probe_spec
    from ..parallel.mesh import CollectiveRecorder, shard

    trace = _trace_setup(mesh)
    fn = build_speculative(strategy, trace.host_mesh, probes=probes, kernel=trace.kern,
                           combine=combine, stages=None, storage="int8c",
                           gather_output=gather_output, b=bucket)
    specs = strategy.batched_specs if bucket is not None else strategy.specs
    spec_a, spec_x, _ = specs(trace.host_mesh)
    placed_a, leaves = _meta_operand(trace, spec_a, "int8c", a_shape, dtype, block)
    m, k = a_shape
    pm = shard(torch.zeros((probes, k), dtype=dtype), probe_spec(strategy, trace.host_mesh),
               trace.host_mesh)
    x = shard(torch.zeros((k,) if bucket is None else (k, bucket), dtype=dtype), spec_x,
              trace.host_mesh)
    with CollectiveRecorder(stand_in=True) as rec:
        fn(placed_a, pm, torch.zeros((probes, m), dtype=dtype), x,
           torch.zeros((), dtype=torch.float32))
    local_shapes = {"a": leaves, "p": [list(t.shape) for t in pm.shards],
                    "rhs": [list(t.shape) for t in x.shards]}
    return {"schedule": rec.records, "local_shapes": local_shapes,
            "routes": _call_routes(trace, kernel, "int8c", dtype, mesh.devices[0], block)}
