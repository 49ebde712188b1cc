"""The collective census: what each schedule issues, by formula and by run.

The port's counterpart of the JAX package's ``staticcheck/hlo.py`` (the
name is kept so a reader finds it; the port lowers nothing). Two halves:

* **The formulas** (:func:`schedule_formula`, :func:`reshard_formula`,
  :func:`storage_bytes_ratio`): the JAX package's, which the analytic cost
  model (``tuning/cost_model.py``) evaluates and which pin the audit. The
  cost model imports this module at call time, so patching
  :func:`schedule_formula` reddens every prediction through the one symbol.
* **The audit**, the port's reading of "lower each config and count its
  collectives": every :data:`AUDIT_CONFIGS` cell (17 native schedules and 6
  quantized-storage cells; ``pallas_ring`` is absent, as in the JAX
  package, its exchange being inside the kernel) is built through
  ``MatvecStrategy.build`` at ``AUDIT_M x AUDIT_K`` fp32 on 8 logical CPU
  shards (2x4), run once under the mesh's collective recorder
  (``parallel/mesh.py::CollectiveRecorder``), and held to

  - its census and per-device payload bytes against :func:`schedule_formula`
    (``hlo-schedule``), and a staged ``overlap@S`` to S chunked collectives,
    never a full-width one (``hlo-overlap``);
  - the storage gates: the resident leaves' ``a_bytes_ratio`` under
    :data:`STORAGE_BYTE_CEILING` and equal to the format's structure
    (``hlo-storage-bytes``), a quantized cell's census equal to its native
    counterpart's (``hlo-storage-census``), and no full-width low-bit to
    float conversion of A while the program runs (``hlo-early-dequant``,
    watched at the ATen level; ``ops.quantize.matvec_quantized_dequant_first``
    is the known-bad program it must catch);
  - the build fingerprint (``engine/executables.py``): the same ExecKey
    fingerprints the same on two fresh builds (``hlo-fingerprint``);
  - every online-reshard migration (:data:`RESHARD_AUDIT_CONFIGS`) against
    :func:`reshard_formula`, with no gather/reduce kind (a host round
    trip's signature) and no redundant collective
    (``hlo-reshard-schedule``);
  - the port's golden table (``golden_schedule.json`` beside this module,
    :func:`write_golden`): a disagreement is drift (``hlo-golden``,
    ``hlo-census``);
  - the served solvers, the fused solves and the speculative programs
    (:data:`SOLVER_AUDIT_CONFIGS`, :data:`FUSED_SOLVER_AUDIT_CONFIGS`,
    :data:`SPEC_AUDIT_CONFIGS`; the section below says how a run stands in
    for a lowering), and the traced fingerprints of their keys and of
    ``pallas_ring``'s.

The comparison is made at the JAX lowering's boundary: the strategies'
output gather, which the JAX package leaves to its compiler outside the
lowered program, is recorded apart and not counted, so ``rowwise|gather``
has an empty census in both packages. The census of every cell equals the
JAX package's committed golden (``tests/test_torch_staticcheck.py``).

Payload bytes are the operand bytes each collective presents per device.
At fp32 every collective moves fp32; at a 16-bit A the port's combines move
the kernels' fp32 accumulator partials where its programs combine them
(:func:`expected_schedule` says which kinds), and y in A's dtype elsewhere.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Iterable, NamedTuple

from .findings import Finding, dedup

# Bytes per element for the census dtype names (the same table the byte
# accounting uses).
_ITEMSIZE = {
    "float32": 4, "float64": 8, "bfloat16": 2, "float16": 2,
    "int8": 1, "float8": 1,
    # Integer/pred widths (indices, counters, masks); irrelevant to the
    # collective payloads.
    "int1": 1, "int16": 2, "int32": 4, "int64": 8, "uint32": 4,
    "uint64": 8,
}


def dtype_itemsize(dtype: str) -> int:
    """Bytes per element of a census dtype name, shared with the cost model
    so both size payloads identically."""
    return _ITEMSIZE[dtype]


def storage_bytes_ratio(
    storage: str, itemsize: int, block: int = 128
) -> float:
    """Structural resident-A byte ratio of a storage format against the
    native ``itemsize``-per-element stream: one payload byte plus one fp32
    scale per ``block``-element group, doubled for the compensated pair.
    The cost model sizes quantized residencies from it."""
    if storage == "native":
        return 1.0
    if storage not in ("int8", "int8c", "fp8"):
        raise KeyError(f"no storage byte formula for {storage!r}")
    per_elem = 1.0 + 4.0 / block
    if storage == "int8c":
        per_elem *= 2.0
    return per_elem / itemsize


def schedule_formula(
    strategy: str,
    combine: str,
    stages: int | None,
    *,
    m: int,
    p: int,
    r: int,
    itemsize: int,
) -> tuple[dict[str, int], dict[str, int]]:
    """The per-config collective census and per-device payload bytes as a
    symbolic function of the operand and mesh: ``(census, payload_bytes)``
    keyed by collective kind.

    Payloads are the operand bytes each op presents per device; the wire
    factor (2(p−1)/p for a ring all-reduce, ...) is the cost model's to
    apply. An ``overlap@S`` entry is S chunked collectives at 1/S of the
    un-staged bytes (the same total). ``r`` is the blockwise grid's row
    count; the 1-D strategies ignore it. Raises ``KeyError`` for a
    (strategy, combine) pair no formula covers."""
    s = stages or 1

    def entry(**kinds: tuple[int, int]):
        # each kind: (op count, elements per op)
        census = {k: n for k, (n, _) in kinds.items()}
        payload = {k: n * e * itemsize for k, (n, e) in kinds.items()}
        return census, payload

    strat, comb = strategy, combine
    if strat in ("rowwise", "colwise"):
        if comb == "gather":
            # The final gather of y: the cost model adds it explicitly
            # (cost_model.implicit_schedule).
            return entry()
        if comb == "psum":
            return entry(**{"all-reduce": (1, m)})
        if comb == "psum_scatter":
            return entry(**{"reduce-scatter": (1, m)})
        if comb in ("ring", "ring_overlap"):
            # p−1 neighbor hops, each moving one m/p accumulator chunk.
            return entry(**{"collective-permute": (p - 1, m // p)})
        if comb == "a2a":
            return entry(**{"all-to-all": (1, m)})
        if comb == "overlap" and strat == "colwise":
            # S chunked reduce-scatters, m/S rows each.
            return entry(**{"reduce-scatter": (s, m // s)})
        if comb == "overlap" and strat == "rowwise":
            # S chunked ring all-gathers: (p−1) hops of m/(p·S) rows each.
            return entry(**{"collective-permute": (s * (p - 1), m // (p * s))})
        if comb == "overlap_ring":
            # S staged ring reduce-scatters: each stage's m/S-row partial
            # rides p−1 hops of m/(p·S)-row accumulator chunks.
            return entry(**{"collective-permute": (s * (p - 1), m // (p * s))})
    if strat == "blockwise":
        if comb == "gather":
            # The reduce over grid columns; the final gather over 'rows' is
            # the implicit one (as above).
            return entry(**{"all-reduce": (1, m // r)})
        if comb == "ring":
            return entry(**{
                "all-reduce": (1, m // r),
                "collective-permute": (r - 1, m // r),
            })
        if comb == "overlap":
            # Per stage: one chunked psum over grid cols + (r−1) chunked
            # ring-gather hops over grid rows, m/(r·S) rows each.
            return entry(**{
                "all-reduce": (s, m // (r * s)),
                "collective-permute": (s * (r - 1), m // (r * s)),
            })
    staged = f"@{stages}" if stages is not None else ""
    raise KeyError(
        f"no schedule formula for {strategy}|{combine}{staged}"
    )


def reshard_formula(
    src: str, dst: str, *, m: int, k: int, p: int, r: int, c: int,
    itemsize: int,
) -> tuple[dict[str, int], dict[str, int]]:
    """The (src, dst) migration's collective census and per-device payload
    bytes as a symbolic function of the operand and mesh. Every step of
    every program (``parallel.reshard.reshard_program``) presents exactly
    the device's 1/p local shard, so payload = count × (m·k·itemsize)/p per
    kind. ``CostModel.predict_reshard`` evaluates it (the wire factor,
    (g−1)/g per all_to_all group, is the cost model's to apply)."""
    from ..parallel.reshard import reshard_program

    shard_bytes = (m * k * itemsize) // p
    census: dict[str, int] = {}
    for step in reshard_program(src, dst, r, c):
        kind = "all-to-all" if step[0] == "a2a" else "collective-permute"
        census[kind] = census.get(kind, 0) + 1
    payload = {kind: n * shard_bytes for kind, n in census.items()}
    return census, payload


# ------------------------------------------------------------------ audit

AUDIT_DEVICES = 8
AUDIT_M = 64
AUDIT_K = 2048
AUDIT_DTYPE = "float32"
GOLDEN_NAME = "golden_schedule.json"
GOLDEN_SCHEMA = 2

# Resident-A byte-ratio ceilings the quantized cells must meet: a 1-byte
# payload plus an fp32 scale plane at 1/block density, doubled for the
# compensated pair (the JAX package's acceptance pins).
STORAGE_BYTE_CEILING = {"int8": 0.30, "fp8": 0.30, "int8c": 0.55}

# Peak ceilings: a quantized cell's peak device memory during a matvec
# (resident leaves plus every transient) against its native counterpart's,
# the JAX package's peak-liveness ceilings. A program that materializes a
# dequantized full-width A lands above them. The card measures the peak
# (staticcheck/card.py); nothing estimates it here.
PEAK_LIVENESS_CEILING = {"int8": 0.70, "fp8": 0.70, "int8c": 0.90}

_CENSUS_KINDS = ("all-gather", "all-reduce", "all-to-all",
                 "collective-permute", "reduce-scatter")


class AuditConfig(NamedTuple):
    """One audited program: a strategy x combine(@stages) x kernel x
    storage cell. ``kernel`` is the port's tier name (``torch`` where the
    JAX package says ``xla``)."""

    strategy: str
    combine: str
    stages: int | None = None
    kernel: str = "torch"
    storage: str = "native"

    @property
    def key(self) -> str:
        combine = self.combine + (
            f"@{self.stages}" if self.stages is not None else ""
        )
        base = f"{self.strategy}|{combine}|{self.kernel}"
        return base if self.storage == "native" else f"{base}|{self.storage}"


# The JAX package's audit family, cell for cell.
AUDIT_CONFIGS: tuple[AuditConfig, ...] = (
    AuditConfig("rowwise", "gather"),
    AuditConfig("rowwise", "ring"),
    AuditConfig("rowwise", "overlap", 2),
    AuditConfig("rowwise", "overlap", 4),
    AuditConfig("colwise", "psum"),
    AuditConfig("colwise", "psum_scatter"),
    AuditConfig("colwise", "ring"),
    AuditConfig("colwise", "ring_overlap"),
    AuditConfig("colwise", "a2a"),
    AuditConfig("colwise", "overlap", 2),
    AuditConfig("colwise", "overlap", 4),
    AuditConfig("colwise", "overlap_ring", 2),
    AuditConfig("colwise", "overlap_ring", 4),
    AuditConfig("blockwise", "gather"),
    AuditConfig("blockwise", "ring"),
    AuditConfig("blockwise", "overlap", 2),
    AuditConfig("blockwise", "overlap", 4),
    # Quantized storage: each strategy's default schedule, and the format
    # ladder on rowwise (no in-body collective: every resident byte is the
    # payload's). Their census must equal the native counterpart's.
    AuditConfig("rowwise", "gather", storage="int8"),
    AuditConfig("rowwise", "gather", storage="int8c"),
    AuditConfig("rowwise", "gather", storage="fp8"),
    AuditConfig("colwise", "psum_scatter", storage="int8"),
    AuditConfig("colwise", "psum_scatter", storage="int8c"),
    AuditConfig("blockwise", "gather", storage="int8"),
)


class ReshardAuditConfig(NamedTuple):
    """One audited migration: a (src, dst) strategy pair."""

    src: str
    dst: str

    @property
    def key(self) -> str:
        return f"reshard|{self.src}|{self.dst}"


RESHARD_AUDIT_CONFIGS = tuple(
    ReshardAuditConfig(src, dst)
    for src in ("rowwise", "colwise", "blockwise")
    for dst in ("rowwise", "colwise", "blockwise")
    if src != dst
)


def native_counterpart(cfg: AuditConfig) -> AuditConfig:
    """The same schedule under native storage."""
    return AuditConfig(cfg.strategy, cfg.combine, cfg.stages, cfg.kernel)


def supported_configs(configs: Iterable[AuditConfig]) -> tuple[AuditConfig, ...]:
    """The cells this torch build can run (fp8 needs ``float8_e4m3fn``)."""
    from ..ops.quantize import fp8_supported

    return tuple(c for c in configs if c.storage != "fp8" or fp8_supported())


def audit_mesh(p: int = AUDIT_DEVICES, device="cpu", grid=None):
    """``p`` logical shards of ``device``: the most-square grid (2x4 at
    8, the JAX audit's), or ``grid``."""
    import torch

    from ..parallel.mesh import make_mesh

    return make_mesh(p, shape=grid, devices=[torch.device(device)] * p)


def _acc_name(dtype: str) -> str:
    return "float64" if dtype == "float64" else "float32"


def _acc_kinds(strategy: str, combine: str) -> frozenset:
    """The kinds a schedule moves in the kernels' accumulator dtype: colwise
    combines its partials; blockwise sums its partials over the grid
    columns (and its staged gather carries them); rowwise's staged gather
    carries the accumulator too. The plain gathers move y in A's dtype."""
    if strategy == "colwise":
        return frozenset(_CENSUS_KINDS)
    if strategy == "blockwise":
        return frozenset({"all-reduce", "collective-permute"}
                         if combine == "overlap" else {"all-reduce"})
    return frozenset({"collective-permute"} if combine == "overlap" else ())


def expected_schedule(
    cfg: AuditConfig, mesh, *, m: int = AUDIT_M, dtype: str = AUDIT_DTYPE,
) -> tuple[dict[str, int], dict[str, int]]:
    """:func:`schedule_formula` evaluated for one cell on ``mesh``: what
    the cell must issue, with each kind's bytes at the dtype it moves."""
    from ..parallel.mesh import mesh_grid_shape

    r, _c = mesh_grid_shape(mesh)
    kw = dict(m=m, p=mesh.size, r=r)
    census, payload = schedule_formula(
        cfg.strategy, cfg.combine, cfg.stages, itemsize=dtype_itemsize(dtype), **kw)
    _, acc = schedule_formula(
        cfg.strategy, cfg.combine, cfg.stages,
        itemsize=dtype_itemsize(_acc_name(dtype)), **kw)
    wide = _acc_kinds(cfg.strategy, cfg.combine)
    return (dict(sorted(census.items())),
            {k: (acc[k] if k in wide else payload[k]) for k in sorted(payload)})


def expected_reshard(
    rcfg: ReshardAuditConfig, mesh, *, m: int = AUDIT_M, k: int = AUDIT_K,
    dtype: str = AUDIT_DTYPE,
) -> tuple[dict[str, int], dict[str, int]]:
    """:func:`reshard_formula` evaluated for one migration on ``mesh``."""
    from ..parallel.mesh import mesh_grid_shape

    r, c = mesh_grid_shape(mesh)
    census, payload = reshard_formula(
        rcfg.src, rcfg.dst, m=m, k=k, p=mesh.size, r=r, c=c,
        itemsize=dtype_itemsize(dtype))
    return dict(sorted(census.items())), dict(sorted(payload.items()))


def audit_block(cfg: AuditConfig, mesh, k: int = AUDIT_K) -> int | None:
    """The quantization block of a quantized cell: the engine's derivation
    (``default_block`` against the strategy's contraction sharding)."""
    if cfg.storage == "native":
        return None
    from ..models import get_strategy
    from ..ops.quantize import default_block

    return default_block(k, get_strategy(cfg.strategy).contraction_shards(mesh))


def _bound(cfg: AuditConfig):
    from ..models import get_strategy

    strat = get_strategy(cfg.strategy)
    return strat.with_combine(cfg.combine, stages=cfg.stages) or strat


def build_config(cfg: AuditConfig, mesh, kernel=None):
    """The cell's program, through ``MatvecStrategy.build``. ``kernel``
    overrides the local kernel (the dequant-first mutation injects the
    known-bad program here)."""
    from ..models import get_strategy

    kwargs: dict = {"combine": cfg.combine,
                    "kernel": kernel if kernel is not None else cfg.kernel}
    if cfg.stages is not None:
        kwargs["stages"] = cfg.stages
    if cfg.storage != "native":
        kwargs["dtype_storage"] = cfg.storage
    return get_strategy(cfg.strategy).build(mesh, **kwargs)


def audit_operands(cfg: AuditConfig, mesh, *, m: int = AUDIT_M, k: int = AUDIT_K,
                   dtype: str = AUDIT_DTYPE, seed: int = 0, a=None):
    """The cell's operands placed on ``mesh``: a seeded uniform A (made on
    the mesh's first device) and x, A quantized for a quantized cell. ``a``
    passes a native A in instead (the card shares one across cells)."""
    import torch

    from ..ops.quantize import quantize_matrix

    device = mesh.devices[0]
    gen = torch.Generator(device=device).manual_seed(seed)
    tdt = getattr(torch, dtype)
    if a is None:
        a = torch.rand((m, k), generator=gen, device=device, dtype=tdt)
    x = torch.rand((k,), generator=gen, device=device, dtype=tdt)
    if cfg.storage != "native":
        a = quantize_matrix(a, cfg.storage, block=audit_block(cfg, mesh, k))
    return _bound(cfg).place(a, x, mesh)


def resident_bytes(placed) -> int:
    """Bytes of a placed A's shards: every leaf of a quantized resident."""
    total = 0
    for s in placed.shards:
        for t in ((s,) if not hasattr(s, "leaves") else s.leaves):
            if t is not None:
                total += t.numel() * t.element_size()
    return total


class _ConvertWatch:
    """Records every ATen conversion of a low-bit (int8 or float8) tensor
    to a float one while entered: ``(source shape, source dtype, result
    dtype)``. The port's reading of the JAX gate's walk over StableHLO
    converts."""

    def __init__(self):
        self.converts: list[tuple] = []
        self._mode = None

    def __enter__(self):
        import torch
        from torch.utils._python_dispatch import TorchDispatchMode

        watch = self
        lowbit = {torch.int8} | ({torch.float8_e4m3fn}
                                 if hasattr(torch, "float8_e4m3fn") else set())
        ops = {torch.ops.aten._to_copy.default: 0, torch.ops.aten.copy_.default: 1}

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                out = func(*args, **(kwargs or {}))
                pos = ops.get(func)
                if pos is not None:
                    src = args[pos]
                    dst = out if pos == 0 else args[0]
                    if src.dtype in lowbit and dst.dtype.is_floating_point:
                        watch.converts.append((tuple(src.shape), str(src.dtype),
                                               str(dst.dtype)))
                return out

        self._mode = Mode()
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        self._mode.__exit__(*exc)


def run_config(cfg: AuditConfig, mesh, a, x, *, kernel=None, watch: bool = False):
    """Run the cell's program once on placed operands under the collective
    recorder (and, with ``watch``, the low-bit conversion watch). Returns
    ``(y, recorder, converts)``."""
    from ..parallel.mesh import CollectiveRecorder

    fn = build_config(cfg, mesh, kernel)
    with CollectiveRecorder() as rec:
        if watch:
            with _ConvertWatch() as w:
                y = fn(a, x)
            converts = w.converts
        else:
            y, converts = fn(a, x), []
    return y, rec, converts


def _local_a_shape(cfg: AuditConfig, mesh, m: int, k: int, dtype, block) -> tuple:
    """The per-device payload shape of a quantized cell, derived from its
    structure (``quantized_struct``) and the strategy's A spec."""
    import torch

    from ..ops.quantize import quantized_like, quantized_struct

    spec = _bound(cfg).specs(mesh)[0]

    def cut(dim_entry) -> int:
        if dim_entry is None:
            return 1
        names = (dim_entry,) if isinstance(dim_entry, str) else tuple(dim_entry)
        n = 1
        for name in names:
            n *= mesh.shape[name]
        return n

    rows, cols = cut(spec[0]), cut(spec[1] if len(spec) > 1 else None)
    local = quantized_like(
        quantized_struct(m, k, cfg.storage, dtype, block),
        lambda leaf: torch.empty((leaf.shape[0] // rows, leaf.shape[1] // cols),
                                 dtype=leaf.dtype, device="meta"),
    )
    return tuple(local.shape)


def early_dequant_findings(cfg: AuditConfig, converts, mesh, *, m: int = AUDIT_M,
                           k: int = AUDIT_K, dtype: str = AUDIT_DTYPE) -> list[Finding]:
    """A quantized cell must never convert a full-width low-bit A — the
    global (m, k) or the per-device shard — to float: the sanctioned
    kernels upcast (m, block) tiles, or nothing outside registers."""
    if cfg.storage == "native":
        return []
    import torch

    full = {(m, k), _local_a_shape(cfg, mesh, m, k, getattr(torch, dtype),
                                   audit_block(cfg, mesh, k))}
    return [
        Finding(f"<hlo:{cfg.key}>", 0, "hlo-early-dequant",
                f"the program converts a full-width {src_dtype} {list(shape)} A to "
                f"{dst_dtype} before the contraction: the quantized cell stores "
                "the payload's bytes but holds and moves full-width float "
                "bytes (upcast per (m, block) tile, or in registers)")
        for shape, src_dtype, dst_dtype in dict.fromkeys(converts)
        if shape in full
    ]


def exec_key(cfg: AuditConfig, dtype: str = AUDIT_DTYPE):
    """The engine-cache identity the cell dispatches under."""
    from ..engine.executables import ExecKey

    combine = cfg.combine + (f"@{cfg.stages}" if cfg.stages is not None else "")
    return ExecKey("matvec", cfg.strategy, cfg.kernel, combine, 1, dtype,
                   cfg.storage)


def config_fingerprint(cfg: AuditConfig, mesh, *, m: int = AUDIT_M, k: int = AUDIT_K,
                       dtype: str = AUDIT_DTYPE) -> str:
    """The cell's build fingerprint from a fresh build, as the engine
    records it (``engine/executables.py``)."""
    import torch

    from ..engine.executables import build_fingerprint, trace_program
    from ..models import get_strategy

    trace = trace_program(
        get_strategy(cfg.strategy), mesh, batched=False, kernel=cfg.kernel,
        combine=cfg.combine, stages=cfg.stages, gather_output=True,
        storage=cfg.storage, a_shape=(m, k), dtype=getattr(torch, dtype),
        block=audit_block(cfg, mesh, k),
    )
    return build_fingerprint(exec_key(cfg, dtype), trace["schedule"],
                             trace["local_shapes"], trace["routes"])


def audit_entry(cfg: AuditConfig, mesh, *, m: int = AUDIT_M, k: int = AUDIT_K,
                dtype: str = AUDIT_DTYPE, kernel=None, seed: int = 0,
                run=None) -> dict:
    """Run one cell and package what it issued: the census, per-device
    payload bytes, the resident leaves' ``a_bytes`` and their ratio to the
    native stream, the full-width low-bit conversions seen (``converts``),
    and the records (``records``) and the output gathers kept apart
    (``boundary``). ``run`` passes in a ``(a, x, y, recorder, converts)``
    already made."""
    if run is None:
        a, x = audit_operands(cfg, mesh, m=m, k=k, dtype=dtype, seed=seed)
        y, rec, converts = run_config(cfg, mesh, a, x, kernel=kernel,
                                      watch=cfg.storage != "native")
    else:
        a, x, y, rec, converts = run
    census, payload = rec.census()
    a_bytes = resident_bytes(a)
    native = m * k * dtype_itemsize(dtype)
    return {
        "census": census,
        "payload_bytes": payload,
        "payload_total_bytes": sum(payload.values()),
        "a_bytes": a_bytes,
        "a_bytes_ratio": round(a_bytes / native, 6),
        "converts": converts,
        "records": rec.program,
        "boundary": rec.boundary,
    }


# The golden-pinned fields of an entry.
_GOLDEN_FIELDS = ("census", "payload_bytes", "payload_total_bytes", "a_bytes",
                  "a_bytes_ratio")


def schedule_findings(cfg: AuditConfig, entry: dict, mesh, *, m: int = AUDIT_M,
                      k: int = AUDIT_K, dtype: str = AUDIT_DTYPE,
                      native_census: dict | None = None) -> list[Finding]:
    """The structural gates of one cell's entry (golden-independent)."""
    findings: list[Finding] = []
    where = f"<hlo:{cfg.key}>"
    exp_census, exp_payload = expected_schedule(cfg, mesh, m=m, dtype=dtype)
    hint = (f" — a staged overlap body must issue S={cfg.stages} chunked "
            "collectives (1/S of the un-staged bytes each), never a full-width one"
            if cfg.stages is not None else "")
    if entry["census"] != exp_census:
        findings.append(Finding(
            where, 0, "hlo-schedule",
            f"collective census {entry['census']} != structural expectation "
            f"{exp_census}{hint}"))
    elif entry["payload_bytes"] != exp_payload:
        findings.append(Finding(
            where, 0, "hlo-schedule",
            f"collective payload {entry['payload_bytes']} != structural "
            f"expectation {exp_payload}{hint}"))
    if cfg.stages is not None:
        for rec in entry["records"]:
            count = exp_census.get(rec.kind)
            chunk = exp_payload[rec.kind] // count if count else 0
            if rec.payload_bytes > chunk:
                findings.append(Finding(
                    where, 0, "hlo-overlap",
                    f"a full-width {rec.kind} ({rec.op} of {rec.payload_bytes} "
                    f"bytes a device, the chunk is {chunk}) inside overlap@"
                    f"{cfg.stages}: the staged pipeline re-serializes the "
                    "transfer it exists to hide"))
                break
    ceiling = STORAGE_BYTE_CEILING.get(cfg.storage)
    if ceiling is not None:
        import torch

        from ..ops.quantize import quantized_struct

        struct = quantized_struct(m, k, cfg.storage, getattr(torch, dtype),
                                  audit_block(cfg, mesh, k))
        if entry["a_bytes_ratio"] > ceiling:
            findings.append(Finding(
                where, 0, "hlo-storage-bytes",
                f"resident-A bytes are {entry['a_bytes_ratio']:.3f}x the native "
                f"stream, over the {cfg.storage} ceiling of {ceiling}x — the "
                "storage format is not shrinking the bytes it exists to shrink"))
        elif entry["a_bytes"] != struct.nbytes:
            findings.append(Finding(
                where, 0, "hlo-storage-bytes",
                f"resident-A bytes {entry['a_bytes']} != the {cfg.storage} "
                f"structure's {struct.nbytes} (a leaf is wider than its format)"))
        if native_census is not None and entry["census"] != native_census:
            findings.append(Finding(
                where, 0, "hlo-storage-census",
                f"quantized census {entry['census']} != the native "
                f"counterpart's {native_census}: the combine must run on the "
                "fp32 partials, never on the payload"))
    findings.extend(early_dequant_findings(cfg, entry["converts"], mesh,
                                           m=m, k=k, dtype=dtype))
    return findings


def reshard_audit_entry(rcfg: ReshardAuditConfig, mesh, *, m: int = AUDIT_M,
                        k: int = AUDIT_K, dtype: str = AUDIT_DTYPE,
                        seed: int = 0) -> dict:
    """Run one migration of a seeded A under the recorder."""
    import torch

    from ..models import get_strategy
    from ..parallel.mesh import CollectiveRecorder, shard, unshard
    from ..parallel.reshard import build_reshard

    device = mesh.devices[0]
    gen = torch.Generator(device=device).manual_seed(seed)
    a = torch.rand((m, k), generator=gen, device=device, dtype=getattr(torch, dtype))
    st = shard(a, get_strategy(rcfg.src).specs(mesh)[0], mesh)
    migrate = build_reshard(mesh, rcfg.src, rcfg.dst)
    with CollectiveRecorder() as rec:
        out = migrate(st)
    if not torch.equal(unshard(out), a):
        raise RuntimeError(f"{rcfg.key}: the migration changed A's values")
    census, payload = rec.census()
    return {"census": census, "payload_bytes": payload,
            "payload_total_bytes": sum(payload.values())}


def reshard_findings(rcfg: ReshardAuditConfig, entry: dict, mesh, *,
                     m: int = AUDIT_M, k: int = AUDIT_K,
                     dtype: str = AUDIT_DTYPE) -> list[Finding]:
    """No gather/reduce kind anywhere (a host round trip's signature), and
    census and payload exactly the formula's minimal program."""
    where = f"<hlo:{rcfg.key}>"
    exp_census, exp_payload = expected_reshard(rcfg, mesh, m=m, k=k, dtype=dtype)
    census = entry["census"]
    gatherish = sorted(set(census) - {"all-to-all", "collective-permute"})
    if gatherish:
        return [Finding(
            where, 0, "hlo-reshard-schedule",
            f"migration issues {gatherish} — a gather/reduce kind materializes "
            "more than the 1/p local shard somewhere, the signature of a host "
            f"round trip; the {rcfg.src}->{rcfg.dst} move must be the minimal "
            "all_to_all/ppermute program")]
    if census != exp_census:
        return [Finding(
            where, 0, "hlo-reshard-schedule",
            f"collective census {census} != structural expectation {exp_census} "
            "— a redundant (or missing) collective in the migration")]
    if entry["payload_bytes"] != exp_payload:
        return [Finding(
            where, 0, "hlo-reshard-schedule",
            f"collective payload {entry['payload_bytes']} != structural "
            f"expectation {exp_payload} — each step must move exactly the "
            "device's 1/p local shard")]
    return []


# ------------------------------------------------------------ solver audit
#
# The served solvers (solvers/ops.py) and the fused tier (ops/cuda_solver.py)
# run their loops as Python over the strategy's matvec program, so the port
# has no while op to count. A run records what a lowering would count:
# ``maxiter`` 0 runs everything outside the loop, ``maxiter`` 1 adds exactly
# one trip (records of the second run beyond the first's,
# ``engine/executables.py::trip_records``). A lowering holds each loop body
# once and calls one matvec program from it however often the body does, so
# the solver census counts each distinct collective of the trip once and each
# distinct collective outside the loop once (Lanczos's fixed depth is
# straight-line code in the port, as its maxiter is ignored). The output
# gather is kept apart, as in the matvec cells. The fused census counts
# every collective of the trip: its body has one hop.

SOLVER_AUDIT_N = 256
FUSED_SOLVER_AUDIT_N = 2048

_SOLVER_AUDIT_OPS = ("cg", "gmres", "power", "lanczos", "chebyshev")

# The ops whose loop the port runs on the device on one card; the others
# are host-stepped (a departure from the JAX package's while loops).
DEVICE_LOOP_SOLVERS = ("cg", "chebyshev")


class SolverAuditConfig(NamedTuple):
    """One audited served solver: an op around one strategy x combine
    matvec (``solvers/ops.py::build_solver``, what ``submit(op=...)``
    dispatches)."""

    op: str
    strategy: str
    combine: str

    @property
    def key(self) -> str:
        return f"{self.op}|{self.strategy}|{self.combine}"

    @property
    def matvec(self) -> AuditConfig:
        """The matvec cell whose collective kinds the solver's must equal."""
        return AuditConfig(self.strategy, self.combine)


SOLVER_AUDIT_CONFIGS: tuple[SolverAuditConfig, ...] = tuple(
    SolverAuditConfig(op, strategy, combine)
    for strategy, combine in (("rowwise", "gather"), ("colwise", "psum"),
                              ("blockwise", "gather"))
    for op in _SOLVER_AUDIT_OPS
)


class FusedSolverAuditConfig(NamedTuple):
    """One audited fused solve: a fixed-recurrence op on the fused tier
    (``build_solver(kernel="cuda_fused")``) at one strategy x canonical
    combine x resident storage."""

    op: str
    strategy: str
    combine: str
    storage: str = "native"

    @property
    def key(self) -> str:
        return f"{self.op}|{self.strategy}|{self.combine}|{self.storage}"


FUSED_SOLVER_AUDIT_CONFIGS: tuple[FusedSolverAuditConfig, ...] = tuple(
    FusedSolverAuditConfig(op, strategy, combine, storage)
    for op in ("cg", "chebyshev")
    for strategy, combine, storage in (("rowwise", "gather", "native"),
                                       ("colwise", "psum", "native"),
                                       ("colwise", "psum", "int8c"))
)

# What one trip of each canonical fused combine issues: one hop.
_FUSED_EXPECTED_CENSUS = {"gather": {"all-gather": 1}, "psum": {"all-reduce": 1}}

# The JAX package's jaxpr names of the fused hop, in the census's spelling.
FUSED_CENSUS_NAMES = {"all_gather": "all-gather", "psum": "all-reduce"}


class SpecAuditConfig(NamedTuple):
    """One audited speculative program: the int8c candidate and the
    acceptance check of one strategy x combine
    (``ops/speculative.py::build_speculative``)."""

    strategy: str
    combine: str

    @property
    def key(self) -> str:
        return f"speculate|{self.strategy}|{self.combine}"

    @property
    def counterpart(self) -> AuditConfig:
        """The int8c matvec cell whose schedule the program must keep."""
        return AuditConfig(self.strategy, self.combine, storage="int8c")


SPEC_AUDIT_CONFIGS: tuple[SpecAuditConfig, ...] = (
    SpecAuditConfig("rowwise", "gather"),
    SpecAuditConfig("colwise", "psum"),
    SpecAuditConfig("blockwise", "gather"),
)


def audit_probes() -> int:
    """The probe count an armed engine places (``probe_count`` at the
    eligibility floor)."""
    from ..ops.speculative import SPEC_RTOL_FLOOR, probe_count

    return probe_count(SPEC_RTOL_FLOOR)


def _census_of(records) -> tuple[dict[str, int], dict[str, int]]:
    census: dict[str, int] = {}
    payload: dict[str, int] = {}
    for r in records:
        census[r.kind] = census.get(r.kind, 0) + 1
        payload[r.kind] = payload.get(r.kind, 0) + r.payload_bytes
    return dict(sorted(census.items())), dict(sorted(payload.items()))


def _distinct(records) -> list:
    return list(dict.fromkeys(records))


def one_card_loop(op: str, strategy: str, combine: str, *, kernel: str = "cuda",
                  storage: str = "native") -> str:
    """The loop a build of the cell takes on a mesh of one CUDA device, as
    ``solvers/ops.py::solver_loop`` decides it; the build allocates
    nothing, so a CPU-only host can ask."""
    import torch

    from ..models import get_strategy
    from ..parallel.mesh import make_mesh
    from ..solvers import build_solver

    mesh = make_mesh(1, devices=[torch.device("cuda", 0)])
    return build_solver(op, get_strategy(strategy), mesh, dtype=torch.float32,
                        kernel=kernel, combine=combine,
                        dtype_storage=None if storage == "native" else storage).loop


def _solver_operand(n: int, device, seed: int):
    """A seeded SPD operand: a symmetric uniform matrix shifted by n·I."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    a = torch.rand((n, n), generator=gen, device=device, dtype=torch.float32)
    b = torch.rand((n,), generator=gen, device=device, dtype=torch.float32)
    return (a + a.T) / 2 + n * torch.eye(n, device=device), b


def _two_runs(fn, a, b, *, stand_in: bool = False, watch: bool = False) -> list:
    """``fn`` run with ``maxiter`` 0 and 1 under the recorder (and, with
    ``watch``, the low-bit conversion watch): ``[(recorder, converts)] * 2``."""
    from ..parallel.mesh import CollectiveRecorder

    runs = []
    for maxiter in (0, 1):
        with CollectiveRecorder(stand_in) as rec:
            if watch:
                with _ConvertWatch() as w:
                    fn(a, b, 1e-6, maxiter, 1.0, float(2 * b.shape[0]))
                converts = w.converts
            else:
                fn(a, b, 1e-6, maxiter, 1.0, float(2 * b.shape[0]))
                converts = []
        runs.append((rec, converts))
    return runs


def solver_audit_entry(scfg: SolverAuditConfig, mesh, *, seed: int = 0,
                       loop: str | None = None) -> dict:
    """One solver cell on ``mesh`` at :data:`SOLVER_AUDIT_N`: the census and
    payload bytes of its distinct collectives outside the loop and in one
    trip (the output gather apart), and ``loop``, what the cell's build
    takes on one card (:func:`one_card_loop`, unless given)."""
    from ..engine.executables import trip_records
    from ..models import get_strategy
    from ..solvers import build_solver

    strat = get_strategy(scfg.strategy)
    a, b = _solver_operand(SOLVER_AUDIT_N, mesh.devices[0], seed)
    fn = build_solver(scfg.op, strat, mesh, dtype=a.dtype, combine=scfg.combine)
    (rec0, _), (rec1, _) = _two_runs(fn, a, b)
    trip = trip_records(rec0.program, rec1.program)
    census, payload = _census_of(_distinct(trip) + _distinct(rec0.program))
    return {"census": census, "payload_bytes": payload,
            "loop": loop if loop is not None else one_card_loop(
                scfg.op, scfg.strategy, scfg.combine)}


def solver_findings(scfg: SolverAuditConfig, entry: dict, mesh) -> list[Finding]:
    """The structural gates of one solver entry: its collective kinds equal
    the matvec counterpart's (``hlo-solver-schedule``), and cg and
    chebyshev keep their loop on the device on one card
    (``hlo-solver-loop``)."""
    findings: list[Finding] = []
    exp_census, _ = expected_schedule(scfg.matvec, mesh, m=SOLVER_AUDIT_N)
    if set(entry["census"]) != set(exp_census):
        findings.append(Finding(
            f"<hlo:{scfg.key}>", 0, "hlo-solver-schedule",
            f"solver program's collective kinds {sorted(entry['census'])} != the "
            f"{scfg.strategy}|{scfg.combine} matvec counterpart's "
            f"{sorted(exp_census)} — the loop body issues collectives the audited "
            "matvec schedule does not (an un-staged gather or a stray reduction "
            "inside the iteration)"))
    if scfg.op in DEVICE_LOOP_SOLVERS and entry["loop"] != "device":
        findings.append(Finding(
            f"<hlo:{scfg.key}>", 0, "hlo-solver-loop",
            f"{scfg.op} takes the {entry['loop']} loop on one card: the iteration "
            "left the device (a host read per iteration re-dispatching matvecs, "
            "where solvers/device_loop.py reads once per chunk)"))
    return findings


def fused_operand(fcfg: FusedSolverAuditConfig, mesh, *, seed: int = 0):
    """The fused cell's placed operand at :data:`FUSED_SOLVER_AUDIT_N`
    (int8c quantized with the engine's block) and right-hand side."""
    from ..models import get_strategy
    from ..models.base import shard_operand
    from ..ops.quantize import default_block, quantize_matrix

    strat = get_strategy(fcfg.strategy)
    n = FUSED_SOLVER_AUDIT_N
    a, b = _solver_operand(n, mesh.devices[0], seed)
    if fcfg.storage != "native":
        a = quantize_matrix(a, fcfg.storage,
                            block=default_block(n, strat.contraction_shards(mesh)))
    return shard_operand(a, strat.specs(mesh)[0], mesh), b


def _fused_full_shapes(n: int, p: int) -> set:
    return {(n, n), (n // p, n), (n, n // p)}


def fused_solver_audit_entry(fcfg: FusedSolverAuditConfig, mesh, *, fn=None,
                             seed: int = 0) -> dict:
    """One fused cell: the recorder stands the kernels in (the wrappers
    are counted at their entry and compute nothing), and one trip gives
    ``steps`` (fused step calls a shard), ``gemv_calls`` (separate GEMV
    calls) and ``census`` (every collective of the trip); over the whole
    run, ``lowbit_shard_converts`` counts conversions of a full-width
    low-bit A to float outside the kernels. ``loop`` is what the cell's
    build takes on one card. ``fn`` passes a fused program in (the
    mutations)."""
    import torch

    from ..engine.executables import trip_records
    from ..models import get_strategy
    from ..solvers import build_solver

    a, b = fused_operand(fcfg, mesh, seed=seed)
    if fn is None:
        fn = build_solver(fcfg.op, get_strategy(fcfg.strategy), mesh, dtype=torch.float32,
                          kernel="cuda_fused", combine=fcfg.combine,
                          dtype_storage=None if fcfg.storage == "native" else fcfg.storage)
    (rec0, _), (rec1, converts) = _two_runs(fn, a, b, stand_in=True, watch=True)
    kernels = [c.name for c in trip_records(rec0.kernels, rec1.kernels)]
    census, _ = _census_of(trip_records(rec0.program, rec1.program))
    full = _fused_full_shapes(FUSED_SOLVER_AUDIT_N, mesh.size)
    steps, rest = divmod(kernels.count("solver_step"), mesh.size)
    return {
        "steps": steps if not rest else steps + rest / mesh.size,
        "gemv_calls": sum(k in ("gemv", "quant_gemv") for k in kernels),
        "census": census,
        "lowbit_shard_converts": sum(shape in full for shape, _, _ in converts),
        "loop": one_card_loop(fcfg.op, fcfg.strategy, fcfg.combine, kernel="cuda_fused",
                              storage=fcfg.storage),
    }


def fused_solver_findings(fcfg: FusedSolverAuditConfig, entry: dict) -> list[Finding]:
    """The structural gates of one fused entry (``hlo-fused-solver``, and
    ``hlo-early-dequant`` for a quantized cell)."""
    findings: list[Finding] = []
    where = f"<hlo:fused:{fcfg.key}>"
    if entry["steps"] != 1:
        findings.append(Finding(
            where, 0, "hlo-fused-solver",
            f"one iteration makes {entry['steps']} fused step calls a shard, "
            "expected exactly 1 — the tier's claim is the whole recurrence (the "
            "vector updates, the residual reduction and the next GEMV) in one "
            "solver_step call, so p, x and r never round-trip between launches"))
    if entry["gemv_calls"]:
        findings.append(Finding(
            where, 0, "hlo-fused-solver",
            f"one iteration makes {entry['gemv_calls']} separate GEMV calls beside "
            "the fused step: an unfused body pays the torch tier's launches while "
            "reporting the fused ExecKey"))
    expected = _FUSED_EXPECTED_CENSUS[fcfg.combine]
    if entry["census"] != expected:
        findings.append(Finding(
            where, 0, "hlo-fused-solver",
            f"one iteration's collective census {entry['census']} != the canonical "
            f"{fcfg.combine} combine's {expected} — a stray collective inside the "
            "loop multiplies per-iteration latency by its cost"))
    if fcfg.storage != "native" and entry["lowbit_shard_converts"]:
        findings.append(Finding(
            where, 0, "hlo-early-dequant",
            f"the quantized fused solve converts {entry['lowbit_shard_converts']} "
            "full-width low-bit A tensor(s) to float outside the kernels: the "
            "int8c-resident tier upcasts inside the step, a tile at a time"))
    return findings


class _HostReadWatch:
    """Counts host reads of a tensor's value (``aten._local_scalar_dense``:
    ``.item()``, ``bool()``, ``int()``, ``float()``) while entered."""

    def __init__(self):
        self.reads = 0
        self._mode = None

    def __enter__(self):
        import torch
        from torch.utils._python_dispatch import TorchDispatchMode

        watch = self
        read = torch.ops.aten._local_scalar_dense.default

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                if func is read:
                    watch.reads += 1
                return func(*args, **(kwargs or {}))

        self._mode = Mode()
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        self._mode.__exit__(*exc)


def spec_operands(scfg: SpecAuditConfig, mesh, *, seed: int = 0):
    """The armed engine's operands at ``AUDIT_M x AUDIT_K`` fp32, placed on
    ``mesh``: the int8c payload, P = U A, U, x and a float32 tolerance."""
    import torch

    from ..models import get_strategy
    from ..models.base import shard_operand
    from ..ops.quantize import quantize_matrix
    from ..ops.speculative import probe_matrix, probe_spec, project_probes
    from ..parallel.mesh import shard

    strat = get_strategy(scfg.strategy)
    device = mesh.devices[0]
    gen = torch.Generator(device=device).manual_seed(seed)
    a = torch.rand((AUDIT_M, AUDIT_K), generator=gen, device=device)
    x = torch.rand((AUDIT_K,), generator=gen, device=device)
    s = audit_probes()
    u = probe_matrix(s, AUDIT_M, torch.float32).to(device)
    aq = quantize_matrix(a, "int8c", block=audit_block(scfg.counterpart, mesh))
    spec_a, spec_x, _ = strat.specs(mesh)
    return (shard_operand(aq, spec_a, mesh),
            shard(project_probes(u, a, device=device), probe_spec(strat, mesh), mesh),
            u, shard(x, spec_x, mesh), torch.tensor(1e-3, dtype=torch.float32,
                                                    device=device))


def spec_audit_entry(scfg: SpecAuditConfig, mesh, *, seed: int = 0) -> dict:
    """One speculative cell, its second run watched (the first fills the
    caches a warm-up fills): the census and payload bytes (the output
    gather apart), the probes, the verdict's dtype and the host reads the
    program made (the port's reading of the JAX gate's i1 output: the
    verdict leaves as a device bool, read by nobody inside)."""
    from ..models import get_strategy
    from ..ops.speculative import build_speculative
    from ..parallel.mesh import CollectiveRecorder

    fn = build_speculative(get_strategy(scfg.strategy), mesh, probes=audit_probes(),
                           combine=scfg.combine, storage="int8c")
    operands = spec_operands(scfg, mesh, seed=seed)
    fn(*operands)  # the warm run fills the per-dtype scale cache, as the engine's warm-up does
    with CollectiveRecorder() as rec, _HostReadWatch() as watch:
        _, _, accept = fn(*operands)
    census, payload = rec.census()
    return {"census": census, "payload_bytes": payload, "probes": audit_probes(),
            "verdict_dtype": str(accept.dtype).removeprefix("torch."),
            "host_reads": watch.reads}


def spec_findings(scfg: SpecAuditConfig, entry: dict, mesh) -> list[Finding]:
    """The structural gates of one speculative entry: the counterpart's
    schedule survives, the check adds at most one all-reduce of at most
    ``probes x 4`` bytes (``hlo-spec-schedule``), and the verdict is a
    device bool nobody reads inside the program (``hlo-spec-host-sync``)."""
    findings: list[Finding] = []
    where = f"<hlo:{scfg.key}>"
    exp_census, exp_payload = expected_schedule(scfg.counterpart, mesh)
    census, payload = entry["census"], entry["payload_bytes"]
    missing = {k: n for k, n in exp_census.items() if census.get(k, 0) < n}
    extra = {k: census[k] - exp_census.get(k, 0) for k in census
             if census[k] > exp_census.get(k, 0)}
    if missing:
        findings.append(Finding(
            where, 0, "hlo-spec-schedule",
            f"the speculative program lost collectives {missing} from its "
            f"{scfg.counterpart.key} counterpart's schedule {exp_census} — the "
            "candidate no longer runs the audited combine"))
    if set(extra) - {"all-reduce"} or sum(extra.values()) > 1:
        findings.append(Finding(
            where, 0, "hlo-spec-schedule",
            f"the acceptance check added {extra} beyond the {scfg.counterpart.key} "
            "counterpart's schedule — the check costs at most one extra reduction "
            "(the sum of s probe scalars; rowwise adds none)"))
    ceiling = entry["probes"] * dtype_itemsize(AUDIT_DTYPE)
    extra_bytes = payload.get("all-reduce", 0) - exp_payload.get("all-reduce", 0)
    if extra.get("all-reduce") and extra_bytes > ceiling:
        findings.append(Finding(
            where, 0, "hlo-spec-schedule",
            f"the check's extra all-reduce moves {extra_bytes} bytes, over the "
            f"{ceiling}-byte probe-vector ceiling ({entry['probes']} probes x "
            f"{dtype_itemsize(AUDIT_DTYPE)} B) — a full-width collective in the check "
            "spends the bandwidth the speculation exists to save"))
    if entry["verdict_dtype"] != "bool" or entry["host_reads"]:
        findings.append(Finding(
            where, 0, "hlo-spec-host-sync",
            f"the verdict leaves as {entry['verdict_dtype']} after "
            f"{entry['host_reads']} host read(s) inside the program: the "
            "accept/escalate decision must stay a device bool until "
            "MatvecFuture.result() reads it"))
    return findings


def solver_coverage_findings() -> list[Finding]:
    """``hlo-solver-coverage``: every op of ``solvers/ops.py::SOLVER_OPS``
    has audit cells, so a new op cannot ship unpinned."""
    from ..solvers import ops

    missing = sorted(set(ops.SOLVER_OPS) - {c.op for c in SOLVER_AUDIT_CONFIGS})
    return [Finding(
        "<hlo:solvers>", 0, "hlo-solver-coverage",
        f"served solver ops {missing} have no audit cells; extend "
        "SOLVER_AUDIT_CONFIGS and bless the golden table")] if missing else []


def solver_fingerprint_findings(configs, mesh) -> list[Finding]:
    """``hlo-fingerprint`` over the traced solver, speculative and
    ``pallas_ring`` keys: two fresh traces of one key fingerprint equal,
    and keys that differ in op or combine fingerprint differently."""
    import torch

    from ..engine.executables import (
        ExecKey, build_fingerprint, trace_program, trace_solver, trace_speculative)
    from ..models import get_strategy
    from ..parallel.mesh import make_1d_mesh

    def solver_fp(op, strategy, combine, kernel="cuda"):
        trace = trace_solver(get_strategy(strategy), mesh, op=op, kernel=kernel,
                             combine=combine, stages=None, storage="native",
                             a_shape=(SOLVER_AUDIT_N,) * 2, dtype=torch.float32,
                             restart=10, steps=32)
        key = ExecKey(op, strategy, kernel, combine, 1, AUDIT_DTYPE)
        return key, build_fingerprint(key, trace["schedule"], trace["local_shapes"],
                                      trace["routes"], loop=trace["loop"])

    def spec_fp(strategy, combine):
        cfg = SpecAuditConfig(strategy, combine)
        trace = trace_speculative(get_strategy(strategy), mesh, kernel="cuda",
                                  combine=combine, gather_output=True,
                                  a_shape=(AUDIT_M, AUDIT_K), dtype=torch.float32,
                                  probes=audit_probes(), bucket=None,
                                  block=audit_block(cfg.counterpart, mesh))
        key = ExecKey("matvec", strategy, "cuda", combine, 1, AUDIT_DTYPE, "speculate")
        return key, build_fingerprint(key, trace["schedule"], trace["local_shapes"],
                                      trace["routes"])

    ring_mesh = make_1d_mesh(AUDIT_DEVICES, devices=[torch.device("cpu")] * AUDIT_DEVICES)

    def ring_fp(combine):
        trace = trace_program(get_strategy("colwise"), ring_mesh, batched=False,
                              kernel="cuda", combine=combine, stages=None,
                              gather_output=True, storage="native",
                              a_shape=(AUDIT_M, AUDIT_K), dtype=torch.float32)
        key = ExecKey("matvec", "colwise", "cuda", combine, 1, AUDIT_DTYPE)
        return key, build_fingerprint(key, trace["schedule"], trace["local_shapes"],
                                      trace["routes"])

    makers = [lambda c=c: solver_fp(c.op, c.strategy, c.combine) for c in configs]
    makers += [lambda c=c: solver_fp(c.op, c.strategy, c.combine, "cuda_fused")
               for c in FUSED_SOLVER_AUDIT_CONFIGS if c.storage == "native"]
    makers += [lambda c=c: spec_fp(c.strategy, c.combine) for c in SPEC_AUDIT_CONFIGS]
    makers += [lambda c=c: ring_fp(c) for c in ("pallas_ring", "psum")]
    findings: list[Finding] = []
    seen: dict[str, str] = {}
    for make in makers:
        (key, fp_a), (_, fp_b) = make(), make()
        if fp_a != fp_b:
            findings.append(Finding(
                f"<hlo:{key.label()}>", 0, "hlo-fingerprint",
                f"two fresh traces of ExecKey {key.label()} fingerprint differently "
                f"({fp_a[:12]} vs {fp_b[:12]}): the engine's cache would hold two "
                "programs for one key"))
        other = seen.setdefault(fp_a, key.label())
        if other != key.label():
            findings.append(Finding(
                f"<hlo:{key.label()}>", 0, "hlo-fingerprint",
                f"ExecKeys {other} and {key.label()} fingerprint the same: the "
                "trace does not see what sets them apart"))
    return findings


def golden_path() -> Path:
    return Path(__file__).resolve().parent / GOLDEN_NAME


def build_schedule_table(configs: Iterable[AuditConfig] | None = None,
                         reshard_configs: Iterable[ReshardAuditConfig] | None = None,
                         mesh=None) -> dict:
    """The golden table's payload for the current tree: the matvec cells,
    the served solvers, the fused solves, the speculative programs and the
    migrations (schema 2)."""
    import torch

    mesh = mesh if mesh is not None else audit_mesh()
    configs = supported_configs(configs or AUDIT_CONFIGS)
    entries = {}
    for cfg in configs:
        entry = audit_entry(cfg, mesh)
        entries[cfg.key] = {f: entry[f] for f in _GOLDEN_FIELDS}
    reshards = {r.key: reshard_audit_entry(r, mesh)
                for r in (reshard_configs or RESHARD_AUDIT_CONFIGS)}
    return {
        "schema": GOLDEN_SCHEMA,
        "mesh": {"devices": mesh.size, "grid": list(mesh.grid)},
        "operand": {"m": AUDIT_M, "k": AUDIT_K, "dtype": AUDIT_DTYPE},
        "solver_operand": {"n": SOLVER_AUDIT_N, "dtype": AUDIT_DTYPE},
        "fused_solver_operand": {"n": FUSED_SOLVER_AUDIT_N, "dtype": AUDIT_DTYPE},
        "torch_version_at_capture": torch.__version__,
        "configs": entries,
        "solvers": {c.key: solver_audit_entry(c, mesh) for c in SOLVER_AUDIT_CONFIGS},
        "fused_solvers": {c.key: fused_solver_audit_entry(c, mesh)
                          for c in FUSED_SOLVER_AUDIT_CONFIGS},
        "speculative": {c.key: spec_audit_entry(c, mesh) for c in SPEC_AUDIT_CONFIGS},
        "reshards": reshards,
    }


def write_golden(path: Path | None = None) -> Path:
    """Bless the current census as the golden table."""
    path = Path(path) if path is not None else golden_path()
    path.write_text(json.dumps(build_schedule_table(), indent=2) + "\n")
    return path


def run_hlo_audit(
    golden: Path | None = None,
    configs: Iterable[AuditConfig] | None = None,
    reshard_configs: Iterable[ReshardAuditConfig] | None = None,
    *,
    solver_configs: Iterable[SolverAuditConfig] | None = None,
    fused_solver_configs: Iterable[FusedSolverAuditConfig] | None = None,
    spec_configs: Iterable[SpecAuditConfig] | None = None,
    check_fingerprints: bool = True,
    kernel=None,
    mesh=None,
) -> list[Finding]:
    """The whole census audit on 8 logical CPU shards: every cell's
    structural, storage, early-dequant and fingerprint gates, every
    migration's, every served solver's, fused solve's and speculative
    program's, and the golden table over whichever cells ran (a narrowed
    run, which names some of the families, runs and compares only those).
    ``kernel`` overrides every matvec cell's local kernel (the
    dequant-first mutation). Empty means clean."""
    golden = Path(golden) if golden is not None else golden_path()
    mesh = mesh if mesh is not None else audit_mesh()
    full_run = (configs is None and reshard_configs is None and solver_configs is None
                and fused_solver_configs is None and spec_configs is None)

    def family(given, default):
        return tuple(default if given is None and full_run else given or ())

    configs = supported_configs(family(configs, AUDIT_CONFIGS))
    reshard_configs = family(reshard_configs, RESHARD_AUDIT_CONFIGS)
    solver_configs = family(solver_configs, SOLVER_AUDIT_CONFIGS)
    fused_solver_configs = family(fused_solver_configs, FUSED_SOLVER_AUDIT_CONFIGS)
    spec_configs = family(spec_configs, SPEC_AUDIT_CONFIGS)
    findings: list[Finding] = []
    pinned: dict = {}
    pinned_reshards: dict = {}
    if golden.is_file():
        table = json.loads(golden.read_text())
        if table.get("schema") != GOLDEN_SCHEMA:
            findings.append(Finding(
                GOLDEN_NAME, 0, "hlo-golden",
                f"golden schema {table.get('schema')!r} != {GOLDEN_SCHEMA}; "
                "regenerate with --write-golden"))
        pinned = table.get("configs", {})
        pinned_reshards = table.get("reshards", {})
        have_golden = True
    else:
        table = {}
        findings.append(Finding(
            GOLDEN_NAME, 0, "hlo-golden",
            "golden collective-schedule table missing; generate it with "
            "`python -m matvec_mpi_multiplier_torch.staticcheck --write-golden`"))
        have_golden = False
    native_census: dict[str, dict] = {}
    for cfg in sorted(configs, key=lambda c: c.storage != "native"):
        entry = audit_entry(cfg, mesh, kernel=kernel)
        base = native_counterpart(cfg)
        if cfg.storage == "native":
            native_census[cfg.key] = entry["census"]
        elif base.key not in native_census:
            native_census[base.key] = audit_entry(base, mesh)["census"]
        findings.extend(schedule_findings(
            cfg, entry, mesh, native_census=native_census.get(base.key)))
        if check_fingerprints:
            fp_a, fp_b = config_fingerprint(cfg, mesh), config_fingerprint(cfg, mesh)
            if fp_a != fp_b:
                findings.append(Finding(
                    f"<hlo:{cfg.key}>", 0, "hlo-fingerprint",
                    f"two fresh builds of ExecKey {exec_key(cfg).label()} "
                    f"fingerprint differently ({fp_a[:12]} vs {fp_b[:12]}): the "
                    "engine's cache would hold two programs for one key"))
        if have_golden:
            observed = {f: entry[f] for f in _GOLDEN_FIELDS}
            want = pinned.get(cfg.key)
            if want is None:
                findings.append(Finding(
                    GOLDEN_NAME, 0, "hlo-golden",
                    f"config {cfg.key} missing from the golden table; bless it "
                    "with --write-golden"))
            elif want != observed:
                findings.append(Finding(
                    GOLDEN_NAME, 0, "hlo-census",
                    f"{cfg.key}: the program issues {observed} != golden {want}; "
                    "if the change is deliberate, bless it with --write-golden"))
    for rcfg in reshard_configs:
        entry = reshard_audit_entry(rcfg, mesh)
        findings.extend(reshard_findings(rcfg, entry, mesh))
        if have_golden:
            want = pinned_reshards.get(rcfg.key)
            if want is None:
                findings.append(Finding(
                    GOLDEN_NAME, 0, "hlo-golden",
                    f"reshard config {rcfg.key} missing from the golden table"))
            elif want != entry:
                findings.append(Finding(
                    GOLDEN_NAME, 0, "hlo-census",
                    f"{rcfg.key}: the migration issues {entry} != golden {want}"))
    layers = (
        ("solvers", "solver", solver_configs, SOLVER_AUDIT_CONFIGS,
         lambda c: solver_audit_entry(c, mesh), lambda c, e: solver_findings(c, e, mesh)),
        ("fused_solvers", "fused solver", fused_solver_configs,
         FUSED_SOLVER_AUDIT_CONFIGS, lambda c: fused_solver_audit_entry(c, mesh),
         fused_solver_findings),
        ("speculative", "speculative", spec_configs, SPEC_AUDIT_CONFIGS,
         lambda c: spec_audit_entry(c, mesh), lambda c, e: spec_findings(c, e, mesh)),
    )
    if full_run:
        findings.extend(solver_coverage_findings())
    for section, label, cells, every, entry_of, gates in layers:
        pinned_section = table.get(section, {})
        for cfg in cells:
            entry = entry_of(cfg)
            findings.extend(gates(cfg, entry))
            if not have_golden:
                continue
            want = pinned_section.get(cfg.key)
            if want is None:
                findings.append(Finding(
                    GOLDEN_NAME, 0, "hlo-golden",
                    f"{label} config {cfg.key} missing from the golden table; bless "
                    "it with --write-golden"))
            elif want != entry:
                findings.append(Finding(
                    GOLDEN_NAME, 0, "hlo-census",
                    f"{cfg.key}: the {label} program issues {entry} != golden {want}; "
                    "if the change is deliberate, bless it with --write-golden"))
        if have_golden and full_run:
            for stale in sorted(set(pinned_section) - {c.key for c in every}):
                findings.append(Finding(
                    GOLDEN_NAME, 0, "hlo-golden",
                    f"golden table pins unknown {label} config {stale}; regenerate "
                    "with --write-golden"))
    if check_fingerprints and (solver_configs or spec_configs or full_run):
        findings.extend(solver_fingerprint_findings(solver_configs, mesh))
    if have_golden and full_run:
        for stale in sorted(set(pinned) - {c.key for c in AUDIT_CONFIGS}):
            findings.append(Finding(
                GOLDEN_NAME, 0, "hlo-golden",
                f"golden table pins unknown config {stale}; regenerate with "
                "--write-golden"))
    return dedup(findings)
