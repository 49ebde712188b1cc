"""The static ExecKey-space audit: the engine's compile surface, enumerated.

The port's counterpart of the JAX package's ``staticcheck/keyspace.py``,
with the port's tier names (``torch`` and ``cuda`` where the JAX package
says ``xla`` and ``pallas``; the solver tiers ``torch`` and ``cuda_fused``).
The serving claims rest on the zero-steady-rebuild doctrine
(``compiles_steady == 0``: no build or capture after warmup); this layer
makes the build surface a static artifact, enumerable per configuration.

For each pinned serve configuration (:data:`KEYSPACE_CONFIGS`) the
enumerator walks the engine's actual construction rules symbolically —
bucket ladder × kernel/combine/stages × dtype_storage (including
``speculate``'s two-tier keys) × solver ops/buckets × degradation-ladder
tiers × reshard destinations — and emits the exact finite set of
compilable :class:`~..engine.executables.ExecKey` labels, classified by
WHEN each may compile:

- ``warmup``  — what ``MatvecEngine.warmup()`` compiles (modelled from
  the warmup enumeration: full ladder, or the buckets declared
  ``warm_widths`` route to) plus each declared solver op's preferred
  key (compiled in the serve warm phase by doctrine).
- ``steady``  — what healthy-path request routing can reach, computed by
  *evaluating the routing* (``bucket_for`` over every reachable chunk
  width) — a genuinely different derivation from the warmup model, so
  ``steady ⊆ warmup`` is a checkable invariant, not a tautology.
- ``fault_only`` — degradation-ladder safe tiers, reachable only after a
  breaker trips. Bucket-halving re-enters the ladder at ladder buckets,
  so it adds no keys beyond these.
- ``rollover`` — keys an online ``reshard()`` to a declared destination
  would compile in its one-time post-swap warmup (off the request path).

The table is golden-pinned (``golden_keyspace.json`` beside this module,
blessed via ``--keyspace --write-golden``): a code change that silently widens the
key space shows up as ``keyspace-golden`` drift, and a change that makes
a steady path reach an un-warmed key is a hard ``keyspace-steady-unwarmed``
error — the static proof of the compile budget
("warmup covers K of N; steady-reachable beyond warmup = 0").

The live half is ``MatvecEngine.exec_keyspace()``, built from the engine's
own key constructors, which the tests hold this enumeration against, and
``chip_smoke.py`` section 49 ties the static claim to the card: live
engines warm up, serve a steady stream, build nothing more, and build
exactly the enumerated warmup class.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

from ..engine.buckets import bucket_for, bucket_ladder, split_widths
from ..engine.core import SAFE_KERNEL, SPECULATE
from ..engine.executables import ExecKey
from ..models.base import STORAGE_INCOMPATIBLE_COMBINES
from ..ops.cuda_solver import _FUSED_COMBINES, FUSED_SOLVER_OPS
from ..ops.quantize import NATIVE
from ..solvers.ops import (
    DEFAULT_RESTART,
    DEFAULT_STEPS,
    SOLVER_OPS,
    solver_bucket,
)
from .findings import Finding

# Golden name (beside this module) + schema version: bump the schema when
# the table's SHAPE changes (new class, new budget field), re-bless when its
# CONTENT legitimately changes (a new config, a deliberate keyspace change).
GOLDEN_REL = "golden_keyspace.json"
KEYSPACE_SCHEMA = 1

_STRATEGIES = ("rowwise", "colwise", "blockwise")


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """One pinned serve configuration — the symbolic mirror of a
    ``MatvecEngine(...)`` construction. Only knobs that mint ExecKeys
    appear; dynamic knobs (rtol, maxiter, interval, window) do not
    exist here because they never mint keys — that absence IS part of
    the audited claim."""

    name: str
    strategy: str
    kernel: str = "torch"
    combine: str | None = None
    stages: int | None = None
    dtype: str = "float32"
    # "native" | "int8" | "int8c" | "fp8" | "speculate"
    dtype_storage: str = NATIVE
    promote: int | None = 8          # b_star; None = per-column only
    max_bucket: int = 32
    warm_widths: tuple[int, ...] | None = None
    solver_ops: tuple[str, ...] = ()
    solver_kernel: str = "torch"     # "torch" | "cuda_fused"
    restart: int = DEFAULT_RESTART
    steps: int = DEFAULT_STEPS
    reshard_to: tuple[str, ...] = ()


@dataclasses.dataclass(frozen=True)
class KeySpace:
    """The enumerated compile surface of one :class:`ServeConfig`."""

    warmup: tuple[str, ...]
    steady: tuple[str, ...]
    fault_only: tuple[str, ...]
    rollover: tuple[str, ...]
    budget: dict


def _validate(cfg: ServeConfig) -> None:
    if cfg.strategy not in _STRATEGIES:
        raise ValueError(f"{cfg.name}: unknown strategy {cfg.strategy!r}")
    for op in cfg.solver_ops:
        if op not in SOLVER_OPS:
            raise ValueError(f"{cfg.name}: unknown solver op {op!r}")
    if cfg.solver_kernel == "cuda_fused":
        if cfg.strategy not in _FUSED_COMBINES:
            raise ValueError(
                f"{cfg.name}: cuda_fused has no {cfg.strategy} spelling"
            )
        bad = [op for op in cfg.solver_ops if op not in FUSED_SOLVER_OPS]
        if bad:
            raise ValueError(
                f"{cfg.name}: cuda_fused serves {FUSED_SOLVER_OPS}, "
                f"config declares {bad}"
            )
    for dst in cfg.reshard_to:
        if dst not in _STRATEGIES:
            raise ValueError(f"{cfg.name}: unknown reshard dst {dst!r}")
    if cfg.reshard_to and (
        cfg.combine is not None
        or cfg.stages is not None
        or cfg.solver_kernel != "torch"
    ):
        # Reshard re-validates combine/stages/fused-tier against the
        # destination; the symbolic model covers the conservative
        # combine=None path — declare richer reshard configs only once
        # the model grows the per-destination re-resolution.
        raise ValueError(
            f"{cfg.name}: reshard_to modelling requires combine=None, "
            f"stages=None, solver_kernel='torch'"
        )
    if cfg.promote is not None and cfg.promote < 1:
        raise ValueError(f"{cfg.name}: promote must be >= 1")


def _resolved_storage(cfg: ServeConfig) -> tuple[str, bool]:
    """Mirror the engine's storage resolution: ``"speculate"`` arms the
    two-tier path with NATIVE primary residency; everything else is the
    declared format."""
    if cfg.dtype_storage == SPECULATE:
        return NATIVE, True
    return cfg.dtype_storage, False


def _primary_combine(cfg: ServeConfig, storage: str) -> str | None:
    """Mirror construction: quantized residency drops A-tiling combines
    (STORAGE_INCOMPATIBLE_COMBINES) to the strategy default."""
    if storage != NATIVE and cfg.combine in STORAGE_INCOMPATIBLE_COMBINES:
        return None
    return cfg.combine


def _combine_label(cfg: ServeConfig, combine: str | None) -> str | None:
    """Mirror ``_combine_label``: staged overlap schedules embed their
    pinned S (``overlap@4``) in the cache identity."""
    if (
        cfg.stages is not None
        and combine is not None
        and combine.startswith("overlap")
    ):
        return f"{combine}@{cfg.stages}"
    return combine


def _spec_combine(combine: str | None) -> str | None:
    """Mirror ``_spec_combine``: the fused speculative program cannot
    run A-tiling schedules — those degrade to the static default."""
    return None if combine in STORAGE_INCOMPATIBLE_COMBINES else combine


def _warm_buckets(cfg: ServeConfig) -> set[int]:
    """The GEMM buckets ``warmup()`` compiles — the warmup enumeration:
    the whole ladder when no widths were declared (any split remainder
    can land on any bucket), else exactly the buckets declared widths
    route to (sub-``b*`` widths ride per-column and warm no bucket)."""
    if cfg.promote is None:
        return set()
    if cfg.warm_widths is None:
        return set(bucket_ladder(cfg.max_bucket))
    buckets: set[int] = set()
    for w in cfg.warm_widths:
        if w < cfg.promote:
            continue
        for chunk in split_widths(w, cfg.max_bucket):
            buckets.add(bucket_for(chunk, cfg.max_bucket))
    return buckets


def _steady_buckets(cfg: ServeConfig) -> set[int]:
    """The GEMM buckets healthy-path routing can reach, by EVALUATING
    the routing: an unconstrained stream splits any promoted request
    into max_bucket chunks plus one remainder, so every width in
    1..max_bucket is a reachable chunk; a declared-widths stream routes
    exactly those widths through ``submit()``'s promote/split rules."""
    if cfg.promote is None:
        return set()
    if cfg.warm_widths is None:
        return {
            bucket_for(w, cfg.max_bucket)
            for w in range(1, cfg.max_bucket + 1)
        }
    buckets: set[int] = set()
    for w in cfg.warm_widths:
        if w < cfg.promote:
            continue  # per-column path: rides the warmed matvec key
        for chunk in split_widths(w, cfg.max_bucket):
            buckets.add(bucket_for(chunk, cfg.max_bucket))
    return buckets


def enumerate_keyspace(cfg: ServeConfig) -> KeySpace:
    """Symbolically enumerate one config's finite compile surface."""
    _validate(cfg)
    storage, speculative = _resolved_storage(cfg)
    combine = _primary_combine(cfg, storage)
    label = _combine_label(cfg, combine)

    def matvec_key() -> ExecKey:
        return ExecKey(
            "matvec", cfg.strategy, cfg.kernel, label, 1, cfg.dtype, storage
        )

    def gemm_key(bucket: int) -> ExecKey:
        return ExecKey(
            "gemm", cfg.strategy, cfg.kernel, label, bucket, cfg.dtype,
            storage,
        )

    def spec_key(op: str, bucket: int) -> ExecKey:
        return ExecKey(
            op, cfg.strategy, cfg.kernel, _spec_combine(combine), bucket,
            cfg.dtype, SPECULATE,
        )

    def solver_key(op: str) -> ExecKey:
        bucket = solver_bucket(op, restart=cfg.restart, steps=cfg.steps)
        if cfg.solver_kernel == "cuda_fused" and op in FUSED_SOLVER_OPS:
            return ExecKey(
                op, cfg.strategy, "cuda_fused",
                _FUSED_COMBINES[cfg.strategy], bucket, cfg.dtype, storage,
            )
        return ExecKey(
            op, cfg.strategy, cfg.kernel, label, bucket, cfg.dtype, storage
        )

    def safe_key(op: str, bucket: int) -> ExecKey:
        return ExecKey(
            op, cfg.strategy, SAFE_KERNEL, None, bucket, cfg.dtype, NATIVE
        )

    warm: set[ExecKey] = {matvec_key()}
    if speculative:
        warm.add(spec_key("matvec", 1))
    for bucket in _warm_buckets(cfg):
        warm.add(gemm_key(bucket))
        if speculative:
            warm.add(spec_key("gemm", bucket))

    steady: set[ExecKey] = {matvec_key()}
    if speculative:
        steady.add(spec_key("matvec", 1))
    for bucket in _steady_buckets(cfg):
        steady.add(gemm_key(bucket))
        if speculative:
            steady.add(spec_key("gemm", bucket))

    fault: set[ExecKey] = set()
    mv_safe = safe_key("matvec", 1)
    if mv_safe != matvec_key():
        fault.add(mv_safe)
    if cfg.promote is not None:
        for bucket in bucket_ladder(cfg.max_bucket):
            g_safe = safe_key("gemm", bucket)
            if g_safe != gemm_key(bucket):
                fault.add(g_safe)

    for op in cfg.solver_ops:
        preferred = solver_key(op)
        warm.add(preferred)
        steady.add(preferred)
        s_safe = safe_key(op, preferred.bucket)
        if s_safe != preferred:
            fault.add(s_safe)

    warm_labels = {k.label() for k in warm}
    steady_labels = {k.label() for k in steady}
    fault_labels = {k.label() for k in fault}
    rollover_labels: set[str] = set()
    steady_beyond = len(steady_labels - warm_labels)
    for dst in cfg.reshard_to:
        dst_cfg = dataclasses.replace(
            cfg, name=f"{cfg.name}->{dst}", strategy=dst, reshard_to=()
        )
        dst_space = enumerate_keyspace(dst_cfg)
        # The destination's one-time post-swap warmup is the rollover
        # compile class; its own steady ⊆ warmup violations roll up into
        # the parent budget so a resharded-into config cannot hide one.
        rollover_labels.update(dst_space.warmup)
        fault_labels.update(dst_space.fault_only)
        steady_beyond += dst_space.budget["steady_beyond_warmup"]

    fault_labels -= warm_labels | steady_labels
    rollover_labels -= warm_labels | steady_labels
    total = len(
        warm_labels | steady_labels | fault_labels | rollover_labels
    )
    return KeySpace(
        warmup=tuple(sorted(warm_labels)),
        steady=tuple(sorted(steady_labels)),
        fault_only=tuple(sorted(fault_labels)),
        rollover=tuple(sorted(rollover_labels)),
        budget={
            "total": total,
            "warmup": len(warm_labels),
            "steady_beyond_warmup": steady_beyond,
        },
    )


# The pinned serve configurations the golden covers, the JAX package's: one
# per build-surface family (plain ladders per strategy, staged overlap,
# quantized residency, the speculative two-tier space, the unfused and
# fused solver tiers, and an online-reshard pair). Adding a config
# here widens the audited surface; the golden must be re-blessed.
KEYSPACE_CONFIGS: tuple[ServeConfig, ...] = (
    ServeConfig(name="rowwise_serve", strategy="rowwise"),
    ServeConfig(
        name="colwise_overlap", strategy="colwise", combine="overlap",
        stages=2,
    ),
    ServeConfig(
        name="blockwise_serve", strategy="blockwise", promote=4,
        max_bucket=16,
    ),
    ServeConfig(
        name="rowwise_int8c", strategy="rowwise", dtype_storage="int8c"
    ),
    ServeConfig(
        name="rowwise_speculate", strategy="rowwise",
        dtype_storage="speculate",
    ),
    ServeConfig(
        name="rowwise_solvers", strategy="rowwise", promote=None,
        solver_ops=SOLVER_OPS,
    ),
    ServeConfig(
        name="rowwise_fused_solvers", strategy="rowwise", promote=None,
        solver_ops=FUSED_SOLVER_OPS, solver_kernel="cuda_fused",
    ),
    ServeConfig(
        name="rowwise_reshard", strategy="rowwise",
        warm_widths=(1, 8, 32), reshard_to=("colwise", "blockwise"),
    ),
)


def keyspace_table(
    configs: tuple[ServeConfig, ...] = KEYSPACE_CONFIGS,
) -> dict:
    """The full audit artifact: every pinned config's enumerated surface
    plus its compile budget, in the golden's JSON shape."""
    table: dict = {"schema": KEYSPACE_SCHEMA, "configs": {}}
    for cfg in configs:
        space = enumerate_keyspace(cfg)
        serve = dataclasses.asdict(cfg)
        serve.pop("name")
        table["configs"][cfg.name] = {
            "serve": serve,
            "warmup": list(space.warmup),
            "steady": list(space.steady),
            "fault_only": list(space.fault_only),
            "rollover": list(space.rollover),
            "budget": dict(space.budget),
        }
    return table


def golden_path(root: str | Path | None = None) -> Path:
    """The golden table: beside this module, or under ``root``."""
    base = Path(root) if root is not None else Path(__file__).resolve().parent
    return base / GOLDEN_REL


def load_golden(root: str | Path | None = None) -> dict | None:
    path = golden_path(root)
    if not path.exists():
        return None
    return json.loads(path.read_text())


def write_golden_keyspace(root: str | Path | None = None) -> Path:
    """Bless the current enumeration as the golden (the ``--write-golden
    --keyspace`` flow). Refuses to bless a table that violates the
    compile budget — a broken invariant must be fixed, never pinned."""
    table = keyspace_table()
    hard = [f for f in _audit_budget(table) if f.severity != "drift"]
    if hard:
        raise ValueError(
            "refusing to bless a keyspace that violates the compile "
            f"budget: {[f.message for f in hard]}"
        )
    path = golden_path(root)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(table, indent=2, sort_keys=True) + "\n")
    return path


def _canon(value):
    """JSON-canonical form (tuples become lists) so a freshly enumerated
    table compares equal to its round-tripped golden."""
    return json.loads(json.dumps(value, sort_keys=True))


def _audit_budget(table: dict) -> list[Finding]:
    """The hard half of the audit: per config, every steady-reachable
    key must be covered by warmup — the static ``compiles_steady == 0``
    proof. Independent of any golden."""
    findings: list[Finding] = []
    for name, entry in sorted(table.get("configs", {}).items()):
        beyond = sorted(set(entry["steady"]) - set(entry["warmup"]))
        if beyond:
            findings.append(Finding(
                GOLDEN_REL, 0, "keyspace-steady-unwarmed",
                f"config {name}: steady routing reaches "
                f"{len(beyond)} key(s) warmup never compiles: "
                + ", ".join(beyond[:4])
                + ("..." if len(beyond) > 4 else ""),
            ))
        declared = entry["budget"].get("steady_beyond_warmup")
        if declared != len(beyond) and not entry.get("rollover"):
            findings.append(Finding(
                GOLDEN_REL, 0, "keyspace-steady-unwarmed",
                f"config {name}: budget declares steady_beyond_warmup="
                f"{declared} but the table shows {len(beyond)}",
            ))
    return findings


def audit_table(table: dict, golden: dict | None) -> list[Finding]:
    """Full audit: the budget invariant (hard error) plus the golden
    diff (drift — ``keyspace-golden``)."""
    findings = _audit_budget(table)
    if golden is None:
        findings.append(Finding(
            GOLDEN_REL, 0, "keyspace-golden",
            "no golden keyspace table committed; bless with "
            "`python -m matvec_mpi_multiplier_torch.staticcheck "
            "--keyspace --write-golden`",
        ))
        return findings
    if golden.get("schema") != table["schema"]:
        findings.append(Finding(
            GOLDEN_REL, 0, "keyspace-golden",
            f"golden schema {golden.get('schema')!r} != enumerator "
            f"schema {table['schema']!r}; re-bless",
        ))
        return findings
    got = set(table["configs"])
    want = set(golden.get("configs", {}))
    for name in sorted(want - got):
        findings.append(Finding(
            GOLDEN_REL, 0, "keyspace-golden",
            f"config {name} is golden-pinned but no longer enumerated",
        ))
    for name in sorted(got - want):
        findings.append(Finding(
            GOLDEN_REL, 0, "keyspace-golden",
            f"config {name} is enumerated but not golden-pinned; "
            "re-bless to widen the audited surface",
        ))
    for name in sorted(got & want):
        entry = _canon(table["configs"][name])
        pinned = _canon(golden["configs"][name])
        if entry == pinned:
            continue
        parts = []
        for cls in ("warmup", "steady", "fault_only", "rollover"):
            added = sorted(set(entry[cls]) - set(pinned.get(cls, [])))
            removed = sorted(set(pinned.get(cls, [])) - set(entry[cls]))
            if added:
                parts.append(f"+{cls}: " + ", ".join(added[:3]))
            if removed:
                parts.append(f"-{cls}: " + ", ".join(removed[:3]))
        if entry.get("serve") != pinned.get("serve"):
            parts.append("serve knobs changed")
        if entry.get("budget") != pinned.get("budget"):
            parts.append(
                f"budget {pinned.get('budget')} -> {entry.get('budget')}"
            )
        findings.append(Finding(
            GOLDEN_REL, 0, "keyspace-golden",
            f"config {name} drifted from golden ("
            + "; ".join(parts or ["content differs"]) + ")",
        ))
    return findings


def run_keyspace_audit(root: str | Path | None = None) -> list[Finding]:
    """Enumerate the pinned configs and audit against the committed
    golden — the ``--keyspace`` CLI layer."""
    return audit_table(keyspace_table(), load_golden(root))
