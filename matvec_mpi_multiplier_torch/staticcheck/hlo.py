"""The symbolic collective census: what each schedule issues, by formula.

The port's own copy of the formulas of the JAX package's
``staticcheck/hlo.py`` that the analytic cost model
(``tuning/cost_model.py``) evaluates. There they also pin the audit of
lowered programs; here they are the model's single source of truth for what
each (strategy, combine, stages) schedule and each reshard migration puts
on the wire, and for the resident bytes of each storage format. The cost
model imports this module at call time, so patching
:func:`schedule_formula` reddens every prediction through the one symbol.
"""

from __future__ import annotations

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
