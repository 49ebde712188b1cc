"""Findings: the one result type both analysis layers report.

A finding is (rule, file, line, message) — file repo-relative, line
1-indexed (0 for whole-artifact findings like a golden-table mismatch).
Reporters render the same list as ``file:line: [rule] message`` text (the
CI log format) or as JSON (``--json``, the machine face the seeded-corpus
agreement test compares across entry points).
"""

from __future__ import annotations

import dataclasses
import json


# Rules whose findings mean "the committed golden table disagrees with
# the tree" rather than "the tree violates an invariant" — a distinct
# severity (and CLI exit status) because the remedy is different:
# re-bless the table, or revert the schedule/keyspace change.
DRIFT_RULES = frozenset({"hlo-golden", "hlo-census", "keyspace-golden"})


@dataclasses.dataclass(frozen=True, order=True)
class Finding:
    """One rule violation (or audit mismatch), sorted file-then-line.

    ``severity`` is ``"error"`` for invariant violations and ``"drift"``
    for golden-table disagreements (:data:`DRIFT_RULES`); ``marker`` is
    the ``# <marker>: <reason>`` comment that could exempt this finding
    (None for rules without an escape hatch)."""

    path: str   # repo-relative posix path ("" for repo-level findings)
    line: int   # 1-indexed; 0 when no single line applies
    rule: str   # rule slug, e.g. "engine-host-sync"
    message: str
    severity: str = "error"
    marker: str | None = None

    def __post_init__(self):
        # The rule, not the construction site, owns the severity: a
        # drift-rule Finding is "drift" even when a future call site
        # forgets to say so (the CLI's exit-code classes depend on it).
        if self.rule in DRIFT_RULES and self.severity == "error":
            object.__setattr__(self, "severity", "drift")

    @property
    def location(self) -> str:
        return f"{self.path}:{self.line}" if self.line else (self.path or "-")

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def dedup(findings) -> list[Finding]:
    """Sorted view, duplicate-free by (path, line, rule): alias chains
    can hit one line twice, and one site reached through two scope
    predicates (or two message spellings of the same violation) is still
    ONE finding to fix — the first (lowest-sorting) message wins."""
    out: dict[tuple[str, int, str], Finding] = {}
    for f in sorted(findings):
        out.setdefault((f.path, f.line, f.rule), f)
    return list(out.values())


def render_text(findings) -> str:
    lines = [f"{f.location}: [{f.rule}] {f.message}" for f in findings]
    n = len(findings)
    lines.append(
        "staticcheck: ok (0 findings)" if n == 0
        else f"staticcheck: {n} finding{'s' if n != 1 else ''}"
    )
    return "\n".join(lines)


def render_json(findings, **extra) -> str:
    by_rule: dict[str, int] = {}
    for f in findings:
        by_rule[f.rule] = by_rule.get(f.rule, 0) + 1
    payload = {
        "findings": [f.as_dict() for f in findings],
        "counts": {"total": len(findings), "by_rule": by_rule},
        **extra,
    }
    return json.dumps(payload, indent=2, sort_keys=True)
