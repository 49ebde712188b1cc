"""Staticcheck CLI for the port: one entry point for every layer.

Usage::

    python -m matvec_mpi_multiplier_torch.staticcheck            # rules + lock graph + dataflow + keyspace + census
    python -m matvec_mpi_multiplier_torch.staticcheck --rules    # AST rules (the lock graph and the dataflow rules included)
    python -m matvec_mpi_multiplier_torch.staticcheck --lockgraph  # rules #13-#15 only
    python -m matvec_mpi_multiplier_torch.staticcheck --keyspace  # ExecKey-space audit
    python -m matvec_mpi_multiplier_torch.staticcheck --hlo-audit  # collective census
    python -m matvec_mpi_multiplier_torch.staticcheck --memory-audit  # card only
    python -m matvec_mpi_multiplier_torch.staticcheck --json
    python -m matvec_mpi_multiplier_torch.staticcheck --write-golden
    python -m matvec_mpi_multiplier_torch.staticcheck --list

The rule layer is pure AST work. ``--keyspace`` is a symbolic enumeration
(no mesh, no run). ``--hlo-audit`` runs every audited cell once on 8
logical CPU shards under the collective recorder: the matvec cells, the
migrations, the served solvers (census of one trip and the one-card loop),
the fused solves (one step call a shard and one hop a trip) and the
speculative programs (the check's one reduction and its device verdict),
with the traced fingerprints of solver, speculative and ``pallas_ring``
keys (about ten seconds). A bare
run does all four and never asks for a card. ``--memory-audit`` runs the
card twins (``staticcheck/card.py``): the dispatch-path sync audit and the
peak audit on ``cuda:0`` at a small size (``chip_smoke.py`` section 49
runs them at full width); without a card it is a usage error.
``--root`` points the rule layer at another corpus. ``--write-golden``
blesses the census and keyspace golden tables beside the module
(``--keyspace --write-golden`` the keyspace's alone).

Exit status (distinct per failure class, worst first; the JAX package's):

* ``0`` — clean
* ``1`` — AST rule findings (the lock-graph rules included)
* ``2`` — usage or environment error
* ``3`` — artifact-audit failures (census, bytes, dequant, fingerprint,
  reshard, peak, sync, or ``keyspace-steady-unwarmed``)
* ``4`` — golden drift only (``hlo-golden``/``hlo-census``/
  ``keyspace-golden``)
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

EXIT_CLEAN = 0
EXIT_RULES = 1
EXIT_USAGE = 2
EXIT_HLO = 3
EXIT_DRIFT = 4

# The card twins' small size: enough shards and blocks to exercise every
# cell; chip_smoke.py runs them at full width.
MEMORY_AUDIT_N = 4096


def exit_status(findings) -> int:
    """The CLI's verdict for a findings list: rule findings dominate, then
    hard artifact-audit failures (census + keyspace + card), then golden
    drift (severity ``"drift"``)."""
    if not findings:
        return EXIT_CLEAN
    if any(
        not (f.rule.startswith("hlo-") or f.rule.startswith("keyspace-"))
        for f in findings
    ):
        return EXIT_RULES
    if any(f.severity != "drift" for f in findings):
        return EXIT_HLO
    return EXIT_DRIFT


def memory_audit(n: int = MEMORY_AUDIT_N) -> list:
    """The card twins at ``n``² as findings: the storage cells' peak ratios
    under the ceilings (``hlo-peak-liveness``), the dequant-first program
    over them, and the dispatch-path sync audit clean and able to go red
    (``hlo-sync``). Raises ``ConfigError`` without a card."""
    import torch

    from ..engine import MatvecEngine
    from ..utils.errors import ConfigError
    from .card import peak_audit, require_card, seeded_sync_red, sync_audit
    from .findings import Finding
    from .hlo import AUDIT_CONFIGS, audit_mesh

    device = require_card()
    findings = []
    cells = [c for c in AUDIT_CONFIGS if c.storage != "native"]
    for grid_cells, grid in (([c for c in cells if c.strategy != "blockwise"], (1, 4)),
                             ([c for c in cells if c.strategy == "blockwise"], (2, 2))):
        peaks = peak_audit(grid_cells, audit_mesh(4, device, grid), m=n, k=n,
                           dequant_first=True)
        for key, entry in peaks.items():
            if not entry["under_ceiling"]:
                findings.append(Finding(
                    f"<card:{key}>", 0, "hlo-peak-liveness",
                    f"peak {entry['peak_bytes']} bytes is {entry['peak_ratio']:.3f}x "
                    f"the native counterpart's, over the ceiling {entry['ceiling']}x"))
            if entry["dequant_first"]["under_ceiling"]:
                findings.append(Finding(
                    f"<card:{key}>", 0, "hlo-peak-liveness",
                    "the dequant-first program stays under the peak ceiling: the "
                    "gate cannot see a full-width dequantized A"))
    a = torch.rand((n, n), device=device, dtype=torch.bfloat16)
    engine = MatvecEngine(a, audit_mesh(1, device), strategy="rowwise", kernel="cuda",
                          promote=8, max_bucket=32)
    try:
        engine.warmup()
        try:
            sync_audit(engine)
        except RuntimeError as exc:
            findings.append(Finding("<card:sync>", 0, "hlo-sync",
                                    f"a synchronizing call on the dispatch path: {exc}"))
        try:
            seeded_sync_red(engine)
        except ConfigError as exc:
            findings.append(Finding("<card:sync>", 0, "hlo-sync", str(exc)))
    finally:
        engine.close()
    return findings


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m matvec_mpi_multiplier_torch.staticcheck",
        description=(
            "AST lint rules (the lock-graph auditor included), the ExecKey-"
            "space audit, the collective census over the mesh, and the "
            "card twins"
        ),
    )
    parser.add_argument("--rules", action="store_true",
                        help="run the AST rule layer (the lock graph included)")
    parser.add_argument("--lockgraph", action="store_true",
                        help="run ONLY the lock-graph rules (#13-#15)")
    parser.add_argument("--keyspace", action="store_true",
                        help="run the ExecKey-space audit (symbolic, no mesh)")
    parser.add_argument("--hlo-audit", action="store_true",
                        help="run the collective census of every audited cell "
                        "on 8 logical CPU shards")
    parser.add_argument("--memory-audit", action="store_true",
                        help="run the card twins (peak and sync audits) on cuda:0")
    parser.add_argument("--json", action="store_true",
                        help="machine-readable findings on stdout")
    parser.add_argument("--rule", action="append", metavar="NAME",
                        help="restrict the rule layer to NAME (repeatable)")
    parser.add_argument("--root", type=Path, default=None,
                        help="corpus root for the RULE layer only (default: "
                        "this checkout)")
    parser.add_argument("--write-golden", action="store_true",
                        help="bless the census and keyspace golden tables")
    parser.add_argument("--list", action="store_true",
                        help="list the rule catalogue and exit")
    args = parser.parse_args(argv)

    from .findings import render_json, render_text
    from .lockgraph import LOCKGRAPH_RULES
    from .rules import RULES, get_rule

    if args.list:
        width = max(len(n) for n in RULES)
        for name, rule in sorted(RULES.items()):
            marker = f"# {rule.marker}:" if rule.marker else "(no marker)"
            print(f"{name:<{width}}  {marker:<16}  {rule.description}")
        return EXIT_CLEAN

    if args.rule:
        try:
            for name in args.rule:
                get_rule(name)
        except KeyError as e:
            print(f"staticcheck: {e.args[0]}", file=sys.stderr)
            return EXIT_USAGE

    explicit = (args.rules or args.lockgraph or args.hlo_audit
                or args.memory_audit or args.keyspace)
    run_rules_layer = args.rules or not explicit
    run_keyspace_layer = args.keyspace or not explicit or args.write_golden
    run_hlo_layer = args.hlo_audit or not explicit or (
        args.write_golden and not args.keyspace)

    findings = []
    if run_rules_layer or args.lockgraph:
        from .rules import run_rules

        selected = args.rule
        if args.lockgraph and not run_rules_layer:
            selected = list(LOCKGRAPH_RULES) + (args.rule or [])
        findings.extend(run_rules(root=args.root, rules=selected))

    if run_keyspace_layer:
        from .keyspace import run_keyspace_audit, write_golden_keyspace

        if args.write_golden:
            try:
                path = write_golden_keyspace()
            except ValueError as e:
                print(f"staticcheck: {e}", file=sys.stderr)
                return EXIT_USAGE
            print(f"staticcheck: golden keyspace table written to {path}",
                  file=sys.stderr)
        findings.extend(run_keyspace_audit())

    if run_hlo_layer:
        from .hlo import run_hlo_audit, write_golden

        if args.write_golden:
            path = write_golden()
            print(f"staticcheck: golden schedule table written to {path}",
                  file=sys.stderr)
        findings.extend(run_hlo_audit())

    if args.memory_audit:
        from ..utils.errors import ConfigError

        try:
            findings.extend(memory_audit())
        except ConfigError as e:
            print(f"staticcheck: {e}", file=sys.stderr)
            return EXIT_USAGE

    findings = sorted(set(findings))
    print(render_json(findings) if args.json else render_text(findings))
    return exit_status(findings)


if __name__ == "__main__":
    sys.exit(main())
