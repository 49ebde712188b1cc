"""Static analysis for the port's schedule and serving invariants.

The port's counterpart of the JAX package's ``staticcheck/``, one CLI
(``python -m matvec_mpi_multiplier_torch.staticcheck``) over four layers:

* **AST rule engine** (``rules``, ``lockgraph``, ``dataflow``): visitor-based lint over
  the port's corpus (the package, ``tests/test_torch_*.py`` and
  ``chip_smoke.py``), with per-rule ``# <marker>: <reason>`` exemptions that
  must carry a reason and sit where their rule fires, and the whole-program
  lock-graph auditor (rules #13-#15) over ``engine/``, ``obs/``,
  ``resilience/`` and ``tuning/``, and the whole-program value-flow rules
  (#17-#20) over the package: device-tensor branches in program bodies,
  float or per-request values and unhashable values in build keys, host
  reads of device tensors in ``engine/`` and ``solvers/``.
* **ExecKey-space audit** (``keyspace``): the engine's build surface
  enumerated per serve configuration, golden-pinned, with the
  ``steady`` within ``warmup`` budget (``compiles_steady == 0``) proved
  statically and held against ``MatvecEngine.exec_keyspace``.
* **Collective census** (``hlo``): every audited strategy x combine x
  storage cell run once under the mesh's collective recorder, its census
  and per-device payload bytes held to the formulas and a golden table,
  with the overlap, storage, early-dequant, reshard and build-fingerprint
  gates; the served solvers, the fused solves and the speculative programs
  with their loop, kernel-count and verdict gates.
* **Card twins** (``card``): the dispatch-path sync audit and the peak
  audit, on a CUDA device only.
"""

from __future__ import annotations

from .corpus import SCAN_FILES, SCAN_ROOTS, SourceFile, iter_corpus, repo_root
from .findings import DRIFT_RULES, Finding, render_json, render_text
from .dataflow import DATAFLOW_RULES, dataflow_scope, sync_scope
from .lockgraph import LOCKGRAPH_RULES, analyze, lockgraph_scope
from .rules import (
    MARKERS,
    RULES,
    check_marker_reasons,
    get_rule,
    run_rules,
)

__all__ = [
    "DATAFLOW_RULES",
    "DRIFT_RULES",
    "Finding",
    "LOCKGRAPH_RULES",
    "MARKERS",
    "RULES",
    "SCAN_FILES",
    "SCAN_ROOTS",
    "SourceFile",
    "analyze",
    "check_marker_reasons",
    "dataflow_scope",
    "get_rule",
    "iter_corpus",
    "lockgraph_scope",
    "render_json",
    "render_text",
    "repo_root",
    "run_rules",
    "sync_scope",
]
