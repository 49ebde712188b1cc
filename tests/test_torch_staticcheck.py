"""The port's staticcheck against the JAX package's.

* The rule engines agree: the rules both packages have get the JAX
  package's own seeded fixtures (read from ``tests/test_staticcheck.py``)
  in each package's layout, and the JAX lock-graph corpora, and both
  engines give the same (rule, line) findings.
* The port's own rules flag their bad snippet and pass the clean twin;
  strings do not trip them; markers need a reason and must not be stale;
  the port's tree is clean.
* The census of every audited cell, run under the mesh's collective
  recorder on 8 logical CPU shards, equals the JAX package's committed
  golden (``data/staticcheck/golden_schedule.json``) exactly, and the JAX
  lowering still matches that golden on two cells. Mutations go red.
* Build fingerprints, the recorder, the exit codes, the CLI, the README's
  rule table, the card twins' refusal without a card, and the tuner's
  refusal to measure on a CPU it was not given.

The tolerance everywhere is exact: counts and bytes are integers.
"""

import importlib.util
import json
import re
import subprocess
import sys
import threading
from pathlib import Path

import pytest
import torch

from matvec_mpi_multiplier_tpu.staticcheck import RULES as JRULES
from matvec_mpi_multiplier_tpu.staticcheck import __main__ as jmain
from matvec_mpi_multiplier_tpu.staticcheck import hlo as jhlo
from matvec_mpi_multiplier_tpu.staticcheck import lockgraph as jlockgraph
from matvec_mpi_multiplier_tpu.staticcheck import run_rules as jax_run_rules
from matvec_mpi_multiplier_tpu.staticcheck.findings import Finding as JFinding
from matvec_mpi_multiplier_torch.models import base as models_base
from matvec_mpi_multiplier_torch.ops.quantize import matvec_quantized_dequant_first
from matvec_mpi_multiplier_torch.parallel import reshard as port_reshard
from matvec_mpi_multiplier_torch.parallel import ring as port_ring
from matvec_mpi_multiplier_torch.parallel.mesh import (
    CollectiveRecorder,
    ShardedTensor,
    psum,
    unshard,
)
from matvec_mpi_multiplier_torch.staticcheck import LOCKGRAPH_RULES, RULES, lockgraph, run_rules
from matvec_mpi_multiplier_torch.staticcheck import __main__ as pmain
from matvec_mpi_multiplier_torch.staticcheck import hlo
from matvec_mpi_multiplier_torch.staticcheck.findings import Finding, dedup
from matvec_mpi_multiplier_torch.staticcheck.rules import scope_label
from matvec_mpi_multiplier_torch.utils.errors import ConfigError

REPO = Path(__file__).resolve().parent.parent
JPKG, PPKG = "matvec_mpi_multiplier_tpu", "matvec_mpi_multiplier_torch"
# The JAX package's kernel names and the port's counterparts.
KERNEL_LABELS = {"xla": "torch", "pallas": "cuda"}


def _jax_fixtures():
    spec = importlib.util.spec_from_file_location(
        "jax_staticcheck_fixtures", REPO / "tests" / "test_staticcheck.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.RULE_FIXTURES, mod.SCHEDULER_SCOPE_FIXTURES


JAX_FIXTURES, JAX_SCHEDULER_FIXTURES = _jax_fixtures()
# The rules the port keeps with the JAX package's bodies. The port reads
# engine-host-sync and fp64-implicit-promotion its own way (same names,
# torch calls), and has its own fixtures for them below.
SHARED_RULES = sorted([
    "hot-path-blocking-io", "mutable-default-arg",
    "scheduler-lock-across-dispatch", "silent-except",
    "device-transfer-under-registry-lock", "measurement-in-admission-path",
    "metric-label-cardinality", "quant-fp64-scale",
    "overlap-unchunked-collective", "lock-mixed-guard",
    "lock-order-inversion", "callback-under-lock",
])


def _seed(root: Path, rel: str, source: str) -> None:
    path = root / rel
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(source)


def _port_rel(rel: str) -> str:
    return rel.replace(f"{JPKG}/", f"{PPKG}/", 1)


def _lines(findings, rule=None):
    return sorted((f.rule, f.line) for f in findings if rule is None or f.rule == rule)


# ------------------------------------------------------ the engines agree


def test_shared_rules_keep_the_jax_names_and_markers():
    assert set(SHARED_RULES) <= set(RULES) & set(JRULES)
    for rule in SHARED_RULES:
        assert RULES[rule].marker == JRULES[rule].marker


@pytest.mark.parametrize("variant", ["bad", "clean"])
@pytest.mark.parametrize("rule", SHARED_RULES)
def test_shared_rule_fixtures_agree(rule, variant, tmp_path):
    rel, bad, clean = JAX_FIXTURES[rule]
    src = bad if variant == "bad" else clean
    _seed(tmp_path / "j", rel, src)
    _seed(tmp_path / "p", _port_rel(rel), src)
    jax_found = _lines(jax_run_rules(root=tmp_path / "j", rules=[rule]), rule)
    port_found = _lines(run_rules(root=tmp_path / "p", rules=[rule]), rule)
    assert port_found == jax_found
    assert bool(port_found) == (variant == "bad")


@pytest.mark.parametrize("rule", [r for r in sorted(JAX_SCHEDULER_FIXTURES)
                                  if r in SHARED_RULES])
def test_scheduler_scope_fixtures_agree(rule, tmp_path):
    rel, bad, clean = JAX_SCHEDULER_FIXTURES[rule]
    for src in (bad, clean):
        _seed(tmp_path / "j", rel, src)
        _seed(tmp_path / "p", _port_rel(rel), src)
        assert (_lines(run_rules(root=tmp_path / "p", rules=[rule]), rule)
                == _lines(jax_run_rules(root=tmp_path / "j", rules=[rule]), rule))


# The JAX package's lock-graph corpora (tests/test_staticcheck.py), one
# entry per corpus: {subpath under the package: source}.
_SEEDED_REGISTRY = (
    "import threading\n"
    "class SeededRegistry:\n"
    "    def __init__(self, engine):\n"
    "        self._registry_lock = threading.Lock()\n"
    "        self.engine = engine\n"
    "    def admit(self):\n"
    "        with self._registry_lock:\n"
    "            self.engine.seeded_place()\n"
    "    def seeded_charge(self):\n"
    "        with self._registry_lock:\n"
    "            pass\n"
)
_LISTENER_SHAPE = (
    "import threading\n"
    "class Engine:\n"
    "    def __init__(self, residency_listener):\n"
    "        self._residency_lock = threading.Lock()\n"
    "        self._residency_listener = residency_listener\n"
    "        self._a = None\n"
    "    def _notify_residency(self, delta, reason):\n"
    "        if self._residency_listener is not None:\n"
    "            self._residency_listener(delta, reason)\n"
    "    def ensure_resident(self, placed, nbytes):\n"
    "        with self._residency_lock:\n"
    "            self._a = placed\n"
    "{indent}self._notify_residency(nbytes, 'resident')\n"
)
_LOCKED_HELPER = (
    "import threading\n"
    "class Sched:\n"
    "    def __init__(self):\n"
    "        self._lock = threading.Lock()\n"
    "        self._pending = []\n"
    "    def _take_locked(self):\n"
    "        batch = self._pending\n"
    "        self._pending = []\n"
    "        return batch\n"
    "    def submit(self, item):\n"
    "        with self._lock:\n"
    "            self._pending.append(item)\n"
)
LOCKGRAPH_CORPORA = {
    "cross_file_inversion": {
        "engine/seeded_registry.py": _SEEDED_REGISTRY,
        "engine/seeded_engine.py": (
            "import threading\n"
            "class SeededEngine:\n"
            "    def __init__(self):\n"
            "        self._residency_lock = threading.Lock()\n"
            "    def seeded_place(self):\n"
            "        with self._residency_lock:\n"
            "            pass\n"
            "    def release(self, registry):\n"
            "        with self._residency_lock:\n"
            "            registry.seeded_charge()\n"),
    },
    "unannotated_direct_acquisition": {"engine/seeded.py": (
        "import threading\n"
        "class SeededRegistry:\n"
        "    def __init__(self, engine):\n"
        "        self._registry_lock = threading.Lock()\n"
        "        self.engine = engine\n"
        "    def admit(self):\n"
        "        with self._registry_lock:\n"
        "            with self.engine._residency_lock:\n"
        "                pass\n"
        "class SeededEngine:\n"
        "    def __init__(self, registry):\n"
        "        self._residency_lock = threading.Lock()\n"
        "        self.registry = registry\n"
        "    def release(self):\n"
        "        with self._residency_lock:\n"
        "            with self.registry._registry_lock:\n"
        "                pass\n")},
    "local_rooted_acquisition": {"engine/seeded.py": (
        "import threading\n"
        "class SeededA:\n"
        "    def __init__(self):\n"
        "        self._alpha_lock = threading.Lock()\n"
        "    def forward(self, peer):\n"
        "        with self._alpha_lock:\n"
        "            with peer._beta_lock:\n"
        "                pass\n"
        "class SeededB:\n"
        "    def __init__(self):\n"
        "        self._beta_lock = threading.Lock()\n"
        "    def backward(self, peer):\n"
        "        with self._beta_lock:\n"
        "            with peer._alpha_lock:\n"
        "                pass\n")},
    "no_phantom_edges_from_locked_helpers": {"engine/seeded.py": (
        "import threading\n"
        "class SeededEng:\n"
        "    def __init__(self, other):\n"
        "        self._gamma_lock = threading.Lock()\n"
        "        self._delta_lock = threading.Lock()\n"
        "        self.other = other\n"
        "    def _bump_locked(self):\n"
        "        with self.other._epsilon_lock:\n"
        "            pass\n"
        "    def bump(self):\n"
        "        with self._gamma_lock:\n"
        "            self._bump_locked()\n"
        "class SeededOther:\n"
        "    def __init__(self, eng):\n"
        "        self._epsilon_lock = threading.Lock()\n"
        "        self.eng = eng\n"
        "    def touch(self):\n"
        "        with self._epsilon_lock:\n"
        "            with self.eng._delta_lock:\n"
        "                pass\n")},
    "marker_drops_an_edge": {"engine/seeded.py": JAX_FIXTURES["lock-order-inversion"][1].replace(
        "            self.registry.seeded_charge()\n",
        "            self.registry.seeded_charge()  # lock-order-ok: seeded proven-safe ordering\n")},
    "marker_inside_with_body": {"engine/seeded.py": JAX_FIXTURES["lock-order-inversion"][1].replace(
        "    def seeded_charge(self):\n"
        "        with self._registry_lock:\n"
        "            pass\n",
        "    def seeded_charge(self):\n"
        "        with self._registry_lock:\n"
        "            pass  # lock-order-ok: seeded comment on an unrelated body line\n")},
    "listener_under_lock": {"engine/seeded.py": _LISTENER_SHAPE.format(indent=" " * 12)},
    "listener_after_release": {"engine/seeded.py": _LISTENER_SHAPE.format(indent=" " * 8)},
    "locked_helper_convention": {"engine/seeded.py": _LOCKED_HELPER + (
        "    def flush(self):\n"
        "        with self._lock:\n"
        "            batch = self._take_locked()\n"
        "        return batch\n")},
    "locked_helper_called_bare": {"engine/seeded.py": _LOCKED_HELPER + (
        "    def flush(self):\n"
        "        return self._take_locked()\n")},
    "multi_item_with": {"engine/seeded.py": (
        "import threading\n"
        "class Pair:\n"
        "    def __init__(self):\n"
        "        self._a_lock = threading.Lock()\n"
        "        self._b_lock = threading.Lock()\n"
        "    def forward(self):\n"
        "        with self._a_lock, self._b_lock:\n"
        "            pass\n"
        "    def backward(self):\n"
        "        with self._b_lock:\n"
        "            with self._a_lock:\n"
        "                pass\n")},
    "wrong_lock_read_of_helper_written_attr": {"engine/seeded.py": (
        "import threading\n"
        "class Counter:\n"
        "    def __init__(self, other):\n"
        "        self._state_lock = threading.Lock()\n"
        "        self.other = other\n"
        "        self._count = 0\n"
        "    def _bump_locked(self):\n"
        "        self._count += 1\n"
        "    def bump(self):\n"
        "        with self._state_lock:\n"
        "            self._bump_locked()\n"
        "    def peek(self):\n"
        "        with self.other._foreign_lock:\n"
        "            return self._count\n")},
    "bare_invocation_of_guarded_callable": {"engine/seeded.py": (
        "import threading\n"
        "class Notifier:\n"
        "    def __init__(self):\n"
        "        self._lock = threading.Lock()\n"
        "        self._listener = None\n"
        "    def set_listener(self, fn):\n"
        "        with self._lock:\n"
        "            self._listener = fn\n"
        "    def fire(self):\n"
        "        self._listener()\n")},
    "wrong_lock_message": {"engine/seeded.py": (
        "import threading\n"
        "class Counter:\n"
        "    def __init__(self, other):\n"
        "        self._state_lock = threading.Lock()\n"
        "        self.other = other\n"
        "        self._count = 0\n"
        "    def bump(self):\n"
        "        with self._state_lock:\n"
        "            self._count += 1\n"
        "    def peek(self):\n"
        "        with self.other._foreign_lock:\n"
        "            return self._count\n")},
}


def _graph_findings(graph, pkg):
    return sorted(
        (rule, rel.removeprefix(f"{pkg}/"), node.lineno)
        for rule, by_file in graph.findings.items()
        for rel, hits in by_file.items() for node, _ in hits
    )


@pytest.mark.parametrize("corpus", sorted(LOCKGRAPH_CORPORA))
def test_lockgraph_corpora_agree(corpus, tmp_path):
    for sub, src in LOCKGRAPH_CORPORA[corpus].items():
        _seed(tmp_path / "j", f"{JPKG}/{sub}", src)
        _seed(tmp_path / "p", f"{PPKG}/{sub}", src)
    jlockgraph.new_generation()
    lockgraph.new_generation()
    jraw = _graph_findings(jlockgraph.analyze(tmp_path / "j"), JPKG)
    praw = _graph_findings(lockgraph.analyze(tmp_path / "p"), PPKG)
    assert praw == jraw
    jrun = _lines(jax_run_rules(root=tmp_path / "j", rules=list(LOCKGRAPH_RULES)))
    prun = _lines(run_rules(root=tmp_path / "p", rules=list(LOCKGRAPH_RULES)))
    assert prun == jrun
    expect_clean = corpus in ("no_phantom_edges_from_locked_helpers", "marker_drops_an_edge",
                              "listener_after_release", "locked_helper_convention")
    assert (prun == []) == expect_clean


# ------------------------------------------------------ the port's own rules

P = PPKG
PORT_FIXTURES = {
    "jax-import": (
        f"{P}/ops/seeded.py",
        "import jax.numpy as jnp\nfrom matvec_mpi_multiplier_tpu import ops\n",
        "import torch\nimport numpy as np\n",
    ),
    "engine-host-sync": (
        f"{P}/engine/seeded.py",
        "def dispatch(y):\n    return y.item()\n",
        "def dispatch(y):\n    return y.item()  # sync-ok: seeded deliberate sync\n",
    ),
    "overlap-unchunked-collective": (
        f"{P}/parallel/ring.py",
        "from .mesh import psum_scatter as pss\n"
        "def stage(v, mesh, axes):\n    return pss(v, mesh, axes)\n",
        "from .mesh import psum_scatter as pss\n"
        "def stage(v, mesh, axes):\n    return pss(v, mesh, axes)  # overlap-ok: seeded chunk\n",
    ),
    "hot-path-blocking-io": JAX_FIXTURES["hot-path-blocking-io"],
    "fp64-implicit-promotion": (
        f"{P}/engine/seeded.py",
        "import numpy as np\nimport torch\n"
        "def stage(x):\n    return torch.from_numpy(np.asarray(x))\n"
        "def widen(t):\n    return t.to(torch.float64)\n",
        "import numpy as np\nimport torch\n"
        "def stage(x):\n    return torch.from_numpy(np.asarray(x, dtype=np.float32))\n"
        "def widen(t):\n    return t.to(torch.float64)  # fp64-ok: seeded fp64 oracle\n",
    ),
    "import-time-torch": (
        f"{P}/ops/seeded.py",
        "import torch\nTABLE = torch.arange(8)\nDEV = torch.cuda.current_device()\n",
        "import numpy as np\nTABLE = np.arange(8)\n"
        "def dev():\n    import torch\n    return torch.cuda.current_device()\n",
    ),
    "mutable-default-arg": JAX_FIXTURES["mutable-default-arg"],
    "scheduler-lock-across-dispatch": JAX_FIXTURES["scheduler-lock-across-dispatch"],
    "silent-except": JAX_FIXTURES["silent-except"],
    "quant-fp64-scale": (
        f"{P}/ops/cuda_quant.py",
        "import torch\ndef scales(a):\n    return a.abs().amax(1).to(torch.float64)\n",
        "import torch\ndef scales(a):\n    return a.abs().amax(1).to(torch.float32)\n",
    ),
    "device-transfer-under-registry-lock": (
        f"{P}/engine/registry.py",
        "class Registry:\n    def admit(self, entry, a, spec, mesh):\n"
        "        with self._lock:\n            entry.a = shard(a, spec, mesh)\n",
        "class Registry:\n    def admit(self, entry, a, spec, mesh):\n"
        "        with self._lock:\n            self._plan(entry)\n"
        "        entry.a = shard(a, spec, mesh)\n",
    ),
    "measurement-in-admission-path": JAX_FIXTURES["measurement-in-admission-path"],
    "metric-label-cardinality": JAX_FIXTURES["metric-label-cardinality"],
    "lock-mixed-guard": JAX_FIXTURES["lock-mixed-guard"],
    "lock-order-inversion": JAX_FIXTURES["lock-order-inversion"],
    "callback-under-lock": JAX_FIXTURES["callback-under-lock"],
    # The value-flow rules (dataflow.py), read the port's way.
    "traced-python-branch": (
        f"{P}/models/seeded.py",
        "import torch\ndef build(mesh):\n    def fn(a, x):\n        y = torch.mv(a, x)\n"
        "        if y.sum() > 0:\n            return y\n        return -y\n    return fn\n",
        "import torch\ndef build(mesh):\n    def fn(a, x):\n        y = torch.mv(a, x)\n"
        "        if y.dim() == 1:\n            return y\n        return -y\n    return fn\n",
    ),
    "weak-type-cache-split": (
        f"{P}/engine/seeded.py",
        "def key(op, n):\n    return ExecKey(op, 'rowwise', 'cuda', None, n / 2, 'float32')\n",
        "def key(op, n):\n    return ExecKey(op, 'rowwise', 'cuda', None, n // 2, 'float32')\n",
    ),
    "unhashable-static-arg": (
        f"{P}/engine/seeded.py",
        "def key(op, parts):\n"
        "    return ExecKey(op, 'rowwise', 'cuda', [p for p in parts], 1, 'float32')\n",
        "def key(op, parts):\n"
        "    return ExecKey(op, 'rowwise', 'cuda', tuple(parts), 1, 'float32')\n",
    ),
    "host-sync-on-tracer": (
        f"{P}/solvers/seeded.py",
        "import torch\ndef norm(v):\n    return float(torch.linalg.vector_norm(v))\n",
        "import torch\ndef norm(v):\n    return torch.linalg.vector_norm(v)\n",
    ),
}


def test_port_fixture_table_covers_every_rule():
    assert set(PORT_FIXTURES) == set(RULES)


@pytest.mark.parametrize("rule", sorted(PORT_FIXTURES))
def test_port_rule_flags_bad_and_passes_clean(rule, tmp_path):
    rel, bad, clean = PORT_FIXTURES[rule]
    rel = _port_rel(rel)
    _seed(tmp_path, rel, bad)
    found = run_rules(root=tmp_path, rules=[rule])
    assert any(f.rule == rule and f.path == rel for f in found), found
    _seed(tmp_path, rel, clean)
    found = run_rules(root=tmp_path, rules=[rule])
    assert not [f for f in found if f.rule == rule], found


def test_jax_import_rule_is_the_purity_test_s_twin(tmp_path):
    """It reads chip_smoke.py too, and the tests (which import both
    packages by design) not at all."""
    _seed(tmp_path, "chip_smoke.py", "import jax\n")
    _seed(tmp_path, "tests/test_torch_seeded.py", "import jax\n")
    found = run_rules(root=tmp_path, rules=["jax-import"])
    assert [(f.path, f.line) for f in found] == [("chip_smoke.py", 1)]


def test_strings_and_docstrings_do_not_trip_port_rules(tmp_path):
    _seed(tmp_path, f"{P}/parallel/ring.py",
          '"""Never call psum(blocks) or unshard(y) here."""\nPATTERN = "psum_scatter(v)"\n')
    _seed(tmp_path, f"{P}/engine/doc.py",
          '"""y.item(), y.cpu() and torch.cuda.synchronize() are forbidden."""\n'
          'RULE = "import jax"\n')
    assert run_rules(root=tmp_path) == []


def test_port_marker_without_reason_is_a_finding(tmp_path):
    _seed(tmp_path, f"{P}/engine/seeded.py", "def dispatch(y):\n    return y.cpu()  # sync-ok:\n")
    assert {f.rule for f in run_rules(root=tmp_path)} == {"marker-missing-reason"}


def test_port_stale_marker_is_a_finding(tmp_path):
    rel = f"{P}/engine/seeded.py"
    _seed(tmp_path, rel, "def dispatch(y):\n    return y  # sync-ok: nothing syncs here\n")
    found = run_rules(root=tmp_path)
    assert [(f.rule, f.line) for f in found] == [("stale-marker", 2)]
    _seed(tmp_path, rel, "def dispatch(y):\n    return y  # sync-ok: kept — stale-ok: pinned\n")
    assert run_rules(root=tmp_path) == []


def test_port_tree_is_clean_under_rules_and_lock_graph():
    findings = run_rules()
    assert findings == [], "\n".join(f"{f.location}: [{f.rule}] {f.message}" for f in findings)


def test_dedup_and_drift_severity_match_the_jax_package():
    a1 = Finding("x.py", 3, "engine-host-sync", "b")
    a2 = Finding("x.py", 3, "engine-host-sync", "a")
    assert [f.message for f in dedup([a1, a2])] == ["a"]
    assert Finding("g", 0, "keyspace-golden", "m").severity == "drift"


# ------------------------------------------------------------ exit codes

_FINDING_LISTS = [
    [],
    [("x.py", 3, "engine-host-sync")],
    [("<hlo:k>", 0, "hlo-schedule")],
    [("g.json", 0, "hlo-census")],
    [("g.json", 0, "keyspace-golden")],
    [("g.json", 0, "keyspace-steady-unwarmed"), ("g.json", 0, "keyspace-golden")],
    [("x.py", 3, "silent-except"), ("<hlo:k>", 0, "hlo-schedule"), ("g", 0, "hlo-golden")],
    [("<hlo:k>", 0, "hlo-early-dequant"), ("g", 0, "hlo-census")],
]


@pytest.mark.parametrize("spec", _FINDING_LISTS, ids=lambda s: "+".join(r for _, _, r in s) or "clean")
def test_exit_status_equals_the_jax_package_s(spec):
    port = [Finding(p, line, rule, "m") for p, line, rule in spec]
    jax = [JFinding(p, line, rule, "m") for p, line, rule in spec]
    assert pmain.exit_status(port) == jmain.exit_status(jax)
    assert (pmain.EXIT_CLEAN, pmain.EXIT_RULES, pmain.EXIT_USAGE, pmain.EXIT_HLO,
            pmain.EXIT_DRIFT) == (0, 1, 2, 3, 4)


def test_cli_and_api_agree_on_a_seeded_corpus(tmp_path):
    for rule, (rel, bad, _clean) in sorted(PORT_FIXTURES.items()):
        _seed(tmp_path, _port_rel(rel).replace("seeded", f"seeded_{rule[:8]}"), bad)
    api = run_rules(root=tmp_path)
    assert api
    proc = subprocess.run(
        [sys.executable, "-m", "matvec_mpi_multiplier_torch.staticcheck",
         "--rules", "--root", str(tmp_path), "--json"],
        capture_output=True, text=True, cwd=REPO, timeout=120)
    assert proc.returncode == pmain.EXIT_RULES, proc.stderr
    cli = json.loads(proc.stdout)["findings"]
    assert [(f["path"], f["line"], f["rule"], f["marker"]) for f in cli] == [
        (f.path, f.line, f.rule, f.marker) for f in api]


def test_cli_lockgraph_flag_runs_only_lock_rules(tmp_path, capsys):
    _seed(tmp_path, _port_rel(PORT_FIXTURES["engine-host-sync"][0]),
          PORT_FIXTURES["engine-host-sync"][1])
    assert pmain.main(["--lockgraph", "--root", str(tmp_path), "--json"]) == pmain.EXIT_CLEAN
    assert json.loads(capsys.readouterr().out)["findings"] == []
    _seed(tmp_path, _port_rel(PORT_FIXTURES["lock-mixed-guard"][0]).replace("seeded", "ledger"),
          PORT_FIXTURES["lock-mixed-guard"][1])
    assert pmain.main(["--lockgraph", "--root", str(tmp_path), "--json"]) == pmain.EXIT_RULES
    assert {f["rule"] for f in json.loads(capsys.readouterr().out)["findings"]} == {
        "lock-mixed-guard"}


def test_cli_usage_errors(capsys):
    assert pmain.main(["--rule", "no-such-rule"]) == pmain.EXIT_USAGE


# ----------------------------------------------------------- the census


@pytest.fixture(scope="module")
def mesh():
    return hlo.audit_mesh()


@pytest.fixture(scope="module")
def jax_golden():
    return json.loads((REPO / "data/staticcheck/golden_schedule.json").read_text())


def _jax_key(cfg) -> str:
    labels = {v: k for k, v in KERNEL_LABELS.items()}
    return cfg.key.replace(f"|{cfg.kernel}", f"|{labels[cfg.kernel]}", 1)


def test_audit_family_is_the_jax_package_s():
    assert [_jax_key(c) for c in hlo.AUDIT_CONFIGS] == [c.key for c in jhlo.AUDIT_CONFIGS]
    assert [r.key for r in hlo.RESHARD_AUDIT_CONFIGS] == [r.key for r in jhlo.RESHARD_AUDIT_CONFIGS]
    assert (hlo.AUDIT_DEVICES, hlo.AUDIT_M, hlo.AUDIT_K, hlo.AUDIT_DTYPE) == (
        jhlo.AUDIT_DEVICES, jhlo.AUDIT_M, jhlo.AUDIT_K, jhlo.AUDIT_DTYPE)
    assert hlo.STORAGE_BYTE_CEILING == jhlo.STORAGE_BYTE_CEILING
    assert hlo.PEAK_LIVENESS_CEILING == jhlo.PEAK_LIVENESS_CEILING
    assert not any(c.combine == "pallas_ring" for c in hlo.AUDIT_CONFIGS)


@pytest.mark.parametrize("cfg", hlo.supported_configs(hlo.AUDIT_CONFIGS), ids=lambda c: c.key)
def test_census_equals_the_jax_golden(cfg, mesh, jax_golden):
    entry = hlo.audit_entry(cfg, mesh)
    want = jax_golden["configs"][_jax_key(cfg)]
    assert entry["census"] == want["census"]
    assert entry["payload_bytes"] == want["payload_bytes"]
    assert entry["payload_total_bytes"] == want["payload_total_bytes"]
    assert entry["a_bytes"] == want["a_bytes"]
    assert entry["a_bytes_ratio"] == want["a_bytes_ratio"]
    assert hlo.schedule_findings(cfg, entry, mesh) == []
    # The output gather the JAX package leaves to its compiler is recorded
    # apart: one for every strategy whose y the program gathers.
    assert all(r.kind == "all-gather" for r in entry["boundary"])


@pytest.mark.parametrize("rcfg", hlo.RESHARD_AUDIT_CONFIGS, ids=lambda r: r.key)
def test_reshard_census_equals_the_jax_golden(rcfg, mesh, jax_golden):
    entry = hlo.reshard_audit_entry(rcfg, mesh)
    assert entry == jax_golden["reshards"][rcfg.key]
    assert hlo.reshard_findings(rcfg, entry, mesh) == []


@pytest.mark.parametrize("key", ["colwise|overlap@4|xla", "blockwise|ring|xla"])
def test_jax_lowering_still_matches_the_golden(key, devices, jax_golden):
    jcfg = next(c for c in jhlo.AUDIT_CONFIGS if c.key == key)
    entry = jhlo.audit_entry(jcfg, jhlo._audit_mesh())
    want = jax_golden["configs"][key]
    assert (entry["census"], entry["payload_bytes"]) == (want["census"], want["payload_bytes"])


def test_the_port_s_golden_is_clean_and_complete(mesh):
    assert hlo.run_hlo_audit(mesh=mesh) == []
    table = json.loads(hlo.golden_path().read_text())
    assert set(table["configs"]) == {c.key for c in hlo.supported_configs(hlo.AUDIT_CONFIGS)}
    assert set(table["reshards"]) == {r.key for r in hlo.RESHARD_AUDIT_CONFIGS}


def test_golden_drift_and_missing_golden(mesh, tmp_path):
    table = json.loads(hlo.golden_path().read_text())
    table["configs"]["rowwise|ring|torch"]["census"] = {"collective-permute": 8}
    path = tmp_path / "golden.json"
    path.write_text(json.dumps(table))
    cfg = [hlo.AuditConfig("rowwise", "ring")]
    found = hlo.run_hlo_audit(path, cfg, mesh=mesh, check_fingerprints=False)
    assert [(f.rule, f.severity) for f in found] == [("hlo-census", "drift")]
    assert pmain.exit_status(found) == pmain.EXIT_DRIFT
    found = hlo.run_hlo_audit(tmp_path / "none.json", cfg, mesh=mesh, check_fingerprints=False)
    assert [f.rule for f in found] == ["hlo-golden"]


def _unstaged_gather(a_blks, x_locs, mesh, gather_axes, kernel, stages, reduce_axes=None):
    """The mutation: the staged gather issued as ONE full-width gather."""
    parts = [kernel(a, x) for a, x in zip(a_blks, x_locs)]
    if reduce_axes is not None:
        parts = psum(parts, mesh, reduce_axes)
    full = unshard(ShardedTensor(tuple(parts), (parts[0].shape[0] * mesh.size,),
                                 (gather_axes,), mesh))
    return [full] * mesh.size


def _unchunked_scatter(a_panels, x_segs, mesh, axes, kernel, stages, step="psum_scatter"):
    """The mutation: the staged scatter issued as ONE full-width scatter."""
    from matvec_mpi_multiplier_torch.parallel.mesh import psum_scatter

    return psum_scatter([kernel(a, x) for a, x in zip(a_panels, x_segs)], mesh, axes)


def test_mutation_full_width_gather_in_overlap_goes_red(mesh, monkeypatch):
    monkeypatch.setattr(models_base, "staged_overlap_gather", _unstaged_gather)
    found = hlo.run_hlo_audit(configs=[hlo.AuditConfig("rowwise", "overlap", 4)],
                              mesh=mesh, check_fingerprints=False)
    assert {"hlo-schedule", "hlo-overlap"} <= {f.rule for f in found}
    assert pmain.exit_status(found) == pmain.EXIT_HLO


def test_mutation_unchunked_scatter_goes_red(mesh, monkeypatch):
    monkeypatch.setattr(port_ring, "staged_overlap_scatter", _unchunked_scatter)
    found = hlo.run_hlo_audit(configs=[hlo.AuditConfig("colwise", "overlap", 4)],
                              mesh=mesh, check_fingerprints=False)
    assert {"hlo-schedule", "hlo-overlap"} <= {f.rule for f in found}


def test_mutation_dequant_first_goes_red(mesh):
    cells = [c for c in hlo.supported_configs(hlo.AUDIT_CONFIGS) if c.storage != "native"]
    found = hlo.run_hlo_audit(configs=cells, kernel=matvec_quantized_dequant_first,
                              mesh=mesh, check_fingerprints=False)
    assert {f.path for f in found if f.rule == "hlo-early-dequant"} == {
        f"<hlo:{c.key}>" for c in cells}


@pytest.mark.parametrize("mutation", ["host", "redundant"])
def test_mutation_reshard_goes_red(mutation, mesh, monkeypatch):
    monkeypatch.setattr(port_reshard, "_MUTATION", mutation)
    found = hlo.run_hlo_audit(configs=[], reshard_configs=hlo.RESHARD_AUDIT_CONFIGS,
                              mesh=mesh)
    assert {f.path for f in found if f.rule == "hlo-reshard-schedule"} == {
        f"<hlo:{r.key}>" for r in hlo.RESHARD_AUDIT_CONFIGS}
    assert pmain.exit_status(found) == pmain.EXIT_HLO


def test_storage_ceiling_gate_wiring(mesh, monkeypatch):
    monkeypatch.setitem(hlo.STORAGE_BYTE_CEILING, "int8", 0.1)
    found = hlo.run_hlo_audit(configs=[hlo.AuditConfig("rowwise", "gather", storage="int8")],
                              mesh=mesh, check_fingerprints=False)
    assert [f.rule for f in found] == ["hlo-storage-bytes"]


def test_cli_exits_hlo_class_under_a_mutation(monkeypatch, capsys):
    monkeypatch.setattr(port_reshard, "_MUTATION", "host")
    assert pmain.main(["--hlo-audit"]) == pmain.EXIT_HLO
    assert "hlo-reshard-schedule" in capsys.readouterr().out


# ----------------------------------------------- fingerprints and recorder


def test_fingerprints_stable_across_builds_and_differ_across_combines(mesh):
    cells = [hlo.AuditConfig("colwise", c) for c in ("psum", "psum_scatter", "ring", "a2a")]
    prints = [hlo.config_fingerprint(c, mesh) for c in cells]
    assert prints == [hlo.config_fingerprint(c, mesh) for c in cells]
    assert len(set(prints)) == len(prints)
    assert hlo.config_fingerprint(hlo.AuditConfig("colwise", "overlap", 2), mesh) != \
        hlo.config_fingerprint(hlo.AuditConfig("colwise", "overlap", 4), mesh)


def test_engine_records_matching_fingerprints():
    from matvec_mpi_multiplier_torch.engine import MatvecEngine

    a = torch.rand(64, 64, generator=torch.Generator().manual_seed(0))
    prints = []
    for _ in range(2):
        engine = MatvecEngine(a, hlo.audit_mesh(), strategy="colwise", kernel="torch",
                              combine="overlap", stages=2, promote=4, max_bucket=8)
        engine.warmup()
        prints.append(engine.fingerprints())
        assert set(prints[-1]) == {k.label() for k in engine._cache.keys()}
        engine.close()
    assert prints[0] == prints[1]


@pytest.mark.parametrize("cfg", [c for c in hlo.AUDIT_CONFIGS if c.storage == "native"],
                         ids=lambda c: c.key)
def test_recorder_is_bitwise_neutral(cfg, mesh):
    a, x = hlo.audit_operands(cfg, mesh, seed=3)
    fn = hlo.build_config(cfg, mesh)
    off = fn(a, x)
    with CollectiveRecorder() as rec:
        on = fn(a, x)
    assert torch.equal(on, off)
    assert all(isinstance(v, (int, str, tuple, bool)) for r in rec.records
               for v in vars(r).values())


def test_recorder_is_per_thread(mesh):
    cfg = hlo.AuditConfig("colwise", "psum")
    a, x = hlo.audit_operands(cfg, mesh)
    fn = hlo.build_config(cfg, mesh)
    with CollectiveRecorder() as rec:
        t = threading.Thread(target=fn, args=(a, x))
        t.start()
        t.join(timeout=60)
        assert not t.is_alive()
    assert rec.records == []
    with CollectiveRecorder() as rec:
        fn(a, x)
    assert rec.census()[0] == {"all-reduce": 1}


# ------------------------------------------------- docs, card, tuner


def _readme_rule_table():
    text = (REPO / "README.md").read_text()
    start = text.index("<!-- port-staticcheck-rules -->")
    rows = {}
    for line in text[start:].splitlines()[1:]:
        if not line.startswith("|"):
            if rows:
                break
            continue
        cells = [c.strip() for c in line.strip("|").split("|")]
        m = re.fullmatch(r"`([a-z0-9-]+)`", cells[0])
        if m:
            rows[m.group(1)] = (cells[1].strip("`"), cells[2])
    return rows


def test_readme_rule_table_matches_the_registry():
    rows = _readme_rule_table()
    assert set(rows) == set(RULES)
    for name, (marker, scope) in rows.items():
        assert marker == (RULES[name].marker or "—"), name
        assert scope == scope_label(name), name


def test_card_twins_refuse_without_a_card(monkeypatch):
    from matvec_mpi_multiplier_torch.engine import MatvecEngine
    from matvec_mpi_multiplier_torch.staticcheck import card

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ConfigError):
        card.require_card()
    engine = MatvecEngine(torch.rand(8, 8), hlo.audit_mesh(1), kernel="torch", promote=None)
    try:
        with pytest.raises(ConfigError):
            card.sync_audit(engine)
        with pytest.raises(ConfigError):
            card.seeded_sync_red(engine)
    finally:
        engine.close()
    with pytest.raises(ConfigError):
        card.peak_audit([hlo.AuditConfig("rowwise", "gather", storage="int8")],
                        hlo.audit_mesh(), m=64, k=2048)
    assert pmain.main(["--memory-audit"]) == pmain.EXIT_USAGE


def test_tuner_refuses_a_quiet_cpu_race(monkeypatch, tmp_path):
    from matvec_mpi_multiplier_torch import tuning
    from matvec_mpi_multiplier_torch.tuning import search

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ConfigError, match="no CUDA device"):
        search._tune_device()
    cache = tuning.TuningCache.load(tmp_path / "tuning_cache.json")
    for call in (lambda: search.tune_gemv(32, 64, "float32", cache),
                 lambda: search.tune_gemm(32, 64, 8, "float32", cache)):
        with pytest.raises(ConfigError, match="no CUDA device"):
            call()
