"""The port's value-flow rules (``staticcheck/dataflow.py``, rules #17-#20).

The rule names and markers are the JAX package's; each rule is read the
port's way (what mints a build or capture, or syncs). Each flags its bad
fixtures and passes their clean twins; the whole-program cache follows an
edit; the taint crosses calls, closures and ``self.`` methods; and the
port's tree is clean under the four rules, every deliberate site marked
with its reason.
"""

from pathlib import Path

import pytest

from matvec_mpi_multiplier_tpu.staticcheck import RULES as JRULES
from matvec_mpi_multiplier_torch.staticcheck import (
    DATAFLOW_RULES,
    RULES,
    dataflow,
    run_rules,
)
from matvec_mpi_multiplier_torch.staticcheck.rules import scope_label

P = "matvec_mpi_multiplier_torch"

# rule -> [(path, bad source, clean twin)]
FIXTURES = {
    "traced-python-branch": [
        (f"{P}/models/seeded.py",
         "import torch\n"
         "def build(mesh):\n"
         "    def fn(a, x):\n"
         "        y = torch.mv(a, x)\n"
         "        if y.sum() > 0:\n"
         "            return y\n"
         "        return -y\n"
         "    return fn\n",
         "import torch\n"
         "def build(mesh):\n"
         "    def fn(a, x):\n"
         "        y = torch.mv(a, x)\n"
         "        if y.dim() == 1:\n"
         "            return y\n"
         "        return -y\n"
         "    return fn\n"),
        # A captured device-loop iteration: its flag frozen at capture.
        (f"{P}/solvers/seeded.py",
         "import torch\n"
         "class Loop:\n"
         "    def _alloc(self):\n"
         "        self.loop = ChunkedLoop(self.iteration, None, None, None)\n"
         "    def iteration(self):\n"
         "        r = torch.rand(4)\n"
         "        while torch.sum(r * r) > 1:\n"
         "            r = r / 2\n",
         "import torch\n"
         "class Loop:\n"
         "    def _alloc(self):\n"
         "        self.loop = ChunkedLoop(self.iteration, None, None, None)\n"
         "    def iteration(self):\n"
         "        r = torch.rand(4)\n"
         "        r = torch.where(torch.sum(r * r) > 1, r / 2, r)\n"),
        # Across a call: the helper's branch runs inside the program body.
        (f"{P}/models/seeded.py",
         "import torch\n"
         "def check(v):\n"
         "    assert bool(v.max() < 10) and v.max() < 10\n"
         "def build_it(mesh):\n"
         "    def fn(a, x):\n"
         "        check(torch.mv(a, x))\n"
         "    return fn\n",
         "import torch\n"
         "def check(v):\n"
         "    assert v.ndim == 1\n"
         "def build_it(mesh):\n"
         "    def fn(a, x):\n"
         "        check(torch.mv(a, x))\n"
         "    return fn\n"),
    ],
    "weak-type-cache-split": [
        (f"{P}/engine/seeded.py",
         "def key(op, n):\n"
         "    return ExecKey(op, 'rowwise', 'cuda', None, n / 2, 'float32')\n",
         "def key(op, n):\n"
         "    return ExecKey(op, 'rowwise', 'cuda', None, n // 2, 'float32')\n"),
        # A per-request tolerance in the build key.
        (f"{P}/engine/seeded.py",
         "class Engine:\n"
         "    def submit(self, x, rtol=None):\n"
         "        return self._fns.get((x.shape, rtol), None)\n",
         "class Engine:\n"
         "    def submit(self, x, rtol=None):\n"
         "        return self._fns.get((x.shape, self.dtype), None)\n"),
        (f"{P}/solvers/seeded.py",
         "def key(op, maxiter):\n"
         "    return ExecKey(op, 'rowwise', 'cuda', None, maxiter, 'float32')\n",
         "def key(op, steps):\n"
         "    return ExecKey(op, 'rowwise', 'cuda', None, steps, 'float32')\n"),
    ],
    "unhashable-static-arg": [
        (f"{P}/engine/seeded.py",
         "def key(op, parts):\n"
         "    return ExecKey(op, 'rowwise', 'cuda', [p for p in parts], 1, 'float32')\n",
         "def key(op, parts):\n"
         "    return ExecKey(op, 'rowwise', 'cuda', tuple(parts), 1, 'float32')\n"),
        (f"{P}/engine/seeded.py",
         "class Engine:\n"
         "    def program(self, x):\n"
         "        return self._cache.get(lambda: x, None)\n",
         "class Engine:\n"
         "    def program(self, x):\n"
         "        return self._cache.get(x, None)\n"),
        (f"{P}/engine/seeded.py",
         "def key(op, combine):\n"
         "    return ExecKey(op=op, strategy='rowwise', kernel='cuda',\n"
         "                   combine={'name': combine}, bucket=1, dtype='float32')\n",
         "def key(op, combine):\n"
         "    return ExecKey(op=op, strategy='rowwise', kernel='cuda',\n"
         "                   combine=combine, bucket=1, dtype='float32')\n"),
    ],
    "host-sync-on-tracer": [
        (f"{P}/solvers/seeded.py",
         "import torch\n"
         "def norm(v):\n"
         "    return float(torch.linalg.vector_norm(v))\n",
         "import torch\n"
         "def norm(v):\n"
         "    return torch.linalg.vector_norm(v)\n"),
        (f"{P}/engine/seeded.py",
         "import torch\n"
         "def settle(flags):\n"
         "    stacked = torch.stack(flags)\n"
         "    return stacked.tolist()\n",
         "import torch\n"
         "def settle(flags):\n"
         "    return torch.stack(flags)\n"),
        # Which VALUES are tensors: a shape read is host metadata.
        (f"{P}/engine/seeded.py",
         "import numpy as np\n"
         "import torch\n"
         "def host(x):\n"
         "    y = torch.abs(x)\n"
         "    return np.asarray(y)\n",
         "import numpy as np\n"
         "import torch\n"
         "def host(x):\n"
         "    y = torch.abs(x)\n"
         "    return np.asarray(y.shape)\n"),
    ],
}


def _seed(root: Path, rel: str, text: str) -> None:
    path = root / rel
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(text)


def test_rules_keep_the_jax_names_markers_and_scopes():
    assert set(DATAFLOW_RULES) == set(dataflow.DATAFLOW_RULES)
    for name in DATAFLOW_RULES:
        assert RULES[name].marker == JRULES[name].marker
    assert {scope_label(n) for n in DATAFLOW_RULES} == {"package", "engine/, solvers/"}
    assert scope_label("host-sync-on-tracer") == "engine/, solvers/"


@pytest.mark.parametrize("rule,case", [(r, i) for r, cases in FIXTURES.items()
                                       for i in range(len(cases))])
def test_rule_flags_bad_and_passes_clean(rule, case, tmp_path):
    rel, bad, clean = FIXTURES[rule][case]
    _seed(tmp_path, rel, bad)
    found = run_rules(root=tmp_path, rules=[rule])
    assert any(f.rule == rule and f.path == rel for f in found), found
    _seed(tmp_path, rel, clean)
    assert [f for f in run_rules(root=tmp_path, rules=[rule]) if f.rule == rule] == []


def test_scopes_hold(tmp_path):
    """Tests and chip_smoke.py drive engines from host code: out of scope.
    The sync rule reports over engine/ and solvers/ only."""
    bad = FIXTURES["host-sync-on-tracer"][0][1]
    _seed(tmp_path, "tests/test_torch_seeded.py", bad)
    _seed(tmp_path, f"{P}/ops/seeded.py", bad)
    assert run_rules(root=tmp_path, rules=list(DATAFLOW_RULES)) == []


def test_marker_with_a_reason_exempts_and_a_stale_one_is_a_finding(tmp_path):
    rel = f"{P}/solvers/seeded.py"
    _seed(tmp_path, rel, "import torch\ndef norm(v):\n"
          "    return float(torch.linalg.vector_norm(v))  # tracer-sync-ok: one read a trip\n")
    assert run_rules(root=tmp_path) == []
    _seed(tmp_path, rel, "import torch\ndef norm(v):\n"
          "    return float(torch.linalg.vector_norm(v))  # tracer-sync-ok:\n")
    assert {f.rule for f in run_rules(root=tmp_path)} == {"marker-missing-reason"}
    _seed(tmp_path, rel, "import torch\ndef norm(v):\n"
          "    return torch.linalg.vector_norm(v)  # tracer-sync-ok: nothing reads here\n")
    assert [f.rule for f in run_rules(root=tmp_path)] == ["stale-marker"]


def test_a_longer_marker_is_not_a_shorter_one(tmp_path):
    """``tracer-sync-ok:`` neither exempts nor stales ``engine-host-sync``'s
    ``sync-ok:``."""
    rel = f"{P}/engine/seeded.py"
    _seed(tmp_path, rel, "import torch\ndef dispatch(y):\n"
          "    return y.cpu()  # tracer-sync-ok: a read\n")
    assert [f.rule for f in run_rules(root=tmp_path, rules=["engine-host-sync"])] == [
        "engine-host-sync"]
    _seed(tmp_path, rel, "import numpy as np\ndef host(x):\n"
          "    if isinstance(x, list):\n        return x\n"
          "    return np.asarray(x)  # tracer-sync-ok: x is no tensor here\n")
    assert [f.rule for f in run_rules(root=tmp_path)] == ["stale-marker"]


def test_dataflow_cache_invalidates_on_edit(tmp_path):
    """The twin of the JAX package's test: the whole-program analysis keys
    on content, so an edit between runs gives the new verdict."""
    rel, bad, clean = FIXTURES["traced-python-branch"][0]
    _seed(tmp_path, rel, clean)
    assert run_rules(root=tmp_path, rules=["traced-python-branch"]) == []
    _seed(tmp_path, rel, bad)
    found = run_rules(root=tmp_path, rules=["traced-python-branch"])
    assert any(f.rule == "traced-python-branch" for f in found), found


def test_analyze_caches_by_generation_and_content(tmp_path):
    rel, bad, clean = FIXTURES["host-sync-on-tracer"][0]
    _seed(tmp_path, rel, clean)
    dataflow.new_generation()
    first = dataflow.analyze(tmp_path)
    assert dataflow.analyze(tmp_path) is first  # same generation
    dataflow.new_generation()
    assert dataflow.analyze(tmp_path) is first  # same content
    _seed(tmp_path, rel, bad)
    dataflow.new_generation()
    second = dataflow.analyze(tmp_path)
    assert second is not first and second.findings["host-sync-on-tracer"]


def test_taint_follows_closures_and_duplicate_program_bodies(tmp_path):
    """A builder that defines one program body per branch, each closing
    over a device value: every body is analyzed."""
    rel = f"{P}/solvers/seeded.py"
    _seed(tmp_path, rel,
          "import torch\n"
          "def build(op):\n"
          "    scale = torch.ones(())\n"
          "    if op == 'a':\n"
          "        def solver(b):\n"
          "            return b\n"
          "        return solver\n"
          "    def solver(b):\n"
          "        return int(scale)\n"
          "    return solver\n")
    found = run_rules(root=tmp_path, rules=["host-sync-on-tracer"])
    assert [(f.rule, f.line) for f in found] == [("host-sync-on-tracer", 9)]


def test_the_port_s_tree_is_clean_under_the_dataflow_rules():
    findings = run_rules(rules=list(DATAFLOW_RULES))
    assert findings == [], "\n".join(f"{f.location}: [{f.rule}] {f.message}"
                                     for f in findings)
