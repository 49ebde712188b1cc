"""The port stands alone: it imports no JAX and nothing of the JAX package.

The AST scan covers every module of ``matvec_mpi_multiplier_torch`` and
``chip_smoke.py``. The import check runs in a subprocess, because this test
process has already imported jax (tests/conftest.py).
"""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "matvec_mpi_multiplier_torch"
FORBIDDEN = ("jax", "jaxlib", "matvec_mpi_multiplier_tpu", "triton", "optax", "orbax")
SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
MODULES = sorted(
    ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
    for p in PORT.rglob("*.py")
)


def _imported(path: Path) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names += [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_no_jax(path):
    bad = [n for n in _imported(path) if n.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def _run(code: str) -> dict:
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        cwd=ROOT, env=env, timeout=120, check=True,
    ).stdout
    return json.loads(out.strip().splitlines()[-1])


def test_every_module_imports_without_jax_or_triton():
    loaded = _run(
        "import importlib, json, sys\n"
        f"for m in {MODULES!r}: importlib.import_module(m)\n"
        "print(json.dumps(sorted(k for k in sys.modules\n"
        f"                       if k.split('.')[0] in {FORBIDDEN!r})))\n"
    )
    assert loaded == []


def test_package_import_builds_nothing():
    """Importing the package imports no kernel module, torch or nvcc."""
    loaded = _run(
        "import json, sys\n"
        "import matvec_mpi_multiplier_torch\n"
        "print(json.dumps(sorted(k for k in sys.modules\n"
        "  if k.startswith(('torch', 'matvec_mpi_multiplier_torch.ops')))))\n"
    )
    assert loaded == []


@pytest.mark.parametrize("module", [
    "matvec_mpi_multiplier_torch.staticcheck.hlo",
    "matvec_mpi_multiplier_torch.tuning.cost_model",
    "matvec_mpi_multiplier_torch.engine.global_scheduler",
])
def test_cost_model_and_scheduler_modules_are_scanned(module):
    """The cost model, its census formulas and the global scheduler are the
    port's own copies: scanned above, and importable without JAX."""
    assert module in MODULES
    loaded = _run(
        "import importlib, json, sys\n"
        f"importlib.import_module({module!r})\n"
        "print(json.dumps(sorted(k for k in sys.modules\n"
        f"                       if k.split('.')[0] in {FORBIDDEN!r})))\n"
    )
    assert loaded == []
