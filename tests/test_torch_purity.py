"""The port stands alone: it imports no JAX and nothing of the JAX package.

The AST scan covers every module of ``matvec_mpi_multiplier_torch`` and
``chip_smoke.py``. The import check runs in a subprocess, because this test
process has already imported jax (tests/conftest.py).
"""

import ast
import re
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


# The JAX package's native tier: its directory, its library and override,
# its build, and the XLA FFI surface its sources include.
JAX_NATIVE = re.compile(
    r"jax\.ffi|jax\.extend\.ffi|xla/ffi|XLA_FFI|libmatvec_gemv|"
    r"MATVEC_NATIVE_LIB\b|make -C native|parents\[2\] / \"native\""
)
NATIVE_SOURCES = sorted((PORT / "native").glob("*.cc"))


@pytest.mark.parametrize("path", SOURCES + NATIVE_SOURCES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_source_names_no_jax_native_tier(path):
    """A port module, its C++ sources and chip_smoke.py name neither the JAX
    package's native/ directory nor jax.ffi: the port builds its own copy."""
    found = JAX_NATIVE.findall(path.read_text())
    assert not found, f"{path.relative_to(ROOT)} names {found}"


def test_native_build_reads_only_the_ports_sources(tmp_path):
    from matvec_mpi_multiplier_torch.utils import native_lib

    assert NATIVE_SOURCES, "the port ships no native sources"
    assert [p.name for p in NATIVE_SOURCES] == ["gemm.cc", "gemv.cc", "textio.cc"]
    cmd = native_lib.build_command(["g++"], tmp_path / "lib.so")
    files = [Path(a) for a in cmd if a.endswith(".cc")]
    assert files == list(native_lib.sources()) == NATIVE_SOURCES
    jax_native = (ROOT / "native").resolve()
    for arg in cmd:
        assert not arg.startswith("-I"), f"the build takes an include path: {arg}"
        assert str(jax_native) not in arg and "ffi" not in arg
    assert native_lib.lib_path().resolve().is_relative_to(PORT) or \
        native_lib.LIB_ENV in os.environ
