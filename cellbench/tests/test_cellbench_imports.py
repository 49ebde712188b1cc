"""What the benchmark may load: never JAX or the JAX package, and in the
reference nothing of the program. Top-level names are compared whole: the
port's name begins with the JAX package's stem."""

import ast
import json
import shutil
import subprocess
import sys

import pytest

from cellbench.harness import runner

from conftest import HARNESS, REPO

FORBIDDEN = {"jax", "jaxlib", "flax", "matvec_mpi_multiplier_tpu"}
PROGRAM = "matvec_mpi_multiplier_torch"
# The reference and what it imports of the harness.
REFERENCE_SIDE = ("reference.py", "operands.py", "control.py", "roofline.py", "stats.py")


def imported_tops(path):
    tree = ast.parse(path.read_text())
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {alias.name.split(".")[0] for alias in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            tops.add(node.module.split(".")[0])
    return tops


@pytest.mark.parametrize("path", sorted(p.relative_to(REPO).as_posix()
                                        for p in HARNESS.rglob("*.py")))
def test_no_file_imports_jax_or_the_jax_package(path):
    assert not imported_tops(REPO / path) & FORBIDDEN


@pytest.mark.parametrize("name", REFERENCE_SIDE)
def test_the_reference_side_imports_nothing_of_the_program(name):
    assert PROGRAM not in imported_tops(HARNESS / "harness" / name)


def test_loading_the_reference_loads_no_program():
    code = ("import sys, cellbench.harness.reference, cellbench.harness.control; "
            f"print(sorted({{m.split('.')[0] for m in sys.modules}} & {{'{PROGRAM}', 'jax'}}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120, check=True)
    assert out.stdout.strip() == "[]"


def test_forbidden_modules_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, f"{PROGRAM}_extra", sys)
    assert runner.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "matvec_mpi_multiplier_tpu.ops", sys)
    assert runner.forbidden_modules() == ["matvec_mpi_multiplier_tpu"]


def _run(cwd, *extra):
    return subprocess.run(
        [sys.executable, "cellbench/run.py", "--workload", "northstar_bf16.matvec",
         "--seed", "1", "--seconds", "1", "--trace", "0", *extra],
        cwd=cwd, capture_output=True, text=True, timeout=300)


def _has_result(stdout):
    lines = stdout.strip().splitlines()
    if not lines:
        return False
    try:
        return "correct" in json.loads(lines[-1])
    except ValueError:
        return False


def test_no_card_exits_nonzero_with_no_result():
    if __import__("torch").cuda.is_available():
        pytest.skip("this machine has a card")
    out = _run(REPO)
    assert out.returncode == 2 and not _has_result(out.stdout)
    assert "cuda" in out.stderr


def test_a_checkout_without_the_program_exits_nonzero(tmp_path):
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(HARNESS, tmp_path / "cellbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0 and not _has_result(out.stdout)
    assert PROGRAM in out.stderr
