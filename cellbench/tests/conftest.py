"""Fixtures for the benchmark's own tests (``python -m pytest cellbench/tests``).

The tests run the harness on the CPU at a small size through a copy of the
benchmark's data files in a temporary root; tests marked ``cuda`` run it on
a card and skip without one.
"""

import json
import shutil
import tempfile
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[2]
HARNESS = REPO / "cellbench"


def make_root(tmp: Path, n: int = 256) -> Path:
    """A benchmark root with the real ``BENCHMARK.json`` and data files,
    every configuration cut to ``n`` × ``n``."""
    for sub in ("configs", "traffic", "metrics"):
        shutil.copytree(HARNESS / sub, tmp / "cellbench" / sub)
    for path in (tmp / "cellbench" / "configs").glob("*.json"):
        cfg = json.loads(path.read_text())
        cfg["m"] = cfg["k"] = n
        path.write_text(json.dumps(cfg))
    shutil.copy(REPO / "BENCHMARK.json", tmp / "BENCHMARK.json")
    return tmp


@pytest.fixture
def small_root(tmp_path, monkeypatch):
    # A traced run writes its Chrome trace under the temporary directory.
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path / "tmp"))
    (tmp_path / "tmp").mkdir()
    return make_root(tmp_path / "root")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: python -m pytest -m cuda cellbench/tests")
    return torch.device("cuda", 0)
