"""``BENCHMARK.json`` against the benchmark's format rules, and a cell, a
configuration and a per-layer metric added as files alone."""

import json
import shutil

import pytest

from cellbench.harness import spec
from cellbench.harness.runner import run_cell

from conftest import HARNESS, REPO

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())

KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def test_benchmark_has_no_problems():
    assert spec.problems(BENCH, REPO) == []
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}


@pytest.mark.parametrize("kind", sorted(KEYS))
def test_entries_have_exactly_the_format_keys(kind):
    for entry in BENCH[kind]:
        assert set(entry) - {"workloads"} == KEYS[kind], entry["name"]


def test_names_and_units_match_the_rules():
    entries = [e for kind in KEYS for e in BENCH[kind]]
    for e in entries:
        assert spec.NAME_RE.fullmatch(e["name"]), e["name"]
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert spec.UNIT_RE.fullmatch(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for c in BENCH["configs"]:
        assert all(spec.NAME_RE.fullmatch(k) for k in c["reduced"])
    for w in BENCH["workloads"]:
        assert spec.NAME_RE.fullmatch(w["config"]) and spec.NAME_RE.fullmatch(w["traffic"])


def test_every_cell_reports_set_up_another_end_to_end_and_a_layer():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    # A cell takes 1 card or 4, and at most a quarter of the cells, or one,
    # take 4; a four-card cell's grid holds one shard a card.
    four = [w for w in BENCH["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(BENCH["workloads"]) // 4)
    for w in BENCH["workloads"]:
        assert w["chips"] in (1, 4)
        if w["chips"] == 4:
            r, c = spec.load_config(BENCH, REPO, w["config"])["grid"]
            assert r * c == 4, w["name"]
        names = {m["name"] for m in spec.metrics_of(BENCH, "end_to_end", w["name"])}
        assert "setup_s" in names and len(names) >= 2
        layers = spec.metrics_of(BENCH, "per_layer", w["name"])
        assert layers
        for m in layers:
            assert m["moves"] in names, (m["name"], w["name"])
            assert e2e[m["moves"]]["source"] in ("host_clock", "device_trace")
        traffic = spec.load_traffic(REPO, w["traffic"])
        assert names - {"setup_s"} <= set(traffic["report"])


def test_bounds_and_run_seconds_within_their_ranges():
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_a_cell_config_and_metric_added_as_files_alone(small_root):
    """A new configuration, traffic mix, end-to-end metric and per-layer
    reader: new files and new BENCHMARK.json entries, no edited file."""
    before = {p: p.read_bytes() for p in HARNESS.rglob("*") if p.is_file()
              and "__pycache__" not in p.parts}
    root = small_root
    (root / "cellbench" / "configs" / "tiny_fp32.json").write_text(json.dumps({
        "name": "tiny_fp32", "strategy": "rowwise", "grid": [1, 1], "m": 96, "k": 160,
        "dtype": "float32", "operand": "uniform_0_10", "limits": {"max_gap": 1e-5},
        "reduced": []}))
    traffic = json.loads((HARNESS / "traffic" / "matvec_stream.json").read_text())
    traffic["report"] = {"tiny_ms": "ms_per_call"}
    (root / "cellbench" / "traffic" / "tiny_stream.json").write_text(json.dumps(traffic))
    (root / "cellbench" / "metrics" / "calls_in_window.tiny.py").write_text(
        "def read(ctx):\n    return float(len(ctx.record.index))\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny_fp32", "source": "a test",
                             "file": "cellbench/configs/tiny_fp32.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "tiny_fp32.tiny", "config": "tiny_fp32",
                               "traffic": "tiny_stream", "chips": 1, "why": "a test"})
    bench["end_to_end"].append({"name": "tiny_ms", "unit": "ms", "better": "lower",
                                "bound": 0.05, "source": "host_clock",
                                "workloads": ["tiny_fp32.tiny"]})
    bench["per_layer"].append({"name": "calls_in_window.tiny", "unit": "count",
                               "better": "higher", "source": "host_clock", "layer": "strategy",
                               "moves": "tiny_ms", "workloads": ["tiny_fp32.tiny"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    assert spec.problems(bench, root) == []

    plain = run_cell("tiny_fp32.tiny", 5, 0.2, False, root=root, require_cuda=False)
    assert plain["correct"] and set(plain["metrics"]) == {"tiny_ms", "setup_s"}
    traced = run_cell("tiny_fp32.tiny", 6, 0.2, True, root=root, require_cuda=False)
    assert traced["correct"] and set(traced["metrics"]) == {"calls_in_window.tiny"}
    assert traced["metrics"]["calls_in_window.tiny"]["value"] == traced["attempted"]
    after = {p: p.read_bytes() for p in HARNESS.rglob("*") if p.is_file()
             and "__pycache__" not in p.parts}
    assert after == before


def test_a_missing_file_is_named(tmp_path):
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    found = spec.problems(BENCH, tmp_path)
    assert any("missing config file" in p for p in found)
    assert any("missing reader" in p for p in found)
