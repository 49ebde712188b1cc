"""The paper's deployment across four cards, ``paper_fp64_4chip``: its
configuration file run through the benchmark's harness on four logical CPU
devices at a small size, its float32 control, its readers on small
synthetic Chrome traces, and ``BENCHMARK.json`` with the cell in it."""

import json
import shutil
import sys
import tempfile
from pathlib import Path

import pytest
import torch

from cellbench.harness import drivers, roofline, spec
from cellbench.harness.devtrace import summarize
from cellbench.harness.runner import Context, run_cell, trace_path

REPO = Path(__file__).resolve().parents[1]
CONFIG = "paper_fp64_4chip"
CELL = "paper_fp64_4chip.blockwise_stream"
READERS = ("kernel_roofline.blockwise_stream", "card_busy_min.blockwise_stream",
           "peer_bytes_per_matvec.blockwise_stream", "collective_host_ms.blockwise_stream")
# Seeds whose first request is among the checked answers (one in four), so
# that a short window on a loaded host still checks one.
SEED = 2 ** 31 + 29
SEED2 = 2 ** 31 + 33


@pytest.fixture
def root(tmp_path, monkeypatch):
    """A benchmark root with the real files, the new configuration cut to
    512 x 512 and nothing else of it changed; traces land under it."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path / "tmp"))
    (tmp_path / "tmp").mkdir()
    out = tmp_path / "root"
    for sub in ("configs", "traffic", "metrics"):
        shutil.copytree(REPO / "cellbench" / sub, out / "cellbench" / sub)
    shutil.copy(REPO / "BENCHMARK.json", out / "BENCHMARK.json")
    path = out / "cellbench" / "configs" / f"{CONFIG}.json"
    cfg = json.loads(path.read_text())
    cfg["m"] = cfg["k"] = 512
    path.write_text(json.dumps(cfg))
    return out


def own_limit():
    cfg = json.loads((REPO / "cellbench" / "configs" / f"{CONFIG}.json").read_text())
    return cfg["limits"]["max_gap"]


def test_the_configuration_is_the_papers_deployment():
    bench = spec.load_benchmark(REPO)
    cfg = spec.load_config(bench, REPO, CONFIG)
    assert (cfg["strategy"], cfg["grid"], cfg["m"], cfg["k"], cfg["dtype"], cfg["operand"],
            cfg["tf32"]) == ("blockwise", [2, 2], 131072, 131072, "float64", "uniform_0_10",
                             False)
    entry, = [c for c in bench["configs"] if c["name"] == CONFIG]
    assert cfg["reduced"] == entry["reduced"] == ["grid"]
    # A is larger than one card's 80 GB; each card holds a quarter.
    assert cfg["m"] * cfg["k"] * 8 > 80e9 and cfg["m"] * cfg["k"] * 8 / 4 == 34359738368
    cell = spec.cell(bench, CELL)
    assert (cell["config"], cell["traffic"], cell["chips"]) == (CONFIG, "matvec_stream", 4)


def test_benchmark_with_the_four_card_cell_has_no_problems():
    bench = spec.load_benchmark(REPO)
    assert spec.problems(bench, REPO) == []
    cells = bench["workloads"]
    four = [w["name"] for w in cells if w["chips"] == 4]
    assert len(cells) == 4 and four == [CELL]
    assert len(four) <= max(1, len(cells) // 4)
    assert [m["name"] for m in spec.metrics_of(bench, "end_to_end", CELL)] == [
        "matvec_ms", "setup_s"]
    layers = spec.metrics_of(bench, "per_layer", CELL)
    assert [m["name"] for m in layers] == list(READERS)
    assert all(m["moves"] == "matvec_ms" for m in layers)
    for entry in bench["configs"] + cells:
        for key in ("source", "why"):
            if key in entry:
                assert 1 <= len(entry[key]) <= 200 and "\n" not in entry[key]


def test_cut_configuration_is_correct_under_its_own_limit(root):
    result = run_cell(CELL, SEED, 0.3, False, root=root, require_cuda=False)
    assert result["correct"], result["checks"]
    assert result["checks"]["max_gap"]["limit"] == own_limit()
    assert set(result["metrics"]) == {"matvec_ms", "setup_s"}
    assert len(result["memory_peak_by_card"]) == 4


def test_float32_control_is_not_correct(root):
    sound = run_cell(CELL, SEED2, 0.3, False, root=root, require_cuda=False)
    control = run_cell(CELL, SEED2, 0.3, False, root=root, require_cuda=False,
                       system="control")
    assert sound["correct"] and not control["correct"], control["checks"]
    gap = control["checks"]["max_gap"]["value"]
    assert gap > 1000 * own_limit() > 10 * sound["checks"]["max_gap"]["value"]


def test_traced_run_reads_the_collectives_host_time(root, monkeypatch):
    """On the CPU the trace holds the mesh's spans and no device record: the
    host-time reader reads, the device readers return None."""
    monkeypatch.setattr(sys, "argv", ["cellbench/run.py", "--workload", CELL,
                                      "--seed", str(SEED), "--seconds", "0.3", "--trace", "1"])
    result = run_cell(CELL, SEED, 0.3, True, root=root, require_cuda=False)
    assert result["correct"], result["checks"]
    assert set(result["metrics"]) == {"collective_host_ms.blockwise_stream"}
    assert result["metrics"]["collective_host_ms.blockwise_stream"]["value"] > 0


# ---- the readers on synthetic traces ----

def X(name, cat, ts, dur, pid=1, tid=9, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "pid": pid, "tid": tid,
            "args": args}


PEER = "Memcpy PtoP (Device -> Device)"
BLOCK = 524288  # 65536 float64 elements
MATVEC_US = 10400.0


def four_card_trace(cards=4, peer=True, spans=True) -> dict:
    """Window [0, 100000) us, two matvecs. Each card runs one GEMV of
    10400 us a matvec, from 0 and 50000 (card i shifted by 100·i us); card
    3's second GEMV runs only 5200 us. Each matvec copies 5 blocks between
    cards, 5 us each. The stream's thread (9) spends 250 us in mesh/psum
    and 50 us in mesh/gather a matvec; another thread's span, one before
    the window and a copy before it do not count."""
    ev = [X("cellbench.window", "user_annotation", 0, 100000),
          X("mesh/psum", "user_annotation", -500, 100),
          X("mesh/psum", "user_annotation", 200, 900, tid=5),
          X("Memcpy DtoD (Device -> Device)", "gpu_memcpy", 30000, 5, device=0, bytes=8)]
    if peer:
        ev.append(X(PEER, "gpu_memcpy", -50, 5, fromDevice=1, inDevice=0, toDevice=0,
                    bytes=BLOCK))
    for start in (0.0, 50000.0):
        for card in range(cards):
            dur = MATVEC_US / 2 if (card, start) == (3, 50000.0) else MATVEC_US
            ev.append(X("gemv_rows<double>", "kernel", start + 100 * card, dur, device=card))
        if peer:
            for i, (src, dst) in enumerate(((1, 0), (3, 2), (0, 1), (2, 3), (2, 0))):
                ev.append(X(PEER, "gpu_memcpy", start + 11000 + 10 * i, 5, fromDevice=src,
                            inDevice=dst, toDevice=dst, bytes=BLOCK))
        if spans:
            ev.append(X("mesh/psum", "user_annotation", start + 10500, 250))
            ev.append(X("mesh/gather", "user_annotation", start + 10800, 50))
    return {"traceEvents": ev}


def context(trace, tmp_path, monkeypatch, seed=7):
    """The readers' context for ``trace``, written where this run's trace
    is found (``program_spans.this_run``)."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    path = trace_path(CELL, seed)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(trace))
    monkeypatch.setattr(sys, "argv", ["cellbench/run.py", "--workload", CELL,
                                      "--seed", str(seed), "--seconds", "10", "--trace", "1"])
    cfg = {"m": 131072, "k": 131072, "dtype": "float64"}
    record = drivers.Record(index=[0, 1])
    cards = [torch.device("cuda", i) for i in range(4)]
    return Context(cfg, {}, record, summarize(trace), {}, {}, cards)


def read(name, ctx):
    return spec.load_reader(REPO, name)(ctx)


def test_readers_on_a_four_card_trace(tmp_path, monkeypatch):
    ctx = context(four_card_trace(), tmp_path, monkeypatch)
    least = (131072 * 131072 + 2 * 131072) * 8 / 3.35e12
    kernel_s = (8 * MATVEC_US - MATVEC_US / 2) * 1e-6
    assert read(READERS[0], ctx) == pytest.approx(100 * 2 * least / kernel_s)
    assert roofline.matvec_work(131072, 131072, "float64").least_seconds() == pytest.approx(least)
    # card 3: its GEMVs, 10400 + 5200 us, and the two copies into it, 5 us each
    assert read(READERS[1], ctx) == pytest.approx(100 * (15600 + 2 * 5) / 100000)
    assert read(READERS[2], ctx) == 5 * BLOCK == 2_621_440
    assert read(READERS[3], ctx) == pytest.approx((250 + 50) * 1e-3)


def test_a_card_without_records_reads_zero(tmp_path, monkeypatch):
    ctx = context(four_card_trace(cards=3, peer=False), tmp_path, monkeypatch)
    assert read(READERS[1], ctx) == 0.0


def test_readers_return_none_where_their_records_are_missing(tmp_path, monkeypatch):
    ctx = context(four_card_trace(peer=False, spans=False), tmp_path, monkeypatch)
    assert read(READERS[2], ctx) is None
    assert read(READERS[3], ctx) is None
    empty = {"traceEvents": [X("cellbench.window", "user_annotation", 0, 100000)]}
    ctx = context(empty, tmp_path, monkeypatch, seed=8)
    assert all(read(name, ctx) is None for name in READERS)
    ctx.trace = None
    assert all(read(name, ctx) is None for name in READERS)
    ctx = context(four_card_trace(), tmp_path, monkeypatch, seed=9)
    monkeypatch.setattr(sys, "argv", ["cellbench/run.py", "--workload", CELL])
    assert read(READERS[2], ctx) is None and read(READERS[3], ctx) is None


def test_a_peer_copy_without_a_byte_count_reads_none(tmp_path, monkeypatch):
    trace = four_card_trace()
    for e in trace["traceEvents"]:
        if e["name"] == PEER:
            del e["args"]["bytes"]
    assert read(READERS[2], context(trace, tmp_path, monkeypatch)) is None
