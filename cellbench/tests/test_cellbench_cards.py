"""A cell's ``chips`` reach the program: one mesh shard a card, A placed
from its seeded row blocks as the program's own placement cuts it, each
card weighed and traced, and a four-card cell added as data files alone.
On the CPU the cards are logical CPU devices; the test marked ``cuda`` runs
a four-card cell on four cards."""

import json
from pathlib import Path

import pytest
import torch

from matvec_mpi_multiplier_torch.models import get_strategy

from cellbench.harness import operands, spec, systems
from cellbench.harness.devtrace import summarize
from cellbench.harness.runner import pick_cards, run_cell

from conftest import HARNESS

CPU = torch.device("cpu")
SEED = 2 ** 31 + 99
CHUNK_ROWS = 7  # divides no card's rows below


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("grid", [(4, 1), (1, 4), (2, 2)])
@pytest.mark.parametrize("strategy", ["rowwise", "colwise", "blockwise"])
def test_row_blocks_land_where_the_program_places_them(monkeypatch, strategy, grid, dtype):
    """The stream's per-card blocks, filled from A's row blocks, are
    bitwise the program's ``strategy.place(whole A, x, mesh)``; x is the
    program's own ``shard``."""
    monkeypatch.setattr(operands, "_resident_chunk_rows", lambda k: CHUNK_ROWS)
    cfg = {"strategy": strategy, "grid": list(grid), "m": 96, "k": 160, "dtype": dtype,
           "operand": "uniform_0_10"}
    cards = pick_cards(4, require_cuda=False)
    stream = systems.StrategyStream(cfg, {}, cards, operands.operand_rows(cfg, CPU, SEED))
    whole = operands.make_operand(cfg, CPU, SEED)
    x = torch.arange(160, dtype=whole.dtype)
    want_a, want_x = get_strategy(strategy).place(whole, x, stream.mesh)
    got_a = stream.a_placed
    assert stream.mesh.devices == tuple(cards) and stream.mesh.grid == grid
    assert (got_a.shape, got_a.spec) == (want_a.shape, want_a.spec)
    for got, want in zip(got_a.shards, want_a.shards, strict=True):
        assert got.is_contiguous() and got.dtype == want.dtype
        assert torch.equal(got, want)
    got_x = stream.prepare(systems.Payload(0, x, 1))
    assert all(torch.equal(g, w) for g, w in zip(got_x.shards, want_x.shards, strict=True))
    assert torch.equal(stream.request(got_x), get_strategy(strategy).build(stream.mesh)(whole, x))


def test_spd_row_blocks_land_where_the_program_places_them(monkeypatch):
    monkeypatch.setattr(operands, "_spd_chunk_rows", lambda n: CHUNK_ROWS)
    cfg = {"strategy": "blockwise", "grid": [2, 2], "m": 64, "k": 64, "dtype": "float32",
           "operand": "spd"}
    stream = systems.StrategyStream(cfg, {}, pick_cards(4, False),
                                    operands.operand_rows(cfg, CPU, SEED))
    want = get_strategy("blockwise").place(operands.make_operand(cfg, CPU, SEED),
                                           torch.zeros(64), stream.mesh)[0]
    assert all(torch.equal(g, w) for g, w in zip(stream.a_placed.shards, want.shards,
                                                 strict=True))


def test_one_card_holds_every_shard_and_several_one_each():
    cfg = {"grid": [2, 2]}
    one = pick_cards(1, require_cuda=False)
    assert systems.program_mesh(cfg, one).devices == (CPU,) * 4
    four = [torch.device("cpu", i) for i in range(4)]
    assert systems.program_mesh(cfg, four).devices == tuple(four)
    with pytest.raises(spec.SpecError, match="does not cover"):
        systems.program_mesh(cfg, four[:2])


def _add_cell(root, name, cfg, traffic, chips, e2e):
    """A configuration, traffic mix and cell dropped in as data files and
    BENCHMARK.json entries, with an end-to-end metric of its own and a
    reader of the cell's cards."""
    (root / "cellbench" / "configs" / f"{cfg['name']}.json").write_text(json.dumps(cfg))
    (root / "cellbench" / "traffic" / f"{name}.json").write_text(json.dumps(traffic))
    (root / "cellbench" / "metrics" / f"cards.{name}.py").write_text(
        "def read(ctx):\n    return float(len(ctx.cards))\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    workload = f"{cfg['name']}.{name}"
    bench["configs"].append({"name": cfg["name"], "source": "a test",
                             "file": f"cellbench/configs/{cfg['name']}.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": workload, "config": cfg["name"], "traffic": name,
                               "chips": chips, "why": "a test"})
    bench["end_to_end"].append({"name": e2e, "unit": "ms", "better": "lower", "bound": 0.05,
                                "source": "host_clock", "workloads": [workload]})
    bench["per_layer"].append({"name": f"cards.{name}", "unit": "count", "better": "lower",
                               "source": "program_counter", "layer": "strategy", "moves": e2e,
                               "workloads": [workload]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return workload, bench


# Limits for these small cells, between the sound runs' max_gap (bf16 under
# 4e-7, fp32 1e-7, fp64 2e-15 at 256^2 on the CPU) and the control's (int8
# 9e-4, TF32 1e-4, fp32 2e-7).
LIMITS = {"bfloat16": 2e-5, "float32": 1e-5, "float64": 1e-11}


def _quad_cell(root, n=256, dtype="bfloat16"):
    cfg = {"name": f"quad_{dtype}", "strategy": "blockwise", "grid": [2, 2], "m": n, "k": n,
           "dtype": dtype, "operand": "uniform_0_10", "limits": {"max_gap": LIMITS[dtype]},
           "reduced": []}
    traffic = json.loads((HARNESS / "traffic" / "matvec_stream.json").read_text())
    traffic.update(check_one_in=1, report={"quad_ms": "ms_per_call"})
    return _add_cell(root, "quad_stream", cfg, traffic, 4, "quad_ms")


def _files():
    return {p: p.read_bytes() for p in HARNESS.rglob("*")
            if p.is_file() and "__pycache__" not in p.parts}


@pytest.mark.parametrize("dtype", sorted(LIMITS))
def test_a_four_card_stream_cell_added_as_files_alone(small_root, dtype):
    """Sound runs read correct; the control, the reference one precision
    below (int8, TF32, float32), does not."""
    before = _files()
    workload, bench = _quad_cell(small_root, dtype=dtype)
    assert spec.problems(bench, small_root) == []

    plain = run_cell(workload, 5, 0.5, False, root=small_root, require_cuda=False)
    assert plain["correct"], plain["checks"]
    assert set(plain["metrics"]) == {"quad_ms", "setup_s"}
    assert len(plain["memory_peak_by_card"]) == 4
    traced = run_cell(workload, 6, 0.5, True, root=small_root, require_cuda=False)
    assert traced["correct"], traced["checks"]
    assert traced["metrics"]["cards.quad_stream"]["value"] == 4.0
    control = run_cell(workload, 5, 0.5, False, root=small_root, require_cuda=False,
                       system="control")
    assert not control["correct"], control["checks"]
    assert control["checks"]["max_gap"]["value"] > 3 * max(plain["checks"]["max_gap"]["value"], 0)
    assert _files() == before


@pytest.mark.parametrize("dtype", sorted(LIMITS))
def test_control_from_row_blocks_is_the_whole_a_table(monkeypatch, dtype):
    from cellbench.harness.control import ProductControl

    monkeypatch.setattr(operands, "_resident_chunk_rows", lambda k: CHUNK_ROWS)
    cfg = {"m": 96, "k": 160, "dtype": dtype, "operand": "uniform_0_10"}
    dt = operands.torch_dtype(dtype)
    payloads = [systems.Payload(j, torch.rand(160, dtype=torch.float64).to(dt), 1)
                for j in range(3)] + [systems.Payload(3, torch.rand(160, 5).to(dt), 5)]
    a = operands.make_operand(cfg, CPU, SEED)
    whole = ProductControl(cfg, {}, [CPU], a)
    whole.warm(payloads)
    assert torch.equal(a, operands.make_operand(cfg, CPU, SEED))  # A left as it was
    rows = ProductControl(cfg, {}, [CPU] * 4, operands.operand_rows(cfg, CPU, SEED))
    rows.warm(payloads)
    for p in payloads:
        got, want = rows.table[p.pid], whole.table[p.pid]
        assert got.shape == (96,) + tuple(p.value.shape[1:]) and got.dtype == dt
        if dtype == "bfloat16":  # int8 sums are exact
            assert torch.equal(got, want)
        else:  # float32 sums, blocked otherwise: k roundings of float32 at most
            torch.testing.assert_close(got, want, rtol=160 * 2.0 ** -23, atol=0)


def test_a_grid_that_does_not_cover_its_cards_is_named(small_root):
    workload, bench = _quad_cell(small_root)
    cfg_path = small_root / "cellbench" / "configs" / "quad_bfloat16.json"
    cfg = json.loads(cfg_path.read_text())
    cfg["grid"] = [1, 2]
    cfg_path.write_text(json.dumps(cfg))
    found = spec.problems(bench, small_root)
    assert found == [f"the 1x2 grid of {workload} does not cover its 4 cards, one shard a card"]


def test_an_engine_entry_on_several_cards_is_refused(small_root):
    cfg = json.loads((small_root / "cellbench" / "configs" / "northstar_bf16.json").read_text())
    cfg.update(name="quad_serve_bf16", grid=[2, 2])
    traffic = json.loads((HARNESS / "traffic" / "serve_mix_c4.json").read_text())
    traffic["report"] = {"quad_serve_ms": "latency_p95_ms"}
    workload, bench = _add_cell(small_root, "quad_serve", cfg, traffic, 4, "quad_serve_ms")
    assert spec.problems(bench, small_root) == []
    with pytest.raises(spec.SpecError, match="the engine takes a whole A"):
        run_cell(workload, 5, 0.3, False, root=small_root, require_cuda=False)


def X(name, cat, ts, dur, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "args": args}


def test_one_card_trace_reads_as_before():
    """Window [0, 100) us; kernels over [10, 30) and [20, 40), a copy over
    [60, 70): busy 40 us, kernels 40 us; the gaps [0, 10), [40, 60) and
    [70, 100) go to the innermost host event open at each gap's start."""
    trace = {"traceEvents": [
        X("cellbench.window", "user_annotation", 0, 100),
        X("cellbench.enqueue", "user_annotation", 0, 90),
        X("cudaLaunchKernel", "cuda_runtime", 35, 10),
        X("cudaDeviceSynchronize", "cuda_runtime", 68, 32),
        X("gemv", "kernel", 10, 20, device=0),
        X("cast", "kernel", 20, 20, device=0),
        X("Memcpy HtoD", "gpu_memcpy", 60, 10, device=0),
        X("gemv", "kernel", 120, 10, device=0),  # after the window
    ]}
    got = summarize(trace)
    assert got.window_s == pytest.approx(100e-6)
    assert got.busy_s == pytest.approx(40e-6)
    assert got.kernel_s == pytest.approx(40e-6)
    assert got.kernels == 2
    assert got.breakdown() == {
        "device_ops": [["gemv", pytest.approx(20e-6)], ["cast", pytest.approx(20e-6)],
                       ["Memcpy HtoD", pytest.approx(10e-6)]],
        "idle_gaps": [["cudaDeviceSynchronize", pytest.approx(30e-6)],
                      ["cudaLaunchKernel", pytest.approx(20e-6)],
                      ["cellbench.enqueue", pytest.approx(10e-6)]]}
    assert got.busy_s_by_card == {0: pytest.approx(40e-6)}
    assert got.kernel_s_by_card == {0: pytest.approx(40e-6)}


def test_two_card_trace_reads_each_card():
    """Card 0 runs [10, 30) and a copy from card 1 over [70, 80); card 1
    [20, 50) and a set over [60, 65): all cards are busy 55 us, card 0 30 us
    (20 of it kernels), card 1 35 us (30 of it kernels). A peer copy names
    the card that ran it as ``inDevice``."""
    trace = {"traceEvents": [
        X("cellbench.window", "user_annotation", 0, 100),
        X("gemv", "kernel", 10, 20, device=0),
        X("gemv", "kernel", 20, 30, device=1),
        X("Memset (Device)", "gpu_memset", 60, 5, device=1),
        X("Memcpy PtoP (Device -> Device)", "gpu_memcpy", 70, 10,
          fromDevice=1, inDevice=0, toDevice=0),
    ]}
    got = summarize(trace)
    assert got.busy_s == pytest.approx(55e-6)
    assert got.kernel_s == pytest.approx(50e-6)
    assert got.kernels == 2
    assert got.busy_s_by_card == {0: pytest.approx(30e-6), 1: pytest.approx(35e-6)}
    assert got.kernel_s_by_card == {0: pytest.approx(20e-6), 1: pytest.approx(30e-6)}


@pytest.fixture
def four_cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA cards: python -m pytest -m cuda cellbench/tests")
    return [torch.device("cuda", i) for i in range(4)]


@pytest.mark.cuda
def test_a_four_card_stream_runs_on_four_cards(four_cards, small_root):
    workload, _ = _quad_cell(small_root, n=4096)
    for trace in (False, True):
        result = run_cell(workload, 23, 0.5, trace, root=small_root)
        assert result["correct"], result["checks"]
        assert result["device"]["count"] == 4
        peaks = dict(result["memory_peak_by_card"])
        assert sorted(peaks) == [str(card) for card in four_cards]
        assert all(peak > 0 for peak in peaks.values())
        assert result["device"]["memory_peak_bytes"] == max(peaks.values())
    assert result["metrics"]["cards.quad_stream"]["value"] == 4.0
    by_card = summarize(json.loads(Path(result["trace_file"]).read_text())).busy_s_by_card
    assert sorted(by_card) == [0, 1, 2, 3] and min(by_card.values()) > 0
