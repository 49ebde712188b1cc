"""One run of one cell: set-up, the measured window, the check, one line.

    python3 cellbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (counted in ``setup_s``, from the start of the process to the
window's open): A made on the card from the seed, the traffic's payloads,
the program's entry built over A, and every shape the traffic uses run
once. The window runs the traffic's driver for ``--seconds``; with
``--trace 1`` under the profiler, whose trace the per-layer readers read.
Then the program is freed and the reference checks the kept answers.

A cell's ``chips`` are its cards, ``cuda:0 ... cuda:chips-1``. On more than
one, A goes from its seeded row blocks straight onto the cards, never
whole on one, and every card is synchronized, weighed and traced. The
first card holds the payloads, the answers and the reference. Each card's
memory peak is a line of standard error.

The last line of standard output is the result, a JSON object; the
numbers compared, each beside its limit, are the last lines of standard
error and the result's last key.
"""

from __future__ import annotations

import argparse
import gc
import importlib
import json
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass
from pathlib import Path

import torch

from . import drivers, operands, reference, spec
from .control import control_system
from .devtrace import TraceSummary, Tracer
from .systems import program_system, synchronize

PROGRAM = "matvec_mpi_multiplier_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "matvec_mpi_multiplier_tpu")
# PyTorch's intra-op threads on the host: the serve cell's eight clients
# each copy their request and answer, and a pool of threads for every copy
# on an eight-core host spreads its runs.
HOST_THREADS = 1


class NoDevice(RuntimeError):
    """The cell asks for more cards than this machine shows."""


@dataclass
class Context:
    """What a per-layer reader reads."""
    cfg: dict
    traffic: dict
    record: drivers.Record
    trace: TraceSummary | None
    counters_warm: dict
    counters_end: dict
    cards: list


def pick_cards(chips: int, require_cuda: bool) -> list[torch.device]:
    """The cell's cards: ``cuda:0 ... cuda:chips-1``, or as many logical
    CPU devices where no card is required."""
    if not require_cuda:
        return [torch.device("cpu")] * chips
    if not torch.cuda.is_available():
        raise NoDevice("torch.cuda.is_available() is False: the benchmark runs on a card")
    if torch.cuda.device_count() < chips:
        raise NoDevice(f"the cell asks for {chips} cards; "
                       f"torch.cuda.device_count() is {torch.cuda.device_count()}")
    return [torch.device("cuda", i) for i in range(chips)]


def trace_path(workload: str, seed: int) -> Path:
    return Path(tempfile.gettempdir()) / "cellbench" / f"{workload}.seed{seed}.trace.json"


def forbidden_modules() -> list[str]:
    """Top-level names of loaded modules that the run may not load, compared
    whole (the port's name begins with the JAX package's stem)."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def power_limit() -> str | None:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
            capture_output=True, text=True, timeout=20, check=False)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip() or None


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *,
             root: Path = spec.DEFAULT_ROOT, system: str = "program",
             require_cuda: bool = True, started: float | None = None) -> dict:
    """Run one cell once and return its result object."""
    started = time.perf_counter() if started is None else started
    if system == "program":
        importlib.import_module(PROGRAM)  # a checkout without the program fails here
    bench = spec.load_benchmark(root)
    cell = spec.cell(bench, workload)
    cfg = spec.load_config(bench, root, cell["config"])
    traffic = spec.load_traffic(root, cell["traffic"])
    cards = pick_cards(cell["chips"], require_cuda)
    device = cards[0]
    torch.backends.cuda.matmul.allow_tf32 = bool(cfg.get("tf32", False))
    torch.backends.cudnn.allow_tf32 = bool(cfg.get("tf32", False))

    # ---- set-up, timed by phase (the ``setup_phases`` key) ----
    phases = {"start_s": time.perf_counter() - started}
    mark = time.perf_counter()

    def lap(name: str) -> None:
        nonlocal mark
        synchronize(cards)
        now = time.perf_counter()
        phases[name] = now - mark
        mark = now

    pool = drivers.make_pool(traffic, cfg, seed)
    lap("payloads_s")
    if len(cards) == 1:
        a = operands.make_operand(cfg, device, seed)
    else:  # drawn as the system fills each card's block from it
        a = operands.operand_rows(cfg, device, seed)
    lap("operand_s")
    factory = program_system if system == "program" else control_system
    sut = factory(cfg, traffic, cards, a)
    del a
    prepared, warm = drivers.prepare_all(sut, pool)
    lap("place_s")
    sut.warm(warm)
    lap("warm_s")
    counters_warm = sut.counters()
    gc.collect()
    tracer = Tracer(trace, trace_path(workload, seed))
    setup_s = time.perf_counter() - started

    # ---- the window ----
    with tracer:
        record = drivers.drive(traffic, sut, prepared, pool, seconds, cards, tracer.span)
    peaks = [torch.cuda.max_memory_allocated(card) if card.type == "cuda" else 0
             for card in cards]
    counters_end = sut.counters()
    sut.close()
    del sut, prepared, warm
    gc.collect()
    for card in cards:
        if card.type == "cuda":
            with torch.cuda.device(card):
                torch.cuda.empty_cache()
    summary = tracer.summary()

    # ---- the check ----
    checked = reference.check(cfg, traffic, seed, device, pool.payloads, record)
    record.kept.clear()

    metrics = {}
    if not trace:
        quantities = record.quantities()
        for m in spec.metrics_of(bench, "end_to_end", workload):
            value = setup_s if m["name"] == "setup_s" else quantities.get(
                traffic["report"][m["name"]])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        ctx = Context(cfg, traffic, record, summary, counters_warm, counters_end, cards)
        for m in spec.metrics_of(bench, "per_layer", workload):
            value = spec.load_reader(root, m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": cell["chips"] if device.type == "cuda" else 1,
           "memory_peak_bytes": max(peaks)}
    result = {"correct": checked["correct"], "attempted": record.attempted,
              "failed": record.failed, "metrics": metrics, "device": dev}
    if summary is not None:
        dev["busy_s"] = summary.busy_s
        dev["window_s"] = summary.window_s
        result["breakdown"] = summary.breakdown()
        result["trace_file"] = str(tracer.path)
    if device.type == "cuda":
        result["power"] = power_limit()
    result["setup_phases"] = phases
    result["memory_peak_by_card"] = [[str(card), peak] for card, peak in zip(cards, peaks)]
    if record.failures:
        result["first_failure"] = record.failures[0][:500]
    result["checks"] = {
        name: ({"value": value, "least": limit} if name == "checked"
               else {"value": value, "limit": limit})
        for name, (value, limit) in checked["compared"].items()}
    return result


def main(argv: list[str] | None = None, started: float | None = None) -> int:
    p = argparse.ArgumentParser(description="Run one benchmark cell once.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    torch.set_num_threads(HOST_THREADS)
    try:
        result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                          started=started)
    except NoDevice as exc:
        print(f"cellbench: {exc}", file=sys.stderr)
        return 2
    found = forbidden_modules()
    if found:
        print(f"cellbench: the run loaded {', '.join(found)}; it may not", file=sys.stderr)
        return 3
    trace_file = result.pop("trace_file", None)
    if trace_file is not None:
        print(f"trace: {trace_file}", flush=True)
    for card, peak in result.pop("memory_peak_by_card"):
        print(f"memory_peak {card} {peak}", file=sys.stderr)
    for name, entry in result["checks"].items():
        bound = (f"least {entry['least']}" if "least" in entry else f"limit {entry['limit']}")
        print(f"check {name} {entry['value']!r} {bound}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
