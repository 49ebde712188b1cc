"""``BENCHMARK.json`` and the files it names, found by name.

A cell (an entry of ``workloads``) pairs a configuration with a traffic
mix. Everything that belongs to one of them sits in a file of its own:

- ``configs[].file``: the configuration's sizes, dtype, strategy, grid,
  operand family and the limits of its correctness check;
- ``<harness>/traffic/<traffic>.json``: the traffic mix, read by the one
  general generator (``drivers.py``);
- ``<harness>/metrics/<metric>.py``: the reader of one per-layer metric, a
  function ``read(ctx)`` that returns a number or None.

So a later cell, configuration or metric is new files and new entries,
and no edit of a file here.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from typing import Callable

HARNESS_DIR = Path(__file__).resolve().parents[1]
DEFAULT_ROOT = HARNESS_DIR.parent

NAME_RE = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT_RE = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")


class SpecError(ValueError):
    """BENCHMARK.json, or a file it names, is missing or malformed."""


def load_benchmark(root: Path = DEFAULT_ROOT) -> dict:
    path = Path(root) / "BENCHMARK.json"
    try:
        return json.loads(path.read_text())
    except FileNotFoundError:
        raise SpecError(f"no BENCHMARK.json at {path}") from None


def _by_name(entries: list, name: str, what: str) -> dict:
    for entry in entries:
        if entry["name"] == name:
            return entry
    raise SpecError(f"no {what} named {name!r} in BENCHMARK.json")


def cell(bench: dict, workload: str) -> dict:
    return _by_name(bench["workloads"], workload, "workload")


def load_config(bench: dict, root: Path, config_name: str) -> dict:
    entry = _by_name(bench["configs"], config_name, "configuration")
    return json.loads((Path(root) / entry["file"]).read_text())


def load_traffic(root: Path, traffic: str) -> dict:
    path = Path(root) / HARNESS_DIR.name / "traffic" / f"{traffic}.json"
    try:
        return json.loads(path.read_text())
    except FileNotFoundError:
        raise SpecError(f"no traffic file {path}") from None


def metrics_of(bench: dict, kind: str, workload: str) -> list[dict]:
    """The ``end_to_end`` or ``per_layer`` metrics a cell reports: those
    that list it, or list no cells at all."""
    return [m for m in bench[kind]
            if "workloads" not in m or workload in m["workloads"]]


def load_reader(root: Path, metric: str) -> Callable:
    """The ``read(ctx)`` function of ``<harness>/metrics/<metric>.py``."""
    path = Path(root) / HARNESS_DIR.name / "metrics" / f"{metric}.py"
    if not path.is_file():
        raise SpecError(f"no reader {path} for the per-layer metric {metric!r}")
    module_name = "cellbench_metric_" + re.sub(r"\W", "_", metric)
    spec = importlib.util.spec_from_file_location(module_name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def problems(bench: dict, root: Path = DEFAULT_ROOT) -> list[str]:
    """What in ``bench`` breaks the naming rules or names a missing file."""
    out = []
    names = ([c["name"] for c in bench["configs"]]
             + [w["name"] for w in bench["workloads"]]
             + [m["name"] for m in bench["end_to_end"] + bench["per_layer"]])
    for name in names:
        if not NAME_RE.fullmatch(name):
            out.append(f"bad name {name!r}")
    if len(set(names)) != len(names):
        out.append("a name is used twice")
    for c in bench["configs"]:
        for key in c["reduced"]:
            if not NAME_RE.fullmatch(key):
                out.append(f"bad reduced key {key!r}")
        if not (Path(root) / c["file"]).is_file():
            out.append(f"missing config file {c['file']}")
    files = {c["name"]: Path(root) / c["file"] for c in bench["configs"]}
    for w in bench["workloads"]:
        for key in ("config", "traffic"):
            if not NAME_RE.fullmatch(w[key]):
                out.append(f"bad {key} {w[key]!r}")
        path = files.get(w["config"])
        if w["chips"] > 1 and path is not None and path.is_file():
            r, c = json.loads(path.read_text())["grid"]
            if r * c != w["chips"]:
                out.append(f"the {r}x{c} grid of {w['name']} does not cover its "
                           f"{w['chips']} cards, one shard a card")
        if not (Path(root) / HARNESS_DIR.name / "traffic" / f"{w['traffic']}.json").is_file():
            out.append(f"missing traffic file for {w['traffic']}")
    for m in bench["end_to_end"] + bench["per_layer"]:
        if not UNIT_RE.fullmatch(m["unit"]):
            out.append(f"bad unit {m['unit']!r} of {m['name']}")
    for m in bench["per_layer"]:
        if not (Path(root) / HARNESS_DIR.name / "metrics" / f"{m['name']}.py").is_file():
            out.append(f"missing reader for {m['name']}")
    return out
