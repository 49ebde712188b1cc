"""CSV metric emission (the same files as the JAX package's ``bench/metrics.py``).

Reference analog: the inline CSV bootstrap+append in each ``main``
(``src/multiplier_rowwise.c:77-88,159-170``): per-strategy file
``./data/out/<strategy>.csv``, header row ``"n_rows, n_cols, n_processes,
time"`` written once if the file is absent (``:86``), then one appended row
per run (``:168``). Plus the extended CSV with strategy/dtype/mode/throughput
columns. A file under an older header is rotated to ``.bak`` (``.bak2`` …).
"""

from __future__ import annotations

import os
from pathlib import Path

from ..parallel.distributed import is_main_process
from ..utils.constants import CSV_HEADER, CSV_HEADER_EXTENDED, OUT_SUBDIR
from ..utils.io import data_dir
from .timing import TimingResult


def out_dir(root: str | os.PathLike | None = None) -> Path:
    return data_dir(root) / OUT_SUBDIR


def csv_path(
    strategy: str, root: str | os.PathLike | None = None, mode: str = "amortized"
) -> Path:
    """Per-strategy CSV, the reference's ``./data/out/<strategy>.csv``;
    reference-mode timings land in ``<strategy>_reference.csv`` (the schema
    has no column to tell the two modes apart)."""
    suffix = "" if mode == "amortized" else f"_{mode}"
    return out_dir(root) / f"{strategy}{suffix}.csv"


def extended_csv_path(root: str | os.PathLike | None = None) -> Path:
    return out_dir(root) / "results_extended.csv"


def _append_row(path: Path, header: str, row: str) -> None:
    """Append-only write with header-schema validation: a file written under
    another header is rotated to ``<name>.bak`` (``.bak2`` … if taken) and a
    fresh file started, so rows never land misaligned with their header."""
    path.parent.mkdir(parents=True, exist_ok=True)
    is_new = True
    if path.exists():
        with open(path) as f:
            existing = f.readline().rstrip("\n")
        if existing == header:
            is_new = False
        elif existing:  # non-empty stale header: rotate; empty file: reuse
            bak = path.with_suffix(path.suffix + ".bak")
            n = 2
            while bak.exists():
                bak = path.with_suffix(f"{path.suffix}.bak{n}")
                n += 1
            path.rename(bak)
    with open(path, "a") as f:
        if is_new:
            f.write(header + "\n")
        f.write(row + "\n")


def append_result(result: TimingResult, root: str | os.PathLike | None = None) -> Path:
    """Append one result in the reference schema (+ the extended CSV).

    Row format mirrors ``fprintf(..., "%ld, %ld, %d, %f\\n", ...)`` at
    ``src/multiplier_rowwise.c:168``: comma+space separated, time with 6
    decimal places. Only the coordinator process writes.
    """
    path = csv_path(result.strategy, root, mode=result.mode)
    if not is_main_process():
        return path
    row = (
        f"{result.n_rows}, {result.n_cols}, {result.n_devices}, "
        f"{result.mean_time_s:.6f}"
    )
    _append_row(path, CSV_HEADER, row)

    ext_row = (
        f"{result.n_rows}, {result.n_cols}, {result.n_devices}, "
        f"{result.mean_time_s:.6f}, {result.strategy}, {result.dtype}, "
        f"{result.mode}, {result.measure}, {result.gflops:.4f}, "
        f"{result.gbps:.4f}, {result.n_rhs}"
    )
    _append_row(extended_csv_path(root), CSV_HEADER_EXTENDED, ext_row)
    return path


def read_csv(path: str | os.PathLike) -> list[dict]:
    """Parse a reference-schema or extended CSV into row dicts (numbers
    converted). Reads both the spaced header the reference's code writes
    (``src/multiplier_rowwise.c:86``, what this module emits) and the
    unspaced one of the CSVs the reference committed (quirk Q10)."""
    path = Path(path)
    lines = [ln.strip() for ln in path.read_text().splitlines() if ln.strip()]
    if not lines:
        return []
    keys = [k.strip() for k in lines[0].split(",")]
    rows = []
    for ln in lines[1:]:
        vals = [v.strip() for v in ln.split(",")]
        row: dict = {}
        for k, v in zip(keys, vals):
            try:
                row[k] = int(v)
            except ValueError:
                try:
                    row[k] = float(v)
                except ValueError:
                    row[k] = v
        rows.append(row)
    return rows
