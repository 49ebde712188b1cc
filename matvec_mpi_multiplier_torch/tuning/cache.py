"""Persistent tuning cache: measured decisions, keyed by configuration and
platform fingerprint.

The port's counterpart of the JAX package's ``tuning/cache.py``, with the
same file: one versioned JSON document (default
``<data_dir>/out/tuning_cache.json``, or the ``MATVEC_TUNING_CACHE`` env
var, or an explicit path) whose entries each record one *decision* — the
measured winner for one configuration — under a key that embeds the
**platform fingerprint**. The port's fingerprint names PyTorch and the card
(:func:`platform_fingerprint`); it never begins like the JAX package's
(``tpu:...``, ``cpu:...``), so the two packages may share one file and no
entry of one ever applies to the other: each reads the other's entries as
misses, and a save keeps every entry it did not write.

Schema (version 6, the JAX package's)::

    {
      "version": 6,
      "entries": {
        "<fingerprint>|gemv|<m>x<k>|<dtype>":
            {"kernel": "cuda", "route": "split", "blocks_per_sm": 1,
             "time_s": ..., "candidates": {"torch": ..., "cuda": ...}},
        "<fingerprint>|gemm|<m>x<k>x<n>|<dtype>":
            {"kernel": "cuda", "route": "ffma", "bn": 32, "stages": 6, ...},
        "<fingerprint>|combine|<op>|<strategy>|<m>x<k>|p<p>|<dtype>":
            {"combine": "psum_scatter", "time_s": ..., "candidates": {...}},
        "<fingerprint>|promote|<strategy>|<m>x<k>|p<p>|<dtype>":
            {"b_star": 4, "seq_time_s": ..., "gemm_times": {"4": ...}},
        "<fingerprint>|overlap|<strategy>|<m>x<k>|p<p>|<dtype>":
            {"stages": 4, "time_s": ..., "candidates": {"1": ..., "2": ...}},
        "<fingerprint>|storage|<strategy>|<m>x<k>|p<p>|<dtype>":
            {"storage": "int8", "time_s": ..., "candidates": {...},
             "resident_bytes": {...}, "bandwidth_gbps": {...}},
        "<fingerprint>|solver_kernel|<op>|<strategy>|<m>x<k>|p<p>|<dtype>|<storage>":
            {"solver_kernel": "cuda_fused", "time_s": ..., "iter_s": ...},
        "<fingerprint>|calibration|p<p>": {...}
      }
    }

The kernel tiers' names are the port's (``torch``, ``cuda``,
``cuda_fused``), the JAX package's are its own (``xla``, ``pallas``,
``pallas_fused``); a key's fingerprint says whose an entry is. The
``calibration`` kind holds the cost model's machine constants
(``cost_model.py``), in the JAX package's record. Versions 1-5 load as they are
(their entries are strict subsets of version 6's).

``gemv``/``gemm`` keys use the LOCAL (per-shard) shape the kernel registry's
``auto`` tier dispatches on; the other kinds the GLOBAL shape and the mesh
size.

Corruption: a file that exists but cannot be used (truncated, garbage, a
schema this build cannot read) loads as **empty and quarantined**: dispatch
falls back to the static defaults, and the next :meth:`TuningCache.save`
moves the file to ``<name>.corrupt`` (a shape-valid future version to
``<name>.v<N>.corrupt``) instead of overwriting it. A save writes a
temporary file and renames it over the cache, so a run killed mid-save
never leaves a truncated file.
"""

from __future__ import annotations

import functools
import json
import os
import platform
import tempfile
from pathlib import Path
from typing import Any

CACHE_VERSION = 6
# Versions load() accepts: v1-v5 entries are strict subsets of v6's.
COMPATIBLE_VERSIONS = (1, 2, 3, 4, 5, CACHE_VERSION)
CACHE_ENV = "MATVEC_TUNING_CACHE"
CACHE_FILENAME = "tuning_cache.json"


def default_cache_path(root: str | os.PathLike | None = None) -> Path:
    """The cache file: the env override (when no ``root`` is given), else
    ``<data_dir>/out/tuning_cache.json`` beside the benchmark CSVs — the
    JAX package's path, so both packages find the same file."""
    env = os.environ.get(CACHE_ENV)
    if root is None and env:
        return Path(env)
    from ..utils.constants import OUT_SUBDIR
    from ..utils.io import data_dir

    return data_dir(root) / OUT_SUBDIR / CACHE_FILENAME


@functools.cache
def platform_fingerprint() -> str:
    """The identity decisions are keyed under: PyTorch and the card (name,
    compute capability, torch and CUDA versions) on a CUDA machine, PyTorch
    and the CPU elsewhere. A measured winner transfers across none of
    them, so a mismatch on any component reads as a miss. Always begins
    with ``torch-``: no fingerprint of the JAX package does."""
    import torch

    if torch.cuda.is_available():
        major, minor = torch.cuda.get_device_capability(0)
        kind = torch.cuda.get_device_name(0)
        return _clean(f"torch-cuda:{kind}:sm_{major}{minor}:"
                      f"torch-{torch.__version__}:cuda-{torch.version.cuda}")
    cpu = platform.processor() or platform.machine() or "unknown"
    return _clean(f"torch-cpu:{cpu}:torch-{torch.__version__}")


def _clean(fingerprint: str) -> str:
    # "|" separates a key's fields; spaces read badly in a key.
    return fingerprint.replace("|", "_").replace(" ", "_")


def _fp(fingerprint: str | None) -> str:
    return fingerprint if fingerprint is not None else platform_fingerprint()


def gemv_key(m: int, k: int, dtype: str, fingerprint: str | None = None) -> str:
    """Key for a local-GEMV kernel decision (LOCAL per-shard shape)."""
    return f"{_fp(fingerprint)}|gemv|{m}x{k}|{dtype}"


def gemm_key(m: int, k: int, n: int, dtype: str,
             fingerprint: str | None = None) -> str:
    """Key for a local-GEMM kernel decision (LOCAL per-shard shape)."""
    return f"{_fp(fingerprint)}|gemm|{m}x{k}x{n}|{dtype}"


def combine_key(op: str, strategy: str, m: int, k: int, p: int, dtype: str,
                fingerprint: str | None = None) -> str:
    """Key for a combine-schedule decision (GLOBAL shape + mesh size)."""
    return f"{_fp(fingerprint)}|combine|{op}|{strategy}|{m}x{k}|p{p}|{dtype}"


def promote_key(strategy: str, m: int, k: int, p: int, dtype: str,
                fingerprint: str | None = None) -> str:
    """Key for a GEMV→GEMM promotion crossover (GLOBAL shape + mesh size)."""
    return f"{_fp(fingerprint)}|promote|{strategy}|{m}x{k}|p{p}|{dtype}"


def overlap_key(strategy: str, m: int, k: int, p: int, dtype: str,
                fingerprint: str | None = None) -> str:
    """Key for a staged-overlap stage count (GLOBAL shape + mesh size)."""
    return f"{_fp(fingerprint)}|overlap|{strategy}|{m}x{k}|p{p}|{dtype}"


def storage_key(strategy: str, m: int, k: int, p: int, dtype: str,
                fingerprint: str | None = None) -> str:
    """Key for a resident-A storage format (GLOBAL shape + mesh size; no op:
    one residency serves both the matvec and the GEMM path)."""
    return f"{_fp(fingerprint)}|storage|{strategy}|{m}x{k}|p{p}|{dtype}"


def solver_kernel_key(op: str, strategy: str, m: int, k: int, p: int,
                      dtype: str, storage: str,
                      fingerprint: str | None = None) -> str:
    """Key for a solver iteration tier, per (op, strategy, GLOBAL shape,
    mesh size, resident storage)."""
    return (f"{_fp(fingerprint)}|solver_kernel|{op}|{strategy}|{m}x{k}|p{p}|"
            f"{dtype}|{storage}")


def calibration_key(p: int, fingerprint: str | None = None) -> str:
    """Key for a cost-model calibration record (``cost_model.calibrate``;
    the JAX package's kind and record, so either package reads the
    other's)."""
    return f"{_fp(fingerprint)}|calibration|p{p}"


def _read(path: Path) -> tuple[dict | None, bool, int | None]:
    """``(entries, quarantined, future_version)`` of the file at ``path``:
    entries None for a missing or unusable file."""
    try:
        text = path.read_text()
    except OSError:
        return None, False, None  # missing or unreadable: no evidence
    try:
        raw = json.loads(text)
    except json.JSONDecodeError:
        return None, True, None
    if (not isinstance(raw, dict)
            or raw.get("version") not in COMPATIBLE_VERSIONS
            or not isinstance(raw.get("entries"), dict)):
        version = raw.get("version") if isinstance(raw, dict) else None
        future = (version if isinstance(version, int)
                  and not isinstance(version, bool)
                  and isinstance(raw.get("entries"), dict) else None)
        return None, True, future
    return ({str(k): v for k, v in raw["entries"].items() if isinstance(v, dict)},
            False, None)


class TuningCache:
    """In-memory view of the JSON cache file, with atomic persistence.

    ``quarantined`` marks a cache whose file existed but could not be used:
    it loads empty, and the first :meth:`save` moves the file to
    :attr:`corrupt_path` rather than overwriting it. A missing file is not
    quarantined (there is nothing to keep)."""

    def __init__(self, path: str | os.PathLike | None = None):
        self.path = Path(path) if path is not None else default_cache_path()
        self.entries: dict[str, dict[str, Any]] = {}
        self.quarantined = False
        self._quarantine_version: int | None = None

    @property
    def corrupt_path(self) -> Path:
        """Where :meth:`save` parks an unusable file: ``<name>.corrupt`` for
        damage (each quarantine replaces the last), ``<name>.v<N>.corrupt``
        for a shape-valid file of an unknown version N (never replaced by
        later damage)."""
        if self._quarantine_version is not None:
            return self.path.with_name(
                f"{self.path.name}.v{self._quarantine_version}.corrupt")
        return self.path.with_name(self.path.name + ".corrupt")

    @classmethod
    def load(cls, path: str | os.PathLike | None = None) -> "TuningCache":
        """Read the cache file; a missing or unusable file loads empty (a
        corrupt cache never breaks a sweep), an unusable one quarantined."""
        cache = cls(path)
        entries, cache.quarantined, cache._quarantine_version = _read(cache.path)
        if entries is not None:
            cache.entries = entries
        return cache

    def lookup(self, key: str) -> dict[str, Any] | None:
        """The decision recorded under ``key``, or None (a miss — every
        fingerprint mismatch included)."""
        return self.entries.get(key)

    def record(self, key: str, decision: dict[str, Any]) -> None:
        self.entries[key] = decision

    def save(self) -> Path:
        """Persist atomically (a temporary file renamed over the cache).

        Entries another writer saved to the file since this cache was
        loaded are kept (this cache's own win on a shared key), so the port
        and the JAX package may tune into one file. Only the coordinator
        process writes (the port's mesh is one process)."""
        from ..parallel.distributed import is_main_process

        if not is_main_process():
            return self.path
        self.path.parent.mkdir(parents=True, exist_ok=True)
        if self.quarantined:
            try:
                os.replace(self.path, self.corrupt_path)
            except OSError:
                pass  # the file vanished since load: nothing left to keep
            self.quarantined = False
        else:
            on_disk, damaged, _ = _read(self.path)
            if on_disk and not damaged:
                self.entries = {**on_disk, **self.entries}
        payload = {"version": CACHE_VERSION, "entries": self.entries}
        fd, tmp = tempfile.mkstemp(dir=self.path.parent, prefix=self.path.name,
                                   suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(payload, f, indent=1, sort_keys=True)
                f.write("\n")
            os.replace(tmp, self.path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        return self.path

    def __len__(self) -> int:
        return len(self.entries)


def broadcast_decisions(cache: TuningCache) -> TuningCache:
    """Replace every process's entries with the coordinator's (process 0).

    Each process reading its own copy of the file could dispatch different
    schedules of one sharded program, and the processes would wait on each
    other's exchanges for ever. So only the coordinator reads the file
    (``tuning.get_cache``), and its entries go to every process through the
    process group (``parallel/distributed.py``): the length first (every
    process must post an equal buffer), then the bytes. A world of one
    returns ``cache`` as it is.
    """
    from ..parallel.distributed import process_count, process_index

    if process_count() == 1:
        return cache
    import torch
    import torch.distributed as dist

    root = process_index() == 0
    payload = json.dumps(cache.entries).encode() if root else b""
    n = torch.tensor([len(payload)], dtype=torch.int64)
    dist.broadcast(n, src=0)
    buf = torch.zeros(int(n), dtype=torch.uint8)
    if root:
        buf.copy_(torch.frombuffer(bytearray(payload), dtype=torch.uint8))
    dist.broadcast(buf, src=0)
    entries = json.loads(bytes(buf.numpy()).decode() or "{}")
    cache.entries = {
        str(k): v for k, v in entries.items() if isinstance(v, dict)
    }
    return cache
