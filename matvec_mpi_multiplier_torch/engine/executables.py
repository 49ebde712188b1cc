"""Executable cache: build once, dispatch forever.

The port's counterpart of the JAX package's ``engine/executables.py``.
PyTorch runs eagerly, so there is no lowering to compile: a "compile" here
is one build of the key's strategy function (``MatvecStrategy.build`` or
``build_batched``) and, on a mesh that lies on one CUDA device, the capture
of its program as a CUDA graph (``engine/core.py``), held under an explicit
key (op × strategy × kernel × combine × bucket × dtype × storage) with
compile and hit counters the serve bench reports — a flat ``compiles``
across a warm stream is the zero-recompilation criterion. Lowering
fingerprints belong to the static-analysis item (ROADMAP.md, queue A 6).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

from ..obs.registry import Counter


class ExecKey(NamedTuple):
    """Identity of one built program in the cache."""

    op: str  # "matvec" | "gemm"
    strategy: str
    kernel: str
    combine: str | None
    bucket: int  # RHS columns (1 for the matvec path)
    dtype: str
    # Resident-A storage format: "native", or int8/int8c/fp8 (ops/quantize.py).
    storage: str = "native"

    def label(self) -> str:
        """Canonical ``op:strategy:kernel:combine:bucket:dtype[:storage]``
        string, as the JAX package spells it (a None combine reads as
        ``default``; the storage suffix appears only for non-native
        storage)."""
        combine = self.combine if self.combine is not None else "default"
        base = (
            f"{self.op}:{self.strategy}:{self.kernel}:{combine}:"
            f"{self.bucket}:{self.dtype}"
        )
        return base if self.storage == "native" else f"{base}:{self.storage}"


@dataclasses.dataclass
class ExecStats:
    """Counters the serve bench reports (a point-in-time view of the
    cache's registry counters)."""

    compiles: int = 0
    hits: int = 0


class ExecutableCache:
    """Built programs keyed by :class:`ExecKey`.

    ``get(key, build)`` returns the cached program or makes it with
    ``build()``, which returns the callable. Counting goes through obs
    counters: pass the engine's registry counters to share one source of
    truth with its metrics snapshot, or let the cache own private ones.
    """

    def __init__(
        self,
        compile_counter: Counter | None = None,
        hit_counter: Counter | None = None,
    ) -> None:
        self._executables: dict[ExecKey, Any] = {}
        self._compiles = compile_counter or Counter("compiles")
        self._hits = hit_counter or Counter("hits")

    @property
    def stats(self) -> ExecStats:
        return ExecStats(compiles=self._compiles.value, hits=self._hits.value)

    def get(self, key: ExecKey, build: Callable[[], Callable]) -> Callable:
        exe = self._executables.get(key)
        if exe is not None:
            self._hits.inc()
            return exe
        exe = build()
        self._executables[key] = exe
        self._compiles.inc()
        return exe

    def clear(self) -> list:
        """Drop every built program (the engine's reshard: programs close
        over the old layout's shards) and return them, so the caller decides
        when their buffers may go. The compile counter keeps counting
        builds: a key built again counts again."""
        dropped = list(self._executables.values())
        self._executables.clear()
        return dropped

    def keys(self) -> list[ExecKey]:
        """The ExecKeys built so far (insertion order)."""
        return list(self._executables)

    def __len__(self) -> int:
        return len(self._executables)

    def __contains__(self, key: ExecKey) -> bool:
        return key in self._executables
