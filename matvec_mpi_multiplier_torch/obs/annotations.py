"""Named trace spans: make profiler captures read by phase.

Two kinds of span, under two rules:

* **Strategy spans** (:func:`named_span`) follow the annotation switch, as
  in the JAX package (its names and its off-by-default contract are held
  to the JAX package's by ``tests/test_torch_profiling.py``).
* **Engine, solver and mesh spans** (:func:`profiler_span`) are on whenever a
  ``torch.profiler`` records, with no switch: the request tracer's phases
  (``engine/submit``, ``engine/dispatch``, ... from ``obs/tracing.py``),
  the event wait of a result's copy (``engine/host_copy_wait``) and the
  solver's loop and host reads (``solver/loop``, ``solver/host_read``,
  ``solvers/device_loop.py``), and the mesh's collectives where they move
  blocks between shards (``mesh/psum``, ``mesh/gather``,
  ``parallel/mesh.py``). They put the program's phases on the
  device trace's clock, beside the kernels they launch. A profiler records
  the spans of the threads it profiles: those of the thread that started
  it, or of every thread under ``_ExperimentalConfig(profile_all_threads=
  True)``.

The port's counterpart of the JAX package's ``obs/annotations.py``.
:func:`named_span` wraps a region in ``torch.profiler.record_function`` (so
it shows in a ``torch.profiler`` trace, ``bench/profiling.py::trace``, on
the host row above the kernels it launches) and, where CUDA is present, in
an NVTX range too (Nsight timelines). Span names are the JAX package's
(``blockwise/local_gemv``, ``blockwise/combine/psum``, …), so a capture of
either package reads the same.

PyTorch runs eagerly, so unlike the JAX package's trace-time spans these
are entered on every call while on. Under a CUDA graph replay (the ``loop``
measure, the engine's captured programs) no Python runs: a span is
recorded once, at the capture, and the replays show only the graph's
kernels. Off by default; ``--annotate`` on the serve/sweep CLIs,
``MATVEC_ANNOTATE=1`` in the environment, :func:`set_annotations` or the
:func:`annotations` context manager turn them on.
"""

from __future__ import annotations

import contextlib
import os

import torch
from torch.autograd import profiler as _autograd_profiler

_override: bool | None = None  # None -> consult the environment

# What :func:`profiler_span` returns while no profiler records: one shared
# context that does nothing.
NOT_RECORDING = contextlib.nullcontext()


def annotations_enabled() -> bool:
    """Whether :func:`named_span` annotates."""
    if _override is not None:
        return _override
    return os.environ.get("MATVEC_ANNOTATE", "0") == "1"


def set_annotations(enabled: bool | None) -> None:
    """Force annotations on or off (None restores the environment default)."""
    global _override
    _override = enabled


@contextlib.contextmanager
def annotations(enabled: bool):
    """Scoped :func:`set_annotations` (tests, captures)."""
    global _override
    saved = _override
    _override = enabled
    try:
        yield
    finally:
        _override = saved


@contextlib.contextmanager
def named_span(name: str):
    """Annotate the enclosed region with ``name`` (no-op when annotations
    are disabled). Nests like the JAX package's name stack."""
    if not annotations_enabled():
        yield
        return
    with torch.profiler.record_function(name):
        if torch.cuda.is_available():
            with torch.cuda.nvtx.range(name):
                yield
        else:
            yield


def profiler_span(name: str):
    """A ``record_function`` range named ``name`` while a ``torch.profiler``
    records, else :data:`NOT_RECORDING`; use as a context manager. No NVTX
    and no switch: off a profiler it costs one attribute read, and enters
    nothing."""
    if not _autograd_profiler._is_profiler_enabled:
        return NOT_RECORDING
    return torch.profiler.record_function(name)
