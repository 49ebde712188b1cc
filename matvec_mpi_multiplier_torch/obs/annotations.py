"""Named trace spans: make profiler captures read by phase.

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

_override: bool | None = None  # None -> consult the environment


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
