"""Named trace spans: make profiler captures read by phase.

The port's counterpart of the JAX package's ``obs/annotations.py``.
:func:`named_span` wraps a region in an NVTX range when CUDA is present (so
it shows in ``torch.profiler`` and Nsight timelines beside the kernels it
launches) and in ``torch.profiler.record_function`` otherwise. Span names
are the JAX package's (``blockwise/local_gemv``, ``blockwise/combine/psum``,
…), so a capture of either package reads the same.

PyTorch runs eagerly, so unlike the JAX package's trace-time spans these
cost a little on every call while on. They are off by default;
``MATVEC_ANNOTATE=1`` in the environment or the :func:`annotations` context
manager turns them on.
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


@contextlib.contextmanager
def annotations(enabled: bool):
    """Force annotations on or off inside the block (tests, captures)."""
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
    if torch.cuda.is_available():
        with torch.cuda.nvtx.range(name):
            yield
    else:
        with torch.profiler.record_function(name):
            yield
