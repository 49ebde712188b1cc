"""Profiling: ``torch.profiler`` trace capture around benchmark regions.

The port's counterpart of the JAX package's ``bench/profiling.py``.
Reference analog: §5.1 — the reference has no tracer; its only profiling is
the manual barrier/Wtime protocol (C9), which ``bench/timing.py``
reproduces. This module adds what the reference lacked: a trace of the
benchmark region (host ops and, on a card, the kernels) as a Chrome-trace
JSON that Perfetto, ``chrome://tracing`` and TensorBoard's profile plugin
read.

Two annotation layers compose inside a :func:`trace` capture:

* :func:`annotate` — a host span around a benchmark region (the sweep
  wraps each config in one);
* :func:`named_span` (re-exported from ``obs/annotations``, so that
  ``parallel``/``models`` use it without importing ``bench``) — spans
  inside the strategies: each local GEMV, each combine schedule, each
  overlap stage (``stage{i}/compute`` / ``stage{i}/combine``). Off by
  default; ``--annotate`` on the serve/sweep CLIs, ``MATVEC_ANNOTATE=1``
  or :func:`set_annotations` turn them on. A span is host code: under a
  CUDA graph replay (the ``loop`` measure, the engine's captured programs)
  it is recorded at the capture only, so a trace that should name every
  rep's spans times with ``--measure sync`` or ``chain``.
"""

from __future__ import annotations

import contextlib
import os
from pathlib import Path

import torch

from ..obs.annotations import (  # noqa: F401  (public re-exports)
    annotations,
    annotations_enabled,
    named_span,
    set_annotations,
)
from ..utils.errors import ConfigError

_PROBE_SPAN = "profiling/cupti_probe"


@contextlib.contextmanager
def trace(log_dir: str | os.PathLike, *, enabled: bool = True,
          cuda: bool | None = None):
    """Capture a trace of the enclosed region into ``log_dir``.

    ``cuda`` asks for the card's activity beside the host's (default:
    whenever CUDA is available). It is never dropped quietly: without
    CUPTI support the capture raises, and a capture that recorded no device
    event for a probe kernel launched at its end raises after writing.
    ``enabled=False`` turns this into a no-op so call sites can thread a
    ``--profile-dir`` flag through unconditionally.
    """
    if not enabled:
        yield None
        return
    if cuda is None:
        cuda = torch.cuda.is_available()
    activities = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        if torch.profiler.ProfilerActivity.CUDA not in torch.profiler.supported_activities():
            raise ConfigError(
                "a CUDA trace was asked for, but this PyTorch's profiler has "
                "no CUDA activity (no CUPTI): nothing of the card would be "
                "recorded"
            )
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(
        activities=activities,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(str(log_dir)),
        acc_events=True,
    ) as prof:
        yield log_dir
        if cuda:
            with torch.profiler.record_function(_PROBE_SPAN):
                torch.ones(1, device="cuda").add_(1)
            torch.cuda.synchronize()
    if cuda and not any(
        e.device_type == torch.autograd.DeviceType.CUDA for e in prof.events()
    ):
        raise RuntimeError(
            f"the trace in {log_dir} holds no device event, not even the "
            "probe kernel's: CUPTI did not record the card"
        )


def annotate(name: str):
    """Named sub-region inside a trace (a host span in the viewer)."""
    return torch.profiler.record_function(name)
