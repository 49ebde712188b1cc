"""CUDA graphs: capture a program once, replay it, keep the launch counts true.

The port's counterpart of what ``jax.jit`` gives the JAX package for free:
one dispatch of a whole program. A program here is any Python function
that enqueues work on one CUDA device (the strategies' matvecs, a rep loop,
a chunk of solver iterations); :func:`capture` records it once into a
``torch.cuda.CUDAGraph`` and :meth:`CapturedGraph.replay` enqueues all of
it with one host call, on the addresses it was captured with. The caller
keeps those addresses fixed: inputs are copied into the tensors the program
read at capture, and outputs are read from the tensors it returned.

Capture rules every kernel wrapper of the port keeps:

* **First launch outside capture.** :func:`capture` runs the program once
  eagerly (on a side stream) before capturing it, unless the caller has
  just done so: the kernel library is built and loaded, function attributes
  set and the allocator's blocks made there. Inside the capture every
  allocation comes from PyTorch's allocator (the graph's private pool).
* **Launch predicates.** A loop captured in chunks (``solvers/``) runs
  iterations that may turn out inactive. Inside :func:`launch_predicate`
  the GEMV (``csrc/gemv.cu``) and the fused solver step
  (``csrc/solver_step.cu``) take a device flag and return at once where it
  holds False, so an inactive iteration streams no A; the other kernels'
  wrappers refuse to launch under a predicate (:func:`refuse_predicate`)
  rather than run work the loop meant to skip.
* **Launch counters.** A wrapper bumps its counters (``gemv_cuda.launches``
  and the like) when it launches. A capture launches nothing, so the bumps
  it made are taken back and kept as the graph's launches, by kernel and
  route; every replay adds them again. The counts stay the number of
  kernel calls the card ran, captured or not.
"""

from __future__ import annotations

import contextlib
import contextvars
import gc
import importlib
from collections import Counter
from typing import Callable

import torch

from ..utils.errors import ConfigError

# (module of ops, wrapper, its counter attributes): every launch counter of
# the port's kernel wrappers.
_COUNTED = (
    ("cuda_gemv", "gemv_cuda", ("launches", "route_launches")),
    ("cuda_gemm", "gemm_cuda", ("launches", "route_launches")),
    ("cuda_quant", "quant_gemv_cuda", ("launches", "route_launches")),
    ("cuda_solver", "solver_step_cuda",
     ("launches", "quant_route_launches", "gemv_route_launches")),
    ("cuda_ring", "ring_gemv_cuda", ("launches",)),
    ("cuda_attention", "flash_partial_cuda", ("launches", "route_launches")),
)

LaunchCounts = dict  # (wrapper name, attribute, route or None) -> count


def _wrappers() -> dict[str, tuple[Callable, tuple[str, ...]]]:
    out = {}
    for module, name, attrs in _COUNTED:
        out[name] = (getattr(importlib.import_module(f"{__package__}.{module}"), name),
                     attrs)
    return out


def launch_counts() -> LaunchCounts:
    """Every wrapper's counters now, flat: ``(wrapper, attribute, route)``
    to a count (route None for a plain integer counter)."""
    counts = {}
    for name, (fn, attrs) in _wrappers().items():
        for attr in attrs:
            value = getattr(fn, attr)
            if isinstance(value, Counter):
                for route, n in value.items():
                    counts[(name, attr, route)] = n
            else:
                counts[(name, attr, None)] = value
    return counts


def count_delta(after: LaunchCounts, before: LaunchCounts) -> LaunchCounts:
    """The launches made between two :func:`launch_counts` snapshots."""
    return {key: n - before.get(key, 0) for key, n in after.items()
            if n != before.get(key, 0)}


def add_launches(delta: LaunchCounts, times: int = 1) -> None:
    """Add ``times`` x ``delta`` to the wrappers' counters."""
    wrappers = _wrappers()
    for (name, attr, route), n in delta.items():
        fn = wrappers[name][0]
        if route is None:
            setattr(fn, attr, getattr(fn, attr) + n * times)
        else:
            getattr(fn, attr)[route] += n * times


class CapturedGraph:
    """One captured program: ``replay()`` enqueues it on the current stream
    of its device and adds its launches to the wrappers' counters."""

    def __init__(self, graph: torch.cuda.CUDAGraph, launches: LaunchCounts,
                 device: torch.device):
        self.graph = graph
        self.launches = launches
        self.device = device

    def replay(self, times: int = 1) -> None:
        with torch.cuda.device(self.device):
            for _ in range(times):
                self.graph.replay()
        add_launches(self.launches, times)


def capture(program: Callable[[], object], device, *, warm: bool = True):
    """Capture ``program()`` on ``device``; return ``(graph, outputs)``,
    ``outputs`` being what the captured call returned (fixed tensors that
    every replay rewrites).

    ``warm=True`` runs the program once eagerly first, on a side stream
    that the current stream then waits for (its results are real work: the
    program must be one that may run once more, a pure function of its
    inputs). ``warm=False`` is for a caller that has just run it eagerly
    itself."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"CUDA graphs capture on a CUDA device, not {device}")
    with torch.cuda.device(device):
        if warm:
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                program()
            torch.cuda.current_stream().wait_stream(side)
        before = launch_counts()
        graph = torch.cuda.CUDAGraph()
        # No cyclic garbage collection inside the capture: a graph freed
        # there (an older loop's, say) would end the capture with an error.
        # torch.cuda.graph collects once on entry.
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph):
                outputs = program()
        finally:
            if collecting:
                gc.enable()
        launches = count_delta(launch_counts(), before)
        add_launches(launches, -1)  # a capture launches nothing
    return CapturedGraph(graph, launches, device), outputs


def single_cuda_device(devices) -> torch.device | None:
    """The one CUDA device of a mesh's device list, or None when the list
    holds a CPU device or more than one CUDA device (those run eagerly: a
    graph is captured on one device)."""
    distinct = list(dict.fromkeys(torch.device(d) for d in devices))
    if len(distinct) == 1 and distinct[0].type == "cuda":
        return distinct[0]
    return None


_PREDICATE: contextvars.ContextVar = contextvars.ContextVar("launch_predicate",
                                                           default=None)


@contextlib.contextmanager
def launch_predicate(flag: torch.Tensor):
    """Within the block, the GEMV and solver-step kernels launched on
    ``flag``'s device read ``flag`` (a one-element ``torch.bool`` on the
    card) when they run and return at once if it is False. On the CPU the
    plain versions ignore it: eager code branches on the host instead."""
    token = _PREDICATE.set(flag)
    try:
        yield
    finally:
        _PREDICATE.reset(token)


def predicate_ptr(device: torch.device) -> int | None:
    """The active launch predicate's device address, or None outside
    :func:`launch_predicate`."""
    flag = _PREDICATE.get()
    if flag is None:
        return None
    if flag.device != device or flag.dtype != torch.bool or flag.numel() != 1:
        raise ValueError(
            f"a launch predicate is one torch.bool on the kernel's device {device}, "
            f"got {flag.dtype} of shape {tuple(flag.shape)} on {flag.device}"
        )
    return flag.data_ptr()


def refuse_predicate(kernel: str) -> None:
    """Raise for a kernel that takes no launch predicate, launched inside
    :func:`launch_predicate` on the card."""
    if _PREDICATE.get() is not None:
        raise ConfigError(
            f"{kernel} takes no launch predicate: a predicated loop runs "
            "only the GEMV (csrc/gemv.cu) and the fused solver step"
        )
