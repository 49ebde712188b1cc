"""The solver loop on the device: masked chunks of iterations, one read each.

The JAX package runs CG and Chebyshev inside ``lax.while_loop``: the
continuation predicate never leaves the device. The port's counterpart runs
the loop in chunks of :data:`DEFAULT_CHUNK` iterations over state that lives
in fixed tensors on the device:

* each iteration computes its update from the state, then commits it under
  the device flag ``go`` (``torch.where(go, new, old, out=old)``), so an
  iteration after the loop has stopped leaves every value bitwise as it
  was; the iteration count ``k`` is a device integer that only an active
  iteration advances, and the continuation predicate is written back to
  ``go`` on the device;
* the host reads ``(go, k)`` once per chunk, and runs another chunk while
  ``go`` holds;
* work that only some iterations need (the iteration's matvec after the
  loop has stopped, CG's and Chebyshev's true-residual refresh) goes through
  :func:`when`: under capture the kernels take the flag as a launch
  predicate (``ops/graphs.py``) and return at once where it is False;
  eagerly, the host branches on the flag.

On one CUDA device the first chunk runs eagerly (the kernels' first
launches, one flag read an iteration, stopping where the loop stops), and if
the loop goes on, the chunk is captured once as a CUDA graph and replayed
for the rest of this solve and every later one on the same operands: a
solve shorter than a chunk is never captured. Elsewhere (the CPU, a mesh
over several CUDA devices) every chunk runs eagerly and whole, masked
iterations included: the solvers run it there only where a caller asks
for it (``solvers/ops.py::solver_loop``). The arithmetic is the host-stepped loop's, operation
for operation, so both give the same iterate bitwise.

Every device→host read on a solve's path goes through :class:`host_read`:
while a ``torch.profiler`` records, it opens a ``solver/host_read`` range
over the read and the work that feeds it, and inside a running
:class:`ChunkedLoop` it counts the read in that loop's ``reads``. A loop
runs inside one ``solver/loop`` range (:data:`LOOP_SPAN`), the
host-stepped loops of ``solvers/ops.py`` too.
"""

from __future__ import annotations

import inspect
import threading
import weakref
from typing import Callable

import torch

from ..obs.annotations import profiler_span
from ..ops.graphs import capture, launch_predicate

# Iterations per chunk: one flag read per chunk; after the loop stops, at
# most DEFAULT_CHUNK - 1 masked iterations run, each with its kernels
# predicated off.
DEFAULT_CHUNK = 16

# The profiler ranges of the solver's loop and of each of its host reads.
LOOP_SPAN = "solver/loop"
HOST_READ_SPAN = "solver/host_read"

# The ChunkedLoop that runs on this thread, whose ``reads`` count the reads.
_running = threading.local()


class host_read:
    """``with host_read(): <one device->host read>``: opens a
    ``solver/host_read`` range while a profiler records, and counts the
    read in the ``reads`` of the loop that runs on this thread. The read
    itself stays at its site, with its ``tracer-sync-ok`` marker."""

    __slots__ = ("_range",)

    def __enter__(self) -> None:
        loop = getattr(_running, "loop", None)
        if loop is not None:
            loop.reads += 1
        self._range = profiler_span(HOST_READ_SPAN)
        self._range.__enter__()

    def __exit__(self, *exc) -> None:
        self._range.__exit__(*exc)


def when(flag: torch.Tensor, body: Callable[[], object],
         otherwise: Callable[[], object]):
    """``body()`` where the device flag holds, ``otherwise()`` where it does
    not. Under CUDA-graph capture ``body`` is captured with ``flag`` as its
    kernels' launch predicate (its outputs are then unwritten where the
    flag is False, and the caller masks them away); eagerly the host reads
    the flag and runs one of the two."""
    if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
        with launch_predicate(flag):
            return body()
    with host_read():
        go = bool(flag)  # tracer-sync-ok: eager only (off the card or before capture); under capture the flag is a launch predicate
    return body() if go else otherwise()


def commit(flag: torch.Tensor, pairs) -> None:
    """``old = new`` where ``flag`` holds, in place, for each ``(old, new)``:
    an inactive iteration leaves every old value bitwise as it was."""
    for old, new in pairs:
        torch.where(flag, new, old, out=old)


class ChunkedLoop:
    """Runs ``iteration()`` in chunks of :data:`DEFAULT_CHUNK` (read when
    the loop is made) until the device flag ``go`` reads False; ``k`` is
    the device iteration count. ``device`` is the one CUDA device the state
    lives on (the chunk is captured there once), or None to run every chunk
    eagerly."""

    def __init__(self, iteration: Callable[[], None], go: torch.Tensor,
                 k: torch.Tensor, device: torch.device | None):
        # A state that owns its loop passes its own bound method: held
        # weakly, so that state and loop make no reference cycle, and the
        # operand the state keeps goes as soon as the state does.
        self._iteration = (weakref.WeakMethod(iteration) if inspect.ismethod(iteration)
                           else lambda: iteration)
        self.go, self.k = go, k
        self.device = device
        self.chunk = DEFAULT_CHUNK
        self.graph = None
        self.reads = 0  # host reads, through host_read: read(), the eager flags, when()

    def iteration(self) -> None:
        self._iteration()()

    def _chunk(self) -> None:
        for _ in range(self.chunk):
            self.iteration()

    def read(self) -> tuple[bool, int]:
        """``(go, k)``: the loop's one device->host read a chunk."""
        with host_read():
            go, k = torch.stack((self.go.to(self.k.dtype), self.k)).tolist()  # tracer-sync-ok: the device loop's one read per chunk
        return bool(go), int(k)

    def _go(self) -> bool:
        """The flag alone, as the eager chunk reads it."""
        with host_read():
            return bool(self.go)

    def _first_chunk(self) -> None:
        """The eager chunk on the card before the capture: it stops where
        the loop does (its iterations read the flag anyway), so a solve
        that ends inside it runs no masked iteration."""
        for _ in range(self.chunk):
            if not self._go():
                return
            self.iteration()

    def run(self) -> int:
        """Run the loop to its end; return the iteration count."""
        outer = getattr(_running, "loop", None)
        _running.loop = self
        try:
            with profiler_span(LOOP_SPAN):
                go, k = self.read()
                while go:
                    if self.graph is not None:
                        self.graph.replay()
                    elif self.device is not None:
                        self._first_chunk()
                        if self._go():
                            self.graph, _ = capture(self._chunk, self.device, warm=False)
                    else:
                        self._chunk()
                    go, k = self.read()
        finally:
            _running.loop = outer
        return k
