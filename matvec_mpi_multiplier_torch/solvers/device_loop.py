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
"""

from __future__ import annotations

import inspect
import weakref
from typing import Callable

import torch

from ..ops.graphs import capture, launch_predicate

# Iterations per chunk: one flag read per chunk; after the loop stops, at
# most DEFAULT_CHUNK - 1 masked iterations run, each with its kernels
# predicated off.
DEFAULT_CHUNK = 16


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
    return body() if bool(flag) else otherwise()  # tracer-sync-ok: eager only (off the card or before capture); under capture the flag is a launch predicate


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
        self.reads = 0  # read() calls (the eager first chunk reads its flag apart)

    def iteration(self) -> None:
        self._iteration()()

    def _chunk(self) -> None:
        for _ in range(self.chunk):
            self.iteration()

    def read(self) -> tuple[bool, int]:
        """``(go, k)``: the loop's one device->host read."""
        self.reads += 1
        go, k = torch.stack((self.go.to(self.k.dtype), self.k)).tolist()  # tracer-sync-ok: the device loop's one read per chunk
        return bool(go), int(k)

    def _first_chunk(self) -> None:
        """The eager chunk on the card before the capture: it stops where
        the loop does (its iterations read the flag anyway), so a solve
        that ends inside it runs no masked iteration."""
        for _ in range(self.chunk):
            if not bool(self.go):
                return
            self.iteration()

    def run(self) -> int:
        """Run the loop to its end; return the iteration count."""
        go, k = self.read()
        while go:
            if self.graph is not None:
                self.graph.replay()
            elif self.device is not None:
                self._first_chunk()
                if bool(self.go):
                    self.graph, _ = capture(self._chunk, self.device, warm=False)
            else:
                self._chunk()
            go, k = self.read()
        return k
