"""JSONL sink: the one place obs does blocking file I/O.

The port's copy of the JAX package's ``obs/sink.py``. Emitting a trace
record or a timeline event never blocks on the filesystem (``tracing.py``,
``timeline.py``); this module is the other half of that contract — a
daemon thread draining a ``SimpleQueue`` into an append-mode JSONL file.

``flush()`` queues an in-band marker (an ``Event``) behind every pending
record, so a caller can wait for the file to be complete: the serve bench
flushes before reporting the trace path, and the tests flush before reading
the file back. :func:`dump_json` is the synchronous face the flight
recorder's writer thread and the CLIs use.
"""

from __future__ import annotations

import json
import os
import queue
import threading
from pathlib import Path

_CLOSE = object()


class JsonlSink:
    """Background JSONL writer. ``put`` is the hot-path face: one
    ``SimpleQueue.put`` (no lock acquisition in CPython), nothing else."""

    def __init__(self, path: str | os.PathLike):
        self.path = Path(path)
        self._q: queue.SimpleQueue = queue.SimpleQueue()
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="obs-jsonl-sink"
        )
        self._thread.start()

    def put(self, record: dict) -> None:
        self._q.put(record)

    def _run(self) -> None:
        try:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            f = open(self.path, "a")
        except OSError:
            # Unwritable destination: exit quietly. The thread's death is the
            # signal (flush() returns False and callers report it); a
            # daemon-thread traceback would land in the middle of a run's
            # output.
            return
        with f:
            while True:
                item = self._q.get()
                if item is _CLOSE:
                    return
                if isinstance(item, threading.Event):
                    f.flush()
                    item.set()
                    continue
                f.write(json.dumps(item) + "\n")

    def flush(self, timeout: float = 5.0) -> bool:
        """Wait until every record queued before this call is on disk.
        Returns False on timeout or a dead sink thread."""
        if not self._thread.is_alive():
            return False
        marker = threading.Event()
        self._q.put(marker)
        return marker.wait(timeout)

    def close(self, timeout: float = 5.0) -> None:
        self._q.put(_CLOSE)
        self._thread.join(timeout)


def dump_json(path: str | os.PathLike, payload: dict) -> Path:
    """Write ``payload`` as one indented JSON document (the flight
    recorder's writer thread and the serve bench's SLO file): the file I/O
    of obs stays in this module."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        json.dump(payload, f, indent=2)
        f.write("\n")
    return path
