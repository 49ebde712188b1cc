"""Process identity: the MPI_Comm_size/MPI_Comm_rank analog.

Reference analog: ``MPI_Comm_size``/``MPI_Comm_rank``
(``src/multiplier_rowwise.c:68-69``). The port's mesh is a single controller:
one Python process drives every shard, so the world is one process. A
multi-card ``torch.distributed`` bring-up is a later slice (ROADMAP.md).
"""

from __future__ import annotations

from ..utils.constants import MAIN_PROCESS


def process_index() -> int:
    """This process's rank (``MPI_Comm_rank``, ``src/multiplier_rowwise.c:69``)."""
    return MAIN_PROCESS


def process_count() -> int:
    """World size in processes (``MPI_Comm_size``, ``src/multiplier_rowwise.c:68``)."""
    return 1


def is_main_process() -> bool:
    """The coordinator-role check (``rank == MAIN_PROCESS``,
    ``src/constants.h:5``): the process that loads data and writes CSVs."""
    return process_index() == MAIN_PROCESS
