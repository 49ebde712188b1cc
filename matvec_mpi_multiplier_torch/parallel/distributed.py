"""Multi-process runtime: the MPI_Init / MPI_Comm_size / MPI_Comm_rank analog.

Reference analog: ``MPI_Init`` (``src/multiplier_rowwise.c:66``) and the SPMD
identity calls ``MPI_Comm_size``/``MPI_Comm_rank`` (``:68-69``). The reference
launches p single-threaded ranks with ``mpiexec -n p`` on one machine
(``test.sh:11``). The port's counterpart joins p Python processes with
``torch.distributed`` on the :data:`BACKEND` named here, ``gloo``: every
exchange between processes is staged through host memory
(``parallel/mesh.py``), so two processes may share one card, as p MPI ranks
share one machine. Kernels still run on each process's own devices.

Each process owns ``local_device_count()`` devices; the global device list
is the processes' local lists in rank order (``make_mesh`` lays a mesh over
it), and :func:`device_count` is its length. In a world of one process,
nothing is initialized and every helper gives the one-process answer, so the
same scripts run unchanged.
"""

from __future__ import annotations

import os

import torch

from ..utils.constants import MAIN_PROCESS
from ..utils.errors import ConfigError

# The process group's backend. gloo exchanges CPU tensors, so device blocks
# are staged through the host; NCCL would refuse two ranks on one card.
BACKEND = "gloo"

# Launcher environments that carry a world to join (torchrun's, SLURM's,
# Open MPI's): the JAX package's list at parallel/distributed.py:49, with
# torchrun's variables in place of the TPU pod's coordinator.
_LAUNCHER_ENV = ("MASTER_ADDR", "SLURM_JOB_ID", "OMPI_COMM_WORLD_SIZE")

# Every process's local device count, in rank order, gathered once by
# initialize(); None in a world of one.
_local_counts: list[int] | None = None


def _dist():
    import torch.distributed as dist

    return dist


def is_initialized() -> bool:
    dist = _dist()
    return dist.is_available() and dist.is_initialized()


def _launcher_world() -> tuple[str, int, int] | None:
    """``(address, world size, rank)`` from the launcher's environment, or
    None where no launcher started this process. The address is
    ``MASTER_ADDR:MASTER_PORT`` under every launcher: SLURM and Open MPI
    name the ranks, not a rendezvous."""
    env = os.environ
    if not any(v in env for v in _LAUNCHER_ENV):
        return None
    if "WORLD_SIZE" in env and "RANK" in env:
        size, rank = int(env["WORLD_SIZE"]), int(env["RANK"])
    elif "OMPI_COMM_WORLD_SIZE" in env:
        size = int(env["OMPI_COMM_WORLD_SIZE"])
        rank = int(env.get("OMPI_COMM_WORLD_RANK", 0))
    elif "SLURM_NTASKS" in env:
        size, rank = int(env["SLURM_NTASKS"]), int(env.get("SLURM_PROCID", 0))
    else:
        size, rank = 1, 0
    if size == 1:
        return None
    if "MASTER_ADDR" not in env:
        raise ConfigError(
            f"a launcher started {size} processes, but MASTER_ADDR (and "
            "MASTER_PORT) are not set: pass initialize(coordinator_address="
            "'host:port', num_processes=..., process_id=...)"
        )
    return f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}", size, rank


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> None:
    """Join the multi-process world (``MPI_Init``,
    ``src/multiplier_rowwise.c:66``): call once at program start, on every
    process, before any device work.

    ``coordinator_address`` is ``host:port`` of rank 0's rendezvous
    (``tcp://`` is prefixed), with ``num_processes`` and ``process_id``.
    With no arguments the launcher's environment is read (torchrun's
    ``MASTER_ADDR``/``MASTER_PORT``/``RANK``/``WORLD_SIZE``, SLURM's,
    Open MPI's). A no-op in a world already initialized, or with no
    arguments and no launcher."""
    global _local_counts
    if is_initialized():
        return
    given = (coordinator_address, num_processes, process_id)
    if all(v is None for v in given):
        world = _launcher_world()
        if world is None:
            return
        coordinator_address, num_processes, process_id = world
    elif any(v is None for v in given):
        raise ConfigError(
            "initialize() takes coordinator_address, num_processes and "
            "process_id together (or none of them, under a launcher)"
        )
    address = coordinator_address
    if "://" not in address:
        address = f"tcp://{address}"
    dist = _dist()
    dist.init_process_group(backend=BACKEND, init_method=address,
                            world_size=int(num_processes), rank=int(process_id))
    counts = [None] * dist.get_world_size()
    dist.all_gather_object(counts, local_device_count())
    _local_counts = [int(c) for c in counts]


def shutdown() -> None:
    """Leave the world (``MPI_Finalize``): destroy the process group."""
    global _local_counts
    if is_initialized():
        _dist().destroy_process_group()
    _local_counts = None


def backend() -> str | None:
    """The process group's backend name, None in a world of one."""
    return _dist().get_backend() if is_initialized() else None


def process_index() -> int:
    """This process's rank (``MPI_Comm_rank``, ``src/multiplier_rowwise.c:69``)."""
    return _dist().get_rank() if is_initialized() else MAIN_PROCESS


def process_count() -> int:
    """World size in processes (``MPI_Comm_size``, ``src/multiplier_rowwise.c:68``)."""
    return _dist().get_world_size() if is_initialized() else 1


def is_main_process() -> bool:
    """The coordinator-role check (``rank == MAIN_PROCESS``,
    ``src/constants.h:5``): the process that loads data and writes CSVs."""
    return process_index() == MAIN_PROCESS


def local_device_count() -> int:
    """Devices this process computes on: its visible CUDA devices, else the
    one CPU."""
    return torch.cuda.device_count() if torch.cuda.is_available() else 1


def device_count() -> int:
    """Global device count, summed over the processes (the 'p' in speedup
    curves)."""
    if _local_counts:
        return sum(_local_counts)
    # A world joined outside initialize(): the launcher starts like
    # processes, each with this one's count.
    return local_device_count() * process_count()
