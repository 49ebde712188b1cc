"""Checkpoint / resume of the trainer's state.

The port's counterpart of the JAX package's ``utils/checkpoint.py``. The
reference's only resumable state is its append-only CSV
(``src/multiplier_rowwise.c:77-88``, kept in ``bench/metrics.py``); this
module checkpoints the trainer's compute state. The format is the port's
own (it does not read an orbax directory): a checkpoint is a directory
holding ``state.pt``, a ``torch.save`` of a plain dict — the whole
parameter vector ``x`` on the host, the step as an int, and the optimizer's
``state_dict()`` — read back with ``torch.load(weights_only=True)``, which
unpickles tensors and plain containers only. Restoring places ``x`` onto
the template state's mesh and spec.
"""

from __future__ import annotations

import os
from pathlib import Path

import torch

from ..models.trainer import TrainState, make_optimizer
from ..parallel.mesh import shard, unshard

STATE_FILE = "state.pt"


def save_state(state: TrainState, path: str | os.PathLike) -> Path:
    """Save ``state`` into the directory ``path`` (made if missing; an older
    checkpoint there is replaced). Returns the resolved path."""
    path = Path(path).resolve()
    path.mkdir(parents=True, exist_ok=True)
    payload = {"x": unshard(state.x).cpu(), "step": int(state.step),
               "optimizer": state.optimizer.state_dict()}
    tmp = path / (STATE_FILE + ".tmp")
    torch.save(payload, tmp)
    os.replace(tmp, path / STATE_FILE)  # a complete file or none
    return path


def restore_state(path: str | os.PathLike, like: TrainState) -> TrainState:
    """Restore a state saved by :func:`save_state` onto the placement of the
    template ``like``: x cut by ``like.x``'s spec over its mesh, in its
    dtype; the optimizer with the saved learning rate; the step on the
    mesh's first device."""
    payload = torch.load(Path(path).resolve() / STATE_FILE, weights_only=True)
    mesh = like.x.mesh
    x = shard(payload["x"].to(like.x.dtype), like.x.spec, mesh)
    # Plain SGD keeps no per-parameter state (which would be per shard, so
    # per placement): its learning rate is what there is to restore.
    opt = make_optimizer(x, payload["optimizer"]["param_groups"][0]["lr"])
    step = torch.tensor(payload["step"], dtype=torch.int32, device=mesh.devices[0])
    return TrainState(x=x, optimizer=opt, step=step)


def latest_step_dir(root: str | os.PathLike) -> Path | None:
    """The highest-numbered ``step_<n>`` checkpoint directory under ``root``."""
    root = Path(root)
    if not root.exists():
        return None
    steps = []
    for p in root.iterdir():
        if p.is_dir() and p.name.startswith("step_"):
            try:
                steps.append((int(p.name.split("_", 1)[1]), p))
            except ValueError:
                continue
    if not steps:
        return None
    return max(steps)[1]
