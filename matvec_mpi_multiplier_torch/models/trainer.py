"""Distributed least-squares trainer: ``min_x ||A x - b||²`` by gradient descent.

The port's counterpart of the JAX package's ``models/trainer.py``. Every
array is placed the blockwise way over the 2-D ``('rows', 'cols')`` mesh:

* ``A`` — spec ``('rows', 'cols')`` (the 2-D block layout of
  ``src/multiplier_blockwise.c:56``);
* ``b`` — spec ``('rows',)`` (the row segments of the blockwise result);
* ``x`` — the *parameter*, spec ``('cols',)`` (tensor-parallel on the
  contraction dimension, the colwise layout of
  ``src/multiplier_colwise.c:86-96``).

JAX takes the gradient with ``jax.grad`` and lets GSPMD insert the
collectives. The port writes the step out with the mesh's explicit
collectives: the forward is each block's product (``torch.matmul``, as
JAX's ``a @ x`` is the library product) summed over ``'cols'``
(``psum``, colwise's ``MPI_Reduce`` analog); the gradient ``2·Aᵀr/m`` is
each block's transposed product summed over ``'rows'``, the transpose
collective. Every device of a column then holds the same gradient, so the
replicas of x stay bitwise equal. optax's ``sgd`` becomes
``torch.optim.SGD`` over x's distinct shard tensors (its ``add_(g,
alpha=-lr)`` may round once where optax's ``x + (-lr·g)`` rounds twice, so
trajectories agree to a tolerance, not bitwise). The host reads one scalar,
the loss, per step in :func:`fit`.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from ..parallel.mesh import Mesh, ShardedTensor, psum, shard
from ..utils.constants import MESH_AXIS_COLS, MESH_AXIS_ROWS


@dataclasses.dataclass(frozen=True)
class TrainState:
    """Parameters and optimizer for the least-squares solve: ``x`` placed
    with spec ``('cols',)``, the SGD optimizer over its distinct shards, and
    the step count (an int32 tensor on the mesh's first device)."""

    x: ShardedTensor
    optimizer: torch.optim.Optimizer
    step: torch.Tensor


def shardings(mesh: Mesh) -> dict[str, tuple]:
    """The placement specs of the operands, the parameter and a replicated
    value (the JAX package's ``NamedSharding`` s; ``shard(t, spec, mesh)``
    places)."""
    return {
        "a": (MESH_AXIS_ROWS, MESH_AXIS_COLS),
        "b": (MESH_AXIS_ROWS,),
        "x": (MESH_AXIS_COLS,),
        "replicated": (),
    }


def _distinct(shards) -> list[torch.Tensor]:
    """The distinct tensors of a placement (a block on one device is one
    tensor, however many logical shards hold it)."""
    return list({id(t): t for t in shards}.values())


def make_optimizer(x: ShardedTensor, learning_rate: float) -> torch.optim.SGD:
    """optax's ``sgd(learning_rate)``: plain SGD over x's distinct shards
    (it keeps no per-parameter state, as optax's keeps none)."""
    return torch.optim.SGD(_distinct(x.shards), lr=learning_rate)


def state_from_numpy(mesh: Mesh, x, step: int, *, learning_rate: float = 1e-2,
                     dtype: torch.dtype = torch.float32) -> TrainState:
    """A :class:`TrainState` holding ``x`` (a host array: a JAX state's
    ``np.asarray(state.x)``) placed with spec ``('cols',)`` and the step
    ``step``, with a fresh SGD (optax's ``sgd`` keeps no state): a JAX
    ``TrainState`` carried into the port, to continue from its step."""
    xt = torch.as_tensor(np.array(x), dtype=dtype)  # a copy: host arrays may be read-only
    xs = shard(xt, shardings(mesh)["x"], mesh)
    return TrainState(x=xs, optimizer=make_optimizer(xs, learning_rate),
                      step=torch.tensor(int(step), dtype=torch.int32,
                                        device=mesh.devices[0]))


def init_state(mesh: Mesh, n_cols: int, *, learning_rate: float = 1e-2,
               dtype: torch.dtype = torch.float32) -> TrainState:
    """x = 0 on the mesh, step 0."""
    return state_from_numpy(mesh, np.zeros(n_cols), 0, learning_rate=learning_rate,
                            dtype=dtype)


def _place(t, spec: tuple, mesh: Mesh) -> ShardedTensor:
    return t if isinstance(t, ShardedTensor) else shard(t, spec, mesh)


def loss_and_grad(x: ShardedTensor, a, b, mesh: Mesh) -> tuple[torch.Tensor, list[torch.Tensor]]:
    """The mean-squared residual ``mean((A x - b)²)`` (a scalar on the
    mesh's first device) and its gradient ``2·Aᵀ(A x - b)/m`` as one block
    per device (x's layout). ``a`` and ``b`` are placed operands (plain
    tensors are placed here)."""
    sh = shardings(mesh)
    a = _place(a, sh["a"], mesh)
    b = _place(b, sh["b"], mesh)
    m = a.shape[0]
    y = psum([torch.matmul(ab, xb) for ab, xb in zip(a.shards, x.shards)], mesh,
             MESH_AXIS_COLS)
    r = [yb - bb for yb, bb in zip(y, b.shards)]
    # Each device of a row holds that row's residual; the sum over 'rows'
    # counts every row once on every device.
    loss = psum([torch.sum(rb * rb) for rb in r], mesh, MESH_AXIS_ROWS)[mesh.first_local] / m
    grad = psum([torch.matmul(rb * (2.0 / m), ab) for rb, ab in zip(r, a.shards)], mesh,
                MESH_AXIS_ROWS)
    return loss, grad


def loss_fn(x: ShardedTensor, a, b, mesh: Mesh) -> torch.Tensor:
    """The mean-squared residual ``mean((A x - b)²)``."""
    return loss_and_grad(x, a, b, mesh)[0]


def build_train_step(mesh: Mesh) -> Callable[[TrainState, object, object],
                                             tuple[TrainState, torch.Tensor]]:
    """Return the distributed training step ``step(state, a, b) -> (state,
    loss)``: one gradient, one SGD update of x's shards in place (x keeps its
    ``('cols',)`` placement), the step count advanced. ``loss`` is the loss
    before the update, a tensor (no host read)."""

    def train_step(state: TrainState, a, b):
        with torch.no_grad():
            loss, grad = loss_and_grad(state.x, a, b, mesh)
            by_id = {id(t): g for t, g in zip(state.x.shards, grad)}
            for p in _distinct(state.x.shards):
                p.grad = by_id[id(p)]
            state.optimizer.step()
            state.optimizer.zero_grad(set_to_none=True)
        return dataclasses.replace(state, step=state.step + 1), loss

    return train_step


def fit(mesh: Mesh, a, b, *, learning_rate: float = 1e-2, n_steps: int = 100,
        dtype: torch.dtype = torch.float32) -> tuple[TrainState, list[float]]:
    """Convenience loop: solve ``A x ≈ b`` on the mesh, return the final
    state and the loss history (one host read a step)."""
    sh = shardings(mesh)
    a = shard(torch.as_tensor(a, dtype=dtype), sh["a"], mesh)
    b = shard(torch.as_tensor(b, dtype=dtype), sh["b"], mesh)
    state = init_state(mesh, a.shape[1], learning_rate=learning_rate, dtype=dtype)
    step = build_train_step(mesh)
    losses = []
    for _ in range(n_steps):
        state, loss = step(state, a, b)
        losses.append(float(loss))
    return state, losses

