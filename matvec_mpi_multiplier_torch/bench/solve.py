"""Distributed least-squares solver CLI: the trainer's user-facing surface.

The port's counterpart of the JAX package's ``scripts/solve.py``, with its
flags and its output lines. Solves ``min_x ||A x - b||²`` by gradient
descent with every array placed over the device mesh
(``models/trainer.py``), saving a checkpoint every ``--ckpt-every`` steps
(``utils/checkpoint.py``, ``<ckpt-dir>/step_<n>``) and resuming from the
latest one if there is one. ``A`` (standard normal, fp32), ``x_true`` and
``b = A x_true`` are made on the mesh's first device from ``--seed``.

Usage::

    python -m matvec_mpi_multiplier_torch.bench.solve --size 16384 16384 \\
        --steps 20
    python -m matvec_mpi_multiplier_torch.bench.solve --size 512 256 \\
        --steps 200 --ckpt-dir /tmp/solve_ckpt --ckpt-every 50 \\
        --platform cpu --host-devices 8   # interrupt and rerun: resumes

It runs on the CUDA devices unless ``--platform cpu`` is given.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import torch


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="matvec-torch-solve",
                                description=__doc__.split("\n")[0])
    p.add_argument("--size", nargs=2, type=int, default=[512, 256], metavar=("M", "N"))
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--lr", type=float, default=1e-2)
    p.add_argument("--devices", type=int, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--ckpt-dir", default=None)
    p.add_argument("--ckpt-every", type=int, default=50)
    p.add_argument("--platform", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("--host-devices", type=int, default=None,
                   help="logical CPU devices with --platform cpu (default: "
                   "--devices, else 1)")
    return p


def main(argv=None) -> int:
    p = build_parser()
    args = p.parse_args(argv)
    if args.ckpt_every < 1:
        p.error("--ckpt-every must be >= 1")

    from ..models import trainer
    from ..parallel import distributed
    from ..parallel.mesh import make_mesh, shard, unshard
    from ..utils import checkpoint
    from .sweep import platform_devices

    # The MPI_Init analog: joins a launcher's world (torchrun, SLURM, Open
    # MPI), a no-op in a world of one.
    distributed.initialize()
    host = args.host_devices
    if args.platform == "cpu" and host is None:
        host = args.devices
    mesh = make_mesh(args.devices, devices=platform_devices(args.platform, host))
    dev0 = mesh.devices[0]
    m, n = args.size
    gen = torch.Generator(device=dev0).manual_seed(args.seed)
    x_true = torch.randn((n,), generator=gen, dtype=torch.float32, device=dev0)
    a_host = torch.randn((m, n), generator=gen, dtype=torch.float32, device=dev0)
    sh = trainer.shardings(mesh)
    a = shard(a_host, sh["a"], mesh)
    b = shard(a_host @ x_true, sh["b"], mesh)
    del a_host
    state = trainer.init_state(mesh, n, learning_rate=args.lr)
    step_fn = trainer.build_train_step(mesh)

    main_process = distributed.is_main_process()
    if args.ckpt_dir:
        latest = checkpoint.latest_step_dir(args.ckpt_dir)
        if latest is not None:
            state = checkpoint.restore_state(latest, state)
            if main_process:
                print(f"resumed from {latest} at step {int(state.step)}", flush=True)

    loss = None
    for i in range(int(state.step), args.steps):
        state, loss = step_fn(state, a, b)
        if args.ckpt_dir and (i + 1) % args.ckpt_every == 0:
            path = checkpoint.save_state(state, Path(args.ckpt_dir) / f"step_{i + 1}")
            if main_process:
                print(f"step {i + 1}: loss={float(loss):.3e} ckpt={path}", flush=True)
        elif (i + 1) % max(1, args.steps // 10) == 0 and main_process:
            print(f"step {i + 1}: loss={float(loss):.3e}", flush=True)

    err = float(torch.max(torch.abs(unshard(state.x) - x_true)))
    if main_process:
        final = float(loss) if loss is not None else float("nan")
        print(f"done: steps={int(state.step)} final_loss={final:.3e} "
              f"max|x-x_true|={err:.3e}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
