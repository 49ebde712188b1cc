"""What the study CLIs share: their platform flags, their mesh, their outputs.

The eight ``bench/*_study.py`` modules are the port's counterparts of the
JAX package's ``scripts/*_study.py``. Each runs on ``cuda:0`` unless the
caller passes ``--platform cpu`` (``--host-devices`` sets the CPU mesh);
without a card it raises :class:`~..utils.errors.ConfigError`, with no CPU
fallback. On the card a mesh of p is p logical shards of ``cuda:0``
(``--devices``). Outputs go under :data:`DEMO_ROOT` by default, a directory
of the port's own: the JAX package's ``data/<name>_demo/`` directories and
``docs/`` reports stay as they are, and a report is written only where
``--report`` names a path.
"""

from __future__ import annotations

import argparse
import contextlib
import os
from pathlib import Path

import torch

from ..parallel.mesh import Mesh, make_mesh
from ..utils.errors import ConfigError

# The studies' default output root, relative to the working directory.
DEMO_ROOT = Path("data") / "torch_demo"


def default_out(name: str) -> str:
    """The default output directory of study ``name``."""
    return str(DEMO_ROOT / name)


def add_platform_args(parser: argparse.ArgumentParser, *, devices: int | None) -> None:
    """``--platform`` (cuda or cpu), ``--host-devices`` (the CPU mesh) and
    ``--devices`` (the mesh size; ``devices`` is its default)."""
    parser.add_argument("--platform", choices=["cuda", "cpu"], default="cuda",
                        help="cuda:0 (default) or the CPU")
    parser.add_argument("--host-devices", type=int, default=None,
                        help="CPU devices of the mesh (--platform cpu only)")
    parser.add_argument("--devices", type=int, default=devices,
                        help="mesh size: logical shards of cuda:0 on the card")


def study_mesh(args) -> Mesh:
    """The study's mesh: ``--host-devices`` (else ``--devices``, else 1)
    CPU devices for ``--platform cpu``, else ``--devices`` (else 1)
    logical shards of ``cuda:0``; ``ConfigError`` without a card."""
    if args.platform == "cpu":
        n = args.host_devices or args.devices or 1
        return make_mesh(n, devices=[torch.device("cpu")] * n)
    if args.host_devices is not None:
        raise ConfigError("--host-devices applies to --platform cpu only")
    if not torch.cuda.is_available():
        raise ConfigError(
            "the study runs on cuda:0 (the default) and no CUDA device is "
            "visible; pass --platform cpu for a CPU run"
        )
    n = args.devices or 1
    return make_mesh(n, devices=[torch.device("cuda", 0)] * n)


def platform_label(mesh: Mesh) -> str:
    """The mesh's device for a report: the card's name, or ``cpu``."""
    dev = mesh.devices[0]
    if dev.type == "cuda":
        return torch.cuda.get_device_name(dev)
    return dev.type


@contextlib.contextmanager
def tuning_cache_at(path: Path):
    """The process's tuning cache read from and written to ``path`` while
    entered (the studies' caches are artifacts that travel with their
    numbers); the earlier setting and the dispatch-side singleton come
    back on exit."""
    from ..tuning import reset_cache
    from ..tuning.cache import CACHE_ENV

    before = os.environ.get(CACHE_ENV)
    os.environ[CACHE_ENV] = str(path)
    reset_cache()
    try:
        yield
    finally:
        if before is None:
            os.environ.pop(CACHE_ENV, None)
        else:
            os.environ[CACHE_ENV] = before
        reset_cache()
