"""matvec_mpi_multiplier_torch — the PyTorch/CUDA port of the matvec framework.

The same system as ``matvec_mpi_multiplier_tpu`` (three named partitioning
strategies for dense ``y = A @ x`` over a most-square device mesh, the
``matrix_<r>_<c>.txt`` data convention, the 100-repetition
max-across-processes timing protocol and its CSVs), written in PyTorch with
a hand-written CUDA GEMV for Hopper (``csrc/gemv.cu``). It imports nothing of
the JAX package; module names mirror it so each counterpart is easy to find.

The re-exports resolve lazily (PEP 562): importing the package imports no
kernel module, builds nothing and never touches ``nvcc``.
"""

from __future__ import annotations

import importlib

__version__ = "0.1.0"

# Exported name -> (submodule, attr — None re-exports the module itself).
_EXPORTS = {
    "MatvecStrategy": (".models", "MatvecStrategy"),
    "RowwiseStrategy": (".models", "RowwiseStrategy"),
    "ColwiseStrategy": (".models", "ColwiseStrategy"),
    "BlockwiseStrategy": (".models", "BlockwiseStrategy"),
    "get_strategy": (".models", "get_strategy"),
    "available_strategies": (".models", "available_strategies"),
    "make_mesh": (".parallel.mesh", "make_mesh"),
    "make_1d_mesh": (".parallel.mesh", "make_1d_mesh"),
    "build_ring_attention": (".parallel.attention", "build_ring_attention"),
    "build_ulysses_attention": (".parallel.attention", "build_ulysses_attention"),
    "io": (".utils.io", None),
    "MatvecError": (".utils.errors", "MatvecError"),
    "ShardingError": (".utils.errors", "ShardingError"),
    "DataFileError": (".utils.errors", "DataFileError"),
    "ConfigError": (".utils.errors", "ConfigError"),
}

__all__ = [*_EXPORTS, "__version__"]


def __getattr__(name: str):
    try:
        module, attr = _EXPORTS[name]
    except KeyError:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}"
        ) from None
    value = importlib.import_module(module, __name__)
    if attr is not None:
        value = getattr(value, attr)
    globals()[name] = value  # cache: resolve each export once
    return value


def __dir__():
    return sorted(set(globals()) | set(__all__))
