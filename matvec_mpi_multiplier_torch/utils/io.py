"""Matrix/vector file IO: the data convention layer (the port's own copy).

Reference analog: ``src/matr_utils.c``. The contract, identical to the JAX
package's ``utils/io.py``:

* data lives under ``./data/`` relative to CWD (``src/matr_utils.c:45-46``),
  overridable via ``MATVEC_DATA_DIR``;
* matrices are named ``matrix_<rows>_<cols>.txt`` (``src/matr_utils.c:9-12``),
  row-major whitespace-separated ``%lf`` tokens (``:55-59``);
* vectors are named ``vector_<n>.txt`` (``:15-18``), one value per line
  (``:76-80``);
* values are written with 4 decimal places (``README.md:32``);
* a missing file raises :class:`DataFileError`.

The generators draw seeded uniform values in [0, 10), the magnitude of the
committed 4×8 fixture, with numpy's generator — so both packages generate
the same operands from the same seed. Parsing uses numpy only.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np

from .constants import MATRIX_FILENAME_FMT, VECTOR_FILENAME_FMT
from .errors import DataFileError


def _load_values(path: Path, count: int) -> np.ndarray:
    """Parse exactly ``count`` whitespace-separated doubles from ``path``."""
    flat = np.loadtxt(path, dtype=np.float64).reshape(-1)
    if flat.size != count:
        raise DataFileError(
            f"{path} holds {flat.size} values, expected {count}"
        )
    return flat


def data_dir(root: str | os.PathLike | None = None) -> Path:
    if root is not None:
        return Path(root)
    # Read the env override at call time, not import time.
    return Path(os.environ.get("MATVEC_DATA_DIR", "./data"))


def matrix_path(n_rows: int, n_cols: int, root: str | os.PathLike | None = None) -> Path:
    """Filename convention of ``build_matrix_filename`` (``src/matr_utils.c:9-12``)."""
    return data_dir(root) / MATRIX_FILENAME_FMT.format(n_rows=n_rows, n_cols=n_cols)


def vector_path(n: int, root: str | os.PathLike | None = None) -> Path:
    """Filename convention of ``build_vector_filename`` (``src/matr_utils.c:15-18``)."""
    return data_dir(root) / VECTOR_FILENAME_FMT.format(n=n)


def load_matrix(
    n_rows: int, n_cols: int, root: str | os.PathLike | None = None,
    dtype: np.dtype | str = np.float64,
) -> np.ndarray:
    """Load a matrix per the ``load_matr`` contract (``src/matr_utils.c:42-62``)."""
    path = matrix_path(n_rows, n_cols, root)
    if not path.exists():
        raise DataFileError(f"Unable to locate matrix file {path}")
    flat = _load_values(path, n_rows * n_cols)
    return flat.reshape(n_rows, n_cols).astype(dtype)


def load_vector(
    n: int, root: str | os.PathLike | None = None,
    dtype: np.dtype | str = np.float64,
) -> np.ndarray:
    """Load a vector per the ``load_vec`` contract (``src/matr_utils.c:65-83``)."""
    path = vector_path(n, root)
    if not path.exists():
        raise DataFileError(f"Unable to locate vector file {path}")
    return _load_values(path, n).astype(dtype)


def save_matrix(a: np.ndarray, root: str | os.PathLike | None = None) -> Path:
    """Write a matrix in the reference text format (%.4f, rows on lines)."""
    a = np.asarray(a)
    if a.ndim != 2:
        raise DataFileError(f"matrix must be 2-D, got shape {a.shape}")
    path = matrix_path(a.shape[0], a.shape[1], root)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savetxt(path, a, fmt="%.4f")
    return path


def save_vector(v: np.ndarray, root: str | os.PathLike | None = None) -> Path:
    """Write a vector in the reference text format (one %.4f per line)."""
    v = np.asarray(v).reshape(-1)
    path = vector_path(v.size, root)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savetxt(path, v, fmt="%.4f")
    return path


def generate_matrix(
    n_rows: int, n_cols: int, seed: int = 0, high: float = 10.0
) -> np.ndarray:
    """Random matrix like the reference's external numpy generator (README.md:32)."""
    rng = np.random.default_rng(seed)
    return np.round(rng.uniform(0.0, high, size=(n_rows, n_cols)), 4)


def generate_vector(n: int, seed: int = 1, high: float = 10.0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return np.round(rng.uniform(0.0, high, size=(n,)), 4)


def ensure_data(
    n_rows: int, n_cols: int, root: str | os.PathLike | None = None, seed: int = 0,
) -> tuple[np.ndarray, np.ndarray]:
    """Load the (matrix, vector) pair for a benchmark size, generating the
    files first if absent (README.md:32; ``.gitignore`` excludes ``*.txt``)."""
    # Generate only when the file is absent — an existing-but-malformed file
    # must keep raising DataFileError, not be silently clobbered.
    if not matrix_path(n_rows, n_cols, root).exists():
        save_matrix(generate_matrix(n_rows, n_cols, seed=seed), root)
    if not vector_path(n_cols, root).exists():
        save_vector(generate_vector(n_cols, seed=seed + 1), root)
    return load_matrix(n_rows, n_cols, root), load_vector(n_cols, root)
