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
the same operands from the same seed. Parsing goes through the native C++
loader (``native/textio.cc``, built by ``utils/native_lib.py``) where it is
built, and ``np.loadtxt`` otherwise or with ``MATVEC_NATIVE_IO=0``; both
give the same bits and reject the same files. :data:`LOADS` counts the
files each parser read.
"""

from __future__ import annotations

import ctypes
import os
from collections import Counter
from pathlib import Path

import numpy as np

from .constants import MATRIX_FILENAME_FMT, VECTOR_FILENAME_FMT
from .errors import DataFileError

_NATIVE_IO_ENV = "MATVEC_NATIVE_IO"  # set to "0" to force the numpy parser

# Files parsed per loader ("native", "numpy") in this process: how a caller
# tells which parser a load went through.
LOADS: Counter = Counter()


def _native_lib():
    """The native library with the loader's signature declared, or None
    (switched off, or no compiler and no earlier build)."""
    if os.environ.get(_NATIVE_IO_ENV, "1") == "0":
        return None
    from .native_lib import library

    lib = library()
    if lib is None:
        return None
    if lib.matvec_load_text.restype != ctypes.c_int64:
        lib.matvec_load_text.restype = ctypes.c_int64
        lib.matvec_load_text.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_double),
            ctypes.c_int64,
        ]
    return lib


def _load_values(path: Path, count: int) -> np.ndarray:
    """Parse exactly ``count`` whitespace-separated doubles from ``path``.

    The native loader's return code (``native/textio.cc``): ``count`` is a
    whole file; another ``n >= 0`` (``count + 1``: more values than
    ``count``) is a count mismatch; ``-1`` (unreadable) and ``-3``
    (malformed) fall through to ``np.loadtxt``, so both parsers reject the
    same files with numpy's message. A count mismatch raises
    :class:`DataFileError` either way.
    """
    lib = _native_lib()
    if lib is not None:
        out = np.empty(count, np.float64)
        n = lib.matvec_load_text(
            os.fsencode(path),  # not str.encode: paths may hold non-UTF-8
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            count,
        )
        if n == count:
            LOADS["native"] += 1
            return out
        if n >= 0:
            held = f"more than {count}" if n > count else str(n)
            raise DataFileError(
                f"{path} holds {held} values, expected {count}"
            )
    LOADS["numpy"] += 1
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


def format_matrix(a: np.ndarray, precision: int = 2) -> str:
    """Debug-print formatting, the ``print_matr`` analog
    (``src/matr_utils.c:21-31``): one row per line, fixed precision."""
    a = np.atleast_2d(np.asarray(a))
    if a.ndim != 2:
        raise DataFileError(f"matrix must be 1-D or 2-D, got shape {a.shape}")
    return "\n".join(
        " ".join(f"{v:.{precision}f}" for v in row) for row in a
    )


def format_vector(v: np.ndarray, precision: int = 2) -> str:
    """``print_vec`` analog (``src/matr_utils.c:33-39``): one value per line."""
    return "\n".join(f"{x:.{precision}f}" for x in np.asarray(v).reshape(-1))


def print_matrix(a: np.ndarray, precision: int = 2) -> None:
    print(format_matrix(a, precision))


def print_vector(v: np.ndarray, precision: int = 2) -> None:
    print(format_vector(v, precision))


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
