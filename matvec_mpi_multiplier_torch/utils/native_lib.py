"""Building and loading the native C++ library (the port's own copy).

The native tier is the host-side C++ GEMV/GEMM and the text loader, built
from the port's sources ``matvec_mpi_multiplier_torch/native/*.cc`` with
``g++`` into the package's ``build/`` directory, beside the CUDA kernels'
library (``ops/_build.py``). Consumers: ``ops/native_gemv.py``,
``ops/native_gemm.py`` and ``utils/io.py``; none imports torch here.

* The flags are the JAX package's Makefile's (:data:`CXXFLAGS`), so the
  arithmetic is its ctypes oracle's bit for bit on the same host.
* The library is built at first use and rebuilt when a source, the
  compiler, the flags or the host's CPU change: a sha256 stamp sits beside
  it, as beside the CUDA library.
* The build is serialized under ``flock`` and the library appears by an
  atomic rename, so concurrent processes (test workers, ranks of one run)
  never load half a file.
* :data:`LIB_ENV` (``MATVEC_TORCH_NATIVE_LIB``) names a prebuilt library
  instead; it is loaded as it is and never built over.
* Where ``g++`` exists and the build fails, :func:`ensure_built` raises with
  the compiler's output. Only a host without a compiler reads as "not
  built".
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[1]
SOURCE_DIR = PACKAGE_DIR / "native"
BUILD_DIR = PACKAGE_DIR / "build"
LIB_NAME = "libmatvec_torch_native.so"
LIB_ENV = "MATVEC_TORCH_NATIVE_LIB"
# The JAX package's native/Makefile CXXFLAGS.
CXXFLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall")

_lib: ctypes.CDLL | None = None


class NativeBuildError(RuntimeError):
    """``g++`` is there and could not build the native library."""


def sources() -> tuple[Path, ...]:
    return tuple(sorted(SOURCE_DIR.glob("*.cc")))


def lib_path() -> Path:
    if LIB_ENV in os.environ:
        return Path(os.environ[LIB_ENV])
    return BUILD_DIR / LIB_NAME


def _stamp_path() -> Path:
    return BUILD_DIR / (LIB_NAME + ".sha256")


def _compiler() -> list[str] | None:
    """The C++ compiler command (``$CXX``, default ``g++``; its first word
    must be on PATH), or None."""
    words = os.environ.get("CXX", "g++").split()
    found = shutil.which(words[0]) if words else None
    return None if found is None else [found, *words[1:]]


def build_command(cxx: list[str], out: Path) -> list[str]:
    """The one ``g++`` command that builds the library from the port's
    sources."""
    return [*cxx, *CXXFLAGS, "-shared", *map(str, sources()), "-o", str(out)]


def _host_tag() -> str:
    """The CPU the library is built for: ``-march=native`` code may not run
    on another (a build directory copied between machines)."""
    try:
        info = Path("/proc/cpuinfo").read_text().split("\n\n")[0]
    except OSError:
        import platform

        return platform.processor() or platform.machine()
    keep = ("model name", "flags", "Features", "CPU part")
    return "\n".join(ln for ln in info.splitlines() if ln.startswith(keep))


def _digest(cxx: list[str]) -> str:
    h = hashlib.sha256()
    for source in sources():
        h.update(source.name.encode())
        h.update(source.read_bytes())
    h.update(" ".join([*cxx, *CXXFLAGS]).encode())
    h.update(_host_tag().encode())
    return h.hexdigest()


def _fresh(cxx: list[str]) -> bool:
    stamp = _stamp_path()
    return (lib_path().exists() and stamp.exists()
            and stamp.read_text() == _digest(cxx))


def ensure_built(timeout_s: float = 300.0) -> bool:
    """Build the native library if it is absent or stale; True when it is
    there afterwards.

    * With :data:`LIB_ENV` set: True when that file exists; nothing is built.
    * Without a compiler: True when a library from an earlier build exists.
    * Otherwise the library is (re)built under a file lock and published by
      an atomic rename; a failed or timed-out build raises
      :class:`NativeBuildError` with the compiler's output.
    """
    global _lib
    if LIB_ENV in os.environ:
        return lib_path().exists()
    cxx = _compiler()
    if cxx is None:
        return lib_path().exists()
    if _fresh(cxx):
        return True

    import fcntl

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".native.lock", "w") as lockf:
        fcntl.flock(lockf, fcntl.LOCK_EX)
        # Another process may have built it while this one waited.
        if _fresh(cxx):
            return True
        tmp = BUILD_DIR / f"{LIB_NAME}.build-{os.getpid()}"
        try:
            result = subprocess.run(
                build_command(cxx, tmp), capture_output=True, text=True,
                timeout=timeout_s,
            )
        except subprocess.TimeoutExpired as e:
            tmp.unlink(missing_ok=True)
            raise NativeBuildError(
                f"native build did not finish in {timeout_s:.0f} s: {e}"
            ) from None
        if result.returncode != 0 or not tmp.exists():
            tmp.unlink(missing_ok=True)
            raise NativeBuildError(
                f"native build failed (exit {result.returncode}): "
                f"{' '.join(build_command(cxx, tmp))}\n"
                f"{result.stdout}{result.stderr}"
            )
        os.replace(tmp, lib_path())
        _stamp_path().write_text(_digest(cxx))
        # The next load_library() maps the fresh build.
        _lib = None
    return True


def load_library() -> ctypes.CDLL | None:
    """The native library, loaded once per process; None when it is not
    there or cannot be loaded (a corrupt or foreign file)."""
    global _lib
    if _lib is None:
        path = lib_path()
        if not path.exists():
            return None
        try:
            _lib = ctypes.CDLL(str(path))
        except OSError as e:
            print(f"native library unloadable ({path}): {e}", file=sys.stderr)
            return None
    return _lib


def library() -> ctypes.CDLL | None:
    """The library for a consumer: built (or checked against its stamp) at
    the first use in this process, then loaded."""
    if _lib is None:
        ensure_built()
    return load_library()


def declare_ctypes_sig(
    lib: ctypes.CDLL, symbol: str, scalar_ctype, n_arrays: int, n_ints: int
) -> None:
    """Declare ``symbol``'s signature: ``n_arrays`` pointers to
    ``scalar_ctype`` followed by ``n_ints`` int64s, returning void, the
    shape of every kernel entry point in ``native/``."""
    fn = getattr(lib, symbol)
    fn.restype = None
    fn.argtypes = (
        [ctypes.POINTER(scalar_ctype)] * n_arrays + [ctypes.c_int64] * n_ints
    )
