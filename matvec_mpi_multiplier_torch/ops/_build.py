"""Build and load the CUDA kernels: ``nvcc`` into a shared library, ctypes.

The kernels have a plain C interface (``csrc/*.cu``), so no PyTorch headers
are compiled: one ``nvcc -c`` per source, all started together, then one
link into one library, in seconds, at first use, into the package's own
``build/`` directory
(``matvec_mpi_multiplier_torch/build``, so an installed copy never shares it
with another environment), and rebuilds it when a source or the flags
change (a hash stamp beside the library). Nothing here falls back: a
missing ``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[1]
SOURCES = tuple(sorted((PACKAGE_DIR / "csrc").glob("*.cu")))
# Headers the sources include: part of the stamp, so an edit rebuilds.
HEADERS = tuple(sorted((PACKAGE_DIR / "csrc").glob("*.cuh")))
BUILD_DIR = PACKAGE_DIR / "build"
LIB_NAME = "libmatvec_torch_kernels.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC",
    # Registers, shared memory and spills per kernel, in the build log.
    "-Xptxas=-v",
)
DEFAULT_CUDA_HOME = "/usr/local/cuda"


def find_nvcc() -> str:
    """``nvcc`` from PATH, else ``$CUDA_HOME/bin`` (default /usr/local/cuda)."""
    found = shutil.which("nvcc")
    if found:
        return found
    candidate = Path(os.environ.get("CUDA_HOME", DEFAULT_CUDA_HOME)) / "bin" / "nvcc"
    if candidate.is_file():
        return str(candidate)
    raise RuntimeError(
        f"nvcc not found on PATH or at {candidate}: the CUDA kernels "
        f"({', '.join(s.name for s in SOURCES)}) cannot be built, and the "
        "cuda tier has no fallback. Install the CUDA toolkit or set "
        "CUDA_HOME; CPU tensors use the plain version and need no build."
    )


def library_path() -> Path:
    return BUILD_DIR / LIB_NAME


def _stamp_path() -> Path:
    return library_path().with_name(LIB_NAME + ".sha256")


def _digest() -> str:
    h = hashlib.sha256()
    for source in (*SOURCES, *HEADERS):
        h.update(source.name.encode())
        h.update(source.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()


def build_library() -> str:
    """Compile every ``csrc/*.cu`` (one ``nvcc`` each, in parallel) and link
    them into one library; return the compiler's log."""
    nvcc = find_nvcc()
    out = library_path()
    out.parent.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    objects = [out.with_name(f"{s.stem}.{tag}.o") for s in SOURCES]
    tmp = out.with_name(f"{out.name}.{tag}")
    try:
        procs = [
            subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            for src, obj in zip(SOURCES, objects)
        ]
        logs = [proc.communicate()[0] for proc in procs]
        failed = [(src.name, proc.returncode, log)
                  for src, proc, log in zip(SOURCES, procs, logs) if proc.returncode]
        if failed:
            raise RuntimeError("nvcc failed to compile " + "".join(
                f"\n{name} (exit {rc}):\n{log}" for name, rc, log in failed))
        link = subprocess.run(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
             "-o", str(tmp), *map(str, objects)],
            capture_output=True, text=True, check=False,
        )
        if link.returncode != 0:
            raise RuntimeError(
                f"nvcc failed to link {[s.name for s in SOURCES]} "
                f"(exit {link.returncode}):\n{link.stdout}{link.stderr}"
            )
        os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    finally:
        for path in (*objects, tmp):
            path.unlink(missing_ok=True)
    _stamp_path().write_text(_digest())
    return "".join(logs) + link.stdout + link.stderr


@functools.cache
def load_library() -> ctypes.CDLL:
    """The kernel library, built first if absent or stale."""
    stamp = _stamp_path()
    if not (library_path().exists() and stamp.exists()
            and stamp.read_text() == _digest()):
        build_library()
    lib = ctypes.CDLL(str(library_path()))
    # Every pointer and the stream as c_void_p: an undeclared argument is
    # passed as a 32-bit int and the pointer is cut.
    # dtype; int plan[3] (route, grid, warps); A, x, y, the split route's
    # scratch (NULL on rows); m, k; the stream; the launch predicate (NULL
    # or a device bool).
    lib.matvec_gemv.argtypes = [
        ctypes.c_int, ctypes.POINTER(ctypes.c_int), *[ctypes.c_void_p] * 4,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.matvec_gemv.restype = ctypes.c_int
    lib.matvec_gemv_acc_x.argtypes = lib.matvec_gemv.argtypes
    lib.matvec_gemv_acc_x.restype = ctypes.c_int
    # dtype, route, bm, bn, stages; A, B, Bt scratch (NULL outside
    # wgmma_tma), C; m, n, k; the stream.
    lib.matvec_gemm.argtypes = [
        *[ctypes.c_int] * 5, *[ctypes.c_void_p] * 4,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
    ]
    lib.matvec_gemm.restype = ctypes.c_int
    # dtype, route, bm, bn, stages, direct_b; m, n; int out[5].
    lib.matvec_gemm_launch_info.argtypes = [
        *[ctypes.c_int] * 6, ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.matvec_gemm_launch_info.restype = ctypes.c_int
    # route, fmt, dtype; q, scales, q2, scales2 (NULL (None) outside int8c),
    # x, y, the parts' scratch (NULL on fma); m, k, n, block; the stream.
    lib.matvec_quant_gemv.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, *[ctypes.c_void_p] * 7,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_void_p,
    ]
    lib.matvec_quant_gemv.restype = ctypes.c_int
    # op, fmt, dtype; A (or q), scales, q2, scales2 (NULL where absent),
    # block, the quantized GEMV's route and scratch (NULL on fma or native),
    # the native GEMV's int plan[3] and scratch (NULL for quantized storage
    # and on rows); x, r, p, ap, s_in; x2, r2, p2, s_out, partial; n, m_loc,
    # k_loc, off; the stream; the launch predicate (NULL or a device bool).
    lib.matvec_solver_step.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        *[ctypes.c_void_p] * 4, ctypes.c_int64, ctypes.c_int, ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_int), ctypes.c_void_p,
        *[ctypes.c_void_p] * 10,
        *[ctypes.c_int64] * 4, ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.matvec_solver_step.restype = ctypes.c_int
    # dtype, p; arrays of p pointers to the panels, the x segments and the
    # output chunks; m, k/p; the stream.
    lib.matvec_ring_gemv.argtypes = [
        ctypes.c_int, ctypes.c_int, *[ctypes.POINTER(ctypes.c_void_p)] * 3,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
    ]
    lib.matvec_ring_gemv.restype = ctypes.c_int
    # route, dtype of k and v; q, k, v, q_pos, k_pos, o, m, l; h, sq, sk,
    # d; causal; the stream.
    lib.matvec_flash_partial.argtypes = [
        ctypes.c_int, ctypes.c_int, *[ctypes.c_void_p] * 8, *[ctypes.c_int64] * 4,
        ctypes.c_int, ctypes.c_void_p,
    ]
    lib.matvec_flash_partial.restype = ctypes.c_int
    # route, dtype; int out[5].
    lib.matvec_flash_launch_info.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int),
    ]
    lib.matvec_flash_launch_info.restype = ctypes.c_int
    lib.matvec_error_string.argtypes = [ctypes.c_int]
    lib.matvec_error_string.restype = ctypes.c_char_p
    return lib
