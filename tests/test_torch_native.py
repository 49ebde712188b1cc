"""The port's native C++ tier against the JAX package's.

The port builds its own copy of the C++ GEMV/GEMM (``matvec_mpi_multiplier_torch
/native``, ``utils/native_lib.py``) with the JAX Makefile's flags, so its
ctypes oracles give the JAX oracles' bits. The ``native`` tiers run inside
the strategies on CPU meshes and refuse CUDA tensors. The build cases are
``tests/test_native_build.py``'s, on the port's build (``utils/native_lib.py``).
"""

import os
import shutil
import types

import numpy as np
import pytest
import torch

from matvec_mpi_multiplier_torch import get_strategy
from matvec_mpi_multiplier_torch.models.gemm import build_gemm
from matvec_mpi_multiplier_torch.ops import (
    available_gemm_kernels,
    available_kernels,
    gemm_kernel_name_for,
    get_gemm_kernel,
    get_kernel,
    native_gemm,
    native_gemv,
)
from matvec_mpi_multiplier_torch.parallel.mesh import make_mesh
from matvec_mpi_multiplier_torch.utils import native_lib
from matvec_mpi_multiplier_torch.utils.errors import ConfigError
from matvec_mpi_multiplier_tpu.ops import native_gemm as jax_native_gemm
from matvec_mpi_multiplier_tpu.ops import native_gemv as jax_native_gemv

from conftest import FIXTURE_MATRIX, FIXTURE_PRODUCT, FIXTURE_VECTOR

CPU = torch.device("cpu")
HAS_CXX = shutil.which("g++") is not None

pytestmark = pytest.mark.skipif(
    not (HAS_CXX and jax_native_gemv.native_available()),
    reason="no C++ toolchain to build either package's native library",
)


@pytest.fixture(scope="module", autouse=True)
def _registered():
    assert native_gemv.register_if_available(build=True)
    assert native_gemm.register_if_available(build=True)


SHAPES = [(64, 128), (33, 77), (1, 1000), (200, 3)]
DTYPES = [np.float32, np.float64]


@pytest.mark.parametrize("dtype", DTYPES)
def test_gemv_ctypes_fixture_is_the_jax_oracles(dtype):
    a, x = FIXTURE_MATRIX.astype(dtype), FIXTURE_VECTOR.astype(dtype)
    y = native_gemv.gemv_ctypes(a, x)
    assert y.dtype == dtype
    np.testing.assert_array_equal(y, jax_native_gemv.gemv_ctypes(a, x))
    np.testing.assert_allclose(y, FIXTURE_PRODUCT, rtol=1e-12 if dtype == np.float64 else 1e-6)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_gemv_ctypes_is_the_jax_oracles(shape, dtype):
    rng = np.random.default_rng(sum(shape))
    a = rng.standard_normal(shape).astype(dtype)
    x = rng.standard_normal(shape[1]).astype(dtype)
    y = native_gemv.gemv_ctypes(a, x)
    np.testing.assert_array_equal(y, jax_native_gemv.gemv_ctypes(a, x))
    # The tensor face runs the same kernel.
    y_t = native_gemv.gemv_native(torch.from_numpy(a), torch.from_numpy(x))
    np.testing.assert_array_equal(y_t.numpy(), y)


@pytest.mark.parametrize("shape", [(32, 48, 24), (16, 80, 8), (5, 130, 1), (64, 64, 33)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_gemm_ctypes_is_the_jax_oracles(shape, dtype):
    m, k, n = shape
    rng = np.random.default_rng(m * k + n)
    a = rng.standard_normal((m, k)).astype(dtype)
    b = rng.standard_normal((k, n)).astype(dtype)
    c = native_gemm.gemm_ctypes(a, b)
    assert c.dtype == dtype
    np.testing.assert_array_equal(c, jax_native_gemm.gemm_ctypes(a, b))
    c_t = native_gemm.gemm_native(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_array_equal(c_t.numpy(), c)


@pytest.mark.parametrize("fn,args,err,match", [
    (native_gemv.gemv_ctypes, (np.ones((2, 2), np.int32), np.ones(2, np.int32)),
     TypeError, "float32/float64"),
    (native_gemv.gemv_ctypes, (np.ones((2, 3)), np.ones(2)), ValueError, "shape mismatch"),
    (native_gemm.gemm_ctypes, (np.ones((8, 12)), np.ones((10, 4))), ValueError,
     "shape mismatch"),
    (native_gemm.gemm_ctypes, (np.ones((4, 4), np.float16), np.ones((4, 4), np.float16)),
     TypeError, "float32/float64"),
    (native_gemv.gemv_native, (torch.ones(2, 2, dtype=torch.bfloat16),
                               torch.ones(2, dtype=torch.bfloat16)),
     TypeError, "float32/float64"),
    (native_gemv.gemv_native, (torch.ones(2, 3), torch.ones(2)), ValueError,
     "shape mismatch"),
    (native_gemm.gemm_native, (torch.ones(4, 4, dtype=torch.float16),
                               torch.ones(4, 4, dtype=torch.float16)),
     TypeError, "float32/float64"),
    (native_gemm.gemm_native, (torch.ones(4, 3), torch.ones(4, 2)), ValueError,
     "shape mismatch"),
], ids=["gemv-int32", "gemv-shape", "gemm-shape", "gemm-fp16", "native-bf16",
        "native-shape", "native-gemm-fp16", "native-gemm-shape"])
def test_refusals(fn, args, err, match):
    with pytest.raises(err, match=match):
        fn(*args)


def test_jax_refuses_the_same_dtypes():
    with pytest.raises(TypeError, match="float32/float64"):
        jax_native_gemv.gemv_ctypes(np.ones((2, 2), np.int32), np.ones(2, np.int32))
    with pytest.raises(TypeError, match="float32/float64"):
        native_gemv.gemv_ctypes(np.ones((2, 2), np.int32), np.ones(2, np.int32))


def test_native_is_in_both_registries():
    assert "native" in available_kernels()
    assert "native" in available_gemm_kernels()
    assert get_kernel("native") is native_gemv.gemv_native
    assert get_gemm_kernel("native") is native_gemm.gemm_native
    assert gemm_kernel_name_for("native") == "native"


def _fake_cuda(t: torch.Tensor):
    """A stand-in for a tensor on the card: the device check reads it."""
    return types.SimpleNamespace(device=torch.device("cuda", 0), dtype=t.dtype,
                                 shape=t.shape)


@pytest.mark.parametrize("fn,rhs", [(native_gemv.gemv_native, (8,)),
                                    (native_gemm.gemm_native, (8, 2))])
@pytest.mark.parametrize("which", ["a", "b"])
def test_cuda_tensors_are_refused(fn, rhs, which):
    a, b = torch.ones(4, 8, dtype=torch.float64), torch.ones(rhs, dtype=torch.float64)
    if which == "a":
        a = _fake_cuda(a)
    else:
        b = _fake_cuda(b)
    with pytest.raises(ConfigError, match="host kernel"):
        fn(a, b)


@pytest.mark.parametrize("name", ["rowwise", "colwise", "blockwise"])
def test_strategies_with_native_kernel(devices, rng, name):
    import jax.numpy as jnp
    import matvec_mpi_multiplier_tpu as mv_jax

    a = rng.standard_normal((64, 128))
    x = rng.standard_normal(128)
    y = get_strategy(name).build(make_mesh(4, devices=[CPU] * 4), kernel="native")(
        torch.from_numpy(a), torch.from_numpy(x))
    np.testing.assert_allclose(y.numpy(), a @ x, rtol=1e-12)
    if name == "rowwise":
        want = mv_jax.get_strategy(name).build(mv_jax.make_mesh(4), kernel="native")(
            jnp.asarray(a), jnp.asarray(x))
        np.testing.assert_array_equal(y.numpy(), np.asarray(want))


@pytest.mark.parametrize("name", ["rowwise", "colwise", "blockwise"])
def test_gemm_strategies_with_native_kernel(rng, name):
    a = rng.standard_normal((16, 32))
    b = rng.standard_normal((32, 8))
    c = build_gemm(name, make_mesh(8, devices=[CPU] * 8), kernel="native")(
        torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(c.numpy(), a @ b, rtol=1e-12)


def test_sweep_kernel_native_on_the_cpu(tmp_path):
    from matvec_mpi_multiplier_torch.bench.metrics import read_csv
    from matvec_mpi_multiplier_torch.bench.sweep import main

    assert main(["--platform", "cpu", "--host-devices", "2", "--sizes", "16",
                 "--strategy", "rowwise", "--kernel", "native", "--dtype",
                 "float64", "--n-reps", "2", "--measure", "sync",
                 "--data-root", str(tmp_path)]) == 0
    rows = read_csv(tmp_path / "out" / "rowwise.csv")
    assert len(rows) == 2  # one per mesh size: 1 and 2


def test_sweep_kernel_native_refuses_the_card(tmp_path, monkeypatch):
    from matvec_mpi_multiplier_torch.bench import sweep

    ran = []
    monkeypatch.setattr(sweep, "_sweep_loop", lambda *a, **k: ran.append(a))
    with pytest.raises(ConfigError, match="--platform cpu only"):
        sweep.main(["--platform", "cuda", "--sizes", "16", "--kernel", "native",
                    "--data-root", str(tmp_path)])
    assert ran == []


# ------------------------------------------------------------ the build

@pytest.fixture()
def private_build(tmp_path, monkeypatch):
    """The build pointed at a private directory, with no handle loaded."""
    monkeypatch.delenv(native_lib.LIB_ENV, raising=False)
    monkeypatch.setattr(native_lib, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native_lib, "_lib", None)
    return tmp_path / "build"


def test_ensure_built_succeeds_with_toolchain(private_build):
    assert native_lib.ensure_built()
    assert native_lib.lib_path() == private_build / native_lib.LIB_NAME
    assert native_lib.lib_path().exists()
    lib = native_lib.load_library()
    for symbol in ("matvec_gemv_f32", "matvec_gemv_f64", "matvec_gemm_f32",
                   "matvec_gemm_f64", "matvec_load_text"):
        assert hasattr(lib, symbol)


def test_override_env_is_never_built_over(monkeypatch, tmp_path):
    missing = tmp_path / "nope" / "lib.so"
    monkeypatch.setenv(native_lib.LIB_ENV, str(missing))
    assert native_lib.ensure_built() is False
    assert not missing.exists()


def test_stale_library_is_rebuilt(private_build):
    assert native_lib.ensure_built()
    lib = native_lib.lib_path()
    os.utime(lib, (1.0, 1.0))
    before = lib.stat().st_mtime
    # A stamp that matches no source: an edit since the build.
    native_lib._stamp_path().write_text("0" * 64)
    assert native_lib.ensure_built()
    assert lib.stat().st_mtime > before
    assert native_lib._fresh(native_lib._compiler())


def test_fresh_library_is_not_rebuilt(private_build):
    assert native_lib.ensure_built()
    lib = native_lib.lib_path()
    os.utime(lib, (1.0, 1.0))
    assert native_lib.ensure_built()
    assert lib.stat().st_mtime == 1.0


def test_corrupt_library_is_not_loaded(monkeypatch, tmp_path, capsys):
    garbage = tmp_path / native_lib.LIB_NAME
    garbage.write_bytes(b"\x7fELFnot-really-an-elf")
    monkeypatch.setenv(native_lib.LIB_ENV, str(garbage))
    monkeypatch.setattr(native_lib, "_lib", None)
    assert native_lib.load_library() is None
    assert "unloadable" in capsys.readouterr().err


def test_failed_build_raises_with_the_compiler_output(private_build, tmp_path,
                                                      monkeypatch):
    src = tmp_path / "src"
    src.mkdir()
    (src / "broken.cc").write_text("int f( { return 0; }\n")
    monkeypatch.setattr(native_lib, "SOURCE_DIR", src)
    with pytest.raises(native_lib.NativeBuildError, match="broken.cc"):
        native_lib.ensure_built()
    assert not native_lib.lib_path().exists()


def test_build_uses_the_jax_makefile_flags():
    makefile = (native_lib.PACKAGE_DIR.parent / "native" / "Makefile").read_text()
    line = next(ln for ln in makefile.splitlines() if ln.startswith("CXXFLAGS"))
    assert line.split("?=")[1].split() == list(native_lib.CXXFLAGS)
