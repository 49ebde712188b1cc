"""The port's native text loader and debug printers against the JAX package's.

Each case writes one file and reads it through both packages' ``utils/io.py``
(the port's on its own ``native/textio.cc``): the same values, bit for bit,
or the same refusal. ``io.LOADS`` shows which parser a load went through.
"""

from pathlib import Path

import numpy as np
import pytest

from matvec_mpi_multiplier_torch.utils import io
from matvec_mpi_multiplier_torch.utils.errors import DataFileError
from matvec_mpi_multiplier_tpu.utils import io as jax_io
from matvec_mpi_multiplier_tpu.utils.errors import DataFileError as JaxDataFileError


def _native_io_available():
    return io._native_lib() is not None and jax_io._native_lib() is not None


native = pytest.mark.skipif(not _native_io_available(),
                            reason="no C++ toolchain to build the native loaders")


@pytest.mark.parametrize("value,precision", [
    (np.array([[1.234, 5.0]]), 2),
    (np.array([1.0, 2.0]), 2),
    (np.arange(12.0).reshape(3, 4) / 7, 4),
    (np.array([[-0.005, 1e6]]), 1),
])
def test_format_matrix_is_the_jax_packages(value, precision):
    assert io.format_matrix(value, precision) == jax_io.format_matrix(value, precision)


def test_debug_printers(capsys):
    """print_matr/print_vec analogs (src/matr_utils.c:21-39)."""
    assert io.format_matrix(np.array([[1.234, 5.0]])) == "1.23 5.00"
    assert io.format_matrix(np.array([1.0, 2.0])) == "1.00 2.00"  # 1-D promotes
    assert io.format_vector(np.array([1.5, 2.25]), precision=1) == "1.5\n2.2"
    with pytest.raises(DataFileError, match="1-D or 2-D"):
        io.format_matrix(np.zeros((2, 2, 2)))
    v = np.array([3.14159, -2.0, 0.0])
    io.print_vector(v, 3)
    io.print_matrix(v.reshape(1, 3))
    got = capsys.readouterr().out
    jax_io.print_vector(v, 3)
    jax_io.print_matrix(v.reshape(1, 3))
    assert got == capsys.readouterr().out


@native
def test_native_loader_matches_numpy(tmp_path, monkeypatch):
    a = io.generate_matrix(37, 53, seed=9)
    io.save_matrix(a, tmp_path)
    before = io.LOADS["native"]
    native_a = io.load_matrix(37, 53, tmp_path)
    assert io.LOADS["native"] == before + 1
    np.testing.assert_array_equal(native_a, jax_io.load_matrix(37, 53, tmp_path))
    monkeypatch.setenv("MATVEC_NATIVE_IO", "0")
    via_numpy = io.load_matrix(37, 53, tmp_path)
    np.testing.assert_array_equal(native_a, via_numpy)
    np.testing.assert_array_equal(native_a, a)


@native
@pytest.mark.parametrize("text,n", [("1\n2\n3\n4\n5\n6\n7\n8\n", 9),
                                    ("1\n2\n3\n4\n5\n", 4)],
                         ids=["too-few", "too-many"])
def test_native_loader_count_mismatch(tmp_path, text, n):
    (tmp_path / f"vector_{n}.txt").write_text(text)
    with pytest.raises(DataFileError, match="expected") as port_err:
        io.load_vector(n, tmp_path)
    with pytest.raises(JaxDataFileError, match="expected") as jax_err:
        jax_io.load_vector(n, tmp_path)
    assert str(port_err.value) == str(jax_err.value)


def test_numpy_fallback_env(tmp_path, monkeypatch):
    monkeypatch.setenv("MATVEC_NATIVE_IO", "0")
    io.save_vector(np.arange(5.0), tmp_path)
    before = io.LOADS["numpy"]
    np.testing.assert_array_equal(io.load_vector(5, tmp_path), np.arange(5.0))
    assert io.LOADS["numpy"] == before + 1
    np.testing.assert_array_equal(jax_io.load_vector(5, tmp_path), np.arange(5.0))


@native
def test_native_loader_strtod_fallback_tokens(tmp_path, monkeypatch):
    # e-notation / >15-digit tokens route through the strtod fallback and
    # must stay bitwise identical to the numpy parser.
    (tmp_path / "vector_6.txt").write_text(
        "1.5e3 -2.25E-2 0.123456789012345678 42 -0 7.0001\n"
    )
    got = io.load_vector(6, tmp_path)
    np.testing.assert_array_equal(got, jax_io.load_vector(6, tmp_path))
    monkeypatch.setenv("MATVEC_NATIVE_IO", "0")
    np.testing.assert_array_equal(got, io.load_vector(6, tmp_path))
    assert np.signbit(got[4])


@native
@pytest.mark.parametrize("name,text", [
    ("vector_4.txt", "1 2 3 abc\n"),
    ("vector_2.txt", "1.5-2.5\n"),
    ("vector_2.txt", "0x1p3 2.0\n"),
    ("matrix_2_4.txt", "1 2 3\n4 5 6 7 8\n"),
], ids=["trailing-garbage", "fused-tokens", "hex-float", "ragged"])
def test_native_loader_rejects_what_numpy_rejects(tmp_path, name, text):
    (tmp_path / name).write_text(text)
    shape = [int(s) for s in name[:-4].split("_")[1:]]
    load = io.load_matrix if len(shape) == 2 else io.load_vector
    jax_load = jax_io.load_matrix if len(shape) == 2 else jax_io.load_vector
    with pytest.raises(Exception) as port_err:
        load(*shape, tmp_path)
    with pytest.raises(Exception) as jax_err:
        jax_load(*shape, tmp_path)
    assert type(port_err.value) is type(jax_err.value)
    assert str(port_err.value) == str(jax_err.value)


@native
def test_native_loader_skips_blank_lines(tmp_path):
    # Blank lines are not ragged: numpy skips them, and so does the native path.
    (tmp_path / "matrix_2_2.txt").write_text("1 2\n\n3 4\n")
    before = io.LOADS["native"]
    got = io.load_matrix(2, 2, tmp_path)
    assert io.LOADS["native"] == before + 1
    np.testing.assert_array_equal(got, np.array([[1.0, 2.0], [3.0, 4.0]]))
    np.testing.assert_array_equal(got, jax_io.load_matrix(2, 2, tmp_path))


@native
def test_committed_fixture_through_the_native_loader():
    from conftest import FIXTURE_MATRIX, FIXTURE_VECTOR

    root = Path(__file__).resolve().parents[1] / "data"
    before = io.LOADS["native"]
    np.testing.assert_array_equal(io.load_matrix(4, 8, root), FIXTURE_MATRIX)
    np.testing.assert_array_equal(io.load_vector(8, root), FIXTURE_VECTOR)
    assert io.LOADS["native"] == before + 2
