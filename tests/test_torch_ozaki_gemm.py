"""The port's int8 ozaki tier (GEMM ``ozaki``/``ozaki6``, GEMV ``ozaki_i8``)
against the JAX package's ``ops/ozaki_gemm.py``.

The same numpy operands go through both. Bars, each stated where it is
used:

* ``_split_int8`` (slices and exponents, both axes), ``_int32_halves`` and
  the tiers on normal-range fp32 data: **bitwise** JAX's. The int8
  products are exact int32 (``torch._int_mm``; ``torch.matmul`` on int8
  would wrap) at a k where an int8 accumulator wraps;
* row chunking and ``_I8_BLOCK`` shrunk to cut k into chunks: bitwise the
  unchunked result (the chunk partials fold exactly in integer space);
* the JAX tests' contracts: the cancellation case within 1e-7 relative of
  fp64 where plain fp32 is off by more than 1; ozaki6 on random data at
  the output's rounding limit (99th percentile 1 ulp, max 64); the long
  drift within 1e-7 and twice closer than plain fp32; the GEMV face within
  1e-7 of the output scale; fp64 inputs bitwise the plain fp64 product; exponent extremes
  finite and within rtol 1e-2 of fp64; the cross-chunk cancellation at
  huge exponents exact zeros.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import matvec_mpi_multiplier_tpu as mv_jax
from matvec_mpi_multiplier_tpu.models.gemm import build_gemm as jax_build_gemm
from matvec_mpi_multiplier_tpu.ops import ozaki_gemm as jg
from matvec_mpi_multiplier_torch.models.gemm import build_gemm
from matvec_mpi_multiplier_torch.ops import compensated as tc
from matvec_mpi_multiplier_torch.ops import ozaki_gemm as tg
from matvec_mpi_multiplier_torch.ops.gemm_kernels import available_gemm_kernels
from matvec_mpi_multiplier_torch.ops.gemv import available_kernels
from matvec_mpi_multiplier_torch.parallel.mesh import make_mesh

CPU = torch.device("cpu")


def _max_rel(y, oracle):
    return float(np.max(np.abs(y.astype(np.float64) - oracle)
                        / np.maximum(np.abs(oracle), 1e-300)))


def _wide(rng, shape):
    return (rng.standard_normal(shape) * 10.0 ** rng.uniform(-2, 2, shape)).astype(np.float32)


def both(name, a, b, **kw):
    """(JAX's, the port's) result of ``name`` on the same operands, numpy."""
    j = np.asarray(getattr(jg, name)(jnp.asarray(a), jnp.asarray(b), **kw))
    t = getattr(tg, name)(torch.from_numpy(a), torch.from_numpy(b), **kw).numpy()
    return j, t


def test_registered_in_both_registries():
    assert {"ozaki", "ozaki6"} <= set(available_gemm_kernels())
    assert "ozaki_i8" in available_kernels()


@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("n_slices", [4, 6])
@pytest.mark.parametrize("scale", [1.0, 2.0 ** -100])
def test_split_int8_bitwise(axis, n_slices, scale):
    """Slices and the original line exponents, per row (axis 1) and per
    column (axis 0), also for lines prescaled into the window."""
    v = (_wide(np.random.default_rng(0), (24, 300)) * np.float32(scale)).astype(np.float32)
    js, je = jg._split_int8(jnp.asarray(v), n_slices, axis=axis)
    ts, te = tg._split_int8(torch.from_numpy(v), n_slices, axis=axis)
    assert ts.dtype == torch.int8
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))


def test_split_int8_reconstructs_within_window():
    v = np.random.default_rng(0).standard_normal((32, 512)).astype(np.float32)
    slices, exp = tg._split_int8(torch.from_numpy(v), 4, axis=1)
    e = exp.numpy()
    recon = sum(slices[i].double().numpy() * np.ldexp(1.0, e - 7 * (i + 1)) for i in range(4))
    assert np.all(np.abs(recon - v) <= np.ldexp(1.0, e - 7 * 4))


def test_int32_halves_bitwise_and_exact():
    rng = np.random.default_rng(1)
    p = np.concatenate([rng.integers(-2 ** 31, 2 ** 31, 4096),
                        [-2 ** 31, 2 ** 31 - 1, -1, 0, 65535, -65536]]).astype(np.int32)
    jh, jl = jg._int32_halves(jnp.asarray(p))
    th, tl = tg._int32_halves(torch.from_numpy(p))
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(th.double().numpy() + tl.double().numpy(), p)


def test_int8_products_are_exact_where_int8_wraps():
    """k = 4096 products of values near ±127: the int32 result is the exact
    integer product, and int8 arithmetic would have wrapped."""
    rng = np.random.default_rng(2)
    a = rng.integers(100, 128, (20, 4096)).astype(np.int8)
    b = rng.integers(100, 128, (4096, 3)).astype(np.int8)
    exact = a.astype(np.int64) @ b.astype(np.int64)
    assert exact.max() > 2 ** 24
    got = tg._int8_matmul(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.int32 and tuple(got.shape) == (20, 3)
    np.testing.assert_array_equal(got.numpy(), exact)
    # Short shapes pad (m <= 16, k and n not multiples of 8), exactly.
    got = tg._int8_matmul(torch.from_numpy(a[:3, :1001]), torch.from_numpy(b[:1001, :1]))
    np.testing.assert_array_equal(
        got.numpy(), a[:3, :1001].astype(np.int64) @ b[:1001, :1].astype(np.int64))


@pytest.mark.parametrize("name", ["matmul_ozaki", "matmul_ozaki6"])
@pytest.mark.parametrize("data", ["random", "wide"])
@pytest.mark.parametrize("shape", [(64, 700, 24), (17, 4096, 8), (5, 33, 3)])
def test_gemm_bitwise(name, data, shape):
    m, k, n = shape
    rng = np.random.default_rng(k)
    if data == "random":
        a = rng.standard_normal((m, k)).astype(np.float32)
        b = rng.standard_normal((k, n)).astype(np.float32)
    else:
        a, b = _wide(rng, (m, k)), _wide(rng, (k, n))
    j, t = both(name, a, b)
    assert t.dtype == np.float32 and t.shape == (m, n)
    np.testing.assert_array_equal(t, j)


@pytest.mark.parametrize("data", ["random", "wide"])
def test_gemv_face_bitwise(data):
    rng = np.random.default_rng(3)
    if data == "random":
        a = rng.standard_normal((64, 700)).astype(np.float32)
        x = rng.standard_normal(700).astype(np.float32)
    else:
        a, x = _wide(rng, (64, 700)), _wide(rng, 700)
    j, t = both("matmul_ozaki", a, x)
    assert t.shape == (64,)
    np.testing.assert_array_equal(t, j)


@pytest.mark.parametrize("block", [128, 256])
def test_k_chunking_is_bitwise(monkeypatch, block):
    """_I8_BLOCK read at call time: chunks of k fold to bitwise the
    unchunked result, and bitwise JAX's with the same chunk."""
    rng = np.random.default_rng(3)
    a = rng.standard_normal((16, 1000)).astype(np.float32)
    b = rng.standard_normal((1000, 8)).astype(np.float32)
    full = tg.matmul_ozaki(torch.from_numpy(a), torch.from_numpy(b))
    monkeypatch.setattr(tg, "_I8_BLOCK", block)
    monkeypatch.setattr(jg, "_I8_BLOCK", block)
    j, t = both("_matmul_ozaki_i8", a, b, n_slices=4)
    np.testing.assert_array_equal(t, j)
    np.testing.assert_array_equal(t, full.numpy())


@pytest.mark.parametrize("rows_per_chunk", [1, 5])
def test_row_chunking_is_bitwise(monkeypatch, rows_per_chunk):
    rng = np.random.default_rng(4)
    a, b = torch.from_numpy(_wide(rng, (23, 300))), torch.from_numpy(_wide(rng, (300, 6)))
    whole = tg.matmul_ozaki6(a, b)
    monkeypatch.setattr(tc, "ROW_CHUNK_BYTES", rows_per_chunk * 300 * 4)
    assert torch.equal(tg.matmul_ozaki6(a, b), whole)


def test_cancellation_stress_exact():
    rng = np.random.default_rng(11)
    m, k, n = 64, 1024, 16
    big = rng.uniform(1e6, 1e7, size=(m, k // 2)).astype(np.float32)
    small = rng.uniform(-1.0, 1.0, size=(m, k // 2)).astype(np.float32)
    a = np.empty((m, k), np.float32)
    a[:, 0::2], a[:, 1::2] = big + small, -big
    b = np.ones((k, n), np.float32)
    oracle = a.astype(np.float64) @ b.astype(np.float64)
    plain = np.cumsum(a, axis=1, dtype=np.float32)[:, -1:]  # b = 1: the rows' sums
    assert _max_rel(np.repeat(plain, n, 1), oracle) > 1.0
    for fn in (tg.matmul_ozaki, tg.matmul_ozaki6):
        assert _max_rel(fn(torch.from_numpy(a), torch.from_numpy(b)).numpy(), oracle) < 1e-7


def test_random_ozaki6_at_output_rounding_limit():
    rng = np.random.default_rng(1)
    a = rng.standard_normal((128, 2048)).astype(np.float32)
    b = rng.standard_normal((2048, 128)).astype(np.float32)
    oracle = a.astype(np.float64) @ b.astype(np.float64)
    y = tg.matmul_ozaki6(torch.from_numpy(a), torch.from_numpy(b)).double().numpy()
    u = np.abs(y - oracle) / np.spacing(np.abs(oracle).astype(np.float32)).astype(np.float64)
    assert float(np.percentile(u, 99)) <= 1.0
    assert float(u.max()) <= 64.0


def test_long_drift_beats_plain_fp32():
    """k = 2^17 crosses _I8_BLOCK; plain fp32 (products summed in order in
    fp32) drifts past the output's rounding, the tier does not."""
    rng = np.random.default_rng(8)
    m, k, n = 16, 1 << 17, 2
    a = rng.uniform(0.0, 10.0, (m, k)).astype(np.float32)
    b = rng.uniform(0.0, 10.0, (k, n)).astype(np.float32)
    oracle = a.astype(np.float64) @ b.astype(np.float64)
    plain = np.stack([np.cumsum(a * b[:, j][None, :], axis=1, dtype=np.float32)[:, -1]
                      for j in range(n)], 1)
    e_plain = float(np.max(np.abs(plain - oracle) / np.abs(oracle)))
    y = tg.matmul_ozaki(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    e_oz = float(np.max(np.abs(y.astype(np.float64) - oracle) / np.abs(oracle)))
    assert e_oz < 1e-7
    assert e_oz * 2 < e_plain


def test_gemv_face_vector_rhs():
    rng = np.random.default_rng(2)
    a = rng.standard_normal((64, 700)).astype(np.float32)
    x = rng.standard_normal(700).astype(np.float32)
    oracle = a.astype(np.float64) @ x.astype(np.float64)
    y = tg.matmul_ozaki(torch.from_numpy(a), torch.from_numpy(x)).numpy()
    assert y.shape == (64,) and y.dtype == np.float32
    assert float(np.abs(y - oracle).max()) / float(np.abs(oracle).max()) < 1e-7


def test_fp64_inputs_use_plain_fp64():
    rng = np.random.default_rng(4)
    a, b = rng.standard_normal((8, 64)), rng.standard_normal((64, 4))
    y = tg.matmul_ozaki(torch.from_numpy(a), torch.from_numpy(b))
    assert y.dtype == torch.float64
    # The plain fp64 product itself; numpy's sums in another order, so
    # against it rtol 1e-14 with an atol of 1e-14 of the output's scale.
    assert torch.equal(y, torch.matmul(torch.from_numpy(a), torch.from_numpy(b)))
    np.testing.assert_allclose(y.numpy(), a @ b, rtol=1e-14,
                               atol=1e-14 * np.abs(a @ b).max())


def test_empty_contraction():
    y = tg.matmul_ozaki(torch.zeros((4, 0)), torch.zeros((0, 3)))
    np.testing.assert_array_equal(y.numpy(), np.zeros((4, 3), np.float32))
    y = tg.matmul_ozaki(torch.zeros((4, 0)), torch.zeros((0,)))
    np.testing.assert_array_equal(y.numpy(), np.zeros(4, np.float32))


def test_exponent_extremes_no_nan():
    for mag in (3.4e38, 2.0 ** -120, np.finfo(np.float32).tiny):
        a = np.zeros((1, 256), np.float32)
        a[0, 0] = mag
        b = np.ones((256, 2), np.float32)
        y = tg.matmul_ozaki(torch.from_numpy(a), torch.from_numpy(b)).numpy()
        assert np.all(np.isfinite(y)), (mag, y)
        np.testing.assert_allclose(y, (a.astype(np.float64) @ b).astype(np.float32), rtol=1e-2)


def test_cross_chunk_cancellation_at_huge_exponents(monkeypatch):
    monkeypatch.setattr(tg, "_I8_BLOCK", 128)
    a = np.empty((1, 256), np.float32)
    a[0, :128], a[0, 128:] = 2.0 ** 113, -(2.0 ** 113)
    y = tg._matmul_ozaki_i8(torch.from_numpy(a), torch.ones((256, 2)), 4).numpy()
    np.testing.assert_array_equal(y, np.zeros((1, 2), np.float32))


@pytest.mark.parametrize("name", ["rowwise", "colwise", "blockwise"])
def test_distributed_gemm_matches_jax(devices, name):
    """Bitwise JAX's build on rowwise; within 1 fp32 ulp where the
    cross-shard sum's order may differ; within 1e-6 of fp64's scale."""
    rng = np.random.default_rng(5)
    a = rng.uniform(0.0, 10.0, (64, 256)).astype(np.float32)
    b = rng.uniform(0.0, 10.0, (256, 32)).astype(np.float32)
    yj = np.asarray(jax_build_gemm(name, mv_jax.make_mesh(8), kernel="ozaki")(
        jnp.asarray(a), jnp.asarray(b)))
    yt = build_gemm(name, make_mesh(8, devices=[CPU] * 8), kernel="ozaki")(
        torch.from_numpy(a), torch.from_numpy(b)).numpy()
    if name == "rowwise":
        np.testing.assert_array_equal(yt, yj)
    else:
        assert np.all(np.abs(yt.astype(np.float64) - yj) <= np.spacing(np.abs(yj)))
    oracle = a.astype(np.float64) @ b.astype(np.float64)
    assert float(np.abs(yt - oracle).max()) / float(np.abs(oracle).max()) < 1e-6
