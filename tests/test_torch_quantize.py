"""The port's quantized storage against the JAX package's.

The same seeded numpy operands go through the JAX package's quantizer
(``ops/quantize.py``) and kernels (the scan kernel ``matvec_quantized`` and
the Pallas tile ``matvec_quantized_pallas`` in interpret mode, as
tests/test_quantized.py runs them) and through the port's quantizer, its
scan tier and ``quant_gemv_cuda``, which, given CPU tensors, computes its
plain version. The CUDA kernel itself runs only on the card (chip_smoke.py
holds it against the plain version there).

Payloads and scales are compared BITWISE, for every format and input dtype:
the port's quantizer reproduces the JAX package's operation by operation.
The contractions are compared at the JAX package's own tolerance between
its two kernels (tests/test_quantized.py:279): rtol 1e-4, atol 1e-5; fp64
at rtol 1e-12.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from matvec_mpi_multiplier_tpu.ops import quantize as jq
from matvec_mpi_multiplier_tpu.ops.pallas_quant import matvec_quantized_pallas, quant_tiles
from matvec_mpi_multiplier_torch.ops import cuda_quant, get_storage_kernel
from matvec_mpi_multiplier_torch.ops import quantize as tq
from matvec_mpi_multiplier_torch.ops.cuda_quant import quant_gemv_cuda, quant_gemv_plain
from matvec_mpi_multiplier_torch.utils.convert import dtype_name, from_numpy
from matvec_mpi_multiplier_torch.utils.errors import ConfigError

NP_DTYPES = {"float32": np.float32, "float64": np.float64,
             "float16": np.float16, "bfloat16": ml_dtypes.bfloat16}
FORMATS = ["int8", "int8c", "fp8"]
M, K = 32, 768  # k = 16 blocks of 48, 6 of 128


def adversarial(dtype: str, seed: int = 0, m: int = M, k: int = K) -> np.ndarray:
    """Rows spread over e^±8, an all-zero block, a subnormal row, and a row
    of exact .5 ties (its blocks' max is 127, so the scale is 1)."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((m, k)) * np.exp(rng.uniform(-8, 8, (m, 1)))
    a[:, 96:192] = 0.0
    tiny = 1e-6 if dtype == "float16" else 1e-40
    a[3] = rng.standard_normal(k) * tiny
    a[4] = np.round(rng.uniform(-100, 100, k) * 2) / 2
    a[4, :8] = [0.5, 1.5, 2.5, 127.0, -0.5, -1.5, 63.5, 64.5]
    a[4, 8::32] = 127.0  # every block of row 4 holds its max
    return a.astype(NP_DTYPES[dtype])


def both(a_np: np.ndarray, fmt: str, **kwargs):
    return (jq.quantize_matrix(a_np, fmt, **kwargs),
            tq.quantize_matrix(from_numpy(a_np, "cpu"), fmt, **kwargs))


def as_bytes(leaf) -> np.ndarray:
    """A payload or scale plane as its raw bytes (fp8 has no torch numpy)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.contiguous().view(torch.uint8).numpy()
    return np.ascontiguousarray(np.asarray(leaf)).view(np.uint8)


# ---------------------------------------------------------- constants


def test_constants_and_names_are_the_jax_packages():
    assert tq.STORAGE_FORMATS == jq.STORAGE_FORMATS
    assert tq.NATIVE == jq.NATIVE and tq.DEFAULT_BLOCK == jq.DEFAULT_BLOCK
    assert (tq.INT8_EPS, tq.INT8C_EPS, tq.FP32_LEVEL_RELERR) == (
        jq.INT8_EPS, jq.INT8C_EPS, jq.FP32_LEVEL_RELERR)
    for fmt in (None, "native", *FORMATS):
        assert tq.normalize_storage(fmt) == jq.normalize_storage(fmt)
    for bad in ("int4", "auto", "speculate"):
        with pytest.raises(ConfigError) as port:
            tq.normalize_storage(bad)
        with pytest.raises(Exception) as ref:
            jq.normalize_storage(bad)
        assert str(port.value) == str(ref.value)
    assert tq.fp8_supported() and jq.fp8_supported()


def test_default_block_grid_is_the_jax_packages():
    for k in (1, 2, 8, 48, 60, 96, 100, 512, 768, 1024, 2048, 3008, 60000, 65536):
        for shards in (1, 2, 3, 4, 8):
            try:
                expect = jq.default_block(k, shards)
            except Exception as e:  # the JAX package's ConfigError
                with pytest.raises(ConfigError) as port:
                    tq.default_block(k, shards)
                assert str(port.value) == str(e)
            else:
                assert tq.default_block(k, shards) == expect, (k, shards)
    assert tq.default_block(60000) == 32 and tq.default_block(8, 8) == 1


def test_quantize_rejects_native_and_bad_operands():
    a = np.ones((4, 8), np.float32)
    cases = [((a, "native"), {}), ((a[0], "int8"), {}),
             ((a.astype(np.int32), "int8"), {}), ((a, "int8"), {"block": 3})]
    for args, kwargs in cases:
        with pytest.raises(ConfigError):
            tq.quantize_matrix(*args, **kwargs)
        with pytest.raises(Exception):
            jq.quantize_matrix(*args, **kwargs)
    with pytest.raises(ConfigError, match="must evenly divide"):
        tq.quantize_matrix(a, "int8", block=3)


# ---------------------------------------------------------- the quantizer


@pytest.mark.parametrize("layout", [
    {"contraction_shards": 1}, {"contraction_shards": 2},
    {"contraction_shards": 4}, {"contraction_shards": 8}, {"block": 48},
], ids=["s1", "s2", "s4", "s8", "b48"])
@pytest.mark.parametrize("dtype", list(NP_DTYPES))
@pytest.mark.parametrize("fmt", FORMATS)
def test_payload_and_scales_bitwise_equal_jax(fmt, dtype, layout):
    j, t = both(adversarial(dtype), fmt, **layout)
    assert (t.fmt, t.block, t.shape, t.ndim) == (j.fmt, j.block, tuple(j.shape), j.ndim)
    assert dtype_name(t.dtype) == str(j.dtype) == dtype
    assert t.nbytes == j.nbytes
    for port, ref in zip(t.leaves, (j.q, j.scales, j.q2, j.scales2)):
        assert (port is None) == (ref is None)
        if port is not None:
            assert np.array_equal(as_bytes(port), as_bytes(ref))
    deq = tq.dequantize(t)
    assert deq.dtype == t.dtype
    np.testing.assert_array_equal(
        deq.double().numpy(), np.asarray(jq.dequantize(j)).astype(np.float64))


@pytest.mark.parametrize("fmt", FORMATS)
def test_adversarial_dynamic_range_bitwise(fmt):
    """Blocks at 1e-18 .. 1e-11 (tests/test_quantized.py:139)."""
    rng = np.random.default_rng(3)
    a = np.concatenate([rng.standard_normal((4, 64)).astype(np.float32) * m
                        for m in 10.0 ** np.arange(-18, -10)], axis=1)
    j, t = both(a, fmt, block=64)
    for port, ref in zip(t.leaves, (j.q, j.scales, j.q2, j.scales2)):
        if port is not None:
            assert np.array_equal(as_bytes(port), as_bytes(ref))


def test_quantized_matrix_faces():
    a = adversarial("float32")
    t = tq.quantize_matrix(torch.from_numpy(a), "int8c", block=64)
    nb = K // 64
    assert t.nbytes == 2 * (M * K + M * nb * 4)
    assert t.nbytes / a.nbytes <= 0.55
    assert tq.quantize_matrix(torch.from_numpy(a), "int8", block=64).nbytes / a.nbytes <= 0.30
    assert t.dtype == torch.float32 and t.shape == (M, K) and t.device == torch.device("cpu")
    moved = t.to("cpu")
    assert moved.fmt == "int8c" and moved.block == 64 and moved.q2 is not None
    assert all(torch.equal(x, y) for x, y in zip(moved.leaves, t.leaves))
    halves = t.map(lambda leaf: leaf[: M // 2])
    assert halves.shape == (M // 2, K) and halves.scales2.shape == (M // 2, nb)


# ------------------------------------------------- round-trip bounds


def _port(a: np.ndarray, fmt: str, **kwargs):
    qa = tq.quantize_matrix(torch.from_numpy(a), fmt, **kwargs)
    return qa, tq.dequantize(qa).double().numpy()


@pytest.mark.parametrize("fmt", ["int8", "int8c"])
def test_roundtrip_bound_per_element(fmt):
    a = np.random.default_rng(1).standard_normal((M, 512)).astype(np.float32)
    qa, deq = _port(a, fmt, block=64)
    err = np.abs(a.astype(np.float64) - deq)
    last = (qa.scales if fmt == "int8" else qa.scales2).double().numpy()
    bound = np.repeat(last / 2, 64, axis=1) * (1 + 1e-6) + np.finfo(np.float32).eps * np.abs(a)
    assert np.all(err <= bound + 1e-30)
    eps = tq.INT8_EPS if fmt == "int8" else tq.INT8C_EPS
    amax = np.abs(a).max()
    assert err.max() <= eps * amax * (1 + 1e-6) + np.finfo(np.float32).eps * amax


def test_per_block_scales_are_amax_over_127():
    a = np.random.default_rng(2).standard_normal((M, 512)).astype(np.float32)
    qa, _ = _port(a, "int8", block=64)
    expect = (np.abs(a.reshape(M, 8, 64)).max(axis=2) / 127.0).astype(np.float32)
    np.testing.assert_array_equal(qa.scales.numpy(), expect)
    assert qa.scales.dtype == torch.float32


@pytest.mark.parametrize("fmt", ["int8", "int8c"])
def test_zero_blocks_roundtrip_exactly(fmt):
    a = np.random.default_rng(4).standard_normal((M, 512)).astype(np.float32)
    a[:, 64:128] = 0.0
    a[5, :] = 0.0
    qa, deq = _port(a, fmt, block=64)
    assert qa.scales[5].max() == 0.0 and np.all(np.isfinite(deq))
    np.testing.assert_array_equal(deq[:, 64:128], 0.0)
    np.testing.assert_array_equal(deq[5], 0.0)


def test_subnormal_blocks_stay_finite():
    a = (np.random.default_rng(5).standard_normal((8, 128)) * np.float32(1e-40)).astype(np.float32)
    qa, deq = _port(a, "int8", block=64)
    assert torch.isfinite(qa.scales).all() and qa.scales.max() > 0
    err = np.abs(a.astype(np.float64) - deq)
    assert np.all(np.isfinite(deq))
    assert err.max() <= np.abs(a).max() * tq.INT8_EPS * (1 + 1e-6) + 1e-45


def test_fp8_roundtrip_keeps_elementwise_relative_precision():
    a = np.random.default_rng(6).standard_normal((M, 512)).astype(np.float32)
    qa, deq = _port(a, "fp8", block=64)
    err = np.abs(a.astype(np.float64) - deq)
    scales = np.repeat(qa.scales.double().numpy(), 64, axis=1)
    assert np.all(err <= np.maximum(np.abs(a) * 2.0 ** -4, scales * 2.0 ** -10) * (1 + 1e-6))


# ---------------------------------------------- the kernel's plain version


def _jax_and_port(fmt, dtype, seed, m, k, block, n=None):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((m, k)).astype(NP_DTYPES[dtype])
    x = rng.standard_normal((k,) if n is None else (k, n)).astype(NP_DTYPES[dtype])
    j, t = both(a, fmt, block=block)
    return j, t, x, from_numpy(x, "cpu")


def _tol(dtype):
    return dict(rtol=1e-12, atol=0) if dtype == "float64" else dict(rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("fmt", FORMATS)
def test_kernel_matches_jax_pallas_tile(fmt):
    """The Pallas tile in interpret mode, 64x1024 in blocks of 128."""
    j, t, x, xt = _jax_and_port(fmt, "float32", 10, 64, 1024, 128)
    assert quant_tiles(64, 1024, 128) is not None
    ref = np.asarray(matvec_quantized_pallas(j, jnp.asarray(x)))
    for fn in (quant_gemv_cuda, tq.matvec_quantized):
        y = fn(t, xt)
        assert y.dtype == torch.float32 and tuple(y.shape) == (64,)
        np.testing.assert_allclose(y.numpy(), ref, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("n", [None, 5], ids=["rank1", "rank2"])
@pytest.mark.parametrize("dtype", ["float32", "float64", "bfloat16", "float16"])
@pytest.mark.parametrize("fmt", FORMATS)
def test_kernel_and_scan_tier_match_jax_scan(fmt, dtype, n):
    j, t, x, xt = _jax_and_port(fmt, dtype, 11, 48, 384, 48, n)
    ref = np.asarray(jq.matvec_quantized(j, jnp.asarray(x))).astype(np.float64)
    acc = torch.float64 if dtype == "float64" else torch.float32
    for fn in (quant_gemv_cuda, quant_gemv_plain, tq.matvec_quantized):
        y = fn(t, xt)
        assert y.dtype == acc and tuple(y.shape) == ref.shape
        np.testing.assert_allclose(y.double().numpy(), ref, **_tol(dtype))


@pytest.mark.parametrize("fmt", FORMATS)
def test_pad_columns_never_change_a_real_column(fmt):
    """Within one width, the real columns are bitwise the same whether the
    pad columns hold zeros or random values (the engine's bucket
    doctrine), and equal to the unpadded product."""
    j, t, x, xt = _jax_and_port(fmt, "float32", 12, 40, 256, 64, 3)
    rng = np.random.default_rng(13)
    for fn in (quant_gemv_cuda, tq.matvec_quantized):
        outs = []
        for pad in (np.zeros((256, 5)), rng.standard_normal((256, 5))):
            block = torch.cat([xt, torch.from_numpy(pad.astype(np.float32))], dim=1)
            outs.append(fn(t, block)[:, :3])
        assert torch.equal(outs[0], outs[1])
        np.testing.assert_allclose(outs[0].numpy(), fn(t, xt).numpy(), rtol=1e-6, atol=1e-6)


def test_plain_version_is_row_chunked(monkeypatch):
    _, t, _, xt = _jax_and_port("int8c", "float32", 14, 64, 256, 64, 4)
    whole = quant_gemv_plain(t, xt)
    monkeypatch.setattr(cuda_quant, "PLAIN_CHUNK_BYTES", 7 * 256 * 4)
    seen = []
    real = cuda_quant._dequantized_rows
    monkeypatch.setattr(cuda_quant, "_dequantized_rows",
                        lambda qa, rows, acc: seen.append(rows) or real(qa, rows, acc))
    np.testing.assert_allclose(quant_gemv_plain(t, xt).numpy(), whole.numpy(), rtol=1e-6)
    assert len(seen) == 10 and all(s.stop - s.start <= 7 for s in seen)


def test_storage_kernel_registry():
    assert get_storage_kernel("cuda") is quant_gemv_cuda
    assert get_storage_kernel("torch") is get_storage_kernel("torch_colwise") is tq.matvec_quantized
    assert get_storage_kernel(quant_gemv_plain) is quant_gemv_plain
    with pytest.raises(KeyError, match="unknown quantized-storage kernel"):
        get_storage_kernel("pallas")


def test_cpu_call_launches_nothing_and_wrapper_checks():
    _, t, _, xt = _jax_and_port("int8", "float32", 15, 8, 64, 16)
    before = quant_gemv_cuda.launches
    quant_gemv_cuda(t, xt)
    assert quant_gemv_cuda.launches == before
    with pytest.raises(ValueError, match="shape"):
        quant_gemv_cuda(t, torch.ones(63))
    with pytest.raises(ValueError, match="logical dtype"):
        quant_gemv_cuda(t, xt.double())
    with pytest.raises(ValueError, match="contiguous"):
        quant_gemv_cuda(t, torch.ones(2, 64).t())
    with pytest.raises(ValueError, match="QuantizedMatrix"):
        quant_gemv_cuda(torch.ones(8, 64), xt)
    with pytest.raises(ValueError, match="scales"):
        quant_gemv_cuda(t.map(lambda leaf: leaf if leaf.dtype != torch.float32
                              else leaf[:, :2].contiguous()), xt)
