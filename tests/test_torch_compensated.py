"""The port's compensated (double-float) tier against the JAX package's.

The same numpy operands go through the JAX package's ``ops/compensated.py``
and through the port's ``ops/compensated.py``. Bars:

* the error-free transformations, the tree reduction, ``ldexp`` and the
  tier itself on normal-range data: **bitwise** equal to JAX's (eager torch
  rounds each op once in IEEE order, as XLA does on the CPU here);
* row chunking: bitwise the unchunked result;
* the JAX tests' own contracts, each with its own bar (stated per test):
  the long contraction within 2 fp32 ulps of fp64 and 10x closer than the
  plain fp32 product, the cancellation case exact, fp64 inputs within
  rtol 1e-15, huge magnitudes within rtol 1e-6 and no NaN, the empty
  contraction zeros.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matvec_mpi_multiplier_tpu.ops import compensated as jc
from matvec_mpi_multiplier_tpu.utils.compat import ldexp as jax_ldexp
from matvec_mpi_multiplier_torch.ops import compensated as tc
from matvec_mpi_multiplier_torch.ops.gemv import available_kernels

DTYPES = {"float32": (np.float32, torch.float32), "float64": (np.float64, torch.float64)}


def _ulps(y, truth):
    """Error in units of fp32 ulp of the true value."""
    t32 = truth.astype(np.float32)
    return np.abs(y.astype(np.float64) - truth) / np.spacing(np.abs(t32))


def _wide(rng, shape, dtype):
    """Normal-range values with magnitudes spread over 10^4, both signs."""
    mag = 10.0 ** rng.uniform(-2, 2, shape)
    return (rng.standard_normal(shape) * mag).astype(dtype)


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _assert_bitwise(jax_out, port_out):
    if isinstance(jax_out, tuple):
        for j, t in zip(jax_out, port_out):
            _assert_bitwise(j, t)
        return
    j, t = np.asarray(jax_out), _np(port_out)
    assert j.dtype == t.dtype and j.shape == t.shape
    np.testing.assert_array_equal(t, j)


# ------------------------------------------------------------ pure functions


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", ["two_sum", "fast_two_sum", "two_prod"])
def test_binary_eft_bitwise(name, dtype):
    np_dt, _ = DTYPES[dtype]
    rng = np.random.default_rng(1)
    a, b = _wide(rng, 4096, np_dt), _wide(rng, 4096, np_dt)
    if name == "fast_two_sum":  # its precondition: |a| >= |b|
        a, b = np.where(np.abs(a) >= np.abs(b), a, b), np.where(np.abs(a) >= np.abs(b), b, a)
    _assert_bitwise(getattr(jc, name)(jnp.asarray(a), jnp.asarray(b)),
                    getattr(tc, name)(torch.from_numpy(a), torch.from_numpy(b)))


@pytest.mark.parametrize("dtype", DTYPES)
def test_split_bitwise_and_exact(dtype):
    np_dt, _ = DTYPES[dtype]
    a = _wide(np.random.default_rng(2), 4096, np_dt)
    hi, lo = tc.split(torch.from_numpy(a))
    _assert_bitwise(jc.split(jnp.asarray(a)), (hi, lo))
    np.testing.assert_array_equal(hi.numpy() + lo.numpy(), a)


@pytest.mark.parametrize("dtype", DTYPES)
def test_df_add_bitwise(dtype):
    np_dt, _ = DTYPES[dtype]
    rng = np.random.default_rng(3)
    ops = [_wide(rng, 2048, np_dt) for _ in range(4)]
    ops[1] *= np_dt(2.0 ** -30)  # lo parts well under their hi parts
    ops[3] *= np_dt(2.0 ** -30)
    _assert_bitwise(jc.df_add(*map(jnp.asarray, ops)),
                    tc.df_add(*map(torch.from_numpy, ops)))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("k", [1, 2, 7, 64, 1001])
def test_tree_reduction_bitwise(k, dtype):
    """Odd lengths pad with exact zeros at every level, as JAX does."""
    np_dt, _ = DTYPES[dtype]
    rng = np.random.default_rng(k)
    hi = _wide(rng, (5, k), np_dt)
    lo = hi * np_dt(2.0 ** -30)
    _assert_bitwise(jc._df_reduce_lastaxis(jnp.asarray(hi), jnp.asarray(lo)),
                    tc._df_reduce_lastaxis(torch.from_numpy(hi), torch.from_numpy(lo)))


@pytest.mark.parametrize("dtype", DTYPES)
def test_ldexp_bitwise_across_the_clamp(dtype):
    """Exponents inside the normal range and beyond its clamp at both ends,
    where the result is a normal number: bitwise JAX's two-step ldexp, and
    the exact product."""
    np_dt, t_dt = DTYPES[dtype]
    emax = 127 if dtype == "float32" else 1023
    rng = np.random.default_rng(4)
    n = 256
    # (x's exponents, e): inside; below the clamp (e <= -emax) on large x;
    # above it (e > emax) on small x. Every result lies in 2^[-110, 110].
    groups = [(rng.integers(-20, 21, n), rng.integers(-90, 91, n)),
              (rng.integers(emax - 87, emax - 66, n), rng.integers(-emax - 23, -emax + 1, n)),
              (rng.integers(-emax + 66, -emax + 87, n), rng.integers(emax + 1, emax + 24, n))]
    ex = np.concatenate([g[0] for g in groups])
    e = np.concatenate([g[1] for g in groups]).astype(np.int32)
    x = np.ldexp(rng.uniform(0.5, 1.0, ex.size), ex).astype(np_dt)
    mine = tc.ldexp(torch.from_numpy(x), torch.from_numpy(e))
    assert mine.dtype == t_dt
    np.testing.assert_array_equal(mine.numpy(), np.asarray(jax_ldexp(jnp.asarray(x),
                                                                     jnp.asarray(e))))
    np.testing.assert_array_equal(mine.numpy(), np.ldexp(x, e))


def test_pow2_is_exact():
    e = torch.arange(-126, 128, dtype=torch.int32)
    np.testing.assert_array_equal(tc.pow2(e, torch.float32).numpy(),
                                  np.ldexp(np.float32(1), e.numpy()))
    e = torch.arange(-1022, 1024, dtype=torch.int64)
    np.testing.assert_array_equal(tc.pow2(e, torch.float64).numpy(),
                                  np.ldexp(1.0, e.numpy()))


# --------------------------------------------------------------- the tier


def test_registered():
    assert "compensated" in available_kernels()


@pytest.mark.parametrize("shape", [(64, 1000), (33, 4097), (3, 1)])
@pytest.mark.parametrize("data", ["random", "wide"])
def test_gemv_compensated_bitwise(shape, data):
    """fp32, random standard normal and wide-range magnitudes: bitwise JAX."""
    rng = np.random.default_rng(sum(shape))
    if data == "random":
        a = rng.standard_normal(shape).astype(np.float32)
        x = rng.standard_normal(shape[1]).astype(np.float32)
    else:
        a, x = _wide(rng, shape, np.float32), _wide(rng, shape[1], np.float32)
    _assert_bitwise(jc.gemv_compensated(jnp.asarray(a), jnp.asarray(x)),
                    tc.gemv_compensated(torch.from_numpy(a), torch.from_numpy(x)))


def test_gemv_compensated_fp64_bitwise():
    rng = np.random.default_rng(5)
    a, x = _wide(rng, (16, 300), np.float64), _wide(rng, 300, np.float64)
    _assert_bitwise(jc.gemv_compensated(jnp.asarray(a), jnp.asarray(x)),
                    tc.gemv_compensated(torch.from_numpy(a), torch.from_numpy(x)))


@pytest.mark.parametrize("rows_per_chunk", [1, 3, 7])
def test_row_chunking_is_bitwise(monkeypatch, rows_per_chunk):
    rng = np.random.default_rng(6)
    a = torch.from_numpy(_wide(rng, (29, 515), np.float32))
    x = torch.from_numpy(_wide(rng, 515, np.float32))
    whole = tc.gemv_compensated(a, x)
    monkeypatch.setattr(tc, "ROW_CHUNK_BYTES", rows_per_chunk * 515 * 4)
    assert len(tc.row_chunks(29, 515 * 4)) == -(-29 // rows_per_chunk)
    assert torch.equal(tc.gemv_compensated(a, x), whole)


def test_bf16_inputs_upcast_exactly():
    rng = np.random.default_rng(7)
    a = torch.from_numpy(rng.standard_normal((8, 256)).astype(np.float32)).bfloat16()
    x = torch.from_numpy(rng.standard_normal(256).astype(np.float32)).bfloat16()
    y = tc.gemv_compensated(a, x)
    assert y.dtype == torch.float32
    assert torch.equal(y, tc.gemv_compensated(a.float(), x.float()))


# -------------------------------------------- the JAX tests' contracts


def test_two_sum_and_two_prod_exact():
    """tests/test_compensated.py's EFT checks, on the port: exact."""
    s, e = tc.two_sum(torch.tensor(1e8, dtype=torch.float32), torch.tensor(1.0))
    assert float(s) + float(e) == 100000001.0
    rng = np.random.default_rng(0)
    a = rng.uniform(-10, 10, 1024).astype(np.float32)
    b = rng.uniform(-10, 10, 1024).astype(np.float32)
    p, err = tc.two_prod(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_array_equal(p.numpy().astype(np.float64) + err.numpy(),
                                  a.astype(np.float64) * b.astype(np.float64))


def plain_fp32(a: np.ndarray, x: np.ndarray) -> np.ndarray:
    """The plain fp32 accumulation the accuracy tiers are held against: each
    product rounded to fp32, then summed in order in fp32 (the reference's
    ``multiply_std_rowwise`` loop with ``float``). PyTorch's CPU reductions
    sum in blocks, or accumulate fp32 in fp64, and would hide the drift."""
    return np.cumsum(a * x[None, :], axis=1, dtype=np.float32)[:, -1]


def test_long_contraction_beats_plain_fp32():
    """Bar: within 2 fp32 ulps of fp64, and 10x closer than plain fp32."""
    rng = np.random.default_rng(1)
    m, k = 8, 1 << 16
    a64, x64 = rng.uniform(0.0, 10.0, (m, k)), rng.uniform(0.0, 10.0, k)
    truth = a64 @ x64
    a32, x32 = a64.astype(np.float32), x64.astype(np.float32)
    comp = tc.gemv_compensated(torch.from_numpy(a32), torch.from_numpy(x32)).numpy()
    assert _ulps(comp, truth).max() <= 2.0
    assert _ulps(comp, truth).max() * 10 < _ulps(plain_fp32(a32, x32), truth).max()


def test_catastrophic_cancellation_exact():
    """Rows of (3e7, 1, -3e7) triples: the count of small terms, exactly."""
    m, triples = 4, 256
    a = np.zeros((m, 3 * triples), np.float32)
    a[:, 0::3], a[:, 1::3], a[:, 2::3] = 3e7, 1.0, -3e7
    y = tc.gemv_compensated(torch.from_numpy(a), torch.ones(3 * triples))
    np.testing.assert_array_equal(y.numpy(), np.full(m, float(triples), np.float32))


def test_fp64_inputs_run_quad():
    """Bar: rtol 1e-15 against the fp64 product."""
    rng = np.random.default_rng(3)
    a, x = rng.uniform(0.0, 10.0, (8, 128)), rng.uniform(0.0, 10.0, 128)
    y = tc.gemv_compensated(torch.from_numpy(a), torch.from_numpy(x))
    assert y.dtype == torch.float64
    np.testing.assert_allclose(y.numpy(), a @ x, rtol=1e-15)


def test_huge_magnitudes_degrade_not_nan():
    """|a| beyond the split's overflow threshold: plain-product accuracy
    (rtol 1e-6), never NaN."""
    y = tc.gemv_compensated(torch.tensor([[1e35, 2.0]]), torch.tensor([1e-30, 3.0]))
    np.testing.assert_allclose(y.numpy(), [1e5 + 6.0], rtol=1e-6)


def test_empty_contraction():
    y = tc.gemv_compensated(torch.zeros((4, 0)), torch.zeros((0,)))
    np.testing.assert_array_equal(y.numpy(), np.zeros(4, np.float32))
