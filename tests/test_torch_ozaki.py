"""The port's ozaki GEMV tiers against the JAX package's, and every accuracy
tier through the registries, the strategies, the engine and the sweep.

The same numpy operands go through the JAX package and through the port.
Bars, each stated where it is used:

* ``_split_blocked`` (slices and shift) and ``gemv_ozaki``/``gemv_ozaki6``
  on normal-range fp32 data: **bitwise** JAX's (fp32 slices on the CPU, as
  JAX off the TPU; every block product exact, so any order agrees);
* row chunking: bitwise the unchunked result;
* the JAX tests' contracts on the port: the cancellation stress case at
  0 ulps from fp64 (the oracle is exact in fp32 there), the long
  contraction within 2 ulps and 10x closer than plain fp32, bf16 inputs
  within 2 ulps, fp64 inputs rtol 1e-15, the short padded block within
  1 ulp, exponent extremes finite and within rtol 1e-6 of the fp64 oracle
  (held to fp64, not bitwise to JAX: XLA on the CPU flushes subnormals,
  PyTorch does not);
* the strategies with each tier against the same JAX build: bitwise on
  rowwise (each shard's rows are its kernel's output), within 1 fp32 ulp
  on colwise and blockwise (the cross-shard sum's order may differ).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import matvec_mpi_multiplier_tpu as mv_jax
import matvec_mpi_multiplier_torch as mv_torch
from matvec_mpi_multiplier_tpu.ops import ozaki as jo
from matvec_mpi_multiplier_tpu.parallel.mesh import make_1d_mesh as jax_1d_mesh
from matvec_mpi_multiplier_torch.engine import MatvecEngine
from matvec_mpi_multiplier_torch.ops import compensated as tc
from matvec_mpi_multiplier_torch.ops import ozaki as to
from matvec_mpi_multiplier_torch.ops.gemm_kernels import (
    available_gemm_kernels,
    gemm_kernel_name_for,
    get_gemm_kernel,
)
from matvec_mpi_multiplier_torch.ops.gemv import available_kernels, get_kernel
from matvec_mpi_multiplier_torch.parallel.mesh import make_1d_mesh, make_mesh
from matvec_mpi_multiplier_torch.tuning import search

CPU = torch.device("cpu")
ACCURACY_TIERS = ("compensated", "ozaki", "ozaki6", "ozaki_i8")
ACCURACY_GEMM_TIERS = ("ozaki", "ozaki6")


def _ulps(y, truth):
    t32 = truth.astype(np.float32)
    return np.abs(y.astype(np.float64) - truth) / np.spacing(np.abs(t32))


def _wide(rng, shape):
    return (rng.standard_normal(shape) * 10.0 ** rng.uniform(-2, 2, shape)).astype(np.float32)


def plain_fp32(a, x):
    """Each product rounded to fp32, summed in order in fp32: the plain
    accumulation (tests/test_torch_compensated.py)."""
    return np.cumsum(a * x[None, :], axis=1, dtype=np.float32)[:, -1]


def stress(m, k, seed=11):
    """scripts/compensated_study.py's cancellation case: interleaved
    (big + small, -big) pairs, big in [1e6, 1e7), small in [-1, 1)."""
    rng = np.random.default_rng(seed)
    big = rng.uniform(1e6, 1e7, size=(m, k // 2)).astype(np.float32)
    small = rng.uniform(-1.0, 1.0, size=(m, k // 2)).astype(np.float32)
    a = np.empty((m, k), np.float32)
    a[:, 0::2] = big + small
    a[:, 1::2] = -big
    return a


# ------------------------------------------------------------- the slicing


@pytest.mark.parametrize("n_slices", [4, 6])
@pytest.mark.parametrize("scale", [1.0, 1e30, 2.0 ** -100])
def test_split_blocked_bitwise(n_slices, scale):
    """Slices and shift bitwise JAX's (JAX's bf16 slices read as fp32), at
    ordinary magnitudes and outside the exponent window at both ends."""
    rng = np.random.default_rng(0)
    v = (_wide(rng, (3, 2, to._BLOCK)) * np.float32(scale)).astype(np.float32)
    js, jshift = jo._split_blocked(jnp.asarray(v), n_slices)
    ts, tshift = to._split_blocked(torch.from_numpy(v), n_slices)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js.astype(jnp.float32)))
    np.testing.assert_array_equal(tshift.numpy(), np.asarray(jshift))
    assert bool(np.any(np.asarray(jshift))) == (scale != 1.0)


def test_split_is_exact_and_bf16_representable():
    rng = np.random.default_rng(0)
    mag = rng.uniform(1e6, 1e7, (4, 2, to._BLOCK))
    v = torch.from_numpy((mag * rng.choice([-1.0, 1.0], mag.shape)).astype(np.float32))
    slices, shift = to._split_blocked(v, 4)
    assert not shift.any()
    assert torch.equal(slices.bfloat16().float(), slices)
    np.testing.assert_array_equal(slices.double().sum(0).numpy(), v.double().numpy())


def test_split_wide_range_residual_within_envelope():
    v = np.random.default_rng(7).uniform(-1e7, 1e7, (4, 2, to._BLOCK)).astype(np.float32)
    slices, _ = to._split_blocked(torch.from_numpy(v), 4)
    _, exp = np.frexp(np.abs(v).max(axis=-1, keepdims=True))
    bound = np.ldexp(1.0, exp - 8 * 4)
    assert np.all(np.abs(slices.double().sum(0).numpy() - v.astype(np.float64)) <= bound)


def test_split_zero_block():
    slices, _ = to._split_blocked(torch.zeros((1, 1, to._BLOCK)), 4)
    assert not slices.any() and torch.isfinite(slices).all()


# ---------------------------------------------------------------- the tier


@pytest.mark.parametrize("fn", ["gemv_ozaki", "gemv_ozaki6"])
@pytest.mark.parametrize("shape", [(64, 4196), (33, 4097), (5, 7)])
@pytest.mark.parametrize("data", ["random", "wide"])
def test_gemv_ozaki_bitwise(fn, shape, data):
    rng = np.random.default_rng(shape[1])
    if data == "random":
        a = rng.standard_normal(shape).astype(np.float32)
        x = rng.standard_normal(shape[1]).astype(np.float32)
    else:
        a, x = _wide(rng, shape), _wide(rng, shape[1])
    y = getattr(to, fn)(torch.from_numpy(a), torch.from_numpy(x))
    assert y.dtype == torch.float32
    np.testing.assert_array_equal(
        y.numpy(), np.asarray(getattr(jo, fn)(jnp.asarray(a), jnp.asarray(x))))


@pytest.mark.parametrize("fn", ["gemv_ozaki", "gemv_ozaki6"])
@pytest.mark.parametrize("rows_per_chunk", [1, 4])
def test_row_chunking_is_bitwise(monkeypatch, fn, rows_per_chunk):
    rng = np.random.default_rng(3)
    a, x = torch.from_numpy(_wide(rng, (13, 600))), torch.from_numpy(_wide(rng, 600))
    whole = getattr(to, fn)(a, x)
    monkeypatch.setattr(tc, "ROW_CHUNK_BYTES", rows_per_chunk * 600 * 4)
    assert torch.equal(getattr(to, fn)(a, x), whole)


def test_cancellation_stress_zero_ulps():
    """Plain fp32 loses every bit; both tiers land on the fp64 oracle,
    which is exact in fp32 here: 0 ulps."""
    a = stress(64, 2048)
    x = np.ones(2048, np.float32)
    oracle = a.astype(np.float64) @ x.astype(np.float64)
    assert np.array_equal(oracle.astype(np.float32).astype(np.float64), oracle)
    assert _ulps(plain_fp32(a, x), oracle).max() > 1e6
    for fn in (to.gemv_ozaki, to.gemv_ozaki6):
        y = fn(torch.from_numpy(a), torch.from_numpy(x)).numpy()
        np.testing.assert_array_equal(y.astype(np.float64), oracle)


def test_random_within_two_ulps():
    """k not a multiple of the block: the padding, within 2 ulps of fp64."""
    rng = np.random.default_rng(1)
    a = rng.standard_normal((64, 4196)).astype(np.float32)
    x = rng.standard_normal(4196).astype(np.float32)
    oracle = a.astype(np.float64) @ x.astype(np.float64)
    for fn in (to.gemv_ozaki, to.gemv_ozaki6):
        assert _ulps(fn(torch.from_numpy(a), torch.from_numpy(x)).numpy(), oracle).max() <= 2.0


def test_long_contraction_beats_plain_fp32():
    rng = np.random.default_rng(2)
    a = rng.uniform(0.0, 10.0, (8, 1 << 15)).astype(np.float32)
    x = rng.uniform(0.0, 10.0, 1 << 15).astype(np.float32)
    truth = a.astype(np.float64) @ x.astype(np.float64)
    oz = to.gemv_ozaki(torch.from_numpy(a), torch.from_numpy(x)).numpy()
    assert _ulps(oz, truth).max() <= 2.0
    assert _ulps(oz, truth).max() * 10 < _ulps(plain_fp32(a, x), truth).max()


def test_bf16_inputs_upcast_exactly():
    rng = np.random.default_rng(4)
    a = torch.from_numpy(rng.standard_normal((16, 512)).astype(np.float32)).bfloat16()
    x = torch.from_numpy(rng.standard_normal(512).astype(np.float32)).bfloat16()
    oracle = a.double().numpy() @ x.double().numpy()
    y = to.gemv_ozaki(a, x)
    assert y.dtype == torch.float32
    assert _ulps(y.numpy(), oracle).max() <= 2.0


def test_fp64_inputs_use_plain_fp64_dot():
    rng = np.random.default_rng(5)
    a, x = rng.uniform(0.0, 10.0, (8, 128)), rng.uniform(0.0, 10.0, 128)
    y = to.gemv_ozaki(torch.from_numpy(a), torch.from_numpy(x))
    assert y.dtype == torch.float64
    np.testing.assert_allclose(y.numpy(), a @ x, rtol=1e-15)


def test_empty_and_short_contraction():
    y = to.gemv_ozaki(torch.zeros((4, 0)), torch.zeros((0,)))
    np.testing.assert_array_equal(y.numpy(), np.zeros(4, np.float32))
    rng = np.random.default_rng(6)
    a = rng.standard_normal((4, 7)).astype(np.float32)
    x = rng.standard_normal(7).astype(np.float32)
    oracle = a.astype(np.float64) @ x.astype(np.float64)
    assert _ulps(to.gemv_ozaki(torch.from_numpy(a), torch.from_numpy(x)).numpy(),
                 oracle).max() <= 1.0


@pytest.mark.parametrize("fn", ["gemv_ozaki", "gemv_ozaki6"])
def test_exponent_extremes_no_nan(fn):
    """Finite, and within rtol 1e-6 of the fp64 oracle, across the fp32
    exponent range (min normal included; the port keeps subnormals)."""
    kernel = getattr(to, fn)
    for mag in (3.4e38, 2.0 ** -120, np.finfo(np.float32).tiny):
        a = np.zeros((1, to._BLOCK), np.float32)
        a[0, 0] = mag
        x = np.ones(to._BLOCK, np.float32)
        y = kernel(torch.from_numpy(a), torch.from_numpy(x)).numpy()
        assert np.all(np.isfinite(y)), (mag, y)
        np.testing.assert_allclose(y, (a.astype(np.float64) @ x).astype(np.float32), rtol=1e-6)
    a = np.full((2, to._BLOCK), 1e30, np.float32)
    x = np.full(to._BLOCK, 1e-30, np.float32)
    y = kernel(torch.from_numpy(a), torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(y, a.astype(np.float64) @ x.astype(np.float64), rtol=1e-6)


def test_gather_output_rejects_unknown_string():
    with pytest.raises(ValueError, match="ring"):
        mv_torch.get_strategy("rowwise").build(make_mesh(2, devices=[CPU] * 2),
                                               kernel="ozaki", gather_output="rings")


# ----------------------------------------------------------- the registries


def test_registries_hold_every_accuracy_tier():
    for name in ACCURACY_TIERS:
        assert name in available_kernels()
        get_kernel(name)
    for name in ACCURACY_GEMM_TIERS:
        assert name in available_gemm_kernels()
        assert gemm_kernel_name_for(name) == name


def test_gemv_tiers_without_a_gemm_face_promote_to_torch():
    """The JAX package sends them to "xla"; the port to its library tier."""
    from matvec_mpi_multiplier_tpu.ops.gemm_kernels import (
        gemm_kernel_name_for as jax_name_for,
    )

    for name in ("compensated", "ozaki_i8"):
        assert jax_name_for(name) == "xla"
        assert gemm_kernel_name_for(name) == "torch"
    assert gemm_kernel_name_for("torch_colwise") == "torch"
    assert gemm_kernel_name_for("no_such_tier") == "no_such_tier"
    with pytest.raises(KeyError, match="no_such_tier"):
        get_gemm_kernel(gemm_kernel_name_for("no_such_tier"))


def test_tuner_races_no_accuracy_tier(monkeypatch):
    """The accuracy tiers trade speed for precision: no race offers them,
    on the CPU or (faked) on a card."""
    cuda = torch.device("cuda", 0)
    tiers = set(ACCURACY_TIERS)
    for device in (CPU, cuda):
        if device.type == "cuda":
            monkeypatch.setattr(search, "_cuda_offered", lambda device: True)
        gemv = search.gemv_candidates(600, 60000, "float32", device, sms=132)
        gemm = search.gemm_candidates(4096, 4096, 32, "float32", device)
        assert not tiers & {c["kernel"] for c in gemv + gemm}
        assert {c["kernel"] for c in gemv + gemm} <= {"cuda", "torch"}


# ------------------------------------------------- strategies, engine, sweep


def _meshes(name):
    """(JAX mesh, port mesh) pairs: p = 8 flat (rowwise, colwise) and 2x4."""
    out = [(mv_jax.make_mesh(8), make_mesh(8, devices=[CPU] * 8))]
    if name != "blockwise":
        out.append((jax_1d_mesh(8), make_1d_mesh(8, devices=[CPU] * 8)))
    return out


@pytest.mark.parametrize("tier", ACCURACY_TIERS)
@pytest.mark.parametrize("name", ["rowwise", "colwise", "blockwise"])
def test_strategies_with_each_tier_match_jax(devices, name, tier):
    rng = np.random.default_rng(3)
    a = rng.uniform(0.0, 10.0, (64, 512)).astype(np.float32)
    x = rng.uniform(0.0, 10.0, 512).astype(np.float32)
    oracle = a.astype(np.float64) @ x.astype(np.float64)
    for jmesh, tmesh in _meshes(name):
        yj = np.asarray(mv_jax.get_strategy(name).build(jmesh, kernel=tier)(
            jnp.asarray(a), jnp.asarray(x)))
        yt = mv_torch.get_strategy(name).build(tmesh, kernel=tier)(
            torch.from_numpy(a), torch.from_numpy(x)).numpy()
        assert yt.dtype == np.float32
        if name == "rowwise":
            np.testing.assert_array_equal(yt, yj)
        else:
            assert np.all(np.abs(yt.astype(np.float64) - yj) <= np.spacing(np.abs(yj)))
        assert _ulps(yt, oracle).max() <= 4.0


@pytest.mark.parametrize("tier", ["ozaki", "compensated"])
def test_engine_serves_a_tier_vectors_and_a_promoted_block(tier):
    """Vectors through the tier's GEMV, bitwise the strategy's own build; a
    promoted block through its GEMM face (ozaki) or the torch tier
    (compensated has none), bitwise ``build_batched``; both within 2^-20
    relative of the fp64 product."""
    rng = np.random.default_rng(8)
    a = rng.uniform(0.0, 10.0, (64, 128)).astype(np.float32)
    X = rng.uniform(0.0, 10.0, (128, 8)).astype(np.float32)
    mesh = make_mesh(8, devices=[CPU] * 8)
    eng = MatvecEngine(a, mesh, strategy="blockwise", kernel=tier, promote=4,
                       max_bucket=8)
    try:
        strat = mv_torch.get_strategy("blockwise")
        a_t, X_t = torch.from_numpy(a), torch.from_numpy(X)
        y = eng.submit(X[:, 0]).result()
        assert torch.equal(y, strat.build(mesh, kernel=tier)(a_t, X_t[:, 0].contiguous()))
        Y = eng.submit(X).result()
        assert torch.equal(Y, strat.build_batched(mesh, kernel=tier)(a_t, X_t))
        oracle = a.astype(np.float64) @ X.astype(np.float64)
        np.testing.assert_allclose(Y.numpy(), oracle, rtol=2.0 ** -20)
        assert eng._kernel_label() == tier
    finally:
        eng.close()


@pytest.mark.parametrize("tier", ACCURACY_TIERS)
def test_sweep_runs_each_tier(tmp_path, capsys, tier):
    from matvec_mpi_multiplier_torch.bench.sweep import main as sweep_main

    rc = sweep_main(["--platform", "cpu", "--host-devices", "4", "--sizes", "64",
                     "--n-reps", "2", "--kernel", tier, "--strategy", "rowwise",
                     "colwise", "blockwise", "--no-csv"])
    assert rc == 0
    out = capsys.readouterr().out
    for name in ("rowwise", "colwise", "blockwise"):
        assert f"{name} 64x64 p=4" in out
