"""The port's CG and refinement (``models/cg.py``) against the JAX package's.

The same numpy systems go through the JAX package's solvers on the conftest's
8-device CPU mesh and through the port's on 8 logical CPU shards (the
device loop's chunks run eagerly here). Bars, each stated where it is used:
iteration and trip counts equal to JAX's; x within 1e-10 of JAX's in fp64
and 1e-4 in fp32; the JAX tests' own bars on convergence, forward error and
residuals.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import matvec_mpi_multiplier_tpu as mv_jax
from matvec_mpi_multiplier_tpu.models import cg as jcg
from matvec_mpi_multiplier_torch import get_strategy
from matvec_mpi_multiplier_torch.models import cg as tcg
from matvec_mpi_multiplier_torch.parallel.mesh import make_mesh
from matvec_mpi_multiplier_torch.solvers import device_loop

from conftest import spd_with_spectrum

CPU = torch.device("cpu")
X_TOL = {"float64": 1e-10, "float32": 1e-4}


def port_mesh(p):
    return make_mesh(p, devices=[CPU] * p)


def spd_system(n, seed=0):
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((n, n))
    a = g.T @ g / n + np.eye(n)
    x_true = rng.standard_normal(n)
    return a, x_true, a @ x_true


def ill_conditioned_spd(n, cond, seed):
    a = spd_with_spectrum(n, np.logspace(0, np.log10(cond), n), seed=seed)
    x_true = np.random.default_rng(seed).standard_normal(n)
    return a, x_true, a @ x_true


def jax_solve(name, p, a, b, **kw):
    return jcg.solve_cg(mv_jax.get_strategy(name), mv_jax.make_mesh(p),
                        jnp.asarray(a), jnp.asarray(b), **kw)


def port_solve(name, p, a, b, **kw):
    return tcg.solve_cg(get_strategy(name), port_mesh(p), torch.from_numpy(a),
                        torch.from_numpy(b), **kw)


# ----------------------------------------------------------------------- cg


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("name", ["rowwise", "colwise", "blockwise", "colwise_ring"])
def test_cg_every_strategy_matches_jax(devices, name, dtype):
    a, x_true, b = spd_system(64, seed=1)
    a, b = a.astype(dtype), b.astype(dtype)
    tol = 1e-10 if dtype == "float64" else 1e-5
    rj = jax_solve(name, 8, a, b, tol=tol)
    rt = port_solve(name, 8, a, b, tol=tol)
    assert bool(rt.converged) and bool(rj.converged)
    assert int(rt.n_iters) == int(rj.n_iters) <= 64 + 5
    assert rt.x.dtype == torch.float64 if dtype == "float64" else torch.float32
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), rtol=0, atol=X_TOL[dtype])
    np.testing.assert_allclose(rt.x.numpy(), x_true, rtol=0, atol=10 * X_TOL[dtype])


def test_cg_reported_residual_is_true(devices):
    a, _, b = spd_system(32, seed=2)
    rt = port_solve("rowwise", 4, a, b, tol=1e-8)
    true_r = np.linalg.norm(b - a @ rt.x.numpy())
    np.testing.assert_allclose(float(rt.residual_norm), true_r, rtol=1e-6)
    assert float(rt.residual_norm) <= 1e-8 * np.linalg.norm(b)


def test_cg_max_iters_cap(devices):
    a, _, b = spd_system(48, seed=3)
    rt = port_solve("rowwise", 8, a, b, tol=1e-14, max_iters=3)
    assert int(rt.n_iters) == 3 and not bool(rt.converged)


def test_cg_rejects_rectangular():
    cg = tcg.build_cg(get_strategy("rowwise"), port_mesh(2))
    with pytest.raises(ValueError, match="square"):
        cg(torch.zeros((8, 4)), torch.zeros(8))


def test_cg_fp32_storage_with_ozaki_kernel(devices):
    a64, x_true, b64 = spd_system(64, seed=4)
    a, b = a64.astype(np.float32), b64.astype(np.float32)
    kw = dict(kernel="ozaki", tol=1e-6, max_iters=300)
    rj = jax_solve("blockwise", 8, a, b, **kw)
    rt = port_solve("blockwise", 8, a, b, **kw)
    assert bool(rt.converged)
    assert int(rt.n_iters) == int(rj.n_iters)
    np.testing.assert_allclose(rt.x.numpy(), x_true, rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), rtol=0, atol=1e-4)


def test_cg_zero_rhs_immediate():
    a, _, _ = spd_system(16, seed=5)
    rt = port_solve("rowwise", 2, a, np.zeros(16))
    assert bool(rt.converged) and int(rt.n_iters) == 0
    np.testing.assert_array_equal(rt.x.numpy(), np.zeros(16))


def test_cg_indefinite_stalls_not_nan():
    rt = port_solve("rowwise", 2, -np.eye(16), np.ones(16), max_iters=5)
    assert not bool(rt.converged)
    assert torch.isfinite(rt.x).all()


def test_pcg_jacobi_beats_plain_on_badly_scaled_system(devices):
    n = 64
    rng = np.random.default_rng(6)
    g = rng.standard_normal((n, n))
    scale = np.logspace(0, 4, n)
    a = scale[:, None] * (g.T @ g / n + np.eye(n)) * scale[None, :]
    x_true = rng.standard_normal(n)
    b = a @ x_true
    plain = port_solve("rowwise", 8, a, b, tol=1e-9, max_iters=2000)
    pcg = port_solve("rowwise", 8, a, b, tol=1e-9, max_iters=2000, precondition="jacobi")
    jpcg = jax_solve("rowwise", 8, a, b, tol=1e-9, max_iters=2000, precondition="jacobi")
    assert bool(pcg.converged)
    assert int(pcg.n_iters) * 2 <= int(plain.n_iters)
    assert int(pcg.n_iters) == int(jpcg.n_iters)
    np.testing.assert_allclose(pcg.x.numpy(), x_true, rtol=1e-3, atol=1e-3)


def test_pcg_identity_jacobi_is_plain():
    """A unit diagonal makes M = I: the same iterations, x bitwise."""
    a, _, b = spd_system(32, seed=7)
    d = np.sqrt(np.diagonal(a))
    a1, b1 = a / np.outer(d, d), b / d
    np.fill_diagonal(a1, 1.0)  # exactly: sqrt(a_ii)² need not round back to a_ii
    plain = port_solve("rowwise", 4, a1, b1, tol=1e-10)
    pcg = port_solve("rowwise", 4, a1, b1, tol=1e-10, precondition=True)
    assert bool(plain.converged) and bool(pcg.converged)
    assert int(plain.n_iters) == int(pcg.n_iters)
    assert torch.equal(plain.x, pcg.x)


def test_pcg_rejects_unknown_preconditioner():
    with pytest.raises(ValueError, match="jacobi"):
        tcg.build_cg(get_strategy("rowwise"), port_mesh(2), precondition="ilu")


@pytest.mark.parametrize("chunk", [1, 5])
def test_device_loop_chunking_keeps_the_iterates(monkeypatch, chunk):
    """The loop's chunk length changes how often it reads, never the
    iterations: masked iterations past the stop leave the state as it was.
    Off the card nothing is captured."""
    a, _, b = spd_system(48, seed=8)
    kw = dict(tol=1e-10, recompute_every=7)
    ref = port_solve("colwise", 4, a, b, **kw)
    monkeypatch.setattr(device_loop, "DEFAULT_CHUNK", chunk)
    cg = tcg.build_cg(get_strategy("colwise"), port_mesh(4), **kw)
    assert cg.loop_device is None
    got = cg(torch.from_numpy(a), torch.from_numpy(b))
    assert int(got.n_iters) == int(ref.n_iters)
    assert torch.equal(got.x, ref.x)
    again = cg(torch.from_numpy(a), torch.from_numpy(b))  # the same loop state
    assert torch.equal(again.x, got.x)


# --------------------------------------------------------------- refinement


def test_refined_recovers_fp32_accuracy_on_ill_conditioned(devices):
    """cond 1e5 from the spectrum: forward error under 1e-5 and at least 50x
    better than plain fp32 CG. Trips within one of JAX's: the fp32 inner
    solves sum in another order than XLA's, cond 1e5 amplifies that from
    the first trip on (2049.9 against 2050.5 after it, at this seed), and
    the stagnation rule may then stop one trip apart. On a
    well-conditioned system the trips are equal (the next test)."""
    n, cond = 96, 1e5
    a64, _, b64 = ill_conditioned_spd(n, cond, seed=21)
    a, b = a64.astype(np.float32), b64.astype(np.float32)
    xs = np.linalg.solve(a.astype(np.float64), b.astype(np.float64))
    rel = lambda x: float(np.max(np.abs(np.asarray(x, np.float64) - xs)) / np.max(np.abs(xs)))  # noqa: E731
    strat, mesh = get_strategy("rowwise"), port_mesh(8)
    plain = tcg.solve_cg(strat, mesh, torch.from_numpy(a), torch.from_numpy(b), tol=1e-7,
                         max_iters=5000)
    refined = tcg.solve_refined(strat, mesh, torch.from_numpy(a), torch.from_numpy(b),
                                max_iters=5000)
    jref = jcg.solve_refined(mv_jax.get_strategy("rowwise"), mv_jax.make_mesh(8),
                             jnp.asarray(a), jnp.asarray(b), max_iters=5000)
    assert bool(refined.converged)
    assert rel(refined.x) < 1e-5
    assert rel(refined.x) * 50 < rel(plain.x)
    assert abs(int(refined.n_iters) - int(jref.n_iters)) <= 1


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_refined_well_conditioned_drives_residual_deep(devices, dtype):
    """The residual below 1e-7 ||b||, x within 1e-4 of the truth, and the
    same trips as JAX."""
    a, x_true, b = spd_system(64, seed=22)
    a, b = a.astype(dtype), b.astype(dtype)
    res = tcg.solve_refined(get_strategy("blockwise"), port_mesh(8),
                            torch.from_numpy(a), torch.from_numpy(b))
    jres = jcg.solve_refined(mv_jax.get_strategy("blockwise"), mv_jax.make_mesh(8),
                             jnp.asarray(a), jnp.asarray(b))
    assert bool(res.converged)
    assert int(res.n_iters) == int(jres.n_iters)
    assert float(res.residual_norm) < 1e-7 * float(np.linalg.norm(b))
    np.testing.assert_allclose(res.x.double().numpy(), x_true, rtol=1e-4, atol=1e-4)


def test_refined_compensated_residual_kernel():
    a64, x_true, b64 = ill_conditioned_spd(48, 1e4, seed=23)
    res = tcg.solve_refined(get_strategy("rowwise"), port_mesh(8),
                            torch.from_numpy(a64.astype(np.float32)),
                            torch.from_numpy(b64.astype(np.float32)),
                            residual_kernel="compensated", max_iters=3000)
    assert bool(res.converged)
    assert float(np.max(np.abs(res.x.double().numpy() - x_true)) / np.max(np.abs(x_true))) < 1e-4


def test_refined_rejects_rectangular_and_unknown_inner():
    with pytest.raises(ValueError, match="square"):
        tcg.solve_refined(get_strategy("rowwise"), port_mesh(2), torch.zeros((8, 4)),
                          torch.zeros(8))
    with pytest.raises(ValueError, match="inner"):
        tcg.build_refined(get_strategy("rowwise"), port_mesh(8), inner="qmr")


def test_refined_residual_falls_back_to_one_device():
    """A size the inner strategy takes but the residual's rowwise build over
    the whole mesh does not (blockwise on 2x4: 36 rows split 2 ways, not 8):
    the residual runs on the mesh's first device."""
    a, x_true, b = spd_system(36, seed=24)
    res = tcg.solve_refined(get_strategy("blockwise"), port_mesh(8),
                            torch.from_numpy(a.astype(np.float32)),
                            torch.from_numpy(b.astype(np.float32)))
    assert bool(res.converged)
    np.testing.assert_allclose(res.x.double().numpy(), x_true, rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------- CLI


def test_cg_cli_smoke(capsys):
    from matvec_mpi_multiplier_torch.bench import solve_cg

    assert solve_cg.main(["--size", "64", "--strategy", "rowwise", "--devices", "4",
                          "--tol", "1e-6", "--platform", "cpu"]) == 0
    assert "converged=True" in capsys.readouterr().out


def test_cg_cli_refine_smoke(capsys):
    from matvec_mpi_multiplier_torch.bench import solve_cg

    assert solve_cg.main(["--size", "64", "--strategy", "rowwise", "--devices", "4",
                          "--refine", "--platform", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "refine(ozaki)" in out and "converged=True" in out
