"""The port's restarted GMRES (``models/gmres.py``) and refinement with a
GMRES inner solver against the JAX package's.

The same numpy systems go through both. Bars, each stated where it is used:
cycle counts equal to JAX's; x within 1e-10 of JAX's (fp64) or of the truth
at the JAX test's 2e-4 (fp32); the reported residual a true one (rtol
1e-6); the JAX tests' own bars elsewhere.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import matvec_mpi_multiplier_tpu as mv_jax
from matvec_mpi_multiplier_tpu.models import gmres as jgm
from matvec_mpi_multiplier_torch import get_strategy
from matvec_mpi_multiplier_torch.models import cg as tcg
from matvec_mpi_multiplier_torch.models import gmres as tgm
from matvec_mpi_multiplier_torch.parallel.mesh import make_mesh

CPU = torch.device("cpu")


def port_mesh(p):
    return make_mesh(p, devices=[CPU] * p)


def nonsym_system(n, seed=0, shift=2.0):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n)) / np.sqrt(n) + shift * np.eye(n)
    assert not np.allclose(a, a.T)
    x_true = rng.standard_normal(n)
    return a, x_true, a @ x_true


def port_solve(name, p, a, b, **kw):
    return tgm.solve_gmres(get_strategy(name), port_mesh(p), torch.from_numpy(a),
                           torch.from_numpy(b), **kw)


@pytest.mark.parametrize("name", ["rowwise", "colwise", "blockwise", "colwise_ring"])
def test_gmres_every_strategy_matches_jax(devices, name):
    a, x_true, b = nonsym_system(64, seed=1)
    rj = jgm.solve_gmres(mv_jax.get_strategy(name), mv_jax.make_mesh(8), jnp.asarray(a),
                         jnp.asarray(b), tol=1e-10)
    rt = port_solve(name, 8, a, b, tol=1e-10)
    assert bool(rt.converged)
    assert int(rt.n_iters) == int(rj.n_iters)
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), rtol=0, atol=1e-10)
    np.testing.assert_allclose(rt.x.numpy(), x_true, rtol=1e-7, atol=1e-7)


def test_gmres_full_krylov_is_direct():
    """restart >= n: one cycle on any nonsingular system (the breakdown
    path: the basis becomes invariant and the rank-revealing least squares
    drops the zero columns)."""
    a, x_true, b = nonsym_system(32, seed=2)
    rt = port_solve("rowwise", 4, a, b, tol=1e-10, restart=32)
    assert bool(rt.converged) and int(rt.n_iters) == 1
    np.testing.assert_allclose(rt.x.numpy(), x_true, rtol=1e-7, atol=1e-7)
    rt = port_solve("rowwise", 4, a, b, tol=1e-10, restart=40)  # past n: breakdown
    assert bool(rt.converged) and int(rt.n_iters) == 1
    assert torch.isfinite(rt.x).all()


def test_gmres_reported_residual_is_true():
    a, _, b = nonsym_system(48, seed=3)
    rt = port_solve("blockwise", 8, a, b, tol=1e-8, restart=12)
    true_r = np.linalg.norm(b - a @ rt.x.numpy())
    np.testing.assert_allclose(float(rt.residual_norm), true_r, rtol=1e-6, atol=1e-12)
    assert true_r <= 1e-8 * np.linalg.norm(b)


def test_gmres_max_restarts_cap(devices):
    rng = np.random.default_rng(4)
    q, _ = np.linalg.qr(rng.standard_normal((48, 48)))
    b = rng.standard_normal(48)
    kw = dict(tol=1e-14, restart=2, max_restarts=3)
    rt = port_solve("rowwise", 8, q, b, **kw)
    rj = jgm.solve_gmres(mv_jax.get_strategy("rowwise"), mv_jax.make_mesh(8),
                         jnp.asarray(q), jnp.asarray(b), **kw)
    assert int(rt.n_iters) == int(rj.n_iters) == 3
    assert not bool(rt.converged)
    assert float(rt.residual_norm) <= np.linalg.norm(b) * (1 + 1e-6)


def test_gmres_fp32_storage_fp32_accuracy():
    a64, x_true, b64 = nonsym_system(64, seed=5)
    rt = port_solve("colwise", 8, a64.astype(np.float32), b64.astype(np.float32), tol=1e-5)
    assert bool(rt.converged) and rt.x.dtype == torch.float32
    np.testing.assert_allclose(rt.x.numpy(), x_true, rtol=2e-4, atol=2e-4)


def test_gmres_matches_cg_on_spd():
    rng = np.random.default_rng(6)
    g = rng.standard_normal((64, 64))
    a, b = g.T @ g / 64 + np.eye(64), rng.standard_normal(64)
    xg = port_solve("rowwise", 8, a, b, tol=1e-10)
    xc = tcg.solve_cg(get_strategy("rowwise"), port_mesh(8), torch.from_numpy(a),
                      torch.from_numpy(b), tol=1e-10)
    np.testing.assert_allclose(xg.x.numpy(), xc.x.numpy(), rtol=1e-7, atol=1e-7)


def test_gmres_zero_rhs():
    a, _, _ = nonsym_system(32, seed=7)
    rt = port_solve("rowwise", 4, a, np.zeros(32))
    assert bool(rt.converged) and int(rt.n_iters) == 0
    np.testing.assert_array_equal(rt.x.numpy(), np.zeros(32))


def test_gmres_guards():
    with pytest.raises(ValueError, match="square"):
        tgm.build_gmres(get_strategy("rowwise"), port_mesh(8))(torch.ones((16, 8)),
                                                               torch.ones(8))
    with pytest.raises(ValueError, match="restart"):
        tgm.build_gmres(get_strategy("rowwise"), port_mesh(8), restart=0)


def test_refined_gmres_beats_plain_fp32_on_nonsym_illconditioned(devices):
    """fp32, nonsymmetric, cond ~1e4 (a row-scaled triangular matrix):
    refinement with a GMRES inner solver lands below 1e-7 forward error, at
    least 4x better than the JAX package's plain fp32 GMRES (its test's
    bar) and 2x better than the port's. The port's plain floor is lower
    than JAX's: its fp32 GEMV and dots are PyTorch's blocked CPU sums, and
    the refined x sits at its own fp32 rounding (about 3e-8 here), so the
    port's own ratio is about 3."""
    n = 96
    rng = np.random.default_rng(8)
    u = np.triu(rng.standard_normal((n, n)), 1)
    a64 = np.diag(np.logspace(0, -4, n)) @ (np.eye(n) + 0.02 * u)
    assert 1e3 < np.linalg.cond(a64) < 1e5
    a32 = a64.astype(np.float32)
    b32 = (a64 @ rng.standard_normal(n)).astype(np.float32)
    xs = np.linalg.solve(a32.astype(np.float64), b32.astype(np.float64))
    rel = lambda x: float(np.max(np.abs(np.asarray(x, np.float64) - xs)) / np.max(np.abs(xs)))  # noqa: E731
    strat, mesh = get_strategy("rowwise"), port_mesh(8)
    plain = tgm.solve_gmres(strat, mesh, torch.from_numpy(a32), torch.from_numpy(b32),
                            tol=1e-12, restart=n, max_restarts=20)
    jplain = jgm.solve_gmres(mv_jax.get_strategy("rowwise"), mv_jax.make_mesh(8),
                             jnp.asarray(a32), jnp.asarray(b32), tol=1e-12, restart=n,
                             max_restarts=20)
    refined = tcg.build_refined(strat, mesh, inner="gmres", restart=n)(
        torch.from_numpy(a32), torch.from_numpy(b32))
    assert bool(refined.converged)
    assert rel(refined.x) < 1e-7
    assert rel(refined.x) * 4 < rel(jplain.x)
    assert rel(refined.x) * 2 < rel(plain.x)


def test_refined_gmres_defaults_to_small_inner_restart(monkeypatch):
    seen = []
    real = tgm.build_gmres

    def spy(strategy, mesh, **kw):
        seen.append(kw)
        return real(strategy, mesh, **kw)

    monkeypatch.setattr(tgm, "build_gmres", spy)
    strat, mesh = get_strategy("rowwise"), port_mesh(8)
    tcg.build_refined(strat, mesh, inner="gmres")
    assert seen[-1]["restart"] == 10
    tcg.build_refined(strat, mesh, inner="gmres", restart=64)
    assert seen[-1]["restart"] == 64


def test_gmres_cli_smoke(capsys):
    from matvec_mpi_multiplier_torch.bench import solve_cg

    assert solve_cg.main(["--size", "64", "--method", "gmres", "--strategy", "rowwise",
                          "--devices", "4", "--tol", "1e-6", "--platform", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "gmres[rowwise" in out and "converged=True" in out
