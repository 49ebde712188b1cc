"""The port's spectral estimators (``models/spectral.py``) against the JAX
package's: power iteration and the CG-backed condition estimate.

Bars: the estimates within the JAX tests' own relative bounds (stated per
test) and within 1e-9 relative of JAX's estimate on the same fp64 operand
(the start vectors are numpy's seeded draws, bitwise the same).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import matvec_mpi_multiplier_tpu as mv_jax
from matvec_mpi_multiplier_tpu.models import spectral as jsp
from matvec_mpi_multiplier_torch import get_strategy
from matvec_mpi_multiplier_torch.models import cg as tcg
from matvec_mpi_multiplier_torch.models import spectral as tsp
from matvec_mpi_multiplier_torch.parallel.mesh import make_mesh

from conftest import spd_with_spectrum

CPU = torch.device("cpu")


def port_mesh(p):
    return make_mesh(p, devices=[CPU] * p)


@pytest.mark.parametrize("name", ["rowwise", "blockwise"])
def test_spectral_norm_known_spectrum(devices, name):
    a = spd_with_spectrum(64, np.linspace(1.0, 37.5, 64), seed=1)
    est = tsp.spectral_norm(get_strategy(name), port_mesh(8), torch.from_numpy(a), tol=1e-8)
    assert est == pytest.approx(37.5, rel=1e-3)
    jest = jsp.spectral_norm(mv_jax.get_strategy(name), mv_jax.make_mesh(8),
                             jnp.asarray(a), tol=1e-8)
    assert est == pytest.approx(jest, rel=1e-9)


def test_spectral_norm_diagonal_exact():
    a = torch.from_numpy(np.diag([1.0, 5.0, 2.0, 9.0]))
    assert tsp.spectral_norm(get_strategy("rowwise"), port_mesh(2), a,
                             tol=1e-10) == pytest.approx(9.0, rel=1e-6)


def test_spectral_norm_rejects_rectangular():
    power = tsp.build_spectral_norm(get_strategy("rowwise"), port_mesh(2))
    with pytest.raises(ValueError, match="square"):
        power(torch.zeros((8, 4)), torch.zeros(4))


def test_condition_estimate_prescribed(devices):
    """Within 10% of the prescribed cond 1e3, and within 1e-9 of JAX's."""
    a = spd_with_spectrum(64, np.logspace(0, 3, 64), seed=2)
    kw = dict(tol=1e-6, cg_tol=1e-10)
    est = tsp.condition_estimate(get_strategy("rowwise"), port_mesh(8), torch.from_numpy(a), **kw)
    assert est == pytest.approx(1e3, rel=0.1)
    jest = jsp.condition_estimate(mv_jax.get_strategy("rowwise"), mv_jax.make_mesh(8),
                                  jnp.asarray(a), **kw)
    assert est == pytest.approx(jest, rel=1e-9)


def test_condition_estimate_identity():
    est = tsp.condition_estimate(get_strategy("rowwise"), port_mesh(8),
                                 torch.eye(16, dtype=torch.float64), cg_tol=1e-12)
    assert est == pytest.approx(1.0, rel=1e-3)


def test_condition_estimate_warns_on_stalled_inner_solve():
    a = spd_with_spectrum(64, np.logspace(0, 6, 64), seed=3)
    with pytest.warns(RuntimeWarning, match="did not converge"):
        est = tsp.condition_estimate(get_strategy("rowwise"), port_mesh(4),
                                     torch.from_numpy(a.astype(np.float32)),
                                     cg_tol=1e-12, cg_max_iters=20)
    assert est > 0


def test_condition_estimate_kernel_threads_both_halves(monkeypatch):
    """kernel= reaches the power half and the inner CG: the ozaki tier
    through the whole estimate (within 15% of cond 10)."""
    kernels = []
    real = tcg.build_cg

    def spy(strategy, mesh, **kw):
        kernels.append(kw["kernel"])
        return real(strategy, mesh, **kw)

    monkeypatch.setattr(tsp, "build_cg", spy)
    seen = []
    real_build = get_strategy("rowwise").__class__.build

    def build(self, mesh, **kw):
        seen.append(kw.get("kernel"))
        return real_build(self, mesh, **kw)

    monkeypatch.setattr(get_strategy("rowwise").__class__, "build", build)
    a = spd_with_spectrum(32, np.linspace(1.0, 10.0, 32), seed=4)
    est = tsp.condition_estimate(get_strategy("rowwise"), port_mesh(4),
                                 torch.from_numpy(a.astype(np.float32)), kernel="ozaki",
                                 cg_tol=1e-6)
    assert est == pytest.approx(10.0, rel=0.15)
    assert kernels == ["ozaki"] and set(seen) == {"ozaki"} and len(seen) == 2
