"""The port's flagship entry points (``matvec_mpi_multiplier_torch/entry.py``)
against the JAX package's (``__graft_entry__.py``, ``tests/test_graft_entry.py``).

``entry(device="cpu")`` hands out the JAX entry's operands bit for bit, and
its forward step agrees with the JAX one's at the bf16 strategy tolerance
(2^-7, one bf16 ulp: both cast an fp32 sum taken in another order).
``dryrun_multichip`` runs every face on logical CPU shards, the 2×3 grid of
the JAX test among them, each face held to numpy inside. Without a card and
without ``device=``, both raise.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from matvec_mpi_multiplier_torch import entry as port_entry
from matvec_mpi_multiplier_torch.utils.errors import ConfigError

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import __graft_entry__ as jax_entry  # noqa: E402


def test_entry_matches_the_jax_entry(devices):
    fn_j, (a_j, x_j) = jax_entry.entry()
    fn_t, (a_t, x_t) = port_entry.entry(device="cpu")
    assert a_t.dtype == x_t.dtype == torch.bfloat16
    assert tuple(a_t.shape) == (512, 512) and tuple(x_t.shape) == (512,)
    for t, j in ((a_t, a_j), (x_t, x_j)):
        np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                      np.asarray(j).view(np.int16))
    y_t = fn_t(a_t, x_t)
    y_j = np.asarray(fn_j(a_j, x_j)).astype(np.float64)
    assert y_t.dtype == torch.bfloat16 and tuple(y_t.shape) == (512,)
    np.testing.assert_allclose(y_t.to(torch.float64).numpy(), y_j, rtol=2 ** -7)
    exact = np.asarray(a_j).astype(np.float64) @ np.asarray(x_j).astype(np.float64)
    np.testing.assert_allclose(y_t.to(torch.float64).numpy(), exact, rtol=2 ** -7)


@pytest.mark.parametrize("n_devices,grid", [(1, [1, 1]), (4, [2, 2]), (6, [2, 3]),
                                            (8, [2, 4])])
def test_dryrun_multichip_on_cpu_shards(n_devices, grid):
    summary = port_entry.dryrun_multichip(n_devices, device="cpu")
    assert summary["grid"] == grid and summary["device"] == "cpu"
    assert np.isfinite(summary["loss"])
    assert summary["cg_iters"] >= 1 and summary["gmres_cycles"] >= 1


def test_dryrun_fails_on_a_wrong_operator(monkeypatch):
    """A finite-but-wrong face fails the dryrun: here the colwise
    schedules' product scaled by 2."""
    from matvec_mpi_multiplier_torch.models import colwise

    real = colwise.ColwiseStrategy.build

    def doubled(self, mesh, **kw):
        fn = real(self, mesh, **kw)
        return lambda a, x: 2 * fn(a, x)

    monkeypatch.setattr(colwise.ColwiseStrategy, "build", doubled)
    with pytest.raises(AssertionError, match="colwise_ring_overlap"):
        port_entry.dryrun_multichip(4, device="cpu")


@pytest.mark.parametrize("call", [
    lambda: port_entry.entry(),
    lambda: port_entry.dryrun_multichip(4),
], ids=["entry", "dryrun"])
def test_entry_points_need_a_card_or_the_cpu_named(monkeypatch, call):
    """No quiet CPU fallback: without a card they raise."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ConfigError, match="no CUDA device"):
        call()


def test_entry_cli_on_cpu(capsys):
    assert port_entry.main(["--device", "cpu", "--n-devices", "6"]) == 0
    out = capsys.readouterr().out
    assert "entry forward:" in out and "'grid': [2, 3]" in out
