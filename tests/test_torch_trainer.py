"""The port's least-squares trainer and checkpoints (``models/trainer.py``,
``utils/checkpoint.py``, ``bench/solve.py``) against the JAX package's.

Bars: fp64 loss histories within rtol 1e-9 of JAX's and across mesh sizes
(the port's SGD update may round once where optax's rounds twice, and the
sums' order differs); a JAX state carried across continues to JAX's later
state within 1e-12 (fp64); checkpoints round-trip bitwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import matvec_mpi_multiplier_tpu as mv_jax
from matvec_mpi_multiplier_tpu.models import trainer as jtr
from matvec_mpi_multiplier_torch.models import trainer as ttr
from matvec_mpi_multiplier_torch.parallel.mesh import make_mesh, shard, unshard
from matvec_mpi_multiplier_torch.utils import checkpoint

CPU = torch.device("cpu")


def port_mesh(p):
    return make_mesh(p, devices=[CPU] * p)


def test_fit_converges(rng):
    x_true = rng.standard_normal(16)
    a = rng.standard_normal((32, 16))
    state, losses = ttr.fit(port_mesh(8), a, a @ x_true, learning_rate=0.02, n_steps=300,
                            dtype=torch.float64)
    assert losses[-1] < 1e-3 * losses[0]
    np.testing.assert_allclose(unshard(state.x).numpy(), x_true, atol=0.2)


def test_param_stays_sharded(rng):
    mesh = port_mesh(8)
    sh = ttr.shardings(mesh)
    state = ttr.init_state(mesh, 16, learning_rate=1e-3, dtype=torch.float64)
    step = ttr.build_train_step(mesh)
    a = shard(torch.from_numpy(rng.standard_normal((16, 16))), sh["a"], mesh)
    b = shard(torch.from_numpy(rng.standard_normal(16)), sh["b"], mesh)
    shards_before = [t.data_ptr() for t in state.x.shards]
    state, loss = step(state, a, b)
    assert state.x.spec == ("cols",)
    assert [t.data_ptr() for t in state.x.shards] == shards_before  # updated in place
    assert int(state.step) == 1 and np.isfinite(float(loss))
    # Every device of a column holds the same block.
    for f in range(mesh.size):
        col = mesh.coords(f)["cols"]
        assert torch.equal(state.x.shards[f], state.x.shards[col])


def test_single_device_matches_multi(rng):
    a, b = rng.standard_normal((16, 8)), rng.standard_normal(16)
    _, l1 = ttr.fit(port_mesh(1), a, b, n_steps=20, dtype=torch.float64)
    _, l8 = ttr.fit(port_mesh(8), a, b, n_steps=20, dtype=torch.float64)
    np.testing.assert_allclose(l1, l8, rtol=1e-9)


def test_loss_history_matches_jax(devices, rng):
    a, b = rng.standard_normal((32, 16)), rng.standard_normal(32)
    _, lj = jtr.fit(mv_jax.make_mesh(8), a, b, learning_rate=0.02, n_steps=20,
                    dtype=jnp.float64)
    _, lt = ttr.fit(port_mesh(8), a, b, learning_rate=0.02, n_steps=20, dtype=torch.float64)
    np.testing.assert_allclose(lt, lj, rtol=1e-9)


def test_jax_state_carried_across_continues_to_jax_state(devices, rng):
    """JAX trains 5 steps; its x and step, carried across with
    state_from_numpy, train 5 more in the port; JAX's own 10-step state is
    where they land."""
    a, b = rng.standard_normal((32, 16)), rng.standard_normal(32)
    jmesh = mv_jax.make_mesh(8)
    opt = optax.sgd(1e-2)
    sh = jtr.shardings(jmesh)
    jstate = jtr.init_state(jmesh, 16, opt, dtype=jnp.float64)
    jstep = jtr.build_train_step(jmesh, opt)
    a_j, b_j = jax.device_put(jnp.asarray(a), sh["a"]), jax.device_put(jnp.asarray(b), sh["b"])
    for _ in range(5):
        jstate, _ = jstep(jstate, a_j, b_j)
    carried = ttr.state_from_numpy(port_mesh(8), np.asarray(jstate.x), int(jstate.step),
                                   learning_rate=1e-2, dtype=torch.float64)
    for _ in range(5):
        jstate, _ = jstep(jstate, a_j, b_j)
    step = ttr.build_train_step(port_mesh(8))
    for _ in range(5):
        carried, _ = step(carried, torch.from_numpy(a), torch.from_numpy(b))
    assert int(carried.step) == int(jstate.step) == 10
    np.testing.assert_allclose(unshard(carried.x).numpy(), np.asarray(jstate.x), rtol=0,
                               atol=1e-12)


def test_checkpoint_round_trip_onto_the_template(tmp_path, rng):
    """Saved on a 2x4 mesh, restored onto a template on a 1x2 mesh: the
    template's placement, the saved values bitwise, the step and the
    optimizer's learning rate; a resume on the saving mesh continues
    bitwise as the unsaved run does."""
    a, b = rng.standard_normal((16, 8)), rng.standard_normal(16)
    mesh = port_mesh(8)
    state, _ = ttr.fit(mesh, a, b, learning_rate=0.05, n_steps=3, dtype=torch.float64)
    path = checkpoint.save_state(state, tmp_path / "ck" / "step_3")
    assert (path / checkpoint.STATE_FILE).exists()
    other = port_mesh(2)
    like = ttr.init_state(other, 8, learning_rate=0.01, dtype=torch.float64)
    restored = checkpoint.restore_state(path, like)
    assert restored.x.mesh == other and restored.x.spec == ("cols",)
    assert torch.equal(unshard(restored.x), unshard(state.x))
    assert int(restored.step) == 3
    assert restored.optimizer.param_groups[0]["lr"] == 0.05
    step = ttr.build_train_step(mesh)
    resumed, _ = step(checkpoint.restore_state(path, ttr.init_state(
        mesh, 8, dtype=torch.float64)), torch.from_numpy(a), torch.from_numpy(b))
    direct, _ = step(state, torch.from_numpy(a), torch.from_numpy(b))
    assert torch.equal(unshard(resumed.x), unshard(direct.x))
    assert int(resumed.step) == int(direct.step) == 4


def test_latest_step_dir(tmp_path):
    assert checkpoint.latest_step_dir(tmp_path / "missing") is None
    assert checkpoint.latest_step_dir(tmp_path) is None
    for name in ("step_3", "step_12", "step_x", "other"):
        (tmp_path / name).mkdir()
    (tmp_path / "step_99").write_text("a file, not a checkpoint")
    assert checkpoint.latest_step_dir(tmp_path) == tmp_path / "step_12"


def test_solve_cli_end_to_end(tmp_path, capsys):
    """Run, checkpoint every 3, then resume from step 6 to step 10."""
    from matvec_mpi_multiplier_torch.bench import solve

    ck = tmp_path / "ck"
    args = ["--size", "64", "32", "--steps", "6", "--platform", "cpu",
            "--ckpt-dir", str(ck), "--ckpt-every", "3"]
    assert solve.main(args) == 0
    first = capsys.readouterr().out
    assert "done: steps=6" in first
    assert (ck / "step_6").exists()
    assert solve.main(args[:4] + ["10"] + args[5:]) == 0
    second = capsys.readouterr().out
    assert "resumed from" in second and "at step 6" in second
    assert "done: steps=10" in second


def test_solve_cli_rejects_bad_interval():
    from matvec_mpi_multiplier_torch.bench import solve

    with pytest.raises(SystemExit):
        solve.main(["--ckpt-every", "0", "--platform", "cpu"])
