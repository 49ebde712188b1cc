"""The port's flagship entry points (the counterpart of the JAX package's
``__graft_entry__.py``).

* :func:`entry` — the flagship forward step, blockwise distributed matvec on
  a one-shard mesh, with example operands (512² bf16, numpy
  ``default_rng(0)`` uniform [0, 10), the JAX entry's).
* :func:`dryrun_multichip` — every face of the system once on ``n_devices``
  logical shards of one device, on the most-square ``(r, c)`` grid: one
  least-squares training step (``models/trainer.py``), the blockwise GEMM,
  the ``colwise_ring_overlap`` and ``colwise_a2a`` schedules, causal ring
  attention against the dense oracle, the flash tier against the xla tier
  at d = 128, cg and gmres, each against numpy at the JAX dryrun's
  tolerances.

Both run on ``cuda:0`` unless the caller passes ``device="cpu"``; with no
card and no ``device``, they raise :class:`ConfigError` (no quiet CPU
fallback).

    python -m matvec_mpi_multiplier_torch.entry [--device cpu] [--n-devices 8]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from .utils.errors import ConfigError


def _device(device) -> torch.device:
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise ConfigError(
            "the entry points run on cuda:0 and found no CUDA device; pass "
            "device='cpu' for a CPU run"
        )
    return torch.device("cuda", 0)


def entry(device=None):
    """Return ``(fn, (a, x))``: the flagship forward step and its operands,
    on ``device`` (``cuda:0`` by default)."""
    from .models import get_strategy
    from .parallel.mesh import make_mesh

    dev = _device(device)
    mesh = make_mesh(1, devices=[dev])
    fn = get_strategy("blockwise").build(mesh)
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.uniform(0, 10, size=(512, 512))).to(dev, torch.bfloat16)
    x = torch.from_numpy(rng.uniform(0, 10, size=(512,))).to(dev, torch.bfloat16)
    return fn, (a, x)


def _close(got: torch.Tensor, want: np.ndarray, what: str, *,
           rtol: float = 1e-4, atol: float = 1e-4) -> None:
    np.testing.assert_allclose(got.detach().cpu().numpy(), want, rtol=rtol,
                               atol=atol, err_msg=f"dryrun: {what}")


def dryrun_multichip(n_devices: int, *, device=None) -> dict:
    """Run every face once on ``n_devices`` logical shards of ``device``
    (``cuda:0`` by default); raises on any disagreement. Returns a summary
    (grid, loss, solver iterations)."""
    from .models import get_strategy
    from .models import trainer
    from .models.cg import solve_cg
    from .models.gemm import build_gemm
    from .models.gmres import solve_gmres
    from .parallel.attention import build_ring_attention
    from .parallel.mesh import make_mesh, mesh_grid_shape, shard

    dev = _device(device)
    mesh = make_mesh(n_devices, devices=[dev] * n_devices)
    r, c = mesh_grid_shape(mesh)
    n_rows, n_cols = 8 * r, 8 * c  # tiny, evenly sharded on the grid

    def t(arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(arr).to(dev)

    rng = np.random.default_rng(0)
    a_host = rng.standard_normal((n_rows, n_cols)).astype(np.float32)
    b_host = rng.standard_normal((n_rows,)).astype(np.float32)

    # The training step: A over ('rows', 'cols'), x over 'cols', b over 'rows'.
    sh = trainer.shardings(mesh)
    state = trainer.init_state(mesh, n_cols)
    step = trainer.build_train_step(mesh)
    state, loss = step(state, shard(t(a_host), sh["a"], mesh),
                       shard(t(b_host), sh["b"], mesh))
    loss = float(loss)
    if not np.isfinite(loss):
        raise RuntimeError(f"dryrun: non-finite loss {loss}")
    if int(state.step) != 1:
        raise RuntimeError(f"dryrun: the step count is {int(state.step)}, not 1")

    # The GEMM strategy set's blockwise step (the one-shot SUMMA step).
    bm = rng.standard_normal((n_rows, n_cols)).astype(np.float32)
    bn = rng.standard_normal((n_cols, 8 * c)).astype(np.float32)
    _close(build_gemm("blockwise", mesh)(t(bm), t(bn)), bm @ bn, "blockwise gemm")

    # The sequence-parallel face: the overlapped ring schedule and the
    # all-to-all, over the flat axis.
    n_flat = n_devices * 8
    ar = rng.standard_normal((n_flat, n_flat)).astype(np.float32)
    xr = rng.standard_normal((n_flat,)).astype(np.float32)
    for name in ("colwise_ring_overlap", "colwise_a2a"):
        _close(get_strategy(name).build(mesh)(t(ar), t(xr)), ar @ xr, name)

    # The long-context face: causal ring attention against the dense oracle.
    s, d = n_devices * 4, 8
    qn, kn, vn = (rng.standard_normal((s, d)).astype(np.float32) for _ in range(3))
    o = build_ring_attention(mesh, causal=True, gather_output=True)(t(qn), t(kn), t(vn))
    scores = (qn.astype(np.float64) @ kn.astype(np.float64).T) / np.sqrt(d)
    scores = np.where(np.tril(np.ones((s, s), bool)), scores, -np.inf)
    w = np.exp(scores - scores.max(axis=1, keepdims=True))
    _close(o, (w / w.sum(axis=1, keepdims=True)) @ vn.astype(np.float64),
           "ring attention against the dense oracle")

    # The flash tier of the same operator at d = 128, against the xla tier.
    df, sf = 128, n_devices * 128
    qf, kf, vf = (t(rng.standard_normal((sf, df)).astype(np.float32)) for _ in range(3))
    o_xla = build_ring_attention(mesh, causal=True, gather_output=True)(qf, kf, vf)
    o_flash = build_ring_attention(mesh, causal=True, gather_output=True,
                                   kernel="flash")(qf, kf, vf)
    _close(o_flash, o_xla.cpu().numpy(), "flash ring against the xla ring")

    # The iterative solvers: cg on an SPD system, gmres on a nonsymmetric one.
    g = rng.standard_normal((n_flat, n_flat)).astype(np.float32)
    spd = g.T @ g / n_flat + np.eye(n_flat, dtype=np.float32)
    xt = rng.standard_normal(n_flat).astype(np.float32)
    blockwise = get_strategy("blockwise")
    res = solve_cg(blockwise, mesh, t(spd), t(spd @ xt), tol=1e-5, max_iters=200)
    if not bool(res.converged):
        raise RuntimeError(f"dryrun: cg did not converge, ||r|| = {float(res.residual_norm)}")
    _close(res.x, xt, "cg", rtol=1e-2, atol=1e-2)
    nonsym = g / np.sqrt(n_flat) + 2.0 * np.eye(n_flat, dtype=np.float32)
    res_g = solve_gmres(blockwise, mesh, t(nonsym), t(nonsym @ xt), tol=1e-5, restart=16)
    if not bool(res_g.converged):
        raise RuntimeError(
            f"dryrun: gmres did not converge, ||r|| = {float(res_g.residual_norm)}")
    _close(res_g.x, xt, "gmres", rtol=1e-2, atol=1e-2)
    return {"grid": [r, c], "device": str(dev), "loss": loss,
            "cg_iters": int(res.n_iters), "gmres_cycles": int(res_g.n_iters)}


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="matvec-torch-entry",
                                description="Run the flagship entry and the dryrun.")
    p.add_argument("--device", default=None, help="default: cuda:0")
    p.add_argument("--n-devices", type=int, default=8,
                   help="logical shards of the dryrun's mesh")
    args = p.parse_args(argv)
    fn, (a, x) = entry(args.device)
    print("entry forward:", fn(a, x)[:4].float().cpu().numpy())
    print("dryrun_multichip:", dryrun_multichip(args.n_devices, device=args.device))
    return 0


if __name__ == "__main__":
    sys.exit(main())
