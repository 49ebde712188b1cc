"""The fused solver step's plain version against the JAX package's fused step.

``ops/cuda_solver.py::solver_step_plain`` is the arithmetic of the port's
hand-written step (``csrc/solver_step.cu``): the rotated CG/Chebyshev update
of ``x``, ``r`` and ``p``, then the shard's GEMV against the fresh ``p``.
Here it meets the JAX package's ``ops/pallas_solver.py::_fused_step`` called
directly, in interpret mode, as the JAX package's own tests run it on the
CPU. The same seeded numpy shard, vectors and scalars go to both.

Cases: cg and chebyshev; a native shard in fp32, fp64 and bf16 (the fused
step reads ``p`` in the accumulator type, where the unfused tier casts it
to A's), and int8, int8c and fp8 payloads from the port's quantizer (bitwise
the JAX package's, ``tests/test_torch_quantize.py``); a rowwise shard
(``off = 0``, all of ``p``) and a colwise one (a segment at ``off > 0``).
All five outputs are compared. The two sum ``pᵀAp`` and ``Σ r2²`` in
another order, so the tolerances are relative: fp64 1e-12, fp32 1e-5, of
each vector's largest element, of the scalars, and of ``|A|·|p2|`` for the
partial (``|deq(A)|·|p2|`` for a payload: the JAX kernel forms
``s·Σ(q·p)`` per block, the port ``Σ fl(s·q)·p``).
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from matvec_mpi_multiplier_tpu.ops import quantize as jq
from matvec_mpi_multiplier_tpu.ops.pallas_solver import _fused_step, fused_tiles
from matvec_mpi_multiplier_torch.ops import cuda_solver
from matvec_mpi_multiplier_torch.ops import quantize as tq
from matvec_mpi_multiplier_torch.ops.cuda_quant import quant_gemv_plain
from matvec_mpi_multiplier_torch.ops.cuda_solver import solver_step_cuda, solver_step_plain
from matvec_mpi_multiplier_torch.utils.convert import from_numpy

N = 96
# (shard shape, column offset): a rowwise shard multiplies all of p, a
# colwise shard its third quarter.
LAYOUTS = {"rowwise": ((24, N), 0), "colwise": ((N, 24), 48)}
TOL = {"float32": 1e-5, "float64": 1e-12, "bfloat16": 1e-5}
NP_DTYPES = {"float32": np.float32, "float64": np.float64, "bfloat16": ml_dtypes.bfloat16}


def step_inputs(op: str, layout: str, dtype: str, seed: int = 0):
    """A seeded shard (both signs) and the step's vectors and scalars in the
    accumulator dtype. Chebyshev's step index is 0 for the rowwise layout
    and 3 for the colwise one, so both weights of the recurrence run."""
    rng = np.random.default_rng(seed)
    (m_loc, k_loc), off = LAYOUTS[layout]
    a = rng.uniform(-1, 1, (m_loc, k_loc)).astype(NP_DTYPES[dtype])
    acc = np.float64 if dtype == "float64" else np.float32
    x, r, p, ap = (rng.standard_normal(N).astype(acc) for _ in range(4))
    if op == "cg":
        s_in = np.array([np.sum(r.astype(np.float64) ** 2)], acc)
    else:
        lmin, lmax = 20.0, 60.0
        d, c2 = (lmax + lmin) / 2, ((lmax - lmin) / 2) ** 2
        s_in = np.array([1.0 / d, 0.0 if layout == "rowwise" else 3.0, d, c2], acc)
    return a, off, (x, r, p, ap, s_in)


def jax_step(op, leaves, off, vectors, *, quant=False, has_q2=False, block=None):
    m_loc, k_loc = leaves[0].shape
    bm, bk = fused_tiles(m_loc, k_loc, leaves[0].dtype.itemsize, on_tpu=False,
                         block=block)
    acc = vectors[0].dtype
    out = _fused_step(
        op, [jnp.asarray(leaf) for leaf in leaves], jnp.asarray(off, jnp.int32),
        *(jnp.asarray(v) for v in vectors), quant=quant, has_q2=has_q2,
        block=block or 1, bm=bm, bk=bk, n=N, m_loc=m_loc, acc=acc, interpret=True,
    )
    return [np.asarray(o) for o in out]


def port_step(op, a_local, off, vectors):
    t = [torch.from_numpy(v) for v in vectors]
    out = solver_step_plain(op, a_local, off, *t)
    # The wrapper takes the plain version for CPU tensors, bit for bit, and
    # counts no launch.
    before = solver_step_cuda.launches
    again = solver_step_cuda(op, a_local, off, *t)
    assert solver_step_cuda.launches == before
    assert all(torch.equal(u, v) for u, v in zip(out, again))
    return [o.numpy() for o in out]


def abs_leaf(leaf: torch.Tensor) -> torch.Tensor:
    """|payload| (e4m3's sign bit cleared); scales are >= 0 already."""
    if leaf.dtype == torch.float8_e4m3fn:
        return (leaf.view(torch.uint8) & 0x7F).view(leaf.dtype)
    return leaf.abs()


def assert_step_close(port, ref, tol, partial_scale):
    names = ("x2", "r2", "p2", "s_out", "partial")
    for name, got, want in zip(names[:4], port, ref):
        assert got.shape == want.shape and got.dtype == want.dtype, name
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol * np.abs(want).max(),
                                   err_msg=name)
    got, want = port[4], ref[4]
    assert got.shape == want.shape and got.dtype == want.dtype
    assert np.all(np.abs(got - want) <= tol * partial_scale), "partial"


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("dtype", ["float32", "float64", "bfloat16"])
@pytest.mark.parametrize("op", ["cg", "chebyshev"])
def test_plain_step_matches_jax_fused_step(op, dtype, layout):
    a, off, vectors = step_inputs(op, layout, dtype)
    ref = jax_step(op, [a], off, vectors)
    port = port_step(op, from_numpy(a, "cpu"), off, vectors)
    k_loc = a.shape[1]
    scale = np.abs(a.astype(np.float64)) @ np.abs(port[2][off:off + k_loc].astype(np.float64))
    assert_step_close(port, ref, TOL[dtype], scale)


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("fmt", ["int8", "int8c", "fp8"])
@pytest.mark.parametrize("op", ["cg", "chebyshev"])
def test_plain_step_matches_jax_fused_step_quantized(op, fmt, layout):
    a, off, vectors = step_inputs(op, layout, "float32", seed=1)
    block = 12  # two scale blocks per row of the 24-column shard
    qj = jq.quantize_matrix(a, fmt, block=block)
    qt = tq.quantize_matrix(from_numpy(a, "cpu"), fmt, block=block)
    leaves = [qj.q, qj.scales] + ([qj.q2, qj.scales2] if qj.q2 is not None else [])
    ref = jax_step(op, leaves, off, vectors, quant=True, has_q2=qj.q2 is not None,
                   block=block)
    port = port_step(op, qt, off, vectors)
    k_loc = a.shape[1]
    seg = torch.from_numpy(np.abs(port[2][off:off + k_loc]))
    scale = quant_gemv_plain(qt.map(abs_leaf), seg).numpy()
    assert_step_close(port, ref, 1e-5, scale)


def test_cg_breakdown_stalls_instead_of_dividing_by_zero():
    """pᵀAp = 0 (ap = 0): α and β are 0, so x, r and p come back unchanged
    and finite, as in the JAX package's update."""
    a, off, (x, r, p, _, s_in) = step_inputs("cg", "rowwise", "float64")
    ap = np.zeros_like(x)
    ref = jax_step("cg", [a], off, (x, r, p, ap, s_in))
    port = port_step("cg", torch.from_numpy(a), off, (x, r, p, ap, s_in))
    for got, want, orig in zip(port[:3], ref[:3], (x, r, r)):
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, orig)


def test_step_wrapper_rejects_what_the_kernel_does_not_take():
    a, off, vectors = step_inputs("cg", "colwise", "float32")
    at = torch.from_numpy(a)
    x, r, p, ap, s_in = (torch.from_numpy(v) for v in vectors)
    cases = [
        ("gmres", at, off, x, r, p, ap, s_in),                    # not a fused op
        ("cg", at, off, x.double(), r, p, ap, s_in),              # not the accumulator
        ("cg", at, off, x[:-1], r, p, ap, s_in),                  # vectors of two lengths
        ("cg", at, off, x, r, p, ap, torch.zeros(4)),             # cg takes [rz]
        ("cg", at, N - 10, x, r, p, ap, s_in),                    # segment past the end
        ("cg", at.t().contiguous().t(), off, x, r, p, ap, s_in),  # not contiguous
        ("cg", at, off, x, r, p, ap, s_in.to("meta")),            # two devices
    ]
    for args in cases:
        with pytest.raises(ValueError):
            solver_step_cuda(*args)


def test_fused_ops_and_typed_errors_are_the_jax_packages():
    from matvec_mpi_multiplier_tpu.ops import pallas_solver
    from matvec_mpi_multiplier_tpu.utils.errors import ConfigError as JaxConfigError
    from matvec_mpi_multiplier_tpu.utils.errors import ShardingError as JaxShardingError
    from matvec_mpi_multiplier_torch.utils.errors import ConfigError, ShardingError

    # The tiers' names, and the word for what the fused body does per
    # iteration (it "lowers" one hop in JAX, "runs" one in the port).
    tiers = {"'pallas_fused'": "'cuda_fused'", "'xla'": "'torch'", " lowers ": " runs "}
    assert cuda_solver.FUSED_SOLVER_OPS == pallas_solver.FUSED_SOLVER_OPS
    for op, strategy, combine in [("gmres", "rowwise", None), ("cg", "blockwise", None),
                                  ("cg", "colwise", "ring"), ("chebyshev", "rowwise", "psum"),
                                  ("cg", "rowwise", "auto"), ("chebyshev", "colwise", "psum")]:
        try:
            want = pallas_solver.check_fused_solver(op, strategy, combine, None)
        except (JaxConfigError, JaxShardingError) as e:
            port_type = ConfigError if isinstance(e, JaxConfigError) else ShardingError
            with pytest.raises(port_type) as got:
                cuda_solver.check_fused_solver(op, strategy, combine, None)
            message = str(e)
            for jax_name, port_name in tiers.items():
                message = message.replace(jax_name, port_name)
            assert str(got.value) == message
            assert not cuda_solver.fused_solver_supported(op, strategy, combine, None)
        else:
            assert cuda_solver.check_fused_solver(op, strategy, combine, None) == want
            assert cuda_solver.fused_solver_supported(op, strategy, combine, None)
