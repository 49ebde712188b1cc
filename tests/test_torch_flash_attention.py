"""The port's flash-attention partial against the JAX package's.

``ops/attention.py`` (the predicate, the plain partial, ``merge_partials``
and ``flash_block_partial``) meets ``ops/pallas_attention.py`` on the same
seeded numpy inputs: the JAX partial through its Pallas kernel in interpret
mode, as the JAX package's own tests run it on the CPU, at its test shapes.
Tolerances are the JAX tests': the partial 2e-5, ``merge_partials`` against
one block m 1e-6, l and o 1e-5, gradients 1e-4.

``ops/cuda_attention.py::flash_partial_cuda`` computes its plain version for
CPU tensors; the kernel itself runs only on the card, in the ``cuda``-marked
test (skipped here) and in ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matvec_mpi_multiplier_tpu.ops import pallas_attention as jpa
from matvec_mpi_multiplier_torch.ops import attention as tpa
from matvec_mpi_multiplier_torch.ops import _build, cuda_attention
from matvec_mpi_multiplier_torch.ops.cuda_attention import (
    flash_partial_cuda,
    flash_partial_plain,
)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def operands(shape_q, shape_kv, seed, dtype="float32"):
    """q (fp32) and k, v (in ``dtype``) for both packages, from one seed:
    bf16 values are rounded once, in JAX, and handed to torch exactly."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal(shape_q).astype(np.float32)
    k, v = (rng.standard_normal(shape_kv).astype(np.float32) for _ in range(2))
    jdt, tdt = DTYPES[dtype]
    jk, jv = jnp.asarray(k, jdt), jnp.asarray(v, jdt)
    tk, tv = (torch.from_numpy(np.array(x.astype(jnp.float32))).to(tdt) for x in (jk, jv))
    return (jnp.asarray(q), jk, jv), (torch.from_numpy(q), tk, tv)


def positions(sq, sk, q_off=0, k_off=0):
    jq = jnp.arange(sq, dtype=jnp.int32) + q_off
    jk = jnp.arange(sk, dtype=jnp.int32) + k_off
    return (jq, jk), (torch.from_numpy(np.array(jq)), torch.from_numpy(np.array(jk)))


def close(got, want, tol):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), rtol=tol, atol=tol)


# ------------------------------------------------------------ the predicate


@pytest.mark.parametrize("sq,sk,d,want", [
    (128, 128, 128, True), (8, 256, 128, True), (64, 64, 128, False),
    (128, 128, 64, False), (30, 128, 128, False),
])
def test_flash_path_available_cases(sq, sk, d, want):
    """tests/test_attention.py::test_flash_path_available_predicate's cases."""
    assert tpa.flash_path_available(sq, sk, d) is want
    assert jpa.flash_path_available(sq, sk, d) is want


@pytest.mark.parametrize("seed", range(4))
def test_flash_path_available_matches_jax_on_a_sweep(seed):
    rng = np.random.default_rng(seed)
    for _ in range(200):
        sq, sk = (int(x) for x in rng.integers(1, 2400, size=2))
        d = int(rng.choice([16, 64, 128, 200, 256, 384, 512]))
        bq, bk = (int(x) for x in rng.choice([64, 128, 256, 512, 1024], size=2))
        assert tpa.flash_path_available(sq, sk, d, bq=bq, bk=bk) == \
            jpa.flash_path_available(sq, sk, d, bq=bq, bk=bk), (sq, sk, d, bq, bk)
        assert tpa._largest_divisor_leq(sq, bq, 8) == \
            jpa._largest_divisor_leq(sq, bq, 8)


# ------------------------------------------------------------ the partial


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("causal", [False, True])
def test_partial_matches_jax(causal, dtype):
    """The plain partial and flash_block_partial against JAX's
    _reference_partial and flash_block_partial (Pallas, interpret mode),
    with offset q positions: the ring's cross-shard case."""
    (jq, jk, jv), (tq, tk, tv) = operands((2, 256, 128), (2, 512, 128), 1, dtype)
    (jqp, jkp), (tqp, tkp) = positions(256, 512, q_off=96)
    want = jpa._reference_partial(jq, jk, jv, jqp, jkp, causal=causal)
    close(tpa.reference_partial(tq, tk, tv, tqp, tkp, causal=causal), want, 2e-5)
    want_kernel = jpa.flash_block_partial(jq, jk, jv, jqp, jkp, causal=causal,
                                          bq=128, bk=128)
    got = tpa.flash_block_partial(tq, tk, tv, tqp, tkp, causal=causal)
    close(got, want_kernel, 2e-5)
    close(got, want, 2e-5)


def test_partial_fully_masked_rows():
    """Rows whose every key is causally masked come back as an empty partial
    (m = -inf, l = 0, finite o), not NaN, in both packages."""
    (jq, jk, jv), (tq, tk, tv) = operands((1, 128, 128), (1, 128, 128), 2)
    (jqp, jkp), (tqp, tkp) = positions(128, 128, k_off=1000)
    o, m, l = tpa.flash_block_partial(tq, tk, tv, tqp, tkp, causal=True)
    assert torch.all(l == 0) and torch.all(torch.isneginf(m))
    assert not torch.any(torch.isnan(o))
    want = jpa.flash_block_partial(jq, jk, jv, jqp, jkp, causal=True, bq=128, bk=128)
    for g, w in zip((o, m, l), want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("shape_q,shape_kv", [
    ((2, 64, 16), (2, 64, 16)),      # d_head no multiple of 128
    ((1, 64, 128), (1, 1000, 128)),  # sk without a multiple-of-128 divisor
    ((2, 30, 128), (2, 128, 128)),   # sq without a multiple-of-8 divisor
])
def test_partial_where_the_predicate_fails_matches_jax(shape_q, shape_kv):
    """Where JAX's predicate refuses the block, JAX runs its plain partial
    and the port (on CPU tensors) its kernel's plain version: the same
    partial at 2e-5."""
    (jq, jk, jv), (tq, tk, tv) = operands(shape_q, shape_kv, 3)
    (jqp, jkp), (tqp, tkp) = positions(shape_q[1], shape_kv[1], q_off=shape_kv[1] // 2)
    assert not tpa.flash_path_available(shape_q[1], shape_kv[1], shape_q[2])
    got = tpa.flash_block_partial(tq, tk, tv, tqp, tkp, causal=True)
    close(got, jpa.flash_block_partial(jq, jk, jv, jqp, jkp, causal=True), 2e-5)


@pytest.mark.parametrize("sq,sk", [(64, 1000), (30, 128), (200, 384)])
def test_partial_on_a_non_cpu_tensor_runs_the_kernel_whatever_the_predicate(
        monkeypatch, sq, sk):
    """On a tensor off the CPU every block goes to the kernel's wrapper,
    also where JAX's predicate refuses it; the plain partial never runs."""
    calls = []

    def kernel(q, k, v, q_pos, k_pos, causal):
        calls.append((tuple(q.shape), tuple(k.shape), causal))
        h, n, d = q.shape
        return torch.empty(h, n, d, device="meta"), *(torch.empty(h, n, device="meta"),) * 2

    monkeypatch.setattr(cuda_attention, "flash_partial_cuda", kernel)
    monkeypatch.setattr(tpa, "reference_partial", lambda *a, **k: pytest.fail("plain ran"))
    q, kv = torch.ones(2, sq, 128, device="meta"), torch.ones(2, sk, 128, device="meta")
    pos = [torch.zeros(n, dtype=torch.int32, device="meta") for n in (sq, sk)]
    o, m, l = tpa.flash_block_partial(q, kv, kv, *pos, causal=True)
    assert calls == [((2, sq, 128), (2, sk, 128), True)]
    assert o.shape == (2, sq, 128) and m.shape == l.shape == (2, sq)


def test_partial_on_a_non_cpu_tensor_raises_for_a_head_dim_the_kernel_refuses(
        monkeypatch):
    """Off the CPU, an empty head dim (the one d the kernel refuses) raises
    before any build, and d_head 16, which the wrapper pads to the kernel's
    128, goes to the kernel (its build): nothing computes the plain partial
    either way."""
    class Built(Exception):
        pass

    def build():
        raise Built

    monkeypatch.setattr(_build, "load_library", build)
    for module, plain in ((tpa, "reference_partial"),
                          (cuda_attention, "flash_partial_plain")):
        monkeypatch.setattr(module, plain, lambda *a, **k: pytest.fail("plain ran"))
    pos = torch.zeros(64, dtype=torch.int32, device="meta")
    q = torch.ones(2, 64, 0, device="meta")
    with pytest.raises(ValueError, match="sq, sk, d >= 1"):
        tpa.flash_block_partial(q, q, q, pos, pos, causal=True)
    q = torch.ones(2, 64, 16, device="meta")
    with pytest.raises(Built):
        tpa.flash_block_partial(q, q, q, pos, pos, causal=True)


def test_merge_partials_matches_single_block():
    """Splitting the key axis and merging the two partials equals the
    one-shot partial over the whole block, and JAX's merge."""
    (jq, jk, jv), (tq, tk, tv) = operands((2, 32, 16), (2, 64, 16), 4)
    (jqp, jkp), (tqp, tkp) = positions(32, 64, q_off=16)
    o_full, m_full, l_full = tpa.reference_partial(tq, tk, tv, tqp, tkp, causal=True)
    p1 = tpa.reference_partial(tq, tk[:, :32], tv[:, :32], tqp, tkp[:32], causal=True)
    p2 = tpa.reference_partial(tq, tk[:, 32:], tv[:, 32:], tqp, tkp[32:], causal=True)
    o, m, l = tpa.merge_partials(p1, p2)
    np.testing.assert_allclose(m.numpy(), m_full.numpy(), rtol=1e-6)
    np.testing.assert_allclose(l.numpy(), l_full.numpy(), rtol=1e-5)
    np.testing.assert_allclose(o.numpy(), o_full.numpy(), rtol=1e-5, atol=1e-5)
    j1 = jpa._reference_partial(jq, jk[:, :32], jv[:, :32], jqp, jkp[:32], causal=True)
    j2 = jpa._reference_partial(jq, jk[:, 32:], jv[:, 32:], jqp, jkp[32:], causal=True)
    close((o, m, l), jpa.merge_partials(j1, j2), 1e-5)


def test_merge_partials_of_empty_partials_stays_empty():
    """Two fully masked partials merge to an empty one without NaN."""
    empty = (torch.zeros(1, 4, 8), torch.full((1, 4), -torch.inf), torch.zeros(1, 4))
    o, m, l = tpa.merge_partials(empty, empty)
    assert torch.all(torch.isneginf(m)) and torch.all(l == 0) and torch.all(o == 0)


@pytest.mark.parametrize("d,causal", [(128, True), (128, False), (16, True)])
def test_partial_gradients_match_jax(d, causal):
    """torch.autograd.grad through flash_block_partial (the custom backward)
    against jax.grad through JAX's (its custom VJP at d = 128, native
    autodiff of its fallback at 16), at 1e-4."""
    (jq, jk, jv), (tq, tk, tv) = operands((1, 128, d), (1, 256, d), 5)
    (jqp, jkp), (tqp, tkp) = positions(128, 256, q_off=64)
    rng = np.random.default_rng(6)
    w_o = rng.standard_normal((1, 128, d)).astype(np.float32)
    w_l = rng.standard_normal((1, 128)).astype(np.float32)

    def jloss(q, k, v):
        o, _, l = jpa.flash_block_partial(q, k, v, jqp, jkp, causal=causal, bq=128, bk=128)
        return jnp.sum(o * w_o) + jnp.sum(l * w_l)

    want = jax.grad(jloss, argnums=(0, 1, 2))(jq, jk, jv)
    leaves = [x.clone().requires_grad_(True) for x in (tq, tk, tv)]
    o, _, l = tpa.flash_block_partial(*leaves, tqp, tkp, causal=causal)
    loss = (o * torch.from_numpy(w_o)).sum() + (l * torch.from_numpy(w_l)).sum()
    close(torch.autograd.grad(loss, leaves), want, 1e-4)


def test_partial_gradient_skips_inputs_without_grad():
    """Only q needs a gradient: the backward computes it and nothing else."""
    _, (tq, tk, tv) = operands((1, 64, 128), (1, 128, 128), 7)
    _, (tqp, tkp) = positions(64, 128)
    q = tq.clone().requires_grad_(True)
    o, m, l = tpa.flash_block_partial(q, tk, tv, tqp, tkp, causal=True)
    (dq,) = torch.autograd.grad(o.sum() + l.sum(), (q,))
    ref_q = tq.clone().requires_grad_(True)
    ro, _, rl = tpa.reference_partial(ref_q, tk, tv, tqp, tkp, causal=True)
    (want,) = torch.autograd.grad(ro.sum() + rl.sum(), (ref_q,))
    torch.testing.assert_close(dq, want, rtol=0, atol=0)


# ------------------------------------------------------------ the kernel module


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_flash_partial_cuda_on_cpu_is_the_plain_version(dtype):
    _, (tq, tk, tv) = operands((2, 64, 128), (2, 128, 128), 8, dtype)
    _, (tqp, tkp) = positions(64, 128, q_off=32)
    before = flash_partial_cuda.launches
    got = flash_partial_cuda(tq, tk, tv, tqp, tkp, True)
    want = flash_partial_plain(tq, tk, tv, tqp, tkp, causal=True)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert flash_partial_cuda.launches == before
    exact = tpa.reference_partial(tq, tk, tv, tqp, tkp, causal=True, sum_dtype=torch.float64)
    assert all(torch.equal(g, w) for g, w in zip(want, exact))
    close(want, tpa.reference_partial(tq, tk, tv, tqp, tkp, causal=True), 2e-5)


def test_flash_partial_cuda_rejects_bad_operands():
    q, k = torch.zeros(2, 8, 128), torch.zeros(2, 16, 128)
    qp, kp = torch.arange(8, dtype=torch.int32), torch.arange(16, dtype=torch.int32)
    with pytest.raises(ValueError, match="q \\(h, sq, d\\)"):
        flash_partial_cuda(q[0], k, k, qp, kp, False)
    with pytest.raises(ValueError, match="heads or head dim"):
        flash_partial_cuda(q, k[:1], k[:1], qp, kp, False)
    with pytest.raises(ValueError, match="q_pos"):
        flash_partial_cuda(q, k, k, kp, kp, False)
    with pytest.raises(ValueError, match="one dtype"):
        flash_partial_cuda(q, k, k.bfloat16(), qp, kp, False)
    with pytest.raises(ValueError, match="float q"):
        flash_partial_cuda(q, k.int(), k.int(), qp, kp, False)


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run `python -m pytest -m cuda "
                    "tests/test_torch_flash_attention.py` on the chip")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 256, 512, 128), (2, 200, 384, 128),
                                   (2, 256, 256, 256), (1, 64, 1000, 128)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_kernel_matches_plain_on_card(card, shape, dtype, causal):
    """The kernel against its plain version at 2e-5, bitwise repeatable:
    JAX's test shape, sq = 8·25 (a ragged q-tile), d = 256 and sk = 1000
    (a ragged KV tile, refused by JAX's predicate)."""
    h, sq, sk, d = shape
    gen = torch.Generator(device=card).manual_seed(sq)
    q = torch.randn((h, sq, d), generator=gen, device=card) / d ** 0.5
    k, v = (torch.randn((h, sk, d), generator=gen, device=card).to(dtype) for _ in range(2))
    qp = torch.arange(sq, dtype=torch.int32, device=card) + 96
    kp = torch.arange(sk, dtype=torch.int32, device=card)
    before = flash_partial_cuda.launches
    a, b = flash_partial_cuda(q, k, v, qp, kp, causal), flash_partial_cuda(q, k, v, qp, kp, causal)
    want = flash_partial_plain(q, k, v, qp, kp, causal=causal)
    torch.cuda.synchronize(card)
    assert flash_partial_cuda.launches == before + 2
    for x, y, w in zip(a, b, want):
        assert torch.equal(x, y)
        torch.testing.assert_close(x, w, rtol=2e-5, atol=2e-5)
