"""The port's ring and Ulysses attention against the JAX package's.

The same seeded numpy q, k, v go through ``matvec_mpi_multiplier_tpu``'s
``build_ring_attention``/``build_ulysses_attention`` on the conftest's CPU
mesh (the flash tier's Pallas kernel in interpret mode, as the JAX
package's own tests run it) and through the port's builders on
``[torch.device("cpu")] * p`` logical shards, where the flash tier's kernel
wrapper computes its plain version. Shapes and tolerances are the JAX
tests' (``tests/test_attention.py``): fp32 xla 2e-5 and flash 2e-4 against
JAX and the dense fp64 oracle, bf16 storage 2e-2, the first causal row 1e-6,
gradients 1e-4. JAX's flash tier is called at h ≤ 2, s ≤ 512, d = 128.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import matvec_mpi_multiplier_tpu as mv_jax
from matvec_mpi_multiplier_tpu.ops.pallas_attention import (
    flash_path_available as jax_flash_path_available,
)
from matvec_mpi_multiplier_tpu.parallel import attention as jatt
from matvec_mpi_multiplier_torch import build_ring_attention, build_ulysses_attention
from matvec_mpi_multiplier_torch.bench import attention as study
from matvec_mpi_multiplier_torch.parallel import attention as tatt
from matvec_mpi_multiplier_torch.parallel.mesh import ShardedTensor, make_mesh, unshard

CPU = torch.device("cpu")
BUILDERS = {"ring": (jatt.build_ring_attention, build_ring_attention),
            "ulysses": (jatt.build_ulysses_attention, build_ulysses_attention)}


def dense(q, k, v, causal=False):
    """The fp64 numpy oracle of one head ((s, d) in)."""
    d, s = q.shape[-1], q.shape[0]
    scores = (q.astype(np.float64) @ k.astype(np.float64).T) / np.sqrt(d)
    if causal:
        scores = np.where(np.tril(np.ones((s, s), bool)), scores, -np.inf)
    w = np.exp(scores - scores.max(axis=1, keepdims=True))
    return (w / w.sum(axis=1, keepdims=True)) @ v.astype(np.float64)


def inputs(shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


def run_both(schedule, p, qkv, *, causal, kernel, dtype=jnp.float32):
    """(JAX output, port output) as numpy, gathered."""
    jbuild, tbuild = BUILDERS[schedule]
    jq = [jnp.asarray(x, dtype) for x in qkv]
    want = np.asarray(jbuild(mv_jax.make_mesh(p), causal=causal, gather_output=True,
                             kernel=kernel)(*jq))
    tq = [torch.from_numpy(np.array(x.astype(jnp.float32))).to(
        torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32) for x in jq]
    got = tbuild(make_mesh(p, devices=[CPU] * p), causal=causal, gather_output=True,
                 kernel=kernel)(*tq)
    return want, got.numpy()


def per_head_oracle(qkv, causal):
    q, k, v = qkv
    if q.ndim == 2:
        return dense(q, k, v, causal)
    return np.stack([dense(q[:, i], k[:, i], v[:, i], causal)
                     for i in range(q.shape[1])], axis=1)


# ------------------------------------------------------------ ring


@pytest.mark.parametrize("p", [1, 2, 4, 8])
@pytest.mark.parametrize("causal", [False, True])
def test_ring_single_head_matches_jax(devices, p, causal):
    qkv = inputs((64, 16), seed=p)
    want, got = run_both("ring", p, qkv, causal=causal, kernel="xla")
    assert got.shape == (64, 16) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got, per_head_oracle(qkv, causal), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("kernel", ["xla", "flash"])
@pytest.mark.parametrize("causal", [False, True])
def test_ring_multihead_matches_jax(devices, causal, kernel):
    """h = 4, d_head = 8 on 8 shards: the JAX package's flash tier takes its
    fallback (d_head is no multiple of 128); the port's runs its kernel's
    plain version, as on every CPU tensor."""
    qkv = inputs((64, 4, 8), seed=11)
    want, got = run_both("ring", 8, qkv, causal=causal, kernel=kernel)
    assert got.shape == (64, 4, 8)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got, per_head_oracle(qkv, causal), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("p", [1, 2, 4])
@pytest.mark.parametrize("causal", [False, True])
def test_ring_flash_tier_matches_jax_and_xla(devices, p, causal):
    """s = 512, h = 2, d_head = 128: every hop's (512/p)-row block takes the
    flash path in both packages."""
    qkv = inputs((512, 2, 128), seed=20 + p)
    assert jax_flash_path_available(512 // p, 512 // p, 128)
    want, got = run_both("ring", p, qkv, causal=causal, kernel="flash")
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    xla = build_ring_attention(make_mesh(p, devices=[CPU] * p), causal=causal,
                               gather_output=True)(*map(torch.from_numpy, qkv))
    np.testing.assert_allclose(got, xla.numpy(), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got, per_head_oracle(qkv, causal), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("kernel", ["xla", "flash"])
@pytest.mark.parametrize("schedule", ["ring", "ulysses"])
def test_bf16_storage_fp32_statistics(devices, schedule, kernel):
    """bf16 q, k, v with fp32 statistics: fp32 out, within 2e-2 of the
    oracle on the bf16-rounded inputs, and of JAX."""
    qkv = inputs((256, 2, 128), seed=30)
    rounded = [np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32) for x in qkv]
    want, got = run_both(schedule, 2, qkv, causal=True, kernel=kernel, dtype=jnp.bfloat16)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, per_head_oracle(rounded, True), rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_ring_causal_first_row_is_v0(devices):
    """Position 0 attends only itself: its output is v[0]."""
    q, k, v = inputs((32, 8), seed=40)
    o = build_ring_attention(make_mesh(8, devices=[CPU] * 8), causal=True,
                             gather_output=True)(*map(torch.from_numpy, (q, k, v)))
    np.testing.assert_allclose(o[0].numpy(), v[0], rtol=1e-6)


@pytest.mark.parametrize("schedule", ["ring", "ulysses"])
def test_output_stays_sequence_sharded(schedule):
    """gather_output=False: a ShardedTensor of (s/p, h, d) blocks on the
    mesh's devices, which unshards to the gathered output."""
    mesh = make_mesh(4, devices=[CPU] * 4)
    q, k, v = map(torch.from_numpy, inputs((64, 4, 8), seed=41))
    out = BUILDERS[schedule][1](mesh, causal=True)(q, k, v)
    assert isinstance(out, ShardedTensor)
    assert out.shape == (64, 4, 8) and out.spec == (mesh.axis_names,)
    assert [tuple(s.shape) for s in out.shards] == [(16, 4, 8)] * 4
    gathered = BUILDERS[schedule][1](mesh, causal=True, gather_output=True)(q, k, v)
    assert torch.equal(unshard(out), gathered)


@pytest.mark.parametrize("schedule", ["ring", "ulysses"])
def test_indivisible_sequence_raises(devices, schedule):
    q = np.zeros((30, 8, 4), np.float32)
    jbuild, tbuild = BUILDERS[schedule]
    with pytest.raises(ValueError, match="not divisible"):
        jbuild(mv_jax.make_mesh(8))(q, q, q)
    with pytest.raises(ValueError, match="not divisible"):
        tbuild(make_mesh(8, devices=[CPU] * 8))(*[torch.from_numpy(q)] * 3)


@pytest.mark.parametrize("schedule", ["ring", "ulysses"])
def test_unknown_kernel_rejected(schedule):
    with pytest.raises(ValueError, match="unknown attention kernel"):
        BUILDERS[schedule][1](make_mesh(2, devices=[CPU] * 2), kernel="bogus")
    assert tatt.ATTENTION_KERNELS == jatt.ATTENTION_KERNELS


# ------------------------------------------------------------ Ulysses


@pytest.mark.parametrize("p", [1, 2, 8])
@pytest.mark.parametrize("causal", [False, True])
def test_ulysses_matches_jax(devices, p, causal):
    qkv = inputs((64, 8, 4), seed=50 + p)
    want, got = run_both("ulysses", p, qkv, causal=causal, kernel="xla")
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got, per_head_oracle(qkv, causal), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("p", [1, 2])
@pytest.mark.parametrize("causal", [False, True])
def test_ulysses_flash_tier_matches_jax_and_xla(devices, p, causal):
    qkv = inputs((512, 2, 128), seed=60 + p)
    want, got = run_both("ulysses", p, qkv, causal=causal, kernel="flash")
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    xla = build_ulysses_attention(make_mesh(p, devices=[CPU] * p), causal=causal,
                                  gather_output=True)(*map(torch.from_numpy, qkv))
    np.testing.assert_allclose(got, xla.numpy(), rtol=2e-4, atol=2e-4)


def test_ulysses_matches_ring_per_head():
    q, k, v = map(torch.from_numpy, inputs((64, 8, 4), seed=70))
    mesh = make_mesh(8, devices=[CPU] * 8)
    ou = build_ulysses_attention(mesh, causal=True, gather_output=True)(q, k, v)
    ring = build_ring_attention(mesh, causal=True, gather_output=True)
    for head in range(8):
        orr = ring(q[:, head], k[:, head], v[:, head])
        np.testing.assert_allclose(ou[:, head].numpy(), orr.numpy(), rtol=2e-5, atol=2e-5)


def test_ulysses_rejects_indivisible_heads(devices):
    q = np.zeros((64, 6, 4), np.float32)
    with pytest.raises(ValueError, match="heads"):
        jatt.build_ulysses_attention(mv_jax.make_mesh(8))(q, q, q)
    mesh = make_mesh(8, devices=[CPU] * 8)
    with pytest.raises(ValueError, match="6 heads not divisible by 8"):
        build_ulysses_attention(mesh)(*[torch.from_numpy(q)] * 3)
    blocks = [torch.zeros(8, 6, 4)] * 8
    with pytest.raises(ValueError, match="ulysses_attention: 6 heads not divisible by 8"):
        tatt.ulysses_attention(blocks, blocks, blocks, mesh, mesh.axis_names)


@pytest.mark.parametrize("p", [1, 2, 4])
def test_ulysses_rejects_rank2_inputs(devices, p):
    """An (s, d) input has no heads to cut: the JAX package's unpacking
    raises ValueError, and so does the port, in build_ulysses_attention and
    ulysses_attention, for every p (before, the port took d as the head
    count and returned a tensor that was not attention)."""
    q = np.random.default_rng(5).standard_normal((24, 16)).astype(np.float32)
    with pytest.raises(ValueError):
        jatt.build_ulysses_attention(mv_jax.make_mesh(p))(q, q, q)
    mesh = make_mesh(p, devices=[CPU] * p)
    for kernel in ("xla", "flash"):
        with pytest.raises(ValueError, match="needs \\(s, h, d_head\\)"):
            build_ulysses_attention(mesh, kernel=kernel)(*[torch.from_numpy(q)] * 3)
    blocks = list(torch.from_numpy(q).chunk(p))
    with pytest.raises(ValueError, match="needs \\(s, h, d_head\\)"):
        tatt.ulysses_attention(blocks, blocks, blocks, mesh, mesh.axis_names)


def test_ulysses_single_shard_skips_the_exchange(monkeypatch):
    """p == 1: plain local attention, no all_to_all."""
    monkeypatch.setattr(tatt, "all_to_all", lambda *a, **kw: pytest.fail("exchanged"))
    q, k, v = map(torch.from_numpy, inputs((64, 6, 4), seed=71))
    o = build_ulysses_attention(make_mesh(1, devices=[CPU]), causal=True,
                                gather_output=True)(q, k, v)
    np.testing.assert_allclose(o.numpy(), per_head_oracle([x.numpy() for x in (q, k, v)], True),
                               rtol=2e-5, atol=2e-5)


# ------------------------------------------------------------ gradients


def _torch_grads(fn, qkv):
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in qkv]
    return torch.autograd.grad((fn(*leaves) ** 2).sum(), leaves)


def _jax_grads(fn, qkv):
    return jax.grad(lambda a, b, c: jnp.sum(fn(a, b, c) ** 2), argnums=(0, 1, 2))(
        *map(jnp.asarray, qkv))


@pytest.mark.parametrize("kernel", ["xla", "flash"])
@pytest.mark.parametrize("schedule", ["ring", "ulysses"])
def test_gradients_match_jax_and_dense(devices, schedule, kernel):
    """torch.autograd.grad of sum(o²) through both schedules against
    jax.grad of the same JAX builder and against the dense oracle's
    gradient (tests/test_attention.py:349-415), at 1e-4."""
    s, h, dh = 64, 8, 16
    qkv = inputs((s, h, dh), seed=80)
    jbuild, tbuild = BUILDERS[schedule]
    got = _torch_grads(tbuild(make_mesh(8, devices=[CPU] * 8), causal=True,
                              gather_output=True, kernel=kernel), qkv)
    want = _jax_grads(jbuild(mv_jax.make_mesh(8), causal=True, gather_output=True,
                             kernel=kernel), qkv)

    def dense_loss(q, k, v):
        sc = torch.einsum("qhd,khd->hqk", q, k) / dh ** 0.5
        r = torch.arange(s)
        sc = torch.where((r[None, :] <= r[:, None])[None], sc, -torch.inf)
        return (torch.einsum("hqk,khd->qhd", torch.softmax(sc, -1), v) ** 2).sum()

    leaves = [torch.from_numpy(x).requires_grad_(True) for x in qkv]
    oracle = torch.autograd.grad(dense_loss(*leaves), leaves)
    for g, w, o in zip(got, want, oracle):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(g.numpy(), o.numpy(), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("schedule,p", [("ring", 4), ("ulysses", 2)])
def test_flash_tier_gradients_match_jax(devices, schedule, p):
    """The flash tier's custom backward (kernel forward, plain recompute)
    against jax.grad through JAX's flash tier and the port's xla tier, at
    h = 2, s = 512, d_head = 128: the kernel path runs forward."""
    qkv = inputs((512, 2, 128), seed=90)
    jbuild, tbuild = BUILDERS[schedule]
    mesh = make_mesh(p, devices=[CPU] * p)
    got = _torch_grads(tbuild(mesh, causal=True, gather_output=True, kernel="flash"), qkv)
    want = _jax_grads(jbuild(mv_jax.make_mesh(p), causal=True, gather_output=True,
                             kernel="flash"), qkv)
    xla = _torch_grads(tbuild(mesh, causal=True, gather_output=True), qkv)
    for g, w, x in zip(got, want, xla):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(g.numpy(), x.numpy(), rtol=1e-4, atol=1e-4)


# ------------------------------------------------------------ the wire


@pytest.mark.parametrize("kernel", ["xla", "flash"])
def test_ring_kv_circulates_in_storage_dtype(monkeypatch, kernel):
    """bf16 K and V ride the ring as bf16: every block handed to ppermute."""
    seen = []
    real = tatt.ppermute

    def recording(blocks, *args):
        seen.extend(b.dtype for b in blocks)
        return real(blocks, *args)

    monkeypatch.setattr(tatt, "ppermute", recording)
    q = torch.zeros(256, 8, 16, dtype=torch.bfloat16)
    build_ring_attention(make_mesh(8, devices=[CPU] * 8), causal=True, kernel=kernel)(q, q, q)
    assert len(seen) == 2 * 7 * 8 and set(seen) == {torch.bfloat16}


@pytest.mark.parametrize("kernel", ["xla", "flash"])
def test_ulysses_forward_exchange_in_storage_dtype(monkeypatch, kernel):
    """Ulysses' three forward exchanges carry bf16, the return leg the fp32
    output, in that order."""
    seen = []
    real = tatt.all_to_all

    def recording(blocks, *args, **kw):
        seen.append({b.dtype for b in blocks})
        return real(blocks, *args, **kw)

    monkeypatch.setattr(tatt, "all_to_all", recording)
    q = torch.zeros(256, 8, 16, dtype=torch.bfloat16)
    build_ulysses_attention(make_mesh(8, devices=[CPU] * 8), causal=True, kernel=kernel)(q, q, q)
    assert seen == [{torch.bfloat16}] * 3 + [{torch.float32}]


# ------------------------------------------------------------ the study


def _jax_flash_fallbacks(s, n_dev, dh):
    """scripts/attention_study.py::flash_fallbacks, with JAX's predicate."""
    out = set()
    if not jax_flash_path_available(s // n_dev, s // n_dev, dh):
        out.add("ring_flash")
    if not jax_flash_path_available(s, s, dh):
        out.add("ulysses_flash")
    return out


@pytest.mark.parametrize("d_head", [128, 16])
def test_attention_study_on_cpu_shards(d_head):
    mesh = make_mesh(4, devices=[CPU] * 4)
    rows = study.run_attention_study(mesh, [256], heads=4, d_head=d_head,
                                     dtype="float32", causal=True, n_reps=2, samples=3)
    (row,) = rows
    assert row["s"] == 256
    assert row["refused"] == _jax_flash_fallbacks(256, 4, d_head)
    for col in study.COLUMNS:
        assert row[col]["ms"] > 0 and row[col]["gflops"] > 0
    table = study.report(rows, mesh, heads=4, d_head=d_head, dtype="float32",
                         causal=True, n_reps=2)
    line = table.splitlines()[-1]
    assert line.count("†") == len(row["refused"])
    assert ("†" in line.split("|")[4]) == ("ring_flash" in row["refused"])


def test_attention_study_cli(tmp_path, capsys, monkeypatch):
    monkeypatch.chdir(tmp_path)
    argv = ["--platform", "cpu", "--host-devices", "2", "--seqs", "128", "--heads", "2",
            "--d-head", "16", "--dtype", "float32", "--n-reps", "2"]
    assert study.main(argv) == 0
    assert "| 128 |" in capsys.readouterr().out
    assert list(tmp_path.iterdir()) == []
    assert study.main(argv + ["--report", str(tmp_path / "a.md")]) == 0
    assert "| 128 |" in (tmp_path / "a.md").read_text()
