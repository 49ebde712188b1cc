"""The flash partial's route plan (``ops/cuda_attention.py::flash_route``),
the arithmetic of its ``wgmma_split`` route, and, on a card, the routes
against the plain version.

The plan is a pure function of k's dtype and the head dim, so the CPU
reads it. The ``wgmma_split`` route runs both products on the bf16 tensor
cores with q and the softmax weights P split into three bf16 parts; the
kernel cannot run here, so :func:`emulate_split_route` repeats its
arithmetic in plain PyTorch (the parts, each pass summed in fp32, a fresh
P·V partial per 64-key tile, fp64 merges) and holds it to the kernel's bar,
rtol = atol = 2e-5 of ``flash_partial_plain``. Two parts of either operand
miss that bar: the reason for three. The tests marked ``cuda`` hold the
kernel itself (route, bitwise row slices) and skip without a card. This
file imports no JAX, so on a machine with a card and no JAX they run alone:
``python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_flash_route.py``.
"""

import numpy as np
import pytest
import torch

from matvec_mpi_multiplier_torch.ops.cuda_attention import (
    flash_partial_cuda,
    flash_partial_plain,
    flash_route,
    pad_head_dim,
    padded_head_dim,
)

TOL = 2e-5  # rtol = atol: the kernel's bar against the exact partial
TILE = 64   # keys per KV tile, as the kernel


def split_bf16(x: torch.Tensor, parts: int) -> list[torch.Tensor]:
    """fp32 ``x`` as ``parts`` fp32 tensors of bf16 values, largest first:
    each is the bf16 rounding of what the ones before it leave."""
    out, rest = [], x.float()
    for _ in range(parts):
        part = rest.to(torch.bfloat16).float()
        out.append(part)
        rest = rest - part
    return out


def emulate_split_route(q, k, v, q_pos, k_pos, *, causal, q_parts=3, p_parts=3):
    """The ``wgmma_split`` kernel's arithmetic in plain PyTorch: per KV tile
    of 64 keys, S as the sum of the q parts' products (smallest first, fp32),
    the mask, the online softmax in fp32 with l in fp64, a fresh P·V from
    the P parts (smallest first, fp32), and o = o·corr + tile in fp64."""
    h, sq, d = q.shape
    q_split = split_bf16(q, q_parts)[::-1]
    kf, vf = k.float(), v.float()
    m = torch.full((h, sq), -torch.inf)
    l = torch.zeros((h, sq), dtype=torch.float64)
    o = torch.zeros((h, sq, d), dtype=torch.float64)
    for k0 in range(0, k.shape[1], TILE):
        kt, vt = kf[:, k0:k0 + TILE], vf[:, k0:k0 + TILE]
        s = torch.zeros((h, sq, kt.shape[1]))
        for part in q_split:
            s = s + part @ kt.transpose(1, 2)
        if causal:
            keep = k_pos[k0:k0 + TILE][None, None, :] <= q_pos[None, :, None]
            s = torch.where(keep, s, -torch.inf)
        new_m = torch.maximum(m, s.amax(dim=-1))
        safe_m = torch.where(torch.isfinite(new_m), new_m, 0.0)
        corr = torch.where(torch.isfinite(m), torch.exp(m - safe_m), 0.0)
        p = torch.exp(s - safe_m[..., None])
        l = l * corr.double() + p.sum(dim=-1).double()
        tile = torch.zeros((h, sq, d))
        for part in split_bf16(p, p_parts)[::-1]:
            tile = tile + part @ vt
        o = o * corr.double()[..., None] + tile.double()
        m = new_m
    return o.float(), m, l.float()


def operands(h, sq, sk, d, q_off, k_off, seed):
    """Pre-scaled standard normal q (fp32), bf16 k and v, and positions from
    the offsets, made with numpy from ``seed``."""
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.standard_normal((h, sq, d)).astype(np.float32)) / d ** 0.5
    k, v = (torch.from_numpy(rng.standard_normal((h, sk, d)).astype(np.float32)).bfloat16()
            for _ in range(2))
    q_pos = torch.arange(sq, dtype=torch.int32) + q_off
    k_pos = torch.arange(sk, dtype=torch.int32) + k_off
    return q, k, v, q_pos, k_pos


def excess(got, want) -> float:
    """max(|got - want| - TOL·|want|) over the finite entries of o, m and l
    (within the bar iff <= TOL); the non-finite entries must be equal."""
    worst = -np.inf
    for x, r in zip(got, want):
        fin = torch.isfinite(r)
        assert torch.equal(torch.isfinite(x), fin) and torch.equal(x[~fin], r[~fin])
        if fin.any():
            worst = max(worst, ((x[fin] - r[fin]).abs() - TOL * r[fin].abs()).max().item())
    return worst


@pytest.mark.parametrize("d", [128, 256, 16, 64, 200])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32, torch.float16])
def test_flash_route_plan(dtype, d):
    """bf16 k/v at d = 128 (every attention path's head dim), and any d the
    kernel pads to 128, take the tensor-core route; fp32, fp16 (cast to
    fp32 first) and d padded past 128 the FFMA one."""
    want = "wgmma_split" if dtype == torch.bfloat16 and d <= 128 else "ffma"
    assert flash_route(dtype, d) == want
    assert padded_head_dim(d) == (128 if d <= 128 else 256)


@pytest.mark.parametrize("d", [16, 64, 200])
@pytest.mark.parametrize("causal", [False, True])
def test_padding_the_head_dim_is_exact(d, causal):
    """The wrapper's zero padding of d (what the kernel runs on the card)
    changes nothing: the plain partial of the padded q, k and v is zero in
    o's padded columns, and cut back to d columns it holds the kernel's
    bar (2e-5) against the unpadded one (the same sums, zero terms added)."""
    q, k, v, q_pos, k_pos = operands(2, 96, 130, d, 20, 0, seed=d)
    want = flash_partial_plain(q, k, v, q_pos, k_pos, causal=causal)
    d_pad = padded_head_dim(d)
    padded = [pad_head_dim(x, d_pad) for x in (q, k, v)]
    assert all(x.shape[-1] == d_pad and x.is_contiguous() for x in padded)
    assert all(torch.equal(x[..., :d], y) and not x[..., d:].any()
               for x, y in zip(padded, (q, k, v)))
    got = flash_partial_plain(*padded, q_pos, k_pos, causal=causal)
    assert not got[0][..., d:].any()
    assert excess((got[0][..., :d], got[1], got[2]), want) <= 0.0


@pytest.mark.parametrize("scale", [1e-20, 1e-3, 1.0, 1e30])
def test_three_bf16_parts_reconstruct_fp32(scale):
    """Each part is a bf16 value, and the three sum to x within 2^-24·|x|
    (away from fp32's subnormal range)."""
    rng = np.random.default_rng(7)
    x = torch.from_numpy((rng.standard_normal(4096) * scale).astype(np.float32))
    parts = split_bf16(x, 3)
    for part in parts:
        assert torch.equal(part.to(torch.bfloat16).float(), part)
    total = parts[0].double() + parts[1].double() + parts[2].double()
    assert ((total - x.double()).abs() <= 2.0 ** -24 * x.double().abs()).all()


# (h, sq, sk, d, q offset, k offset, causal): causal with offset q positions
# and ragged sq and sk; keys all after the queries (every row fully
# masked); a causal block wholly below the diagonal; the ring's hop length.
EMULATION_SHAPES = [(2, 200, 333, 128, 50, 0, True), (2, 77, 130, 128, 0, 0, False),
                    (1, 128, 128, 128, 0, 1000, True), (1, 256, 1000, 128, 4096, 0, True),
                    (1, 512, 4096, 128, 0, 0, False)]


@pytest.mark.parametrize("shape", EMULATION_SHAPES)
def test_split_route_holds_the_bar(shape):
    """Three q parts and three P parts hold rtol = atol = 2e-5 of the exact
    partial, fully masked rows included (m = -inf, l = 0, o = 0)."""
    h, sq, sk, d, q_off, k_off, causal = shape
    ops = operands(h, sq, sk, d, q_off, k_off, seed=sq + sk)
    got = emulate_split_route(*ops, causal=causal)
    want = flash_partial_plain(*ops, causal=causal)
    assert excess(got, want) <= TOL
    if k_off > sq + q_off:
        assert torch.isneginf(got[1]).all() and (got[2] == 0).all() and (got[0] == 0).all()


@pytest.mark.parametrize("parts", [(3, 2), (2, 3), (2, 2)])
def test_two_parts_miss_the_bar(parts):
    """With two parts of q or of P the remainder is near 2^-16 of the value,
    and at the ring's hop length (4096 keys) the partial lands beyond 2e-5:
    why the kernel takes three passes of each."""
    ops = operands(1, 512, 4096, 128, 0, 0, seed=4608)
    got = emulate_split_route(*ops, causal=False, q_parts=parts[0], p_parts=parts[1])
    assert excess(got, flash_partial_plain(*ops, causal=False)) > TOL


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run `python -m pytest --noconftest -m cuda "
                    "tests/test_torch_flash_route.py` on the chip")
    return torch.device("cuda", 0)


# (route kind, h, sq, sk, q offset, k offset): ragged sq and sk with offset
# q positions on each route; the ring's hop at s = 4000 (sk = 1000, a ragged
# KV tile); keys all after the queries (causal: every row fully masked).
CARD_CASES = [("bf16", 2, 256, 300, 40, 0), ("fp32", 2, 256, 300, 40, 0),
              ("d256", 2, 256, 300, 40, 0), ("bf16", 8, 1000, 1000, 0, 0),
              ("bf16", 1, 128, 128, 0, 1000), ("d16", 2, 256, 300, 40, 0),
              ("d64", 2, 256, 300, 40, 0), ("d64fp32", 2, 256, 300, 40, 0)]


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("case", CARD_CASES)
def test_route_taken_and_row_slices_on_card(card, case, causal):
    """Each route on the card against the plain version at 2e-5, bitwise
    repeatable, on the route the plan names; rows 37:b of the call alone
    (b = 203, or sq - 25 for a shorter call) give the full call's rows
    bitwise (a row's result depends on the row, the keys and the positions,
    not on its place in a tile)."""
    kind, h, sq, sk, q_off, k_off = case
    dtype = torch.float32 if kind.endswith("fp32") else torch.bfloat16
    d = {"d256": 256, "d16": 16, "d64": 64, "d64fp32": 64}.get(kind, 128)
    seed = 256 if sq == 256 else sq + sk
    q, k, v, q_pos, k_pos = (x.to(card) for x in operands(h, sq, sk, d, q_off, k_off, seed))
    k, v = k.to(dtype), v.to(dtype)
    a0, b0 = 37, min(203, sq - 25)
    route = flash_route(dtype, d)
    before = flash_partial_cuda.route_launches[route]
    a = flash_partial_cuda(q, k, v, q_pos, k_pos, causal)
    b = flash_partial_cuda(q, k, v, q_pos, k_pos, causal)
    rows = flash_partial_cuda(q[:, a0:b0], k, v, q_pos[a0:b0], k_pos, causal)
    want = flash_partial_plain(q, k, v, q_pos, k_pos, causal=causal)
    torch.cuda.synchronize(card)
    assert flash_partial_cuda.route_launches[route] == before + 3
    for x, y, part, w in zip(a, b, rows, want):
        assert torch.equal(x, y)
        assert torch.equal(part, x[:, a0:b0])
        torch.testing.assert_close(x, w, rtol=TOL, atol=TOL)
    if causal and k_off > sq + q_off:
        o, m, l = a
        assert torch.isneginf(m).all() and (l == 0).all() and (o == 0).all()
