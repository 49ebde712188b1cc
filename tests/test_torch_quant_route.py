"""The block-scaled GEMV's route plan (``ops/cuda_quant.py::quant_route``),
the arithmetic of its tensor-core routes, and, on a card, each route
against the plain version.

The plan is a pure function of the format, x's dtype, the payload's shape,
its block and its alignment, so the CPU reads it. The ``wgmma`` and
``wgmma_split`` routes run the contraction on the 16-bit tensor cores:
every payload value is exact in bf16 and fp16, fp32 x is split into
``SPLIT_PARTS`` bf16 parts, and each quantization block's partial is fresh
in fp32, scaled once per row and block and summed in block order, each
level on its own. The kernel cannot run here, so
:func:`emulate_quant_route` repeats that arithmetic in plain PyTorch and
holds it to the kernel's bar, 1e-5 of |deq(A)|·|x| up to k = 4096 and 1e-4
above, against ``quant_gemv_plain`` and against the JAX package's scan
kernel on the same seeded inputs. One part misses the bar: the reason for
two. The tests marked ``cuda`` hold the kernel itself (the route taken,
bitwise repeatable, pad columns, ragged m and n) and skip without a card.
Only the JAX comparison imports JAX, inside its test, so on a machine with
a card and no JAX the card tests run alone:
``python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_quant_route.py``.
"""

import numpy as np
import pytest
import torch

from matvec_mpi_multiplier_torch.ops.cuda_quant import (
    ROUTE_PARTS,
    SPLIT_PARTS,
    quant_gemv_cuda,
    quant_gemv_plain,
    quant_route,
)
from matvec_mpi_multiplier_torch.ops.quantize import QuantizedMatrix, quantize_matrix

FORMATS = ("int8", "int8c", "fp8")
DTYPES = (torch.bfloat16, torch.float16, torch.float32, torch.float64)


def bar(k: int, dtype: torch.dtype = torch.float32) -> float:
    """The kernel's bar, a share of |deq(A)|·|x|: fp32 sums agree to about
    sqrt(k) eps32 (1e-5 up to k = 4096, 1e-4 above); fp64 to 1e-12."""
    return 1e-12 if dtype == torch.float64 else (1e-5 if k <= 4096 else 1e-4)


def split_bf16(x: torch.Tensor, parts: int) -> list[torch.Tensor]:
    """fp32 ``x`` as ``parts`` fp32 tensors of bf16 values, largest first:
    each is the bf16 rounding of what the ones before it leave."""
    out, rest = [], x.float()
    for _ in range(parts):
        part = rest.to(torch.bfloat16).float()
        out.append(part)
        rest = rest - part
    return out


def emulate_quant_route(qa: QuantizedMatrix, x: torch.Tensor,
                        parts: int = SPLIT_PARTS) -> torch.Tensor:
    """The tensor-core routes' arithmetic in plain PyTorch, in fp32: x in
    ``parts`` bf16 parts (fp32 x; bf16 and fp16 x are one exact part), each
    payload value exact; per level and block, a fresh partial summed over
    the parts (smallest first), then ``acc + s·partial`` (a rounded multiply,
    then an add) in block order; the levels summed apart, then added."""
    m, k = qa.shape
    xs = split_bf16(x, parts) if x.dtype == torch.float32 else [x.float()]
    xs = [p.reshape(k, -1) for p in xs][::-1]
    y = None
    for q, scales in ((qa.q, qa.scales), (qa.q2, qa.scales2)):
        if q is None:
            continue
        qf = q.float()
        acc = torch.zeros((m, xs[0].shape[1]))
        for j in range(k // qa.block):
            cols = slice(j * qa.block, (j + 1) * qa.block)
            partial = torch.zeros_like(acc)
            for part in xs:
                partial = partial + qf[:, cols] @ part[cols]
            acc = acc + scales[:, j:j + 1] * partial
        y = acc if y is None else y + acc
    return y.reshape((m, *x.shape[1:]))


def payload_abs(qa: QuantizedMatrix) -> QuantizedMatrix:
    """|payload| leaf by leaf (e4m3's sign bit cleared), so that
    quant_gemv_plain(payload_abs(qa), |x|) is |deq(A)|·|x|."""
    def clear_sign(leaf):
        if leaf.dtype == torch.int8:
            return leaf.abs()
        if leaf.dtype == torch.float32:  # the scales, >= 0
            return leaf
        return (leaf.view(torch.uint8) & 0x7F).view(leaf.dtype)
    return qa.map(clear_sign)


def excess(got, qa, x) -> float:
    """max(|got - plain| - bar·|deq(A)|·|x|) over y: within the bar iff <= 0."""
    k = qa.shape[1]
    want = quant_gemv_plain(qa, x).double()
    scale = quant_gemv_plain(payload_abs(qa), x.abs()).double()
    return ((got.double() - want).abs() - bar(k, x.dtype) * scale).max().item()


def operands(m, k, block, n, fmt, seed, dtype=torch.float32):
    """A uniform in [-5, 5) (both signs) quantized in ``fmt``, and x uniform
    in [0, 10) as (k,) for n None else (k, n), made with numpy from
    ``seed``."""
    rng = np.random.default_rng(seed)
    a = torch.from_numpy(rng.uniform(-5, 5, (m, k)).astype(np.float32))
    x = rng.uniform(0, 10, (k,) if n is None else (k, n)).astype(np.float32)
    qa = quantize_matrix(a.to(dtype), fmt, block=block)
    return qa, torch.from_numpy(x).to(dtype)


# (k, block, tensor-core shape?): the default block at k = 4096; JAX's block
# 48 (a multiple of 16 that is not a power of two); the asymmetric regime's
# block 32 at k = 60000; the 4x8 fixture's k = 8 (k % 16 != 0); a block of
# 8 at k = 4096 (block % 16 != 0); k = 1000 (k % 16 != 0).
PLAN_SHAPES = [(4096, 128, True), (96, 48, True), (60000, 32, True), (8, 4, False),
               (4096, 8, False), (1000, 8, False)]


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("shape", PLAN_SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("fmt", FORMATS)
def test_quant_route_plan(fmt, dtype, shape, aligned):
    """bf16 and fp16 x take ``wgmma``, fp32 ``wgmma_split``; fp64, an
    unaligned payload, and k or a block that is not a multiple of 16 take
    ``fma``. m and n never change the route."""
    k, block, tensor_shape = shape
    if dtype == torch.float64 or not tensor_shape or not aligned:
        want = "fma"
    else:
        want = "wgmma_split" if dtype == torch.float32 else "wgmma"
    for m, n in ((1, 1), (1000, 4), (65536, 128)):
        assert quant_route(fmt, dtype, m, k, n, block, aligned) == want
    assert ROUTE_PARTS[want] == {"wgmma": 1, "wgmma_split": SPLIT_PARTS, "fma": 0}[want]


def test_quant_route_refuses_what_no_route_takes():
    for args in (("int4", torch.float32, 4, 8, 1, 4, True),
                 ("int8", torch.int32, 4, 8, 1, 4, True),
                 ("int8", torch.float32, 4, 8, 1, 3, True),
                 ("int8", torch.float32, 0, 8, 1, 4, True)):
        with pytest.raises(ValueError):
            quant_route(*args)
    assert quant_route("int8", torch.float32, 2**31, 4096, 1, 128, True) == "fma"


@pytest.mark.parametrize("scale", [1e-20, 1e-3, 1.0, 1e30])
def test_two_bf16_parts_reconstruct_fp32_to_2_16(scale):
    """Each part is a bf16 value, and two sum to x within 2^-16·|x|, the
    share of |deq(A)|·|x| the split leaves (away from fp32's subnormals)."""
    rng = np.random.default_rng(7)
    x = torch.from_numpy((rng.standard_normal(4096) * scale).astype(np.float32))
    parts = split_bf16(x, 2)
    for part in parts:
        assert torch.equal(part.to(torch.bfloat16).float(), part)
    total = parts[0].double() + parts[1].double()
    assert ((total - x.double()).abs() <= 2.0 ** -16 * x.double().abs()).all()


def test_payload_is_exact_in_both_16_bit_types():
    """Every int8 value and every finite e4m3 value is a bf16 and an fp16
    value: the conversion in registers loses nothing."""
    q = torch.arange(-128, 128, dtype=torch.int16).to(torch.int8)
    e4m3 = torch.arange(256, dtype=torch.int16).to(torch.uint8).view(torch.float8_e4m3fn)
    for vals in (q.float(), e4m3.float()[torch.isfinite(e4m3.float())]):
        for t in (torch.bfloat16, torch.float16):
            assert torch.equal(vals.to(t).float(), vals)


# (m, k, block, n): chip_smoke.py's check shapes the tensor cores take (JAX's
# block-48 shape, a ragged m, the square one; n None is x as (k,)) and a
# k above 4096.
EMULATION_SHAPES = [(6, 96, 48, None), (1000, 3008, 64, 4), (256, 4096, 128, 32),
                    (64, 8192, 128, None)]


@pytest.mark.parametrize("shape", EMULATION_SHAPES)
@pytest.mark.parametrize("fmt", FORMATS)
def test_split_route_holds_the_bar(fmt, shape):
    """Two bf16 parts of fp32 x, a fresh partial per block, scaled in block
    order: within the kernel's bar of ``quant_gemv_plain``."""
    m, k, block, n = shape
    qa, x = operands(m, k, block, n, fmt, seed=m + k)
    assert excess(emulate_quant_route(qa, x), qa, x) <= 0


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("fmt", FORMATS)
def test_one_pass_route_holds_the_bar(fmt, dtype):
    """bf16 and fp16 x are one exact part (the ``wgmma`` route)."""
    qa, x = operands(1000, 3008, 64, 4, fmt, seed=11, dtype=dtype)
    assert excess(emulate_quant_route(qa, x), qa, x) <= 0


@pytest.mark.parametrize("fmt", FORMATS)
def test_one_part_misses_the_bar(fmt):
    """With one bf16 part of fp32 x the remainder is near 2^-9 of x, far
    beyond 1e-5 of |deq(A)|·|x|: why wgmma_split takes two."""
    assert SPLIT_PARTS - 1 == 1
    qa, x = operands(256, 4096, 128, 32, fmt, seed=4352)
    assert excess(emulate_quant_route(qa, x, parts=SPLIT_PARTS - 1), qa, x) > 0


@pytest.mark.parametrize("n", [None, 4])
@pytest.mark.parametrize("fmt", FORMATS)
def test_split_route_matches_jax_scan_kernel(fmt, n):
    """The emulated route against the JAX package's scan kernel
    (``ops/quantize.py::matvec_quantized``) on the same seeded inputs and
    payload, at the bar: the same association, other roundings."""
    import jax.numpy as jnp

    from matvec_mpi_multiplier_tpu.ops import quantize as jq

    m, k, block = 200, 3008, 64
    rng = np.random.default_rng(5)
    a = rng.uniform(-5, 5, (m, k)).astype(np.float32)
    x = rng.uniform(0, 10, (k,) if n is None else (k, n)).astype(np.float32)
    qa = quantize_matrix(torch.from_numpy(a), fmt, block=block)
    ref = np.asarray(jq.matvec_quantized(jq.quantize_matrix(a, fmt, block=block),
                                         jnp.asarray(x))).astype(np.float64)
    got = emulate_quant_route(qa, torch.from_numpy(x)).double().numpy()
    scale = quant_gemv_plain(payload_abs(qa), torch.from_numpy(x)).double().numpy()
    assert (np.abs(got - ref) <= bar(k) * scale).all()


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run `python -m pytest --noconftest -m cuda "
                    "tests/test_torch_quant_route.py` on the chip")
    return torch.device("cuda", 0)


def unaligned(qa: QuantizedMatrix) -> QuantizedMatrix:
    """The same payload with each level's base one byte past a 16-byte
    boundary (TMA cannot read it: the ``fma`` route)."""
    def shift(leaf):
        if leaf.dtype == torch.float32:
            return leaf
        buf = torch.empty(leaf.numel() + 16, dtype=torch.uint8, device=leaf.device)
        out = buf[1:1 + leaf.numel()].view(leaf.shape)
        out.copy_(leaf.view(torch.uint8))
        return out.view(leaf.dtype)
    return qa.map(shift)


# (m, k, block, widths): a ragged m with JAX's block 48; a ragged m at the
# default block; the square shape; k above 4096 with block 32. Widths:
# the vector, every N tile (8, 32, 64) and its neighbours, a ragged n past
# one tile (33, 100) and one past two (130).
CARD_SHAPES = [(6, 96, 48, (None, 2, 8, 9)), (1000, 3008, 64, (None, 4, 31, 33)),
               (4096, 4096, 128, (None, 16, 32, 64, 65, 130)),
               (300, 8192, 32, (None, 8, 100))]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("shape", CARD_SHAPES)
def test_route_on_card(card, shape, fmt, dtype):
    """Each route on the card against the plain version at the bar, on the
    route the plan names, bitwise repeatable, and its real columns the same
    whether the pad columns hold zeros or random values."""
    m, k, block, widths = shape
    qa, _ = operands(m, k, block, 1, fmt, seed=m + k, dtype=dtype)
    qa = qa.to(card)
    rng = np.random.default_rng(k)
    for w in widths:
        x = torch.from_numpy(rng.uniform(0, 10, (k,) if w is None else (k, w))
                             .astype(np.float32)).to(card, dtype)
        n = 1 if w is None else w
        route = quant_route(fmt, dtype, m, k, n, block, True)
        before = quant_gemv_cuda.route_launches[route]
        y1, y2 = quant_gemv_cuda(qa, x), quant_gemv_cuda(qa, x)
        torch.cuda.synchronize(card)
        assert quant_gemv_cuda.route_launches[route] == before + 2
        assert torch.equal(y1, y2)
        assert excess(y1.cpu(), qa.to("cpu"), x.cpu()) <= 0
        if w is None:
            continue
        real = []
        for pad in ("zeros", "random"):
            wide = (torch.zeros((k, w + 7), dtype=dtype, device=card) if pad == "zeros"
                    else torch.rand((k, w + 7), device=card).to(dtype) * 10)
            wide[:, :w] = x
            real.append(quant_gemv_cuda(qa, wide)[:, :w])
        assert torch.equal(real[0], real[1])


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", FORMATS)
def test_unaligned_payload_takes_fma_on_card(card, fmt):
    """A payload TMA cannot read goes to ``fma``, and agrees with the plain
    version there."""
    qa, x = operands(100, 1024, 64, 8, fmt, seed=3)
    qa = unaligned(qa.to(card))
    x = x.to(card)
    assert quant_route(fmt, x.dtype, 100, 1024, 8, 64, qa.q.data_ptr() % 16 == 0) == "fma"
    before = quant_gemv_cuda.route_launches["fma"]
    y = quant_gemv_cuda(qa, x)
    torch.cuda.synchronize(card)
    assert quant_gemv_cuda.route_launches["fma"] == before + 1
    assert excess(y.cpu(), qa.to("cpu"), x.cpu()) <= 0
