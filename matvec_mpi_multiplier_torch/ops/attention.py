"""The flash-attention partial of one Q block against one KV block.

The port's counterpart of the JAX package's ``ops/pallas_attention.py``
without its Pallas body, which becomes the CUDA kernel of
``ops/cuda_attention.py`` (``csrc/flash_attention.cu``). The long-context
schedules (``parallel/attention.py``: ring and Ulysses) do their per-shard
work as "attention of a Q block against one KV block", and the ``flash``
tier computes it as a **partial**, not a finished attention:

    o_unnorm[h, q, :] = sum_k exp(s[h, q, k] - m[h, q]) * v[h, k, :]
    m[h, q]           = max_k s[h, q, k]          (-inf if all masked)
    l[h, q]           = sum_k exp(s[h, q, k] - m[h, q])

with ``s = (Q_pre_scaled) @ K^T`` and an optional causal mask by GLOBAL
positions ``q_pos``/``k_pos``. Partials compose: the ring folds one per hop
with :func:`merge_partials`, Ulysses normalizes one full-block partial
(``o = o_unnorm / l``). Statistics and accumulation are at least fp32
whatever the storage dtype.

:func:`flash_block_partial` runs the kernel on every CUDA tensor whose head
dim it takes (``d % 128 == 0``) and raises on the rest; it never computes
the plain partial on the card. :func:`flash_path_available` is the JAX
package's predicate for where its Pallas kernel runs: here it only labels
the cells of the attention study where the JAX package would fall back.
"""

from __future__ import annotations

import torch

# The JAX package's (bq, bk) score tiles, for flash_path_available. The
# CUDA kernel tiles by 64 rows and keys whatever these say.
DEFAULT_BQ = 512
DEFAULT_BK = 512


def _largest_divisor_leq(n: int, cap: int, multiple: int) -> int | None:
    """Largest d ≤ cap with n % d == 0 and d % multiple == 0 (None if none)."""
    d = min(cap, n)
    d -= d % multiple
    while d >= multiple:
        if n % d == 0:
            return d
        d -= multiple
    return None


def flash_path_available(
    sq: int, sk: int, d: int, *, bq: int = DEFAULT_BQ, bk: int = DEFAULT_BK
) -> bool:
    """True iff these block shapes take the kernel: sq has a divisor ≤ bq
    that is a multiple of 8, sk one ≤ bk that is a multiple of 128, and
    ``d % 128 == 0``: the JAX package's predicate for where its Pallas
    kernel runs. The port's kernel takes any sq and sk; the attention study
    uses this to mark the cells where the JAX package would fall back."""
    return (
        _largest_divisor_leq(sq, bq, 8) is not None
        and _largest_divisor_leq(sk, bk, 128) is not None
        and d % 128 == 0
    )


def reference_partial(q, k, v, q_pos, k_pos, *, causal: bool,
                      sum_dtype: torch.dtype = torch.float32):
    """The partial in plain PyTorch. ``q`` (h, sq, d) pre-scaled; ``k``,
    ``v`` (h, sk, d) in any float dtype; returns fp32 ``(o_unnorm, m, l)``.

    The scores and weights are fp32. With the default ``sum_dtype`` every
    step is fp32, as the JAX package's ``_reference_partial``: the flash
    tier's backward recomputes through this. With ``torch.float64`` the two
    sums over the keys (l and the V product) are fp64, rounded once: the
    kernel's plain version (``cuda_attention.flash_partial_plain``), which
    the kernel is held to at 2e-5. All-fp32 sums land beyond that bar at
    Ulysses' block length on an H100 (``PERF.md`` §6)."""
    s = torch.einsum("hqd,hkd->hqk", q.float(), k.float())
    if causal:
        s = torch.where(k_pos[None, None, :] <= q_pos[None, :, None], s, -torch.inf)
    m = s.amax(dim=-1)                          # (h, sq); -inf if all masked
    safe_m = torch.where(torch.isfinite(m), m, 0.0)
    p = torch.exp(s - safe_m[..., None]).to(sum_dtype)
    l = p.sum(dim=-1)
    o = torch.einsum("hqk,hkd->hqd", p, v.to(sum_dtype))
    return o.float(), m, l.float()


class _FlashPartial(torch.autograd.Function):
    """The kernel forward; the backward recomputes the block through
    :func:`reference_partial` in fp32 and pulls the cotangents through
    that, as the JAX package's custom VJP does. It holds one block's score tile, never
    the full (s, s) matrix, and no gradient flows to the positions."""

    @staticmethod
    def forward(ctx, q, k, v, q_pos, k_pos, causal):
        # cuda_attention takes its plain version from this module.
        from .cuda_attention import flash_partial_cuda

        ctx.save_for_backward(q, k, v, q_pos, k_pos)
        ctx.causal = causal
        return flash_partial_cuda(q, k, v, q_pos, k_pos, causal)

    @staticmethod
    def backward(ctx, d_o, d_m, d_l):
        q, k, v, q_pos, k_pos = ctx.saved_tensors
        wants = ctx.needs_input_grad[:3]
        leaves = [x.detach().requires_grad_(w) for x, w in zip((q, k, v), wants)]
        with torch.enable_grad():
            out = reference_partial(*leaves, q_pos, k_pos, causal=ctx.causal)
            inputs = [x for x, w in zip(leaves, wants) if w]
            grads = iter(torch.autograd.grad(out, inputs, (d_o, d_m, d_l),
                                             allow_unused=True))
        return (*(next(grads) if w else None for w in wants), None, None, None)


def flash_block_partial(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    q_pos: torch.Tensor, k_pos: torch.Tensor, *, causal: bool = False,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Attention partial of Q (h, sq, d) against one KV block (h, sk, d).

    ``q`` must be pre-scaled (callers own the 1/sqrt(d) factor, as the ring
    does once instead of per hop). ``q_pos``/``k_pos``: (sq,)/(sk,) int32
    global positions, used only under ``causal``. Returns ``(o_unnorm, m,
    l)`` from the kernel of ``ops/cuda_attention.py`` (its plain version on
    CPU tensors; on other tensors a shape it does not take raises), with a
    backward that recomputes through :func:`reference_partial`.
    """
    return _FlashPartial.apply(q, k, v, q_pos, k_pos, causal)


def merge_partials(a, b):
    """Merge two attention partials via the rescaling identity.

    Both arguments and the result are ``(o_unnorm, m, l)`` triples in the
    order :func:`flash_block_partial` returns, so partials chain without
    permutation. Commutative up to rounding and associative, which lets the
    ring fold hops in arrival order.
    """
    o_a, m_a, l_a = a
    o_b, m_b, l_b = b
    new_m = torch.maximum(m_a, m_b)
    safe_m = torch.where(torch.isfinite(new_m), new_m, 0.0)
    c_a = torch.where(torch.isfinite(m_a), torch.exp(m_a - safe_m), 0.0)
    c_b = torch.where(torch.isfinite(m_b), torch.exp(m_b - safe_m), 0.0)
    l = l_a * c_a + l_b * c_b
    o = o_a * c_a[..., None] + o_b * c_b[..., None]
    return o, new_m, l
