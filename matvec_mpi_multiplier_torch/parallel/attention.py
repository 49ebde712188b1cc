"""Sequence-parallel exact attention: the ring and Ulysses schedules.

The port's counterpart of the JAX package's ``parallel/attention.py``.
``Q, K, V`` are ``(s, d)`` or ``(s, h, d_head)`` with the SEQUENCE axis
sharded over the mesh's flat axis (every mesh axis, row-major): each shard
owns an ``(s/p, …)`` block of all three.

* **Ring** (:func:`ring_attention`): the KV pair circulates the ring. At
  step ``t`` shard ``i`` holds the KV block of shard ``(i - t) mod p``,
  computes its ``Q_i K_j^T`` tile and folds it into an online-softmax state
  (running row max ``m``, normalizer ``l``, value accumulator), so the
  ``s × s`` score matrix never exists. The hops are ``ppermute`` s of the
  right-neighbour permutation.
* **Ulysses** (:func:`ulysses_attention`): one ``all_to_all`` reshards to
  head-parallel ``(s, h/p, d_head)``, each shard runs dense attention over
  its heads, and a second ``all_to_all`` reshards back.

Each has two tiers (:data:`ATTENTION_KERNELS`): ``xla`` materializes the
score tile in plain torch; ``flash`` computes each block through
``ops/attention.py::flash_block_partial``, the hand-written CUDA kernel on
the card. Statistics and accumulation are fp32 whatever the storage dtype;
K and V circulate at their storage dtype (bf16 moves half the bytes of
fp32), as do Ulysses' three forward exchanges, and the return leg carries
the fp32 output.

The mesh is the single controller of ``parallel/mesh.py``: the functions
take and return per-shard lists in flat mesh order, and the collectives
are tensor ops on those lists (on one card, list rotations and slices).
Over several processes each computes its own shards only; another's stay
placeholders, and the hops and exchanges cross processes.
Everything is differentiable with autograd: on one device a hop returns
the same tensor.
"""

from __future__ import annotations

import torch

from ..ops.attention import flash_block_partial, merge_partials
from .mesh import (
    Mesh,
    ShardedTensor,
    _axes,
    _axes_size,
    all_to_all,
    ppermute,
    shard,
    unshard,
)
from .ring import _ring_index, _ring_perm

# Local-block attention tiers: "xla" materializes the (h, bq, bk) score tile
# between two matmuls; "flash" computes scores, online softmax and the
# weighted V in one kernel (ops/cuda_attention.py), the tile never reaching
# device memory.
ATTENTION_KERNELS = ("xla", "flash")


def _check_kernel(kernel: str) -> None:
    if kernel not in ATTENTION_KERNELS:
        raise ValueError(
            f"unknown attention kernel {kernel!r}; "
            f"options: {', '.join(ATTENTION_KERNELS)}"
        )


def _online_update(m, l, acc, scores, v_blk):
    """Fold one score tile into the flash-attention running state.

    ``scores``: (h, q_blk, k_blk) fp32 logits (already masked); ``v_blk``:
    (k_blk, h, d). ``m, l``: (h, q_blk); ``acc``: (h, q_blk, d). Rows with
    no unmasked entries contribute -inf maxima and zero weight.
    """
    tile_max = scores.amax(dim=-1)
    new_m = torch.maximum(m, tile_max)
    # Guard -inf - -inf (fully masked row against fully masked history).
    safe_m = torch.where(torch.isfinite(new_m), new_m, 0.0)
    correction = torch.where(torch.isfinite(m), torch.exp(m - safe_m), 0.0)
    p_tile = torch.exp(scores - safe_m[..., None])  # exp(-inf) = 0 where masked
    l = l * correction + p_tile.sum(dim=-1)
    acc = acc * correction[..., None] + torch.einsum("hqk,khd->hqd", p_tile, v_blk)
    return new_m, l, acc


def ring_attention(
    qs, ks, vs, mesh: Mesh, axes, *, causal: bool = False, kernel: str = "xla",
) -> list[torch.Tensor]:
    """Exact attention with the sequence axis sharded over ``axes``.

    ``qs, ks, vs``: per-shard ``(blk, d)`` single-head or ``(blk, h,
    d_head)`` multi-head sequence blocks (one ``blk`` on every shard).
    Returns each shard's block of ``softmax(Q Kᵀ / sqrt(d)) V`` (fp32, input
    rank kept). ``kernel`` picks the per-hop tile tier; both fold the same
    online-softmax state, so they agree to fp32 rounding.
    """
    _check_kernel(kernel)
    axes = _axes(axes)
    p = _axes_size(mesh, axes)
    idx = _ring_index(mesh, axes)
    single_head = qs[0].dim() == 2
    if single_head:
        qs, ks, vs = ([x[:, None, :] for x in xs] for xs in (qs, ks, vs))
    blk, h, d = qs[0].shape
    scale = 1.0 / (d ** 0.5)
    # Q is local, so pre-scaling it in fp32 once costs no wire bytes; K and
    # V circulate at their storage dtype, and each tile upcasts (exactly).
    qf = [q.float() * scale for q in qs]
    n = mesh.size
    m = [torch.full((h, blk), -torch.inf, device=q.device) for q in qs]
    l = [torch.zeros((h, blk), device=q.device) for q in qs]
    acc = [torch.zeros((h, blk, d), device=q.device) for q in qs]
    rows = [torch.arange(blk, dtype=torch.int32, device=q.device) for q in qs]
    perm = _ring_perm(p)
    if kernel == "flash":
        # The kernel wants head-major operands: transpose Q once and
        # circulate K and V already head-major, not twice per hop.
        qf = [q.transpose(0, 1).contiguous() for q in qf]
        ks, vs = ([x.transpose(0, 1).contiguous() for x in xs] for xs in (ks, vs))
    for t in range(p):
        if t > 0:
            ks = ppermute(ks, mesh, axes, perm)
            vs = ppermute(vs, mesh, axes, perm)
        for f in range(n):
            if not mesh.is_local(f):
                continue  # another process's shard: its state stays a placeholder
            # This shard's rows start at idx*blk; the KV block in hand at
            # step t came from ring index (idx - t) mod p.
            src = (idx[f] - t) % p
            q_pos, k_pos = idx[f] * blk + rows[f], src * blk + rows[f]
            if kernel == "flash":
                part = flash_block_partial(qf[f], ks[f], vs[f], q_pos, k_pos,
                                           causal=causal)
                acc[f], m[f], l[f] = merge_partials((acc[f], m[f], l[f]), part)
                continue
            scores = torch.einsum("qhd,khd->hqk", qf[f], ks[f].float())
            if causal:
                keep = k_pos[None, :] <= q_pos[:, None]
                scores = torch.where(keep[None], scores, -torch.inf)
            m[f], l[f], acc[f] = _online_update(m[f], l[f], acc[f], scores,
                                                vs[f].float())
    out = []
    for a, lf in zip(acc, l):
        # Fully masked rows cannot occur causally (a position attends
        # itself); guard the division anyway.
        o = a / torch.clamp(lf, min=1e-30)[..., None]  # (h, blk, d)
        out.append(o[0] if single_head else o.transpose(0, 1))
    return out


def _dense_block_attention(q, k, v, *, causal: bool) -> torch.Tensor:
    """Plain fp32 attention over full local arrays, batched over leading
    dimensions ((…, s, d) in, (…, s, d) out): the per-head local step of
    the Ulysses schedule."""
    d = q.shape[-1]
    scores = (q @ k.transpose(-2, -1)) * (1.0 / (d ** 0.5))
    if causal:
        rows = torch.arange(q.shape[-2], device=q.device)
        scores = torch.where(rows[None, :] <= rows[:, None], scores, -torch.inf)
    m = scores.amax(dim=-1, keepdim=True)
    w = torch.exp(scores - m)
    return (w @ v) / w.sum(dim=-1, keepdim=True)


def _local_heads_attention(q, k, v, *, causal: bool, kernel: str) -> torch.Tensor:
    """Full local attention over (s, h, d_head) arrays in the requested
    tier: the per-head step both Ulysses branches share. Takes the storage
    dtype (the exchanges deliver it un-upcast) and computes in fp32. The
    flash tier hands the kernel K and V in that dtype (its bf16 load is
    exact, and bf16 takes the kernel's tensor-core route); only q is
    upcast, to be pre-scaled."""
    q = q.float().transpose(0, 1)  # (h, s, dh)
    k, v = (x.transpose(0, 1) for x in (k, v))
    if kernel == "flash":
        s, dh = q.shape[1], q.shape[2]
        pos = torch.arange(s, dtype=torch.int32, device=q.device)
        o_u, _, l = flash_block_partial(
            (q * (1.0 / (dh ** 0.5))).contiguous(), k.contiguous(),
            v.contiguous(), pos, pos, causal=causal,
        )
        o = o_u / torch.clamp(l, min=1e-30)[..., None]
    else:
        o = _dense_block_attention(q, k.float(), v.float(), causal=causal)
    return o.transpose(0, 1)


def _check_heads_rank(q, k, v) -> None:
    """Ulysses cuts the heads: q, k and v must be ``(s, h, d_head)``. The
    JAX package's unpacking of ``q.shape`` raises ``ValueError`` for any
    other rank; so does this."""
    if any(x.dim() != 3 for x in (q, k, v)):
        raise ValueError(
            "ulysses attention needs (s, h, d_head) q, k and v, got shapes "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )


def ulysses_attention(
    qs, ks, vs, mesh: Mesh, axes, *, causal: bool = False, kernel: str = "xla",
) -> list[torch.Tensor]:
    """Exact multi-head attention, sequence-parallel through ONE
    ``all_to_all`` each way.

    ``qs, ks, vs``: per-shard ``(s/p, h, d_head)`` blocks. The first
    exchange reshards to head-parallel ``(s, h/p, d_head)`` (the full
    sequence, a slice of the heads), where attention is a dense per-head
    step; the second reshards back. Needs ``h % p == 0``. Returns each
    shard's ``(s/p, h, d_head)`` output block (fp32).
    """
    _check_kernel(kernel)
    _check_heads_rank(qs[0], ks[0], vs[0])
    axes = _axes(axes)
    p = _axes_size(mesh, axes)
    h = qs[0].shape[1]
    if p == 1:
        return [_local_heads_attention(q, k, v, causal=causal, kernel=kernel)
                for q, k, v in zip(qs, ks, vs)]
    if h % p != 0:
        raise ValueError(f"ulysses_attention: {h} heads not divisible by {p}")

    def to_heads(xs):
        # (s/p, h, dh) -> (s, h/p, dh), in the storage dtype.
        return all_to_all(xs, mesh, axes, split_axis=1, concat_axis=0)

    qh, kh, vh = to_heads(qs), to_heads(ks), to_heads(vs)
    oh = [_local_heads_attention(q, k, v, causal=causal, kernel=kernel)
          if mesh.is_local(f) else
          torch.empty((*q.shape[:2], v.shape[2]), dtype=torch.float32, device="meta")
          for f, (q, k, v) in enumerate(zip(qh, kh, vh))]
    # (s, h/p, dh) -> (s/p, h, dh): the inverse exchange.
    return all_to_all(oh, mesh, axes, split_axis=0, concat_axis=1)


def _build(schedule, mesh: Mesh, *, causal: bool, gather_output: bool,
           kernel: str, heads_parallel: bool):
    _check_kernel(kernel)
    axes = tuple(mesh.axis_names)
    spec = (axes,)

    def attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
        s, p = q.shape[0], mesh.size
        if s % p != 0:
            raise ValueError(f"sequence length {s} not divisible by {p} devices")
        if heads_parallel:
            _check_heads_rank(q, k, v)
        if heads_parallel and q.shape[1] % p != 0:
            raise ValueError(f"{q.shape[1]} heads not divisible by {p} devices")
        blocks = [list(shard(x, spec, mesh).shards) for x in (q, k, v)]
        o = schedule(*blocks, mesh, axes, causal=causal, kernel=kernel)
        out = ShardedTensor(tuple(o), tuple(q.shape), spec, mesh)
        return unshard(out, boundary=True) if gather_output else out

    return attn


def build_ring_attention(
    mesh: Mesh, *, causal: bool = False, gather_output: bool = False,
    kernel: str = "xla",
):
    """Return ``attn(q, k, v) -> o`` over ``mesh``'s flat axis.

    Inputs are global ``(s, d)`` single-head or ``(s, h, d_head)``
    multi-head tensors, cut by sequence over the mesh; ``s`` must divide by
    the device count. ``gather_output=True`` returns the whole fp32 output
    on the mesh's first device; ``False`` a :class:`ShardedTensor` of
    ``(s/p, …)`` blocks (the long-context mode: chained layers never hold
    the whole sequence). ``kernel``: the per-hop tile tier.
    """
    return _build(ring_attention, mesh, causal=causal, gather_output=gather_output,
                  kernel=kernel, heads_parallel=False)


def build_ulysses_attention(
    mesh: Mesh, *, causal: bool = False, gather_output: bool = False,
    kernel: str = "xla",
):
    """Return ``attn(q, k, v) -> o`` for the all-to-all schedule.

    Inputs are global ``(s, h, d_head)`` tensors, cut by sequence over the
    flat axis; ``s`` and ``h`` must both divide by the device count.
    ``gather_output`` and ``kernel`` as in :func:`build_ring_attention`.
    """
    return _build(ulysses_attention, mesh, causal=causal,
                  gather_output=gather_output, kernel=kernel, heads_parallel=True)
