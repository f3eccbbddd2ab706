"""Ring attention: causal attention over a sequence split across ranks.

The port of the JAX package's ``ops/ring_attention.py`` on
``torch.distributed``. Each rank of the sequence group holds a
``[B, T/n, H(kv), D]`` slice of q, k and v (rank i the tokens
``[i T/n, (i+1) T/n)``); the K/V blocks rotate around the ring while each
rank folds the blocks it receives into its queries' attention with an
online softmax:

  s   = q k^T / sqrt(d)   (masked on the diagonal block)
  m'  = max(m, rowmax(s))
  p   = exp(s - m')
  o   = o exp(m - m') + p v
  l   = l exp(m - m') + rowsum(p)

and ``out = o / l`` once every block has passed. The state (o, m, l) is
f32 whatever the inputs' dtype. The self block comes first, so ``m`` is
finite from the first fold (every causal query attends to itself).

- **The exchange** (``ring_shift``) is an autograd function: its forward
  sends the stacked (k, v) block to rank ``(i+1) % n`` and receives from
  ``(i-1) % n``, one ``batch_isend_irecv`` in the same order on every
  rank; its backward is the reverse rotation of the cotangents, as JAX's
  AD transposes ``ppermute``. GQA heads are expanded after the exchange,
  so the ring moves the unexpanded ``[B, T/n, Hkv, D]`` blocks. A ring
  pays n - 1 exchanges a call, causal or not.
- **Causal skip**: a block from a later rank (``src > i``) is fully
  masked, and its two products are skipped. Its cotangent is still zero
  rather than absent (``_join``): otherwise autograd would not run that
  exchange's backward on this rank while its peer waits in the same
  exchange.
- **The products** are plain ``torch`` products through
  ``ops/remat.product`` (untagged and batched: ``dots`` remat keeps them,
  as JAX's ``checkpoint_dots`` keeps the ring's einsums), computed on the
  f32 values of the inputs. JAX computes them with ``jnp.einsum``,
  outside any Pallas kernel; no TPU kernel is on this path.
- **Transport**: gloo on CUDA tensors (the port's way to put several
  ranks on one card, which NCCL refuses) stages each block through host
  memory here, explicitly: the choice is the group's backend's
  (``staged``), the copy gloo makes anyway. NCCL and CPU tensors go
  direct.

``exchanges`` counts the exchanges this module issued (forward, backward
and a remat recompute's alike), as ``ops/tp.collectives`` counts the
all-reduces.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

from pytorch_distributed_tpu_torch.ops.remat import product

NEG_INF = -1e30
exchanges = 0  # ring exchanges (one batched send/recv pair each)


def staged(group, t: torch.Tensor) -> bool:
    """Whether a collective on ``group`` moves ``t`` through host memory:
    a CUDA tensor on a gloo group."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def group_peer(group, offset: int) -> int:
    """The global rank of the group rank ``offset`` places after this
    one, around the ring."""
    n = dist.get_world_size(group)
    idx = dist.get_rank(group)
    return dist.get_process_group_ranks(group)[(idx + offset) % n]


def _shift(x: torch.Tensor, group, offset: int) -> torch.Tensor:
    """``x`` sent to the rank ``offset`` after this one; returns what the
    rank ``offset`` before this one sent."""
    global exchanges
    exchanges += 1
    stage = staged(group, x)
    send = x.detach().contiguous()
    if stage:
        send = send.cpu()
    recv = torch.empty_like(send)
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, send, group_peer(group, offset), group),
        dist.P2POp(dist.irecv, recv, group_peer(group, -offset), group)])
    for req in reqs:
        req.wait()
    return recv.to(x.device) if stage else recv


class _RingShift(torch.autograd.Function):
    """Forward: one step around the ring; backward: one step back."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _shift(x, group, 1)

    @staticmethod
    def backward(ctx, g):
        return _shift(g, ctx.group, -1), None


def ring_shift(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` from the previous rank of ``group`` (this rank's goes to the
    next); differentiable, its backward the reverse rotation."""
    return _RingShift.apply(x, group)


class _Join(torch.autograd.Function):
    """``acc`` unchanged; gives ``block`` a zero cotangent, so the exchange
    that produced a skipped block runs its backward on this rank too."""

    @staticmethod
    def forward(ctx, acc, block):
        ctx.shape, ctx.dtype = block.shape, block.dtype
        return acc.view_as(acc)

    @staticmethod
    def backward(ctx, g):
        return g, g.new_zeros(ctx.shape, dtype=ctx.dtype)


def _repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    return x if n_rep == 1 else x.repeat_interleave(n_rep, dim=2)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   group, causal: bool = True) -> torch.Tensor:
    """q [B, T/n, H, D], k and v [B, T/n, Hkv, D], this rank's slice of the
    sequence over ``group`` -> this rank's output slice [B, T/n, H, D] in
    v's dtype: the global semantics of ``naive_attention`` on the whole
    sequence."""
    n = dist.get_world_size(group)
    idx = dist.get_rank(group)
    b, tl, h, d = q.shape
    n_rep = h // k.shape[2]
    scale = 1.0 / math.sqrt(d)
    qh = q.float().transpose(1, 2)  # [B, H, Tl, D]
    o = q.new_zeros((b, h, tl, d), dtype=torch.float32)
    m = q.new_full((b, h, tl), NEG_INF, dtype=torch.float32)
    l = q.new_zeros((b, h, tl), dtype=torch.float32)
    kv = torch.stack([k, v])  # one block, one exchange
    diag = None
    if causal:
        pos = torch.arange(tl, device=q.device)
        diag = pos[None, :] <= pos[:, None]
    for step in range(n):
        if step:
            kv = ring_shift(kv, group)
        src = (idx - step) % n
        if causal and src > idx:  # fully masked: no products
            o = _Join.apply(o, kv)
            continue
        kb = _repeat_kv(kv[0], n_rep).float().permute(0, 2, 3, 1)
        vb = _repeat_kv(kv[1], n_rep).float().transpose(1, 2)
        s = product(qh, kb) * scale  # [B, H, Tl, Tl]
        if causal and src == idx:
            s = torch.where(diag, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        o = o * alpha[..., None] + product(p, vb)
        l = l * alpha + p.sum(dim=-1)
        m = m_new
    out = o / l[..., None]
    return out.transpose(1, 2).to(v.dtype)
