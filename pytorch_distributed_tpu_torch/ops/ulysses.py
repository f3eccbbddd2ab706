"""Ulysses (DeepSpeed-style) all-to-all sequence parallelism.

The port of the JAX package's ``ops/ulysses.py`` on ``torch.distributed``.
Where the ring (``ops/ring_attention``) keeps the sequence split and
streams K/V blocks around the ranks, Ulysses re-shards once a call:

    [B, T/n, H, D]  --all-to-all-->  [B, T, H/n, D]
    full-sequence attention on this rank's head group
    [B, T, H/n, D]  --all-to-all-->  [B, T/n, H, D]

Inside, the local attention sees the whole sequence, so the causal mask
and the softmax are the single-device computation on a head group.

- **The all-to-all** (``all_to_all``) is an autograd function whose
  backward is the reverse all-to-all, as JAX's AD transposes
  ``lax.all_to_all``: one ``all_to_all_single`` on the group, issued in
  the same order on every rank; through host memory for CUDA tensors on
  a gloo group (``ring_attention.staged``). ``all_to_alls`` counts them.
- **Heads**: n must divide both H and Hkv (JAX's message otherwise). KV
  heads scatter as the query heads do, so a rank's H/n query heads read
  its Hkv/n KV heads in GQA's grouping.
- **The local backend**: under ``impl="flash"`` with no attention dropout
  it is ``ops/attention.flash_attention``, the flash kernels K1 (forward)
  and K2 (backward) at ``[B, H/n, T, D]``, which is what JAX's
  ``pallas_flash.flash_attention`` reaches on its accelerator. A shape the
  kernels do not take raises there; nothing falls back. With attention
  dropout drawn the local backend is naive attention, with JAX's warning,
  and this rank's seq index is folded into the mask's stream (the
  ``seq`` field of ``utils/prng.StreamId``; JAX folds
  ``axis_index(axis_name)`` into the key), so head groups on different
  ranks draw their own masks.
"""

from __future__ import annotations

import warnings

import torch
import torch.distributed as dist

from pytorch_distributed_tpu_torch.ops.ring_attention import staged
from pytorch_distributed_tpu_torch.utils.prng import StreamId

all_to_alls = 0  # all-to-alls issued by this module


def _all_to_all(x: torch.Tensor, group, split: int,
                concat: int) -> torch.Tensor:
    """JAX's tiled ``all_to_all``: ``x`` cut into n chunks along
    ``split``, chunk j sent to group rank j; the chunks received, rank i's
    at place i, joined along ``concat``."""
    global all_to_alls
    all_to_alls += 1
    n = dist.get_world_size(group)
    send = torch.stack(x.detach().chunk(n, dim=split))
    stage = staged(group, send)
    if stage:
        send = send.cpu()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    if stage:
        recv = recv.to(x.device)
    return torch.cat(recv.unbind(0), dim=concat)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split, concat):
        ctx.group, ctx.split, ctx.concat = group, split, concat
        return _all_to_all(x, group, split, concat)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.group, ctx.concat, ctx.split), None, \
            None, None


def all_to_all(x: torch.Tensor, group, split: int,
               concat: int) -> torch.Tensor:
    """Differentiable ``_all_to_all``; its backward the reverse one."""
    return _AllToAll.apply(x, group, split, concat)


def heads_to_seq(x: torch.Tensor, group) -> torch.Tensor:
    """[B, T/n, H, D] -> [B, T, H/n, D]."""
    return all_to_all(x, group, 2, 1)


def seq_to_heads(x: torch.Tensor, group) -> torch.Tensor:
    """[B, T, H/n, D] -> [B, T/n, H, D]."""
    return all_to_all(x, group, 1, 2)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      *, group, causal: bool = True, impl: str = "naive",
                      dropout_rate: float = 0.0,
                      dropout_sid: StreamId | None = None,
                      deterministic: bool = True) -> torch.Tensor:
    """q [B, T/n, H, D], k and v [B, T/n, Hkv, D] (this rank's slice of
    the sequence over ``group``) -> [B, T/n, H, D]. ``impl`` picks the
    local full-sequence backend (module docstring)."""
    from pytorch_distributed_tpu_torch.ops.attention import (
        flash_attention,
        naive_attention,
    )

    n = dist.get_world_size(group)
    h, hkv = q.shape[2], k.shape[2]
    if h % n or hkv % n:
        raise ValueError(
            f"ulysses needs the mesh axis ({n}) to divide both head counts "
            f"(H={h}, Hkv={hkv}); use ring attention (or repeat KV heads) "
            "otherwise")
    qh, kh, vh = (heads_to_seq(x, group) for x in (q, k, v))
    dropout_active = not deterministic and dropout_rate > 0.0
    if impl == "flash" and dropout_active:
        warnings.warn(
            "ulysses_attention: impl='flash' with active attention "
            "dropout falls back to NAIVE attention (flash has no dropout "
            f"support) — O(T^2) score memory at T={q.shape[1] * n} "
            "global sequence length; set attn_pdrop=0.0 to keep flash",
            stacklevel=2)
    if impl == "flash" and not dropout_active:
        out = flash_attention(qh, kh, vh, causal=causal)
    else:
        if dropout_active and dropout_sid is not None:
            dropout_sid = dropout_sid._replace(
                seq=1 + dist.get_rank(group))
        out = naive_attention(qh, kh, vh, causal=causal,
                              dropout_rate=dropout_rate,
                              dropout_sid=dropout_sid,
                              deterministic=deterministic)
    return seq_to_heads(out, group)
