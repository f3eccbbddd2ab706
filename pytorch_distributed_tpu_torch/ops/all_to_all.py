"""JAX's tiled ``lax.all_to_all`` on ``torch.distributed``: the one
exchange the port's all-to-all users share — ``ops/ulysses`` (heads <->
sequence) and ``ops/moe`` (each expert's slots to the rank that owns the
expert, and back).

``all_to_all(x, group, split, concat)`` cuts ``x`` into n chunks along
``split`` (n the group's size), sends chunk j to group rank j, and joins
the n chunks received, rank i's at place i, along ``concat``. It is an
autograd function whose backward is the reverse exchange (``concat`` cut,
``split`` joined), as JAX's AD transposes ``lax.all_to_all``. One
``all_to_all_single`` on the group per exchange, issued in the same order
on every rank; a CUDA tensor on a gloo group goes through host memory
(``ring_attention.staged``: gloo's own collectives take host tensors).

``count``: called once for every exchange issued, forward or backward, so
each caller keeps its own counter (``ulysses.all_to_alls``,
``moe.all_to_alls``).
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from pytorch_distributed_tpu_torch.ops.ring_attention import staged


def _exchange(x: torch.Tensor, group, split: int, concat: int,
              count: Callable[[], None] | None) -> torch.Tensor:
    if count is not None:
        count()
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
    def forward(ctx, x, group, split, concat, count):
        ctx.group, ctx.split, ctx.concat, ctx.count = group, split, concat, \
            count
        return _exchange(x, group, split, concat, count)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.group, ctx.concat, ctx.split, ctx.count), \
            None, None, None, None


def all_to_all(x: torch.Tensor, group, split: int, concat: int,
               count: Callable[[], None] | None = None) -> torch.Tensor:
    """The exchange (module docstring), differentiable."""
    return _AllToAll.apply(x, group, split, concat, count)
