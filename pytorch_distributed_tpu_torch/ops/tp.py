"""Megatron-style tensor-parallel conjugate operators (the f / g pair):
the port of the JAX package's ``ops/tp.py`` on ``torch.distributed``.

Tensor parallelism needs exactly two communication-bearing ops
(Megatron-LM section 3, the ``f`` and ``g`` conjugates):

- ``tp_copy`` (f): the identity forward (the activation entering a
  column-parallel region is used by every tensor rank) and an all-reduce
  backward (each rank's gradient covers only its own heads and columns).
- ``tp_reduce`` (g): an all-reduce forward (a row-parallel product is a
  partial sum over the sharded contracting dim) and the identity backward
  (the reduced activation's gradient is already whole on every rank).

Biases of row-parallel projections go AFTER ``tp_reduce``: they are
replicated, and adding them before the sum would count them tensor-ways.
Both ops are no-ops when ``group`` is None, so model code threads an
optional tensor group straight through. JAX writes them as ``psum`` over a
``shard_map`` axis; here they are ``all_reduce`` calls on the mesh's tensor
process group (``parallel/mesh``), in the same order on every rank.

Decode runs them under ``torch.no_grad``: ``tp_reduce`` then sums its
input IN PLACE (a fresh product nothing else holds) and returns it, with
no autograd node. ``collectives`` counts the all-reduces this module
issues, as ``parallel.zero.collectives`` counts its own.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

collectives = 0  # all-reduces issued by this module


def _all_reduce_(t: torch.Tensor, group) -> torch.Tensor:
    global collectives
    collectives += 1
    dist.all_reduce(t, group=group)
    return t


class _TpCopy(torch.autograd.Function):
    """Forward: the identity; backward: all-reduce (sum)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce_(g.contiguous().clone(), ctx.group), None


class _TpReduce(torch.autograd.Function):
    """Forward: all-reduce (sum); backward: the identity."""

    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce_(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def tp_copy(x: torch.Tensor, group) -> torch.Tensor:
    """Identity forward, all-reduce backward (Megatron f); a no-op when
    ``group`` is None."""
    if group is None:
        return x
    return _TpCopy.apply(x, group)


def tp_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """All-reduce forward, identity backward (Megatron g); a no-op when
    ``group`` is None. Without autograd (decode) ``x`` is summed in place
    and returned."""
    if group is None:
        return x
    if not (torch.is_grad_enabled() and x.requires_grad):
        return _all_reduce_(x if x.is_contiguous() else x.contiguous(),
                            group)
    return _TpReduce.apply(x, group)
