"""The ZeRO building blocks: the port of the JAX package's
``parallel/zero.py`` on ``torch.distributed``.

JAX writes these inside ``shard_map`` as ``lax.all_gather``,
``psum_scatter`` and ``psum`` over the mesh's "fsdp" axis; here they are
``all_gather_into_tensor``, ``reduce_scatter_tensor`` and ``all_reduce``
calls on the mesh's fsdp process group (``parallel/mesh``), one per leaf
(or per bucket), in the same order on every rank. Those calls gather and
scatter along dim 0, so a leaf sharded on another dim is moved there and
back (``movedim`` and a contiguous copy: plain tensor ops).

- ``gather_params`` all-gathers each sharded leaf through ``GatherParams``,
  an autograd function whose backward is the reduce-scatter (sum): the
  transpose pair JAX gets from AD, so a gathered leaf's gradient arrives
  on the shard already summed over the fsdp ranks. ``LayerGather`` is
  that gather for one layer's leaves as a ``block_transform``, and its
  ``issue`` starts the same gathers asynchronously (``async_op=True``),
  each finished by ``WaitGather`` when its layer runs: the prefetch
  window of ``ops/layer_scan``.
- ``scatter_grads`` reduce-scatters each sharded leaf (sum) and
  all-reduces the others, and ``scatter_grads_bucketed`` does it in about
  ``n_buckets`` collectives: each leaf's sharded dim moved first and
  reshaped to [F, -1], concatenated per dtype, one reduce-scatter per
  bucket, the pieces cut back out (the same sums, moved together).
- ``fsdp_slice`` is a view of this rank's fsdp slice; ``unscatter``
  rebuilds the leaf whole over fsdp with an all-gather (JAX sums
  zero-padded slices there for its replication typing, which this port
  has no use for: the values are the same), and ``unshard`` gathers the
  expert and tensor dims too (the full leaf, for a checkpoint).
- ``global_norm_sharded`` sums each leaf's squares once: over the fsdp,
  tensor and expert groups it is sharded on, replicated leaves' on every
  rank alike; under a pipe axis a stage's own leaves (its layers) are
  summed over the pipe group too.
- ``unstage_blocks``: every stage's layers, in order, on every rank of a
  pipe group (an all-gather per leaf; the checkpoint's and ``evaluate``'s
  whole model).
- A leaf that is also tensor- or expert-sharded is gathered and
  scattered along its fsdp dim only: the tensor or expert dim is another
  dim of the same leaf, and each tensor (expert) rank's fsdp group holds
  that rank's tensor slices (experts).
- ``clip_by_global_norm_typed`` scales every gradient by min(1, clip /
  norm) with the reduced norm (``train/optim.clip_by_global_norm_``, the
  optimizer's own clip).
- ``zero_sharded_update``: ZeRO-2/1's Adam update on this rank's slice of
  the replicated params (views: the update writes into the full leaf)
  against the sharded moments, then the params all-gathered.

gloo takes all three collectives on CUDA tensors (staged through the
host; PyTorch 2.11 on an H100) and on CPU tensors, so nothing is
composed from other collectives. ``collectives`` counts the calls this
module issues (a trace's collective rows are held to it).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from pytorch_distributed_tpu_torch.parallel.sharding import (
    fsdp_slice,
    shard_dim,
)
from pytorch_distributed_tpu_torch.train.optim import (
    Optimizer,
    clip_by_global_norm_,
    global_norm,
)
from pytorch_distributed_tpu_torch.utils import tree

collectives = 0  # collective calls issued by this module

# PyTorch 2.13 renamed the two tensor collectives (the old names warn);
# PyTorch 2.11, the card's, has only the old ones.
_all_gather = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) or \
    dist.reduce_scatter_tensor


def _count() -> None:
    global collectives
    collectives += 1


def all_reduce_(t: torch.Tensor, group) -> torch.Tensor:
    """Sum ``t`` over ``group``, in place."""
    _count()
    dist.all_reduce(t, group=group)
    return t


def all_gather_dim(shard: torch.Tensor, dim: int, group,
                   n: int) -> torch.Tensor:
    """The ``n`` ranks' shards concatenated along ``dim``, rank order."""
    src = shard.movedim(dim, 0).contiguous()
    out = src.new_empty((n * src.shape[0], *src.shape[1:]))
    _count()
    _all_gather(out, src, group=group)
    return out.movedim(0, dim)


def reduce_scatter_dim(full: torch.Tensor, dim: int, group,
                       n: int) -> torch.Tensor:
    """This rank's slice along ``dim`` of the sum over ``group``."""
    src = full.movedim(dim, 0).contiguous()
    out = src.new_empty((src.shape[0] // n, *src.shape[1:]))
    _count()
    _reduce_scatter(out, src, group=group)
    return out.movedim(0, dim).contiguous()


class GatherParams(torch.autograd.Function):
    """Forward: all-gather along ``dim``; backward: reduce-scatter (sum)."""

    @staticmethod
    def forward(ctx, shard, dim, group, n):
        ctx.dim, ctx.group, ctx.n = dim, group, n
        return all_gather_dim(shard, dim, group, n)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter_dim(g, ctx.dim, ctx.group, ctx.n), None, \
            None, None


class _InFlight:
    """An all-gather started with ``async_op=True``: its work handle and
    output buffer, kept alive until ``WaitGather`` waits on it."""

    def __init__(self, shard, dim, group, n):
        src = shard.detach().movedim(dim, 0).contiguous()
        self.out = src.new_empty((n * src.shape[0], *src.shape[1:]))
        self.dim, self.group, self.n = dim, group, n
        _count()
        self.work = _all_gather(self.out, src, group=group, async_op=True)


class WaitGather(torch.autograd.Function):
    """Forward: wait for ``pending`` (an ``_InFlight`` gather of
    ``shard``) and return the gathered leaf; backward: reduce-scatter
    (sum), as ``GatherParams``."""

    @staticmethod
    def forward(ctx, shard, pending):
        ctx.dim, ctx.group, ctx.n = pending.dim, pending.group, pending.n
        pending.work.wait()
        out = pending.out.movedim(0, pending.dim)
        pending.out = pending.work = None
        return out

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter_dim(g, ctx.dim, ctx.group, ctx.n), None


class LayerGather:
    """ZeRO-3's ``block_transform`` for one layer's leaves laid out by
    ``specs``: calling it gathers them now (``gather_params``); ``issue``
    starts the same gathers without waiting and returns a function that
    waits and gives the gathered leaves (``ops/layer_scan``'s window).
    Decode uses it too: leaves that need no gradient record no graph."""

    def __init__(self, specs, mesh):
        self.specs, self.mesh = specs, mesh

    def __call__(self, bp):
        return gather_params(bp, self.specs, self.mesh)

    def issue(self, bp):
        group, n = self.mesh.axis_group("fsdp"), self.mesh.cfg.fsdp

        def start(leaf, spec):
            dim = shard_dim(spec)
            return leaf if dim is None else (leaf,
                                             _InFlight(leaf, dim, group, n))

        pending = tree.map_tree2(start, bp, self.specs)
        return lambda: _map_pending(
            lambda p: WaitGather.apply(*p) if isinstance(p, tuple) else p,
            pending)


def _map_pending(fn, t):
    """``tree.map_tree`` with a (shard, in-flight gather) pair as a leaf."""
    if isinstance(t, dict):
        return {k: _map_pending(fn, v) for k, v in t.items()}
    if isinstance(t, list):
        return [_map_pending(fn, v) for v in t]
    return fn(t)


def gather_params(params, specs, mesh):
    """Each sharded leaf gathered over the fsdp group (differentiable)."""
    n = mesh.cfg.fsdp

    def gather(leaf, spec):
        dim = shard_dim(spec)
        if dim is None:
            return leaf
        return GatherParams.apply(leaf, dim, mesh.axis_group("fsdp"), n)

    return tree.map_tree2(gather, params, specs)


def scatter_grads(grads: list, specs: list, mesh) -> list:
    """Each gradient summed over the fsdp ranks: sharded leaves
    reduce-scattered onto their shards, the others all-reduced."""
    group, n = mesh.axis_group("fsdp"), mesh.cfg.fsdp
    out = []
    for g, spec in zip(grads, specs):
        dim = shard_dim(spec)
        out.append(all_reduce_(g, group) if dim is None
                   else reduce_scatter_dim(g, dim, group, n))
    return out


def scatter_grads_bucketed(grads: list, specs: list, mesh,
                           n_buckets: int) -> list:
    """``scatter_grads`` in about ``n_buckets`` reduce-scatters per dtype
    (module docstring); numerically the same."""
    group, n = mesh.axis_group("fsdp"), mesh.cfg.fsdp
    out: list = [None] * len(grads)
    by_dtype: dict = {}
    for i, (g, spec) in enumerate(zip(grads, specs)):
        if shard_dim(spec) is None:
            out[i] = all_reduce_(g, group)
        else:
            by_dtype.setdefault(g.dtype, []).append(i)
    for idxs in by_dtype.values():
        total = sum(grads[i].numel() for i in idxs)
        target = -(-total // max(1, n_buckets))
        buckets: list[list[int]] = [[]]
        filled = 0
        for i in idxs:
            if filled >= target and buckets[-1]:
                buckets.append([])
                filled = 0
            buckets[-1].append(i)
            filled += grads[i].numel()
        for bucket in buckets:
            moved = [grads[i].movedim(shard_dim(specs[i]), 0)
                     for i in bucket]
            flat = torch.cat([m.reshape(n, -1) for m in moved], dim=1)
            piece = flat.new_empty(flat.shape[1])
            _count()
            _reduce_scatter(piece, flat.reshape(-1), group=group)
            off = 0
            for i, m in zip(bucket, moved):
                width = m.numel() // n
                shard = piece[off:off + width].reshape(
                    (m.shape[0] // n, *m.shape[1:]))
                out[i] = shard.movedim(0, shard_dim(specs[i])).contiguous()
                off += width
    return out


def unscatter(shard: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """The leaf whole over fsdp from every fsdp rank's shard (the inverse
    of ``fsdp_slice``)."""
    dim = shard_dim(spec)
    if dim is None:
        return shard
    return all_gather_dim(shard, dim, mesh.axis_group("fsdp"),
                          mesh.cfg.fsdp)


def unshard(shard: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """The full leaf from every rank's slice along every axis ``spec``
    names (the inverse of ``shard_slice``): fsdp, then expert and
    tensor."""
    full = unscatter(shard, spec, mesh)
    for axis in ("expert", "tensor"):
        dim = shard_dim(spec, axis)
        if dim is not None:
            full = all_gather_dim(full, dim, mesh.axis_group(axis),
                                  mesh.axis_size(axis))
    return full


def global_norm_sharded(grads: list, specs: list, mesh,
                        staged: list | None = None) -> torch.Tensor:
    """The global norm of gradients laid out by ``specs``: each leaf's
    squares summed over exactly the axes it is sharded on (fsdp, tensor
    and expert, and pipe for a leaf ``staged`` marks as a stage's own: one
    all-reduce per axis per bucket of leaves sharded alike, as JAX's
    buckets), a replicated leaf counted once. With no sharded leaf it is
    ``train/optim.global_norm`` itself."""
    buckets: dict = {}
    piped = mesh.axis_size("pipe") > 1
    for i, (g, s) in enumerate(zip(grads, specs)):
        axes = tuple(ax for ax in ("fsdp", "tensor", "expert")
                     if ax in s and mesh.axis_size(ax) > 1)
        if piped and staged is not None and staged[i]:
            axes = ("pipe",) + axes
        buckets.setdefault(axes, []).append(g)
    if set(buckets) <= {()}:
        return global_norm(buckets.get((), []))
    sq = None
    # The sharded buckets first, the replicated leaves last.
    for axes in sorted(buckets, key=lambda a: (not a, len(a), a)):
        val = global_norm(buckets[axes]).square()
        for ax in axes:
            all_reduce_(val, mesh.axis_group(ax))
        sq = val if sq is None else sq + val
    return sq.sqrt()


def unstage_blocks(blocks: list, mesh) -> list:
    """Every stage's layers in layer order, from each stage's ``blocks``
    (the same number of layers, shaped alike, on every stage): one
    all-gather over the pipe group per leaf (no autograd). Without a pipe
    axis, ``blocks`` itself."""
    n = mesh.axis_size("pipe")
    if n == 1:
        return blocks
    group = mesh.axis_group("pipe")
    gathered = [tree.map_tree(
        lambda t: all_gather_dim(t.detach().unsqueeze(0), 0, group, n), bp)
        for bp in blocks]
    return [tree.map_tree(lambda t, s=s: t[s], bp)
            for s in range(n) for bp in gathered]


def clip_by_global_norm_typed(grads: list, grad_norm: torch.Tensor,
                              clip_norm: float) -> None:
    """Clip in place against the already-reduced global norm: the same
    scale on every rank."""
    clip_by_global_norm_(grads, grad_norm, clip_norm)


def zero_sharded_update(tx: Optimizer, params, opt_state: dict,
                        grads: list, shard_specs, mesh, strategy: str, *,
                        anomaly: torch.Tensor | None = None):
    """ZeRO-2 / ZeRO-1: the update of this rank's slice of the replicated
    ``params`` against the sharded ``opt_state``, then the params
    re-gathered. "shard_grad_op" grads arrive reduce-scattered (shards);
    "shard_opt" grads arrive all-reduced (full) and are sliced here.
    Returns (params, opt_state): the same params tensors, updated."""
    specs = tree.leaves(shard_specs)
    full = tree.leaves(params)
    # The params and full gradients are this rank's tensor slices already:
    # only their fsdp dim is cut here.
    shards = [fsdp_slice(p, s, mesh) for p, s in zip(full, specs)]
    if strategy == "shard_opt":
        grads = [fsdp_slice(g, s, mesh) for g, s in zip(grads, specs)]
    _, opt_state = tx.update(grads, opt_state,
                             tree.unflatten(params, shards),
                             anomaly=anomaly)
    with torch.no_grad():
        for p, shard, spec in zip(full, shards, specs):
            if shard_dim(spec) is not None:
                p.copy_(unscatter(shard, spec, mesh))
    return params, opt_state
