"""Parameter and optimizer-state sharding: the port of the JAX package's
``parallel/sharding.py``, the FSDP strategy table.

  full_shard     (ZeRO-3): params, grads and optimizer state sharded;
  shard_grad_op  (ZeRO-2): params replicated, grads and optimizer state
                 sharded;
  shard_opt      (ZeRO-1): optimizer state sharded only;
  no_shard       (DDP): everything replicated.

A leaf's spec is JAX's ``PartitionSpec`` as a tuple: one entry per dim,
"fsdp" on the dim the fsdp axis splits, None elsewhere; ``()`` for a
replicated leaf. The rule is JAX's ``_leaf_spec``: the largest dim >=
``min_dim`` that the fsdp size divides (and longer than 1), ties to the
last; none such, and the leaf stays replicated. The port's per-layer
block leaves are JAX's stacked ``[L, ...]`` leaves with L dropped, as
JAX's own explicit step drops it for its per-layer gathers; so a block
leaf's spec is JAX's without its leading None, and the embedding tables
(wte, wpe) shard from dim 1, as in JAX. The tensor and expert rules have
no counterpart yet (``MeshConfig`` refuses those axes).

``shard_train_state`` keeps, on each rank, only its slice of every
sharded leaf and of its Adam moments: with F = fsdp, rank f holds
elements [f * n / F, (f + 1) * n / F) of the sharded dim — per leaf,
the same element count as JAX's device shard (per stacked leaf, summed
over layers). It returns the state and its ``StateSharding``, which
the step, the checkpoint and the trainer read.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from pytorch_distributed_tpu_torch.config import MeshConfig
from pytorch_distributed_tpu_torch.train.state import TrainState
from pytorch_distributed_tpu_torch.utils import tree

REPLICATED: tuple = ()


def _leaf_spec(shape: tuple[int, ...], mesh_cfg: MeshConfig, *,
               shard_fsdp: bool, min_dim: int = 0) -> tuple:
    if not shape or not shard_fsdp or mesh_cfg.fsdp <= 1:
        return REPLICATED
    best_dim, best_size = None, 0
    for i, s in enumerate(shape):
        if i >= min_dim and s % mesh_cfg.fsdp == 0 and s >= best_size \
                and s > 1:
            best_dim, best_size = i, s
    if best_dim is None:
        return REPLICATED
    return tuple("fsdp" if i == best_dim else None
                 for i in range(len(shape)))


def _min_dim(path) -> int:
    """Embedding tables shard their embedding dim only (JAX's min_dim=1);
    block leaves have no layer dim to skip here."""
    return 1 if path and path[-1] in ("wte", "wpe") else 0


def param_partition_specs(params, mesh_cfg: MeshConfig, *,
                          for_grads: bool = False):
    """The spec tree of ``params`` under the strategy; ``for_grads``: the
    gradients' (sharded under shard_grad_op too)."""
    shard = mesh_cfg.strategy == "full_shard" or (
        for_grads and mesh_cfg.strategy == "shard_grad_op")
    return tree.map_tree_with_path(
        lambda path, p: _leaf_spec(tuple(p.shape), mesh_cfg,
                                   shard_fsdp=shard,
                                   min_dim=_min_dim(path)),
        params)


def opt_state_partition_specs(opt_state: dict, mesh_cfg: MeshConfig):
    """Adam's moments mirror the params, sharded under every strategy but
    no_shard; the counts are replicated."""
    shard = mesh_cfg.strategy in ("full_shard", "shard_grad_op", "shard_opt")
    out = {}
    for k, v in opt_state.items():
        if k in ("mu", "nu"):
            out[k] = tree.map_tree_with_path(
                lambda path, p: _leaf_spec(tuple(p.shape), mesh_cfg,
                                           shard_fsdp=shard,
                                           min_dim=_min_dim(path)), v)
        else:
            out[k] = REPLICATED
    return out


class StateSharding(NamedTuple):
    """How a train state is laid out over a mesh (JAX's
    ``state_shardings``): the spec trees of the params and of the
    optimizer state, with the mesh."""

    mesh: object
    params: object
    opt_state: dict


def shard_dim(spec: tuple) -> int | None:
    return spec.index("fsdp") if "fsdp" in spec else None


def shard_slice(full: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """This rank's slice of a full leaf (a view; the full leaf for a
    replicated spec)."""
    dim = shard_dim(spec)
    if dim is None:
        return full
    f = mesh.cfg.fsdp
    size = full.shape[dim] // f
    return full.narrow(dim, mesh.axis_index("fsdp") * size, size)


def full_shape(shard: torch.Tensor, spec: tuple, fsdp: int) -> tuple:
    """The global shape of a leaf from one rank's shard."""
    shape = list(shard.shape)
    dim = shard_dim(spec)
    if dim is not None:
        shape[dim] *= fsdp
    return tuple(shape)


def state_sharding(state: TrainState, mesh) -> StateSharding:
    """The specs of a full (unsharded) train state under ``mesh``."""
    return StateSharding(
        mesh, param_partition_specs(state.params, mesh.cfg),
        opt_state_partition_specs(state.opt_state, mesh.cfg))


def _take(t, spec, mesh):
    return t if shard_dim(spec) is None else \
        shard_slice(t, spec, mesh).contiguous().clone()


def shard_train_state(state: TrainState, mesh
                      ) -> tuple[TrainState, StateSharding]:
    """Keep this rank's slice of each sharded leaf of a full train state
    (the same full state on every rank: built from one seed, or loaded).
    Returns (sharded state, its ``StateSharding``)."""
    sharding = state_sharding(state, mesh)
    params = tree.map_tree2(lambda p, s: _take(p, s, mesh), state.params,
                            sharding.params)
    opt = dict(state.opt_state)
    for k in ("mu", "nu"):
        opt[k] = tree.map_tree2(lambda p, s: _take(p, s, mesh), opt[k],
                                sharding.opt_state[k])
    return state._replace(params=params, opt_state=opt), sharding


def local_numel(state: TrainState) -> dict:
    """Elements this rank holds: {"params", "mu", "nu"} (the per-device
    counts JAX's shards have)."""
    return {
        "params": sum(p.numel() for p in tree.leaves(state.params)),
        "mu": sum(p.numel() for p in tree.leaves(state.opt_state["mu"])),
        "nu": sum(p.numel() for p in tree.leaves(state.opt_state["nu"])),
    }
