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
(wte, wpe) shard from dim 1, as in JAX.

The tensor axis (``_TENSOR_RULES``, JAX's Megatron placement): the
column-parallel projections (QKV, the MLP's up projections, the MoE
experts' ``w_in``/``w_gate``) shard their output dim, the row-parallel
ones that follow (``c_proj``/``wo``/``down``/``w_out``) their input dim,
so one all-reduce after each row-parallel product is the only forward
collective. JAX's dims count the stacked layer dim; the port's per-layer
leaves take each dim minus one. GPT-2's fused QKV kernel [E, 3, H, D]
shards its HEAD dim, never a flat 3E split, so q, k and v stay
head-aligned on every rank. The tensor rule claims its dim first, then
fsdp shards the largest remaining divisible dim (JAX's combined spec). A
tensor dim the axis does not divide is refused, as in JAX. The expert
axis has no rules yet (``MeshConfig`` refuses it, ROADMAP queue 1 item
7(e)). ``shard_params`` keeps this rank's slice of every sharded leaf of
full params, along every axis its spec names.

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

# Megatron tensor-parallel placement (JAX's ``_TENSOR_RULES``), keyed by
# param-path suffix: the dim of a PER-LAYER block leaf the tensor axis
# splits (JAX's stacked dim minus one).
_TENSOR_RULES: dict[tuple[str, ...], int] = {
    # gpt2: the fused QKV kernel [E, 3, H, D] shards its head dim.
    ("attn", "c_attn", "kernel"): 2,
    ("attn", "c_attn", "bias"): 1,
    ("attn", "c_proj", "kernel"): 0,
    ("mlp", "c_fc", "kernel"): 1,
    ("mlp", "c_fc", "bias"): 0,
    ("mlp", "c_proj", "kernel"): 0,
    # llama
    ("attn", "wq"): 1,
    ("attn", "wk"): 1,
    ("attn", "wv"): 1,
    ("attn", "wo"): 0,
    ("mlp", "gate"): 1,
    ("mlp", "up"): 1,
    ("mlp", "down"): 0,
    # MoE experts [X, D, F] / [X, F, D]: TP inside each expert on F; the
    # router stays replicated (routing must agree across tensor ranks).
    ("mlp", "w_in"): 2,
    ("mlp", "w_gate"): 2,
    ("mlp", "w_out"): 1,
}


def _tensor_dim(path) -> int | None:
    keys = tuple(k for k in path if isinstance(k, str))
    for n in (3, 2):
        if len(keys) >= n and keys[-n:] in _TENSOR_RULES:
            return _TENSOR_RULES[keys[-n:]]
    return None


def _leaf_spec(shape: tuple[int, ...], mesh_cfg: MeshConfig, *,
               shard_fsdp: bool, min_dim: int = 0, path=()) -> tuple:
    """The combined tensor + fsdp spec of one leaf: the tensor rule (if
    any) claims its dim, then fsdp shards the largest remaining divisible
    dim >= ``min_dim`` (ties to the last)."""
    if not shape:
        return REPLICATED
    spec: list = [None] * len(shape)
    tdim = _tensor_dim(path) if mesh_cfg.tensor > 1 else None
    if tdim is not None:
        if shape[tdim] % mesh_cfg.tensor:
            raise ValueError(
                f"tensor-parallel dim {tdim} of param "
                f"{'/'.join(map(str, path))} (shape {shape}) is not "
                f"divisible by tensor={mesh_cfg.tensor}")
        spec[tdim] = "tensor"
    if shard_fsdp and mesh_cfg.fsdp > 1:
        best_dim, best_size = None, 0
        for i, s in enumerate(shape):
            if i >= min_dim and spec[i] is None and \
                    s % mesh_cfg.fsdp == 0 and s >= best_size and s > 1:
                best_dim, best_size = i, s
        if best_dim is not None:
            spec[best_dim] = "fsdp"
    if all(ax is None for ax in spec):
        return REPLICATED
    return tuple(spec)


def _min_dim(path) -> int:
    """Embedding tables shard their embedding dim only (JAX's min_dim=1);
    block leaves have no layer dim to skip here."""
    return 1 if path and path[-1] in ("wte", "wpe") else 0


def param_partition_specs(params, mesh_cfg: MeshConfig, *,
                          for_grads: bool = False):
    """The spec tree of ``params`` under the strategy; ``for_grads``: the
    gradients' (sharded under shard_grad_op too). The tensor axis shards
    under every strategy (TP is orthogonal to the ZeRO level)."""
    shard = mesh_cfg.strategy == "full_shard" or (
        for_grads and mesh_cfg.strategy == "shard_grad_op")
    return tree.map_tree_with_path(
        lambda path, p: _leaf_spec(tuple(p.shape), mesh_cfg,
                                   shard_fsdp=shard,
                                   min_dim=_min_dim(path), path=path),
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
                                           min_dim=_min_dim(path),
                                           path=path), v)
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
    """This rank's slice of a full leaf along every axis ``spec`` names (a
    view; the full leaf for a replicated spec)."""
    for dim, axis in enumerate(spec):
        if axis is not None:
            size = full.shape[dim] // mesh.axis_size(axis)
            full = full.narrow(dim, mesh.axis_index(axis) * size, size)
    return full


def shard_params(params, specs, mesh):
    """This rank's slices of full ``params`` under the spec tree ``specs``
    (contiguous copies of the sharded leaves, the replicated ones as
    given)."""
    return tree.map_tree2(lambda p, s: _take(p, s, mesh), params, specs)


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
    return t if not spec else shard_slice(t, spec, mesh).contiguous().clone()


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
