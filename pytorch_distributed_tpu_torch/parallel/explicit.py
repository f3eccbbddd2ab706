"""The data-parallel train step with its collectives written out: the
port of the JAX package's ``parallel/explicit.py`` over the port's mesh
(``parallel/mesh``: ranks are processes, collectives are calls on process
groups, ``parallel/zero``). Each rank runs the port's own forward and
backward (``train/trainer``'s loss, the flash kernels K1/K2 on the card)
on its rows of the batch.

  DDP (no_shard):
    - the micro-batches' gradients are summed locally with no
      communication — the ``no_sync`` analogue;
    - one all-reduce per leaf at the accumulation boundary, then / dp;
    - the loss all-reduced and / dp (the reference's all_reduce(AVG)).

  FSDP full_shard (ZeRO-3):
    - each rank holds its shards; the embeddings and the final norm are
      gathered before the forward, each block's leaves at the start of
      that block (``block_transform``, ``zero.LayerGather``, inside the
      block's checkpoint: a remat mode gathers again in backward, as
      JAX's remat does) and dropped after it; ``prefetch_buffers`` > 0
      issues a window of layers' gathers ahead (``ops/layer_scan``), bit
      for bit the same step;
    - the gather's backward reduce-scatters (``zero.GatherParams``), so
      the shards' gradients arrive summed over fsdp, once per
      micro-batch as in JAX (the forward needs the gathered params, so
      ZeRO-3 cannot defer its communication to the boundary); / fsdp,
      leaves no dim of which fsdp divides all-reduced; then / data over
      the data group;
    - the update runs on the shards.

  FSDP shard_grad_op (ZeRO-2): params replicated; at the boundary the
    gradients reduce-scatter onto the moments' shards (``rs_buckets`` > 0:
    in buckets), / fsdp, / data; Adam on this rank's slice; the params
    all-gathered.

  FSDP shard_opt (ZeRO-1): gradients all-reduced as in DDP; each rank
    updates its slice against its moments' shard; params all-gathered.

  Tensor parallelism (the tensor axis, Megatron): the block leaves are
    this rank's heads and columns (``parallel/sharding``); the model runs
    on them with the tensor group (``tp_group``: ``tp_copy`` after each
    norm, one all-reduce after each row-parallel projection, its backward
    one all-reduce per ``tp_copy``). It composes with every strategy
    above: the gradients and the loss reduce over the batch axes only
    (data and fsdp, the mesh's ``batch_group``), since a replicated
    leaf's gradient comes out the same on every tensor rank through
    ``tp_copy``'s backward and a sharded leaf's is its rank's own.
    Attention dropout under it follows ``tensor_dropout``: "reject"
    raises (GPT-2 only: the Llama family draws no dropout), as JAX does;
    "folded" folds the tensor index into the attention masks only
    (``parallel/mesh.fold_tensor_key``).

  Sequence parallelism (the seq axis): each rank holds a span of every
    sequence of its rows (``parallel/mesh.make_batch_put``) and the params
    whole; attention crosses the spans by ring or Ulysses
    (``cfg.seq_impl``, the model's ``seq_group``), and the seq index is
    folded into the dropout key with the batch shard's. Each rank's loss
    is the mean over its tokens, so the gradients are averaged over seq
    after the batch axes and the loss over seq before them (JAX's
    ``pmean``s, in JAX's order). A ring refuses attention dropout (GPT-2
    only), and Ulysses needs seq to divide a rank's head counts (H /
    tensor and Hkv / tensor): both raise when the step is built
    (``check_seq``). MoE routes each rank's local tokens, capacity
    counted per span, as JAX does. It composes with every strategy and
    with the tensor axis.

  Expert parallelism (the expert axis; an MoE model whose ``n_experts``
    the axis divides, ``check_expert``): the axis splits the batch's rows
    like data, and each rank holds ``n_experts / expert`` experts of every
    MoE layer (``parallel/sharding``'s expert rule); two all-to-alls a MoE
    layer move each token's slots to their expert's owner and back (the
    model's ``expert_group``, ``ops/moe``), capacity and the Switch term
    per rank's tokens as in JAX. At the boundary, after the batch axes
    (JAX's order): an expert-sharded leaf already holds the sum over every
    expert rank's tokens (the backward exchange routed each token's
    contribution to its expert's owner), so it is divided by ``expert``
    and never reduced over the axis, which would add different experts
    together; every other leaf is averaged over the expert group, and so
    is the loss. It composes with every strategy and with the tensor and
    seq axes.

The gradient norm is global: each leaf's squares are summed over exactly
the axes it is sharded on (fsdp, tensor and/or expert) and a replicated
leaf is counted once (``zero.global_norm_sharded``; never summed over seq,
where the gradients are equal); clipping uses it, so every rank scales
alike. The DDP-style reductions are issued over the mesh's group at every
size, a world of one included: there they are exact no-ops (a sum of one,
/ 1), and a world of one is bit-equal to the single-device step.

The anomaly guard (``make_parallel_train_step``'s ``guard``): the loss and
the norm are already global and bitwise the same on every rank (tensor
ranks included: their replicated activations are the results of the same
all-reduces; seq ranks: their gradients and loss are), so every rank
takes the same decision; the batch's id check is per rank, so its flag
is summed over the ranks first.
"""

from __future__ import annotations

from typing import Callable

import torch

from pytorch_distributed_tpu_torch.config import MeshConfig, ModelConfig
from pytorch_distributed_tpu_torch.models import ModelApi
from pytorch_distributed_tpu_torch.parallel import zero
from pytorch_distributed_tpu_torch.parallel.mesh import (
    Mesh,
    fold_batch_shard_key,
    fold_tensor_key,
)
from pytorch_distributed_tpu_torch.parallel.sharding import (
    StateSharding,
    shard_dim,
)
from pytorch_distributed_tpu_torch.train import guard as guard_lib
from pytorch_distributed_tpu_torch.train.guard import GuardConfig
from pytorch_distributed_tpu_torch.train.optim import Optimizer
from pytorch_distributed_tpu_torch.train.state import TrainState
from pytorch_distributed_tpu_torch.train.trainer import (
    _loss,
    accumulate_grads,
)
from pytorch_distributed_tpu_torch.utils import tree
from pytorch_distributed_tpu_torch.utils.prng import DropoutKey


def check_tensor_dropout(model_cfg: ModelConfig,
                         mesh_cfg: MeshConfig) -> None:
    """JAX's refusal of attention dropout under a tensor axis with
    ``tensor_dropout="reject"``: every tensor rank would draw its local
    heads' masks from one stream (correlated, and not the single-device
    draw). The Llama family draws no dropout, so it is never refused."""
    if (mesh_cfg.tensor > 1 and model_cfg.family == "gpt2"
            and model_cfg.attn_pdrop > 0
            and model_cfg.tensor_dropout != "folded"):
        raise NotImplementedError(
            "attention dropout is not supported with explicit tensor "
            f"parallelism (attn_pdrop={model_cfg.attn_pdrop}); set "
            "attn_pdrop=0.0 or opt into tensor_dropout='folded'")


def check_seq(model_cfg: ModelConfig, mesh_cfg: MeshConfig) -> None:
    """JAX's build-time refusals under a seq axis: attention dropout with
    the ring (GPT-2 only: the Llama family draws none), whose weights
    exist only per block inside the online softmax; and Ulysses with a
    seq size that does not divide a rank's head counts (the message of
    ``ops/ulysses``, which JAX raises at its first trace)."""
    n = mesh_cfg.seq
    if n == 1:
        return
    if (model_cfg.family == "gpt2" and model_cfg.attn_pdrop > 0
            and model_cfg.seq_impl != "ulysses"):
        raise NotImplementedError(
            "attention dropout is not supported with ring-attention "
            f"sequence parallelism (attn_pdrop={model_cfg.attn_pdrop}); "
            "set attn_pdrop=0.0 or use seq_impl='ulysses'")
    if model_cfg.seq_impl == "ulysses":
        h = model_cfg.n_head // mesh_cfg.tensor
        hkv = model_cfg.kv_heads // mesh_cfg.tensor
        if h % n or hkv % n:
            raise ValueError(
                f"ulysses needs the mesh axis ({n}) to divide both head "
                f"counts (H={h}, Hkv={hkv}); use ring attention (or repeat "
                "KV heads) otherwise")


def check_expert(model_cfg: ModelConfig, mesh_cfg: MeshConfig) -> None:
    """JAX's build-time refusals under an expert axis: a dense model, and
    an expert count the axis does not divide."""
    if mesh_cfg.expert == 1:
        return
    if not model_cfg.n_experts:
        raise ValueError("expert axis > 1 needs an MoE model (n_experts > 0)")
    if model_cfg.n_experts % mesh_cfg.expert:
        raise ValueError(f"n_experts={model_cfg.n_experts} not divisible by "
                         f"expert={mesh_cfg.expert}")


def _mean_over(ts: list, group, n: int) -> None:
    if group is None:  # not split over the group: nothing to reduce
        return
    for t in ts:
        zero.all_reduce_(t, group)
    torch._foreach_div_(ts, n)


def reduce_at_boundary(grads: list, loss: torch.Tensor, mesh: Mesh,
                       p_spec_leaves: list, shard_specs: list):
    """The accumulation boundary's collectives (module docstring): the
    gradients (this rank's, summed over its micro-batches and divided by
    their count; laid out by ``p_spec_leaves``, ZeRO-2 scattering them
    onto ``shard_specs``) reduced over fsdp by strategy, then data, then
    expert, then seq; the loss over seq, then data and fsdp, then expert.
    Returns (grads, loss), the same on every rank of the batch and seq
    axes. The pipeline step shares it (``parallel/pipeline``)."""
    cfg = mesh.cfg
    f, d, sq, e = cfg.fsdp, cfg.data, cfg.seq, cfg.expert
    data_group = mesh.axis_group("data") if d > 1 else None
    seq_group = mesh.axis_group("seq") if sq > 1 else None
    expert_group = mesh.axis_group("expert") if e > 1 else None
    if cfg.strategy == "full_shard" and f > 1:
        for g, spec in zip(grads, p_spec_leaves):
            if shard_dim(spec) is None:
                zero.all_reduce_(g, mesh.axis_group("fsdp"))
        torch._foreach_div_(grads, f)
        _mean_over(grads, data_group, d)
    elif cfg.strategy == "shard_grad_op" and f > 1:
        grads = (zero.scatter_grads_bucketed(grads, shard_specs, mesh,
                                             cfg.rs_buckets)
                 if cfg.rs_buckets > 0 else
                 zero.scatter_grads(grads, shard_specs, mesh))
        torch._foreach_div_(grads, f)
        _mean_over(grads, data_group, d)
    else:
        _mean_over(grads, mesh.batch_group, d * f)
    if expert_group is not None:
        # An expert-sharded leaf holds the sum over the expert ranks'
        # tokens already (module docstring): divided, never reduced.
        _mean_over([g for g, spec in zip(grads, p_spec_leaves)
                    if "expert" not in spec], expert_group, e)
        torch._foreach_div_([g for g, spec in zip(grads, p_spec_leaves)
                             if "expert" in spec], e)
    _mean_over(grads, seq_group, sq)
    if seq_group is not None:
        loss = zero.all_reduce_(loss.clone(), seq_group) / sq
    if mesh.batch_group is not None:
        loss = zero.all_reduce_(loss.clone(), mesh.batch_group) / (d * f)
    if expert_group is not None:
        loss = zero.all_reduce_(loss.clone(), expert_group) / e
    return grads, loss


def make_explicit_train_step(
    model: ModelApi,
    model_cfg: ModelConfig,
    tx: Optimizer,
    mesh: Mesh,
    mesh_cfg: MeshConfig,
    sharding: StateSharding,
    *,
    grad_clip_norm: float | None = None,
    accum_dtype: str = "float32",
    seed: int = 42,
    guard: GuardConfig | None = None,
) -> Callable:
    """``step(state, batch) -> (state, metrics)`` over ``mesh``: ``state``
    sharded by ``shard_train_state``, whose ``StateSharding`` is
    ``sharding`` (JAX takes the state itself: its arrays carry their
    layout, the port's shards do not); ``batch`` this rank's rows,
    "inputs"/"targets" [A, b, T] on the mesh's device. ``tx`` must be
    clip-free (``make_optimizer(cfg, with_clip=False)``): the step clips
    against the global norm itself (``grad_clip_norm``). ``seed``: the
    dropout streams' (``train/trainer.make_train_step``). Metrics: the
    global ``loss`` and ``grad_norm``, equal on every rank (and
    ``anomaly`` with ``guard``)."""
    check_tensor_dropout(model_cfg, mesh_cfg)
    check_seq(model_cfg, mesh_cfg)
    check_expert(model_cfg, mesh_cfg)
    if mesh.cfg != mesh_cfg:
        raise ValueError("mesh_cfg is not the mesh's config")
    if tx.clip is not None:
        raise ValueError("the explicit step needs a clip-free optimizer "
                         "(make_optimizer(cfg, with_clip=False)); pass "
                         "grad_clip_norm instead")
    if mesh_cfg.pipe > 1:
        raise ValueError("a pipe axis trains on the pipeline path "
                         "(parallel/pipeline.make_pipeline_train_step)")
    strategy, f = mesh_cfg.strategy, mesh_cfg.fsdp
    zero3 = strategy == "full_shard" and f > 1
    zero2 = strategy == "shard_grad_op" and f > 1
    sharded_update = strategy in ("shard_grad_op", "shard_opt") and f > 1
    p_specs = sharding.params
    # ZeRO-2/1 shard grads and moments in the layout full_shard gives the
    # params: the moments' own specs.
    shard_tree = sharding.opt_state["mu"]

    def aligned(specs, params):
        """``specs`` in the order of ``params``' leaves: a state may order
        its dict keys otherwise than the one ``sharding`` was built from
        (a tree converted from JAX's sorted keys)."""
        return tree.map_tree2(lambda _, spec: spec, params, specs)

    train_mode = (model_cfg.embd_pdrop > 0 or model_cfg.attn_pdrop > 0
                  or model_cfg.resid_pdrop > 0)
    acc_dtype = getattr(torch, accum_dtype)
    tp_group = mesh.axis_group("tensor") if mesh_cfg.tensor > 1 else None
    seq_group = mesh.axis_group("seq") if mesh_cfg.seq > 1 else None
    expert_group = (mesh.axis_group("expert") if mesh_cfg.expert > 1
                    else None)
    block_transform = (zero.LayerGather(p_specs["blocks"][0], mesh)
                       if zero3 else None)
    # A window prefetches gathers: there are none outside full_shard.
    prefetch_buffers = mesh_cfg.prefetch_buffers if zero3 else 0

    def loss_and_grads(ps, params_like, inputs, targets, key):
        live = [p.detach().requires_grad_(True) for p in ps]
        params = tree.unflatten(params_like, live)
        if zero3:
            params = {k: v if k == "blocks"
                      else zero.gather_params(v, p_specs[k], mesh)
                      for k, v in params.items()}
        key = fold_batch_shard_key(key, mesh)
        if model_cfg.tensor_dropout == "folded":
            key = fold_tensor_key(key, mesh)
        loss = _loss(model, model_cfg, params, inputs, targets,
                     deterministic=not train_mode, key=key,
                     block_transform=block_transform, tp_group=tp_group,
                     seq_group=seq_group, expert_group=expert_group,
                     prefetch_buffers=prefetch_buffers)
        grads = torch.autograd.grad(loss, live)
        return loss.detach(), list(grads)

    def step(state: TrainState, batch: dict):
        inputs, targets = batch["inputs"], batch["targets"]
        if inputs.dim() != 3 or inputs.shape != targets.shape:
            raise ValueError(
                f"batch inputs/targets must be [A, B, T] of one shape, got "
                f"{tuple(inputs.shape)} and {tuple(targets.shape)}")
        nan_target = bad_data = None
        if guard is not None:
            if state.guard is None:
                raise ValueError("a guarded step needs state.guard: "
                                 "init_train_state(..., guard=...)")
            bad = (guard_lib.check_batch(batch, guard.vocab_size)
                   if guard.vocab_size else
                   torch.zeros((), dtype=torch.bool, device=inputs.device))
            flag = bad.to(torch.int32)
            zero.all_reduce_(flag, mesh.group)  # any rank's bad ids
            bad_data = flag > 0
            inputs = guard_lib.safe_input_ids(inputs, model_cfg.vocab_size)
            if not model_cfg.fused_head_ce:
                targets, nan_target = guard_lib.safe_targets(
                    targets, model_cfg.vocab_size)
        ps = tree.leaves(state.params)
        p_spec_leaves = tree.leaves(aligned(p_specs, state.params))
        shard_like = aligned(shard_tree, state.params)
        shard_specs = tree.leaves(shard_like)
        # Each gradient's layout: its spec names the axes its norm sums over.
        norm_specs = shard_specs if zero2 else p_spec_leaves
        loss, grads = accumulate_grads(
            lambda i: loss_and_grads(ps, state.params, inputs[i],
                                     targets[i],
                                     DropoutKey(seed, state.step, i)),
            inputs.shape[0], ps, acc_dtype)
        if nan_target is not None:
            loss = torch.where(nan_target, torch.nan, loss)

        grads, loss = reduce_at_boundary(grads, loss, mesh, p_spec_leaves,
                                         shard_specs)
        grad_norm = zero.global_norm_sharded(grads, norm_specs, mesh)
        metrics = {"loss": loss, "grad_norm": grad_norm}

        # -- the update ----------------------------------------------------
        like = state.params
        same = all(g.dtype == p.dtype for g, p in zip(grads, ps))
        grads = [g.to(p.dtype) for g, p in zip(grads, ps)]
        if grad_clip_norm is not None:
            norm = grad_norm if same else zero.global_norm_sharded(
                grads, norm_specs, mesh)
            zero.clip_by_global_norm_typed(grads, norm, grad_clip_norm)
        anomaly = None
        new_guard = state.guard
        if guard is not None:
            new_guard, anomaly = guard_lib.guard_step(
                state.guard, loss, grad_norm, bad_data, guard)
            metrics["anomaly"] = anomaly
        if sharded_update:
            params, opt_state = zero.zero_sharded_update(
                tx, like, state.opt_state, grads, shard_like, mesh,
                strategy, anomaly=anomaly)
        else:
            params, opt_state = tx.update(grads, state.opt_state, like,
                                          anomaly=anomaly)
        return TrainState(params, opt_state, state.step + 1,
                          new_guard), metrics

    return step

