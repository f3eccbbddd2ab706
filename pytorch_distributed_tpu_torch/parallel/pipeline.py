"""Pipeline parallelism over a "pipe" mesh axis: the port of the JAX
package's ``parallel/pipeline.py`` (GPipe and 1F1B), on
``torch.distributed``.

Stage s (``mesh.axis_index("pipe")``) holds layers ``[s L/S, (s+1) L/S)``
of the blocks and their moments (``shard_pipeline_state``); the embeddings,
the final norm and the head are whole on every stage. The step's M
gradient-accumulation micro-batches stream through the stages: stage 0
embeds, each stage runs its layers (``ModelApi.run_blocks`` with its
``layer_offset``), the last stage runs the head and the loss, and the
activations hop to the next stage (their cotangents to the previous one)
point to point on the pipe group.

- **GPipe**: M forwards on each stage, each micro-batch's autograd graph
  kept, then the M backwards in reverse order. The last stage seeds each
  micro-batch's backward with its loss, the others with the cotangent the
  next stage sends.
- **1F1B** (PipeDream-flush, JAX's timing): stage s runs F(m) at tick
  2m + s and B(m) at tick 2m + 2S - 1 - s, over 2 (M + S - 1) ticks. An F
  tick runs the stage forward without autograd, keeps its input (a stash
  of at most S inputs) and sends its output on; a B tick runs the stage
  forward again under autograd from the kept input and backpropagates the
  cotangent received (the loss, on the last stage): one extra stage
  forward per micro-batch for an activation stash of S inputs instead of
  M graphs. Both schedules give the same numbers.
- **The hops**: each tick's sends and receives are posted together
  (``dist.batch_isend_irecv``: an F tick's send forward and a B tick's
  send back cross between neighbours in the same tick, which blocking
  sends would deadlock on). Over gloo, CUDA tensors are staged through
  the host (``ops/ring_attention.staged``: gloo's own send of a CUDA
  tensor kills the rank). ``sends`` counts the sends this module issued.

Composition (JAX's): the batch's rows split over data, fsdp and expert
and its tokens over seq as on the explicit path (every stage of a pipe
group takes the same rows); each stage's layers run Megatron-style on
the tensor group and the ring or Ulysses on the seq group; fsdp follows the
ZeRO ladder (full_shard gathers the embeddings and final norm per
micro-batch and each layer just in time, ``zero.LayerGather``). After
the step, the gradients of the leaves every stage holds are summed over
pipe (GPT-2's tied ``wte``: its embedding part from stage 0, its head part
from the last stage), then the explicit path's boundary reduces them over
fsdp, data, expert and seq (``explicit.reduce_at_boundary``), and the loss,
summed over pipe and divided by M, likewise. The gradient norm sums a
block leaf's squares over pipe too (``zero.global_norm_sharded``), and
the clip uses it. MoE models run with their experts replicated in each
stage, or split over an in-stage expert axis (the batch's rows split
over it as over data; each stage's MoE layers exchange tokens with the
expert group, ``ops/moe``, and the boundary divides expert-sharded
leaves by the axis and averages the rest over it, as the explicit step):
each stage adds its layers' Switch term to its loss. Dropout
(GPT-2 only; the Llama family draws none, as in JAX) draws each
micro-batch's masks from ``DropoutKey(seed, step, m)`` at the global
layer ids, so a pipe-only mesh draws the single-device step's masks.

**Deliberate differences.** JAX's schedule is one ``lax.scan`` over
ticks in which bubble ticks compute on garbage whose loss is masked out;
here a tick with nothing to do launches nothing, and the last stage's F
ticks (whose output JAX sends nowhere) compute nothing either: its B
tick runs the forward it needs. Seq, tensor and fsdp peers share a stage,
so they agree on every predicate and issue their collectives alike. The
step takes the ``StateSharding`` (as ``parallel/explicit``), not the
state, and keys its dropout on ``seed`` and the state's step.
Refused as JAX refuses them: attention dropout under in-stage tensor
parallelism unless ``tensor_dropout="folded"``, the ring with attention
dropout, a ``tx`` that clips (the step clips against the pipe-aware
norm), ``n_layer`` not divisible by the stage count, an expert axis on
a dense model or with an expert count it does not divide.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from pytorch_distributed_tpu_torch.config import (
    MeshConfig,
    ModelConfig,
    TrainConfig,
)
from pytorch_distributed_tpu_torch.models import ModelApi
from pytorch_distributed_tpu_torch.ops.layers import dropout
from pytorch_distributed_tpu_torch.ops.losses import (
    cross_entropy_loss,
    linear_cross_entropy,
)
from pytorch_distributed_tpu_torch.ops.ring_attention import staged
from pytorch_distributed_tpu_torch.parallel import zero
from pytorch_distributed_tpu_torch.parallel.explicit import (
    check_expert,
    check_seq,
    check_tensor_dropout,
    reduce_at_boundary,
)
from pytorch_distributed_tpu_torch.parallel.mesh import (
    Mesh,
    fold_batch_shard_key,
    fold_tensor_key,
)
from pytorch_distributed_tpu_torch.parallel.sharding import (
    StateSharding,
    shard_train_state,
    stage_range,
    stage_state,
    staged as staged_leaves,
)
from pytorch_distributed_tpu_torch.train.optim import Optimizer
from pytorch_distributed_tpu_torch.train.state import TrainState
from pytorch_distributed_tpu_torch.utils import prng, tree

sends = 0  # point-to-point sends this module issued (the pipe hops)


def check_pipeline(model_cfg: ModelConfig, mesh_cfg: MeshConfig) -> None:
    """JAX's build-time refusals of the pipeline step (module docstring;
    ``MeshConfig`` refuses an unknown ``pipe_schedule``)."""
    if mesh_cfg.pipe <= 1:
        raise ValueError("pipeline path needs mesh_cfg.pipe > 1")
    check_tensor_dropout(model_cfg, mesh_cfg)
    check_seq(model_cfg, mesh_cfg)
    check_expert(model_cfg, mesh_cfg)
    if model_cfg.n_layer % mesh_cfg.pipe:
        raise ValueError(f"n_layer={model_cfg.n_layer} not divisible by "
                         f"pipe={mesh_cfg.pipe} stages")


def shard_pipeline_state(state: TrainState, mesh: Mesh
                         ) -> tuple[TrainState, StateSharding]:
    """This rank's part of a whole train state (the same on every rank):
    its stage's layers (``sharding.stage_state``), then its fsdp and
    tensor slices (``sharding.shard_train_state``). Returns (state, its
    ``StateSharding``)."""
    return shard_train_state(stage_state(state, mesh), mesh)


def f_tick(t: int, stage: int, m: int) -> int | None:
    """The micro-batch whose 1F1B forward ``stage`` runs at tick ``t``."""
    i = t - stage
    return i // 2 if 0 <= i < 2 * m and i % 2 == 0 else None


def b_tick(t: int, stage: int, n_stages: int, m: int) -> int | None:
    """The micro-batch whose 1F1B backward ``stage`` runs at tick ``t``."""
    i = t - (2 * n_stages - 1 - stage)
    return i // 2 if 0 <= i < 2 * m and i % 2 == 0 else None


def _exchange(group, out: list, want: list, like: torch.Tensor) -> list:
    """Send each (tensor, peer) of ``out`` and receive a tensor shaped and
    typed like ``like`` from each peer of ``want`` (pipe-group ranks), all
    posted at once; returns the received tensors on ``like``'s device."""
    global sends
    if not out and not want:
        return []
    host = staged(group, like)
    ranks = dist.get_process_group_ranks(group)
    ops, bufs = [], []
    for t, peer in out:
        t = t.detach().contiguous()
        ops.append(dist.P2POp(dist.isend, t.cpu() if host else t,
                              ranks[peer], group))
        sends += 1
    for peer in want:
        buf = torch.empty(like.shape, dtype=like.dtype,
                          device="cpu" if host else like.device)
        ops.append(dist.P2POp(dist.irecv, buf, ranks[peer], group))
        bufs.append(buf)
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return [b.to(like.device) for b in bufs] if host else bufs


def make_pipeline_train_step(
    model: ModelApi,
    model_cfg: ModelConfig,
    tx: Optimizer,
    mesh: Mesh,
    mesh_cfg: MeshConfig,
    sharding: StateSharding,
    train_cfg: TrainConfig | None = None,
    *,
    grad_clip_norm: float | None = None,
    accum_dtype: str = "float32",
    seed: int = 42,
) -> Callable:
    """``step(state, batch) -> (state, metrics)`` over ``mesh``'s pipe
    axis: ``state`` placed by ``shard_pipeline_state`` (whose sharding is
    ``sharding``), ``batch`` this rank's rows, "inputs"/"targets"
    [M, b, T] (M micro-batches, ``parallel/mesh.make_batch_put``).
    The schedule is ``mesh_cfg.pipe_schedule``, "gpipe" or "1f1b".
    ``tx`` must be clip-free (``make_optimizer(cfg, with_clip=False)``):
    the step clips against the pipe-aware global norm
    (``grad_clip_norm``); a ``train_cfg`` with a clip and no
    ``grad_clip_norm`` raises, as JAX does. Metrics: the global ``loss``
    and ``grad_norm``, the same on every rank."""
    schedule = mesh_cfg.pipe_schedule
    check_pipeline(model_cfg, mesh_cfg)
    if train_cfg is not None and train_cfg.grad_clip_norm and \
            grad_clip_norm is None:
        raise ValueError(
            "grad_clip_norm on the pipeline path must be applied by this "
            "step against the pipe-aware global norm: build the optimizer "
            "with make_optimizer(cfg, with_clip=False) and pass "
            "grad_clip_norm= explicitly")
    if tx.clip is not None:
        raise ValueError("the pipeline step needs a clip-free optimizer "
                         "(make_optimizer(cfg, with_clip=False)); pass "
                         "grad_clip_norm instead")
    if mesh.cfg != mesh_cfg:
        raise ValueError("mesh_cfg is not the mesh's config")
    if model_cfg.remat != "none":
        # ``torch.utils.checkpoint``'s first call imports ``torch._dynamo``
        # (seconds of CPU). In the first step each stage would pay it in
        # its first forward, one stage after the other, as each waits for
        # the one before: here the stages pay it side by side.
        import torch._dynamo  # noqa: F401
    n_stages, f = mesh_cfg.pipe, mesh_cfg.fsdp
    stage = mesh.axis_index("pipe")
    last = n_stages - 1
    pipe_group = mesh.axis_group("pipe")
    strategy = mesh_cfg.strategy
    zero3 = strategy == "full_shard" and f > 1
    zero2 = strategy == "shard_grad_op" and f > 1
    sharded_update = strategy in ("shard_grad_op", "shard_opt") and f > 1
    p_specs = sharding.params
    shard_tree = sharding.opt_state["mu"]
    tp_group = mesh.axis_group("tensor") if mesh_cfg.tensor > 1 else None
    seq_group = mesh.axis_group("seq") if mesh_cfg.seq > 1 else None
    expert_group = (mesh.axis_group("expert") if mesh_cfg.expert > 1
                    else None)
    # Dropout is the GPT-2 family's alone (JAX's ``train_mode``).
    train_mode = model_cfg.family == "gpt2" and (
        model_cfg.embd_pdrop > 0 or model_cfg.attn_pdrop > 0
        or model_cfg.resid_pdrop > 0)
    moe = bool(model_cfg.n_experts)
    acc_dtype = getattr(torch, accum_dtype)
    offset = stage_range(model_cfg.n_layer, mesh).start
    block_transform = (zero.LayerGather(p_specs["blocks"][0], mesh)
                       if zero3 else None)

    def gathered(params):
        """ZeRO-3: the leaves outside the blocks gathered (per
        micro-batch, as the explicit step does)."""
        if not zero3:
            return params
        return {k: v if k == "blocks"
                else zero.gather_params(v, p_specs[k], mesh)
                for k, v in params.items()}

    def head_loss(params, y, targets):
        if not model_cfg.fused_head_ce:
            return cross_entropy_loss(model.head(params, y, model_cfg),
                                      targets)
        hidden = model.final_norm(params, y, model_cfg)
        w, layout = model.head_weight(params)
        return linear_cross_entropy(
            hidden.reshape(-1, hidden.shape[-1]), w, targets.reshape(-1),
            w_layout=layout, logits_dtype=model_cfg.logits_dtype)

    def stage_forward(params, x, tokens, targets, key):
        """(y, this stage's loss for the micro-batch or None): the
        embedding on stage 0, this stage's layers, the head's loss on the
        last stage, plus the layers' Switch term under MoE."""
        params = gathered(params)
        if stage == 0:
            x = model.embed(params, tokens, model_cfg, seq_group=seq_group)
            if train_mode:
                x = dropout(x, model_cfg.embd_pdrop,
                            prng.stream_id(key, prng.EMBD_LAYER, "embd"),
                            deterministic=False)
        y = model.run_blocks(
            params["blocks"], x, model_cfg, block_transform=block_transform,
            return_aux=moe, tp_group=tp_group, seq_group=seq_group,
            expert_group=expert_group,
            dropout_seed=key if train_mode else None,
            deterministic=not train_mode, layer_offset=offset)
        loss = None
        if moe:
            y, aux = y
            loss = model_cfg.moe_aux_coef * aux
        if stage == last:
            ce = head_loss(params, y, targets)
            loss = ce if loss is None else ce + loss
        return y, loss

    def step(state: TrainState, batch: dict):
        inputs, targets = batch["inputs"], batch["targets"]
        if inputs.dim() != 3 or inputs.shape != targets.shape:
            raise ValueError(
                f"batch inputs/targets must be [M, B, T] of one shape, got "
                f"{tuple(inputs.shape)} and {tuple(targets.shape)}")
        m_count, b, t = inputs.shape
        ps = tree.leaves(state.params)
        live = [p.detach().requires_grad_(True) for p in ps]
        params = tree.unflatten(state.params, live)
        grads = [torch.zeros_like(p, dtype=acc_dtype) for p in ps]
        loss_sum = torch.zeros((), dtype=torch.float32, device=inputs.device)
        act = torch.empty((b, t, model_cfg.n_embd),
                          dtype=getattr(torch, model_cfg.dtype),
                          device=inputs.device)

        def key_of(m):
            key = fold_batch_shard_key(prng.DropoutKey(seed, state.step, m),
                                       mesh)
            if model_cfg.tensor_dropout == "folded":
                key = fold_tensor_key(key, mesh)
            return key

        def backward(y, dy, loss, x):
            """Accumulate one micro-batch's gradients: ``y`` seeded with
            the next stage's cotangent ``dy`` (none on the last stage),
            ``loss`` with 1; returns the cotangent of the stage input
            ``x`` (None on stage 0)."""
            outs, seeds = [], []
            if dy is not None:
                outs.append(y)
                seeds.append(dy.to(y.dtype))
            if loss is not None:
                outs.append(loss)
                seeds.append(torch.ones_like(loss))
            wrt = live + ([x] if x is not None else [])
            got = torch.autograd.grad(outs, wrt, seeds, allow_unused=True)
            for acc, g in zip(grads, got):
                if g is not None:  # None: a leaf this stage does not use
                    acc.add_(g.to(acc_dtype))
            return got[-1] if x is not None else None

        def take(x):
            return None if x is None else x.requires_grad_(True)

        if schedule == "gpipe":
            kept = []
            for m in range(m_count):
                x = None
                if stage > 0:
                    (x,) = _exchange(pipe_group, [], [stage - 1], act)
                y, loss = stage_forward(params, take(x), inputs[m],
                                        targets[m], key_of(m))
                if stage < last:
                    _exchange(pipe_group, [(y, stage + 1)], [], act)
                if loss is not None:
                    loss_sum += loss.detach().float()
                kept.append((x, y, loss))
            for m in reversed(range(m_count)):
                x, y, loss = kept.pop()
                dy = None
                if stage < last:
                    (dy,) = _exchange(pipe_group, [], [stage + 1], act)
                dx = backward(y, dy, loss, x)
                del y, loss
                if stage > 0:
                    _exchange(pipe_group, [(dx, stage - 1)], [], act)
        else:
            stash: dict = {}
            fwd_in = bwd_in = None
            for tick in range(2 * (m_count + n_stages - 1)):
                out = []
                m = f_tick(tick, stage, m_count)
                if m is not None:
                    stash[m] = fwd_in
                    if stage < last:  # the last stage's B runs its forward
                        with torch.no_grad():
                            y, _ = stage_forward(params, fwd_in, inputs[m],
                                                 targets[m], key_of(m))
                        out.append((y, stage + 1))
                m = b_tick(tick, stage, n_stages, m_count)
                if m is not None:
                    x = take(stash.pop(m))
                    y, loss = stage_forward(params, x, inputs[m],
                                            targets[m], key_of(m))
                    if loss is not None:
                        loss_sum += loss.detach().float()
                    dx = backward(y, bwd_in, loss, x)
                    del y, loss
                    if stage > 0:
                        out.append((dx, stage - 1))
                want = []
                if stage > 0 and f_tick(tick + 1, stage, m_count) is not None:
                    want.append(stage - 1)
                if stage < last and b_tick(tick + 1, stage, n_stages,
                                           m_count) is not None:
                    want.append(stage + 1)
                got = _exchange(pipe_group, out, want, act)
                fwd_in = bwd_in = None
                for peer, g in zip(want, got):
                    if peer < stage:
                        fwd_in = g
                    else:
                        bwd_in = g
        del live, params
        torch._foreach_div_(grads, m_count)
        # Every stage holds the leaves outside the blocks: their gradients
        # are the sum of the stages' parts.
        for g, is_block in zip(grads, staged_leaves(state.params)):
            if not is_block:
                zero.all_reduce_(g, pipe_group)
        loss = zero.all_reduce_(loss_sum, pipe_group) / m_count

        p_spec_leaves = tree.leaves(tree.map_tree2(
            lambda _, spec: spec, state.params, p_specs))
        shard_like = tree.map_tree2(lambda _, spec: spec, state.params,
                                    shard_tree)
        shard_specs = tree.leaves(shard_like)
        grads, loss = reduce_at_boundary(grads, loss, mesh, p_spec_leaves,
                                         shard_specs)
        norm_specs = shard_specs if zero2 else p_spec_leaves
        is_staged = staged_leaves(state.params)
        grad_norm = zero.global_norm_sharded(grads, norm_specs, mesh,
                                             is_staged)
        metrics = {"loss": loss, "grad_norm": grad_norm}
        same = all(g.dtype == p.dtype for g, p in zip(grads, ps))
        grads = [g.to(p.dtype) for g, p in zip(grads, ps)]
        if grad_clip_norm is not None:
            norm = grad_norm if same else zero.global_norm_sharded(
                grads, norm_specs, mesh, is_staged)
            zero.clip_by_global_norm_typed(grads, norm, grad_clip_norm)
        if sharded_update:
            new_params, opt_state = zero.zero_sharded_update(
                tx, state.params, state.opt_state, grads, shard_like, mesh,
                strategy)
        else:
            new_params, opt_state = tx.update(grads, state.opt_state,
                                              state.params)
        return TrainState(new_params, opt_state, state.step + 1,
                          state.guard), metrics

    return step


def pipe_counts(schedule: str, stage: int, n_stages: int, n_layer: int,
                m: int) -> dict:
    """K1 and K2 launches and point-to-point sends a step on ``stage``
    as this module gives them, under a remat mode that keeps the flash
    op's (o, lse) (``names``, ``flash``: no K1 in a recompute), with
    ``n_layer`` layers in all and ``m`` micro-batches: GPipe runs each
    micro-batch's forward once (K1) and its backward once (K2); 1F1B's B
    tick runs the forward again, so K1 twice a micro-batch but on the last
    stage, whose F tick computes nothing. Each stage sends its m outputs
    forward (but the last) and m cotangents back (but stage 0)."""
    per = n_layer // n_stages * m
    k1 = per if schedule == "gpipe" or stage == n_stages - 1 else 2 * per
    hops = m * ((stage < n_stages - 1) + (stage > 0))
    return dict(K1=k1, K2=per, sends=hops)
