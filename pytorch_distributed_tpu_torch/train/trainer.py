"""The single-device train step: the port of ``make_train_step`` in the JAX
package's ``train/trainer.py``.

``make_train_step(model, model_cfg, tx) -> step(state, batch) -> (state,
metrics)``. ``batch`` holds "inputs" and "targets" of shape [A, B, T]
(A = 1: no accumulation). Each micro-batch runs ``model.apply``, the f32
cross-entropy and ``torch.autograd.grad``; for A > 1 the gradients are
summed in an ``accum_dtype`` buffer and divided by A, and the loss is the
mean over micro-batches. Then one optimizer update (``train/optim``).
Metrics: ``loss`` and ``grad_norm``, the global norm of the averaged
gradients before clipping, both as device scalars (reading them is the
caller's sync).

The step updates the state's params and optimizer moments in place and
returns them in a new ``TrainState`` (the JAX step donates its input state:
the old values are not used again either way).

Not ported yet, and refused: dropout (any ``*_pdrop > 0``), the fused head
cross-entropy (``fused_head_ce``), the anomaly guard, MoE. The ``Trainer``
loop, checkpointing and ``make_eval_step`` are not ported yet.
"""

from __future__ import annotations

from typing import Callable

import torch

from pytorch_distributed_tpu_torch.config import ModelConfig
from pytorch_distributed_tpu_torch.models import ModelApi
from pytorch_distributed_tpu_torch.ops.losses import cross_entropy_loss
from pytorch_distributed_tpu_torch.train.optim import Optimizer, global_norm
from pytorch_distributed_tpu_torch.train.state import TrainState
from pytorch_distributed_tpu_torch.utils import tree


def _refuse_unported(model_cfg: ModelConfig, tx: Optimizer, guard) -> None:
    pdrop = {name: getattr(model_cfg, name)
             for name in ("embd_pdrop", "attn_pdrop", "resid_pdrop")}
    if any(pdrop.values()):
        raise NotImplementedError(
            f"training with dropout is not ported yet: {pdrop} "
            f"(set every *_pdrop to 0.0)"
        )
    if model_cfg.fused_head_ce:
        raise NotImplementedError(
            "fused_head_ce (linear_cross_entropy) is not ported yet"
        )
    if model_cfg.n_experts:
        raise NotImplementedError("MoE training is not ported yet")
    if guard is not None or tx.cfg.anomaly_guard:
        raise NotImplementedError("the anomaly guard is not ported yet")


def make_train_step(
    model: ModelApi,
    model_cfg: ModelConfig,
    tx: Optimizer,
    *,
    accum_dtype: str = "float32",
    guard=None,
) -> Callable:
    """Build ``step(state, batch) -> (state, metrics)`` (see the module
    docstring)."""
    _refuse_unported(model_cfg, tx, guard)
    acc_dtype = getattr(torch, accum_dtype)

    def loss_and_grads(leaves_like, params, inputs, targets):
        live = [p.detach().requires_grad_(True) for p in leaves_like]
        logits = model.apply(tree.unflatten(params, live), inputs, model_cfg)
        loss = cross_entropy_loss(logits, targets)
        grads = torch.autograd.grad(loss, live)
        return loss.detach(), list(grads)

    def step(state: TrainState, batch: dict):
        inputs, targets = batch["inputs"], batch["targets"]
        if inputs.dim() != 3 or inputs.shape != targets.shape:
            raise ValueError(
                f"batch inputs/targets must be [A, B, T] of one shape, got "
                f"{tuple(inputs.shape)} and {tuple(targets.shape)}"
            )
        accum = inputs.shape[0]
        ps = tree.leaves(state.params)
        if accum == 1:
            loss, grads = loss_and_grads(ps, state.params, inputs[0],
                                         targets[0])
        else:
            grads = [torch.zeros_like(p, dtype=acc_dtype) for p in ps]
            loss = torch.zeros((), dtype=torch.float32, device=ps[0].device)
            for i in range(accum):
                loss_i, g = loss_and_grads(ps, state.params, inputs[i],
                                           targets[i])
                torch._foreach_add_(grads, [x.to(acc_dtype) for x in g])
                loss = loss + loss_i
                del g
            torch._foreach_div_(grads, accum)
            loss = loss / accum
        metrics = {"loss": loss, "grad_norm": global_norm(grads)}
        params, opt_state = tx.update(grads, state.opt_state, state.params)
        return TrainState(params, opt_state, state.step + 1), metrics

    return step
