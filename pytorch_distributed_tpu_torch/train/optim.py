"""Optimizer and learning-rate schedule: the port of the JAX package's
``train/optim.py`` (AdamW with weight decay on every param by default, and
a cosine schedule to ``min_lr_ratio`` with optional linear warmup).

The JAX package builds the optax chain

    clip_by_global_norm(grad_clip_norm)  (identity when None)
    -> scale_by_adam(b1, b2, eps)        mu, nu, count
    -> add_decayed_weights(wd[, mask])   (mask: decay_exclude_1d)
    -> scale_by_learning_rate(schedule)  schedule counted from step 0

``Optimizer.update`` applies the same four elements in the same order with
the same state, so the update of a param p with gradient g at step n
(counted from 0) is

    g <- g * min(1, clip / |g|_global)
    mu <- b1 mu + (1 - b1) g;   nu <- b2 nu + (1 - b2) g^2
    u  <- (mu / (1 - b1^(n+1))) / (sqrt(nu / (1 - b2^(n+1))) + eps)
    p  <- p - lr(n) * (u + wd * p)

which is also ``torch.optim.AdamW``'s decoupled decay (p (1 - lr wd) -
lr u) written the other way round. It runs as ``torch._foreach_*``
multi-tensor ops over the whole tree and updates params, mu and nu IN
PLACE (the JAX step donates its state, so the old values are dead either
way). The state mirrors optax's: ``count`` (Adam's), ``mu``, ``nu`` (trees
like the params, in the params' dtype) and ``schedule_count``;
``interop.opt_state_{from,to}_jax`` convert it. Counts are Python ints
held on the host, so the step needs no device sync for its schedule or
bias corrections; the bias corrections are taken in float32 as optax
takes them.
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch

from pytorch_distributed_tpu_torch.config import TrainConfig
from pytorch_distributed_tpu_torch.utils import tree


def make_schedule(cfg: TrainConfig) -> Callable[[int], float]:
    """step -> learning rate, as the optax schedule the JAX package builds:
    cosine_decay_schedule(peak, max(num_steps, 1), alpha=min_lr_ratio)
    (or constant), joined after ``warmup_steps`` of linear warmup from 0."""
    peak = cfg.learning_rate
    if cfg.lr_schedule == "constant":
        def main(count):
            return peak
    elif cfg.lr_schedule == "cosine":
        decay_steps = float(max(cfg.num_steps, 1))
        alpha = cfg.min_lr_ratio

        def main(count):
            count = min(float(count), decay_steps)
            cosine = 0.5 * (1 + math.cos(math.pi * count / decay_steps))
            return peak * ((1 - alpha) * cosine + alpha)
    else:
        raise KeyError(f"unknown lr_schedule {cfg.lr_schedule!r}")
    if cfg.warmup_steps <= 0:
        return main
    ws = cfg.warmup_steps

    def joined(count):
        if count < ws:
            return peak * min(count, ws) / ws
        return main(count - ws)

    return joined


def lr_at_step(cfg: TrainConfig, step: int) -> float:
    """Host-side schedule evaluation for logging (the JAX package's
    ``lr_at_step``)."""
    if cfg.warmup_steps > 0 and step < cfg.warmup_steps:
        return cfg.learning_rate * step / cfg.warmup_steps
    t = step - cfg.warmup_steps
    peak, floor = cfg.learning_rate, cfg.min_lr_ratio * cfg.learning_rate
    if cfg.lr_schedule == "constant":
        return peak
    tmax = max(cfg.num_steps, 1)
    frac = min(t / tmax, 1.0)
    return floor + (peak - floor) * 0.5 * (1.0 + math.cos(math.pi * frac))


def _decays(path, p) -> bool:
    """The JAX package's decay_exclude_1d rule on an unstacked leaf: no
    decay for a leaf named "bias" or "scale", nor for one of rank < 2."""
    return path[-1] not in ("bias", "scale") and p.dim() >= 2


def _f32_bias_correction(decay: float, count: int) -> float:
    return float(np.float32(1) - np.float32(decay) ** np.float32(count))


class Optimizer:
    """The optax chain above over a params tree (``make_optimizer``)."""

    def __init__(self, cfg: TrainConfig, with_clip: bool = True):
        self.cfg = cfg
        self.clip = cfg.grad_clip_norm if with_clip else None
        self.schedule = make_schedule(cfg)

    def init(self, params) -> dict:
        zeros = lambda p: torch.zeros_like(p)  # noqa: E731
        return {
            "count": 0,
            "mu": tree.map_tree(zeros, params),
            "nu": tree.map_tree(zeros, params),
            "schedule_count": 0,
        }

    def update(self, grads: list[torch.Tensor], opt_state: dict, params):
        """One step, in place: ``grads`` are the params' gradients as a list
        in ``utils.tree.leaves`` order (consumed: clipped in place). Returns
        (params, opt_state), the same tensors updated."""
        cfg = self.cfg
        with_path = list(tree.leaves_with_path(params))
        ps = [p for _, p in with_path]
        mu, nu = tree.leaves(opt_state["mu"]), tree.leaves(opt_state["nu"])
        if not (len(grads) == len(ps) == len(mu) == len(nu)):
            raise ValueError(
                f"{len(grads)} grads, {len(ps)} params, {len(mu)}/{len(nu)} "
                f"moments: they must match"
            )
        grads = [g.to(p.dtype) for g, p in zip(grads, ps)]
        with torch.no_grad():
            if self.clip is not None:
                norm = global_norm(grads)
                factor = torch.where(norm < self.clip, 1.0, self.clip / norm)
                torch._foreach_mul_(grads, factor)
            count = opt_state["count"] + 1
            torch._foreach_mul_(mu, cfg.beta1)
            torch._foreach_add_(mu, grads, alpha=1 - cfg.beta1)
            torch._foreach_mul_(nu, cfg.beta2)
            torch._foreach_addcmul_(nu, grads, grads, value=1 - cfg.beta2)
            u = torch._foreach_div(mu, _f32_bias_correction(cfg.beta1, count))
            den = torch._foreach_div(nu, _f32_bias_correction(cfg.beta2, count))
            torch._foreach_sqrt_(den)
            torch._foreach_add_(den, cfg.eps)
            torch._foreach_div_(u, den)
            del den
            if cfg.weight_decay:
                pick = [i for i, (path, p) in enumerate(with_path)
                        if not cfg.decay_exclude_1d or _decays(path, p)]
                torch._foreach_add_([u[i] for i in pick],
                                    [ps[i] for i in pick],
                                    alpha=cfg.weight_decay)
            lr = self.schedule(opt_state["schedule_count"])
            torch._foreach_add_(ps, u, alpha=-lr)
        new_state = dict(opt_state, count=count,
                         schedule_count=opt_state["schedule_count"] + 1)
        return params, new_state


def make_optimizer(cfg: TrainConfig, *, with_clip: bool = True) -> Optimizer:
    """The port's counterpart of the JAX ``make_optimizer`` (same chain,
    same order; ``with_clip=False`` drops the clip element)."""
    return Optimizer(cfg, with_clip=with_clip)


def global_norm(tensors: list[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares over all tensors, in f32 (optax's
    ``global_norm``)."""
    norms = torch._foreach_norm([t.float() for t in tensors])
    return torch.linalg.vector_norm(torch.stack(norms))
