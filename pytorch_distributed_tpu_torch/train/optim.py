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

**Under the anomaly guard** (``train/guard``; ``init(on_device=True)``,
``update(..., anomaly=)``) an anomalous step must leave params, mu, nu
and both counts as they were, as the JAX guard's select of the old state
does — and the host cannot know the step was bad without a sync. So the
counts are 0-d int32 tensors on the params' device, the bias corrections
(f32, from the would-be count n + 1) and the schedule's learning rate
(f64, rounded to f32) are computed there, and the counts advance by
``~anomaly``. The update stays in place and is made a bit-for-bit no-op
on an anomaly without copying the state: each gradient is replaced by
-0.0 (``torch.where``, so a NaN gradient cannot leak through a product
with a 0 mask); mu and nu are scaled by ``where(anomaly, 1, b)``, so mu
gains (1 - b1) x -0.0 = -0.0, which leaves every float as it is, and nu
gains +0.0, which leaves every float but -0.0 as it is (nu is never
-0.0: it starts at +0.0 and only adds squares); the update u is replaced
by +0.0 before it meets the learning rate, and p - (+0.0) is p for every
p. The selects run in place (``out=``) and the state's tensors are the
unguarded step's, so the guard adds no tensor the size of a leaf to the
step's peak memory: for GPT-2 124M and for Llama-3.2-1B alike it adds a
few 0-d tensors (and the [A, B, T] id checks of the batch). A clean
guarded step subtracts ``lr * u`` rounded to the params' dtype (as optax's
two steps, scale then add, round it in f32); the unguarded step fuses
the two into one rounding.
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

    def init(self, params, *, on_device: bool = False) -> dict:
        """Zero moments like the params; ``on_device``: the counts as 0-d
        int32 tensors on the params' device (the guarded step's)."""
        zeros = lambda p: torch.zeros_like(p)  # noqa: E731
        dev = tree.leaves(params)[0].device

        def count():
            return (torch.zeros((), dtype=torch.int32, device=dev)
                    if on_device else 0)

        return {
            "count": count(),
            "mu": tree.map_tree(zeros, params),
            "nu": tree.map_tree(zeros, params),
            "schedule_count": count(),
        }

    def lr_tensor(self, count: torch.Tensor) -> torch.Tensor:
        """``make_schedule`` on a device count: the learning rate as an f32
        0-d tensor, computed in f64 on the count's device."""
        cfg, peak = self.cfg, self.cfg.learning_rate
        c = count.double()

        def main(c):
            if cfg.lr_schedule == "constant":
                return torch.full_like(c, peak)
            decay_steps = float(max(cfg.num_steps, 1))
            c = c.clamp(max=decay_steps)
            cosine = 0.5 * (1 + torch.cos(math.pi * c / decay_steps))
            return peak * ((1 - cfg.min_lr_ratio) * cosine
                           + cfg.min_lr_ratio)

        if cfg.lr_schedule not in ("constant", "cosine"):
            raise KeyError(f"unknown lr_schedule {cfg.lr_schedule!r}")
        if cfg.warmup_steps <= 0:
            return main(c).float()
        ws = cfg.warmup_steps
        return torch.where(c < ws, peak * c.clamp(max=ws) / ws,
                           main(c - ws)).float()

    def update(self, grads: list[torch.Tensor], opt_state: dict, params,
               *, anomaly: torch.Tensor | None = None):
        """One step, in place: ``grads`` are the params' gradients as a list
        in ``utils.tree.leaves`` order (consumed: clipped in place). Returns
        (params, opt_state), the same tensors updated. ``anomaly`` (a 0-d
        bool tensor; the counts must then be device tensors): the guarded
        update of the module docstring."""
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
        if self.clip is not None:
            clip_by_global_norm_(grads, global_norm(grads), self.clip)
        if anomaly is not None:
            return self._guarded_update(grads, opt_state, params, with_path,
                                        mu, nu, anomaly)
        with torch.no_grad():
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
            self._add_weight_decay(u, with_path)
            lr = self.schedule(opt_state["schedule_count"])
            torch._foreach_add_(ps, u, alpha=-lr)
        new_state = dict(opt_state, count=count,
                         schedule_count=opt_state["schedule_count"] + 1)
        return params, new_state

    def _add_weight_decay(self, u: list, with_path: list) -> None:
        """u += wd * p over the leaves that decay (in place)."""
        cfg = self.cfg
        if not cfg.weight_decay:
            return
        pick = [i for i, (path, p) in enumerate(with_path)
                if not cfg.decay_exclude_1d or _decays(path, p)]
        torch._foreach_add_([u[i] for i in pick],
                            [with_path[i][1] for i in pick],
                            alpha=cfg.weight_decay)

    def _guarded_update(self, grads, opt_state, params, with_path, mu, nu,
                        anomaly):
        cfg = self.cfg
        ps = [p for _, p in with_path]
        count, sched = opt_state["count"], opt_state["schedule_count"]
        if not (torch.is_tensor(count) and torch.is_tensor(sched)):
            raise TypeError("the guarded update needs the counts on the "
                            "device: init(params, on_device=True)")
        dev = ps[0].device
        with torch.no_grad():
            neg_zero = {dt: torch.full((), -0.0, dtype=dt, device=dev)
                        for dt in {g.dtype for g in grads}}
            for g in grads:
                torch.where(anomaly, neg_zero[g.dtype], g, out=g)
            torch._foreach_mul_(mu, torch.where(anomaly, 1.0, cfg.beta1))
            torch._foreach_add_(mu, grads, alpha=1 - cfg.beta1)
            torch._foreach_mul_(nu, torch.where(anomaly, 1.0, cfg.beta2))
            torch._foreach_addcmul_(nu, grads, grads, value=1 - cfg.beta2)
            del grads
            n = (count + 1).float()
            u = torch._foreach_div(mu, 1 - torch.pow(cfg.beta1, n))
            den = torch._foreach_div(nu, 1 - torch.pow(cfg.beta2, n))
            torch._foreach_sqrt_(den)
            torch._foreach_add_(den, cfg.eps)
            torch._foreach_div_(u, den)
            del den
            self._add_weight_decay(u, with_path)
            zero = {dt: torch.zeros((), dtype=dt, device=dev)
                    for dt in {x.dtype for x in u}}
            for x in u:
                torch.where(anomaly, zero[x.dtype], x, out=x)
            torch._foreach_mul_(u, self.lr_tensor(sched))
            torch._foreach_sub_(ps, u)
            advance = (~anomaly).int()
        new_state = dict(opt_state, count=count + advance,
                         schedule_count=sched + advance)
        return params, new_state


def make_optimizer(cfg: TrainConfig, *, with_clip: bool = True) -> Optimizer:
    """The port's counterpart of the JAX ``make_optimizer`` (same chain,
    same order; ``with_clip=False`` drops the clip element)."""
    return Optimizer(cfg, with_clip=with_clip)


@torch.no_grad()
def clip_by_global_norm_(grads: list[torch.Tensor], norm: torch.Tensor,
                         clip: float) -> None:
    """optax's ``clip_by_global_norm`` against a given global ``norm``, in
    place: every gradient scaled by min(1, clip / norm) (the distributed
    step passes the norm reduced over ranks, ``parallel/zero``)."""
    factor = torch.where(norm < clip, 1.0, clip / norm)
    torch._foreach_mul_(grads, factor)


def global_norm(tensors: list[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares over all tensors, in f32 (optax's
    ``global_norm``)."""
    norms = torch._foreach_norm([t.float() for t in tensors])
    return torch.linalg.vector_norm(torch.stack(norms))
