"""The anomaly guard of the training step: the port of the JAX package's
``train/guard.py``.

A bad step — a corrupt shard, a numerically unlucky batch, a NaN from a
kernel — poisons the params, and every step after it is wasted. Reading
the loss on the host every step would catch it but makes the host wait
for step n before it enqueues step n + 1. The guard instead runs on the
card, inside the step, as tensor ops on values the step already has:

- **Detection.** Three predicates: a non-finite loss or gradient norm; a
  loss spike (``loss > spike_factor * ema`` once the EMA of clean losses
  has ``warmup_steps`` samples); token ids outside ``[0, vocab)`` in the
  batch (``check_batch``).
- **Reaction.** On an anomalous step the update leaves params, Adam's
  moments and the optimizer's counts bit for bit as they were
  (``train/optim.Optimizer.update`` with ``anomaly=``); ``state.step``
  still advances (it counts consumed data windows). The guard's own state
  (``GuardState``: five 0-d tensors on the card) rides ``TrainState.guard``.
- **No host sync.** Every predicate and update here is a tensor op
  (``torch.where``, ``torch.isfinite``); none reads a device value on the
  host (no ``.item()``, ``bool()`` or ``float()``), so the guard adds no
  synchronizing call to the step.
- **Policy on the host, at syncs the loop makes anyway.** The trainer
  reads the counters at log and save boundaries; after ``rollback_after``
  consecutive anomalies the sticky ``trip`` flag is set on the card (a
  burst inside one log window cannot be missed) and the trainer rolls back
  to the last good checkpoint (``train/trainer``).

``safe_input_ids`` and ``safe_targets`` reproduce what the JAX package's
gathers do with ids outside ``[0, vocab)``, where ``F.embedding`` and
``F.cross_entropy`` would raise (on the card: a device-side assert, which
leaves the process's CUDA context unusable). The guarded step applies
them; the unguarded step is unchanged.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch


class GuardState(NamedTuple):
    """The guard's carry, five 0-d tensors on the state's device.

    ``ema``/``seen``: the EMA of CLEAN losses (f32) and how many were
    folded in (the spike check waits for ``warmup_steps``).
    ``consecutive``: the current run of anomalous steps (0 after a clean
    one). ``total``: anomalies since the state was initialised or restored.
    ``trip``: sticky 0/1, set when ``consecutive`` reaches the rollback
    threshold."""

    ema: torch.Tensor  # f32
    seen: torch.Tensor  # i32
    consecutive: torch.Tensor  # i32
    total: torch.Tensor  # i32
    trip: torch.Tensor  # i32, sticky 0/1


def init_guard_state(device=None) -> GuardState:
    f32 = torch.zeros((), dtype=torch.float32, device=device)
    i32 = [torch.zeros((), dtype=torch.int32, device=device)
           for _ in range(4)]
    return GuardState(f32, *i32)


@dataclasses.dataclass(frozen=True)
class GuardConfig:
    """The guard's fixed parameters (``guard_config_from`` builds them from
    a TrainConfig), validated as the JAX package's."""

    spike_factor: float = 3.0
    ema_decay: float = 0.98
    warmup_steps: int = 10
    # Consecutive anomalies that set ``trip``; None: never trip (the guard
    # still skips anomalous updates).
    rollback_after: int | None = 3
    # Check token ids against [0, vocab) (0 turns the data check off).
    vocab_size: int = 0

    def __post_init__(self) -> None:
        if self.spike_factor <= 1.0:
            raise ValueError(
                f"spike_factor must be > 1, got {self.spike_factor}")
        if not 0.0 < self.ema_decay < 1.0:
            raise ValueError(
                f"ema_decay must be in (0, 1), got {self.ema_decay}")
        if self.warmup_steps < 1:
            raise ValueError(
                f"warmup_steps must be >= 1, got {self.warmup_steps}")
        if self.rollback_after is not None and self.rollback_after < 1:
            raise ValueError(
                f"rollback_after must be >= 1 or None, got "
                f"{self.rollback_after}")


def guard_config_from(train_cfg, model_cfg) -> GuardConfig | None:
    """TrainConfig -> GuardConfig (None when the guard is off)."""
    if not train_cfg.anomaly_guard:
        return None
    return GuardConfig(
        spike_factor=train_cfg.guard_spike_factor,
        ema_decay=train_cfg.guard_ema_decay,
        warmup_steps=train_cfg.guard_warmup_steps,
        rollback_after=train_cfg.guard_rollback_after,
        vocab_size=model_cfg.vocab_size,
    )


def check_batch(batch: dict, vocab_size: int) -> torch.Tensor:
    """A 0-d bool tensor: some token id of the batch's inputs or targets
    lies outside ``[0, vocab_size)``."""
    bad = None
    for x in (batch["inputs"], batch["targets"]):
        b = ((x < 0) | (x >= vocab_size)).any()
        bad = b if bad is None else bad | b
    return bad


def safe_input_ids(ids: torch.Tensor, vocab_size: int) -> torch.Tensor:
    """The row each id reads in the JAX package's embedding gather
    (``wte[ids]``): a negative id wraps once (id + V), then the index is
    clamped into ``[0, V)``. With V = 5: -6 -> 0, -5 -> 0, -1 -> 4, 5 -> 4."""
    wrapped = torch.where(ids < 0, ids + vocab_size, ids)
    return wrapped.clamp(0, vocab_size - 1)


def safe_targets(targets: torch.Tensor, vocab_size: int):
    """What the JAX package's unfused cross-entropy does with a target id
    (``take_along_axis``): an id in ``[-V, 0)`` wraps to id + V, any other
    id outside ``[0, V)`` reads NaN. Returns (in-range targets, a 0-d bool:
    some target read NaN, so the mean loss is NaN)."""
    wrapped = torch.where(targets < 0, targets + vocab_size, targets)
    invalid = ((wrapped < 0) | (wrapped >= vocab_size)).any()
    return wrapped.clamp(0, vocab_size - 1), invalid


def guard_step(guard: GuardState, loss: torch.Tensor,
               grad_norm: torch.Tensor, bad_data: torch.Tensor,
               cfg: GuardConfig) -> tuple[GuardState, torch.Tensor]:
    """One guard update: classify this step, fold a clean loss into the
    EMA, advance the counters. Returns (new guard, anomaly: 0-d bool)."""
    loss32 = loss.float()
    nonfinite = ~torch.isfinite(loss32) | ~torch.isfinite(grad_norm)
    warmed = guard.seen >= cfg.warmup_steps
    spike = warmed & (loss32 > cfg.spike_factor * guard.ema)
    anomaly = nonfinite | spike | bad_data
    clean = ~anomaly
    # decay * ema + (1 - decay) * loss with the first product fused into
    # the sum, as XLA fuses the JAX guard's (one rounding, taken in f64:
    # the f32 product is exact there).
    decay = float(np.float32(cfg.ema_decay))
    fused = (decay * guard.ema.double()
             + ((1.0 - cfg.ema_decay) * loss32).double()).float()
    folded = torch.where(guard.seen == 0, loss32, fused)
    ema = torch.where(clean, folded, guard.ema)
    seen = guard.seen + clean.int()
    consecutive = torch.where(anomaly, guard.consecutive + 1,
                              torch.zeros_like(guard.consecutive))
    total = guard.total + anomaly.int()
    trip = guard.trip
    if cfg.rollback_after is not None:
        trip = trip | (consecutive >= cfg.rollback_after).int()
    return GuardState(ema, seen, consecutive, total, trip), anomaly


def apply_guard(anomaly: torch.Tensor, new_tree, old_tree):
    """The JAX ``apply_guard``: the old tree's leaves on anomaly, the new
    one's otherwise (``torch.where`` per leaf, on nested dicts and lists).
    The trainer's in-place update does not need it (``Optimizer.update``
    with ``anomaly=`` leaves the state as it was); it serves a caller that
    keeps both trees."""
    if isinstance(new_tree, dict):
        return {k: apply_guard(anomaly, new_tree[k], old_tree[k])
                for k in new_tree}
    if isinstance(new_tree, (list, tuple)):
        out = [apply_guard(anomaly, n, o) for n, o in zip(new_tree, old_tree)]
        return (type(new_tree)(*out) if hasattr(new_tree, "_fields")
                else type(new_tree)(out))
    return torch.where(anomaly, old_tree, new_tree)


def read_guard(guard: GuardState) -> dict:
    """The counters on the host (one sync): {"consecutive", "total",
    "trip"}. Call it only where the loop syncs anyway."""
    consecutive, total, trip = torch.stack(
        [guard.consecutive, guard.total, guard.trip]).tolist()
    return dict(consecutive=consecutive, total=total, trip=trip)
