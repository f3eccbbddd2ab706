"""The single-device training loop: the port of the JAX package's
``train/trainer.py`` (``make_train_step``, ``make_eval_step`` and the
``Trainer``).

``make_train_step(model, model_cfg, tx) -> step(state, batch) -> (state,
metrics)``. ``batch`` holds "inputs" and "targets" of shape [A, B, T]
(A = 1: no accumulation). Each micro-batch runs ``model.apply`` — in
training mode when any ``*_pdrop > 0``, its dropout masks drawn from the
stream ``DropoutKey(seed, state.step, micro)`` (``utils/prng``; micro is
0 when A = 1, as JAX's ``fold_in(key, 0)``) — then the f32 cross-entropy
(or, with ``fused_head_ce``, ``ops/losses.linear_cross_entropy`` on the
final-norm hidden states and ``model.head_weight``) and
``torch.autograd.grad``; for A > 1 the gradients are summed in an
``accum_dtype`` buffer and divided by A, and the loss is the mean over
micro-batches. A MoE config adds ``moe_aux_coef`` times the Switch
load-balancing term to each micro-batch's loss (and to the reported
loss), as JAX does. Then one optimizer update (``train/optim``). Metrics:
``loss`` and ``grad_norm``, the global norm of the averaged gradients
before clipping, both as device scalars (reading them is the caller's
sync). The step updates the state's params and optimizer moments in
place and returns them in a new ``TrainState`` (the JAX step donates its
input state: the old values are not used again either way).

``make_eval_step(model, model_cfg) -> eval_fn(params, batch) -> loss``:
the deterministic forward (flash attention takes the kernels) and the
same cross-entropy, fused or not (no MoE aux term, as in JAX), on [B, T]
or [A, B, T] batches, under ``torch.no_grad()``.

``Trainer`` groups A loader batches into one step batch, places it on its
device (``put_batch``), steps, keeps the per-step losses on the device
until a log boundary (one sync per window), logs, writes the metrics
JSON lines, saves npz checkpoints (``train/checkpoint``, the loader's
position in their metadata) and prunes them, resumes from the newest
good one, saves once on SIGTERM/SIGINT with ``save_on_preemption``, and
evaluates. ``train(profiler=...)`` steps a profiler
(``profiling.ScheduledProfiler``) once per optimizer step and runs each
step inside its ``step_context``.

**The anomaly guard** (``train_cfg.anomaly_guard``; ``train/guard``):
``make_train_step(guard=GuardConfig)`` checks the batch's ids, maps
out-of-range ids as the JAX package's gathers do (``guard.safe_input_ids``
and, on the unfused loss, ``guard.safe_targets``: the loss reads NaN where
JAX's does), runs ``guard_step`` on the loss and gradient norm, and hands
the anomaly flag to ``Optimizer.update``, which then leaves the state as
it was; ``metrics["anomaly"]`` is the flag. None of it reads a device
value on the host. The loop reads the counters only where it syncs
anyway — at a log boundary (non-finite losses are left out of the
window's average, and ``anomalies`` joins the entry) and at a save
boundary (a save inside an anomaly burst is deferred) — and when ``trip``
is set rolls back to the newest loadable checkpoint
(``guard_rollback_after``, ``guard_skip_window``, ``guard_max_rollbacks``;
no checkpoint, or too many rollbacks, raises). A trip pending when the
loop ends early is logged as a warning, and a preemption save with
anomalies pending is skipped when a good checkpoint exists.

**Faults** (``set_fault_injector``, ``train/chaos.TrainFaultInjector``):
host hooks at the step boundary (``on_step``, then ``before_step``, which
may crash, signal or corrupt the numpy batch) and after each save
(``after_save``); the injector's ``install`` also sets the checkpoint
module's save hook (a crash inside a save, before it commits). The step
never sees the injector.

**Async checkpoints** (``train_cfg.async_checkpoint``): each save is
``checkpoint.save_checkpoint_async`` (the state copied to host memory
before it returns, the payload written by a thread), made visible by the
next save, by ``resume_latest``, by a rollback, and at the end of
``train`` (also when it raises).
"""

from __future__ import annotations

import contextlib
import json
import math
import signal
import time
from pathlib import Path
from typing import Any, Callable, Iterable

import numpy as np
import torch

from pytorch_distributed_tpu_torch.config import ModelConfig, TrainConfig
from pytorch_distributed_tpu_torch.models import ModelApi
from pytorch_distributed_tpu_torch.ops.losses import (
    cross_entropy_loss,
    linear_cross_entropy,
)
from pytorch_distributed_tpu_torch.train import checkpoint as ckpt_lib
from pytorch_distributed_tpu_torch.train import guard as guard_lib
from pytorch_distributed_tpu_torch.train.guard import (
    GuardConfig,
    guard_config_from,
)
from pytorch_distributed_tpu_torch.train.optim import (
    Optimizer,
    global_norm,
    lr_at_step,
    make_optimizer,
)
from pytorch_distributed_tpu_torch.train.state import (
    TrainState,
    init_train_state,
)
from pytorch_distributed_tpu_torch.utils import tree
from pytorch_distributed_tpu_torch.utils.device import resolve_device
from pytorch_distributed_tpu_torch.utils.logging import get_logger
from pytorch_distributed_tpu_torch.utils.prng import DropoutKey

def _loss(model: ModelApi, cfg: ModelConfig, params, inputs, targets, *,
          deterministic: bool = True, key: DropoutKey | None = None,
          with_aux: bool = True, block_transform=None, tp_group=None,
          seq_group=None):
    """The JAX ``micro_loss``: the forward, then the cross-entropy, fused
    with the head when ``cfg.fused_head_ce``; for a MoE config (and
    ``with_aux``) plus ``moe_aux_coef`` times the Switch term summed over
    layers. ``block_transform``, ``tp_group`` and ``seq_group``: the
    forward's (``parallel/explicit``'s per-layer gather, tensor group and
    sequence group; under the last the loss is the mean over this rank's
    tokens)."""
    aux = bool(cfg.n_experts) and with_aux
    out = model.apply(params, inputs, cfg, deterministic=deterministic,
                      dropout_seed=key, return_aux=aux,
                      return_hidden=cfg.fused_head_ce,
                      block_transform=block_transform, tp_group=tp_group,
                      seq_group=seq_group)
    out, aux_sum = out if aux else (out, None)
    if not cfg.fused_head_ce:
        loss = cross_entropy_loss(out, targets)
    else:
        w, layout = model.head_weight(params)
        loss = linear_cross_entropy(out.reshape(-1, out.shape[-1]), w,
                                    targets.reshape(-1), w_layout=layout,
                                    logits_dtype=cfg.logits_dtype)
    return loss if aux_sum is None else loss + cfg.moe_aux_coef * aux_sum


def accumulate_grads(loss_and_grads: Callable, accum: int, leaves: list,
                     acc_dtype: torch.dtype):
    """Gradient accumulation over ``accum`` micro-batches:
    ``loss_and_grads(i)`` gives micro-batch i's (loss, gradients as a list
    like ``leaves``). One micro-batch is returned as it is; more are
    summed in an ``acc_dtype`` buffer and divided by ``accum``, and so is
    the loss. Returns (loss, grads)."""
    if accum == 1:
        return loss_and_grads(0)
    grads = [torch.zeros_like(p, dtype=acc_dtype) for p in leaves]
    loss = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    for i in range(accum):
        loss_i, g = loss_and_grads(i)
        torch._foreach_add_(grads, [x.to(acc_dtype) for x in g])
        loss = loss + loss_i
        del g
    torch._foreach_div_(grads, accum)
    return loss / accum, grads


def make_train_step(
    model: ModelApi,
    model_cfg: ModelConfig,
    tx: Optimizer,
    *,
    accum_dtype: str = "float32",
    guard: GuardConfig | None = None,
    seed: int = 42,
) -> Callable:
    """Build ``step(state, batch) -> (state, metrics)`` (see the module
    docstring). ``seed`` is the dropout streams' (the JAX Trainer's
    ``domain_key(train_cfg.seed, "dropout")``). ``guard``: the anomaly
    guard (``state.guard`` must then be a ``GuardState`` and the optimizer
    counts device tensors: ``init_train_state(..., guard=...)``)."""
    vocab = model_cfg.vocab_size
    train_mode = (model_cfg.embd_pdrop > 0 or model_cfg.attn_pdrop > 0
                  or model_cfg.resid_pdrop > 0)
    acc_dtype = getattr(torch, accum_dtype)

    def loss_and_grads(leaves_like, params, inputs, targets, key):
        live = [p.detach().requires_grad_(True) for p in leaves_like]
        loss = _loss(model, model_cfg, tree.unflatten(params, live), inputs,
                     targets, deterministic=not train_mode, key=key)
        grads = torch.autograd.grad(loss, live)
        return loss.detach(), list(grads)

    def step(state: TrainState, batch: dict):
        inputs, targets = batch["inputs"], batch["targets"]
        if inputs.dim() != 3 or inputs.shape != targets.shape:
            raise ValueError(
                f"batch inputs/targets must be [A, B, T] of one shape, got "
                f"{tuple(inputs.shape)} and {tuple(targets.shape)}"
            )
        nan_target = None
        if guard is not None:
            if state.guard is None:
                raise ValueError("a guarded step needs state.guard: "
                                 "init_train_state(..., guard=...)")
            bad_data = (guard_lib.check_batch(batch, guard.vocab_size)
                        if guard.vocab_size else
                        torch.zeros((), dtype=torch.bool,
                                    device=inputs.device))
            inputs = guard_lib.safe_input_ids(inputs, vocab)
            if not model_cfg.fused_head_ce:
                # The fused loss already reads out-of-range targets as JAX's
                # fused loss does (no column matches them).
                targets, nan_target = guard_lib.safe_targets(targets, vocab)
        ps = tree.leaves(state.params)
        loss, grads = accumulate_grads(
            lambda i: loss_and_grads(ps, state.params, inputs[i], targets[i],
                                     DropoutKey(seed, state.step, i)),
            inputs.shape[0], ps, acc_dtype)
        if nan_target is not None:
            loss = torch.where(nan_target, torch.nan, loss)
        metrics = {"loss": loss, "grad_norm": global_norm(grads)}
        if guard is None:
            params, opt_state = tx.update(grads, state.opt_state,
                                          state.params)
            return TrainState(params, opt_state, state.step + 1), metrics
        new_guard, anomaly = guard_lib.guard_step(
            state.guard, loss, metrics["grad_norm"], bad_data, guard)
        params, opt_state = tx.update(grads, state.opt_state, state.params,
                                      anomaly=anomaly)
        metrics["anomaly"] = anomaly
        return (TrainState(params, opt_state, state.step + 1, new_guard),
                metrics)

    return step


def make_eval_step(model: ModelApi, model_cfg: ModelConfig, *,
                   tp_group=None) -> Callable:
    """Build ``eval_fn(params, batch) -> loss`` (a device scalar): the
    deterministic forward and the training loss on "inputs"/"targets" of
    shape [B, T] or [A, B, T] (flattened to [A*B, T]). ``tp_group``: the
    forward's tensor group (``params`` then this rank's slices)."""

    @torch.no_grad()
    def eval_fn(params, batch):
        inputs, targets = batch["inputs"], batch["targets"]
        if inputs.dim() == 3:
            inputs = inputs.reshape(-1, inputs.shape[-1])
            targets = targets.reshape(-1, targets.shape[-1])
        return _loss(model, model_cfg, params, inputs, targets,
                     with_aux=False, tp_group=tp_group)

    return eval_fn


class Trainer:
    """The training loop. The loader yields [B, T] (inputs, targets)
    numpy batches; the trainer groups ``accum`` of them into one [A, B, T]
    step batch on ``device`` (default: the card). The JAX ``Trainer``'s
    hooks for ``train/distributed_trainer``: ``data_parallel_size`` (the
    accumulation rule ``global // (micro * dp)``), ``put_batch`` (in place
    of the move to ``device``), ``train_step`` (in place of the
    single-device step) and ``_is_metrics_writer``; left at their
    defaults, the trainer is the single-device one."""

    def __init__(
        self,
        model: ModelApi,
        model_cfg: ModelConfig,
        train_cfg: TrainConfig,
        *,
        device: str | torch.device | None = None,
        data_parallel_size: int = 1,
        put_batch: Callable[[dict], dict] | None = None,
        train_step: Callable | None = None,
        log_fn: Callable[[str], None] | None = None,
    ):
        self.model = model
        self.model_cfg = model_cfg
        self.train_cfg = train_cfg
        self.device = resolve_device(device)
        self.accum = train_cfg.grad_accum_steps(data_parallel_size)
        self.tx = make_optimizer(train_cfg)
        self.guard_cfg = guard_config_from(train_cfg, model_cfg)
        self.train_step = (
            train_step if train_step is not None
            else make_train_step(model, model_cfg, self.tx,
                                 accum_dtype=train_cfg.accum_dtype,
                                 guard=self.guard_cfg, seed=train_cfg.seed))
        if put_batch is not None:
            self.put_batch = put_batch
        # The state's layout over ranks (train/distributed_trainer); the
        # checkpoint calls take it. None on one device.
        self.sharding = None
        self._log = log_fn or get_logger().info
        self._eval_step = make_eval_step(model, model_cfg)
        self._injector = None  # train/chaos.TrainFaultInjector, or None
        self._rollbacks = 0

    def set_fault_injector(self, injector) -> None:
        """Install a ``train/chaos.TrainFaultInjector`` (None removes it):
        host hooks at the step and save boundaries."""
        self._injector = injector

    def put_batch(self, batch: dict) -> dict:
        """Numpy batches -> tensors on the trainer's device."""
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                for k, v in batch.items()}

    # -- state ------------------------------------------------------------
    def init_state(self) -> TrainState:
        """Fresh params (``model.init`` from a generator on the trainer's
        device seeded with ``train_cfg.seed``: the card draws a
        billion-parameter model in well under a second, where the host
        takes tens of seconds), the optimizer state and, with the guard,
        a fresh ``GuardState``."""
        g = torch.Generator(device=self.device).manual_seed(
            self.train_cfg.seed)
        params = self.model.init(g, self.model_cfg, device=self.device)
        guard = (guard_lib.init_guard_state(self.device)
                 if self.guard_cfg is not None else None)
        return init_train_state(params, self.tx, guard=guard)

    # -- checkpointing ----------------------------------------------------
    def checkpoint_path(self, step: int) -> Path:
        return Path(self.train_cfg.checkpoint_dir) / f"checkpoint_step_{step}"

    def save_checkpoint(self, state: TrainState, *,
                        loader: Any | None = None) -> str:
        metadata: dict = {"step": int(state.step)}
        if loader is not None and hasattr(loader, "state_dict"):
            # The stream position rides the checkpoint, so a resumed run
            # continues the token stream instead of repeating it.
            metadata["loader_state"] = loader.state_dict()
        save = (ckpt_lib.save_checkpoint_async
                if self.train_cfg.async_checkpoint
                else ckpt_lib.save_checkpoint)
        # The async save finalizes the one before it first; the prune then
        # keeps disk bounded during the run (it never touches the save in
        # flight).
        path = save(self.checkpoint_path(state.step), state, self.model_cfg,
                    metadata=metadata, **self._sharding_kw())
        if self.train_cfg.keep_checkpoints is not None:
            ckpt_lib.prune_checkpoints(self.train_cfg.checkpoint_dir,
                                       self.train_cfg.keep_checkpoints)
        if self._injector is not None:
            self._injector.after_save(self.train_cfg.checkpoint_dir)
        return path

    def load_checkpoint(self, path: str | Path,
                        state: TrainState) -> TrainState:
        return ckpt_lib.load_checkpoint(path, state, self.model_cfg,
                                        **self._sharding_kw())

    def _sharding_kw(self) -> dict:
        """The checkpoint calls' ``sharding``, where the state has one."""
        return {} if self.sharding is None else {"sharding": self.sharding}

    def _load_latest_good(
        self, state: TrainState
    ) -> tuple[TrainState, str] | None:
        """Walk the committed checkpoints newest-first and load the first
        one that passes verification, logging every corrupt one skipped.
        None when there is none; raises ``CheckpointCorrupt`` when there
        are some and all fail (a silent restart would lose the run)."""
        root = self.train_cfg.checkpoint_dir
        candidates = ckpt_lib.list_checkpoints(root)
        if not candidates:
            stray = ckpt_lib.uncommitted_checkpoints(root)
            if stray:
                names = ", ".join(Path(s).name for s in stray[:3])
                self._log(
                    f"WARNING: no committed checkpoint in {root}, but "
                    f"{len(stray)} checkpoint dir(s) without a COMMIT marker "
                    f"exist ({names}{', ...' if len(stray) > 3 else ''}): "
                    "half-written saves — not resumable; training starts "
                    "fresh"
                )
            return None
        for path in candidates:
            try:
                return self.load_checkpoint(path, state), path
            except ckpt_lib.CheckpointCorrupt as e:
                self._log(
                    f"checkpoint {path} failed integrity verification ({e}); "
                    "falling back to the next-older retained checkpoint"
                )
        raise ckpt_lib.CheckpointCorrupt(
            f"all {len(candidates)} retained checkpoints in {root} failed "
            "verification"
        )

    def resume_latest(self, state: TrainState, *,
                      loader: Any | None = None) -> TrainState:
        ckpt_lib.finalize_async_save()  # an in-flight save is invisible
        loaded = self._load_latest_good(state)
        if loaded is None:
            return state
        restored, path = loaded
        self._log(f"resuming from {path}")
        if loader is not None and hasattr(loader, "load_state_dict"):
            meta = ckpt_lib.read_metadata(path)
            if "loader_state" in meta:
                loader.load_state_dict(meta["loader_state"])
        return restored

    def _guard_rollback(self, state: TrainState, dataloader, groups):
        """The guard tripped: restore the newest loadable checkpoint,
        rewind the data stream to its position (unless
        ``guard_skip_window``, the policy for persistent corruption) and go
        on. Returns (state, groups, step). Raises when no checkpoint loads
        or ``guard_max_rollbacks`` is spent: a thrashing run must fail."""
        cfg = self.train_cfg
        self._rollbacks += 1
        if self._rollbacks > cfg.guard_max_rollbacks:
            raise RuntimeError(
                f"anomaly guard rolled back {cfg.guard_max_rollbacks} "
                "times in one run and tripped again — the anomaly is "
                "persistent; inspect the data/numerics (or set "
                "guard_skip_window=True for corrupt-data streams)"
            )
        ckpt_lib.finalize_async_save()
        loaded = self._load_latest_good(state)
        if loaded is None:
            raise RuntimeError(
                "anomaly guard tripped but no checkpoint exists to roll "
                "back to; set save_every_n_steps (or disable rollback "
                "with guard_rollback_after=None)"
            )
        restored, path = loaded
        rewound = False
        if not cfg.guard_skip_window:
            meta = ckpt_lib.read_metadata(path)
            if hasattr(dataloader, "load_state_dict") and \
                    "loader_state" in meta:
                dataloader.load_state_dict(meta["loader_state"])
                groups = self._grouped_batches(dataloader)
                rewound = True
        self._log(
            f"anomaly guard tripped: rolled back to {path} (step "
            f"{restored.step}, rollback {self._rollbacks}/"
            f"{cfg.guard_max_rollbacks}); data stream "
            + ("rewound and replayed" if rewound else
               "NOT rewound — offending window skipped")
        )
        return restored, groups, restored.step

    # -- data grouping ----------------------------------------------------
    def _grouped_batches(self, dataloader: Iterable):
        """Group ``accum`` [B, T] micro-batches into one [A, B, T] step
        batch; a trailing partial group is dropped (the optimizer steps on
        complete accumulation windows only)."""
        inputs_buf: list[np.ndarray] = []
        targets_buf: list[np.ndarray] = []
        for inputs, targets in dataloader:
            inputs_buf.append(np.asarray(inputs))
            targets_buf.append(np.asarray(targets))
            if len(inputs_buf) == self.accum:
                yield {"inputs": np.stack(inputs_buf),
                       "targets": np.stack(targets_buf)}
                inputs_buf, targets_buf = [], []

    # -- the loop ---------------------------------------------------------
    def train(
        self,
        dataloader: Iterable,
        *,
        state: TrainState | None = None,
        profiler: Any | None = None,
        num_steps: int | None = None,
    ) -> tuple[TrainState, list[dict]]:
        cfg = self.train_cfg
        if state is None:
            state = self.init_state()
        num_steps = num_steps if num_steps is not None else cfg.num_steps
        guarded = self.guard_cfg is not None
        history: list[dict] = []
        # Per-step losses stay on the device until a log boundary: reading
        # one every step would make the host wait for step n before it
        # enqueues step n + 1.
        window_losses: list[torch.Tensor] = []
        t0 = time.perf_counter()
        step = state.step

        preempted = {"flag": False}
        restore_handlers: list = []
        if cfg.save_on_preemption:
            def _on_signal(signum, frame):
                preempted["flag"] = True

            try:
                for sig in (signal.SIGTERM, signal.SIGINT):
                    restore_handlers.append(
                        (sig, signal.signal(sig, _on_signal)))
            except ValueError:
                restore_handlers = []  # not the main thread: no handlers

        # Explicit iterator: the stop check comes BEFORE the next group is
        # fetched, or the saved loader position would skip data the
        # resumed run never trains on.
        groups = self._grouped_batches(dataloader)
        self._rollbacks = 0
        try:
            while step < num_steps:
                if preempted["flag"]:
                    break  # the checkpoint is written once, after the loop
                batch = next(groups, None)
                if batch is None:
                    break
                if self._injector is not None:
                    # Arm this step's faults, then let the injector crash,
                    # signal or corrupt the host batch before it is placed.
                    self._injector.on_step(step + 1)
                    batch = self._injector.before_step(step + 1, batch)
                ctx = (profiler.step_context(step)
                       if profiler is not None
                       and hasattr(profiler, "step_context")
                       else contextlib.nullcontext())
                with ctx:
                    state, metrics = self.train_step(state,
                                                     self.put_batch(batch))
                window_losses.append(metrics["loss"])
                step = state.step
                if profiler is not None:
                    profiler.step()
                if step % cfg.log_every_n_steps == 0 or step == num_steps:
                    losses = torch.stack(window_losses).tolist()  # one sync
                    elapsed = time.perf_counter() - t0
                    lr = lr_at_step(cfg, step)
                    entry = {"step": step, "lr": lr, "elapsed_s": elapsed}
                    suffix = ""
                    if guarded:
                        # The counters ride the window's sync; skipped
                        # (non-finite) losses stay out of the average, so
                        # one NaN step does not turn the line NaN.
                        g = guard_lib.read_guard(state.guard)
                        finite = [x for x in losses if math.isfinite(x)]
                        avg_loss = (sum(finite) / len(finite) if finite
                                    else float("nan"))
                        entry["anomalies"] = g["total"]
                        if g["total"]:
                            suffix = f" | anomalies {g['total']}"
                    else:
                        avg_loss = sum(losses) / len(losses)
                    entry["loss"] = avg_loss
                    self._log(
                        f"step {step}/{num_steps} | loss {avg_loss:.4f} | "
                        f"lr {lr:.2e} | elapsed {elapsed:.1f}s{suffix}"
                    )
                    history.append(entry)
                    self._write_metrics(entry)
                    window_losses = []
                    if guarded and g["trip"]:
                        state, groups, step = self._guard_rollback(
                            state, dataloader, groups)
                        continue
                if cfg.save_every_n_steps and \
                        step % cfg.save_every_n_steps == 0:
                    if guarded:
                        # A checkpoint must not capture anomalies not yet
                        # adjudicated: a later rollback would land on a
                        # state that silently skipped the poisoned window.
                        # The save syncs anyway, so this read is free.
                        g = guard_lib.read_guard(state.guard)
                        if g["trip"]:
                            window_losses = []
                            state, groups, step = self._guard_rollback(
                                state, dataloader, groups)
                            continue
                        if g["consecutive"] > 0:
                            self._log(
                                f"deferring checkpoint at step {step}: "
                                f"anomaly burst in progress "
                                f"({g['consecutive']} consecutive)")
                            continue
                    self.save_checkpoint(state, loader=dataloader)
        finally:
            for sig, prev in restore_handlers:
                signal.signal(sig, prev)
            if cfg.async_checkpoint:
                # An in-flight save is committed only by finalize: a raised
                # step must not discard a fully written checkpoint.
                ckpt_lib.finalize_async_save()
        if guarded and step < num_steps:
            # The loop ended early between boundaries: a pending trip would
            # vanish unadjudicated, and there is no data left to replay.
            g = guard_lib.read_guard(state.guard)
            if g["trip"] or g["consecutive"]:
                self._log(
                    f"WARNING: training ended at step {step} with "
                    f"un-adjudicated anomalies (consecutive "
                    f"{g['consecutive']}, trip {g['trip']}): the returned "
                    "state skipped anomalous windows without rollback; "
                    "resume from the last good checkpoint to replay them"
                )
        if preempted["flag"]:
            skip_save = False
            if guarded:
                # The clean-history rule of the in-loop saves: a
                # preemption checkpoint carrying pending anomalies would
                # anchor every later resume on a state that silently lost
                # the poisoned window's replay — unless there is no good
                # checkpoint at all (a tainted one beats losing the run).
                g = guard_lib.read_guard(state.guard)
                if g["trip"] or g["consecutive"]:
                    ckpt_lib.finalize_async_save()
                    prior = ckpt_lib.latest_checkpoint(cfg.checkpoint_dir)
                    skip_save = prior is not None
                    if skip_save:
                        self._log(
                            f"preemption checkpoint at step {step} "
                            f"SKIPPED: un-adjudicated anomalies "
                            f"(consecutive {g['consecutive']}, trip "
                            f"{g['trip']}); resume replays from {prior}")
                    else:
                        self._log(
                            f"WARNING: preemption checkpoint at step "
                            f"{step} carries un-adjudicated anomalies "
                            f"(consecutive {g['consecutive']}, trip "
                            f"{g['trip']}) — saved anyway, no earlier "
                            "checkpoint exists; the skipped windows were "
                            "not replayed")
            if not skip_save:
                self._log(f"preemption signal received: checkpointing at "
                          f"step {step}")
                self.save_checkpoint(state, loader=dataloader)
        if cfg.async_checkpoint:
            # The last save is committed and visible before train returns.
            ckpt_lib.finalize_async_save()
            if cfg.keep_checkpoints is not None:
                ckpt_lib.prune_checkpoints(cfg.checkpoint_dir,
                                           cfg.keep_checkpoints)
        return state, history

    def _write_metrics(self, entry: dict) -> None:
        """Append one JSON line to ``train_cfg.metrics_path`` (if set)."""
        path = self.train_cfg.metrics_path
        if not path or not self._is_metrics_writer():
            return
        p = Path(path)
        p.parent.mkdir(parents=True, exist_ok=True)
        with p.open("a") as f:
            f.write(json.dumps(entry) + "\n")

    def _is_metrics_writer(self) -> bool:
        return True  # the DistributedTrainer writes from rank 0 only

    # -- evaluation -------------------------------------------------------
    def evaluate(self, state: TrainState, dataloader: Iterable, *,
                 max_batches: int | None = None) -> float:
        """Mean loss over a validation loader ([B, T] batches) with the
        deterministic forward; the losses stay on the device until one
        final sync."""
        losses: list[torch.Tensor] = []
        for i, (inputs, targets) in enumerate(dataloader):
            if max_batches is not None and i >= max_batches:
                break
            batch = self.put_batch({"inputs": inputs[None],
                                    "targets": targets[None]})
            losses.append(self._eval_step(state.params, batch))
        if not losses:
            raise ValueError("evaluate() got an empty dataloader")
        vals = torch.stack(losses).tolist()
        return sum(vals) / len(vals)
