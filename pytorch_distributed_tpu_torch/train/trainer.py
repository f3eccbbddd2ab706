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
evaluates. Not ported yet, and refused: the anomaly guard, the fault
injector and the async checkpoint (ROADMAP queue 1 item 5), the profiler
(item 6).
"""

from __future__ import annotations

import json
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

_GUARD = ("the anomaly guard is not ported yet (ROADMAP queue 1 item 5: "
          "train/guard)")


def _loss(model: ModelApi, cfg: ModelConfig, params, inputs, targets, *,
          deterministic: bool = True, key: DropoutKey | None = None,
          with_aux: bool = True):
    """The JAX ``micro_loss``: the forward, then the cross-entropy, fused
    with the head when ``cfg.fused_head_ce``; for a MoE config (and
    ``with_aux``) plus ``moe_aux_coef`` times the Switch term summed over
    layers."""
    aux = bool(cfg.n_experts) and with_aux
    out = model.apply(params, inputs, cfg, deterministic=deterministic,
                      dropout_seed=key, return_aux=aux,
                      return_hidden=cfg.fused_head_ce)
    out, aux_sum = out if aux else (out, None)
    if not cfg.fused_head_ce:
        loss = cross_entropy_loss(out, targets)
    else:
        w, layout = model.head_weight(params)
        loss = linear_cross_entropy(out.reshape(-1, out.shape[-1]), w,
                                    targets.reshape(-1), w_layout=layout,
                                    logits_dtype=cfg.logits_dtype)
    return loss if aux_sum is None else loss + cfg.moe_aux_coef * aux_sum


def make_train_step(
    model: ModelApi,
    model_cfg: ModelConfig,
    tx: Optimizer,
    *,
    accum_dtype: str = "float32",
    guard=None,
    seed: int = 42,
) -> Callable:
    """Build ``step(state, batch) -> (state, metrics)`` (see the module
    docstring). ``seed`` is the dropout streams' (the JAX Trainer's
    ``domain_key(train_cfg.seed, "dropout")``)."""
    if guard is not None or tx.cfg.anomaly_guard:
        raise NotImplementedError(_GUARD)
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
        accum = inputs.shape[0]
        ps = tree.leaves(state.params)
        keys = [DropoutKey(seed, state.step, i) for i in range(accum)]
        if accum == 1:
            loss, grads = loss_and_grads(ps, state.params, inputs[0],
                                         targets[0], keys[0])
        else:
            grads = [torch.zeros_like(p, dtype=acc_dtype) for p in ps]
            loss = torch.zeros((), dtype=torch.float32, device=ps[0].device)
            for i in range(accum):
                loss_i, g = loss_and_grads(ps, state.params, inputs[i],
                                           targets[i], keys[i])
                torch._foreach_add_(grads, [x.to(acc_dtype) for x in g])
                loss = loss + loss_i
                del g
            torch._foreach_div_(grads, accum)
            loss = loss / accum
        metrics = {"loss": loss, "grad_norm": global_norm(grads)}
        params, opt_state = tx.update(grads, state.opt_state, state.params)
        return TrainState(params, opt_state, state.step + 1), metrics

    return step


def make_eval_step(model: ModelApi, model_cfg: ModelConfig) -> Callable:
    """Build ``eval_fn(params, batch) -> loss`` (a device scalar): the
    deterministic forward and the training loss on "inputs"/"targets" of
    shape [B, T] or [A, B, T] (flattened to [A*B, T])."""

    @torch.no_grad()
    def eval_fn(params, batch):
        inputs, targets = batch["inputs"], batch["targets"]
        if inputs.dim() == 3:
            inputs = inputs.reshape(-1, inputs.shape[-1])
            targets = targets.reshape(-1, targets.shape[-1])
        return _loss(model, model_cfg, params, inputs, targets,
                     with_aux=False)

    return eval_fn


class Trainer:
    """The single-device training loop (the JAX ``Trainer`` without the
    guard, chaos and multi-process branches). The loader yields [B, T]
    (inputs, targets) numpy batches; the trainer groups ``accum`` of them
    into one [A, B, T] step batch on ``device`` (default: the card)."""

    def __init__(
        self,
        model: ModelApi,
        model_cfg: ModelConfig,
        train_cfg: TrainConfig,
        *,
        device: str | torch.device | None = None,
        log_fn: Callable[[str], None] | None = None,
    ):
        if train_cfg.anomaly_guard:
            raise NotImplementedError(_GUARD)
        if train_cfg.async_checkpoint:
            raise NotImplementedError(
                "async_checkpoint is not ported yet (ROADMAP queue 1 item "
                "5): the port saves npz checkpoints synchronously")
        self.model = model
        self.model_cfg = model_cfg
        self.train_cfg = train_cfg
        self.device = resolve_device(device)
        self.accum = train_cfg.grad_accum_steps()
        self.tx = make_optimizer(train_cfg)
        self.train_step = make_train_step(model, model_cfg, self.tx,
                                          accum_dtype=train_cfg.accum_dtype,
                                          seed=train_cfg.seed)
        self._log = log_fn or get_logger().info
        self._eval_step = make_eval_step(model, model_cfg)

    def set_fault_injector(self, injector) -> None:
        raise NotImplementedError(
            "the training fault injector is not ported yet (ROADMAP queue 1 "
            "item 5: train/chaos)")

    def put_batch(self, batch: dict) -> dict:
        """Numpy batches -> tensors on the trainer's device."""
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                for k, v in batch.items()}

    # -- state ------------------------------------------------------------
    def init_state(self) -> TrainState:
        """Fresh params (``model.init`` from a generator on the trainer's
        device seeded with ``train_cfg.seed``: the card draws a
        billion-parameter model in well under a second, where the host
        takes tens of seconds) and the optimizer state."""
        g = torch.Generator(device=self.device).manual_seed(
            self.train_cfg.seed)
        params = self.model.init(g, self.model_cfg, device=self.device)
        return init_train_state(params, self.tx)

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
        path = ckpt_lib.save_checkpoint(self.checkpoint_path(state.step),
                                        state, self.model_cfg,
                                        metadata=metadata)
        if self.train_cfg.keep_checkpoints is not None:
            ckpt_lib.prune_checkpoints(self.train_cfg.checkpoint_dir,
                                       self.train_cfg.keep_checkpoints)
        return path

    def load_checkpoint(self, path: str | Path,
                        state: TrainState) -> TrainState:
        return ckpt_lib.load_checkpoint(path, state, self.model_cfg)

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
        if profiler is not None:
            raise NotImplementedError(
                "the training profiler is not ported yet (ROADMAP queue 1 "
                "item 6)")
        cfg = self.train_cfg
        if state is None:
            state = self.init_state()
        num_steps = num_steps if num_steps is not None else cfg.num_steps
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
        try:
            while step < num_steps:
                if preempted["flag"]:
                    break  # the checkpoint is written once, after the loop
                batch = next(groups, None)
                if batch is None:
                    break
                state, metrics = self.train_step(state,
                                                 self.put_batch(batch))
                window_losses.append(metrics["loss"])
                step = state.step
                if step % cfg.log_every_n_steps == 0 or step == num_steps:
                    losses = torch.stack(window_losses).tolist()  # one sync
                    elapsed = time.perf_counter() - t0
                    lr = lr_at_step(cfg, step)
                    avg_loss = sum(losses) / len(losses)
                    entry = {"step": step, "lr": lr, "elapsed_s": elapsed,
                             "loss": avg_loss}
                    self._log(
                        f"step {step}/{num_steps} | loss {avg_loss:.4f} | "
                        f"lr {lr:.2e} | elapsed {elapsed:.1f}s"
                    )
                    history.append(entry)
                    self._write_metrics(entry)
                    window_losses = []
                if cfg.save_every_n_steps and \
                        step % cfg.save_every_n_steps == 0:
                    self.save_checkpoint(state, loader=dataloader)
        finally:
            for sig, prev in restore_handlers:
                signal.signal(sig, prev)
        if preempted["flag"]:
            self._log(f"preemption signal received: checkpointing at step "
                      f"{step}")
            self.save_checkpoint(state, loader=dataloader)
        return state, history

    def _write_metrics(self, entry: dict) -> None:
        """Append one JSON line to ``train_cfg.metrics_path`` (if set)."""
        path = self.train_cfg.metrics_path
        if not path:
            return
        p = Path(path)
        p.parent.mkdir(parents=True, exist_ok=True)
        with p.open("a") as f:
            f.write(json.dumps(entry) + "\n")

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
