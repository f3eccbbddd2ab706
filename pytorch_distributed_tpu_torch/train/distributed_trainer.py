"""The distributed training loop: the port of the JAX package's
``train/distributed_trainer.py`` (``DistributedTrainer``), one per rank.

- World identity from the mesh (``parallel/mesh.make_mesh`` over the
  process group ``initialize_distributed`` joined); the rank computes on
  ``mesh.device``.
- The accumulation factor is ``global // (micro * dp)``
  (``TrainConfig.grad_accum_steps``).
- The gradients are reduced once per optimizer step, at the accumulation
  boundary (``parallel/explicit``); the logged loss is already the global
  mean, equal on every rank.
- Logging and the metrics file are rank 0's (``utils.logging.
  is_process_zero``).
- ``put_batch`` places this rank's rows: a loader batch of
  ``micro_batch_size`` rows is the rank's own (a
  ``DistributedTokenShardLoader`` slice, its rank and world size taken
  from the process group), and a global one of ``micro * dp`` rows is
  cut to the rank's rows (``parallel/mesh.batch_rows``).
- ``save_checkpoint`` is called by every rank: the sharded save is
  collective, and the npz save gathers to rank 0 (``train/checkpoint``).
- ``evaluate`` gathers ZeRO-3's params once, runs each rank's batches and
  averages over the ranks.
- Under a tensor axis (Megatron TP) each rank holds its slices of the
  block leaves and runs the forward with the tensor group; the loss, the
  gradient norm and so the guard's decision come out bitwise the same on
  every rank, and tensor ranks take the same rows of a batch.
- Under a seq axis (sequence parallelism) each rank takes its span of
  every sequence of its rows (``parallel/mesh.seq_cols``): the loader
  reads the rank's rows whole (its rank is the batch shard's, so seq
  ranks read the same rows) and ``put_batch`` cuts the span. The params
  are whole on every seq rank, and the loss and gradient norm come out
  the same on each.
- Under an expert axis (expert parallelism, an MoE model) each rank
  holds its share of every MoE layer's experts and takes its own rows,
  as under data; the forward (training and ``evaluate``) exchanges
  tokens with the expert group, so every expert rank must run as many
  steps and evaluation batches.

- Under a pipe axis (``path="pipeline"``, ``parallel/pipeline``) each
  rank holds its stage's layers; the step is built with a clip-free
  optimizer and clips against the pipe-aware norm, as JAX's
  ``init_state`` does; every stage takes the same rows, and ``evaluate``
  gathers every stage's layers.

``path``: "auto" or "explicit", the same hand-scheduled step here
(``parallel/api``), or "pipeline" (GPipe or 1F1B by the mesh config's
``pipe_schedule``), which a pipe axis needs. The anomaly guard rides
"auto", as in JAX. The async save is a one-rank
save here: on several ranks it raises.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from pytorch_distributed_tpu_torch.config import (
    MeshConfig,
    ModelConfig,
    TrainConfig,
)
from pytorch_distributed_tpu_torch.models import ModelApi
from pytorch_distributed_tpu_torch.parallel import zero
from pytorch_distributed_tpu_torch.parallel.api import (
    make_parallel_train_step,
)
from pytorch_distributed_tpu_torch.parallel.explicit import (
    check_expert,
    check_seq,
    check_tensor_dropout,
    make_explicit_train_step,
)
from pytorch_distributed_tpu_torch.parallel.pipeline import (
    check_pipeline,
    make_pipeline_train_step,
    shard_pipeline_state,
)
from pytorch_distributed_tpu_torch.parallel.mesh import (
    Mesh,
    batch_rows,
    data_parallel_size,
    seq_cols,
)
from pytorch_distributed_tpu_torch.parallel.sharding import (
    shard_train_state,
)
from pytorch_distributed_tpu_torch.train.optim import make_optimizer
from pytorch_distributed_tpu_torch.train.state import TrainState
from pytorch_distributed_tpu_torch.train.trainer import (
    Trainer,
    make_eval_step,
)
from pytorch_distributed_tpu_torch.utils.logging import (
    get_logger,
    is_process_zero,
)


class DistributedTrainer(Trainer):
    def __init__(
        self,
        model: ModelApi,
        model_cfg: ModelConfig,
        train_cfg: TrainConfig,
        mesh: Mesh,
        mesh_cfg: MeshConfig,
        *,
        path: str = "auto",
        log_fn: Callable[[str], None] | None = None,
    ):
        check_tensor_dropout(model_cfg, mesh_cfg)
        check_seq(model_cfg, mesh_cfg)
        check_expert(model_cfg, mesh_cfg)
        if path not in ("auto", "explicit", "pipeline"):
            raise ValueError(f"unknown parallel path {path!r}")
        if path == "pipeline":
            check_pipeline(model_cfg, mesh_cfg)
        elif mesh_cfg.pipe > 1:
            raise ValueError(f"a pipe axis trains on path='pipeline', not "
                             f"path={path!r}")
        if train_cfg.anomaly_guard and path != "auto":
            raise ValueError(
                f"anomaly_guard is supported on path='auto', not "
                f"path={path!r}")
        if train_cfg.async_checkpoint and mesh.size > 1:
            raise NotImplementedError(
                "async_checkpoint is a one-rank save in the port; on "
                f"{mesh.size} ranks save synchronously")
        if mesh.cfg != mesh_cfg:
            raise ValueError("mesh_cfg is not the mesh's config")
        self.mesh = mesh
        self.mesh_cfg = mesh_cfg
        self.path = path

        def gated_log(msg: str) -> None:
            if is_process_zero():
                (log_fn or get_logger().info)(msg)

        super().__init__(
            model, model_cfg, train_cfg, device=mesh.device,
            data_parallel_size=data_parallel_size(mesh_cfg),
            put_batch=self._put_batch_impl, log_fn=gated_log)
        self.train_step = None  # init_state builds it, knowing the layout
        if mesh_cfg.tensor > 1 or mesh_cfg.expert > 1:
            self._eval_step = make_eval_step(
                model, model_cfg,
                tp_group=(mesh.axis_group("tensor") if mesh_cfg.tensor > 1
                          else None),
                expert_group=(mesh.axis_group("expert")
                              if mesh_cfg.expert > 1 else None))

    # -- state ------------------------------------------------------------
    def init_state(self) -> TrainState:
        """The full state from the seed (the same on every rank), sharded;
        builds the step."""
        cfg = self.train_cfg
        if self.path == "pipeline":
            state, self.sharding = shard_pipeline_state(
                super().init_state(), self.mesh)
            # Clip-free: the step clips against the pipe-aware norm.
            self.train_step = make_pipeline_train_step(
                self.model, self.model_cfg,
                make_optimizer(cfg, with_clip=False), self.mesh,
                self.mesh_cfg, self.sharding, cfg,
                grad_clip_norm=cfg.grad_clip_norm,
                accum_dtype=cfg.accum_dtype, seed=cfg.seed)
            return state
        state, self.sharding = shard_train_state(super().init_state(),
                                                 self.mesh)
        if self.path == "explicit":
            self.train_step = make_explicit_train_step(
                self.model, self.model_cfg,
                make_optimizer(cfg, with_clip=False), self.mesh,
                self.mesh_cfg, self.sharding,
                grad_clip_norm=cfg.grad_clip_norm,
                accum_dtype=cfg.accum_dtype, seed=cfg.seed)
        else:
            self.train_step, _ = make_parallel_train_step(
                self.model, self.model_cfg, self.tx, self.mesh,
                self.mesh_cfg, self.sharding, accum_dtype=cfg.accum_dtype,
                guard=self.guard_cfg, seed=cfg.seed)
        return state

    def _is_metrics_writer(self) -> bool:
        return is_process_zero()

    # -- data placement ---------------------------------------------------
    def _put_batch_impl(self, batch: dict) -> dict:
        """This rank's rows of a host [A, B, T] batch, and its span of T,
        on its device (module docstring)."""
        micro = self.train_cfg.micro_batch_size
        dp = data_parallel_size(self.mesh_cfg)
        out = {}
        for k, v in batch.items():
            v = np.asarray(v)
            if v.shape[1] == micro * dp and dp > 1:
                v = v[:, batch_rows(self.mesh, v.shape[1])]
            elif v.shape[1] != micro:
                raise ValueError(
                    f"batch of {v.shape[1]} rows: this rank takes "
                    f"{micro} (its own) or {micro * dp} (global)")
            v = v[:, :, seq_cols(self.mesh, v.shape[2])]
            out[k] = torch.from_numpy(np.ascontiguousarray(v)).to(
                self.device)
        return out

    # -- the loop ---------------------------------------------------------
    def train(self, dataloader, *, state=None, profiler=None,
              num_steps=None):
        if state is None:
            state = self.init_state()
        if self.train_step is None:
            raise RuntimeError("call init_state() before train()")
        return super().train(dataloader, state=state, profiler=profiler,
                             num_steps=num_steps)

    # -- evaluation -------------------------------------------------------
    def evaluate(self, state: TrainState, dataloader, *,
                 max_batches: int | None = None) -> float:
        """Mean loss over each rank's validation batches ([B, T]), averaged
        over the ranks (each rank must see as many batches)."""
        with torch.no_grad():
            params = zero.gather_params(state.params, self.sharding.params,
                                        self.mesh)
            params = dict(params, blocks=zero.unstage_blocks(
                params["blocks"], self.mesh))
            losses = []
            for i, (inputs, targets) in enumerate(dataloader):
                if max_batches is not None and i >= max_batches:
                    break
                batch = {k: torch.from_numpy(np.ascontiguousarray(v)).to(
                    self.device) for k, v in (("inputs", inputs),
                                              ("targets", targets))}
                losses.append(self._eval_step(params, batch))
            if not losses:
                raise ValueError("evaluate() got an empty dataloader")
            mean = torch.stack(losses).mean()
            zero.all_reduce_(mean, self.mesh.group)
        return mean.item() / self.mesh.size
