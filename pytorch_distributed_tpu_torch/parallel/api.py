"""``make_parallel_train_step``: the port of the JAX package's
``parallel/api.py``, with its signature.

**A deliberate difference.** JAX's "auto" path is a pjit step whose
collectives XLA's SPMD partitioner places from sharding annotations.
PyTorch has no such partitioner, so here "auto" builds the same
hand-scheduled step as "explicit" (``parallel/explicit``): the optimizer's
clip, which in JAX runs on the global gradients inside the partitioned
step, becomes the explicit step's clip against the global norm. The
anomaly guard is accepted here, as in JAX: its loss and gradient norm are
global and equal on every rank, so its counters stay in step with no
collective of their own (the batch's id flag is summed over the ranks).
"""

from __future__ import annotations

from pytorch_distributed_tpu_torch.config import MeshConfig, ModelConfig
from pytorch_distributed_tpu_torch.models import ModelApi
from pytorch_distributed_tpu_torch.parallel.explicit import (
    make_explicit_train_step,
)
from pytorch_distributed_tpu_torch.parallel.mesh import Mesh, make_batch_put
from pytorch_distributed_tpu_torch.parallel.sharding import StateSharding
from pytorch_distributed_tpu_torch.train.guard import GuardConfig
from pytorch_distributed_tpu_torch.train.optim import (
    Optimizer,
    make_optimizer,
)


def make_parallel_train_step(
    model: ModelApi,
    model_cfg: ModelConfig,
    tx: Optimizer,
    mesh: Mesh,
    mesh_cfg: MeshConfig,
    sharding: StateSharding,
    *,
    accum_dtype: str = "float32",
    guard: GuardConfig | None = None,
    seed: int = 42,
):
    """Returns (train_step, batch_put): ``train_step(state, batch) ->
    (state, metrics)`` over this rank's rows (``parallel/explicit``; ``tx``
    may clip: its clip moves into the step), and ``batch_put``, which
    places this rank's rows of a host global [A, B, T] batch on the mesh's
    device (``parallel/mesh.make_batch_put``; tensor ranks take the same
    rows, seq ranks the same rows, each its span of T, and expert ranks
    rows of their own, as data ranks do)."""
    step = make_explicit_train_step(
        model, model_cfg, make_optimizer(tx.cfg, with_clip=False), mesh,
        mesh_cfg, sharding, grad_clip_norm=tx.clip, accum_dtype=accum_dtype,
        seed=seed, guard=guard)
    return step, make_batch_put(mesh)
