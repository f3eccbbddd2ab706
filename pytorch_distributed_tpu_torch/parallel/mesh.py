"""Process groups and process identity: the port of the JAX package's
``parallel/mesh.py``.

JAX's mesh is a grid of devices inside one program; here each device is a
rank (a process), and ``make_mesh`` lays the ranks out on the same grid:
mesh rank r sits at the row-major coordinates of ``cfg.axis_order`` (with
the default order and only data and fsdp > 1, r = d * fsdp + f, JAX's
device order), and every axis of size > 1 gets the process groups of the
ranks that differ only along it. Collectives are explicit calls on those
groups (``parallel/zero``).

- ``spawn_ranks``: the twins' ``--cpu-devices N``, N ranks of a module
  started on this host as a launcher would.
- ``initialize_distributed()``: the env:// rendezvous torchrun sets up
  (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``); without
  them a world of one on a free localhost port. Backend ``nccl`` for a
  CUDA rank and ``gloo`` for a CPU rank, unless the caller names one
  (gloo on CUDA tensors stages them through the host: the way two ranks
  share one card, which NCCL refuses). Every group gets ``timeout``.
- ``process_info()``, ``data_parallel_size``, ``batch_partition_spec``
  (JAX's spec as a tuple) and ``batch_rows`` (the rows of the global
  [A, B, T] batch a rank owns: B split over data x fsdp, data major).
- ``fold_batch_shard_key``: the JAX package folds the batch shard's index
  into the dropout key; the port's ``DropoutKey`` takes ``shard`` = 1 +
  the index (0 stays "not folded"). JAX's threefry streams cannot be
  matched, so this is held to the port itself: each shard's masks differ,
  and a world of one keeps the single-device masks.
"""

from __future__ import annotations

import dataclasses
import os
import socket
import subprocess
import sys
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

from pytorch_distributed_tpu_torch.config import MeshConfig
from pytorch_distributed_tpu_torch.utils.prng import DropoutKey

DEFAULT_TIMEOUT_S = 600.0
# The axes a batch is split over, in the order of JAX's batch spec.
BATCH_AXES = ("data", "fsdp", "expert")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn_ranks(n: int, module: str, argv: list[str]) -> int:
    """Start ``n`` ranks of ``python -m module argv`` on this host, as a
    launcher would (``RANK``, ``LOCAL_RANK``, ``WORLD_SIZE`` and a free
    127.0.0.1 port); wait for all. The highest exit code wins."""
    port = _free_port()
    procs = []
    for r in range(n):
        env = dict(os.environ, RANK=str(r), LOCAL_RANK=str(r),
                   WORLD_SIZE=str(n), MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port))
        procs.append(subprocess.Popen([sys.executable, "-m", module, *argv],
                                      env=env))
    return max(p.wait() for p in procs)


def initialize_distributed(*, device: str | torch.device | None = None,
                           backend: str | None = None,
                           timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
    """Join the process group (idempotent). ``device``: where this rank
    computes (None: the card), which picks the default backend."""
    if dist.is_initialized():
        return
    dev = torch.device("cuda" if device is None else device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    env = os.environ
    if "RANK" in env and "WORLD_SIZE" in env:
        rank, world = int(env["RANK"]), int(env["WORLD_SIZE"])
        init = "env://"
    else:  # one process, no launcher: a world of one
        rank, world = 0, 1
        init = f"tcp://127.0.0.1:{_free_port()}"
    kw = {}
    if backend == "nccl":
        local = int(env.get("LOCAL_RANK", "0"))
        kw["device_id"] = torch.device("cuda", local if dev.index is None
                                       else dev.index)
    dist.init_process_group(backend, init_method=init, rank=rank,
                            world_size=world,
                            timeout=timedelta(seconds=timeout_s), **kw)


def process_info() -> dict:
    """The JAX package's keys: each rank is a process driving one device."""
    init = dist.is_initialized()
    world = dist.get_world_size() if init else 1
    return {
        "process_index": dist.get_rank() if init else 0,
        "process_count": world,
        "local_device_count": 1,
        "global_device_count": world,
    }


@dataclasses.dataclass
class Mesh:
    """This rank's place on the mesh: ``coords`` (axis -> index), the
    mesh's process group and, per axis of size > 1, the group of ranks
    that differ only along that axis (``groups``). ``device``: where the
    rank computes. ``backend``: the groups' backend."""

    cfg: MeshConfig
    rank: int
    coords: dict
    group: object
    groups: dict
    device: torch.device
    backend: str

    @property
    def size(self) -> int:
        return self.cfg.num_devices

    def axis_size(self, axis: str) -> int:
        return getattr(self.cfg, axis)

    def axis_index(self, axis: str) -> int:
        return self.coords[axis]

    def axis_group(self, axis: str):
        """The group along ``axis`` (the mesh's own group when it is the
        only axis of size > 1)."""
        return self.groups[axis]


def _default_device(cfg: MeshConfig, rank: int, backend: str):
    if cfg.device_ids is not None:
        return torch.device("cuda", cfg.device_ids[rank])
    if backend == "gloo" and not torch.cuda.is_available():
        raise RuntimeError(
            "the port runs on the GPU by default, but CUDA is not "
            "available here — pass device='cpu' to make_mesh")
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))


def make_mesh(cfg: MeshConfig, *, group=None,
              device: str | torch.device | None = None,
              timeout_s: float = DEFAULT_TIMEOUT_S) -> Mesh:
    """The mesh of ``cfg`` over ``group``'s ranks (default: the world,
    which ``initialize_distributed`` must have joined), in group-rank
    order; the group's size must be ``cfg.num_devices``. Every rank of the
    group calls this, in the same order as its other group creations."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call "
                           "initialize_distributed() first")
    group = group or dist.group.WORLD
    size = dist.get_world_size(group)
    if size != cfg.num_devices:
        raise ValueError(f"mesh needs {cfg.num_devices} ranks "
                         f"({cfg.shape}) but the group has {size}")
    rank = dist.get_rank(group)
    global_ranks = dist.get_process_group_ranks(group)
    shape = tuple(cfg.shape.values())
    grid = np.arange(size).reshape(shape)
    coords = dict(zip(cfg.axis_order,
                      (int(i) for i in np.unravel_index(rank, shape))))
    backend = dist.get_backend(group)
    live = [ax for ax in cfg.axis_order if getattr(cfg, ax) > 1]
    groups = {}
    for ax in live:
        if len(live) == 1:
            groups[ax] = group
            continue
        lines = np.moveaxis(grid, cfg.axis_order.index(ax), -1)
        for line in lines.reshape(-1, getattr(cfg, ax)):
            members = [global_ranks[int(i)] for i in line]
            if rank not in line:
                continue
            groups[ax] = dist.new_group(
                members, timeout=timedelta(seconds=timeout_s),
                backend=backend, use_local_synchronization=True)
    dev = (torch.device(device) if device is not None
           else _default_device(cfg, rank, backend))
    return Mesh(cfg=cfg, rank=rank, coords=coords, group=group,
                groups=groups, device=dev, backend=backend)


def data_parallel_size(cfg: MeshConfig) -> int:
    """How many ways the batch is split (the reference's world size in the
    accumulation rule)."""
    return cfg.data * cfg.fsdp * cfg.expert


def batch_partition_spec(cfg: MeshConfig) -> tuple:
    """JAX's ``P(None, batch_axes, seq_axis)`` as a tuple: the [A, B, T]
    batch's B split over the batch axes of size > 1, T over seq."""
    axes = tuple(ax for ax in BATCH_AXES if getattr(cfg, ax) > 1) or None
    if axes is not None and len(axes) == 1:
        axes = axes[0]  # JAX's PartitionSpec spells one axis bare
    return (None, axes, "seq" if cfg.seq > 1 else None)


def batch_shard_index(mesh: Mesh) -> int:
    """This rank's shard of the batch dim: the batch axes' coordinates,
    first axis major (JAX's tiling of a dim over several mesh axes)."""
    idx = 0
    for ax in BATCH_AXES:
        idx = idx * mesh.axis_size(ax) + mesh.coords.get(ax, 0)
    return idx


def batch_rows(mesh: Mesh, global_rows: int) -> slice:
    """The rows of a global batch dim of ``global_rows`` this rank owns."""
    n = data_parallel_size(mesh.cfg)
    if global_rows % n:
        raise ValueError(f"global batch of {global_rows} rows does not "
                         f"split over {n} batch shards")
    per = global_rows // n
    i = batch_shard_index(mesh)
    return slice(i * per, (i + 1) * per)


def make_batch_put(mesh: Mesh):
    """``put(batch)``: a host {inputs, targets} batch of GLOBAL [A, B, T]
    arrays -> this rank's rows as tensors on the mesh's device."""

    def put(batch: dict) -> dict:
        out = {}
        for k, v in batch.items():
            v = np.asarray(v)
            rows = batch_rows(mesh, v.shape[1])
            out[k] = torch.from_numpy(
                np.ascontiguousarray(v[:, rows])).to(mesh.device)
        return out

    return put


def fold_batch_shard_key(key: DropoutKey, mesh: Mesh) -> DropoutKey:
    """The key of this rank's batch shard (module docstring): unchanged
    when the batch is not split."""
    if data_parallel_size(mesh.cfg) == 1:
        return key
    return key._replace(shard=1 + batch_shard_index(mesh))
