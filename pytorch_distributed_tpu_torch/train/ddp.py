"""Data-parallel (DDP) training: the port's twin of the JAX package's
``scripts/train_ddp.py``, with its flags, one process per rank:

    python -m torch.distributed.run --nproc-per-node N \\
        -m pytorch_distributed_tpu_torch.train.ddp          # N cards, NCCL
    python -m pytorch_distributed_tpu_torch.train.ddp --cpu-devices 4 \\
        --preset tiny --seq-len 64 --global-batch-size 16 \\
        --micro-batch-size 1 --steps 8                      # 4 CPU ranks

Replicated params, the batch split over a data mesh of every rank, one
gradient all-reduce per optimizer step at the accumulation boundary
(``train/distributed_trainer``). Each rank reads its slice of the token
stream (``DistributedTokenShardLoader``, its rank and world size from the
process group). ``--path`` is "auto" or "explicit" (the same step here,
``parallel/api``). ``--cpu-devices N`` is "use N gloo CPU ranks": under a
launcher N must be its world size, and without one the twin starts the N
ranks itself. On the cards each rank takes ``cuda:LOCAL_RANK`` and NCCL
(which refuses two ranks on one card). Per-rank traces go to
``outputs/traces/ddp/rank<r>``.
"""

from __future__ import annotations

import argparse
import os
import sys

import torch

from pytorch_distributed_tpu_torch.train.baseline import (
    add_common_args,
    build_model_cfg,
    build_train_cfg,
    check_args,
    make_profiler,
    shard_paths,
)

_REFUSED = {
    "debug_nans": "--debug-nans: jax_debug_nans has no counterpart here; "
                  "torch.autograd.set_detect_anomaly is the tool",
}


def parser(doc: str, *,
           preset: str = "gpt2-large") -> argparse.ArgumentParser:
    """The JAX scripts' flags and ``--path``."""
    p = argparse.ArgumentParser(description=doc.split("\n\n")[0])
    add_common_args(p, preset=preset)
    p.add_argument("--path", default="auto", choices=["auto", "explicit"])
    return p


def run(args, argv, module: str, mesh_cfg_for, trace_dir: str,
        log_name: str, describe) -> int:
    """The body both twins share: join the group, build the mesh
    (``mesh_cfg_for(world)``), the loader and the DistributedTrainer, and
    train (``argv``: the flags, for the ranks ``--cpu-devices`` starts)."""
    import torch.distributed as dist

    from pytorch_distributed_tpu_torch.data import (
        DistributedTokenShardLoader,
    )
    from pytorch_distributed_tpu_torch.models import get_model
    from pytorch_distributed_tpu_torch.parallel.mesh import (
        initialize_distributed,
        make_mesh,
        spawn_ranks,
    )
    from pytorch_distributed_tpu_torch.train.distributed_trainer import (
        DistributedTrainer,
    )
    from pytorch_distributed_tpu_torch.utils.logging import get_logger

    cpu = bool(args.cpu_devices)
    if cpu and "RANK" not in os.environ and args.cpu_devices > 1:
        return spawn_ranks(args.cpu_devices, module,
                            sys.argv[1:] if argv is None else argv)
    local = int(os.environ.get("LOCAL_RANK", "0"))
    device = torch.device("cpu") if cpu else torch.device("cuda", local)
    initialize_distributed(device=device)
    try:
        world = dist.get_world_size()
        if args.cpu_devices and world != args.cpu_devices:
            raise SystemExit(f"--cpu-devices {args.cpu_devices} under a "
                             f"launcher of {world} ranks")
        if cpu:  # ranks sharing the host's cores: no oversubscription
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
        mesh_cfg = mesh_cfg_for(world)
        mesh = make_mesh(mesh_cfg, device=device)
        log = get_logger(log_name)
        model_cfg = build_model_cfg(args)
        train_cfg = build_train_cfg(args, data_parallel_size=world)
        if dist.get_rank() == 0:  # one writer for the shared shards
            shard_paths(args, model_cfg.vocab_size)
        dist.barrier()
        paths = shard_paths(args, model_cfg.vocab_size)
        loader = DistributedTokenShardLoader(paths, args.micro_batch_size,
                                             args.seq_len)
        if dist.get_rank() == 0:
            log.info(f"{describe(mesh_cfg)} over {world} ranks "
                     f"({mesh.backend}, {device.type}), accum="
                     f"{train_cfg.grad_accum_steps(world)}, "
                     f"path={args.path}")
        trainer = DistributedTrainer(get_model(model_cfg), model_cfg,
                                     train_cfg, mesh, mesh_cfg,
                                     path=args.path)
        state = trainer.init_state()
        if args.resume:
            state = trainer.resume_latest(state, loader=loader)
        profiler = make_profiler(args, trace_dir, device=device)
        try:
            state, history = trainer.train(loader, state=state,
                                           profiler=profiler)
        finally:
            if profiler is not None:
                profiler.close()
        if dist.get_rank() == 0:
            log.info(f"done: {history[-1] if history else {}}")
    finally:
        dist.destroy_process_group()
    return 0


def main(argv=None) -> int:
    from pytorch_distributed_tpu_torch.config import MeshConfig

    args = check_args(parser(__doc__).parse_args(argv), _REFUSED)
    return run(args, argv, "pytorch_distributed_tpu_torch.train.ddp",
               lambda world: MeshConfig(data=world, strategy="no_shard"),
               "outputs/traces/ddp", "pdtpu.ddp", lambda m: "DDP")


if __name__ == "__main__":
    raise SystemExit(main())
