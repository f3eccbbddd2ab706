"""Mesh-parallel training over the data, fsdp, seq and tensor axes: the
port's twin of the JAX package's ``scripts/train_parallel.py``, with its
flags, one process per rank:

    python -m torch.distributed.run --nproc-per-node 4 \\
        -m pytorch_distributed_tpu_torch.train.parallel \\
        --mesh data=2,tensor=2 --preset gpt2 --no-dropout     # 4 cards
    python -m pytorch_distributed_tpu_torch.train.parallel \\
        --cpu-devices 8 --mesh data=2,fsdp=2,tensor=2 --preset tiny \\
        --seq-len 64 --global-batch-size 16 --micro-batch-size 2 \\
        --steps 4 --no-dropout                               # 8 CPU ranks
    python -m pytorch_distributed_tpu_torch.train.parallel \
        --cpu-devices 4 --mesh data=2,seq=2 --seq-impl ulysses \
        --preset tiny --seq-len 64 --no-dropout              # 4 CPU ranks

``--mesh`` names each axis's size (its product is the number of ranks);
``--strategy`` is the ZeRO level over fsdp, and a tensor axis is
Megatron tensor parallelism composed with it, and a seq axis splits
each sequence over its ranks, attention crossing them by ``--seq-impl``
(ring or Ulysses; ``parallel/explicit``).
``--path`` is "auto" or "explicit" (the same hand-scheduled step here,
``parallel/api``). ``--cpu-devices N`` starts N gloo CPU ranks through the
port's launcher (``parallel/mesh.spawn_ranks``) unless a launcher already
started them; on cards each rank takes ``cuda:LOCAL_RANK`` and NCCL.

Refused, naming the ROADMAP queue 1 item that ports them: the pipe axis,
``--path pipeline`` and ``--pipe-schedule 1f1b`` (7(d)), the expert axis
(7(e)). Refused as the explicit step refuses them, before any rank
starts (the port's "auto" path is that step): attention dropout under a
tensor axis, or under a seq axis with the ring (``--no-dropout``, or a
preset without it), and Ulysses with a seq size that does not divide a
rank's head counts. Traces: ``outputs/traces/parallel/rank<r>``.
"""

from __future__ import annotations

import argparse
import math

from pytorch_distributed_tpu_torch.config import _AXIS_NOT_PORTED as _ITEM
from pytorch_distributed_tpu_torch.train.baseline import (
    add_common_args,
    build_model_cfg,
)
from pytorch_distributed_tpu_torch.train.ddp import _REFUSED, check_args, run

AXES = ("pipe", "data", "fsdp", "expert", "seq", "tensor")


def parse_mesh(spec: str) -> dict:
    """``"data=2,tensor=2"`` -> {"data": 2, "tensor": 2} (the JAX
    script's parser)."""
    out = {}
    for part in spec.split(","):
        if not part:
            continue
        name, _, val = part.partition("=")
        if name not in AXES:
            raise SystemExit(
                f"unknown mesh axis {name!r}; known: {', '.join(AXES)}")
        try:
            out[name] = int(val)
        except ValueError:
            raise SystemExit(f"bad mesh axis size {part!r}: expected "
                             f"{name}=<int>") from None
    return out


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_common_args(p, preset="tiny")
    p.add_argument("--mesh", default="data=8",
                   help="comma-separated axis=size (data, fsdp, seq, "
                        "tensor; pipe and expert are refused); the product "
                        "must equal the rank count")
    p.add_argument("--strategy", default="full_shard",
                   choices=["full_shard", "shard_grad_op", "shard_opt",
                            "no_shard"])
    p.add_argument("--path", default="auto",
                   choices=["auto", "explicit", "pipeline"])
    p.add_argument("--n-experts", type=int, default=0)
    p.add_argument("--seq-impl", default="ring", choices=["ring", "ulysses"])
    p.add_argument("--pipe-schedule", default="gpipe",
                   choices=["gpipe", "1f1b"])
    p.add_argument("--no-dropout", action="store_true",
                   help="zero all dropout")
    return p


def refusals(args, axes: dict) -> str | None:
    """Why this run is refused (None: it is not)."""
    for axis, item in _ITEM.items():
        if axes.get(axis, 1) > 1:
            return f"mesh axis {axis}={axes[axis]} is not ported: {item}"
    if args.path == "pipeline":
        return f"--path pipeline is not ported: {_ITEM['pipe']}"
    if args.pipe_schedule != "gpipe":
        return (f"--pipe-schedule {args.pipe_schedule} is the pipeline's: "
                f"{_ITEM['pipe']}")
    return None


def model_cfg_from(args):
    """The preset's config with ``--n-experts``, ``--seq-impl`` and
    ``--no-dropout``."""
    cfg = build_model_cfg(args).replace(seq_impl=args.seq_impl)
    if args.n_experts:
        cfg = cfg.replace(n_experts=args.n_experts)
    if args.no_dropout:
        cfg = cfg.replace(embd_pdrop=0.0, attn_pdrop=0.0, resid_pdrop=0.0)
    return cfg


def main(argv=None) -> int:
    from pytorch_distributed_tpu_torch.config import MeshConfig
    from pytorch_distributed_tpu_torch.parallel.explicit import (
        check_seq,
        check_tensor_dropout,
    )

    args = check_args(parser().parse_args(argv), _REFUSED)
    axes = parse_mesh(args.mesh)
    why = refusals(args, axes)
    if why:
        raise SystemExit(why)
    mesh_cfg = MeshConfig(**axes, strategy=args.strategy)
    try:  # before any rank starts
        check_tensor_dropout(model_cfg_from(args), mesh_cfg)
        check_seq(model_cfg_from(args), mesh_cfg)
    except NotImplementedError as err:
        raise SystemExit(f"{err}; or pass --no-dropout") from None
    except ValueError as err:
        raise SystemExit(str(err)) from None

    def mesh_cfg_for(world: int):
        if math.prod(axes.values()) != world:
            raise SystemExit(f"mesh {axes} covers "
                             f"{math.prod(axes.values())} ranks, but the "
                             f"group has {world}")
        return mesh_cfg

    return run(args, argv, "pytorch_distributed_tpu_torch.train.parallel",
               mesh_cfg_for, "outputs/traces/parallel", "pdtpu.parallel",
               lambda m: f"mesh={dict(m.shape)} strategy={m.strategy}",
               model_cfg_for=model_cfg_from)


if __name__ == "__main__":
    from pytorch_distributed_tpu_torch.parallel.mesh import bind_to_parent

    bind_to_parent()  # a rank started by the port's launcher
    raise SystemExit(main())
