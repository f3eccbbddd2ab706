"""Fully-sharded data-parallel training: the port's twin of the JAX
package's ``scripts/train_fsdp.py``, with its flags and its
``--strategy``:

  FULL_SHARD      params, grads and optimizer state sharded (ZeRO-3)
  SHARD_GRAD_OP   grads and optimizer state sharded, params replicated
                  (ZeRO-2)
  SHARD_OPT       optimizer state sharded (ZeRO-1)
  NO_SHARD        the DDP comparison arm

    python -m torch.distributed.run --nproc-per-node N \\
        -m pytorch_distributed_tpu_torch.train.fsdp --strategy FULL_SHARD
    python -m pytorch_distributed_tpu_torch.train.fsdp --cpu-devices 4 \\
        --preset tiny --seq-len 64 --strategy FULL_SHARD \\
        --global-batch-size 16 --micro-batch-size 1 --steps 8

An fsdp mesh of every rank (``parallel/sharding``, ``parallel/explicit``);
ZeRO-3 gathers each block's params at that block and reduce-scatters its
gradients. The launch flags are ``train/ddp``'s. Traces:
``outputs/traces/fsdp_<strategy>/rank<r>``.
"""

from __future__ import annotations

from pytorch_distributed_tpu_torch.train.ddp import (
    _REFUSED,
    check_args,
    parser,
    run,
)

STRATEGY_MAP = {
    "FULL_SHARD": "full_shard",
    "SHARD_GRAD_OP": "shard_grad_op",
    "SHARD_OPT": "shard_opt",
    "NO_SHARD": "no_shard",
    "full_shard": "full_shard",
    "shard_grad_op": "shard_grad_op",
    "shard_opt": "shard_opt",
    "no_shard": "no_shard",
}


def main(argv=None) -> int:
    from pytorch_distributed_tpu_torch.config import MeshConfig

    p = parser(__doc__)
    p.add_argument("--strategy", default="FULL_SHARD",
                   choices=sorted(STRATEGY_MAP),
                   help="FSDP sharding strategy (reference "
                        "train_fsdp.py:88-92)")
    args = check_args(p.parse_args(argv), _REFUSED)
    strategy = STRATEGY_MAP[args.strategy]
    return run(args, argv, "pytorch_distributed_tpu_torch.train.fsdp",
               lambda world: MeshConfig(fsdp=world, strategy=strategy),
               f"outputs/traces/fsdp_{strategy}", "pdtpu.fsdp",
               lambda m: f"FSDP {m.strategy}")


if __name__ == "__main__":
    from pytorch_distributed_tpu_torch.parallel.mesh import bind_to_parent

    bind_to_parent()  # a rank or mode started by the port's launcher
    raise SystemExit(main())
