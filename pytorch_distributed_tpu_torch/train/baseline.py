"""Single-device training baseline: the port's twin of the JAX package's
``scripts/train_baseline.py`` (with the parts of ``scripts/_common.py`` it
uses), run as a module:

    python -m pytorch_distributed_tpu_torch.train.baseline          # the card
    python -m pytorch_distributed_tpu_torch.train.baseline --device cpu \\
        --preset tiny --seq-len 64 --global-batch-size 8 \\
        --micro-batch-size 4 --steps 8 --eval-batches 1

The same defaults: GPT-2 Large, global batch 32, micro-batch 8, T 1024, 20
steps, AdamW lr 3e-4 wd 0.1 with a cosine anneal to 0.1 lr, flash
attention and ``names`` remat, dropout from the preset (``--preset
llama3-1b`` trains the dropout-free Llama-3.2-1B shape); synthetic shards
unless ``--data local`` names a directory of ``*.bin`` shards. Training
runs on ``--device`` (default cuda) under the ``ScheduledProfiler``
(``profiling/profiler``) with the reference schedule, wait 2, warmup 2,
active 6, repeat 1, writing a Kineto trace to ``--trace-dir`` (default
``outputs/traces/baseline``) under ``rank0/``; ``--no-profiler`` turns it
off. ``--anomaly-guard`` turns on the anomaly guard (``train/guard``;
``--guard-rollback-after N``, 0 for skip-only, ``--guard-skip-window``)
and ``--async-checkpoint`` the async npz save (``train/checkpoint``).
Flags for what the port does not have exit with the reason: ``--data
fineweb`` (it downloads), ``--cpu-devices`` and ``--debug-nans``.
"""

from __future__ import annotations

import argparse
import glob
import os

from pytorch_distributed_tpu_torch.config import (
    ModelConfig,
    TrainConfig,
    model_config,
)
from pytorch_distributed_tpu_torch.data import (
    TokenShardLoader,
    make_synthetic_shards,
)
from pytorch_distributed_tpu_torch.models import get_model
from pytorch_distributed_tpu_torch.train.trainer import Trainer
from pytorch_distributed_tpu_torch.utils.logging import get_logger

# Flags of the JAX script the port refuses, with the reason.
_REFUSED = {
    "cpu_devices": "--cpu-devices: the port has no virtual-device mesh; "
                   "use --device cpu",
    "debug_nans": "--debug-nans: jax_debug_nans has no counterpart here; "
                  "torch.autograd.set_detect_anomaly is the tool",
}
DEFAULT_TRACE_DIR = "outputs/traces/baseline"


def add_model_args(p: argparse.ArgumentParser, *, preset: str) -> None:
    """The model flags the entry points share (``build_model_cfg``)."""
    p.add_argument("--preset", default=preset,
                   help="model preset (gpt2, gpt2-large, gpt2-1p3b, "
                        "llama3-1b, ... or 'tiny')")
    p.add_argument("--seq-len", type=int, default=1024)
    p.add_argument("--dtype", default=None,
                   help="activation dtype override (bfloat16/float32)")
    p.add_argument("--param-dtype", default=None,
                   help="parameter/optimizer-state dtype override")
    p.add_argument("--attention-impl", default="flash",
                   choices=["flash", "naive"])
    p.add_argument("--remat", default="names",
                   choices=["none", "full", "dots", "dots_no_batch",
                            "names", "flash"])


def add_common_args(p: argparse.ArgumentParser, *, preset: str) -> None:
    """The flags of the JAX package's ``scripts/_common.add_common_args``
    (the baseline and the ddp/fsdp twins share them)."""
    add_model_args(p, preset=preset)
    p.add_argument("--data", default="synthetic",
                   choices=["synthetic", "fineweb", "local"],
                   help="synthetic (generated shards), local (every *.bin "
                        "in --data-dir), or fineweb (refused: it downloads)")
    p.add_argument("--data-dir", default=".cache/data")
    p.add_argument("--num-train-files", type=int, default=10)
    p.add_argument("--global-batch-size", type=int, default=32)
    p.add_argument("--micro-batch-size", type=int, default=8)
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--weight-decay", type=float, default=0.1)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--save-every", type=int, default=None)
    p.add_argument("--checkpoint-dir", default="checkpoints")
    p.add_argument("--keep-checkpoints", type=int, default=None,
                   help="retain only the newest N checkpoints")
    p.add_argument("--accum-dtype", default="float32",
                   choices=["float32", "bfloat16"],
                   help="gradient-accumulation buffer dtype (A > 1)")
    p.add_argument("--metrics-out", default=None,
                   help="append logged metrics as JSON lines to this file")
    p.add_argument("--save-on-preemption", action="store_true",
                   help="on SIGTERM/SIGINT, finish the step in flight, "
                        "write a resumable checkpoint and exit")
    p.add_argument("--resume", action="store_true",
                   help="resume from the newest good checkpoint")
    p.add_argument("--async-checkpoint", action="store_true",
                   help="overlap checkpoint writes with training (the npz "
                        "save copied to host memory, written by a thread, "
                        "committed at the next save or the end of the run)")
    p.add_argument("--anomaly-guard", action="store_true",
                   help="the anomaly guard: non-finite loss or gradient, "
                        "loss spikes and corrupt token ids detected on the "
                        "card inside the step, anomalous updates skipped "
                        "with no host sync, and a rollback to the last "
                        "good checkpoint after --guard-rollback-after "
                        "consecutive anomalies")
    p.add_argument("--guard-rollback-after", type=int, default=3,
                   help="consecutive anomalies before a rollback (0: skip "
                        "only, never roll back)")
    p.add_argument("--guard-skip-window", action="store_true",
                   help="on a rollback, drop the offending data window "
                        "instead of replaying it (persistent corruption)")
    p.add_argument("--cpu-devices", type=int, default=0)
    p.add_argument("--debug-nans", action="store_true")
    p.add_argument("--trace-dir", default=None,
                   help=f"where the profiler writes (default "
                        f"{DEFAULT_TRACE_DIR})")
    p.add_argument("--no-profiler", action="store_true",
                   help="train without the profiler")


def check_args(args, refused: dict) -> argparse.Namespace:
    """Exit with the reason for a flag the port refuses (``refused``:
    {attribute: reason}) and for ``--data fineweb``."""
    for flag, reason in refused.items():
        if getattr(args, flag):
            raise SystemExit(reason)
    if args.data == "fineweb":
        raise SystemExit(
            "--data fineweb downloads its shards, and the port reads local "
            "and synthetic shards only: use --data local --data-dir DIR")
    return args


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_common_args(p, preset="gpt2-large")
    p.add_argument("--eval-batches", type=int, default=0,
                   help="after training, report the mean validation loss "
                        "over this many batches; 0 = off")
    p.add_argument("--device", default="cuda",
                   help="where to train: cuda (default) or cpu")
    return check_args(p.parse_args(argv), _REFUSED)


def build_model_cfg(args) -> ModelConfig:
    cfg = model_config(args.preset)
    if args.preset == "tiny":
        cfg = cfg.replace(n_ctx=max(args.seq_len, 32))
    if args.dtype:
        cfg = cfg.replace(dtype=args.dtype)
    if args.param_dtype:
        cfg = cfg.replace(param_dtype=args.param_dtype)
    cfg = cfg.replace(attention_impl=args.attention_impl, remat=args.remat)
    if args.seq_len > cfg.n_ctx:
        raise SystemExit(
            f"--seq-len {args.seq_len} exceeds model n_ctx {cfg.n_ctx}")
    return cfg


def build_train_cfg(args, *, data_parallel_size: int = 1) -> TrainConfig:
    cfg = TrainConfig(
        global_batch_size=args.global_batch_size,
        micro_batch_size=args.micro_batch_size,
        num_steps=args.steps,
        learning_rate=args.lr,
        weight_decay=args.weight_decay,
        seed=args.seed,
        log_every_n_steps=args.log_every,
        save_every_n_steps=args.save_every,
        checkpoint_dir=args.checkpoint_dir,
        keep_checkpoints=args.keep_checkpoints,
        accum_dtype=args.accum_dtype,
        async_checkpoint=args.async_checkpoint,
        metrics_path=args.metrics_out,
        save_on_preemption=args.save_on_preemption,
        anomaly_guard=args.anomaly_guard,
        guard_rollback_after=(args.guard_rollback_after
                              if args.guard_rollback_after > 0 else None),
        guard_skip_window=args.guard_skip_window,
    )
    cfg.grad_accum_steps(data_parallel_size)  # validate divisibility early
    return cfg


def _local_shards(args) -> list[str]:
    paths = sorted(glob.glob(os.path.join(args.data_dir, "*.bin")))
    if not paths:
        raise SystemExit(f"--data local: no *.bin shards in "
                         f"{args.data_dir!r}")
    return paths


def _holds_out_val_shard(args, paths) -> bool:
    """Whether ``shard_paths`` keeps the last local shard for validation:
    only when the run evaluates and there is more than one shard."""
    return len(paths) > 1 and args.eval_batches > 0


def shard_paths(args, vocab_size: int) -> list[str]:
    if args.data == "local":
        paths = _local_shards(args)
        if _holds_out_val_shard(args, paths):
            print(f"--data local: holding out {paths[-1]!r} as the "
                  f"validation shard (training on {len(paths) - 1} "
                  f"shard(s))")
            return paths[:-1]
        return paths
    return make_synthetic_shards(
        os.path.join(args.data_dir, "synthetic"),
        num_shards=max(2, args.num_train_files),
        tokens_per_shard=2_000_000,
        vocab_size=min(vocab_size, 2**16),
        seed=args.seed,
    )


def val_shard_paths(args, vocab_size: int) -> list[str]:
    """The last local shard (held out of training when the run evaluates),
    or a synthetic shard from a disjoint seed."""
    if args.data == "local":
        paths = _local_shards(args)
        if len(paths) == 1:
            print("WARNING: --data local has a single shard; validation "
                  "overlaps training data, so val loss is optimistic")
        elif not _holds_out_val_shard(args, paths):
            print(f"WARNING: --data local: validation shard {paths[-1]!r} "
                  "was NOT held out of training, so val loss is optimistic")
        return [paths[-1]]
    return make_synthetic_shards(
        os.path.join(args.data_dir, "synthetic_val"),
        num_shards=1,
        tokens_per_shard=500_000,
        vocab_size=min(vocab_size, 2**16),
        seed=args.seed + 10_000,
    )


def make_profiler(args, default_trace_dir: str = DEFAULT_TRACE_DIR,
                  device=None):
    """The reference schedule (train_baseline.py:83-86): wait 2, warmup 2,
    active 6, repeat 1; None under ``--no-profiler``."""
    if args.no_profiler:
        return None
    from pytorch_distributed_tpu_torch.profiling.profiler import (
        ScheduledProfiler,
    )

    return ScheduledProfiler(args.trace_dir or default_trace_dir, wait=2,
                             warmup=2, active=6, repeat=1,
                             device=device or args.device)


def main(argv=None) -> int:
    args = parse_args(argv)
    log = get_logger("pdtpu.baseline")
    model_cfg = build_model_cfg(args)
    train_cfg = build_train_cfg(args)
    paths = shard_paths(args, model_cfg.vocab_size)
    loader = TokenShardLoader(paths, args.micro_batch_size, args.seq_len)
    log.info(f"model={args.preset} data={args.data} shards={len(paths)} "
             f"accum={train_cfg.grad_accum_steps()} device={args.device}")
    trainer = Trainer(get_model(model_cfg), model_cfg, train_cfg,
                      device=args.device)
    state = trainer.init_state()
    if args.resume:
        state = trainer.resume_latest(state, loader=loader)
    profiler = make_profiler(args)
    try:
        state, history = trainer.train(loader, state=state,
                                       profiler=profiler)
    finally:
        if profiler is not None:
            profiler.close()
    final = history[-1] if history else {}
    if args.eval_batches > 0:
        val_loader = TokenShardLoader(
            val_shard_paths(args, model_cfg.vocab_size),
            args.micro_batch_size, args.seq_len)
        val_loss = trainer.evaluate(state, val_loader,
                                    max_batches=args.eval_batches)
        final = {**final, "val_loss": val_loss}
        log.info(f"val loss ({args.eval_batches} batches): {val_loss:.4f}")
    log.info(f"done: {final}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
