"""Memory analysis: the analytic breakdown against measured device memory.

The port's twin of the JAX package's ``scripts/memory_analysis.py``
(reference assignment0/memory_analysis.py): the analytic params / grads /
Adam breakdown, a few training steps, the allocator's live and peak bytes,
and an allocator-history snapshot for pytorch.org/memory_viz (recording
starts before the model is built). Defaults: GPT-2 small, B 8, T 1024.

    python -m pytorch_distributed_tpu_torch.profiling.memory_analysis
    python -m pytorch_distributed_tpu_torch.profiling.memory_analysis \\
        --device cpu --preset tiny --seq-len 64 --micro-batch-size 4

The JAX script's compiled-program section (XLA's buffer assignment) has
no eager-PyTorch counterpart; the twin says so in one line.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from pytorch_distributed_tpu_torch.config import TrainConfig
from pytorch_distributed_tpu_torch.profiling.memory import (
    analytic_memory_breakdown,
    measured_memory,
    save_memory_snapshot,
    start_memory_history,
    stop_memory_history,
)
from pytorch_distributed_tpu_torch.train.baseline import (
    add_model_args,
    build_model_cfg,
)


def _fmt(n: int) -> str:
    return f"{n / 2**30:.3f} GiB" if n >= 2**28 else f"{n / 2**20:.1f} MiB"


def main(argv=None) -> int:
    from pytorch_distributed_tpu_torch.models import get_model
    from pytorch_distributed_tpu_torch.train.optim import make_optimizer
    from pytorch_distributed_tpu_torch.train.state import init_train_state
    from pytorch_distributed_tpu_torch.train.trainer import make_train_step

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_model_args(p, preset="gpt2")
    p.add_argument("--micro-batch-size", type=int, default=8)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--profile-steps", type=int, default=3)
    p.add_argument("--snapshot",
                   default="outputs/task1_memory_snapshot.pickle")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    model_cfg = build_model_cfg(args)
    b, t = args.micro_batch_size, args.seq_len
    dev = torch.device(args.device)

    est = analytic_memory_breakdown(model_cfg, batch_size=b, seq_len=t)
    print("=== analytic breakdown (reference memory_analysis.py:12-52) ===")
    print(f"params:      {est['param_count']:,}  ({_fmt(est['params_bytes'])})")
    print(f"gradients:   {_fmt(est['grads_bytes'])}")
    print(f"adam states: {_fmt(est['optimizer_bytes'])}")
    print(f"activations: {_fmt(est['activations_bytes_estimate'])} "
          f"(remat={model_cfg.remat})")
    print(f"TOTAL est:   {_fmt(est['total_bytes_estimate'])}")
    print("\n(compiled-program accounting: XLA's buffer assignment has no "
          "eager-PyTorch counterpart -- left out)")

    recording = start_memory_history()
    print(f"\n=== profiling {args.profile_steps} training steps ===")
    model = get_model(model_cfg)
    tx = make_optimizer(TrainConfig(global_batch_size=b, micro_batch_size=b,
                                    num_steps=args.profile_steps))
    state = init_train_state(
        model.init(torch.Generator().manual_seed(args.seed), model_cfg,
                   device=dev), tx)
    step = make_train_step(model, model_cfg, tx, seed=args.seed)
    rng = np.random.default_rng(args.seed)
    batch = {key: torch.as_tensor(
        rng.integers(0, model_cfg.vocab_size, (1, b, t)), dtype=torch.long,
        device=dev) for key in ("inputs", "targets")}
    for i in range(args.profile_steps):
        state, metrics = step(state, batch)
        print(f"step {i}: loss {float(metrics['loss']):.4f}")

    meas = measured_memory(dev)
    print("\n=== measured (torch.cuda memory stats) ===")
    print(f"bytes_in_use:      {_fmt(meas['bytes_in_use'])}")
    print(f"peak_bytes_in_use: {_fmt(meas['peak_bytes_in_use'])}")
    if meas["peak_bytes_in_use"]:
        ratio = meas["peak_bytes_in_use"] / est["total_bytes_estimate"]
        print(f"measured/estimated: {ratio:.2f}x")
    else:
        print("(no CUDA device: no memory stats -- the analytic estimate "
              "above is the budget)")

    snap = save_memory_snapshot(args.snapshot) if recording else None
    stop_memory_history()
    if snap is None:
        print("\n(memory snapshot needs a CUDA device -- skipped)")
    else:
        print(f"\nmemory snapshot written to {snap} (pytorch.org/memory_viz)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
