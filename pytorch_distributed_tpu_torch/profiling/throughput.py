"""Throughput measurement, batch sweeps and scaling extrapolation.

The port of the JAX package's ``profiling/throughput.py`` (reference
assignment0/throughput.py), with its defaults and keys:

- ``measure_tokens_per_second`` — the port's train step on random tokens:
  5 warmup steps, then 20 timed between two ``torch.cuda.synchronize()``
  fences. The data and weights come from a fresh seed per call unless one
  is given (``_fresh_seed``, kept from the JAX package).
- ``extrapolate_modern_training`` — the reference's 1T-param / 10T-token
  estimate under linear FLOPs scaling.
- ``compare_batch_sizes`` — throughput and peak memory per batch size.
  A point that runs out of device memory (``torch.cuda.OutOfMemoryError``,
  nothing else) is recorded as ``oom``; its tensors are dropped and the
  allocator's cache emptied, so the next point runs. Peak stats are reset
  before each point, so each reports its own peak (the JAX package's peak
  is the process's).

Run as a module for the twin of the JAX package's ``scripts/throughput.py``:

    python -m pytorch_distributed_tpu_torch.profiling.throughput
    python -m pytorch_distributed_tpu_torch.profiling.throughput \\
        --device cpu --preset tiny --seq-len 64 --micro-batch-size 4 \\
        --steps 5 --warmup-steps 1 --sweep 1,2
"""

from __future__ import annotations

import argparse
import gc
import os
import time

import numpy as np
import torch

from pytorch_distributed_tpu_torch.config import ModelConfig, TrainConfig
from pytorch_distributed_tpu_torch.profiling.memory import measured_memory
from pytorch_distributed_tpu_torch.utils.device import resolve_device


def _fresh_seed() -> int:
    return int.from_bytes(os.urandom(4), "little")


def _fence(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def measure_tokens_per_second(
    cfg: ModelConfig,
    *,
    batch_size: int = 8,
    seq_len: int = 1024,
    num_steps: int = 20,
    warmup_steps: int = 5,
    seed: int | None = None,
    device=None,
) -> dict:
    """Train-step throughput on dummy data (reference :13-83 defaults:
    B=8, T=1024, 5 warmup + 20 timed). ``device``: None is the GPU."""
    from pytorch_distributed_tpu_torch.models import get_model
    from pytorch_distributed_tpu_torch.train.optim import make_optimizer
    from pytorch_distributed_tpu_torch.train.state import init_train_state
    from pytorch_distributed_tpu_torch.train.trainer import make_train_step
    from pytorch_distributed_tpu_torch.utils import tree

    device = resolve_device(device)
    seed = _fresh_seed() if seed is None else seed
    model = get_model(cfg)
    tcfg = TrainConfig(
        global_batch_size=batch_size,
        micro_batch_size=batch_size,
        num_steps=num_steps,
        learning_rate=3e-4,
    )
    tx = make_optimizer(tcfg)
    params = model.init(torch.Generator().manual_seed(seed), cfg,
                        device=device)
    n_params = int(sum(p.numel() for p in tree.leaves(params)))
    state = init_train_state(params, tx)
    step = make_train_step(model, cfg, tx, seed=seed)

    rng = np.random.default_rng(seed)
    batch = {
        key: torch.as_tensor(
            rng.integers(0, cfg.vocab_size, (1, batch_size, seq_len)),
            dtype=torch.long, device=device)
        for key in ("inputs", "targets")
    }

    for _ in range(warmup_steps):
        state, metrics = step(state, batch)
        float(metrics["loss"])  # fence

    _fence(device)
    t0 = time.perf_counter()
    for _ in range(num_steps):
        state, metrics = step(state, batch)
    _fence(device)
    elapsed = time.perf_counter() - t0

    tokens_per_batch = batch_size * seq_len  # reference TODO :41-42
    total_tokens = num_steps * tokens_per_batch
    return {
        "tokens_per_second": total_tokens / elapsed,
        "steps_per_second": num_steps / elapsed,
        "seconds_per_step": elapsed / num_steps,
        "elapsed_seconds": elapsed,
        "num_steps": num_steps,
        "batch_size": batch_size,
        "seq_len": seq_len,
        "param_count": n_params,
    }


def extrapolate_modern_training(
    measured: dict,
    *,
    target_params: float = 1e12,
    target_tokens: float = 10e12,
) -> dict:
    """Scale measured throughput to a hypothetical giant run under the
    linear-FLOPs assumption (time/token scales with param count —
    reference :86-129's 1T-param / 10T-token estimate)."""
    tps = measured["tokens_per_second"]
    n = measured["param_count"]
    scale = target_params / n
    scaled_tps = tps / scale
    seconds = target_tokens / scaled_tps
    return {
        "measured_params": n,
        "measured_tokens_per_second": tps,
        "target_params": target_params,
        "target_tokens": target_tokens,
        "scaled_tokens_per_second": scaled_tps,
        "seconds": seconds,
        "days": seconds / 86400,
        "years": seconds / (86400 * 365),
        "assumption": "linear FLOPs scaling, identical hardware+efficiency",
    }


def _release(device: torch.device) -> None:
    """Free what a finished (or failed) point left: its tensors are
    garbage once its frames are gone, and the allocator's cache goes back
    to the device."""
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def compare_batch_sizes(
    cfg: ModelConfig,
    *,
    batch_sizes=(1, 4, 8, 16, 32, 64),
    seq_len: int = 1024,
    num_steps: int = 10,
    warmup_steps: int = 2,
    device=None,
) -> list[dict]:
    """Throughput + peak memory per batch size, OOM-tolerant
    (reference :132-181: fresh model per point, catch OOM, record peak)."""
    device = resolve_device(device)
    results = []
    for b in batch_sizes:
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        error = None
        try:
            r = measure_tokens_per_second(
                cfg,
                batch_size=b,
                seq_len=seq_len,
                num_steps=num_steps,
                warmup_steps=warmup_steps,
                device=device,
            )
            r["peak_bytes_in_use"] = measured_memory(
                device)["peak_bytes_in_use"]
            r["oom"] = False
        except torch.cuda.OutOfMemoryError as e:
            error = str(e).splitlines()[0][:200]
        if error is not None:  # outside the handler: its frames are gone
            r = {"batch_size": b, "seq_len": seq_len, "oom": True,
                 "error": error}
        _release(device)
        results.append(r)
    return results


def main(argv=None) -> int:
    from pytorch_distributed_tpu_torch.train.baseline import (
        add_model_args,
        build_model_cfg,
    )

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_model_args(p, preset="gpt2")
    p.add_argument("--micro-batch-size", type=int, default=8)
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--warmup-steps", type=int, default=5)
    p.add_argument("--sweep", default="1,4,8,16,32,64",
                   help="comma-separated batch sizes ('' disables)")
    p.add_argument("--no-extrapolate", action="store_true")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    cfg = build_model_cfg(args)
    b, t = args.micro_batch_size, args.seq_len

    print(f"=== throughput: {args.preset}, B={b}, T={t}, "
          f"{args.warmup_steps} warmup + {args.steps} timed, "
          f"device {args.device} ===")
    r = measure_tokens_per_second(
        cfg, batch_size=b, seq_len=t, num_steps=args.steps,
        warmup_steps=args.warmup_steps, device=args.device,
    )
    print(f"tokens/sec: {r['tokens_per_second']:,.0f}")
    print(f"steps/sec:  {r['steps_per_second']:.3f}")
    print(f"sec/step:   {r['seconds_per_step'] * 1000:.1f} ms")
    print(f"params:     {r['param_count']:,}")

    if not args.no_extrapolate:
        ex = extrapolate_modern_training(r)
        print("\n=== extrapolation to 1T params / 10T tokens "
              "(reference throughput.py:86-129) ===")
        print(f"scaled tokens/sec: {ex['scaled_tokens_per_second']:.2f}")
        print(f"time: {ex['days']:,.0f} days = {ex['years']:,.1f} years")
        print(f"(assumption: {ex['assumption']})")

    if args.sweep:
        sizes = tuple(int(x) for x in args.sweep.split(","))
        print(f"\n=== batch-size sweep {sizes} "
              "(reference throughput.py:132-181) ===")
        rows = compare_batch_sizes(
            cfg, batch_sizes=sizes, seq_len=t,
            num_steps=max(2, args.steps // 2),
            warmup_steps=min(2, args.warmup_steps), device=args.device,
        )
        print(f"{'batch':>6} {'tokens/s':>12} {'peak mem':>12}")
        for row in rows:
            if row.get("oom"):
                print(f"{row['batch_size']:>6} {'OOM':>12}")
            else:
                peak = row.get("peak_bytes_in_use", 0)
                print(
                    f"{row['batch_size']:>6} "
                    f"{row['tokens_per_second']:>12,.0f} "
                    f"{peak / 2**20:>10.0f}Mi"
                )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
