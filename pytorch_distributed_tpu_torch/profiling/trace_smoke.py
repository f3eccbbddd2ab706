"""End-to-end check of the trace-analysis pipeline on a real device trace.

The port's twin of the JAX package's ``scripts/trace_smoke.py``: GPT-2
at full width (12 layers, n_embd 768, bf16, flash attention, ``names``
remat, no dropout), B 8, T 1024, trained by the port's ``Trainer`` for 8
steps under ``ScheduledProfiler(wait=2, warmup=2, active=4)``; the Kineto
trace of steps 4-7 is found, loaded and analysed. On the GPU it asserts
that the breakdown finds device work (compute above 10 %, more than 10
distinct device ops, no communication on one card). The JAX script runs 4
layers and writes ``benchmarks/trace_smoke.json``; this twin runs all 12
and writes ``outputs/trace_smoke.json``, or ``--out``.

    python -m pytorch_distributed_tpu_torch.profiling.trace_smoke
    python -m pytorch_distributed_tpu_torch.profiling.trace_smoke \\
        --device cpu --preset tiny --batch 2 --seq-len 64

On the CPU the pipeline runs the same way; a CPU trace holds no device
events, so the artifact says so and the device gates are not applied.
"""

from __future__ import annotations

import argparse
import json
import tempfile
from pathlib import Path

import numpy as np

from pytorch_distributed_tpu_torch.config import (
    ModelConfig,
    TrainConfig,
    model_config,
)
from pytorch_distributed_tpu_torch.profiling.profiler import (
    ScheduledProfiler,
    find_trace_files,
)
from pytorch_distributed_tpu_torch.profiling.trace_analysis import (
    load_trace,
    op_summary,
    temporal_breakdown,
)

SCHEDULE = dict(wait=2, warmup=2, active=4)


def smoke_cfg(preset: str = "gpt2", seq_len: int = 1024) -> ModelConfig:
    """The preset in bf16 with flash attention, ``names`` remat and no
    dropout (the training main path)."""
    cfg = model_config(preset, dtype="bfloat16").replace(
        attention_impl="flash", remat="names", logits_dtype="bfloat16",
        embd_pdrop=0.0, attn_pdrop=0.0, resid_pdrop=0.0,
    )
    if preset == "tiny":
        cfg = cfg.replace(n_ctx=max(seq_len, 32))
    return cfg


def profiled_training(cfg: ModelConfig, trace_dir, *, batch: int = 8,
                      seq_len: int = 1024, steps: int = 8, seed: int = 0,
                      device=None, profiler_cls=ScheduledProfiler) -> dict:
    """Train ``steps`` steps of random tokens from ``seed`` under
    ``profiler_cls(trace_dir, **SCHEDULE)``; the trace files written, the
    first loaded, its breakdown and op summary, and the profiler."""
    from pytorch_distributed_tpu_torch.models import get_model
    from pytorch_distributed_tpu_torch.train.trainer import Trainer

    tcfg = TrainConfig(global_batch_size=batch, micro_batch_size=batch,
                       num_steps=steps, learning_rate=3e-4,
                       log_every_n_steps=steps, seed=seed)
    trainer = Trainer(get_model(cfg), cfg, tcfg, device=device,
                      log_fn=lambda msg: None)
    rng = np.random.default_rng(seed)

    def loader():
        for _ in range(steps):
            b = rng.integers(0, cfg.vocab_size, (batch, seq_len + 1))
            yield b[:, :-1].astype(np.int32), b[:, 1:].astype(np.int32)

    with profiler_cls(trace_dir, device=device, **SCHEDULE) as prof:
        _, history = trainer.train(loader(), profiler=prof)
    files = find_trace_files(trace_dir)
    if not files:
        raise AssertionError(f"the profiler wrote no trace under {trace_dir}")
    trace = load_trace(files[0])
    return dict(files=files, trace=trace, breakdown=temporal_breakdown(trace),
                ops=op_summary(trace), profiler=prof, history=history)


def check(run: dict) -> None:
    """The device gates: compute above 10 %, more than 10 device ops, no
    communication on one card."""
    tb, ops = run["breakdown"], run["ops"]
    if not tb["compute_pct"] > 10:
        raise AssertionError(f"the breakdown found almost no compute on a "
                             f"busy train loop: {tb}")
    if tb["communication_us"] != 0:
        comm = sorted(n for n, r in ops.items()
                      if r["category"] == "communication")
        raise AssertionError(f"communication on one card: {comm[:5]}")
    if len(ops) <= 10:
        raise AssertionError(f"op summary nearly empty: {len(ops)} ops")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--preset", default="gpt2")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq-len", type=int, default=1024)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default="outputs/trace_smoke.json")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    cfg = smoke_cfg(args.preset, args.seq_len)
    with tempfile.TemporaryDirectory(prefix="trace_smoke_") as tmp:
        run = profiled_training(cfg, tmp, batch=args.batch,
                                seq_len=args.seq_len, seed=args.seed,
                                device=args.device)
    on_gpu = args.device != "cpu"
    if on_gpu:
        check(run)
    tb, ops = run["breakdown"], run["ops"]
    top = sorted(ops.items(), key=lambda kv: -kv[1]["total_us"])[:10]
    artifact = {
        "device": args.device,
        "status": "ok" if on_gpu else
                  "cpu: the trace holds no device events (gates need the "
                  "GPU)",
        "trace_file": Path(run["files"][0]).name,
        "trace_files": len(run["files"]),
        "config": f"{args.preset} {cfg.n_layer}-layer, B={args.batch}, "
                  f"T={args.seq_len}, bf16, flash+names, profiler schedule "
                  f"wait=2 warmup=2 active=4",
        "temporal_breakdown_pct": {
            k.replace("_pct", ""): round(v, 2)
            for k, v in tb.items() if k.endswith("_pct")
        },
        "device_op_count": len(ops),
        "top_ops_ms": {name: round(v["total_us"] / 1e3, 2)
                       for name, v in top},
    }
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(artifact, indent=1))
    print(json.dumps(artifact, indent=1))
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
