"""Crash-recovery supervisor and seeded fault storm for the training loop:
the port's twin of the JAX package's ``scripts/train_supervisor.py``, run
as a module:

    python -m pytorch_distributed_tpu_torch.train.supervisor --seed 0
    python -m pytorch_distributed_tpu_torch.train.supervisor --soak \\
        --json report.json                        # the bench leg
    python -m pytorch_distributed_tpu_torch.train.supervisor --soak \\
        --dryrun --device cpu                     # a CPU smoke

It restarts a real training PROCESS across injected faults
(``train/chaos``) and proves the whole recovery stack — the anomaly guard
(``train/guard``), checkpoint integrity and crash-safe resume
(``train/checkpoint``), preemption saves, loader-position resume,
step-keyed dropout — by one bar: after a storm of process crashes at
seeded steps (``os._exit``: no cleanup runs), crashes inside a checkpoint
save (before it commits), SIGTERM, corrupt-token batches (the guard must
skip them and roll back), bit-flipped checkpoint payloads (resume must
fall back to an older checkpoint) and slow steps, the final params and
optimizer state must be BIT-EQUAL to a fault-free leg of the same seed.
Everything is a function of ``--seed``: the storm replays exactly.

The worker's run is the JAX script's: GPT-2 at vocab 101, n_ctx 16,
n_embd 32, 2 layers, 4 heads, f32, remat "dots", dropout 0.1 (so the
step-keyed masks are part of the claim, and training attention is the
naive path), A = 2 micro-batches of [4, 16], lr 1e-3, the guard rolling
back after every anomaly. Workers run on ``--device`` (default cuda).
Where the JAX script pins ``compile_count`` to 1 in every incarnation
(one XLA executable, no recompile), the port compiles nothing per shape:
its counterpart is the number of kernel libraries the worker loaded
(``ops/_build``), which must be the same in every incarnation as in the
fault-free one.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from pathlib import Path

from pytorch_distributed_tpu_torch.parallel.mesh import bind_to_parent, run

DONE_NAME = "DONE.json"
FAULT_KINDS = ("crash", "sigterm", "bad_batch", "ckpt_corrupt", "slow_step")
_REPO_ROOT = Path(__file__).resolve().parents[2]


def _worker_config(args) -> dict:
    """What every attempt (and the fault-free leg) needs, written once so
    every attempt runs the same run."""
    return {
        "seed": args.seed,
        "steps": args.steps,
        "save_every": args.save_every,
        "keep_checkpoints": args.keep_checkpoints,
        "async_checkpoint": bool(args.async_checkpoint),
        "device": args.device,
        "p_crash": args.p_crash,
        "p_save_crash": args.p_save_crash,
        "p_sigterm": args.p_sigterm,
        "p_bad_batch": args.p_bad_batch,
        "p_ckpt_corrupt": args.p_ckpt_corrupt,
        "p_ckpt_corrupt_attempt": args.p_ckpt_corrupt_attempt,
        "p_slow_step": args.p_slow_step,
        "slow_step_s": args.slow_step_s,
    }


def _build_trainer(workdir: Path, cfg: dict, leg: str):
    from pytorch_distributed_tpu_torch.config import ModelConfig, TrainConfig
    from pytorch_distributed_tpu_torch.data import (
        TokenShardLoader,
        make_synthetic_shards,
    )
    from pytorch_distributed_tpu_torch.models import get_model
    from pytorch_distributed_tpu_torch.train.trainer import Trainer

    mcfg = ModelConfig(vocab_size=101, n_ctx=16, n_embd=32, n_layer=2,
                       n_head=4, dtype="float32", remat="dots")
    shards = make_synthetic_shards(workdir / "data", num_shards=2,
                                   tokens_per_shard=20_000, vocab_size=101,
                                   seed=cfg["seed"])
    loader = TokenShardLoader(shards, 4, 16)
    tcfg = TrainConfig(
        global_batch_size=8, micro_batch_size=4,  # A = 2
        num_steps=cfg["steps"], learning_rate=1e-3,
        log_every_n_steps=4, seed=cfg["seed"],
        save_every_n_steps=cfg["save_every"],
        checkpoint_dir=str(workdir / f"ckpt_{leg}"),
        keep_checkpoints=cfg["keep_checkpoints"],
        async_checkpoint=cfg["async_checkpoint"],
        save_on_preemption=True,
        anomaly_guard=True,
        guard_rollback_after=1,  # every anomaly rolls back and replays
        guard_warmup_steps=4,
        guard_max_rollbacks=1000,  # the storm, not the guard, bounds it
    )
    trainer = Trainer(get_model(mcfg), mcfg, tcfg, device=cfg["device"],
                      log_fn=lambda line: print(line, flush=True))
    return trainer, loader


def _make_injector(workdir: Path, cfg: dict, attempt: int):
    import numpy as np

    from pytorch_distributed_tpu_torch.train.chaos import (
        TrainFault,
        TrainFaultInjector,
    )

    # A function of (seed, attempt): each restart sees a fresh but
    # reproducible storm.
    fold = cfg["seed"] * 1000 + attempt
    scripted = []
    rng = np.random.default_rng(fold + 7)
    # Save-coupled faults go on EARLY save boundaries: an attempt rarely
    # lives long past its first kill draw.
    early_saves = min(4, max(1, cfg["steps"] // cfg["save_every"]))
    if rng.random() < cfg["p_save_crash"]:
        tick = cfg["save_every"] * int(rng.integers(1, early_saves + 1))
        scripted.append(TrainFault(tick=tick, kind="crash", program="save"))
    if rng.random() < cfg["p_ckpt_corrupt_attempt"]:
        tick = cfg["save_every"] * int(rng.integers(1, early_saves + 1))
        scripted.append(TrainFault(tick=tick, kind="ckpt_corrupt"))
    return TrainFaultInjector(
        scripted, seed=fold,
        p_crash=cfg["p_crash"], p_sigterm=cfg["p_sigterm"],
        p_bad_batch=cfg["p_bad_batch"], p_ckpt_corrupt=cfg["p_ckpt_corrupt"],
        p_slow_step=cfg["p_slow_step"], slow_step_s=cfg["slow_step_s"],
        crash_mode="exit", counts_path=workdir / f"counts_{attempt}.json",
    )


def _loaded_libraries() -> int:
    from pytorch_distributed_tpu_torch.ops import _build

    return len(_build._loaded)


def run_worker(args) -> int:
    """One training attempt: resume from the newest loadable checkpoint,
    train (under faults on the chaos leg), record the outcome. A DONE
    marker only when every step completed."""
    from pytorch_distributed_tpu_torch.train import checkpoint as ckpt_lib

    workdir = Path(args.workdir)
    cfg = json.loads((workdir / "config.json").read_text())
    leg_dir = workdir / args.leg
    leg_dir.mkdir(parents=True, exist_ok=True)
    trainer, loader = _build_trainer(workdir, cfg, args.leg)
    state = trainer.init_state()
    t0 = time.perf_counter()
    if ckpt_lib.latest_checkpoint(trainer.train_cfg.checkpoint_dir) is None:
        # An anchor: rollback and resume always have a target.
        trainer.save_checkpoint(state, loader=loader)
    state = trainer.resume_latest(state, loader=loader)
    start_step = state.step
    if args.leg == "chaos":
        _make_injector(workdir, cfg, args.attempt).install(trainer)
    state, history = trainer.train(loader, state=state)
    record = {
        "attempt": args.attempt,
        "leg": args.leg,
        "start_step": start_step,
        "end_step": state.step,
        "wallclock_s": round(time.perf_counter() - t0, 3),
        "rollbacks": trainer._rollbacks,
        "anomalies": history[-1].get("anomalies", 0) if history else 0,
        # No per-shape compile here: the kernel libraries loaded (module
        # docstring).
        "compile_count": _loaded_libraries(),
    }
    (workdir / f"attempt_{args.leg}_{args.attempt}.json").write_text(
        json.dumps(record))
    if state.step >= cfg["steps"]:
        ckpt_lib.save_checkpoint(workdir / f"final_{args.leg}", state,
                                 trainer.model_cfg, format="npz")
        (leg_dir / DONE_NAME).write_text(json.dumps(record))
    return 0


def _spawn_worker(args, leg: str, attempt: int, log_dir: Path) -> int:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(_REPO_ROOT), env.get("PYTHONPATH")) if p)
    log = log_dir / f"worker_{leg}_{attempt}.log"
    with log.open("w") as f:
        # The port's launcher: the worker's group is killed if the
        # supervisor is interrupted, and the worker dies with the
        # supervisor (``bind_to_parent``).
        return run(
            [sys.executable, "-m", "pytorch_distributed_tpu_torch.train."
             "supervisor", "--worker", "--workdir", str(args.workdir),
             "--leg", leg, "--attempt", str(attempt)],
            timeout=None, env=env, log=f).returncode


def _run_leg(args, leg: str) -> dict:
    """Drive one leg to completion across restarts: its attempts, wall
    clock and exit codes."""
    workdir = Path(args.workdir)
    log_dir = workdir / "logs"
    log_dir.mkdir(parents=True, exist_ok=True)
    done_path = workdir / leg / DONE_NAME
    rcs = []
    t0 = time.perf_counter()
    max_attempts = 1 if leg == "clean" else args.max_restarts + 1
    for attempt in range(max_attempts):
        rcs.append(_spawn_worker(args, leg, attempt, log_dir))
        if done_path.exists():
            break
    wallclock = time.perf_counter() - t0
    attempts = [json.loads(p.read_text())
                for p in sorted(workdir.glob(f"attempt_{leg}_*.json"))]
    return {
        "leg": leg,
        "completed": done_path.exists(),
        "spawned": len(rcs),
        "restarts": len(rcs) - 1,
        "exit_codes": rcs,
        "wallclock_s": round(wallclock, 3),
        "attempts": attempts,
    }


def _bit_equal_finals(workdir: Path) -> tuple[bool, list[str]]:
    import numpy as np

    loaded = []
    for p in (workdir / "final_chaos", workdir / "final_clean"):
        if not (p / "arrays.npz").exists():
            return False, [f"missing final checkpoint {p}"]
        with np.load(p / "arrays.npz") as data:
            loaded.append({k: data[k] for k in data.files})
    chaos, clean = loaded
    if set(chaos) != set(clean):
        return False, ["final checkpoints have different leaf sets"]
    diffs = [k for k in sorted(chaos)
             if chaos[k].shape != clean[k].shape
             or chaos[k].dtype != clean[k].dtype
             or chaos[k].tobytes() != clean[k].tobytes()]
    return not diffs, diffs


def run_supervisor(args) -> dict:
    workdir = Path(args.workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    (workdir / "config.json").write_text(json.dumps(_worker_config(args)))
    chaos = _run_leg(args, "chaos")
    clean = _run_leg(args, "clean")

    failures: list[str] = []
    if not chaos["completed"]:
        failures.append(
            f"chaos leg did not complete within {args.max_restarts} restarts")
    if not clean["completed"]:
        failures.append("fault-free leg did not complete (harness bug)")
    bit_equal, diffs = False, ["legs incomplete"]
    if chaos["completed"] and clean["completed"]:
        bit_equal, diffs = _bit_equal_finals(workdir)
        if not bit_equal:
            failures.append(f"final state NOT bit-equal to the fault-free "
                            f"run: {diffs[:5]}")
    # Fault coverage over every attempt, the dead ones included (a fault
    # is recorded before it acts).
    counts: dict[str, int] = {}
    for p in sorted(workdir.glob("counts_*.json")):
        for k, v in json.loads(p.read_text()).items():
            counts[k] = counts.get(k, 0) + v
    for kind in FAULT_KINDS:
        if not counts.get(kind):
            failures.append(f"fault kind {kind!r} never fired — this "
                            "seed's storm did not exercise it (raise its "
                            "probability)")
    want = [a["compile_count"] for a in clean["attempts"]][:1]
    for leg in (chaos, clean):
        for a in leg["attempts"]:
            if want and a["compile_count"] != want[0]:
                failures.append(
                    f"{a['leg']} attempt {a['attempt']}: {a['compile_count']}"
                    f" kernel libraries loaded, the fault-free run {want[0]}")
    goodput_chaos = args.steps / max(chaos["wallclock_s"], 1e-9)
    goodput_clean = args.steps / max(clean["wallclock_s"], 1e-9)
    return {
        "seed": args.seed,
        "steps": args.steps,
        "save_every": args.save_every,
        "async_checkpoint": bool(args.async_checkpoint),
        "device": args.device,
        "chaos": chaos,
        "clean": clean,
        "fault_counts": counts,
        "bit_equal": bit_equal,
        "goodput_steps_per_s": {"chaos": round(goodput_chaos, 3),
                                "clean": round(goodput_clean, 3)},
        "goodput_retention": round(goodput_chaos / goodput_clean, 4),
        "recovery_overhead_s": round(
            chaos["wallclock_s"] - clean["wallclock_s"], 3),
        "failures": failures,
        "ok": not failures,
    }


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--worker", action="store_true",
                    help="internal: run one training attempt")
    ap.add_argument("--leg", default="chaos", choices=["chaos", "clean"])
    ap.add_argument("--attempt", type=int, default=0)
    ap.add_argument("--workdir", default=None,
                    help="storm state dir (default: a fresh temp dir)")
    ap.add_argument("--device", default="cuda",
                    help="where the workers train: cuda (default) or cpu")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--steps", type=int, default=48)
    ap.add_argument("--save-every", type=int, default=4)
    ap.add_argument("--keep-checkpoints", type=int, default=3)
    ap.add_argument("--async-checkpoint", action="store_true",
                    help="storm the async (npz) save instead of the sync "
                         "one")
    ap.add_argument("--max-restarts", type=int, default=40)
    ap.add_argument("--p-crash", type=float, default=0.03)
    ap.add_argument("--p-save-crash", type=float, default=0.5,
                    help="per-ATTEMPT probability of one crash inside a "
                         "checkpoint save (before it commits)")
    ap.add_argument("--p-sigterm", type=float, default=0.02)
    ap.add_argument("--p-bad-batch", type=float, default=0.05)
    ap.add_argument("--p-ckpt-corrupt", type=float, default=0.03)
    ap.add_argument("--p-ckpt-corrupt-attempt", type=float, default=0.5,
                    help="per-ATTEMPT probability of one checkpoint "
                         "bit-flip on a save boundary")
    ap.add_argument("--p-slow-step", type=float, default=0.08)
    ap.add_argument("--slow-step-s", type=float, default=0.05)
    ap.add_argument("--soak", action="store_true",
                    help="the full storm at soak scale (more steps)")
    ap.add_argument("--dryrun", action="store_true",
                    help="small smoke (fewer steps, hotter faults)")
    ap.add_argument("--json", default=None, help="write the report here")
    args = ap.parse_args(argv)
    if args.soak:
        args.steps = max(args.steps, 64)
    if args.dryrun:
        # Fewer steps are fewer ticks: the per-step probabilities go UP so
        # that every kind still fires.
        args.steps = min(args.steps, 20)
        args.save_every = min(args.save_every, 2)
        args.p_crash = max(args.p_crash, 0.06)
        args.p_sigterm = max(args.p_sigterm, 0.05)
        args.p_bad_batch = max(args.p_bad_batch, 0.12)
        args.p_ckpt_corrupt = max(args.p_ckpt_corrupt, 0.10)
        args.p_slow_step = max(args.p_slow_step, 0.20)
    return args


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.worker:
        if args.workdir is None:
            raise SystemExit("--worker requires --workdir")
        return run_worker(args)
    if args.workdir is None:
        args.workdir = tempfile.mkdtemp(prefix="train_storm_")
    report = run_supervisor(args)
    print(json.dumps(report, indent=2))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(report, f, indent=2)
            f.write("\n")
    if not report["ok"]:
        print("TRAIN STORM FAILED", file=sys.stderr)
        return 1
    print(f"train storm ok: {args.steps} steps, "
          f"{report['chaos']['restarts']} restarts, faults "
          f"{report['fault_counts']}, goodput retention "
          f"{report['goodput_retention']}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    bind_to_parent()
    raise SystemExit(main())
