"""The port's ``ScheduledProfiler`` against the JAX package's schedule, and
the profiler on the ``Trainer`` and the training entry point, on the CPU.

The JAX profiler's trace calls are replaced by no-ops, so its schedule
(``_phase``) runs alone; the port's active steps are read from the
``torch.profiler`` schedule it drives.
"""

import re

import pytest
import torch
from torch.profiler import ProfilerAction

from pytorch_distributed_tpu.profiling import profiler as jprofiler
from pytorch_distributed_tpu_torch.config import TrainConfig, model_config
from pytorch_distributed_tpu_torch.models import get_model
from pytorch_distributed_tpu_torch.profiling import trace_analysis as ta
from pytorch_distributed_tpu_torch.profiling.profiler import (
    ScheduledProfiler,
    find_trace_files,
)
from pytorch_distributed_tpu_torch.train import baseline
from pytorch_distributed_tpu_torch.train.trainer import Trainer

SCHEDULES = [(2, 2, 6, 1), (0, 0, 1, 0), (1, 0, 3, 2), (1, 1, 2, 0)]
RECORDING = (ProfilerAction.RECORD, ProfilerAction.RECORD_AND_SAVE)


def _jax_active_steps(monkeypatch, tmp_path, schedule, n=30):
    monkeypatch.setattr(jprofiler.jax.profiler, "start_trace",
                        lambda *a, **k: None)
    monkeypatch.setattr(jprofiler.jax.profiler, "stop_trace", lambda: None)
    wait, warmup, active, repeat = schedule
    prof = jprofiler.ScheduledProfiler(tmp_path / "jax", wait=wait,
                                       warmup=warmup, active=active,
                                       repeat=repeat)
    steps = set()
    for i in range(n):
        if prof._phase() == "active":
            steps.add(i)
        prof.step()
    return steps


@pytest.mark.parametrize("schedule", SCHEDULES,
                         ids=["-".join(map(str, s)) for s in SCHEDULES])
def test_active_steps_equal_jax_schedule(monkeypatch, tmp_path, schedule):
    want = _jax_active_steps(monkeypatch, tmp_path, schedule)
    wait, warmup, active, repeat = schedule
    recorded, phased = set(), set()
    with ScheduledProfiler(tmp_path / "torch", wait=wait, warmup=warmup,
                           active=active, repeat=repeat,
                           device="cpu") as prof:
        for i in range(30):
            if prof._prof.current_action in RECORDING:
                recorded.add(i)
            if prof._phase() == "active":
                phased.add(i)
            prof.step()
    assert recorded == want
    assert phased == want
    assert want  # every schedule here traces something


def _tiny_trainer(steps):
    cfg = model_config("tiny").replace(attention_impl="flash",
                                       remat="names", embd_pdrop=0.0,
                                       attn_pdrop=0.0, resid_pdrop=0.0)
    tcfg = TrainConfig(global_batch_size=2, micro_batch_size=2,
                       num_steps=steps, log_every_n_steps=steps, seed=0)
    trainer = Trainer(get_model(cfg), cfg, tcfg, device="cpu",
                      log_fn=lambda msg: None)
    g = torch.Generator().manual_seed(0)

    def loader():
        for _ in range(steps):
            b = torch.randint(0, cfg.vocab_size, (2, 17), generator=g)
            yield b[:, :-1].numpy(), b[:, 1:].numpy()

    return trainer, loader()


def test_trainer_writes_one_trace_with_the_active_steps(tmp_path):
    trainer, data = _tiny_trainer(10)
    with ScheduledProfiler(tmp_path, wait=2, warmup=2, active=4, repeat=1,
                           device="cpu") as prof:
        state, history = trainer.train(data, profiler=prof)
    assert state.step == 10 and history
    assert len(prof.window_seconds) == 1 and prof.window_seconds[0] > 0
    files = find_trace_files(tmp_path)
    assert len(files) == 1
    assert re.search(r"/rank0/[^/]+\.pt\.trace\.json\.gz$", files[0])
    trace = ta.load_trace(files[0])
    steps = sorted(int(e["name"].split("#")[1])
                   for e in trace["traceEvents"]
                   if e.get("cat") == "user_annotation"
                   and e["name"].startswith("train_step#"))
    assert steps == [4, 5, 6, 7]
    assert ta.temporal_breakdown(trace)["total_us"] == 0.0  # no device


def test_trainer_runs_without_a_profiler(tmp_path):
    trainer, data = _tiny_trainer(3)
    state, _ = trainer.train(data)
    assert state.step == 3


def _baseline_argv(tmp_path, *extra):
    return ["--device", "cpu", "--preset", "tiny", "--seq-len", "32",
            "--global-batch-size", "4", "--micro-batch-size", "2",
            "--steps", "11", "--num-train-files", "2", "--log-every", "11",
            "--data-dir", str(tmp_path / "data"), "--checkpoint-dir",
            str(tmp_path / "ckpt"), *extra]


def test_baseline_profiles_into_trace_dir(tmp_path):
    out = tmp_path / "traces"
    assert baseline.main(_baseline_argv(tmp_path, "--trace-dir",
                                        str(out))) == 0
    files = find_trace_files(out)
    assert len(files) == 1 and "/rank0/" in files[0]
    trace = ta.load_trace(files[0])
    steps = sorted(int(e["name"].split("#")[1])
                   for e in trace["traceEvents"]
                   if e.get("cat") == "user_annotation"
                   and e["name"].startswith("train_step#"))
    assert steps == [4, 5, 6, 7, 8, 9]  # wait 2, warmup 2, active 6


def test_baseline_no_profiler_writes_nothing(tmp_path):
    out = tmp_path / "traces"
    assert baseline.main(_baseline_argv(tmp_path, "--trace-dir", str(out),
                                        "--no-profiler")) == 0
    assert not out.exists()


def test_baseline_default_trace_dir_is_the_reference_one():
    args = baseline.parse_args(["--device", "cpu"])
    assert baseline.DEFAULT_TRACE_DIR == "outputs/traces/baseline"
    assert args.trace_dir is None and not args.no_profiler
