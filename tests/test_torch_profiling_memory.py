"""The port's memory and throughput accounting against the JAX package's,
and the four profiling twins at tiny shapes, on the CPU."""

import json

import pytest
import torch

from pytorch_distributed_tpu.config import ModelConfig as JaxModelConfig
from pytorch_distributed_tpu.config import model_config as jax_model_config
from pytorch_distributed_tpu.profiling import memory as jmemory
from pytorch_distributed_tpu.profiling import throughput as jthroughput
from pytorch_distributed_tpu_torch.config import ModelConfig, model_config
from pytorch_distributed_tpu_torch.profiling import (
    analyze_traces,
    memory,
    memory_analysis,
    throughput,
    trace_smoke,
)

REMATS = ["none", "full", "dots", "dots_no_batch", "names", "flash"]


@pytest.mark.parametrize("fused", [False, True], ids=["logits", "fused"])
@pytest.mark.parametrize("remat", REMATS)
@pytest.mark.parametrize("preset", ["gpt2", "gpt2-large", "llama3-1b"])
def test_analytic_breakdown_equals_jax(preset, remat, fused):
    kw = dict(remat=remat, fused_head_ce=fused)
    got = memory.analytic_memory_breakdown(model_config(preset, **kw),
                                           batch_size=8, seq_len=1024)
    want = jmemory.analytic_memory_breakdown(jax_model_config(preset, **kw),
                                             batch_size=8, seq_len=1024)
    assert got == want


@pytest.mark.parametrize("optimizer", ["adamw", "sgd", "momentum"])
def test_analytic_breakdown_equals_jax_bf16_moe(optimizer):
    kw = dict(dtype="bfloat16", param_dtype="bfloat16", n_experts=4,
              moe_top_k=2)
    got = memory.analytic_memory_breakdown(
        model_config("gpt2", **kw), batch_size=4, seq_len=512,
        optimizer=optimizer)
    want = jmemory.analytic_memory_breakdown(
        jax_model_config("gpt2", **kw), batch_size=4, seq_len=512,
        optimizer=optimizer)
    assert got == want


def test_param_count_allocates_nothing():
    # Llama-3.2-1B's 1.5B f32 parameters would take 6 GB to draw.
    assert memory._model_param_count(model_config("llama3-1b")) == \
        1_498_482_688


def test_measured_memory_on_the_cpu_has_jax_keys_at_zero():
    got = memory.measured_memory("cpu")
    assert set(got) == set(jmemory.measured_memory())
    assert got == {"bytes_in_use": 0, "peak_bytes_in_use": 0,
                   "bytes_limit": 0, "raw": {}}
    assert memory.save_memory_snapshot("unused.pickle") is None
    assert memory.start_memory_history() is False


def test_compare_estimate_vs_measured_on_the_cpu():
    cfg = model_config("gpt2")
    got = memory.compare_estimate_vs_measured(cfg)
    assert got["estimated"] == memory.analytic_memory_breakdown(cfg)
    assert got["ratio_measured_over_estimated"] == 0.0


@pytest.mark.parametrize("measured, targets", [
    ({"tokens_per_second": 1000.0, "param_count": 1_000_000},
     dict(target_params=1e9, target_tokens=1e9)),
    ({"tokens_per_second": 123456.7, "param_count": 124_439_808}, {}),
    ({"tokens_per_second": 87.5, "param_count": 1_498_482_688},
     dict(target_params=4e11, target_tokens=15e12)),
])
def test_extrapolation_equals_jax(measured, targets):
    assert throughput.extrapolate_modern_training(measured, **targets) == \
        jthroughput.extrapolate_modern_training(measured, **targets)


TINY = dict(vocab_size=101, n_ctx=16, n_embd=32, n_layer=2, n_head=4,
            dtype="float32")


def test_measure_tokens_per_second_has_jax_keys_and_count():
    got = throughput.measure_tokens_per_second(
        ModelConfig(**TINY), batch_size=2, seq_len=16, num_steps=3,
        warmup_steps=1, seed=7, device="cpu")
    want = jthroughput.measure_tokens_per_second(
        JaxModelConfig(**TINY), batch_size=2, seq_len=16, num_steps=3,
        warmup_steps=1, seed=7)
    assert set(got) == set(want)
    assert got["param_count"] == want["param_count"]
    for key in ("num_steps", "batch_size", "seq_len"):
        assert got[key] == want[key]
    assert got["tokens_per_second"] == pytest.approx(
        got["steps_per_second"] * 2 * 16, rel=1e-6)


def test_batch_sweep_records_an_oom_and_runs_the_next_point(monkeypatch):
    real = throughput.measure_tokens_per_second
    calls = []

    def measure(cfg, *, batch_size, **kw):
        calls.append(batch_size)
        if batch_size == 4:
            held = torch.zeros(1024)  # the point's tensors, dropped after
            raise torch.cuda.OutOfMemoryError(
                f"CUDA out of memory. Tried to allocate {held.numel()} B\n"
                "details")
        return real(cfg, batch_size=batch_size, **kw)

    monkeypatch.setattr(throughput, "measure_tokens_per_second", measure)
    rows = throughput.compare_batch_sizes(
        ModelConfig(**TINY), batch_sizes=(1, 4, 2), seq_len=16,
        num_steps=2, warmup_steps=1, device="cpu")
    assert calls == [1, 4, 2]
    assert [r["batch_size"] for r in rows] == [1, 4, 2]
    assert [r["oom"] for r in rows] == [False, True, False]
    assert rows[1]["error"].startswith("CUDA out of memory")
    assert "\n" not in rows[1]["error"]
    assert rows[2]["tokens_per_second"] > 0
    assert rows[0]["peak_bytes_in_use"] == 0  # the CPU keeps no stats


def test_batch_sweep_lets_other_errors_through(monkeypatch):
    def measure(cfg, **kw):
        raise RuntimeError("not a memory error")

    monkeypatch.setattr(throughput, "measure_tokens_per_second", measure)
    with pytest.raises(RuntimeError, match="not a memory error"):
        throughput.compare_batch_sizes(ModelConfig(**TINY),
                                       batch_sizes=(1,), device="cpu")


# ---- the four twins, at tiny shapes on the CPU ----------------------------
def test_memory_analysis_twin(capsys, tmp_path):
    assert memory_analysis.main([
        "--device", "cpu", "--preset", "tiny", "--seq-len", "32",
        "--micro-batch-size", "2", "--profile-steps", "2",
        "--snapshot", str(tmp_path / "snap.pickle")]) == 0
    out = capsys.readouterr().out
    assert "analytic breakdown" in out and "step 1: loss" in out
    assert "XLA's buffer assignment has no eager-PyTorch counterpart" in out
    assert not (tmp_path / "snap.pickle").exists()


def test_throughput_twin(capsys):
    assert throughput.main([
        "--device", "cpu", "--preset", "tiny", "--seq-len", "32",
        "--micro-batch-size", "2", "--steps", "2", "--warmup-steps", "1",
        "--sweep", "1,2"]) == 0
    out = capsys.readouterr().out
    assert "tokens/sec:" in out and "extrapolation" in out
    assert "batch-size sweep (1, 2)" in out


@pytest.fixture(scope="module")
def smoke_trace(tmp_path_factory):
    out = tmp_path_factory.mktemp("smoke") / "trace_smoke.json"
    assert trace_smoke.main(["--device", "cpu", "--preset", "tiny",
                             "--batch", "2", "--seq-len", "32",
                             "--out", str(out)]) == 0
    return json.loads(out.read_text())


def test_trace_smoke_twin(smoke_trace):
    assert smoke_trace["device"] == "cpu"
    assert smoke_trace["trace_files"] == 1
    assert smoke_trace["trace_file"].endswith(".pt.trace.json.gz")
    assert smoke_trace["device_op_count"] == 0
    assert "2-layer" in smoke_trace["config"]


def test_trace_smoke_device_gates():
    run = dict(breakdown=dict(compute_pct=50.0, communication_us=0.0),
               ops={f"k{i}": dict(category="compute") for i in range(11)})
    trace_smoke.check(run)
    run["breakdown"]["communication_us"] = 3.0
    run["ops"]["ncclDevKernel_AllReduce"] = dict(category="communication")
    with pytest.raises(AssertionError, match="communication on one card"):
        trace_smoke.check(run)
    run = dict(breakdown=dict(compute_pct=5.0, communication_us=0.0),
               ops={})
    with pytest.raises(AssertionError, match="almost no compute"):
        trace_smoke.check(run)


def _cpu_trace_dir(tmp_path):
    from pytorch_distributed_tpu_torch.profiling.profiler import (
        ScheduledProfiler,
    )

    with ScheduledProfiler(tmp_path, wait=0, warmup=1, active=1,
                           device="cpu") as prof:
        for _ in range(2):
            (torch.ones(8) * 2).sum()
            prof.step()
    return str(tmp_path)


def test_analyze_traces_twin(capsys, tmp_path):
    a = _cpu_trace_dir(tmp_path / "a")
    b = _cpu_trace_dir(tmp_path / "b")
    charts = tmp_path / "charts"
    assert analyze_traces.main([a, b, "--all-ops", "--charts",
                                str(charts)]) == 0
    out = capsys.readouterr().out
    assert out.count("temporal: compute 0.0%") == 2
    assert "op diff (all ops)" in out and "(no differences)" in out


def test_analyze_traces_charts_need_matplotlib(capsys, tmp_path,
                                               monkeypatch):
    a = _cpu_trace_dir(tmp_path / "a")
    real = analyze_traces.importlib.util.find_spec
    monkeypatch.setattr(
        analyze_traces.importlib.util, "find_spec",
        lambda name, *rest: None if name == "matplotlib" else real(
            name, *rest))
    with pytest.raises(SystemExit, match="needs matplotlib"):
        analyze_traces.main([a, "--charts", str(tmp_path / "charts")])
    captured = capsys.readouterr()
    assert "temporal: compute" in captured.out  # the report still ran
    assert "runs without charts" in captured.err
    assert not (tmp_path / "charts").exists()
