"""The ``decode_bench`` twin's remaining modes on the CPU: each leg runs
under ``--dryrun --device cpu``, exits 0, carries the JAX script's row keys
(less ``roofline``: the port compiles no program to analyse) and holds the
checks the JAX legs assert.

The serving legs' clock is replaced by a counter that advances 1 ms per
read, as in ``tests/test_torch_decode_bench.py``; the non-serving benches
divide by time differences and keep the host clock.
"""

import importlib.util
import itertools
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from pytorch_distributed_tpu_torch.serving import decode_bench

ROOT = Path(__file__).resolve().parent.parent

# The JAX rows' keys (scripts/decode_bench.py), nested legs by name.
LEG = ("steady_tokens_per_sec", "p50_request_ms", "p99_request_ms",
       "observed_compile_count_steady")
JAX_KEYS = {
    # bench_serving, :458-477 and its _leg_row, :429-444
    "serving_stream": dict(
        top=("leg", "model", "batch", "max_new", "requests_per_pass",
             "distinct_prompt_lengths_per_pass", "sampling_configs",
             "steady_passes", "buckets", "engine", "legacy", "platform"),
        engine=("observed_compile_count_cold", "observed_compile_count_steady",
                "stream_seconds_cold", "steady_tokens_per_sec",
                "repeat_stream_tokens_per_sec", "p50_request_ms",
                "cache_hbm_bytes", "cache_hbm_bytes_peak_in_use"),
        legacy=("observed_compile_count_cold",
                "observed_compile_count_steady", "stream_seconds_cold",
                "steady_tokens_per_sec", "repeat_stream_tokens_per_sec",
                "p50_request_ms")),
    # bench_serving_batched, :782-809
    "serving_batched_stream": dict(
        top=("leg", "model", "slots", "max_new", "max_len", "requests",
             "buckets", "sampling_configs", "mean_interarrival_ms",
             "arrival_process", "serial", "batched", "aggregate_speedup",
             "platform"),
        serial=LEG, batched=LEG + ("cache_hbm_bytes",)),
    # bench_serving_chaos, :2006-2037
    "serving_batched_chaos": dict(
        top=("leg", "model", "slots", "max_new", "max_len", "requests",
             "buckets", "chaos_seed", "mean_interarrival_ms",
             "fault_probabilities", "fault_counts", "clean", "chaos",
             "goodput_retention", "platform"),
        clean=("goodput_tokens_per_sec", "p50_request_ms", "p99_request_ms",
               "terminal_states", "dispatch_failures", "resumes",
               "nan_quarantines", "observed_compile_count_steady")),
    # bench_serving_quant, :1534-1567
    "serving_quant_stream": dict(
        top=("leg", "model", "slots", "max_new", "max_len", "page_size",
             "prefill_chunk", "requests", "shared_prefix_tokens", "seed",
             "sampling", "mean_interarrival_ms", "bytes_per_position", "f32",
             "int8", "int8_equal_bytes", "page_pool_hbm_ratio",
             "equal_bytes_speedup", "quality", "platform"),
        f32=("kv_quant", "weight_quant", "pool_pages") + LEG + (
            "cache_hbm_bytes", "cache_hbm_bytes_peak_in_use", "preemptions"),
        quality=("greedy_token_match_rate", "relative_logit_mse",
                 "autoregressive_prefix_match_rate", "probe_requests",
                 "budget")),
    # bench_serving_spec's run_pair, :1743-1784
    "serving_spec_repetitive": dict(
        top=("leg", "model", "slots", "max_len", "max_new", "page_size",
             "prefill_chunk", "pool_pages", "requests", "speculative_k",
             "spec_ngram", "seed", "plain", "speculative", "spec_extras",
             "aggregate_speedup", "outputs_match", "platform"),
        plain=LEG, speculative=LEG,
        spec_extras=("drafted_tokens", "accepted_tokens", "spec_accept_rate",
                     "mean_accepted_len_per_commit", "decode_ticks_plain",
                     "decode_ticks_spec")),
    # bench_decode, :133-148
    "decode": dict(top=(
        "preset", "n_experts", "moe_top_k", "batch", "prompt_len",
        "incremental_tokens_per_sec", "per_sequence_tokens_per_sec",
        "spread", "platform")),
    # bench_speculative, :223-239
    "speculative": dict(top=(
        "preset", "mode", "n_experts", "moe_top_k", "draft_len", "ngram",
        "max_new", "plain_tokens_per_sec", "speculative_tokens_per_sec",
        "speedup", "outputs_match", "platform")),
}
JAX_KEYS["serving_spec_low_repetition"] = dict(
    JAX_KEYS["serving_spec_repetitive"],
    top=JAX_KEYS["serving_spec_repetitive"]["top"]
    + ("regression_bound_note",))


def _has_jax_keys(row, kind):
    for part, keys in JAX_KEYS[kind].items():
        got = row if part == "top" else row[part]
        missing = set(keys) - set(got)
        assert not missing, f"{kind}.{part} lacks {sorted(missing)}"
    assert "roofline" not in json.dumps(row)
    assert set(row["launches"]) == {"K3", "K4", "lora"}


@pytest.fixture
def step_clock(monkeypatch):
    ticks = itertools.count()
    monkeypatch.setattr(decode_bench, "_now", lambda: next(ticks) * 1e-3)


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _run(capsys, *flags):
    assert decode_bench.main([*flags, "--dryrun", "--device", "cpu"]) == 0
    return [json.loads(line) for line in capsys.readouterr().out.splitlines()
            if line.startswith("{")]


def test_serving_leg(capsys, step_clock):
    assert decode_bench.main(["--serving", "--dryrun", "--device",
                              "cpu"]) == 0
    out, err = capsys.readouterr()
    (row,) = [json.loads(x) for x in out.splitlines() if x.startswith("{")]
    assert "zero3_decode skipped" in err
    _has_jax_keys(row, "serving_stream")
    assert row["leg"] == "serving_stream" and row["platform"] == "cpu"
    for path in ("engine", "legacy"):
        assert row[path]["observed_compile_count_steady"] == 0
        assert row[path]["steady_tokens_per_sec"] > 0
    assert row["distinct_prompt_lengths_per_pass"] == row[
        "requests_per_pass"] == 8
    assert row["engine"]["cache_hbm_bytes"] > 0
    assert row["launches"] == {"K3": 0, "K4": 0, "lora": 0}


def test_serving_batched_leg(capsys, step_clock):
    (row,) = _run(capsys, "--serving-batched")
    _has_jax_keys(row, "serving_batched_stream")
    for leg in ("serial", "batched"):
        assert row[leg]["observed_compile_count_steady"] == 0
        assert row[leg]["p99_request_ms"] >= row[leg]["p50_request_ms"]
    assert row["requests"] == 16 and row["slots"] == 4


def test_serving_chaos_leg(capsys, step_clock):
    (row,) = _run(capsys, "--serving-batched", "--chaos")
    _has_jax_keys(row, "serving_batched_chaos")
    assert row["clean"]["terminal_states"] == {"DONE": 16}
    assert sum(row["chaos"]["terminal_states"].values()) == 16
    assert all(row["fault_counts"][k] > 0
               for k in ("dispatch_error", "drop_result", "nan_row"))
    for leg in ("clean", "chaos"):
        assert row[leg]["observed_compile_count_steady"] == 0
    assert 0 < row["goodput_retention"] <= 1.5


def test_serving_spec_legs(capsys, step_clock):
    rows = _run(capsys, "--serving-spec")
    assert [r["leg"] for r in rows] == ["serving_spec_repetitive",
                                        "serving_spec_low_repetition"]
    for row in rows:
        _has_jax_keys(row, row["leg"])
        assert row["invariant_failures"] == []
        assert row["outputs_match"] == "12/12"
        assert row["plain"]["observed_compile_count_steady"] == 0
        assert row["speculative"]["observed_compile_count_steady"] == 0
    rep, low = rows
    pairs = rep["aggregate_speedup_pairs"]
    assert len(pairs) == decode_bench.SPEC_PAIRS
    assert rep["aggregate_speedup"] == float(np.median(pairs))
    assert rep["aggregate_speedup_single_pass"] == pairs[0]
    assert rep["spec_extras"]["accepted_tokens"] > 0
    assert low["spec_extras"]["drafted_tokens"] == 0
    assert rep["speculative_k"] == 4 and rep["spec_ngram"] == 1


def test_serving_quant_leg(capsys, step_clock):
    from pytorch_distributed_tpu_torch.ops.quant import Q8_QUALITY

    (row,) = _run(capsys, "--serving-paged", "--kv-quant", "int8",
                  "--weight-quant", "int8")
    _has_jax_keys(row, "serving_quant_stream")
    assert row["invariant_failures"] == []
    q = row["quality"]
    assert q["greedy_token_match_rate"] >= Q8_QUALITY["min_token_match_rate"]
    assert q["relative_logit_mse"] <= Q8_QUALITY["max_relative_logit_mse"]
    for leg in ("f32", "int8", "int8_equal_bytes"):
        assert row[leg]["observed_compile_count_steady"] == 0
    assert row["int8"]["kv_quant"] == "int8"
    assert row["int8"]["weight_quant"] == "int8"
    assert row["f32"]["weight_quant"] == "none"
    assert row["int8"]["pool_pages"] == row["f32"]["pool_pages"]
    assert row["int8_equal_bytes"]["pool_pages"] > row["f32"]["pool_pages"]
    bpp = row["bytes_per_position"]
    assert row["page_pool_hbm_ratio"] == round(bpp["int8"] / bpp["f32"], 4)


def test_default_mode_over_both_presets(capsys):
    rows = _run(capsys, "--batch", "2", "--n1", "4", "--n2", "12",
                "--repeats", "2")
    assert [r["preset"] for r in rows] == ["gpt2", "llama3-1b"]
    for row in rows:
        _has_jax_keys(row, "decode")
        assert row["incremental_tokens_per_sec"] > 0
        assert row["n_experts"] == 0 and row["moe_top_k"] is None


def test_default_mode_moe(capsys):
    (row,) = _run(capsys, "--preset", "gpt2", "--batch", "2", "--n1", "4",
                  "--n2", "8", "--repeats", "1", "--n-experts", "4",
                  "--moe-top-k", "2")
    assert row["n_experts"] == 4 and row["moe_top_k"] == 2
    assert row["incremental_tokens_per_sec"] > 0


def _speedup_agrees(row):
    """speedup = med_plain / med_spec = speculative tok/s / plain tok/s,
    all three rounded from the same pair of medians."""
    plain, spec = row["plain_tokens_per_sec"], row["speculative_tokens_per_sec"]
    ratio = spec / plain
    slack = 5e-4 + ratio * (0.05 / plain + 0.05 / spec)
    assert row["speedup"] == pytest.approx(ratio, abs=slack)


def test_speculative_mode(capsys):
    rows = _run(capsys, "--speculative", "4", "--max-new", "24",
                "--prompt-len", "8", "--repeats", "2")
    assert [r["preset"] for r in rows] == ["gpt2", "llama3-1b"]
    for row in rows:
        _has_jax_keys(row, "speculative")
        assert row["mode"] == "speculative" and row["ngram"] == 2
        assert row["draft_len"] == 4
        _speedup_agrees(row)


def test_jax_speculative_row_agrees_the_same_way():
    spec = importlib.util.spec_from_file_location(
        "jax_decode_bench", ROOT / "scripts" / "decode_bench.py")
    jdb = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jdb)
    row = jdb.bench_speculative("tiny", 8, 16, 4, 2, 2)
    assert set(row) == set(JAX_KEYS["speculative"]["top"])
    _speedup_agrees(row)


@pytest.mark.parametrize("argv, message", [
    (["--chaos"], "--chaos requires --serving-batched"),
    (["--kv-quant", "int8"], "--kv-quant requires --serving-paged"),
    (["--serving-paged", "--weight-quant", "int8"],
     "pass --kv-quant int8 too"),
])
def test_jax_parse_errors_are_kept(capsys, argv, message):
    with pytest.raises(SystemExit) as exc:
        decode_bench.parse_args(argv)
    assert exc.value.code == 2
    assert message in capsys.readouterr().err
