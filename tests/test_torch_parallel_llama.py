"""The port's data-parallel steps against the JAX package's, Llama with
grouped-query attention (4 heads over 2 KV heads), the cases and
tolerances of ``test_torch_parallel.py`` (``_torch_parallel_cases``):
each strategy at data 2, fsdp 2 and data 2 x fsdp 2, three steps at
A = 2, clip 1.0, f32; naive attention and ``dots`` remat here (GPT-2's
file takes flash and ``names``), so ZeRO-3's per-layer gathers run again
in a second remat mode's backward.
"""

import threading

import pytest

from _torch_dist_worker import launch
from _torch_parallel_cases import (
    CASE_IDS,
    CASES,
    assert_case_matches,
    assert_numel_matches,
    run_jax_case,
    write_inputs,
)

MODEL_KW = dict(family="llama", vocab_size=97, n_ctx=32, n_embd=32,
                n_layer=2, n_head=4, n_kv_head=2, n_inner=48,
                dtype="float32", embd_pdrop=0.0, attn_pdrop=0.0,
                resid_pdrop=0.0, attention_impl="naive", remat="dots")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    workdir = tmp_path_factory.mktemp("parallel_llama")
    params, batches = write_inputs(workdir, MODEL_KW)
    result: dict = {}
    ranks = threading.Thread(target=lambda: result.update(
        port=launch("parallel", 4, workdir)))
    ranks.start()
    jax_runs = {c["name"]: run_jax_case(MODEL_KW, c, params, batches)
                for c in CASES}
    ranks.join()
    assert "port" in result, "the port's ranks did not finish"
    return workdir, jax_runs


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_llama_strategy_matches_jax(runs, case):
    workdir, jax_runs = runs
    assert_case_matches(workdir, case["name"], jax_runs[case["name"]])


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_llama_shard_element_counts_match_jax(runs, case):
    workdir, jax_runs = runs
    n = 4 if case["group"] == "world" else 2
    assert_numel_matches(workdir, case["name"], jax_runs[case["name"]], n)
