"""The port's GPT-2 weights and paged forward against the JAX package's.

Weights are made by the JAX ``gpt2.init`` and converted with
``interop.params_from_jax``; the same seeded token ids go through the JAX
``decode.forward`` (paged, gather path) and the port's — one prefill
chunk, then three single-token steps with per-row positions. f32 on the
CPU, where only summation order differs: logits atol = rtol = 1e-4, the
written pool pages atol = rtol = 1e-5 with exactly the same positions
written (unwritten positions stay exactly zero on both sides).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_tpu.config import ModelConfig as JaxModelConfig
from pytorch_distributed_tpu.models import decode as jdecode
from pytorch_distributed_tpu.models import gpt2 as jgpt2
from pytorch_distributed_tpu_torch import interop
from pytorch_distributed_tpu_torch.config import ModelConfig, model_config
from pytorch_distributed_tpu_torch.models import decode, get_model, gpt2

CFG_KW = dict(
    vocab_size=97, n_ctx=64, n_embd=64, n_layer=2, n_head=4,
    dtype="float32", attn_pdrop=0.0, resid_pdrop=0.0, embd_pdrop=0.0,
)


def _jax_params(seed=0):
    cfg = JaxModelConfig(**CFG_KW)
    return cfg, jax.device_get(jgpt2.init(jax.random.key(seed), cfg))


def test_config_matches_jax_field_for_field():
    for name in ("gpt2", "tiny", "gpt2-medium", "llama3-1b"):
        from pytorch_distributed_tpu.config import model_config as jmc

        ours, theirs = model_config(name), jmc(name)
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
        assert (ours.head_dim, ours.kv_heads, ours.inner_dim) == (
            theirs.head_dim, theirs.kv_heads, theirs.inner_dim
        )
    assert model_config("gpt2", dtype="float32").replace(n_layer=2).n_layer == 2
    with pytest.raises(KeyError, match="unknown model preset"):
        model_config("gpt5")
    with pytest.raises(ValueError, match="not divisible"):
        ModelConfig(n_embd=10, n_head=3)


def test_interop_round_trips_the_jax_tree_exactly():
    cfg, tree = _jax_params()
    port = interop.params_from_jax(tree, ModelConfig(**CFG_KW))
    assert len(port["blocks"]) == cfg.n_layer
    np.testing.assert_array_equal(
        port["blocks"][1]["attn"]["c_attn"]["kernel"].numpy(),
        tree["blocks"]["attn"]["c_attn"]["kernel"][1],
    )
    back = interop.params_to_jax(port, ModelConfig(**CFG_KW))
    flat_a = jax.tree_util.tree_leaves_with_path(tree)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(flat_b[path], leaf, err_msg=str(path))


def test_init_has_the_jax_layout_and_gpt2_distributions():
    pcfg = ModelConfig(**CFG_KW)
    ours = gpt2.init(torch.Generator().manual_seed(0), pcfg, device="cpu")
    _, tree = _jax_params()
    as_jax = interop.params_to_jax(ours, pcfg)
    for (path, a), (_, b) in zip(
        jax.tree_util.tree_leaves_with_path(as_jax),
        jax.tree_util.tree_leaves_with_path(tree),
    ):
        assert a.shape == b.shape and a.dtype == b.dtype, path
    assert abs(float(ours["wte"].std()) - 0.02) < 2e-3
    assert abs(float(ours["wpe"].std()) - 0.01) < 1e-3
    assert float(ours["blocks"][0]["ln_1"]["scale"].min()) == 1.0
    again = gpt2.init(torch.Generator().manual_seed(0), pcfg, device="cpu")
    torch.testing.assert_close(again["wte"], ours["wte"], rtol=0, atol=0)


def test_head_accumulates_and_returns_f32_for_bf16_activations():
    pcfg = ModelConfig(**{**CFG_KW, "dtype": "bfloat16"})
    params = gpt2.init(torch.Generator().manual_seed(1), pcfg, device="cpu")
    x = torch.randn(2, 3, 64, generator=torch.Generator().manual_seed(2))
    logits = gpt2.head(params, x.to(torch.bfloat16), pcfg)
    assert logits.dtype == torch.float32
    xn = gpt2.final_norm(params, x.to(torch.bfloat16), pcfg)
    want = xn.float() @ params["wte"].to(torch.bfloat16).float().t()
    torch.testing.assert_close(logits, want, rtol=0, atol=0)


def test_get_model_serves_gpt2_only():
    """gpt2 is the one family with every entry point; llama serves (its
    head) but does not train yet: its ``apply`` raises."""
    assert get_model(ModelConfig(**CFG_KW)).head is gpt2.head
    from pytorch_distributed_tpu_torch.models import llama

    api = get_model(model_config("llama3-1b"))
    assert api.head is llama.head
    with pytest.raises(NotImplementedError, match="not ported"):
        api.apply({}, torch.zeros(1, 1, dtype=torch.long),
                  model_config("llama3-1b"))


@pytest.mark.parametrize("impl", ["gather", "kernel"])
def test_paged_forward_matches_jax(impl):
    """Prefill chunk (T=8) for 3 rows whose prompts are 8, 5 and 3 tokens,
    then 3 decode steps, each row at its own position, over a shared
    paged pool with distinct per-row pages."""
    jcfg, tree = _jax_params(seed=3)
    pcfg = ModelConfig(**CFG_KW)
    params = interop.params_from_jax(tree, pcfg)
    rng = np.random.default_rng(0)
    page, n_pages, pool_pages = 4, 4, 13
    tables = np.array(
        [[1, 2, 3, 4], [5, 6, 7, 8], [9, 10, 11, 12]], np.int32
    )
    plens = np.array([8, 5, 3], np.int32)
    prompt = rng.integers(0, 97, (3, 8)).astype(np.int32)

    jcache = jdecode.init_paged_cache(jcfg, pool_pages, page)
    pcache = decode.init_paged_cache(pcfg, pool_pages, page, device="cpu")
    jparams = jax.tree.map(jnp.asarray, tree)

    def step(ids, pos, jcache):
        jl, jcache = jdecode.forward(
            jparams, jnp.asarray(ids), jcfg, jcache, jnp.asarray(pos),
            block_tables=jnp.asarray(tables), paged_impl="gather",
        )
        pl, _ = decode.forward(
            params, torch.from_numpy(ids), pcfg, pcache,
            torch.from_numpy(pos), block_tables=torch.from_numpy(tables),
            paged_impl=impl,
        )
        assert pl.dtype == torch.float32
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl),
                                   atol=1e-4, rtol=1e-4)
        return np.asarray(jl), jcache

    logits, jcache = step(prompt, np.zeros(3, np.int32), jcache)
    toks = logits[np.arange(3), plens - 1].argmax(-1).astype(np.int32)
    pos = plens.copy()
    for _ in range(3):
        logits, jcache = step(toks[:, None], pos, jcache)
        toks = logits[:, -1].argmax(-1).astype(np.int32)
        pos = pos + 1
    for leaf in ("k", "v"):
        ours, theirs = pcache[leaf].numpy(), np.asarray(jcache[leaf])
        np.testing.assert_array_equal(ours == 0, theirs == 0)
        np.testing.assert_allclose(ours, theirs, atol=1e-5, rtol=1e-5)


def test_forward_rejects_scalar_pos_and_unknown_impl():
    pcfg = ModelConfig(**CFG_KW)
    params = gpt2.init(torch.Generator().manual_seed(0), pcfg, device="cpu")
    cache = decode.init_paged_cache(pcfg, 5, 4, device="cpu")
    ids = torch.zeros(2, 1, dtype=torch.int32)
    tables = torch.zeros(2, 4, dtype=torch.int32)
    with pytest.raises(ValueError, match="per-row"):
        decode.forward(params, ids, pcfg, cache, torch.tensor(0),
                       block_tables=tables)
    with pytest.raises(ValueError, match="paged_impl"):
        decode.forward(params, ids, pcfg, cache,
                       torch.zeros(2, dtype=torch.int32),
                       block_tables=tables, paged_impl="kernel_interpret")


def test_init_and_cache_default_to_the_gpu():
    """``device=None`` means "cuda" for the model's public constructors, as
    for the engine; without CUDA it raises rather than run on the CPU."""
    pcfg = ModelConfig(**CFG_KW)
    if torch.cuda.is_available():
        assert gpt2.init(torch.Generator(), pcfg)["wte"].is_cuda
        assert decode.init_paged_cache(pcfg, 5, 4)["k"].is_cuda
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        gpt2.init(torch.Generator().manual_seed(0), pcfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        decode.init_paged_cache(pcfg, 5, 4)


def test_sampling_matches_jax_filters_and_is_a_function_of_seed():
    """Greedy rows take the argmax; top_k=1 and top_p->0 reduce a sampled
    row to greedy (as in the JAX sampler); a sampled row's draw depends
    only on (seed, index) and its logits."""
    logits = torch.randn(4, 97, generator=torch.Generator().manual_seed(4))
    greedy_tok = logits.argmax(-1)
    t, k, p = decode.sampling_scalars(0.7, 1, None, 97)
    out = decode.sample_token_rows(logits, [False] * 4, [t] * 4, [k] * 4,
                                   [p] * 4, [11, 12, 13, 14])
    torch.testing.assert_close(out, greedy_tok)
    t, k, p = decode.sampling_scalars(1.3, None, 1e-6, 97)
    out = decode.sample_token_rows(logits, [False] * 4, [t] * 4, [k] * 4,
                                   [p] * 4, [1, 2, 3, 4])
    torch.testing.assert_close(out, greedy_tok)
    t, k, p = decode.sampling_scalars(1.0, 20, 0.9, 97)
    seeds = [decode.sample_seed(7, i) for i in range(4)]
    a = decode.sample_token_rows(logits, [False, True, False, True],
                                 [t] * 4, [k] * 4, [p] * 4, seeds)
    b = decode.sample_token_rows(logits[:1], [False], [t], [k], [p],
                                 seeds[:1])
    assert int(a[0]) == int(b[0])
    assert int(a[1]) == int(greedy_tok[1])
    top20 = set(torch.topk(logits[0], 20).indices.tolist())
    assert int(a[0]) in top20
    with pytest.raises(ValueError, match="top_k"):
        decode.sampling_scalars(1.0, -1, None, 97)


def test_nonfinite_rows():
    x = torch.zeros(3, 2, 5)
    x[1, 0, 2] = float("nan")
    x[2, 1, 4] = float("inf")
    assert decode.nonfinite_rows(x).tolist() == [False, True, True]
