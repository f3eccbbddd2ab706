"""The port's llama family against the JAX package's, on the CPU.

Weights are made by the JAX ``llama.init`` and converted with
``interop.params_from_jax``; the same seeded inputs go through both
sides. f32, where only the summation order of the two CPU backends
differs: rope and rms_norm within 1e-6, the paged forward's logits within
atol = rtol = 1e-4 and its written pools within 1e-5 (the same positions
written on both sides), and the engine's greedy tokens equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_tpu.config import ModelConfig as JaxModelConfig
from pytorch_distributed_tpu.models import decode as jdecode
from pytorch_distributed_tpu.models import llama as jllama
from pytorch_distributed_tpu.ops import layers as jl
from pytorch_distributed_tpu.ops import quant as jq
from pytorch_distributed_tpu.ops import rope as jrope
from pytorch_distributed_tpu.serving.engine import (
    PagedBatchedDecodeEngine as JaxEngine,
)
from pytorch_distributed_tpu_torch import interop
from pytorch_distributed_tpu_torch.config import ModelConfig
from pytorch_distributed_tpu_torch.models import decode, get_model, llama
from pytorch_distributed_tpu_torch.ops import layers as tl
from pytorch_distributed_tpu_torch.ops import rope as trope
from pytorch_distributed_tpu_torch.serving import PagedBatchedDecodeEngine

CFG_KW = dict(
    family="llama", vocab_size=97, n_ctx=64, n_embd=64, n_layer=2, n_head=4,
    n_kv_head=2, dtype="float32", attn_pdrop=0.0, resid_pdrop=0.0,
    embd_pdrop=0.0, activation_function="silu",
)
ENGINE_KW = dict(slots=3, max_len=32, page_size=8, prefill_chunk=8)


@pytest.fixture(scope="module")
def weights():
    jcfg = JaxModelConfig(**CFG_KW)
    jparams = jllama.init(jax.random.key(0), jcfg)
    pcfg = ModelConfig(**CFG_KW)
    return jcfg, jparams, pcfg, interop.params_from_jax(
        jax.device_get(jparams), pcfg
    )


@pytest.mark.parametrize("theta", [10000.0, 500000.0])
@pytest.mark.parametrize("head_dim", [16, 64])
def test_rope_matches_jax(head_dim, theta):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 2, head_dim)).astype(np.float32)
    offsets = np.array([[0], [7], [1000]], np.int32)
    for offset in (0, 9):
        jc, js = jrope.rope_angles(5, head_dim, theta, offset=offset)
        tc, ts = trope.rope_angles(5, head_dim, theta, offset=offset)
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-6,
                                   rtol=1e-6)
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-6,
                                   rtol=1e-6)
        np.testing.assert_allclose(
            trope.apply_rope(torch.from_numpy(x), tc, ts).numpy(),
            np.asarray(jrope.apply_rope(jnp.asarray(x), jc, js)),
            atol=1e-6, rtol=1e-6,
        )
    jc, js = jrope.rope_angles(5, head_dim, theta,
                               offset=jnp.asarray(offsets))
    tc, ts = trope.rope_angles(5, head_dim, theta,
                               offset=torch.from_numpy(offsets))
    assert tuple(tc.shape) == (3, 5, head_dim)
    got = trope.apply_rope(torch.from_numpy(x), tc, ts)
    want = jrope.apply_rope(jnp.asarray(x), jc, js)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=1e-6)
    # Row b of the per-row angles is the int-offset result for offset[b].
    c7, _ = trope.rope_angles(5, head_dim, theta, offset=7)
    torch.testing.assert_close(tc[1], c7, rtol=0, atol=0)


def test_apply_rope_keeps_bf16_dtype():
    x = torch.randn(2, 3, 4, 16).to(torch.bfloat16)
    c, s = trope.rope_angles(3, 16, 10000.0)
    out = trope.apply_rope(x, c, s)
    assert out.dtype == torch.bfloat16
    want = trope.apply_rope(x.float(), c, s).to(torch.bfloat16)
    assert torch.equal(out, want)


@pytest.mark.parametrize("eps", [1e-5, 1e-6])
def test_rms_norm_matches_jax(eps):
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((3, 7, 64)) * 2.0).astype(np.float32)
    scale = (rng.standard_normal(64) + 1.0).astype(np.float32)
    want = jl.rms_norm(jnp.asarray(x), {"scale": jnp.asarray(scale)},
                       eps=eps)
    got = tl.rms_norm(torch.from_numpy(x), {"scale": torch.from_numpy(scale)},
                      eps=eps)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=1e-6)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    assert tl.rms_norm(xb, {"scale": torch.ones(64)}, eps=eps).dtype == \
        torch.bfloat16


@pytest.mark.parametrize("quantized", [False, True])
def test_interop_round_trips_the_llama_tree_exactly(weights, quantized):
    jcfg, jparams, pcfg, _ = weights
    tree = jax.device_get(
        jq.quantize_decode_params(jparams) if quantized else jparams
    )
    port = interop.params_from_jax(tree, pcfg)
    assert set(port) == {"wte", "blocks", "ln_f", "lm_head"}
    assert len(port["blocks"]) == pcfg.n_layer
    wq = port["blocks"][1]["attn"]["wq"]
    want = tree["blocks"]["attn"]["wq"]
    if quantized:
        np.testing.assert_array_equal(wq["q8"].numpy(), want["q8"][1])
        np.testing.assert_array_equal(wq["scale"].numpy(), want["scale"][1])
    else:
        np.testing.assert_array_equal(wq.numpy(), want[1])
    back = interop.params_to_jax(port, pcfg)
    flat_a = jax.tree_util.tree_leaves_with_path(tree)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        assert flat_b[path].dtype == leaf.dtype, path
        np.testing.assert_array_equal(flat_b[path], leaf, err_msg=str(path))


def test_init_has_the_jax_layout_and_distributions(weights):
    _, jparams, pcfg, _ = weights
    ours = llama.init(torch.Generator().manual_seed(0), pcfg, device="cpu")
    as_jax = interop.params_to_jax(ours, pcfg)
    for (path, a), (_, b) in zip(
        jax.tree_util.tree_leaves_with_path(as_jax),
        jax.tree_util.tree_leaves_with_path(jax.device_get(jparams)),
    ):
        assert a.shape == b.shape and a.dtype == b.dtype, path
    assert abs(float(ours["lm_head"].std()) - 0.02) < 2e-3
    assert float(ours["blocks"][0]["ln_attn"]["scale"].min()) == 1.0
    again = llama.init(torch.Generator().manual_seed(0), pcfg, device="cpu")
    assert torch.equal(again["blocks"][1]["mlp"]["down"],
                       ours["blocks"][1]["mlp"]["down"])
    assert get_model(pcfg).init is llama.init
    with pytest.raises(ValueError, match="llama.init"):
        llama.init(torch.Generator(), ModelConfig(), device="cpu")


@pytest.mark.parametrize("logits_dtype", ["float32", "bfloat16"])
def test_head_matches_jax(weights, logits_dtype):
    jcfg, jparams, pcfg, params = weights
    x = np.random.default_rng(2).standard_normal((2, 3, 64)).astype(
        np.float32
    )
    want = jllama.head(jparams, jnp.asarray(x),
                       jcfg.replace(logits_dtype=logits_dtype))
    got = llama.head(params, torch.from_numpy(x),
                     pcfg.replace(logits_dtype=logits_dtype))
    assert str(got.dtype) == f"torch.{logits_dtype}"
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("impl", ["gather", "kernel"])
def test_paged_forward_matches_jax(weights, impl):
    """Prefill chunk (T=8) for 3 rows whose prompts are 8, 5 and 3 tokens,
    then 3 decode steps at per-row positions (RoPE angles per row)."""
    jcfg, jparams, pcfg, params = weights
    page, pool_pages = 4, 13
    tables = np.array([[1, 2, 3, 4], [5, 6, 7, 8], [9, 10, 11, 12]], np.int32)
    plens = np.array([8, 5, 3], np.int32)
    prompt = np.random.default_rng(0).integers(0, 97, (3, 8)).astype(np.int32)
    jcache = jdecode.init_paged_cache(jcfg, pool_pages, page)
    pcache = decode.init_paged_cache(pcfg, pool_pages, page, device="cpu")

    def step(ids, pos, jcache):
        jlog, jcache = jdecode.forward(
            jparams, jnp.asarray(ids), jcfg, jcache, jnp.asarray(pos),
            block_tables=jnp.asarray(tables), paged_impl="gather",
        )
        plog, _ = decode.forward(
            params, torch.from_numpy(ids), pcfg, pcache,
            torch.from_numpy(pos), block_tables=torch.from_numpy(tables),
            paged_impl=impl,
        )
        np.testing.assert_allclose(plog.numpy(), np.asarray(jlog),
                                   atol=1e-4, rtol=1e-4)
        return np.asarray(jlog), jcache

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


def _prompt(n, seed):
    return np.random.default_rng(seed).integers(0, 97, n).astype(np.int32)


def _greedy_mix():
    shared = _prompt(16, 42)
    return [
        dict(prompt=_prompt(14, 1), max_new_tokens=10),
        dict(prompt=np.concatenate([shared, _prompt(4, 7)]), max_new_tokens=6),
        dict(prompt=_prompt(8, 2), max_new_tokens=7),
        dict(prompt=np.concatenate([shared, _prompt(3, 8)]), max_new_tokens=5),
        dict(prompt=_prompt(5, 3), max_new_tokens=9),
        dict(prompt=_prompt(13, 4), max_new_tokens=4),
    ]


@pytest.mark.parametrize("paged_attention", ["gather", "kernel"])
def test_engine_greedy_tokens_equal_jax_engine(weights, paged_attention):
    """A 6-request mix with a prefix hit and preemptions (pool of 6 pages)
    on a GQA config (group 2)."""
    jcfg, jparams, pcfg, params = weights
    want_eng = JaxEngine(jcfg, pool_pages=6, paged_attention="gather",
                         **ENGINE_KW)
    want = want_eng.run(jparams, _greedy_mix())
    eng = PagedBatchedDecodeEngine(pcfg, pool_pages=6, device="cpu",
                                   paged_attention=paged_attention,
                                   **ENGINE_KW)
    got = eng.run(params, _greedy_mix())
    assert sorted(got) == sorted(want)
    for rid in want:
        assert want[rid].state == got[rid].state == "DONE"
        np.testing.assert_array_equal(got[rid].tokens,
                                      np.asarray(want[rid].tokens),
                                      err_msg=f"request {rid}")
    assert eng.counters["preemptions"] == want_eng.counters["preemptions"] >= 1
    assert eng.pool.stats["prefix_hits"] == \
        want_eng.pool.stats["prefix_hits"] >= 1
    placed = eng._place_params(params)
    assert set(placed) == {"wte", "ln_f", "head_w", "blocks"}
    assert placed["head_w"].dtype == torch.float32
