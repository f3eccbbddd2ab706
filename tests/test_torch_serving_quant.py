"""int8 serving in the port against the JAX package's, on the CPU.

Weights are made by the JAX ``init`` and converted with
``interop.params_from_jax``; int8 weights on the JAX side come from its
``quantize_decode_params``, on the port's side from its own (bit-equal,
``tests/test_torch_quant.py``). f32 on the CPU, tiny gpt2 and llama
configs:

- one int8 ``decode.forward`` (a prefill chunk, then 3 decode steps)
  matches JAX's ``forward(kv_quant="int8")``: logits within atol = rtol =
  1e-4 (summation order); the int8 pools equal on all but <= 1e-3 of
  their entries, which differ by exactly 1 (an f32 K/V an ulp apart can
  land on the other side of a .5 rounding tie); the scale pools within
  rtol 1e-6;
- the int8 engine's greedy tokens equal the JAX int8
  ``PagedBatchedDecodeEngine``'s on a 6-request mix with a prefix hit and
  preemptions;
- ``Q8_QUALITY`` holds teacher-forced, as in the JAX package's
  ``tests/test_serving_quant.py``;
- the pool's bytes follow ``kv_bytes_per_position``, preemption under
  int8 is token-identical, and bad quant arguments raise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_tpu.config import ModelConfig as JaxModelConfig
from pytorch_distributed_tpu.models import decode as jdecode
from pytorch_distributed_tpu.models import get_model as jax_get_model
from pytorch_distributed_tpu.ops import quant as jq
from pytorch_distributed_tpu.serving.engine import (
    PagedBatchedDecodeEngine as JaxEngine,
)
from pytorch_distributed_tpu_torch import interop
from pytorch_distributed_tpu_torch.config import ModelConfig
from pytorch_distributed_tpu_torch.models import decode
from pytorch_distributed_tpu_torch.ops import quant
from pytorch_distributed_tpu_torch.serving import PagedBatchedDecodeEngine
from pytorch_distributed_tpu_torch.serving.engine import kv_bytes_per_position

ENGINE_KW = dict(slots=3, max_len=32, page_size=8, prefill_chunk=8)
Q8 = dict(kv_quant="int8", weight_quant="int8")


def _cfg_kw(family):
    kw = dict(family=family, vocab_size=97, n_ctx=64, n_embd=64, n_layer=2,
              n_head=4, dtype="float32", attn_pdrop=0.0, resid_pdrop=0.0,
              embd_pdrop=0.0)
    if family == "llama":
        kw.update(n_kv_head=2, activation_function="silu")
    return kw


@pytest.fixture(scope="module", params=["gpt2", "llama"])
def weights(request):
    jcfg = JaxModelConfig(**_cfg_kw(request.param))
    jparams = jax_get_model(jcfg).init(jax.random.key(0), jcfg)
    pcfg = ModelConfig(**_cfg_kw(request.param))
    return jcfg, jparams, pcfg, interop.params_from_jax(
        jax.device_get(jparams), pcfg
    )


def _assert_pools_close(ours: np.ndarray, theirs: np.ndarray) -> None:
    diff = ours.astype(np.int32) - theirs.astype(np.int32)
    off = diff != 0
    assert off.mean() <= 1e-3, off.mean()
    assert np.abs(diff).max(initial=0) <= 1


@pytest.mark.parametrize("impl", ["gather", "kernel"])
def test_int8_forward_matches_jax(weights, impl):
    jcfg, jparams, pcfg, params = weights
    jqp = jq.quantize_decode_params(jparams)
    qparams = quant.quantize_decode_params(params)
    page, pool_pages = 4, 13
    tables = np.array([[1, 2, 3, 4], [5, 6, 7, 8], [9, 10, 11, 12]], np.int32)
    plens = np.array([8, 5, 3], np.int32)
    prompt = np.random.default_rng(0).integers(0, 97, (3, 8)).astype(np.int32)
    jcache = jdecode.init_paged_cache(jcfg, pool_pages, page, kv_quant="int8")
    pcache = decode.init_paged_cache(pcfg, pool_pages, page, device="cpu",
                                     kv_quant="int8")
    assert {k: v.dtype for k, v in pcache.items()} == {
        "k": torch.int8, "v": torch.int8, "k_scale": torch.float32,
        "v_scale": torch.float32,
    }

    def step(ids, pos, jcache):
        jlog, jcache = jdecode.forward(
            jqp, jnp.asarray(ids), jcfg, jcache, jnp.asarray(pos),
            block_tables=jnp.asarray(tables), paged_impl="gather",
            kv_quant="int8",
        )
        plog, _ = decode.forward(
            qparams, torch.from_numpy(ids), pcfg, pcache,
            torch.from_numpy(pos), block_tables=torch.from_numpy(tables),
            paged_impl=impl, kv_quant="int8",
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
        _assert_pools_close(pcache[leaf].numpy(), np.asarray(jcache[leaf]))
    for leaf in ("k_scale", "v_scale"):
        np.testing.assert_allclose(pcache[leaf].numpy(),
                                   np.asarray(jcache[leaf]), rtol=1e-6,
                                   atol=0)


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
def test_int8_engine_token_equal_to_jax_engine(weights, paged_attention):
    jcfg, jparams, pcfg, params = weights
    want_eng = JaxEngine(jcfg, pool_pages=6, paged_attention="gather",
                         **Q8, **ENGINE_KW)
    want = want_eng.run(jparams, _greedy_mix())
    eng = PagedBatchedDecodeEngine(pcfg, pool_pages=6, device="cpu",
                                   paged_attention=paged_attention, **Q8,
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
    # The placed weights stay int8 on the device, their scales in the
    # activation dtype.
    blocks = eng._place_params(params)["blocks"][0]
    w = (blocks["attn"]["c_attn"]["kernel"] if pcfg.family == "gpt2"
         else blocks["attn"]["wq"])
    assert w["q8"].dtype == torch.int8 and w["scale"].dtype == torch.float32


def test_quality_budget_held_teacher_forced(weights):
    """Serve a greedy stream from the unquantized engine, then run its
    sequences teacher-forced through ``decode.forward`` with f32 weights
    and pool and with int8 weights and pool: both ``Q8_QUALITY`` budgets
    hold over the generated region (the JAX package's contract)."""
    _, _, pcfg, params = weights
    reqs = [dict(prompt=_prompt(5, 1), max_new_tokens=6),
            dict(prompt=_prompt(8, 2), max_new_tokens=7),
            dict(prompt=_prompt(13, 3), max_new_tokens=4)]
    out = PagedBatchedDecodeEngine(pcfg, device="cpu", **ENGINE_KW).run(
        params, reqs)
    seqs = [np.asarray(out[rid].tokens, np.int32)[:-1] for rid in out]
    t_max = max(len(s) for s in seqs)
    batch = np.zeros((len(seqs), t_max), np.int32)
    for i, s in enumerate(seqs):
        batch[i, : len(s)] = s
    n_pp = -(-t_max // 8)
    tables = torch.arange(1, 1 + len(seqs) * n_pp,
                          dtype=torch.int32).reshape(len(seqs), n_pp)
    pos = torch.zeros(len(seqs), dtype=torch.int32)
    logits = {}
    for kv_quant, p in (("none", params),
                        ("int8", quant.quantize_decode_params(params))):
        cache = decode.init_paged_cache(pcfg, len(seqs) * n_pp + 1, 8,
                                        device="cpu", kv_quant=kv_quant)
        logits[kv_quant], _ = decode.forward(
            p, torch.from_numpy(batch), pcfg, cache, pos,
            block_tables=tables, kv_quant=kv_quant,
        )
    agree, mse = [], []
    for i, req in enumerate(reqs):
        g0, g1 = len(req["prompt"]) - 1, len(seqs[i])
        ref, got = (logits[k][i, g0:g1].numpy() for k in ("none", "int8"))
        agree.append(quant.argmax_agreement(ref, got))
        mse.append(quant.relative_logit_mse(ref, got))
    assert np.mean(agree) >= quant.Q8_QUALITY["min_token_match_rate"]
    assert np.mean(mse) <= quant.Q8_QUALITY["max_relative_logit_mse"]
    assert np.mean(mse) > 0  # the int8 path did quantize


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pool_bytes_follow_kv_bytes_per_position_and_stats_report(dtype):
    cfg = ModelConfig(**{**_cfg_kw("gpt2"), "dtype": dtype})
    plain = PagedBatchedDecodeEngine(cfg, device="cpu", **ENGINE_KW)
    q8 = PagedBatchedDecodeEngine(cfg, device="cpu", kv_quant="int8",
                                  **ENGINE_KW)
    ratio = (q8.cache_hbm_bytes()["allocated"]
             / plain.cache_hbm_bytes()["allocated"])
    assert ratio == (kv_bytes_per_position(cfg, "int8")
                     / kv_bytes_per_position(cfg))
    # head_dim 16: (16 + 4) / (16 x itemsize).
    assert ratio == {"float32": 0.3125, "bfloat16": 0.625}[dtype]
    real = sum(t.numel() * t.element_size() for t in q8._cache.values())
    assert real == q8.cache_hbm_bytes()["allocated"]
    st = q8.stats()
    assert st["kv_quant"] == "int8" and st["weight_quant"] == "none"
    assert plain.stats()["kv_quant"] == "none"


def test_preemption_resume_token_identical_q8(weights):
    """A pool too small for both rows preempts one; its re-prefill
    quantizes the same tokens into fresh pages bit-identically, so its
    tokens equal an undisturbed int8 run's (greedy and sampled)."""
    _, _, pcfg, params = weights
    reqs = [dict(prompt=_prompt(14, 1), max_new_tokens=10),
            dict(prompt=_prompt(15, 2), max_new_tokens=10, temperature=0.8,
                 top_k=9, seed=5)]
    kw = dict(device="cpu", **Q8, **{**ENGINE_KW, "slots": 2})
    ref = PagedBatchedDecodeEngine(pcfg, **kw).run(params, reqs)
    tight = PagedBatchedDecodeEngine(pcfg, pool_pages=6, **kw)
    out = tight.run(params, reqs)
    assert tight.counters["preemptions"] >= 1
    for rid in (0, 1):
        assert out[rid].state == "DONE"
        np.testing.assert_array_equal(out[rid].tokens, ref[rid].tokens)


def test_quant_arguments_are_checked():
    cfg = ModelConfig(**_cfg_kw("gpt2"))
    for kw in (dict(kv_quant="fp8"), dict(weight_quant="int4")):
        with pytest.raises(ValueError, match="must be 'none' or 'int8'"):
            PagedBatchedDecodeEngine(cfg, device="cpu", **kw, **ENGINE_KW)
    with pytest.raises(ValueError, match="kv_quant"):
        decode.init_paged_cache(cfg, 5, 4, device="cpu", kv_quant="int4")
    params = {"wte": torch.zeros(97, 64), "wpe": torch.zeros(64, 64),
              "blocks": [], "ln_f": {}}
    ids = torch.zeros(2, 1, dtype=torch.int32)
    pos = torch.zeros(2, dtype=torch.int32)
    tables = torch.zeros(2, 4, dtype=torch.int32)
    for cache_quant, fwd_quant in (("none", "int8"), ("int8", "none")):
        cache = decode.init_paged_cache(cfg, 5, 4, device="cpu",
                                        kv_quant=cache_quant)
        with pytest.raises(ValueError, match="cache layout"):
            decode.forward(params, ids, cfg, cache, pos, block_tables=tables,
                           kv_quant=fwd_quant)
    moe = ModelConfig(**{**_cfg_kw("gpt2"), "n_experts": 2})
    with pytest.raises(NotImplementedError, match="MoE"):
        PagedBatchedDecodeEngine(moe, device="cpu", **Q8, **ENGINE_KW)
