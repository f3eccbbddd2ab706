"""The port's dense-cache decode, serial engine and MoE decode against the
JAX package's, on the CPU.

Weights are made by the JAX ``init`` and converted with
``interop.params_from_jax``; the same seeded numpy token ids go through
the JAX function and the port's. f32 on the CPU, where only summation
order differs: logits atol = rtol = 1e-4, written cache positions
atol = rtol = 1e-5 (unwritten positions exactly zero on both sides),
greedy tokens equal. Sampled tokens cannot match JAX's threefry stream;
they are held to the port itself (the same seed gives the same tokens on
every path).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_tpu.config import ModelConfig as JaxModelConfig
from pytorch_distributed_tpu.models import decode as jdecode
from pytorch_distributed_tpu.models import get_model as jget_model
from pytorch_distributed_tpu.serving.engine import (
    DecodeEngine as JaxDecodeEngine,
)
from pytorch_distributed_tpu_torch import interop
from pytorch_distributed_tpu_torch.config import MeshConfig, ModelConfig
from pytorch_distributed_tpu_torch.models import decode
from pytorch_distributed_tpu_torch.serving.engine import (
    BatchedDecodeEngine,
    BucketSpec,
    DecodeEngine,
    PagedBatchedDecodeEngine,
    kv_bytes_per_position,
)
from pytorch_distributed_tpu_torch.serving.lifecycle import RequestFailed

LOGITS_TOL = dict(atol=1e-4, rtol=1e-4)
CACHE_TOL = dict(atol=1e-5, rtol=1e-5)


def _kw(family, **extra):
    kw = dict(family=family, vocab_size=97, n_ctx=64, n_embd=64, n_layer=2,
              n_head=4, dtype="float32", attn_pdrop=0.0, resid_pdrop=0.0,
              embd_pdrop=0.0)
    if family == "llama":
        kw["n_kv_head"] = 2
    kw.update(extra)
    return kw


def _weights(family, seed=0, **extra):
    kw = _kw(family, **extra)
    jcfg, pcfg = JaxModelConfig(**kw), ModelConfig(**kw)
    jparams = jget_model(jcfg).init(jax.random.key(seed), jcfg)
    params = interop.params_from_jax(jax.device_get(jparams), pcfg)
    return jcfg, jparams, pcfg, params


@pytest.fixture(scope="module", params=["gpt2", "llama"])
def weights(request):
    return _weights(request.param)


def _ids(shape, seed, vocab=97):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def _check_cache(pcache, jcache):
    for leaf in ("k", "v"):
        ours, theirs = pcache[leaf].numpy(), np.asarray(jcache[leaf])
        np.testing.assert_array_equal(ours == 0, theirs == 0)
        np.testing.assert_allclose(ours, theirs, **CACHE_TOL)


def test_dense_forward_scalar_pos_matches_jax(weights):
    """Prefill of [3, 8] at position 0, then three single-token steps with
    every row at one (scalar) position — the serial engine's shapes."""
    jcfg, jparams, pcfg, params = weights
    jcache = jdecode.init_cache(jcfg, 3, 16)
    pcache = decode.init_cache(pcfg, 3, 16, device="cpu")
    ids = _ids((3, 8), 1)
    pos = 0
    for _ in range(4):
        jl, jcache = jdecode.forward(jparams, jnp.asarray(ids), jcfg,
                                     jcache, pos)
        pl, _ = decode.forward(params, torch.from_numpy(ids), pcfg, pcache,
                               pos)
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl), **LOGITS_TOL)
        pos += ids.shape[1]
        ids = np.asarray(jl)[:, -1].argmax(-1).astype(np.int32)[:, None]
    _check_cache(pcache, jcache)


def test_dense_forward_per_row_pos_matches_jax(weights):
    """Rows at unrelated depths ([B] pos vector), one token each, then a
    per-row window of 4 tokens whose last lanes run past max_len on the
    deepest row: JAX drops those lanes (``mode="drop"``), and so must the
    port — never shifting the window onto committed positions."""
    jcfg, jparams, pcfg, params = weights
    s = 16
    jcache = jdecode.init_cache(jcfg, 3, s)
    pcache = decode.init_cache(pcfg, 3, s, device="cpu")
    for pos, ids in (
        (np.array([0, 0, 0], np.int32), _ids((3, 6), 2)),
        (np.array([6, 3, 5], np.int32), _ids((3, 1), 3)),
        (np.array([7, 4, 14], np.int32), _ids((3, 4), 4)),
    ):
        jl, jcache = jdecode.forward(jparams, jnp.asarray(ids), jcfg,
                                     jcache, jnp.asarray(pos))
        pl, _ = decode.forward(params, torch.from_numpy(ids), pcfg, pcache,
                               torch.from_numpy(pos))
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl), **LOGITS_TOL)
    _check_cache(pcache, jcache)


def test_dense_and_paged_forward_agree_bit_for_bit():
    """The dense layout and the paged layout run the same masked
    attention (``ops/paged_kernel.masked_attention``): the same rows at
    the same depths give the same logits, bit for bit, on the CPU."""
    _, _, pcfg, params = _weights("gpt2", seed=5)
    ids = torch.from_numpy(_ids((2, 8), 6))
    dense = decode.init_cache(pcfg, 2, 16, device="cpu")
    paged = decode.init_paged_cache(pcfg, 9, 4, device="cpu")
    tables = torch.tensor([[1, 2, 3, 4], [5, 6, 7, 8]], dtype=torch.int32)
    pos = torch.zeros(2, dtype=torch.int32)
    for step in range(3):
        a, _ = decode.forward(params, ids, pcfg, dense, pos)
        b, _ = decode.forward(params, ids, pcfg, paged, pos,
                              block_tables=tables)
        assert torch.equal(a, b), f"step {step}"
        pos = pos + ids.shape[1]
        ids = a[:, -1:].argmax(-1)


def test_generate_and_monolithic_match_jax_greedy(weights):
    jcfg, jparams, pcfg, params = weights
    prompt = _ids((2, 5), 7)
    want = np.asarray(jdecode.generate(jparams, jnp.asarray(prompt), jcfg,
                                       12))
    mono = decode.generate_monolithic(params, prompt, pcfg, 12, device="cpu")
    shim = decode.generate(params, prompt, pcfg, 12, device="cpu")
    np.testing.assert_array_equal(mono.numpy(), want)
    np.testing.assert_array_equal(shim.numpy(), want)
    assert mono.shape == (2, 17)


def test_serial_engine_buckets_stream_and_pool_match_jax(weights):
    """A bucketed ``DecodeEngine`` (prompts padded to 8) serves two
    requests of different batch sizes from its pool; ``stream`` yields the
    same tokens as ``generate``, and both equal the JAX engine's."""
    jcfg, jparams, pcfg, params = weights
    jeng = JaxDecodeEngine(jcfg, max_len=24, buckets=BucketSpec((8, 16)))
    eng = DecodeEngine(pcfg, max_len=24, buckets=BucketSpec((8, 16)),
                       pool_max_entries=1, device="cpu")
    for prompt in (_ids((1, 5), 8), _ids((3, 11), 9), _ids((1, 3), 10)):
        want = np.asarray(jeng.generate(jparams, jnp.asarray(prompt), 9))
        got = eng.generate(params, prompt, 9)
        np.testing.assert_array_equal(got.numpy(), want)
        streamed = np.stack([t.numpy() for t in eng.stream(params, prompt,
                                                           9)], axis=1)
        np.testing.assert_array_equal(streamed, want[:, prompt.shape[1]:])
    # The LRU pool keeps one batch size; its peak saw one more in flight.
    per = 24 * kv_bytes_per_position(pcfg)
    assert eng.cache_hbm_bytes()["allocated"] == 1 * per
    assert eng.cache_hbm_bytes()["peak_in_use"] == (3 + 1) * per
    assert eng.counters["requests"] == 6 and eng.counters["done"] == 6


def test_sampled_generation_is_a_function_of_the_seed():
    """Sampled tokens: the same seed gives the same tokens through
    ``generate_monolithic``, the serial engine, ``stream`` and the
    batched engines (a one-row request); another seed gives others."""
    _, _, pcfg, params = _weights("gpt2", seed=11)
    prompt = _ids((1, 6), 12)
    kw = dict(temperature=0.9, top_k=40, top_p=0.95, seed=1234)
    mono = decode.generate_monolithic(params, prompt, pcfg, 10,
                                      device="cpu", **kw)
    eng = DecodeEngine(pcfg, max_len=16, device="cpu")
    got = eng.generate(params, prompt, 10, **kw)
    np.testing.assert_array_equal(got.numpy(), mono.numpy())
    streamed = [int(t[0]) for t in eng.stream(params, prompt, 10, **kw)]
    assert streamed == mono[0, 6:].tolist()
    for batched in (
        BatchedDecodeEngine(pcfg, slots=2, max_len=16, device="cpu"),
        PagedBatchedDecodeEngine(pcfg, slots=2, max_len=16, page_size=4,
                                 device="cpu"),
    ):
        out = batched.run(params, [dict(prompt=prompt[0],
                                        max_new_tokens=10, **kw)])
        np.testing.assert_array_equal(out[0].tokens, mono[0].numpy())
    other = decode.generate_monolithic(params, prompt, pcfg, 10,
                                       device="cpu", **{**kw, "seed": 99})
    assert not torch.equal(other, mono)
    with pytest.raises(ValueError, match="requires a seed"):
        decode.generate(params, prompt, pcfg, 4, temperature=0.5,
                        device="cpu")


@pytest.mark.parametrize("family", ["gpt2", "llama"])
def test_moe_decode_matches_jax_at_batch_1_and_4(family):
    """MoE decode (4 experts, top-2, the no-drop capacity): the dense
    forward's logits equal JAX's at B 1 and B 4, a row's logits do not
    depend on its batch (one expert assignment never evicts another's),
    and the serial engine's greedy tokens equal JAX's."""
    jcfg, jparams, pcfg, params = _weights(family, seed=13, n_experts=4,
                                           moe_top_k=2)
    prompts = _ids((4, 6), 14)
    rows = []
    for b in (1, 4):
        jl, _ = jdecode.forward(jparams, jnp.asarray(prompts[:b]), jcfg,
                                jdecode.init_cache(jcfg, b, 8), 0)
        pl, _ = decode.forward(params, torch.from_numpy(prompts[:b]), pcfg,
                               decode.init_cache(pcfg, b, 8, device="cpu"),
                               0)
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl), **LOGITS_TOL)
        rows.append(pl[0])
    torch.testing.assert_close(rows[0], rows[1], atol=1e-5, rtol=1e-5)
    want = np.asarray(jdecode.generate(jparams, jnp.asarray(prompts), jcfg,
                                       8))
    eng = DecodeEngine(pcfg, max_len=14, device="cpu")
    np.testing.assert_array_equal(eng.generate(params, prompts, 8).numpy(),
                                  want)
    for i in range(4):
        one = eng.generate(params, prompts[i:i + 1], 8)
        np.testing.assert_array_equal(one.numpy()[0], want[i])


def test_weight_quant_int8_serial_engine_matches_jax(weights):
    jcfg, jparams, pcfg, params = weights
    prompt = _ids((2, 6), 15)
    jeng = JaxDecodeEngine(jcfg, max_len=16, weight_quant="int8")
    want = np.asarray(jeng.generate(jparams, jnp.asarray(prompt), 10))
    eng = DecodeEngine(pcfg, max_len=16, weight_quant="int8", device="cpu")
    np.testing.assert_array_equal(eng.generate(params, prompt, 10).numpy(),
                                  want)
    assert eng.stats()["weight_quant"] == "int8"


def test_nan_guard_retries_once_then_fails_like_jax():
    jcfg, jparams, pcfg, params = _weights("gpt2", seed=16)
    bad = dict(params, wpe=params["wpe"].clone())
    bad["wpe"][4:] = float("nan")
    jbad = dict(jparams, wpe=np.asarray(jparams["wpe"]).copy())
    jbad["wpe"][4:] = np.nan
    prompt = _ids((1, 3), 17)
    outs = []
    for eng, p in (
        (JaxDecodeEngine(jcfg, max_len=12), jbad),
        (DecodeEngine(pcfg, max_len=12, device="cpu"), bad),
    ):
        with pytest.raises(Exception, match="fresh-cache retry") as err:
            eng.generate(p, prompt, 6)
        assert type(err.value).__name__ == RequestFailed.__name__
        with pytest.raises(Exception, match="mid-stream"):
            list(eng.stream(p, prompt, 6))
        outs.append(dict(eng.counters))
    assert outs[0] == outs[1]
    quiet = DecodeEngine(pcfg, max_len=12, nan_guard=False, device="cpu")
    assert quiet.generate(bad, prompt, 6).shape == (1, 9)


def test_refusals_and_uniform_stats():
    _, _, pcfg, _ = _weights("gpt2")
    # The meshed paths decode (tests/test_torch_decode_tp.py); what they
    # still refuse: a mesh that is not tensor-only / fsdp-only, and the
    # mixed TP x ZeRO-3 mesh on the engine.
    for fn in (decode.generate_tp, decode.generate_tp_monolithic):
        with pytest.raises(NotImplementedError, match="tensor-only"):
            fn(None, None, pcfg, MeshConfig(tensor=2, data=2), 4)
    for fn in (decode.generate_fsdp, decode.generate_fsdp_monolithic):
        with pytest.raises(NotImplementedError, match="fsdp-only"):
            fn(None, None, pcfg, MeshConfig(fsdp=2, tensor=2), 4)
    with pytest.raises(NotImplementedError, match="TP x ZeRO-3"):
        DecodeEngine(pcfg, max_len=16, mesh_cfg=MeshConfig(tensor=2, fsdp=2),
                     device="cpu")
    moe = ModelConfig(**_kw("gpt2", n_experts=2))
    with pytest.raises(NotImplementedError, match="MoE expert stacks"):
        DecodeEngine(moe, max_len=16, weight_quant="int8", device="cpu")
    with pytest.raises(NotImplementedError, match="serial DecodeEngine"):
        BatchedDecodeEngine(moe, slots=2, max_len=16, device="cpu")
    with pytest.raises(ValueError, match="largest bucket"):
        DecodeEngine(pcfg, max_len=16, buckets=BucketSpec((8, 32)),
                     device="cpu")
    with pytest.raises(ValueError, match="strictly increasing"):
        BucketSpec((8, 8))
    assert BucketSpec.powers_of_two(100, 16).buckets == (16, 32, 64, 100)
    keys = None
    for eng in (
        DecodeEngine(pcfg, max_len=16, device="cpu"),
        BatchedDecodeEngine(pcfg, slots=2, max_len=16, device="cpu"),
        PagedBatchedDecodeEngine(pcfg, slots=2, max_len=16, page_size=4,
                                 device="cpu"),
    ):
        st = eng.stats()
        keys = keys or set(st)
        assert set(st) == keys and st["spec_accept_rate"] is None
        for name in ("drafted_tokens", "accepted_tokens", "spec_commits"):
            assert st["counters"][name] == 0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            DecodeEngine(pcfg, max_len=16)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            decode.generate_monolithic({}, _ids((1, 2), 0), pcfg, 2)
