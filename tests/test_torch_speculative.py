"""The port's prompt-lookup speculative decoding against the JAX
package's, on the CPU.

``prompt_lookup_draft``, the reference loop's vectorised lookup and
``speculative_accept`` are compared with JAX's on seeded arrays (exact);
``generate_speculative`` runs on weights made by the JAX ``init`` and
converted with ``interop.params_from_jax``, in f32, and its greedy tokens
must equal JAX's ``generate_speculative`` and the port's plain
``decode.generate`` (MoE included).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_tpu.config import ModelConfig as JaxModelConfig
from pytorch_distributed_tpu.models import decode as jdecode
from pytorch_distributed_tpu.models import get_model as jget_model
from pytorch_distributed_tpu.models import speculative as jspec
from pytorch_distributed_tpu_torch import interop
from pytorch_distributed_tpu_torch.config import ModelConfig
from pytorch_distributed_tpu_torch.models import decode, speculative


def _weights(family, seed, **extra):
    kw = dict(family=family, vocab_size=61, n_ctx=96, n_embd=64, n_layer=2,
              n_head=4, dtype="float32", attn_pdrop=0.0, resid_pdrop=0.0,
              embd_pdrop=0.0)
    if family == "llama":
        kw["n_kv_head"] = 2
    kw.update(extra)
    jcfg, pcfg = JaxModelConfig(**kw), ModelConfig(**kw)
    jparams = jget_model(jcfg).init(jax.random.key(seed), jcfg)
    return jcfg, jparams, pcfg, interop.params_from_jax(
        jax.device_get(jparams), pcfg)


def test_prompt_lookup_draft_and_traced_lookup_equal_jax():
    """The host drafter and the reference loop's lookup, over a seeded
    battery of histories on a tiny vocabulary (matches are frequent),
    equal the JAX package's bit for bit."""
    rng = np.random.default_rng(7)
    total = 30  # one buffer length: each (ngram, k) compiles once in JAX
    for trial in range(60):
        n = int(rng.integers(2, 24))
        ngram = int(rng.choice([1, 2, 3]))
        k = int(rng.choice([1, 3, 5]))
        toks = rng.integers(0, 5, (n,)).astype(np.int32)
        host = speculative.prompt_lookup_draft(toks, k, ngram=ngram)
        np.testing.assert_array_equal(
            host, jspec.prompt_lookup_draft(toks, k, ngram=ngram),
            err_msg=f"trial {trial}")
        buf = np.zeros((1, total), np.int32)
        buf[0, :n] = toks
        want = np.asarray(jspec._lookup_draft(
            jnp.asarray(buf), jnp.asarray(n, jnp.int32), ngram=ngram,
            draft_len=k, total=total))
        got = speculative._lookup_draft(torch.from_numpy(buf).long(), n,
                                        ngram=ngram, draft_len=k,
                                        total=total)
        np.testing.assert_array_equal(got.numpy(), want,
                                      err_msg=f"trial {trial}")


def test_speculative_accept_equals_jax():
    rng = np.random.default_rng(8)
    b, k = 5, 6
    for _ in range(20):
        drafts = rng.integers(0, 3, (b, k)).astype(np.int32)
        verified = rng.integers(0, 3, (b, k)).astype(np.int32)
        n_draft = rng.integers(0, k + 1, (b,)).astype(np.int32)
        want = np.asarray(jdecode.speculative_accept(
            jnp.asarray(drafts), jnp.asarray(verified),
            jnp.asarray(n_draft)))
        got = decode.speculative_accept(torch.from_numpy(drafts),
                                        torch.from_numpy(verified),
                                        torch.from_numpy(n_draft))
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("family", ["gpt2", "llama"])
@pytest.mark.parametrize("pattern", ["random", "repetitive"])
def test_generate_speculative_equals_jax_and_greedy(family, pattern):
    """A random prompt (drafts mostly rejected) and a repetitive one
    (drafts accepted): the tokens equal JAX's speculative loop and the
    plain greedy decode."""
    jcfg, jparams, pcfg, params = _weights(family, seed=2)
    prompt = (np.random.default_rng(1).integers(0, 61, (1, 7)).astype(
        np.int32) if pattern == "random"
        else np.array([[5, 9, 12, 5, 9, 12, 5, 9, 12, 5, 9]], np.int32))
    want = np.asarray(jspec.generate_speculative(
        jparams, jnp.asarray(prompt), jcfg, 20))
    got = speculative.generate_speculative(params, prompt, pcfg, 20,
                                           device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)
    plain = decode.generate(params, prompt, pcfg, 20, device="cpu")
    np.testing.assert_array_equal(got.numpy(), plain.numpy())


@pytest.mark.parametrize("draft_len,ngram", [(1, 1), (4, 2), (8, 3)])
def test_speculative_settings_do_not_change_output(draft_len, ngram):
    _, _, pcfg, params = _weights("gpt2", seed=3)
    prompt = np.random.default_rng(4).integers(0, 61, (1, 6))
    ref = decode.generate(params, prompt, pcfg, 16, device="cpu")
    got = speculative.generate_speculative(
        params, prompt, pcfg, 16, draft_len=draft_len, ngram=ngram,
        device="cpu")
    np.testing.assert_array_equal(got.numpy(), ref.numpy())


def test_speculative_moe_equals_jax_and_greedy():
    """MoE verify forward: per-token routing inside the K+1-token forward
    agrees with one-token-at-a-time routing (no-drop capacity)."""
    jcfg, jparams, pcfg, params = _weights("gpt2", seed=5, n_experts=4,
                                           moe_top_k=2)
    prompt = np.array([[3, 8, 3, 8, 3, 8, 3]], np.int32)
    want = np.asarray(jspec.generate_speculative(
        jparams, jnp.asarray(prompt), jcfg, 16))
    got = speculative.generate_speculative(params, prompt, pcfg, 16,
                                           device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)
    ref = decode.generate(params, prompt, pcfg, 16, device="cpu")
    np.testing.assert_array_equal(got.numpy(), ref.numpy())


def test_speculative_rejects_bad_args():
    """The JAX refusals (``tests/test_speculative.py``)."""
    _, _, pcfg, params = _weights("gpt2", seed=6)
    with pytest.raises(ValueError, match="single-sequence"):
        speculative.generate_speculative(params, np.zeros((2, 4)), pcfg, 4,
                                         device="cpu")
    prompt = np.zeros((1, 4), np.int32)
    with pytest.raises(ValueError, match="draft_len"):
        speculative.generate_speculative(params, prompt, pcfg, 4,
                                         draft_len=0, device="cpu")
    with pytest.raises(ValueError, match="ngram"):
        speculative.generate_speculative(params, prompt, pcfg, 4, ngram=0,
                                         device="cpu")
    with pytest.raises(ValueError, match="n_ctx"):
        speculative.generate_speculative(params, prompt, pcfg, pcfg.n_ctx,
                                         device="cpu")
    out = speculative.generate_speculative(params, prompt, pcfg, 0,
                                           device="cpu")
    np.testing.assert_array_equal(out.numpy(), prompt)
