"""The port's dropout against the JAX package's, on the CPU in f32.

The port draws each mask through one function, ``utils.prng.
draw_keep_mask(stream_id, shape, keep, device)``. Here it is replaced by
``jax_mask``, which returns, for each stream id, ``jax.random.bernoulli``
of the key the JAX chain gives that id (``domain_key(seed, "dropout")`` ->
``step_key(step)`` -> ``fold_in(micro)`` -> ``split`` -> the embedding's
key, or ``fold_in(layer)`` -> ``split(.., 3)`` -> attention, residual-1,
MLP). With the masks equal, the port's training-mode ``gpt2.apply`` and
its gradients are held to JAX's ``apply(deterministic=False,
dropout_key=...)`` on the same weights: logits within atol 1e-5 / rtol
1e-5 (the tolerance ``tests/test_torch_train.py`` holds the deterministic
forward to) and every gradient within atol 1e-6 / rtol 1e-4 (measured:
logits 1.8e-7, gradients 8.9e-8). The port's own masks are held to their
rate (within 5 standard errors), distinct per stream id and the same when
drawn again.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_tpu.config import ModelConfig as JaxModelConfig
from pytorch_distributed_tpu.models import gpt2 as jgpt2
from pytorch_distributed_tpu.ops import layers as jlayers
from pytorch_distributed_tpu.ops import losses as jlosses
from pytorch_distributed_tpu.ops import pallas_flash
from pytorch_distributed_tpu.utils.prng import domain_key, step_key
from pytorch_distributed_tpu_torch import interop
from pytorch_distributed_tpu_torch.config import ModelConfig
from pytorch_distributed_tpu_torch.models import gpt2
from pytorch_distributed_tpu_torch.ops import flash_kernel as fk
from pytorch_distributed_tpu_torch.ops import layers
from pytorch_distributed_tpu_torch.ops.attention import flash_active
from pytorch_distributed_tpu_torch.ops.losses import cross_entropy_loss
from pytorch_distributed_tpu_torch.utils import prng, tree

CFG_KW = dict(
    vocab_size=97, n_ctx=32, n_embd=32, n_layer=2, n_head=2,
    dtype="float32", embd_pdrop=0.1, attn_pdrop=0.1, resid_pdrop=0.1,
    remat="names",
)
SEED, STEP, MICRO = 7, 3, 1


def jax_key_for(sid: prng.StreamId):
    """The JAX key chain's key for the mask ``sid`` names."""
    key = jax.random.fold_in(
        step_key(domain_key(sid.seed, "dropout"), sid.step), sid.micro)
    blocks_key, embd_key = jax.random.split(key)
    if sid.site == "embd":
        return embd_key
    attn, resid_attn, resid_mlp = jax.random.split(
        jax.random.fold_in(blocks_key, sid.layer), 3)
    return {"attn": attn, "resid_attn": resid_attn,
            "resid_mlp": resid_mlp}[sid.site]


def jax_mask(sid, shape, keep, device):
    """``prng.draw_keep_mask`` drawing JAX's mask for ``sid``."""
    m = jax.random.bernoulli(jax_key_for(sid), p=keep, shape=tuple(shape))
    return torch.from_numpy(np.array(m)).to(device)


@pytest.fixture
def jax_masks(monkeypatch):
    monkeypatch.setattr(prng, "draw_keep_mask", jax_mask)


def jax_dropout_key(seed=SEED, step=STEP, micro=MICRO):
    return jax.random.fold_in(step_key(domain_key(seed, "dropout"), step),
                              micro)


def _both(kw, seed=0):
    jcfg, cfg = JaxModelConfig(**kw), ModelConfig(**kw)
    jparams = jgpt2.init(jax.random.key(seed), jcfg)
    params = interop.params_from_jax(jax.device_get(jparams), cfg)
    return jcfg, cfg, jparams, params


@pytest.mark.parametrize("attn_pdrop", [0.0, 0.1])
@pytest.mark.parametrize("impl", ["naive", "flash"])
def test_training_forward_and_grads_match_jax(jax_masks, impl, attn_pdrop):
    kw = dict(CFG_KW, attention_impl=impl, attn_pdrop=attn_pdrop)
    jcfg, cfg, jparams, params = _both(kw)
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 97, (2, 24)).astype(np.int32)
    tgt = rng.integers(0, 97, (2, 24)).astype(np.int32)

    def jloss(p):
        logits = jgpt2.apply(p, jnp.asarray(ids), jcfg, deterministic=False,
                             dropout_key=jax_dropout_key())
        return jlosses.cross_entropy_loss(logits, jnp.asarray(tgt)), logits

    with jax.default_matmul_precision("highest"):
        (_, want), jgrads = jax.value_and_grad(jloss, has_aux=True)(jparams)
    leaves = [p.requires_grad_() for p in tree.leaves(params)]
    logits = gpt2.apply(params, torch.from_numpy(ids), cfg,
                        deterministic=False,
                        dropout_seed=(SEED, STEP, MICRO))
    grads = torch.autograd.grad(
        cross_entropy_loss(logits, torch.from_numpy(tgt)), leaves)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(want),
                               atol=1e-5, rtol=1e-5)
    got = interop.params_to_jax(tree.unflatten(params, list(grads)), cfg)
    for (path, a), (_, b) in zip(
            jax.tree_util.tree_leaves_with_path(got),
            jax.tree_util.tree_leaves_with_path(jax.device_get(jgrads))):
        np.testing.assert_allclose(a, b, atol=1e-6, rtol=1e-4,
                                   err_msg=str(path))
    # The masks were drawn: the deterministic forward differs.
    det = gpt2.apply(params, torch.from_numpy(ids), cfg)
    assert not torch.allclose(det, logits, atol=1e-3)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dropout_matches_jax_bit_for_bit(jax_masks, dtype):
    """``where(mask, x / keep, 0)`` in x's dtype: keep rounded to x's dtype
    first, as a Python float meets a bf16 JAX array."""
    x = np.random.default_rng(1).standard_normal((4, 8, 32)) * 3
    sid = prng.StreamId(SEED, STEP, MICRO, 1, "resid_mlp")
    jx = jnp.asarray(x, dtype=jnp.dtype(dtype))
    want = jlayers.dropout(jx, 0.1, jax_key_for(sid), deterministic=False)
    px = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(
        getattr(torch, dtype))
    got = layers.dropout(px, 0.1, sid, deterministic=False)
    assert got.dtype == px.dtype
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))
    assert layers.dropout(px, 0.1, None, deterministic=True) is px
    assert layers.dropout(px, 0.0, None, deterministic=False) is px
    with pytest.raises(ValueError, match="stream id"):
        layers.dropout(px, 0.1, None, deterministic=False)


def test_flash_fallback_matches_jax(monkeypatch):
    """The port's ``flash_active`` equals the JAX ``_flash_kernel_active``
    wherever the JAX kernel takes the shape (on the CPU the JAX side never
    does, so its shape check is answered yes here); and the port's forward
    runs the flash op exactly when it says so."""
    monkeypatch.setattr(pallas_flash, "_pallas_supported",
                        lambda t, s, d: True)
    for impl in ("naive", "flash"):
        for attn_pdrop in (0.0, 0.1):
            for det in (True, False):
                kw = dict(CFG_KW, attention_impl=impl, attn_pdrop=attn_pdrop)
                want = jgpt2._flash_kernel_active(JaxModelConfig(**kw), 128,
                                                  None, det)
                cfg = ModelConfig(**kw)
                assert flash_active(impl, attn_pdrop, det) == want
                params = gpt2.init(torch.Generator().manual_seed(0), cfg,
                                   device="cpu")
                before = fk.plain_calls["forward"]
                gpt2.apply(params, torch.zeros(1, 8, dtype=torch.long), cfg,
                           deterministic=det, dropout_seed=(0, 0, 0))
                ran = fk.plain_calls["forward"] - before
                assert ran == (cfg.n_layer if want else 0), (kw, det)


def test_port_masks_rate_distinct_and_repeatable():
    shape, keep = (1000, 1000), 0.9
    base = prng.StreamId(SEED, STEP, MICRO, 0, "attn")
    m = prng.draw_keep_mask(base, shape, keep, "cpu")
    n = m.numel()
    se = (keep * (1 - keep) / n) ** 0.5
    assert m.dtype == torch.bool and tuple(m.shape) == shape
    assert abs(float(m.float().mean()) - keep) < 5 * se
    assert torch.equal(m, prng.draw_keep_mask(base, shape, keep, "cpu"))
    others = [base._replace(seed=SEED + 1), base._replace(step=STEP + 1),
              base._replace(micro=MICRO + 1), base._replace(layer=1),
              base._replace(site="resid_attn")]
    for sid in others:
        other = prng.draw_keep_mask(sid, shape, keep, "cpu")
        # Independent masks agree on keep^2 + (1-keep)^2 = 82 % of places.
        agree = float((other == m).float().mean())
        assert abs(agree - 0.82) < 0.01, sid
    seeds = {prng.stream_seed(s) for s in [base, *others]}
    assert len(seeds) == 6 and all(0 <= s < 2**64 for s in seeds)
    with pytest.raises(ValueError, match="embedding"):
        prng.stream_id(prng.DropoutKey(0, 0), 0, "embd")
    with pytest.raises(KeyError, match="site"):
        prng.stream_id(prng.DropoutKey(0, 0), 0, "nope")


def test_masks_differ_across_layers_steps_and_micro_batches():
    """One training-mode forward draws one mask per (layer, site), and
    another step or micro-batch draws others: recorded through the seam."""
    drawn = []

    def record(sid, shape, keep, device):
        drawn.append(sid)
        return prng_draw(sid, shape, keep, device)

    prng_draw = prng.draw_keep_mask
    cfg = ModelConfig(**CFG_KW)
    params = gpt2.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    ids = torch.zeros(1, 8, dtype=torch.long)
    try:
        prng.draw_keep_mask = record
        out = {}
        for key in ((SEED, 0, 0), (SEED, 1, 0), (SEED, 0, 1)):
            with torch.no_grad():
                out[key] = gpt2.apply(params, ids, cfg, deterministic=False,
                                      dropout_seed=key)
    finally:
        prng.draw_keep_mask = prng_draw
    per_forward = 1 + 3 * cfg.n_layer
    assert len(drawn) == 3 * per_forward == len(set(drawn))
    assert [(s.layer, s.site) for s in drawn[:per_forward]] == [
        (-1, "embd")] + [(layer, site) for layer in range(cfg.n_layer)
                         for site in ("attn", "resid_attn", "resid_mlp")]
    a, b, c = out.values()
    assert not torch.equal(a, b) and not torch.equal(a, c)
