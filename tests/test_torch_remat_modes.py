"""The port's remat modes against the JAX package's policies, on the CPU.

For one GPT-2 block (E 128, 2 heads of 64, T 128, so that the JAX flash
path is its Pallas kernel, run here in interpret mode) the JAX side's
``jax.ad_checkpoint`` ``saved_residuals`` under each policy — what backward
keeps, the block's arguments aside — and the port's ``_Kept`` list under
the same mode are the same multiset of (dtype, element count), in f32 and
bf16 (the port keeps the weights-times-values product as [B, H, T, D]
where JAX saves it as [B, H, D, T], and the qkv product as [B, T, 3E]
where JAX saves [B, T, 3, H, D]: the same values in another layout). The
flash forward runs in JAX's backward under ``full``, ``dots`` and
``dots_no_batch`` (3 ``pallas_call``s in the grad jaxpr, 2 under
``names``, ``flash`` and ``none``), and the port's K1 (its plain version
here) runs as often. Gradients under every mode, with dropout on, equal
mode ``none``'s within atol/rtol 1e-6 (they are bit-equal on the CPU).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src.ad_checkpoint import saved_residuals

from pytorch_distributed_tpu.config import ModelConfig as JaxModelConfig
from pytorch_distributed_tpu.models import gpt2 as jgpt2
from pytorch_distributed_tpu.ops import flash_kernel as jfk
from pytorch_distributed_tpu.ops import pallas_flash
from pytorch_distributed_tpu.ops import remat as jremat
from pytorch_distributed_tpu_torch import interop
from pytorch_distributed_tpu_torch.config import ModelConfig
from pytorch_distributed_tpu_torch.models import gpt2
from pytorch_distributed_tpu_torch.ops import flash_kernel as fk
from pytorch_distributed_tpu_torch.ops import remat
from pytorch_distributed_tpu_torch.utils import prng, tree

B, T = 2, 128
KW = dict(vocab_size=97, n_ctx=T, n_embd=128, n_layer=1, n_head=2,
          embd_pdrop=0.1, resid_pdrop=0.1)
MODES = ("full", "dots", "dots_no_batch", "names", "flash")
# (attention_impl, attn_pdrop): the naive path; the flash kernel; flash
# asked for but attention dropout on, so naive.
PATHS = [("naive", 0.1), ("flash", 0.0), ("flash", 0.1)]
# What the port keeps per mode, in forward order, on the naive path and
# on the kernel path.
WANT_LABELS = {
    ("naive", "full"): [], ("flash", "full"): [],
    ("naive", "dots"): ["qkv", "attn_scores", "attn_out", "attn_proj",
                        "mlp_fc"],
    ("flash", "dots"): ["qkv", "attn_proj", "mlp_fc"],
    ("naive", "dots_no_batch"): ["qkv", "attn_proj", "mlp_fc"],
    ("flash", "dots_no_batch"): ["qkv", "attn_proj", "mlp_fc"],
    ("naive", "names"): ["qkv", "attn_out", "attn_proj", "mlp_fc"],
    ("flash", "names"): ["qkv", "flash", "attn_proj", "mlp_fc"],
    ("naive", "flash"): [], ("flash", "flash"): ["flash"],
}


@pytest.fixture
def jax_kernel(monkeypatch):
    """The JAX flash path on its Pallas kernel, in interpret mode."""
    flash_mha = jfk.flash_mha
    monkeypatch.setattr(pallas_flash, "_pallas_supported",
                        lambda t, s, d: t == s and t % 128 == 0
                        and d % 64 == 0)
    monkeypatch.setattr(jfk, "flash_mha", lambda *a: flash_mha(
        *a, interpret=True))


def _jax_block(mode, impl, attn_pdrop, dtype):
    cfg = JaxModelConfig(**KW, attention_impl=impl, attn_pdrop=attn_pdrop,
                         dtype=dtype)
    params = jgpt2.init(jax.random.key(0), cfg)
    bp = jax.tree.map(lambda a: a[0], params["blocks"])
    x = jax.random.normal(jax.random.key(1), (B, T, 128)).astype(dtype)

    def block(x, bp, key):
        return jgpt2._block(x, bp, cfg, key, False)[0]

    f = jremat.apply_remat(block, mode)
    res = saved_residuals(f, x, bp, jax.random.key(2))
    kept = sorted((str(a.dtype), int(np.prod(a.shape))) for a, what in res
                  if "argument" not in what)
    grad = jax.make_jaxpr(jax.grad(lambda x, bp, k: f(x, bp, k).astype(
        jnp.float32).sum()))(x, bp, jax.random.key(2))
    return kept, str(grad).count("pallas_call"), cfg, params


def _port_block(monkeypatch, mode, impl, attn_pdrop, dtype, jparams):
    lists = []

    class Recorded(remat._Kept):
        def __init__(self):
            super().__init__()
            lists.append(self)

    monkeypatch.setattr(remat, "_Kept", Recorded)
    cfg = ModelConfig(**KW, attention_impl=impl, attn_pdrop=attn_pdrop,
                      dtype=dtype, remat=mode)
    bp = interop.params_from_jax(jax.device_get(jparams), cfg)["blocks"][0]
    x = torch.randn(B, T, 128, generator=torch.Generator().manual_seed(1))
    x = x.to(getattr(torch, dtype)).requires_grad_()
    block = remat.apply_remat(functools.partial(
        gpt2._block, cfg=cfg, key=prng.DropoutKey(0, 0)), mode)
    before = dict(fk.plain_calls)
    out = block(x, bp, 0)
    torch.autograd.grad(out.float().sum(), [x])
    calls = sum(fk.plain_calls[k] - before[k] for k in before)
    values, labels = ([], []) if not lists else (lists[0].values,
                                                 lists[0].labels)
    flat = [t for v in values for t in (v if isinstance(v, tuple) else (v,))]
    kept = sorted((str(t.dtype).replace("torch.", ""), t.numel())
                  for t in flat)
    return kept, labels, calls


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl, attn_pdrop", PATHS)
@pytest.mark.parametrize("mode", MODES)
def test_kept_set_matches_jax_saved_residuals(monkeypatch, jax_kernel, mode,
                                              impl, attn_pdrop, dtype):
    want, pallas_calls, jcfg, jparams = _jax_block(mode, impl, attn_pdrop,
                                                   dtype)
    got, labels, calls = _port_block(monkeypatch, mode, impl, attn_pdrop,
                                     dtype, jparams)
    assert got == want
    kernel = impl == "flash" and attn_pdrop == 0.0
    assert labels == WANT_LABELS[("flash" if kernel else "naive", mode)]
    assert jgpt2._flash_kernel_active(jcfg, T, None, False) == kernel
    # K1 and K2 runs per block: the JAX grad's pallas_calls.
    assert calls == pallas_calls


@pytest.mark.parametrize("impl, attn_pdrop", PATHS)
def test_grads_equal_under_every_mode_with_dropout(impl, attn_pdrop):
    def grads(mode):
        cfg = ModelConfig(**dict(KW, n_layer=2, n_embd=64, n_ctx=32),
                          attention_impl=impl, attn_pdrop=attn_pdrop,
                          dtype="float32", remat=mode)
        params = gpt2.init(torch.Generator().manual_seed(3), cfg,
                           device="cpu")
        leaves = [p.requires_grad_() for p in tree.leaves(params)]
        ids = torch.randint(0, 97, (2, 32),
                            generator=torch.Generator().manual_seed(4))
        logits = gpt2.apply(params, ids, cfg, deterministic=False,
                            dropout_seed=(5, 6, 0))
        return torch.autograd.grad(logits.square().mean(), leaves)

    ref = grads("none")
    for mode in MODES:
        for a, b in zip(grads(mode), ref):
            torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)
