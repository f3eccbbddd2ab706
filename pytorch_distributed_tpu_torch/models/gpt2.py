"""GPT-2 parameters, forward pass and LM head as plain tensor functions
(the port of the JAX package's ``models/gpt2.py``: ``init``, ``_block``,
``apply``, ``final_norm``, ``head``).

Params are a dict of tensors with the JAX package's leaf names and
layouts, except that the per-layer leaves are a Python LIST of per-layer
dicts (the JAX tree stacks them along a leading [L] axis for its
``scan``; here the layer loop is a Python loop). ``interop.py`` converts
between the two. Shapes (E=n_embd, V=vocab, C=n_ctx, F=inner_dim,
H=n_head, D=head_dim):

  wte [V, E]; wpe [C, E]
  blocks[l]: ln_1 {scale[E], bias[E]}, ln_2 same,
             attn/c_attn {kernel[E, 3, H, D], bias[3, H, D]},
             attn/c_proj {kernel[E, E], bias[E]},
             mlp/c_fc {kernel[E, F], bias[F]}, mlp/c_proj {kernel[F, E], bias[E]}
  ln_f {scale[E], bias[E]}

The LM head is tied to wte (no separate leaf). ``apply`` is the training
forward: a Python loop over ``params["blocks"]``, each block wrapped by
``ops.remat.apply_remat(cfg.remat)``, attention through
``ops.attention.multi_head_attention(impl=cfg.attention_impl)``. In
training mode (``deterministic=False``) it draws the embedding, attention
and residual dropout masks from stream ids (``utils/prng``) that mirror
the JAX key chain: the embedding's, then per layer attention, residual
after ``attn_proj``, residual after ``mlp_proj``.
"""

from __future__ import annotations

import functools
from typing import Any

import torch
import torch.nn.functional as F

from pytorch_distributed_tpu_torch.config import ModelConfig
from pytorch_distributed_tpu_torch.ops.attention import multi_head_attention
from pytorch_distributed_tpu_torch.ops.layers import (
    activation,
    dense,
    dropout,
    layer_norm,
)
from pytorch_distributed_tpu_torch.ops.remat import apply_remat, checkpoint_name
from pytorch_distributed_tpu_torch.utils import prng
from pytorch_distributed_tpu_torch.utils.device import resolve_device

Params = dict[str, Any]


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def init(generator: torch.Generator, cfg: ModelConfig,
         device: str | torch.device | None = None) -> Params:
    """GPT-2 initialisation: linear kernels N(0, 0.02), wte N(0, 0.02),
    wpe N(0, 0.01), LayerNorm scale 1 / bias 0, zero biases; draws in f32
    from ``generator`` on the generator's own device (so one seed gives the
    same weights wherever they are placed), stored in ``cfg.param_dtype``
    on ``device`` (None: the GPU, ``utils.device.resolve_device``)."""
    if cfg.family != "gpt2":
        raise ValueError(f"gpt2.init got a {cfg.family!r} config")
    if cfg.n_experts:
        raise NotImplementedError("MoE GPT-2 is not ported yet")
    device = resolve_device(device)
    pdt = _dtype(cfg.param_dtype)
    e, v, c, f = cfg.n_embd, cfg.vocab_size, cfg.n_ctx, cfg.inner_dim
    h, d = cfg.n_head, cfg.head_dim

    def normal(shape, std):
        x = torch.randn(shape, generator=generator, device=generator.device,
                        dtype=torch.float32)
        return (x * std).to(device, pdt)

    def zeros(shape):
        return torch.zeros(shape, dtype=pdt, device=device)

    def ln():
        return {"scale": torch.ones(e, dtype=pdt, device=device),
                "bias": zeros(e)}

    params: Params = {"wte": normal((v, e), 0.02), "wpe": normal((c, e), 0.01)}
    params["blocks"] = [
        {
            "ln_1": ln(),
            "attn": {
                "c_attn": {"kernel": normal((e, 3, h, d), 0.02),
                           "bias": zeros((3, h, d))},
                "c_proj": {"kernel": normal((e, e), 0.02), "bias": zeros(e)},
            },
            "ln_2": ln(),
            "mlp": {
                "c_fc": {"kernel": normal((e, f), 0.02), "bias": zeros(f)},
                "c_proj": {"kernel": normal((f, e), 0.02), "bias": zeros(e)},
            },
        }
        for _ in range(cfg.n_layer)
    ]
    params["ln_f"] = ln()
    return params


def _block(x: torch.Tensor, bp: Params, layer: int, *, cfg: ModelConfig,
           key: prng.DropoutKey | None) -> torch.Tensor:
    """Pre-norm residual block: x + drop(attn(ln_1(x))); x +
    drop(mlp(ln_2(x))). ``key`` None: deterministic; else the masks of
    ``layer`` derive from it. The projections the remat policies keep are
    tagged as in the JAX model (``qkv``, ``attn_proj``, ``mlp_fc``,
    ``mlp_proj``; the naive attention output ``attn_out``)."""
    eps = cfg.layer_norm_epsilon
    det = key is None
    sid = (lambda site: None) if det else (
        lambda site: prng.stream_id(key, layer, site))
    b, t = x.shape[:2]
    a = layer_norm(x, bp["ln_1"], eps=eps)
    with checkpoint_name("qkv"):
        qkv = dense(a, bp["attn"]["c_attn"])  # [B, T, 3, H, D]
    q, k, v = qkv.unbind(2)
    a = multi_head_attention(
        q, k, v, impl=cfg.attention_impl, causal=True,
        dropout_rate=cfg.attn_pdrop, dropout_sid=sid("attn"),
        deterministic=det, out_name="attn_out",
    ).reshape(b, t, -1)
    with checkpoint_name("attn_proj"):
        a = dense(a, bp["attn"]["c_proj"])
    x = x + dropout(a, cfg.resid_pdrop, sid("resid_attn"), deterministic=det)
    m = layer_norm(x, bp["ln_2"], eps=eps)
    with checkpoint_name("mlp_fc"):
        m = dense(m, bp["mlp"]["c_fc"])
    m = activation(cfg.activation_function)(m)
    with checkpoint_name("mlp_proj"):
        m = dense(m, bp["mlp"]["c_proj"])
    return x + dropout(m, cfg.resid_pdrop, sid("resid_mlp"), deterministic=det)


def apply(params: Params, input_ids: torch.Tensor, cfg: ModelConfig, *,
          deterministic: bool = True,
          dropout_seed: prng.DropoutKey | None = None,
          return_hidden: bool = False) -> torch.Tensor:
    """Forward pass: [B, T] token ids -> [B, T, V] logits in
    ``cfg.logits_dtype``: wte + wpe (cast to ``cfg.dtype``), embedding
    dropout, n_layer pre-norm blocks (each under ``cfg.remat``), ln_f,
    tied head. ``deterministic=False`` (training) draws the dropout masks
    from ``dropout_seed`` and raises without one, as the JAX ``apply``
    does without a key. ``return_hidden``: the final-norm hidden states
    [B, T, E] in place of the logits (what ``ops/losses.
    linear_cross_entropy`` consumes). Under ``torch.no_grad`` the blocks
    run without checkpointing: there is no backward to recompute for."""
    if cfg.n_experts:
        raise NotImplementedError("MoE GPT-2 is not ported yet")
    if not deterministic and dropout_seed is None:
        raise ValueError("training-mode apply() requires dropout_seed")
    key = None if deterministic else prng.DropoutKey(*dropout_seed)
    t = input_ids.shape[1]
    if t > cfg.n_ctx:
        raise ValueError(f"sequence length {t} exceeds n_ctx {cfg.n_ctx}")
    x = F.embedding(input_ids, params["wte"]) + params["wpe"][:t]
    x = x.to(_dtype(cfg.dtype))
    if key is not None:
        x = dropout(x, cfg.embd_pdrop,
                    prng.stream_id(key, prng.EMBD_LAYER, "embd"),
                    deterministic=False)
    remat = cfg.remat if torch.is_grad_enabled() else "none"
    block = apply_remat(functools.partial(_block, cfg=cfg, key=key), remat)
    for layer, bp in enumerate(params["blocks"]):
        x = block(x, bp, layer)
    if return_hidden:
        return final_norm(params, x, cfg)
    return head(params, x, cfg)


def final_norm(params: Params, x: torch.Tensor,
               cfg: ModelConfig) -> torch.Tensor:
    return layer_norm(x, params["ln_f"], eps=cfg.layer_norm_epsilon)


def head(params: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """ln_f, then the tied head ``x @ wte^T`` ACCUMULATED AND RETURNED in
    float32: the activations and the head weight are rounded to the
    activation dtype (as the JAX package's ``wte.astype(x.dtype)``) and the
    product runs on their exact f32 values, so a bf16 model's logits are
    not rounded to bf16 (which would flip near-tied argmaxes) unless
    ``cfg.logits_dtype`` asks for it. A placed
    params dict (``serving/engine``) carries the rounded head weight as
    ``head_w`` so it is not recast per call."""
    x = final_norm(params, x, cfg)
    out = _dtype(cfg.logits_dtype)
    if out == x.dtype and "head_w" not in params:
        # Logits in the activation dtype (the training path's bf16 logits):
        # one product in that dtype, accumulated in f32 and rounded once,
        # as the JAX package's f32-accumulated einsum then cast.
        return x @ params["wte"].to(x.dtype).t()
    w = params.get("head_w")
    if w is None:
        w = params["wte"].to(x.dtype).float()
    logits = x.float() @ w.t()
    return logits.to(out)
