"""The Llama family as plain tensor functions (the port of the JAX
package's ``models/llama.py``: ``init``, ``_block``, ``apply``,
``final_norm``, ``head``). RMSNorm pre-norm, rotary positions,
grouped-query attention, SwiGLU MLP (or Switch-routed SwiGLU experts,
``ops/moe``), untied LM head, no biases.

Params keep the JAX leaf names and per-layer shapes, with the blocks as a
Python list of per-layer dicts (``interop.py`` converts). E=n_embd,
V=vocab, F=inner_dim, H=n_head, K=kv_heads, D=head_dim:

  wte [V, E]
  blocks[l]: ln_attn {scale[E]}, ln_mlp {scale[E]},
             attn {wq [E, H*D], wk [E, K*D], wv [E, K*D], wo [H*D, E]},
             mlp {gate [E, F], up [E, F], down [F, E]}
             (MoE, X = n_experts: mlp {router [E, X], w_gate [X, E, F],
             w_in [X, E, F], w_out [X, F, E]})
  ln_f {scale[E]}
  lm_head [E, V]

``apply`` is the training forward, built from the phase functions the
pipeline calls (``embed``, ``run_blocks``: the blocks through
``ops/layer_scan.scan_layers``, each under
``ops.remat.apply_remat(cfg.remat)``, attention through
``ops.attention.multi_head_attention``); the family has no dropout, so
training and eval forwards coincide. The serving forward is
``models/decode`` (``_llama_block``).
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from pytorch_distributed_tpu_torch.config import ModelConfig
from pytorch_distributed_tpu_torch.models.gpt2 import seq_span
from pytorch_distributed_tpu_torch.ops.attention import multi_head_attention
from pytorch_distributed_tpu_torch.ops.layer_scan import scan_layers
from pytorch_distributed_tpu_torch.ops.layers import rms_norm
from pytorch_distributed_tpu_torch.ops.moe import moe_mlp
from pytorch_distributed_tpu_torch.ops.remat import (
    checkpoint_name,
    product,
)
from pytorch_distributed_tpu_torch.ops.rope import apply_rope, rope_angles
from pytorch_distributed_tpu_torch.ops.tp import tp_copy
from pytorch_distributed_tpu_torch.utils.device import resolve_device

Params = dict[str, Any]


def init(generator: torch.Generator, cfg: ModelConfig,
         device: str | torch.device | None = None) -> Params:
    """Llama initialisation: every matrix N(0, 0.02), norm scales 1; drawn
    in f32 from ``generator`` on the generator's own device (a CUDA
    generator draws a full-width model on the card in well under a second
    where the CPU takes minutes), stored in ``cfg.param_dtype`` on
    ``device`` (None: the GPU, ``utils.device.resolve_device``)."""
    if cfg.family != "llama":
        raise ValueError(f"llama.init got a {cfg.family!r} config")
    device = resolve_device(device)
    pdt = getattr(torch, cfg.param_dtype)
    e, v, f = cfg.n_embd, cfg.vocab_size, cfg.inner_dim
    h, k, d = cfg.n_head, cfg.kv_heads, cfg.head_dim

    def normal(shape):
        x = torch.randn(shape, generator=generator, device=generator.device,
                        dtype=torch.float32)
        return (x * 0.02).to(device, pdt)

    def norm():
        return {"scale": torch.ones(e, dtype=pdt, device=device)}

    def mlp():
        x = cfg.n_experts
        if not x:
            return {"gate": normal((e, f)), "up": normal((e, f)),
                    "down": normal((f, e))}
        # Switch-routed SwiGLU experts (ops/moe).
        return {"router": normal((e, x)), "w_gate": normal((x, e, f)),
                "w_in": normal((x, e, f)), "w_out": normal((x, f, e))}

    return {
        "wte": normal((v, e)),
        "blocks": [
            {
                "ln_attn": norm(),
                "attn": {
                    "wq": normal((e, h * d)),
                    "wk": normal((e, k * d)),
                    "wv": normal((e, k * d)),
                    "wo": normal((h * d, e)),
                },
                "ln_mlp": norm(),
                "mlp": mlp(),
            }
            for _ in range(cfg.n_layer)
        ],
        "ln_f": norm(),
        "lm_head": normal((e, v)),
    }


def _block(x: torch.Tensor, bp: Params, cos: torch.Tensor,
           sin: torch.Tensor, *, cfg: ModelConfig, tp_group=None,
           seq_group=None, expert_group=None):
    """x + wo(attn(rope(q), rope(k), v)) over rms_norm(x); then x +
    swiglu(rms_norm(x)), or the MoE MLP. Returns x, or (x, aux) for a MoE
    config (aux: the layer's Switch term). The products are tagged as in
    the JAX block (``q``, ``k``, ``v``, ``attn_out`` on the naive path,
    ``attn_proj``, ``mlp_gate``, ``mlp_up``, ``mlp_proj``). ``tp_group``: tensor parallelism (``gpt2._block``): this rank's q and
    KV heads (the head counts follow the sharded kernels' widths, so GQA's
    group is kept), SwiGLU's gate and up columns, and ``wo``/``down``
    row-parallel, each summed over the group once. ``seq_group``:
    sequence parallelism, ``expert_group``: expert parallelism
    (``gpt2._block``)."""
    eps = cfg.layer_norm_epsilon
    b, t = x.shape[:2]
    d = cfg.head_dim
    attn = bp["attn"]
    a = tp_copy(rms_norm(x, bp["ln_attn"], eps=eps), tp_group)
    with checkpoint_name("q"):
        q = product(a, attn["wq"].to(a.dtype))
    with checkpoint_name("k"):
        k = product(a, attn["wk"].to(a.dtype))
    with checkpoint_name("v"):
        v = product(a, attn["wv"].to(a.dtype))
    q = apply_rope(q.view(b, t, -1, d), cos, sin)
    k = apply_rope(k.view(b, t, -1, d), cos, sin)
    a = multi_head_attention(
        q, k, v.view(b, t, -1, d), impl=cfg.attention_impl, causal=True,
        out_name="attn_out", seq_group=seq_group, seq_impl=cfg.seq_impl,
    ).reshape(b, t, -1)
    with checkpoint_name("attn_proj"):
        a = product(a, attn["wo"].to(a.dtype), group=tp_group)
    x = x + a
    m = rms_norm(x, bp["ln_mlp"], eps=eps)
    if cfg.n_experts:
        m, aux = moe_mlp(m, bp["mlp"], activation=F.silu,
                         capacity_factor=cfg.expert_capacity_factor,
                         expert_axis=expert_group,
                         tensor_axis=tp_group, top_k=cfg.moe_top_k,
                         dispatch_impl=cfg.moe_dispatch)
        return x + m, aux
    m = tp_copy(m, tp_group)
    mp = bp["mlp"]
    with checkpoint_name("mlp_gate"):
        gate = F.silu(product(m, mp["gate"].to(m.dtype)))
    with checkpoint_name("mlp_up"):
        up = product(m, mp["up"].to(m.dtype))
    with checkpoint_name("mlp_proj"):
        return x + product(gate * up, mp["down"].to(m.dtype),
                           group=tp_group)


def apply(params: Params, input_ids: torch.Tensor, cfg: ModelConfig, *,
          deterministic: bool = True, dropout_seed=None,
          return_aux: bool = False, return_hidden: bool = False,
          block_transform=None, tp_group=None, seq_group=None,
          expert_group=None, prefetch_buffers: int = 0):
    """Forward pass: [B, T] token ids -> [B, T, V] logits in
    ``cfg.logits_dtype``: ``embed``, ``run_blocks``, the head (the
    contract of ``gpt2.apply``, its ``block_transform``,
    ``prefetch_buffers``, ``tp_group``, ``seq_group`` and ``expert_group``
    included; under a sequence group the RoPE angles start at this rank's
    first position).
    The family is dropout-free, so ``deterministic`` and ``dropout_seed``
    change nothing. ``return_hidden``: the final-norm hidden states
    [B, T, E] in place of the logits; ``return_aux``: also the Switch term
    summed over layers (an f32 scalar, 0 for a dense config)."""
    del deterministic, dropout_seed
    x = embed(params, input_ids, cfg, seq_group=seq_group)
    x = run_blocks(params["blocks"], x, cfg, block_transform=block_transform,
                   return_aux=return_aux, tp_group=tp_group,
                   seq_group=seq_group, expert_group=expert_group,
                   prefetch_buffers=prefetch_buffers)
    x, aux = x if return_aux else (x, None)
    out = final_norm(params, x, cfg) if return_hidden else \
        head(params, x, cfg)
    return (out, aux) if return_aux else out


# -- phase functions (pipeline parallelism) — see models/gpt2.py --------------


def embed(params: Params, input_ids: torch.Tensor, cfg: ModelConfig, *,
          seq_group=None) -> torch.Tensor:
    """The token rows in ``cfg.dtype`` (positions are rotary, applied in
    ``run_blocks``); under ``seq_group`` the global length (ranks x T) is
    held to ``n_ctx``."""
    _, global_t = seq_span(input_ids.shape[1], seq_group)
    if global_t > cfg.n_ctx:
        raise ValueError(
            f"sequence length {global_t} exceeds n_ctx {cfg.n_ctx}")
    return F.embedding(input_ids, params["wte"]).to(
        getattr(torch, cfg.dtype))


def run_blocks(blocks: list, x: torch.Tensor, cfg: ModelConfig, *,
               block_transform=None, return_aux: bool = False,
               tp_group=None, seq_group=None, expert_group=None,
               dropout_seed=None, deterministic: bool = True,
               layer_offset: int = 0,
               prefetch_buffers: int = 0):
    """``gpt2.run_blocks`` for the family: the RoPE angles built once per
    call on x's device, from this rank's first position under
    ``seq_group``, and shared by every layer. The dropout arguments are
    taken for the pipeline's sake and ignored (no dropout here)."""
    del dropout_seed, deterministic, layer_offset
    t = x.shape[1]
    start, _ = seq_span(t, seq_group)
    cos, sin = rope_angles(t, cfg.head_dim, cfg.rope_theta, offset=start,
                           device=x.device)
    moe = bool(cfg.n_experts)

    def block_fn(carry, bp, _):
        h = carry[0] if moe else carry
        out = _block(h, bp, cos, sin, cfg=cfg, tp_group=tp_group,
                     seq_group=seq_group, expert_group=expert_group)
        if not moe:
            return out
        h, aux = out
        return h, carry[1] + aux

    carry = x
    if moe:
        carry = (x, torch.zeros((), dtype=torch.float32, device=x.device))
    carry = scan_layers(
        block_fn, carry, blocks,
        remat_mode=cfg.remat if torch.is_grad_enabled() else "none",
        block_transform=block_transform, prefetch_buffers=prefetch_buffers)
    if not return_aux:
        return carry[0] if moe else carry
    if moe:
        return carry
    return carry, torch.zeros((), dtype=torch.float32, device=x.device)


def final_norm(params: Params, x: torch.Tensor,
               cfg: ModelConfig) -> torch.Tensor:
    return rms_norm(x, params["ln_f"], eps=cfg.layer_norm_epsilon)


def head(params: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """ln_f, then the untied head ``x @ lm_head`` on the activation-dtype
    values of both, accumulated in float32 and cast to
    ``cfg.logits_dtype``. A placed params dict (``serving/engine``)
    carries ``lm_head``'s rounded values in f32 as ``head_w``, so the
    weight is not recast per call."""
    x = final_norm(params, x, cfg)
    w = params.get("head_w")
    if w is None:
        w = params["lm_head"].to(x.dtype).float()
    return (x.float() @ w).to(getattr(torch, cfg.logits_dtype))
