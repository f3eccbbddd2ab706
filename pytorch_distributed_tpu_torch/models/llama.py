"""Llama-family parameters and LM head as plain tensor functions (the port
of the JAX package's ``models/llama.py``: ``init``, ``final_norm``,
``head``). RMSNorm pre-norm, rotary positions, grouped-query attention,
SwiGLU MLP, untied LM head, no biases.

Params keep the JAX leaf names and per-layer shapes, with the blocks as a
Python list of per-layer dicts (``interop.py`` converts). E=n_embd,
V=vocab, F=inner_dim, H=n_head, K=kv_heads, D=head_dim:

  wte [V, E]
  blocks[l]: ln_attn {scale[E]}, ln_mlp {scale[E]},
             attn {wq [E, H*D], wk [E, K*D], wv [E, K*D], wo [H*D, E]},
             mlp {gate [E, F], up [E, F], down [F, E]}
  ln_f {scale[E]}
  lm_head [E, V]

The serving forward is ``models/decode`` (``_llama_block``). The training
forward ``apply`` is not ported yet and raises.
"""

from __future__ import annotations

from typing import Any

import torch

from pytorch_distributed_tpu_torch.config import ModelConfig
from pytorch_distributed_tpu_torch.ops.layers import rms_norm
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
    if cfg.n_experts:
        raise NotImplementedError("MoE llama is not ported yet")
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
                "mlp": {
                    "gate": normal((e, f)),
                    "up": normal((e, f)),
                    "down": normal((f, e)),
                },
            }
            for _ in range(cfg.n_layer)
        ],
        "ln_f": norm(),
        "lm_head": normal((e, v)),
    }


def apply(params: Params, input_ids: torch.Tensor, cfg: ModelConfig,
          **kwargs):
    raise NotImplementedError(
        "llama training (models/llama.apply) is not ported yet; the llama "
        "family serves through models/decode.forward"
    )


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
