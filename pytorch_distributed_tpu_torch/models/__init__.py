"""Model families: ``get_model(cfg)`` returns the family's functions (the
port of the JAX package's ``models/__init__.py``)."""

from __future__ import annotations

from typing import Callable, NamedTuple

from pytorch_distributed_tpu_torch.config import ModelConfig


class ModelApi(NamedTuple):
    init: Callable[..., dict]
    head: Callable[..., object]
    # (params, input_ids [B, T], cfg, *, deterministic, dropout_seed,
    # return_hidden) -> logits [B, T, V] (or hidden [B, T, E]): the
    # training forward (the JAX ModelApi's ``apply``).
    apply: Callable[..., object]
    # (params) -> (head weight, ops.losses layout tag): the LM-head matrix
    # the fused head + cross-entropy multiplies against — the tied wte
    # [V, E] ("ve") for gpt2, the untied lm_head [E, V] ("ev") for llama.
    head_weight: Callable[[dict], tuple]
    # ln_f alone: head() without the vocab product.
    final_norm: Callable[..., object]


def get_model(cfg: ModelConfig) -> ModelApi:
    if cfg.family == "gpt2":
        from pytorch_distributed_tpu_torch.models import gpt2

        return ModelApi(gpt2.init, gpt2.head, gpt2.apply,
                        lambda params: (params["wte"], "ve"),
                        gpt2.final_norm)
    if cfg.family == "llama":
        from pytorch_distributed_tpu_torch.models import llama

        # Serving only: llama.apply (training) raises NotImplementedError.
        return ModelApi(llama.init, llama.head, llama.apply,
                        lambda params: (params["lm_head"], "ev"),
                        llama.final_norm)
    raise NotImplementedError(
        f"model family {cfg.family!r} is not ported (gpt2, llama)"
    )
