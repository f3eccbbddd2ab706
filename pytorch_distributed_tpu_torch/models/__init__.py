"""Model families: ``get_model(cfg)`` returns the family's functions."""

from __future__ import annotations

from typing import Callable, NamedTuple

from pytorch_distributed_tpu_torch.config import ModelConfig


class ModelApi(NamedTuple):
    init: Callable[..., dict]
    head: Callable[..., object]
    # (params, input_ids [B, T], cfg) -> logits [B, T, V]: the training
    # forward (the JAX ModelApi's ``apply``).
    apply: Callable[..., object]


def get_model(cfg: ModelConfig) -> ModelApi:
    if cfg.family == "gpt2":
        from pytorch_distributed_tpu_torch.models import gpt2

        return ModelApi(gpt2.init, gpt2.head, gpt2.apply)
    if cfg.family == "llama":
        from pytorch_distributed_tpu_torch.models import llama

        # Serving only: llama.apply (training) raises NotImplementedError.
        return ModelApi(llama.init, llama.head, llama.apply)
    raise NotImplementedError(
        f"model family {cfg.family!r} is not ported (gpt2, llama)"
    )
