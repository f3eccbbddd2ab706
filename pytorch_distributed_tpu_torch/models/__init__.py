"""Model families: ``get_model(cfg)`` returns the family's functions (the
port of the JAX package's ``models/__init__.py``)."""

from __future__ import annotations

from typing import Callable, NamedTuple

from pytorch_distributed_tpu_torch.config import ModelConfig


class ModelApi(NamedTuple):
    init: Callable[..., dict]
    head: Callable[..., object]
    # (params, input_ids [B, T], cfg, *, deterministic, dropout_seed,
    # return_aux, return_hidden, block_transform, tp_group, seq_group,
    # expert_group, prefetch_buffers)
    # -> logits [B, T, V] (or hidden [B, T, E]; with return_aux, a pair
    # with the summed MoE Switch term): the training forward (the JAX
    # ModelApi's ``apply``; ``tp_group`` is its ``tensor_axis``,
    # ``seq_group`` its ``seq_axis``, ``expert_group`` its
    # ``expert_axis``).
    apply: Callable[..., object]
    # (params) -> (head weight, ops.losses layout tag): the LM-head matrix
    # the fused head + cross-entropy multiplies against — the tied wte
    # [V, E] ("ve") for gpt2, the untied lm_head [E, V] ("ev") for llama.
    head_weight: Callable[[dict], tuple]
    # ln_f alone: head() without the vocab product.
    final_norm: Callable[..., object]
    # The pipeline's phase functions (``parallel/pipeline``; ``apply`` is
    # built from them): (params, input_ids, cfg, *, seq_group) -> the
    # embedded [B, T, E] in cfg.dtype (GPT-2: wte + wpe, no dropout);
    # (blocks, x, cfg, *, block_transform, return_aux, tp_group,
    # seq_group, expert_group, dropout_seed, deterministic, layer_offset,
    # prefetch_buffers) -> x (with return_aux: (x, the layers' Switch
    # term)) over a list of layers, all of them or a stage's.
    embed: Callable[..., object]
    run_blocks: Callable[..., object]


def get_model(cfg: ModelConfig) -> ModelApi:
    if cfg.family == "gpt2":
        from pytorch_distributed_tpu_torch.models import gpt2

        return ModelApi(gpt2.init, gpt2.head, gpt2.apply,
                        lambda params: (params["wte"], "ve"),
                        gpt2.final_norm, gpt2.embed, gpt2.run_blocks)
    if cfg.family == "llama":
        from pytorch_distributed_tpu_torch.models import llama

        return ModelApi(llama.init, llama.head, llama.apply,
                        lambda params: (params["lm_head"], "ev"),
                        llama.final_norm, llama.embed, llama.run_blocks)
    raise NotImplementedError(
        f"model family {cfg.family!r} is not ported (gpt2, llama)"
    )
