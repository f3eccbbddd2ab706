"""Typed model configuration for the PyTorch port.

The same frozen dataclass, field names, defaults and presets as the JAX
package's ``config.ModelConfig`` / ``model_config``, so one set of keyword
arguments describes a model to both packages (the tests build each side's
config from the same dict). ``TrainConfig`` likewise mirrors the JAX
package's training config; the mesh and data configs arrive with the
slices that use them.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any


@dataclass(frozen=True)
class ModelConfig:
    """Transformer architecture config (GPT-2 field conventions:
    n_embd/n_head/n_layer/n_ctx, vocab_size, activation_function,
    layer_norm_epsilon, *_pdrop)."""

    # "gpt2" (learned positions, LayerNorm, gelu MLP, tied head) or
    # "llama" (RoPE, RMSNorm, SwiGLU, untied head; served, not yet trained).
    family: str = "gpt2"

    vocab_size: int = 50257
    n_ctx: int = 1024  # max sequence length (positional table size for gpt2)
    n_embd: int = 768
    n_layer: int = 12
    n_head: int = 12
    # Defaults to n_head (no GQA); llama-family configs may set fewer KV heads.
    n_kv_head: int | None = None
    # MLP hidden size; None -> 4*n_embd (gpt2) or the llama 8/3 rule rounded.
    n_inner: int | None = None

    activation_function: str = "gelu_new"
    layer_norm_epsilon: float = 1e-5
    rope_theta: float = 10000.0

    embd_pdrop: float = 0.1
    attn_pdrop: float = 0.1
    resid_pdrop: float = 0.1
    tensor_dropout: str = "reject"

    # Numerics: params kept in param_dtype, activations computed in dtype.
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    # Dtype the LM head emits (the head always accumulates in float32).
    logits_dtype: str = "float32"

    # Training-path knobs (fused_head_ce, remat and attention_impl are read
    # by the training forward; the rest are carried so a config
    # round-trips between the two packages unchanged).
    fused_head_ce: bool = False
    remat: str = "dots"
    scan_unroll: int = 1
    attention_impl: str = "naive"
    seq_impl: str = "ring"

    n_experts: int = 0
    expert_capacity_factor: float = 1.25
    moe_aux_coef: float = 0.01
    moe_top_k: int = 1
    moe_dispatch: str = "auto"

    def __post_init__(self) -> None:
        if self.n_embd % self.n_head != 0:
            raise ValueError(
                f"n_embd={self.n_embd} not divisible by n_head={self.n_head}"
            )
        if self.family not in ("gpt2", "llama"):
            raise ValueError(f"unknown model family: {self.family!r}")
        if self.attention_impl not in ("naive", "flash"):
            raise ValueError(
                f"unknown attention_impl: {self.attention_impl!r} "
                "(implemented: naive, flash)"
            )
        if self.seq_impl not in ("ring", "ulysses"):
            raise ValueError(
                f"unknown seq_impl: {self.seq_impl!r} "
                "(implemented: ring, ulysses)"
            )
        if self.n_experts and not (1 <= self.moe_top_k <= self.n_experts):
            raise ValueError(
                f"moe_top_k={self.moe_top_k} out of range for "
                f"n_experts={self.n_experts}"
            )
        if self.moe_dispatch not in ("auto", "einsum", "sort"):
            raise ValueError(
                f"unknown moe_dispatch: {self.moe_dispatch!r} "
                "(implemented: auto, einsum, sort)"
            )
        if self.scan_unroll < 1:
            raise ValueError(
                f"scan_unroll must be >= 1, got {self.scan_unroll}"
            )
        if self.tensor_dropout not in ("reject", "folded"):
            raise ValueError(
                f"unknown tensor_dropout: {self.tensor_dropout!r} "
                "(implemented: reject, folded)"
            )

    @property
    def head_dim(self) -> int:
        return self.n_embd // self.n_head

    @property
    def kv_heads(self) -> int:
        return self.n_kv_head if self.n_kv_head is not None else self.n_head

    @property
    def inner_dim(self) -> int:
        if self.n_inner is not None:
            return self.n_inner
        if self.family == "llama":
            # Llama FFN rule: 2/3 * 4d, rounded up to a multiple of 256.
            return ((8 * self.n_embd // 3) + 255) // 256 * 256
        return 4 * self.n_embd

    def replace(self, **kw: Any) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


# HF AutoConfig shapes (gpt2 .. gpt2-xl), the GPT-3 XL shape, and the
# CPU smoke-test shape.
_GPT2_PRESETS: dict[str, dict[str, Any]] = {
    "gpt2": dict(n_embd=768, n_layer=12, n_head=12),  # 124M
    "gpt2-medium": dict(n_embd=1024, n_layer=24, n_head=16),  # 355M
    "gpt2-large": dict(n_embd=1280, n_layer=36, n_head=20),  # 774M
    "gpt2-xl": dict(n_embd=1600, n_layer=48, n_head=25),  # 1.56B
    "gpt2-1p3b": dict(n_embd=2048, n_layer=24, n_head=16),  # 1.31B
    "tiny": dict(
        vocab_size=256, n_ctx=128, n_embd=64, n_layer=2, n_head=4,
        dtype="float32",
    ),
}

_LLAMA_PRESETS: dict[str, dict[str, Any]] = {
    # Llama-3.2-1B / Llama-3.1-8B shapes.
    "llama3-1b": dict(
        vocab_size=128256, n_ctx=8192, n_embd=2048, n_layer=16, n_head=32,
        n_kv_head=8, n_inner=8192, rope_theta=500000.0,
    ),
    "llama3-8b": dict(
        vocab_size=128256, n_ctx=8192, n_embd=4096, n_layer=32, n_head=32,
        n_kv_head=8, n_inner=14336, rope_theta=500000.0,
    ),
}


@dataclass(frozen=True)
class TrainConfig:
    """Training config: the JAX package's ``config.TrainConfig`` field for
    field, with the same defaults. The port's ``train/trainer`` reads the
    optimizer, schedule, accumulation, seed, logging, checkpoint, metrics
    and preemption fields; the anomaly-guard fields are carried so a
    config round-trips between the packages, and the trainer refuses
    ``anomaly_guard`` and ``async_checkpoint`` (not ported yet)."""

    global_batch_size: int = 32
    micro_batch_size: int = 8
    num_steps: int = 20
    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8
    grad_clip_norm: float | None = None
    # Exclude rank<2 params (norm scales, biases) from weight decay.
    decay_exclude_1d: bool = False
    # Gradient-accumulation buffer dtype (A > 1 only).
    accum_dtype: str = "float32"
    # Cosine anneal to min_lr_ratio * learning_rate over num_steps, after
    # warmup_steps of linear warmup.
    lr_schedule: str = "cosine"
    min_lr_ratio: float = 0.1
    warmup_steps: int = 0

    seed: int = 42
    log_every_n_steps: int = 10
    save_every_n_steps: int | None = None
    checkpoint_dir: str = "checkpoints"
    keep_checkpoints: int | None = None
    async_checkpoint: bool = False

    def __post_init__(self) -> None:
        if self.keep_checkpoints is not None and self.keep_checkpoints < 1:
            raise ValueError(
                f"keep_checkpoints must be >= 1 or None, got "
                f"{self.keep_checkpoints}"
            )
        if self.accum_dtype not in ("float32", "bfloat16"):
            raise ValueError(
                f"unknown accum_dtype: {self.accum_dtype!r} "
                "(implemented: float32, bfloat16)"
            )
        if self.anomaly_guard:
            # The JAX package's GuardConfig checks, restated.
            if self.guard_spike_factor <= 1.0:
                raise ValueError(f"spike_factor must be > 1, got "
                                 f"{self.guard_spike_factor}")
            if not 0.0 < self.guard_ema_decay < 1.0:
                raise ValueError(f"ema_decay must be in (0, 1), got "
                                 f"{self.guard_ema_decay}")
            if self.guard_warmup_steps < 1:
                raise ValueError(f"warmup_steps must be >= 1, got "
                                 f"{self.guard_warmup_steps}")
            if (self.guard_rollback_after is not None
                    and self.guard_rollback_after < 1):
                raise ValueError(
                    f"rollback_after must be >= 1 or None, got "
                    f"{self.guard_rollback_after}"
                )
            if self.guard_max_rollbacks < 1:
                raise ValueError(
                    f"guard_max_rollbacks must be >= 1, got "
                    f"{self.guard_max_rollbacks}"
                )

    # Traced anomaly guard (JAX package: train/guard.py); not ported.
    anomaly_guard: bool = False
    guard_spike_factor: float = 3.0
    guard_ema_decay: float = 0.98
    guard_warmup_steps: int = 10
    guard_rollback_after: int | None = 3
    guard_max_rollbacks: int = 8
    guard_skip_window: bool = False
    metrics_path: str | None = None
    save_on_preemption: bool = False
    preemption_sync_every_n_steps: int = 1

    def grad_accum_steps(self, data_parallel_size: int = 1) -> int:
        """Micro-batches per optimizer step: global // (micro * dp)."""
        denom = self.micro_batch_size * data_parallel_size
        if self.global_batch_size % denom != 0:
            raise ValueError(
                f"global_batch_size={self.global_batch_size} must be divisible "
                f"by micro_batch_size*dp={denom}"
            )
        return self.global_batch_size // denom


def model_config(name: str, **overrides: Any) -> ModelConfig:
    """Look up a preset by name, then apply ``overrides``."""
    if name in _GPT2_PRESETS:
        base: dict[str, Any] = dict(family="gpt2", **_GPT2_PRESETS[name])
    elif name in _LLAMA_PRESETS:
        base = dict(
            family="llama",
            activation_function="silu",
            layer_norm_epsilon=1e-5,
            embd_pdrop=0.0,
            attn_pdrop=0.0,
            resid_pdrop=0.0,
            **_LLAMA_PRESETS[name],
        )
    else:
        raise KeyError(
            f"unknown model preset {name!r}; known: "
            f"{sorted(_GPT2_PRESETS) + sorted(_LLAMA_PRESETS)}"
        )
    base.update(overrides)
    return ModelConfig(**base)
