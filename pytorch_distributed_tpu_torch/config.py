"""Typed model configuration for the PyTorch port.

The same frozen dataclass, field names, defaults and presets as the JAX
package's ``config.ModelConfig`` / ``model_config``, so one set of keyword
arguments describes a model to both packages (the tests build each side's
config from the same dict). ``TrainConfig`` likewise mirrors the JAX
package's training config, and ``MeshConfig`` its mesh config (the port
trains over its data, fsdp and tensor axes; the others raise, naming the
ROADMAP item that ports them).
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
    # "llama" (RoPE, RMSNorm, SwiGLU, untied head).
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
    # Attention dropout under tensor parallelism (the explicit step):
    # "reject" refuses attn_pdrop > 0 there, as JAX does; "folded" draws
    # each tensor rank's local heads from a stream with the rank's tensor
    # index folded in (``utils/prng``), statistically the single-device
    # draw, not bitwise; embd and resid masks stay replicated.
    tensor_dropout: str = "reject"

    # Numerics: params kept in param_dtype, activations computed in dtype.
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    # Dtype the LM head emits (the head always accumulates in float32).
    logits_dtype: str = "float32"

    # Training-path knobs (fused_head_ce, remat, attention_impl and the MoE
    # fields below are read by the training forward; scan_unroll and
    # seq_impl are carried so a config round-trips between the two
    # packages unchanged).
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
    optimizer, schedule, accumulation, seed, logging, checkpoint (the
    async save included), metrics, preemption and anomaly-guard fields
    (``train/guard``)."""

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

    # The anomaly guard (train/guard).
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


# The mesh axes the port has not taken yet, each with the ROADMAP queue 1
# item that ports it.
_AXIS_NOT_PORTED = {
    "pipe": "ROADMAP queue 1 item 7(d), pipeline parallelism",
    "expert": "ROADMAP queue 1 item 7(e), expert parallelism",
}


@dataclass(frozen=True)
class MeshConfig:
    """The JAX package's ``MeshConfig``, field for field with the same
    defaults. The port's mesh is one rank (process) per device
    (``parallel/mesh``): ``data`` replicates the model, ``fsdp`` shards it
    by ``strategy`` — "full_shard" (ZeRO-3: params, grads and optimizer
    state sharded), "shard_grad_op" (ZeRO-2: grads and optimizer state),
    "shard_opt" (ZeRO-1: optimizer state only) or "no_shard" (DDP) — and
    ``rs_buckets`` > 0 coalesces ZeRO-2's gradient reduce-scatters into
    about that many bucketed collectives. ``tensor`` > 1 is Megatron
    tensor parallelism, in training (the explicit step behind
    ``parallel.api.make_parallel_train_step``, the ``DistributedTrainer``
    and the ``train.parallel`` twin; alone and with every strategy) and
    in the decode paths (``models/decode.generate_tp`` and every engine's
    ``mesh_cfg``). ``seq`` > 1 splits each sequence over that axis in
    training (sequence parallelism: ring or Ulysses attention by the model
    config's ``seq_impl``, ``ops/ring_attention``, ``ops/ulysses``),
    alone and with the axes above. ``pipe`` and ``expert`` > 1 raise
    NotImplementedError here, naming the items that port them (7(d),
    7(e)), and so does
    ``prefetch_buffers`` > 0 (the JAX layer scan's prefetch window, item
    7(d); the port's ZeRO-3 decode gathers each layer just in time).
    ``device_ids``: the CUDA device each mesh rank uses, in rank order
    (None: the rank's ``LOCAL_RANK``)."""

    data: int = 1
    fsdp: int = 1
    tensor: int = 1
    seq: int = 1
    pipe: int = 1
    expert: int = 1
    strategy: str = "full_shard"
    pipe_schedule: str = "gpipe"
    prefetch_buffers: int = 0
    rs_buckets: int = 0
    axis_order: tuple[str, ...] = (
        "pipe", "data", "fsdp", "expert", "seq", "tensor"
    )
    device_ids: tuple[int, ...] | None = None

    def __post_init__(self) -> None:
        if self.device_ids is not None:
            ids = tuple(int(d) for d in self.device_ids)
            object.__setattr__(self, "device_ids", ids)
            if len(set(ids)) != len(ids):
                raise ValueError(f"device_ids must be unique, got {ids}")
            if len(ids) != self.num_devices:
                raise ValueError(
                    f"device_ids has {len(ids)} entries but the mesh "
                    f"needs {self.num_devices} devices"
                )
        if self.strategy not in (
            "full_shard", "shard_grad_op", "shard_opt", "no_shard"
        ):
            raise ValueError(f"unknown FSDP strategy: {self.strategy!r}")
        if self.pipe_schedule not in ("gpipe", "1f1b"):
            raise ValueError(
                f"unknown pipe_schedule: {self.pipe_schedule!r} "
                "(implemented: gpipe, 1f1b)"
            )
        if self.prefetch_buffers < 0:
            raise ValueError(
                f"prefetch_buffers must be >= 0, got {self.prefetch_buffers}"
            )
        if self.rs_buckets < 0:
            raise ValueError(
                f"rs_buckets must be >= 0, got {self.rs_buckets}"
            )
        for axis, item in _AXIS_NOT_PORTED.items():
            if getattr(self, axis) > 1:
                raise NotImplementedError(
                    f"mesh axis {axis}={getattr(self, axis)} is not ported: "
                    f"{item}; the port's mesh has the data, fsdp, seq "
                    "and tensor axes"
                )
        if self.prefetch_buffers > 0:
            raise NotImplementedError(
                f"prefetch_buffers={self.prefetch_buffers} is not ported: "
                "the layer scan's prefetch window is ROADMAP queue 1 item "
                "7(d); the port gathers each layer just in time"
            )

    @property
    def num_devices(self) -> int:
        return (
            self.data * self.fsdp * self.tensor * self.seq * self.pipe
            * self.expert
        )

    @property
    def shape(self) -> dict[str, int]:
        return {ax: getattr(self, ax) for ax in self.axis_order}
