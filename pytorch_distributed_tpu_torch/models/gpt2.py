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
  (MoE, X = n_experts: mlp {router [E, X], w_in [X, E, F], w_out [X, F, E]})
  ln_f {scale[E], bias[E]}

The LM head is tied to wte (no separate leaf). ``apply`` is the training
forward, built from the phase functions the pipeline calls (``embed``,
``run_blocks``, ``final_norm``, ``head``): ``run_blocks`` loops over the
blocks through ``ops/layer_scan.scan_layers``, each block wrapped by
``ops.remat.apply_remat(cfg.remat)``, attention through
``ops.attention.multi_head_attention(impl=cfg.attention_impl)``. In
training mode (``deterministic=False``) it draws the embedding, attention
and residual dropout masks from stream ids (``utils/prng``) that mirror
the JAX key chain: the embedding's, then per layer attention, residual
after ``attn_proj``, residual after ``mlp_proj``.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from pytorch_distributed_tpu_torch.config import ModelConfig
from pytorch_distributed_tpu_torch.ops.attention import multi_head_attention
from pytorch_distributed_tpu_torch.ops.layer_scan import scan_layers
from pytorch_distributed_tpu_torch.ops.layers import (
    activation,
    dense,
    dropout,
    layer_norm,
)
from pytorch_distributed_tpu_torch.ops.moe import moe_mlp
from pytorch_distributed_tpu_torch.ops.remat import checkpoint_name
from pytorch_distributed_tpu_torch.ops.tp import tp_copy
from pytorch_distributed_tpu_torch.utils import prng
from pytorch_distributed_tpu_torch.utils.device import resolve_device

Params = dict[str, Any]


def seq_span(t: int, seq_group) -> tuple[int, int]:
    """(this rank's first position, the global length) of a sequence of
    ``t`` tokens a rank split over ``seq_group`` (None: (0, t))."""
    if seq_group is None:
        return 0, t
    import torch.distributed as dist

    return dist.get_rank(seq_group) * t, dist.get_world_size(seq_group) * t


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

    def mlp():
        x = cfg.n_experts
        if not x:
            return {
                "c_fc": {"kernel": normal((e, f), 0.02), "bias": zeros(f)},
                "c_proj": {"kernel": normal((f, e), 0.02), "bias": zeros(e)},
            }
        # Switch-routed experts (ops/moe): a router and stacked expert
        # kernels, no biases.
        return {"router": normal((e, x), 0.02),
                "w_in": normal((x, e, f), 0.02),
                "w_out": normal((x, f, e), 0.02)}

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
            "mlp": mlp(),
        }
        for _ in range(cfg.n_layer)
    ]
    params["ln_f"] = ln()
    return params


def _block(x: torch.Tensor, bp: Params, layer: int, *, cfg: ModelConfig,
           key: prng.DropoutKey | None, tp_group=None, seq_group=None,
           expert_group=None) -> torch.Tensor:
    """Pre-norm residual block: x + drop(attn(ln_1(x))); x +
    drop(mlp(ln_2(x))), the MLP dense or, for a MoE config, ``ops/moe``'s
    experts. ``key`` None: deterministic; else the masks of ``layer``
    derive from it. The projections the remat policies keep are tagged as
    in the JAX model (``qkv``, ``attn_proj``, ``mlp_fc``, ``mlp_proj``;
    the naive attention output ``attn_out``). Returns x, or (x, aux) for a
    MoE config (aux: the layer's Switch term). ``tp_group``: Megatron tensor parallelism over
    that group (the JAX ``tensor_axis``): ``bp`` holds this rank's heads
    and MLP columns, ``tp_copy`` follows each norm, and the row-parallel
    ``c_proj``s sum their partials over the group before their bias.
    ``seq_group``: the sequence is split over that group (the JAX
    ``seq_axis``): ``x`` holds this rank's tokens, and attention crosses
    the ranks by ``cfg.seq_impl`` (``ops/attention``). ``expert_group``:
    expert parallelism over that group (the JAX ``expert_axis``): ``bp``'s
    MoE experts are this rank's share, and ``ops/moe`` moves each token to
    its experts' owner and back."""
    eps = cfg.layer_norm_epsilon
    det = key is None
    sid = (lambda site: None) if det else (
        lambda site: prng.stream_id(key, layer, site))
    b, t = x.shape[:2]
    a = tp_copy(layer_norm(x, bp["ln_1"], eps=eps), tp_group)
    with checkpoint_name("qkv"):
        qkv = dense(a, bp["attn"]["c_attn"])  # [B, T, 3, H(local), D]
    q, k, v = qkv.unbind(2)
    a = multi_head_attention(
        q, k, v, impl=cfg.attention_impl, causal=True,
        dropout_rate=cfg.attn_pdrop, dropout_sid=sid("attn"),
        deterministic=det, out_name="attn_out", seq_group=seq_group,
        seq_impl=cfg.seq_impl,
    ).reshape(b, t, -1)
    with checkpoint_name("attn_proj"):
        a = dense(a, bp["attn"]["c_proj"], tp_group=tp_group)
    x = x + dropout(a, cfg.resid_pdrop, sid("resid_attn"), deterministic=det)
    m = layer_norm(x, bp["ln_2"], eps=eps)
    aux = None
    if cfg.n_experts:
        m, aux = moe_mlp(m, bp["mlp"],
                         activation=activation(cfg.activation_function),
                         capacity_factor=cfg.expert_capacity_factor,
                         expert_axis=expert_group,
                         tensor_axis=tp_group, top_k=cfg.moe_top_k,
                         dispatch_impl=cfg.moe_dispatch)
    else:
        m = tp_copy(m, tp_group)
        with checkpoint_name("mlp_fc"):
            m = dense(m, bp["mlp"]["c_fc"])
        m = activation(cfg.activation_function)(m)
        with checkpoint_name("mlp_proj"):
            m = dense(m, bp["mlp"]["c_proj"], tp_group=tp_group)
    x = x + dropout(m, cfg.resid_pdrop, sid("resid_mlp"), deterministic=det)
    return x if aux is None else (x, aux)


def apply(params: Params, input_ids: torch.Tensor, cfg: ModelConfig, *,
          deterministic: bool = True,
          dropout_seed: prng.DropoutKey | None = None,
          return_aux: bool = False, return_hidden: bool = False,
          block_transform=None, tp_group=None, seq_group=None,
          expert_group=None, prefetch_buffers: int = 0):
    """Forward pass: [B, T] token ids -> [B, T, V] logits in
    ``cfg.logits_dtype``: ``embed``, embedding dropout, ``run_blocks``
    (n_layer pre-norm blocks, each under ``cfg.remat``), ln_f, tied head.
    ``deterministic=False`` (training) draws the dropout masks from
    ``dropout_seed`` and raises without one, as the JAX ``apply`` does
    without a key. ``return_hidden``: the final-norm hidden states
    [B, T, E] in place of the logits (what ``ops/losses.
    linear_cross_entropy`` consumes). ``return_aux``: also the MoE Switch
    term summed over layers (an f32 scalar, 0 for a dense config). Under
    ``torch.no_grad`` the blocks run without checkpointing: there is no
    backward to recompute for. ``block_transform``: a function of one
    layer's params run at the start of that layer, inside its checkpoint
    (ZeRO-3's just-in-time gather, ``parallel/explicit``: a remat mode
    then gathers again in backward, as JAX's remat does), and
    ``prefetch_buffers`` its prefetch window (``ops/layer_scan``).
    ``tp_group``: the blocks' tensor group (``_block``); the embeddings,
    the final norm and the head are replicated, so the logits are the
    same on every tensor rank. Under it the attention masks take
    ``dropout_seed``'s ``tensor`` field (``utils/prng``; set by
    ``parallel/explicit`` under ``tensor_dropout="folded"``).
    ``seq_group``: ``input_ids`` are this rank's slice of a sequence split
    over that group (the JAX ``seq_axis``), rank i's the positions
    ``[i T, (i+1) T)``: its position rows are those, the global length
    (ranks x T) must fit ``n_ctx``, and the logits are this rank's
    tokens'. ``expert_group``: the MoE blocks' expert group (``_block``;
    the rows of ``input_ids`` are this rank's)."""
    if not deterministic and dropout_seed is None:
        raise ValueError("training-mode apply() requires dropout_seed")
    x = embed(params, input_ids, cfg, seq_group=seq_group)
    if not deterministic:
        x = embed_dropout(x, cfg, prng.DropoutKey(*dropout_seed))
    x = run_blocks(params["blocks"], x, cfg, block_transform=block_transform,
                   return_aux=return_aux, tp_group=tp_group,
                   seq_group=seq_group, expert_group=expert_group,
                   dropout_seed=dropout_seed, deterministic=deterministic,
                   prefetch_buffers=prefetch_buffers)
    x, aux = x if return_aux else (x, None)
    out = final_norm(params, x, cfg) if return_hidden else \
        head(params, x, cfg)
    return (out, aux) if return_aux else out


# -- phase functions (pipeline parallelism, ``parallel/pipeline``) ------------
# The forward split where the pipeline splits it: embed | blocks | head;
# ``apply`` is built from them, so the two paths cannot drift.


def embed(params: Params, input_ids: torch.Tensor, cfg: ModelConfig, *,
          seq_group=None) -> torch.Tensor:
    """wte + wpe rows, in ``cfg.dtype``. ``seq_group``: ``input_ids`` are
    this rank's span of a sequence split over it, whose position rows are
    taken (``apply``)."""
    t = input_ids.shape[1]
    start, global_t = seq_span(t, seq_group)
    if global_t > cfg.n_ctx:
        raise ValueError(
            f"sequence length {global_t} exceeds n_ctx {cfg.n_ctx}")
    x = F.embedding(input_ids, params["wte"]) + \
        params["wpe"][start:start + t]
    return x.to(_dtype(cfg.dtype))


def embed_dropout(x: torch.Tensor, cfg: ModelConfig,
                  key: prng.DropoutKey) -> torch.Tensor:
    """The embedding's dropout mask of ``key`` (its stream id's layer is
    ``prng.EMBD_LAYER``)."""
    return dropout(x, cfg.embd_pdrop,
                   prng.stream_id(key, prng.EMBD_LAYER, "embd"),
                   deterministic=False)


def run_blocks(blocks: list, x: torch.Tensor, cfg: ModelConfig, *,
               block_transform=None, return_aux: bool = False,
               tp_group=None, seq_group=None, expert_group=None,
               dropout_seed: prng.DropoutKey | None = None,
               deterministic: bool = True, layer_offset: int = 0,
               prefetch_buffers: int = 0):
    """The blocks of ``blocks`` (all of the model's, or a pipeline
    stage's) over ``x`` through ``ops/layer_scan.scan_layers``, each under
    ``cfg.remat`` (none under ``torch.no_grad``). Returns x, or with
    ``return_aux`` (x, the Switch term summed over these layers: an f32
    scalar, 0 for a dense config). ``layer_offset``: the global id of the
    first layer, so a stage draws the dropout masks of the global layer
    ids (``utils/prng.stream_id``), the single-device forward's. The rest
    as ``apply``."""
    if not deterministic and dropout_seed is None:
        raise ValueError("training-mode run_blocks requires dropout_seed")
    key = None if deterministic else prng.DropoutKey(*dropout_seed)
    moe = bool(cfg.n_experts)

    def block_fn(carry, bp, layer):
        h = carry[0] if moe else carry
        out = _block(h, bp, layer, cfg=cfg, key=key, tp_group=tp_group,
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
        list(range(layer_offset, layer_offset + len(blocks))),
        remat_mode=cfg.remat if torch.is_grad_enabled() else "none",
        block_transform=block_transform, prefetch_buffers=prefetch_buffers)
    if not return_aux:
        return carry[0] if moe else carry
    if moe:
        return carry
    return carry, torch.zeros((), dtype=torch.float32, device=x.device)


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
