"""KV-cache decoding: the forward pass of every serving engine, the
sampler, and the single-request generation paths.

The port of the JAX package's ``models/decode.py``, for the gpt2 and
llama families, dense and MoE. One ``forward`` serves prefill (T tokens
per row) and the single-token decode step (T = 1) over either cache
layout:

- **dense** (``init_cache``): ``k``/``v`` of [L, B, max_len, Hkv, D].
  ``pos`` is an int (every row at one position: the serial paths) or a
  [B] tensor (slot-batched decode, each row at its own position). New
  K/V are written in place at each row's offsets; a multi-token window
  that runs past ``max_len`` (a speculative verify window near a row's
  end) writes nothing past it, as the JAX package's ``mode="drop"``
  scatter;
- **paged** (``init_paged_cache``, with ``block_tables``): pools ``k``/
  ``v`` of [L, P, page, Hkv, D]; row b's token at position j lives at
  page ``block_tables[b, j // page]``, offset ``j % page``. Page 0 is the
  scratch page: free and mid-prefill rows of a decode step run with
  position 0 and an all-zero table, so they write and read page 0, which
  no live row's table points at;
- new K/V are written INTO the cache in place (``index_put_``) before the
  attention reads it — the JAX package returns an updated cache from a
  pure function instead; the values written are the same;
- attention for a single-token paged step with ``paged_impl="kernel"``
  goes through the paged decode kernel (``ops/paged_kernel``), which reads
  pages in place and only up to each row's depth; so does a multi-token
  decode window (``decode_window``: a speculative verify forward), each
  query a single-token row of its own at its position. Every other call —
  dense attention, paged prefill chunks, and decode with
  ``paged_impl="gather"`` — runs the masked softmax in plain
  PyTorch (``ops/paged_kernel.masked_attention``, also the kernel's plain
  version), with float32 scores (``preferred_element_type=float32`` in
  the JAX package);
- ``kv_quant="int8"`` (paged only): the pools are int8 with f32 scale
  pools ``k_scale``/``v_scale`` of [L, P, page, Hkv] beside them. New K/V
  are QUANTIZED ON APPEND (``ops/quant.quantize_kv``, one scale per token
  and KV head), so writing a token never touches its neighbours' values.
  The kernel path hands the scale pools to the int8 kernel (K4); the
  gather path dequantizes the gathered view to the activation dtype.
  Weights quantized by ``ops/quant.quantize_decode_params`` go through
  ``ops/quant.qdot`` in every projection, whatever ``kv_quant`` is;
- MoE configs route each token through ``ops/moe.moe_mlp`` at the
  no-drop capacity (``_moe_mlp``); routing is per token and cache-free;
- ``lora=(layers, rows)`` adds each row's multi-tenant low-rank delta
  (``serving/adapters``) to the query and attention-output projections
  (``ops/lora_kernel.lora_delta_add``: the JAX package's lowering on the
  CPU, one kernel on the card); slot 0 is the exact-zero adapter;
- the layers run in a Python loop over the per-layer params list (the JAX
  package scans over stacked layers);
- ``tp_group`` (tensor parallelism, the JAX package's ``tensor_axis``):
  the block params are this rank's Megatron slices
  (``parallel/sharding``) and the cache holds this rank's KV heads
  (``init_cache``/``init_paged_cache`` with ``n_kv``), so attention runs on
  local heads (K3/K4 on each rank's own heads); each row-parallel
  projection (attention output, MLP down) issues ONE all-reduce over the
  group (``ops/layers.dense_epilogue``), after its partial product, the
  LoRA delta and the int8 scale and before its bias: 2 a layer, whatever
  the rows, int8 or adapters. Embeddings, norms and the head are
  replicated, so every rank computes the same logits;
- ``block_transform`` (ZeRO-3 decode): applied to each layer's params
  before the layer runs (the just-in-time all-gather of its shards).

Sampling: greedy rows take the float32 argmax; a sampled draw uses a
``torch.Generator`` seeded by (request seed, token index), so a sampled
token is a pure function of (seed, index, logits) whatever the row's
neighbours. JAX's threefry stream cannot be reproduced, so parity with
the JAX package holds on greedy rows only.

Generation: ``generate_monolithic`` is the plain reference loop (prefill,
then one forward per token); ``generate`` is the shim over
``serving.engine.DecodeEngine``. The meshed forms run on every rank of a
``torch.distributed`` group (one process a rank, the same call on each):
``generate_tp`` (Megatron-sharded params, a local-head KV cache, the TP
``DecodeEngine``) and ``generate_fsdp`` (ZeRO-3: params kept as this
rank's full_shard slices, each layer all-gathered just in time through
``parallel/zero``, no prefetch window), each with its ``_monolithic``
reference loop. Both take the FULL params on every rank and keep this
rank's slices; the output is the same on every rank.
"""

from __future__ import annotations

import functools
from typing import Any

import numpy as np
import torch

from pytorch_distributed_tpu_torch.config import ModelConfig
from pytorch_distributed_tpu_torch.models import get_model
from pytorch_distributed_tpu_torch.ops import lora_kernel, paged_kernel
from pytorch_distributed_tpu_torch.ops.layers import (
    activation,
    dense,
    dense_epilogue,
    layer_norm,
    rms_norm,
)
from pytorch_distributed_tpu_torch.ops.quant import (
    check_mode,
    qdot,
    quantize_kv,
)
from pytorch_distributed_tpu_torch.ops.rope import apply_rope, rope_angles
from pytorch_distributed_tpu_torch.utils.device import resolve_device

Params = dict[str, Any]
Cache = dict[str, torch.Tensor]

def init_cache(
    cfg: ModelConfig, batch: int, max_len: int, dtype=None,
    device: str | torch.device | None = None, n_kv: int | None = None,
) -> Cache:
    """Zeroed dense ``k``/``v`` of [L, batch, max_len, Hkv, D] in
    ``dtype`` (default ``cfg.dtype``) on ``device`` (None: the GPU);
    ``n_kv``: the KV heads this rank holds (tensor parallelism; default
    all of them)."""
    if max_len > cfg.n_ctx:
        raise ValueError(f"max_len {max_len} exceeds n_ctx {cfg.n_ctx}")
    device = resolve_device(device)
    dtype = dtype or getattr(torch, cfg.dtype)
    shape = (cfg.n_layer, batch, max_len, n_kv or cfg.kv_heads,
             cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
    }


def init_paged_cache(
    cfg: ModelConfig, pool_pages: int, page_size: int, dtype=None,
    device: str | torch.device | None = None, kv_quant: str = "none",
    n_kv: int | None = None,
) -> Cache:
    """Zeroed paged pools ``k``/``v`` of [L, pool_pages, page_size, Hkv, D]
    in ``dtype`` (default ``cfg.dtype``) on ``device`` (None: the GPU,
    ``utils.device.resolve_device``); page 0 is the scratch page.
    ``kv_quant="int8"``: int8 pools (zeros) and f32 scale pools
    ``k_scale``/``v_scale`` of [L, pool_pages, page_size, Hkv] (ones).
    ``n_kv``: the KV heads this rank holds (a head-sharded pool under
    tensor parallelism; default all of them)."""
    check_mode("kv_quant", kv_quant)
    device = resolve_device(device)
    shape = (cfg.n_layer, pool_pages, page_size, n_kv or cfg.kv_heads,
             cfg.head_dim)
    if kv_quant == "int8":
        return {
            "k": torch.zeros(shape, dtype=torch.int8, device=device),
            "v": torch.zeros(shape, dtype=torch.int8, device=device),
            "k_scale": torch.ones(shape[:-1], device=device),
            "v_scale": torch.ones(shape[:-1], device=device),
        }
    dtype = dtype or getattr(torch, cfg.dtype)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
    }


def _cached_attention(q, kv, pos, block_tables, paged_impl="gather",
                      kv_quant="none", valid=None, window=None):
    """q [B, T, H, D] at positions pos..pos+T-1 against one layer's cache
    ``kv``: dense rows [B, S, Hkv, D] (``block_tables`` None) or paged
    pools [P, page, Hkv, D] (plus the scale pools under int8); key j of
    row b is valid iff j <= pos[b] + i (``valid``, the [B, T, S] mask, when
    the forward made it once for all layers). ``window``: the ([B*T,
    n_pages] tables, [B*T] positions) of a decode window's per-query
    kernel rows. Returns [B, T, H, D] in the cache dtype (q's dtype for
    int8 pools)."""
    if block_tables is None:
        return paged_kernel.masked_attention(q, kv["k"], kv["v"], pos, valid)
    scales = ((kv["k_scale"], kv["v_scale"]) if kv_quant == "int8"
              else (None, None))
    if window is not None:
        b, t, h, d = q.shape
        out = paged_kernel.paged_decode_attention(
            q.reshape(b * t, h, d).contiguous(), kv["k"], kv["v"], *window,
            *scales,
        )
        return out.reshape(b, t, h, d)
    if q.shape[1] == 1 and paged_impl == "kernel":
        out = paged_kernel.paged_decode_attention(
            q[:, 0].contiguous(), kv["k"], kv["v"], block_tables, pos,
            *scales,
        )
        return out[:, None]
    return paged_kernel.gather_attention(q, kv["k"], kv["v"], block_tables,
                                         pos, *scales, valid=valid)


def _page_slots(pos, t, block_tables, page):
    """Where each new token goes in a paged pool: (page ids, in-page
    offsets), each [B, T]. Token i of row b lands at page
    ``table[b, (pos[b]+i) // page]``, offset ``(pos[b]+i) % page``; lanes
    past the table go to the scratch page 0 (as in the JAX package, which
    never clamps them onto a live page). The same for every layer, so
    ``forward`` computes it once."""
    n_pages = block_tables.shape[1]
    gpos = pos.long()[:, None] + torch.arange(t, device=pos.device)[None]
    pidx = gpos // page
    pids = torch.gather(block_tables.long(), 1, pidx.clamp(max=n_pages - 1))
    return torch.where(pidx < n_pages, pids, 0), gpos % page


def _dense_slots(pos, t, s):
    """Where each new token goes in a dense cache of ``s`` positions:
    (rows, positions), each [B, T], and the [B, T] mask of lanes inside
    the cache. A lane past ``s`` is dropped (JAX's ``mode="drop"``
    scatter): it is aimed at the row's position pos[b] - 1, which this
    call never writes, and writes back the value already there — never a
    clamp-shift onto a committed position. The same for every layer."""
    b = pos.shape[0]
    gpos = pos.long()[:, None] + torch.arange(t, device=pos.device)[None]
    inside = gpos < s
    # A lane can only pass s when pos[b] + t > s, so pos[b] >= 1 there.
    gpos = torch.where(inside, gpos, (pos.long()[:, None] - 1).clamp(min=0))
    rows = torch.arange(b, device=pos.device)[:, None].expand(b, t)
    return rows, gpos, inside


def _write(layer, new, slots) -> None:
    """Write new [B, T, ...] into one cache layer IN PLACE at ``slots``:
    paged (page ids, offsets) from ``_page_slots`` — distinct live rows own
    distinct pages (the block pool's copy-on-write discipline), so only
    scratch-page writes can collide; dense (rows, positions, inside) from
    ``_dense_slots``; or a dense (start, stop) slice at one position."""
    if isinstance(slots[0], int):
        layer[:, slots[0]:slots[1]] = new.to(layer.dtype)
        return
    if len(slots) == 3:
        rows, gpos, inside = slots
        if inside.shape[1] > 1:
            keep = layer[rows, gpos]
            mask = inside.reshape(inside.shape + (1,) * (new.dim() - 2))
            new = torch.where(mask, new.to(layer.dtype), keep)
        layer.index_put_((rows, gpos), new.to(layer.dtype))
        return
    layer.index_put_(slots, new.to(layer.dtype))


def _write_kv(kv, k_new, v_new, slots, kv_quant="none") -> None:
    """Write this step's [B, T, Hkv, D] K/V into one layer's cache in
    place. ``kv_quant="int8"`` quantizes the new tokens first and writes
    the values and their scales at the same slots."""
    if kv_quant == "int8":
        kq, ks = quantize_kv(k_new)
        vq, vs = quantize_kv(v_new)
        _write(kv["k"], kq, slots)
        _write(kv["v"], vq, slots)
        _write(kv["k_scale"], ks, slots)
        _write(kv["v_scale"], vs, slots)
        return
    _write(kv["k"], k_new, slots)
    _write(kv["v"], v_new, slots)


def _moe_mlp(m, mlp_params, cfg, act, tp_group=None):
    """Routed MLP for decode: routing is per token and cache-free, so only
    the capacity differs from training — the no-drop bound
    (``capacity_factor = n_experts``: every expert could take every
    assignment), as the JAX package's ``_moe_mlp``: a dropped token at
    inference would silently zero its MLP, and with no drops a row's
    output does not depend on the rows beside it. ``tp_group``: TP inside
    each expert (``ops/moe``), routing on the replicated activations."""
    from pytorch_distributed_tpu_torch.ops.moe import moe_mlp

    out, _ = moe_mlp(
        m, mlp_params, activation=act,
        capacity_factor=float(cfg.n_experts), top_k=cfg.moe_top_k,
        dispatch_impl=cfg.moe_dispatch, tensor_axis=tp_group,
    )
    return out


def _lane0(fn, x, *args, alone=False):
    """``fn(x, *args)`` over x [B, T, ...]; with ``alone``, lane 0 keeps
    the values of ``fn`` on x[:, :1] by itself, which are bit for bit
    those of a [B, 1] decode step: cuBLAS picks its f32 GEMM kernel by
    the rows in the call, so a row's last bits can depend on how many
    rows share it."""
    y = fn(x, *args)
    if alone:
        y[:, :1] = fn(x[:, :1].contiguous(), *args)
    return y


def _lora_add(a, lp, rows):
    """The LoRA delta of input ``a`` as an ``extra_pre_reduce`` function
    (``ops/layers.dense_epilogue``), or None without adapters."""
    if lp is None:
        return None
    return lambda y: lora_kernel.lora_delta_add(y, a, lp, rows)


def _gpt2_block(x, bp, kv, pos, slots, cfg, block_tables,
                paged_impl="gather", kv_quant="none", lora=None,
                lora_rows=None, valid=None, window=None, alone=False,
                tp_group=None):
    eps = cfg.layer_norm_epsilon
    b, t = x.shape[:2]
    a = layer_norm(x, bp["ln_1"], eps=eps)
    # [B, T, 3, H(/tp), D]
    qkv = _lane0(dense, a, bp["attn"]["c_attn"], alone=alone)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    if lora is not None:
        # Query only on the fused projection: K/V are never adapted.
        q = lora_kernel.lora_delta_add(q, a, lora["q"], lora_rows)
    _write_kv(kv, k, v, slots, kv_quant)
    a = _cached_attention(q, kv, pos, block_tables, paged_impl, kv_quant,
                          valid, window)
    a = a.reshape(b, t, -1)
    proj = bp["attn"]["c_proj"]
    # The (partial) product, the delta, one all-reduce, then the bias.
    y = dense_epilogue(
        _lane0(dense, a, {"kernel": proj["kernel"]}, alone=alone), proj,
        tp_group=tp_group,
        extra_pre_reduce=_lora_add(a, lora and lora["c_proj"], lora_rows))
    x = x + y
    m = layer_norm(x, bp["ln_2"], eps=eps)
    act = activation(cfg.activation_function)
    if cfg.n_experts:
        return x + _lane0(_moe_mlp, m, bp["mlp"], cfg, act, tp_group,
                          alone=alone)
    m = act(_lane0(dense, m, bp["mlp"]["c_fc"], alone=alone))
    proj = bp["mlp"]["c_proj"]
    return x + dense_epilogue(
        _lane0(dense, m, {"kernel": proj["kernel"]}, alone=alone), proj,
        tp_group=tp_group)


def _llama_block(x, bp, kv, pos, slots, cfg, block_tables, cos, sin,
                 paged_impl="gather", kv_quant="none", lora=None,
                 lora_rows=None, valid=None, window=None, alone=False,
                 tp_group=None):
    """RMSNorm pre-norm block: every projection through ``qdot`` (plain or
    int8 weights), RoPE on q and k at each row's own positions, SwiGLU
    (or SwiGLU experts). ``lora`` adds the tenant deltas to wq and wo
    (never to wk/wv); ``tp_group`` sums wo's and down's partials."""
    eps = cfg.layer_norm_epsilon
    b, t = x.shape[:2]
    d = cfg.head_dim
    a = rms_norm(x, bp["ln_attn"], eps=eps)
    q_pre = _lane0(qdot, a, bp["attn"]["wq"], alone=alone)
    if lora is not None:
        q_pre = lora_kernel.lora_delta_add(q_pre, a, lora["wq"], lora_rows)
    q = apply_rope(q_pre.reshape(b, t, -1, d), cos, sin)
    k = _lane0(qdot, a, bp["attn"]["wk"], alone=alone)
    k = apply_rope(k.reshape(b, t, -1, d), cos, sin)
    v = _lane0(qdot, a, bp["attn"]["wv"], alone=alone).reshape(b, t, -1, d)
    _write_kv(kv, k, v, slots, kv_quant)
    a = _cached_attention(q, kv, pos, block_tables, paged_impl, kv_quant,
                          valid, window)
    a = a.reshape(b, t, -1)
    x = x + dense_epilogue(
        _lane0(qdot, a, bp["attn"]["wo"], alone=alone), {},
        tp_group=tp_group,
        extra_pre_reduce=_lora_add(a, lora and lora["wo"], lora_rows))
    m = rms_norm(x, bp["ln_mlp"], eps=eps)
    if cfg.n_experts:
        return x + _lane0(_moe_mlp, m, bp["mlp"], cfg,
                          torch.nn.functional.silu, tp_group, alone=alone)
    gate = torch.nn.functional.silu(
        _lane0(qdot, m, bp["mlp"]["gate"], alone=alone))
    up = _lane0(qdot, m, bp["mlp"]["up"], alone=alone)
    return x + dense_epilogue(
        _lane0(qdot, gate * up, bp["mlp"]["down"], alone=alone), {},
        tp_group=tp_group)


def forward(
    params: Params,
    input_ids: torch.Tensor,  # [B, T] token ids
    cfg: ModelConfig,
    cache: Cache,
    pos,  # int, or a [B] int tensor: tokens already in each row's cache
    *,
    block_tables: torch.Tensor | None = None,  # [B, n_pages] int32
    paged_impl: str = "gather",
    kv_quant: str = "none",
    lora: tuple | None = None,
    decode_window: bool = False,
    lane0_alone: bool = False,
    tp_group=None,
    block_transform=None,
) -> tuple[torch.Tensor, Cache]:
    """Run T tokens per row at positions pos..pos+T-1 through the cache.
    Returns ([B, T, V] logits in ``cfg.logits_dtype``, ``cache``), the
    cache updated in place. Without ``block_tables`` the cache is dense
    (``init_cache``) and ``pos`` an int or a [B] tensor; with them it is
    paged (``init_paged_cache``), ``pos`` must be a [B] tensor,
    ``paged_impl`` picks single-token attention — "gather" (plain
    PyTorch over gathered pages) or "kernel" (the paged decode kernel, K3
    or for int8 pools K4; on CPU tensors its plain version) — and
    ``kv_quant`` names the pool layout. ``decode_window`` marks a paged
    T > 1 call as T decode steps (a speculative verify window, not a
    prefill chunk): with ``paged_impl="kernel"`` each query then runs as
    a single-token kernel row at its own position, and ``lane0_alone``
    runs every projection and the head on lane 0 by itself as well, so
    that lane 0 is bit for bit the [B, 1] decode step (``_lane0``: a
    sampled row commits only lane 0, which must be the plain tick's
    token). ``lora`` is ``(adapter layers, [B] tenant-slot rows)``, the
    layers a list of per-layer adapter slices
    (``serving/adapters.AdapterRegistry.device_tree``): each row's low-rank
    delta joins its query and attention-output projections
    (``ops/lora_kernel.lora_delta_add``), slot 0 the exact-zero adapter. A
    row's values are those of the same call with that row alone.
    ``tp_group``: the tensor group of this rank's Megatron-sharded block
    params and local-head cache (module docstring); ``block_transform``:
    a function of each layer's params run before the layer (ZeRO-3's
    just-in-time gather)."""
    if cfg.family not in ("gpt2", "llama"):
        raise NotImplementedError(
            f"decode.forward serves the gpt2 and llama families, got "
            f"{cfg.family!r}"
        )
    check_mode("kv_quant", kv_quant)
    if ("k_scale" in cache) != (kv_quant == "int8"):
        raise ValueError(
            f"kv_quant={kv_quant!r} does not match the cache layout "
            f"{sorted(cache)} (init_paged_cache(kv_quant=...) builds it)"
        )
    if paged_impl not in ("gather", "kernel"):
        raise ValueError(
            f"paged_impl must be 'gather' or 'kernel', got {paged_impl!r}"
        )
    b, t = input_ids.shape
    per_row = torch.is_tensor(pos) and pos.dim() > 0
    if per_row and pos.shape[0] != b:
        raise ValueError(
            f"pos has shape {tuple(pos.shape)} for batch {b}: a per-row "
            "position vector needs one entry per row"
        )
    if block_tables is not None and not per_row:
        raise ValueError(
            "paged decode (block_tables) needs a per-row [B] pos vector — "
            f"got {pos!r}"
        )
    if block_tables is None and kv_quant != "none":
        raise ValueError(
            "kv_quant requires the paged cache layout (block_tables): dense "
            "caches stay full precision"
        )
    if not per_row:
        pos = int(pos)
    dtype = getattr(torch, cfg.dtype)
    dev = input_ids.device
    if cfg.family == "gpt2":
        if per_row:
            rows = pos.long()[:, None] + torch.arange(t, device=dev)[None]
            # Positions past the table read its last row, as a JAX gather
            # clamps them (an index error here would be a device assert on
            # the card).
            wpe = params["wpe"][rows.clamp(max=cfg.n_ctx - 1)]  # [B, T, E]
        else:
            wpe = params["wpe"][pos:pos + t][None]
        x = (params["wte"][input_ids.long()] + wpe).to(dtype)
        block = _gpt2_block
    else:
        x = params["wte"][input_ids.long()].to(dtype)
        cos, sin = rope_angles(
            t, cfg.head_dim, cfg.rope_theta,
            offset=pos[:, None] if per_row else pos, device=dev,
        )
        block = functools.partial(_llama_block, cos=cos, sin=sin)
    if block_tables is not None:
        slots = _page_slots(pos, t, block_tables, cache["k"].shape[2])
    elif per_row:
        slots = _dense_slots(pos, t, cache["k"].shape[2])
    else:
        slots = (pos, pos + t)
    # A kernel decode window's per-query rows: query i of row b at
    # position pos[b] + i over row b's table (a lane past the table sees
    # every key, as the mask gives it), made once for every layer.
    window = None
    if (decode_window and t > 1 and block_tables is not None
            and paged_impl == "kernel"):
        n_keys = block_tables.shape[1] * cache["k"].shape[2]
        lengths = pos.long()[:, None] + torch.arange(t, device=dev)[None]
        window = (block_tables.repeat_interleave(t, dim=0),
                  lengths.clamp(max=n_keys - 1).reshape(-1).int())
    # The plain attention's key mask (and int64 tables for its page
    # gathers), made once for every layer; a kernel decode step has none.
    valid = None
    if window is None and (block_tables is None or t > 1
                           or paged_impl == "gather"):
        s_keys = (cache["k"].shape[2] if block_tables is None
                  else block_tables.shape[1] * cache["k"].shape[2])
        valid = paged_kernel.attention_mask(pos, t, s_keys, b, dev)
        if block_tables is not None:
            block_tables = block_tables.long()
    alone = lane0_alone and window is not None
    lora_layers = lora_rows = None
    if lora is not None:
        lora_layers, rows = lora
        # Each flattened row's slot, once for every layer and target.
        lora_rows = torch.as_tensor(rows, device=dev).long()
        if t > 1:
            lora_rows = lora_rows.repeat_interleave(t)
    for layer, bp in enumerate(params["blocks"]):
        if block_transform is not None:
            bp = block_transform(bp)
        kv = {name: c[layer] for name, c in cache.items()}
        x = block(x, bp, kv, pos, slots, cfg, block_tables,
                  paged_impl=paged_impl, kv_quant=kv_quant,
                  lora=None if lora is None else lora_layers[layer],
                  lora_rows=lora_rows, valid=valid, window=window,
                  alone=alone, tp_group=tp_group)
    head = get_model(cfg).head
    return _lane0(lambda h: head(params, h, cfg), x, alone=alone), cache


# -- sampling ----------------------------------------------------------------


def sampling_scalars(temperature, top_k, top_p,
                     vocab_size: int) -> tuple[float, int, float]:
    """Encode a (possibly-None) sampling config as plain scalars: top_k in
    {None, 0} keeps the full vocabulary, top_p None keeps every mass."""
    if top_k is not None and top_k < 0:
        raise ValueError(f"top_k must be >= 0 or None, got {top_k}")
    t = float(temperature if temperature else 1.0)
    k = int(top_k or vocab_size)
    p = float(2.0 if top_p is None else top_p)
    return t, k, p


def sample_seed(seed: int, index: int) -> int:
    """The generator seed for a request's token ``index``: a pure function
    of (seed, index), independent of the batch the row rides in."""
    state = np.random.SeedSequence([int(seed), int(index)]).generate_state(
        2, np.uint32
    )
    return int(state[0]) << 31 | int(state[1]) >> 1


def _sample_greedy(logits):
    """[B, V] -> [B] float32 argmax tokens (int64)."""
    return torch.argmax(logits.float(), dim=-1)


def _filtered_sorted(logits, temperature, top_k, top_p):
    """The sampler's support: ``logits`` [B, V] over ``temperature`` (a
    [B] tensor or a float), sorted descending (stable), with the tokens
    past rank ``top_k`` and past the nucleus ``top_p`` (over the top-k
    support: HF semantics) at -inf. Returns (probabilities, order), each
    [B, V]. The argmax token always survives both filters."""
    dev = logits.device
    t = torch.as_tensor(temperature, device=dev, dtype=torch.float32)
    k = torch.as_tensor(top_k, device=dev)
    p = torch.as_tensor(top_p, device=dev, dtype=torch.float32)
    if t.dim():
        t, k, p = t[:, None], k[:, None], p[:, None]
    vals, order = torch.sort(logits.float() / t, dim=-1, descending=True,
                             stable=True)
    rank = torch.arange(vals.shape[-1], device=dev)[None]
    in_k = rank < k
    probs = torch.softmax(torch.where(in_k, vals, -torch.inf), dim=-1)
    cum_before = torch.cumsum(probs, dim=-1) - probs
    vals = torch.where(in_k & (cum_before < p), vals, -torch.inf)
    return torch.softmax(vals, dim=-1), order


def _draw(probs, order, seed: int):
    """One token per row of ``probs`` [B, V] from a generator seeded by
    ``seed`` (one draw per row, in row order); returns [B] ids."""
    gen = torch.Generator(device=probs.device).manual_seed(seed)
    choice = torch.multinomial(probs, 1, generator=gen)
    return torch.gather(order, 1, choice)[:, 0]


def _sample_traced(logits, temperature, seed, top_k, top_p):
    """[B, V] -> [B] sampled tokens: temperature, then top-k, then the
    nucleus, then a draw from a generator seeded by ``seed``
    (``sample_seed(request seed, token index)``)."""
    probs, order = _filtered_sorted(logits, temperature, top_k, top_p)
    return _draw(probs, order, seed)


def sample_token(logits, sampled: bool, temperature, seed, top_k, top_p):
    """One next-token draw for every row of ``logits`` [B, V]: the argmax
    when not ``sampled``, else ``_sample_traced`` — the serial paths'
    sampler (``generate_monolithic``, ``DecodeEngine``), so the two cannot
    drift."""
    if not sampled:
        return _sample_greedy(logits)
    return _sample_traced(logits, temperature, seed, top_k, top_p)


def sample_token_rows(logits, greedy, temperature, top_k, top_p, seeds):
    """One next token per row of ``logits`` [B, V] with per-row sampling
    state (the batched engines): greedy rows take the argmax; sampled
    rows are filtered together and each draws from its own generator
    seeded by ``seeds[b]`` (``sample_seed``) — a row's draw equals
    ``sample_token`` on that row alone with the same seed. ``greedy`` is a
    [B] bool sequence, ``temperature``/``top_k``/``top_p``/``seeds`` [B]
    sequences. Returns a [B] int64 tensor on the logits' device."""
    toks = _sample_greedy(logits)
    rows = [i for i, g in enumerate(greedy) if not g]
    if not rows:
        return toks
    idx = torch.tensor(rows, device=logits.device)
    probs, order = _filtered_sorted(
        logits[idx], [temperature[i] for i in rows],
        [top_k[i] for i in rows], [top_p[i] for i in rows],
    )
    for j, i in enumerate(rows):
        toks[i] = _draw(probs[j:j + 1], order[j:j + 1], seeds[i])[0]
    return toks


def speculative_accept(drafts, verified, n_draft):
    """Per-row accept lengths of a speculative verify window: draft lane j
    survives iff every earlier lane survived, it equals the model's own
    greedy token for that position (``verified`` [B, K], the argmax after
    lanes 0..K-1) and it is a real draft (j < ``n_draft[b]``). Returns [B]
    int64 in [0, K]; the committed tokens are the accepted drafts plus the
    model's next token, so greedy output is the plain decode whatever the
    drafts were."""
    lanes = torch.arange(drafts.shape[1], device=drafts.device)[None]
    match = (drafts == verified) & (lanes < n_draft[:, None])
    return torch.cumprod(match.long(), dim=1).sum(dim=1)


def nonfinite_rows(logits: torch.Tensor) -> torch.Tensor:
    """[B, ...] -> [B] bool: True where any logit of the row is NaN/Inf."""
    return ~torch.isfinite(logits).flatten(1).all(dim=1)


# -- generation --------------------------------------------------------------


def _check_sample_args(prompt, max_new_tokens, temperature, seed,
                       max_len=None) -> int:
    """The shared generate-entry validation of the JAX package; returns
    the sampling seed (0 for greedy requests). Rejects empty prompts,
    ``max_new_tokens <= 0``, a request past ``max_len`` and temperature
    sampling without a seed."""
    tp = np.shape(prompt)[-1]
    if tp == 0:
        raise ValueError(
            "empty prompt: need at least one token to prefill (an empty "
            "prompt would sample the first token from a pad position)"
        )
    if max_new_tokens <= 0:
        raise ValueError(
            f"max_new_tokens must be >= 1, got {max_new_tokens} — a "
            "request that generates nothing is a no-op; don't dispatch it"
        )
    if max_len is not None and tp + max_new_tokens > max_len:
        raise ValueError(
            f"prompt ({tp}) + max_new_tokens ({max_new_tokens}) exceeds "
            f"max_len {max_len}: the KV cache holds max_len positions, so "
            "the request cannot fit — shorten it or raise max_len"
        )
    if temperature > 0.0 and seed is None:
        raise ValueError("temperature sampling requires a seed")
    return 0 if seed is None else int(seed)


def to_device(tree, device: torch.device):
    """Every tensor of a nested dict/list on ``device`` (a no-op for
    tensors already there)."""
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_device(v, device) for v in tree]
    return tree.to(device) if torch.is_tensor(tree) else tree


def as_prompt(prompt, device) -> torch.Tensor:
    """A [B, Tp] prompt (array or tensor) as an int64 tensor on
    ``device``."""
    if torch.is_tensor(prompt):
        return prompt.to(device).long()
    return torch.as_tensor(np.asarray(prompt), device=device).long()


@torch.no_grad()
def generate_monolithic(
    params: Params,
    prompt,  # [B, Tp] int
    cfg: ModelConfig,
    max_new_tokens: int,
    *,
    temperature: float = 0.0,
    seed: int | None = None,
    max_len: int | None = None,
    top_k: int | None = None,
    top_p: float | None = None,
    device=None,
) -> torch.Tensor:
    """The plain reference generation loop: a fresh zeroed dense cache,
    one prefill forward over the prompt, then one single-token forward
    per new token. Returns [B, Tp + max_new_tokens] int32 on ``device``
    (None: the GPU; the params move there). Token j of the request is
    drawn with ``sample_seed(seed, j)``; greedy without a seed. The
    reference ``DecodeEngine`` is held token-equal to."""
    seed = _check_sample_args(prompt, max_new_tokens, temperature, seed,
                              max_len=max_len)
    device = resolve_device(device)
    return _generate_loop(to_device(params, device), prompt, cfg,
                          max_new_tokens, temperature, seed, max_len, top_k,
                          top_p, device)


def _generate_loop(params, prompt, cfg, max_new_tokens, temperature, seed,
                   max_len, top_k, top_p, device, *, n_kv=None,
                   top_transform=None, **fwd_kw) -> torch.Tensor:
    """The reference loop every ``*_monolithic`` path runs (the JAX
    package's ``_generate_impl``): a fresh zeroed dense cache of ``n_kv``
    heads, one prefill forward, then one single-token forward per token.
    ``top_transform``: a function of the params run before each forward
    (ZeRO-3 gathers the embeddings and the head there); ``fwd_kw`` goes to
    ``forward`` (``tp_group``, ``block_transform``)."""
    ids = as_prompt(prompt, device)
    b, tp = ids.shape
    sampled = temperature > 0
    t, k, p = sampling_scalars(temperature, top_k, top_p, cfg.vocab_size)
    cache = init_cache(cfg, b, max_len or tp + max_new_tokens,
                       device=device, n_kv=n_kv)
    top = top_transform or (lambda prm: prm)
    logits, cache = forward(top(params), ids, cfg, cache, 0, **fwd_kw)
    tok = sample_token(logits[:, -1], sampled, t, sample_seed(seed, 0), k, p)
    out = [ids, tok[:, None]]
    for i in range(max_new_tokens - 1):
        logits, cache = forward(top(params), tok[:, None], cfg, cache,
                                tp + i, **fwd_kw)
        tok = sample_token(logits[:, -1], sampled, t,
                           sample_seed(seed, i + 1), k, p)
        out.append(tok[:, None])
    return torch.cat(out, dim=1).to(torch.int32)


def generate(
    params: Params,
    prompt,  # [B, Tp] int
    cfg: ModelConfig,
    max_new_tokens: int,
    *,
    temperature: float = 0.0,
    seed: int | None = None,
    max_len: int | None = None,
    top_k: int | None = None,
    top_p: float | None = None,
    device=None,
) -> torch.Tensor:
    """Autoregressive generation, [B, Tp + max_new_tokens]: the shim over
    ``serving.engine.DecodeEngine`` (exact-length buckets, no cache pool:
    one engine per (cfg, max_len, device), kept for the process).
    Token-equal to ``generate_monolithic``."""
    seed = _check_sample_args(prompt, max_new_tokens, temperature, seed,
                              max_len=max_len)
    engine = shim_engine(
        cfg, max_len or (np.shape(prompt)[-1] + max_new_tokens),
        str(resolve_device(device)),
    )
    return engine.generate(
        params, prompt, max_new_tokens, temperature=temperature, seed=seed,
        top_k=top_k, top_p=top_p,
    )


@functools.lru_cache(maxsize=None)
def shim_engine(cfg: ModelConfig, max_len: int, device: str, mesh_cfg=None):
    """The engine behind ``generate`` (and, with ``mesh_cfg``, behind
    ``generate_tp``/``generate_fsdp``): exact-length buckets and no cache
    pool (an engine lives as long as the process, so a pooled cache per
    request shape would grow memory with request diversity)."""
    from pytorch_distributed_tpu_torch.serving.engine import DecodeEngine

    return DecodeEngine(cfg, max_len=max_len, pool_caches=False,
                        device=device, mesh_cfg=mesh_cfg)


# -- meshed generation (tensor parallelism, ZeRO-3) ---------------------------

_MESH_AXES = ("data", "fsdp", "tensor", "seq", "pipe", "expert")


def _validate_tp_mesh(cfg: ModelConfig, mesh_cfg) -> None:
    """The shared ``generate_tp`` validation (the JAX package's)."""
    tp_size = mesh_cfg.tensor
    if tp_size <= 1:
        raise ValueError("generate_tp needs mesh_cfg.tensor > 1")
    for ax in _MESH_AXES:
        if ax != "tensor" and getattr(mesh_cfg, ax) > 1:
            raise NotImplementedError(
                f"generate_tp supports a tensor-only mesh (got {ax}="
                f"{getattr(mesh_cfg, ax)})")
    if cfg.n_experts and cfg.inner_dim % tp_size:
        raise ValueError(
            f"tensor={tp_size} must divide the MoE expert hidden dim "
            f"inner_dim={cfg.inner_dim} (experts run Megatron TP on F)")
    if cfg.n_head % tp_size or cfg.kv_heads % tp_size:
        raise ValueError(
            f"tensor={tp_size} must divide n_head={cfg.n_head} and "
            f"kv_heads={cfg.kv_heads}")


def _validate_fsdp_mesh(mesh_cfg) -> None:
    """The shared ``generate_fsdp`` validation (the JAX package's)."""
    if mesh_cfg.fsdp <= 1:
        raise ValueError("generate_fsdp needs mesh_cfg.fsdp > 1")
    for ax in _MESH_AXES:
        if ax != "fsdp" and getattr(mesh_cfg, ax) > 1:
            raise NotImplementedError(
                f"generate_fsdp supports an fsdp-only mesh (got {ax}="
                f"{getattr(mesh_cfg, ax)}); combine with generate_tp's "
                "tensor sharding is future surface")
    if mesh_cfg.strategy != "full_shard":
        raise ValueError(
            "generate_fsdp decodes from full_shard (ZeRO-3) param "
            f"layouts; strategy={mesh_cfg.strategy!r} keeps params "
            "replicated — plain generate already covers it")


def zero3_transforms(specs, mesh):
    """(top_transform, block_transform) of ZeRO-3 decode over ``mesh``'s
    fsdp group: each all-gathers the sharded leaves of its part of this
    rank's full_shard params (``parallel/zero.all_gather_dim``, no
    autograd) — the embeddings, final norm and head once per forward, a
    layer's leaves just before the layer runs."""
    from pytorch_distributed_tpu_torch.parallel.sharding import shard_dim
    from pytorch_distributed_tpu_torch.parallel.zero import all_gather_dim
    from pytorch_distributed_tpu_torch.utils import tree

    group, n = mesh.axis_group("fsdp"), mesh.cfg.fsdp

    def gather(leaves, leaf_specs):
        return tree.map_tree2(
            lambda leaf, spec: leaf if shard_dim(spec) is None else
            all_gather_dim(leaf, shard_dim(spec), group, n),
            leaves, leaf_specs)

    # Every layer's leaves have the same shapes, hence the same specs.
    block_specs = specs["blocks"][0]
    top_specs = {k: v for k, v in specs.items() if k != "blocks"}

    def top(params):
        out = gather({k: v for k, v in params.items() if k != "blocks"},
                     top_specs)
        out["blocks"] = params["blocks"]
        return out

    return top, lambda bp: gather(bp, block_specs)


def _meshed_setup(params, mesh_cfg, device):
    """(mesh, spec tree, this rank's param slices) of a meshed
    monolithic path; every rank of the world calls it."""
    from pytorch_distributed_tpu_torch.parallel.mesh import make_mesh
    from pytorch_distributed_tpu_torch.parallel.sharding import (
        param_partition_specs,
        shard_params,
    )

    mesh = make_mesh(mesh_cfg, device=device)
    params = to_device(params, device)
    specs = param_partition_specs(params, mesh_cfg)
    return mesh, specs, shard_params(params, specs, mesh)


def _meshed_generate(kind, params, prompt, cfg, mesh_cfg, max_new_tokens,
                     temperature, seed, max_len, top_k, top_p, device):
    """``generate_tp``/``generate_fsdp``: the shim over the meshed
    ``DecodeEngine`` (one per (cfg, max_len, device, mesh_cfg))."""
    (_validate_tp_mesh(cfg, mesh_cfg) if kind == "tp"
     else _validate_fsdp_mesh(mesh_cfg))
    seed = _check_sample_args(prompt, max_new_tokens, temperature, seed,
                              max_len=max_len)
    engine = shim_engine(
        cfg, max_len or (np.shape(prompt)[-1] + max_new_tokens),
        str(resolve_device(device)), mesh_cfg,
    )
    return engine.generate(
        params, prompt, max_new_tokens, temperature=temperature, seed=seed,
        top_k=top_k, top_p=top_p,
    )


def generate_tp(
    params: Params, prompt, cfg: ModelConfig, mesh_cfg,
    max_new_tokens: int, *, temperature: float = 0.0,
    seed: int | None = None, max_len: int | None = None,
    top_k: int | None = None, top_p: float | None = None, device=None,
) -> torch.Tensor:
    """Tensor-parallel generation over a tensor-only mesh, on every rank
    of the group: block params sharded Megatron-style
    (``parallel/sharding``, the layout training would leave them in),
    attention on this rank's heads against a local-head KV cache (1/tp of
    the cache memory), one all-reduce after each row-parallel projection,
    and the replicated logits sampled alike on every rank. ``params``:
    the full params (this rank keeps its slices); ``device``: this rank's
    device (None: the card). The shim over the TP ``DecodeEngine``;
    ``generate_tp_monolithic`` is the reference loop."""
    return _meshed_generate("tp", params, prompt, cfg, mesh_cfg,
                            max_new_tokens, temperature, seed, max_len,
                            top_k, top_p, device)


@torch.no_grad()
def generate_tp_monolithic(
    params: Params, prompt, cfg: ModelConfig, mesh_cfg,
    max_new_tokens: int, *, temperature: float = 0.0,
    seed: int | None = None, max_len: int | None = None,
    top_k: int | None = None, top_p: float | None = None, device=None,
) -> torch.Tensor:
    """The TP reference loop: ``generate_monolithic`` over this rank's
    param slices and a local-head cache, the tensor group threaded through
    ``forward``."""
    _validate_tp_mesh(cfg, mesh_cfg)
    seed = _check_sample_args(prompt, max_new_tokens, temperature, seed,
                              max_len=max_len)
    device = resolve_device(device)
    mesh, _, local = _meshed_setup(params, mesh_cfg, device)
    return _generate_loop(local, prompt, cfg, max_new_tokens, temperature,
                          seed, max_len, top_k, top_p, device,
                          n_kv=cfg.kv_heads // mesh_cfg.tensor,
                          tp_group=mesh.axis_group("tensor"))


def generate_fsdp(
    params: Params, prompt, cfg: ModelConfig, mesh_cfg,
    max_new_tokens: int, *, temperature: float = 0.0,
    seed: int | None = None, max_len: int | None = None,
    top_k: int | None = None, top_p: float | None = None, device=None,
) -> torch.Tensor:
    """Decode from ZeRO-3-sharded params over an fsdp-only full_shard
    mesh, on every rank of the group: each rank keeps its full_shard
    slices (``parallel/sharding``, the layout the ZeRO-3 trainer keeps;
    1/fsdp of the param memory) and all-gathers each layer just in time
    (``zero3_transforms``; ``prefetch_buffers`` is 0, item 7(d)). The shim
    over the ZeRO-3 ``DecodeEngine``; MoE configs work unchanged."""
    return _meshed_generate("fsdp", params, prompt, cfg, mesh_cfg,
                            max_new_tokens, temperature, seed, max_len,
                            top_k, top_p, device)


@torch.no_grad()
def generate_fsdp_monolithic(
    params: Params, prompt, cfg: ModelConfig, mesh_cfg,
    max_new_tokens: int, *, temperature: float = 0.0,
    seed: int | None = None, max_len: int | None = None,
    top_k: int | None = None, top_p: float | None = None, device=None,
) -> torch.Tensor:
    """The ZeRO-3 reference loop: ``generate_monolithic`` over this
    rank's full_shard slices with the just-in-time gathers."""
    _validate_fsdp_mesh(mesh_cfg)
    seed = _check_sample_args(prompt, max_new_tokens, temperature, seed,
                              max_len=max_len)
    device = resolve_device(device)
    mesh, specs, local = _meshed_setup(params, mesh_cfg, device)
    top, block = zero3_transforms(specs, mesh)
    return _generate_loop(local, prompt, cfg, max_new_tokens, temperature,
                          seed, max_len, top_k, top_p, device,
                          top_transform=top, block_transform=block)
