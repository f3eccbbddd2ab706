"""KV-cache decoding over a PAGED pool: the serving engine's forward pass.

The port of the paged path of the JAX package's ``models/decode.py``,
for the gpt2 and llama families. One ``forward`` serves both chunked
prefill (T tokens per row) and the single-token decode step (T = 1), each
batch row at its own position:

- the cache is a pool pair ``k``/``v`` of [L, P, page, Hkv, D]; row b's
  token at position j lives at page ``block_tables[b, j // page]``,
  offset ``j % page``. Page 0 is the scratch page: free and mid-prefill
  rows of a decode step run with position 0 and an all-zero table, so
  they write and read page 0, which no live row's table points at;
- new K/V are written INTO the pool in place (``index_put_``) before the
  attention reads it — the JAX package returns an updated pool from a
  pure function instead; the values written are the same;
- attention for a single-token step with ``paged_impl="kernel"`` goes
  through the paged decode kernel (``ops/paged_kernel``), which reads
  pages in place and only up to each row's depth. Every other call —
  prefill chunks, and decode with ``paged_impl="gather"`` — gathers each
  row's pages into a contiguous view and runs the masked softmax in
  plain PyTorch (``ops/paged_kernel.gather_attention``, also the kernel's
  plain version), with float32 scores (``preferred_element_type=float32``
  in the JAX package);
- ``kv_quant="int8"``: the pools are int8 with f32 scale pools
  ``k_scale``/``v_scale`` of [L, P, page, Hkv] beside them. New K/V are
  QUANTIZED ON APPEND (``ops/quant.quantize_kv``, one scale per token and
  KV head), so writing a token never touches its neighbours' values. The
  kernel path hands the scale pools to the int8 kernel (K4); the gather
  path dequantizes the gathered view to the activation dtype. Weights
  quantized by ``ops/quant.quantize_decode_params`` go through
  ``ops/quant.qdot`` in every projection, whatever ``kv_quant`` is;
- the layers run in a Python loop over the per-layer params list (the JAX
  package scans over stacked layers).

Sampling: greedy rows take the float32 argmax; a sampled row draws from a
``torch.Generator`` seeded by (request seed, token index), so a sampled
token is a pure function of (seed, index, logits) whatever the row's
neighbours. JAX's threefry stream cannot be reproduced, so parity with
the JAX package holds on greedy rows only.
"""

from __future__ import annotations

import functools
from typing import Any

import numpy as np
import torch

from pytorch_distributed_tpu_torch.config import ModelConfig
from pytorch_distributed_tpu_torch.models import get_model
from pytorch_distributed_tpu_torch.ops import paged_kernel
from pytorch_distributed_tpu_torch.ops.layers import (
    activation,
    dense,
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


def init_paged_cache(
    cfg: ModelConfig, pool_pages: int, page_size: int, dtype=None,
    device: str | torch.device | None = None, kv_quant: str = "none",
) -> Cache:
    """Zeroed paged pools ``k``/``v`` of [L, pool_pages, page_size, Hkv, D]
    in ``dtype`` (default ``cfg.dtype``) on ``device`` (None: the GPU,
    ``utils.device.resolve_device``); page 0 is the scratch page.
    ``kv_quant="int8"``: int8 pools (zeros) and f32 scale pools
    ``k_scale``/``v_scale`` of [L, pool_pages, page_size, Hkv] (ones)."""
    check_mode("kv_quant", kv_quant)
    device = resolve_device(device)
    shape = (cfg.n_layer, pool_pages, page_size, cfg.kv_heads, cfg.head_dim)
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
                      kv_quant="none"):
    """q [B, T, H, D] at positions pos[b]..pos[b]+T-1 against one layer's
    pools ``kv`` ({"k", "v"}: [P, page, Hkv, D], plus the scale pools
    ``k_scale``/``v_scale`` under int8); key j of row b is valid iff
    j <= pos[b] + i. Returns [B, T, H, D] in the pool dtype (q's dtype
    for int8 pools)."""
    scales = ((kv["k_scale"], kv["v_scale"]) if kv_quant == "int8"
              else (None, None))
    if q.shape[1] == 1 and paged_impl == "kernel":
        out = paged_kernel.paged_decode_attention(
            q[:, 0].contiguous(), kv["k"], kv["v"], block_tables, pos,
            *scales,
        )
        return out[:, None]
    return paged_kernel.gather_attention(q, kv["k"], kv["v"], block_tables,
                                         pos, *scales)


def _page_slots(pos, t, block_tables, page):
    """Where each new token goes: (page ids, in-page offsets), each
    [B, T]. Token i of row b lands at page ``table[b, (pos[b]+i) //
    page]``, offset ``(pos[b]+i) % page``; lanes past the table go to the
    scratch page 0 (as in the JAX package, which never clamps them onto a
    live page). The same for every layer, so ``forward`` computes it
    once."""
    n_pages = block_tables.shape[1]
    gpos = pos.long()[:, None] + torch.arange(t, device=pos.device)[None]
    pidx = gpos // page
    pids = torch.gather(block_tables.long(), 1, pidx.clamp(max=n_pages - 1))
    return torch.where(pidx < n_pages, pids, 0), gpos % page


def _write(pool, new, slots) -> None:
    """Write new [B, T, Hkv, D] into the paged pool layer [P, page, Hkv, D]
    IN PLACE at ``slots`` (``_page_slots``). Distinct live rows own
    distinct pages (the block pool's copy-on-write discipline), so only
    scratch-page writes can collide."""
    pool.index_put_(slots, new.to(pool.dtype))


def _write_kv(kv, k_new, v_new, slots, kv_quant="none") -> None:
    """Write this step's [B, T, Hkv, D] K/V into one layer's pools in
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


def _gpt2_block(x, bp, kv, pos, slots, cfg, block_tables,
                paged_impl="gather", kv_quant="none"):
    eps = cfg.layer_norm_epsilon
    b, t = x.shape[:2]
    a = layer_norm(x, bp["ln_1"], eps=eps)
    qkv = dense(a, bp["attn"]["c_attn"])  # [B, T, 3, H, D]
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    _write_kv(kv, k, v, slots, kv_quant)
    a = _cached_attention(q, kv, pos, block_tables, paged_impl, kv_quant)
    x = x + dense(a.reshape(b, t, -1), bp["attn"]["c_proj"])
    m = layer_norm(x, bp["ln_2"], eps=eps)
    m = activation(cfg.activation_function)(dense(m, bp["mlp"]["c_fc"]))
    return x + dense(m, bp["mlp"]["c_proj"])


def _llama_block(x, bp, kv, pos, slots, cfg, block_tables, cos, sin,
                 paged_impl="gather", kv_quant="none"):
    """RMSNorm pre-norm block: every projection through ``qdot`` (plain or
    int8 weights), RoPE on q and k at each row's own positions, SwiGLU."""
    eps = cfg.layer_norm_epsilon
    b, t = x.shape[:2]
    d = cfg.head_dim
    a = rms_norm(x, bp["ln_attn"], eps=eps)
    q = apply_rope(qdot(a, bp["attn"]["wq"]).reshape(b, t, -1, d), cos, sin)
    k = apply_rope(qdot(a, bp["attn"]["wk"]).reshape(b, t, -1, d), cos, sin)
    v = qdot(a, bp["attn"]["wv"]).reshape(b, t, -1, d)
    _write_kv(kv, k, v, slots, kv_quant)
    a = _cached_attention(q, kv, pos, block_tables, paged_impl, kv_quant)
    x = x + qdot(a.reshape(b, t, -1), bp["attn"]["wo"])
    m = rms_norm(x, bp["ln_mlp"], eps=eps)
    gate = torch.nn.functional.silu(qdot(m, bp["mlp"]["gate"]))
    up = qdot(m, bp["mlp"]["up"])
    return x + qdot(gate * up, bp["mlp"]["down"])


def forward(
    params: Params,
    input_ids: torch.Tensor,  # [B, T] token ids
    cfg: ModelConfig,
    cache: Cache,
    pos: torch.Tensor,  # [B] int32: tokens already in each row's cache
    *,
    block_tables: torch.Tensor,  # [B, n_pages] int32
    paged_impl: str = "gather",
    kv_quant: str = "none",
) -> tuple[torch.Tensor, Cache]:
    """Run T tokens per row at positions pos[b]..pos[b]+T-1 through the
    paged cache. Returns ([B, T, V] logits in ``cfg.logits_dtype``,
    ``cache``), the pools updated in place. ``paged_impl`` picks
    single-token attention: "gather" (plain PyTorch over gathered pages)
    or "kernel" (the paged decode kernel, K3 or for int8 pools K4; on CPU
    tensors its plain version). ``kv_quant`` names the cache layout
    (``init_paged_cache``)."""
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
    if pos.dim() != 1 or pos.shape[0] != input_ids.shape[0]:
        raise ValueError(
            "paged decode needs a per-row [B] pos vector, got shape "
            f"{tuple(pos.shape)} for batch {input_ids.shape[0]}"
        )
    b, t = input_ids.shape
    dtype = getattr(torch, cfg.dtype)
    if cfg.family == "gpt2":
        rows = pos.long()[:, None] + torch.arange(t, device=pos.device)[None]
        # Positions past the table read its last row, as a JAX gather
        # clamps them (an index error here would be a device assert on the
        # card).
        wpe = params["wpe"][rows.clamp(max=cfg.n_ctx - 1)]  # [B, T, E]
        x = (params["wte"][input_ids.long()] + wpe).to(dtype)
        block = _gpt2_block
    else:
        x = params["wte"][input_ids.long()].to(dtype)
        cos, sin = rope_angles(t, cfg.head_dim, cfg.rope_theta,
                               offset=pos[:, None])
        block = functools.partial(_llama_block, cos=cos, sin=sin)
    slots = _page_slots(pos, t, block_tables, cache["k"].shape[2])
    for layer, bp in enumerate(params["blocks"]):
        kv = {name: pool[layer] for name, pool in cache.items()}
        x = block(x, bp, kv, pos, slots, cfg, block_tables,
                  paged_impl=paged_impl, kv_quant=kv_quant)
    return get_model(cfg).head(params, x, cfg), cache


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


def sample_token_rows(logits, greedy, temperature, top_k, top_p, seeds):
    """One next token per row of ``logits`` [B, V]: greedy rows take the
    argmax; sampled rows apply temperature, then top-k, then the nucleus
    (top-p, over the top-k support), and draw from a generator seeded by
    ``seeds[b]`` (``sample_seed``). ``greedy`` is a [B] bool sequence,
    ``temperature``/``top_k``/``top_p``/``seeds`` [B] sequences. Returns a
    [B] int64 tensor on the logits' device."""
    logits = logits.float()
    toks = torch.argmax(logits, dim=-1)
    rows = [i for i, g in enumerate(greedy) if not g]
    if not rows:
        return toks
    dev = logits.device
    idx = torch.tensor(rows, device=dev)
    t = torch.tensor([temperature[i] for i in rows], device=dev)
    k = torch.tensor([top_k[i] for i in rows], device=dev)
    p = torch.tensor([top_p[i] for i in rows], device=dev)
    vals, order = torch.sort(logits[idx] / t[:, None], dim=-1,
                             descending=True, stable=True)
    rank = torch.arange(vals.shape[-1], device=dev)[None]
    in_k = rank < k[:, None]
    probs = torch.softmax(torch.where(in_k, vals, -torch.inf), dim=-1)
    cum_before = torch.cumsum(probs, dim=-1) - probs
    vals = torch.where(in_k & (cum_before < p[:, None]), vals, -torch.inf)
    probs = torch.softmax(vals, dim=-1)
    for j, i in enumerate(rows):
        gen = torch.Generator(device=dev).manual_seed(seeds[i])
        choice = torch.multinomial(probs[j], 1, generator=gen)
        toks[i] = order[j, choice[0]]
    return toks


def nonfinite_rows(logits: torch.Tensor) -> torch.Tensor:
    """[B, ...] -> [B] bool: True where any logit of the row is NaN/Inf."""
    return ~torch.isfinite(logits).flatten(1).all(dim=1)
