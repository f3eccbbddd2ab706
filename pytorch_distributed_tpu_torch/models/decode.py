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
  pages in place and only up to each row's depth. Every other call —
  dense attention, paged prefill chunks, multi-token verify windows, and
  decode with ``paged_impl="gather"`` — runs the masked softmax in plain
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
- the layers run in a Python loop over the per-layer params list (the JAX
  package scans over stacked layers).

Sampling: greedy rows take the float32 argmax; a sampled draw uses a
``torch.Generator`` seeded by (request seed, token index), so a sampled
token is a pure function of (seed, index, logits) whatever the row's
neighbours. JAX's threefry stream cannot be reproduced, so parity with
the JAX package holds on greedy rows only.

Generation: ``generate_monolithic`` is the plain reference loop (prefill,
then one forward per token); ``generate`` is the shim over
``serving.engine.DecodeEngine``. The meshed forms (``generate_tp``,
``generate_fsdp``) wait for the multi-GPU slice and raise.
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

MESH_NOT_PORTED = (
    "is multi-device (tensor parallelism / ZeRO-3 decode) and not ported "
    "yet (ROADMAP queue 1 item 7)"
)


def init_cache(
    cfg: ModelConfig, batch: int, max_len: int, dtype=None,
    device: str | torch.device | None = None,
) -> Cache:
    """Zeroed dense ``k``/``v`` of [L, batch, max_len, Hkv, D] in
    ``dtype`` (default ``cfg.dtype``) on ``device`` (None: the GPU)."""
    if max_len > cfg.n_ctx:
        raise ValueError(f"max_len {max_len} exceeds n_ctx {cfg.n_ctx}")
    device = resolve_device(device)
    dtype = dtype or getattr(torch, cfg.dtype)
    shape = (cfg.n_layer, batch, max_len, cfg.kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
    }


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
    """q [B, T, H, D] at positions pos..pos+T-1 against one layer's cache
    ``kv``: dense rows [B, S, Hkv, D] (``block_tables`` None) or paged
    pools [P, page, Hkv, D] (plus the scale pools under int8); key j of
    row b is valid iff j <= pos[b] + i. Returns [B, T, H, D] in the cache
    dtype (q's dtype for int8 pools)."""
    if block_tables is None:
        return paged_kernel.masked_attention(q, kv["k"], kv["v"], pos)
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


def _moe_mlp(m, mlp_params, cfg, act):
    """Routed MLP for decode: routing is per token and cache-free, so only
    the capacity differs from training — the no-drop bound
    (``capacity_factor = n_experts``: every expert could take every
    assignment), as the JAX package's ``_moe_mlp``: a dropped token at
    inference would silently zero its MLP, and with no drops a row's
    output does not depend on the rows beside it."""
    from pytorch_distributed_tpu_torch.ops.moe import moe_mlp

    out, _ = moe_mlp(
        m, mlp_params, activation=act,
        capacity_factor=float(cfg.n_experts), top_k=cfg.moe_top_k,
        dispatch_impl=cfg.moe_dispatch,
    )
    return out


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
    act = activation(cfg.activation_function)
    if cfg.n_experts:
        return x + _moe_mlp(m, bp["mlp"], cfg, act)
    m = act(dense(m, bp["mlp"]["c_fc"]))
    return x + dense(m, bp["mlp"]["c_proj"])


def _llama_block(x, bp, kv, pos, slots, cfg, block_tables, cos, sin,
                 paged_impl="gather", kv_quant="none"):
    """RMSNorm pre-norm block: every projection through ``qdot`` (plain or
    int8 weights), RoPE on q and k at each row's own positions, SwiGLU
    (or SwiGLU experts)."""
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
    if cfg.n_experts:
        return x + _moe_mlp(m, bp["mlp"], cfg, torch.nn.functional.silu)
    gate = torch.nn.functional.silu(qdot(m, bp["mlp"]["gate"]))
    up = qdot(m, bp["mlp"]["up"])
    return x + qdot(gate * up, bp["mlp"]["down"])


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
) -> tuple[torch.Tensor, Cache]:
    """Run T tokens per row at positions pos..pos+T-1 through the cache.
    Returns ([B, T, V] logits in ``cfg.logits_dtype``, ``cache``), the
    cache updated in place. Without ``block_tables`` the cache is dense
    (``init_cache``) and ``pos`` an int or a [B] tensor; with them it is
    paged (``init_paged_cache``), ``pos`` must be a [B] tensor,
    ``paged_impl`` picks single-token attention — "gather" (plain
    PyTorch over gathered pages) or "kernel" (the paged decode kernel, K3
    or for int8 pools K4; on CPU tensors its plain version) — and
    ``kv_quant`` names the pool layout. A row's values are those of the
    same call with that row alone."""
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
    for layer, bp in enumerate(params["blocks"]):
        kv = {name: c[layer] for name, c in cache.items()}
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
    params = to_device(params, device)
    ids = as_prompt(prompt, device)
    b, tp = ids.shape
    sampled = temperature > 0
    t, k, p = sampling_scalars(temperature, top_k, top_p, cfg.vocab_size)
    cache = init_cache(cfg, b, max_len or tp + max_new_tokens,
                       device=device)
    logits, cache = forward(params, ids, cfg, cache, 0)
    tok = sample_token(logits[:, -1], sampled, t, sample_seed(seed, 0), k, p)
    out = [ids, tok[:, None]]
    for i in range(max_new_tokens - 1):
        logits, cache = forward(params, tok[:, None], cfg, cache, tp + i)
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
def shim_engine(cfg: ModelConfig, max_len: int, device: str):
    """The engine behind ``generate``: exact-length buckets and no cache
    pool (an engine lives as long as the process, so a pooled cache per
    request shape would grow memory with request diversity)."""
    from pytorch_distributed_tpu_torch.serving.engine import DecodeEngine

    return DecodeEngine(cfg, max_len=max_len, pool_caches=False,
                        device=device)


def generate_tp(*args, **kwargs):
    """Tensor-parallel decode: not ported yet."""
    raise NotImplementedError(f"generate_tp {MESH_NOT_PORTED}")


def generate_tp_monolithic(*args, **kwargs):
    """Tensor-parallel reference decode: not ported yet."""
    raise NotImplementedError(f"generate_tp_monolithic {MESH_NOT_PORTED}")


def generate_fsdp(*args, **kwargs):
    """ZeRO-3 decode from the training layout: not ported yet."""
    raise NotImplementedError(f"generate_fsdp {MESH_NOT_PORTED}")


def generate_fsdp_monolithic(*args, **kwargs):
    """ZeRO-3 reference decode: not ported yet."""
    raise NotImplementedError(f"generate_fsdp_monolithic {MESH_NOT_PORTED}")
