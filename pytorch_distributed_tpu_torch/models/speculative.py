"""Prompt-lookup speculative decoding: the host-side drafter and the
single-sequence reference loop.

The port of the JAX package's ``models/speculative.py``. The serving
implementation lives in ``serving/engine.py``: the batched engines built
with ``speculative_k=K`` draft up to K tokens per greedy row on the host
(``prompt_lookup_draft`` below), verify every row's drafts in one
[slots, K+1] forward and commit each row's accepted prefix plus the
model's next token (``models/decode.speculative_accept``). This module
keeps:

- ``prompt_lookup_draft`` — the numpy n-gram drafter the engines call
  per row per tick (the port's own copy of the JAX package's numpy
  logic);
- ``generate_speculative`` — the greedy reference loop the engines are
  held token-equal to, and the MoE path of ``serving.generate
  --speculative`` (the batched engines refuse MoE: expert capacity
  couples rows). Each iteration drafts with ``_lookup_draft`` (the
  vectorised lookup over the output buffer, as the JAX package's traced
  one), runs ONE forward of K+1 tokens (the last token plus K drafts)
  against the dense cache, and commits the accepted drafts plus the
  model's own next token. Rejected drafts' K/V stay past the committed
  position, masked, and are overwritten by the next window. The JAX
  package runs the loop inside one program; here it is a host loop with
  one device-to-host read of the accept count per iteration.

Exactness: the output is a greedy decode of the model whatever the
drafts; in float32 on the CPU it equals the plain ``decode.generate``.
A K+1-token forward and a 1-token forward are differently shaped
products, so on the card (and in bf16) a near-tie can round the other
way, as the JAX package's docstring says of its accelerator.
"""

from __future__ import annotations

import numpy as np
import torch

from pytorch_distributed_tpu_torch.config import ModelConfig
from pytorch_distributed_tpu_torch.models import decode
from pytorch_distributed_tpu_torch.utils.device import resolve_device


def prompt_lookup_draft(
    tokens: np.ndarray, k: int, ngram: int = 2
) -> np.ndarray:
    """Host-side prompt-lookup drafter: find the most recent EARLIER
    occurrence of the trailing ``ngram`` of ``tokens`` and return up to
    ``k`` tokens that followed it ([<=k] int32; empty when there is no
    match or the history is not longer than the n-gram). Windows lie
    fully inside the known prefix and the trailing n-gram itself is
    excluded. Drafts are proposals only: the verify forward decides."""
    tokens = np.asarray(tokens, np.int32)
    n = tokens.shape[0]
    if k < 1 or n <= ngram:
        return np.zeros((0,), np.int32)
    tail = tokens[-ngram:]
    # Candidate windows start at 0..n-ngram-1 (the last window IS the
    # tail): those whose first token matches, checked whole from the most
    # recent back — the first full match is the closest context. (One
    # compare over the history a call: the engines draft every greedy row
    # on every tick, on the host.)
    for start in np.flatnonzero(tokens[: n - ngram] == tail[0])[::-1]:
        if ngram == 1 or np.array_equal(tokens[start:start + ngram], tail):
            best = int(start)
            return tokens[best + ngram : best + ngram + k].copy()
    return np.zeros((0,), np.int32)


def _lookup_draft(out_buf, pos, *, ngram: int, draft_len: int, total: int):
    """The vectorised lookup of the reference loop: the ``draft_len``
    tokens that followed the most recent earlier occurrence of the
    trailing ``ngram`` of ``out_buf[0, :pos]`` ([draft_len] int64; zeros
    where there is no match or the continuation is not yet known)."""
    seq = out_buf[0]  # [total]
    dev = seq.device
    tail_idx = (pos - ngram + torch.arange(ngram, device=dev)).clamp(
        0, total - 1)
    tail = seq[tail_idx]
    starts = torch.arange(total, device=dev)
    win_idx = (starts[:, None] + torch.arange(ngram, device=dev)[None]
               ).clamp(max=total - 1)
    matches = (seq[win_idx] == tail[None]).all(dim=1)
    # A window counts when it lies inside the known prefix and is not the
    # tail itself; the most recent match wins (-1: none).
    hit = matches & (starts + ngram < pos)
    best = torch.where(hit, starts, -1).max()
    draft_idx = best + ngram + torch.arange(draft_len, device=dev)
    draft = seq[draft_idx.clamp(0, total - 1)]
    known = (best >= 0) & (draft_idx < pos)
    return torch.where(known, draft, 0)


@torch.no_grad()
def generate_speculative(
    params,
    prompt,  # [1, Tp] int — single sequence
    cfg: ModelConfig,
    max_new_tokens: int,
    *,
    draft_len: int = 8,
    ngram: int = 2,
    device=None,
) -> torch.Tensor:
    """Greedy generation with prompt-lookup speculative decoding. Returns
    [1, Tp + max_new_tokens] int32 on ``device`` (None: the GPU) — the
    plain greedy decode (module docstring). ``draft_len`` (K) is the
    speculation depth: each iteration verifies K drafted tokens in one
    K+1-token forward and commits 1 to K+1 tokens. ``ngram`` is the
    lookup width."""
    prompt = np.asarray(prompt)
    if prompt.ndim != 2 or prompt.shape[0] != 1:
        raise ValueError(
            "speculative decoding is single-sequence ([1, Tp] prompts): "
            "per-row acceptance lengths would need per-row cache offsets "
            f"(got shape {tuple(prompt.shape)})"
        )
    if draft_len < 1:
        raise ValueError(f"draft_len must be >= 1, got {draft_len}")
    if ngram < 1:
        raise ValueError(f"ngram must be >= 1, got {ngram}")
    if max_new_tokens < 0:
        raise ValueError(f"max_new_tokens must be >= 0, got {max_new_tokens}")
    device = resolve_device(device)
    ids = decode.as_prompt(prompt, device)
    if max_new_tokens == 0:
        return ids.to(torch.int32)
    tp = ids.shape[1]
    total = tp + max_new_tokens
    # The verify forward may write up to draft_len positions past the last
    # needed one; the cache (and the position table) must cover them.
    max_len = total + draft_len
    if max_len > cfg.n_ctx:
        raise ValueError(
            f"prompt + max_new_tokens + draft_len = {max_len} exceeds "
            f"n_ctx {cfg.n_ctx}; shorten the generation or draft_len"
        )
    params = decode.to_device(params, device)
    cache = decode.init_cache(cfg, 1, max_len, device=device)
    out = torch.zeros((1, total), dtype=torch.long, device=device)
    out[:, :tp] = ids
    logits, cache = decode.forward(params, ids, cfg, cache, 0)
    out[:, tp] = torch.argmax(logits[:, -1].float(), dim=-1)
    pos = tp + 1  # tokens known so far
    while pos < total:
        draft = _lookup_draft(out, pos, ngram=ngram, draft_len=draft_len,
                              total=total)
        window = torch.cat([out[:, pos - 1:pos], draft[None]], dim=1)
        logits, cache = decode.forward(params, window, cfg, cache, pos - 1)
        greedy = torch.argmax(logits.float(), dim=-1)[0]  # [K+1]
        n_acc = int(torch.cumprod((draft == greedy[:draft_len]).long(),
                                  dim=0).sum())
        # Accepted drafts plus the model's own next token, clipped at the
        # end of the output.
        n = min(n_acc + 1, total - pos)
        out[0, pos:pos + n] = greedy[:n]
        pos += n
    return out.to(torch.int32)
