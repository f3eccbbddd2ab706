"""Multi-head causal self-attention for training.

The port of the JAX package's ``ops/attention.py`` (``naive_attention``,
``multi_head_attention``) and of the ``[B, T, H, D]`` wrapper around the
flash kernels in ``ops/pallas_flash.py`` (``flash_attention`` /
``_pallas_flash``). Inputs and outputs are ``[B, T, H(kv), D]``.

- ``naive``: materialises the f32 ``[B, H, T, S]`` scores. Attention
  dropout is not ported yet (the trainer refuses ``attn_pdrop > 0``).
- ``flash``: ``ops/flash_kernel.flash_mha`` on ``[B, H, T, D]`` views of
  the inputs (no copies): K1 forward, K2 backward on the card, their plain
  versions on the CPU. The JAX package's off-TPU blockwise scan
  (``pallas_flash.blockwise_attention``) is not ported: on the CPU the
  kernels' plain versions take its place.
"""

from __future__ import annotations

import torch

from pytorch_distributed_tpu_torch.ops.remat import checkpoint_name, product

NEG_INF = -1e30  # finite mask value: -inf breaks softmax when a row is all-masked


def naive_attention(q, k, v, *, causal: bool = True,
                    out_name: str | None = None) -> torch.Tensor:
    """[B, T, H, D] x [B, S, Hkv, D] -> [B, T, H, D] in v's dtype; scores
    and softmax in f32, the last query aligned with the last key. The
    weights-times-values product is tagged ``out_name`` for the remat
    policy (the JAX model tags the attention output ``attn_out`` when the
    flash kernel is off)."""
    b, t, h, d = q.shape
    s = k.shape[1]
    if k.shape[2] != h:
        k = k.repeat_interleave(h // k.shape[2], dim=2)
        v = v.repeat_interleave(h // v.shape[2], dim=2)
    scores = torch.einsum("bthd,bshd->bhts", q.float(), k.float()) * (
        1.0 / d**0.5
    )
    if causal:
        qpos = torch.arange(t, device=q.device)[:, None] + (s - t)
        kpos = torch.arange(s, device=q.device)[None, :]
        scores = torch.where(kpos <= qpos, scores, NEG_INF)
    weights = torch.softmax(scores, dim=-1).to(v.dtype)
    with checkpoint_name(out_name):
        return product(weights, v.transpose(1, 2)).transpose(1, 2)


def flash_attention(q, k, v, *, causal: bool = True) -> torch.Tensor:
    """[B, T, H, D] -> [B, T, H, D] through the flash kernels (GQA heads
    resolved in-kernel, no repeat)."""
    from pytorch_distributed_tpu_torch.ops.flash_kernel import flash_mha

    o, _ = flash_mha(q.transpose(1, 2), k.transpose(1, 2),
                     v.transpose(1, 2), causal)
    return o.transpose(1, 2)


def multi_head_attention(q, k, v, *, impl: str = "naive",
                         causal: bool = True,
                         out_name: str | None = None) -> torch.Tensor:
    """Dispatch over attention implementations; inputs [B, T, H(kv), D].
    ``out_name`` tags the naive path's output for ``names`` remat; the
    flash path keeps its (o, lse) itself."""
    if impl == "naive":
        return naive_attention(q, k, v, causal=causal, out_name=out_name)
    if impl == "flash":
        return flash_attention(q, k, v, causal=causal)
    raise KeyError(f"unknown attention impl {impl!r}")
