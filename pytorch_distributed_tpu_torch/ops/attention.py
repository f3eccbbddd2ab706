"""Multi-head causal self-attention for training.

The port of the JAX package's ``ops/attention.py`` (``naive_attention``,
``multi_head_attention``) and of the ``[B, T, H, D]`` wrapper around the
flash kernels in ``ops/pallas_flash.py`` (``flash_attention`` /
``_pallas_flash``). Inputs and outputs are ``[B, T, H(kv), D]``.

- ``naive``: materialises the f32 ``[B, H, T, S]`` scores; attention
  dropout acts on the f32 softmax weights before their cast to v's dtype,
  as in the JAX package.
- ``flash``: ``ops/flash_kernel.flash_mha`` on ``[B, H, T, D]`` views of
  the inputs (no copies): K1 forward, K2 backward on the card, their plain
  versions on the CPU. The JAX package's off-TPU blockwise scan
  (``pallas_flash.blockwise_attention``) is not ported: on the CPU the
  kernels' plain versions take its place. The flash kernels have no
  dropout (in neither package): training with ``attn_pdrop > 0`` takes
  the naive path (``flash_active``).
"""

from __future__ import annotations

import torch

from pytorch_distributed_tpu_torch.ops.layers import dropout
from pytorch_distributed_tpu_torch.ops.remat import checkpoint_name, product
from pytorch_distributed_tpu_torch.utils.prng import StreamId

NEG_INF = -1e30  # finite mask value: -inf breaks softmax when a row is all-masked


def flash_active(impl: str, dropout_rate: float,
                 deterministic: bool) -> bool:
    """Whether ``multi_head_attention`` runs the flash kernels: flash was
    asked for and no attention dropout is drawn. The port of the JAX
    ``models/gpt2._flash_kernel_active``, whose other clauses do not apply
    here (no sequence axis; the port's kernels take every training
    length). Where it is true, the flash op keeps its own (o, lse) for
    remat, and the naive path's ``attn_out`` tag does not exist."""
    return impl == "flash" and (deterministic or dropout_rate == 0.0)


def naive_attention(q, k, v, *, causal: bool = True,
                    dropout_rate: float = 0.0,
                    dropout_sid: StreamId | None = None,
                    deterministic: bool = True,
                    out_name: str | None = None) -> torch.Tensor:
    """[B, T, H, D] x [B, S, Hkv, D] -> [B, T, H, D] in v's dtype; scores
    and softmax in f32, the last query aligned with the last key. Both
    products go through ``ops/remat.product``: the f32 score product is
    tagged ``attn_scores`` (kept by ``dots`` remat), the weights-times-
    values product ``out_name`` (the JAX model tags the attention output
    ``attn_out`` when the flash kernel is off). ``dropout_sid`` is the
    attention mask's stream (``utils/prng``)."""
    b, t, h, d = q.shape
    s = k.shape[1]
    if k.shape[2] != h:
        k = k.repeat_interleave(h // k.shape[2], dim=2)
        v = v.repeat_interleave(h // v.shape[2], dim=2)
    with checkpoint_name("attn_scores"):
        scores = product(q.float().transpose(1, 2),
                         k.float().permute(0, 2, 3, 1))
    scores = scores * (1.0 / d**0.5)
    if causal:
        qpos = torch.arange(t, device=q.device)[:, None] + (s - t)
        kpos = torch.arange(s, device=q.device)[None, :]
        scores = torch.where(kpos <= qpos, scores, NEG_INF)
    weights = torch.softmax(scores, dim=-1)
    weights = dropout(weights, dropout_rate, dropout_sid,
                      deterministic=deterministic).to(v.dtype)
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
                         causal: bool = True, dropout_rate: float = 0.0,
                         dropout_sid: StreamId | None = None,
                         deterministic: bool = True,
                         out_name: str | None = None) -> torch.Tensor:
    """Dispatch over attention implementations; inputs [B, T, H(kv), D].
    ``impl="flash"`` with attention dropout drawn runs the naive path, as
    in the JAX package. ``out_name`` tags the naive path's output for
    ``names`` remat; the flash path keeps its (o, lse) itself."""
    if impl not in ("naive", "flash"):
        raise KeyError(f"unknown attention impl {impl!r}")
    if flash_active(impl, dropout_rate, deterministic):
        return flash_attention(q, k, v, causal=causal)
    return naive_attention(q, k, v, causal=causal, dropout_rate=dropout_rate,
                           dropout_sid=dropout_sid,
                           deterministic=deterministic, out_name=out_name)
