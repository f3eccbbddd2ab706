"""int8 quantization for the bandwidth-bound serving path.

The port of the JAX package's ``ops/quant.py``. Decode streams the whole
KV pool and every projection weight through device memory per token;
int8 roughly halves those bytes against a bf16 deployment. Two families:

1. **KV pages** (``quantize_kv`` / ``dequantize_kv``): symmetric int8 with
   a PER-TOKEN, PER-KV-HEAD f32 scale (``max|x[..., :]| / 127`` over the
   head dim), stored beside the value pages (``[L, P, page, Hkv]`` scale
   pools next to the ``[L, P, page, Hkv, D]`` int8 pools). A token's
   scale depends on that token alone, so appending to a page never
   re-quantizes what it already holds, and a re-prefill after preemption
   writes bit-identical pages.
2. **Weights** (``quantize_weight`` / ``quantize_decode_params``):
   weight-only int8 with one f32 scale per output channel over the
   contracting dim, for the block projections
   (``QUANT_WEIGHT_SUFFIXES``). ``qdot`` computes
   ``(x @ q8.to(x.dtype)) * scale``: the matmul runs in the activation
   dtype. Embeddings, the LM head and norms stay full precision.

The arithmetic is the JAX package's, step for step (``amax / 127``,
scale 1 for an all-zero row, a true division by ``max(scale, 1e-30)``,
round half to even, clamp to [-127, 127]), so equal f32 inputs give
bit-equal int8 values and scales on both sides.

The quality metrics are numpy copies of the JAX module's: the port keeps
its own so it never imports the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

# Pinned quality budgets of the int8 serving path (the JAX package's
# values). The pinned token metric is teacher-forced greedy agreement
# (``argmax_agreement`` over two logit tensors for IDENTICAL contexts):
# it measures quantization error and nothing else. The autoregressive
# ``token_match_rate`` compounds one early flip over a whole generation
# and is reported, not pinned.
Q8_QUALITY = {
    "max_relative_logit_mse": 2e-3,
    "min_token_match_rate": 0.90,
}

_EPS = 1e-30
_QKEYS = frozenset({"q8", "scale"})

# The decode-path projection weights ``quantize_decode_params`` targets,
# keyed by their path inside one layer's params: the gpt2 kernels and the
# llama raw matrices. Embeddings, the head, norms and biases stay as they
# are.
QUANT_WEIGHT_SUFFIXES: frozenset[tuple[str, ...]] = frozenset({
    ("attn", "c_attn", "kernel"),
    ("attn", "c_proj", "kernel"),
    ("mlp", "c_fc", "kernel"),
    ("mlp", "c_proj", "kernel"),
    ("attn", "wq"),
    ("attn", "wk"),
    ("attn", "wv"),
    ("attn", "wo"),
    ("mlp", "gate"),
    ("mlp", "up"),
    ("mlp", "down"),
})


def check_mode(name: str, value: str) -> str:
    """``value`` if it names a quantization mode ("none" or "int8"), else
    ValueError (``kv_quant``/``weight_quant`` arguments)."""
    if value not in ("none", "int8"):
        raise ValueError(f"{name} must be 'none' or 'int8', got {value!r}")
    return value


def _quantize(x32: torch.Tensor, amax: torch.Tensor, axis: int):
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.round(x32 / scale.clamp(min=_EPS).unsqueeze(axis))
    return q.clamp(-127, 127).to(torch.int8), scale


def quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 with a per-token, per-head scale: ``x`` is [..., D]
    (new K or V, [B, T, Hkv, D]); the scale is taken over the head dim
    only. Returns (int8 of x.shape, f32 scales of x.shape[:-1]). An
    all-zero row gets scale 1, so it dequantizes to exact zeros; -128 is
    never emitted, so |dequantized| <= amax."""
    x32 = x.float()
    return _quantize(x32, x32.abs().amax(dim=-1), -1)


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor,
                  dtype: torch.dtype) -> torch.Tensor:
    """Inverse of ``quantize_kv``: int8 [..., D] times f32 scales [...],
    computed in f32, returned in ``dtype``."""
    return (q.float() * scale[..., None]).to(dtype)


def is_quantized(w) -> bool:
    return isinstance(w, dict) and set(w) == _QKEYS


def quantize_weight(w: torch.Tensor, contract_axis: int = 0) -> dict:
    """Per-output-channel symmetric int8: the scale reduces over
    ``contract_axis`` (the matmul's contracting dim; 0 for the port's
    per-layer [in, out...] kernels), one f32 scale per output coordinate.
    Returns {"q8": int8 of w.shape, "scale": f32 of the output shape}."""
    w32 = w.float()
    q, scale = _quantize(w32, w32.abs().amax(dim=contract_axis),
                         contract_axis)
    return {"q8": q, "scale": scale}


def qdot(x: torch.Tensor, w) -> torch.Tensor:
    """``x @ w`` over x's last dim and w's first, w [in, out...] plain (as
    ``x @ w.to(x.dtype)``) or a ``quantize_weight`` dict (the int8 values
    cast to x's dtype per call, the product in that dtype, then times the
    per-channel scale in the product's dtype, as the JAX ``qdot``).
    Returns [..., out...]."""
    quantized = is_quantized(w)
    k = w["q8"] if quantized else w
    y = x @ k.reshape(k.shape[0], -1).to(x.dtype)
    y = y.reshape(*x.shape[:-1], *k.shape[1:])
    if quantized:
        y = y * w["scale"].to(y.dtype)
    return y


def _quantize_layer(tree, path=()):
    if is_quantized(tree):
        return tree
    if isinstance(tree, dict):
        return {k: _quantize_layer(v, path + (k,)) for k, v in tree.items()}
    if any(path[-n:] in QUANT_WEIGHT_SUFFIXES for n in (3, 2)
           if len(path) >= n):
        return quantize_weight(tree, contract_axis=0)
    return tree


def quantize_decode_params(params: dict) -> dict:
    """Quantize the block projection weights of a port params tree
    (``QUANT_WEIGHT_SUFFIXES`` inside each of ``params["blocks"]``, a list
    of per-layer dicts); every other leaf is passed through as the same
    tensor. Already quantized weights stay as they are."""
    out = dict(params)
    out["blocks"] = [_quantize_layer(bp) for bp in params["blocks"]]
    return out


# -- quality metrics (numpy copies of the JAX package's) --------------------


def relative_logit_mse(ref_logits, q_logits) -> float:
    """Scale-free logit error: mean((q - ref)^2) / mean(ref^2)."""
    ref = np.asarray(ref_logits, np.float64)
    q = np.asarray(q_logits, np.float64)
    denom = max(float(np.mean(ref * ref)), _EPS)
    return float(np.mean((q - ref) ** 2) / denom)


def argmax_agreement(ref_logits, q_logits) -> float:
    """Teacher-forced greedy agreement: the share of positions where both
    logit tensors ([..., V], identical input contexts) pick the same
    argmax."""
    ref = np.argmax(np.asarray(ref_logits), axis=-1)
    q = np.argmax(np.asarray(q_logits), axis=-1)
    return float(np.mean(ref == q))


def token_match_rate(ref_tokens, q_tokens) -> float:
    """Greedy-continuation agreement over paired token sequences:
    sum(longest common prefix) / sum(longer length). 1.0 means every
    sequence is identical."""
    total = matched = 0
    for r, q in zip(ref_tokens, q_tokens, strict=True):
        r = np.asarray(r)
        q = np.asarray(q)
        n = min(r.shape[0], q.shape[0])
        agree = r[:n] == q[:n]
        m = int(agree.argmin()) if not agree.all() else n
        matched += m
        total += max(r.shape[0], q.shape[0])
    return matched / max(total, 1)
