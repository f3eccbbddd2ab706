"""Core layer primitives as plain tensor functions over param dicts.

Conventions shared with the JAX package's ``ops/layers.py``:

- Dense kernels are stored ``[in_features, out...]``, so weights convert
  between the packages without a transpose, and ``y = x @ kernel + bias``.
- Normalisation statistics are computed in float32 whatever the
  activation dtype, then cast back.
- The matmul runs in the activation dtype. ``dense`` casts the kernel
  per call (``x @ w.to(x.dtype)``), as the JAX package does, so training
  keeps f32 master weights and autograd returns their gradients in f32
  (the cast's backward). Serving alone casts the weights ONCE when it
  places them on the device (``serving/engine``), which gives the same
  values without re-reading every weight per decode step; those pre-cast
  weights are for inference only.
- A quantized kernel (``ops/quant.quantize_weight``: int8 values and a
  per-output-channel f32 scale) goes through ``ops/quant.qdot``, as the
  JAX package's ``dense`` delegates to its ``qdot``.
- ``dense(tp_group=, extra_pre_reduce=)`` is JAX's ``tp_reduce_axis`` and
  ``extra_pre_reduce``: a row-parallel product's partial, its addend and
  its int8 scale, ONE all-reduce (``ops/tp``), then the bias
  (``dense_epilogue``).
- ``dropout`` draws its mask through ``utils/prng.draw_keep_mask`` from a
  stream id, where the JAX package's draws ``jax.random.bernoulli`` from a
  key.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from pytorch_distributed_tpu_torch.ops.quant import is_quantized, qdot
from pytorch_distributed_tpu_torch.ops.remat import product
from pytorch_distributed_tpu_torch.ops.tp import tp_reduce
from pytorch_distributed_tpu_torch.utils import prng


def dense(x: torch.Tensor, params: dict, *, tp_group=None,
          extra_pre_reduce=None) -> torch.Tensor:
    """y = x @ kernel + bias; kernel [in, out...] (trailing output dims
    are kept, e.g. the merged QKV kernel [E, 3, H, D]) or its int8 form
    (``ops/quant.qdot``: the scale applied before the bias); bias
    optional. A plain kernel's product is kept by ``names`` remat under a
    saved tag (``ops/remat.product``).

    ``tp_group``: the tensor group this product is row-parallel over (the
    JAX package's ``tp_reduce_axis``): the kernel's input dim is sharded,
    each rank's product is a partial sum, and ONE all-reduce
    (``ops/tp.tp_reduce``) runs after the partial product and before the
    replicated bias, so the bias is counted once. The int8 scale is a
    linear factor applied inside ``qdot``, before the sum.
    ``extra_pre_reduce``: an addend joined to the (partial) product before
    the sum — a tensor, or a function ``y -> y + delta`` (the LoRA delta
    kernel adds in place, ``ops/lora_kernel``). On a row-parallel
    projection the delta is a partial too, and by linearity one sum of
    (base + delta) equals the sum of each, so adapters add no collective.
    """
    w = params["kernel"]
    if is_quantized(w):
        y = qdot(x, w)
    else:
        y = product(x, w.reshape(w.shape[0], -1).to(x.dtype))
        y = y.reshape(*x.shape[:-1], *w.shape[1:])
    return dense_epilogue(y, params, tp_group=tp_group,
                          extra_pre_reduce=extra_pre_reduce)


def dense_epilogue(y: torch.Tensor, params: dict, *, tp_group=None,
                   extra_pre_reduce=None) -> torch.Tensor:
    """The tail of ``dense`` after its product ``y``: the pre-reduce
    addend, the one all-reduce over ``tp_group``, then ``params``' bias
    (if any). Decode calls it on a product it computed itself (lane 0
    alone, ``models/decode._lane0``), so that a projection issues one
    all-reduce whatever the product's shape."""
    if callable(extra_pre_reduce):
        y = extra_pre_reduce(y)
    elif extra_pre_reduce is not None:
        y = y + extra_pre_reduce.to(y.dtype)
    y = tp_reduce(y, tp_group)
    bias = params.get("bias")
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y


def layer_norm(x: torch.Tensor, params: dict, *, eps: float) -> torch.Tensor:
    """LayerNorm with learned scale/bias: normalised and scaled in float32
    (one fused kernel), then cast back to x's dtype."""
    y = F.layer_norm(x.float(), x.shape[-1:], params["scale"].float(),
                     params["bias"].float(), eps)
    return y.to(x.dtype)


def rms_norm(x: torch.Tensor, params: dict, *, eps: float) -> torch.Tensor:
    """RMSNorm (llama family): normalised and scaled in float32, then cast
    back to x's dtype."""
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps) * params["scale"].float()
    return y.to(x.dtype)


def dropout(x: torch.Tensor, rate: float, sid: prng.StreamId | None, *,
            deterministic: bool) -> torch.Tensor:
    """``where(mask, x / keep, 0)`` in x's dtype, keep = 1 - rate, the mask
    ``prng.draw_keep_mask(sid, ...)``; identity when ``deterministic`` or
    ``rate == 0``. As in the JAX package, ``keep`` is first rounded to x's
    dtype (a Python float meets a bf16 array as bf16), and the quotient is
    rounded to x's dtype once. ``keep`` is a 0-dim tensor filled on x's
    device (``torch.tensor`` would copy it from the host: a sync per mask),
    so it also divides elementwise (PyTorch's CUDA division by a host
    scalar multiplies by its reciprocal)."""
    if deterministic or rate == 0.0:
        return x
    if sid is None:
        raise ValueError("dropout requires a stream id when not deterministic")
    keep = 1.0 - rate
    mask = prng.draw_keep_mask(sid, x.shape, keep, x.device)
    scaled = x / torch.full((), keep, dtype=x.dtype, device=x.device)
    return torch.where(mask, scaled, torch.zeros((), dtype=x.dtype,
                                                 device=x.device))


_ACTIVATIONS = {
    # "gelu_new" is HF's tanh-approximated gelu (GPT-2's activation).
    "gelu_new": lambda x: F.gelu(x, approximate="tanh"),
    "gelu": lambda x: F.gelu(x, approximate="none"),
    "relu": F.relu,
    "silu": F.silu,
}


def activation(name: str):
    try:
        return _ACTIVATIONS[name]
    except KeyError:
        raise KeyError(
            f"unknown activation {name!r}; known: {sorted(_ACTIVATIONS)}"
        ) from None
