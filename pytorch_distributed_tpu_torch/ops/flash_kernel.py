"""Flash attention with its fused backward: the Hopper kernels and their
plain versions.

The port of the JAX package's ``ops/flash_kernel.py``: the Pallas kernels
``_fwd_kernel`` (K1) and ``_bwd_kernel`` (K2) and the custom VJP that ties
them (``flash_mha``). Layout ``[B, H, T, D]``; k and v may have fewer
heads (grouped-query attention, query head h reads KV head h // group);
T == S self-attention, causal or not.

- ``flash_forward(q, k, v, causal, scale) -> (o, lse)`` and
  ``flash_backward(q, k, v, o, lse, do, causal, scale) -> (dq, dk, dv)``
  are the kernels' wrappers. On CUDA tensors they launch the kernels of
  ``csrc/flash_attention.cu`` (built at first use, ``ops/_build.py``) or
  raise; on CPU tensors, and only there, they run the plain versions.
  bf16 runs on the tensor cores (wgmma); f32 on f32 FMAs, for exact parity.
  Inputs may be strided views with a contiguous head dim; ``o`` comes back
  as a ``[B, H, T, D]`` view of ``[B, T, H, D]`` memory, which is what the
  model's next projection reads, and so do dq, dk and dv.
- ``flash_forward_reference`` materialises the masked f32 scores (base 2,
  ``NEG_INF`` = -1e30) and returns ``(o, lse)``; ``flash_backward_reference``
  computes dq, dk, dv in closed form from ``(q, k, v, o, lse, do)``, as K2
  does (it does not differentiate the forward). Both round the softmax
  weights (and dS) to the input dtype before their products, as the TPU
  kernels and the bf16 CUDA kernels do (the tensor cores take bf16
  operands); what is left between them in bf16 is summation order, exp2's
  last bits, and where those flip a rounding.
- ``flash_mha(q, k, v, causal=True, scale=None) -> (o, lse)`` is the
  differentiable entry: a ``torch.autograd.Function`` whose gradient runs
  ``flash_backward``. ``lse`` is ``[B, H, T]`` f32 with no gradient (the
  JAX package returns it under ``stop_gradient``). Under ``names`` and
  ``flash`` remat the op keeps both outputs (``ops/remat.keep``), so the
  backward never re-runs K1.
- ``launches`` counts kernel launches and ``plain_calls`` the plain
  versions' calls made by the wrappers on CPU tensors, per direction
  ("forward", "backward"), so a run can show that its steps went through
  the kernels.

Measured on the CPU in f32 against the JAX ``flash_mha`` in interpret mode
(tests/test_torch_flash_kernel.py): o 3.6e-7, lse 4.8e-7, dq/dk/dv 3.3e-6.
"""

from __future__ import annotations

import ctypes

import torch

from pytorch_distributed_tpu_torch.ops import remat

LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453
NEG_INF = -1e30

launches = {"forward": 0, "backward": 0}
plain_calls = {"forward": 0, "backward": 0}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)
_GROUPS = (1, 2, 4, 8)


def _expand_kv(x: torch.Tensor, h: int) -> torch.Tensor:
    """[B, Hkv, T, D] -> [B, H, T, D] (query head i reads KV head i // g)."""
    return x if x.shape[1] == h else x.repeat_interleave(h // x.shape[1], 1)


def _scores(q, k, causal, scale) -> torch.Tensor:
    """Masked f32 scores in the base-2 domain, [B, H, T, S]."""
    t, s = q.shape[2], k.shape[2]
    x = torch.einsum("bhtd,bhsd->bhts", q.float(),
                     _expand_kv(k, q.shape[1]).float()) * (scale * LOG2E)
    if causal:
        valid = (torch.arange(s, device=q.device)[None, :]
                 <= torch.arange(t, device=q.device)[:, None])
        x = torch.where(valid, x, NEG_INF)
    return x


def flash_forward_reference(q, k, v, causal: bool = True,
                            scale: float | None = None):
    """Plain version of K1: (o [B, H, T, D] in q's dtype, lse [B, H, T]
    f32 natural log)."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    s = _scores(q, k, causal, scale)
    m = s.amax(-1, keepdim=True)
    p = torch.exp2(s - m)
    l = p.sum(-1, keepdim=True).clamp_min(1e-30)
    acc = torch.einsum("bhts,bhsd->bhtd", p.to(v.dtype).float(),
                       _expand_kv(v, q.shape[1]).float())
    o = (acc / l).to(q.dtype)
    lse = (m * LN2 + torch.log(l))[..., 0]
    return o, lse


def flash_backward_reference(q, k, v, o, lse, do, causal: bool = True,
                             scale: float | None = None):
    """Plain version of K2: dq in q's dtype, dk and dv [B, Hkv, T, D] in
    k's and v's dtypes, from (q, k, v, o, lse, do) in closed form:
    P = exp2(S - lse log2 e), dP = dO V^T, delta = rowsum(O dO),
    dS = P (dP - delta) scale; dV = P^T dO, dK = dS^T Q, dQ = dS K, with
    dk/dv summed over each KV head's query-head group."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    h, hkv = q.shape[1], k.shape[1]
    p = torch.exp2(_scores(q, k, causal, scale)
                   - lse.float()[..., None] * LOG2E)
    dof = do.float()
    dp = torch.einsum("bhtd,bhsd->bhts", dof, _expand_kv(v, h).float())
    delta = (o.float() * dof).sum(-1)
    ds = p * (dp - delta[..., None]) * scale
    p_b = p.to(do.dtype).float()
    ds_b = ds.to(q.dtype).float()
    dv = torch.einsum("bhts,bhtd->bhsd", p_b, dof)
    dk = torch.einsum("bhts,bhtd->bhsd", ds_b, q.float())
    dq = torch.einsum("bhts,bhsd->bhtd", ds_b, _expand_kv(k, h).float())
    if hkv != h:
        b, _, t, d = k.shape
        dk = dk.reshape(b, hkv, h // hkv, t, d).sum(2)
        dv = dv.reshape(b, hkv, h // hkv, t, d).sum(2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _lib():
    """The built library's two C entry points, their signatures declared
    once (every pointer and the stream as c_void_p, or ctypes would cut
    them to 32 bits)."""
    from pytorch_distributed_tpu_torch.ops import _build

    lib = _build.load("flash_attention")
    fwd, bwd = lib.pdt_flash_fwd, lib.pdt_flash_bwd
    if fwd.argtypes is None:
        ints = [ctypes.c_int] * 7
        fwd.restype = bwd.restype = ctypes.c_int
        fwd.argtypes = [ctypes.c_void_p] * 6 + ints + [ctypes.c_float,
                                                       ctypes.c_void_p]
        bwd.argtypes = [ctypes.c_void_p] * 11 + ints + [ctypes.c_float,
                                                        ctypes.c_void_p]
    return fwd, bwd


def _check(q, k, v) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(
            f"expected q, k, v as [B, H, T, D], got {tuple(q.shape)}, "
            f"{tuple(k.shape)}, {tuple(v.shape)}"
        )
    b, h, t, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[2:] != (t, d):
        raise ValueError(
            f"flash attention takes T == S self-attention with matching "
            f"K/V: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}"
        )
    if h % k.shape[1]:
        raise ValueError(
            f"query heads {h} must be a multiple of kv heads {k.shape[1]}"
        )
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError(
            f"q, k and v must share a dtype, got {q.dtype}, {k.dtype}, "
            f"{v.dtype}"
        )
    devices = {q.device, k.device, v.device}
    if len(devices) != 1:
        raise ValueError(f"all inputs must be on one device, got {devices}")


def _device_kind(x: torch.Tensor, what: str) -> str:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(
            f"{what} runs on cuda (kernel) or cpu (plain version), got "
            f"device {x.device}"
        )
    return x.device.type


def _kernel_strides(tensors, names) -> list[int]:
    """(b, h, t) element strides of each tensor, checked for what the
    kernel's 16-byte loads and stores need: a contiguous head dim, strides
    that keep rows 16-byte aligned, and 16-byte aligned data."""
    out = []
    for x, name in zip(tensors, names):
        vec = 16 // x.element_size()
        if x.stride(3) != 1:
            raise ValueError(f"the kernel takes {name} with a contiguous "
                             f"head dim, got strides {x.stride()}")
        if any(s % vec for s in x.stride()[:3]) or x.data_ptr() % 16:
            raise ValueError(
                f"the kernel takes {name} 16-byte aligned with strides that "
                f"are multiples of {vec} elements, got strides {x.stride()}"
            )
        out.extend(x.stride()[:3])
    return out


def _check_kernel_shape(q, k) -> None:
    b, h, t, d = q.shape
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(
            f"the kernel takes {sorted(map(str, _DTYPE_CODES))}, got {q.dtype}"
        )
    if d not in _HEAD_DIMS or h // k.shape[1] not in _GROUPS:
        raise ValueError(
            f"the kernel takes head_dim in {_HEAD_DIMS} and query-head "
            f"groups in {_GROUPS}, got head_dim {d}, group {h // k.shape[1]}"
        )
    if b < 1 or t < 1:
        raise ValueError(f"the kernel takes B >= 1 and T >= 1, got {b}, {t}")


def _bthd_like(x: torch.Tensor) -> torch.Tensor:
    """An uninitialised [B, H, T, D] tensor laid out as [B, T, H, D]."""
    b, h, t, d = x.shape
    return torch.empty(b, t, h, d, dtype=x.dtype,
                       device=x.device).transpose(1, 2)


def flash_forward(q, k, v, causal: bool = True,
                  scale: float | None = None):
    """K1: (o [B, H, T, D] in q's dtype, lse [B, H, T] f32). A CUDA tensor
    launches the kernel or raises; a CPU tensor takes the plain version."""
    _check(q, k, v)
    scale = q.shape[-1] ** -0.5 if scale is None else float(scale)
    if _device_kind(q, "flash_forward") == "cpu":
        plain_calls["forward"] += 1
        return flash_forward_reference(q, k, v, causal, scale)
    _check_kernel_shape(q, k)
    b, h, t, d = q.shape
    o = _bthd_like(q)
    lse = torch.empty(b, h, t, dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 12)(
        *_kernel_strides((q, k, v, o), ("q", "k", "v", "o"))
    )
    fwd, _ = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                  lse.data_ptr(), strides, b, h, k.shape[1], t, d,
                  _DTYPE_CODES[q.dtype], int(causal), scale, stream)
    if err:
        raise RuntimeError(f"flash forward kernel launch failed: error {err}")
    launches["forward"] += 1
    return o, lse


def flash_backward(q, k, v, o, lse, do, causal: bool = True,
                   scale: float | None = None):
    """K2: (dq in q's dtype, dk and dv [B, Hkv, T, D] in k's dtype). One
    launch of the backward runs the delta pass (rowsum(o * do) in f32, into
    a scratch buffer allocated here), then the dk/dv and the dq kernels. A
    CUDA tensor launches or raises; a CPU tensor takes the plain version."""
    _check(q, k, v)
    if o.shape != q.shape or do.shape != q.shape:
        raise ValueError(
            f"o {tuple(o.shape)} and do {tuple(do.shape)} must match q "
            f"{tuple(q.shape)}"
        )
    if tuple(lse.shape) != tuple(q.shape[:3]) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be [B, H, T] float32, got "
                         f"{tuple(lse.shape)} {lse.dtype}")
    scale = q.shape[-1] ** -0.5 if scale is None else float(scale)
    if _device_kind(q, "flash_backward") == "cpu":
        plain_calls["backward"] += 1
        return flash_backward_reference(q, k, v, o, lse, do, causal, scale)
    _check_kernel_shape(q, k)
    if do.dtype != q.dtype or o.dtype != q.dtype:
        raise ValueError(f"o and do must have q's dtype {q.dtype}, got "
                         f"{o.dtype}, {do.dtype}")
    b, h, t, d = q.shape
    lse = lse.contiguous()
    delta = torch.empty(b, h, t, dtype=torch.float32, device=q.device)
    dq, dk, dv = _bthd_like(q), _bthd_like(k), _bthd_like(v)
    strides = (ctypes.c_longlong * 24)(*_kernel_strides(
        (q, k, v, o, do, dq, dk, dv),
        ("q", "k", "v", "o", "do", "dq", "dk", "dv"),
    ))
    _, bwd = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = bwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                  do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                  dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), strides, b, h,
                  k.shape[1], t, d, _DTYPE_CODES[q.dtype], int(causal),
                  scale, stream)
    if err:
        raise RuntimeError(f"flash backward kernel launch failed: error {err}")
    launches["backward"] += 1
    return dq, dk, dv


# -- the differentiable function ---------------------------------------------


class _FlashMHA(torch.autograd.Function):
    """K1 forward, K2 backward; under ``names`` and ``flash`` remat the
    forward's (o, lse) are kept and K1 does not run again in the
    recompute."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        o, lse = remat.keep(lambda: flash_forward(q, k, v, causal, scale))
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale = causal, scale
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, o, lse = ctx.saved_tensors
        if do.stride(-1) != 1:  # e.g. the expanded gradient of o.sum()
            do = do.contiguous()
        dq, dk, dv = flash_backward(q, k, v, o, lse, do, ctx.causal,
                                    ctx.scale)
        return dq, dk, dv, None, None


def flash_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True, scale: float | None = None):
    """Flash attention returning (o [B, H, T, D], lse [B, H, T] f32), with
    gradients for q, k and v through K2 and none for lse."""
    _check(q, k, v)
    scale = q.shape[-1] ** -0.5 if scale is None else float(scale)
    return _FlashMHA.apply(q, k, v, bool(causal), scale)
