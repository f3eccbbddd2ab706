"""The multi-tenant LoRA delta: its plain version (the JAX package's
lowering) and the CUDA kernel (``csrc/lora_delta.cu``).

``lora_delta_add(y, x, lp, rows)`` returns ``y + delta`` for a projection
output ``y`` [B, T, *out] and its input ``x`` [B, T, Din], where row b's
delta is ``(x[b] @ a[rows[b]]) @ b[rows[b]]`` in f32, cast to y's dtype
before the add (``serving/adapters``; slot 0 is the exact-zero adapter, so
a slot-0 row equals ``y`` bit for bit).

- On CPU tensors it runs the plain version, ``lora_delta_reference``: the
  JAX package's lowering (``models/decode.py`` ``lora_delta``) — two plain
  2-D products against every slot, the batch flattened into M and the
  slot axis into N, with an exact ``torch.gather`` of each row's slot after
  each — and returns a new tensor.
- On CUDA tensors it launches the kernel, which adds into ``y`` IN PLACE
  (``y`` may be a strided view, e.g. the query third of a fused QKV
  output) and returns ``y``; unsupported inputs raise. Each row's sums run
  in a fixed order whatever its neighbours, so a row's bits depend on its
  own input and slot alone; they differ from the plain version's only in
  summation order.

``launches`` counts kernel launches (under a lock: engines stepped on
several threads launch at once).
"""

from __future__ import annotations

import ctypes
import threading

import torch

launches = 0
_count_lock = threading.Lock()
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_RANKS = (1, 2, 4, 8, 16, 32, 64)


def _flat(lp) -> tuple[torch.Tensor, torch.Tensor]:
    """(a_flat [Din, S*r], b_flat [r, S*out]) of one layer's adapter
    slice: the registry's laid-out forms when present, else from ``a``
    [S, Din, r] and ``b`` [S, r, *out]."""
    a, b = lp["a"], lp["b"]
    s_n, r = a.shape[0], a.shape[-1]
    a_flat = lp.get("a_flat")
    if a_flat is None:
        a_flat = a.permute(1, 0, 2).reshape(a.shape[1], s_n * r)
    b_flat = lp.get("b_flat")
    if b_flat is None:
        b_flat = b.reshape(s_n, r, -1).permute(1, 0, 2).reshape(r, -1)
    return a_flat, b_flat


def lora_delta_reference(x, lp, rows):
    """The plain version: the delta [B, T, *out] in f32 for ``x`` [B, T,
    Din] and ``rows`` the [B*T] slot of each flattened row."""
    a_flat, b_flat = _flat(lp)
    s_n, r = lp["a"].shape[0], lp["a"].shape[-1]
    bsz, t = x.shape[:2]
    n = bsz * t
    idx = rows.long()[:, None, None]
    xf = x.reshape(n, -1).to(a_flat.dtype)
    h = torch.gather((xf @ a_flat).view(n, s_n, r), 1,
                     idx.expand(n, 1, r))  # [B*T, 1, r]
    d_all = (h.view(n, r) @ b_flat).view(n, s_n, -1)
    d = torch.gather(d_all, 1, idx.expand(n, 1, d_all.shape[-1]))
    return d.view(bsz, t, *lp["b"].shape[2:])


_fn = None


def _kernel():
    """The built kernel's C entry point, its signature declared once (the
    pointers and the stream as c_void_p, or ctypes would cut them to 32
    bits)."""
    global _fn
    if _fn is None:
        from pytorch_distributed_tpu_torch.ops import _build

        fn = _build.load("lora_delta").pdt_lora_delta_add
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int64] + [ctypes.c_int] * 6 + [
                           ctypes.c_void_p]
        _fn = fn
    return _fn


def _row_stride(t: torch.Tensor, inner: int) -> int | None:
    """The element stride between the flattened rows of ``t`` [B, T,
    *inner dims] when its inner ``inner`` elements are contiguous and its
    B*T rows evenly spaced, else None."""
    if t.is_contiguous():
        return inner
    b, n_t = t.shape[:2]
    expect = 1
    for size, stride in zip(reversed(t.shape[2:]), reversed(t.stride()[2:])):
        if size != 1 and stride != expect:
            return None
        expect *= size
    if n_t == 1:
        return t.stride(0) if b > 1 else inner
    if b > 1 and t.stride(0) != n_t * t.stride(1):
        return None
    return t.stride(1)


def factor_args(a_flat, b_flat) -> tuple:
    """(a_flat pointer, b_flat pointer, din, rank, slots, out) of one
    layer's laid-out factors (``_flat``), checked for the kernel. The
    adapter registry computes it once per uploaded layer
    (``AdapterRegistry.device_tree``'s ``"kernel_args"``): every adapted
    projection of every forward passes the same factors, and their checks
    cost host time the kernel exists to save."""
    din, r = a_flat.shape[0], b_flat.shape[0]
    s_n = a_flat.shape[1] // r
    if not (a_flat.is_contiguous() and b_flat.is_contiguous()
            and a_flat.dtype == b_flat.dtype == torch.float32):
        raise ValueError("the kernel takes contiguous f32 factors")
    return (a_flat.data_ptr(), b_flat.data_ptr(), din, r, s_n,
            b_flat.shape[1] // s_n)


def lora_delta_add(y, x, lp, rows):
    """``y + delta`` (module docstring); ``lp`` is one target of one layer
    of ``AdapterRegistry.device_tree`` and ``rows`` the [B*T] adapter slot
    of each flattened row. The CUDA path is what every adapted projection
    of every forward pays on the host, so it checks per call only what the
    kernel could not survive (the factors were checked once, by
    ``factor_args``)."""
    if y.device.type != "cuda":
        if y.device.type != "cpu":
            raise ValueError(
                f"lora_delta_add runs on cuda (kernel) or cpu (plain "
                f"version), got device {y.device}"
            )
        return y + lora_delta_reference(x, lp, rows).to(y.dtype)
    a_ptr, b_ptr, din, r, s_n, out = lp["kernel_args"]
    if r not in _RANKS:
        raise ValueError(f"the kernel takes rank in {_RANKS}, got {r}")
    code = _DTYPE_CODES.get(y.dtype)
    n = rows.shape[0]
    if (code is None or x.dtype != y.dtype or x.shape[-1] != din
            or y.numel() != n * out or x.numel() != n * din):
        raise ValueError(
            f"the kernel takes x [.., {din}] and y of {out} per row in one "
            f"dtype of {sorted(map(str, _DTYPE_CODES))} over {n} rows, got "
            f"x {tuple(x.shape)} {x.dtype}, y {tuple(y.shape)} {y.dtype}"
        )
    x_stride = din if x.is_contiguous() else _row_stride(x, din)
    if x_stride is None:
        x = x.contiguous()
        x_stride = din
    y_stride = out if y.is_contiguous() else _row_stride(y, out)
    if y_stride is None:
        raise ValueError("y's rows must be evenly spaced with contiguous "
                         "elements (the kernel adds into it in place)")
    if rows.dtype != torch.int64:
        rows = rows.long()
    idx = y.device.index
    cur = torch.cuda.current_device()
    args = (x.data_ptr(), x_stride, rows.data_ptr(), a_ptr, b_ptr,
            y.data_ptr(), y_stride, n, din, r, s_n, out, code)
    if idx is None or idx == cur:
        err = _kernel()(*args, torch._C._cuda_getCurrentRawStream(cur))
    else:
        with torch.cuda.device(idx):
            err = _kernel()(*args, torch._C._cuda_getCurrentRawStream(idx))
    if err:
        raise RuntimeError(f"LoRA delta kernel launch failed: cudaError "
                           f"{err}")
    global launches
    with _count_lock:
        launches += 1
    return y
