"""Memory accounting: analytic breakdown, measured device stats, snapshot.

The port of the JAX package's ``profiling/memory.py`` (reference
assignment0/memory_analysis.py):

- ``analytic_memory_breakdown`` — params, grads, Adam moments and an
  activation estimate that knows the remat modes; the JAX package's dict,
  key for key. The parameter count is the port's own parameters, counted
  from an init under ``FakeTensorMode`` (shapes only, nothing allocated).
- ``measured_memory`` — the CUDA caching allocator's live and peak bytes
  (``memory_allocated``, ``max_memory_allocated``), the card's total
  memory as the limit, and ``memory_stats()`` as ``raw``; zeros on the
  CPU, as in the JAX package.
- ``start_memory_history`` / ``save_memory_snapshot`` — the allocator's
  history pickle (``torch.cuda.memory._record_memory_history`` /
  ``_dump_snapshot``), the reference's own pytorch.org/memory_viz format.
  Recording starts at ``start_memory_history``, so call it before the
  allocations the snapshot should show; it costs host time on every
  allocation while on. On the CPU torch keeps no allocator history, and
  ``save_memory_snapshot`` returns None (the JAX package writes a pprof
  file there).

The JAX package's ``compiled_memory_analysis`` reads XLA's buffer
assignment of a compiled program; eager PyTorch compiles no program, and
it is left out.
"""

from __future__ import annotations

from pathlib import Path

import torch

from pytorch_distributed_tpu_torch.config import ModelConfig


def _model_param_count(cfg: ModelConfig) -> int:
    from torch._subclasses.fake_tensor import FakeTensorMode

    from pytorch_distributed_tpu_torch.models import get_model
    from pytorch_distributed_tpu_torch.utils import tree

    with FakeTensorMode():
        params = get_model(cfg).init(torch.Generator(), cfg, device="cpu")
        return int(sum(p.numel() for p in tree.leaves(params)))


def activation_bytes_estimate(
    cfg: ModelConfig, batch_size: int, seq_len: int
) -> int:
    """Rough per-step live-activation bytes under our remat policy.

    With per-block remat saving dot outputs ("dots"), the dominant saved
    tensors per layer are the block I/O plus matmul outputs
    (qkv 3E, attn-out E, c_fc F, c_proj E per token); without remat, add the
    attention score matrices (H*T^2) and softmax outputs.
    """
    act_itemsize = 2 if cfg.dtype == "bfloat16" else 4
    b, t, e, f, h, l = (
        batch_size, seq_len, cfg.n_embd, cfg.inner_dim, cfg.n_head,
        cfg.n_layer,
    )
    per_layer_tokens = b * t * (e + 3 * e + e + f + e)  # x, qkv, attn, fc, proj
    if cfg.remat == "none":
        per_layer_tokens += b * t * (2 * e)  # ln outputs
        score_bytes = l * b * h * t * t * 4 * 2  # scores+softmax in f32
    elif cfg.remat == "full":
        per_layer_tokens = b * t * e  # only block inputs saved
        score_bytes = 0
    elif cfg.remat == "flash":
        # Only the flash kernel's (o, l, m) per layer — the long-context
        # policy; the o save is E per token, l/m are f32 [B, H, T].
        per_layer_tokens = b * t * (e + e)  # block input + o
        score_bytes = l * b * h * t * 4 * 2  # l and m, f32
    else:  # dots / dots_no_batch / names
        score_bytes = 0
    logits_bytes = (
        0 if cfg.fused_head_ce else b * t * cfg.vocab_size * 4
    )
    return l * per_layer_tokens * act_itemsize + score_bytes + logits_bytes


def analytic_memory_breakdown(
    cfg: ModelConfig,
    *,
    batch_size: int = 8,
    seq_len: int = 1024,
    optimizer: str = "adamw",
) -> dict:
    """Estimated training-memory breakdown in bytes
    (reference memory_analysis.py:12-52, defaults :136-138: gpt2-small,
    B=8, T=1024)."""
    n = _model_param_count(cfg)
    param_itemsize = 2 if cfg.param_dtype == "bfloat16" else 4
    params_b = n * param_itemsize
    grads_b = n * 4  # grads accumulate in f32
    opt_mult = {"adamw": 2, "adam": 2, "sgd": 0, "momentum": 1}[optimizer]
    opt_b = opt_mult * n * 4
    act_b = activation_bytes_estimate(cfg, batch_size, seq_len)
    total = params_b + grads_b + opt_b + act_b
    return {
        "param_count": n,
        "params_bytes": params_b,
        "grads_bytes": grads_b,
        "optimizer_bytes": opt_b,
        "activations_bytes_estimate": act_b,
        "total_bytes_estimate": total,
        "total_gib_estimate": total / 2**30,
        "config": {
            "batch_size": batch_size,
            "seq_len": seq_len,
            "remat": cfg.remat,
            "dtype": cfg.dtype,
            "param_dtype": cfg.param_dtype,
        },
    }


def _cuda(device) -> torch.device | None:
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        return None
    return dev


def measured_memory(device=None) -> dict:
    """Live/peak device memory (reference :105-110's
    memory_allocated/memory_reserved analogue) of ``device`` (None: the
    current CUDA device). Zeros where there is no CUDA device (the
    CPU)."""
    dev = _cuda(device)
    if dev is None:
        return {"bytes_in_use": 0, "peak_bytes_in_use": 0,
                "bytes_limit": 0, "raw": {}}
    return {
        "bytes_in_use": torch.cuda.memory_allocated(dev),
        "peak_bytes_in_use": torch.cuda.max_memory_allocated(dev),
        "bytes_limit": torch.cuda.get_device_properties(dev).total_memory,
        "raw": dict(torch.cuda.memory_stats(dev)),
    }


def start_memory_history(max_entries: int = 100_000) -> bool:
    """Start recording the CUDA allocator's history (each allocation with
    its stack), for ``save_memory_snapshot``. False (nothing recorded)
    without a CUDA device."""
    if _cuda(None) is None:
        return False
    torch.cuda.memory._record_memory_history(max_entries=max_entries)
    return True


def stop_memory_history() -> None:
    if _cuda(None) is not None:
        torch.cuda.memory._record_memory_history(enabled=None)


def save_memory_snapshot(path: str | Path) -> str | None:
    """Dump the allocator's state and recorded history as a pickle (open
    it at pytorch.org/memory_viz; the reference's :112-117). Returns None
    (no file) without a CUDA device."""
    if _cuda(None) is None:
        return None
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.cuda.memory._dump_snapshot(str(path))
    return str(path)


def compare_estimate_vs_measured(
    cfg: ModelConfig, *, batch_size: int = 8, seq_len: int = 1024
) -> dict:
    """Side-by-side analytic estimate vs measured peak
    (reference :152-163)."""
    est = analytic_memory_breakdown(
        cfg, batch_size=batch_size, seq_len=seq_len
    )
    meas = measured_memory()
    est_total = est["total_bytes_estimate"]
    peak = meas["peak_bytes_in_use"]
    return {
        "estimated": est,
        "measured": meas,
        "ratio_measured_over_estimated": (peak / est_total) if est_total else None,
    }
