"""Rotary position embeddings (llama family).

The port of the JAX package's ``ops/rope.py``. Half-split convention (as
HF Llama): the head dim splits into two halves, rotate_half([x1, x2]) =
[-x2, x1], and x_rot = x cos + rotate_half(x) sin with angles
pos / theta^(2i/d). Angles and the rotation are computed in float32.
"""

from __future__ import annotations

import torch


def rope_angles(seq_len: int, head_dim: int, theta: float, *, offset=0,
                device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin), each [seq_len, head_dim] float32. ``offset`` is an int
    or a [B, 1] per-row tensor (slot-batched decode, every row at its own
    position): the angles are then [B, seq_len, head_dim], row b equal to
    the int-offset result for offset[b]. ``device`` defaults to the
    offset tensor's."""
    if device is None:
        device = offset.device if torch.is_tensor(offset) else "cpu"
    half = head_dim // 2
    exponent = torch.arange(0, half, dtype=torch.float32,
                            device=device) * 2.0 / head_dim
    # theta stays a Python scalar: a tensor made from it on the card would
    # be a host copy (and a sync) per call.
    inv_freq = 1.0 / torch.pow(theta, exponent)
    pos = torch.arange(seq_len, dtype=torch.float32, device=device)
    if torch.is_tensor(offset):
        pos = pos + offset.float()  # [B, T]
    else:
        pos = pos + offset
    angles = pos[..., None] * inv_freq  # [..., T, half]
    angles = torch.cat([angles, angles], dim=-1)  # [..., T, D]
    return torch.cos(angles), torch.sin(angles)


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """Rotate x [B, T, H, D] by (cos, sin), [T, D] shared or [B, T, D] per
    row; computed in f32, returned in x's dtype."""
    x32 = x.float()
    if cos.dim() == 3:  # per-row positions
        c, s = cos[:, :, None, :], sin[:, :, None, :]
    else:
        c, s = cos[None, :, None, :], sin[None, :, None, :]
    return (x32 * c + _rotate_half(x32) * s).to(x.dtype)
