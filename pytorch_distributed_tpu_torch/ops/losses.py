"""Loss functions: the port of the JAX package's ``ops/losses.py``.

``cross_entropy_loss`` is the mean token cross-entropy in float32:
logsumexp of the logits minus the gold logit, averaged over every
position. The fused head + cross-entropy (``linear_cross_entropy``,
``ModelConfig.fused_head_ce``) is not ported yet.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def cross_entropy_loss(logits: torch.Tensor,
                       targets: torch.Tensor) -> torch.Tensor:
    """Mean token cross-entropy. logits [..., V] float; targets [...] int.
    ``F.cross_entropy`` on the f32 logits computes exactly that mean of
    logsumexp - gold."""
    v = logits.shape[-1]
    return F.cross_entropy(logits.float().reshape(-1, v),
                           targets.reshape(-1).long())
