"""Loss functions: the port of the JAX package's ``ops/losses.py``.

``cross_entropy_loss`` is the mean token cross-entropy in float32:
logsumexp of the logits minus the gold logit, averaged over every
position.

``linear_cross_entropy`` fuses the LM-head product into that loss
(``ModelConfig.fused_head_ce``): the logits are made and consumed one
vocab block at a time, so the [N, V] logits tensor never exists — neither
in the forward (an online logsumexp) nor in the backward (each block's
softmax-minus-onehot feeds the dx and dW products directly). It costs one
more head product per block in the backward. Like the JAX op it rounds
each block's logits to ``logits_dtype`` (default: x's dtype), so the fused
loss reproduces the unfused head's ``cfg.logits_dtype`` numerics, and runs
its reductions in f32; the last block is padded with zero rows and its
padding columns masked to ``NEG_INF``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

NEG_INF = -1e30


def cross_entropy_loss(logits: torch.Tensor,
                       targets: torch.Tensor) -> torch.Tensor:
    """Mean token cross-entropy. logits [..., V] float; targets [...] int.
    ``F.cross_entropy`` on the f32 logits computes exactly that mean of
    logsumexp - gold."""
    v = logits.shape[-1]
    return F.cross_entropy(logits.float().reshape(-1, v),
                           targets.reshape(-1).long())


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b accumulated and returned in f32 (JAX's
    ``preferred_element_type=float32``): bf16 operands stay bf16 on the
    card's tensor cores; on the CPU their exact f32 values are
    multiplied."""
    if a.dtype == torch.float32:
        return a @ b
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


def _w_block(wc: torch.Tensor, ib: int, block_v: int,
             w_layout: str) -> torch.Tensor:
    """Vocab block ``ib`` of the head weight as [block_v, E]; the last one
    padded with zero rows past V."""
    w = wc if w_layout == "ve" else wc.t()
    blk = w[ib * block_v:(ib + 1) * block_v]
    if blk.shape[0] < block_v:
        blk = F.pad(blk, (0, 0, 0, block_v - blk.shape[0]))
    return blk


def _block_logits(x, wblk, ib, block_v, v, ldt):
    """One vocab block of logits [N, block_v] in f32, rounded to ``ldt``
    first; in the last block the padding columns are masked to
    ``NEG_INF``."""
    if ldt == x.dtype:
        logits = (x @ wblk.t()).float()
    else:
        logits = _mm_f32(x, wblk.t()).to(ldt).float()
    if (ib + 1) * block_v > v:
        col = ib * block_v + torch.arange(block_v, device=x.device)
        logits = torch.where(col < v, logits, NEG_INF)
    return logits


def _in_block(tgt, ib, block_v):
    """Each row's target as a column of block ``ib`` (clamped into it), and
    whether it lies there."""
    local = tgt - ib * block_v
    hit = (local >= 0) & (local < block_v)
    return local.clamp(0, block_v - 1)[:, None], hit


class _LinearCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, targets, block_v, w_layout, ldt):
        n = x.shape[0]
        ldt = ldt or x.dtype
        wc = w.to(x.dtype)
        v = wc.shape[0] if w_layout == "ve" else wc.shape[1]
        m = torch.full((n,), NEG_INF, dtype=torch.float32, device=x.device)
        l = torch.zeros(n, dtype=torch.float32, device=x.device)
        gold = torch.zeros(n, dtype=torch.float32, device=x.device)
        tgt = targets.long()
        for ib in range(-(-v // block_v)):
            logits = _block_logits(
                x, _w_block(wc, ib, block_v, w_layout), ib, block_v, v, ldt)
            m_new = torch.maximum(m, logits.amax(1))
            l = l * torch.exp(m - m_new) + torch.exp(
                logits - m_new[:, None]).sum(1)
            local, hit = _in_block(tgt, ib, block_v)
            gold = gold + torch.where(hit, logits.gather(1, local)[:, 0], 0.0)
            m = m_new
            del logits
        logz = m + torch.log(l)
        ctx.save_for_backward(x, wc, tgt, logz)
        ctx.block_v, ctx.w_layout, ctx.ldt = block_v, w_layout, ldt
        ctx.w_dtype, ctx.v = w.dtype, v
        return (logz - gold).mean()

    @staticmethod
    def backward(ctx, ct):
        x, wc, tgt, logz = ctx.saved_tensors
        block_v, w_layout, v = ctx.block_v, ctx.w_layout, ctx.v
        scale = ct / x.shape[0]
        dx = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
        dw = torch.empty((v, x.shape[1]), dtype=torch.float32,
                         device=x.device)  # [V, E], transposed for "ev"
        for ib in range(-(-v // block_v)):
            wblk = _w_block(wc, ib, block_v, w_layout)
            logits = _block_logits(x, wblk, ib, block_v, v, ctx.ldt)
            p = torch.exp(logits - logz[:, None])  # padding columns: 0
            del logits
            local, hit = _in_block(tgt, ib, block_v)
            p.scatter_add_(1, local, -hit.float()[:, None])  # - onehot
            dl = p.mul_(scale).to(x.dtype)  # [N, block_v]
            del p
            dx += _mm_f32(dl, wblk)
            stop = min((ib + 1) * block_v, v) - ib * block_v
            dw[ib * block_v:ib * block_v + stop] = _mm_f32(dl.t(), x)[:stop]
        dw = dw.to(ctx.w_dtype)
        if w_layout == "ev":
            dw = dw.t().contiguous()
        return dx.to(x.dtype), dw, None, None, None, None


def linear_cross_entropy(x: torch.Tensor, w: torch.Tensor,
                         targets: torch.Tensor, block_v: int = 8192,
                         w_layout: str = "ve",
                         logits_dtype=None) -> torch.Tensor:
    """Mean cross-entropy of softmax(x @ head) without the [N, V] logits.
    x [N, E] (the final-norm hidden states), w the head weight: [V, E]
    (``"ve"``, gpt2's tied wte) or [E, V] (``"ev"``, llama's lm_head),
    targets [N] int. Gradients reach x (in x's dtype) and w (in w's
    dtype)."""
    if w_layout not in ("ve", "ev"):
        raise ValueError(f"w_layout must be 've' or 'ev', got {w_layout!r}")
    ldt = (getattr(torch, logits_dtype) if isinstance(logits_dtype, str)
           else logits_dtype)
    return _LinearCE.apply(x, w, targets, block_v, w_layout, ldt)
