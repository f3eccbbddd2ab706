"""Selective activation checkpointing per transformer block.

The port of the JAX package's ``ops/remat.py`` on
``torch.utils.checkpoint.checkpoint(use_reentrant=False)``:

- ``"none"``: no checkpointing; every activation autograd needs is kept.
- ``"full"``: keep only the block's input; the whole block, flash forward
  (K1) included, runs again in backward.
- ``"names"``: keep the tagged products (``SAVED_ACTIVATION_NAMES``:
  ``qkv``, ``attn_proj``, ``mlp_fc`` in GPT-2 — never ``mlp_proj``; the
  naive attention's ``attn_out``) and both outputs of the flash forward,
  and recompute the rest (layer norms, gelu, bias adds, the head split) in
  backward. With (o, lse) kept, backward never re-runs K1, as the JAX
  ``_flash_call_policy`` arranges.

How ``names`` picks out what it keeps. PyTorch has no ``checkpoint_name``.
The model wraps each tagged product in ``with checkpoint_name("qkv"):``,
which sets a module-level tag for that Python block; the product goes
through ``product(a, b)``, and the flash forward op through ``keep``.
``checkpoint`` takes a ``context_fn`` giving one context for the block's
forward and one for its recompute in backward; under ``names`` these share
one ``_Kept`` list. In the forward, ``keep`` runs its computation and
appends the result; in the recompute it returns the kept results in the
same order instead of computing them again. The recompute still builds
the same autograd nodes (``_KeptProduct`` saves its inputs in both
passes), so checkpointing finds the same saved tensors in the same order.
The tag and the active list are plain globals, not thread-locals, because
the recompute runs on the autograd engine's thread.

This takes the place of PyTorch's selective-checkpoint contexts
(``create_selective_checkpoint_contexts``), which decide per ATen op from
inside a Python dispatch mode: on an H100 that mode took 54 ms of host
time over two GPT-2 124M training steps, in a step whose pace the host
already sets (PERF.md). The blocks draw no random numbers (dropout is not
ported), so checkpointing does not save and restore RNG states.
The JAX modes ``dots``, ``dots_no_batch`` and ``flash`` are not ported yet
and raise.
"""

from __future__ import annotations

import contextlib
import functools

import torch
from torch.utils.checkpoint import checkpoint

# The JAX package's names list (gpt2 uses qkv, attn_out — on the naive path
# only —, attn_proj and mlp_fc; llama the separate projections).
SAVED_ACTIVATION_NAMES = (
    "qkv", "q", "k", "v", "attn_out", "attn_proj", "mlp_fc", "mlp_gate",
    "mlp_up",
)
_UNPORTED = ("dots", "dots_no_batch", "flash")


class _Kept:
    """What one checkpointed block call keeps under ``names``: results in
    forward order, and the recompute's read position."""

    def __init__(self):
        self.values: list = []
        self.next = 0


_tag: str | None = None
_kept: _Kept | None = None
_replaying = False


@contextlib.contextmanager
def checkpoint_name(name: str | None):
    """Tag the product computed inside this block as ``name`` (the
    counterpart of ``jax.ad_checkpoint.checkpoint_name`` on its result)."""
    global _tag
    outer, _tag = _tag, name
    try:
        yield
    finally:
        _tag = outer


@contextlib.contextmanager
def _using(kept: _Kept, replay: bool):
    global _kept, _replaying
    outer = (_kept, _replaying)
    _kept, _replaying = kept, replay
    kept.next = 0
    try:
        yield
    finally:
        _kept, _replaying = outer


def _names_contexts():
    kept = _Kept()
    return _using(kept, False), _using(kept, True)


def _detached(out):
    if isinstance(out, tuple):
        return tuple(t.detach() for t in out)
    return out.detach()


def keep(compute):
    """``compute()`` — except inside a ``names`` block's recompute, which
    gets back what the block's forward computed here (tensor or tuple of
    tensors), in call order, without computing it again."""
    if _kept is None:
        return compute()
    if _replaying:
        out = _kept.values[_kept.next]
        _kept.next += 1
        return _detached(out)
    out = compute()
    _kept.values.append(_detached(out))
    return out


class _KeptProduct(torch.autograd.Function):
    """a @ b whose result ``keep`` holds; saves a and b in both passes."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return keep(lambda: a @ b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ga = g @ b.transpose(-1, -2)
        if b.dim() == 2:  # a [..., K] @ b [K, N]: sum over a's leading dims
            gb = a.reshape(-1, a.shape[-1]).t() @ g.reshape(-1, g.shape[-1])
        else:
            gb = a.transpose(-1, -2) @ g
        return ga, gb


def product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b``, kept by a ``names`` block when computed under one of
    ``SAVED_ACTIVATION_NAMES``."""
    if _kept is None or _tag not in SAVED_ACTIVATION_NAMES:
        return a @ b
    return _KeptProduct.apply(a, b)


def apply_remat(fn, mode: str):
    """Wrap ``fn`` (a block: tensors in, tensor out) per ``mode``: "none",
    "full" or "names"."""
    if mode == "none":
        return fn
    if mode in _UNPORTED:
        raise NotImplementedError(
            f"remat mode {mode!r} is not ported yet (ported: none, full, "
            f"names)"
        )
    if mode == "full":
        kw = {}
    elif mode == "names":
        kw = {"context_fn": _names_contexts}
    else:
        raise KeyError(
            f"unknown remat mode {mode!r}; known: none, full, names, "
            f"{', '.join(_UNPORTED)}"
        )

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False, **kw, **kwargs)

    return wrapped
