"""Selective activation checkpointing per transformer block.

The port of the JAX package's ``ops/remat.py`` on
``torch.utils.checkpoint.checkpoint(use_reentrant=False)``. Each mode keeps
what the JAX policy of that name saves for one block, found with
``jax.ad_checkpoint`` on the JAX block (``tests/test_torch_remat_modes.py``
holds the two to the same set), and recomputes the rest in backward:

- ``"none"``: no checkpointing; every activation autograd needs is kept.
- ``"full"``: keep only the block's input; the whole block, flash forward
  (K1) included, runs again in backward.
- ``"names"``: keep the tagged products (``SAVED_ACTIVATION_NAMES``:
  ``qkv``, ``attn_proj``, ``mlp_fc`` in GPT-2 — never ``mlp_proj``; the
  naive attention's ``attn_out``) and both outputs of the flash forward.
  With (o, lse) kept, backward never re-runs K1, as the JAX
  ``_flash_call_policy`` arranges.
- ``"dots"`` (``checkpoint_dots``): keep every product — the projections
  and, on the naive path, the f32 score product and the weights-times-
  values product — but not the flash op, which is no dot to JAX: backward
  re-runs K1.
- ``"dots_no_batch"`` (``checkpoint_dots_with_no_batch_dims``): keep the
  products with no batch dimension in ``dot_general``'s sense — the dense
  projections; the attention products batch over (b, h).
- ``"flash"``: keep only the flash op's (o, lse); with naive attention,
  nothing.

No mode keeps ``mlp_proj``: its value feeds only the dropout and the
residual add, whose backward needs no value, so JAX's partial evaluation
never saves it, whatever the policy.

Under tensor parallelism a row-parallel projection's all-reduce belongs
to its product (``product(..., group=)``): a kept ``attn_proj`` is the
summed value, so ``names`` keeps one all-reduce per row-parallel
projection in the forward and none in the recompute.

Under a sequence axis every mode keeps what it keeps without one: the
tagged projections; ``dots`` the ring's block products (untagged,
batched, as JAX's ``checkpoint_dots`` saves the ring's einsums); and
under Ulysses the flash op's (o, lse) (``names``, ``flash``). The
sequence attention's output is not tagged ``attn_out`` (JAX tags it):
its backward needs the exchanged blocks, which only a recompute of the
exchanges rebuilds, so a kept copy would save nothing. A recompute of a
ring or Ulysses block issues its exchanges again, as JAX's remat does
(``ops/ring_attention.exchanges``, ``ops/ulysses.all_to_alls`` count
them: under ``names`` one exchange a layer at seq 2 in each of the
forward, the recompute and the backward; four all-to-alls in each).

How a mode picks out what it keeps. PyTorch has no ``checkpoint_name``.
The model wraps each tagged product in ``with checkpoint_name("qkv"):``,
which sets a module-level tag for that Python block; the product goes
through ``product(a, b)``, and the flash forward op through ``keep``.
``checkpoint`` takes a ``context_fn`` giving one context for the block's
forward and one for its recompute in backward; under every mode but
``none`` and ``full`` these share one ``_Kept`` list. In the forward,
``keep`` runs its computation and, where the mode keeps it, appends the
result; in the recompute it returns the kept results in the same order
instead of computing them again. The recompute still builds the same
autograd nodes (``_KeptProduct`` saves its inputs in both passes), so
checkpointing finds the same saved tensors in the same order. The tag and
the active list are plain globals, not thread-locals, because the
recompute runs on the autograd engine's thread.

This takes the place of PyTorch's selective-checkpoint contexts
(``create_selective_checkpoint_contexts``), which decide per ATen op from
inside a Python dispatch mode: on an H100 that mode took 54 ms of host
time over two GPT-2 124M training steps, in a step whose pace the host
already sets (PERF.md). Dropout masks are drawn from stream ids
(``utils/prng``), a pure function of the id, so the recompute draws the
same masks and checkpointing neither saves nor restores RNG states.
"""

from __future__ import annotations

import contextlib
import functools

import torch
from torch.utils.checkpoint import checkpoint

from pytorch_distributed_tpu_torch.ops.tp import tp_reduce

# The JAX package's names list (gpt2 uses qkv, attn_out — on the naive path
# only —, attn_proj and mlp_fc; llama the separate projections).
SAVED_ACTIVATION_NAMES = (
    "qkv", "q", "k", "v", "attn_out", "attn_proj", "mlp_fc", "mlp_gate",
    "mlp_up",
)
MODES = ("none", "full", "dots", "dots_no_batch", "names", "flash")
# Products whose value no backward needs: no mode keeps them (see above).
_NEVER_KEPT = ("mlp_proj",)


def _keeps(mode: str, name: str | None, batched: bool | None) -> bool:
    """Whether ``mode`` keeps a value: the flash op's (``name`` "flash",
    ``batched`` None) or a product tagged ``name`` (None: untagged) that
    has batch dimensions or not."""
    if name == "flash":
        return mode in ("names", "flash")
    if mode == "names":
        return name in SAVED_ACTIVATION_NAMES
    if name in _NEVER_KEPT:
        return False
    return mode == "dots" or (mode == "dots_no_batch" and not batched)


class _Kept:
    """What one checkpointed block call keeps: results in forward order,
    their tags (``labels``: the product's tag or "flash"), and the
    recompute's read position."""

    def __init__(self):
        self.mode = "names"
        self.values: list = []
        self.labels: list = []
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


def _kept_contexts(mode: str):
    kept = _Kept()
    kept.mode = mode
    return _using(kept, False), _using(kept, True)


def _detached(out):
    if isinstance(out, tuple):
        return tuple(t.detach() for t in out)
    return out.detach()


def keep(compute, name: str = "flash", batched: bool | None = None):
    """``compute()`` — except inside the recompute of a block whose mode
    keeps this value (``_keeps``), which gets back what the block's
    forward computed here (tensor or tuple of tensors), in call order,
    without computing it again."""
    if _kept is None or not _keeps(_kept.mode, name, batched):
        return compute()
    if _replaying:
        out = _kept.values[_kept.next]
        _kept.next += 1
        return _detached(out)
    out = compute()
    _kept.values.append(_detached(out))
    _kept.labels.append(name)
    return out


class _KeptProduct(torch.autograd.Function):
    """a @ b (summed over ``group`` when given: ``ops/tp.tp_reduce``, whose
    backward is the identity) whose result ``keep`` holds; saves a and b
    in both passes."""

    @staticmethod
    def forward(ctx, a, b, name, group):
        ctx.save_for_backward(a, b)
        return keep(lambda: tp_reduce(a @ b, group), name, b.dim() > 2)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ga = g @ b.transpose(-1, -2)
        if b.dim() == 2:  # a [..., K] @ b [K, N]: sum over a's leading dims
            gb = a.reshape(-1, a.shape[-1]).t() @ g.reshape(-1, g.shape[-1])
        else:
            gb = a.transpose(-1, -2) @ g
        return ga, gb, None, None


def product(a: torch.Tensor, b: torch.Tensor, group=None) -> torch.Tensor:
    """``a @ b`` (b [K, N]: no batch dimension; b [..., K, N] batched),
    kept by a checkpointed block whose mode keeps a product of this tag
    (the enclosing ``checkpoint_name``) and kind.

    ``group``: the tensor group a row-parallel product is summed over
    (``ops/tp.tp_reduce``, one all-reduce). The product and its sum are
    one kept value, so a recompute that replays it issues no second
    all-reduce, as JAX's saved ``attn_proj`` (the psum's output) issues
    none. A product no mode keeps (``mlp_proj``) skips its all-reduce in
    the recompute of a block: its value is read by no backward (the reason
    no mode keeps it), so the recompute's partial sum goes unread. In
    ``full`` mode (no kept values) a recompute runs the block's
    collectives again, as JAX's full remat does."""
    if _kept is None or not _keeps(_kept.mode, _tag, b.dim() > 2):
        if group is not None and _replaying and _tag in _NEVER_KEPT:
            return a @ b
        return tp_reduce(a @ b, group)
    return _KeptProduct.apply(a, b, _tag, group)


def apply_remat(fn, mode: str):
    """Wrap ``fn`` (a block: tensors in, tensor out) per ``mode``, one of
    ``MODES``."""
    if mode == "none":
        return fn
    if mode not in MODES:
        raise KeyError(
            f"unknown remat mode {mode!r}; known: {', '.join(MODES)}"
        )
    kw = ({} if mode == "full"
          else {"context_fn": functools.partial(_kept_contexts, mode)})

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False, **kw, **kwargs)

    return wrapped
