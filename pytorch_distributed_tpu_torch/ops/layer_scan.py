"""The layer loop with an optional prefetch window: the port of the JAX
package's ``ops/layer_scan.py``.

Both families run their blocks as one loop over the per-layer param list,
each layer's params passed first through an optional ``block_transform``
(ZeRO-3's just-in-time all-gather, ``parallel/zero.LayerGather``) inside
the layer's checkpoint. Just in time, every gather sits on the critical
path:

    gather(l) -> block(l) -> gather(l+1) -> block(l+1) -> ...

With window W = ``effective_window(prefetch_buffers, L)`` > 1 the loop
runs over L / W windows, and each window issues ALL W gathers before its
first block computes, as asynchronous collectives (``async_op=True``
work handles, ``LayerGather.issue``), and waits on each one just before
its block:

    issue(l) ; issue(l+1) ; ... ; issue(l+W-1)
    wait(l) block(l) -> wait(l+1) block(l+1) -> ...

so layer l+1's shards travel while layer l computes. The whole window
runs under one ``ops/remat.apply_remat`` checkpoint, as JAX's
``window_body`` does under ``jax.checkpoint``: a remat mode's backward
replays the window and gathers its W layers again, and autograd saves no
gathered param (only the window's input and the shards). Every layer sees
the same inputs in the same order as at W = 1 and each gather's backward
reduce-scatters the same sums, so the numbers are bit for bit those of
W = 1.

Transport: on NCCL a gather runs on the collective's stream; ``wait()``
makes the computing stream wait for it, and the output buffer stays
referenced by the in-flight handle until then. Over gloo, CUDA tensors go
through the backend's own host staging, as ``zero.GatherParams``'s do.
Without a ``block_transform`` there is nothing to prefetch, and the loop
runs one layer at a time whatever ``prefetch_buffers`` says (a window
would only make the backward replay W layers at once).
"""

from __future__ import annotations

from typing import Callable

from pytorch_distributed_tpu_torch.ops.remat import apply_remat


def effective_window(prefetch_buffers: int, n_layer: int) -> int:
    """Largest divisor of ``n_layer`` that is <= prefetch_buffers + 1
    (JAX's table): 1 (no prefetch) at worst, ``n_layer`` at most."""
    if prefetch_buffers <= 0 or n_layer <= 1:
        return 1
    want = min(prefetch_buffers + 1, n_layer)
    for w in range(want, 0, -1):
        if n_layer % w == 0:
            return w
    return 1


def scan_layers(block_fn: Callable, carry, blocks: list, extras=None, *,
                remat_mode: str, block_transform=None,
                prefetch_buffers: int = 0):
    """Run ``block_fn(carry, bp, extra) -> carry`` over every layer of the
    per-layer list ``blocks`` (``extras[l]``, e.g. the global layer id,
    None when ``extras`` is None), each layer's params through
    ``block_transform`` first. A window needs a ``block_transform`` with
    ``issue`` (``zero.LayerGather``). Returns the final carry."""
    n = len(blocks)
    if extras is None:
        extras = [None] * n
    window = (1 if block_transform is None
              else effective_window(prefetch_buffers, n))
    if window <= 1:
        def body(c, bp, extra):
            if block_transform is not None:
                bp = block_transform(bp)
            return block_fn(c, bp, extra)

        body = apply_remat(body, remat_mode)
        for bp, extra in zip(blocks, extras):
            carry = body(carry, bp, extra)
        return carry

    def window_body(c, bw, ew):
        ready = [block_transform.issue(bp) for bp in bw]  # all in flight
        for wait, extra in zip(ready, ew):
            c = block_fn(c, wait(), extra)
        return c

    window_body = apply_remat(window_body, remat_mode)
    for i in range(0, n, window):
        carry = window_body(carry, blocks[i:i + window],
                            extras[i:i + window])
    return carry
