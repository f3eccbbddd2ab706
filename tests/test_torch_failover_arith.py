"""Why a failed-over row's bf16 tokens can part from the undisturbed
run's: the two attention arithmetics of the JAX package itself.

A decode tick's single-token paged attention goes through the Pallas
kernel on the accelerator (``paged_attention="auto"`` picks it there),
which keeps the softmax weights ``p`` in f32
(``pytorch_distributed_tpu/ops/paged_kernel.py:95-103``); a resumed
row's re-prefill goes through the gather path, which rounds them to the
cache dtype (``models/decode.py:201``, ``.astype(cv.dtype)``). On the
same bf16 pages, on the CPU (the kernel in interpret mode):

- the kernel's output is the gather math with f32 weights, rounded once
  to bf16: within one bf16 rounding (unit roundoff 2^-8, half an ulp) of
  it, plus f32 summation order;
- the gather path's output differs from the kernel's — not by zero, and
  by at most one bf16 unit roundoff (2^-8) of the values it averages
  (``max |v|``) plus the output's own rounding.

So the JAX package's bit-identical failover holds only where both paths
are the gather path (its CPU); the port's card runs K3 in the tick and
the gather path in the re-prefill, and shares the behaviour.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from pytorch_distributed_tpu.models.decode import _cached_attention
from pytorch_distributed_tpu.ops.paged_kernel import paged_decode_attention

U = 2.0**-8  # bf16 unit roundoff (8 significant bits)


def _case(h, hkv, seed, b=4, d=64, page=16, n_pages=8):
    rng = np.random.default_rng(seed)
    n_pool = b * n_pages + 1
    k = jnp.asarray(rng.standard_normal((n_pool, page, hkv, d)),
                    jnp.bfloat16)
    v = jnp.asarray(rng.standard_normal((n_pool, page, hkv, d)),
                    jnp.bfloat16)
    q = jnp.asarray(rng.standard_normal((b, h, d)), jnp.bfloat16)
    tables = jnp.asarray(np.arange(1, n_pool).reshape(b, n_pages), jnp.int32)
    lengths = jnp.asarray([0, page - 1, 77, n_pages * page - 1], jnp.int32)
    return q, k, v, tables, lengths


def _f32_weights(q, k, v, tables, lengths):
    """The gather math with the softmax weights kept in f32, in f64 numpy
    over the exact bf16 values (the reference both paths are measured
    against)."""
    b, h, d = q.shape
    ck = np.asarray(k, np.float64)[np.asarray(tables)].reshape(
        b, -1, k.shape[2], d)
    cv = np.asarray(v, np.float64)[np.asarray(tables)].reshape(
        b, -1, v.shape[2], d)
    rep = h // k.shape[2]
    ck, cv = np.repeat(ck, rep, axis=2), np.repeat(cv, rep, axis=2)
    s = np.einsum("bhd,bshd->bhs", np.asarray(q, np.float64), ck) / d**0.5
    valid = np.arange(ck.shape[1])[None, None] <= np.asarray(lengths)[
        :, None, None]
    s = np.where(valid, s, -np.inf)
    w = np.exp(s - s.max(-1, keepdims=True))
    w /= w.sum(-1, keepdims=True)
    return np.einsum("bhs,bshd->bhd", w, cv), float(np.abs(cv).max())


@pytest.mark.parametrize("h, hkv", [(12, 12), (32, 8)],
                         ids=["gpt2-heads", "gqa-4"])
@pytest.mark.parametrize("seed", [0, 1])
def test_kernel_keeps_f32_weights_and_the_gather_path_rounds_them(
        h, hkv, seed):
    q, k, v, tables, lengths = _case(h, hkv, seed)
    kernel = np.asarray(paged_decode_attention(
        q, k, v, tables, lengths, interpret=True), np.float64)
    gather = np.asarray(_cached_attention(
        q[:, None], {"k": k, "v": v}, lengths, tables, "gather")[:, 0],
        np.float64)
    ref, vmax = _f32_weights(q, k, v, tables, lengths)

    # The kernel: the f32-weights math, rounded once to bf16 — a bound
    # the gather path's output does not keep.
    once = U * np.abs(ref) + 2.0**-20 * vmax
    np.testing.assert_array_less(np.abs(kernel - ref), once)
    assert (np.abs(gather - ref) > once).any()
    # The gather path: its weights rounded to bf16 move the average by at
    # most u max|v|, then its own output rounding.
    bound = U * (1 + U) * vmax + U * np.abs(ref) + 2.0**-20 * vmax
    np.testing.assert_array_less(np.abs(gather - ref), bound)
    # ... and the two differ: not zero, within the same bound.
    diff = np.abs(kernel - gather)
    assert diff.max() > 0 and (diff > 0).mean() > 0.05
    np.testing.assert_array_less(diff, bound + U * np.abs(ref))
