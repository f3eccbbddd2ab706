"""The port's fused head + cross-entropy against the JAX package's, on the
CPU.

``linear_cross_entropy`` (x [N, E], the head weight, targets [N]) at N 40,
E 32, vocab 301 in blocks of 128 (the last block padded and masked), both
weight layouts, x in f32 and bf16, logits rounded to f32 or bf16; JAX
matmuls at "highest" precision. Targets: loss within rtol 1e-6, dx and
dW within atol 1e-6 / rtol 1e-5 (measured: loss 9.5e-7 absolute at a loss
of ~6, gradients 2.3e-8; bf16 dx bit-equal). The fused loss is also held
to the unfused head + ``cross_entropy_loss`` (rtol 1e-5; gradients atol
1e-6), and a fused training step to an unfused one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_tpu.ops import losses as jlosses
from pytorch_distributed_tpu_torch.config import ModelConfig, TrainConfig
from pytorch_distributed_tpu_torch.models import get_model, gpt2
from pytorch_distributed_tpu_torch.ops import losses
from pytorch_distributed_tpu_torch.train import optim
from pytorch_distributed_tpu_torch.train.state import init_train_state
from pytorch_distributed_tpu_torch.train.trainer import make_train_step

N, E, V, BLOCK = 40, 32, 301, 128


def _inputs(layout, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((N, E)).astype(np.float32)
    shape = (V, E) if layout == "ve" else (E, V)
    w = (rng.standard_normal(shape) * 0.3).astype(np.float32)
    t = rng.integers(0, V, N).astype(np.int32)
    t[:3] = (0, V - 1, BLOCK)  # the first and last ids, a block edge
    return x, w, t


@pytest.mark.parametrize("logits_dtype", [None, "float32", "bfloat16"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout", ["ve", "ev"])
def test_loss_and_grads_match_jax(layout, dtype, logits_dtype):
    x, w, t = _inputs(layout)
    jx = jnp.asarray(x).astype(dtype)

    def jloss(a, b):
        return jlosses.linear_cross_entropy(
            a, b, jnp.asarray(t), block_v=BLOCK, w_layout=layout,
            logits_dtype=logits_dtype)

    with jax.default_matmul_precision("highest"):
        want, (jdx, jdw) = jax.value_and_grad(jloss, argnums=(0, 1))(
            jx, jnp.asarray(w))
    px = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(
        getattr(torch, dtype)).requires_grad_()
    pw = torch.from_numpy(w).requires_grad_()
    loss = losses.linear_cross_entropy(px, pw, torch.from_numpy(t),
                                       block_v=BLOCK, w_layout=layout,
                                       logits_dtype=logits_dtype)
    dx, dw = torch.autograd.grad(loss, [px, pw])
    assert loss.dtype == torch.float32
    assert dx.dtype == px.dtype and dw.dtype == pw.dtype
    assert dw.shape == pw.shape
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-6)
    np.testing.assert_allclose(dx.float().numpy(),
                               np.asarray(jdx.astype(jnp.float32)),
                               atol=1e-6, rtol=1e-5)
    np.testing.assert_allclose(dw.numpy(), np.asarray(jdw), atol=1e-6,
                               rtol=1e-5)


@pytest.mark.parametrize("layout", ["ve", "ev"])
def test_fused_equals_unfused_head(layout):
    x, w, t = _inputs(layout, seed=1)
    px = torch.from_numpy(x).requires_grad_()
    pw = torch.from_numpy(w).requires_grad_()
    tt = torch.from_numpy(t)
    fused = losses.linear_cross_entropy(px, pw, tt, block_v=BLOCK,
                                        w_layout=layout)
    logits = px @ (pw.t() if layout == "ve" else pw)
    unfused = losses.cross_entropy_loss(logits, tt)
    g_fused = torch.autograd.grad(fused, [px, pw])
    g_unfused = torch.autograd.grad(unfused, [px, pw])
    torch.testing.assert_close(fused, unfused, atol=0.0, rtol=1e-5)
    for a, b in zip(g_fused, g_unfused):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-5)
    with pytest.raises(ValueError, match="w_layout"):
        losses.linear_cross_entropy(px, pw, tt, w_layout="vv")


def test_fused_train_step_equals_unfused():
    """Two steps of ``make_train_step`` with ``fused_head_ce`` on and off
    (f32, tied head, dropout on): losses within rtol 1e-6, grad_norm
    within rtol 1e-5, params within the tolerance ``test_torch_train.py``
    holds a step to (atol 1e-5 / rtol 1e-4 at lr 3e-4: Adam turns
    summation-order noise in a gradient near zero into an update
    difference of order lr)."""
    kw = dict(vocab_size=301, n_ctx=32, n_embd=32, n_layer=2, n_head=2,
              dtype="float32", remat="dots")
    out = {}
    for fused in (False, True):
        cfg = ModelConfig(**kw, fused_head_ce=fused)
        tx = optim.make_optimizer(TrainConfig(learning_rate=3e-4))
        params = gpt2.init(torch.Generator().manual_seed(0), cfg,
                           device="cpu")
        state = init_train_state(params, tx)
        step = make_train_step(get_model(cfg), cfg, tx)
        ids = torch.randint(0, 301, (2, 2, 2, 32),
                            generator=torch.Generator().manual_seed(1))
        ls = []
        for i in range(2):
            state, m = step(state, {"inputs": ids[i, :1],
                                    "targets": ids[i, 1:]})
            ls.append((float(m["loss"]), float(m["grad_norm"])))
        out[fused] = np.array(ls), optim.tree.leaves(state.params)
    np.testing.assert_allclose(out[True][0][:, 0], out[False][0][:, 0],
                               rtol=1e-6)
    np.testing.assert_allclose(out[True][0][:, 1], out[False][0][:, 1],
                               rtol=1e-5)
    for a, b in zip(out[True][1], out[False][1]):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-4)
