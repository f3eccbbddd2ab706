"""The port's training slice against the JAX package's, on the CPU in f32.

The same weights (JAX ``gpt2.init``, converted with ``interop``) and the
same seeded numpy batches go through the JAX ``make_train_step`` and the
port's: GPT-2 at vocab 97, n_ctx 128, n_embd 64, 2 layers, 4 heads, f32,
no dropout, flash attention (the JAX side takes its blockwise path on the
CPU, the port its kernels' plain versions), ``names`` remat, clip 1.0,
cosine schedule. JAX matmuls run at "highest" precision. Targets: each
step's loss and grad_norm within rtol 1e-5; params after three steps
within atol 1e-5 / rtol 1e-4 (at lr 3e-4: Adam's update is about
lr * sign(g) per element, so a gradient near zero can turn summation-order
noise into an update difference of order lr). Measured maxima: loss 2.1e-7
relative, grad_norm 3.6e-7 relative, params 3.9e-6 absolute (A=1) and
1.5e-6 (A=2); apply logits 4.2e-7 (naive) and 3.3e-7 (flash).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_tpu.config import ModelConfig as JaxModelConfig
from pytorch_distributed_tpu.config import TrainConfig as JaxTrainConfig
from pytorch_distributed_tpu.models import get_model as jget_model
from pytorch_distributed_tpu.train import optim as joptim
from pytorch_distributed_tpu.train.state import init_train_state as jinit
from pytorch_distributed_tpu.train.trainer import make_train_step as jstep
from pytorch_distributed_tpu_torch import interop
from pytorch_distributed_tpu_torch.config import ModelConfig, TrainConfig
from pytorch_distributed_tpu_torch.models import get_model, gpt2
from pytorch_distributed_tpu_torch.ops import flash_kernel as fk
from pytorch_distributed_tpu_torch.ops import remat
from pytorch_distributed_tpu_torch.train import optim
from pytorch_distributed_tpu_torch.train.guard import guard_config_from
from pytorch_distributed_tpu_torch.train.state import init_train_state
from pytorch_distributed_tpu_torch.train.trainer import make_train_step

CFG_KW = dict(
    vocab_size=97, n_ctx=128, n_embd=64, n_layer=2, n_head=4,
    dtype="float32", attn_pdrop=0.0, resid_pdrop=0.0, embd_pdrop=0.0,
    attention_impl="flash", remat="names",
)
TRAIN_KW = dict(learning_rate=3e-4, num_steps=3, grad_clip_norm=1.0,
                lr_schedule="cosine")
B, T = 2, 64


def _batches(accum, n=3, seed=0):
    rng = np.random.default_rng(seed)
    return [
        dict(inputs=rng.integers(0, 97, (accum, B, T)).astype(np.int32),
             targets=rng.integers(0, 97, (accum, B, T)).astype(np.int32))
        for _ in range(n)
    ]


def _jax_setup(train_kw=TRAIN_KW):
    cfg = JaxModelConfig(**CFG_KW)
    tx = joptim.make_optimizer(JaxTrainConfig(**train_kw))
    params = jget_model(cfg).init(jax.random.key(0), cfg)
    return cfg, tx, jinit(params, tx), jax.jit(
        jstep(jget_model(cfg), cfg, tx, jit=False)
    )


def _jax_run(state, step, batches):
    out = []
    with jax.default_matmul_precision("highest"):
        for batch in batches:
            state, m = step(state, jax.tree.map(jnp.asarray, batch),
                            jax.random.key(0))
            out.append((float(m["loss"]), float(m["grad_norm"])))
    return state, out


def _port_setup(jax_params, train_kw=TRAIN_KW):
    cfg = ModelConfig(**CFG_KW)
    tx = optim.make_optimizer(TrainConfig(**train_kw))
    params = interop.params_from_jax(jax.device_get(jax_params), cfg)
    return cfg, tx, init_train_state(params, tx), make_train_step(
        get_model(cfg), cfg, tx
    )


def _port_run(state, step, batches):
    out = []
    for batch in batches:
        state, m = step(state, {k: torch.from_numpy(v)
                                for k, v in batch.items()})
        out.append((float(m["loss"]), float(m["grad_norm"])))
    return state, out


def _assert_params_close(port_params, jax_params, cfg):
    got = interop.params_to_jax(port_params, cfg)
    want = jax.device_get(jax_params)
    for (path, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(got),
                                 jax.tree_util.tree_leaves_with_path(want)):
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=1e-4,
                                   err_msg=str(path))


def test_train_config_matches_jax_field_for_field():
    for kw in ({}, TRAIN_KW, dict(warmup_steps=5, decay_exclude_1d=True)):
        assert (dataclasses.asdict(TrainConfig(**kw))
                == dataclasses.asdict(JaxTrainConfig(**kw)))
    assert TrainConfig(global_batch_size=32, micro_batch_size=8) \
        .grad_accum_steps() == 4
    with pytest.raises(ValueError, match="accum_dtype"):
        TrainConfig(accum_dtype="float16")
    with pytest.raises(ValueError, match="spike_factor"):
        TrainConfig(anomaly_guard=True, guard_spike_factor=0.5)


@pytest.mark.parametrize("kw", [
    TRAIN_KW,
    dict(learning_rate=3e-4, num_steps=10, warmup_steps=4),
    dict(learning_rate=1e-3, num_steps=7, lr_schedule="constant"),
], ids=["cosine", "warmup", "constant"])
def test_schedule_matches_optax(kw):
    jcfg, cfg = JaxTrainConfig(**kw), TrainConfig(**kw)
    jsched, sched = joptim.make_schedule(jcfg), optim.make_schedule(cfg)
    end = cfg.num_steps + cfg.warmup_steps
    for step in (0, 1, end // 2, end, end + 3):
        want = float(jsched(step))
        np.testing.assert_allclose(sched(step), want, rtol=1e-6)
        np.testing.assert_allclose(optim.lr_at_step(cfg, step),
                                   joptim.lr_at_step(jcfg, step), rtol=1e-12)
        np.testing.assert_allclose(optim.lr_at_step(cfg, step), want,
                                   rtol=1e-6)


@pytest.mark.parametrize("impl", ["naive", "flash"])
def test_apply_logits_match_jax(impl):
    jcfg = JaxModelConfig(**dict(CFG_KW, attention_impl=impl))
    cfg = ModelConfig(**dict(CFG_KW, attention_impl=impl))
    jparams = jget_model(jcfg).init(jax.random.key(1), jcfg)
    ids = np.random.default_rng(1).integers(0, 97, (B, 100)).astype(np.int32)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jget_model(jcfg).apply(jparams, jnp.asarray(ids),
                                                 jcfg))
    params = interop.params_from_jax(jax.device_get(jparams), cfg)
    got = gpt2.apply(params, torch.from_numpy(ids), cfg)
    assert got.dtype == torch.float32 and got.shape == (B, 100, 97)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("accum", [1, 2])
def test_three_steps_match_jax(accum):
    batches = _batches(accum)
    jcfg, _, jstate, step_j = _jax_setup()
    cfg, _, state, step_p = _port_setup(jstate.params)
    jstate, jm = _jax_run(jstate, step_j, batches)
    state, pm = _port_run(state, step_p, batches)
    assert state.step == 3 and int(jstate.step) == 3
    for (lj, gj), (lp, gp) in zip(jm, pm):
        np.testing.assert_allclose(lp, lj, rtol=1e-5)
        np.testing.assert_allclose(gp, gj, rtol=1e-5)
    assert pm[0][1] > 1.0  # the clip was active on the first step
    _assert_params_close(state.params, jstate.params, cfg)


def test_resume_from_jax_state():
    """Two JAX steps, then the JAX params and optimizer state converted
    into the port; the third step agrees on both sides."""
    batches = _batches(1)
    jcfg, tx_j, jstate, step_j = _jax_setup()
    jstate, _ = _jax_run(jstate, step_j, batches[:2])
    cfg, tx, _, step_p = _port_setup(jstate.params)
    host = jax.device_get(jstate)
    state = init_train_state(interop.params_from_jax(host.params, cfg), tx)
    state = state._replace(
        opt_state=interop.opt_state_from_jax(host.opt_state, cfg), step=2
    )
    assert state.opt_state["count"] == state.opt_state["schedule_count"] == 2
    jstate, jm = _jax_run(jstate, step_j, batches[2:])
    state, pm = _port_run(state, step_p, batches[2:])
    np.testing.assert_allclose(pm[0], jm[0], rtol=1e-5)
    _assert_params_close(state.params, jstate.params, cfg)


def test_optimizer_state_round_trips_exactly():
    batches = _batches(1, n=2)
    kw = dict(TRAIN_KW, decay_exclude_1d=True)
    _, tx_j, jstate, step_j = _jax_setup(kw)
    jstate, _ = _jax_run(jstate, step_j, batches)
    host = jax.device_get(jstate.opt_state)
    cfg = ModelConfig(**CFG_KW)
    port = interop.opt_state_from_jax(host, cfg)
    back = interop.opt_state_to_jax(port, cfg, like=host)
    assert [type(s) for s in back] == [type(s) for s in host]
    a, b = (jax.tree_util.tree_leaves_with_path(x) for x in (back, host))
    assert len(a) == len(b)
    for (path, x), (_, y) in zip(a, b):
        assert np.asarray(x).dtype == np.asarray(y).dtype, path
        np.testing.assert_array_equal(x, y, err_msg=str(path))
    again = interop.opt_state_from_jax(back, cfg)
    for x, y in zip(optim.tree.leaves(again), optim.tree.leaves(port)):
        assert torch.equal(torch.as_tensor(x), torch.as_tensor(y))


def test_bf16_params_round_trip_bit_for_bit():
    jcfg = JaxModelConfig(**dict(CFG_KW, param_dtype="bfloat16"))
    tree = jax.device_get(jget_model(jcfg).init(jax.random.key(2), jcfg))
    cfg = ModelConfig(**dict(CFG_KW, param_dtype="bfloat16"))
    port = interop.params_from_jax(tree, cfg)
    assert port["wte"].dtype == torch.bfloat16
    back = interop.params_to_jax(port, cfg)
    a, b = (jax.tree_util.tree_leaves_with_path(x) for x in (back, tree))
    for (path, x), (_, y) in zip(a, b):
        assert x.dtype == y.dtype, path
        np.testing.assert_array_equal(x.view(np.uint16), y.view(np.uint16),
                                      err_msg=str(path))
    ours = gpt2.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    again = interop.params_from_jax(interop.params_to_jax(ours, cfg), cfg)
    for x, y in zip(optim.tree.leaves(ours), optim.tree.leaves(again)):
        assert torch.equal(x.view(torch.int16), y.view(torch.int16))


def _grads_and_calls(mode, seed=3):
    cfg = ModelConfig(**dict(CFG_KW, remat=mode))
    params = gpt2.init(torch.Generator().manual_seed(seed), cfg, device="cpu")
    ids = torch.from_numpy(
        np.random.default_rng(seed).integers(0, 97, (2, B, T))
    )
    leaves = [p.requires_grad_() for p in optim.tree.leaves(params)]
    before = dict(fk.plain_calls)
    from pytorch_distributed_tpu_torch.ops.losses import cross_entropy_loss

    loss = cross_entropy_loss(gpt2.apply(params, ids[0], cfg), ids[1])
    grads = torch.autograd.grad(loss, leaves)
    calls = {k: fk.plain_calls[k] - before[k] for k in before}
    return grads, calls


def test_remat_modes_give_the_same_grads_and_kernel_counts():
    """Per step, K1 runs n_layer times under none and names and 2 n_layer
    under full; K2 n_layer times under all three (counted here as the
    plain versions' calls)."""
    n = CFG_KW["n_layer"]
    ref, calls = _grads_and_calls("none")
    assert calls == {"forward": n, "backward": n}
    for mode, want in (("full", 2 * n), ("names", n)):
        grads, calls = _grads_and_calls(mode)
        assert calls == {"forward": want, "backward": n}, mode
        for a, b in zip(grads, ref):
            torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)


def test_names_keeps_the_tagged_products_and_the_flash_outputs(monkeypatch):
    """One layer under names: the forward keeps the qkv product, the
    flash op's (o, lse), the attn_proj and mlp_fc products — not mlp_proj
    — and the recompute in backward reads all four back."""
    lists = []

    class Recorded(remat._Kept):
        def __init__(self):
            super().__init__()
            lists.append(self)

    monkeypatch.setattr(remat, "_Kept", Recorded)
    cfg = ModelConfig(**dict(CFG_KW, n_layer=1))
    params = gpt2.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    leaves = [p.requires_grad_() for p in optim.tree.leaves(params)]
    logits = gpt2.apply(params, torch.zeros(2, 8, dtype=torch.long), cfg)
    (kept,) = lists
    shapes = [tuple(x.shape) if torch.is_tensor(x) else
              tuple(tuple(t.shape) for t in x) for x in kept.values]
    e, f = cfg.n_embd, cfg.inner_dim
    assert shapes == [(2, 8, 3 * e), ((2, 4, 8, 16), (2, 4, 8)), (2, 8, e),
                      (2, 8, f)]
    before = dict(fk.plain_calls)
    torch.autograd.grad(logits.sum(), leaves)
    assert kept.next == 4
    assert fk.plain_calls["forward"] == before["forward"]  # K1 not re-run


def test_refusals():
    """What the port still refuses: an unknown remat mode; a training-mode
    forward without a dropout stream. Dropout, ``fused_head_ce``, MoE,
    every remat mode and the anomaly guard are ported (the guard is the
    step's ``guard=`` argument, as in JAX: tests/test_torch_guard.py)."""
    cfg = ModelConfig(**CFG_KW)
    tx = optim.make_optimizer(TrainConfig())
    model = get_model(cfg)
    for ok in (dict(attn_pdrop=0.1), dict(embd_pdrop=0.1),
               dict(fused_head_ce=True), dict(n_experts=4)):
        assert callable(make_train_step(model, cfg.replace(**ok), tx))
    guarded = TrainConfig(anomaly_guard=True)
    assert callable(make_train_step(
        model, cfg, optim.make_optimizer(guarded),
        guard=guard_config_from(guarded, cfg)))
    for mode in ("dots", "dots_no_batch", "flash"):
        assert callable(remat.apply_remat(lambda x: x, mode))
    with pytest.raises(KeyError, match="unknown remat"):
        remat.apply_remat(lambda x: x, "nope")
    params = gpt2.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    with pytest.raises(ValueError, match="dropout_seed"):
        gpt2.apply(params, torch.zeros(1, 4, dtype=torch.long), cfg,
                   deterministic=False)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            gpt2.init(torch.Generator().manual_seed(0), cfg)
