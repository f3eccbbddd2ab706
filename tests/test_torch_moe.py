"""The port's MoE (``ops/moe`` and the MoE blocks of both families) against
the JAX package's, on the CPU in f32 (bf16 where stated).

``moe_mlp``: the same seeded numpy tokens and weights through JAX
``ops/moe.moe_mlp`` and the port's, for top-1 and top-2, dense and gated
(SwiGLU) experts, einsum and sort dispatch, a generous capacity (factor
X / k: nothing dropped) and a dropping one (factor 0.5); JAX at "highest"
matmul precision. Outputs and gradients (tokens, router, expert weights)
within 2e-6 of each array's largest magnitude, the aux term within rtol
1e-6: the routes agree, and what is left is summation order (measured at
most 4.8e-7 of the largest magnitude, the aux term equal).

The MoE blocks: each remat mode's kept set against the JAX block's
``saved_residuals`` (gpt2 and llama MoE blocks, both dispatches, f32 and
bf16), as ``tests/test_torch_remat_modes.py`` does for the dense block.

Training: three MoE steps per family against JAX ``make_train_step``
(``tests/test_torch_train.py``'s tolerances: loss and grad_norm rtol 1e-5,
params atol 1e-5 / rtol 1e-4), the ``Trainer`` against the JAX
``Trainer``, and checkpoints of a llama MoE model crossing between the
packages both ways (rtol 1e-5 on the resumed losses).
"""

import functools
import json
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax._src.ad_checkpoint import saved_residuals

from pytorch_distributed_tpu.config import ModelConfig as JaxModelConfig
from pytorch_distributed_tpu.config import TrainConfig as JaxTrainConfig
from pytorch_distributed_tpu.data import TokenShardLoader as JaxLoader
from pytorch_distributed_tpu.models import get_model as jget_model
from pytorch_distributed_tpu.models import gpt2 as jgpt2
from pytorch_distributed_tpu.models import llama as jllama
from pytorch_distributed_tpu.ops import moe as jmoe
from pytorch_distributed_tpu.ops import remat as jremat
from pytorch_distributed_tpu.ops.layers import activation as jactivation
from pytorch_distributed_tpu.ops.rope import rope_angles as jrope_angles
from pytorch_distributed_tpu.train import optim as joptim
from pytorch_distributed_tpu.train.state import init_train_state as jinit
from pytorch_distributed_tpu.train.trainer import Trainer as JaxTrainer
from pytorch_distributed_tpu.train.trainer import make_eval_step as jeval
from pytorch_distributed_tpu.train.trainer import make_train_step as jstep
from pytorch_distributed_tpu_torch import interop
from pytorch_distributed_tpu_torch.config import ModelConfig, TrainConfig
from pytorch_distributed_tpu_torch.data import (
    TokenShardLoader,
    make_synthetic_shards,
)
from pytorch_distributed_tpu_torch.models import get_model, gpt2, llama
from pytorch_distributed_tpu_torch.ops import moe, remat
from pytorch_distributed_tpu_torch.ops.rope import rope_angles
from pytorch_distributed_tpu_torch.train import checkpoint as ckpt
from pytorch_distributed_tpu_torch.train import optim
from pytorch_distributed_tpu_torch.train.state import init_train_state
from pytorch_distributed_tpu_torch.train.trainer import (
    Trainer,
    make_eval_step,
    make_train_step,
)
from pytorch_distributed_tpu_torch.utils import prng, tree

D, F_, X = 32, 64, 4
# The cotangent of the output in the gradient checks.
COT = np.random.default_rng(9).normal(size=D).astype(np.float32)


def _moe_weights(gated, seed=0):
    rng = np.random.default_rng(seed)
    w = {"router": rng.normal(0, 0.5, (D, X)),
         "w_in": rng.normal(0, 0.2, (X, D, F_)),
         "w_out": rng.normal(0, 0.2, (X, F_, D))}
    if gated:
        w["w_gate"] = rng.normal(0, 0.2, (X, D, F_))
    return {k: v.astype(np.float32) for k, v in w.items()}


def _jax_moe(x, w, act, **kw):
    def f(x, w):
        out, aux = jmoe.moe_mlp(x, w, activation=act, **kw)
        return (out * jnp.asarray(COT)).sum() + aux, (out, aux)

    with jax.default_matmul_precision("highest"):
        (_, (out, aux)), grads = jax.value_and_grad(
            f, argnums=(0, 1), has_aux=True)(jnp.asarray(x),
                                             jax.tree.map(jnp.asarray, w))
    return np.asarray(out), float(aux), grads


def _close(got, want, err_msg=""):
    """Within 2e-6 of the array's largest magnitude (or rtol 1e-5)."""
    np.testing.assert_allclose(got, want, atol=2e-6 * np.abs(want).max(),
                               rtol=1e-5, err_msg=err_msg)


def _port_moe(x, w, act, **kw):
    xt = torch.from_numpy(x).requires_grad_()
    wt = {k: torch.from_numpy(v).requires_grad_() for k, v in w.items()}
    out, aux = moe.moe_mlp(xt, wt, activation=act, **kw)
    loss = (out * torch.from_numpy(COT)).sum() + aux
    grads = torch.autograd.grad(loss, [xt, *wt.values()])
    return out.detach().numpy(), float(aux.detach()), dict(
        zip(["x", *wt], [g.numpy() for g in grads]))


@pytest.mark.parametrize("capacity_factor", ["generous", 0.5])
@pytest.mark.parametrize("dispatch", ["einsum", "sort"])
@pytest.mark.parametrize("gated", [False, True])
@pytest.mark.parametrize("top_k", [1, 2])
def test_moe_mlp_matches_jax(top_k, gated, dispatch, capacity_factor):
    cf = X / top_k if capacity_factor == "generous" else capacity_factor
    kw = dict(capacity_factor=cf, top_k=top_k, dispatch_impl=dispatch)
    x = np.random.default_rng(1).normal(size=(2, 24, D)).astype(np.float32)
    w = _moe_weights(gated)
    want, waux, (jgx, jgw) = _jax_moe(x, w, jax.nn.silu if gated
                                      else jactivation("gelu_new"), **kw)
    got, aux, grads = _port_moe(x, w, F.silu if gated else
                                (lambda h: F.gelu(h, approximate="tanh")),
                                **kw)
    _close(got, want)
    np.testing.assert_allclose(aux, waux, rtol=1e-6)
    _close(grads["x"], np.asarray(jgx))
    for k, g in jgw.items():
        _close(grads[k], np.asarray(g), err_msg=k)
    dropped = float(moe.dropped_share(torch.from_numpy(x),
                                      torch.from_numpy(w["router"]),
                                      top_k=top_k, capacity_factor=cf))
    assert (dropped == 0.0) == (capacity_factor == "generous")


@pytest.mark.parametrize("top_k", [1, 2, 3])
def test_sort_and_einsum_dispatch_agree(top_k):
    x = torch.from_numpy(np.random.default_rng(2).normal(
        size=(3, 40, D)).astype(np.float32))
    w = {k: torch.from_numpy(v) for k, v in _moe_weights(True, 3).items()}
    outs = [moe.moe_mlp(x, w, activation=F.silu, capacity_factor=0.75,
                        top_k=top_k, dispatch_impl=d)
            for d in ("einsum", "sort")]
    torch.testing.assert_close(outs[0][0], outs[1][0], atol=1e-6, rtol=1e-5)
    assert torch.equal(outs[0][1], outs[1][1])
    again = moe.moe_mlp(x, w, activation=F.silu, capacity_factor=0.75,
                        top_k=top_k, dispatch_impl="sort")
    assert torch.equal(again[0], outs[1][0])


def test_ties_go_to_the_lower_expert_as_in_jax():
    """A zero router gives every expert the same probability: top-k picks
    experts 0..k-1 in both packages (torch.topk would not promise it)."""
    x = np.random.default_rng(4).normal(size=(1, 8, D)).astype(np.float32)
    router = np.zeros((D, X), np.float32)
    for k in (1, 2, 3):
        idx, gates, _ = moe._route(torch.from_numpy(x[0]),
                                   torch.from_numpy(router), k)
        jidx, jgates, _ = jmoe._route(jnp.asarray(x[0]), jnp.asarray(router),
                                      k)
        assert idx.tolist() == np.asarray(jidx).tolist() == \
            [list(range(k))] * 8
        np.testing.assert_allclose(gates.numpy(), np.asarray(jgates))


def test_capacity_positions_and_auto_switch_match_jax():
    for tokens, cf in ((64, 1.25), (4096, 1.0), (7, 0.1)):
        assert moe.expert_capacity(tokens, 8, cf) == \
            jmoe.expert_capacity(tokens, 8, cf)
    assert moe._AUTO_EINSUM_LIMIT == jmoe._AUTO_EINSUM_LIMIT
    e = np.random.default_rng(5).integers(0, X, 50)
    pos = moe._assignment_positions(torch.from_numpy(e), X)[0]
    jpos = jmoe._assignment_positions(jnp.asarray(e), X)[0]
    assert pos.tolist() == np.asarray(jpos).tolist()


def test_dropped_assignments_contribute_exactly_zero():
    """Capacity 1 slot per expert: every token but each expert's first
    comes out exactly 0, its gradient exactly 0."""
    x = torch.randn(1, 16, D, generator=torch.Generator().manual_seed(6),
                    requires_grad=True)
    w = {k: torch.from_numpy(v) for k, v in _moe_weights(False, 7).items()}
    for dispatch in ("einsum", "sort"):
        out, _ = moe.moe_mlp(x, w, activation=F.relu, capacity_factor=1e-3,
                             dispatch_impl=dispatch)
        idx = moe._route(x[0].detach(), w["router"], 1)[0][:, 0]
        first = {int(e): i for i, e in reversed(list(enumerate(idx)))}
        kept = set(first.values())
        g, = torch.autograd.grad(out.sum(), [x])
        for i in range(16):
            assert (out[0, i].abs().sum() > 0) == (i in kept)
            if i not in kept:
                assert torch.equal(out[0, i], torch.zeros(D))


def test_multi_device_axes_are_refused():
    x = torch.zeros(1, 4, D)
    w = {k: torch.from_numpy(v) for k, v in _moe_weights(False).items()}
    with pytest.raises(NotImplementedError, match="item 7"):
        moe.moe_mlp(x, w, activation=F.relu, expert_axis="expert")
    # The tensor axis is ported (TP inside each expert): it takes the
    # tensor process group, not JAX's axis name.
    with pytest.raises(TypeError, match="process group"):
        moe.moe_mlp(x, w, activation=F.relu, tensor_axis="tensor")


# --- the MoE blocks under remat -------------------------------------------

RB, RT, RE = 2, 16, 64
MODES = ("full", "dots", "dots_no_batch", "names", "flash")
BLOCK_KW = {
    "gpt2": dict(vocab_size=97, n_ctx=RT, n_embd=RE, n_layer=1, n_head=2,
                 n_inner=128, embd_pdrop=0.0, attn_pdrop=0.0,
                 resid_pdrop=0.0),
    "llama": dict(family="llama", activation_function="silu", vocab_size=97,
                  n_ctx=RT, n_embd=RE, n_layer=1, n_head=2, n_kv_head=1,
                  n_inner=128, embd_pdrop=0.0, attn_pdrop=0.0,
                  resid_pdrop=0.0),
}


def _blocks(family, cfg, jcfg, jparams):
    jbp = jax.tree.map(lambda a: a[0], jparams["blocks"])
    bp = interop.params_from_jax(jax.device_get(jparams), cfg)["blocks"][0]
    if family == "gpt2":
        return ((lambda x, bp: jgpt2._block(x, bp, jcfg, None, True)[0]),
                (jbp,), functools.partial(gpt2._block, cfg=cfg, key=None),
                (bp, 0))
    jcos, jsin = jrope_angles(RT, jcfg.head_dim, jcfg.rope_theta)
    cos, sin = rope_angles(RT, cfg.head_dim, cfg.rope_theta, device="cpu")
    return ((lambda x, bp, c, s: jllama._block(x, bp, jcfg, c, s)[0]),
            (jbp, jcos, jsin), functools.partial(llama._block, cfg=cfg),
            (bp, cos, sin))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dispatch", ["einsum", "sort"])
@pytest.mark.parametrize("family", ["gpt2", "llama"])
def test_moe_block_kept_sets_match_jax_saved_residuals(monkeypatch, family,
                                                       dispatch, dtype):
    from test_torch_llama_train import jax_block_residuals, port_block_kept

    kw = dict(BLOCK_KW[family], dtype=dtype, n_experts=X, moe_top_k=2,
              moe_dispatch=dispatch, attention_impl="naive")
    jcfg = JaxModelConfig(**kw)
    jparams = jget_model(jcfg).init(jax.random.key(0), jcfg)
    jx = jax.random.normal(jax.random.key(1), (RB, RT, RE)).astype(dtype)
    x0 = torch.randn(RB, RT, RE, generator=torch.Generator().manual_seed(1))
    for mode in MODES:
        cfg = ModelConfig(**kw, remat=mode)
        jfn, jrest, fn, rest = _blocks(family, cfg, jcfg, jparams)
        want, _ = jax_block_residuals(jremat.apply_remat(jfn, mode),
                                      (jx, *jrest))
        x = x0.to(getattr(torch, dtype)).requires_grad_()
        got, labels, _ = port_block_kept(
            monkeypatch, remat.apply_remat(fn, mode), x, *rest)
        assert got == want, mode
        if mode == "names":  # the MoE MLP has no tag: nothing kept in it
            assert None not in labels


# --- training -------------------------------------------------------------

# tests/test_torch_train.py's step settings, which its tolerances assume.
TRAIN_KW = dict(learning_rate=3e-4, num_steps=3, grad_clip_norm=1.0,
                lr_schedule="cosine")
MODEL_KW = {
    "gpt2": dict(vocab_size=97, n_ctx=32, n_embd=32, n_layer=2, n_head=2,
                 dtype="float32", embd_pdrop=0.0, attn_pdrop=0.0,
                 resid_pdrop=0.0, attention_impl="flash", remat="names",
                 n_experts=X),
    "llama": dict(family="llama", activation_function="silu",
                  vocab_size=97, n_ctx=32, n_embd=32, n_layer=2, n_head=4,
                  n_kv_head=2, n_inner=64, dtype="float32",
                  embd_pdrop=0.0, attn_pdrop=0.0, resid_pdrop=0.0,
                  attention_impl="flash", remat="dots", n_experts=X),
}


@pytest.mark.parametrize("top_k, dispatch, fused", [
    (1, "auto", False), (2, "sort", True), (2, "einsum", False)])
@pytest.mark.parametrize("family", ["gpt2", "llama"])
def test_three_moe_steps_match_jax(family, top_k, dispatch, fused):
    kw = dict(MODEL_KW[family], moe_top_k=top_k, moe_dispatch=dispatch,
              fused_head_ce=fused, expert_capacity_factor=1.0)
    jcfg, cfg = JaxModelConfig(**kw), ModelConfig(**kw)
    jtx = joptim.make_optimizer(JaxTrainConfig(**TRAIN_KW))
    jparams = jget_model(jcfg).init(jax.random.key(0), jcfg)
    jstate = jinit(jparams, jtx)
    step_j = jax.jit(jstep(jget_model(jcfg), jcfg, jtx, jit=False))
    tx = optim.make_optimizer(TrainConfig(**TRAIN_KW))
    state = init_train_state(
        interop.params_from_jax(jax.device_get(jparams), cfg), tx)
    step_p = make_train_step(get_model(cfg), cfg, tx)
    rng = np.random.default_rng(8)
    for _ in range(3):
        batch = {k: rng.integers(0, 97, (2, 2, 32)).astype(np.int32)
                 for k in ("inputs", "targets")}
        with jax.default_matmul_precision("highest"):
            jstate, jm = step_j(jstate, jax.tree.map(jnp.asarray, batch),
                                jax.random.key(0))
        state, m = step_p(state, {k: torch.from_numpy(v)
                                  for k, v in batch.items()})
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-5)
    got = interop.params_to_jax(state.params, cfg)
    for (path, a), (_, b) in zip(
            jax.tree_util.tree_leaves_with_path(got),
            jax.tree_util.tree_leaves_with_path(
                jax.device_get(jstate.params))):
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=1e-4,
                                   err_msg=str(path))
    # Eval is the plain cross-entropy: no aux term, as in JAX.
    with jax.default_matmul_precision("highest"):
        want = float(jax.jit(jeval(jget_model(jcfg), jcfg))(
            jstate.params, jax.tree.map(jnp.asarray, batch)))
    got = float(make_eval_step(get_model(cfg), cfg)(
        state.params, {k: torch.from_numpy(v) for k, v in batch.items()}))
    np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.parametrize("family", ["gpt2", "llama"])
def test_moe_init_has_the_jax_layout(family):
    kw = dict(MODEL_KW[family], param_dtype="bfloat16")
    jcfg, cfg = JaxModelConfig(**kw), ModelConfig(**kw)
    jparams = jax.device_get(jget_model(jcfg).init(jax.random.key(0), jcfg))
    params = get_model(cfg).init(torch.Generator().manual_seed(0), cfg,
                                 device="cpu")
    got = interop.params_to_jax(params, cfg)
    jl = jax.tree_util.tree_leaves_with_path(jparams)
    pl = jax.tree_util.tree_leaves_with_path(got)
    assert [(str(p), np.shape(a), str(a.dtype)) for p, a in pl] == \
        [(str(p), np.shape(a), str(a.dtype)) for p, a in jl]
    back = interop.params_from_jax(got, cfg)
    for a, b in zip(tree.leaves(back), tree.leaves(params)):
        assert torch.equal(a, b)
    std = float(params["blocks"][0]["mlp"]["w_in"].float().std())
    assert 0.018 < std < 0.022


@pytest.mark.parametrize("family", ["gpt2", "llama"])
def test_moe_optimizer_state_round_trips_exactly(family):
    """After a JAX step the optax state's stacked [L, X, ...] expert moments
    convert to the port's per-layer layout and back bit for bit, bf16
    params and moments included."""
    kw = dict(MODEL_KW[family], param_dtype="bfloat16", moe_top_k=2)
    jcfg, cfg = JaxModelConfig(**kw), ModelConfig(**kw)
    jtx = joptim.make_optimizer(JaxTrainConfig(**TRAIN_KW))
    jstate = jinit(jget_model(jcfg).init(jax.random.key(0), jcfg), jtx)
    step_j = jax.jit(jstep(jget_model(jcfg), jcfg, jtx, jit=False))
    batch = {k: np.random.default_rng(9).integers(0, 97, (1, 2, 32)).astype(
        np.int32) for k in ("inputs", "targets")}
    jstate, _ = step_j(jstate, jax.tree.map(jnp.asarray, batch),
                       jax.random.key(0))
    host = jax.device_get(jstate.opt_state)
    port = interop.opt_state_from_jax(host, cfg)
    assert port["mu"]["blocks"][0]["mlp"]["w_in"].shape == (
        X, 32, cfg.inner_dim)
    back = interop.opt_state_to_jax(port, cfg, like=host)
    a, b = (jax.tree_util.tree_leaves_with_path(x) for x in (back, host))
    assert len(a) == len(b)
    for (path, x), (_, y) in zip(a, b):
        assert np.asarray(x).dtype == np.asarray(y).dtype, path
        np.testing.assert_array_equal(x, y, err_msg=str(path))
    params = interop.params_from_jax(jax.device_get(jstate.params), cfg)
    for (path, x), (_, y) in zip(
            jax.tree_util.tree_leaves_with_path(
                interop.params_to_jax(params, cfg)),
            jax.tree_util.tree_leaves_with_path(
                jax.device_get(jstate.params))):
        np.testing.assert_array_equal(x, y, err_msg=str(path))


def _shard_paths(tmp_path):
    return make_synthetic_shards(tmp_path / "data", num_shards=2,
                                 tokens_per_shard=2000, vocab_size=97,
                                 seed=3)


def _trainers(tmp_path, family, ckdir, **kw):
    mkw = dict(MODEL_KW[family], moe_top_k=2)
    jcfg, cfg = JaxModelConfig(**mkw), ModelConfig(**mkw)
    tkw = dict(global_batch_size=4, micro_batch_size=2, num_steps=4,
               learning_rate=1e-3, log_every_n_steps=1, seed=5,
               checkpoint_dir=str(ckdir), **kw)
    jt = JaxTrainer(jget_model(jcfg), jcfg, JaxTrainConfig(**tkw),
                    log_fn=lambda s: None)
    pt = Trainer(get_model(cfg), cfg, TrainConfig(**tkw), device="cpu",
                 log_fn=lambda s: None)
    return jt, pt


def test_moe_trainer_matches_jax_trainer(tmp_path):
    paths = _shard_paths(tmp_path)
    jt, pt = _trainers(tmp_path, "gpt2", tmp_path / "ck")
    jstate = jt.init_state()
    start = init_train_state(interop.params_from_jax(
        jax.device_get(jstate.params), pt.model_cfg), pt.tx)
    with jax.default_matmul_precision("highest"):
        _, jhist = jt.train(JaxLoader(paths, 2, 16), state=jstate)
    state, hist = pt.train(TokenShardLoader(paths, 2, 16), state=start)
    assert state.step == 4 and len(hist) == len(jhist) == 4
    np.testing.assert_allclose([h["loss"] for h in hist],
                               [h["loss"] for h in jhist], rtol=1e-5)


def test_moe_checkpoints_cross_between_the_packages(tmp_path):
    """A llama MoE run: JAX writes, the port resumes; the port writes, JAX
    resumes; both continue (steps 3-4) to the uninterrupted losses, and
    the two manifests list the same expert leaves."""
    paths = _shard_paths(tmp_path)
    jt, _ = _trainers(tmp_path, "llama", tmp_path / "jck",
                      save_every_n_steps=2)
    _, pt = _trainers(tmp_path, "llama", tmp_path / "pck",
                      save_every_n_steps=2)
    jstate0 = jt.init_state()
    start = init_train_state(interop.params_from_jax(
        jax.device_get(jstate0.params), pt.model_cfg), pt.tx)
    with jax.default_matmul_precision("highest"):
        _, jhist = jt.train(JaxLoader(paths, 2, 16), state=jstate0)
    _, phist = pt.train(TokenShardLoader(paths, 2, 16), state=start)
    jman, pman = (json.loads(Path(ckpt.latest_checkpoint(d), "manifest.json")
                             .read_text())["leaves"]
                  for d in (tmp_path / "jck", tmp_path / "pck"))
    assert list(pman) == list(jman)
    assert {k: (v["shape"], v["dtype"]) for k, v in pman.items()} == \
        {k: (v["shape"], v["dtype"]) for k, v in jman.items()}
    assert "params/blocks/mlp/w_gate" in pman
    assert "opt_state/1/mu/blocks/mlp/router" in pman
    for d in ("jck", "pck"):
        newest = ckpt.latest_checkpoint(tmp_path / d)
        shutil.move(newest, str(tmp_path / f"parked_{d}"))
    _, pt2 = _trainers(tmp_path, "llama", tmp_path / "jck")
    loader = TokenShardLoader(paths, 2, 16)
    state = pt2.resume_latest(pt2.init_state(), loader=loader)
    assert state.step == 2
    _, hist = pt2.train(loader, state=state)
    np.testing.assert_allclose([h["loss"] for h in hist],
                               [h["loss"] for h in jhist[2:]], rtol=1e-5)
    jt2, _ = _trainers(tmp_path, "llama", tmp_path / "pck")
    jloader = JaxLoader(paths, 2, 16)
    jstate = jt2.resume_latest(jt2.init_state(), loader=jloader)
    assert int(jstate.step) == 2
    with jax.default_matmul_precision("highest"):
        _, jhist2 = jt2.train(jloader, state=jstate)
    np.testing.assert_allclose([h["loss"] for h in jhist2],
                               [h["loss"] for h in phist[2:]], rtol=1e-5)


def test_moe_gpt2_dropout_draws_the_same_masks_under_every_mode():
    """A MoE GPT-2 with dropout: gradients under every remat mode equal
    mode none's (the recompute redraws the same masks, and the routing is
    recomputed from the same values)."""
    def grads(mode):
        cfg = ModelConfig(**dict(MODEL_KW["gpt2"], remat=mode, moe_top_k=2,
                                 embd_pdrop=0.1, resid_pdrop=0.1,
                                 attn_pdrop=0.1))
        params = gpt2.init(torch.Generator().manual_seed(3), cfg,
                           device="cpu")
        leaves = [p.requires_grad_() for p in tree.leaves(params)]
        ids = torch.randint(0, 97, (2, 32),
                            generator=torch.Generator().manual_seed(4))
        logits, aux = gpt2.apply(params, ids, cfg, deterministic=False,
                                 dropout_seed=prng.DropoutKey(5, 6, 0),
                                 return_aux=True)
        return torch.autograd.grad(logits.square().mean() + aux, leaves)

    ref = grads("none")
    for mode in MODES:
        for a, b in zip(grads(mode), ref):
            torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)
