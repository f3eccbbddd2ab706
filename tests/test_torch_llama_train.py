"""The port's llama training forward and step against the JAX package's,
on the CPU in f32.

The same weights (JAX ``llama.init``, converted with ``interop``) and the
same seeded numpy batches go through both packages: llama at vocab 97,
n_ctx 128, n_embd 64, 2 layers, 4 query heads over 2 KV heads (GQA group
2), SwiGLU inner 128, f32; JAX matmuls at "highest" precision. Tolerances
are ``tests/test_torch_train.py``'s: logits atol/rtol 1e-5; each step's
loss and grad_norm within rtol 1e-5; params after three steps within atol
1e-5 / rtol 1e-4 (Adam's update is about lr * sign(g) per element, so a
gradient near zero turns summation-order noise into a difference of order
lr).

The remat modes: for one llama block (E 128, 2 query heads of 64 over 1 KV
head, T 128, so that the JAX flash path is its Pallas kernel, run in
interpret mode) the JAX ``saved_residuals`` under each policy and the
port's ``_Kept`` list under the same mode are the same multiset of
(dtype, element count), in f32 and bf16, and the port's K1 (its plain
version here) runs as often as the JAX grad's ``pallas_call``s.

Then the entry point ``train/baseline.py`` with ``--preset llama3-1b``,
its preset narrowed by the test (not by the package) to run here.
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src.ad_checkpoint import saved_residuals

from pytorch_distributed_tpu.config import ModelConfig as JaxModelConfig
from pytorch_distributed_tpu.config import TrainConfig as JaxTrainConfig
from pytorch_distributed_tpu.models import get_model as jget_model
from pytorch_distributed_tpu.models import llama as jllama
from pytorch_distributed_tpu.ops import flash_kernel as jfk
from pytorch_distributed_tpu.ops import pallas_flash
from pytorch_distributed_tpu.ops import remat as jremat
from pytorch_distributed_tpu.ops.rope import rope_angles as jrope_angles
from pytorch_distributed_tpu.train import optim as joptim
from pytorch_distributed_tpu.train.state import init_train_state as jinit
from pytorch_distributed_tpu.train.trainer import make_train_step as jstep
from pytorch_distributed_tpu_torch import config as port_config
from pytorch_distributed_tpu_torch import interop
from pytorch_distributed_tpu_torch.config import ModelConfig, TrainConfig
from pytorch_distributed_tpu_torch.models import get_model, llama
from pytorch_distributed_tpu_torch.ops import flash_kernel as fk
from pytorch_distributed_tpu_torch.ops import remat
from pytorch_distributed_tpu_torch.ops.rope import rope_angles
from pytorch_distributed_tpu_torch.train import baseline, optim
from pytorch_distributed_tpu_torch.train import checkpoint as ckpt
from pytorch_distributed_tpu_torch.train.state import init_train_state
from pytorch_distributed_tpu_torch.train.trainer import make_train_step
from pytorch_distributed_tpu_torch.utils import tree

LLAMA = dict(family="llama", activation_function="silu", embd_pdrop=0.0,
             attn_pdrop=0.0, resid_pdrop=0.0, rope_theta=500000.0)
CFG_KW = dict(LLAMA, vocab_size=97, n_ctx=128, n_embd=64, n_layer=2,
              n_head=4, n_kv_head=2, n_inner=128, dtype="float32",
              attention_impl="flash", remat="names")
TRAIN_KW = dict(learning_rate=3e-4, num_steps=3, grad_clip_norm=1.0,
                lr_schedule="cosine")
B, T = 2, 64


def _cfgs(**kw):
    kw = dict(CFG_KW, **kw)
    return JaxModelConfig(**kw), ModelConfig(**kw)


def _batches(accum, n=3, seed=0):
    rng = np.random.default_rng(seed)
    return [
        dict(inputs=rng.integers(0, 97, (accum, B, T)).astype(np.int32),
             targets=rng.integers(0, 97, (accum, B, T)).astype(np.int32))
        for _ in range(n)
    ]


def _assert_params_close(port_params, jax_params, cfg):
    got = interop.params_to_jax(port_params, cfg)
    want = jax.device_get(jax_params)
    for (path, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(got),
                                 jax.tree_util.tree_leaves_with_path(want)):
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=1e-4,
                                   err_msg=str(path))


@pytest.mark.parametrize("impl", ["naive", "flash"])
@pytest.mark.parametrize("t", [100, 128])
def test_apply_logits_match_jax(impl, t):
    jcfg, cfg = _cfgs(attention_impl=impl)
    jparams = jget_model(jcfg).init(jax.random.key(1), jcfg)
    ids = np.random.default_rng(1).integers(0, 97, (B, t)).astype(np.int32)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jget_model(jcfg).apply(jparams, jnp.asarray(ids),
                                                 jcfg))
    params = interop.params_from_jax(jax.device_get(jparams), cfg)
    before = dict(fk.plain_calls)
    got = llama.apply(params, torch.from_numpy(ids), cfg)
    assert got.dtype == torch.float32 and got.shape == (B, t, 97)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    # Flash asked for: every layer's attention through the K1 wrapper.
    assert fk.plain_calls["forward"] - before["forward"] == (
        cfg.n_layer if impl == "flash" else 0)


def test_apply_hidden_and_aux_contract():
    jcfg, cfg = _cfgs()
    jparams = jget_model(jcfg).init(jax.random.key(2), jcfg)
    ids = np.random.default_rng(2).integers(0, 97, (B, 32)).astype(np.int32)
    with jax.default_matmul_precision("highest"):
        want, waux = jget_model(jcfg).apply(
            jparams, jnp.asarray(ids), jcfg, return_hidden=True,
            return_aux=True)
    params = interop.params_from_jax(jax.device_get(jparams), cfg)
    got, aux = llama.apply(params, torch.from_numpy(ids), cfg,
                           return_hidden=True, return_aux=True)
    assert got.shape == (B, 32, 64) and float(aux) == float(waux) == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    with pytest.raises(ValueError, match="exceeds n_ctx"):
        llama.apply(params, torch.zeros(1, 129, dtype=torch.long), cfg)


def test_rope_angles_built_on_the_ids_device(monkeypatch):
    """One (cos, sin) per ``apply``, on the ids' device, equal to JAX's."""
    calls = []
    real = llama.rope_angles

    def spy(*a, **kw):
        calls.append(kw.get("device"))
        return real(*a, **kw)

    monkeypatch.setattr(llama, "rope_angles", spy)
    _, cfg = _cfgs(n_layer=3, attention_impl="naive")
    params = llama.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    llama.apply(params, torch.zeros(1, 16, dtype=torch.long), cfg)
    assert calls == [torch.device("cpu")]
    cos, sin = rope_angles(16, 16, 500000.0, device="cpu")
    jcos, jsin = jrope_angles(16, 16, 500000.0)
    np.testing.assert_allclose(cos.numpy(), np.asarray(jcos), atol=1e-6)
    np.testing.assert_allclose(sin.numpy(), np.asarray(jsin), atol=1e-6)


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("fused", [False, True])
def test_three_steps_match_jax(accum, fused):
    jcfg, cfg = _cfgs(fused_head_ce=fused)
    jtx = joptim.make_optimizer(JaxTrainConfig(**TRAIN_KW))
    jparams = jget_model(jcfg).init(jax.random.key(0), jcfg)
    jstate = jinit(jparams, jtx)
    step_j = jax.jit(jstep(jget_model(jcfg), jcfg, jtx, jit=False))
    tx = optim.make_optimizer(TrainConfig(**TRAIN_KW))
    state = init_train_state(
        interop.params_from_jax(jax.device_get(jparams), cfg), tx)
    step_p = make_train_step(get_model(cfg), cfg, tx)
    for batch in _batches(accum):
        with jax.default_matmul_precision("highest"):
            jstate, jm = step_j(jstate, jax.tree.map(jnp.asarray, batch),
                                jax.random.key(0))
        state, m = step_p(state, {k: torch.from_numpy(v)
                                  for k, v in batch.items()})
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-5)
    assert state.step == 3 and int(jstate.step) == 3
    _assert_params_close(state.params, jstate.params, cfg)


# --- remat: the port's kept sets against JAX's saved residuals ------------

RB, RT = 2, 128
REMAT_KW = dict(LLAMA, vocab_size=97, n_ctx=RT, n_embd=128, n_layer=1,
                n_head=2, n_kv_head=1, n_inner=256)
MODES = ("full", "dots", "dots_no_batch", "names", "flash")
# What the port keeps per mode, in forward order, on the naive path and on
# the kernel path.
WANT_LABELS = {
    ("naive", "full"): [], ("flash", "full"): [],
    ("naive", "dots"): ["q", "k", "v", "attn_scores", "attn_out",
                        "attn_proj", "mlp_gate", "mlp_up"],
    ("flash", "dots"): ["q", "k", "v", "attn_proj", "mlp_gate", "mlp_up"],
    ("naive", "dots_no_batch"): ["q", "k", "v", "attn_proj", "mlp_gate",
                                 "mlp_up"],
    ("flash", "dots_no_batch"): ["q", "k", "v", "attn_proj", "mlp_gate",
                                 "mlp_up"],
    ("naive", "names"): ["q", "k", "v", "attn_out", "attn_proj", "mlp_gate",
                         "mlp_up"],
    ("flash", "names"): ["q", "k", "v", "flash", "attn_proj", "mlp_gate",
                         "mlp_up"],
    ("naive", "flash"): [], ("flash", "flash"): ["flash"],
}


@pytest.fixture
def jax_kernel(monkeypatch):
    """The JAX flash path on its Pallas kernel, in interpret mode."""
    flash_mha = jfk.flash_mha
    monkeypatch.setattr(pallas_flash, "_pallas_supported",
                        lambda t, s, d: t == s and t % 128 == 0
                        and d % 64 == 0)
    monkeypatch.setattr(jfk, "flash_mha", lambda *a: flash_mha(
        *a, interpret=True))


def jax_block_residuals(block, args):
    """(sorted (dtype, size) of what backward keeps, pallas_calls in the
    grad jaxpr) of a JAX block under remat."""
    res = saved_residuals(block, *args)
    kept = sorted((str(a.dtype), int(np.prod(a.shape))) for a, what in res
                  if "argument" not in what)
    grad = jax.make_jaxpr(jax.grad(
        lambda x, *rest: block(x, *rest).astype(jnp.float32).sum()))(*args)
    return kept, str(grad).count("pallas_call")


def port_block_kept(monkeypatch, block, x, *rest):
    """(sorted (dtype, size) of the port's ``_Kept`` values, their labels,
    plain K1/K2 calls) for one forward and backward of ``block``."""
    lists = []

    class Recorded(remat._Kept):
        def __init__(self):
            super().__init__()
            lists.append(self)

    monkeypatch.setattr(remat, "_Kept", Recorded)
    before = dict(fk.plain_calls)
    out = block(x, *rest)
    out = out[0] if isinstance(out, tuple) else out
    torch.autograd.grad(out.float().sum(), [x])
    calls = sum(fk.plain_calls[k] - before[k] for k in before)
    values, labels = ([], []) if not lists else (lists[0].values,
                                                 lists[0].labels)
    flat = [t for v in values for t in (v if isinstance(v, tuple) else (v,))]
    kept = sorted((str(t.dtype).replace("torch.", ""), t.numel())
                  for t in flat)
    return kept, labels, calls


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["naive", "flash"])
@pytest.mark.parametrize("mode", MODES)
def test_kept_set_matches_jax_saved_residuals(monkeypatch, jax_kernel, mode,
                                              impl, dtype):
    kw = dict(REMAT_KW, attention_impl=impl, dtype=dtype)
    jcfg, cfg = JaxModelConfig(**kw), ModelConfig(**kw, remat=mode)
    jparams = jllama.init(jax.random.key(0), jcfg)
    jbp = jax.tree.map(lambda a: a[0], jparams["blocks"])
    jx = jax.random.normal(jax.random.key(1), (RB, RT, 128)).astype(dtype)
    jcos, jsin = jrope_angles(RT, 64, jcfg.rope_theta)
    jblock = jremat.apply_remat(
        lambda x, bp, cos, sin: jllama._block(x, bp, jcfg, cos, sin)[0], mode)
    want, pallas_calls = jax_block_residuals(jblock, (jx, jbp, jcos, jsin))

    bp = interop.params_from_jax(jax.device_get(jparams), cfg)["blocks"][0]
    x = torch.randn(RB, RT, 128, generator=torch.Generator().manual_seed(1))
    x = x.to(getattr(torch, dtype)).requires_grad_()
    cos, sin = rope_angles(RT, 64, cfg.rope_theta, device="cpu")
    block = remat.apply_remat(functools.partial(llama._block, cfg=cfg), mode)
    got, labels, calls = port_block_kept(monkeypatch, block, x, bp, cos, sin)
    assert got == want
    assert labels == WANT_LABELS[(impl, mode)]
    assert calls == pallas_calls


def test_grads_equal_under_every_mode():
    def grads(mode):
        _, cfg = _cfgs(remat=mode, n_ctx=32)
        params = llama.init(torch.Generator().manual_seed(3), cfg,
                            device="cpu")
        leaves = [p.requires_grad_() for p in tree.leaves(params)]
        ids = torch.randint(0, 97, (2, 32),
                            generator=torch.Generator().manual_seed(4))
        logits = llama.apply(params, ids, cfg)
        return torch.autograd.grad(logits.square().mean(), leaves)

    ref = grads("none")
    for mode in MODES:
        for a, b in zip(grads(mode), ref):
            torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)


# --- the entry point ------------------------------------------------------


def test_baseline_trains_the_llama_preset(tmp_path, monkeypatch):
    """``--preset llama3-1b`` through ``Trainer`` at the entry point's
    defaults (flash, names, f32 logits, unfused head), the preset narrowed
    here to run on the CPU; the loss falls on the synthetic stream."""
    monkeypatch.setitem(port_config._LLAMA_PRESETS, "llama3-1b", dict(
        vocab_size=301, n_ctx=64, n_embd=32, n_layer=2, n_head=4,
        n_kv_head=2, n_inner=64, rope_theta=500000.0))
    args = ["--device", "cpu", "--preset", "llama3-1b", "--seq-len", "32",
            "--global-batch-size", "8", "--micro-batch-size", "4",
            "--steps", "8", "--log-every", "4", "--lr", "3e-3",
            "--num-train-files", "2", "--data-dir", str(tmp_path / "data"),
            "--checkpoint-dir", str(tmp_path / "ck"), "--save-every", "8",
            "--metrics-out", str(tmp_path / "m.jsonl"),
            "--dtype", "float32"]
    parsed = baseline.parse_args(args)
    cfg = baseline.build_model_cfg(parsed)
    assert (cfg.family, cfg.attention_impl, cfg.remat, cfg.logits_dtype,
            cfg.fused_head_ce) == ("llama", "flash", "names", "float32",
                                   False)
    before = dict(fk.plain_calls)
    assert baseline.main(args) == 0
    # 8 steps x A 2 micro-batches x 2 layers, each through K1 and K2.
    assert fk.plain_calls["forward"] - before["forward"] == 32
    assert fk.plain_calls["backward"] - before["backward"] == 32
    losses = [json.loads(x)["loss"] for x in
              (tmp_path / "m.jsonl").read_text().splitlines()]
    assert len(losses) == 2 and losses[-1] < losses[0]
    assert ckpt.latest_checkpoint(tmp_path / "ck").endswith("step_8")
    defaults = baseline.parse_args(["--preset", "llama3-1b"])
    tc = baseline.build_train_cfg(defaults)
    assert (tc.global_batch_size, tc.micro_batch_size, defaults.seq_len,
            defaults.device) == (32, 8, 1024, "cuda")
