"""The port's tensor-parallel training against the JAX package.

The same seeded weights (JAX ``init``) and batch go through the port's
``make_parallel_train_step`` on gloo CPU ranks (one group of four
processes runs every case, ``_torch_tp_jobs.job_tp_train``; the JAX side
runs in this process meanwhile) and through the JAX package's
single-device ``make_train_step``: one step at A = 2, f32, clip 1.0, no
dropout; the port at flash attention (the kernels' plain versions here)
and ``names`` remat. The tolerances are those JAX's own tests hold its
explicit TP step to against that single-device step
(``tests/test_parallel.py``): loss within 1e-5, grad norm within 1e-4,
every param within 1e-4. JAX's explicit TP step itself is not the
reference here: under JAX 0.9 its ``check_vma`` typing refuses
``tp_copy``'s custom VJP (``test_parallel.py``'s tensor cases, in the
slow tier, fail so in this environment), and JAX holds that step to the
same single-device step anyway. JAX's side runs at its own test config
(naive attention, its default remat: ``_jax_cfg``); neither changes a
value beyond summation order.

- GPT-2 (JAX's tiny config: E 64, 4 heads): tensor 4 alone, data 2 x
  tensor 2, and ZeRO-1/2/3 at fsdp 2 x tensor 2.
- Llama with GQA (4 q over 2 KV heads, SwiGLU): tensor 2 alone (tensor 4
  does not divide its 2 KV heads, in JAX either), data 2 x tensor 2,
  ZeRO-2/3 at fsdp 2 x tensor 2.
- MoE (capacity factor 4, so no token drops): GPT-2 with 4 experts top-2
  and Llama with gated experts, each at tensor 2 (TP inside each expert;
  the batch is not split, as the Switch aux term of split batches is
  not the single-device one).
- ``names`` remat issues one all-reduce per row-parallel projection in the
  forward and one per ``tp_copy`` in the backward, none in the recompute:
  4 x n_layer x A on a dense model.
- Attention dropout: refused under ``tensor_dropout="reject"`` as JAX
  refuses it; under "folded" held to the port itself (the same seed gives
  the same masks, and the masks act).
- The sharded checkpoint at fsdp 2 x tensor 2 restores at tensor 1 bit
  for bit, and onto data 2 x tensor 2; JAX's npz restores at tensor 2.
- The ``DistributedTrainer``'s loop at tensor 4 with the anomaly guard
  skips a corrupt batch on every rank alike.
- The ``train.parallel`` twin trains at tensor 2 on two CPU ranks it
  starts itself, and refuses the axes and paths not ported.
"""

import dataclasses
import json
import threading

import jax
import numpy as np
import pytest

from _torch_dist_worker import launch
from test_torch_serving_tp import read_outputs
from pytorch_distributed_tpu.config import MeshConfig as JaxMeshConfig
from pytorch_distributed_tpu.config import ModelConfig as JaxModelConfig
from pytorch_distributed_tpu.config import TrainConfig as JaxTrainConfig
from pytorch_distributed_tpu.models import get_model as jget_model
from pytorch_distributed_tpu.parallel import make_mesh, shard_train_state
from pytorch_distributed_tpu.parallel.explicit import (
    make_explicit_train_step,
)
from pytorch_distributed_tpu.train import checkpoint as jckpt
from pytorch_distributed_tpu.train.optim import make_optimizer as jmake_opt
from pytorch_distributed_tpu.train.state import init_train_state as jinit
from pytorch_distributed_tpu.train.trainer import make_train_step as jstep
from pytorch_distributed_tpu_torch.config import (
    MeshConfig,
    ModelConfig,
    TrainConfig,
)
from pytorch_distributed_tpu_torch.models import get_model
from pytorch_distributed_tpu_torch.parallel.api import (
    make_parallel_train_step,
)
from pytorch_distributed_tpu_torch.train.checkpoint import _flatten
from pytorch_distributed_tpu_torch.train.optim import make_optimizer
from pytorch_distributed_tpu_torch.utils import prng

COMMON = dict(vocab_size=128, n_ctx=16, n_embd=64, n_layer=2, n_head=4,
              dtype="float32", embd_pdrop=0.0, attn_pdrop=0.0,
              resid_pdrop=0.0, attention_impl="flash", remat="names")
MODELS = {
    "gpt2": dict(COMMON),
    "llama": dict(COMMON, family="llama", n_kv_head=2, n_inner=128,
                  activation_function="silu"),
    "gpt2_moe": dict(COMMON, n_experts=4, moe_top_k=2,
                     expert_capacity_factor=4.0),
    "llama_moe": dict(COMMON, family="llama", n_kv_head=2, n_inner=128,
                      activation_function="silu", n_experts=4, moe_top_k=2,
                      expert_capacity_factor=4.0),
}
TRAIN = dict(global_batch_size=16, micro_batch_size=8, num_steps=1,
             learning_rate=1e-3, grad_clip_norm=1.0)
A, B, T = 2, 8, 16
# (name, model, group, mesh): "a" = ranks {0, 1} and "b" = {2, 3} run at
# once, "world" = all four.
CASES = [
    ("gpt2-tensor4", "gpt2", "world", dict(tensor=4, strategy="no_shard")),
    ("gpt2-data2xtensor2", "gpt2", "world",
     dict(data=2, tensor=2, strategy="no_shard")),
    ("gpt2-zero1-fsdp2xtensor2", "gpt2", "world",
     dict(fsdp=2, tensor=2, strategy="shard_opt")),
    ("gpt2-zero2-fsdp2xtensor2", "gpt2", "world",
     dict(fsdp=2, tensor=2, strategy="shard_grad_op")),
    ("gpt2-zero3-fsdp2xtensor2", "gpt2", "world",
     dict(fsdp=2, tensor=2, strategy="full_shard")),
    ("llama-tensor2", "llama", "a", dict(tensor=2, strategy="no_shard")),
    ("gpt2_moe-tensor2", "gpt2_moe", "b",
     dict(tensor=2, strategy="no_shard")),
    ("llama-data2xtensor2", "llama", "world",
     dict(data=2, tensor=2, strategy="no_shard")),
    ("llama-zero2-fsdp2xtensor2", "llama", "world",
     dict(fsdp=2, tensor=2, strategy="shard_grad_op")),
    ("llama-zero3-fsdp2xtensor2", "llama", "world",
     dict(fsdp=2, tensor=2, strategy="full_shard")),
    ("llama_moe-tensor2", "llama_moe", "a",
     dict(tensor=2, strategy="no_shard")),
]
CASE_IDS = [c[0] for c in CASES]
DENSE_TP_ALLREDUCES = 4 * COMMON["n_layer"] * A


def _init(model: str, seed: int = 0):
    cfg = JaxModelConfig(**MODELS[model])
    return jax.device_get(jget_model(cfg).init(jax.random.key(seed), cfg))


def _save_npz(path, params) -> None:
    flat: dict = {}
    _flatten("params", params, flat)
    np.savez(path, **flat)


def _jax_cfg(model: str) -> JaxModelConfig:
    """JAX's side at JAX's own test config: naive attention and its
    default remat. Its flash path's custom VJP is refused by ``check_vma``
    under a tensor axis in this JAX version; neither changes a value
    beyond summation order, and the port runs flash and ``names``."""
    kw = {k: v for k, v in MODELS[model].items()
          if k not in ("attention_impl", "remat")}
    return JaxModelConfig(**kw)


def _jax_step(model: str, params, batch):
    """JAX's single-device step, once: (state, metrics)."""
    cfg = _jax_cfg(model)
    tx = jmake_opt(JaxTrainConfig(**TRAIN))
    with jax.default_matmul_precision("highest"):
        state, m = jstep(jget_model(cfg), cfg, tx, donate=False)(
            jinit(params, tx),
            {k: v.astype(np.int32) for k, v in batch.items()},
            jax.random.key(0))
    return jax.device_get(state), m


def _jax_case(model: str, params, batch) -> dict:
    """Loss, grad norm and params after JAX's single-device step."""
    state, m = _jax_step(model, params, batch)
    flat: dict = {}
    _flatten("params", state.params, flat)
    return dict(loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
                params=flat)


def _jax_checkpoint(workdir, params, batch) -> dict:
    """JAX's single-device step on GPT-2, saved as the JAX package's npz;
    returns its params and Adam mu (flat JAX keys)."""
    state, _ = _jax_step("gpt2", params, batch)
    jckpt.save_checkpoint(workdir / "jax_ckpt", state, format="npz")
    out: dict = {"params": {}, "mu": {}}
    _flatten("params", state.params, out["params"])
    _flatten("params", state.opt_state[1].mu, out["mu"])
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Write the inputs, start the port's ranks, run JAX meanwhile."""
    wd = tmp_path_factory.mktemp("tp_train")
    params = {m: _init(m) for m in MODELS}
    for m, p in params.items():
        _save_npz(wd / f"{m}.npz", p)
    _save_npz(wd / "other.npz", _init("gpt2", seed=3))
    rng = np.random.default_rng(0)
    batch = dict(inputs=rng.integers(0, 128, (A, B, T)),
                 targets=rng.integers(0, 128, (A, B, T)))
    np.savez(wd / "batch.npz", **batch)
    (wd / "spec.json").write_text(json.dumps(dict(
        models=MODELS, train=TRAIN,
        cases=[dict(name=n, model=m, group=g, mesh=k)
               for n, m, g, k in CASES])))
    jax_ckpt = _jax_checkpoint(wd, params["gpt2"], batch)
    box: dict = {}
    th = threading.Thread(target=lambda: box.update(
        results=launch("tp_train", 4, wd, timeout_s=400)))
    th.start()
    by_model = {m: _jax_case(m, params[m], batch) for m in MODELS}
    want = {n: by_model[m] for n, m, _, _ in CASES}
    th.join()
    assert "results" in box, "the port's ranks did not finish"
    return wd, want, read_outputs(wd, box["results"], n=4), jax_ckpt


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_tp_step_matches_jax(runs, case):
    wd, want, outs, _ = runs
    name, group = case[0], case[2]
    ranks = {"a": (0, 1), "b": (2, 3), "world": (0, 1, 2, 3)}[group]
    got = [outs[r]["cases"][name] for r in ranks]
    w = want[name]
    for g in got:  # every rank reports the same global loss and norm
        assert g["loss"] == got[0]["loss"]
        assert g["grad_norm"] == got[0]["grad_norm"]
    assert got[0]["loss"] == pytest.approx(w["loss"], abs=1e-5)
    assert got[0]["grad_norm"] == pytest.approx(w["grad_norm"], abs=1e-4)
    with np.load(wd / f"params_{name}.npz") as f:
        assert sorted(f.files) == sorted(w["params"])
        for k in f.files:
            np.testing.assert_allclose(f[k], np.asarray(w["params"][k]),
                                       atol=1e-4, err_msg=k)


@pytest.mark.parametrize("name", [n for n, m, _, _ in CASES
                                  if not m.endswith("moe")])
def test_names_remat_issues_one_allreduce_per_projection(runs, name):
    """Forward: attn_proj and mlp_proj, one each a layer; backward: the
    two ``tp_copy``s a layer; the recompute of a ``names`` block none."""
    _, _, outs, _ = runs
    counts = {o["cases"][name]["tp_collectives"] for o in outs
              if name in o["cases"]}
    assert counts == {DENSE_TP_ALLREDUCES}


def test_names_recompute_with_dropout_issues_no_second_allreduce(runs):
    """With residual dropout the recompute of a ``names`` block runs past
    ``mlp_proj`` (the masks are saved); its sum is not issued again."""
    _, _, outs, _ = runs
    assert [o["resid_dropout_tp_collectives"] for o in outs[2:]] == \
        [DENSE_TP_ALLREDUCES] * 2


def test_folded_attention_dropout_is_held_to_the_port(runs):
    _, _, outs, _ = runs
    for o in outs[:2]:
        a, b, det = o["folded_losses"]
        assert a == b  # the same seed: the same masks
        assert o["folded_params_sha"][0] == o["folded_params_sha"][1]
        assert abs(a - det) > 1e-4  # the masks act
    assert outs[0]["folded_losses"] == outs[1]["folded_losses"]


def test_folded_key_changes_the_attention_masks_only():
    key = prng.DropoutKey(1, 2, 0, 0)
    ranks = [key._replace(tensor=1 + t) for t in range(2)]
    for site, layer in (("embd", prng.EMBD_LAYER), ("resid_attn", 0),
                        ("resid_mlp", 1)):
        seeds = {prng.stream_seed(prng.stream_id(k, layer, site))
                 for k in (key, *ranks)}
        assert len(seeds) == 1, site
    seeds = {prng.stream_seed(prng.stream_id(k, 0, "attn"))
             for k in (key, *ranks)}
    assert len(seeds) == 3
    # a batch shard's fold and a tensor fold never meet
    assert prng.stream_seed(prng.stream_id(
        key._replace(shard=2), 0, "attn")) != prng.stream_seed(
        prng.stream_id(key._replace(tensor=2), 0, "attn"))


def test_attention_dropout_under_tensor_is_refused_as_in_jax():
    kw = dict(MODELS["gpt2"], attn_pdrop=0.1)
    tcfg = TrainConfig(**TRAIN)
    mcfg = MeshConfig(tensor=2, strategy="no_shard")
    cfg = ModelConfig(**kw)
    with pytest.raises(NotImplementedError, match="tensor_dropout"):
        make_parallel_train_step(get_model(cfg), cfg, make_optimizer(tcfg),
                                 None, mcfg, None)
    jcfg = JaxModelConfig(**kw)
    jm = JaxMeshConfig(tensor=2, strategy="no_shard")
    mesh = make_mesh(jm)
    tx = jmake_opt(JaxTrainConfig(**TRAIN), with_clip=False)
    state, _ = shard_train_state(jinit(_init("gpt2"), tx), mesh, jm)
    with pytest.raises(NotImplementedError, match="tensor_dropout"):
        make_explicit_train_step(jget_model(jcfg), jcfg, tx, mesh, jm, state)
    # Llama draws no dropout: its default pdrops are never refused.
    lcfg = ModelConfig(**dict(MODELS["llama"], attn_pdrop=0.1))
    with pytest.raises(AttributeError):  # past the refusal, at the mesh
        make_parallel_train_step(get_model(lcfg), lcfg,
                                 make_optimizer(tcfg), None, mcfg, None)
    assert dataclasses.replace(cfg, tensor_dropout="folded")


def test_tensor2_checkpoint_restores_at_tensor1_bit_equal(runs):
    _, _, outs, _ = runs
    for o in outs:
        ck = o["ckpt"]
        assert ck["tp_orbax_tensor1_bit_equal"], o["rank"]
        assert ck["tp_npz_tensor1_bit_equal"], o["rank"]
        assert ck["tp_orbax_step"] == ck["tp_npz_step"] == 1
        assert ck["onto_data2_tensor2_bit_equal"], o["rank"]
    # every rank's blocks were written: one file per (fsdp, tensor) point
    assert outs[0]["ckpt"]["grid"] == {"fsdp": 2, "tensor": 2}
    assert outs[0]["ckpt"]["files"] == [
        "index.json", "shard_0.npz", "shard_1.npz", "shard_2.npz",
        "shard_3.npz"]


def test_jax_npz_restores_at_tensor2(runs):
    wd, _, outs, want = runs
    assert {o["ckpt"]["jax_step"] for o in outs} == {1}
    for name, key in (("jax_ckpt_params.npz", "params"),
                      ("jax_ckpt_mu.npz", "mu")):
        with np.load(wd / name) as f:
            assert sorted(f.files) == sorted(want[key])
            for k in f.files:
                np.testing.assert_array_equal(f[k], want[key][k],
                                              err_msg=k)


def test_parallel_twin_trains_at_tensor2_on_cpu_ranks(tmp_path):
    """``python -m pytorch_distributed_tpu_torch.train.parallel
    --cpu-devices 2 --mesh tensor=2``: the twin starts its two gloo ranks
    through the port's launcher; rank 0 logs its last step."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    proc = subprocess.run(
        [sys.executable, "-m", "pytorch_distributed_tpu_torch.train.parallel",
         "--cpu-devices", "2", "--mesh", "tensor=2",
         "--strategy", "no_shard", "--preset", "tiny", "--seq-len", "32",
         "--global-batch-size", "4", "--micro-batch-size", "2",
         "--steps", "2", "--log-every", "1", "--no-dropout",
         "--no-profiler", "--num-train-files", "2",
         "--data-dir", str(tmp_path / "data"),
         "--checkpoint-dir", str(tmp_path / "ckpt")],
        cwd=tmp_path, capture_output=True, text=True, timeout=240,
        env=dict(os.environ, PYTHONPATH=str(root), OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = proc.stdout + proc.stderr
    assert "mesh={'pipe': 1, 'data': 1, 'fsdp': 1, 'expert': 1, 'seq': 1, " \
           "'tensor': 2}" in out, out[-3000:]
    assert "done:" in out, out[-3000:]


@pytest.mark.parametrize("argv, item", [
    (["--mesh", "seq=2", "--preset", "tiny"], "ring-attention"),
    (["--mesh", "pipe=2"], "--path pipeline"),
    (["--mesh", "expert=2"], "n_experts > 0"),
    (["--mesh", "expert=3", "--n-experts", "4"], "not divisible by expert=3"),
    (["--path", "pipeline"], "requires a pipe>1 mesh axis"),
    (["--mesh", "pipe=3", "--path", "pipeline", "--pipe-schedule", "1f1b",
      "--preset", "tiny"], "not divisible by pipe=3"),
    (["--mesh", "seq=8", "--seq-impl", "ulysses", "--preset", "tiny",
      "--no-dropout"], "divide both head counts"),
], ids=["seq", "pipe", "expert", "expert_count", "pipeline", "1f1b",
        "ulysses"])
def test_parallel_twin_refuses_what_is_not_ported(argv, item):
    """What the twin refuses before any rank starts: since every axis is
    ported (the seq, pipe and expert axes are items 7(c), 7(d), 7(e)),
    what the explicit and pipeline steps refuse, as JAX does: the ring
    with attention dropout (the tiny preset draws it), Ulysses with a seq
    size that does not divide the heads (tiny: 4), a pipe axis off
    ``--path pipeline`` and that path without one, a layer count (tiny:
    2) the stages do not divide, an expert axis without ``--n-experts``
    and an expert count the axis does not divide."""
    from pytorch_distributed_tpu_torch.train import parallel

    with pytest.raises(SystemExit, match=item.replace("(", r"\(")
                       .replace(")", r"\)")):
        parallel.main(["--cpu-devices", "2", *argv])


def test_parallel_twin_refuses_attention_dropout_under_tensor():
    from pytorch_distributed_tpu_torch.train import parallel

    with pytest.raises(SystemExit, match="--no-dropout"):
        parallel.main(["--cpu-devices", "2", "--mesh", "tensor=2",
                       "--preset", "tiny"])


def test_trainer_loop_at_tensor4_guard_decides_alike(runs):
    _, _, outs, _ = runs
    guards = [o["guard"] for o in outs]
    assert all(g["anomalies"] == 1 for g in guards), guards
    assert all(g == guards[0] for g in guards)
    assert np.isfinite(guards[0]["losses"]).all()
