"""The port's sequence-parallel training against the JAX package.

One group of four gloo CPU ranks (``_torch_seq_jobs.job_seq_train``)
runs every case; the JAX side runs in this process meanwhile, under the
8-device CPU fixture, its compiles in threads. Same seeded inputs (numpy;
JAX ``init``'s weights) on both sides, f32, one step at A = 2. The ops
alone: ``tests/test_torch_seq_ops.py``.

- One explicit step against JAX's explicit step on the same mesh, for
  the ring on GPT-2 and Ulysses on Llama with GQA (8 query over 4 KV
  heads), at seq 2 alone, data 2 x seq 2 and fsdp 2 x seq 2
  (full_shard): loss within 1e-5, grad norm and params within 1e-4 (the
  tolerances JAX's ``tests/test_parallel.py`` holds its seq step to). The
  port runs flash attention under ``names`` remat; JAX its test config.
- seq 2 x tensor 2 (Ulysses on GPT-2, the ring on Llama) against JAX's
  single-device step at the same tolerances: JAX's explicit step under a
  tensor axis fails JAX 0.9's ``check_vma`` in this environment (the
  tensor cases of ``tests/test_parallel.py``, slow tier).
- MoE (GPT-2, 4 experts top-2, capacity 4) under the ring: each rank
  routes its own tokens, held to JAX's explicit step.
- The counts a step shows under ``names``: ring exchanges 3 x n_layer x
  A at seq 2 (forward, recompute, backward) and no kernel; under Ulysses
  12 all-to-alls a layer (q, k, v and the output, each in the forward,
  the recompute and the backward), K1 and K2 once a layer (the flash
  op's (o, lse) kept: no K1 in the recompute).
- A global length over ``n_ctx`` raises on every seq rank.
- The sharded checkpoint: saved at fsdp 2 x seq 2, restored at seq 1
  bit for bit (only seq rank 0 of each fsdp index writes), and back.
- The ``DistributedTrainer``'s loop at data 2 x seq 2 with the anomaly
  guard: a corrupt batch skipped on every rank alike.
"""

import json
import threading
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest

from _torch_dist_worker import launch
from test_torch_serving_tp import read_outputs
from test_torch_tp_train import _flatten, _init, _save_npz
from pytorch_distributed_tpu.config import MeshConfig as JaxMeshConfig
from pytorch_distributed_tpu.config import ModelConfig as JaxModelConfig
from pytorch_distributed_tpu.config import TrainConfig as JaxTrainConfig
from pytorch_distributed_tpu.models import get_model as jget_model
from pytorch_distributed_tpu.parallel import make_mesh, shard_train_state
from pytorch_distributed_tpu.parallel.explicit import (
    make_explicit_train_step,
)
from pytorch_distributed_tpu.parallel.mesh import make_batch_put
from pytorch_distributed_tpu.train.optim import make_optimizer as jmake_opt
from pytorch_distributed_tpu.train.state import init_train_state as jinit
from pytorch_distributed_tpu.train.trainer import make_train_step as jstep

COMMON = dict(vocab_size=128, n_ctx=16, n_embd=64, n_layer=2, n_head=4,
              dtype="float32", embd_pdrop=0.0, attn_pdrop=0.0,
              resid_pdrop=0.0, attention_impl="flash", remat="names")
MODELS = {
    "gpt2": dict(COMMON, seq_impl="ring"),
    "gpt2_ulysses": dict(COMMON, seq_impl="ulysses"),
    "llama": dict(COMMON, family="llama", n_head=8, n_kv_head=4,
                  n_inner=128, activation_function="silu",
                  seq_impl="ulysses"),
    "llama_ring": dict(COMMON, family="llama", n_head=8, n_kv_head=4,
                       n_inner=128, activation_function="silu"),
    "gpt2_moe": dict(COMMON, n_experts=4, moe_top_k=2,
                     expert_capacity_factor=4.0),
}
# The weights each model's npz holds (the Ulysses and ring variants of a
# family share theirs).
WEIGHTS = {"gpt2": "gpt2", "gpt2_ulysses": "gpt2", "llama": "llama",
           "llama_ring": "llama", "gpt2_moe": "gpt2_moe"}
TRAIN = dict(global_batch_size=16, micro_batch_size=8, num_steps=1,
             learning_rate=1e-3, grad_clip_norm=1.0)
A, B, T = 2, 8, 16
# (name, model, group, mesh, JAX reference): "a" = ranks {0, 1} and "b" =
# {2, 3} run at once, "world" = all four.
STEPS = [
    ("gpt2-ring-seq2", "gpt2", "a", dict(seq=2, strategy="no_shard"),
     "explicit"),
    ("llama-ulysses-seq2", "llama", "b", dict(seq=2, strategy="no_shard"),
     "explicit"),
    ("gpt2-ring-data2xseq2", "gpt2", "world",
     dict(data=2, seq=2, strategy="no_shard"), "explicit"),
    ("gpt2-ring-zero3-fsdp2xseq2", "gpt2", "world",
     dict(fsdp=2, seq=2, strategy="full_shard"), "explicit"),
    ("llama-ulysses-data2xseq2", "llama", "world",
     dict(data=2, seq=2, strategy="no_shard"), "explicit"),
    ("llama-ulysses-zero3-fsdp2xseq2", "llama", "world",
     dict(fsdp=2, seq=2, strategy="full_shard"), "explicit"),
    ("gpt2-ulysses-seq2xtensor2", "gpt2_ulysses", "world",
     dict(seq=2, tensor=2, strategy="no_shard"), "single"),
    ("llama-ring-seq2xtensor2", "llama_ring", "world",
     dict(seq=2, tensor=2, strategy="no_shard"), "single"),
    ("gpt2_moe-ring-seq2", "gpt2_moe", "a", dict(seq=2, strategy="no_shard"),
     "explicit"),
]
STEP_IDS = [c[0] for c in STEPS]
def _jax_cfg(model: str) -> JaxModelConfig:
    kw = {k: v for k, v in MODELS[model].items()
          if k not in ("attention_impl", "remat")}
    return JaxModelConfig(**kw)


def _jax_explicit(model: str, mesh_kw: dict, params, batch) -> dict:
    """JAX's explicit step, once, on a mesh of the first devices."""
    cfg = _jax_cfg(model)
    tcfg = JaxTrainConfig(**TRAIN)
    mcfg = JaxMeshConfig(**mesh_kw)
    mesh = make_mesh(mcfg)
    tx = jmake_opt(tcfg, with_clip=False)
    state, _ = shard_train_state(jinit(params, tx), mesh, mcfg)
    step = make_explicit_train_step(jget_model(cfg), cfg, tx, mesh, mcfg,
                                    state, grad_clip_norm=TRAIN[
                                        "grad_clip_norm"])
    with jax.default_matmul_precision("highest"):
        state, m = step(state, make_batch_put(mesh, mcfg)(
            {k: v.astype(np.int32) for k, v in batch.items()}),
            jax.random.key(0))
    flat: dict = {}
    _flatten("params", jax.device_get(state.params), flat)
    return dict(loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
                params=flat)


def _init_model(model: str):
    cfg = _jax_cfg(model)
    return jax.device_get(jget_model(cfg).init(jax.random.key(0), cfg))


def _jax_single(model: str, params, batch) -> dict:
    """JAX's single-device step on ``model``'s config, once."""
    cfg = _jax_cfg(model)
    tx = jmake_opt(JaxTrainConfig(**TRAIN))
    with jax.default_matmul_precision("highest"):
        state, m = jstep(jget_model(cfg), cfg, tx, donate=False)(
            jinit(params, tx),
            {k: v.astype(np.int32) for k, v in batch.items()},
            jax.random.key(0))
    flat: dict = {}
    _flatten("params", jax.device_get(state.params), flat)
    return dict(loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
                params=flat)


@pytest.fixture(scope="module")
def runs(tmp_path_factory, eight_devices):
    """Write the inputs, start the port's ranks, run JAX meanwhile."""
    wd = tmp_path_factory.mktemp("seq_train")
    params = {w: _init_model(w) for w in set(WEIGHTS.values())}
    for w, p in params.items():
        _save_npz(wd / f"{w}.npz", p)
    for m, w in WEIGHTS.items():
        if m != w:
            (wd / f"{m}.npz").symlink_to(wd / f"{w}.npz")
    _save_npz(wd / "other.npz", _init("gpt2", seed=3))
    rng = np.random.default_rng(0)
    batch = dict(inputs=rng.integers(0, 128, (A, B, T)),
                 targets=rng.integers(0, 128, (A, B, T)))
    np.savez(wd / "batch.npz", **batch)
    (wd / "spec.json").write_text(json.dumps(dict(
        models=MODELS, train=TRAIN,
        steps=[dict(name=n, model=m, group=g, mesh=k)
               for n, m, g, k, _ in STEPS])))
    box: dict = {}
    th = threading.Thread(target=lambda: box.update(
        results=launch("seq_train", 4, wd, timeout_s=300)))
    th.start()

    def reference(case):
        _, model, _, mesh_kw, ref = case
        p = params[WEIGHTS[model]]
        return (_jax_explicit(model, mesh_kw, p, batch) if ref == "explicit"
                else _jax_single(model, p, batch))

    with ThreadPoolExecutor(4) as ex:  # JAX compiles in parallel
        want = dict(zip(STEP_IDS, ex.map(reference, STEPS)))
    th.join()
    assert "results" in box, "the port's ranks did not finish"
    return wd, want, read_outputs(wd, box["results"], n=4)


@pytest.mark.parametrize("case", STEPS, ids=STEP_IDS)
def test_seq_step_matches_jax(runs, case):
    wd, want, outs = runs
    name, group = case[0], case[2]
    ranks = {"a": (0, 1), "b": (2, 3), "world": (0, 1, 2, 3)}[group]
    got = [outs[r]["steps"][name] for r in ranks]
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


@pytest.mark.parametrize("case", STEPS, ids=STEP_IDS)
def test_seq_step_counts(runs, case):
    """A step at A = 2 under ``names``: the ring's 3 x n_layer x A
    exchanges and no kernel; Ulysses' 12 x n_layer x A all-to-alls and
    K1 = K2 = n_layer x A (the kept (o, lse): no K1 in the recompute)."""
    _, _, outs = runs
    name, model, group = case[0], case[1], case[2]
    ranks = {"a": (0, 1), "b": (2, 3), "world": (0, 1, 2, 3)}[group]
    layers = COMMON["n_layer"] * A
    ulysses = MODELS[model].get("seq_impl") == "ulysses"
    for r in ranks:
        c = {k: outs[r]["steps"][name][k]
             for k in ("exchanges", "all_to_alls", "k1", "k2")}
        if ulysses:
            assert c == dict(exchanges=0, all_to_alls=12 * layers,
                             k1=layers, k2=layers)
        else:
            assert c == dict(exchanges=3 * layers, all_to_alls=0, k1=0,
                             k2=0)


def test_seq_checkpoint_round_trip(runs):
    _, _, outs = runs
    for o in outs:
        ck = o["ckpt"]
        assert ck["seq2_to_seq1_bit_equal"], o["rank"]
        assert ck["seq1_to_seq2_bit_equal"], o["rank"]
        assert ck["seq1_to_seq2_step"] == 1
    # seq rank 0 of each fsdp index writes: one file per fsdp shard
    assert outs[0]["ckpt"]["seq2_files"] == ["index.json", "shard_0.npz",
                                             "shard_1.npz"]


def test_global_length_over_n_ctx_raises(runs):
    _, _, outs = runs
    for o in outs[:2]:
        assert "sequence length 32 exceeds n_ctx 16" in o["overflow"]


def test_guarded_loop_at_data2xseq2_decides_alike(runs):
    """The anomaly guard skips the corrupt batch on every rank alike: its
    flag is summed over the mesh, and the loss and norm are the same on
    every seq rank."""
    _, _, outs = runs
    guards = [o["guard"] for o in outs]
    assert all(g["anomalies"] == 1 for g in guards), guards
    assert all(g == guards[0] for g in guards)
    assert np.isfinite(guards[0]["losses"]).all()
