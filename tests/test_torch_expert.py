"""The port's expert parallelism against the JAX package: ``moe_mlp``'s
all-to-all exchange and the explicit step's expert axis.

One group of four gloo CPU ranks (``_torch_expert_jobs.job_expert``)
runs every case; the JAX side runs in this process meanwhile, under the
8-device CPU fixture, its compiles in threads, each reference compiled
once (``_torch_pipe_cases.run_once``). Same seeded inputs on both sides
(numpy; the port's ``init``'s weights as JAX's stacked tree), f32, at
JAX's expert-parallel test shape (``tests/test_moe.py``: vocab 128,
n_ctx 16, E 64, 2 layers, 4 heads, Llama 2 KV heads, 4 experts,
capacity factor 8.0, so nothing drops).

- ``moe_mlp`` under an expert group of 2 and of 4 ranks against JAX's
  under ``shard_map``: einsum and sort dispatch, top-1 and top-2, dense
  and gated experts, generous and dropping capacity. Each rank's output
  and aux term within 1e-5, the gradients of sum(out^2) + 0.01 aux (x,
  the experts, the router summed over the ranks) within 1e-4; 4
  all-to-alls a call (2 forward, 2 backward).
- One explicit step against JAX's explicit step on the same mesh: expert
  4; expert 2 x data 2; expert 2 x fsdp 2 under every strategy
  (full_shard with and without the prefetch window, shard_grad_op with
  and without ``rs_buckets``, shard_opt); expert 2 x seq 2 (the ring);
  Llama's gated experts; the sort dispatch; the aux term on. Loss within
  2e-5, grad norm and params within 1e-4 (JAX's ``tests/test_moe.py``
  tolerances); the aux-on loss also within 1e-3 of JAX's single-device
  step (the Switch term is per token shard under expert parallelism).
- Expert 2 x tensor 2 (GPT-2 and Llama) against JAX's single-device step
  at the same tolerances: JAX's explicit step under a tensor axis fails
  JAX 0.9's ``check_vma`` here (``tests/test_moe.py``'s
  ``test_expert_tensor_composition_matches_single_device``, slow tier),
  as its TP step does.
- The counts a step under ``names``: ``moe.exchanges_per_layer`` (6) x
  n_layer x A all-to-alls, K1 and K2 once a layer and micro-batch (none
  under the ring); the leaves the expert axis does not split bitwise
  equal on every expert rank.
- The sharded checkpoint at expert 2 x fsdp 2: restored on one rank bit
  for bit (one file per fsdp and expert index), and an npz save of it
  restored onto the same layout.
- The placement rules, the refusals, the fold of the expert coordinate
  into the dropout key, and the ``train.parallel`` twin at ``--mesh
  expert=2 --n-experts 4`` on two CPU ranks it starts itself.
"""

import json
import os
import subprocess
import sys
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from _torch_dist_worker import launch
from _torch_pipe_cases import run_once
from test_torch_serving_tp import read_outputs
from test_torch_tp_train import _flatten, _save_npz
from pytorch_distributed_tpu.config import MeshConfig as JaxMeshConfig
from pytorch_distributed_tpu.config import ModelConfig as JaxModelConfig
from pytorch_distributed_tpu.config import TrainConfig as JaxTrainConfig
from pytorch_distributed_tpu.models import get_model as jget_model
from pytorch_distributed_tpu.ops.moe import moe_mlp as jmoe_mlp
from pytorch_distributed_tpu.parallel import make_mesh, shard_train_state
from pytorch_distributed_tpu.parallel.explicit import (
    make_explicit_train_step,
)
from pytorch_distributed_tpu.parallel.mesh import make_batch_put
from pytorch_distributed_tpu.parallel.sharding import (
    param_partition_specs as jparam_specs,
)
from pytorch_distributed_tpu.train.optim import make_optimizer as jmake_opt
from pytorch_distributed_tpu.train.state import init_train_state as jinit
from pytorch_distributed_tpu.train.trainer import make_train_step as jstep
from pytorch_distributed_tpu.utils.compat import shard_map
from pytorch_distributed_tpu_torch import interop
from pytorch_distributed_tpu_torch.config import (
    MeshConfig,
    ModelConfig,
    TrainConfig,
)
from pytorch_distributed_tpu_torch.models import get_model
from pytorch_distributed_tpu_torch.ops import moe
from pytorch_distributed_tpu_torch.parallel import mesh as pmesh
from pytorch_distributed_tpu_torch.parallel.explicit import check_expert
from pytorch_distributed_tpu_torch.parallel.sharding import (
    param_partition_specs,
)
from pytorch_distributed_tpu_torch.utils import tree
from pytorch_distributed_tpu_torch.utils.prng import DropoutKey

ROOT = Path(__file__).resolve().parents[1]
W = "world"
RANKS = {"a": (0, 1), "b": (2, 3), W: (0, 1, 2, 3)}

# -- the op ------------------------------------------------------------------

# (name, ranks, dispatch, top_k, capacity factor, gated) over x [2 n, 8, 16]
# and 4 experts of F 32.
OPS = [
    ("einsum-n2-top1", 2, "einsum", 1, 8.0, False),
    ("einsum-n2-top2-gated", 2, "einsum", 2, 8.0, True),
    ("sort-n2-top2", 2, "sort", 2, 8.0, False),
    ("sort-n2-top2-dropping", 2, "sort", 2, 0.5, False),
    ("sort-n4-top1-gated", 4, "sort", 1, 8.0, True),
    ("einsum-n4-top2", 4, "einsum", 2, 8.0, False),
    ("einsum-n4-top2-dropping", 4, "einsum", 2, 0.5, False),
]
OP_IDS = [c[0] for c in OPS]
OD, OX, OF, OT = 16, 4, 32, 8


def _op_inputs(rng) -> dict:
    out = {}
    for name, n, _, _, _, gated in OPS:
        out[f"{name}_x"] = rng.standard_normal((2 * n, OT, OD))
        out[f"{name}_router"] = rng.standard_normal((OD, OX))
        out[f"{name}_w_in"] = 0.1 * rng.standard_normal((OX, OD, OF))
        out[f"{name}_w_out"] = 0.1 * rng.standard_normal((OX, OF, OD))
        if gated:
            out[f"{name}_w_gate"] = 0.1 * rng.standard_normal((OX, OD, OF))
    return {k: v.astype(np.float32) for k, v in out.items()}


def _jax_op(c, arrays, devices) -> dict:
    """JAX's ``moe_mlp`` under ``shard_map`` over ``n`` devices on the
    expert axis: each device's output and aux term, and the gradients of
    sum(out^2) + 0.01 sum(aux)."""
    name, n, dispatch, top_k, cf, _ = c
    mesh = Mesh(np.array(devices[:n]), axis_names=("expert",))
    params = {k: arrays[f"{name}_{k}"] for k in ("router", "w_in", "w_gate",
                                                  "w_out")
              if f"{name}_{k}" in arrays}
    specs = {k: P() if k == "router" else P("expert") for k in params}

    def op(x, p):
        y, aux = jmoe_mlp(x, p, activation=jax.nn.gelu, capacity_factor=cf,
                          expert_axis="expert", top_k=top_k,
                          dispatch_impl=dispatch)
        return y, aux[None]

    fn = shard_map(op, mesh=mesh, in_specs=(P("expert"), specs),
                   out_specs=(P("expert"), P("expert")))

    def loss(x, p):
        y, aux = fn(x, p)
        return jnp.sum(jnp.square(y)) + 0.01 * jnp.sum(aux), (y, aux)

    (_, (y, aux)), (dx, dp) = run_once(
        jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)),
        arrays[f"{name}_x"], params)
    return dict(out=np.asarray(y), aux=np.asarray(aux), dx=np.asarray(dx),
                **{f"d_{k}": np.asarray(v) for k, v in dp.items()})


# -- the step ----------------------------------------------------------------

COMMON = dict(vocab_size=128, n_ctx=16, n_embd=64, n_layer=2, n_head=4,
              dtype="float32", embd_pdrop=0.0, attn_pdrop=0.0,
              resid_pdrop=0.0, attention_impl="flash", remat="names",
              n_experts=4, expert_capacity_factor=8.0, moe_aux_coef=0.0)
MODELS = {
    "gpt2_moe": dict(COMMON, moe_top_k=2),
    "gpt2_moe_sort": dict(COMMON, moe_top_k=2, moe_dispatch="sort"),
    "gpt2_moe_aux": dict(COMMON, moe_top_k=2, moe_aux_coef=0.01),
    "llama_moe": dict(COMMON, family="llama", n_kv_head=2,
                      activation_function="silu"),
}
WEIGHTS = {"gpt2_moe": "gpt2_moe.npz", "gpt2_moe_sort": "gpt2_moe.npz",
           "gpt2_moe_aux": "gpt2_moe.npz", "llama_moe": "llama_moe.npz"}
TRAIN = dict(global_batch_size=16, micro_batch_size=8, num_steps=1,
             learning_rate=1e-3, grad_clip_norm=1.0)
A, B, T = 2, 8, 16
FSDP2 = dict(expert=2, fsdp=2)
# (name, model, group, mesh, JAX reference): "a" and "b" run at once. A
# reference "=case" is that case's: the same step by another route (the
# sort dispatch, the prefetch window, bucketed scatters, ZeRO-1 against
# DDP over the same rows), so one compile serves both.
STEPS = [
    ("llama-expert2", "llama_moe", "a",
     dict(expert=2, strategy="no_shard"), "explicit"),
    ("gpt2-expert2", "gpt2_moe", "b",
     dict(expert=2, strategy="no_shard"), "explicit"),
    ("gpt2_aux-expert2", "gpt2_moe_aux", "a",
     dict(expert=2, strategy="no_shard"), "explicit"),
    ("gpt2_sort-expert2", "gpt2_moe_sort", "b",
     dict(expert=2, strategy="no_shard"), "=gpt2-expert2"),
    ("gpt2-expert4", "gpt2_moe", W, dict(expert=4, strategy="no_shard"),
     "explicit"),
    ("gpt2-expert2xdata2", "gpt2_moe", W,
     dict(data=2, expert=2, strategy="no_shard"), "explicit"),
    ("gpt2-expert2xfsdp2-full_shard", "gpt2_moe", W,
     dict(FSDP2, strategy="full_shard"), "explicit"),
    ("gpt2-expert2xfsdp2-full_shard-prefetch1", "gpt2_moe", W,
     dict(FSDP2, strategy="full_shard", prefetch_buffers=1),
     "=gpt2-expert2xfsdp2-full_shard"),
    ("gpt2-expert2xfsdp2-shard_grad_op", "gpt2_moe", W,
     dict(FSDP2, strategy="shard_grad_op"), "explicit"),
    ("gpt2-expert2xfsdp2-shard_grad_op-rs2", "gpt2_moe", W,
     dict(FSDP2, strategy="shard_grad_op", rs_buckets=2),
     "=gpt2-expert2xfsdp2-shard_grad_op"),
    ("gpt2-expert2xfsdp2-shard_opt", "gpt2_moe", W,
     dict(FSDP2, strategy="shard_opt"), "=gpt2-expert2xdata2"),
    ("gpt2-ring-expert2xseq2", "gpt2_moe", W,
     dict(expert=2, seq=2, strategy="no_shard"), "explicit"),
    ("gpt2-expert2xtensor2", "gpt2_moe", W,
     dict(expert=2, tensor=2, strategy="no_shard"), "single"),
    ("llama-expert2xtensor2", "llama_moe", W,
     dict(expert=2, tensor=2, strategy="no_shard"), "single"),
]
STEP_IDS = [c[0] for c in STEPS]


def _jax_cfg(model: str) -> JaxModelConfig:
    """JAX at its own test config: naive attention, its default remat."""
    return JaxModelConfig(**{k: v for k, v in MODELS[model].items()
                             if k not in ("attention_impl", "remat")})


def _int_batch(batch):
    return {k: v.astype(np.int32) for k, v in batch.items()}


def _flat_result(state, m) -> dict:
    flat: dict = {}
    _flatten("params", jax.device_get(state.params), flat)
    return dict(loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
                params=flat)


def _jax_explicit(model: str, mesh_kw: dict, params, batch) -> dict:
    """JAX's explicit step, once, on a mesh of the first devices."""
    cfg = _jax_cfg(model)
    mcfg = JaxMeshConfig(**mesh_kw)
    mesh = make_mesh(mcfg)
    tx = jmake_opt(JaxTrainConfig(**TRAIN), with_clip=False)
    state, _ = shard_train_state(jinit(params, tx), mesh, mcfg)
    step = make_explicit_train_step(jget_model(cfg), cfg, tx, mesh, mcfg,
                                    state,
                                    grad_clip_norm=TRAIN["grad_clip_norm"])
    state, m = run_once(step, state,
                        make_batch_put(mesh, mcfg)(_int_batch(batch)),
                        jax.random.key(0))
    return _flat_result(state, m)


def _jax_single(model: str, params, batch) -> dict:
    """JAX's single-device step, once."""
    cfg = _jax_cfg(model)
    tx = jmake_opt(JaxTrainConfig(**TRAIN))
    state, m = run_once(jstep(jget_model(cfg), cfg, tx, donate=False),
                        jinit(params, tx), _int_batch(batch),
                        jax.random.key(0))
    return _flat_result(state, m)


def _init_params(model: str, seed: int = 0) -> dict:
    cfg = ModelConfig(**MODELS[model])
    return interop.params_to_jax(get_model(cfg).init(
        torch.Generator().manual_seed(seed), cfg, device="cpu"), cfg)


def _twin(tmp_path):
    """The ``train.parallel`` twin at ``--mesh expert=2 --n-experts 4`` on
    two CPU ranks, started (it runs beside the fixture's ranks)."""
    return subprocess.Popen(
        [sys.executable, "-m", "pytorch_distributed_tpu_torch.train.parallel",
         "--cpu-devices", "2", "--mesh", "expert=2", "--n-experts", "4",
         "--strategy", "no_shard", "--preset", "tiny", "--seq-len", "32",
         "--global-batch-size", "4", "--micro-batch-size", "2",
         "--steps", "2", "--log-every", "1", "--no-profiler",
         "--num-train-files", "2", "--data-dir", str(tmp_path / "data"),
         "--checkpoint-dir", str(tmp_path / "ckpt")],
        cwd=tmp_path, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True,
        env=dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1"))


@pytest.fixture(scope="module")
def runs(tmp_path_factory, eight_devices):
    """Write the inputs, start the port's ranks and the twin, run JAX
    meanwhile."""
    wd = tmp_path_factory.mktemp("expert")
    twin = _twin(tmp_path_factory.mktemp("expert_twin"))
    try:
        rng = np.random.default_rng(0)
        ops = _op_inputs(rng)
        np.savez(wd / "ops.npz", **ops)
        params = {}
        for model, f in WEIGHTS.items():
            if f not in params:
                params[f] = _init_params(model)
                _save_npz(wd / f, params[f])
        _save_npz(wd / "other.npz", _init_params("gpt2_moe", seed=3))
        batch = dict(inputs=rng.integers(0, 128, (A, B, T)),
                     targets=rng.integers(0, 128, (A, B, T)))
        np.savez(wd / "batch.npz", **batch)
        (wd / "spec.json").write_text(json.dumps(dict(
            models=MODELS, weights=WEIGHTS, train=TRAIN,
            ops=[dict(name=c[0], group="a" if c[1] == 2 else W,
                      dispatch=c[2], top_k=c[3], capacity_factor=c[4])
                 for c in OPS],
            steps=[dict(name=n, model=m, group=g, mesh=k)
                   for n, m, g, k, _ in STEPS])))
        box: dict = {}
        th = threading.Thread(target=lambda: box.update(
            results=launch("expert", 4, wd, timeout_s=300)))
        th.start()

        def step_ref(c):
            _, model, _, mesh_kw, ref = c
            p = params[WEIGHTS[model]]
            return (_jax_explicit(model, mesh_kw, p, batch)
                    if ref == "explicit" else _jax_single(model, p, batch))

        own = [c for c in STEPS if not c[4].startswith("=")]
        with ThreadPoolExecutor(4) as ex:  # JAX compiles in parallel
            want_ops = dict(zip(OP_IDS, ex.map(
                lambda c: _jax_op(c, ops, eight_devices), OPS)))
            aux_single = ex.submit(_jax_single, "gpt2_moe_aux",
                                   params["gpt2_moe.npz"], batch)
            want = dict(zip([c[0] for c in own], ex.map(step_ref, own)))
            want["gpt2_aux-expert2/single"] = aux_single.result()
        for c in STEPS:
            if c[4].startswith("="):
                want[c[0]] = want[c[4][1:]]
        th.join()
        assert "results" in box, "the port's ranks did not finish"
        outs = read_outputs(wd, box["results"], n=4)
        twin_out, _ = twin.communicate(timeout=240)
    finally:
        if twin.poll() is None:
            twin.kill()
            twin.wait()
    return wd, want_ops, want, outs, (twin.returncode, twin_out)


@pytest.mark.parametrize("case", OPS, ids=OP_IDS)
def test_moe_mlp_exchange_matches_jax(runs, case):
    wd, want_ops, _, outs, _ = runs
    name, n = case[0], case[1]
    w = want_ops[name]
    rows = w["out"].shape[0] // n
    router = 0
    for r in RANKS["a" if n == 2 else W]:
        o = outs[r]["ops"][name]
        i = o["index"]
        assert {k: o[k] for k in ("all_to_alls", "k1", "k2")} == dict(
            all_to_alls=4, k1=0, k2=0)
        with np.load(wd / f"op_{name}_{r}.npz") as f:
            got = {k: f[k] for k in f.files}
        sl = slice(i * rows, (i + 1) * rows)
        np.testing.assert_allclose(got["out"], w["out"][sl], atol=1e-5)
        np.testing.assert_allclose(got["aux"], w["aux"][i], atol=1e-5)
        np.testing.assert_allclose(got["dx"], w["dx"][sl], atol=1e-4)
        for k in ("w_in", "w_gate", "w_out"):
            if f"d_{k}" in w:
                per = OX // n
                np.testing.assert_allclose(
                    got[f"d_{k}"], w[f"d_{k}"][i * per:(i + 1) * per],
                    atol=1e-4, err_msg=k)
        router = router + got["d_router"]
    np.testing.assert_allclose(router, w["d_router"], atol=1e-4)


def _check_step(wd, want, got, name, loss_atol=2e-5):
    for g in got:  # every rank reports the same global loss and norm
        assert g["loss"] == got[0]["loss"]
        assert g["grad_norm"] == got[0]["grad_norm"]
    assert got[0]["loss"] == pytest.approx(want["loss"], abs=loss_atol)
    assert got[0]["grad_norm"] == pytest.approx(want["grad_norm"], abs=1e-4)
    with np.load(wd / f"params_{name}.npz") as f:
        assert sorted(f.files) == sorted(want["params"])
        for k in f.files:
            np.testing.assert_allclose(f[k], np.asarray(want["params"][k]),
                                       atol=1e-4, err_msg=k)


@pytest.mark.parametrize("case", STEPS, ids=STEP_IDS)
def test_expert_step_matches_jax(runs, case):
    wd, _, want, outs, _ = runs
    name, group = case[0], case[2]
    got = [outs[r]["steps"][name] for r in RANKS[group]]
    _check_step(wd, want[name], got, name)


def test_expert_aux_on_close_to_single_device(runs):
    """The Switch term per token shard, averaged (JAX's convention, held
    above to JAX's explicit step): the loss within 1e-3 of JAX's
    single-device step, whose term is the whole batch's."""
    _, _, want, outs, _ = runs
    got = outs[0]["steps"]["gpt2_aux-expert2"]["loss"]
    single = want["gpt2_aux-expert2/single"]["loss"]
    assert got == pytest.approx(single, abs=1e-3)
    assert got != single  # the per-shard term: not the global one


def test_expert_prefetch_window_is_bit_equal(runs):
    """The prefetch window only reorders ZeRO-3's gathers: the step is
    bit for bit the one without it."""
    wd, _, _, outs, _ = runs
    a, b = (f"gpt2-expert2xfsdp2-full_shard{x}" for x in ("", "-prefetch1"))
    assert outs[0]["steps"][a]["loss"] == outs[0]["steps"][b]["loss"]
    with np.load(wd / f"params_{a}.npz") as fa, \
            np.load(wd / f"params_{b}.npz") as fb:
        for k in fa.files:
            np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


@pytest.mark.parametrize("case", STEPS, ids=STEP_IDS)
def test_expert_step_counts_and_replicas(runs, case):
    """A step at A = 2 under ``names``: 6 all-to-alls a MoE layer and
    micro-batch, K1 and K2 once (none under the ring); the leaves the
    expert axis does not split equal on every expert rank."""
    _, _, _, outs, _ = runs
    name, model, group, mesh_kw = case[:4]
    layers = COMMON["n_layer"] * A
    kernels = 0 if mesh_kw.get("seq", 1) > 1 else layers
    by_place: dict = {}
    for r in RANKS[group]:
        s = outs[r]["steps"][name]
        assert {k: s[k] for k in ("all_to_alls", "k1", "k2")} == dict(
            all_to_alls=moe.exchanges_per_layer("names") * layers,
            k1=kernels, k2=kernels), r
        place = tuple(sorted((k, v) for k, v in s["coords"].items()
                             if k != "expert"))
        by_place.setdefault(place, set()).add(s["replicated"])
    assert all(len(v) == 1 for v in by_place.values()), by_place
    assert len(by_place) == len(RANKS[group]) // mesh_kw["expert"]


def test_expert_checkpoint_round_trip(runs):
    _, _, _, outs, _ = runs
    for o in outs:
        ck = o["ckpt"]
        assert ck["expert2_to_one_rank_bit_equal"], o["rank"]
        assert ck["npz_onto_expert2_bit_equal"], o["rank"]
    # one file per (fsdp, expert) index: each expert rank writes its experts
    assert outs[0]["ckpt"]["expert2_files"] == [
        "index.json", "shard_0.npz", "shard_1.npz", "shard_2.npz",
        "shard_3.npz"]


def test_parallel_twin_trains_at_expert2(runs):
    rc, out = runs[4]
    assert rc == 0, out[-3000:]
    assert "mesh={'pipe': 1, 'data': 1, 'fsdp': 1, 'expert': 2, 'seq': 1, " \
           "'tensor': 1}" in out, out[-3000:]
    assert "done:" in out, out[-3000:]


# -- no ranks needed ----------------------------------------------------------


@pytest.mark.parametrize("mesh_kw", [
    dict(expert=2), dict(expert=4, fsdp=2, strategy="full_shard"),
    dict(expert=2, fsdp=2, strategy="shard_grad_op"),
    dict(expert=2, tensor=2, fsdp=2, strategy="full_shard"),
], ids=["expert2", "expert4xfsdp2", "expert2xfsdp2-zero2",
        "expert2xtensor2xfsdp2"])
@pytest.mark.parametrize("model", ["gpt2_moe", "llama_moe"])
def test_expert_specs_match_jax(mesh_kw, model):
    """Every leaf's spec is JAX's without the stacked layer dim: the
    experts' stacks on expert (with tensor and fsdp where they land), the
    router replicated."""
    cfg = ModelConfig(**MODELS[model])
    params = get_model(cfg).init(torch.Generator().manual_seed(0), cfg,
                                 device="cpu")
    jtree = interop.params_to_jax(params, cfg)
    for grads in (False, True):
        ours = param_partition_specs(params, MeshConfig(**mesh_kw),
                                     for_grads=grads)
        theirs = jparam_specs(jtree, JaxMeshConfig(**mesh_kw),
                              for_grads=grads)
        for path, spec in tree.leaves_with_path(ours):
            jspec = theirs
            for k in path:
                if not isinstance(k, int):
                    jspec = jspec[k]
            jspec = tuple(jspec)
            if path[0] == "blocks":
                jspec = jspec[1:]  # JAX's stacked layer dim
            want = tuple(jspec) + (None,) * (len(spec) - len(jspec))
            assert spec == (want if any(want) else ()), (path, spec, jspec)
        mlp = ours["blocks"][0]["mlp"]
        assert "expert" not in mlp["router"]
        assert mlp["w_in"][0] == "expert" and mlp["w_out"][0] == "expert"
        # JAX's test_expert_fsdp_actually_shards_both_axes: a leaf split
        # over expert and fsdp at once where fsdp shards it.
        if mesh_kw.get("fsdp") and (grads or mesh_kw["strategy"]
                                    == "full_shard"):
            assert "fsdp" in mlp["w_in"] and "fsdp" in mlp["w_out"]


def test_expert_refusals():
    """JAX's refusals: an expert axis on a dense model names n_experts, an
    expert count the axis does not divide is refused, and so is an
    expert stack the expert size does not divide."""
    dense = ModelConfig(**dict(MODELS["gpt2_moe"], n_experts=0))
    with pytest.raises(ValueError, match="n_experts"):
        check_expert(dense, MeshConfig(expert=2))
    with pytest.raises(ValueError, match="not divisible by expert=3"):
        check_expert(ModelConfig(**MODELS["gpt2_moe"]), MeshConfig(expert=3))
    cfg = ModelConfig(**MODELS["gpt2_moe"])
    params = get_model(cfg).init(torch.Generator().manual_seed(0), cfg,
                                 device="cpu")
    with pytest.raises(ValueError, match="is not divisible by expert=3"):
        param_partition_specs(params, MeshConfig(expert=3))


def test_expert_coordinate_folds_into_the_dropout_key():
    """The expert axis splits the batch: its coordinate is part of the
    batch shard's index (data major, as JAX tiles its batch spec), so
    each expert rank draws its own masks."""
    cfg = MeshConfig(data=2, expert=2)
    keys = []
    for d in range(2):
        for e in range(2):
            m = pmesh.Mesh(cfg=cfg, rank=0, coords=dict(
                pipe=0, data=d, fsdp=0, expert=e, seq=0, tensor=0),
                group=None, groups={}, device=torch.device("cpu"),
                backend="gloo")
            assert pmesh.batch_shard_index(m) == 2 * d + e
            assert pmesh.batch_rows(m, 8) == slice(4 * d + 2 * e,
                                                   4 * d + 2 * e + 2)
            keys.append(pmesh.fold_batch_shard_key(DropoutKey(1, 0, 0), m))
    assert [k.shard for k in keys] == [1, 2, 3, 4]
    assert pmesh.batch_partition_spec(cfg) == (None, ("data", "expert"),
                                               None)
