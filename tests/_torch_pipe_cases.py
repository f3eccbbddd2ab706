"""Shared by the port's pipeline tests (``test_torch_pipeline.py``,
``test_torch_pipeline_comp.py``): the configs, the seeded inputs, the JAX
references and the fixture body that starts the port's four gloo ranks
(``_torch_pipe_jobs.job_pipe_train``) while JAX runs its references in
this process, its compiles in threads.

The JAX package's pipeline test shape (``tests/_pipeline_common.py``):
n_layer 4, n_embd 64, 4 heads (Llama: 2 KV heads), f32, M = 3
micro-batches of [8, 16]; JAX at its own test config (naive attention,
its default remat), the port with flash attention (the plain versions of
K1/K2 here) under ``names``. Tolerances are JAX's pipeline tests': loss
1e-5, grad norm 1e-4, params 1e-4.
"""

from __future__ import annotations

import json
import threading
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch

from _torch_dist_worker import launch
from test_torch_serving_tp import read_outputs
from test_torch_tp_train import _flatten, _save_npz
from pytorch_distributed_tpu.config import MeshConfig as JaxMeshConfig
from pytorch_distributed_tpu.config import ModelConfig as JaxModelConfig
from pytorch_distributed_tpu.config import TrainConfig as JaxTrainConfig
from pytorch_distributed_tpu.models import get_model as jget_model
from pytorch_distributed_tpu.parallel import make_mesh
from pytorch_distributed_tpu.parallel.pipeline import (
    make_pipeline_train_step as jpipe_step,
    shard_pipeline_state as jshard_pipe,
)
from pytorch_distributed_tpu.train.optim import make_optimizer as jmake_opt
from pytorch_distributed_tpu.train.state import init_train_state as jinit
from pytorch_distributed_tpu.train.trainer import make_train_step as jstep
from pytorch_distributed_tpu_torch import interop
from pytorch_distributed_tpu_torch.config import ModelConfig
from pytorch_distributed_tpu_torch.models import get_model

COMMON = dict(vocab_size=128, n_ctx=16, n_embd=64, n_layer=4, n_head=4,
              dtype="float32", embd_pdrop=0.0, attn_pdrop=0.0,
              resid_pdrop=0.0, attention_impl="flash", remat="names")
LLAMA = dict(family="llama", n_kv_head=2, n_inner=128,
             activation_function="silu")
MODELS = {
    "gpt2": dict(COMMON, seq_impl="ring"),
    "llama": dict(COMMON, **LLAMA),
    "llama_ulysses": dict(COMMON, **LLAMA, seq_impl="ulysses"),
    "gpt2_moe": dict(COMMON, n_experts=4, moe_top_k=2,
                     expert_capacity_factor=4.0),
}
# The JAX weights each model's stages take (npz of the stacked tree).
WEIGHTS = {"gpt2": "gpt2.npz", "llama": "llama.npz",
           "llama_ulysses": "llama.npz", "gpt2_moe": "gpt2_moe.npz"}
TRAIN = dict(global_batch_size=24, micro_batch_size=8, num_steps=1,
             learning_rate=1e-3)
M, B, T = 3, 8, 16
RANKS = {"a": (0, 1), "b": (2, 3), "world": (0, 1, 2, 3),
         "b4": (4, 5, 6, 7), "all8": tuple(range(8))}


def _jax_cfg(model: str) -> JaxModelConfig:
    kw = {k: v for k, v in MODELS[model].items()
          if k not in ("attention_impl", "remat")}
    return JaxModelConfig(**kw)


def _flat_result(state, m) -> dict:
    flat: dict = {}
    _flatten("params", jax.device_get(state.params), flat)
    return dict(loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
                params=flat)


# XLA's cheaper compile for a step run once: fusion may reorder float
# sums, far inside the tolerances.
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}


def run_once(jitted, *args):
    """``jitted(*args)`` at full matmul precision, compiled with
    ``FAST_COMPILE``."""
    with jax.default_matmul_precision("highest"):
        return jitted.lower(*args).compile(
            compiler_options=FAST_COMPILE)(*args)


def jax_pipeline(case, params, batch) -> dict:
    """JAX's pipeline step, once, on a mesh of the first devices."""
    cfg = _jax_cfg(case["model"])
    mcfg = JaxMeshConfig(**case["mesh"])
    mesh = make_mesh(mcfg)
    tx = jmake_opt(JaxTrainConfig(**TRAIN), with_clip=False)
    state, _ = jshard_pipe(jinit(params, tx), mesh, mcfg)
    step = jpipe_step(jget_model(cfg), cfg, tx, mesh, mcfg, state,
                      schedule=case["schedule"],
                      grad_clip_norm=case.get("clip"))
    state, m = run_once(step, state, {k: v.astype(np.int32)
                                      for k, v in batch.items()},
                        jax.random.key(0))
    return _flat_result(state, m)


def jax_single(case, params, batch) -> dict:
    """JAX's single-device step (M micro-batches accumulated), once."""
    cfg = _jax_cfg(case["model"])
    tx = jmake_opt(JaxTrainConfig(**TRAIN))
    state, m = run_once(jstep(jget_model(cfg), cfg, tx, donate=False),
                        jinit(params, tx),
                        {k: v.astype(np.int32) for k, v in batch.items()},
                        jax.random.key(0))
    return _flat_result(state, m)


def init_params(model: str, seed: int = 0) -> dict:
    """``model``'s weights from the port's ``init`` (the JAX family's
    distributions, drawn in a fraction of JAX's first-call time) as the
    JAX tree of numpy leaves, stacked [L, ...]."""
    cfg = ModelConfig(**MODELS[model])
    return interop.params_to_jax(get_model(cfg).init(
        torch.Generator().manual_seed(seed), cfg, device="cpu"), cfg)


def case(name, model, group, mesh, schedule, ref="pipeline", **kw):
    return dict(name=name, model=model, group=group, mesh=mesh,
                schedule=schedule, ref=ref, **kw)


def start(tmp_path_factory, cases: list, parts: list, tag: str,
          n: int = 4):
    """Write the inputs, start the port's ``n`` ranks (4, or 8 for the
    groups "b4" and "all8"), run JAX meanwhile: (workdir, JAX results by
    case name, the ranks' outputs)."""
    wd = tmp_path_factory.mktemp(tag)
    params = {}
    for model, f in WEIGHTS.items():
        if f not in params:
            params[f] = init_params(model)
            _save_npz(wd / f, params[f])
    _save_npz(wd / "other.npz", init_params("gpt2", seed=3))
    rng = np.random.default_rng(0)
    batch = dict(inputs=rng.integers(0, 128, (M, B, T)),
                 targets=rng.integers(0, 128, (M, B, T)))
    np.savez(wd / "batch.npz", **batch)
    (wd / "spec.json").write_text(json.dumps(dict(
        models=MODELS, weights=WEIGHTS, train=TRAIN, parts=parts,
        steps=[{k: v for k, v in c.items() if k != "ref"}
               for c in cases])))
    box: dict = {}
    th = threading.Thread(target=lambda: box.update(
        results=launch("pipe_train", n, wd, timeout_s=300)))
    th.start()

    def reference(c):
        p = params[WEIGHTS[c["model"]]]
        return (jax_pipeline(c, p, batch) if c["ref"] == "pipeline"
                else jax_single(c, p, batch))

    with ThreadPoolExecutor(4) as ex:
        want = dict(zip([c["name"] for c in cases], ex.map(reference,
                                                            cases)))
    th.join()
    assert "results" in box, "the port's ranks did not finish"
    return wd, want, read_outputs(wd, box["results"], n=n)


def check_step(runs, c) -> None:
    """Every rank of the case reports the same loss and norm; both, and
    the gathered params, at JAX's tolerances from JAX's result."""
    wd, want, outs = runs
    got = [outs[r]["steps"][c["name"]] for r in RANKS[c["group"]]]
    w = want[c["name"]]
    for g in got:
        assert g["loss"] == got[0]["loss"]
        assert g["grad_norm"] == got[0]["grad_norm"]
    assert got[0]["loss"] == pytest.approx(w["loss"], abs=1e-5)
    assert got[0]["grad_norm"] == pytest.approx(w["grad_norm"], abs=1e-4)
    with np.load(wd / f"params_{c['name']}.npz") as f:
        assert sorted(f.files) == sorted(w["params"])
        for k in f.files:
            np.testing.assert_allclose(f[k], np.asarray(w["params"][k]),
                                       atol=1e-4, err_msg=k)


def check_counts(runs, c) -> None:
    """K1/K2 calls and pipe sends a step on each rank, as
    ``parallel/pipeline.pipe_counts`` derives them (the ring launches no
    flash kernel)."""
    from pytorch_distributed_tpu_torch.parallel.pipeline import pipe_counts

    _, _, outs = runs
    s = c["mesh"]["pipe"]
    ring = c["mesh"].get("seq", 1) > 1 and \
        MODELS[c["model"]].get("seq_impl", "ring") == "ring"
    for r in RANKS[c["group"]]:
        got = outs[r]["steps"][c["name"]]
        want = pipe_counts(c["schedule"], got["stage"], s,
                           COMMON["n_layer"], M)
        if ring:
            want.update(K1=0, K2=0)
        assert dict(K1=got["k1"], K2=got["k2"], sends=got["sends"]) == \
            want, (r, got)
