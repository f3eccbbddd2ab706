"""The JAX side of the port's data-parallel tests: the JAX package's
explicit step (``make_explicit_train_step``) on a mesh over the first 2 or
4 of the conftest's 8 CPU devices, per case of ``CASES``, on the seeded
weights and batches the port's gloo ranks read (``_torch_dist_worker``).

Each case: a strategy at data 2 ("a", ranks {0, 1}), fsdp 2 ("b", ranks
{2, 3}) or data 2 x fsdp 2 ("world"); ZeRO-2 at data 2 x fsdp 2 with
``rs_buckets`` 3 (the bucketed reduce-scatter). Three steps at A = 2,
clip 1.0, f32, dropout 0.
"""

from __future__ import annotations

import json

import jax
import numpy as np

from pytorch_distributed_tpu.config import MeshConfig as JaxMeshConfig
from pytorch_distributed_tpu.config import ModelConfig as JaxModelConfig
from pytorch_distributed_tpu.config import TrainConfig as JaxTrainConfig
from pytorch_distributed_tpu.models import get_model as jget_model
from pytorch_distributed_tpu.parallel import make_mesh, shard_train_state
from pytorch_distributed_tpu.parallel.explicit import (
    make_explicit_train_step,
)
from pytorch_distributed_tpu.parallel.mesh import make_batch_put
from pytorch_distributed_tpu.train.optim import make_optimizer
from pytorch_distributed_tpu.train.state import init_train_state
from pytorch_distributed_tpu_torch.train.checkpoint import _flatten

MESHES = {"data2": ("a", dict(data=2)), "fsdp2": ("b", dict(fsdp=2)),
          "data2xfsdp2": ("world", dict(data=2, fsdp=2))}
STRATEGIES = ("no_shard", "full_shard", "shard_grad_op", "shard_opt")
TRAIN_KW = dict(global_batch_size=8, micro_batch_size=2, num_steps=3,
                learning_rate=1e-3, grad_clip_norm=1.0)
A, B, T = 2, 4, 16  # B: the global micro-batch, micro 2 per batch shard


def cases() -> list[dict]:
    out = []
    for mesh_name, (group, kw) in MESHES.items():
        for strategy in STRATEGIES:
            mesh = dict(kw, strategy=strategy)
            if strategy == "shard_grad_op" and mesh_name == "data2xfsdp2":
                mesh["rs_buckets"] = 3
            out.append(dict(name=f"{strategy}-{mesh_name}", group=group,
                            mesh=mesh))
    return out


CASES = cases()
CASE_IDS = [c["name"] for c in CASES]


def write_inputs(workdir, model_kw: dict, *, seed: int = 0):
    """The JAX weights (npz, JAX keys), the batches and the spec; returns
    (JAX params, batches)."""
    cfg = JaxModelConfig(**model_kw)
    # Host copies: each JAX case places (and its step donates) its own.
    params = jax.device_get(jget_model(cfg).init(jax.random.key(seed), cfg))
    flat: dict = {}
    _flatten("params", params, flat)
    np.savez(workdir / "params.npz", **flat)
    rng = np.random.default_rng(seed)
    batches = [dict(inputs=rng.integers(0, cfg.vocab_size, (A, B, T)),
                    targets=rng.integers(0, cfg.vocab_size, (A, B, T)))
               for _ in range(3)]
    np.savez(workdir / "batches.npz", **{
        f"{k}_{i}": v for i, b in enumerate(batches) for k, v in b.items()})
    (workdir / "spec.json").write_text(json.dumps(
        dict(model=model_kw, train=TRAIN_KW, cases=CASES)))
    return params, batches


def run_jax_case(model_kw: dict, case: dict, params, batches) -> dict:
    """The JAX explicit step's losses, grad norms, final params (flat JAX
    keys) and each device's shard element counts per leaf."""
    cfg = JaxModelConfig(**model_kw)
    model = jget_model(cfg)
    tcfg = JaxTrainConfig(**TRAIN_KW)
    mcfg = JaxMeshConfig(**case["mesh"])
    mesh = make_mesh(mcfg)
    tx = make_optimizer(tcfg, with_clip=False)
    state, _ = shard_train_state(init_train_state(params, tx), mesh, mcfg)
    numel = []
    for dev in mesh.devices.flat:
        counts: dict = {}
        for prefix, t in (("params", state.params),
                          ("mu", state.opt_state[1].mu),
                          ("nu", state.opt_state[1].nu)):
            for path, leaf in jax.tree_util.tree_leaves_with_path(t):
                key = prefix + "/" + "/".join(str(p.key) for p in path)
                counts[key] = sum(s.data.size for s in leaf.addressable_shards
                                  if s.device == dev)
        numel.append(counts)
    step = make_explicit_train_step(model, cfg, tx, mesh, mcfg, state,
                                    grad_clip_norm=tcfg.grad_clip_norm)
    put = make_batch_put(mesh, mcfg)
    hist = []
    with jax.default_matmul_precision("highest"):
        for b in batches:
            state, m = step(state, put({k: v.astype(np.int32)
                                        for k, v in b.items()}),
                            jax.random.key(0))
            hist.append([float(m["loss"]), float(m["grad_norm"])])
    flat: dict = {}
    _flatten("params", jax.device_get(state.params), flat)
    return dict(hist=hist, params=flat, numel=numel)


def assert_case_matches(workdir, name: str, want: dict) -> None:
    """Losses and grad norms within rtol 1e-5; every param within rtol
    1e-5 of JAX's, with an absolute floor of 1e-5: the attention's k bias
    has a zero gradient in exact arithmetic, so Adam moves it by the sign
    of rounding noise on either side (its elements differ by up to 1.8e-6
    after 3 steps at lr 1e-3, where every other leaf agrees to 4e-7
    relative to its norm)."""
    hist = json.loads((workdir / f"hist_{name}.json").read_text())
    np.testing.assert_allclose(np.array(hist)[:, 0],
                               np.array(want["hist"])[:, 0], rtol=1e-5)
    np.testing.assert_allclose(np.array(hist)[:, 1],
                               np.array(want["hist"])[:, 1], rtol=1e-5)
    with np.load(workdir / f"params_{name}.npz") as got:
        assert sorted(got.files) == sorted(want["params"])
        for k in got.files:
            a, b = got[k], np.asarray(want["params"][k])
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5,
                                       err_msg=k)


def assert_numel_matches(workdir, name: str, want: dict, n: int) -> None:
    """Each rank's elements per JAX leaf equal JAX's device shard's."""
    for r in range(n):
        got = json.loads((workdir / f"numel_{name}_{r}.json").read_text())
        assert got == want["numel"][r], (r, got, want["numel"][r])

