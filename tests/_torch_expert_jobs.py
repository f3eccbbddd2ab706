"""The rank side of the port's expert-parallel tests
(``_torch_dist_worker`` runs ``job_expert`` on four gloo ranks; no JAX
here).

The job reads ``spec.json`` and the inputs the test wrote (the op inputs,
the weights as JAX's stacked npz, the batch), runs every case on its
group ("a" = ranks {0, 1}, "b" = {2, 3}, both at once, or "world"), and
writes ``out_<rank>.json`` plus npz files of what the test holds to JAX:
``moe_mlp``'s local outputs and gradients, and the params gathered after
one explicit step.
"""

from __future__ import annotations

import hashlib
import json
from pathlib import Path

import numpy as np

from _torch_dist_worker import _params, _save_params, _setup

MEMBERS = {"a": (0, 1), "b": (2, 3), "world": (0, 1, 2, 3)}


def _groups():
    import torch.distributed as dist

    return {"a": dist.new_group([0, 1]), "b": dist.new_group([2, 3]),
            "world": dist.group.WORLD}


def _counts() -> dict:
    from pytorch_distributed_tpu_torch.ops import flash_kernel as fk
    from pytorch_distributed_tpu_torch.ops import moe

    return dict(all_to_alls=moe.all_to_alls, k1=fk.plain_calls["forward"],
                k2=fk.plain_calls["backward"])


def _since(c0: dict) -> dict:
    return {k: v - c0[k] for k, v in _counts().items()}


def _ops(workdir: Path, rank: int, groups: dict, spec: dict) -> dict:
    """Each op case: this rank's rows of x and its experts' weights
    through ``moe_mlp`` on the case's expert group, then the gradients of
    sum(out^2) + 0.01 aux (the tanh GELU, ``jax.nn.gelu``'s default);
    saved as ``op_<case>_<rank>.npz`` (the router's gradient is this
    rank's part: the test sums them)."""
    import torch
    import torch.distributed as dist
    import torch.nn.functional as F

    from pytorch_distributed_tpu_torch.ops.moe import moe_mlp

    with np.load(workdir / "ops.npz") as f:
        arrays = {k: f[k] for k in f.files}
    out = {}
    for case in spec["ops"]:
        name, group = case["name"], groups[case["group"]]
        if rank not in MEMBERS[case["group"]]:
            continue
        n, i = dist.get_world_size(group), dist.get_rank(group)
        x = arrays[f"{name}_x"]
        rows = x.shape[0] // n
        xl = torch.tensor(x[i * rows:(i + 1) * rows], requires_grad=True)
        params = {}
        for k in ("router", "w_in", "w_gate", "w_out"):
            w = arrays.get(f"{name}_{k}")
            if w is None:
                continue
            if k != "router":
                per = w.shape[0] // n
                w = w[i * per:(i + 1) * per]
            params[k] = torch.tensor(w, requires_grad=True)
        c0 = _counts()
        y, aux = moe_mlp(xl, params,
                         activation=lambda h: F.gelu(h, approximate="tanh"),
                         capacity_factor=case["capacity_factor"],
                         expert_axis=group, top_k=case["top_k"],
                         dispatch_impl=case["dispatch"])
        (y.square().sum() + 0.01 * aux).backward()
        np.savez(workdir / f"op_{name}_{rank}.npz", out=y.detach().numpy(),
                 aux=aux.detach().numpy(), dx=xl.grad.numpy(),
                 **{f"d_{k}": p.grad.numpy() for k, p in params.items()})
        out[name] = dict(index=i, **_since(c0))
    return out


def _replicated_digest(state, sharding) -> str:
    """A digest of the params, mu and nu leaves the expert axis does not
    split: the same on every expert rank of one place on the other axes."""
    from pytorch_distributed_tpu_torch.utils import tree

    h = hashlib.sha256()
    for t, spec in zip(
            tree.leaves([state.params, state.opt_state["mu"],
                         state.opt_state["nu"]]),
            tree.leaves([sharding.params, sharding.opt_state["mu"],
                         sharding.opt_state["nu"]])):
        if "expert" not in spec:
            h.update(t.detach().contiguous().numpy().tobytes())
    return h.hexdigest()


def _steps(workdir: Path, rank: int, groups: dict, spec: dict,
           batch) -> dict:
    """Each step case: one explicit step on its mesh
    (``make_parallel_train_step``), its loss, grad norm, counts and the
    digest of the leaves replicated over expert; the params gathered and
    saved by the mesh's rank 0 as ``params_<case>.npz``."""
    from pytorch_distributed_tpu_torch.config import (
        MeshConfig,
        ModelConfig,
        TrainConfig,
    )
    from pytorch_distributed_tpu_torch.models import get_model
    from pytorch_distributed_tpu_torch.parallel.api import (
        make_parallel_train_step,
    )
    from pytorch_distributed_tpu_torch.parallel.mesh import make_mesh
    from pytorch_distributed_tpu_torch.parallel.sharding import (
        shard_train_state,
    )
    from pytorch_distributed_tpu_torch.train import checkpoint as ckpt
    from pytorch_distributed_tpu_torch.train.optim import make_optimizer
    from pytorch_distributed_tpu_torch.train.state import init_train_state

    tcfg = TrainConfig(**spec["train"])
    out = {}
    for case in spec["steps"]:
        name = case["name"]
        if rank not in MEMBERS[case["group"]]:
            continue
        cfg = ModelConfig(**spec["models"][case["model"]])
        mcfg = MeshConfig(**case["mesh"])
        mesh = make_mesh(mcfg, group=groups[case["group"]], device="cpu")
        tx = make_optimizer(tcfg)
        state, sh = shard_train_state(init_train_state(
            _params(workdir, cfg, spec["weights"][case["model"]]), tx),
            mesh)
        step, put = make_parallel_train_step(get_model(cfg), cfg, tx, mesh,
                                             mcfg, sh)
        c0 = _counts()
        state, m = step(state, put(batch))
        out[name] = dict(loss=float(m["loss"]),
                         grad_norm=float(m["grad_norm"]),
                         coords=mesh.coords,
                         replicated=_replicated_digest(state, sh),
                         **_since(c0))
        full = ckpt.gather_state(state, sh)
        if mesh.rank == 0:
            _save_params(workdir / f"params_{name}.npz", full.params, cfg)
        del state, full
    return out


def _checkpoint(workdir: Path, spec: dict, batch) -> dict:
    """The sharded checkpoint over expert x fsdp: a state after one step
    at expert 2 x fsdp 2 (full_shard) saved in the sharded format and
    restored on one rank whole, and saved as npz and restored onto the
    same layout; each held bit for bit. The files the sharded save
    wrote."""
    import torch

    from pytorch_distributed_tpu_torch.config import (
        MeshConfig,
        ModelConfig,
        TrainConfig,
    )
    from pytorch_distributed_tpu_torch.models import get_model
    from pytorch_distributed_tpu_torch.parallel.api import (
        make_parallel_train_step,
    )
    from pytorch_distributed_tpu_torch.parallel.mesh import make_mesh
    from pytorch_distributed_tpu_torch.parallel.sharding import (
        shard_train_state,
    )
    from pytorch_distributed_tpu_torch.train import checkpoint as ckpt
    from pytorch_distributed_tpu_torch.train.optim import make_optimizer
    from pytorch_distributed_tpu_torch.train.state import init_train_state
    from pytorch_distributed_tpu_torch.utils import tree

    tcfg = TrainConfig(**spec["train"])
    cfg = ModelConfig(**spec["models"]["gpt2_moe"])
    weights = spec["weights"]["gpt2_moe"]
    mcfg = MeshConfig(expert=2, fsdp=2, strategy="full_shard")
    mesh = make_mesh(mcfg, device="cpu")
    tx = make_optimizer(tcfg)
    state, sh = shard_train_state(init_train_state(
        _params(workdir, cfg, weights), tx), mesh)
    step, put = make_parallel_train_step(get_model(cfg), cfg, tx, mesh,
                                         mcfg, sh)
    state, _ = step(state, put(batch))

    def leaves(s):
        return tree.leaves([s.params, s.opt_state["mu"], s.opt_state["nu"]])

    def fresh():
        return init_train_state(_params(workdir, cfg, "other.npz"), tx)

    out = {}
    ckpt.save_checkpoint(workdir / "ep2", state, cfg, format="orbax",
                         sharding=sh, metadata={"step": 1})
    ckpt.save_checkpoint(workdir / "ep2_npz", state, cfg, format="npz",
                         sharding=sh, metadata={"step": 1})
    full = ckpt.gather_state(state, sh)
    whole = ckpt.load_checkpoint(workdir / "ep2", fresh(), cfg)
    out["expert2_to_one_rank_bit_equal"] = whole.step == 1 and all(
        torch.equal(a, b) for a, b in zip(leaves(whole), leaves(full)))
    out["expert2_files"] = sorted(p.name for p in (workdir / "ep2" / "tree")
                                  .iterdir())
    like, _ = shard_train_state(fresh(), mesh)
    got = ckpt.load_checkpoint(workdir / "ep2_npz", like, cfg, sharding=sh)
    out["npz_onto_expert2_bit_equal"] = got.step == 1 and all(
        torch.equal(a, b) for a, b in zip(leaves(got), leaves(state)))
    return out


def job_expert(workdir: Path) -> None:
    """The op cases, the step cases and the checkpoint
    (``tests/test_torch_expert.py``)."""
    import torch.distributed as dist

    spec, rank = _setup(workdir)
    groups = _groups()
    with np.load(workdir / "batch.npz") as f:
        batch = {k: f[k] for k in f.files}
    out: dict = {"rank": rank}
    out["ops"] = _ops(workdir, rank, groups, spec)
    out["steps"] = _steps(workdir, rank, groups, spec, batch)
    out["ckpt"] = _checkpoint(workdir, spec, batch)
    (workdir / f"out_{rank}.json").write_text(json.dumps(out))
    dist.barrier()


EXPERT_JOBS = {"expert": job_expert}
