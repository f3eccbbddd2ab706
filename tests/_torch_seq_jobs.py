"""The rank side of the port's sequence-parallel tests
(``_torch_dist_worker`` runs ``job_seq_ops`` and ``job_seq_train``, each
on four gloo ranks; no JAX here).

The job reads ``spec.json`` and the inputs the test wrote, runs every
case on its group ("a" = ranks {0, 1}, "b" = {2, 3}, both at once, or
"world"), and writes ``out_<rank>.json`` plus npz files of the arrays the
test holds to JAX's: ring and Ulysses attention's local outputs and
gradients, and the params after one explicit step.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from _torch_dist_worker import _params, _save_params, _setup

MEMBERS = {"a": (0, 1), "b": (2, 3), "world": (0, 1, 2, 3)}


def _counts():
    from pytorch_distributed_tpu_torch.ops import flash_kernel as fk
    from pytorch_distributed_tpu_torch.ops import ring_attention, ulysses

    return dict(exchanges=ring_attention.exchanges,
                all_to_alls=ulysses.all_to_alls,
                k1=fk.plain_calls["forward"], k2=fk.plain_calls["backward"])


def _since(c0: dict) -> dict:
    return {k: v - c0[k] for k, v in _counts().items()}


def _ops(workdir: Path, rank: int, groups: dict, spec: dict) -> dict:
    """Each op case: this rank's slice of q, k, v through ring or Ulysses
    attention (Ulysses' local backend: the flash kernels' plain
    versions), then the gradients of sum(out^2); saved as
    ``op_<case>_<rank>.npz``."""
    import torch
    import torch.distributed as dist

    from pytorch_distributed_tpu_torch.ops.attention import (
        multi_head_attention,
    )

    out = {}
    with np.load(workdir / "ops.npz") as f:
        arrays = {k: f[k] for k in f.files}
    for case in spec["ops"]:
        name, group = case["name"], groups[case["group"]]
        if rank not in MEMBERS[case["group"]]:
            continue
        n, i = dist.get_world_size(group), dist.get_rank(group)
        tl = arrays[f"{name}_q"].shape[1] // n
        qkv = [torch.tensor(arrays[f"{name}_{x}"][:, i * tl:(i + 1) * tl],
                            requires_grad=True) for x in "qkv"]
        c0 = _counts()
        o = multi_head_attention(*qkv, impl="flash", causal=case["causal"],
                                 seq_group=group, seq_impl=case["impl"])
        o.square().sum().backward()
        np.savez(workdir / f"op_{name}_{rank}.npz", o=o.detach().numpy(),
                 dq=qkv[0].grad.numpy(), dk=qkv[1].grad.numpy(),
                 dv=qkv[2].grad.numpy())
        out[name] = dict(index=i, **_since(c0))
    return out


def _steps(workdir: Path, rank: int, groups: dict, spec: dict, batch):
    """Each step case: one explicit step on its mesh (``make_parallel_
    train_step``: the batch's rows and span placed by ``make_batch_put``),
    its loss, grad norm and counts; the params gathered and saved by the
    mesh's rank 0 as ``params_<case>.npz``."""
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
            _params(workdir, cfg, f"{case['model']}.npz"), tx), mesh)
        step, put = make_parallel_train_step(get_model(cfg), cfg, tx, mesh,
                                             mcfg, sh)
        c0 = _counts()
        state, m = step(state, put(batch))
        out[name] = dict(loss=float(m["loss"]),
                         grad_norm=float(m["grad_norm"]),
                         coords=mesh.coords, **_since(c0))
        full = ckpt.gather_state(state, sh)
        if mesh.rank == 0:
            _save_params(workdir / f"params_{name}.npz", full.params, cfg)
        del state, full
    return out


def _checkpoint(workdir: Path, spec: dict, batch) -> dict:
    """The sharded checkpoint across seq: a state after one step at fsdp 2
    x seq 2 (full_shard) saved, then restored at seq 1 whole; and a state
    saved at fsdp 4 (seq 1) restored onto fsdp 2 x seq 2. Each restore
    held bit for bit; the files the seq-2 save wrote."""
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
        shard_slice,
        shard_train_state,
    )
    from pytorch_distributed_tpu_torch.train import checkpoint as ckpt
    from pytorch_distributed_tpu_torch.train.optim import make_optimizer
    from pytorch_distributed_tpu_torch.train.state import init_train_state
    from pytorch_distributed_tpu_torch.utils import tree

    tcfg = TrainConfig(**spec["train"])
    cfg = ModelConfig(**spec["models"]["gpt2"])

    def build(mesh_kw):
        mcfg = MeshConfig(**mesh_kw)
        mesh = make_mesh(mcfg, device="cpu")
        tx = make_optimizer(tcfg)
        state, sh = shard_train_state(init_train_state(
            _params(workdir, cfg, "gpt2.npz"), tx), mesh)
        step, put = make_parallel_train_step(get_model(cfg), cfg, tx, mesh,
                                             mcfg, sh)
        state, _ = step(state, put(batch))
        return mesh, state, sh

    def leaves(s):
        return tree.leaves([s.params, s.opt_state["mu"], s.opt_state["nu"]])

    def fresh():
        return init_train_state(_params(workdir, cfg, "other.npz"),
                                make_optimizer(tcfg))

    out = {}
    _, state, sh = build(dict(fsdp=2, seq=2, strategy="full_shard"))
    ckpt.save_checkpoint(workdir / "seq2", state, cfg, format="orbax",
                         sharding=sh, metadata={"step": 1})
    full = ckpt.gather_state(state, sh)
    whole = ckpt.load_checkpoint(workdir / "seq2", fresh(), cfg)
    out["seq2_to_seq1_bit_equal"] = all(
        torch.equal(a, b) for a, b in zip(leaves(whole), leaves(full)))
    out["seq2_files"] = sorted(p.name for p in (workdir / "seq2" / "tree")
                               .iterdir())
    _, state, sh4 = build(dict(fsdp=4, strategy="full_shard"))
    ckpt.save_checkpoint(workdir / "seq1", state, cfg, format="orbax",
                         sharding=sh4, metadata={"step": 1})
    full = ckpt.gather_state(state, sh4)
    like, _ = shard_train_state(fresh(), sh.mesh)
    got = ckpt.load_checkpoint(workdir / "seq1", like, cfg, sharding=sh)
    want = [shard_slice(t, s, sh.mesh) for t, s in zip(
        leaves(full), tree.leaves([sh.params, sh.opt_state["mu"],
                                   sh.opt_state["nu"]]))]
    out["seq1_to_seq2_bit_equal"] = all(
        torch.equal(a, b) for a, b in zip(leaves(got), want))
    out["seq1_to_seq2_step"] = got.step
    return out


def _overflow(spec: dict, group) -> str:
    """The global-length check: each rank of a seq-2 group holds n_ctx
    tokens (2 n_ctx in all); the forward's error."""
    import torch

    from pytorch_distributed_tpu_torch.config import ModelConfig
    from pytorch_distributed_tpu_torch.models import get_model

    cfg = ModelConfig(**spec["models"]["llama"])
    model = get_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    try:
        model.apply(params, torch.zeros((1, cfg.n_ctx), dtype=torch.long),
                    cfg, seq_group=group)
    except ValueError as err:
        return str(err)
    return ""


def _groups():
    import torch.distributed as dist

    return {"a": dist.new_group([0, 1]), "b": dist.new_group([2, 3]),
            "world": dist.group.WORLD}


def _guard_loop(workdir: Path, spec: dict) -> dict:
    """The ``DistributedTrainer``'s loop at data 2 x seq 2 with the anomaly
    guard, 4 steps on global batches; the third holds an out-of-range id
    in one row (one data shard's, one seq span's). Every rank must take
    the same decision: the anomalies, losses and params' digest."""
    import hashlib

    from pytorch_distributed_tpu_torch.config import (
        MeshConfig,
        ModelConfig,
        TrainConfig,
    )
    from pytorch_distributed_tpu_torch.models import get_model
    from pytorch_distributed_tpu_torch.parallel.mesh import make_mesh
    from pytorch_distributed_tpu_torch.parallel.sharding import (
        shard_train_state,
    )
    from pytorch_distributed_tpu_torch.train import checkpoint as ckpt
    from pytorch_distributed_tpu_torch.train.distributed_trainer import (
        DistributedTrainer,
    )
    from pytorch_distributed_tpu_torch.train.guard import init_guard_state
    from pytorch_distributed_tpu_torch.train.state import init_train_state
    from pytorch_distributed_tpu_torch.utils import tree

    tcfg = TrainConfig(**dict(spec["train"], anomaly_guard=True,
                              num_steps=4, log_every_n_steps=1,
                              guard_rollback_after=None))
    mcfg = MeshConfig(data=2, seq=2, strategy="no_shard")
    mesh = make_mesh(mcfg, device="cpu")
    cfg = ModelConfig(**spec["models"]["gpt2"])
    tr = DistributedTrainer(get_model(cfg), cfg, tcfg, mesh, mcfg,
                            log_fn=lambda s: None)
    tr.init_state()
    state, sh = shard_train_state(init_train_state(
        _params(workdir, cfg, "gpt2.npz"), tr.tx,
        guard=init_guard_state(mesh.device)), mesh)
    rng = np.random.default_rng(7)
    rows, t = tcfg.micro_batch_size * 2, cfg.n_ctx
    loader = []
    for i in range(4 * tr.accum):
        x = rng.integers(0, cfg.vocab_size, (rows, t))
        if i == 2 * tr.accum:
            x[rows - 1, t - 2] = cfg.vocab_size + 5
        loader.append((x, rng.integers(0, cfg.vocab_size, (rows, t))))
    state, hist = tr.train(loader, state=state)
    full = ckpt.gather_state(state, sh)
    return dict(
        anomalies=hist[-1]["anomalies"], losses=[h["loss"] for h in hist],
        params_sha=hashlib.sha256(b"".join(
            p.detach().numpy().tobytes()
            for p in tree.leaves(full.params))).hexdigest())


def job_seq_ops(workdir: Path) -> None:
    """The op cases (``tests/test_torch_seq_ops.py``)."""
    import torch.distributed as dist

    spec, rank = _setup(workdir)
    out = {"rank": rank, "ops": _ops(workdir, rank, _groups(), spec)}
    (workdir / f"out_{rank}.json").write_text(json.dumps(out))
    dist.barrier()


def job_seq_train(workdir: Path) -> None:
    """The step cases, the checkpoint, the guarded loop and the length
    check (``tests/test_torch_seq.py``)."""
    import torch.distributed as dist

    spec, rank = _setup(workdir)
    groups = _groups()
    with np.load(workdir / "batch.npz") as f:
        batch = {k: f[k] for k in f.files}
    out: dict = {"rank": rank}
    out["steps"] = _steps(workdir, rank, groups, spec, batch)
    out["ckpt"] = _checkpoint(workdir, spec, batch)
    out["guard"] = _guard_loop(workdir, spec)
    if rank in MEMBERS["a"]:
        out["overflow"] = _overflow(spec, groups["a"])
    (workdir / f"out_{rank}.json").write_text(json.dumps(out))
    dist.barrier()


def job_cuda_seq(workdir: Path) -> None:
    """On the card: one ring exchange and one Ulysses all-to-all pair on
    CUDA tensors over a gloo group of two ranks sharing cuda:0 (the port
    stages them through the host), forward and backward; writes what each
    rank received and its gradients."""
    import torch
    import torch.distributed as dist

    from pytorch_distributed_tpu_torch.ops import ring_attention, ulysses

    _, rank = _setup(workdir)
    dev = torch.device("cuda", 0)
    group = dist.group.WORLD
    x = (torch.arange(6, dtype=torch.float32, device=dev).view(2, 3)
         + 100 * rank).requires_grad_()
    y = ring_attention.ring_shift(x, group)
    (y * (rank + 1)).sum().backward()
    # [B 1, T/n 2, H 4, D 2], every element naming (rank, t, h, d)
    q = (torch.arange(16, dtype=torch.float32, device=dev).view(1, 2, 4, 2)
         + 1000 * rank).requires_grad_()
    h = ulysses.heads_to_seq(q, group)
    back = ulysses.seq_to_heads(h, group)
    (h * (rank + 1)).sum().backward()
    out = dict(rank=rank, device=str(y.device), ring=y.tolist(),
               ring_grad=x.grad.tolist(), heads_to_seq=h.tolist(),
               heads_to_seq_device=str(h.device),
               round_trip_equal=bool(torch.equal(back, q)),
               all_to_all_grad=q.grad.tolist())
    (workdir / f"out_{rank}.json").write_text(json.dumps(out))


SEQ_JOBS = {"seq_ops": job_seq_ops, "seq_train": job_seq_train,
            "cuda_seq": job_cuda_seq}
