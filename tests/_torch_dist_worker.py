"""Gloo CPU ranks for the port's data-parallel tests (no JAX here).

``launch(job, n, workdir)`` starts ``n`` processes of this file, each a
rank of one ``torch.distributed`` group on 127.0.0.1, runs ``job`` (a
function below) in each, and returns when all exit; a rank that does not
finish within the limit fails the test, and so does a nonzero exit code
(with its stderr). Each job reads its inputs from ``workdir`` (``spec.json``
and the npz files the test wrote) and writes its results there, one file
per result, so one group runs every case of a test module.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
GROUP_TIMEOUT_S = 60.0


def launch(job: str, n: int, workdir, *, timeout_s: float = 240.0,
           expect_fail: bool = False) -> list:
    """Run ``job`` on ``n`` ranks; returns their (exit code, stderr)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    for r in range(n):
        env = dict(os.environ, RANK=str(r), LOCAL_RANK=str(r),
                   WORLD_SIZE=str(n), MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port), OMP_NUM_THREADS="1",
                   PYTHONPATH=str(ROOT))
        procs.append(subprocess.Popen(
            [sys.executable, __file__, job, str(workdir)], env=env,
            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True,
            cwd=str(workdir)))
    deadline = time.monotonic() + timeout_s
    out = []
    try:
        for p in procs:
            left = max(1.0, deadline - time.monotonic())
            _, err = p.communicate(timeout=left)
            out.append((p.returncode, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if len(out) < n:
        raise AssertionError(f"{job}: a rank did not finish in {timeout_s}s")
    if not expect_fail:
        bad = [(i, rc, err[-3000:]) for i, (rc, err) in enumerate(out)
               if rc != 0]
        assert not bad, f"{job} failed: {bad}"
    return out


# -- shared by the jobs -----------------------------------------------------


def _setup(workdir: Path):
    import torch
    import torch.distributed as dist

    from pytorch_distributed_tpu_torch.parallel.mesh import (
        initialize_distributed,
    )

    torch.set_num_threads(1)
    initialize_distributed(device="cpu", timeout_s=GROUP_TIMEOUT_S)
    return json.loads((workdir / "spec.json").read_text()), dist.get_rank()


def _cfgs(spec):
    """(model config, train config, ``MeshConfig``) of the spec."""
    from pytorch_distributed_tpu_torch.config import (
        MeshConfig,
        ModelConfig,
        TrainConfig,
    )

    return ModelConfig(**spec["model"]), TrainConfig(**spec["train"]), \
        lambda kw: MeshConfig(**kw)


def _params(workdir: Path, cfg, name="params.npz"):
    import numpy as np

    from pytorch_distributed_tpu_torch import interop
    from pytorch_distributed_tpu_torch.train.checkpoint import _unflatten

    with np.load(workdir / name) as f:
        flat = {k: f[k] for k in f.files}
    return interop.params_from_jax(_unflatten("params", flat), cfg)


def _batches(workdir: Path):
    import numpy as np

    with np.load(workdir / "batches.npz") as f:
        n = len(f.files) // 2
        return [dict(inputs=f[f"inputs_{i}"], targets=f[f"targets_{i}"])
                for i in range(n)]


def _save_params(path: Path, params, cfg) -> None:
    import numpy as np

    from pytorch_distributed_tpu_torch import interop
    from pytorch_distributed_tpu_torch.train.checkpoint import _flatten

    out: dict = {}
    _flatten("params", interop.params_to_jax(params, cfg), out)
    np.savez(path, **out)


def _jax_key(path) -> str:
    """A per-layer leaf's JAX key: the layer index dropped."""
    return "/".join(str(p) for p in path if not isinstance(p, int))


def _numel_by_jax_leaf(state) -> dict:
    from pytorch_distributed_tpu_torch.utils import tree

    out: dict = {}
    for prefix, t in (("params", state.params),
                      ("mu", state.opt_state["mu"]),
                      ("nu", state.opt_state["nu"])):
        for path, leaf in tree.leaves_with_path(t):
            key = f"{prefix}/{_jax_key(path)}"
            out[key] = out.get(key, 0) + leaf.numel()
    return out


def _run_steps(step, state, batches, put):
    hist = []
    for b in batches:
        state, m = step(state, put(b))
        hist.append([float(m["loss"]), float(m["grad_norm"])])
    return state, hist


# -- jobs -------------------------------------------------------------------


def job_parallel(workdir: Path) -> None:
    """Every case of ``spec["cases"]`` on its group: "a" = ranks {0, 1},
    "b" = ranks {2, 3} (both at once), "world" = all four. Writes the
    losses and grad norms, the gathered params and each rank's element
    counts."""
    import torch.distributed as dist

    from pytorch_distributed_tpu_torch.models import get_model
    from pytorch_distributed_tpu_torch.parallel.api import (
        make_parallel_train_step,
    )
    from pytorch_distributed_tpu_torch.parallel.mesh import make_mesh
    from pytorch_distributed_tpu_torch.parallel.sharding import (
        shard_train_state,
    )
    from pytorch_distributed_tpu_torch.train.checkpoint import gather_state
    from pytorch_distributed_tpu_torch.train.optim import make_optimizer
    from pytorch_distributed_tpu_torch.train.state import init_train_state

    spec, rank = _setup(workdir)
    cfg, tcfg, mesh_cfg = _cfgs(spec)
    groups = {"a": dist.new_group([0, 1]), "b": dist.new_group([2, 3]),
              "world": dist.group.WORLD}
    members = {"a": (0, 1), "b": (2, 3), "world": (0, 1, 2, 3)}
    batches = _batches(workdir)
    model = get_model(cfg)
    for case in spec["cases"]:
        if rank not in members[case["group"]]:
            continue
        mcfg = mesh_cfg(case["mesh"])
        mesh = make_mesh(mcfg, group=groups[case["group"]], device="cpu")
        tx = make_optimizer(tcfg)
        state = init_train_state(_params(workdir, cfg), tx)
        state, sharding = shard_train_state(state, mesh)
        step, put = make_parallel_train_step(model, cfg, tx, mesh, mcfg,
                                             sharding)
        name = case["name"]
        (workdir / f"numel_{name}_{mesh.rank}.json").write_text(
            json.dumps(_numel_by_jax_leaf(state)))
        state, hist = _run_steps(step, state, batches, put)
        full = gather_state(state, sharding)
        if mesh.rank == 0:
            _save_params(workdir / f"params_{name}.npz", full.params, cfg)
            (workdir / f"hist_{name}.json").write_text(json.dumps(hist))


def job_world1(workdir: Path) -> None:
    """A world of one: the DistributedTrainer's step (auto and explicit)
    under each strategy against the single-device Trainer's, and the
    DistributedTrainer's loop against the Trainer's loop. Writes whether
    each is bit-equal."""
    import torch

    from pytorch_distributed_tpu_torch.models import get_model
    from pytorch_distributed_tpu_torch.parallel import zero
    from pytorch_distributed_tpu_torch.parallel.mesh import make_mesh
    from pytorch_distributed_tpu_torch.train.distributed_trainer import (
        DistributedTrainer,
    )
    from pytorch_distributed_tpu_torch.train.trainer import Trainer
    from pytorch_distributed_tpu_torch.utils import tree

    spec, _ = _setup(workdir)
    cfg, tcfg, mesh_cfg = _cfgs(spec)
    model = get_model(cfg)
    batches = _batches(workdir)
    quiet = dict(log_fn=lambda s: None)

    def run(trainer):
        state = trainer.init_state()
        hist = []
        for b in batches:
            state, m = trainer.train_step(state, trainer.put_batch(b))
            hist.append((m["loss"].item(), m["grad_norm"].item()))
        return hist, [p.clone() for p in tree.leaves(state.params)]

    ref = run(Trainer(model, cfg, tcfg, device="cpu", **quiet))
    out = {}
    for strategy in ("no_shard", "full_shard", "shard_grad_op",
                     "shard_opt"):
        for path in ("auto", "explicit"):
            mcfg = mesh_cfg(dict(strategy=strategy))
            tr = DistributedTrainer(model, cfg, tcfg,
                                    make_mesh(mcfg, device="cpu"), mcfg,
                                    path=path, **quiet)
            before = zero.collectives
            hist, params = run(tr)
            out[f"{strategy}/{path}"] = dict(
                loss_equal=hist == ref[0],
                params_equal=all(torch.equal(a, b)
                                 for a, b in zip(params, ref[1])),
                collectives=zero.collectives - before)
    # The loops, on a loader of [B, T] batches.
    loader = [(b["inputs"][i], b["targets"][i]) for b in batches
              for i in range(b["inputs"].shape[0])]
    mcfg = mesh_cfg(dict(strategy="full_shard"))
    _, h1 = Trainer(model, cfg, tcfg, device="cpu", **quiet).train(loader)
    _, h2 = DistributedTrainer(model, cfg, tcfg,
                               make_mesh(mcfg, device="cpu"), mcfg,
                               **quiet).train(loader)
    out["loop"] = dict(loss_equal=[h["loss"] for h in h1]
                       == [h["loss"] for h in h2], steps=h2[-1]["step"])
    (workdir / "world1.json").write_text(json.dumps(out))


def job_trainer(workdir: Path) -> None:
    """Two ranks: the DistributedTrainer's loop on a rank-sliced loader
    (no_shard and full_shard, the spec's weights), its evaluate, and the
    guard's skip of a bad batch that only rank 1's slice holds."""
    import numpy as np
    import torch.distributed as dist

    from pytorch_distributed_tpu_torch.data import (
        DistributedTokenShardLoader,
    )
    from pytorch_distributed_tpu_torch.models import get_model
    from pytorch_distributed_tpu_torch.parallel.mesh import make_mesh
    from pytorch_distributed_tpu_torch.parallel.sharding import (
        shard_train_state,
    )
    from pytorch_distributed_tpu_torch.train.checkpoint import gather_state
    from pytorch_distributed_tpu_torch.train.distributed_trainer import (
        DistributedTrainer,
    )
    from pytorch_distributed_tpu_torch.train.guard import init_guard_state
    from pytorch_distributed_tpu_torch.train.state import init_train_state
    from pytorch_distributed_tpu_torch.utils import tree

    spec, rank = _setup(workdir)
    cfg, tcfg, mesh_cfg = _cfgs(spec)
    model = get_model(cfg)
    paths = sorted(str(p) for p in (workdir / "shards").glob("*.bin"))
    out: dict = {}
    for strategy, mesh_kw in spec["meshes"].items():
        mcfg = mesh_cfg(dict(mesh_kw, strategy=strategy))
        mesh = make_mesh(mcfg, device="cpu")
        tr = DistributedTrainer(model, cfg, tcfg, mesh, mcfg,
                                path=spec["path"], log_fn=lambda s: None)
        tr.init_state()
        state, _ = shard_train_state(
            init_train_state(_params(workdir, cfg), tr.tx), mesh)
        loader = DistributedTokenShardLoader(paths, tcfg.micro_batch_size,
                                             spec["seq_len"])
        out[f"loader_rank_{strategy}"] = [loader.rank, loader.world_size]
        state, hist = tr.train(loader, state=state)
        out[strategy] = [h["loss"] for h in hist]
        val = DistributedTokenShardLoader(paths, tcfg.micro_batch_size,
                                          spec["seq_len"])
        out[f"eval_{strategy}"] = tr.evaluate(state, val, max_batches=2)
        full = gather_state(state, tr.sharding)  # collective
        if rank == 0:
            _save_params(workdir / f"trainer_params_{strategy}.npz",
                         full.params, cfg)
    # The guard: the third step's batch holds an out-of-range id in rank
    # 1's rows only; both ranks must skip that step alike.
    gcfg = dataclasses.replace(tcfg, anomaly_guard=True, num_steps=4,
                               log_every_n_steps=4,
                               guard_rollback_after=None)
    mcfg = mesh_cfg(dict(data=2, strategy="no_shard"))
    mesh = make_mesh(mcfg, device="cpu")
    tr = DistributedTrainer(model, cfg, gcfg, mesh, mcfg,
                            log_fn=lambda s: None)
    tr.init_state()
    state, _ = shard_train_state(init_train_state(
        _params(workdir, cfg), tr.tx,
        guard=init_guard_state(mesh.device)), mesh)
    rng = np.random.default_rng(7)
    b = tcfg.micro_batch_size
    loader = []
    for i in range(4 * tr.accum):
        x = rng.integers(0, cfg.vocab_size, (b, spec["seq_len"]))
        if i == 2 * tr.accum and rank == 1:
            x[0, 3] = cfg.vocab_size + 5
        loader.append((x, rng.integers(0, cfg.vocab_size,
                                       (b, spec["seq_len"]))))
    state, hist = tr.train(loader, state=state)
    leaves = [p.detach().numpy().tobytes() for p in
              tree.leaves(state.params)]
    out["guard"] = dict(anomalies=hist[-1]["anomalies"],
                        step=state.step, params_sha=hashlib.sha256(
                            b"".join(leaves)).hexdigest(),
                        count=int(state.opt_state["count"]))
    (workdir / f"trainer_{rank}.json").write_text(json.dumps(out))
    dist.barrier()


def job_ckpt(workdir: Path) -> None:
    """Two ranks, full_shard over fsdp 2: 2 steps, a save in each format,
    1 more step (the reference); then each save restored into a fresh
    sharded state and 1 step, and the orbax save restored onto no_shard.
    Writes losses and parameter bytes' hashes."""
    import torch.distributed as dist

    from pytorch_distributed_tpu_torch.models import get_model
    from pytorch_distributed_tpu_torch.parallel.api import (
        make_parallel_train_step,
    )
    from pytorch_distributed_tpu_torch.parallel.mesh import make_mesh
    from pytorch_distributed_tpu_torch.parallel.sharding import (
        local_numel,
        shard_train_state,
    )
    from pytorch_distributed_tpu_torch.train import checkpoint as ckpt
    from pytorch_distributed_tpu_torch.train.optim import make_optimizer
    from pytorch_distributed_tpu_torch.train.state import init_train_state
    from pytorch_distributed_tpu_torch.utils import tree

    spec, rank = _setup(workdir)
    cfg, tcfg, mesh_cfg = _cfgs(spec)
    model = get_model(cfg)
    batches = _batches(workdir)

    def build(strategy):
        mcfg = mesh_cfg(dict(fsdp=2, strategy=strategy))
        mesh = make_mesh(mcfg, device="cpu")
        tx = make_optimizer(tcfg)

        def fresh(name="params.npz"):
            return shard_train_state(init_train_state(
                _params(workdir, cfg, name), tx), mesh)

        state, sharding = fresh()
        step, put = make_parallel_train_step(model, cfg, tx, mesh, mcfg,
                                             sharding)
        return fresh, sharding, step, put

    def digest(state):
        h = hashlib.sha256()
        for t in tree.leaves([state.params, state.opt_state["mu"],
                              state.opt_state["nu"]]):
            h.update(t.detach().numpy().tobytes())
        return h.hexdigest()

    fresh, sharding, step, put = build("full_shard")
    state, _ = fresh()
    state, _ = _run_steps(step, state, batches[:2], put)
    out: dict = {"local_numel": local_numel(state)}
    for fmt in ("orbax", "npz"):
        ckpt.save_checkpoint(workdir / fmt, state, cfg, format=fmt,
                             sharding=sharding, metadata={"step": 2})
    full = ckpt.gather_state(state, sharding)  # collective
    if rank == 0:  # before the next step updates the state in place
        _save_params(workdir / "ckpt_params.npz", full.params, cfg)
    ref_state, ref_hist = _run_steps(step, state, batches[2:], put)
    out["ref"] = dict(hist=ref_hist, digest=digest(ref_state))
    for fmt in ("orbax", "npz"):
        like, _ = fresh("other.npz")
        restored = ckpt.load_checkpoint(workdir / fmt, like, cfg,
                                        sharding=sharding)
        out[f"{fmt}_step"] = restored.step
        new_state, hist = _run_steps(step, restored, batches[2:], put)
        out[fmt] = dict(hist=hist, digest=digest(new_state))
    # Resharding: the fsdp-2 orbax save restored onto no_shard.
    fresh_ns, sharding_ns, step_ns, put_ns = build("no_shard")
    like, _ = fresh_ns("other.npz")
    restored = ckpt.load_checkpoint(workdir / "orbax", like, cfg,
                                    sharding=sharding_ns)
    _, hist = _run_steps(step_ns, restored, batches[2:], put_ns)
    out["onto_no_shard"] = dict(hist=hist)
    (workdir / f"ckpt_{rank}.json").write_text(json.dumps(out))
    dist.barrier()


def job_ckpt_kill(workdir: Path) -> None:
    """Two ranks save twice (orbax); rank 0 is killed at the second save's
    pre-commit hook, after every shard is written."""
    from pytorch_distributed_tpu_torch.parallel.mesh import make_mesh
    from pytorch_distributed_tpu_torch.parallel.sharding import (
        shard_train_state,
    )
    from pytorch_distributed_tpu_torch.train import checkpoint as ckpt
    from pytorch_distributed_tpu_torch.train.optim import make_optimizer
    from pytorch_distributed_tpu_torch.train.state import init_train_state

    spec, rank = _setup(workdir)
    cfg, tcfg, mesh_cfg = _cfgs(spec)
    mesh = make_mesh(mesh_cfg(dict(fsdp=2, strategy="full_shard")),
                     device="cpu")
    state, sharding = shard_train_state(init_train_state(
        _params(workdir, cfg), make_optimizer(tcfg)), mesh)
    root = workdir / "kill"
    ckpt.save_checkpoint(root / "checkpoint_step_1", state, cfg,
                         format="orbax", sharding=sharding)
    if rank == 0:
        ckpt.set_save_hook(lambda stage, d: os._exit(43))
    ckpt.save_checkpoint(root / "checkpoint_step_2", state._replace(step=2),
                         cfg, format="orbax", sharding=sharding)


JOBS = {"parallel": job_parallel, "world1": job_world1,
        "trainer": job_trainer, "ckpt": job_ckpt,
        "ckpt_kill": job_ckpt_kill}

if __name__ == "__main__":
    # The tensor- and sequence-parallel jobs live beside this file and
    # import from it.
    from _torch_seq_jobs import SEQ_JOBS
    from _torch_tp_jobs import TP_JOBS

    JOBS.update(TP_JOBS)
    JOBS.update(SEQ_JOBS)
    job, workdir = sys.argv[1], Path(sys.argv[2])
    try:
        JOBS[job](workdir)
    finally:
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()
