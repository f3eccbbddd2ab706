"""The rank side of the port's pipeline and prefetch-window tests
(``_torch_dist_worker`` runs ``job_pipe_train`` on four or eight gloo
ranks, ``job_layer_scan`` on two, ``job_cuda_pipe`` on two sharing cuda:0; no
JAX here).

Each job reads ``spec.json`` and the inputs the test wrote (the JAX
params as npz, stacked [L, ...]; each stage takes its layers through
``interop.stage_params_from_jax``), runs every case on its group ("a" =
ranks {0, 1}, "b" = {2, 3}, both at once, or "world"), and writes
``out_<rank>.json`` plus the gathered params of each case as npz.
"""

from __future__ import annotations

import hashlib
import json
from pathlib import Path

import numpy as np

from _torch_dist_worker import _save_params, _setup

# On eight ranks "world" is still ranks 0-3; "b4" is 4-7 and "all8" all.
MEMBERS = {"a": (0, 1), "b": (2, 3), "world": (0, 1, 2, 3),
           "b4": (4, 5, 6, 7), "all8": tuple(range(8))}


def _groups():
    import torch.distributed as dist

    groups = {"a": dist.new_group([0, 1]), "b": dist.new_group([2, 3]),
              "world": dist.group.WORLD}
    if dist.get_world_size() == 8:
        # Every rank joins as many groups ([4, 5] and [6, 7] to match "a"
        # and "b"): ``make_mesh``'s groups, made by their members alone,
        # are named by their ranks and by how many groups a rank holds.
        dist.new_group([4, 5])
        dist.new_group([6, 7])
        groups.update(world=dist.new_group([0, 1, 2, 3]),
                      b4=dist.new_group([4, 5, 6, 7]),
                      all8=dist.group.WORLD)
    return groups


def _jax_tree(workdir: Path, name: str) -> dict:
    from pytorch_distributed_tpu_torch.train.checkpoint import _unflatten

    with np.load(workdir / name) as f:
        return _unflatten("params", {k: f[k] for k in f.files})


def _counts() -> dict:
    from pytorch_distributed_tpu_torch.ops import flash_kernel as fk
    from pytorch_distributed_tpu_torch.ops import moe
    from pytorch_distributed_tpu_torch.parallel import pipeline

    return dict(k1=fk.plain_calls["forward"], k2=fk.plain_calls["backward"],
                sends=pipeline.sends, all_to_alls=moe.all_to_alls)


def _since(c0: dict) -> dict:
    return {k: v - c0[k] for k, v in _counts().items()}


def _digest(tensors) -> str:
    return hashlib.sha256(b"".join(
        t.detach().contiguous().numpy().tobytes()
        for t in tensors)).hexdigest()


def _stage_state(workdir, cfg, weights, mesh, tx):
    """This rank's stage of the JAX weights ``weights``, sharded."""
    from pytorch_distributed_tpu_torch import interop
    from pytorch_distributed_tpu_torch.parallel.sharding import (
        shard_train_state,
    )
    from pytorch_distributed_tpu_torch.train.state import init_train_state

    params = interop.stage_params_from_jax(
        _jax_tree(workdir, weights), cfg, mesh.axis_index("pipe"),
        mesh.cfg.pipe)
    return shard_train_state(init_train_state(params, tx), mesh)


def _pipe_steps(workdir: Path, rank: int, groups: dict, spec: dict,
                batch) -> dict:
    """Each step case: one pipeline step on its mesh, its loss, grad norm,
    stage and counts (K1/K2 plain calls, pipe sends); the params gathered
    (every stage's layers) and saved by the mesh's rank 0."""
    from pytorch_distributed_tpu_torch.config import (
        MeshConfig,
        ModelConfig,
        TrainConfig,
    )
    from pytorch_distributed_tpu_torch.models import get_model
    from pytorch_distributed_tpu_torch.parallel.mesh import (
        make_batch_put,
        make_mesh,
    )
    from pytorch_distributed_tpu_torch.parallel.pipeline import (
        make_pipeline_train_step,
    )
    from pytorch_distributed_tpu_torch.train import checkpoint as ckpt
    from pytorch_distributed_tpu_torch.train.optim import make_optimizer

    tcfg = TrainConfig(**spec["train"])
    out = {}
    for case in spec["steps"]:
        name = case["name"]
        if rank not in MEMBERS[case["group"]]:
            continue
        cfg = ModelConfig(**spec["models"][case["model"]])
        mcfg = MeshConfig(**case["mesh"], pipe_schedule=case["schedule"])
        mesh = make_mesh(mcfg, group=groups[case["group"]], device="cpu")
        tx = make_optimizer(tcfg, with_clip=False)
        state, sh = _stage_state(workdir, cfg, spec["weights"][case["model"]],
                                 mesh, tx)
        step = make_pipeline_train_step(
            get_model(cfg), cfg, tx, mesh, mcfg, sh,
            grad_clip_norm=case.get("clip"))
        c0 = _counts()
        state, m = step(state, make_batch_put(mesh)(batch))
        out[name] = dict(loss=float(m["loss"]),
                         grad_norm=float(m["grad_norm"]),
                         stage=mesh.axis_index("pipe"), **_since(c0))
        full = ckpt.gather_state(state, sh)
        if mesh.rank == 0:
            _save_params(workdir / f"params_{name}.npz", full.params, cfg)
        del state, full
    return out


def _dropout(workdir: Path, rank: int, groups: dict, spec: dict,
             batch) -> dict:
    """GPT-2 with dropout 0.1 at pipe 2 (both schedules, group "a")
    against the port's single-device step on the same weights and seed:
    (loss, grad norm, the largest param difference) of each."""
    import torch

    from pytorch_distributed_tpu_torch import interop
    from pytorch_distributed_tpu_torch.config import (
        MeshConfig,
        ModelConfig,
        TrainConfig,
    )
    from pytorch_distributed_tpu_torch.models import get_model
    from pytorch_distributed_tpu_torch.parallel.mesh import (
        make_batch_put,
        make_mesh,
    )
    from pytorch_distributed_tpu_torch.parallel.pipeline import (
        make_pipeline_train_step,
    )
    from pytorch_distributed_tpu_torch.train import checkpoint as ckpt
    from pytorch_distributed_tpu_torch.train.optim import make_optimizer
    from pytorch_distributed_tpu_torch.train.state import init_train_state
    from pytorch_distributed_tpu_torch.train.trainer import make_train_step
    from pytorch_distributed_tpu_torch.utils import tree

    if rank not in MEMBERS["a"]:
        return {}
    cfg = ModelConfig(**dict(spec["models"]["gpt2"], embd_pdrop=0.1,
                             attn_pdrop=0.1, resid_pdrop=0.1))
    model = get_model(cfg)
    tcfg = TrainConfig(**spec["train"])
    tx = make_optimizer(tcfg, with_clip=False)
    whole = interop.params_from_jax(_jax_tree(workdir, "gpt2.npz"), cfg)
    ref, ref_m = make_train_step(model, cfg, tx)(
        init_train_state(whole, tx),
        {k: torch.as_tensor(v) for k, v in batch.items()})
    out = {}
    for schedule in ("gpipe", "1f1b"):
        mcfg = MeshConfig(pipe=2, strategy="no_shard",
                          pipe_schedule=schedule)
        mesh = make_mesh(mcfg, group=groups["a"], device="cpu")
        state, sh = _stage_state(workdir, cfg, "gpt2.npz", mesh, tx)
        step = make_pipeline_train_step(model, cfg, tx, mesh, mcfg, sh)
        state, m = step(state, make_batch_put(mesh)(batch))
        full = ckpt.gather_state(state, sh)
        out[schedule] = dict(
            loss=float(m["loss"]), ref_loss=float(ref_m["loss"]),
            grad_norm=float(m["grad_norm"]),
            ref_grad_norm=float(ref_m["grad_norm"]),
            max_param_diff=max(float((a - b).abs().max()) for a, b in zip(
                tree.leaves(full.params), tree.leaves(ref.params))))
    return out


def _checkpoint(workdir: Path, spec: dict, batch) -> dict:
    """The sharded checkpoint across pipe: a state after one step at
    pipe 2 x fsdp 2 (full_shard) saved in both formats and restored at
    pipe 1 whole; a state after one step at fsdp 4 (pipe 1) saved and
    restored onto pipe 2 x fsdp 2. Each restore held bit for bit."""
    import torch

    from pytorch_distributed_tpu_torch import interop
    from pytorch_distributed_tpu_torch.config import (
        MeshConfig,
        ModelConfig,
        TrainConfig,
    )
    from pytorch_distributed_tpu_torch.models import get_model
    from pytorch_distributed_tpu_torch.parallel.api import (
        make_parallel_train_step,
    )
    from pytorch_distributed_tpu_torch.parallel.mesh import (
        make_batch_put,
        make_mesh,
    )
    from pytorch_distributed_tpu_torch.parallel.pipeline import (
        make_pipeline_train_step,
        shard_pipeline_state,
    )
    from pytorch_distributed_tpu_torch.parallel.sharding import (
        shard_slice,
        shard_train_state,
        stage_state,
    )
    from pytorch_distributed_tpu_torch.train import checkpoint as ckpt
    from pytorch_distributed_tpu_torch.train.optim import make_optimizer
    from pytorch_distributed_tpu_torch.train.state import init_train_state
    from pytorch_distributed_tpu_torch.utils import tree

    tcfg = TrainConfig(**spec["train"])
    cfg = ModelConfig(**spec["models"]["gpt2"])
    model = get_model(cfg)
    tx = make_optimizer(tcfg, with_clip=False)

    def leaves(s):
        return tree.leaves([s.params, s.opt_state["mu"], s.opt_state["nu"]])

    def fresh():
        return init_train_state(interop.params_from_jax(
            _jax_tree(workdir, "other.npz"), cfg), tx)

    out = {}
    mcfg = MeshConfig(pipe=2, fsdp=2, strategy="full_shard")
    mesh = make_mesh(mcfg, device="cpu")
    state, sh = _stage_state(workdir, cfg, "gpt2.npz", mesh, tx)
    step = make_pipeline_train_step(model, cfg, tx, mesh, mcfg, sh)
    state, _ = step(state, make_batch_put(mesh)(batch))
    for fmt in ("orbax", "npz"):
        ckpt.save_checkpoint(workdir / f"pipe2_{fmt}", state, cfg,
                             format=fmt, sharding=sh, metadata={"step": 1})
    full = ckpt.gather_state(state, sh)
    for fmt in ("orbax", "npz"):
        whole = ckpt.load_checkpoint(workdir / f"pipe2_{fmt}", fresh(), cfg)
        out[f"pipe2_to_pipe1_{fmt}_bit_equal"] = whole.step == 1 and all(
            torch.equal(a, b) for a, b in zip(leaves(whole), leaves(full)))
    out["pipe2_files"] = sorted(
        p.name for p in (workdir / "pipe2_orbax" / "tree").iterdir())
    # pipe 1 (fsdp 4) -> pipe 2 x fsdp 2
    mcfg4 = MeshConfig(fsdp=4, strategy="full_shard")
    mesh4 = make_mesh(mcfg4, device="cpu")
    state4, sh4 = shard_train_state(init_train_state(
        interop.params_from_jax(_jax_tree(workdir, "gpt2.npz"), cfg), tx),
        mesh4)
    step4, put4 = make_parallel_train_step(model, cfg, tx, mesh4, mcfg4,
                                           sh4)
    state4, _ = step4(state4, put4(batch))
    ckpt.save_checkpoint(workdir / "pipe1", state4, cfg, format="orbax",
                         sharding=sh4, metadata={"step": 1})
    full4 = stage_state(ckpt.gather_state(state4, sh4), mesh)
    like, _ = shard_pipeline_state(fresh(), mesh)
    got = ckpt.load_checkpoint(workdir / "pipe1", like, cfg, sharding=sh)
    want = [shard_slice(t, s, mesh) for t, s in zip(
        leaves(full4), tree.leaves([sh.params, sh.opt_state["mu"],
                                    sh.opt_state["nu"]]))]
    out["pipe1_to_pipe2_bit_equal"] = got.step == 1 and all(
        torch.equal(a, b) for a, b in zip(leaves(got), want))
    return out


def _trainer(workdir: Path, rank: int, groups: dict, spec: dict) -> dict:
    """The ``DistributedTrainer``'s loop on ``path="pipeline"`` at pipe 2 x
    data 2 (1F1B, world) and on the explicit path at data 2 (each pair),
    on the same global batches: each loop's losses, and the pipeline's
    ``evaluate``."""
    import dataclasses

    from pytorch_distributed_tpu_torch import interop
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
    from pytorch_distributed_tpu_torch.train.distributed_trainer import (
        DistributedTrainer,
    )
    from pytorch_distributed_tpu_torch.train.state import init_train_state

    cfg = ModelConfig(**spec["models"]["gpt2"])
    tcfg = dataclasses.replace(TrainConfig(**spec["train"]), num_steps=2,
                               global_batch_size=16, micro_batch_size=4,
                               log_every_n_steps=1)
    rng = np.random.default_rng(11)
    loader = [(rng.integers(0, cfg.vocab_size, (8, cfg.n_ctx)),
               rng.integers(0, cfg.vocab_size, (8, cfg.n_ctx)))
              for _ in range(4)]
    out = {}
    for name, mesh_kw, path, group in (
            ("pipeline", dict(pipe=2, data=2, strategy="no_shard",
                              pipe_schedule="1f1b"), "pipeline", "world"),
            ("explicit", dict(data=2, strategy="no_shard"), "explicit",
             "a" if rank in MEMBERS["a"] else "b")):
        mcfg = MeshConfig(**mesh_kw)
        mesh = make_mesh(mcfg, group=groups[group], device="cpu")
        tr = DistributedTrainer(get_model(cfg), cfg, tcfg, mesh, mcfg,
                                path=path, log_fn=lambda s: None)
        tr.init_state()
        whole = init_train_state(interop.params_from_jax(
            _jax_tree(workdir, "gpt2.npz"), cfg), tr.tx)
        if path == "pipeline":
            from pytorch_distributed_tpu_torch.parallel.pipeline import (
                shard_pipeline_state,
            )

            state, _ = shard_pipeline_state(whole, mesh)
        else:
            state, _ = shard_train_state(whole, mesh)
        state, hist = tr.train(loader, state=state)
        out[name] = [h["loss"] for h in hist]
        if path == "pipeline":
            val = [(x[:4], y[:4]) for x, y in loader[:2]]
            out["pipeline_eval"] = tr.evaluate(state, val)
    return out


def job_pipe_train(workdir: Path) -> None:
    """The step cases, dropout, the checkpoint and the trainer's loop
    (``tests/test_torch_pipeline*.py``); the spec's ``parts`` picks
    which."""
    import torch.distributed as dist

    spec, rank = _setup(workdir)
    groups = _groups()
    with np.load(workdir / "batch.npz") as f:
        batch = {k: f[k] for k in f.files}
    out: dict = {"rank": rank}
    out["steps"] = _pipe_steps(workdir, rank, groups, spec, batch)
    parts = spec.get("parts", [])
    if "dropout" in parts:
        out["dropout"] = _dropout(workdir, rank, groups, spec, batch)
    if "ckpt" in parts:
        out["ckpt"] = _checkpoint(workdir, spec, batch)
    if "trainer" in parts:
        out["trainer"] = _trainer(workdir, rank, groups, spec)
    (workdir / f"out_{rank}.json").write_text(json.dumps(out))
    dist.barrier()


def job_layer_scan(workdir: Path) -> None:
    """Two ranks: the explicit full_shard step at fsdp 2 under each remat
    mode of ``spec["prefetch"]`` at each of its windows (loss, grad norm,
    the params' digest; the params saved for prefetch 0 and 1 under
    ``names``), the no_shard step at data 2 at prefetch 0 and 1, whether
    each step's layer loop ran a window, and ``generate_fsdp`` at prefetch 0 and 1 (greedy and
    sampled tokens; prefetch 1's against its monolithic loop)."""
    import torch
    import torch.distributed as dist

    from pytorch_distributed_tpu_torch import interop
    from pytorch_distributed_tpu_torch.config import (
        MeshConfig,
        ModelConfig,
        TrainConfig,
    )
    from pytorch_distributed_tpu_torch.models import decode, get_model
    from pytorch_distributed_tpu_torch.ops import layer_scan
    from pytorch_distributed_tpu_torch.parallel import zero
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

    # Whether a step's layer loop ran a window: the checkpoints it made.
    made: list = []
    apply_remat = layer_scan.apply_remat

    def spy(fn, mode):
        made.append(fn.__name__)
        return apply_remat(fn, mode)

    layer_scan.apply_remat = spy
    spec, rank = _setup(workdir)
    with np.load(workdir / "batch.npz") as f:
        batch = {k: f[k] for k in f.files}
    tcfg = TrainConfig(**spec["train"])
    out: dict = {"rank": rank, "steps": {}, "windowed": {}}
    # full_shard at fsdp 2 under each remat mode and window, then
    # no_shard at data 2 ("data/"), which has no gathers to prefetch.
    runs = [("", remat, pf) for remat, pfs in spec["prefetch"].items()
            for pf in pfs] + [("data/", "names", pf) for pf in (0, 1)]
    for axis, remat, pf in runs:
        cfg = ModelConfig(**dict(spec["model"], remat=remat))
        mcfg = (MeshConfig(data=2, prefetch_buffers=pf) if axis else
                MeshConfig(fsdp=2, strategy="full_shard",
                           prefetch_buffers=pf))
        mesh = make_mesh(mcfg, device="cpu")
        tx = make_optimizer(tcfg)
        state, sh = shard_train_state(init_train_state(
            interop.params_from_jax(_jax_tree(workdir, "params.npz"), cfg),
            tx), mesh)
        step, put = make_parallel_train_step(get_model(cfg), cfg, tx, mesh,
                                             mcfg, sh)
        c0 = zero.collectives
        made.clear()
        state, m = step(state, put(batch))
        out["windowed"][f"{axis}{remat}/{pf}"] = "window_body" in made
        full = ckpt.gather_state(state, sh)
        out["steps"][f"{axis}{remat}/{pf}"] = dict(
            loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
            collectives=zero.collectives - c0,
            digest=_digest(tree.leaves([full.params, full.opt_state["mu"],
                                        full.opt_state["nu"]])))
        if rank == 0 and not axis and remat == "names" and pf < 2:
            _save_params(workdir / f"params_pf{pf}.npz", full.params, cfg)
    cfg = ModelConfig(**spec["model"])
    params = interop.params_from_jax(_jax_tree(workdir, "params.npz"), cfg)
    prompt = np.random.default_rng(5).integers(0, cfg.vocab_size, (3, 5))
    out["generate"] = {}
    for pf in (0, 1):
        mcfg = MeshConfig(fsdp=2, strategy="full_shard", prefetch_buffers=pf)
        for temp in (0.0, 0.8):
            toks = decode.generate_fsdp(params, prompt, cfg, mcfg, 6,
                                        temperature=temp, seed=3,
                                        device="cpu")
            got = out["generate"][f"{pf}/{temp}"] = dict(
                tokens=toks.tolist())
            if pf:
                got["monolithic_equal"] = bool(torch.equal(
                    toks, decode.generate_fsdp_monolithic(
                        params, prompt, cfg, mcfg, 6, temperature=temp,
                        seed=3, device="cpu")))
    (workdir / f"out_{rank}.json").write_text(json.dumps(out))
    dist.barrier()


def job_cuda_pipe(workdir: Path) -> None:
    """On the card, two gloo ranks sharing cuda:0: one GPipe and one 1F1B
    step of a 2-layer GPT-2 at pipe 2 (every hop a CUDA tensor staged
    through the host) against the single-device step, and one layer's
    windowed gathers (``LayerGather.issue``) at fsdp 2 against the
    synchronous gather, forward and backward."""
    import torch
    import torch.distributed as dist

    from pytorch_distributed_tpu_torch.config import (
        MeshConfig,
        ModelConfig,
        TrainConfig,
    )
    from pytorch_distributed_tpu_torch.models import get_model
    from pytorch_distributed_tpu_torch.parallel import pipeline, zero
    from pytorch_distributed_tpu_torch.parallel.mesh import (
        make_batch_put,
        make_mesh,
    )
    from pytorch_distributed_tpu_torch.parallel.pipeline import (
        make_pipeline_train_step,
        shard_pipeline_state,
    )
    from pytorch_distributed_tpu_torch.train import checkpoint as ckpt
    from pytorch_distributed_tpu_torch.train.optim import make_optimizer
    from pytorch_distributed_tpu_torch.train.state import init_train_state
    from pytorch_distributed_tpu_torch.train.trainer import make_train_step
    from pytorch_distributed_tpu_torch.utils import tree

    _, rank = _setup(workdir)
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = ModelConfig(vocab_size=128, n_ctx=16, n_embd=64, n_layer=2,
                      n_head=4, dtype="float32", embd_pdrop=0.0,
                      attn_pdrop=0.0, resid_pdrop=0.0)
    model = get_model(cfg)
    tx = make_optimizer(TrainConfig(global_batch_size=8, micro_batch_size=4,
                                    learning_rate=1e-3), with_clip=False)
    params = model.init(torch.Generator().manual_seed(0), cfg, device=dev)
    rng = np.random.default_rng(0)
    batch = dict(inputs=rng.integers(0, 128, (2, 4, 16)),
                 targets=rng.integers(0, 128, (2, 4, 16)))
    ref, ref_m = make_train_step(model, cfg, tx)(
        init_train_state(tree.map_tree(torch.clone, params), tx),
        {k: torch.as_tensor(v, device=dev) for k, v in batch.items()})
    out = dict(rank=rank)
    for schedule in ("gpipe", "1f1b"):
        mcfg = MeshConfig(pipe=2, strategy="no_shard",
                          pipe_schedule=schedule)
        mesh = make_mesh(mcfg, device=dev)
        state, sh = shard_pipeline_state(
            init_train_state(tree.map_tree(torch.clone, params), tx), mesh)
        step = make_pipeline_train_step(model, cfg, tx, mesh, mcfg, sh)
        s0 = pipeline.sends
        state, m = step(state, make_batch_put(mesh)(batch))
        full = ckpt.gather_state(state, sh)
        out[schedule] = dict(
            loss=float(m["loss"]), ref_loss=float(ref_m["loss"]),
            sends=pipeline.sends - s0,
            device=str(state.params["blocks"][0]["ln_1"]["scale"].device),
            max_param_diff=max(float((a - b).abs().max()) for a, b in zip(
                tree.leaves(full.params), tree.leaves(ref.params))))
    # One layer's gathers, windowed against synchronous, at fsdp 2.
    fmesh = make_mesh(MeshConfig(fsdp=2, strategy="full_shard"), device=dev)
    specs = {"w": ("fsdp", None), "b": ()}
    g = torch.Generator().manual_seed(1 + rank)
    shard = {"w": torch.randn(4, 3, generator=g).to(dev).requires_grad_(),
             "b": torch.randn(3, generator=g).to(dev).requires_grad_()}
    gather = zero.LayerGather(specs, fmesh)
    sync = gather(shard)
    (sync["w"] * sync["w"]).sum().backward()
    sync_grad = shard["w"].grad.clone()
    shard["w"].grad = None
    windowed = gather.issue(shard)()
    (windowed["w"] * windowed["w"]).sum().backward()
    out["window"] = dict(
        forward_equal=bool(torch.equal(sync["w"], windowed["w"])),
        backward_equal=bool(torch.equal(sync_grad, shard["w"].grad)),
        shape=list(windowed["w"].shape), device=str(windowed["w"].device))
    (workdir / f"out_{rank}.json").write_text(json.dumps(out))
    dist.barrier()


PIPE_JOBS = {"pipe_train": job_pipe_train, "layer_scan": job_layer_scan,
             "cuda_pipe": job_cuda_pipe}
