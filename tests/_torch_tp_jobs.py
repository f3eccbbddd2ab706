"""The rank side of the port's tensor-parallel and ZeRO-3 decode tests
(``_torch_dist_worker`` runs them; no JAX here).

Each job runs on every rank of one gloo group, reads ``spec.json`` and
the weights the test wrote (the JAX ``init``'s, sharpened), and writes
``out_<rank>.json``: every case's tokens (and logits, counts) from this
rank, so the test holds them to JAX's and the ranks to each other.
"""

from __future__ import annotations

import json
import time
from pathlib import Path

import numpy as np

import _torch_tp_cases as C
from _torch_dist_worker import _params, _setup


def _write(workdir: Path, rank: int, out: dict) -> None:
    path = workdir / f"out_{rank}.json"
    path.write_text(json.dumps(out))


def _cfg(name):
    from pytorch_distributed_tpu_torch.config import ModelConfig

    return ModelConfig(**C.MODELS[name])


def _tokens(results) -> dict:
    return {str(rid): [r.state, np.asarray(r.tokens).tolist()]
            for rid, r in sorted(results.items())}


# -- ops/tp -------------------------------------------------------------------


def job_tp_ops(workdir: Path) -> None:
    """``tp_copy``/``tp_reduce`` forward and backward on the tensor groups
    of two meshes over four ranks — tensor 4 alone, data 2 x tensor 2 —
    with this rank's inputs from ``spec["ops"]``; and the groups
    ``make_mesh`` built."""
    import torch
    import torch.distributed as dist

    from pytorch_distributed_tpu_torch.config import MeshConfig
    from pytorch_distributed_tpu_torch.ops import tp
    from pytorch_distributed_tpu_torch.parallel.mesh import make_mesh

    spec, rank = _setup(workdir)
    out: dict = {"rank": rank, "cases": {}}
    for name, kw in spec["ops_meshes"].items():
        mesh = make_mesh(MeshConfig(**kw), device="cpu")
        d, t = mesh.coords["data"], mesh.coords["tensor"]
        group = mesh.axis_group("tensor")
        ops = spec["ops"][name]
        x = torch.tensor(ops["x"][d], requires_grad=True)
        w = torch.tensor(ops["w"][d][t], requires_grad=True)
        c = torch.tensor(ops["c"][d])
        c0 = tp.collectives
        y = tp.tp_reduce(tp.tp_copy(x, group) @ w, group)
        fwd = tp.collectives - c0
        (y * c).sum().backward()
        out["cases"][name] = dict(
            coords=[d, t], y=y.tolist(), dx=x.grad.tolist(),
            dw=w.grad.tolist(), fwd_collectives=fwd,
            collectives=tp.collectives - c0,
            group_ranks=dist.get_process_group_ranks(group),
            no_group=torch.equal(tp.tp_reduce(tp.tp_copy(x, None), None),
                                 x),
        )
    _write(workdir, rank, out)


# -- generation ---------------------------------------------------------------


def job_decode_tp(workdir: Path) -> None:
    """``generate_tp``/``generate_fsdp`` and their reference loops on two
    ranks for every model of ``spec["models"]``, greedy and sampled, and
    the TP forward's logits over a prefill and two decode steps."""
    import torch

    from pytorch_distributed_tpu_torch.config import MeshConfig
    from pytorch_distributed_tpu_torch.models import decode
    from pytorch_distributed_tpu_torch.ops import tp
    from pytorch_distributed_tpu_torch.parallel.mesh import make_mesh
    from pytorch_distributed_tpu_torch.parallel.sharding import (
        param_partition_specs,
        shard_params,
    )

    spec, rank = _setup(workdir)
    prompts = np.asarray(C.gen_prompts())
    out: dict = {"rank": rank, "models": {}}
    tp_mesh, z3 = MeshConfig(**C.TP), MeshConfig(**C.ZERO3)
    for name in spec["models"]:
        cfg = _cfg(name)
        params = _params(workdir, cfg, f"{name}.npz")
        res: dict = {}
        kw = dict(device="cpu")
        res["tp"] = decode.generate_tp(params, prompts, cfg, tp_mesh, 8,
                                       **kw).tolist()
        res["tp_monolithic"] = decode.generate_tp_monolithic(
            params, prompts, cfg, tp_mesh, 8, **kw).tolist()
        res["fsdp"] = decode.generate_fsdp(params, prompts, cfg, z3, 8,
                                           **kw).tolist()
        res["fsdp_monolithic"] = decode.generate_fsdp_monolithic(
            params, prompts, cfg, z3, 8, **kw).tolist()
        sample = dict(temperature=0.9, top_k=30, seed=5, **kw)
        res["tp_sampled"] = decode.generate_tp(
            params, prompts, cfg, tp_mesh, 8, **sample).tolist()
        res["fsdp_sampled"] = decode.generate_fsdp(
            params, prompts, cfg, z3, 8, **sample).tolist()
        res["plain_sampled"] = decode.generate(
            params, prompts, cfg, 8, **sample).tolist()
        # The TP forward itself at init scale: a prefill of the prompts,
        # then two single-token steps, over this rank's slices and local
        # heads.
        mesh = make_mesh(tp_mesh, device="cpu")
        init = _params(workdir, cfg, f"{name}_init.npz")
        local = shard_params(init, param_partition_specs(init, tp_mesh),
                             mesh)
        cache = decode.init_cache(cfg, 2, 16, device="cpu",
                                  n_kv=cfg.kv_heads // 2)
        ids = torch.as_tensor(prompts)
        logits, per_fwd = [], []
        with torch.no_grad():
            for step, pos in enumerate((0, 5, 6)):
                c0 = tp.collectives
                lg, _ = decode.forward(local, ids, cfg, cache, pos,
                                       tp_group=mesh.axis_group("tensor"))
                per_fwd.append(tp.collectives - c0)
                logits.append(lg[:, -1].tolist())
                ids = lg[:, -1].argmax(-1)[:, None]
        res["logits"] = logits
        res["collectives_per_forward"] = per_fwd
        res["cache_heads"] = int(cache["k"].shape[3])
        out["models"][name] = res
    _write(workdir, rank, out)


# -- the engines --------------------------------------------------------------


def _registry(cfg, device_tree=False):
    from pytorch_distributed_tpu_torch.serving.adapters import (
        AdapterRegistry,
        _targets,
    )

    reg = AdapterRegistry(cfg, rank=C.LORA_RANK, max_tenants=3)
    for i, tid in enumerate(C.TENANTS):
        reg.register(tid, C.lora_factors(_targets(cfg), 100 + i),
                     scale=2.0)
    return reg


def _decode_only_tick(eng, params) -> int:
    """Step once with every live row decoding: the all-reduces that tick
    issued."""
    from pytorch_distributed_tpu_torch.ops import tp

    before = eng.counters["prefill_ticks"], eng.counters["decode_ticks"]
    c0 = tp.collectives
    eng.step(params)
    after = eng.counters["prefill_ticks"], eng.counters["decode_ticks"]
    assert after == (before[0], before[1] + 1), (before, after)
    return tp.collectives - c0


def _per_tick(make, params, n_rows) -> int:
    """All-reduces of one decode tick with ``n_rows`` rows live."""
    eng = make()
    for i in range(n_rows):
        eng.submit(C.prompt(4 + i, 40 + i), 12)
    while any(s is not None and not s.ready for s in eng._slots) or \
            eng._queue:
        eng.step(params)
    return _decode_only_tick(eng, params)


def _handoff(cfg, params, tp_mesh, kw) -> dict:
    """A TP prefill worker hands every row to a TP decode worker (each
    rank moving its own heads' pages); the decode worker finishes them."""
    from pytorch_distributed_tpu_torch.serving.engine import (
        PagedBatchedDecodeEngine,
    )

    pre = PagedBatchedDecodeEngine(cfg, role="prefill", mesh_cfg=tp_mesh,
                                   **kw)
    dec = PagedBatchedDecodeEngine(cfg, role="decode", mesh_cfg=tp_mesh,
                                   **kw)
    reqs = C.mix(sampled=False)[:3]
    rids = [pre.submit(np.asarray(r["prompt"], np.int32),
                       r["max_new_tokens"]) for r in reqs]
    moved, shapes = {}, set()
    while len(moved) < len(rids):
        pre.step(params)
        for rid in pre.handoff_ready():
            h = pre.export_handoff(rid)
            shapes.add(tuple(h.pages["k"].shape))
            new = dec.import_handoff(h)
            assert new is not None
            pre.complete_handoff(rid)
            moved[rid] = new
    res = dec.run(params)
    return dict(tokens={str(r): np.asarray(res[moved[r]].tokens).tolist()
                        for r in rids},
                page_shapes=sorted(shapes))


def job_serving_tp(workdir: Path) -> None:
    """Every engine in tp mode (and the serial engine in zero3) on two
    ranks, for each family: the request mixes' tokens, the port's plain
    engines' for the sampled rows, the all-reduces a decode tick issues
    (1 and 3 live rows; int8; adapters), the pool's per-rank bytes.
    Then the failure case: rank 1 raises inside a TP engine's forward."""
    import torch

    from pytorch_distributed_tpu_torch.config import MeshConfig
    from pytorch_distributed_tpu_torch.serving.engine import (
        BatchedDecodeEngine,
        BucketSpec,
        DecodeEngine,
        PagedBatchedDecodeEngine,
    )

    spec, rank = _setup(workdir)
    tp_mesh, z3 = MeshConfig(**C.TP), MeshConfig(**C.ZERO3)
    dense_kw = dict(slots=C.SLOTS, max_len=C.MAX_LEN,
                    buckets=BucketSpec(C.BUCKETS), device="cpu")
    paged_kw = dict(slots=C.SLOTS, max_len=C.MAX_LEN, page_size=C.PAGE,
                    prefill_chunk=C.CHUNK, paged_attention="kernel",
                    device="cpu")
    q8 = dict(kv_quant="int8", weight_quant="int8")
    out: dict = {"rank": rank, "families": {}}
    for name in C.SERVING_FAMILIES:
        cfg = _cfg(name)
        params = _params(workdir, cfg, f"{name}.npz")
        res: dict = {}
        prompts = np.asarray(C.gen_prompts())
        res["serial_tp"] = DecodeEngine(
            cfg, max_len=C.MAX_LEN, device="cpu", mesh_cfg=tp_mesh
        ).generate(params, prompts, 8).tolist()
        res["serial_zero3"] = DecodeEngine(
            cfg, max_len=C.MAX_LEN, device="cpu", mesh_cfg=z3
        ).generate(params, prompts, 8).tolist()
        res["serial_tp_stream"] = [
            t.tolist() for t in DecodeEngine(
                cfg, max_len=C.MAX_LEN, device="cpu", mesh_cfg=tp_mesh
            ).stream(params, prompts, 8)]
        legs = {
            "dense": (BatchedDecodeEngine, dense_kw, {}, C.mix()),
            "paged": (PagedBatchedDecodeEngine, paged_kw, {}, C.mix()),
            "paged_q8": (PagedBatchedDecodeEngine, paged_kw, q8, C.mix()),
            "dense_spec": (BatchedDecodeEngine, dense_kw, C.SPEC, C.mix()),
            "paged_spec": (PagedBatchedDecodeEngine, paged_kw, C.SPEC,
                           C.mix()),
        }
        for leg, (cls, kw, extra, reqs) in legs.items():
            eng = cls(cfg, mesh_cfg=tp_mesh, **kw, **extra)
            got = eng.run(params, reqs)
            res[leg] = _tokens(got)
            res[leg + "_counters"] = {k: eng.counters[k] for k in (
                "done", "drafted_tokens", "accepted_tokens")}
            if cls is PagedBatchedDecodeEngine:
                res[leg + "_pool_bytes"] = sum(
                    t.numel() * t.element_size()
                    for t in eng._cache.values())
            plain = cls(cfg, **kw, **extra)
            res[leg + "_plain"] = _tokens(plain.run(params, reqs))
            if cls is PagedBatchedDecodeEngine:
                res[leg + "_plain_pool_bytes"] = sum(
                    t.numel() * t.element_size()
                    for t in plain._cache.values())
        # LoRA on the TP paged engine: the mix, and each tenant alone.
        reg = _registry(cfg)
        lora = PagedBatchedDecodeEngine(cfg, mesh_cfg=tp_mesh, adapters=reg,
                                        **paged_kw)
        res["lora"] = _tokens(lora.run(params, C.tenant_mix()))
        for tid in C.TENANTS:
            alone = [r for r in C.tenant_mix() if r.get("tenant") == tid]
            res[f"lora_alone_{tid}"] = _tokens(PagedBatchedDecodeEngine(
                cfg, mesh_cfg=tp_mesh, adapters=reg, **paged_kw
            ).run(params, alone))
        res["handoff"] = _handoff(cfg, params, tp_mesh, paged_kw)
        # All-reduces a decode tick issues: 2 x n_layer whatever the rows,
        # the pool format or the adapters.
        counts = {}
        for leg, make in {
            "paged": lambda: PagedBatchedDecodeEngine(
                cfg, mesh_cfg=tp_mesh, **paged_kw),
            "paged_q8": lambda: PagedBatchedDecodeEngine(
                cfg, mesh_cfg=tp_mesh, **paged_kw, **q8),
            "paged_lora": lambda: PagedBatchedDecodeEngine(
                cfg, mesh_cfg=tp_mesh, adapters=reg, **paged_kw),
            "dense": lambda: BatchedDecodeEngine(
                cfg, mesh_cfg=tp_mesh, **dense_kw),
        }.items():
            counts[leg] = [_per_tick(make, params, n) for n in (1, 3)]
        res["allreduce_per_tick"] = counts
        out["families"][name] = res
        torch.set_num_threads(1)
    _write(workdir, rank, out)
    _fail_one_rank(workdir, rank, tp_mesh, paged_kw)


def _fail_one_rank(workdir, rank, tp_mesh, paged_kw) -> None:
    """A real failure on rank 1 only, in its third decode tick's forward:
    rank 1 raises, and rank 0 must end with an error too (its next
    all-reduce has no partner) within the group's timeout, not hang."""
    from pytorch_distributed_tpu_torch.serving.engine import (
        PagedBatchedDecodeEngine,
    )

    cfg = _cfg("gpt2")
    params = _params(workdir, cfg, "gpt2.npz")
    eng = PagedBatchedDecodeEngine(cfg, mesh_cfg=tp_mesh, **paged_kw)
    for r in C.mix(sampled=False):
        eng.submit(np.asarray(r["prompt"], np.int32), r["max_new_tokens"])
    forward = eng._forward
    calls = [0]

    def failing(*a, **kw):
        calls[0] += 1
        if rank == 1 and calls[0] == 3:
            raise RuntimeError("injected failure on rank 1 only")
        return forward(*a, **kw)

    eng._forward = failing
    (workdir / f"fail_start_{rank}").write_text(str(time.time()))
    while eng.has_work():
        eng.step(params)
    (workdir / f"fail_survived_{rank}").write_text("")


def job_cuda_tp_paged(workdir: Path) -> None:
    """On the card: the TP paged engine (kernel path, f32) on two gloo
    ranks sharing cuda:0, and the one-rank kernel engine in each rank, on
    the same seeded weights and requests; tokens, first-tick logits, K3
    launches and all-reduces a decode tick."""
    import torch

    from pytorch_distributed_tpu_torch.config import MeshConfig, ModelConfig
    from pytorch_distributed_tpu_torch.models import gpt2
    from pytorch_distributed_tpu_torch.ops import paged_kernel as pk
    from pytorch_distributed_tpu_torch.ops import tp
    from pytorch_distributed_tpu_torch.serving import PagedBatchedDecodeEngine

    _, rank = _setup(workdir)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    cfg = ModelConfig(vocab_size=512, n_ctx=256, n_embd=256, n_layer=2,
                      n_head=4, dtype="float32")
    params = gpt2.init(torch.Generator().manual_seed(0), cfg, device=dev)
    rng = np.random.default_rng(0)
    reqs = [dict(prompt=rng.integers(0, 512, int(n)).astype(np.int32),
                 max_new_tokens=16) for n in rng.integers(20, 100, 6)]
    out: dict = {"rank": rank, "n_layer": cfg.n_layer}
    logits = {}
    for name, mesh in (("tp", MeshConfig(tensor=2)), ("one_rank", None)):
        eng = PagedBatchedDecodeEngine(cfg, slots=4, max_len=256,
                                       page_size=16, device=dev,
                                       paged_attention="kernel",
                                       mesh_cfg=mesh)
        eng.warmup(params)
        forward, per_tick = eng._forward, []

        def watched(*a, forward=forward, per_tick=per_tick, name=name,
                    **kw):
            c0 = tp.collectives
            y = forward(*a, **kw)
            if kw.get("window"):
                per_tick.append(tp.collectives - c0)
                live = torch.from_numpy(np.asarray(a[2]) > 0).to(y.device)
                logits.setdefault(name, y[live, -1].float().cpu())
            return y

        eng._forward = watched
        pk.launches = 0
        res = eng.run(params, reqs)
        out[name] = dict(
            tokens=[np.asarray(res[r].tokens).tolist() for r in sorted(res)],
            K3=pk.launches, decode_ticks=eng.counters["decode_ticks"],
            decode_allreduces=sorted(set(per_tick)))
    out["first_tick_max_abs_err"] = float(
        (logits["tp"] - logits["one_rank"]).abs().max())
    _write(workdir, rank, out)


# -- tensor-parallel training ---------------------------------------------------


def job_tp_train(workdir: Path) -> None:
    """Tensor-parallel training on four ranks: every case of
    ``spec["cases"]`` (one explicit step on its group: "a" = ranks {0, 1},
    "b" = {2, 3}, both at once, or "world"), writing the loss, grad norm,
    the all-reduces ``ops/tp`` issued and the gathered params; then folded
    attention dropout on "a" (two runs of a step, and the deterministic
    step), the sharded checkpoint on the world (saved at fsdp 2 x tensor
    2, restored at tensor 1 and onto data 2 x tensor 2) and the JAX npz
    restored at tensor 2; last the ``DistributedTrainer``'s loop at
    tensor 4 with the anomaly guard and one corrupt batch."""
    import torch
    import torch.distributed as dist

    from _torch_dist_worker import _save_params
    from pytorch_distributed_tpu_torch.config import (
        MeshConfig,
        ModelConfig,
        TrainConfig,
    )
    from pytorch_distributed_tpu_torch.models import get_model
    from pytorch_distributed_tpu_torch.ops import tp
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

    import hashlib

    spec, rank = _setup(workdir)
    groups = {"a": dist.new_group([0, 1]), "b": dist.new_group([2, 3]),
              "world": dist.group.WORLD}
    members = {"a": (0, 1), "b": (2, 3), "world": (0, 1, 2, 3)}
    tcfg = TrainConfig(**spec["train"])
    with np.load(workdir / "batch.npz") as f:
        batch = {k: f[k] for k in f.files}
    out: dict = {"rank": rank, "cases": {}}

    def build(model, mesh_kw, group="world", **cfg_kw):
        cfg = ModelConfig(**dict(spec["models"][model], **cfg_kw))
        mcfg = MeshConfig(**mesh_kw)
        mesh = make_mesh(mcfg, group=groups[group], device="cpu")
        tx = make_optimizer(tcfg)
        state, sh = shard_train_state(init_train_state(
            _params(workdir, cfg, f"{model}.npz"), tx), mesh)
        step, put = make_parallel_train_step(get_model(cfg), cfg, tx, mesh,
                                             mcfg, sh)
        return cfg, mesh, state, sh, step, put

    for case in spec["cases"]:
        if rank not in members[case["group"]]:
            continue
        cfg, mesh, state, sh, step, put = build(case["model"], case["mesh"],
                                                case["group"])
        c0 = tp.collectives
        state, m = step(state, put(batch))
        res = dict(loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
                   tp_collectives=tp.collectives - c0, coords=mesh.coords)
        full = ckpt.gather_state(state, sh)
        if mesh.rank == 0:
            _save_params(workdir / f"params_{case['name']}.npz",
                         full.params, cfg)
        out["cases"][case["name"]] = res

    # Folded attention dropout (group a, tensor 2): the same seed gives
    # the same masks, so two runs of the step are bit-equal; the masks
    # act (the deterministic step's loss differs).
    if rank in members["a"]:
        losses = []
        for pdrop in (0.5, 0.5, 0.0):
            _, _, state, _, step, put = build(
                "gpt2", dict(tensor=2, strategy="no_shard"), "a",
                attn_pdrop=pdrop, tensor_dropout="folded")
            state, m = step(state, put(batch))
            losses.append(m["loss"].item())
            out.setdefault("folded_params_sha", []).append(
                hashlib.sha256(b"".join(
                    t.detach().numpy().tobytes()
                    for t in tree.leaves(state.params))).hexdigest())
        out["folded_losses"] = losses

    # Residual dropout under names (group b): the masks are saved, so the
    # recompute of a block runs past mlp_proj, whose sum it must not issue
    # again.
    if rank in members["b"]:
        _, _, state, _, step, put = build(
            "gpt2", dict(tensor=2, strategy="no_shard"), "b",
            resid_pdrop=0.1, embd_pdrop=0.1)
        c0 = tp.collectives
        step(state, put(batch))
        out["resid_dropout_tp_collectives"] = tp.collectives - c0

    # The sharded checkpoint at fsdp 2 x tensor 2 (full_shard: leaves
    # split over both axes), restored at tensor 1 (no sharding: the whole
    # state) and onto data 2 x tensor 2.
    cfg, mesh, state, sh, step, put = build(
        "gpt2", dict(fsdp=2, tensor=2, strategy="full_shard"))
    state, _ = step(state, put(batch))
    ckpt.save_checkpoint(workdir / "tp_orbax", state, cfg, format="orbax",
                         sharding=sh, metadata={"step": 1})
    ckpt.save_checkpoint(workdir / "tp_npz", state, cfg, format="npz",
                         sharding=sh)
    full = ckpt.gather_state(state, sh)
    full_leaves = tree.leaves([full.params, full.opt_state["mu"],
                               full.opt_state["nu"]])

    def fresh_full():
        return init_train_state(_params(workdir, cfg, "other.npz"),
                                make_optimizer(tcfg))

    def same_bits(a_leaves, b_leaves):
        return all(torch.equal(a, b) for a, b in zip(a_leaves, b_leaves))

    ck: dict = {}
    for fmt in ("tp_orbax", "tp_npz"):
        whole = ckpt.load_checkpoint(workdir / fmt, fresh_full(), cfg)
        ck[f"{fmt}_tensor1_bit_equal"] = same_bits(
            tree.leaves([whole.params, whole.opt_state["mu"],
                         whole.opt_state["nu"]]), full_leaves)
        ck[f"{fmt}_step"] = whole.step
    mcfg2 = MeshConfig(data=2, tensor=2, strategy="no_shard")
    mesh2 = make_mesh(mcfg2, device="cpu")
    like, sh2 = shard_train_state(fresh_full(), mesh2)
    got = ckpt.load_checkpoint(workdir / "tp_orbax", like, cfg,
                               sharding=sh2)
    want = [shard_slice(t, s, mesh2) for t, s in zip(
        full_leaves, tree.leaves([sh2.params, sh2.opt_state["mu"],
                                  sh2.opt_state["nu"]]))]
    ck["onto_data2_tensor2_bit_equal"] = same_bits(
        tree.leaves([got.params, got.opt_state["mu"], got.opt_state["nu"]]),
        want)
    index = json.loads((workdir / "tp_orbax" / "tree" / "index.json")
                       .read_text())
    ck["files"] = sorted(p.name for p in (workdir / "tp_orbax" / "tree")
                         .iterdir())
    ck["grid"] = index["grid"]
    # The JAX package's npz (one single-device step) at tensor 2.
    like, sh2 = shard_train_state(fresh_full(), mesh2)
    got = ckpt.load_checkpoint(workdir / "jax_ckpt", like, cfg, sharding=sh2)
    whole = ckpt.gather_state(got, sh2)
    ck["jax_step"] = got.step
    if rank == 0:
        _save_params(workdir / "jax_ckpt_params.npz", whole.params, cfg)
        _save_params(workdir / "jax_ckpt_mu.npz", whole.opt_state["mu"],
                     cfg)
    out["ckpt"] = ck

    # The DistributedTrainer's loop at tensor 4 with the anomaly guard: the
    # third step's batch holds an out-of-range id, and every tensor rank
    # takes the same decision (the same global loss and norm).
    from pytorch_distributed_tpu_torch.train.distributed_trainer import (
        DistributedTrainer,
    )
    from pytorch_distributed_tpu_torch.train.guard import init_guard_state

    gcfg = TrainConfig(**dict(spec["train"], anomaly_guard=True,
                              num_steps=4, log_every_n_steps=1,
                              guard_rollback_after=None))
    mcfg = MeshConfig(tensor=4, strategy="no_shard")
    mesh = make_mesh(mcfg, device="cpu")
    cfg = ModelConfig(**spec["models"]["gpt2"])
    tr = DistributedTrainer(get_model(cfg), cfg, gcfg, mesh, mcfg,
                            log_fn=lambda s: None)
    tr.init_state()
    state, sh = shard_train_state(init_train_state(
        _params(workdir, cfg, "gpt2.npz"), tr.tx,
        guard=init_guard_state(mesh.device)), mesh)
    rng = np.random.default_rng(7)
    b, t = gcfg.micro_batch_size, cfg.n_ctx
    loader = []
    for i in range(4 * tr.accum):
        x = rng.integers(0, cfg.vocab_size, (b, t))
        if i == 2 * tr.accum:
            x[0, 3] = cfg.vocab_size + 5
        loader.append((x, rng.integers(0, cfg.vocab_size, (b, t))))
    state, hist = tr.train(loader, state=state)
    full = ckpt.gather_state(state, sh)
    out["guard"] = dict(
        anomalies=hist[-1]["anomalies"], losses=[h["loss"] for h in hist],
        params_sha=hashlib.sha256(b"".join(
            p.detach().numpy().tobytes()
            for p in tree.leaves(full.params))).hexdigest())
    _write(workdir, rank, out)
    dist.barrier()


TP_JOBS = {"tp_ops": job_tp_ops, "decode_tp": job_decode_tp,
           "serving_tp": job_serving_tp, "cuda_tp_paged": job_cuda_tp_paged,
           "tp_train": job_tp_train}
