"""The port's DistributedTrainer and its twins, on gloo CPU ranks.

- A world of one (``_torch_dist_worker.job_world1``): under every
  strategy, on both paths, the DistributedTrainer's step is bit-equal to
  the single-device Trainer's (GPT-2, dropout 0.1, flash, ``names``,
  A = 2, clip 1.0: the masks are the single-device ones), and so is its
  loop.
- Two ranks (``job_trainer``), GPT-2 without dropout: the loop on
  rank-sliced shards (no_shard over data 2, full_shard over fsdp 2)
  against the JAX package's DistributedTrainer (explicit path) on the
  same shards and weights — each step's loss within rtol 1e-5, the final
  params as in ``_torch_parallel_cases``, the evaluation within 1e-5 —;
  the loader's rank and world size taken from the process group; and the
  anomaly guard skipping a step whose bad token id only rank 1's rows
  hold, alike on both ranks.
- The ``train.ddp`` and ``train.fsdp`` twins end to end on two CPU ranks
  (``--cpu-devices 2``), a resume from the sharded checkpoints included.
- The refusals, ``is_process_zero`` and the classing of NCCL kernels.
"""

import json
import subprocess
import sys
import threading
from pathlib import Path

import jax
import numpy as np
import pytest

from _torch_dist_worker import launch
from pytorch_distributed_tpu.config import MeshConfig as JaxMeshConfig
from pytorch_distributed_tpu.config import ModelConfig as JaxModelConfig
from pytorch_distributed_tpu.config import TrainConfig as JaxTrainConfig
from pytorch_distributed_tpu.data import (
    DistributedTokenShardLoader as JaxDistLoader,
)
from pytorch_distributed_tpu.models import get_model as jget_model
from pytorch_distributed_tpu.parallel import make_mesh as jmake_mesh
from pytorch_distributed_tpu.parallel import shard_train_state as jshard
from pytorch_distributed_tpu.train.distributed_trainer import (
    DistributedTrainer as JaxDistributedTrainer,
)
from pytorch_distributed_tpu.train.state import init_train_state as jinit
from pytorch_distributed_tpu_torch.config import (
    MeshConfig,
    ModelConfig,
    TrainConfig,
)
from pytorch_distributed_tpu_torch.data import make_synthetic_shards
from pytorch_distributed_tpu_torch.models import get_model
from pytorch_distributed_tpu_torch.parallel import mesh as pmesh
from pytorch_distributed_tpu_torch.profiling import trace_analysis
from pytorch_distributed_tpu_torch.train.checkpoint import _flatten
from pytorch_distributed_tpu_torch.train.distributed_trainer import (
    DistributedTrainer,
)
from pytorch_distributed_tpu_torch.utils.logging import is_process_zero

ROOT = Path(__file__).resolve().parent.parent
GPT2 = dict(vocab_size=97, n_ctx=32, n_embd=32, n_layer=2, n_head=4,
            dtype="float32", attention_impl="flash", remat="names")
NO_DROPOUT = dict(embd_pdrop=0.0, attn_pdrop=0.0, resid_pdrop=0.0)
T = 16
MESHES = {"no_shard": dict(data=2), "full_shard": dict(fsdp=2)}
TRAIN_KW = dict(global_batch_size=8, micro_batch_size=2, num_steps=3,
                learning_rate=1e-3, grad_clip_norm=1.0, log_every_n_steps=1)


def _write_params(workdir: Path, kw: dict):
    cfg = JaxModelConfig(**kw)
    params = jax.device_get(jget_model(cfg).init(jax.random.key(0), cfg))
    flat: dict = {}
    _flatten("params", params, flat)
    np.savez(workdir / "params.npz", **flat)
    return params


@pytest.fixture(scope="module")
def world1(tmp_path_factory):
    workdir = tmp_path_factory.mktemp("world1")
    rng = np.random.default_rng(1)
    batches = [dict(inputs=rng.integers(0, 97, (2, 2, T)),
                    targets=rng.integers(0, 97, (2, 2, T)))
               for _ in range(3)]
    np.savez(workdir / "batches.npz", **{
        f"{k}_{i}": v for i, b in enumerate(batches) for k, v in b.items()})
    (workdir / "spec.json").write_text(json.dumps(dict(
        model=dict(GPT2, embd_pdrop=0.1, attn_pdrop=0.1, resid_pdrop=0.1),
        train=dict(TRAIN_KW, global_batch_size=4, log_every_n_steps=3))))
    return workdir


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory, world1):
    """The world-of-one job and the two-rank job run at once; the JAX
    trainers run meanwhile."""
    workdir = tmp_path_factory.mktemp("trainer")
    params = _write_params(workdir, dict(GPT2, **NO_DROPOUT))
    paths = make_synthetic_shards(workdir / "shards", num_shards=2,
                                  tokens_per_shard=20_000, vocab_size=97,
                                  seed=3)
    (workdir / "spec.json").write_text(json.dumps(dict(
        model=dict(GPT2, **NO_DROPOUT), train=TRAIN_KW, meshes=MESHES,
        path="explicit", seq_len=T)))
    done: dict = {}
    jobs = [threading.Thread(target=lambda: done.update(
                trainer=launch("trainer", 2, workdir))),
            threading.Thread(target=lambda: done.update(
                world1=launch("world1", 1, world1)))]
    for j in jobs:
        j.start()
    want = {s: _jax_run(s, kw, params, paths) for s, kw in MESHES.items()}
    for j in jobs:
        j.join()
    assert set(done) == {"trainer", "world1"}, "a job did not finish"
    got = [json.loads((workdir / f"trainer_{r}.json").read_text())
           for r in range(2)]
    return workdir, got, want


def _jax_run(strategy, mesh_kw, params, paths):
    cfg = JaxModelConfig(**GPT2, **NO_DROPOUT)
    tcfg = JaxTrainConfig(**TRAIN_KW)
    mcfg = JaxMeshConfig(**mesh_kw, strategy=strategy)
    mesh = jmake_mesh(mcfg)
    tr = JaxDistributedTrainer(jget_model(cfg), cfg, tcfg, mesh, mcfg,
                               path="explicit", log_fn=lambda s: None)
    tr.init_state()
    state, _ = jshard(jinit(params, tr.tx), mesh, mcfg)
    loader = JaxDistLoader(paths, 2 * tcfg.micro_batch_size, T, rank=0,
                           world_size=1)
    with jax.default_matmul_precision("highest"):
        state, hist = tr.train(loader, state=state)
        val = JaxDistLoader(paths, 2 * tcfg.micro_batch_size, T, rank=0,
                            world_size=1)
        ev = tr.evaluate(state, val, max_batches=2)
    flat: dict = {}
    _flatten("params", jax.device_get(state.params), flat)
    return dict(losses=[h["loss"] for h in hist], eval=ev, params=flat)


def test_world_of_one_is_bit_equal_to_the_trainer(two_ranks, world1):
    got = json.loads((world1 / "world1.json").read_text())
    assert len(got) == 9
    for name, row in got.items():
        assert row["loss_equal"], name
        if name == "loop":
            assert row["steps"] == 3
            continue
        assert row["params_equal"], name
        # The reductions run at a world of one too (a sum of one, / 1).
        assert row["collectives"] > 0, name


@pytest.mark.parametrize("strategy", sorted(MESHES))
def test_trainer_loop_matches_jax(two_ranks, strategy):
    workdir, got, want = two_ranks
    w = want[strategy]
    assert len(w["losses"]) == 3
    for r in range(2):
        np.testing.assert_allclose(got[r][strategy], w["losses"], rtol=1e-5)
        np.testing.assert_allclose(got[r][f"eval_{strategy}"], w["eval"],
                                   rtol=1e-5)
    with np.load(workdir / f"trainer_params_{strategy}.npz") as p:
        for k in p.files:
            np.testing.assert_allclose(p[k], w["params"][k], rtol=1e-5,
                                       atol=1e-5, err_msg=k)


def test_loader_takes_its_rank_from_the_process_group(two_ranks):
    _, got, _ = two_ranks
    for r in range(2):
        for strategy in MESHES:
            assert got[r][f"loader_rank_{strategy}"] == [r, 2]


def test_guard_skips_one_ranks_bad_batch_on_both_ranks(two_ranks):
    _, got, _ = two_ranks
    g0, g1 = got[0]["guard"], got[1]["guard"]
    assert g0 == g1
    assert g0["anomalies"] == 1 and g0["step"] == 4 and g0["count"] == 3


def _twin(module, tmp, *extra):
    cmd = [sys.executable, "-m", f"pytorch_distributed_tpu_torch.train."
           f"{module}", "--cpu-devices", "2", "--preset", "tiny",
           "--seq-len", "32", "--global-batch-size", "8",
           "--micro-batch-size", "2", "--log-every", "2",
           "--num-train-files", "2", "--no-profiler", "--data-dir",
           str(tmp / "data"), "--checkpoint-dir", str(tmp / "ck"), *extra]
    res = subprocess.run(cmd, cwd=tmp, capture_output=True, text=True,
                         timeout=240, env={**__import__("os").environ,
                                           "PYTHONPATH": str(ROOT)})
    assert res.returncode == 0, res.stderr[-3000:]
    return res.stdout + res.stderr


def test_twins_train_and_resume_on_two_cpu_ranks(tmp_path):
    out = _twin("fsdp", tmp_path, "--strategy", "FULL_SHARD", "--steps",
                "2", "--save-every", "2")
    assert "FSDP full_shard over 2 ranks (gloo, cpu), accum=2" in out
    assert "done: {'step': 2" in out
    assert (tmp_path / "ck" / "checkpoint_step_2" / "COMMIT").is_file()
    assert (tmp_path / "ck" / "checkpoint_step_2" / "tree"
            / "shard_1.npz").is_file()
    out = _twin("ddp", tmp_path, "--steps", "4", "--resume")
    assert "DDP over 2 ranks" in out
    assert "resuming from" in out and "checkpoint_step_2" in out
    assert "done: {'step': 4" in out


def test_refusals_name_their_items():
    cfg = ModelConfig(**GPT2)
    model = get_model(cfg)
    # The pipeline path is ported (item 7(d)); it needs a pipe axis.
    with pytest.raises(ValueError, match="pipe > 1"):
        DistributedTrainer(model, cfg, TrainConfig(), None, MeshConfig(),
                           path="pipeline")
    with pytest.raises(ValueError, match="unknown parallel path"):
        DistributedTrainer(model, cfg, TrainConfig(), None, MeshConfig(),
                           path="ring")
    with pytest.raises(ValueError, match="anomaly_guard"):
        DistributedTrainer(model, cfg, TrainConfig(anomaly_guard=True),
                           None, MeshConfig(), path="explicit")
    with pytest.raises(RuntimeError, match="initialize_distributed"):
        pmesh.make_mesh(MeshConfig())
    res = subprocess.run(
        [sys.executable, "-m", "pytorch_distributed_tpu_torch.train.fsdp",
         "--help"], capture_output=True, text=True, timeout=60, cwd=ROOT)
    for flag in ("--cpu-devices", "--path", "--strategy", "--resume"):
        assert flag in res.stdout


def test_identity_without_a_process_group():
    assert is_process_zero()
    assert pmesh.process_info() == dict(process_index=0, process_count=1,
                                        local_device_count=1,
                                        global_device_count=1)


def test_nccl_kernels_of_a_kineto_trace_are_communication():
    """What a rank's step trace holds: NCCL's ``ncclDevKernel_*`` kernels
    class as communication, its one-rank copies as memcpy, a GEMM as
    compute."""
    events = [
        dict(ph="X", cat="kernel", name="ncclDevKernel_AllReduce_Sum_f32_"
             "RING_LL(ncclDevKernelArgsStorage<4096ul>)", ts=0, dur=5,
             pid=0, tid=7),
        dict(ph="X", cat="kernel", name="ncclDevKernel_SendRecv(nccl"
             "DevKernelArgsStorage<4096ul>)", ts=10, dur=5, pid=0, tid=7),
        dict(ph="X", cat="gpu_memcpy", name="Memcpy DtoD (Device -> "
             "Device)", ts=20, dur=2, pid=0, tid=7),
        dict(ph="X", cat="kernel", name="sm90_xmma_gemm_bf16bf16_bf16f32",
             ts=30, dur=10, pid=0, tid=8),
        dict(ph="X", cat="gpu_user_annotation", name="nccl:all_reduce",
             ts=0, dur=6, pid=0, tid=7),
    ]
    rows = trace_analysis.device_op_events({"traceEvents": events})
    assert [r["category"] for r in rows] == [
        "communication", "communication", "memcpy", "compute"]
    bd = trace_analysis.temporal_breakdown({"traceEvents": events})
    assert bd["communication_us"] == 10.0
