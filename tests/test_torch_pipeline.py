"""The port's pipeline parallelism against the JAX package: schedules,
data, Llama, MoE, the clip, dropout, the counts, the trainer and the
refusals. The fsdp, seq and tensor compositions and the checkpoint:
``tests/test_torch_pipeline_comp.py``.

One group of four gloo CPU ranks (``_torch_pipe_jobs.job_pipe_train``)
runs every case; the JAX side runs in this process meanwhile, under the
8-device CPU fixture, its compiles in threads (``_torch_pipe_cases``).
Same seeded inputs (numpy; the port's ``init``'s weights as JAX's stacked
tree, each stage taking its layers through
``interop.stage_params_from_jax``) on both sides, f32, one
step at M = 3 micro-batches of [8, 16].

- One step against JAX's pipeline step on the same mesh: GPT-2 at pipe 2
  with GPipe and with 1F1B (the latter under the global-norm clip at 0.5,
  below the step's norm), at pipe 4 with 1F1B, at pipe 2 x data 2; Llama
  with GQA at pipe 2 (1F1B); GPT-2 MoE (4 experts top-2) with its experts
  in each stage. Loss within 1e-5, grad norm and params within 1e-4 (JAX's
  own pipeline tests').
- The counts a step on each rank equal ``pipeline.pipe_counts``: K1 once
  a layer and micro-batch (twice under 1F1B but on the last stage), K2
  once, and M sends each way a stage has a neighbour.
- Dropout at pipe 2 (both schedules) draws the single-device step's
  masks: held to the port's own single-device step (JAX's threefry
  streams cannot be matched).
- The ``DistributedTrainer``'s loop on ``path="pipeline"`` (pipe 2 x
  data 2, 1F1B) gives the explicit path's losses on the same batches,
  and its ``evaluate`` runs; the ``train.parallel`` twin at
  ``--cpu-devices 4`` on ``--path pipeline``.
- The 1F1B timing (JAX's) and the refusals, in this process.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from _torch_pipe_cases import (
    COMMON,
    M,
    MODELS,
    RANKS,
    TRAIN,
    case,
    check_counts,
    check_step,
    start,
)
from pytorch_distributed_tpu_torch.config import (
    MeshConfig,
    ModelConfig,
    TrainConfig,
)
from pytorch_distributed_tpu_torch.models import get_model
from pytorch_distributed_tpu_torch.parallel import pipeline
from pytorch_distributed_tpu_torch.train.optim import make_optimizer

ROOT = Path(__file__).resolve().parents[1]
CASES = [
    case("gpt2-pipe2-gpipe", "gpt2", "a", dict(pipe=2, strategy="no_shard"),
         "gpipe"),
    case("gpt2-pipe2-1f1b-clip", "gpt2", "b",
         dict(pipe=2, strategy="no_shard"), "1f1b", clip=0.5),
    case("gpt2-pipe4-1f1b", "gpt2", "world",
         dict(pipe=4, strategy="no_shard"), "1f1b"),
    case("llama-pipe2-1f1b", "llama", "a", dict(pipe=2, strategy="no_shard"),
         "1f1b"),
    case("gpt2-pipe2xdata2-gpipe", "gpt2", "world",
         dict(pipe=2, data=2, strategy="no_shard"), "gpipe"),
    case("gpt2_moe-pipe2-gpipe", "gpt2_moe", "b",
         dict(pipe=2, strategy="no_shard"), "gpipe"),
]
IDS = [c["name"] for c in CASES]


def _twin(tmp_path):
    """The ``train.parallel`` twin on ``--path pipeline`` at
    ``--cpu-devices 4``, started (it runs beside the fixture's ranks)."""
    return subprocess.Popen(
        [sys.executable, "-m", "pytorch_distributed_tpu_torch.train.parallel",
         "--cpu-devices", "4", "--mesh", "pipe=2,data=2", "--path",
         "pipeline", "--pipe-schedule", "1f1b", "--preset", "tiny",
         "--seq-len", "32", "--global-batch-size", "8",
         "--micro-batch-size", "2", "--steps", "2", "--log-every", "1",
         "--no-profiler", "--num-train-files", "2",
         "--data-dir", str(tmp_path / "data"),
         "--checkpoint-dir", str(tmp_path / "ckpt")],
        cwd=tmp_path, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True,
        env=dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1"))


@pytest.fixture(scope="module")
def runs(tmp_path_factory, eight_devices):
    twin = _twin(tmp_path_factory.mktemp("twin"))
    try:
        out = start(tmp_path_factory, CASES, ["dropout", "trainer"], "pipe")
        twin_out, _ = twin.communicate(timeout=240)
    finally:
        if twin.poll() is None:
            twin.kill()
            twin.wait()
    return (*out, (twin.returncode, twin_out))


@pytest.mark.parametrize("c", CASES, ids=IDS)
def test_pipeline_step_matches_jax(runs, c):
    check_step(runs[:3], c)


@pytest.mark.parametrize("c", CASES, ids=IDS)
def test_pipeline_step_counts(runs, c):
    check_counts(runs[:3], c)


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_dropout_at_pipe2_matches_single_device(runs, schedule):
    _, _, outs, _ = runs
    for r in RANKS["a"]:
        d = outs[r]["dropout"][schedule]
        assert d["loss"] == pytest.approx(d["ref_loss"], abs=1e-5)
        assert d["grad_norm"] == pytest.approx(d["ref_grad_norm"], abs=1e-4)
        assert d["max_param_diff"] < 1e-4


def test_trainer_loop_on_the_pipeline_path(runs):
    _, _, outs, _ = runs
    got = [o["trainer"] for o in outs]
    for g in got:
        assert g["pipeline"] == got[0]["pipeline"]
        assert g["pipeline_eval"] == got[0]["pipeline_eval"]
    np.testing.assert_allclose(got[0]["pipeline"], got[0]["explicit"],
                               atol=1e-5)
    assert len(got[0]["pipeline"]) == 2
    assert np.isfinite(got[0]["pipeline_eval"])


def test_parallel_twin_on_the_pipeline_path(runs):
    rc, out = runs[3]
    assert rc == 0, out[-3000:]
    assert "'pipe': 2, 'data': 2" in out and "pipe_schedule=1f1b" in out
    assert "path=pipeline" in out and "done:" in out, out[-3000:]


@pytest.mark.parametrize("s, m", [(2, 3), (4, 3), (4, 6)])
def test_1f1b_timing_is_jax(s, m):
    """JAX's timing: F(m) at tick 2m + s, B(m) at 2m + 2S - 1 - s; F and
    B never share a tick; each hop is consumed one tick after it is sent;
    at most S - s inputs are in flight on stage s."""
    ticks = range(2 * (m + s - 1))
    for st in range(s):
        f = {t: pipeline.f_tick(t, st, m) for t in ticks}
        b = {t: pipeline.b_tick(t, st, s, m) for t in ticks}
        assert sorted(v for v in f.values() if v is not None) == \
            list(range(m))
        assert sorted(v for v in b.values() if v is not None) == \
            list(range(m))
        assert not [t for t in ticks if f[t] is not None
                    and b[t] is not None]
        for t in ticks:
            if f[t] is not None:
                assert t == 2 * f[t] + st
                if st + 1 < s:
                    assert pipeline.f_tick(t + 1, st + 1, m) == f[t]
            if b[t] is not None:
                assert t == 2 * b[t] + 2 * s - 1 - st
                if st > 0:
                    assert pipeline.b_tick(t + 1, st - 1, s, m) == b[t]
            done_f = sum(v is not None and k <= t for k, v in f.items())
            done_b = sum(v is not None and k <= t for k, v in b.items())
            assert done_f - done_b <= s - st


def test_pipe_counts_formula():
    assert pipeline.pipe_counts("gpipe", 0, 2, 12, 4) == \
        dict(K1=24, K2=24, sends=4)
    assert pipeline.pipe_counts("1f1b", 0, 2, 12, 4) == \
        dict(K1=48, K2=24, sends=4)
    assert pipeline.pipe_counts("1f1b", 1, 2, 12, 4) == \
        dict(K1=24, K2=24, sends=4)
    assert pipeline.pipe_counts("1f1b", 1, 4, 4, M) == \
        dict(K1=6, K2=3, sends=6)


def _build(cfg_kw=None, mesh_kw=None, train_kw=None, *, clip=False,
           grad_clip_norm=None):
    cfg = ModelConfig(**dict(MODELS["gpt2"], **(cfg_kw or {})))
    tcfg = TrainConfig(**dict(TRAIN, **(train_kw or {})))
    pipeline.make_pipeline_train_step(
        get_model(cfg), cfg, make_optimizer(tcfg, with_clip=clip), None,
        MeshConfig(**dict(dict(pipe=2), **(mesh_kw or {}))), None, tcfg,
        grad_clip_norm=grad_clip_norm)


def test_pipeline_refusals():
    """JAX's refusals, raised when the step is built (before the mesh is
    read), the expert axis's among them: on a dense model it names
    n_experts, and an expert count the axis does not divide."""
    with pytest.raises(ValueError, match="pipe > 1"):
        _build(mesh_kw=dict(pipe=1))
    with pytest.raises(ValueError, match="unknown pipe_schedule"):
        _build(mesh_kw=dict(pipe_schedule="zb-v"))
    with pytest.raises(ValueError, match="not divisible by pipe=3"):
        _build(mesh_kw=dict(pipe=3))
    with pytest.raises(NotImplementedError, match="tensor_dropout"):
        _build(dict(attn_pdrop=0.1), dict(tensor=2))
    with pytest.raises(NotImplementedError, match="ring-attention"):
        _build(dict(attn_pdrop=0.1), dict(seq=2))
    with pytest.raises(ValueError, match="pipe-aware global norm"):
        _build(train_kw=dict(grad_clip_norm=1.0))
    with pytest.raises(ValueError, match="clip-free optimizer"):
        _build(train_kw=dict(grad_clip_norm=1.0), clip=True,
               grad_clip_norm=1.0)
    with pytest.raises(ValueError, match="n_experts"):
        _build(mesh_kw=dict(expert=2))
    with pytest.raises(ValueError, match="not divisible by expert=2"):
        _build(dict(n_experts=3), dict(expert=2))
    # Llama draws no dropout: its pdrop fields refuse nothing (JAX's).
    llama = ModelConfig(**dict(MODELS["llama"], attn_pdrop=0.1))
    pipeline.check_pipeline(llama, MeshConfig(pipe=2, tensor=2))


def test_stage_params_from_jax_takes_the_stage_layers():
    from pytorch_distributed_tpu_torch import interop

    cfg = ModelConfig(**MODELS["gpt2"])
    rng = np.random.default_rng(0)
    full = get_model(cfg).init(__import__("torch").Generator().manual_seed(
        0), cfg, device="cpu")
    tree = interop.params_to_jax(full, cfg)
    for s in range(2):
        got = interop.stage_params_from_jax(tree, cfg, s, 2)
        assert len(got["blocks"]) == COMMON["n_layer"] // 2
        for i, bp in enumerate(got["blocks"]):
            want = full["blocks"][2 * s + i]
            assert (bp["attn"]["c_attn"]["kernel"]
                    == want["attn"]["c_attn"]["kernel"]).all()
        assert (got["wte"] == full["wte"]).all()
    with pytest.raises(ValueError):
        interop.stage_params_from_jax(tree, cfg, 2, 2)
    del rng
