"""The port's pipeline with an in-stage expert axis against the JAX
package (the explicit step's expert axis and ``moe_mlp``'s exchange:
``tests/test_torch_expert.py``; the pipeline's other compositions:
``tests/test_torch_pipeline*.py``, whose helpers and tolerances this file
shares, ``_torch_pipe_cases``).

One group of eight gloo CPU ranks (``_torch_pipe_jobs.job_pipe_train``)
runs every case, JAX's pipeline step in this process meanwhile on the
8-device CPU fixture. GPT-2 MoE (4 layers, 4 experts top-2, capacity
factor 4, the Switch term on: it is per token shard in both), M = 3
micro-batches of [8, 16], f32.

- pipe 2 x expert 2 under GPipe (ranks 0-3) and 1F1B (ranks 4-7, at the
  same time), and pipe 2 x expert 2 x fsdp 2 under full_shard (all
  eight): each stage's experts split over the expert axis, its tokens
  through the all-to-all exchange. Loss within 1e-5, grad norm and
  params within 1e-4 of JAX's pipeline step on the same mesh (JAX's
  pipeline tests' tolerances).
- The counts a step on each rank: K1/K2 and pipe sends as
  ``pipeline.pipe_counts`` derives them, and the all-to-alls: 6 a MoE
  layer and micro-batch under ``names`` (``moe.exchanges_per_layer``),
  and under 1F1B 2 more on every stage but the last, whose F tick runs
  its layers' forward once more without a graph.
- The refusals: an expert axis on a dense model, and an expert count the
  axis does not divide.
"""

import pytest

from _torch_pipe_cases import (
    COMMON,
    M,
    MODELS,
    RANKS,
    case,
    check_counts,
    check_step,
    start,
)
from pytorch_distributed_tpu_torch.config import MeshConfig, ModelConfig
from pytorch_distributed_tpu_torch.ops import moe
from pytorch_distributed_tpu_torch.parallel import pipeline

EP2 = dict(pipe=2, expert=2)
CASES = [
    case("gpt2_moe-pipe2xexpert2-gpipe", "gpt2_moe", "world",
         dict(EP2, strategy="no_shard"), "gpipe"),
    case("gpt2_moe-pipe2xexpert2-1f1b", "gpt2_moe", "b4",
         dict(EP2, strategy="no_shard"), "1f1b"),
    case("gpt2_moe-pipe2xexpert2xfsdp2-full_shard-gpipe", "gpt2_moe", "all8",
         dict(EP2, fsdp=2, strategy="full_shard"), "gpipe"),
]
IDS = [c["name"] for c in CASES]


@pytest.fixture(scope="module")
def runs(tmp_path_factory, eight_devices):
    return start(tmp_path_factory, CASES, [], "expert_pipe", n=8)


@pytest.mark.parametrize("c", CASES, ids=IDS)
def test_pipeline_expert_step_matches_jax(runs, c):
    check_step(runs, c)


@pytest.mark.parametrize("c", CASES, ids=IDS)
def test_pipeline_expert_step_counts(runs, c):
    check_counts(runs, c)
    _, _, outs = runs
    per = COMMON["n_layer"] // c["mesh"]["pipe"] * M
    for r in RANKS[c["group"]]:
        got = outs[r]["steps"][c["name"]]
        extra = c["schedule"] == "1f1b" and got["stage"] < 1
        assert got["all_to_alls"] == per * (
            moe.exchanges_per_layer("names") + 2 * extra), (r, got)


def test_pipeline_expert_refusals():
    """JAX's build-time checks, raised before the mesh is read."""
    dense = ModelConfig(**MODELS["gpt2"])
    with pytest.raises(ValueError, match="n_experts"):
        pipeline.check_pipeline(dense, MeshConfig(pipe=2, expert=2))
    moe_cfg = ModelConfig(**dict(MODELS["gpt2_moe"], n_experts=6))
    with pytest.raises(ValueError, match="not divisible by expert=4"):
        pipeline.check_pipeline(moe_cfg, MeshConfig(pipe=2, expert=4))
    pipeline.check_pipeline(ModelConfig(**MODELS["gpt2_moe"]),
                            MeshConfig(pipe=2, expert=2))
