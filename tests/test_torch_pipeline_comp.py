"""The port's pipeline composed with the ZeRO ladder, sequence and
tensor parallelism, against the JAX package, and the sharded checkpoint
across pipe (the schedules and the rest: ``tests/test_torch_pipeline.py``,
whose helpers and tolerances this file shares, ``_torch_pipe_cases``).

- One step against JAX's pipeline step on the same mesh: GPT-2 at pipe 2
  x fsdp 2 under full_shard (1F1B), shard_grad_op and shard_opt (GPipe);
  pipe 2 x seq 2 with the ring on GPT-2 (GPipe) and Ulysses on Llama
  (1F1B). Loss within 1e-5, grad norm and params within 1e-4.
- pipe 2 x tensor 2 (GPT-2, GPipe) against JAX's single-device step at
  the same tolerances: JAX's pipeline under a tensor axis fails
  JAX 0.9's ``check_vma`` in this environment (``tests/
  test_pipeline_comp.py``, slow tier), as its explicit TP step does.
- The counts a step (``pipeline.pipe_counts``; the ring launches no
  flash kernel).
- The checkpoint: a pipe 2 x fsdp 2 state saved in the sharded format
  (one file per stage and fsdp index) and as npz, each restored at pipe 1
  bit for bit; a pipe-1 save restored onto pipe 2 x fsdp 2 bit for bit.
"""

import pytest

from _torch_pipe_cases import case, check_counts, check_step, start

W = "world"
CASES = [
    case("gpt2-pipe2xfsdp2-full_shard-1f1b", "gpt2", W,
         dict(pipe=2, fsdp=2, strategy="full_shard"), "1f1b"),
    case("gpt2-pipe2xfsdp2-shard_grad_op-gpipe", "gpt2", W,
         dict(pipe=2, fsdp=2, strategy="shard_grad_op"), "gpipe"),
    case("gpt2-pipe2xfsdp2-shard_opt-gpipe", "gpt2", W,
         dict(pipe=2, fsdp=2, strategy="shard_opt"), "gpipe"),
    case("gpt2-ring-pipe2xseq2-gpipe", "gpt2", W,
         dict(pipe=2, seq=2, strategy="no_shard"), "gpipe"),
    case("llama-ulysses-pipe2xseq2-1f1b", "llama_ulysses", W,
         dict(pipe=2, seq=2, strategy="no_shard"), "1f1b"),
    case("gpt2-pipe2xtensor2-gpipe", "gpt2", W,
         dict(pipe=2, tensor=2, strategy="no_shard"), "gpipe", ref="single"),
]
IDS = [c["name"] for c in CASES]


@pytest.fixture(scope="module")
def runs(tmp_path_factory, eight_devices):
    return start(tmp_path_factory, CASES, ["ckpt"], "pipe_comp")


@pytest.mark.parametrize("c", CASES, ids=IDS)
def test_pipeline_step_matches_jax(runs, c):
    check_step(runs, c)


@pytest.mark.parametrize("c", CASES, ids=IDS)
def test_pipeline_step_counts(runs, c):
    check_counts(runs, c)


def test_pipeline_checkpoint_round_trip(runs):
    _, _, outs = runs
    for o in outs:
        ck = o["ckpt"]
        assert ck["pipe2_to_pipe1_orbax_bit_equal"], o["rank"]
        assert ck["pipe2_to_pipe1_npz_bit_equal"], o["rank"]
        assert ck["pipe1_to_pipe2_bit_equal"], o["rank"]
    # one file per (stage, fsdp index): each stage writes its layers
    assert outs[0]["ckpt"]["pipe2_files"] == [
        "index.json", "shard_0.npz", "shard_1.npz", "shard_2.npz",
        "shard_3.npz"]
