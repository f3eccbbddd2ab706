"""The twin of ``scripts/generate.py``
(``python -m pytorch_distributed_tpu_torch.serving.generate``) on the
CPU: its flags and refusals, its routing (plain, ``--stream``,
``--speculative`` on dense and MoE models) and its printed ids, which
must equal the JAX script's on the same weights for greedy decoding.
"""

import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_tpu.config import model_config as jax_model_config
from pytorch_distributed_tpu.models import decode as jdecode
from pytorch_distributed_tpu_torch import interop
from pytorch_distributed_tpu_torch.serving import generate

BASE = ["--preset", "tiny", "--device", "cpu", "--prompt-ids",
        "5,9,12,5,9,12,5", "--max-new-tokens", "12"]


def _run(argv, capsys):
    assert generate.main(argv) == 0
    out = capsys.readouterr().out.strip().splitlines()[-1]
    return [int(t) for t in out.split(",")]


@pytest.fixture(scope="module")
def tiny():
    args = generate.parse_args(BASE)
    return generate.load_params(args)


def test_plain_speculative_and_stream_print_the_same_greedy_ids(capsys):
    plain = _run(BASE, capsys)
    assert len(plain) == 7 + 12 and plain[:7] == [5, 9, 12, 5, 9, 12, 5]
    assert _run(BASE + ["--speculative", "4"], capsys) == plain
    assert _run(BASE + ["--speculative", "2", "--ngram", "1"],
                capsys) == plain
    assert _run(BASE + ["--stream"], capsys) == plain[7:]


def test_checkpoint_weights_are_the_ones_generated_from(tmp_path):
    """``--checkpoint``: the port's npz checkpoint (the format both
    packages write) is loaded into the preset's params, and the printed
    ids are those of the saved weights."""
    from pytorch_distributed_tpu_torch.config import TrainConfig
    from pytorch_distributed_tpu_torch.models import gpt2
    from pytorch_distributed_tpu_torch.train.checkpoint import (
        save_checkpoint,
    )
    from pytorch_distributed_tpu_torch.train.optim import make_optimizer
    from pytorch_distributed_tpu_torch.train.state import init_train_state

    args = generate.parse_args(BASE)
    cfg, fresh = generate.load_params(args)
    trained = gpt2.init(torch.Generator().manual_seed(99), cfg,
                        device="cpu")
    tx = make_optimizer(TrainConfig(global_batch_size=1,
                                    micro_batch_size=1, num_steps=1))
    save_checkpoint(tmp_path / "ckpt", init_train_state(trained, tx), cfg)
    args = generate.parse_args(BASE + ["--checkpoint",
                                       str(tmp_path / "ckpt")])
    _, loaded = generate.load_params(args)
    torch.testing.assert_close(loaded["wte"], trained["wte"])
    assert not torch.equal(loaded["wte"], fresh["wte"])
    ids = generate.prompt_ids(args)
    np.testing.assert_array_equal(
        generate.generate_ids(args, cfg, loaded, ids),
        generate.generate_ids(args, cfg, trained, ids))


def test_greedy_ids_equal_the_jax_generate(tiny):
    """The twin's tokens for the random-init ``tiny`` weights equal JAX's
    ``decode.generate`` on the same weights (converted to JAX)."""
    cfg, params = tiny
    args = generate.parse_args(BASE)
    ids = generate.prompt_ids(args)
    got = generate.generate_ids(args, cfg, params, ids)
    jcfg = jax_model_config("tiny").replace(attn_pdrop=0.0, resid_pdrop=0.0,
                                            embd_pdrop=0.0)
    jparams = jax.tree.map(jnp.asarray, interop.params_to_jax(params, cfg))
    want = np.asarray(jdecode.generate(jparams, jnp.asarray(ids), jcfg, 12))
    np.testing.assert_array_equal(got, want[0])


def test_moe_routes_and_speculates(capsys):
    moe = BASE + ["--n-experts", "4", "--moe-top-k", "2"]
    plain = _run(moe, capsys)
    assert len(plain) == 19
    assert _run(moe + ["--speculative", "3"], capsys) == plain
    args = generate.parse_args(moe)
    cfg, _ = generate.load_params(args)
    assert cfg.n_experts == 4 and cfg.moe_top_k == 2


def test_sampling_is_a_function_of_the_seed(capsys):
    kw = ["--temperature", "0.9", "--top-k", "40", "--top-p", "0.95"]
    a = _run(BASE + kw + ["--seed", "3"], capsys)
    assert _run(BASE + kw + ["--seed", "3"], capsys) == a
    assert _run(BASE + kw + ["--seed", "3", "--stream"], capsys) == a[7:]


@pytest.mark.parametrize("flags, match", [
    (["--speculative", "4", "--temperature", "0.8"], "greedy-only"),
    (["--speculative", "4", "--top-k", "40"], "top-k"),
    (["--speculative", "4", "--top-p", "0.9"], "top-p"),
    (["--speculative", "4", "--stream"], "cannot stream"),
    (["--mesh", "tensor=2"], "queue 1 item 7"),
    (["--cpu-devices", "8"], "--device cpu"),
    (["--hf", "gpt2"], "downloads nothing"),
    (["--tokenizer", "gpt2"], "downloads nothing"),
])
def test_refusals_before_any_weight_io(flags, match):
    with pytest.raises(SystemExit, match=match):
        generate.parse_args(BASE + flags)


def test_default_device_is_the_card():
    args = generate.parse_args(["--preset", "tiny"])
    assert args.device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            generate.load_params(args)


def test_the_module_runs_as_a_program():
    out = subprocess.run(
        [sys.executable, "-m", "pytorch_distributed_tpu_torch.serving.generate",
         *BASE], capture_output=True, text=True, timeout=300, check=True,
    ).stdout.strip().split(",")
    assert len(out) == 19
