"""The port's ``models/hf_import`` against in-memory ``transformers``
models and against the JAX package's ``models/hf_import``, on the CPU in
f32.

Tiny GPT-2, Llama (GQA) and Mixtral (4 experts, top-2) models are built
from ``transformers`` config objects with seeded weights (no download).
Their state dicts import into the port's params, which equal the JAX
package's import converted by ``interop`` exactly, and give the HF
model's logits within atol 2e-5 / rtol 1e-4 (f32, summation order; the
Mixtral capacity at its no-drop bound X / k). Export inverts import
exactly, and the shape checks reject a checkpoint that does not fit the
config.
"""

import jax
import numpy as np
import pytest
import torch

from pytorch_distributed_tpu.config import ModelConfig as JaxModelConfig
from pytorch_distributed_tpu.models import hf_import as jhf
from pytorch_distributed_tpu_torch import interop
from pytorch_distributed_tpu_torch.config import ModelConfig, model_config
from pytorch_distributed_tpu_torch.models import get_model, hf_import
from pytorch_distributed_tpu_torch.utils import tree

transformers = pytest.importorskip("transformers")

V, E, L, T = 101, 64, 2, 24
LOGITS_TOL = dict(atol=2e-5, rtol=1e-4)


def _gpt2():
    hf_cfg = transformers.GPT2Config(vocab_size=V, n_positions=32, n_embd=E,
                                     n_layer=L, n_head=4)
    torch.manual_seed(0)
    model = transformers.GPT2LMHeadModel(hf_cfg).eval()
    cfg = model_config("gpt2", vocab_size=V, n_ctx=32, n_embd=E, n_layer=L,
                       n_head=4, dtype="float32")
    return model, cfg


def _llama(mixtral=False):
    kw = dict(vocab_size=V, hidden_size=E, intermediate_size=96,
              num_hidden_layers=L, num_attention_heads=4,
              num_key_value_heads=2, max_position_embeddings=64,
              rms_norm_eps=1e-5, rope_theta=10000.0,
              tie_word_embeddings=False)
    torch.manual_seed(1)
    if mixtral:
        hf_cfg = transformers.MixtralConfig(num_local_experts=4,
                                            num_experts_per_tok=2,
                                            sliding_window=None, **kw)
        model = transformers.MixtralForCausalLM(hf_cfg).eval()
    else:
        hf_cfg = transformers.LlamaConfig(**kw)
        model = transformers.LlamaForCausalLM(hf_cfg).eval()
    extra = dict(n_experts=4, moe_top_k=2, expert_capacity_factor=2.0) \
        if mixtral else {}
    cfg = model_config("llama3-1b", vocab_size=V, n_ctx=64, n_embd=E,
                       n_layer=L, n_head=4, n_kv_head=2, n_inner=96,
                       rope_theta=10000.0, dtype="float32", **extra)
    return model, cfg


MODELS = {"gpt2": _gpt2, "llama": _llama,
          "mixtral": lambda: _llama(mixtral=True)}


def _imports(name):
    return (hf_import.from_hf_gpt2_state_dict if name == "gpt2"
            else hf_import.from_hf_llama_state_dict,
            jhf.from_hf_gpt2_state_dict if name == "gpt2"
            else jhf.from_hf_llama_state_dict)


def _jax_cfg(cfg):
    return JaxModelConfig(**{f: getattr(cfg, f)
                             for f in cfg.__dataclass_fields__})


@pytest.mark.parametrize("name", list(MODELS))
def test_import_gives_the_hf_logits(name):
    model, cfg = MODELS[name]()
    ours, _ = _imports(name)
    params = ours(model.state_dict(), cfg)
    ids = torch.from_numpy(np.random.default_rng(2).integers(0, V, (2, T)))
    with torch.no_grad():
        want = model(ids).logits
        got = get_model(cfg).apply(params, ids, cfg)
    torch.testing.assert_close(got, want, **LOGITS_TOL)


@pytest.mark.parametrize("name", list(MODELS))
def test_import_equals_the_jax_import(name):
    model, cfg = MODELS[name]()
    ours, theirs = _imports(name)
    sd = model.state_dict()
    got = jax.tree_util.tree_leaves_with_path(
        interop.params_to_jax(ours(sd, cfg), cfg))
    want = jax.tree_util.tree_leaves_with_path(theirs(sd, _jax_cfg(cfg)))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, a), (_, b) in zip(got, want):
        assert a.dtype == b.dtype == np.float32, path
        np.testing.assert_array_equal(a, b, err_msg=str(path))


@pytest.mark.parametrize("name", list(MODELS))
def test_export_inverts_import(name):
    model, cfg = MODELS[name]()
    sd = {k: v.numpy() for k, v in model.state_dict().items()
          if "rotary" not in k and not k.endswith(".attn.bias")
          and not k.endswith("masked_bias")}
    ours, _ = _imports(name)
    params = ours(sd, cfg)
    if name == "gpt2":
        out = hf_import.to_hf_gpt2_state_dict(params)
        want = {k[len("transformer."):] if k.startswith("transformer.")
                else k: v for k, v in sd.items()}
        jout = jhf.to_hf_gpt2_state_dict(jhf.from_hf_gpt2_state_dict(
            sd, _jax_cfg(cfg)))
    else:
        out = hf_import.to_hf_llama_state_dict(params)
        want = sd
        jout = jhf.to_hf_llama_state_dict(jhf.from_hf_llama_state_dict(
            sd, _jax_cfg(cfg)))
    assert sorted(out) == sorted(want) == sorted(jout)
    for k in want:
        np.testing.assert_array_equal(out[k], want[k], err_msg=k)
        np.testing.assert_array_equal(out[k], np.asarray(jout[k]), err_msg=k)


def test_reference_layout_and_bf16_params():
    model, cfg = _gpt2()
    sd = model.state_dict()
    linear = {k: (v.t() if k.endswith(tuple(hf_import._KERNELS)) else v)
              for k, v in sd.items()}
    a = hf_import.from_hf_gpt2_state_dict(sd, cfg)
    b = hf_import.from_reference_state_dict(linear, cfg)
    for x, y in zip(tree.leaves(a), tree.leaves(b)):
        assert torch.equal(x, y)
    bf = hf_import.from_hf_gpt2_state_dict(
        {k: v.to(torch.bfloat16) for k, v in sd.items()},
        cfg.replace(param_dtype="bfloat16"))
    for x, y in zip(tree.leaves(bf), tree.leaves(a)):
        assert x.dtype == torch.bfloat16 and torch.equal(
            x, y.to(torch.bfloat16))


def test_tied_llama_checkpoint_reuses_the_embedding():
    model, cfg = _llama()
    sd = {k: v for k, v in model.state_dict().items()
          if k != "lm_head.weight"}
    params = hf_import.from_hf_llama_state_dict(sd, cfg)
    assert torch.equal(params["lm_head"], params["wte"].t())
    out = hf_import.to_hf_llama_state_dict(params)
    assert "lm_head.weight" not in out
    assert "lm_head.weight" in hf_import.to_hf_llama_state_dict(params,
                                                                tied=False)


def test_mismatched_checkpoints_are_rejected():
    model, cfg = _gpt2()
    sd = model.state_dict()
    with pytest.raises(ValueError, match="wte shape"):
        hf_import.from_hf_gpt2_state_dict(sd, cfg.replace(vocab_size=100))
    with pytest.raises(KeyError, match="missing 'h.2"):
        hf_import.from_hf_gpt2_state_dict(sd, cfg.replace(n_layer=3))
    with pytest.raises(ValueError, match="c_attn kernel"):
        hf_import.from_reference_state_dict(
            {k: (v[:, :E] if k.endswith("c_attn.weight") else v)
             for k, v in sd.items()}, cfg)
    lmodel, lcfg = _llama()
    lsd = lmodel.state_dict()
    with pytest.raises(ValueError, match="wk stacked shape"):
        hf_import.from_hf_llama_state_dict(lsd, lcfg.replace(n_kv_head=4))
    mmodel, mcfg = _llama(mixtral=True)
    msd = mmodel.state_dict()
    with pytest.raises(ValueError, match="moe_top_k >= 2"):
        hf_import.from_hf_llama_state_dict(msd, mcfg.replace(moe_top_k=1))
    with pytest.raises(KeyError, match="experts.4"):
        hf_import.from_hf_llama_state_dict(msd, mcfg.replace(n_experts=5))
    with pytest.raises(ValueError, match="n_inner"):
        hf_import.from_hf_llama_state_dict(msd, mcfg.replace(n_inner=128))


@pytest.mark.parametrize("name", ["gpt2", "mixtral"])
def test_from_hf_pretrained_reads_a_local_directory(tmp_path, name):
    model, cfg = MODELS[name]()
    model.save_pretrained(tmp_path)
    params, got_cfg = hf_import.from_hf_pretrained(str(tmp_path))
    assert (got_cfg.family, got_cfg.n_layer, got_cfg.n_embd,
            got_cfg.vocab_size, got_cfg.n_experts) == (
        cfg.family, L, E, V, cfg.n_experts)
    if name == "mixtral":
        assert (got_cfg.moe_top_k, got_cfg.expert_capacity_factor,
                got_cfg.kv_heads) == (2, 2.0, 2)
    ids = torch.from_numpy(np.random.default_rng(3).integers(0, V, (1, T)))
    run_cfg = got_cfg.replace(dtype="float32")
    with torch.no_grad():
        got = get_model(run_cfg).apply(params, ids, run_cfg)
        want = model(ids).logits
    torch.testing.assert_close(got, want, **LOGITS_TOL)
