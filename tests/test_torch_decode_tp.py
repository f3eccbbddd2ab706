"""The port's meshed generation — ``generate_tp``, ``generate_fsdp`` and
their reference loops — on two gloo CPU ranks, against the JAX
package's on its virtual CPU devices.

One group of two rank processes (``_torch_tp_jobs.job_decode_tp``) runs
every case for GPT-2, Llama GQA (4 query heads over 2 KV heads) and MoE
of both families (4 experts; GPT-2's top-2), f32, the JAX ``init``'s
weights sharpened (``_torch_tp_cases``) — the logits at init scale —;
the JAX side runs in this process meanwhile. Greedy tokens equal JAX's
``generate_tp`` and ``generate_fsdp`` (both shims and both reference
loops); sampled tokens
equal the port's plain ``generate`` (JAX's threefry stream cannot be
matched). The TP forward's logits over a prefill and two decode steps
are within atol = rtol = 1e-5 of JAX's plain ``forward`` (f32; only the
split of each row-parallel sum differs), with 2 x n_layer all-reduces a
forward and a cache of the rank's KV heads. Both ranks' outputs are
identical. Bad meshes are refused as JAX refuses them.
"""

import json
import threading
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import _torch_tp_cases as C
from _torch_dist_worker import launch
from test_torch_serving_tp import read_outputs, write_params
from pytorch_distributed_tpu.config import MeshConfig as JaxMeshConfig
from pytorch_distributed_tpu.config import ModelConfig as JaxModelConfig
from pytorch_distributed_tpu.models import decode as jdecode
from pytorch_distributed_tpu.models import get_model as jget_model
from pytorch_distributed_tpu_torch.config import MeshConfig, ModelConfig
from pytorch_distributed_tpu_torch.models import decode
from pytorch_distributed_tpu_torch.serving.engine import (
    BatchedDecodeEngine,
    DecodeEngine,
    PagedBatchedDecodeEngine,
)

MODELS = tuple(C.MODELS)
LOGITS_TOL = dict(atol=1e-5, rtol=1e-5)


def _jax_refs(jcfg, jparams, init_params):
    prompts = jnp.asarray(C.gen_prompts(), jnp.int32)
    want = {
        "tp": np.asarray(jdecode.generate_tp(
            jparams, prompts, jcfg, JaxMeshConfig(**C.TP), 8)).tolist(),
        "fsdp": np.asarray(jdecode.generate_fsdp(
            jparams, prompts, jcfg, JaxMeshConfig(**C.ZERO3), 8)).tolist(),
    }
    # The plain forward the TP forward is held to: a prefill, then two
    # greedy single-token steps, at init scale (the sharpened weights'
    # logits are O(10), where 1e-5 is a few f32 ulps).
    cache = jdecode.init_cache(jcfg, 2, 16)
    ids, logits = prompts, []
    for pos in (0, 5, 6):
        lg, cache = jdecode.forward(init_params, ids, jcfg, cache, pos)
        logits.append(np.asarray(lg[:, -1]))
        ids = jnp.argmax(lg[:, -1], axis=-1)[:, None].astype(jnp.int32)
    want["logits"] = logits
    return want


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    wd = tmp_path_factory.mktemp("decode_tp")
    weights = {name: (*write_params(wd, name),
                      write_params(wd, name, 1.0, "_init")[1])
               for name in MODELS}
    (wd / "spec.json").write_text(json.dumps({"models": list(MODELS)}))
    box = {}
    th = threading.Thread(target=lambda: box.update(
        results=launch("decode_tp", 2, wd, timeout_s=300)))
    th.start()
    with ThreadPoolExecutor(len(weights)) as pool:
        want = dict(zip(weights, pool.map(lambda w: _jax_refs(*w),
                                          weights.values())))
    th.join()
    return want, read_outputs(wd, box["results"])


@pytest.fixture(params=MODELS)
def model(request, runs):
    want, outs = runs
    return request.param, want[request.param], \
        outs[0]["models"][request.param]


def test_ranks_identical(runs):
    a, b = (o["models"] for o in runs[1])
    assert a == b


def test_generate_tp_matches_jax(model):
    _, want, got = model
    assert got["tp"] == want["tp"]
    assert got["tp_monolithic"] == want["tp"]


def test_generate_fsdp_matches_jax(model):
    _, want, got = model
    assert got["fsdp"] == want["fsdp"]
    assert got["fsdp_monolithic"] == want["fsdp"]


def test_sampled_rows_equal_the_plain_generate(model):
    _, _, got = model
    assert got["tp_sampled"] == got["plain_sampled"]
    assert got["fsdp_sampled"] == got["plain_sampled"]


def test_tp_logits_within_1e5_of_jax(model):
    name, want, got = model
    cfg = ModelConfig(**C.MODELS[name])
    for ours, theirs in zip(got["logits"], want["logits"]):
        np.testing.assert_allclose(np.asarray(ours), theirs, **LOGITS_TOL)
    assert got["collectives_per_forward"] == [2 * cfg.n_layer] * 3
    assert got["cache_heads"] == cfg.kv_heads // 2


def _jax_setup(kw):
    jcfg = JaxModelConfig(**kw)
    return jcfg, jget_model(jcfg).init(jax.random.key(0), jcfg)


@pytest.mark.parametrize("fn, mesh_kw, exc, match", [
    ("generate_tp", dict(tensor=1), ValueError, "tensor > 1"),
    ("generate_tp", dict(tensor=2, data=2), NotImplementedError,
     "tensor-only"),
    ("generate_tp_monolithic", dict(tensor=2, fsdp=2), NotImplementedError,
     "tensor-only"),
    ("generate_tp", dict(tensor=3), ValueError, "must divide n_head"),
    ("generate_fsdp", dict(fsdp=1), ValueError, "fsdp > 1"),
    ("generate_fsdp", dict(fsdp=2, tensor=2), NotImplementedError,
     "fsdp-only"),
    ("generate_fsdp_monolithic",
     dict(fsdp=2, strategy="shard_grad_op"), ValueError, "full_shard"),
], ids=["tp1", "tp_data", "tp_fsdp", "tp3", "fsdp1", "fsdp_tp",
        "fsdp_zero2"])
def test_bad_meshes_refused_as_jax_refuses_them(fn, mesh_kw, exc, match):
    kw = dict(C.MODELS["gpt2"])
    jcfg, jparams = _jax_setup(kw)
    prompt = np.zeros((1, 3), np.int32)
    with pytest.raises(exc, match=match):
        getattr(jdecode, fn)(jparams, jnp.asarray(prompt), jcfg,
                             JaxMeshConfig(**mesh_kw), 2)
    with pytest.raises(exc, match=match):
        getattr(decode, fn)(None, prompt, ModelConfig(**kw),
                            MeshConfig(**mesh_kw), 2, device="cpu")


def test_moe_inner_dim_must_split_as_in_jax():
    kw = dict(C.MODELS["gpt2"], n_experts=4, n_inner=63)
    jcfg, jparams = _jax_setup(kw)
    prompt = np.zeros((1, 3), np.int32)
    with pytest.raises(ValueError, match="inner_dim"):
        jdecode.generate_tp(jparams, jnp.asarray(prompt), jcfg,
                            JaxMeshConfig(tensor=2), 2)
    with pytest.raises(ValueError, match="inner_dim"):
        decode.generate_tp(None, prompt, ModelConfig(**kw),
                           MeshConfig(tensor=2), 2, device="cpu")


@pytest.mark.parametrize("make", [
    lambda cfg, m: DecodeEngine(cfg, max_len=16, mesh_cfg=m, device="cpu"),
    lambda cfg, m: BatchedDecodeEngine(cfg, slots=2, max_len=16,
                                       mesh_cfg=m, device="cpu"),
    lambda cfg, m: PagedBatchedDecodeEngine(cfg, slots=2, max_len=16,
                                            page_size=8, mesh_cfg=m,
                                            device="cpu"),
], ids=["serial", "dense", "paged"])
def test_engines_refuse_the_mixed_mesh_and_batched_zero3(make):
    cfg = ModelConfig(**C.MODELS["gpt2"])
    with pytest.raises(NotImplementedError, match="TP x ZeRO-3"):
        make(cfg, MeshConfig(tensor=2, fsdp=2))
    if not isinstance(make(cfg, None), DecodeEngine):
        with pytest.raises(NotImplementedError, match="ZeRO-3 slot-batched"):
            make(cfg, MeshConfig(fsdp=2))
