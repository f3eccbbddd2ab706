"""The port's tensor-parallel building blocks against the JAX package's.

- ``ops/tp``: ``tp_copy``/``tp_reduce`` forward and backward on four gloo
  CPU ranks (one group, ``_torch_tp_jobs.job_tp_ops``), on the tensor
  groups ``parallel/mesh.make_mesh`` builds for tensor 4 alone and for
  data 2 x tensor 2, against JAX's ``shard_map`` over the same meshes of
  its virtual CPU devices: values, ``dx`` (summed over the tensor ranks by
  ``tp_copy``'s backward) and each rank's ``dw``, f32, atol = rtol =
  1e-6; one all-reduce forward and one backward; no-ops without a group.
- The spec rules, without processes: ``param_partition_specs`` with the
  tensor axis (alone and with fsdp), ``quantized_param_specs`` and
  ``AdapterRegistry.partition_specs`` equal JAX's, as tuples (a stacked
  leaf's layer dim dropped).
- ``MeshConfig(tensor > 1)`` builds; training with it refuses only what
  JAX refuses there (attention dropout under ``tensor_dropout="reject"``;
  it trains in ``tests/test_torch_tp_train.py``).
"""

import json
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

import _torch_tp_cases as C
from _torch_dist_worker import launch
from test_torch_serving_tp import read_outputs
from pytorch_distributed_tpu.config import MeshConfig as JaxMeshConfig
from pytorch_distributed_tpu.config import ModelConfig as JaxModelConfig
from pytorch_distributed_tpu.models import get_model as jget_model
from pytorch_distributed_tpu.ops.quant import (
    quantized_param_specs as jquant_specs,
)
from pytorch_distributed_tpu.ops.tp import tp_copy as jtp_copy
from pytorch_distributed_tpu.ops.tp import tp_reduce as jtp_reduce
from pytorch_distributed_tpu.parallel.sharding import (
    param_partition_specs as jparam_specs,
)
from pytorch_distributed_tpu.serving.adapters import (
    AdapterRegistry as JaxRegistry,
)
from pytorch_distributed_tpu.utils.compat import shard_map
from pytorch_distributed_tpu_torch import interop
from pytorch_distributed_tpu_torch.config import (
    MeshConfig,
    ModelConfig,
    TrainConfig,
)
from pytorch_distributed_tpu_torch.models import get_model
from pytorch_distributed_tpu_torch.ops import quant
from pytorch_distributed_tpu_torch.parallel import sharding
from pytorch_distributed_tpu_torch.parallel.api import (
    make_parallel_train_step,
)
from pytorch_distributed_tpu_torch.serving.adapters import AdapterRegistry
from pytorch_distributed_tpu_torch.train.distributed_trainer import (
    DistributedTrainer,
)
from pytorch_distributed_tpu_torch.train.optim import make_optimizer
from pytorch_distributed_tpu_torch.utils import tree

OPS_MESHES = {"tensor4": dict(tensor=4), "data2_tensor2": dict(data=2,
                                                               tensor=2)}
OPS_TOL = dict(atol=1e-6, rtol=1e-6)


def _ops_inputs(kw):
    d, t = kw.get("data", 1), kw["tensor"]
    rng = np.random.default_rng(7)
    return dict(x=rng.standard_normal((d, 3, 5)).astype(np.float32),
                w=rng.standard_normal((d, t, 5, 2)).astype(np.float32),
                c=rng.standard_normal((d, 3, 2)).astype(np.float32))


def _jax_ops(kw, inputs):
    """(y, dx, dw) of ``sum(tp_reduce(tp_copy(x) @ w) * c)`` under JAX's
    shard_map, stacked as the inputs are."""
    d, t = kw.get("data", 1), kw["tensor"]
    mesh = Mesh(np.asarray(jax.devices()[: d * t]).reshape(d, t),
                ("data", "tensor"))

    def body(x, w, c):
        x, w, c = x[0], w[0, 0], c[0]

        def loss(x, w):
            y = jtp_reduce(jtp_copy(x, "tensor") @ w, "tensor")
            return jnp.sum(y * c), y

        (_, y), (gx, gw) = jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True)(x, w)
        return y[None], gx[None], gw[None, None]

    # Untyped (check_vma off): this loss hands tp_reduce's backward a
    # cotangent invariant over the tensor axis, which JAX's typed
    # custom-VJP check refuses; the values are the same.
    fn = shard_map(body, mesh=mesh,
                   in_specs=(P("data"), P("data", "tensor"), P("data")),
                   out_specs=(P("data"), P("data"), P("data", "tensor")),
                   check_vma=False)
    return [np.asarray(a) for a in jax.jit(fn)(
        inputs["x"], inputs["w"], inputs["c"])]


@pytest.fixture(scope="module")
def ops_runs(tmp_path_factory):
    wd = tmp_path_factory.mktemp("tp_ops")
    inputs = {name: _ops_inputs(kw) for name, kw in OPS_MESHES.items()}
    (wd / "spec.json").write_text(json.dumps({
        "ops_meshes": OPS_MESHES,
        "ops": {name: {k: v.tolist() for k, v in inp.items()}
                for name, inp in inputs.items()}}))
    box = {}
    th = threading.Thread(target=lambda: box.update(
        results=launch("tp_ops", 4, wd, timeout_s=200)))
    th.start()
    want = {name: _jax_ops(OPS_MESHES[name], inp)
            for name, inp in inputs.items()}
    th.join()
    return want, read_outputs(wd, box["results"], n=4)


@pytest.mark.parametrize("mesh", list(OPS_MESHES))
def test_tp_copy_and_reduce_forward_and_backward_match_jax(ops_runs, mesh):
    want, outs = ops_runs
    y, dx, dw = want[mesh]
    for out in outs:
        case = out["cases"][mesh]
        d, t = case["coords"]
        np.testing.assert_allclose(case["y"], y[d], **OPS_TOL)
        np.testing.assert_allclose(case["dx"], dx[d], **OPS_TOL)
        np.testing.assert_allclose(case["dw"], dw[d, t], **OPS_TOL)
        assert case["fwd_collectives"] == 1 and case["collectives"] == 2
        assert case["no_group"]


def test_make_mesh_builds_the_tensor_groups(ops_runs):
    _, outs = ops_runs
    for r, out in enumerate(outs):
        assert out["cases"]["tensor4"]["group_ranks"] == [0, 1, 2, 3]
        assert out["cases"]["tensor4"]["coords"] == [0, r]
        # data major: rank = 2 d + t, so the tensor groups are {0, 1} and
        # {2, 3}.
        assert out["cases"]["data2_tensor2"]["coords"] == [r // 2, r % 2]
        assert out["cases"]["data2_tensor2"]["group_ranks"] == \
            [2 * (r // 2), 2 * (r // 2) + 1]


# -- the spec rules -----------------------------------------------------------


def _as_port_specs(jspecs) -> dict:
    """JAX specs keyed like the port's per-layer ones: a "blocks" leaf
    loses its leading (layer) entry; an all-None spec is ()."""
    out = {}
    for path, spec in jax.tree_util.tree_leaves_with_path(
            jspecs, is_leaf=lambda x: isinstance(x, P)):
        keys = tuple(getattr(p, "key", str(p)) for p in path)
        t = tuple(spec)
        if keys[0] == "blocks" and t:
            t = t[1:]
        out[keys] = t if any(e is not None for e in t) else ()
    return out


def _port_specs(specs) -> dict:
    return {(("blocks",) + path[2:] if path[0] == "blocks" else path): spec
            for path, spec in tree.leaves_with_path(specs)}


def _weights(name):
    kw = C.MODELS[name]
    jcfg, cfg = JaxModelConfig(**kw), ModelConfig(**kw)
    jparams = jax.device_get(jget_model(jcfg).init(jax.random.key(0), jcfg))
    return jcfg, jparams, cfg, interop.params_from_jax(jparams, cfg)


SPEC_MESHES = [dict(tensor=2), dict(tensor=4),
               dict(tensor=2, fsdp=2, strategy="full_shard"),
               dict(tensor=2, fsdp=2, strategy="shard_grad_op")]


@pytest.mark.parametrize("name", list(C.MODELS))
def test_param_and_quantized_specs_match_jax(name):
    jcfg, jparams, cfg, params = _weights(name)
    for kw in SPEC_MESHES:
        jm, m = JaxMeshConfig(**kw), MeshConfig(**kw)
        for for_grads in (False, True):
            want = jparam_specs(jparams, jm, for_grads=for_grads)
            got = sharding.param_partition_specs(params, m,
                                                 for_grads=for_grads)
            assert _port_specs(got) == _as_port_specs(want), (kw, for_grads)
        if cfg.n_experts:
            continue  # weight_quant covers dense configs only
        want = jquant_specs(jparam_specs(jparams, jm), jparams)
        got = quant.quantized_param_specs(
            sharding.param_partition_specs(params, m), params)
        assert _port_specs(got) == _as_port_specs(want), kw


def test_tensor_dim_not_divisible_is_refused_as_in_jax():
    jcfg, jparams, cfg, params = _weights("gpt2")
    with pytest.raises(ValueError, match="not divisible by tensor=3"):
        jparam_specs(jparams, JaxMeshConfig(tensor=3))
    with pytest.raises(ValueError, match="not divisible by tensor=3"):
        sharding.param_partition_specs(params, MeshConfig(tensor=3))


@pytest.mark.parametrize("name", ["gpt2", "llama"])
def test_adapter_partition_specs_match_jax(name):
    jreg = JaxRegistry(JaxModelConfig(**C.MODELS[name]), rank=4)
    reg = AdapterRegistry(ModelConfig(**C.MODELS[name]), rank=4)
    want = {t: {k: tuple(s) for k, s in v.items()}
            for t, v in jreg.partition_specs().items()}
    assert reg.partition_specs() == want


def test_adapter_shards_concatenate_to_the_full_factors():
    cfg = ModelConfig(**C.MODELS["llama"])
    reg = AdapterRegistry(cfg, rank=4, max_tenants=2)
    from pytorch_distributed_tpu_torch.serving.adapters import _targets

    reg.register("t", C.lora_factors(_targets(cfg), 1))
    full = reg.device_tree("cpu")
    parts = [reg.device_tree("cpu", shard=(i, 2)) for i in range(2)]
    for layer in range(cfg.n_layer):
        wq = [p[layer]["wq"]["b_flat"].reshape(4, 3, -1) for p in parts]
        assert np.array_equal(
            np.concatenate([w.numpy() for w in wq], axis=-1),
            full[layer]["wq"]["b_flat"].reshape(4, 3, -1).numpy())
        wo = [p[layer]["wo"]["a_flat"] for p in parts]
        assert np.array_equal(np.concatenate([w.numpy() for w in wo]),
                              full[layer]["wo"]["a_flat"].numpy())


# -- the mesh config and training ---------------------------------------------


def test_tensor_mesh_builds_and_training_refuses_it():
    """The tensor axis builds and trains (item 7(f), done); what training
    refuses under it is JAX's refusal: attention dropout with
    ``tensor_dropout="reject"`` (tests/test_torch_tp_train.py trains)."""
    m = MeshConfig(tensor=2)
    assert m.num_devices == 2 and m.shape["tensor"] == 2
    cfg = ModelConfig(**dict(C.MODELS["gpt2"], attn_pdrop=0.1))
    assert cfg.tensor_dropout == "reject"
    tcfg = TrainConfig(global_batch_size=4, micro_batch_size=2)
    with pytest.raises(NotImplementedError, match="tensor_dropout"):
        make_parallel_train_step(get_model(cfg), cfg, make_optimizer(tcfg),
                                 None, m, None)
    with pytest.raises(NotImplementedError, match="tensor_dropout"):
        DistributedTrainer(get_model(cfg), cfg, tcfg, None, m)
