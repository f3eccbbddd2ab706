"""The port's data-parallel steps against the JAX package's, GPT-2.

The same seeded weights (JAX ``gpt2.init``) and batches go through the
JAX explicit step on a mesh of the conftest's CPU devices and through the
port's ``make_parallel_train_step`` on gloo CPU ranks (one group of four
processes runs every case, ``_torch_dist_worker.job_parallel``): each
strategy at data 2, fsdp 2 and data 2 x fsdp 2, three steps at A = 2,
clip 1.0, f32, no dropout. GPT-2 at n_embd 27 over 3 heads, so under
fsdp 2 the MLP's leaves shard (their hidden dim, 108) and the others
stay replicated (the layer norms, attention, the embeddings: 27 and 3
are odd). Tolerances: loss and grad norm rtol 1e-5; params rtol 1e-5
with an absolute floor of 1e-5
(``_torch_parallel_cases.assert_case_matches``). Each rank's element
count per leaf equals JAX's device shard's. The mesh, sharding and
config rules are held to JAX's without processes.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from _torch_dist_worker import launch
from _torch_parallel_cases import (
    CASE_IDS,
    CASES,
    assert_case_matches,
    assert_numel_matches,
    run_jax_case,
    write_inputs,
)
from pytorch_distributed_tpu.config import MeshConfig as JaxMeshConfig
from pytorch_distributed_tpu.config import ModelConfig as JaxModelConfig
from pytorch_distributed_tpu.config import TrainConfig as JaxTrainConfig
from pytorch_distributed_tpu.models import get_model as jget_model
from pytorch_distributed_tpu.parallel.mesh import (
    batch_partition_spec as jbatch_spec,
)
from pytorch_distributed_tpu.parallel.mesh import (
    data_parallel_size as jdp_size,
)
from pytorch_distributed_tpu.parallel.sharding import (
    opt_state_partition_specs as jopt_specs,
)
from pytorch_distributed_tpu.parallel.sharding import (
    param_partition_specs as jparam_specs,
)
from pytorch_distributed_tpu.train.optim import make_optimizer as jmake_opt
from pytorch_distributed_tpu.train.state import init_train_state as jinit
from pytorch_distributed_tpu_torch import interop
from pytorch_distributed_tpu_torch.config import (
    MeshConfig,
    ModelConfig,
    TrainConfig,
)
from pytorch_distributed_tpu_torch.models import get_model
from pytorch_distributed_tpu_torch.parallel import mesh as pmesh
from pytorch_distributed_tpu_torch.parallel.api import (
    make_parallel_train_step,
)
from pytorch_distributed_tpu_torch.parallel import sharding
from pytorch_distributed_tpu_torch.train.optim import make_optimizer
from pytorch_distributed_tpu_torch.train.state import init_train_state
from pytorch_distributed_tpu_torch.utils.prng import DropoutKey

MODEL_KW = dict(vocab_size=97, n_ctx=32, n_embd=27, n_layer=2, n_head=3,
                dtype="float32", embd_pdrop=0.0, attn_pdrop=0.0,
                resid_pdrop=0.0, attention_impl="flash", remat="names")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Start the port's ranks, run the JAX side meanwhile, then wait."""
    workdir = tmp_path_factory.mktemp("parallel_gpt2")
    params, batches = write_inputs(workdir, MODEL_KW)
    import threading

    result: dict = {}
    ranks = threading.Thread(target=lambda: result.update(
        port=launch("parallel", 4, workdir)))
    ranks.start()
    jax_runs = {c["name"]: run_jax_case(MODEL_KW, c, params, batches)
                for c in CASES}
    ranks.join()
    assert "port" in result, "the port's ranks did not finish"
    return workdir, jax_runs


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_strategy_matches_jax(runs, case):
    workdir, jax_runs = runs
    assert_case_matches(workdir, case["name"], jax_runs[case["name"]])


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_shard_element_counts_match_jax(runs, case):
    workdir, jax_runs = runs
    n = 4 if case["group"] == "world" else 2
    assert_numel_matches(workdir, case["name"], jax_runs[case["name"]], n)


def _meshes():
    return [JaxMeshConfig(data=2, strategy=s) for s in
            ("no_shard", "full_shard")] + [
        JaxMeshConfig(fsdp=f, strategy=s)
        for f in (2, 3, 4) for s in ("full_shard", "shard_grad_op",
                                     "shard_opt", "no_shard")]


@pytest.mark.parametrize("family", ["gpt2", "llama"])
def test_partition_specs_match_jax(family):
    """Per leaf, the port's spec is JAX's with a stacked leaf's layer dim
    dropped, for params, grads and Adam's moments."""
    kw = (MODEL_KW if family == "gpt2" else
          dict(family="llama", vocab_size=97, n_ctx=32, n_embd=32,
               n_layer=2, n_head=4, n_kv_head=2, n_inner=48,
               dtype="float32"))
    jcfg, cfg = JaxModelConfig(**kw), ModelConfig(**kw)
    jparams = jax.device_get(jget_model(jcfg).init(jax.random.key(0), jcfg))
    params = interop.params_from_jax(jparams, cfg)
    opt = make_optimizer(TrainConfig()).init(params)
    jopt = jinit(jparams, jmake_opt(JaxTrainConfig())).opt_state

    def unstack(tree):
        """JAX specs as the port's per-layer ones: "blocks" leaves lose
        their leading entry, every spec becomes a padded tuple."""
        out = {}
        for path, spec in jax.tree_util.tree_leaves_with_path(
                tree, is_leaf=lambda x: isinstance(x, jax.sharding
                                                   .PartitionSpec)):
            keys = tuple(getattr(p, "key", str(p)) for p in path)
            out[keys] = tuple(spec)
        return out

    for jm in _meshes():
        m = MeshConfig(**{k: getattr(jm, k) for k in
                          ("data", "fsdp", "strategy")})
        for for_grads in (False, True):
            want = unstack(jparam_specs(jparams, jm, for_grads=for_grads))
            got = sharding.param_partition_specs(params, m,
                                                 for_grads=for_grads)
            _compare(got, want, jparams)
        jo = jopt_specs(jopt, None, jm)[1]
        got = sharding.opt_state_partition_specs(opt, m)
        for k in ("mu", "nu"):
            _compare(got[k], unstack(getattr(jo, k)), jparams)


def _compare(got_tree, want: dict, jparams) -> None:
    from pytorch_distributed_tpu_torch.utils import tree

    for path, spec in tree.leaves_with_path(got_tree):
        stacked = path[0] == "blocks"
        keys = (("blocks",) + tuple(p for p in path[2:]) if stacked
                else tuple(path))
        w = want[keys]
        ndim = len(spec) if spec else None
        w_full = tuple(w) + (None,) * 8
        if stacked:
            assert w_full[0] is None, keys
            w_full = w_full[1:]
        if spec == ():
            assert all(x is None for x in w_full), (keys, w)
        else:
            assert tuple(spec) == w_full[:ndim], (keys, spec, w)


def test_mesh_config_matches_jax_field_for_field():
    for kw in ({}, dict(data=2, fsdp=4, strategy="shard_opt", rs_buckets=4),
               dict(fsdp=2, device_ids=(3, 1))):
        assert (dataclasses.asdict(MeshConfig(**kw))
                == dataclasses.asdict(JaxMeshConfig(**kw)))
        assert MeshConfig(**kw).shape == JaxMeshConfig(**kw).shape
        assert pmesh.data_parallel_size(MeshConfig(**kw)) == \
            jdp_size(JaxMeshConfig(**kw))
        assert pmesh.batch_partition_spec(MeshConfig(**kw)) == \
            tuple(jbatch_spec(JaxMeshConfig(**kw)))
    for bad in (dict(strategy="zero9"), dict(rs_buckets=-1),
                dict(fsdp=2, device_ids=(0, 0))):
        with pytest.raises(ValueError):
            MeshConfig(**bad)


@pytest.mark.parametrize("kw, item", [
    (dict(tensor=2), "tensor_dropout"), (dict(seq=2), "ring-attention"),
    (dict(pipe=2), "7(d)"), (dict(expert=2), "7(e)"),
    (dict(prefetch_buffers=1), "7(d)"),
], ids=["tensor", "seq", "pipe", "expert", "prefetch"])
def test_unported_axes_raise_naming_their_item(kw, item):
    JaxMeshConfig(**kw)  # JAX takes them
    with pytest.raises(NotImplementedError, match=item.replace("(", r"\(")
                       .replace(")", r"\)")):
        if "tensor" in kw or "seq" in kw:
            # The tensor and seq axes train (items 7(f) and 7(c), done);
            # what stays refused under them is JAX's: attention dropout
            # with tensor_dropout "reject", and with the ring.
            cfg = ModelConfig(**dict(MODEL_KW, attn_pdrop=0.1))
            make_parallel_train_step(
                get_model(cfg), cfg, make_optimizer(TrainConfig()), None,
                MeshConfig(**kw), None)
        else:
            MeshConfig(**kw)


class _FakeMesh:
    def __init__(self, cfg, coords):
        self.cfg, self.coords = cfg, coords

    def axis_size(self, ax):
        return getattr(self.cfg, ax)

    def axis_index(self, ax):
        return self.coords[ax]


def test_batch_rows_follow_jax_batch_sharding():
    """Rank r of a data x fsdp mesh owns JAX's device r's rows of the
    global batch (data major), and make_batch_put places them."""
    jm = JaxMeshConfig(data=2, fsdp=2)
    from pytorch_distributed_tpu.parallel import make_mesh as jmake_mesh
    from pytorch_distributed_tpu.parallel.mesh import make_batch_put

    jput = make_batch_put(jmake_mesh(jm), jm)
    x = np.arange(2 * 8 * 3).reshape(2, 8, 3).astype(np.int32)
    jx = jput({"inputs": x})["inputs"]
    jmesh = jmake_mesh(jm)
    cfg = MeshConfig(data=2, fsdp=2)
    for r, dev in enumerate(jmesh.devices.flat):
        coords = dict(zip(cfg.axis_order, np.unravel_index(
            r, tuple(cfg.shape.values()))))
        fake = _FakeMesh(cfg, {k: int(v) for k, v in coords.items()})
        want = [s.data for s in jx.addressable_shards if s.device == dev][0]
        np.testing.assert_array_equal(x[:, pmesh.batch_rows(fake, 8)],
                                      np.asarray(want))
    with pytest.raises(ValueError, match="split"):
        pmesh.batch_rows(fake, 6)


def test_fold_batch_shard_key_is_held_to_the_port():
    """A split batch folds 1 + the shard index into the key, so masks
    differ per shard; an unsplit one keeps the single-device key."""
    key = DropoutKey(42, 3, 1)
    one = _FakeMesh(MeshConfig(), {})
    assert pmesh.fold_batch_shard_key(key, one) == key
    cfg = MeshConfig(data=2, fsdp=2)
    keys = [pmesh.fold_batch_shard_key(key, _FakeMesh(
        cfg, dict(zip(("pipe", "data", "fsdp", "expert", "seq", "tensor"),
                      (0, r // 2, r % 2, 0, 0, 0))))) for r in range(4)]
    assert [k.shard for k in keys] == [1, 2, 3, 4]
    from pytorch_distributed_tpu_torch.utils import prng

    masks = [prng.draw_keep_mask(prng.stream_id(k, 0, "attn"), (64,), 0.5,
                                 "cpu") for k in [key, *keys]]
    for i in range(5):
        for j in range(i):
            assert not torch.equal(masks[i], masks[j])
    assert prng.stream_seed(prng.stream_id(key, 0, "attn")) == \
        prng.stream_seed(prng.StreamId(42, 3, 1, 0, "attn"))


def test_shard_slices_tile_the_leaf_and_gather_back():
    """shard_train_state's slices over the fsdp ranks tile each leaf, and
    the element counts are the leaf's over fsdp (or all of it)."""
    cfg = ModelConfig(**MODEL_KW)
    params = interop.params_from_jax(jax.device_get(jget_model(
        JaxModelConfig(**MODEL_KW)).init(jax.random.key(0),
                                         JaxModelConfig(**MODEL_KW))), cfg)
    state = init_train_state(params, make_optimizer(TrainConfig()))
    mcfg = MeshConfig(fsdp=2, strategy="full_shard")
    parts = []
    for f in range(2):
        mesh = _FakeMesh(mcfg, dict(pipe=0, data=0, fsdp=f, expert=0, seq=0,
                                    tensor=0))
        parts.append(sharding.shard_train_state(state, mesh))
    from pytorch_distributed_tpu_torch.utils import tree

    specs = tree.leaves(parts[0][1].params)
    for i, (full, spec) in enumerate(zip(tree.leaves(params), specs)):
        dim = sharding.shard_dim(spec)
        pieces = [tree.leaves(p[0].params)[i] for p in parts]
        if dim is None:
            assert all(torch.equal(x, full) for x in pieces)
        else:
            assert torch.equal(torch.cat(pieces, dim), full)
    sharded = [s for s in specs if sharding.shard_dim(s) is not None]
    assert 0 < len(sharded) < len(specs)
