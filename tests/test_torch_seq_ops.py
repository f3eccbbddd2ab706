"""The port's ring and Ulysses attention ops against the JAX package's.

One group of four gloo CPU ranks (``_torch_seq_jobs.job_seq_ops``) runs
every case; the JAX side runs in this process meanwhile, under the
8-device CPU fixture, as ``tests/test_ring_attention.py`` runs it. Same
seeded numpy inputs on both sides, f32.

- ``ring_attention`` and ``ulysses_attention`` against JAX's under
  ``shard_map`` at 2 and 4 ranks, causal and not, GQA: forward within
  1e-5, gradients of sum(out^2) within 1e-4 (the tolerances of
  ``tests/test_ring_attention.py`` and ``tests/test_ulysses.py``). The
  port's Ulysses runs its local attention through the flash kernels'
  plain versions; JAX's through its naive attention (the same math).
- The counts a call shows: n - 1 ring exchanges forward and as many
  back; four all-to-alls forward (q, k, v, the output) and four back,
  and one K1 and one K2 under Ulysses; the ring runs neither kernel.
- The refusals that need no ranks: the ring with attention dropout (as
  JAX), Ulysses with a seq size that does not divide a rank's heads, an
  unknown ``seq_impl``; the seq index folded into the dropout key.
- The ``train.parallel`` twin trains at seq 2 with Ulysses on two CPU
  ranks it starts itself.
"""

import functools
import json
import os
import subprocess
import sys
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, PartitionSpec as P

from _torch_dist_worker import launch
from test_torch_serving_tp import read_outputs
from test_torch_seq import MODELS, TRAIN, _init_model
from pytorch_distributed_tpu.config import MeshConfig as JaxMeshConfig
from pytorch_distributed_tpu.config import ModelConfig as JaxModelConfig
from pytorch_distributed_tpu.config import TrainConfig as JaxTrainConfig
from pytorch_distributed_tpu.models import get_model as jget_model
from pytorch_distributed_tpu.ops.ring_attention import (
    ring_attention as jring,
)
from pytorch_distributed_tpu.ops.ulysses import (
    ulysses_attention as julysses,
)
from pytorch_distributed_tpu.parallel import make_mesh, shard_train_state
from pytorch_distributed_tpu.parallel.explicit import (
    make_explicit_train_step,
)
from pytorch_distributed_tpu.train.optim import make_optimizer as jmake_opt
from pytorch_distributed_tpu.train.state import init_train_state as jinit
from pytorch_distributed_tpu.utils.compat import shard_map
from pytorch_distributed_tpu_torch.config import (
    MeshConfig,
    ModelConfig,
    TrainConfig,
)
from pytorch_distributed_tpu_torch.models import get_model
from pytorch_distributed_tpu_torch.ops.attention import multi_head_attention
from pytorch_distributed_tpu_torch.parallel.api import (
    make_parallel_train_step,
)
from pytorch_distributed_tpu_torch.parallel.mesh import fold_batch_shard_key
from pytorch_distributed_tpu_torch.train.optim import make_optimizer
from pytorch_distributed_tpu_torch.utils import prng

# (name, impl, ranks, causal, KV heads) over q [2, 32, 8, 8].
OPS = [(f"{impl}-n{n}-{'causal' if causal else 'full'}-hkv{hkv}", impl, n,
        causal, hkv)
       for impl in ("ring", "ulysses")
       for n, causal, hkv in ((2, True, 8), (2, False, 8), (2, True, 4),
                              (4, True, 8), (4, False, 4))]
OP_IDS = [c[0] for c in OPS]
OB, OT, OH, OD = 2, 32, 8, 8



def _jax_op(impl: str, n: int, causal: bool, q, k, v, devices) -> dict:
    """JAX's op under shard_map over ``n`` devices: the output and the
    gradients of sum(out^2)."""
    mesh = Mesh(np.array(devices[:n]), axis_names=("seq",))
    spec = P(None, "seq", None, None)
    op = (functools.partial(jring, axis_name="seq", causal=causal)
          if impl == "ring" else
          functools.partial(julysses, axis_name="seq", causal=causal))
    fn = jax.jit(shard_map(op, mesh=mesh, in_specs=(spec,) * 3,
                               out_specs=spec))

    def loss(q, k, v):
        o = fn(q, k, v)
        return jnp.sum(jnp.square(o)), o

    with jax.default_matmul_precision("highest"):
        (_, o), grads = jax.value_and_grad(loss, argnums=(0, 1, 2),
                                           has_aux=True)(q, k, v)
    return dict(o=np.asarray(o), dq=np.asarray(grads[0]),
                dk=np.asarray(grads[1]), dv=np.asarray(grads[2]))


@pytest.fixture(scope="module")
def runs(tmp_path_factory, eight_devices):
    """Write the inputs, start the port's ranks, run JAX meanwhile."""
    wd = tmp_path_factory.mktemp("seq_ops")
    rng = np.random.default_rng(0)
    ops = {}
    for name, _, _, _, hkv in OPS:
        ops[f"{name}_q"] = rng.standard_normal((OB, OT, OH, OD))
        ops[f"{name}_k"] = rng.standard_normal((OB, OT, hkv, OD))
        ops[f"{name}_v"] = rng.standard_normal((OB, OT, hkv, OD))
    ops = {k: v.astype(np.float32) for k, v in ops.items()}
    np.savez(wd / "ops.npz", **ops)
    (wd / "spec.json").write_text(json.dumps(dict(
        ops=[dict(name=n, impl=i, group="a" if r == 2 else "world",
                  causal=c) for n, i, r, c, _ in OPS])))
    box: dict = {}
    th = threading.Thread(target=lambda: box.update(
        results=launch("seq_ops", 4, wd, timeout_s=300)))
    th.start()
    with ThreadPoolExecutor(4) as ex:  # JAX compiles in parallel
        want = dict(zip(OP_IDS, ex.map(
            lambda c: _jax_op(c[1], c[2], c[3], ops[f"{c[0]}_q"],
                              ops[f"{c[0]}_k"], ops[f"{c[0]}_v"],
                              eight_devices), OPS)))
    th.join()
    assert "results" in box, "the port's ranks did not finish"
    return wd, want, read_outputs(wd, box["results"], n=4)


@pytest.mark.parametrize("case", OPS, ids=OP_IDS)
def test_seq_attention_matches_jax(runs, case):
    wd, want_ops, outs = runs
    name, _, n, _, _ = case
    w = want_ops[name]
    tl = OT // n
    for r in range(n):
        i = outs[r]["ops"][name]["index"]
        with np.load(wd / f"op_{name}_{r}.npz") as f:
            sl = slice(i * tl, (i + 1) * tl)
            np.testing.assert_allclose(f["o"], w["o"][:, sl], atol=1e-5)
            for g in ("dq", "dk", "dv"):
                np.testing.assert_allclose(f[g], w[g][:, sl], atol=1e-4,
                                           err_msg=g)


@pytest.mark.parametrize("case", OPS, ids=OP_IDS)
def test_seq_attention_counts(runs, case):
    """A ring call pays n - 1 exchanges forward and n - 1 back; a Ulysses
    call four all-to-alls forward (q, k, v, out) and four back, and one
    K1 and one K2 (their plain versions here)."""
    _, _, outs = runs
    name, impl, n, _, _ = case
    for r in range(n):
        c = {k: v for k, v in outs[r]["ops"][name].items() if k != "index"}
        if impl == "ring":
            assert c == dict(exchanges=2 * (n - 1), all_to_alls=0, k1=0,
                             k2=0)
        else:
            assert c == dict(exchanges=0, all_to_alls=8, k1=1, k2=1)


def test_ring_attention_dropout_is_refused_as_in_jax():
    kw = dict(MODELS["gpt2"], attn_pdrop=0.1)
    mcfg = MeshConfig(seq=2, strategy="no_shard")
    cfg = ModelConfig(**kw)
    with pytest.raises(NotImplementedError, match="ring-attention"):
        make_parallel_train_step(get_model(cfg), cfg,
                                 make_optimizer(TrainConfig(**TRAIN)), None,
                                 mcfg, None)
    jcfg = JaxModelConfig(**{k: v for k, v in kw.items()
                             if k not in ("attention_impl", "remat")})
    jm = JaxMeshConfig(seq=2, strategy="no_shard")
    mesh = make_mesh(jm)
    tx = jmake_opt(JaxTrainConfig(**TRAIN), with_clip=False)
    state, _ = shard_train_state(jinit(_init_model("gpt2"), tx), mesh, jm)
    with pytest.raises(NotImplementedError, match="ring-attention"):
        make_explicit_train_step(jget_model(jcfg), jcfg, tx, mesh, jm, state)
    # Ulysses takes attention dropout (past the refusal, at the mesh)
    ucfg = ModelConfig(**dict(kw, seq_impl="ulysses"))
    with pytest.raises(AttributeError):
        make_parallel_train_step(get_model(ucfg), ucfg,
                                 make_optimizer(TrainConfig(**TRAIN)), None,
                                 mcfg, None)


@pytest.mark.parametrize("mesh_kw", [dict(seq=4), dict(seq=2, tensor=2)],
                         ids=["seq4", "seq2xtensor2"])
def test_ulysses_needs_seq_to_divide_a_ranks_heads(mesh_kw):
    """Llama at 8 query over 2 KV heads: seq 4 does not divide the 2 KV
    heads; under tensor 2 a rank holds 4 over 1, which seq 2 does not
    divide. Refused when the step is built."""
    cfg = ModelConfig(**dict(MODELS["llama"], n_kv_head=2))
    mcfg = MeshConfig(**mesh_kw, strategy="no_shard")
    with pytest.raises(ValueError, match="divide both head counts"):
        make_parallel_train_step(get_model(cfg), cfg,
                                 make_optimizer(TrainConfig(**TRAIN)), None,
                                 mcfg, None)


def test_unknown_seq_impl_raises_key_error():
    x = np.zeros((1, 2, 1, 8), np.float32)
    import torch

    t = torch.from_numpy(x)
    with pytest.raises(KeyError, match="seq_impl"):
        multi_head_attention(t, t, t, seq_group=object(), seq_impl="zigzag")


class _SeqMesh:
    def __init__(self, cfg, coords):
        self.cfg, self.coords = cfg, coords

    def axis_size(self, ax):
        return getattr(self.cfg, ax)


def test_seq_index_is_folded_into_the_dropout_key():
    key = prng.DropoutKey(1, 2, 0)
    cfg = MeshConfig(data=2, seq=2, strategy="no_shard")
    shards = {fold_batch_shard_key(key, _SeqMesh(cfg, dict(
        data=d, fsdp=0, expert=0, seq=s, tensor=0))).shard
        for d in range(2) for s in range(2)}
    assert shards == {1, 2, 3, 4}
    one = MeshConfig(strategy="no_shard")
    assert fold_batch_shard_key(key, _SeqMesh(one, {})) == key
    # Ulysses' own fold of the seq index reaches the attention stream only
    sid = prng.stream_id(key, 0, "attn")
    assert prng.stream_seed(sid) != prng.stream_seed(sid._replace(seq=1))


def test_parallel_twin_trains_at_seq2_ulysses_on_cpu_ranks(tmp_path):
    root = Path(__file__).resolve().parents[1]
    proc = subprocess.run(
        [sys.executable, "-m", "pytorch_distributed_tpu_torch.train.parallel",
         "--cpu-devices", "2", "--mesh", "seq=2", "--seq-impl", "ulysses",
         "--strategy", "no_shard", "--preset", "tiny", "--seq-len", "32",
         "--global-batch-size", "4", "--micro-batch-size", "2",
         "--steps", "2", "--log-every", "1", "--no-dropout",
         "--no-profiler", "--num-train-files", "2",
         "--data-dir", str(tmp_path / "data"),
         "--checkpoint-dir", str(tmp_path / "ckpt")],
        cwd=tmp_path, capture_output=True, text=True, timeout=240,
        env=dict(os.environ, PYTHONPATH=str(root), OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = proc.stdout + proc.stderr
    assert "'seq': 2, 'tensor': 1}" in out, out[-3000:]
    assert "done:" in out, out[-3000:]
