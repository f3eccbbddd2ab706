"""The port's multi-rank checkpoint on two gloo CPU ranks (the counterpart
of ``tests/test_checkpoint_sharded.py`` for the JAX package).

GPT-2 (no dropout) under full_shard over fsdp 2
(``_torch_dist_worker.job_ckpt``): two steps, a save in each format
(``orbax``: the port's sharded format, each rank writing its shards; and
``npz`` gathered to rank 0), one more step; each save restored into a
fresh sharded state of other values continues bit-identically, and the
sharded save restores onto no_shard too. The two-rank npz save loads in
the JAX package. A rank killed after the shard writes, at the commit,
leaves that step's directory uncommitted and the one before it the
newest (``job_ckpt_kill``). The JAX package's tensorstore directories
are refused by name.
"""

import json
import threading

import jax
import numpy as np
import pytest

from _torch_dist_worker import launch
from pytorch_distributed_tpu.config import ModelConfig as JaxModelConfig
from pytorch_distributed_tpu.config import TrainConfig as JaxTrainConfig
from pytorch_distributed_tpu.models import get_model as jget_model
from pytorch_distributed_tpu.train import checkpoint as jckpt
from pytorch_distributed_tpu.train.optim import make_optimizer as jmake_opt
from pytorch_distributed_tpu.train.state import init_train_state as jinit
from pytorch_distributed_tpu_torch.config import ModelConfig, TrainConfig
from pytorch_distributed_tpu_torch.models import get_model
from pytorch_distributed_tpu_torch.train import checkpoint as ckpt
from pytorch_distributed_tpu_torch.train.checkpoint import _flatten
from pytorch_distributed_tpu_torch.train.optim import make_optimizer
from pytorch_distributed_tpu_torch.train.state import init_train_state
from pytorch_distributed_tpu_torch.utils import tree

MODEL = dict(vocab_size=97, n_ctx=32, n_embd=32, n_layer=2, n_head=4,
             dtype="float32", attention_impl="flash", remat="names",
             embd_pdrop=0.0, attn_pdrop=0.0, resid_pdrop=0.0)
TRAIN = dict(global_batch_size=4, micro_batch_size=2, num_steps=3,
             learning_rate=1e-3, grad_clip_norm=1.0)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    workdir = tmp_path_factory.mktemp("ckpt")
    kill = tmp_path_factory.mktemp("ckpt_kill")
    cfg = JaxModelConfig(**MODEL)
    for name, seed in (("params.npz", 0), ("other.npz", 1)):
        flat: dict = {}
        _flatten("params", jax.device_get(
            jget_model(cfg).init(jax.random.key(seed), cfg)), flat)
        for d in (workdir, kill):
            np.savez(d / name, **flat)
    rng = np.random.default_rng(2)
    np.savez(workdir / "batches.npz", **{
        f"{k}_{i}": rng.integers(0, 97, (1, 4, 16))
        for i in range(3) for k in ("inputs", "targets")})
    for d in (workdir, kill):
        (d / "spec.json").write_text(json.dumps(dict(model=MODEL,
                                                     train=TRAIN)))
    out: dict = {}
    jobs = [threading.Thread(target=lambda: out.update(
                ckpt=launch("ckpt", 2, workdir))),
            threading.Thread(target=lambda: out.update(
                kill=launch("ckpt_kill", 2, kill, expect_fail=True)))]
    for j in jobs:
        j.start()
    for j in jobs:
        j.join()
    assert set(out) == {"ckpt", "kill"}, "a job did not finish"
    got = [json.loads((workdir / f"ckpt_{r}.json").read_text())
           for r in range(2)]
    return workdir, got, kill, out["kill"]


@pytest.mark.parametrize("fmt", ["orbax", "npz"])
def test_full_shard_save_restore_continues_bit_identically(runs, fmt):
    _, got, _, _ = runs
    for r in range(2):
        assert got[r][f"{fmt}_step"] == 2
        assert got[r][fmt]["hist"] == got[r]["ref"]["hist"]
        assert got[r][fmt]["digest"] == got[r]["ref"]["digest"]
    assert got[0]["ref"]["digest"] != got[1]["ref"]["digest"]  # shards


def test_sharded_save_restores_onto_another_layout(runs):
    """The fsdp-2 save restored onto no_shard (whole leaves on each rank)
    continues with the same losses to f32 round-off."""
    _, got, _, _ = runs
    for r in range(2):
        np.testing.assert_allclose(got[r]["onto_no_shard"]["hist"],
                                   got[r]["ref"]["hist"], rtol=1e-6)


def test_sharded_directory_layout(runs):
    """Each rank wrote its shards; index.json has every leaf's global
    shape and shard dim; each rank holds half of the sharded leaves."""
    workdir, got, _, _ = runs
    d = workdir / "orbax"
    assert ckpt.is_committed(d)
    ckpt.verify_checkpoint(d)
    index = json.loads((d / "tree" / "index.json").read_text())
    assert index["shards"] == 2
    assert sorted(p.name for p in (d / "tree").iterdir()) == [
        "index.json", "shard_0.npz", "shard_1.npz"]
    cfg = ModelConfig(**MODEL)
    params = get_model(cfg).init(__import__("torch").Generator()
                                 .manual_seed(0), cfg, device="cpu")
    leaves = dict(tree.leaves_with_path(params))
    total = sum(t.numel() for t in leaves.values())
    for path, t in leaves.items():
        entry = index["leaves"]["/".join(map(str, ("params", *path)))]
        assert tuple(entry["shape"]) == tuple(t.shape)
    assert index["leaves"]["step"]["dim"] is None
    sharded = [e for e in index["leaves"].values() if e["dim"] is not None]
    assert sharded
    assert got[0]["local_numel"] == got[1]["local_numel"]
    assert got[0]["local_numel"]["params"] < total
    meta = ckpt.read_metadata(d)
    assert meta == {"step": 2}


def test_two_rank_npz_loads_in_the_jax_package(runs):
    workdir, _, _, _ = runs
    cfg = JaxModelConfig(**MODEL)
    like = jinit(jget_model(cfg).init(jax.random.key(5), cfg),
                 jmake_opt(JaxTrainConfig(**TRAIN)))
    restored = jckpt.load_checkpoint(workdir / "npz", like)
    assert int(restored.step) == 2
    flat: dict = {}
    _flatten("params", jax.device_get(restored.params), flat)
    with np.load(workdir / "ckpt_params.npz") as want:
        assert sorted(want.files) == sorted(flat)
        for k in want.files:
            np.testing.assert_array_equal(flat[k], want[k])


def test_kill_at_the_commit_leaves_the_step_uncommitted(runs):
    _, _, kill, rcs = runs
    assert rcs[0][0] == 43  # killed in the pre-commit hook
    assert rcs[1][0] != 0  # its peer's barrier failed
    root = kill / "kill"
    assert ckpt.latest_checkpoint(root) == str(root / "checkpoint_step_1")
    assert not ckpt.is_committed(root / "checkpoint_step_2")
    assert ckpt.uncommitted_checkpoints(root) == []
    tmp = root / ".tmp_checkpoint_step_2" / "tree"
    assert (tmp / "shard_0.npz").is_file() and (tmp / "shard_1.npz").is_file()
    ckpt.verify_checkpoint(root / "checkpoint_step_1")
    ckpt.prune_checkpoints(root, 1)  # sweeps the orphaned temp dir
    assert not (root / ".tmp_checkpoint_step_2").exists()


def test_one_rank_orbax_round_trip_and_jax_tensorstore_refused(tmp_path):
    """Without a process group the sharded format is one rank's whole
    state; a directory of JAX's tensorstore format is refused by name."""
    cfg = ModelConfig(**MODEL)
    tx = make_optimizer(TrainConfig(**TRAIN))
    import torch

    state = init_train_state(get_model(cfg).init(
        torch.Generator().manual_seed(0), cfg, device="cpu"), tx)
    path = ckpt.save_checkpoint(tmp_path / "o", state, cfg, format="orbax")
    back = ckpt.load_checkpoint(path, init_train_state(get_model(cfg).init(
        torch.Generator().manual_seed(1), cfg, device="cpu"), tx), cfg)
    for a, b in zip(tree.leaves([back.params, back.opt_state["mu"]]),
                    tree.leaves([state.params, state.opt_state["mu"]])):
        assert torch.equal(a, b)
    (tmp_path / "j" / "tree").mkdir(parents=True)
    with pytest.raises(NotImplementedError, match=r"item 7\(a\)"):
        ckpt.verify_checkpoint(tmp_path / "j")
    with pytest.raises(NotImplementedError, match="tensorstore"):
        ckpt.load_checkpoint(tmp_path / "j", state, cfg)
