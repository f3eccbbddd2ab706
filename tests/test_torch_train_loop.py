"""The port's training loop against the JAX package's, on the CPU in f32.

GPT-2 at vocab 301, n_ctx 32, n_embd 32, 2 layers, 2 heads; the same
weights on both sides (the JAX ``init``, converted by ``interop``), the same
seeded batches or the same synthetic shards; JAX matmuls at "highest"
precision. Tolerances are the ones ``tests/test_torch_train.py`` holds
the deterministic step to: loss and grad_norm within rtol 1e-5, params
within atol 1e-5 / rtol 1e-4 (Adam turns summation-order noise in a
gradient near zero into an update difference of order lr). With dropout
the port's masks come through the seam of ``tests/test_torch_dropout.py``
(JAX's mask for each stream id).

- ``make_train_step`` with dropout and A = 2, three steps;
- ``make_eval_step``, fused and unfused, [B, T] and [A, B, T];
- ``Trainer.train`` on synthetic shards (dropout off) against the JAX
  ``Trainer``: per-window losses and the ``history`` entries' keys;
- checkpoints: one the JAX ``Trainer`` writes is resumed by the port's and
  the reverse, both continuing to the uninterrupted run's losses, with the
  same keys, shapes and dtypes in both manifests; a corrupt newest
  checkpoint falls back to the older one; pruning; the loader position
  riding the checkpoint; ``metrics_path``; the save on SIGTERM;
- the entry point ``python -m pytorch_distributed_tpu_torch.train.baseline``
  on the CPU, and the flags it refuses.
"""

import json
import os
import shutil
import signal
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_dropout import jax_mask

from pytorch_distributed_tpu.config import ModelConfig as JaxModelConfig
from pytorch_distributed_tpu.config import TrainConfig as JaxTrainConfig
from pytorch_distributed_tpu.data import TokenShardLoader as JaxLoader
from pytorch_distributed_tpu.models import get_model as jget_model
from pytorch_distributed_tpu.train import optim as joptim
from pytorch_distributed_tpu.train.state import init_train_state as jinit
from pytorch_distributed_tpu.train.trainer import Trainer as JaxTrainer
from pytorch_distributed_tpu.train.trainer import make_eval_step as jeval
from pytorch_distributed_tpu.train.trainer import make_train_step as jstep
from pytorch_distributed_tpu.utils.prng import domain_key, step_key
from pytorch_distributed_tpu_torch import interop
from pytorch_distributed_tpu_torch.config import (
    ModelConfig,
    TrainConfig,
    model_config,
)
from pytorch_distributed_tpu_torch.data import (
    TokenShardLoader,
    make_synthetic_shards,
)
from pytorch_distributed_tpu_torch.models import get_model
from pytorch_distributed_tpu_torch.train import baseline
from pytorch_distributed_tpu_torch.train import checkpoint as ckpt
from pytorch_distributed_tpu_torch.train import optim
from pytorch_distributed_tpu_torch.train.state import init_train_state
from pytorch_distributed_tpu_torch.train.trainer import (
    Trainer,
    make_eval_step,
    make_train_step,
)
from pytorch_distributed_tpu_torch.utils import prng

CFG_KW = dict(vocab_size=301, n_ctx=32, n_embd=32, n_layer=2, n_head=2,
              dtype="float32", attention_impl="flash", remat="dots")
NO_DROP = dict(embd_pdrop=0.0, attn_pdrop=0.0, resid_pdrop=0.0)
SEED = 11
B, T = 2, 16


def _cfgs(**kw):
    kw = dict(CFG_KW, **kw)
    return JaxModelConfig(**kw), ModelConfig(**kw)


def _jax_params(jcfg, seed=0):
    return jget_model(jcfg).init(jax.random.key(seed), jcfg)


def _assert_params_close(port_params, jax_params, cfg):
    got = interop.params_to_jax(port_params, cfg)
    for (path, a), (_, b) in zip(
            jax.tree_util.tree_leaves_with_path(got),
            jax.tree_util.tree_leaves_with_path(jax.device_get(jax_params))):
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=1e-4,
                                   err_msg=str(path))


def test_three_steps_with_dropout_and_accumulation_match_jax(monkeypatch):
    monkeypatch.setattr(prng, "draw_keep_mask", jax_mask)
    jcfg, cfg = _cfgs()
    tkw = dict(learning_rate=1e-3, num_steps=3, grad_clip_norm=1.0)
    jtx = joptim.make_optimizer(JaxTrainConfig(**tkw))
    tx = optim.make_optimizer(TrainConfig(**tkw))
    jparams = _jax_params(jcfg)
    jstate = jinit(jparams, jtx)
    state = init_train_state(
        interop.params_from_jax(jax.device_get(jparams), cfg), tx)
    step_j = jax.jit(jstep(jget_model(jcfg), jcfg, jtx, jit=False))
    step_p = make_train_step(get_model(cfg), cfg, tx, seed=SEED)
    rng = np.random.default_rng(0)
    root = domain_key(SEED, "dropout")
    for i in range(3):
        batch = {k: rng.integers(0, 301, (2, B, T)).astype(np.int32)
                 for k in ("inputs", "targets")}
        with jax.default_matmul_precision("highest"):
            jstate, jm = step_j(jstate, jax.tree.map(jnp.asarray, batch),
                                step_key(root, i))
        state, m = step_p(state, {k: torch.from_numpy(v)
                                  for k, v in batch.items()})
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-5)
    assert state.step == 3
    _assert_params_close(state.params, jstate.params, cfg)


@pytest.mark.parametrize("fused", [False, True])
def test_eval_step_matches_jax(fused):
    jcfg, cfg = _cfgs(fused_head_ce=fused)
    jparams = _jax_params(jcfg, seed=1)
    params = interop.params_from_jax(jax.device_get(jparams), cfg)
    rng = np.random.default_rng(1)
    batch = {k: rng.integers(0, 301, (2, B, T)).astype(np.int32)
             for k in ("inputs", "targets")}
    eval_j, eval_p = jeval(jget_model(jcfg), jcfg), make_eval_step(
        get_model(cfg), cfg)
    for b in (batch, {k: v[0] for k, v in batch.items()}):
        with jax.default_matmul_precision("highest"):
            want = float(eval_j(jparams, jax.tree.map(jnp.asarray, b)))
        got = eval_p(params, {k: torch.from_numpy(v) for k, v in b.items()})
        assert not got.requires_grad
        np.testing.assert_allclose(float(got), want, rtol=1e-5)


def _shard_paths(tmp_path):
    return make_synthetic_shards(tmp_path / "data", num_shards=2,
                                 tokens_per_shard=2000, vocab_size=301,
                                 seed=3)


def _train_kw(ckdir, **kw):
    return dict(dict(global_batch_size=4, micro_batch_size=2, num_steps=4,
                     learning_rate=1e-3, log_every_n_steps=1,
                     checkpoint_dir=str(ckdir), seed=SEED), **kw)


def _jax_trainer(tmp_path, ckdir, **kw):
    jcfg, _ = _cfgs(**NO_DROP)
    return JaxTrainer(jget_model(jcfg), jcfg,
                      JaxTrainConfig(**_train_kw(ckdir, **kw)),
                      log_fn=lambda s: None)


def _port_trainer(ckdir, logs=None, **kw):
    _, cfg = _cfgs(**NO_DROP)
    return Trainer(get_model(cfg), cfg, TrainConfig(**_train_kw(ckdir, **kw)),
                   device="cpu",
                   log_fn=(logs.append if logs is not None
                           else lambda s: None))


def _port_state(trainer, jparams):
    params = interop.params_from_jax(jax.device_get(jparams),
                                     trainer.model_cfg)
    return init_train_state(params, trainer.tx)


def test_trainer_matches_jax_trainer(tmp_path):
    paths = _shard_paths(tmp_path)
    jt = _jax_trainer(tmp_path, tmp_path / "jck", log_every_n_steps=2)
    jstate = jt.init_state()
    pt = _port_trainer(tmp_path / "pck", log_every_n_steps=2)
    start = _port_state(pt, jstate.params)  # the JAX step donates them
    with jax.default_matmul_precision("highest"):
        _, jhist = jt.train(JaxLoader(paths, B, T), state=jstate)
    state, hist = pt.train(TokenShardLoader(paths, B, T), state=start)
    assert [list(h) for h in hist] == [list(h) for h in jhist]
    assert [h["step"] for h in hist] == [2, 4] and state.step == 4
    for h, jh in zip(hist, jhist):
        np.testing.assert_allclose(h["lr"], jh["lr"], rtol=1e-12)
        np.testing.assert_allclose(h["loss"], jh["loss"], rtol=1e-5)


def _drop_newest(ckdir):
    """Park the newest checkpoint outside the run's view: the state of a
    run that died after the older save."""
    newest = ckpt.latest_checkpoint(ckdir)
    shutil.move(newest, str(Path(ckdir).parent / "parked"))


def test_checkpoints_cross_between_the_packages(tmp_path):
    """JAX writes, the port resumes; the port writes, JAX resumes: both
    continue (steps 3-4) to the uninterrupted run's losses."""
    paths = _shard_paths(tmp_path)
    # The JAX run, uninterrupted, saving at steps 2 and 4.
    jt = _jax_trainer(tmp_path, tmp_path / "jck", save_every_n_steps=2)
    jstate0 = jt.init_state()
    pt = _port_trainer(tmp_path / "pck", save_every_n_steps=2)
    start = _port_state(pt, jstate0.params)  # the JAX step donates them
    with jax.default_matmul_precision("highest"):
        _, jhist = jt.train(JaxLoader(paths, B, T), state=jstate0)
    # The port run from the same weights, uninterrupted, saving too.
    _, phist = pt.train(TokenShardLoader(paths, B, T), state=start)
    jman, pman = (json.loads(Path(ckpt.latest_checkpoint(d), "manifest.json")
                             .read_text())["leaves"]
                  for d in (tmp_path / "jck", tmp_path / "pck"))
    assert {k: (v["shape"], v["dtype"]) for k, v in pman.items()} == \
        {k: (v["shape"], v["dtype"]) for k, v in jman.items()}
    assert list(pman) == list(jman)
    # The port resumes the JAX run's step-2 checkpoint.
    _drop_newest(tmp_path / "jck")
    loader = TokenShardLoader(paths, B, T)
    pt2 = _port_trainer(tmp_path / "jck")
    state = pt2.resume_latest(pt2.init_state(), loader=loader)
    assert state.step == 2 and state.opt_state["count"] == 2
    assert loader._pending_state == (1, 8 * T)
    _, hist = pt2.train(loader, state=state)
    np.testing.assert_allclose([h["loss"] for h in hist],
                               [h["loss"] for h in jhist[2:]], rtol=1e-5)
    # JAX resumes the port run's step-2 checkpoint.
    _drop_newest(tmp_path / "pck")
    (tmp_path / "parked").rename(tmp_path / "parked_jax")
    jt2 = _jax_trainer(tmp_path, tmp_path / "pck")
    jloader = JaxLoader(paths, B, T)
    jstate = jt2.resume_latest(jt2.init_state(), loader=jloader)
    assert int(jstate.step) == 2
    with jax.default_matmul_precision("highest"):
        _, jhist2 = jt2.train(jloader, state=jstate)
    np.testing.assert_allclose([h["loss"] for h in jhist2],
                               [h["loss"] for h in phist[2:]], rtol=1e-5)


def test_corrupt_newest_checkpoint_falls_back(tmp_path):
    paths = _shard_paths(tmp_path)
    ckdir = tmp_path / "ck"
    pt = _port_trainer(ckdir, save_every_n_steps=2)
    done, _ = pt.train(TokenShardLoader(paths, B, T))
    newest = Path(ckpt.latest_checkpoint(ckdir))
    assert newest.name == "checkpoint_step_4"
    ckpt.verify_checkpoint(newest)
    arrays = newest / "arrays.npz"
    raw = bytearray(arrays.read_bytes())
    raw[len(raw) // 2] ^= 0xFF
    arrays.write_bytes(bytes(raw))
    with pytest.raises(ckpt.CheckpointCorrupt):
        ckpt.verify_checkpoint(newest)
    logs = []
    pt2 = _port_trainer(ckdir, logs=logs)
    state = pt2.resume_latest(pt2.init_state())
    assert state.step == 2
    assert any("failed integrity verification" in s for s in logs)
    # Every checkpoint corrupt: an error, not a silent fresh start.
    older = ckdir / "checkpoint_step_2" / "meta.json"
    older.write_text(older.read_text() + " ")
    with pytest.raises(ckpt.CheckpointCorrupt, match="all 2"):
        pt2.resume_latest(pt2.init_state())
    # No COMMIT marker: never resumed; a warning and a fresh start.
    for d in ckpt.list_checkpoints(ckdir):
        (Path(d) / ckpt.COMMIT_NAME).unlink()
    logs.clear()
    fresh = pt2.init_state()
    assert pt2.resume_latest(fresh) is fresh
    assert any("without a COMMIT marker" in s for s in logs)
    assert ckpt.latest_checkpoint(ckdir) is None
    # The restore is exact.
    good = pt.save_checkpoint(done)
    again = pt.load_checkpoint(good, pt.init_state())
    for a, b in zip(optim.tree.leaves(again.params),
                    optim.tree.leaves(done.params)):
        assert torch.equal(a, b)


def test_prune_loader_position_and_metrics(tmp_path):
    paths = _shard_paths(tmp_path)
    ckdir = tmp_path / "ck"
    (ckdir / ".trash_checkpoint_step_0").mkdir(parents=True)
    (ckdir / ".ckpt_tmp_orphan").mkdir()
    metrics = tmp_path / "m" / "metrics.jsonl"
    pt = _port_trainer(ckdir, save_every_n_steps=1, keep_checkpoints=2,
                       metrics_path=str(metrics), log_every_n_steps=2)
    loader = TokenShardLoader(paths, B, T)
    _, hist = pt.train(loader)
    assert sorted(p.name for p in ckdir.iterdir()) == [
        "checkpoint_step_3", "checkpoint_step_4"]
    meta = ckpt.read_metadata(ckdir / "checkpoint_step_4")
    assert meta == {"step": 4, "loader_state": loader.state_dict()}
    assert meta["loader_state"] == {"shard_idx": 1, "position": 16 * T}
    lines = [json.loads(x) for x in metrics.read_text().splitlines()]
    assert lines == hist and [x["step"] for x in lines] == [2, 4]
    assert ckpt.prune_checkpoints(ckdir, 1) == [
        str(ckdir / "checkpoint_step_3")]
    with pytest.raises(ValueError, match="keep"):
        ckpt.prune_checkpoints(ckdir, 0)


def test_preemption_saves_once_after_the_loop(tmp_path):
    paths = _shard_paths(tmp_path)

    class Signalling(TokenShardLoader):
        """Sends this process SIGTERM as it yields its 5th batch (the
        first micro-batch of step 3)."""

        def __iter__(self):
            for i, batch in enumerate(super().__iter__()):
                if i == 4:
                    os.kill(os.getpid(), signal.SIGTERM)
                yield batch

    logs = []
    pt = _port_trainer(tmp_path / "ck", logs=logs, save_on_preemption=True,
                       num_steps=8)
    before = signal.getsignal(signal.SIGTERM)
    loader = Signalling(paths, B, T)
    state, _ = pt.train(loader)
    assert signal.getsignal(signal.SIGTERM) is before
    assert state.step == 3  # the step in flight finished, then the loop
    assert [Path(p).name for p in ckpt.list_checkpoints(tmp_path / "ck")] \
        == ["checkpoint_step_3"]
    assert ckpt.read_metadata(tmp_path / "ck" / "checkpoint_step_3")[
        "loader_state"] == loader.state_dict()
    assert any("preemption signal received" in s for s in logs)


@pytest.mark.parametrize("kw", [
    dict(), dict(remat="dots_no_batch"), dict(remat="flash"),
    dict(fused_head_ce=True), dict(attention_impl="flash", remat="flash"),
])
def test_gpt2_preset_defaults_train_through_the_trainer(tmp_path, kw):
    """``model_config("gpt2")``'s own knobs (remat "dots", every *_pdrop
    0.1, naive attention), at a tiny width, and the other modes: the loss
    falls over 6 steps on the learnable synthetic stream."""
    cfg = model_config("gpt2", vocab_size=301, n_ctx=32, n_embd=32,
                       n_layer=2, n_head=2, dtype="float32", **kw)
    assert (cfg.embd_pdrop, cfg.attn_pdrop, cfg.resid_pdrop) == (0.1,) * 3
    tc = TrainConfig(**_train_kw(tmp_path / "ck", num_steps=6,
                                 log_every_n_steps=3, learning_rate=3e-3))
    trainer = Trainer(get_model(cfg), cfg, tc, device="cpu",
                      log_fn=lambda s: None)
    _, hist = trainer.train(TokenShardLoader(_shard_paths(tmp_path), B, T))
    assert hist[-1]["loss"] < hist[0]["loss"]


def test_refusals():
    _, cfg = _cfgs()
    model = get_model(cfg)
    for kw, match in ((dict(anomaly_guard=True), "guard"),
                      (dict(async_checkpoint=True), "async")):
        with pytest.raises(NotImplementedError, match=match):
            Trainer(model, cfg, TrainConfig(**kw), device="cpu")
    trainer = Trainer(model, cfg, TrainConfig(), device="cpu")
    with pytest.raises(NotImplementedError, match="item 6"):
        trainer.train([], profiler=object())
    with pytest.raises(NotImplementedError, match="chaos"):
        trainer.set_fault_injector(object())
    with pytest.raises(NotImplementedError, match="orbax"):
        ckpt.save_checkpoint("x", trainer.init_state(), cfg, format="orbax")
    with pytest.raises(NotImplementedError, match="async"):
        ckpt.save_checkpoint_async("x")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            Trainer(model, cfg, TrainConfig())


def test_baseline_entry_point_on_the_cpu(tmp_path, capsys):
    args = ["--device", "cpu", "--preset", "tiny", "--seq-len", "32",
            "--global-batch-size", "4", "--micro-batch-size", "2",
            "--steps", "3", "--log-every", "1", "--eval-batches", "1",
            "--num-train-files", "2", "--data-dir", str(tmp_path / "data"),
            "--checkpoint-dir", str(tmp_path / "ck"), "--save-every", "3",
            "--metrics-out", str(tmp_path / "m.jsonl")]
    assert baseline.main(args) == 0
    lines = (tmp_path / "m.jsonl").read_text().splitlines()
    assert [json.loads(x)["step"] for x in lines] == [1, 2, 3]
    assert ckpt.latest_checkpoint(tmp_path / "ck").endswith("step_3")
    # --resume continues from the checkpoint: nothing left to train.
    assert baseline.main(args + ["--resume", "--eval-batches", "0"]) == 0
    assert len((tmp_path / "m.jsonl").read_text().splitlines()) == 3
    parsed = baseline.parse_args([])
    cfg, tc = baseline.build_model_cfg(parsed), baseline.build_train_cfg(
        parsed)
    assert (parsed.preset, parsed.device, cfg.attention_impl, cfg.remat) == \
        ("gpt2-large", "cuda", "flash", "names")
    assert (tc.global_batch_size, tc.micro_batch_size, tc.num_steps,
            tc.learning_rate, tc.weight_decay) == (32, 8, 20, 3e-4, 0.1)
    assert cfg.attn_pdrop == cfg.resid_pdrop == cfg.embd_pdrop == 0.1


@pytest.mark.parametrize("flag, reason", [
    (["--data", "fineweb"], "downloads"),
    (["--async-checkpoint"], "async"),
    (["--anomaly-guard"], "guard"),
    (["--cpu-devices", "8"], "mesh"),
    (["--debug-nans"], "debug_nans"),
    (["--trace-dir", "t"], "profiler"),
])
def test_baseline_refuses_what_the_port_lacks(flag, reason):
    with pytest.raises(SystemExit, match=reason):
        baseline.parse_args(flag)
