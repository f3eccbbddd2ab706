"""The port's training loop under faults (``train/chaos``, the guard's
rollback, checkpoint integrity, the async save, the supervisor twin),
the counterparts of the JAX package's ``tests/test_train_chaos.py``, on
the CPU.

The port's own runs use GPT-2 at vocab 101, n_ctx 16, n_embd 32, 2
layers, 4 heads, f32, dropout 0.1 (the step-keyed masks are part of every
bit-identity claim). The cross-package cases turn dropout off (the two
packages draw different random streams, ROADMAP) and start both Trainers
from the JAX ``init`` converted by ``interop``, with JAX matmuls at
"highest": the same scripted faults on the same shards give equal
counters (step, rollbacks, anomalies, the history's steps), window
losses within rtol 1e-5, and final params within atol 1e-5 / rtol 1e-4
(``tests/test_torch_train_loop.py``'s bound) on all but one in a thousand
elements and within 2 lr everywhere. That is ``chip_smoke.py``'s
train_parity rule: Adam's update is about lr * sign(g), so where a
gradient is near zero, f32 summation order alone can move one element by
up to 2 lr — these runs without any fault or guard already show one such
element of 3232 in wte (6.2e-5 after 4 steps). Bit-identity claims are
exact; the injectors' schedules are compared fault for fault.
"""

import json
import os
import shutil
import signal
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from pytorch_distributed_tpu.config import ModelConfig as JaxModelConfig
from pytorch_distributed_tpu.config import TrainConfig as JaxTrainConfig
from pytorch_distributed_tpu.data import TokenShardLoader as JaxLoader
from pytorch_distributed_tpu.models import get_model as jget_model
from pytorch_distributed_tpu.train import chaos as jchaos
from pytorch_distributed_tpu.train import checkpoint as jckpt
from pytorch_distributed_tpu.train.trainer import Trainer as JaxTrainer
from pytorch_distributed_tpu_torch import interop
from pytorch_distributed_tpu_torch.config import ModelConfig, TrainConfig
from pytorch_distributed_tpu_torch.data import (
    TokenShardLoader,
    make_synthetic_shards,
)
from pytorch_distributed_tpu_torch.models import get_model
from pytorch_distributed_tpu_torch.train import chaos as pchaos
from pytorch_distributed_tpu_torch.train import checkpoint as ckpt
from pytorch_distributed_tpu_torch.train import guard as guard_lib
from pytorch_distributed_tpu_torch.train.chaos import (
    CRASH_EXIT_CODE,
    ChaosCrash,
    TrainFault,
    TrainFaultInjector,
    VirtualClock,
)
from pytorch_distributed_tpu_torch.train.state import init_train_state
from pytorch_distributed_tpu_torch.train.trainer import Trainer
from pytorch_distributed_tpu_torch.utils import chaos as shared
from pytorch_distributed_tpu_torch.utils import tree

ROOT = Path(__file__).resolve().parent.parent
MODEL_KW = dict(vocab_size=101, n_ctx=16, n_embd=32, n_layer=2, n_head=4,
                dtype="float32")
NO_DROP = dict(embd_pdrop=0.0, attn_pdrop=0.0, resid_pdrop=0.0)


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """Many tiny steps, whose cost on a loaded host is the intra-op thread
    pool's synchronisation: one thread for the module, restored after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _reset_save_hooks():
    # An injector installs a hook into its checkpoint module: never let
    # one test's schedule leak into the next.
    yield
    ckpt.set_save_hook(None)
    jckpt.set_save_hook(None)
    ckpt.finalize_async_save()


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    return make_synthetic_shards(tmp_path_factory.mktemp("chaosdata"),
                                 num_shards=2, tokens_per_shard=6000,
                                 vocab_size=101, seed=11)


def _loader(shards):
    return TokenShardLoader(shards, 4, 16)


def _tkw(**kw):
    return dict(dict(global_batch_size=8, micro_batch_size=4, num_steps=8,
                     learning_rate=1e-3, log_every_n_steps=2,
                     anomaly_guard=True, guard_rollback_after=1,
                     guard_warmup_steps=2), **kw)


def _trainer(logs=None, *, model_kw=None, **kw):
    cfg = ModelConfig(**dict(MODEL_KW, **(model_kw or {})))
    return Trainer(get_model(cfg), cfg, TrainConfig(**_tkw(**kw)),
                   device="cpu",
                   log_fn=logs.append if logs is not None else
                   (lambda s: None))


def _assert_state_bit_equal(a, b, what="state"):
    for name, ta, tb in (("params", a.params, b.params),
                         ("mu", a.opt_state["mu"], b.opt_state["mu"]),
                         ("nu", a.opt_state["nu"], b.opt_state["nu"])):
        for x, y in zip(tree.leaves(ta), tree.leaves(tb)):
            assert torch.equal(x, y), f"{what}: {name} leaves diverge"
    for k in ("count", "schedule_count"):
        assert int(a.opt_state[k]) == int(b.opt_state[k]), f"{what}: {k}"


# -- crash / resume bit-identity -------------------------------------------


@pytest.mark.parametrize("accum", [1, 2], ids=["accum1", "accum2"])
@pytest.mark.parametrize("async_ckpt", [False, True], ids=["sync", "async"])
def test_crash_resume_bit_identity(shards, tmp_path, accum, async_ckpt):
    """8 steps with a crash at step 5, then a fresh trainer resumes: final
    params, moments, counts and the last logged loss bit-equal to the
    uninterrupted run's (loader position, dropout streams and optimizer
    state all resume exactly)."""
    kw = dict(micro_batch_size=8 // accum, async_checkpoint=async_ckpt)
    ref_state, ref_hist = _trainer(**kw).train(_loader(shards))
    assert ref_state.step == 8
    ckdir = str(tmp_path / "ck")
    t1 = _trainer(save_every_n_steps=2, checkpoint_dir=ckdir, **kw)
    TrainFaultInjector([TrainFault(tick=5, kind="crash")]).install(t1)
    with pytest.raises(ChaosCrash):
        t1.train(_loader(shards))
    t2 = _trainer(save_every_n_steps=2, checkpoint_dir=ckdir, **kw)
    l2 = _loader(shards)
    state2 = t2.resume_latest(t2.init_state(), loader=l2)
    assert state2.step == 4
    state2, hist2 = t2.train(l2, state=state2)
    assert state2.step == 8
    _assert_state_bit_equal(ref_state, state2, "crash/resume")
    assert hist2[-1]["loss"] == ref_hist[-1]["loss"]
    assert hist2[-1]["anomalies"] == 0


def test_crash_resume_consumes_each_batch_once(shards, tmp_path):
    class Recording:
        def __init__(self, inner):
            self.inner, self.seen = inner, []

        def __iter__(self):
            for b in self.inner:
                self.seen.append(np.asarray(b[0]).copy())
                yield b

        def state_dict(self):
            return self.inner.state_dict()

        def load_state_dict(self, sd):
            self.inner.load_state_dict(sd)

    ref = Recording(_loader(shards))
    _trainer().train(ref)
    ckdir = str(tmp_path / "ck")
    l1 = Recording(_loader(shards))
    t1 = _trainer(save_every_n_steps=2, checkpoint_dir=ckdir)
    TrainFaultInjector([TrainFault(tick=5, kind="crash")]).install(t1)
    with pytest.raises(ChaosCrash):
        t1.train(l1)
    l2 = Recording(_loader(shards))
    t2 = _trainer(save_every_n_steps=2, checkpoint_dir=ckdir)
    state2 = t2.resume_latest(t2.init_state(), loader=l2)
    t2.train(l2, state=state2)
    # A = 2: the resumed stream continues at micro-batch 2 x step.
    for i, got in enumerate(l2.seen):
        np.testing.assert_array_equal(got, ref.seen[state2.step * 2 + i])
    assert len(l1.seen) + len(l2.seen) >= len(ref.seen)


# -- checkpoint integrity ----------------------------------------------------


def test_corrupt_checkpoint_detected_and_fallback(shards, tmp_path):
    ckdir = str(tmp_path / "ck")
    state, _ = _trainer(save_every_n_steps=2, checkpoint_dir=ckdir).train(
        _loader(shards))
    latest = ckpt.latest_checkpoint(ckdir)
    assert latest.endswith("checkpoint_step_8")
    payload = Path(latest) / "arrays.npz"
    data = bytearray(payload.read_bytes())
    data[len(data) // 2] ^= 0xFF
    payload.write_bytes(bytes(data))
    with pytest.raises(ckpt.CheckpointCorrupt):
        ckpt.verify_checkpoint(latest)
    logs = []
    t2 = _trainer(logs, save_every_n_steps=2, checkpoint_dir=ckdir)
    assert t2.resume_latest(t2.init_state()).step == 6
    assert any("failed integrity verification" in m for m in logs)
    assert any("checkpoint_step_6" in m and "resuming" in m for m in logs)
    for p in ckpt.list_checkpoints(ckdir):
        f = Path(p) / "arrays.npz"
        d = bytearray(f.read_bytes())
        for off in (len(d) // 3, len(d) // 3 + 1, 2 * len(d) // 3):
            d[off] ^= 0x55
        f.write_bytes(bytes(d))
    with pytest.raises(ckpt.CheckpointCorrupt, match="all .* failed"):
        t2.resume_latest(t2.init_state())


def test_uncommitted_checkpoint_never_picked(tmp_path):
    tr = _trainer(checkpoint_dir=str(tmp_path))
    good = ckpt.save_checkpoint(tmp_path / "checkpoint_step_2",
                                tr.init_state(), tr.model_cfg)
    half = tmp_path / "checkpoint_step_4"
    half.mkdir()
    (half / "arrays.npz").write_bytes(b"torn write")
    assert ckpt.latest_checkpoint(tmp_path).endswith("checkpoint_step_2")
    assert [Path(p).name for p in ckpt.uncommitted_checkpoints(tmp_path)] \
        == ["checkpoint_step_4"]
    with pytest.raises(ckpt.CheckpointCorrupt, match="COMMIT"):
        ckpt.verify_checkpoint(half)
    shutil.rmtree(good)
    logs = []
    t2 = _trainer(logs, checkpoint_dir=str(tmp_path))
    assert t2.resume_latest(t2.init_state()).step == 0
    assert any("without a COMMIT marker" in m for m in logs)


def test_meta_json_rot_detected(tmp_path):
    tr = _trainer(checkpoint_dir=str(tmp_path))
    state = tr.init_state()
    path = Path(ckpt.save_checkpoint(tmp_path / "checkpoint_step_2", state,
                                     tr.model_cfg))
    data = bytearray((path / "meta.json").read_bytes())
    data[len(data) // 2] ^= 0xFF
    (path / "meta.json").write_bytes(bytes(data))
    with pytest.raises(ckpt.CheckpointCorrupt, match="meta.json"):
        ckpt.verify_checkpoint(path)
    with pytest.raises(ckpt.CheckpointCorrupt, match="meta.json"):
        tr.load_checkpoint(path, state)


@pytest.mark.parametrize("async_ckpt", [False, True], ids=["sync", "async"])
def test_kill_mid_save_leaves_old_generation(shards, tmp_path, async_ckpt):
    """A crash inside the step-4 save, the instant before it commits (the
    save hook; for the async save that instant is its finalize, which the
    step-6 save runs first): the new directory never appears, the previous
    one verifies, and resume continues from it."""
    ckdir = str(tmp_path / "ck")
    tr = _trainer(save_every_n_steps=2, checkpoint_dir=ckdir,
                  async_checkpoint=async_ckpt)
    tick = 6 if async_ckpt else 4
    TrainFaultInjector([TrainFault(tick=tick, kind="crash",
                                   program="save")]).install(tr)
    with pytest.raises(ChaosCrash, match="mid-save"):
        tr.train(_loader(shards))
    latest = ckpt.latest_checkpoint(ckdir)
    assert latest is not None and latest.endswith("checkpoint_step_2")
    ckpt.verify_checkpoint(latest)
    t2 = _trainer(save_every_n_steps=2, checkpoint_dir=ckdir)
    assert t2.resume_latest(t2.init_state()).step == 2


def test_prune_sweeps_crash_orphans_but_not_the_inflight_save(tmp_path):
    tr = _trainer()
    state = tr.init_state()
    ckpt.save_checkpoint(tmp_path / "checkpoint_step_2", state, tr.model_cfg)
    for orphan in (".ckpt_tmp_dead1", ".tmp_checkpoint_step_9",
                   ".trash_checkpoint_step_1"):
        (tmp_path / orphan).mkdir()
        (tmp_path / orphan / "arrays.npz").write_bytes(b"orphaned payload")
    ckpt.save_checkpoint_async(tmp_path / "checkpoint_step_4", state,
                               tr.model_cfg)
    try:
        ckpt.prune_checkpoints(tmp_path, keep=2)
        assert sorted(p.name for p in tmp_path.iterdir()
                      if p.name.startswith(".")) == [
            ".tmp_checkpoint_step_4"]
    finally:
        ckpt.finalize_async_save()
    ckpt.verify_checkpoint(tmp_path / "checkpoint_step_4")


def test_prune_never_races_an_inflight_async_save(tmp_path):
    tr = _trainer()
    state = tr.init_state()
    for step in (4, 6):
        ckpt.save_checkpoint(tmp_path / f"checkpoint_step_{step}", state,
                             tr.model_cfg)
    # An async save overwriting step 4 (a replay recrossing a boundary).
    ckpt.save_checkpoint_async(tmp_path / "checkpoint_step_4", state,
                               tr.model_cfg)
    assert ckpt.pending_async_directory() == \
        (tmp_path / "checkpoint_step_4").resolve()
    try:
        assert ckpt.prune_checkpoints(tmp_path, keep=1) == []
        assert (tmp_path / "checkpoint_step_4").exists()
    finally:
        assert ckpt.finalize_async_save() == str(
            (tmp_path / "checkpoint_step_4").resolve())
    assert ckpt.pending_async_directory() is None
    ckpt.verify_checkpoint(tmp_path / "checkpoint_step_4")
    assert [Path(p).name for p in ckpt.prune_checkpoints(tmp_path, 1)] == \
        ["checkpoint_step_4"]


def test_async_save_snapshots_before_returning(tmp_path):
    """The async save copies the state before it returns: a step that
    overwrites params in place right after does not reach the checkpoint,
    and the save is invisible until finalized."""
    tr = _trainer(checkpoint_dir=str(tmp_path))
    state = tr.init_state()
    want = {k: np.array(a, copy=True)
            for k, a in ckpt._state_arrays(state, tr.model_cfg).items()}
    ckpt.save_checkpoint_async(tr.checkpoint_path(0), state, tr.model_cfg,
                               metadata={"step": 0})
    with torch.no_grad():
        for p in tree.leaves(state.params):
            p.add_(1.0)
    assert ckpt.latest_checkpoint(tmp_path) is None
    ckpt.finalize_async_save()
    assert ckpt.latest_checkpoint(tmp_path).endswith("checkpoint_step_0")
    with np.load(tmp_path / "checkpoint_step_0" / "arrays.npz") as got:
        assert sorted(got.files) == sorted(want)
        for k, a in want.items():
            np.testing.assert_array_equal(got[k], a, err_msg=k)
    assert ckpt.read_metadata(tmp_path / "checkpoint_step_0") == {"step": 0}


def test_async_and_sync_saves_end_bit_equal(shards, tmp_path):
    runs = {}
    for mode in (False, True):
        d = tmp_path / str(mode)
        state, hist = _trainer(save_every_n_steps=2, checkpoint_dir=str(d),
                               keep_checkpoints=2,
                               async_checkpoint=mode).train(_loader(shards))
        runs[mode] = (state, hist, sorted(p.name for p in d.iterdir()))
    _assert_state_bit_equal(runs[False][0], runs[True][0], "async vs sync")
    assert runs[False][1] == [dict(h, elapsed_s=g["elapsed_s"])
                              for h, g in zip(runs[True][1], runs[False][1])]
    assert runs[False][2] == runs[True][2] == ["checkpoint_step_6",
                                               "checkpoint_step_8"]
    for name in runs[False][2]:
        with np.load(tmp_path / "False" / name / "arrays.npz") as a, \
                np.load(tmp_path / "True" / name / "arrays.npz") as b:
            assert all(np.array_equal(a[k], b[k]) for k in a.files)


def test_orbax_stays_refused_and_names_item_7(tmp_path):
    """Item 7(a) ported the orbax-class format as the port's own sharded
    one: it saves and verifies; what stays refused, naming the item, is a
    directory of JAX's tensorstore format."""
    tr = _trainer()
    path = ckpt.save_checkpoint(tmp_path / "x", tr.init_state(),
                                tr.model_cfg, format="orbax")
    ckpt.verify_checkpoint(path)
    (tmp_path / "o" / "tree").mkdir(parents=True)
    with pytest.raises(NotImplementedError, match="item 7"):
        ckpt.verify_checkpoint(tmp_path / "o")


# -- guard rollback ----------------------------------------------------------


def test_rollback_replay_bit_identity(shards, tmp_path):
    """A transient corrupt batch: the guard skips it, the loop rolls back
    to the last checkpoint and replays the window on clean data — final
    state bit-equal to an undisturbed run."""
    ref_state, _ = _trainer().train(_loader(shards))
    logs = []
    tr = _trainer(logs, save_every_n_steps=2,
                  checkpoint_dir=str(tmp_path / "ck"))
    inj = TrainFaultInjector([TrainFault(tick=5, kind="bad_batch")]
                             ).install(tr)
    state, _ = tr.train(_loader(shards))
    assert inj.counts["bad_batch"] == 1 and tr._rollbacks == 1
    assert any("rolled back" in m for m in logs)
    _assert_state_bit_equal(ref_state, state, "rollback replay")


def test_rollback_defers_mid_burst_checkpoint(shards, tmp_path):
    logs = []
    tr = _trainer(logs, save_every_n_steps=2,
                  checkpoint_dir=str(tmp_path / "ck"),
                  guard_rollback_after=3, log_every_n_steps=8)
    TrainFaultInjector([TrainFault(tick=3, kind="bad_batch"),
                        TrainFault(tick=4, kind="bad_batch")]).install(tr)
    state, _ = tr.train(_loader(shards))
    assert state.step == 8
    assert any("deferring checkpoint" in m for m in logs)
    saved = [Path(p).name for p in ckpt.list_checkpoints(tmp_path / "ck")]
    assert "checkpoint_step_4" not in saved and "checkpoint_step_6" in saved


class _PersistentlyCorruptLoader:
    """Batch ``poison_at`` is corrupt on EVERY pass: a replay re-hits it."""

    def __init__(self, n=24, poison_at=7, seed=0):
        rng = np.random.default_rng(seed)
        self.batches = [(rng.integers(0, 101, (4, 16)).astype(np.int32),
                         rng.integers(0, 101, (4, 16)).astype(np.int32))
                        for _ in range(n)]
        self.batches[poison_at] = (np.full((4, 16), -7, np.int32),
                                   self.batches[poison_at][1])
        self._pos, self._pending = 0, None

    def state_dict(self):
        return {"pos": self._pos}

    def load_state_dict(self, sd):
        self._pending = int(sd["pos"])

    def __iter__(self):
        if self._pending is not None:
            self._pos, self._pending = self._pending, None
        while self._pos < len(self.batches):
            b = self.batches[self._pos]
            self._pos += 1
            yield b


def test_persistent_corruption_skip_window_vs_replay(tmp_path):
    kw = dict(global_batch_size=4, micro_batch_size=4, num_steps=10,
              log_every_n_steps=1, save_every_n_steps=2)
    tr = _trainer(checkpoint_dir=str(tmp_path / "a"), guard_max_rollbacks=2,
                  **kw)
    with pytest.raises(RuntimeError, match="persistent"):
        tr.train(_PersistentlyCorruptLoader())
    logs = []
    tr2 = _trainer(logs, checkpoint_dir=str(tmp_path / "b"),
                   guard_skip_window=True, **kw)
    state, hist = tr2.train(_PersistentlyCorruptLoader())
    assert state.step == 10
    assert any("offending window skipped" in m for m in logs)
    assert hist[-1]["anomalies"] == 0  # the rolled-back state is clean
    assert all(np.isfinite(e["loss"]) for e in hist if e["step"] > 8)


def test_rollback_without_checkpoint_fails_loudly(shards):
    tr = _trainer()  # no save_every
    TrainFaultInjector([TrainFault(tick=2, kind="bad_batch")]).install(tr)
    with pytest.raises(RuntimeError, match="no checkpoint"):
        tr.train(_loader(shards))


# -- the other fault kinds ---------------------------------------------------


def test_sigterm_fault_drives_the_preemption_save(shards, tmp_path):
    ckdir = str(tmp_path / "ck")
    tr = _trainer(num_steps=50, checkpoint_dir=ckdir,
                  save_on_preemption=True)
    before = signal.getsignal(signal.SIGTERM)
    inj = TrainFaultInjector([TrainFault(tick=3, kind="sigterm")]
                             ).install(tr)
    state, _ = tr.train(_loader(shards))
    assert signal.getsignal(signal.SIGTERM) is before
    assert state.step == 3 and inj.counts["sigterm"] == 1
    latest = ckpt.latest_checkpoint(ckdir)
    assert ckpt.read_metadata(latest)["step"] == 3
    assert "loader_state" in ckpt.read_metadata(latest)


def test_preemption_with_an_anomaly_saves_only_without_a_prior(tmp_path):
    def run(ckdir, save_every):
        logs = []
        tr = _trainer(logs, num_steps=50, checkpoint_dir=str(ckdir),
                      save_every_n_steps=save_every,
                      save_on_preemption=True, guard_rollback_after=3)
        TrainFaultInjector([TrainFault(tick=3, kind="bad_batch")]
                           ).install(tr)
        rng = np.random.default_rng(0)

        def signalling():
            for i in range(20):
                if i == 5:  # A = 2: lands inside step 3's window
                    os.kill(os.getpid(), signal.SIGTERM)
                yield (rng.integers(0, 101, (4, 16)).astype(np.int32),
                       rng.integers(0, 101, (4, 16)).astype(np.int32))

        tr.train(signalling())
        return logs

    logs = run(tmp_path / "a", None)
    assert any("saved anyway, no earlier checkpoint" in m for m in logs)
    assert ckpt.latest_checkpoint(tmp_path / "a") is not None
    logs = run(tmp_path / "b", 2)
    assert any("SKIPPED: un-adjudicated anomalies" in m for m in logs)
    assert ckpt.latest_checkpoint(tmp_path / "b").endswith(
        "checkpoint_step_2")


def test_slow_step_advances_a_virtual_clock(shards, tmp_path):
    clock = VirtualClock()
    counts_path = tmp_path / "counts.json"
    tr = _trainer(num_steps=4)
    inj = TrainFaultInjector(
        [TrainFault(tick=2, kind="slow_step", seconds=0.5),
         TrainFault(tick=3, kind="slow_step")],
        sleep=clock.advance, counts_path=counts_path, slow_step_s=0.25,
    ).install(tr)
    tr.train(_loader(shards))
    assert clock() == 0.75 and inj.counts["slow_step"] == 2
    assert json.loads(counts_path.read_text())["slow_step"] == 2


def test_trip_at_loop_exit_warns():
    logs = []
    tr = _trainer(logs, num_steps=50, log_every_n_steps=50)
    rng = np.random.default_rng(0)
    batches = [(rng.integers(0, 101, (4, 16)).astype(np.int32),
                rng.integers(0, 101, (4, 16)).astype(np.int32))
               for _ in range(6)]
    TrainFaultInjector([TrainFault(tick=3, kind="bad_batch")]).install(tr)
    state, _ = tr.train(iter(batches))
    assert state.step == 3
    assert any("un-adjudicated anomalies" in m for m in logs)


def test_ckpt_corrupt_fault_flips_the_committed_payload(shards, tmp_path):
    ckdir = str(tmp_path / "ck")
    tr = _trainer(num_steps=4, save_every_n_steps=2, checkpoint_dir=ckdir)
    inj = TrainFaultInjector([TrainFault(tick=2, kind="ckpt_corrupt")],
                             seed=0).install(tr)
    tr.train(_loader(shards))
    assert inj.counts["ckpt_corrupt"] == 1
    states = []
    for p in ckpt.list_checkpoints(ckdir):
        try:
            ckpt.verify_checkpoint(p)
            states.append("ok")
        except ckpt.CheckpointCorrupt:
            states.append("corrupt")
    assert sorted(states) == ["corrupt", "ok"]


def test_fault_validation_and_the_shared_engine():
    with pytest.raises(ValueError, match="unknown fault kind"):
        TrainFault(tick=1, kind="nan_row")
    with pytest.raises(ValueError, match="crash_mode"):
        TrainFaultInjector(crash_mode="abort")
    from pytorch_distributed_tpu_torch.serving import chaos as serving_chaos

    assert serving_chaos.VirtualClock is shared.VirtualClock is VirtualClock
    assert issubclass(TrainFaultInjector, shared.ScriptedFaults)
    assert issubclass(TrainFault, shared.Fault)
    assert CRASH_EXIT_CODE == jchaos.CRASH_EXIT_CODE == 43
    assert TrainFault.KINDS == jchaos.TrainFault.KINDS


# -- the schedules against JAX's injector ------------------------------------


def _drive_schedule(mod, root: Path, seed: int, ticks: int = 40):
    """Drive one injector over a step and save sequence (a save every 2nd
    tick into a committed fake checkpoint): the faults it fires, tick by
    tick, with the byte ckpt_corrupt flipped."""
    ck = root / "checkpoint_step_1"
    ck.mkdir(parents=True)
    (ck / "arrays.npz").write_bytes(bytes(range(256)) * 4)
    (ck / "COMMIT").write_text("{}")
    stalls = []
    inj = mod.TrainFaultInjector(
        [mod.TrainFault(tick=6, kind="crash", program="save"),
         mod.TrainFault(tick=9, kind="bad_batch")],
        seed=seed, p_crash=0.1, p_sigterm=0.1, p_bad_batch=0.1,
        p_ckpt_corrupt=0.2, p_slow_step=0.2, sleep=stalls.append)
    fired = []
    batch = {"inputs": np.zeros((1, 2, 8), np.int32),
             "targets": np.zeros((1, 2, 8), np.int32)}
    got_signal = []
    prev = signal.signal(signal.SIGTERM, lambda *a: got_signal.append(1))
    try:
        for tick in range(1, ticks + 1):
            before = dict(inj.counts)
            inj.on_step(tick)
            try:
                out = inj.before_step(tick, batch)
                poisoned = int((out["inputs"] < 0).sum())
            except BaseException as e:  # ChaosCrash of either package
                poisoned = type(e).__name__
            if tick % 2 == 0:
                try:
                    inj.on_save("pre_commit", ck)
                except BaseException as e:
                    poisoned = (poisoned, type(e).__name__)
                inj.after_save(root)
            fired.append((tick, poisoned, {k: v - before[k] for k, v in
                                           inj.counts.items()
                                           if v != before[k]}))
    finally:
        signal.signal(signal.SIGTERM, prev)
    return fired, stalls, (ck / "arrays.npz").read_bytes(), len(got_signal)


@pytest.mark.parametrize("seed", range(5))
def test_fault_schedule_matches_jax_injector(tmp_path, seed):
    want = _drive_schedule(jchaos, tmp_path / "jax", seed)
    got = _drive_schedule(pchaos, tmp_path / "port", seed)
    assert got == want
    assert sum(len(f[2]) for f in got[0]) > 0


# -- the port's Trainer against the JAX Trainer, same faults ----------------


def _cross_trainers(tmp_path, **kw):
    jcfg = JaxModelConfig(**MODEL_KW, **NO_DROP)
    cfg = ModelConfig(**MODEL_KW, **NO_DROP)
    tk = _tkw(**dict(dict(seed=5), **kw))
    jlogs, plogs = [], []
    jt = JaxTrainer(jget_model(jcfg), jcfg, JaxTrainConfig(
        **dict(tk, checkpoint_dir=str(tmp_path / "j"))),
        log_fn=jlogs.append)
    pt = Trainer(get_model(cfg), cfg, TrainConfig(
        **dict(tk, checkpoint_dir=str(tmp_path / "p"))), device="cpu",
        log_fn=plogs.append)
    jstate = jt.init_state()
    pstate = init_train_state(
        interop.params_from_jax(jax.device_get(jstate.params), cfg), pt.tx,
        guard=guard_lib.init_guard_state("cpu"))
    return jt, jstate, jlogs, pt, pstate, plogs, cfg


@pytest.mark.parametrize("case", ["replay", "defer", "skip_window"])
def test_trainer_under_faults_matches_the_jax_trainer(shards, tmp_path,
                                                      case):
    """The same shards (or the persistently corrupt stream) and the same
    scripted faults through both Trainers: equal steps, rollbacks,
    anomalies and history steps; final params within 1e-5."""
    if case == "replay":
        kw, faults = dict(save_every_n_steps=2), [(5, "bad_batch")]
    elif case == "defer":
        kw = dict(save_every_n_steps=2, guard_rollback_after=3,
                  log_every_n_steps=8)
        faults = [(3, "bad_batch"), (4, "bad_batch")]
    else:
        kw = dict(global_batch_size=4, micro_batch_size=4, num_steps=10,
                  log_every_n_steps=1, save_every_n_steps=2,
                  guard_skip_window=True)
        faults = []
    jt, jstate, jlogs, pt, pstate, plogs, cfg = _cross_trainers(tmp_path,
                                                                **kw)
    jchaos.TrainFaultInjector([jchaos.TrainFault(tick=t, kind=k)
                               for t, k in faults]).install(jt)
    TrainFaultInjector([TrainFault(tick=t, kind=k) for t, k in faults]
                       ).install(pt)
    if case == "skip_window":
        jloader, ploader = _PersistentlyCorruptLoader(), \
            _PersistentlyCorruptLoader()
    else:
        jloader, ploader = JaxLoader(shards, 4, 16), _loader(shards)
    with jax.default_matmul_precision("highest"):
        jstate, jhist = jt.train(jloader, state=jstate)
    pstate, phist = pt.train(ploader, state=pstate)
    assert pstate.step == int(jstate.step)
    assert pt._rollbacks == jt._rollbacks
    assert [h["step"] for h in phist] == [h["step"] for h in jhist]
    assert [h["anomalies"] for h in phist] == [h["anomalies"] for h in jhist]
    for h, jh in zip(phist, jhist):
        np.testing.assert_allclose(h["loss"], jh["loss"], rtol=1e-5)
    assert [m.split(" (")[0] for m in plogs if "rolled back" in m or
            "deferring" in m] == [m.split(" (")[0] for m in jlogs
                                  if "rolled back" in m or "deferring" in m
                                  ] or case != "defer"
    assert sorted(Path(p).name for p in ckpt.list_checkpoints(
        tmp_path / "p")) == sorted(Path(p).name for p in
                                   jckpt.list_checkpoints(tmp_path / "j"))
    _assert_params_parity(pstate.params, jstate.params, cfg, lr=1e-3)


def _assert_params_parity(port_params, jax_params, cfg, lr):
    """The module docstring's bound: all but 1e-3 of the elements within
    atol 1e-5 / rtol 1e-4, every element within 2 lr."""
    got = interop.params_to_jax(port_params, cfg)
    n = off = 0
    for (path, a), (_, b) in zip(
            jax.tree_util.tree_leaves_with_path(got),
            jax.tree_util.tree_leaves_with_path(jax.device_get(jax_params))):
        d = np.abs(a - np.asarray(b))
        assert d.max() <= 2 * lr, (path, float(d.max()))
        off += int((d > 1e-5 + 1e-4 * np.abs(b)).sum())
        n += d.size
    assert off <= n // 1000, f"{off} of {n} elements beyond 1e-5"


# -- the supervisor twin -----------------------------------------------------


def test_supervisor_twin_dryrun_storm_is_bit_equal(tmp_path):
    """The twin's storm in real processes on the CPU: crashes (one inside
    a save), SIGTERM, corrupt batches, bit-flipped checkpoints and slow
    steps — final state bit-equal to its own fault-free leg, every fault
    kind fired, the same kernel libraries loaded in every incarnation."""
    out = tmp_path / "report.json"
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "pytorch_distributed_tpu_torch.train."
         "supervisor", "--soak", "--dryrun", "--device", "cpu", "--seed",
         "0", "--workdir", str(tmp_path / "storm"), "--json", str(out)],
        cwd=ROOT, capture_output=True, text=True, timeout=600, env=env)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    report = json.loads(out.read_text())
    assert report["ok"], report["failures"]
    assert report["bit_equal"] and report["chaos"]["completed"]
    assert all(report["fault_counts"][k] > 0 for k in
               ("crash", "sigterm", "bad_batch", "ckpt_corrupt",
                "slow_step"))
    assert report["chaos"]["restarts"] >= 1
    assert report["chaos"]["exit_codes"].count(CRASH_EXIT_CODE) == \
        report["fault_counts"]["crash"]
    assert {a["compile_count"] for a in report["chaos"]["attempts"]} == {0}


def test_baseline_entry_point_with_the_guard_and_async_saves(tmp_path):
    """``train.baseline --anomaly-guard --async-checkpoint``: the saves
    commit with the guard's leaves, and ``--resume`` continues."""
    from pytorch_distributed_tpu_torch.train import baseline

    args = ["--device", "cpu", "--preset", "tiny", "--seq-len", "32",
            "--global-batch-size", "4", "--micro-batch-size", "2",
            "--steps", "4", "--log-every", "2", "--num-train-files", "2",
            "--data-dir", str(tmp_path / "data"), "--no-profiler",
            "--checkpoint-dir", str(tmp_path / "ck"), "--save-every", "2",
            "--metrics-out", str(tmp_path / "m.jsonl"), "--anomaly-guard",
            "--guard-rollback-after", "0", "--async-checkpoint"]
    parsed = baseline.parse_args(args)
    tc = baseline.build_train_cfg(parsed)
    assert tc.anomaly_guard and tc.async_checkpoint
    assert tc.guard_rollback_after is None and not tc.guard_skip_window
    assert baseline.main(args) == 0
    assert ckpt.pending_async_directory() is None
    names = [Path(p).name for p in ckpt.list_checkpoints(tmp_path / "ck")]
    assert names == ["checkpoint_step_4", "checkpoint_step_2"]
    man = json.loads((tmp_path / "ck" / names[0] / "manifest.json")
                     .read_text())["leaves"]
    assert [k for k in man if k.startswith("guard/")] == [
        "guard/ema", "guard/seen", "guard/consecutive", "guard/total",
        "guard/trip"]
    lines = [json.loads(x) for x in
             (tmp_path / "m.jsonl").read_text().splitlines()]
    assert [(x["step"], x["anomalies"]) for x in lines] == [(2, 0), (4, 0)]
    assert baseline.main(args + ["--resume"]) == 0  # nothing left to train
    assert len((tmp_path / "m.jsonl").read_text().splitlines()) == 2
