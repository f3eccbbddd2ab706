"""The port's anomaly guard (``train/guard``, the guarded step and update)
against the JAX package's, on the CPU in f32.

GPT-2 at vocab 101, n_ctx 16, n_embd 32, 2 layers, 4 heads, no dropout;
the same weights on both sides (the JAX ``init``, converted by
``interop``), the same seeded numpy batches; JAX matmuls at "highest"
precision. Tolerances: guard counters equal, the EMA within rtol 1e-7
(f32 rounding of the same formula); a step's loss within 1e-6 of JAX's
(a NaN loss NaN on both sides); params after clean guarded steps within
atol 1e-5 / rtol 1e-4 (``tests/test_torch_train_loop.py``'s bound: Adam
turns summation-order noise in a near-zero gradient into an update
difference of order lr). An anomalous step must leave the port's params,
moments and counts BIT-EQUAL to their values before it.

- ``guard_step`` over a seeded loss sequence (NaN, Inf, spikes before
  and after warmup, a trip, rollback off);
- ``check_batch``, and the id mapping of the guarded step against JAX's
  gathers for ids -V-1 ... V+1: the embedding, the unfused and the fused
  cross-entropy;
- ``GuardConfig`` validation and ``guard_config_from``; ``apply_guard``;
- the guarded step on a corrupt batch (inputs, targets; fused and not)
  and on NaN params, then a clean step, against JAX's guarded step;
- guard leaves in checkpoints JAX <-> port, and a pre-guard checkpoint
  resumed into a guarded run.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from pytorch_distributed_tpu.config import ModelConfig as JaxModelConfig
from pytorch_distributed_tpu.config import TrainConfig as JaxTrainConfig
from pytorch_distributed_tpu.models import get_model as jget_model
from pytorch_distributed_tpu.ops import losses as jlosses
from pytorch_distributed_tpu.train import checkpoint as jckpt
from pytorch_distributed_tpu.train import guard as jguard
from pytorch_distributed_tpu.train import optim as joptim
from pytorch_distributed_tpu.train.state import init_train_state as jinit
from pytorch_distributed_tpu.train.trainer import Trainer as JaxTrainer
from pytorch_distributed_tpu.train.trainer import make_train_step as jstep
from pytorch_distributed_tpu.utils.prng import domain_key, step_key
from pytorch_distributed_tpu_torch import interop
from pytorch_distributed_tpu_torch.config import ModelConfig, TrainConfig
from pytorch_distributed_tpu_torch.models import get_model
from pytorch_distributed_tpu_torch.ops import losses
from pytorch_distributed_tpu_torch.train import guard
from pytorch_distributed_tpu_torch.train import optim
from pytorch_distributed_tpu_torch.train.state import init_train_state
from pytorch_distributed_tpu_torch.train.trainer import (
    Trainer,
    make_train_step,
)
from pytorch_distributed_tpu_torch.utils import tree

V = 101
CFG_KW = dict(vocab_size=V, n_ctx=16, n_embd=32, n_layer=2, n_head=4,
              dtype="float32", embd_pdrop=0.0, attn_pdrop=0.0,
              resid_pdrop=0.0)
B, T = 2, 16
SEED = 5


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """Many tiny steps, whose cost on a loaded host is the intra-op thread
    pool's synchronisation: one thread for the module, restored after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# -- guard_step ------------------------------------------------------------


def _jax_guard_run(cfg_kw, seq):
    cfg = jguard.GuardConfig(**cfg_kw)
    step = jax.jit(lambda g, l, n, b: jguard.guard_step(g, l, n, b, cfg))
    g, out = jguard.init_guard_state(), []
    for loss, norm, bad in seq:
        g, a = step(g, jnp.float32(loss), jnp.float32(norm), jnp.asarray(bad))
        out.append((jax.device_get(g), bool(a)))
    return out


def _port_guard_run(cfg_kw, seq):
    cfg = guard.GuardConfig(**cfg_kw)
    g, out = guard.init_guard_state("cpu"), []
    for loss, norm, bad in seq:
        g, a = guard.guard_step(g, torch.tensor(loss, dtype=torch.float32),
                                torch.tensor(norm, dtype=torch.float32),
                                torch.tensor(bad), cfg)
        out.append((g, bool(a)))
    return out


def _loss_sequence(seed):
    """Seeded losses near 3 with NaN, Inf, a spike inside the warmup and
    spikes after it (a burst of two trips rollback_after=2), and bad-data
    flags."""
    rng = np.random.default_rng(seed)
    seq = [(float(3 + rng.normal(0, 0.1)), float(abs(rng.normal(1, 0.2))),
            False) for _ in range(24)]
    seq[1] = (40.0, 1.0, False)  # a spike inside the warmup: folded
    seq[5] = (float("nan"), 1.0, False)
    seq[7] = (3.0, float("inf"), False)
    seq[9] = (float("inf"), 1.0, False)
    seq[12] = (50.0, 1.0, False)  # after the warmup: a spike
    seq[15] = (3.1, 1.0, True)  # corrupt data
    seq[18], seq[19] = (60.0, 1.0, False), (float("nan"), 1.0, False)
    return seq


@pytest.mark.parametrize("rollback_after", [2, None])
@pytest.mark.parametrize("seed", [0, 1])
def test_guard_step_sequence_matches_jax(seed, rollback_after):
    kw = dict(spike_factor=3.0, ema_decay=0.9, warmup_steps=3,
              rollback_after=rollback_after, vocab_size=V)
    seq = _loss_sequence(seed)
    want, got = _jax_guard_run(kw, seq), _port_guard_run(kw, seq)
    anomalies = 0
    for i, ((jg, ja), (pg, pa)) in enumerate(zip(want, got)):
        assert pa == ja, f"step {i}"
        anomalies += pa
        for name in ("seen", "consecutive", "total", "trip"):
            assert int(getattr(pg, name)) == int(getattr(jg, name)), \
                f"step {i} {name}"
            assert getattr(pg, name).dtype == torch.int32
        assert pg.ema.dtype == torch.float32
        np.testing.assert_allclose(float(pg.ema), float(jg.ema), rtol=1e-7,
                                   err_msg=f"step {i}")
    assert anomalies == 7
    assert int(got[-1][0].trip) == (rollback_after is not None)


def test_check_batch_flags_out_of_range_like_jax():
    rng = np.random.default_rng(0)
    base = {k: rng.integers(0, V, (2, B, T)).astype(np.int32)
            for k in ("inputs", "targets")}
    cases = [base]
    for key, where, val in (("inputs", (0, 0, 0), -1),
                            ("targets", (1, 1, 15), V),
                            ("inputs", (1, 0, 3), -V - 1)):
        b = {k: v.copy() for k, v in base.items()}
        b[key][where] = val
        cases.append(b)
    for b in cases:
        want = bool(jguard.check_batch(
            {k: jnp.asarray(v) for k, v in b.items()}, V))
        got = guard.check_batch(
            {k: torch.from_numpy(v) for k, v in b.items()}, V)
        assert got.dtype == torch.bool and got.dim() == 0
        assert bool(got) == want
    assert [bool(guard.check_batch({k: torch.from_numpy(v) for k, v in
                                    b.items()}, V)) for b in cases] == \
        [False, True, True, True]


# -- the id mapping: the guarded step reads what JAX's gathers read --------

SMALL_V = 5
IDS = list(range(-SMALL_V - 1, SMALL_V + 2))


def test_input_id_mapping_matches_jax_embedding_gather():
    wte = np.random.default_rng(0).normal(size=(SMALL_V, 3)).astype(
        np.float32)
    ids = np.asarray(IDS, np.int32)
    want = np.asarray(jnp.asarray(wte)[jnp.asarray(ids)])
    got = F.embedding(guard.safe_input_ids(torch.from_numpy(ids), SMALL_V),
                      torch.from_numpy(wte)).numpy()
    np.testing.assert_array_equal(got, want)
    assert guard.safe_input_ids(torch.tensor(IDS), SMALL_V).tolist() == \
        [0, 0, 1, 2, 3, 4, 0, 1, 2, 3, 4, 4, 4]


@pytest.mark.parametrize("tid", IDS)
def test_target_mapping_matches_jax_cross_entropy(tid):
    """The unfused loss: ids in [-V, 0) wrap, others outside [0, V) read
    NaN — through ``safe_targets`` and the NaN select of the step."""
    rng = np.random.default_rng(1)
    logits = rng.normal(size=(3, SMALL_V)).astype(np.float32)
    tgt = np.asarray([1, tid, 3], np.int32)
    want = float(jlosses.cross_entropy_loss(jnp.asarray(logits),
                                            jnp.asarray(tgt)))
    safe, invalid = guard.safe_targets(torch.from_numpy(tgt), SMALL_V)
    got = float(torch.where(invalid, torch.nan, losses.cross_entropy_loss(
        torch.from_numpy(logits), safe)))
    if np.isnan(want):
        assert np.isnan(got)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("layout", ["ve", "ev"])
def test_target_mapping_matches_jax_fused_cross_entropy(layout):
    """The fused loss takes out-of-range targets as they are, and reads
    what JAX's fused loss reads (no column matches a negative id; one past
    V hits a masked padding column): ids -V-1 ... V+1 and one past the
    padded width, with a padded last block (block_v 4, V 5)."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(len(IDS) + 1, 4)).astype(np.float32)
    w = rng.normal(size=(SMALL_V, 4)).astype(np.float32)
    if layout == "ev":
        w = np.ascontiguousarray(w.T)
    tgt = np.asarray(IDS + [9], np.int32)
    for i in range(len(tgt)):
        args = (x[i:i + 1], w, tgt[i:i + 1])
        want = float(jlosses.linear_cross_entropy(
            *map(jnp.asarray, args), block_v=4, w_layout=layout))
        got = float(losses.linear_cross_entropy(
            *map(torch.from_numpy, args), block_v=4, w_layout=layout))
        np.testing.assert_allclose(got, want, rtol=1e-6,
                                   err_msg=f"target {tgt[i]}")


# -- config ----------------------------------------------------------------


def test_guard_config_validation_and_adapter():
    for kw, match in ((dict(spike_factor=1.0), "spike_factor"),
                      (dict(ema_decay=1.0), "ema_decay"),
                      (dict(ema_decay=0.0), "ema_decay"),
                      (dict(warmup_steps=0), "warmup_steps"),
                      (dict(rollback_after=0), "rollback_after")):
        for cls in (guard.GuardConfig, jguard.GuardConfig):
            with pytest.raises(ValueError, match=match):
                cls(**kw)
    assert guard.GuardConfig(rollback_after=None).rollback_after is None
    tkw = dict(anomaly_guard=True, guard_spike_factor=4.0,
               guard_ema_decay=0.5, guard_warmup_steps=2,
               guard_rollback_after=None)
    got = guard.guard_config_from(TrainConfig(**tkw), ModelConfig(**CFG_KW))
    want = jguard.guard_config_from(JaxTrainConfig(**tkw),
                                    JaxModelConfig(**CFG_KW))
    assert got == guard.GuardConfig(**vars(want))
    assert guard.guard_config_from(TrainConfig(), ModelConfig(**CFG_KW)) \
        is None


def test_apply_guard_selects_the_old_tree():
    old = {"a": torch.ones(3), "b": [torch.zeros((), dtype=torch.int32)],
           "g": guard.init_guard_state("cpu")}
    new = {"a": torch.full((3,), 2.0), "b": [torch.ones((),
                                                        dtype=torch.int32)],
           "g": guard.GuardState(*(x + 1 for x in old["g"]))}
    kept = guard.apply_guard(torch.tensor(True), new, old)
    assert torch.equal(kept["a"], old["a"]) and int(kept["b"][0]) == 0
    assert isinstance(kept["g"], guard.GuardState)
    assert int(kept["g"].total) == 0
    passed = guard.apply_guard(torch.tensor(False), new, old)
    assert torch.equal(passed["a"], new["a"]) and int(passed["g"].seen) == 1


# -- the guarded step against JAX's -----------------------------------------


def _bits(t: torch.Tensor) -> torch.Tensor:
    """A tensor's bit pattern (NaN == NaN, -0.0 != +0.0)."""
    ints = {4: torch.int32, 2: torch.int16, 1: torch.int8, 8: torch.int64}
    return t.detach().contiguous().view(ints[t.element_size()]).clone()


def _snapshot(state):
    opt = state.opt_state
    return ([_bits(p) for p in tree.leaves(state.params)]
            + [_bits(p) for p in tree.leaves(opt["mu"])]
            + [_bits(p) for p in tree.leaves(opt["nu"])]
            + [int(opt["count"]), int(opt["schedule_count"])])


def _same(a, b) -> bool:
    return len(a) == len(b) and all(
        torch.equal(x, y) if torch.is_tensor(x) else x == y
        for x, y in zip(a, b))


def _pair(fused: bool, accum: int, lr_kw=None):
    kw = dict(CFG_KW, fused_head_ce=fused)
    jcfg, cfg = JaxModelConfig(**kw), ModelConfig(**kw)
    tkw = dict(learning_rate=1e-3, num_steps=8, warmup_steps=2,
               grad_clip_norm=1.0, anomaly_guard=True,
               guard_warmup_steps=2, guard_rollback_after=2, **(lr_kw or {}))
    jtx, tx = joptim.make_optimizer(JaxTrainConfig(**tkw)), \
        optim.make_optimizer(TrainConfig(**tkw))
    jg = jguard.guard_config_from(JaxTrainConfig(**tkw), jcfg)
    pg = guard.guard_config_from(TrainConfig(**tkw), cfg)
    jparams = jget_model(jcfg).init(jax.random.key(0), jcfg)
    jstate = jinit(jparams, jtx, guard=jguard.init_guard_state())
    state = init_train_state(
        interop.params_from_jax(jax.device_get(jparams), cfg), tx,
        guard=guard.init_guard_state("cpu"))
    return (jax.jit(jstep(jget_model(jcfg), jcfg, jtx, jit=False, guard=jg)),
            jstate, make_train_step(get_model(cfg), cfg, tx, guard=pg,
                                    seed=SEED), state, cfg)


def _batches(accum, n, seed=3):
    rng = np.random.default_rng(seed)
    return [{k: rng.integers(0, V, (accum, B, T)).astype(np.int32)
             for k in ("inputs", "targets")} for _ in range(n)]


def _corrupt(batch, where):
    b = {k: v.copy() for k, v in batch.items()}
    if where == "inputs":
        b["inputs"].reshape(-1)[:max(1, b["inputs"].size // 8)] = -1
    elif where == "targets":
        b["targets"][0, 0, :3] = [V, -V - 1, -2]
    elif where == "targets_wrap":
        b["targets"][0, 1, :2] = [-1, -V]
    return b


def _run_both(jstep_fn, jstate, step_fn, state, batch, i):
    root = domain_key(SEED, "dropout")
    with jax.default_matmul_precision("highest"):
        jstate, jm = jstep_fn(jstate, jax.tree.map(jnp.asarray, batch),
                              step_key(root, i))
    state, m = step_fn(state, {k: torch.from_numpy(v)
                               for k, v in batch.items()})
    return jstate, jax.device_get(jm), state, m


def _assert_guard_equal(pg, jg):
    jg = jax.device_get(jg)
    for name in ("seen", "consecutive", "total", "trip"):
        assert int(getattr(pg, name)) == int(getattr(jg, name)), name
    np.testing.assert_allclose(float(pg.ema), float(jg.ema), rtol=1e-6)


@pytest.mark.parametrize("fused,accum,where", [
    (False, 1, "inputs"), (False, 2, "targets"), (False, 1, "targets_wrap"),
    (True, 1, "inputs"), (True, 2, "targets"),
])
def test_guarded_step_on_a_corrupt_batch_matches_jax(fused, accum, where):
    """Clean, corrupt, clean: the corrupt step leaves the port's state
    bit-unchanged (params, mu, nu, counts) with its loss within 1e-6 of
    JAX's (NaN where JAX's is), the guard counters equal, and the next
    clean step lands where JAX's does (the counts held back)."""
    jstep_fn, jstate, step_fn, state, cfg = _pair(fused, accum)
    clean = _batches(accum, 3)
    jstate, jm, state, m = _run_both(jstep_fn, jstate, step_fn, state,
                                     clean[0], 0)
    assert not bool(m["anomaly"]) and not bool(jm["anomaly"])
    before = _snapshot(state)
    jstate, jm, state, m = _run_both(jstep_fn, jstate, step_fn, state,
                                     _corrupt(clean[1], where), 1)
    assert bool(m["anomaly"]) and bool(jm["anomaly"])
    assert _same(_snapshot(state), before), "the anomalous step moved state"
    assert state.step == 2 and int(jstate.step) == 2
    want = float(jm["loss"])
    if np.isnan(want):
        assert np.isnan(float(m["loss"]))
    else:
        np.testing.assert_allclose(float(m["loss"]), want, rtol=1e-6)
    _assert_guard_equal(state.guard, jstate.guard)
    jstate, jm, state, m = _run_both(jstep_fn, jstate, step_fn, state,
                                     clean[2], 2)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    _assert_guard_equal(state.guard, jstate.guard)
    assert int(state.opt_state["count"]) == \
        int(jstate.opt_state[1].count) == 2
    got = interop.params_to_jax(state.params, cfg)
    for (path, a), (_, b) in zip(
            jax.tree_util.tree_leaves_with_path(got),
            jax.tree_util.tree_leaves_with_path(
                jax.device_get(jstate.params))):
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=1e-4,
                                   err_msg=str(path))


def test_guarded_step_on_nan_params_is_a_bitwise_no_op():
    """A NaN in the params makes the loss NaN on both sides; the port's
    step leaves every byte of the state (the NaN included) and both counts
    as they were, and the guard counts the anomaly as JAX's does."""
    jstep_fn, jstate, step_fn, state, cfg = _pair(False, 1)
    batch = _batches(1, 1)[0]
    jstate, jm, state, m = _run_both(jstep_fn, jstate, step_fn, state,
                                     batch, 0)
    jparams = jax.device_get(jstate.params)
    jparams = jax.tree.map(np.array, jparams)
    jparams["ln_f"]["scale"][3] = np.nan
    jstate = jstate._replace(params=jax.tree.map(jnp.asarray, jparams))
    with torch.no_grad():
        state.params["ln_f"]["scale"][3] = torch.nan
    before = _snapshot(state)
    jstate, jm, state, m = _run_both(jstep_fn, jstate, step_fn, state,
                                     batch, 1)
    assert np.isnan(float(jm["loss"])) and np.isnan(float(m["loss"]))
    assert bool(m["anomaly"]) and bool(jm["anomaly"])
    assert _same(_snapshot(state), before)
    _assert_guard_equal(state.guard, jstate.guard)


def test_guard_off_step_is_unchanged():
    """Without ``guard`` the step keeps host counts and returns no guard
    and no anomaly metric (the unguarded path of before)."""
    cfg = ModelConfig(**CFG_KW)
    tx = optim.make_optimizer(TrainConfig(learning_rate=1e-3))
    params = get_model(cfg).init(torch.Generator().manual_seed(0), cfg,
                                 device="cpu")
    state = init_train_state(params, tx)
    assert state.guard is None and state.opt_state["count"] == 0
    state, m = make_train_step(get_model(cfg), cfg, tx)(
        state, {k: torch.from_numpy(v) for k, v in _batches(1, 1)[0].items()})
    assert set(m) == {"loss", "grad_norm"} and state.guard is None
    assert state.opt_state["count"] == 1 and \
        isinstance(state.opt_state["count"], int)
    with pytest.raises(ValueError, match="state.guard"):
        make_train_step(get_model(cfg), cfg, tx,
                        guard=guard.GuardConfig(vocab_size=V))(
            state, {k: torch.from_numpy(v)
                    for k, v in _batches(1, 1)[0].items()})


@pytest.mark.parametrize("sched", [dict(), dict(lr_schedule="constant"),
                                   dict(warmup_steps=0)])
def test_device_learning_rate_matches_the_host_schedule(sched):
    tx = optim.make_optimizer(TrainConfig(learning_rate=3e-4, num_steps=20,
                                          **dict(dict(warmup_steps=3),
                                                 **sched)))
    for n in range(0, 26):
        got = float(tx.lr_tensor(torch.tensor(n, dtype=torch.int32)))
        assert got == float(np.float32(tx.schedule(n))), n


# -- checkpoints -------------------------------------------------------------


def _tcfg_kw(ckdir, **kw):
    return dict(dict(global_batch_size=4, micro_batch_size=2, num_steps=4,
                     learning_rate=1e-3, log_every_n_steps=2,
                     checkpoint_dir=str(ckdir), seed=SEED,
                     anomaly_guard=True, guard_warmup_steps=2), **kw)


def test_guard_leaves_cross_between_the_packages(tmp_path):
    """A guarded JAX state with non-zero counters saved by JAX restores
    into the port's guarded state, and the port's save restores into
    JAX's, the counters equal; the manifests' keys and dtypes match."""
    jcfg, cfg = JaxModelConfig(**CFG_KW), ModelConfig(**CFG_KW)
    jt = JaxTrainer(jget_model(jcfg), jcfg,
                    JaxTrainConfig(**_tcfg_kw(tmp_path / "j")),
                    log_fn=lambda s: None)
    pt = Trainer(get_model(cfg), cfg, TrainConfig(**_tcfg_kw(tmp_path / "p")),
                 device="cpu", log_fn=lambda s: None)
    jstate = jt.init_state()
    jg = jguard.GuardState(jnp.float32(2.5), jnp.int32(7), jnp.int32(1),
                           jnp.int32(3), jnp.int32(1))
    jstate = jstate._replace(guard=jg)
    jpath = jckpt.save_checkpoint(tmp_path / "j" / "checkpoint_step_0",
                                  jstate)
    got = pt.load_checkpoint(jpath, pt.init_state())
    assert float(got.guard.ema) == 2.5
    assert [int(x) for x in got.guard[1:]] == [7, 1, 3, 1]
    assert all(x.dtype == torch.int32 for x in got.guard[1:])
    assert torch.is_tensor(got.opt_state["count"])
    ppath = pt.save_checkpoint(got)
    back = jckpt.load_checkpoint(ppath, jt.init_state())
    assert float(back.guard.ema) == 2.5
    assert [int(x) for x in back.guard[1:]] == [7, 1, 3, 1]
    import json
    from pathlib import Path
    jman, pman = (json.loads(Path(p, "manifest.json").read_text())["leaves"]
                  for p in (jpath, ppath))
    assert list(pman) == list(jman)
    assert {k: v["dtype"] for k, v in pman.items()} == \
        {k: v["dtype"] for k, v in jman.items()}


def test_pre_guard_checkpoint_resumes_into_a_guarded_run(tmp_path):
    """A run that turns the guard on mid-life: a guard-off checkpoint
    restores params, moments and counts (counts onto the device) and
    starts the guard fresh; a guarded checkpoint restores into an
    unguarded state without its guard."""
    cfg = ModelConfig(**CFG_KW)
    off = Trainer(get_model(cfg), cfg,
                  TrainConfig(**_tcfg_kw(tmp_path, anomaly_guard=False)),
                  device="cpu", log_fn=lambda s: None)
    state_off = off.init_state()
    batch = off.put_batch(_batches(1, 1)[0])
    state_off, _ = off.train_step(state_off, batch)
    off.save_checkpoint(state_off)
    on = Trainer(get_model(cfg), cfg, TrainConfig(**_tcfg_kw(tmp_path)),
                 device="cpu", log_fn=lambda s: None)
    resumed = on.resume_latest(on.init_state())
    assert resumed.step == 1 and int(resumed.guard.total) == 0
    assert int(resumed.opt_state["count"]) == 1
    assert torch.is_tensor(resumed.opt_state["schedule_count"])
    for a, b in zip(tree.leaves(state_off.params),
                    tree.leaves(resumed.params)):
        assert torch.equal(a, b)
    resumed, m = on.train_step(resumed, batch)  # the guarded step goes on
    assert not bool(m["anomaly"]) and int(resumed.opt_state["count"]) == 2
    on.save_checkpoint(resumed)
    back = off.load_checkpoint(on.checkpoint_path(2), off.init_state())
    assert back.guard is None and back.opt_state["count"] == 2
