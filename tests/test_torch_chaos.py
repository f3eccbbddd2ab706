"""The request lifecycle and fault injection of the port's paged engine.

Ported case by case from the JAX package's ``tests/test_chaos.py`` (each
docstring names its JAX test), on the port's ``PagedBatchedDecodeEngine``
on the CPU in f32: abort, deadlines, bounded admission with the reject
and block policies, the NaN quarantine, dropped results and failed
dispatches recovered token-equal (the pool reset, nothing reused),
retry-budget exhaustion, snapshot/restore, the run guards and the
lifecycle log. The recovery paths are also held exactly to the JAX
``PagedBatchedDecodeEngine`` under the same scripted faults: the same
terminal states, reasons, tokens and counters. The serial engine's
``RequestFailed`` test has no counterpart: the serial engine is not
ported.
"""

import logging

import jax
import numpy as np
import pytest
import torch

from pytorch_distributed_tpu.config import ModelConfig as JaxModelConfig
from pytorch_distributed_tpu.models import gpt2 as jgpt2
from pytorch_distributed_tpu.serving import chaos as jchaos
from pytorch_distributed_tpu.serving.engine import (
    PagedBatchedDecodeEngine as JaxEngine,
)
from pytorch_distributed_tpu_torch import interop
from pytorch_distributed_tpu_torch.config import ModelConfig
from pytorch_distributed_tpu_torch.serving.chaos import (
    Fault,
    FaultInjector,
    VirtualClock,
)
from pytorch_distributed_tpu_torch.serving.engine import (
    PagedBatchedDecodeEngine,
)
from pytorch_distributed_tpu_torch.serving.lifecycle import (
    ABORTED,
    DONE,
    EXPIRED,
    FAILED,
    AdmissionQueueFull,
    DispatchFailure,
    RequestResult,
)

CFG_KW = dict(
    vocab_size=97, n_ctx=64, n_embd=64, n_layer=2, n_head=4,
    dtype="float32", attn_pdrop=0.0, resid_pdrop=0.0, embd_pdrop=0.0,
)
ENGINE_KW = dict(slots=2, max_len=24, page_size=8, prefill_chunk=8)


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """These tests run many tiny forwards, whose cost on a loaded host is
    the intra-op thread pool's synchronisation: one thread for the
    module, restored after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def weights():
    jcfg = JaxModelConfig(**CFG_KW)
    jparams = jgpt2.init(jax.random.key(0), jcfg)
    pcfg = ModelConfig(**CFG_KW)
    return jcfg, jparams, pcfg, interop.params_from_jax(
        jax.device_get(jparams), pcfg
    )


def _prompt(n, seed):
    return np.random.default_rng(seed).integers(0, 97, n).astype(np.int32)


def _engine(pcfg, **kw):
    return PagedBatchedDecodeEngine(pcfg, device="cpu",
                                    **{**ENGINE_KW, **kw})


def _reqs():
    return [
        dict(prompt=_prompt(5, 1), max_new_tokens=8, temperature=0.9,
             seed=21, top_k=13),
        dict(prompt=_prompt(7, 2), max_new_tokens=6),
    ]


def _greedy_reqs():
    return [dict(prompt=_prompt(5, 1), max_new_tokens=8),
            dict(prompt=_prompt(7, 2), max_new_tokens=6),
            dict(prompt=_prompt(11, 3), max_new_tokens=5)]


# -- lifecycle: abort / deadlines / backpressure -----------------------------


def test_abort_mid_decode_spares_neighbour(weights):
    """JAX ``test_abort_mid_decode_spares_neighbour``: abort() on an
    ACTIVE row retires it ABORTED with its clean partial prefix; the
    neighbour finishes equal to an undisturbed run."""
    pcfg, params = weights[2], weights[3]
    reqs = _reqs()
    undisturbed = _engine(pcfg).run(params, reqs)
    eng = _engine(pcfg)
    r0 = eng.submit(**reqs[0])
    r1 = eng.submit(**reqs[1])
    eng.step(params)
    eng.step(params)
    warm = eng.compile_count()
    assert eng.abort(r0) is True
    res0 = eng.results[r0]
    assert res0.state == ABORTED and "mid-decode" in res0.reason
    tp, budget = len(reqs[0]["prompt"]), reqs[0]["max_new_tokens"]
    assert tp < len(res0.tokens) < tp + budget
    np.testing.assert_array_equal(
        res0.tokens, undisturbed[r0].tokens[: len(res0.tokens)]
    )
    out = eng.run(params)
    assert out[r1].state == DONE
    np.testing.assert_array_equal(out[r1].tokens, undisturbed[r1].tokens)
    assert eng.compile_count() == warm
    assert eng.abort(r0) is False
    with pytest.raises(KeyError, match="unknown rid"):
        eng.abort(999)


def test_abort_while_queued(weights):
    """JAX ``test_abort_while_queued``."""
    pcfg, params = weights[2], weights[3]
    eng = _engine(pcfg, slots=1)
    r0 = eng.submit(_prompt(5, 1), 4)
    r1 = eng.submit(_prompt(5, 2), 4)
    eng.step(params)
    assert eng.queued_rids() == [r1]
    assert eng.abort(r1) is True
    res = eng.results[r1]
    assert res.state == ABORTED and "queued" in res.reason
    np.testing.assert_array_equal(res.tokens, _prompt(5, 2))
    assert eng.run(params)[r0].state == DONE


def test_deadline_expires_queued_and_mid_decode(weights):
    """JAX ``test_deadline_expires_queued_and_mid_decode``."""
    pcfg, params = weights[2], weights[3]
    reqs = _reqs()
    undisturbed = _engine(pcfg).run(params, reqs)
    clock = VirtualClock()
    eng = _engine(pcfg, slots=1, clock=clock)
    r0 = eng.submit(**reqs[0], timeout_s=1.0)
    r1 = eng.submit(**reqs[1], timeout_s=0.5)
    eng.step(params)
    eng.step(params)
    clock.advance(2.0)
    done = eng.step(params)
    assert sorted(done) == [r0, r1]
    res0, res1 = eng.results[r0], eng.results[r1]
    assert res0.state == EXPIRED and "mid-decode" in res0.reason
    assert res1.state == EXPIRED and "queued" in res1.reason
    np.testing.assert_array_equal(
        res0.tokens, undisturbed[r0].tokens[: len(res0.tokens)]
    )
    np.testing.assert_array_equal(res1.tokens, reqs[1]["prompt"])
    assert not eng.has_work()


def test_bounded_queue_rejects_loudly(weights):
    """JAX ``test_bounded_queue_rejects_loudly``."""
    pcfg = weights[2]
    eng = _engine(pcfg, queue_limit=2)
    eng.submit(_prompt(4, 1), 2)
    eng.submit(_prompt(4, 2), 2)
    with pytest.raises(AdmissionQueueFull, match="queue_limit 2"):
        eng.submit(_prompt(4, 3), 2)
    with pytest.raises(ValueError, match="'reject' or 'block'"):
        _engine(pcfg, backpressure="bogus")
    with pytest.raises(ValueError, match="queue_limit must be >= 1"):
        _engine(pcfg, queue_limit=0)


def test_block_backpressure_drains_then_admits(weights):
    """JAX ``test_block_backpressure_drains_then_admits``."""
    pcfg, params = weights[2], weights[3]
    eng = _engine(pcfg, queue_limit=1, backpressure="block")
    r0 = eng.submit(_prompt(4, 1), 3)
    with pytest.raises(ValueError, match="needs params"):
        eng.submit(_prompt(4, 2), 3)
    r1 = eng.submit(_prompt(4, 2), 3, params=params)
    assert eng.queued_rids() == [r1] and r0 in eng.active_rids()
    out = eng.run(params)
    assert out[r0].state == DONE and out[r1].state == DONE


def test_block_backpressure_times_out(weights):
    """JAX ``test_block_backpressure_times_out``: permanent dispatch
    faults, the block policy gives up at block_timeout_s (the virtual
    clock driven by the retry backoff)."""
    pcfg, params = weights[2], weights[3]
    clock = VirtualClock()
    eng = _engine(
        pcfg, queue_limit=1, backpressure="block", clock=clock,
        sleep=clock.sleep, dispatch_retries=None, request_retries=10**6,
    )
    FaultInjector(seed=0, p_dispatch_error=1.0, clock=clock).install(eng)
    eng.submit(_prompt(4, 1), 3)
    with pytest.raises(AdmissionQueueFull, match="not draining"):
        eng.submit(_prompt(4, 2), 3, params=params, block_timeout_s=1.0)


# -- fault detection: non-finite logits --------------------------------------


def _poison(params):
    """Every float leaf times NaN (the port's tree of tensors)."""
    from pytorch_distributed_tpu_torch.utils import tree

    return tree.map_tree(lambda x: x * float("nan"), params)


def test_batched_engine_quarantines_then_fails_on_nan_params(weights):
    """JAX ``test_batched_engine_quarantines_then_fails_on_nan_params``:
    every request is quarantined once (a fresh re-prefill), reproduces,
    and retires FAILED with its clean prefix (the prompt alone)."""
    pcfg, params = weights[2], weights[3]
    eng = _engine(pcfg)
    reqs = [dict(prompt=_prompt(5, 1), max_new_tokens=4),
            dict(prompt=_prompt(7, 2), max_new_tokens=4)]
    out = eng.run(_poison(params), reqs)
    for rid, req in enumerate(reqs):
        assert out[rid].state == FAILED
        assert "quarantine retry" in out[rid].reason
        np.testing.assert_array_equal(out[rid].tokens, req["prompt"])
    assert eng.counters["nan_quarantines"] == 4
    assert not eng.has_work() and eng.pool.pages_in_use() == 0


def test_nan_quarantine_isolates_row(weights):
    """JAX ``test_nan_quarantine_isolates_row``: an injected transient
    poisoning of one row mid-decode quarantines that row (freed,
    re-prefilled from its clean prefix); it and its neighbour finish
    equal to an undisturbed run."""
    pcfg, params = weights[2], weights[3]
    reqs = _reqs()
    undisturbed = _engine(pcfg).run(params, reqs)
    eng = _engine(pcfg)
    warm = eng.warmup(params)
    FaultInjector([Fault(tick=3, kind="nan_row", row=0)]).install(eng)
    out = eng.run(params, reqs)
    assert eng.counters["nan_quarantines"] == 1
    for rid in (0, 1):
        assert out[rid].state == DONE
        np.testing.assert_array_equal(out[rid].tokens,
                                      undisturbed[rid].tokens)
    assert eng.compile_count() == warm


# -- recovery: dropped results, retry budgets, snapshot/replay ---------------


def test_dropped_result_recovers_token_equal(weights):
    """JAX ``test_dropped_result_recovers_token_equal``: drop_result fires
    after the forward wrote its K/V into the pool; the pool is reset and
    every in-flight row resumes from its clean prefix, token-equal to an
    undisturbed run."""
    pcfg, params = weights[2], weights[3]
    reqs = _reqs()
    undisturbed = _engine(pcfg).run(params, reqs)
    eng = _engine(pcfg)
    FaultInjector([Fault(tick=2, kind="drop_result")]).install(eng)
    out = eng.run(params, reqs)
    assert eng.counters["dispatch_failures"] == 1
    assert eng.counters["resumes"] == 2
    for rid in (0, 1):
        assert out[rid].state == DONE
        np.testing.assert_array_equal(out[rid].tokens,
                                      undisturbed[rid].tokens)
    assert eng.pool.pages_in_use() == 0


def test_dispatch_failure_resets_the_pool_and_the_prefix_cache(weights):
    """No page is trusted after a failed dispatch: the pool is reset and
    its prefix cache dropped, so a prompt whose prefix was cached before
    the failure prefills from scratch after it (no prefix hit), and the
    pages a dropped decode tick wrote are never read back."""
    pcfg, params = weights[2], weights[3]
    shared = _prompt(16, 9)
    first = dict(prompt=np.concatenate([shared, _prompt(2, 10)]),
                 max_new_tokens=3)
    second = dict(prompt=np.concatenate([shared, _prompt(3, 11)]),
                  max_new_tokens=3)
    ref = _engine(pcfg, max_len=32).run(params, [first, second])
    eng = _engine(pcfg, max_len=32)
    eng.run(params, [first])
    assert eng.pool.stats["prefix_queries"] >= 1
    cached = len(eng.pool.cached_page_ids())
    assert cached > 0  # the shared 16 tokens are cached
    FaultInjector([Fault(tick=eng._ticks + 2, kind="drop_result",
                         program="decode_step")]).install(eng)
    rid = eng.submit(**second)
    hits0 = eng.pool.stats["prefix_hits"]
    out = eng.run(params)
    assert eng.counters["dispatch_failures"] == 1
    assert len(eng.pool.cached_page_ids()) <= cached
    # One hit at the first admission; none at the re-admission after the
    # reset (the cache was dropped with the pool).
    assert eng.pool.stats["prefix_hits"] - hits0 == 1
    assert out[rid].state == DONE
    np.testing.assert_array_equal(out[rid].tokens, ref[1].tokens)


def test_request_retries_exhaustion_fails_request(weights):
    """JAX ``test_request_retries_exhaustion_fails_request``."""
    pcfg, params = weights[2], weights[3]
    eng = _engine(pcfg, request_retries=0)
    rid = eng.submit(_prompt(5, 1), 6)
    eng.step(params)
    FaultInjector([Fault(tick=2, kind="dispatch_error")]).install(eng)
    done = eng.step(params)
    assert done == [rid]
    res = eng.results[rid]
    assert res.state == FAILED and "fault-resume retries" in res.reason
    np.testing.assert_array_equal(res.tokens[:5], _prompt(5, 1))


def test_dispatch_retries_exhaustion_raises_consistent(weights):
    """JAX ``test_dispatch_retries_exhaustion_raises_consistent``:
    consecutive failures raise DispatchFailure with everything requeued;
    clearing the fault finishes every request token-equal to an
    undisturbed run; the exponential backoff shows on the virtual
    clock."""
    pcfg, params = weights[2], weights[3]
    reqs = _reqs()
    undisturbed = _engine(pcfg).run(params, reqs)
    clock = VirtualClock()
    eng = _engine(
        pcfg, dispatch_retries=2, request_retries=10, clock=clock,
        sleep=clock.sleep, retry_backoff_s=0.05,
    )
    inj = FaultInjector(seed=0, p_dispatch_error=1.0, clock=clock).install(
        eng)
    rids = [eng.submit(**r) for r in reqs]
    with pytest.raises(DispatchFailure, match="state is consistent"):
        while True:
            eng.step(params)
    assert inj.counts["dispatch_error"] == 3
    assert eng.active_rids() == []
    assert eng.queued_rids() == rids
    assert clock.now >= 0.05 + 0.10
    eng.set_fault_injector(None)
    out = eng.run(params)
    for rid in rids:
        assert out[rid].state == DONE
        np.testing.assert_array_equal(out[rid].tokens,
                                      undisturbed[rid].tokens)


def test_snapshot_replay_token_identical(weights):
    """JAX ``test_snapshot_replay_token_identical``: snapshot a busy
    engine, rebuild, restore, finish: every request (in flight, queued,
    sampled or greedy) ends token-identical to an uninterrupted run."""
    pcfg, params = weights[2], weights[3]
    reqs = _reqs() + [dict(prompt=_prompt(4, 3), max_new_tokens=5,
                           temperature=1.1, seed=31, top_p=0.9)]
    undisturbed = _engine(pcfg).run(params, reqs)
    eng = _engine(pcfg)
    rids = [eng.submit(**r) for r in reqs]
    eng.step(params)
    eng.step(params)
    snap = eng.snapshot()
    assert sorted(q.rid for q in snap.pending) == rids
    del eng
    eng2 = _engine(pcfg)
    eng2.restore(snap)
    out = eng2.run(params)
    assert sorted(out) == rids
    for rid in rids:
        assert out[rid].state == DONE
        np.testing.assert_array_equal(out[rid].tokens,
                                      undisturbed[rid].tokens)
    with pytest.raises(RuntimeError, match="fresh idle engine"):
        eng2.restore(snap)


def test_adopt_on_a_busy_engine_continues_token_identical(weights):
    """``adopt`` (the router's failover; JAX ``BatchedDecodeEngine.adopt``):
    a donor's in-flight and queued entries, sampled rows included, join a
    busy engine under fresh rids and finish token-identical; an entry
    that does not fit is refused before anything is queued."""
    pcfg, params = weights[2], weights[3]
    reqs = _reqs() + [dict(prompt=_prompt(6, 4), max_new_tokens=4)]
    undisturbed = _engine(pcfg).run(params, reqs)
    donor = _engine(pcfg)
    for r in reqs:
        donor.submit(**r)
    donor.step(params)
    donor.step(params)
    snap = donor.snapshot()
    busy = _engine(pcfg)
    own = busy.submit(_prompt(3, 5), 4)
    busy.step(params)
    big = _engine(pcfg, max_len=32)
    big.submit(_prompt(20, 6), 10)
    with pytest.raises(ValueError, match="max_len"):
        busy.adopt(snap.pending + big.snapshot().pending)
    assert busy.queued_rids() == []
    mapping = busy.adopt(snap.pending)
    assert sorted(mapping) == [0, 1, 2] and own not in mapping.values()
    out = busy.run(params)
    assert out[own].state == DONE
    for donor_rid, rid in mapping.items():
        assert out[rid].state == DONE
        np.testing.assert_array_equal(out[rid].tokens,
                                      undisturbed[donor_rid].tokens)


def test_run_guard_terminates_permanent_fault(weights):
    """JAX ``test_run_guard_terminates_permanent_fault``."""
    pcfg, params = weights[2], weights[3]
    clock = VirtualClock()
    eng = _engine(
        pcfg, dispatch_retries=None, request_retries=10**6, clock=clock,
        sleep=clock.sleep,
    )
    FaultInjector(seed=0, p_dispatch_error=1.0, clock=clock).install(eng)
    rid = eng.submit(_prompt(5, 1), 4)
    out = eng.run(params, max_ticks=7)
    assert out == {} and eng.has_work() and eng.queued_rids() == [rid]
    out = eng.run(params, timeout_s=5.0)
    assert out == {} and eng.has_work()
    assert clock.now >= 5.0


def test_only_injected_and_retryable_errors_are_recovered(weights):
    """A real error from the forward (not the injector's, not
    ``RETRYABLE_ERRORS``) propagates instead of being retried; CUDA
    out-of-memory is recovered like an injected failure."""
    pcfg, params = weights[2], weights[3]
    eng = _engine(pcfg)
    eng.submit(_prompt(5, 1), 4)
    real = eng._forward

    def broken(*a, **k):
        raise RuntimeError("illegal memory access")

    eng._forward = broken
    with pytest.raises(RuntimeError, match="illegal memory access"):
        eng.step(params)
    assert eng.counters["dispatch_failures"] == 0

    eng = _engine(pcfg)
    rid = eng.submit(_prompt(5, 1), 4)
    calls = []

    def oom_once(*a, **k):
        if not calls:
            calls.append(1)
            raise torch.cuda.OutOfMemoryError("CUDA out of memory")
        return real.__func__(eng, *a, **k)

    eng._forward = oom_once
    out = eng.run(params)
    assert eng.counters["dispatch_failures"] == 1
    assert out[rid].state == DONE


# -- the same faults through the JAX engine ----------------------------------


@pytest.mark.parametrize(
    "faults, kw",
    [
        ([("drop_result", 2, None)], {}),
        ([("dispatch_error", 3, "decode_step"),
          ("drop_result", 5, "prefill")], {}),
        ([("dispatch_error", 2, None)], dict(request_retries=0)),
        ([("nan_row", 3, None)], {}),
    ],
    ids=["drop_result", "dispatch_then_drop", "retries_exhausted",
         "nan_row"],
)
def test_recovery_matches_the_jax_engine(weights, faults, kw):
    """The same scripted faults on the same greedy requests through the
    JAX ``PagedBatchedDecodeEngine`` and the port's: the same terminal
    states, reasons and tokens, and the same fault counters."""
    jcfg, jparams, pcfg, params = weights
    outs = []
    for mod, eng in (
        (jchaos, JaxEngine(jcfg, paged_attention="gather", **ENGINE_KW,
                           **kw)),
        (None, _engine(pcfg, **kw)),
    ):
        fault_cls = jchaos.Fault if mod else Fault
        inj_cls = jchaos.FaultInjector if mod else FaultInjector
        inj_cls([fault_cls(tick=t, kind=k, program=p, row=0)
                 for k, t, p in faults]).install(eng)
        out = eng.run(jparams if mod else params, _greedy_reqs())
        outs.append((
            {rid: (r.state, r.reason, np.asarray(r.tokens).tolist())
             for rid, r in out.items()},
            {k: eng.counters[k] for k in ("dispatch_failures", "resumes",
                                          "nan_quarantines", "done",
                                          "failed")},
        ))
    assert outs[0] == outs[1]
    assert outs[1][1]["dispatch_failures"] + outs[1][1]["nan_quarantines"]


def test_dispatch_retries_exhaustion_matches_the_jax_engine(weights):
    """``dispatch_retries`` exhaustion in both engines: DispatchFailure,
    the same queued rids, the same retry charges; then the same tokens
    once the fault clears."""
    jcfg, jparams, pcfg, params = weights
    outs = []
    for jax_side in (True, False):
        clock = (jchaos if jax_side else __import__(
            "pytorch_distributed_tpu_torch.serving.chaos",
            fromlist=["VirtualClock"])).VirtualClock()
        kw = dict(dispatch_retries=1, request_retries=5, clock=clock,
                  sleep=clock.sleep, retry_backoff_s=0.01, **ENGINE_KW)
        eng = (JaxEngine(jcfg, paged_attention="gather", **kw) if jax_side
               else PagedBatchedDecodeEngine(pcfg, device="cpu", **kw))
        p = jparams if jax_side else params
        inj_cls = jchaos.FaultInjector if jax_side else FaultInjector
        fault_cls = jchaos.Fault if jax_side else Fault
        inj_cls([fault_cls(tick=t, kind="dispatch_error") for t in (3, 4)],
                clock=clock).install(eng)
        rids = [eng.submit(**r) for r in _greedy_reqs()]
        raised = None
        try:
            while eng.has_work():
                eng.step(p)
        except Exception as err:  # noqa: BLE001 — compared below
            raised = type(err).__name__
        state = (raised, eng.queued_rids(), eng.active_rids(),
                 [q.retries for q in eng._queue], round(clock.now, 9))
        eng.set_fault_injector(None)
        out = eng.run(p)
        outs.append((state, {r: np.asarray(out[r].tokens).tolist()
                             for r in rids}))
    assert outs[0] == outs[1]
    assert outs[1][0][0] == "DispatchFailure"


# -- harness plumbing --------------------------------------------------------


def test_lifecycle_and_fault_vocabulary_validate():
    """JAX ``test_lifecycle_and_fault_vocabulary_validate``."""
    with pytest.raises(ValueError, match="state must be one of"):
        RequestResult(rid=0, state="BOGUS", tokens=np.zeros(1, np.int32))
    with pytest.raises(ValueError, match="unknown fault kind"):
        Fault(tick=1, kind="bogus")
    with pytest.raises(ValueError, match="VirtualClock"):
        inj = FaultInjector([Fault(tick=1, kind="slow_tick", seconds=1.0)])
        inj.on_tick(1)
    clock = VirtualClock()
    inj = FaultInjector(
        [Fault(tick=1, kind="slow_tick", seconds=2.5)], clock=clock
    )
    inj.on_tick(1)
    assert clock.now == 2.5 and inj.counts["slow_tick"] == 1


@pytest.mark.parametrize("seed", [0, 7])
def test_seeded_schedule_equals_the_jax_injector(seed):
    """The port's ``FaultInjector`` and ``RouterFaultInjector`` draw the
    same seeded schedule as the JAX package's over the same ticks."""
    from pytorch_distributed_tpu_torch.serving import chaos as pchaos

    def fired(mod):
        clock = mod.VirtualClock()
        inj = mod.FaultInjector(seed=seed, p_dispatch_error=0.3,
                                p_drop_result=0.2, p_nan_row=0.1,
                                p_slow_tick=0.25, clock=clock)
        log = []
        for tick in range(1, 60):
            inj.on_tick(tick)
            log.append((tick, sorted(f.kind for f in inj._armed), clock.now))
        kill = mod.RouterFaultInjector(
            [mod.RouterFault(tick=3, kind="replica_kill")], seed=seed,
            p_replica_kill=0.2)
        kills = []
        for tick in range(1, 40):
            kill.on_tick(tick)
            kills.append(kill.pop_kill([0, 1, 2, 3]))
        return log, dict(inj.counts), kills, dict(kill.counts)

    assert fired(pchaos) == fired(jchaos)


def test_lifecycle_log_is_diagnosable(weights):
    """JAX ``test_lifecycle_log_is_diagnosable``: submit -> admit ->
    retire with rid and timestamps, and the fault events."""
    pcfg, params = weights[2], weights[3]
    eng = _engine(pcfg)
    events: list[str] = []
    handler = logging.Handler()
    handler.emit = lambda r: events.append(r.getMessage())
    lg = logging.getLogger("pdtpu.serving")
    lg.addHandler(handler)
    old_level = lg.level
    lg.setLevel(logging.DEBUG)
    try:
        rid = eng.submit(_prompt(5, 1), 2, timeout_s=9.0)
        FaultInjector([Fault(tick=1, kind="drop_result")]).install(eng)
        eng.run(params)
    finally:
        lg.removeHandler(handler)
        lg.setLevel(old_level)
    assert any(m.startswith("event=submit") and f"rid={rid}" in m
               and "deadline=" in m for m in events)
    assert any(m.startswith("event=admit") and f"rid={rid}" in m
               for m in events)
    assert any(m.startswith("event=dispatch_fail") and "kind=prefill" in m
               for m in events)
    assert any(m.startswith("event=retire") and f"rid={rid}" in m
               and "state=DONE" in m for m in events)


@pytest.mark.parametrize("quant", [{}, dict(kv_quant="int8",
                                            weight_quant="int8")],
                         ids=["f32", "int8"])
def test_no_page_content_is_read_after_a_dropped_result(weights, quant):
    """drop_result after a decode forward wrote its K/V, the whole pool
    then overwritten with garbage (a failed dispatch may leave pages
    half-written): recovery resets the pool and its prefix cache and
    re-prefills every row, so the tokens equal a fault-free run and no
    garbage is ever read."""
    pcfg, params = weights[2], weights[3]

    class Trash(FaultInjector):
        def after_dispatch(self, kind, tick, tok, bad):
            if kind == "decode_step" and tick == 6:
                for pool in self._engine._cache.values():
                    pool.fill_(1e3 if pool.is_floating_point() else 77)
            return super().after_dispatch(kind, tick, tok, bad)

    shared = _prompt(16, 12)
    reqs = [dict(prompt=np.concatenate([shared, _prompt(k, 13 + k)]),
                 max_new_tokens=6) for k in (2, 3, 5)]
    want = _engine(pcfg, max_len=32, **quant).run(params, reqs)
    eng = _engine(pcfg, max_len=32, **quant)
    Trash([Fault(tick=6, kind="drop_result",
                 program="decode_step")]).install(eng)
    out = eng.run(params, reqs)
    assert eng.counters["dispatch_failures"] == 1
    assert eng.counters["nan_quarantines"] == 0
    for rid, res in want.items():
        assert out[rid].state == DONE
        np.testing.assert_array_equal(out[rid].tokens, res.tokens)
