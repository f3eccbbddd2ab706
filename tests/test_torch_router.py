"""The port's replica router (``serving/router``) and load generator twin
(``serving/loadgen``) on the CPU.

Held exactly to the JAX package: a greedy fleet with a scripted replica
kill through the port's ``ReplicaRouter`` is token-equal to the JAX
``ReplicaRouter`` over JAX ``PagedBatchedDecodeEngine`` replicas on the
same schedule, with equal ``routed``, ``failovers`` and
``failover_requests`` counters. The other tests port
``tests/test_router.py`` case by case (each docstring names its JAX
test) onto the port's paged engines, holding failover, drain and restart
to a fault-free single-engine reference, sampled rows included (the
port's sampling is a pure function of (seed, token index), so a resumed
row draws the same tokens on any replica).
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
from pytorch_distributed_tpu.serving.router import (
    ReplicaRouter as JaxRouter,
)
from pytorch_distributed_tpu_torch import interop
from pytorch_distributed_tpu_torch.config import ModelConfig
from pytorch_distributed_tpu_torch.serving import loadgen
from pytorch_distributed_tpu_torch.serving.chaos import (
    Fault,
    FaultInjector,
    RouterFault,
    RouterFaultInjector,
    VirtualClock,
)
from pytorch_distributed_tpu_torch.serving.engine import (
    PagedBatchedDecodeEngine,
)
from pytorch_distributed_tpu_torch.serving.lifecycle import (
    DONE,
    RouterOverloaded,
)
from pytorch_distributed_tpu_torch.serving.router import (
    DEGRADED,
    DOWN,
    DRAINED,
    HEALTHY,
    ReplicaRouter,
)
from pytorch_distributed_tpu_torch.serving.workload import (
    request_stream,
    tick_bursts,
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


def _factory(pcfg, clock, **kw):
    kw = {**ENGINE_KW, "retry_backoff_s": 0.0, **kw}

    def make_engine(rep_id):
        return PagedBatchedDecodeEngine(pcfg, device="cpu", clock=clock,
                                        sleep=clock.sleep, **kw)

    return make_engine


def _reqs(n=6, seed=11, greedy=False):
    kw = dict(sampling_cycle=(dict(),)) if greedy else {}
    return request_stream(
        np.random.default_rng(seed), n=n, vocab_size=97, prompt_len=(3, 8),
        max_new=(3, 6), key_seed=seed, **kw,
    )


def _reference(pcfg, params, reqs):
    """The fault-free reference: one engine, the same requests; outputs
    depend only on (request, params), never on placement."""
    eng = PagedBatchedDecodeEngine(pcfg, device="cpu", **ENGINE_KW)
    rid_to_idx = {eng.submit(**req): i for i, req in enumerate(reqs)}
    eng.run(params)
    return {rid_to_idx[rid]: np.asarray(eng.pop_result(rid).tokens)
            for rid in list(eng.results)}


def _drain_checked(router, params):
    """Run to idle; no rid may be reported terminal twice."""
    seen: set[int] = set()
    while router.has_work():
        done = router.step(params)
        assert not set(done) & seen
        seen.update(done)
    return seen


# -- held to the JAX router --------------------------------------------------


@pytest.mark.parametrize("kill_tick, n_req", [(3, 8), (5, 7)])
def test_scripted_kill_matches_the_jax_router(weights, kill_tick, n_req):
    """The same greedy stream and scripted kill through the JAX router
    (JAX paged engines, gather attention) and the port's: every result
    token-equal under the same router rid, and the same counters."""
    jcfg, jparams, pcfg, params = weights
    reqs = _reqs(n_req, seed=21 + kill_tick, greedy=True)
    runs = []
    for jax_side in (True, False):
        mod_clock = jchaos.VirtualClock() if jax_side else VirtualClock()
        if jax_side:
            def make(rep_id, clock=mod_clock):
                return JaxEngine(jcfg, paged_attention="gather",
                                 clock=clock, sleep=clock.sleep,
                                 retry_backoff_s=0.0, **ENGINE_KW)
            router = JaxRouter(make, 2, clock=mod_clock)
            jchaos.RouterFaultInjector([jchaos.RouterFault(
                tick=kill_tick, kind="replica_kill", row=0)]).install(router)
        else:
            router = ReplicaRouter(_factory(pcfg, mod_clock), 2,
                                   clock=mod_clock)
            RouterFaultInjector([RouterFault(
                tick=kill_tick, kind="replica_kill", row=0)]).install(router)
        p = jparams if jax_side else params
        rids = [router.submit(**r) for r in reqs]
        router.run(p)
        runs.append((
            {rid: (router.results[rid].state,
                   np.asarray(router.results[rid].tokens).tolist())
             for rid in rids},
            {k: router.counters[k] for k in ("routed", "shed", "failovers",
                                             "failover_requests")},
            router.replica_states(),
        ))
    assert runs[0] == runs[1]
    assert runs[1][1]["failovers"] == 1
    assert runs[1][1]["failover_requests"] >= 1


# -- routing and admission ---------------------------------------------------


def test_stats_schema_carries_the_router_signals(weights):
    """JAX ``test_stats_schema_uniform_across_engines`` (the paged
    engine's part): the keys the router scores on, and occupancy that
    tracks the scheduler."""
    pcfg, params = weights[2], weights[3]
    eng = PagedBatchedDecodeEngine(pcfg, device="cpu", **ENGINE_KW)
    st = eng.stats()
    for key in ("slots", "queue_depth", "active_rows", "free_slots",
                "pool_pages", "free_pages", "pages_in_use",
                "session_pinned_pages", "device_ids", "counters"):
        assert key in st
    assert st["free_pages"] == eng.pool_pages - 1
    assert st["device_ids"] == [0]
    for seed in (1, 2, 3):
        eng.submit(_prompt(4, seed), 3)
    st = eng.stats()
    assert st["queue_depth"] == 3 and st["active_rows"] == 0
    eng.step(params)
    st = eng.stats()
    assert st["active_rows"] == 2 and st["free_slots"] == 0
    assert st["queue_depth"] == 1


def test_routing_spreads_by_load(weights):
    """JAX ``test_routing_spreads_by_load``."""
    pcfg, params = weights[2], weights[3]
    clock = VirtualClock()
    router = ReplicaRouter(_factory(pcfg, clock), 2, clock=clock)
    for req in _reqs(4):
        router.submit(**req)
    by_replica = {0: 0, 1: 0}
    for rep_id, _erid in router._assign.values():
        by_replica[rep_id] += 1
    assert by_replica == {0: 2, 1: 2}
    router.run(params)
    assert len(router.results) == 4


def test_page_pressure_excludes_starved_replica(weights):
    """JAX ``test_page_pressure_excludes_starved_replica``."""
    pcfg = weights[2]
    clock = VirtualClock()
    router = ReplicaRouter(_factory(pcfg, clock, max_len=32, pool_pages=9),
                           2, clock=clock)
    r0 = router._replicas[0]
    taken = r0.engine.pool.alloc(r0.engine.pool.free_pages())
    assert r0.engine.pool.free_pages() == 0
    rid = router.submit(_prompt(4, 1), 2)
    assert router._assign[rid][0] == 1
    r0.engine.pool.release(taken)
    rid2 = router.submit(_prompt(4, 2), 2)
    assert router._assign[rid2][0] == 0


def test_shed_rejects_loudly_with_retry_after(weights):
    """JAX ``test_shed_rejects_loudly_with_retry_after``."""
    pcfg, params = weights[2], weights[3]
    clock = VirtualClock()
    router = ReplicaRouter(_factory(pcfg, clock), 2, clock=clock,
                           shed_queue_depth=2)
    reqs = _reqs(10, seed=3)
    accepted, shed = [], 0
    for req in reqs:
        try:
            accepted.append(router.submit(**req))
        except RouterOverloaded as err:
            shed += 1
            assert err.retry_after_s is not None and err.retry_after_s > 0
    assert len(accepted) == 4 and shed == 6
    assert router.counters["shed"] == 6
    router.run(params)
    rid = router.submit(**reqs[0])
    assert rid in router._assign


def test_tenants_are_refused_with_the_reason(weights):
    """A tenant on a fleet without adapters, and an unregistered tenant on
    a fleet with them, are refused with ``ValueError`` naming the reason,
    as the JAX router refuses them; nothing is routed."""
    from pytorch_distributed_tpu_torch.serving.adapters import (
        AdapterRegistry,
    )

    pcfg = weights[2]
    clock = VirtualClock()
    router = ReplicaRouter(_factory(pcfg, clock), 1, clock=clock)
    with pytest.raises(ValueError, match="adapter registry"):
        router.submit(_prompt(3, 1), 2, tenant="a")
    reg = AdapterRegistry(pcfg, rank=2, max_tenants=1)
    reg.register("b", seed=0)
    tenanted = ReplicaRouter(_factory(pcfg, clock, adapters=reg), 1,
                             clock=clock)
    with pytest.raises(ValueError, match="unregistered tenant 'a'"):
        tenanted.submit(_prompt(3, 1), 2, tenant="a")
    assert router.counters["routed"] == tenanted.counters["routed"] == 0


# -- failover -----------------------------------------------------------------


def test_replica_kill_failover_bit_identity(weights):
    """JAX ``test_replica_kill_failover_bit_identity``: kill one of two
    replicas mid-decode; every request, greedy and sampled, ends DONE and
    token-identical to a fault-free run; no rid lost or duplicated; no
    compile on the survivor."""
    pcfg, params = weights[2], weights[3]
    reqs = _reqs(8, seed=21)
    assert any("seed" in r for r in reqs) and any("seed" not in r
                                                  for r in reqs)
    ref = _reference(pcfg, params, reqs)
    clock = VirtualClock()
    router = ReplicaRouter(_factory(pcfg, clock), 2, clock=clock)
    router.warmup(params)
    RouterFaultInjector(
        faults=[RouterFault(tick=3, kind="replica_kill", row=0)],
    ).install(router)
    rids = {router.submit(**req): i for i, req in enumerate(reqs)}
    _drain_checked(router, params)
    assert router.replica_states() == {0: DOWN, 1: HEALTHY}
    assert router.counters["failovers"] == 1
    assert router.counters["failover_requests"] >= 1
    assert set(router.results) == set(rids)
    for rid, idx in rids.items():
        res = router.pop_result(rid)
        assert res.state == DONE and res.rid == rid
        np.testing.assert_array_equal(res.tokens, ref[idx])
    assert router.steady_compiles()[1] == 0


def test_dispatch_failure_takes_replica_down(weights):
    """JAX ``test_dispatch_failure_takes_replica_down``."""
    pcfg, params = weights[2], weights[3]
    reqs = _reqs(6, seed=33)
    ref = _reference(pcfg, params, reqs)
    clock = VirtualClock()
    router = ReplicaRouter(_factory(pcfg, clock, dispatch_retries=0), 2,
                           clock=clock)
    router.warmup(params)
    FaultInjector(faults=[Fault(tick=2, kind="dispatch_error")],
                  clock=clock).install(router._replicas[0].engine)
    rids = {router.submit(**req): i for i, req in enumerate(reqs)}
    router.run(params)
    assert router.replica_states()[0] == DOWN
    assert "dispatch failure" in router._replicas[0].down_reason
    assert set(router.results) == set(rids)
    for rid, idx in rids.items():
        res = router.pop_result(rid)
        assert res.state == DONE
        np.testing.assert_array_equal(res.tokens, ref[idx])
    assert router.steady_compiles()[1] == 0


def test_total_fleet_loss_parks_and_recovers(weights):
    """JAX ``test_total_fleet_loss_parks_and_recovers``."""
    pcfg, params = weights[2], weights[3]
    reqs = _reqs(4, seed=44)
    ref = _reference(pcfg, params, reqs)
    clock = VirtualClock()
    router = ReplicaRouter(_factory(pcfg, clock), 2, clock=clock)
    router.warmup(params)
    rids = {router.submit(**req): i for i, req in enumerate(reqs)}
    router.step(params)
    router.kill(0)
    router.kill(1)
    assert router.replica_states() == {0: DOWN, 1: DOWN}
    assert router.stats()["orphans"] > 0
    with pytest.raises(RouterOverloaded):
        router.submit(_prompt(4, 9), 2)
    router.restart(1, params)
    router.run(params)
    assert set(router.results) == set(rids)
    for rid, idx in rids.items():
        res = router.pop_result(rid)
        assert res.state == DONE
        np.testing.assert_array_equal(res.tokens, ref[idx])


def test_abort_of_a_parked_orphan(weights):
    """An orphan (no live replica) aborts with its clean prefix; the rest
    re-adopt on restart."""
    pcfg, params = weights[2], weights[3]
    clock = VirtualClock()
    router = ReplicaRouter(_factory(pcfg, clock), 1, clock=clock)
    rids = [router.submit(**req) for req in _reqs(3, seed=45)]
    router.step(params)
    router.kill(0)
    assert router.abort(rids[0]) is True
    assert router.results[rids[0]].state == "ABORTED"
    assert router.abort(rids[0]) is False
    assert router.progress(rids[1]) is not None
    router.restart(0, params)
    router.run(params)
    assert {router.results[r].state for r in rids[1:]} == {DONE}
    with pytest.raises(KeyError):
        router.abort(999)


# -- drain / restart ----------------------------------------------------------


def test_drain_restart_rides_snapshot_restore(weights):
    """JAX ``test_drain_restart_rides_snapshot_restore``."""
    pcfg, params = weights[2], weights[3]
    reqs = _reqs(6, seed=55)
    ref = _reference(pcfg, params, reqs)
    clock = VirtualClock()
    router = ReplicaRouter(_factory(pcfg, clock), 2, clock=clock)
    router.warmup(params)
    rids = {router.submit(**req): i for i, req in enumerate(reqs)}
    router.step(params)
    assert router.drain(0) > 0
    assert router.replica_states()[0] == DRAINED
    rid_extra = router.submit(_prompt(5, 71), 3)
    assert router._assign[rid_extra][0] == 1
    router.step(params)
    router.restart(0, params)
    assert router.replica_states()[0] == HEALTHY
    router.run(params)
    assert set(rids) <= set(router.results)
    for rid, idx in rids.items():
        res = router.pop_result(rid)
        assert res.state == DONE and res.rid == rid
        np.testing.assert_array_equal(res.tokens, ref[idx])
    assert router.counters["drains"] == 1


def test_kill_after_drain_neither_loses_nor_duplicates(weights):
    """JAX ``test_kill_after_drain_neither_loses_nor_duplicates``."""
    pcfg, params = weights[2], weights[3]
    reqs = _reqs(6, seed=91)
    ref = _reference(pcfg, params, reqs)
    clock = VirtualClock()
    router = ReplicaRouter(_factory(pcfg, clock), 2, clock=clock)
    router.warmup(params)
    rids = {router.submit(**req): i for i, req in enumerate(reqs)}
    router.step(params)
    aborted_rid, aborted_erid = next(
        (rid, erid) for rid, (rep, erid) in router._assign.items()
        if rep == 0
    )
    router._replicas[0].engine.abort(aborted_erid)
    router.step(params)
    router.drain(0)
    assert router.results[aborted_rid].state == "ABORTED"
    router.kill(0, reason="died while drained")
    router.run(params)
    assert set(router.results) == set(rids)
    for rid, idx in rids.items():
        res = router.pop_result(rid)
        assert res.rid == rid
        if rid == aborted_rid:
            continue
        assert res.state == DONE
        np.testing.assert_array_equal(res.tokens, ref[idx])


def test_abort_on_drained_replica_not_resurrected(weights):
    """JAX ``test_abort_on_drained_replica_not_resurrected``."""
    pcfg, params = weights[2], weights[3]
    reqs = _reqs(5, seed=96)
    clock = VirtualClock()
    router = ReplicaRouter(_factory(pcfg, clock), 2, clock=clock)
    router.warmup(params)
    rids = {router.submit(**req): i for i, req in enumerate(reqs)}
    router.step(params)
    router.drain(0)
    on_drained = [rid for rid, (rep, _e) in router._assign.items()
                  if rep == 0]
    assert on_drained
    victim = on_drained[0]
    assert router.abort(victim) is True
    assert router.results[victim].state == "ABORTED"
    router.restart(0, params)
    router.run(params)
    assert set(router.results) == set(rids)
    for rid in rids:
        res = router.pop_result(rid)
        assert res.state == ("ABORTED" if rid == victim else DONE)


def test_drain_migrate_hands_work_to_survivors(weights):
    """JAX ``test_drain_migrate_hands_work_to_survivors``."""
    pcfg, params = weights[2], weights[3]
    reqs = _reqs(6, seed=66)
    ref = _reference(pcfg, params, reqs)
    clock = VirtualClock()
    router = ReplicaRouter(_factory(pcfg, clock), 2, clock=clock)
    router.warmup(params)
    rids = {router.submit(**req): i for i, req in enumerate(reqs)}
    router.step(params)
    router.drain(0, migrate=True)
    assert router.replica_states()[0] == DOWN
    with pytest.raises(RuntimeError, match="drain needs a routable"):
        router.drain(0)
    router.run(params)
    assert set(router.results) == set(rids)
    for rid, idx in rids.items():
        np.testing.assert_array_equal(router.pop_result(rid).tokens,
                                      ref[idx])
    with pytest.raises(RuntimeError, match="restart needs"):
        router.restart(1, params)


# -- brown-out ----------------------------------------------------------------


def test_slow_replica_degrades_and_recovers(weights):
    """JAX ``test_slow_replica_degrades_and_recovers``."""
    pcfg, params = weights[2], weights[3]
    clock = VirtualClock()
    router = ReplicaRouter(_factory(pcfg, clock), 2, clock=clock,
                           shed_queue_depth=64)
    FaultInjector(p_slow_tick=1.0, slow_tick_s=1.0, seed=0,
                  clock=clock).install(router._replicas[0].engine)
    for req in _reqs(4, seed=77):
        router.submit(**req)
    router.step(params)
    router.step(params)
    assert router.replica_states()[0] == DEGRADED
    assert router.replica_states()[1] == HEALTHY
    fresh = [router.submit(**r) for r in _reqs(3, seed=78)]
    assert all(router._assign[rid][0] == 1 for rid in fresh)
    router._replicas[0].engine.set_fault_injector(None)
    deep = request_stream(
        np.random.default_rng(9), n=2, vocab_size=97, prompt_len=(3, 4),
        max_new=12, key_seed=9,
    )
    for r in deep:
        router.submit(**r)
    router.run(params)
    assert router.replica_states()[0] == HEALTHY
    assert router.counters["shed"] == 0


# -- the router log -----------------------------------------------------------


def test_router_log_vocabulary(weights):
    """JAX ``test_router_log_vocabulary``."""
    pcfg, params = weights[2], weights[3]
    clock = VirtualClock()
    router = ReplicaRouter(_factory(pcfg, clock), 2, clock=clock,
                           shed_queue_depth=1)
    router.warmup(params)
    events: list[str] = []
    handler = logging.Handler()
    handler.emit = lambda r: events.append(r.getMessage())
    lg = logging.getLogger("pdtpu.serving")
    lg.addHandler(handler)
    old_level = lg.level
    lg.setLevel(logging.DEBUG)
    try:
        rids = []
        for req in _reqs(8, seed=88):
            try:
                rids.append(router.submit(**req))
            except RouterOverloaded:
                pass
        router.step(params)
        router.kill(0, reason="test storm")
        router.step(params)
        router.restart(0, params)
        router.drain(0)
        router.restart(0, params)
        router.run(params)
    finally:
        lg.removeHandler(handler)
        lg.setLevel(old_level)
    assert any(m.startswith("event=route") and f"rid={rids[0]}" in m
               and "replica=" in m for m in events)
    assert any(m.startswith("event=shed") for m in events)
    assert any(m.startswith("event=replica_down") and "replica=0" in m
               and "reason=test" in m for m in events)
    assert any(m.startswith("event=failover") and "from_replica=0" in m
               and "to_replica=1" in m for m in events)
    assert any(m.startswith("event=drain") for m in events)
    assert any(m.startswith("event=replica_up") and "replica=0" in m
               for m in events)


# -- the storm ------------------------------------------------------------------


def test_router_replica_storm_matrix(weights):
    """JAX ``test_router_replica_storm_matrix`` (fewer requests): seeded
    kills and restarts, per-replica dispatch faults and bursty arrivals
    over 3 replicas; every rid terminal exactly once, DONE outputs equal
    to the fault-free reference, sampled rows included."""
    pcfg, params = weights[2], weights[3]
    n_req = 24
    reqs = _reqs(n_req, seed=5)
    ref = _reference(pcfg, params, reqs)
    clock = VirtualClock()
    router = ReplicaRouter(_factory(pcfg, clock), 3, clock=clock,
                           shed_queue_depth=16)
    router.warmup(params)
    storm = RouterFaultInjector(
        faults=[RouterFault(tick=4, kind="replica_kill")],
        seed=9, p_replica_kill=0.04,
    ).install(router)
    FaultInjector(seed=10, p_dispatch_error=0.05, clock=clock).install(
        router._replicas[1].engine)
    bursts = tick_bursts(np.random.default_rng(123), 2)
    rids: dict[int, int] = {}
    next_req = tick = 0
    restart_due: dict[int, int] = {}
    while (next_req < n_req or router.has_work()) and tick < 3000:
        tick += 1
        for rep_id, due in list(restart_due.items()):
            if tick >= due:
                del restart_due[rep_id]
                router.restart(rep_id, params)
        for _ in range(min(bursts[tick % len(bursts)], n_req - next_req)):
            try:
                rids[router.submit(**reqs[next_req])] = next_req
                next_req += 1
            except RouterOverloaded:
                break
        if router.has_work():
            router.step(params)
        for rep_id, state in router.replica_states().items():
            if state == DOWN and rep_id not in restart_due:
                restart_due[rep_id] = tick + 10
    assert tick < 3000 and next_req == n_req
    assert set(router.results) == set(rids)
    assert storm.counts["replica_kill"] >= 1
    for rid, idx in rids.items():
        res = router.pop_result(rid)
        assert res.state == DONE, (rid, res.state, res.reason)
        np.testing.assert_array_equal(res.tokens, ref[idx])
    assert router.counters["failovers"] >= 1


def test_parallel_step_matches_the_reference(weights):
    """``parallel_step`` (busy replicas stepped on concurrent host
    threads, for replicas on separate cards): with a kill mid-stream
    every request still ends DONE, once, token-identical to the
    fault-free reference."""
    pcfg, params = weights[2], weights[3]
    reqs = _reqs(10, seed=71)
    ref = _reference(pcfg, params, reqs)
    clock = VirtualClock()
    router = ReplicaRouter(_factory(pcfg, clock), 3, clock=clock,
                           parallel_step=True, shed_queue_depth=16)
    RouterFaultInjector([RouterFault(tick=4, kind="replica_kill",
                                     row=1)]).install(router)
    rids = {router.submit(**req): i for i, req in enumerate(reqs)}
    seen = _drain_checked(router, params)
    assert seen == set(rids) and router.counters["failovers"] == 1
    for rid, idx in rids.items():
        res = router.pop_result(rid)
        assert res.state == DONE
        np.testing.assert_array_equal(res.tokens, ref[idx])


# -- the load generator twin ------------------------------------------------------


def test_loadgen_dryrun_storm_equals_clean_greedy_and_sampled():
    """The loadgen twin's ``--dryrun`` on the CPU: its invariants hold
    (no lost or duplicated rid, every clean request DONE, kills fired),
    and the storm legs' DONE outputs — greedy and sampled rows alike —
    equal the clean legs' token for token."""
    args = loadgen.parse_args(["--dryrun", "--device", "cpu"])
    report = loadgen.run_loadgen(args)
    assert report["ok"], report["invariant_failures"]
    assert report["placement"] == "colocated on cpu"
    assert not report["parallel_step"]
    reqs = request_stream(np.random.default_rng(0), n=args.requests,
                          vocab_size=256, prompt_len=(4, args.max_len // 3),
                          max_new=args.max_new, key_seed=0)
    assert any("seed" in r for r in reqs)
    for row in report["curve"]:
        assert row["storm"]["failovers"] >= 1
        assert row["storm"]["done_outputs_match_clean"] == "12/12"
        assert row["clean"]["done"] == 12 and not row["storm"]["mismatches"]
        assert row["clean"]["steady_compiles"] == 0


def test_loadgen_refuses_what_the_port_lacks():
    with pytest.raises(SystemExit, match="cpu-devices"):
        loadgen.parse_args(["--cpu-devices", "8"])
