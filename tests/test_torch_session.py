"""Multi-turn sessions in the port (``serving/session``, the engine's
session hooks, the router's sticky routing and the server's
``/v1/session`` endpoints) on the CPU.

Held exactly to the JAX package: the same greedy session turns through
the JAX ``PagedBatchedDecodeEngine`` and the port's give the same
transcripts, prefix-cache economics, pins and evictions, and the port's
``session_stream`` draws the JAX generator's tails and budgets. The
others port the session cases of ``tests/test_serving_scenarios.py``
(each docstring names its JAX test).
"""

import asyncio
import json
import logging

import jax
import numpy as np
import pytest
import torch

from pytorch_distributed_tpu.config import ModelConfig as JaxModelConfig
from pytorch_distributed_tpu.models import gpt2 as jgpt2
from pytorch_distributed_tpu.serving import workload as jwl
from pytorch_distributed_tpu.serving.engine import (
    PagedBatchedDecodeEngine as JaxEngine,
)
from pytorch_distributed_tpu_torch import interop
from pytorch_distributed_tpu_torch.config import ModelConfig
from pytorch_distributed_tpu_torch.serving import workload as wl
from pytorch_distributed_tpu_torch.serving.chaos import Fault, FaultInjector
from pytorch_distributed_tpu_torch.serving.engine import (
    PagedBatchedDecodeEngine,
)
from pytorch_distributed_tpu_torch.serving.lifecycle import RouterOverloaded
from pytorch_distributed_tpu_torch.serving.router import ReplicaRouter
from pytorch_distributed_tpu_torch.serving.server import ServingServer
from pytorch_distributed_tpu_torch.serving.session import SessionTracker

CFG_KW = dict(
    vocab_size=97, n_ctx=128, n_embd=64, n_layer=2, n_head=4,
    dtype="float32", attn_pdrop=0.0, resid_pdrop=0.0, embd_pdrop=0.0,
)
PAGED_KW = dict(slots=2, max_len=32, page_size=4, prefill_chunk=4)


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


def _paged(pcfg, **kw):
    return PagedBatchedDecodeEngine(pcfg, device="cpu",
                                    **{**PAGED_KW, **kw})


def _run_turn(eng, params, sid, prompt, max_new, **kw):
    rid = eng.submit(prompt, max_new, session=sid, **kw)
    out = eng.run(params)
    assert out[rid].state == "DONE", out[rid]
    return np.asarray(out[rid].tokens)


class _events:
    def __enter__(self):
        self.lines: list[str] = []
        self._handler = logging.Handler()
        self._handler.emit = lambda r: self.lines.append(r.getMessage())
        self._lg = logging.getLogger("pdtpu.serving")
        self._old = self._lg.level
        self._lg.addHandler(self._handler)
        self._lg.setLevel(logging.DEBUG)
        return self

    def __exit__(self, *exc):
        self._lg.removeHandler(self._handler)
        self._lg.setLevel(self._old)

    def named(self, event):
        return [m for m in self.lines if m.startswith(f"event={event} ")]


# -- held to the JAX engine ----------------------------------------------------


@pytest.mark.parametrize("budget", [None, 12], ids=["default", "tight"])
def test_session_turns_match_the_jax_engine(weights, budget):
    """Two sessions, three greedy turns each, interleaved, through both
    engines: equal transcripts, prefix-cache hit economics, pinned pages
    and evictions (a tight pin budget evicts the longest-idle)."""
    jcfg, jparams, pcfg, params = weights
    outs = []
    for jax_side in (True, False):
        kw = dict(max_len=64, pool_pages=40,
                  session_pin_budget_pages=budget)
        eng = (JaxEngine(jcfg, paged_attention="gather", **{**PAGED_KW,
                                                            **kw})
               if jax_side else _paged(pcfg, **kw))
        p = jparams if jax_side else params
        sids = [eng.open_session(), eng.open_session()]
        trs = {sid: np.zeros((0,), np.int32) for sid in sids}
        log = []
        for turn in range(3):
            for k, sid in enumerate(sids):
                tail = _prompt(24 if turn == 0 else 4, 10 * turn + k)
                trs[sid] = _run_turn(eng, p, sid,
                                     np.concatenate([trs[sid], tail]), 3)
                log.append((trs[sid].tolist(), eng.pool.pinned_pages(),
                            eng.stats()["counters"]["session_evictions"]))
        outs.append((log, dict(eng._sessions.hit), eng._sessions.evictions,
                     eng.pool.stats["prefix_hits"]))
    assert outs[0] == outs[1]


def test_session_stream_equals_jax():
    """JAX ``test_session_stream_generator_deterministic``, held to the
    JAX generator: the same tails, budgets and sampling configs (the
    sampled turns carry the port's ``seed`` where JAX has a key)."""
    kw = dict(n_sessions=2, turns=3, vocab_size=97, open_len=(8, 12),
              turn_len=(2, 5), max_new=(2, 4), key_seed=4)
    port = wl.session_stream(np.random.default_rng(5), **kw)
    ref = jwl.session_stream(np.random.default_rng(5), **kw)
    again = wl.session_stream(np.random.default_rng(5), **kw)
    assert len(port) == 2 and all(len(s) == 3 for s in port)
    for a, b, c in zip(sum(port, []), sum(ref, []), sum(again, [])):
        np.testing.assert_array_equal(a["tail"], b["tail"])
        assert a["max_new_tokens"] == b["max_new_tokens"]
        assert ("seed" in a) == ("key" in b)
        assert {k: v for k, v in a.items() if k not in ("tail", "seed")} \
            == {k: v for k, v in b.items() if k not in ("tail", "key")}
        assert a.get("seed") == c.get("seed")


# -- the engine -------------------------------------------------------------------


def test_session_turns_hit_prefix_cache_and_match_one_shot(weights):
    """JAX ``test_session_turns_hit_prefix_cache_and_match_one_shot``."""
    pcfg, params = weights[2], weights[3]
    eng = _paged(pcfg, max_len=64, pool_pages=40)
    sid = eng.open_session()
    transcript = np.zeros((0,), np.int32)
    for turn, tail in enumerate([_prompt(40, 1), _prompt(4, 2),
                                 _prompt(4, 3)]):
        prompt = np.concatenate([transcript, tail])
        transcript = _run_turn(eng, params, sid, prompt, 4)
        ref = _paged(pcfg, max_len=64, pool_pages=40).run(
            params, [dict(prompt=prompt, max_new_tokens=4)])
        np.testing.assert_array_equal(transcript, ref[0].tokens,
                                      err_msg=f"turn {turn + 1}")
    assert eng._sessions.hit_rate() >= 0.9, eng._sessions.hit
    st = eng.stats()
    assert st["sessions"] == 1 and st["session_pinned_pages"] > 0
    eng.close_session(sid)
    assert eng.stats()["sessions"] == 0


def test_session_transcript_guards(weights):
    """JAX ``test_session_transcript_guards`` (the paged engine's part)."""
    pcfg, params = weights[2], weights[3]
    eng = _paged(pcfg, pool_pages=40)
    sid = eng.open_session()
    t1 = _run_turn(eng, params, sid, _prompt(8, 1), 3)
    with pytest.raises(ValueError, match="must EXTEND"):
        eng.submit(t1[:4], 2, session=sid)
    bad = np.concatenate([t1, _prompt(2, 2)])
    bad[3] = (bad[3] + 1) % 97
    with pytest.raises(ValueError, match="diverges .* at position 3"):
        eng.submit(bad, 2, session=sid)
    with pytest.raises(ValueError, match="unknown session id 77"):
        eng.submit(np.concatenate([t1, _prompt(2, 3)]), 2, session=77)
    with pytest.raises(ValueError, match="unknown session id 77"):
        eng.close_session(77)
    rid = eng.submit(np.concatenate([t1, _prompt(2, 4)]), 2, session=sid)
    with pytest.raises(ValueError, match="already has turn rid"):
        eng.submit(np.concatenate([t1, _prompt(3, 5)]), 2, session=sid)
    assert eng.run(params)[rid].state == "DONE"
    assert eng._next_rid == rid + 1  # a rejected turn burned no rid


def test_session_pins_survive_lru_pressure(weights):
    """JAX ``test_session_pins_survive_lru_pressure``."""
    pcfg, params = weights[2], weights[3]
    eng = _paged(pcfg, max_len=64, pool_pages=24)
    sid = eng.open_session()
    t1 = _run_turn(eng, params, sid, _prompt(40, 1), 4)
    pinned_before = eng.pool.pinned_pages()
    assert pinned_before > 0
    for i in range(4):
        out = eng.run(params, [dict(prompt=_prompt(36, 50 + i),
                                    max_new_tokens=2)])
        assert all(r.state == "DONE" for r in out.values())
    assert eng.pool.stats["evictions"] > 0
    assert eng.pool.pinned_pages() == pinned_before
    t2 = _run_turn(eng, params, sid, np.concatenate([t1, _prompt(4, 2)]), 3)
    assert eng._sessions.hit_rate() >= 0.9, eng._sessions.hit
    assert t2.shape[0] == t1.shape[0] + 4 + 3


def test_pin_budget_evicts_longest_idle_session_loudly(weights):
    """JAX ``test_pin_budget_evicts_longest_idle_session_loudly``."""
    pcfg, params = weights[2], weights[3]
    eng = _paged(pcfg, max_len=64, pool_pages=40,
                 session_pin_budget_pages=12)
    sid_a, sid_b = eng.open_session(), eng.open_session()
    with _events() as ev:
        ta = _run_turn(eng, params, sid_a, _prompt(32, 1), 4)
        tb = _run_turn(eng, params, sid_b, _prompt(32, 2), 4)
    assert eng._sessions.evictions == 1
    evicted = ev.named("session_evict")
    assert evicted and f"session={sid_a}" in evicted[0], evicted
    ta2 = _run_turn(eng, params, sid_a, np.concatenate([ta, _prompt(4, 3)]),
                    3)
    assert ta2.shape[0] == ta.shape[0] + 7
    assert len(eng._sessions) == 2
    assert tb.shape[0] == 32 + 4


def test_pin_budget_partial_shed_clamps_to_own_pins():
    """JAX ``test_pin_budget_partial_shed_clamps_to_own_pins``."""
    class _Pool:
        page_size = 4
        chunk_tokens = 8

        def __init__(self):
            self.pinned = []

        def pin(self, keys):
            self.pinned.extend(keys)

        def unpin(self, keys):
            for k in keys:
                self.pinned.remove(k)

    pool = _Pool()
    tr = SessionTracker(pool, pin_budget_pages=2, clock=lambda: 0.0)
    sid_a, sid_b = tr.open(), tr.open()
    tr._sessions[sid_a].pinned_keys = ["a0", "a1"]
    pool.pin(["a0", "a1"])
    tr.begin_turn(sid_a, rid=7)
    tr.on_turn_done(sid_b, np.arange(24, dtype=np.int32),
                    ["b0", "b1", "b2"])
    assert tr._sessions[sid_b].pinned_keys == []
    assert pool.pinned == ["a0", "a1"]
    with pytest.raises(ValueError, match="pin_budget_pages"):
        SessionTracker(pool, pin_budget_pages=-1, clock=lambda: 0.0)


def test_batch_never_breaks_session_pins(weights):
    """JAX ``test_batch_never_breaks_session_pins``."""
    pcfg, params = weights[2], weights[3]
    eng = _paged(pcfg, max_len=64, pool_pages=24, slots=1,
                 batch_admit_free_frac=0.0)
    sid = eng.open_session()
    _run_turn(eng, params, sid, _prompt(40, 1), 4)
    rid = eng.submit(_prompt(56, 2), 2, priority="batch")
    for _ in range(6):
        eng.step(params)
    assert rid in eng.queued_rids()
    assert eng._sessions.evictions == 0
    eng.close_session(sid)
    assert eng.run(params)[rid].state == "DONE"


def test_session_pins_break_before_allocation_deadlocks(weights):
    """JAX ``test_session_pins_break_before_allocation_deadlocks``."""
    pcfg, params = weights[2], weights[3]
    eng = _paged(pcfg, max_len=64, pool_pages=24, slots=1)
    sid = eng.open_session()
    _run_turn(eng, params, sid, _prompt(40, 1), 4)
    out = eng.run(params, [dict(prompt=_prompt(56, 2), max_new_tokens=2)])
    assert out[1].state == "DONE"
    assert eng._sessions.evictions == 1
    assert eng.counters["preemptions"] == 0


def test_queued_session_turns_not_stalled_by_unallocatable_head(weights):
    """JAX ``test_queued_session_turns_not_stalled_by_unallocatable_head``."""
    pcfg, params = weights[2], weights[3]
    eng = _paged(pcfg, max_len=64, pool_pages=24, slots=2,
                 session_pin_budget_pages=16)
    sa, sb = eng.open_session(), eng.open_session()
    ta = _run_turn(eng, params, sa, _prompt(20, 1), 4)
    tb = _run_turn(eng, params, sb, _prompt(20, 2), 4)
    assert eng.pool.pinned_pages() >= 10
    big = eng.submit(_prompt(56, 3), 2)
    ra = eng.submit(np.concatenate([ta, _prompt(4, 4)]), 2, session=sa)
    rb = eng.submit(np.concatenate([tb, _prompt(4, 5)]), 2, session=sb)
    for _ in range(200):
        if not eng.has_work():
            break
        eng.step(params)
    assert not eng.has_work()
    for r in (big, ra, rb):
        assert eng.results[r].state == "DONE", eng.results[r]


def test_dispatch_failure_drops_pins_and_keeps_the_transcript(weights):
    """A failed dispatch resets the pool: the session's pins go (no page
    is trusted), its transcript stays, and the next turn completes with
    the tokens of a one-shot run."""
    pcfg, params = weights[2], weights[3]
    eng = _paged(pcfg, max_len=64, pool_pages=40)
    sid = eng.open_session()
    t1 = _run_turn(eng, params, sid, _prompt(20, 1), 3)
    assert eng.pool.pinned_pages() > 0
    prompt = np.concatenate([t1, _prompt(4, 2)])
    FaultInjector([Fault(tick=eng._ticks + 2,
                         kind="dispatch_error")]).install(eng)
    t2 = _run_turn(eng, params, sid, prompt, 3)
    assert eng.counters["dispatch_failures"] == 1
    ref = _paged(pcfg, max_len=64, pool_pages=40).run(
        params, [dict(prompt=prompt, max_new_tokens=3)])
    np.testing.assert_array_equal(t2, ref[0].tokens)


def test_snapshot_restore_and_adopt_drop_session_links(weights):
    """A restored or adopted session turn finishes as a plain request:
    the receiving engine's tracker knows nothing of the donor's sids."""
    pcfg, params = weights[2], weights[3]
    eng = _paged(pcfg, max_len=64, pool_pages=40)
    sid = eng.open_session()
    rid = eng.submit(_prompt(10, 1), 4, session=sid)
    eng.step(params)
    snap = eng.snapshot()
    assert [q.session for q in snap.pending] == [sid]
    fresh = _paged(pcfg, max_len=64, pool_pages=40)
    fresh.restore(snap)
    assert fresh.run(params)[rid].state == "DONE"
    busy = _paged(pcfg, max_len=64, pool_pages=40)
    new = busy.adopt(snap.pending)[rid]
    assert busy.run(params)[new].state == "DONE"
    assert len(busy._sessions) == 0


# -- the router and the server ------------------------------------------------------


def _router(pcfg, n):
    return ReplicaRouter(lambda rep: _paged(pcfg, max_len=64, pool_pages=40),
                         n)


def test_router_counts_pinned_pages_as_unavailable(weights):
    """JAX ``test_router_counts_pinned_pages_as_unavailable``."""
    pcfg, params = weights[2], weights[3]
    router = _router(pcfg, 2)
    router.warmup(params)
    sid = router.open_session()
    rep_pinned = router._sessions[sid][0]
    rid = router.submit(_prompt(40, 1), 4, session=sid)
    router.run(params)
    assert router.pop_result(rid).state == "DONE"
    assert router._replicas[rep_pinned].engine.stats()[
        "session_pinned_pages"] > 0
    with _events() as ev:
        router.submit(_prompt(6, 2), 2)
    routes = ev.named("route")
    assert routes and f"replica={1 - rep_pinned}" in routes[0], routes


def test_session_turns_route_sticky_and_rehome_on_kill(weights):
    """JAX ``test_session_turns_route_sticky_and_rehome_on_kill``."""
    pcfg, params = weights[2], weights[3]
    router = _router(pcfg, 2)
    router.warmup(params)
    sid = router.open_session()
    rep0, _ = router._sessions[sid]
    rid = router.submit(_prompt(10, 1), 3, session=sid)
    router.run(params)
    t1 = router.pop_result(rid).tokens
    assert router._sessions[sid][0] == rep0
    router.kill(rep0, reason="scenario test")
    rid2 = router.submit(np.concatenate([t1, _prompt(3, 2)]), 3,
                         session=sid)
    assert router.counters["session_rehomes"] == 1
    assert router._sessions[sid][0] != rep0
    router.run(params)
    assert router.pop_result(rid2).state == "DONE"
    router.close_session(sid)
    with pytest.raises(ValueError, match="unknown router session"):
        router.close_session(sid)


def test_session_survives_replica_restart(weights):
    """JAX ``test_session_survives_replica_restart``."""
    pcfg, params = weights[2], weights[3]
    router = _router(pcfg, 1)
    router.warmup(params)
    sid = router.open_session()
    rid = router.submit(_prompt(10, 1), 3, session=sid)
    router.run(params)
    t1 = router.pop_result(rid).tokens
    router.kill(0, reason="scenario test")
    with pytest.raises(RouterOverloaded):
        router.open_session()
    router.restart(0, params)
    assert router.counters["session_rehomes"] == 1
    sid2 = router.open_session()
    assert router._sessions[sid][1] != router._sessions[sid2][1]
    rid2 = router.submit(np.concatenate([t1, _prompt(3, 2)]), 3,
                         session=sid)
    rid3 = router.submit(_prompt(5, 3), 2, session=sid2)
    router.run(params)
    assert router.pop_result(rid2).state == "DONE"
    assert router.pop_result(rid3).state == "DONE"


def test_session_turns_respect_shed_thresholds(weights):
    """JAX ``test_session_turns_respect_shed_thresholds``: a session turn
    past its replica's admission threshold is shed (429), never queued
    without bound."""
    pcfg, params = weights[2], weights[3]
    router = ReplicaRouter(
        lambda rep: _paged(pcfg, max_len=64, pool_pages=40), 1,
        shed_queue_depth=1)
    sid = router.open_session()
    router.submit(_prompt(6, 1), 2)
    with pytest.raises(RouterOverloaded, match="admission threshold"):
        router.submit(_prompt(6, 2), 2, session=sid)
    assert router.counters["shed"] == 1
    router.run(params)
    rid = router.submit(_prompt(6, 2), 2, session=sid)
    router.run(params)
    assert router.pop_result(rid).state == "DONE"


def test_http_session_surface(weights):
    """JAX ``test_http_scenario_surface`` (its session part): open a
    session over the wire, run two turns, a diverged resubmission is 400,
    close it, closing again is 404."""
    pcfg, params = weights[2], weights[3]
    router = _router(pcfg, 2)
    router.warmup(params)
    server = ServingServer(router, params)

    async def http(host, port, path, body=None):
        reader, writer = await asyncio.open_connection(host, port)
        payload = b"" if body is None else json.dumps(body).encode()
        writer.write((f"POST {path} HTTP/1.1\r\nHost: t\r\n"
                      f"Content-Length: {len(payload)}\r\n\r\n").encode()
                     + payload)
        await writer.drain()
        raw = await asyncio.wait_for(reader.read(), 120)
        writer.close()
        head, _, rest = raw.partition(b"\r\n\r\n")
        return int(head.split()[1]), json.loads(rest)

    async def scenario():
        host, port = await server.start()
        try:
            status, body = await http(host, port, "/v1/session/open")
            assert status == 200
            sid = body["session"]
            status, r1 = await http(host, port, "/v1/generate", dict(
                prompt=_prompt(12, 1).tolist(), max_new_tokens=3,
                session=sid))
            assert status == 200 and r1["state"] == "DONE"
            status, r2 = await http(host, port, "/v1/generate", dict(
                prompt=r1["tokens"] + [5, 6], max_new_tokens=3,
                session=sid))
            assert status == 200 and r2["tokens"][:15] == r1["tokens"]
            bad = list(r2["tokens"])
            bad[0] = (bad[0] + 1) % 97
            status, body = await http(host, port, "/v1/generate", dict(
                prompt=bad + [1], max_new_tokens=2, session=sid))
            assert status == 400 and "diverges" in body["error"]
            status, _ = await http(host, port, "/v1/session/close",
                                   {"session": sid})
            assert status == 200
            status, _ = await http(host, port, "/v1/session/close",
                                   {"session": sid})
            assert status == 404
            status, _ = await http(host, port, "/v1/session/close", {})
            assert status == 400
        finally:
            await server.stop()

    asyncio.run(scenario())
