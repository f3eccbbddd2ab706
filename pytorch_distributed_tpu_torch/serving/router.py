"""Health-checked multi-replica router: the serving tier over N engines.

The port of the JAX package's ``serving/router.py``. One engine (a
``PagedBatchedDecodeEngine``, or a dense ``BatchedDecodeEngine``: a
colocated replica with no page pressure) is one failure domain;
``ReplicaRouter`` is the layer above it — placement, health, failover
and honest overload behaviour — and it is host-side only: nothing it does
changes a kernel, a neighbour row or a tensor shape.

- **Routing and admission** (``submit``): each request goes to the
  least-loaded routable replica, scored on the engine's ``stats()``:
  queue depth and page pressure (a replica without free pages is not a
  candidate even if its queue is short). DEGRADED replicas rank after
  HEALTHY ones. Ties break by replica id, so routing is a deterministic
  function of (request order, replica states).
- **Load shedding**: when no replica is admissible the router raises
  ``lifecycle.RouterOverloaded`` with a drain-time ``retry_after_s``
  instead of queueing without bound; the HTTP front door maps it to
  429 + Retry-After.
- **Failover** (replica death): a replica that dies — its engine raising
  ``DispatchFailure`` from ``step``, or a lost process (``kill``, or
  ``RouterFaultInjector``) — has every in-flight request converted to a
  resume entry (its tokens so far, from the engine's host-side
  ``snapshot``) and ADOPTED by survivors (``engine.adopt``). The
  continuation is token-identical to an uninterrupted run when the
  resumed row's re-prefill computes the same logits as the decode ticks
  it replaces: exactly so on the CPU in f32; on the card the prefill
  chunk and the decode tick take different GEMM shapes and attention
  paths, so a near-tie can flip (``loadgen`` counts it). No rid is lost
  or duplicated. With no survivor the entries park in the router and
  re-adopt when a replica comes back.
- **Drain / restart**: ``drain`` snapshots the replica and takes it out
  of rotation; ``restart`` rebuilds the engine from the factory, warms it
  and ``restore``s the snapshot. ``drain(migrate=True)`` hands the work
  to survivors instead.
- **Brown-out**: per-replica step latency rides an EMA on the router's
  clock; a replica whose EMA exceeds ``degrade_factor`` x the fleet
  median (floored at ``degrade_min_s``) turns DEGRADED and stops
  attracting new load until it recovers.

Request ids: the router issues its own rids and maps them onto
per-engine rids (re-mapped on every adoption); results are relabelled so
a client never sees engine-internal ids. Every transition logs through
``utils/logging.log_event`` with the router vocabulary (``route``,
``shed``, ``failover``, ``drain``, ``replica_down``, ``replica_up``,
``replica_degraded``, ``replica_recovered``) carrying rid and replica id.

- **Sessions** (paged replicas only): ``open_session`` opens a
  multi-turn session on the least-loaded replica; its turns
  (``submit(session=)``) route STICKY to
  that replica, whose pinned prefix pages are the locality. When the
  replica is lost, the next turn re-homes the session onto a survivor
  (a fresh engine session; the transcript-carrying resubmission makes
  that lossless, at one cold prefill), and ``restart`` re-homes the
  sessions still homed on the restarted replica.

Not ported yet: the disaggregated prefill/decode handoff pump and LoRA
tenants; they raise ``NotImplementedError`` naming their ROADMAP item.

Not thread-safe: one dispatcher per router (the front door in
``serving/server.py`` serialises through a lock). Replicas must share one
params object and, when deadlines or virtual-time chaos are in play, one
clock. On one card the replicas colocate; ``parallel_step`` then only
interleaves their host work and is left off.
"""

from __future__ import annotations

import dataclasses
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable

import numpy as np

from pytorch_distributed_tpu_torch.serving.lifecycle import (
    ABORTED,
    AdmissionQueueFull,
    DispatchFailure,
    EngineSnapshot,
    RequestResult,
    RouterOverloaded,
)
from pytorch_distributed_tpu_torch.utils.logging import log_event

HEALTHY = "HEALTHY"
DEGRADED = "DEGRADED"
DRAINED = "DRAINED"
DOWN = "DOWN"
REPLICA_STATES = (HEALTHY, DEGRADED, DRAINED, DOWN)
_ROUTABLE = (HEALTHY, DEGRADED)

LORA_NOT_PORTED = (
    "LoRA adapters are not yet ported (ROADMAP queue 1 item 4)"
)


def _check_session_engine(engine) -> None:
    """Sessions ride the paged engine's pinned prefix cache."""
    if not hasattr(engine, "open_session"):
        raise ValueError(
            "sessions need paged replica engines (PagedBatchedDecodeEngine)"
            f" — this fleet serves {type(engine).__name__}"
        )


@dataclasses.dataclass
class _Replica:
    """One replica's router-side record: the engine, its health state,
    the engine-rid -> router-rid map, and the compile-count watermark."""

    rep_id: int
    engine: Any
    state: str = HEALTHY
    tick_ema_s: float | None = None  # None until the first measured tick
    rid_map: dict[int, int] = dataclasses.field(default_factory=dict)
    warm_count: int = 0
    held_snapshot: EngineSnapshot | None = None  # parked by drain()
    down_reason: str = ""


class ReplicaRouter:
    """See the module docstring. ``make_engine(rep_id)`` builds one
    replica engine (called at construction and again on every
    ``restart``, so it must return a fresh idle engine each call);
    ``n_replicas`` fixes the fleet size. Health knobs:

    - ``shed_queue_depth``: a replica whose engine queue is this deep is
      not admissible (default: 2x its slot count).
    - ``shed_page_free``: a replica with fewer free pages is not
      admissible (default 1).
    - ``degrade_factor`` / ``degrade_min_s`` / ``ema_alpha``: brown-out
      detection.
    - ``retry_after_s``: the shed hint when the drain estimate has no
      signal; otherwise it is derived from the median step EMA and the
      shallowest queue.
    - ``parallel_step``: step busy replicas on concurrent host threads
      instead of in turn. Only worth it when replicas own separate
      devices; all router bookkeeping still runs serially after the
      joins. Default False.
    """

    def __init__(
        self,
        make_engine: Callable[[int], Any],
        n_replicas: int,
        *,
        clock=None,
        shed_queue_depth: int | None = None,
        shed_page_free: int = 1,
        degrade_factor: float = 4.0,
        degrade_min_s: float = 0.05,
        ema_alpha: float = 0.3,
        retry_after_s: float = 1.0,
        parallel_step: bool = False,
    ) -> None:
        if n_replicas < 1:
            raise ValueError(f"n_replicas must be >= 1, got {n_replicas}")
        self._make_engine = make_engine
        self._clock = clock or time.monotonic
        self._replicas = [
            _Replica(rep_id=i, engine=make_engine(i))
            for i in range(n_replicas)
        ]
        self.shed_queue_depth = shed_queue_depth
        self.shed_page_free = int(shed_page_free)
        self.degrade_factor = float(degrade_factor)
        self.degrade_min_s = float(degrade_min_s)
        self.ema_alpha = float(ema_alpha)
        self.retry_after_s = float(retry_after_s)
        self.parallel_step = bool(parallel_step)
        self._next_rid = 0
        # router rid -> (rep_id, engine rid); the mirror of each replica's
        # rid_map. Entries leave on terminal delivery.
        self._assign: dict[int, tuple[int, int]] = {}
        # Entries with no live replica to run them: (router rid, entry).
        self._orphans: list[tuple[int, Any]] = []
        # Session stickiness: router sid -> (rep_id, engine sid).
        self._sessions: dict[int, tuple[int, int]] = {}
        self._next_sid = 0
        self.results: dict[int, RequestResult] = {}
        # router rid -> tokens it had generated at each failover (kept
        # until pop_result): where a resumed row's continuation begins.
        self.failover_points: dict[int, list[int]] = {}
        self._ticks = 0
        self._injector = None  # serving/chaos.RouterFaultInjector
        self.counters: dict[str, int] = {
            "routed": 0, "shed": 0, "failovers": 0, "failover_requests": 0,
            "drains": 0, "restarts": 0, "orphaned": 0,
            "sessions_opened": 0, "session_rehomes": 0,
        }

    # -- fleet management ---------------------------------------------------

    def warmup(self, params) -> int:
        """Warm every replica and record the per-replica watermark
        ``steady_compiles`` is measured against. Returns the fleet-total
        ``compile_count``."""
        for r in self._replicas:
            r.engine.warmup(params)
            r.warm_count = r.engine.compile_count()
        return sum(r.engine.compile_count() for r in self._replicas)

    def steady_compiles(self) -> dict[int, int]:
        """Per-replica ``compile_count`` since its warmup watermark:
        expected 0 for every replica (``engine.compile_count``)."""
        return {
            r.rep_id: r.engine.compile_count() - r.warm_count
            for r in self._replicas
        }

    def replica_states(self) -> dict[int, str]:
        return {r.rep_id: r.state for r in self._replicas}

    def live_replicas(self) -> list[int]:
        return [r.rep_id for r in self._replicas if r.state in _ROUTABLE]

    def engines(self) -> dict[int, Any]:
        """The current engine of every replica (a restart replaces it)."""
        return {r.rep_id: r.engine for r in self._replicas}

    def set_fault_injector(self, injector) -> None:
        """Install a ``serving/chaos.RouterFaultInjector`` (or None):
        consulted once per ``step`` for replica_kill faults."""
        self._injector = injector

    # -- admission ----------------------------------------------------------

    def _admissible(self, r: _Replica) -> tuple[float, ...] | None:
        """Admission and scoring in one read of the replica's ``stats()``:
        None = not admissible (saturated queue or page starvation);
        otherwise the routing sort key — DEGRADED after HEALTHY, then host
        load, then page pressure (0 on a dense replica, which has no
        pages), then id."""
        st = r.engine.stats()
        limit = (
            self.shed_queue_depth
            if self.shed_queue_depth is not None
            else 2 * (st["slots"] or 1)
        )
        if st["queue_depth"] >= limit:
            return None
        page_pressure = 0.0
        if st["free_pages"] is not None:  # None: a dense engine, no pages
            if st["free_pages"] < self.shed_page_free:
                return None
            # Session-pinned pages count as unavailable capacity. A
            # speculating row's draft window lives on its own, already
            # counted tail pages (grown without preemption), so
            # speculation does not enter this accounting.
            pinned = st.get("session_pinned_pages") or 0
            page_pressure = (
                st["pages_in_use"] + pinned
            ) / max(1, st["pool_pages"])
        load = st["queue_depth"] + st["active_rows"]
        return (
            1.0 if r.state == DEGRADED else 0.0,
            float(load),
            page_pressure,
            float(r.rep_id),
        )

    def _ranked_replicas(self) -> list[_Replica]:
        """Admissible replicas, best routing choice first."""
        scored = []
        for r in self._replicas:
            if r.state not in _ROUTABLE:
                continue
            key = self._admissible(r)
            if key is not None:
                scored.append((key, r))
        return [r for _, r in sorted(scored, key=lambda kr: kr[0])]

    def _retry_after(self) -> float:
        """Drain-time hint for a shed response: one slot's worth of decode
        at the fleet's median measured tick latency, floored at the
        configured default."""
        emas = sorted(
            r.tick_ema_s for r in self._replicas
            if r.state in _ROUTABLE and r.tick_ema_s is not None
        )
        if not emas:
            return self.retry_after_s
        med = emas[len(emas) // 2]
        depth = min(
            r.engine.stats()["queue_depth"] for r in self._replicas
            if r.state in _ROUTABLE
        )
        return max(self.retry_after_s, med * (depth + 1))

    def open_session(self) -> int:
        """Open a multi-turn session on the least-loaded routable replica;
        returns the ROUTER sid ``submit(session=)`` takes."""
        best = self._least_loaded()
        if best is None:
            raise RouterOverloaded(
                "no live replica to open a session on "
                f"(states {self.replica_states()})",
                retry_after_s=self._retry_after(),
            )
        _check_session_engine(best.engine)
        esid = best.engine.open_session()
        sid = self._next_sid
        self._next_sid += 1
        self._sessions[sid] = (best.rep_id, esid)
        self.counters["sessions_opened"] += 1
        log_event(
            "session_route", session=sid, replica=best.rep_id,
            engine_session=esid, t=round(self._clock(), 6),
        )
        return sid

    def close_session(self, sid: int) -> None:
        """Close a router session; the replica's pins release. Unknown
        sids raise."""
        loc = self._sessions.pop(sid, None)
        if loc is None:
            raise ValueError(
                f"unknown router session id {sid}: open_session() first "
                "(or it was already closed)"
            )
        rep_id, esid = loc
        r = self._replicas[rep_id]
        if r.state in _ROUTABLE:
            r.engine.close_session(esid)
        # A DOWN/DRAINED holder's tracker died (or will be rebuilt) with
        # its engine: nothing to release.

    def _session_target(self, sid: int) -> tuple[_Replica, int]:
        """The (replica, engine sid) a session turn routes to, re-homing
        onto a survivor when the sticky replica is not routable."""
        loc = self._sessions.get(sid)
        if loc is None:
            raise ValueError(
                f"unknown router session id {sid}: open_session() first "
                "(or it was closed)"
            )
        rep_id, esid = loc
        r = self._replicas[rep_id]
        if r.state in _ROUTABLE:
            return r, esid
        best = self._least_loaded()
        if best is None:
            raise RouterOverloaded(
                f"session {sid}'s replica {rep_id} is {r.state} and no "
                "survivor can re-home it",
                retry_after_s=self._retry_after(),
            )
        _check_session_engine(best.engine)
        esid = best.engine.open_session()
        self._sessions[sid] = (best.rep_id, esid)
        self.counters["session_rehomes"] += 1
        log_event(
            "session_route", session=sid, replica=best.rep_id,
            engine_session=esid, rehomed_from=rep_id,
            t=round(self._clock(), 6),
        )
        return best, esid

    def _shed(self, message: str):
        self.counters["shed"] += 1
        hint = self._retry_after()
        log_event(
            "shed", t=round(self._clock(), 6),
            live=len(self.live_replicas()), retry_after_s=round(hint, 4),
        )
        return RouterOverloaded(f"{message}; retry after ~{hint:.2f}s",
                                retry_after_s=hint)

    def submit(self, prompt, max_new_tokens: int, *,
               session: int | None = None, **kw) -> int:
        """Route one request (``engine.submit`` kwargs pass through:
        deadlines via ``timeout_s=``, SLO tiers via ``priority=``, sampling
        via ``temperature``/``top_k``/``top_p``/``seed``). Returns the
        ROUTER rid its terminal ``RequestResult`` will carry. Raises
        ``RouterOverloaded`` (with ``retry_after_s``) when no replica is
        admissible. ``session=`` (a router sid from ``open_session``)
        routes STICKY to the replica holding the session's pages; past
        that replica's admission threshold the turn is shed like a
        saturated fleet's."""
        if kw.get("tenant") is not None:
            raise NotImplementedError(LORA_NOT_PORTED)
        kw.pop("tenant", None)
        r = erid = None
        if session is not None:
            cand, esid = self._session_target(session)
            if self._admissible(cand) is None:
                raise self._shed(
                    f"session {session}'s replica {cand.rep_id} is past "
                    "its admission threshold"
                )
            try:
                erid = cand.engine.submit(prompt, max_new_tokens,
                                          session=esid, **kw)
            except AdmissionQueueFull as err:
                raise self._shed(
                    f"session {session}'s replica {cand.rep_id} is "
                    f"saturated ({err})"
                ) from None
            r = cand
        else:
            for cand in self._ranked_replicas():
                try:
                    erid = cand.engine.submit(prompt, max_new_tokens, **kw)
                    r = cand
                    break
                except AdmissionQueueFull:
                    # The engine's own queue_limit can be tighter than
                    # the router's threshold: try the next replica.
                    continue
        if r is None:
            raise self._shed(
                "every routable replica is past its admission threshold "
                f"(states {self.replica_states()})"
            )
        rid = self._next_rid
        self._next_rid += 1
        r.rid_map[erid] = rid
        self._assign[rid] = (r.rep_id, erid)
        self.counters["routed"] += 1
        log_event(
            "route", rid=rid, replica=r.rep_id, engine_rid=erid,
            state=r.state, t=round(self._clock(), 6),
        )
        return rid

    # -- results ------------------------------------------------------------

    def _deliver(self, r: _Replica, erid: int, res: RequestResult) -> int:
        rid = r.rid_map.pop(erid)
        self._assign.pop(rid, None)
        self.results[rid] = dataclasses.replace(res, rid=rid)
        return rid

    def pop_result(self, rid: int) -> RequestResult:
        """Deliver and release one terminal result."""
        self.failover_points.pop(rid, None)
        return self.results.pop(rid)

    def abort(self, rid: int) -> bool:
        """Cancel one request wherever it lives — queued or active on a
        replica, or parked as an orphan. True on transition, False if
        already terminal, KeyError for unknown rids."""
        if rid in self.results:
            return False
        for i, (orid, q) in enumerate(self._orphans):
            if orid == rid:
                del self._orphans[i]
                self.results[rid] = RequestResult(
                    rid=rid, state=ABORTED,
                    tokens=np.concatenate([
                        np.asarray(q.prompt, np.int32),
                        np.asarray(q.gen, np.int32),
                    ]),
                    reason="abort() while parked (no live replica)",
                )
                return True
        loc = self._assign.get(rid)
        if loc is None:
            raise KeyError(
                f"unknown router rid {rid}: never submitted, or already "
                "delivered via pop_result"
            )
        rep_id, erid = loc
        r = self._replicas[rep_id]
        if r.engine.abort(erid):
            # A DRAINED replica's held snapshot still carries the entry;
            # scrub it, or restart would run a cancelled request again.
            if r.held_snapshot is not None:
                r.held_snapshot.pending = [
                    q for q in r.held_snapshot.pending if q.rid != erid
                ]
            self._deliver(r, erid, r.engine.pop_result(erid))
            return True
        return False

    def progress(self, rid: int):
        """Tokens so far for a live or terminal router rid (the SSE
        streaming read); None for unknown rids."""
        if rid in self.results:
            return np.asarray(self.results[rid].tokens)
        for orid, q in self._orphans:
            if orid == rid:
                return np.concatenate([
                    np.asarray(q.prompt, np.int32),
                    np.asarray(q.gen, np.int32),
                ])
        loc = self._assign.get(rid)
        if loc is None:
            return None
        rep_id, erid = loc
        return self._replicas[rep_id].engine.peek_tokens(erid)

    def has_work(self) -> bool:
        return bool(self._orphans) or any(
            r.state in _ROUTABLE and r.engine.has_work()
            for r in self._replicas
        )

    # -- the tick -----------------------------------------------------------

    def step(self, params) -> list[int]:
        """One router tick: fire chaos, re-adopt orphans, then advance
        every routable replica one engine tick — measuring its latency for
        brown-out detection, catching ``DispatchFailure`` as replica
        death — and deliver every terminal result under ROUTER rids.
        Returns the router rids that reached a terminal state."""
        self._ticks += 1
        if self._injector is not None:
            self._injector.on_tick(self._ticks)
            # Drain every armed kill, re-reading the live set after each.
            while True:
                target = self._injector.pop_kill(self.live_replicas())
                if target is None:
                    break
                self.kill(target, reason="chaos replica_kill")
        self._readopt_orphans()
        finished: list[int] = []

        def _idle(r: _Replica) -> bool:
            if r.engine.has_work():
                return False
            # An idle DEGRADED replica gets no tick evidence: decay its
            # EMA optimistically instead.
            if r.state == DEGRADED:
                self._update_health(r, 0.0)
            return True

        def _one(r: _Replica):
            t0 = self._clock()
            try:
                done = r.engine.step(params)
            except DispatchFailure as err:
                return r, self._clock() - t0, None, err
            return r, self._clock() - t0, done, None

        def _settle(r: _Replica, dt: float, done, err) -> None:
            if err is not None:
                # The engine exhausted its own retry budget and left its
                # state consistent: at the router tier that is replica
                # death; survivors take the work.
                self._take_down(
                    r, f"dispatch failure: {err}", finished=finished
                )
                return
            self._update_health(r, dt)
            for erid in done:
                finished.append(
                    self._deliver(r, erid, r.engine.pop_result(erid))
                )

        if self.parallel_step:
            busy = [
                r for r in self._replicas
                if r.state in _ROUTABLE and not _idle(r)
            ]
            if len(busy) > 1:
                with ThreadPoolExecutor(max_workers=len(busy)) as pool:
                    stepped = list(pool.map(_one, busy))
            else:
                stepped = [_one(r) for r in busy]
            for r, dt, done, err in stepped:
                _settle(r, dt, done, err)
        else:
            # Settle inline, re-reading routability and has_work at each
            # replica's turn: a mid-tick death's entries can be adopted —
            # and stepped — by replicas later in this same tick.
            for r in self._replicas:
                if r.state not in _ROUTABLE or _idle(r):
                    continue
                _settle(*_one(r))
        return finished

    def run(self, params, *, max_ticks: int | None = None) -> list[int]:
        """Drive ``step`` until idle (or ``max_ticks``); returns every
        router rid that finished during the drive."""
        finished: list[int] = []
        ticks = 0
        while self.has_work():
            if max_ticks is not None and ticks >= max_ticks:
                break
            finished += self.step(params)
            ticks += 1
        return finished

    def _update_health(self, r: _Replica, dt: float) -> None:
        a = self.ema_alpha
        r.tick_ema_s = (
            dt if r.tick_ema_s is None
            else (1 - a) * r.tick_ema_s + a * dt
        )
        others = [
            x.tick_ema_s for x in self._replicas
            if x is not r and x.state in _ROUTABLE
            and x.tick_ema_s is not None
        ]
        if not others:
            # No peer baseline: "slow" is only meaningful relative to the
            # fleet.
            return
        med = sorted(others)[len(others) // 2]
        threshold = max(self.degrade_min_s, self.degrade_factor * med)
        if r.state == HEALTHY and r.tick_ema_s > threshold:
            r.state = DEGRADED
            log_event(
                "replica_degraded", replica=r.rep_id,
                tick_ema_s=round(r.tick_ema_s, 4),
                threshold_s=round(threshold, 4),
                t=round(self._clock(), 6),
            )
        elif r.state == DEGRADED and r.tick_ema_s <= threshold:
            r.state = HEALTHY
            log_event(
                "replica_recovered", replica=r.rep_id,
                tick_ema_s=round(r.tick_ema_s, 4),
                t=round(self._clock(), 6),
            )

    # -- failover / drain / restart ----------------------------------------

    def kill(self, rep_id: int, *, reason: str = "process loss") -> None:
        """Treat one replica as a lost process: its engine is written off
        and every in-flight or queued request fails over to survivors from
        the engine's host-side snapshot. Idempotent on DOWN replicas."""
        r = self._replicas[rep_id]
        if r.state == DOWN:
            return
        self._take_down(r, reason)

    def _take_down(self, r: _Replica, reason: str,
                   finished: list[int] | None = None) -> None:
        snap = r.engine.snapshot()
        r.state = DOWN
        r.down_reason = reason
        r.held_snapshot = None
        log_event(
            "replica_down", replica=r.rep_id, reason=reason,
            pending=len(snap.pending), t=round(self._clock(), 6),
        )
        # Undelivered terminal results are host memory: they survive the
        # replica and deliver now.
        for erid, res in snap.results.items():
            rid = self._deliver(r, erid, res)
            if finished is not None:
                finished.append(rid)
        self.counters["failovers"] += 1
        self._redistribute(r, snap.pending)
        r.rid_map.clear()

    def _least_loaded(self, exclude: _Replica | None = None):
        """Least-loaded routable replica for failover and re-adoption —
        the routing order without the admission thresholds: failover must
        not shed accepted work."""
        best, best_key = None, None
        for r in self._replicas:
            if r is exclude or r.state not in _ROUTABLE:
                continue
            st = r.engine.stats()
            key = (
                1.0 if r.state == DEGRADED else 0.0,
                float(st["queue_depth"] + st["active_rows"]),
                float(r.rep_id),
            )
            if best_key is None or key < best_key:
                best, best_key = r, key
        return best

    def _redistribute(self, src: _Replica, pendings) -> None:
        """Re-route a dead or drained replica's entries onto least-loaded
        survivors; park what nothing can take."""
        for q in pendings:
            rid = src.rid_map.pop(q.rid)
            self.failover_points.setdefault(rid, []).append(len(q.gen))
            best = self._least_loaded(exclude=src)
            if best is None:
                self.counters["orphaned"] += 1
                self._orphans.append((rid, q))
                self._assign.pop(rid, None)
                log_event(
                    "failover", rid=rid, from_replica=src.rep_id,
                    to_replica=None, parked=True,
                    resumed_tokens=len(q.gen),
                    t=round(self._clock(), 6),
                )
                continue
            self._adopt_one(best, rid, q, from_replica=src.rep_id)

    def _adopt_one(self, r: _Replica, rid: int, q,
                   from_replica: int | None) -> None:
        new_erid = r.engine.adopt([q])[q.rid]
        r.rid_map[new_erid] = rid
        self._assign[rid] = (r.rep_id, new_erid)
        self.counters["failover_requests"] += 1
        log_event(
            "failover", rid=rid, from_replica=from_replica,
            to_replica=r.rep_id, resumed_tokens=len(q.gen),
            t=round(self._clock(), 6),
        )

    def _readopt_orphans(self) -> None:
        if not self._orphans:
            return
        orphans, self._orphans = self._orphans, []
        for rid, q in orphans:
            best = self._least_loaded()
            if best is None:
                self._orphans.append((rid, q))
            else:
                self._adopt_one(best, rid, q, from_replica=None)

    def drain(self, rep_id: int, *, migrate: bool = False) -> int:
        """Planned maintenance: snapshot the replica and take it out of
        rotation. By default the snapshot is held and ``restart``
        restores it; ``migrate=True`` hands the work to survivors at once
        (parking it when none is left). Returns the number of requests
        captured."""
        r = self._replicas[rep_id]
        if r.state not in _ROUTABLE:
            raise RuntimeError(
                f"replica {rep_id} is {r.state}; drain needs a routable "
                "replica"
            )
        snap = r.engine.snapshot()
        log_event(
            "drain", replica=rep_id, pending=len(snap.pending),
            migrate=migrate, t=round(self._clock(), 6),
        )
        self.counters["drains"] += 1
        # Undelivered results deliver now and leave both the held
        # snapshot and the still-live engine (a later kill() snapshots it
        # again and must not deliver them twice).
        for erid, res in list(snap.results.items()):
            r.engine.pop_result(erid)
            self._deliver(r, erid, res)
        snap.results = {}
        if migrate:
            r.state = DOWN
            r.down_reason = "drained (migrated)"
            self._redistribute(r, snap.pending)
            r.rid_map.clear()
        else:
            r.state = DRAINED
            r.down_reason = "drained (held for restart)"
            r.held_snapshot = snap
        return len(snap.pending)

    def restart(self, rep_id: int, params) -> None:
        """Bring a DOWN or DRAINED replica back: a fresh engine from the
        factory, warmed (the watermark resets), the drained snapshot
        restored if one is held. The replica re-enters rotation
        HEALTHY."""
        r = self._replicas[rep_id]
        if r.state in _ROUTABLE:
            raise RuntimeError(
                f"replica {rep_id} is {r.state}; restart needs a "
                "DOWN/DRAINED replica"
            )
        if r.state == DOWN:
            r.rid_map.clear()
        r.engine = self._make_engine(rep_id)
        r.engine.warmup(params)
        if r.held_snapshot is not None:
            r.engine.restore(r.held_snapshot)
            r.held_snapshot = None
        r.warm_count = r.engine.compile_count()
        r.state = HEALTHY
        r.tick_ema_s = None
        r.down_reason = ""
        # Sessions still homed here hold the old engine's sids: re-home
        # each onto a fresh session of the new engine (its next turn's
        # resubmitted conversation extends the empty transcript).
        for sid, (home, _stale) in list(self._sessions.items()):
            if home != rep_id:
                continue
            esid = r.engine.open_session()
            self._sessions[sid] = (rep_id, esid)
            self.counters["session_rehomes"] += 1
            log_event(
                "session_route", session=sid, replica=rep_id,
                engine_session=esid, rehomed_from=rep_id,
                t=round(self._clock(), 6),
            )
        self.counters["restarts"] += 1
        log_event("replica_up", replica=rep_id, t=round(self._clock(), 6))

    # -- introspection ------------------------------------------------------

    def stats(self) -> dict[str, Any]:
        """Router-tier snapshot: per-replica health and engine stats,
        router counters and orphan depth — what ``/healthz`` serves."""
        return {
            "replicas": {
                r.rep_id: dict(
                    state=r.state,
                    tick_ema_s=(
                        None if r.tick_ema_s is None
                        else round(r.tick_ema_s, 6)
                    ),
                    down_reason=r.down_reason or None,
                    **(
                        r.engine.stats() if r.state != DOWN
                        else {"engine": None}
                    ),
                )
                for r in self._replicas
            },
            "orphans": len(self._orphans),
            "undelivered_results": len(self.results),
            "sessions": len(self._sessions),
            "counters": dict(self.counters),
        }
