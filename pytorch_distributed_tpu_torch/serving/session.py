"""Multi-turn chat sessions over the paged engine's prefix cache.

The port of the JAX package's ``serving/session.py``. A chat session's
turn N resubmits the conversation so far plus one new message. The block
pool's chunk-chained prefix cache stores K/V per chunk of tokens, so if
turn N-1's pages are still resident when turn N arrives, the whole
recorded transcript matches and turn N prefills about one chunk. This
module makes "still resident" a contract:

- **Transcript recording**: each session records the full token sequence
  it has served (prompt + generated, updated on DONE). A turn's prompt
  must EXTEND the recorded transcript exactly; a resubmission whose
  history diverges is rejected naming the first divergent position (it
  would otherwise be served against the old cached K/V).
- **Turn-over-turn publishing**: a one-shot request publishes only its
  prefill chunks. A session row also publishes its full decode-written
  chunks at retirement, which is what lets turn N+1 skip re-prefilling
  turn N's reply. On the card those pages hold the decode path's K/V,
  whose last bits can differ from what a prefill of the same tokens
  computes (the same difference a failed-over row's re-prefill meets).
- **Pinning with a budget**: published session chunks are PINNED against
  LRU eviction (``serving/block_pool``) while the session lives, bounded
  by ``pin_budget_pages``. Over budget, the longest-idle session is
  evicted loudly (``session_evict`` log event and counter): its chunks
  return to ordinary LRU, its transcript survives, and its next turn pays
  a cold prefill. The engine also breaks pins under page starvation —
  retention never deadlocks allocation.

Nothing here touches a device: the tracker is scheduler bookkeeping over
the block pool. One tracker per paged engine; the router keeps its own
router-sid -> (replica, engine sid) stickiness map and re-opens sessions
on a survivor after failover (the transcript-carrying resubmission makes
that lossless, at one cold prefill).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from pytorch_distributed_tpu_torch.utils.logging import log_event


@dataclasses.dataclass
class _Session:
    sid: int
    transcript: np.ndarray  # every token served so far ([0] at open)
    pinned_keys: list  # chunk chain keys currently pinned for this sid
    inflight_rid: int | None = None  # one outstanding turn at a time
    last_active: float = 0.0  # engine clock; idle-eviction order
    turns: int = 0


class SessionTracker:
    """Host-side session registry for one ``PagedBatchedDecodeEngine``
    (the engine constructs and drives it; see the engine's
    ``open_session`` / ``submit(session=)`` / ``close_session``)."""

    def __init__(self, pool, *, pin_budget_pages: int, clock) -> None:
        if pin_budget_pages < 0:
            raise ValueError(
                f"pin_budget_pages must be >= 0, got {pin_budget_pages}"
            )
        self.pool = pool
        self.pin_budget_pages = int(pin_budget_pages)
        self._clock = clock
        self._sessions: dict[int, _Session] = {}
        self._next_sid = 0
        self._inflight: dict[int, int] = {}  # rid -> sid
        # Turn-N (N >= 2) prefill economics: tokens the client RESENT
        # (the recorded transcript) vs tokens the prefix cache served.
        self.hit = {"resubmitted_tokens": 0, "cached_tokens": 0}
        self._hit_counted: set[int] = set()
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._sessions)

    @property
    def chunk_pages(self) -> int:
        return self.pool.chunk_tokens // self.pool.page_size

    def pinned_pages_total(self) -> int:
        """Pages held by session pins (budget accounting: every pinned
        chunk is chunk_pages pages, referenced or not). DISTINCT chunks
        only — two sessions sharing a system-prompt prefix pin the same
        physical pages once, and the budget charges what the pool
        actually holds, not per-holder."""
        keys: set = set()
        for s in self._sessions.values():
            keys.update(s.pinned_keys)
        return len(keys) * self.chunk_pages

    # -- lifecycle ----------------------------------------------------------

    def open(self) -> int:
        sid = self._next_sid
        self._next_sid += 1
        self._sessions[sid] = _Session(
            sid=sid, transcript=np.zeros((0,), np.int32),
            pinned_keys=[], last_active=self._clock(),
        )
        log_event("session_open", session=sid, t=round(self._clock(), 6))
        return sid

    def close(self, sid: int) -> None:
        s = self._sessions.pop(sid, None)
        if s is None:
            raise ValueError(f"unknown session id {sid}")
        if s.inflight_rid is not None:
            self._inflight.pop(s.inflight_rid, None)
        self.pool.unpin(s.pinned_keys)
        log_event(
            "session_close", session=sid, turns=s.turns,
            t=round(self._clock(), 6),
        )

    def check_turn(self, sid: int, prompt: np.ndarray) -> int:
        """Validate one turn submission; returns the resubmitted-prefix
        length (= recorded transcript length). Loud on: unknown sid, a
        still-inflight previous turn, and a prompt whose history
        diverges from (or fails to extend) the transcript."""
        s = self._sessions.get(sid)
        if s is None:
            raise ValueError(
                f"unknown session id {sid}: open_session() first (or "
                "the session was closed/evicted)"
            )
        if s.inflight_rid is not None:
            raise ValueError(
                f"session {sid} already has turn rid "
                f"{s.inflight_rid} in flight — one outstanding turn "
                "per session (pop its result first; interleaved turns "
                "would race the transcript)"
            )
        tr = s.transcript
        if prompt.shape[0] <= tr.shape[0]:
            raise ValueError(
                f"session {sid} turn must EXTEND the recorded "
                f"transcript ({tr.shape[0]} tokens) with at least one "
                f"new token; got a {prompt.shape[0]}-token prompt — "
                "resubmit the conversation-so-far plus the new message"
            )
        head = prompt[: tr.shape[0]]
        if not np.array_equal(head, tr):
            at = int(np.argmax(head != tr))
            raise ValueError(
                f"session {sid} resubmission diverges from the "
                f"recorded transcript at position {at} (sent token "
                f"{int(head[at])}, transcript has {int(tr[at])}): the "
                "cached K/V no longer matches the client's history — "
                "open a fresh session for an edited conversation"
            )
        return int(tr.shape[0])

    def begin_turn(self, sid: int, rid: int) -> None:
        s = self._sessions[sid]
        s.inflight_rid = rid
        s.turns += 1
        s.last_active = self._clock()
        self._inflight[rid] = sid
        log_event(
            "session_turn", session=sid, rid=rid, turn=s.turns,
            transcript=int(s.transcript.shape[0]),
            t=round(self._clock(), 6),
        )

    def on_terminal(self, rid: int) -> None:
        """Any terminal state clears the in-flight marker (the DONE
        path updated the transcript first via ``on_turn_done``); a
        FAILED/EXPIRED/ABORTED turn leaves the transcript unchanged, so
        the client's retry of the same turn still extends it."""
        self._hit_counted.discard(rid)
        sid = self._inflight.pop(rid, None)
        if sid is None:
            return
        s = self._sessions.get(sid)
        if s is not None and s.inflight_rid == rid:
            s.inflight_rid = None
            s.last_active = self._clock()

    # -- retention ----------------------------------------------------------

    def on_turn_done(self, sid: int, transcript: np.ndarray,
                     keys: list) -> None:
        """A session turn retired DONE: record the new transcript and
        pin its chunk keys, evicting longest-idle sessions (never this
        one) while over the pin budget. ``keys`` is the full chain from
        token 0 — pins are idempotent per key."""
        s = self._sessions.get(sid)
        if s is None:
            return  # closed/evicted mid-turn, or a restored foreign rid
        s.transcript = np.asarray(transcript, np.int32)
        s.last_active = self._clock()
        new = [k for k in keys if k not in s.pinned_keys]
        self.pool.pin(new)
        s.pinned_keys.extend(new)
        while (
            self.pinned_pages_total() > self.pin_budget_pages
            and self.evict_idle(exclude_sid=sid)
        ):
            pass
        if self.pinned_pages_total() > self.pin_budget_pages:
            # Still over budget (this session alone exceeds it, or the
            # other pinners are all mid-turn and unevictable): shed this
            # session's TAIL pins — the chain matches from the front, so
            # keeping the head preserves the longest matchable prefix.
            # The overage can exceed OUR pin count when inflight
            # neighbours hold the rest; clamp — their pins release at
            # their own turn end, which re-runs this balance.
            over = (
                self.pinned_pages_total() - self.pin_budget_pages
                + self.chunk_pages - 1
            ) // self.chunk_pages
            over = min(over, len(s.pinned_keys))
            if over:
                drop = s.pinned_keys[len(s.pinned_keys) - over:]
                s.pinned_keys = s.pinned_keys[: len(s.pinned_keys) - over]
                self.pool.unpin(drop)
                log_event(
                    "session_evict", session=sid, partial=True,
                    unpinned_chunks=len(drop), t=round(self._clock(), 6),
                )

    def evict_idle(self, exclude_sid: int | None = None) -> bool:
        """Unpin the longest-idle session with no turn in flight (LOUD:
        ``session_evict``). The session record and transcript survive —
        only the retention guarantee is lost; its next turn pays
        whatever the LRU left behind. Returns False when nothing is
        evictable (everything pinned is mid-turn)."""
        cands = [
            s for s in self._sessions.values()
            if s.pinned_keys and s.inflight_rid is None
            and s.sid != exclude_sid
        ]
        if not cands:
            return False
        victim = min(cands, key=lambda s: (s.last_active, s.sid))
        self.pool.unpin(victim.pinned_keys)
        n = len(victim.pinned_keys)
        victim.pinned_keys = []
        self.evictions += 1
        log_event(
            "session_evict", session=victim.sid, unpinned_chunks=n,
            t=round(self._clock(), 6),
        )
        return True

    def on_pool_reset(self) -> None:
        """A failed dispatch reset the block pool: no page content is
        trusted, so the pins are dropped (transcripts survive — the next
        turn pays its prefill again, like the other resume paths)."""
        for s in self._sessions.values():
            s.pinned_keys = []

    # -- accounting ---------------------------------------------------------

    def note_admit(self, rid: int, cached: int, resub_len: int) -> None:
        """First admission of a session turn with a non-empty recorded
        transcript: account how much of the RESENT history the prefix
        cache served (preemption re-admissions are not re-counted — the
        economics of the turn were decided at first admission)."""
        if resub_len <= 0 or rid in self._hit_counted:
            return
        self._hit_counted.add(rid)
        self.hit["resubmitted_tokens"] += int(resub_len)
        self.hit["cached_tokens"] += min(int(cached), int(resub_len))

    def hit_rate(self) -> float:
        """cached/resubmitted over every turn >= 2."""
        return self.hit["cached_tokens"] / max(
            1, self.hit["resubmitted_tokens"]
        )
