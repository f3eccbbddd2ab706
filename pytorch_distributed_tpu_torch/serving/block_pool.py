"""Host-side KV page-pool bookkeeping for the paged serving engine.

A copy of the JAX package's ``serving/block_pool.py`` (pure numpy; the
port keeps its own copy so it imports nothing of that package). The
paged engine (``serving/engine.PagedBatchedDecodeEngine``) stores K/V in
a flat pool of fixed-size PAGES — ``[L, pool_pages, page_size, Hkv, D]``
on the device — and gives each request a per-row BLOCK TABLE of page ids.
This module is the pool's host-side brain; the device only ever sees
page-id int32 tables.

Three responsibilities:

1. **Allocation + refcounts.** Pages are acquired per row and REFERENCE
   COUNTED, because prefix sharing hands the same physical page to many
   rows. A page returns to the free list only when its last reference
   drops AND it is not retained by the prefix cache.

2. **Prefix cache.** Identical prompt prefixes are stored ONCE: prefixes
   are keyed by a sha1 CHAIN over fixed-size token chunks
   (``key_j = sha1(key_{j-1} || tokens[jC:(j+1)C])``), so a chunk's key
   commits to the ENTIRE prefix before it — the precondition that makes
   K/V sharing sound (a position's K/V is a pure function of the tokens
   at and before it). ``match_prefix`` walks the chain and hands back
   shared pages (acquiring a reference on each); ``register_chunk``
   publishes a freshly prefilled chunk's pages. Chunks are retained after
   their last reference drops and EVICTED in LRU order only when
   allocation would otherwise fail.

3. **Copy-on-write discipline, by construction.** Shared pages are never
   written: sharing is chunk-granular over the prefill prefix, a row's
   own writes start at its first un-cached position (always a chunk
   boundary), and decode writes land past the prompt — so two rows that
   share a prefix and then fork diverge onto PRIVATE pages without any
   device-side copy.

Page id 0 is RESERVED as the scratch page: block-table entries default to
0, so free rows of a decode step write and read page 0, which no live
row's table ever points at. Session pins (``serving/session``) and the
KV-handoff page ledger (``alloc_for_handoff``/``note_handoff_out``, fed
by a disaggregated decode worker's imports and a prefill worker's
completed exports) keep the pool's behaviour and ``stats`` the JAX
package's exactly.
"""

from __future__ import annotations

import dataclasses
import hashlib

import numpy as np


@dataclasses.dataclass
class _CachedChunk:
    """One published prefix chunk: the pages holding its K/V."""

    pids: list  # page ids, in position order


class BlockPool:
    """Fixed-size page pool with refcounts and a chunk-chained prefix
    cache. Page ids are ``1..pool_pages-1`` (0 is the scratch page).
    Purely host-side state; see the module docstring."""

    def __init__(
        self, pool_pages: int, page_size: int, chunk_tokens: int
    ) -> None:
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        if chunk_tokens < page_size or chunk_tokens % page_size:
            raise ValueError(
                f"chunk_tokens ({chunk_tokens}) must be a positive "
                f"multiple of page_size ({page_size})"
            )
        if pool_pages < 2:
            raise ValueError(
                f"pool_pages must be >= 2 (page 0 is the reserved "
                f"scratch page), got {pool_pages}"
            )
        self.pool_pages = int(pool_pages)
        self.page_size = int(page_size)
        self.chunk_tokens = int(chunk_tokens)
        # Ascending allocation order (pop from the front via index) is
        # deterministic and makes tests legible.
        self._free: list[int] = list(range(1, pool_pages))
        self._ref: dict[int, int] = {}
        # Insertion-ordered = LRU order; match_prefix refreshes recency.
        self._cache: dict[str, _CachedChunk] = {}
        self._cached_pages: set[int] = set()
        # Chunk keys PINNED against LRU eviction (session-aware
        # retention): a live chat session's prefix
        # chunks stay resident between turns even under allocation
        # pressure — the pin, not recency, is what keeps turn N+1's
        # prefill ~one chunk. Bounded by the engine's pin budget.
        # REFCOUNTED per key: two sessions sharing a system-prompt
        # prefix pin the same chunks, and one closing must not strip
        # the survivor's retention.
        self._pinned: dict[str, int] = {}
        self.stats: dict[str, int] = {
            "prefix_queries": 0,
            "prefix_hits": 0,
            "prefix_hit_tokens": 0,
            "evictions": 0,
            "peak_pages_in_use": 0,
            # Disaggregated serving's kv_handoff traffic through THIS
            # pool: pages landed by an import / released by a completed
            # export — the page-level handoff ledger.
            "handoff_pages_in": 0,
            "handoff_pages_out": 0,
        }

    # -- accounting --------------------------------------------------------

    def free_pages(self) -> int:
        """Pages immediately allocatable WITHOUT evicting cached
        prefixes (the conservative headroom figure ``engine.stats()``
        reports; eviction can stretch it by the unreferenced cached
        pages)."""
        return len(self._free)

    def pages_in_use(self) -> int:
        """Pages referenced by at least one live row (the working set —
        what ``decode_bench`` reports as cache HBM actually in use)."""
        return sum(1 for r in self._ref.values() if r > 0)

    def pages_resident(self) -> int:
        """Pages holding content (referenced OR retained by the prefix
        cache) — everything not on the free list."""
        return self.pool_pages - 1 - len(self._free)

    def allocatable_pages(self) -> int:
        """Pages the allocator can actually deliver: immediately free
        plus whole cached-and-unpinned chunks no live row references —
        exactly what LRU eviction reclaims on demand (``_evictable``'s
        rule). The BATCH admission gate reads THIS, not ``free_pages``:
        a pool idling full of retired prefixes is headroom, not
        pressure — only live working sets and session pins subtract."""
        evictable = sum(
            len(chunk.pids)
            for key, chunk in self._cache.items()
            if key not in self._pinned
            and all(self._ref.get(p, 0) == 0 for p in chunk.pids)
        )
        return len(self._free) + evictable

    def pinned_pages(self) -> int:
        """Pages held ONLY by a pin: in pinned chunks and not currently
        referenced by any live row. This is the capacity a pin takes
        away from the allocator beyond the working set (``pages_in_use``
        already counts referenced pages), so it is the figure
        ``engine.stats()`` reports and the router's least-loaded scoring
        adds to page pressure — a session-heavy replica looks loaded
        BEFORE it starts preempting for its pinned residents."""
        return sum(
            1
            for key in self._pinned
            if key in self._cache
            for pid in self._cache[key].pids
            if self._ref.get(pid, 0) == 0
        )

    def refcount(self, pid: int) -> int:
        """Current reference count of one page (0 = free or cache-
        retained only). Introspection for the sharing pins: the
        speculative-rollback tests read it to prove a shared prefix
        page stays multiply-referenced — and byte-untouched — while a
        borrowing row speculates past it."""
        return self._ref.get(pid, 0)

    def cached_page_ids(self) -> set[int]:
        """Page ids currently retained by the prefix cache (a copy).
        The COW/rollback pins snapshot these pages' device content
        around a speculating neighbour's run."""
        return set(self._cached_pages)

    def pin(self, keys) -> None:
        """Protect cached chunks from LRU eviction (unknown keys are
        ignored — a chunk can lose the first-writer race or die with a
        pool reset before its pin lands). Pins are REFCOUNTED: each
        holder unpins exactly what it pinned, and the chunk returns to
        LRU only when the last holder lets go."""
        for key in keys:
            if key in self._cache:
                self._pinned[key] = self._pinned.get(key, 0) + 1

    def unpin(self, keys) -> None:
        """Release one holder's pins (idempotent for keys whose pin
        never landed); a chunk returns to ordinary LRU retention when
        its last holder unpins."""
        for key in keys:
            n = self._pinned.get(key)
            if n is None:
                continue
            if n <= 1:
                del self._pinned[key]
            else:
                self._pinned[key] = n - 1

    def _bump_peak(self) -> None:
        n = self.pages_in_use()
        if n > self.stats["peak_pages_in_use"]:
            self.stats["peak_pages_in_use"] = n

    # -- allocation --------------------------------------------------------

    def alloc(self, n: int) -> list[int] | None:
        """Take ``n`` fresh private pages (refcount 1 each), evicting
        unreferenced cached chunks LRU-first if the free list runs dry.
        Returns None — with the pool UNCHANGED — when even eviction
        cannot cover the request (the caller preempts or defers)."""
        if n == 0:
            return []
        evicted: list[str] = []
        while len(self._free) < n:
            key = self._evictable()
            if key is None:
                # Roll back nothing: eviction only ever freed pages,
                # which is harmless to keep; the allocation itself never
                # started.
                return None
            evicted.append(key)
            self._evict(key)
        out = self._free[:n]
        del self._free[:n]
        for pid in out:
            self._ref[pid] = 1
        self._bump_peak()
        return out

    def alloc_for_handoff(self, n: int) -> list[int] | None:
        """``alloc`` for a kv_handoff import: same allocator, same
        None-on-exhaustion contract, plus the handoff page ledger the
        disaggregation bench reports."""
        pids = self.alloc(n)
        if pids is not None:
            self.stats["handoff_pages_in"] += n
        return pids

    def note_handoff_out(self, n: int) -> None:
        """Count a completed export's pages (released by the engine's
        ``complete_handoff`` through the normal ``release`` path)."""
        self.stats["handoff_pages_out"] += n

    def _evictable(self) -> str | None:
        for key, chunk in self._cache.items():  # LRU-first
            if key in self._pinned:
                continue  # session-pinned: survives pressure
            if all(self._ref.get(p, 0) == 0 for p in chunk.pids):
                return key
        return None

    def _evict(self, key: str) -> None:
        chunk = self._cache.pop(key)
        self.stats["evictions"] += 1
        for pid in chunk.pids:
            self._cached_pages.discard(pid)
            self._ref.pop(pid, None)
            self._free.append(pid)

    def acquire(self, pids) -> None:
        """Add one reference to each page (prefix sharing)."""
        for pid in pids:
            self._ref[pid] = self._ref.get(pid, 0) + 1
        self._bump_peak()

    def release(self, pids) -> None:
        """Drop one reference per page. A page at refcount 0 returns to
        the free list UNLESS the prefix cache retains it (then it stays
        resident, evictable-on-demand)."""
        for pid in pids:
            r = self._ref.get(pid, 0) - 1
            if r < 0:
                raise RuntimeError(
                    f"page {pid} released more times than acquired — "
                    "engine bookkeeping bug"
                )
            self._ref[pid] = r
            if r == 0 and pid not in self._cached_pages:
                self._ref.pop(pid)
                self._free.append(pid)

    # -- prefix cache ------------------------------------------------------

    def _chain_digest(self, prev: str, tokens: np.ndarray) -> str:
        h = hashlib.sha1()
        h.update(prev.encode())
        h.update(np.ascontiguousarray(tokens, np.int32).tobytes())
        return h.hexdigest()

    def chain_keys(self, tokens: np.ndarray, length: int) -> list[str]:
        """The chain keys of every full chunk covering
        ``tokens[:length]`` (length floored to a chunk multiple) — what
        session retention pins. Pure digests: no cache reads, no
        references taken."""
        c = self.chunk_tokens
        key, keys = "", []
        for start in range(0, (int(length) // c) * c, c):
            key = self._chain_digest(key, tokens[start:start + c])
            keys.append(key)
        return keys

    def match_prefix(
        self, tokens: np.ndarray, max_tokens: int
    ) -> tuple[int, list[int], str]:
        """Longest cached chunk-chain prefix of ``tokens``, capped at
        ``max_tokens`` (callers cap at len-1 so at least one token is
        left to prefill — the next-token logits have to come from
        somewhere). Returns (cached_len, shared page ids, chain key at
        cached_len) with one reference ACQUIRED per shared page;
        cached_len is always a multiple of chunk_tokens. Carry the
        returned key into ``register_chunk(prev_key=...)`` so publishing
        stays one digest per chunk instead of a from-zero rewalk."""
        c = self.chunk_tokens
        self.stats["prefix_queries"] += 1
        limit = (max(0, int(max_tokens)) // c) * c
        key = ""
        pids: list[int] = []
        length = 0
        while length + c <= limit:
            nxt = self._chain_digest(key, tokens[length:length + c])
            chunk = self._cache.get(nxt)
            if chunk is None:
                break
            # LRU refresh: re-insert at the back.
            self._cache.pop(nxt)
            self._cache[nxt] = chunk
            key = nxt
            pids += chunk.pids
            length += c
        if length:
            self.stats["prefix_hits"] += 1
            self.stats["prefix_hit_tokens"] += length
            self.acquire(pids)
        return length, pids, key

    def cancel_match(self, length: int, pids) -> None:
        """Undo a ``match_prefix`` whose admission could not proceed
        (page starvation deferred the request): drop the acquired
        references AND the stats it counted — a head-of-line request
        retrying every tick must not inflate the hit counters the bench
        commits (each retry will re-match when it finally admits)."""
        self.release(pids)
        self.stats["prefix_queries"] -= 1
        if length:
            self.stats["prefix_hits"] -= 1
            self.stats["prefix_hit_tokens"] -= length

    def register_chunk(
        self, tokens: np.ndarray, start: int, pids,
        prev_key: str | None = None,
    ) -> str:
        """Publish the chunk covering ``tokens[start : start+chunk]``
        (its K/V now lives in ``pids``) for future ``match_prefix``
        hits. ``start`` must be chunk-aligned. ``prev_key`` is the chain
        key at ``start`` (from ``match_prefix`` or the previous
        ``register_chunk`` — ONE digest per publish); None falls back to
        rewalking the chain from token 0. First writer wins: an already
        published identical chunk keeps its pages and the duplicate
        stays private to its row. Returns the chunk's chain key (carry
        it forward as the next ``prev_key``)."""
        c = self.chunk_tokens
        if start % c:
            raise ValueError(
                f"register_chunk start {start} is not chunk-aligned "
                f"(chunk_tokens={c})"
            )
        if prev_key is None:
            prev_key = ""
            for j in range(0, start, c):
                prev_key = self._chain_digest(prev_key, tokens[j:j + c])
        key = self._chain_digest(prev_key, tokens[start:start + c])
        if key not in self._cache:
            self._cache[key] = _CachedChunk(pids=list(pids))
            self._cached_pages.update(pids)
        return key

    # -- lifecycle ---------------------------------------------------------

    def reset(self) -> None:
        """Drop EVERYTHING (free all pages, forget the prefix cache):
        the recovery path after a failed dispatch consumed the donated
        pool buffer — its content is gone, so any cached chunk would
        alias garbage."""
        self._free = list(range(1, self.pool_pages))
        self._ref.clear()
        self._cache.clear()
        self._cached_pages.clear()
        self._pinned.clear()
