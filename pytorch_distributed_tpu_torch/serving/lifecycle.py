"""Request lifecycle vocabulary for the serving engine and the router.

Every submitted request ends in exactly one TERMINAL state, delivered as a
``RequestResult`` through ``pop_result``:

- ``DONE``    — ran to its token budget (or its EOS); ``tokens`` is the
  prompt followed by every generated token.
- ``FAILED``  — the engine gave up on it: non-finite logits persisted
  after the one quarantine retry (a fresh re-prefill of its clean
  prefix), or it exhausted its fault-resume budget
  (``request_retries``). ``tokens`` holds the clean tokens generated
  before the fault.
- ``ABORTED`` — the client called ``abort(rid)``; partial prefix.
- ``EXPIRED`` — its deadline (``submit(timeout_s=...)``) passed while
  queued or mid-decode; partial prefix.

    submit -> QUEUED -> ACTIVE -> DONE
                 |         |----> ABORTED / EXPIRED / FAILED
                 |         '----> QUEUED (fault resume: NaN quarantine,
                 |                dispatch failure, engine restore or
                 |                adoption by another replica;
                 |                preemption: the page pool ran dry)
                 '------> ABORTED / EXPIRED

A request may bounce ACTIVE -> QUEUED any number of times; the invariant
is that every rid reaches exactly one terminal result. Every bounce keeps
the tokens so far and resumes token-identically: the resumed row
re-prefills prompt + generated tokens, and a sampled row draws its next
token from the same (seed, token index) generator. Preemption is load
shedding, not a fault: it charges no retry budget and cannot FAIL a
request. At the router tier a request can also move between engines:
when a replica dies its in-flight rows become resume entries
(``EngineSnapshot``) that a survivor ``adopt``s.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

DONE = "DONE"
FAILED = "FAILED"
ABORTED = "ABORTED"
EXPIRED = "EXPIRED"
TERMINAL_STATES = (DONE, FAILED, ABORTED, EXPIRED)


@dataclasses.dataclass
class RequestResult:
    """One request's terminal outcome. ``tokens`` holds the prompt followed
    by every clean token generated before the terminal transition."""

    rid: int
    state: str  # one of TERMINAL_STATES
    tokens: np.ndarray  # [prompt + generated-so-far] int32
    reason: str = ""  # diagnostic for FAILED/ABORTED/EXPIRED

    def __post_init__(self) -> None:
        if self.state not in TERMINAL_STATES:
            raise ValueError(
                f"state must be one of {TERMINAL_STATES}, got {self.state!r}"
            )


@dataclasses.dataclass
class EngineSnapshot:
    """Host-side engine state for crash recovery and failover: queued
    entries and every in-flight row as a resume entry carrying its tokens
    so far, the rid counter and the undelivered results. The KV pool is
    not captured: it is rebuilt from the prefixes, which is what
    ``restore`` (or ``adopt`` on another engine) and admission do. Capture
    between ``step`` calls."""

    pending: list  # engine._Pending entries, ascending rid
    next_rid: int
    results: dict[int, RequestResult]  # undelivered terminal results
    stats: dict[str, Any] = dataclasses.field(default_factory=dict)


class AdmissionQueueFull(RuntimeError):
    """The bounded admission queue (``queue_limit``) is full under the
    ``reject`` backpressure policy (or ``block`` timed out): submitted load
    exceeds what the engine drains. The message carries the limit."""


class RequestFailed(RuntimeError):
    """A request's output would be garbage (non-finite logits after the
    retry): it fails loudly instead of emitting tokens."""


class PagePoolExhausted(RuntimeError):
    """The paged engine could not free a KV page even after preempting
    every other active request — an invariant violation (construction
    validates ``pool_pages >= max_len/page_size + 1``, so one full-length
    row always fits), raised loudly instead of hanging."""


class DispatchFailure(RuntimeError):
    """The engine's consecutive-dispatch-failure budget
    (``dispatch_retries``) is exhausted. Engine state is CONSISTENT when
    this raises: every in-flight request was requeued (or FAILED past its
    retry budget) and the page pool reset — the caller can ``snapshot()``
    and rebuild, or step again later. The router treats it as replica
    death."""


class RouterOverloaded(RuntimeError):
    """Load shedding (``serving/router.py``): every routable replica is past
    its admission thresholds (queue depth and/or page headroom), so the
    router rejects loudly instead of queueing without bound.
    ``retry_after_s`` is the router's drain-time estimate; the HTTP front
    door maps it onto a ``Retry-After`` header."""

    def __init__(self, message: str, *, retry_after_s: float | None = None):
        super().__init__(message)
        self.retry_after_s = retry_after_s
