"""Request lifecycle vocabulary for the serving engine.

Every submitted request ends in exactly one TERMINAL state, delivered as a
``RequestResult`` through ``pop_result``:

- ``DONE``    — ran to its token budget (or its EOS); ``tokens`` is the
  prompt followed by every generated token.
- ``FAILED``  — the engine gave up on it: its logits went non-finite. The
  JAX package retries such a row once in quarantine; this port fails it
  at once, with the reason, and keeps the clean tokens generated before.
- ``ABORTED`` — the client called ``abort(rid)``; partial prefix.
- ``EXPIRED`` — its deadline (``submit(timeout_s=...)``) passed while
  queued or mid-decode; partial prefix.

    submit -> QUEUED -> ACTIVE -> DONE
                 |         |----> ABORTED / EXPIRED / FAILED
                 |         '----> QUEUED (preemption: the page pool ran
                 |                dry; tokens so far are kept and the
                 |                request resumes token-identically)
                 '------> ABORTED / EXPIRED
"""

from __future__ import annotations

import dataclasses

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


class AdmissionQueueFull(RuntimeError):
    """The bounded admission queue (``queue_limit``) is full: submitted load
    exceeds what the engine drains. The message carries the limit."""


class PagePoolExhausted(RuntimeError):
    """The paged engine could not free a KV page even after preempting
    every other active request — an invariant violation (construction
    validates ``pool_pages >= max_len/page_size + 1``, so one full-length
    row always fits), raised loudly instead of hanging."""
