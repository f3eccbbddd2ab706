"""SLO priority tiers for the serving engine (host-side policy only).

Three classes, ranked (lower rank = higher priority):

- ``INTERACTIVE`` (0) — latency-sensitive: admits ahead of everything,
  earliest deadline first within the tier, and may preempt strictly
  lower-priority active rows for a slot or for pages at admission.
- ``STANDARD`` (1) — the default: strict FIFO within the tier.
- ``BATCH`` (2) — throughput traffic: admits only while the page pool has
  free headroom, is first in line for preemption, and its rows sit out
  decode ticks and chunk prefills while an interactive row is live (a
  skipped tick recomputes nothing, so its tokens are delayed, never
  changed).

Preemption picks the active row with the MAXIMUM ``(tier rank, rid)``:
lowest priority first, then youngest.
"""

from __future__ import annotations

INTERACTIVE = "interactive"
STANDARD = "standard"
BATCH = "batch"
PRIORITIES = (INTERACTIVE, STANDARD, BATCH)
TIER_RANK = {name: rank for rank, name in enumerate(PRIORITIES)}
TIER_NAME = {rank: name for rank, name in enumerate(PRIORITIES)}


def check_priority(priority: str) -> int:
    """Priority-class name -> tier rank, rejecting unknown classes."""
    rank = TIER_RANK.get(priority)
    if rank is None:
        raise ValueError(
            f"unknown priority class {priority!r}: expected one of "
            f"{PRIORITIES} (lower-latency tiers admit first; 'standard' "
            "is the untier'd default)"
        )
    return rank


def queue_key(tier: int, deadline: float | None, rid: int):
    """Admission-queue sort key: tier rank, then — INTERACTIVE only —
    earliest deadline, then rid (= submit order)."""
    dl = (
        deadline
        if tier == TIER_RANK[INTERACTIVE] and deadline is not None
        else float("inf")
    )
    return (tier, dl, rid)


def preemption_key(tier: int, rid: int):
    """Victim-selection key: the active row with the MAX key is preempted
    first (lowest priority, then youngest)."""
    return (tier, rid)
