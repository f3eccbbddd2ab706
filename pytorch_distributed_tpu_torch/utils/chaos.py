"""Seeded and scripted fault-injection primitives.

The port's copy of the JAX package's ``utils/chaos.py`` (numpy only, so it
is copied rather than imported). The serving injector
(``serving/chaos.py``) builds on it:

- ``VirtualClock`` — a clock that advances ONLY through injected time
  (backoff sleeps, stall faults), so deadlines, backoff and stalls replay
  exactly run after run.
- ``Fault`` — one scripted injection, validated against a domain's
  fault-kind catalog (subclass and set ``KINDS``).
- ``ScriptedFaults`` — the schedule engine: scripted faults fire exactly
  once at their tick; a seeded schedule draws one Bernoulli per (kind,
  tick) from a private generator, so the whole storm is a pure function
  of (seed, tick sequence); "slow" kinds advance the clock at once; every
  firing is counted in ``counts``, so a run can assert that its fault
  schedule actually fired.

Everything here is host-side: no kernel or tensor ever sees an injector.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, ClassVar

import numpy as np


class VirtualClock:
    """A deterministic clock: advances ONLY via ``sleep``/``advance``
    (backoff sleeps and slow-tick faults). Pass it as both ``clock=`` and
    ``sleep=`` to the consumer so deadlines, backoff and stalls replay
    identically run after run."""

    def __init__(self, start: float = 0.0) -> None:
        self.now = float(start)

    def __call__(self) -> float:
        return self.now

    def sleep(self, seconds: float) -> None:
        self.now += max(0.0, float(seconds))

    advance = sleep


@dataclasses.dataclass(frozen=True)
class Fault:
    """One scripted injection. ``tick`` is the consumer's step counter
    (first step = tick 1). ``program`` restricts the fault to one named
    injection point (None = first eligible point of the tick); ``row``
    picks a target index where the domain has one (serving's nan_row
    slot); ``seconds`` is the stall length for slow kinds (None = the
    injector's default). Subclasses set ``KINDS`` to validate ``kind``
    against their catalog at construction."""

    tick: int
    kind: str
    program: str | None = None
    row: int | None = None
    seconds: float | None = None

    KINDS: ClassVar[tuple[str, ...] | None] = None

    def __post_init__(self) -> None:
        if self.KINDS is not None and self.kind not in self.KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r}; known: {self.KINDS}"
            )


class ScriptedFaults:
    """Seeded and scripted fault schedule over per-tick hooks.

    ``faults``: scripted ``Fault`` list (each fires exactly once).
    ``seed``: enables the random schedule — each tick draws one Bernoulli
    per entry of ``probabilities`` (in insertion order, so the schedule is
    a pure function of the seed and the tick sequence).
    ``slow_kinds``: kinds that stall rather than arm — they advance the
    clock (or call ``advance``) at once in ``on_tick``.
    ``clock``/``advance``: how slow kinds apply their stall; ``clock`` (a
    VirtualClock) keeps the stall deterministic, ``advance`` (e.g. a real
    ``time.sleep``) makes it a wall-clock slowdown.
    ``fault_cls``: the domain's Fault subclass (its ``KINDS`` validates
    seeded draws too, and seeds ``counts``).
    """

    def __init__(
        self,
        faults: tuple[Fault, ...] | list[Fault] = (),
        *,
        seed: int | None = None,
        probabilities: dict[str, float] | None = None,
        slow_kinds: tuple[str, ...] = (),
        slow_s: float = 0.25,
        clock: VirtualClock | None = None,
        advance: Callable[[float], None] | None = None,
        fault_cls: type[Fault] = Fault,
    ) -> None:
        self._scripted: dict[int, list[Fault]] = {}
        for f in faults:
            self._scripted.setdefault(f.tick, []).append(f)
        self._rng = (
            np.random.default_rng(seed) if seed is not None else None
        )
        self._p = dict(probabilities or {})
        self._slow_kinds = tuple(slow_kinds)
        self._slow_s = float(slow_s)
        self._advance = advance if advance is not None else (
            clock.advance if clock is not None else None
        )
        self._fault_cls = fault_cls
        self._armed: list[Fault] = []  # this tick's not-yet-fired faults
        kinds = fault_cls.KINDS if fault_cls.KINDS else tuple(self._p)
        self.counts = {k: 0 for k in kinds}

    def on_tick(self, tick: int) -> None:
        """Arm this tick's faults (scripted and seeded draws) and apply
        slow-kind stalls at once."""
        self._armed = list(self._scripted.pop(tick, ()))
        if self._rng is not None:
            for kind, p in self._p.items():
                if p > 0.0 and self._rng.random() < p:
                    self._armed.append(
                        self._fault_cls(tick, kind, seconds=self._slow_s)
                    )
        for f in [f for f in self._armed if f.kind in self._slow_kinds]:
            self._armed.remove(f)
            if self._advance is None:
                raise ValueError(
                    f"{f.kind} faults need a clock: pass the consumer's "
                    "VirtualClock as clock=... (or a sleep fn as "
                    "advance=...)"
                )
            self._advance(self._slow_s if f.seconds is None else f.seconds)
            self._count(f.kind)

    def _count(self, kind: str) -> None:
        """Record one firing."""
        self.counts[kind] += 1

    def _pop(self, kind: str, program: str | None) -> Fault | None:
        """Take (and consume) the first armed fault of ``kind`` whose
        ``program`` restriction matches, if any."""
        for f in self._armed:
            if f.kind == kind and f.program in (None, program):
                self._armed.remove(f)
                return f
        return None
