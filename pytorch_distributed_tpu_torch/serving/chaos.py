"""Deterministic fault injection for the serving engine and the router.

The port of the JAX package's ``serving/chaos.py``. A ``FaultInjector``
installed on a batched engine (``engine.set_fault_injector``)
drives seeded, composable injections through host-side hooks around every
dispatch (one prefill-chunk forward or one decode-tick forward, with its
sampling); no kernel and no tensor ever sees it, so the fault paths run
the same kernels production runs.

The schedule machinery (scripted and seeded arming, the ``VirtualClock``,
firing counts) is ``utils/chaos.ScriptedFaults``.

Injection points:

- ``dispatch_error`` — raise before the forward runs: the engine sees what
  a failed dispatch looks like and drops its cache (dense) or resets its
  page pool (paged).
- ``drop_result`` — raise AFTER the forward ran and wrote K/V into the
  pool: the compute happened but the result never reached the scheduler
  (a lost transfer). Same recovery path; the pages written are not
  trusted.
- ``nan_row`` — flip one active row's non-finite flag, a poisoned logits
  row at the scheduler boundary. Targets decode ticks (plain or
  speculative); transient, so the quarantine retry succeeds.
- ``slow_tick`` — advance the engine's ``VirtualClock``, a stall; this is
  how deadline expiries are driven deterministically.

Faults come scripted (``Fault(tick=...)``) and/or seeded (per-tick
Bernoulli draws from one numpy generator); both compose. Every firing is
counted in ``injector.counts``.

``RouterFaultInjector`` is the router tier's: a fired ``replica_kill``
makes ``ReplicaRouter`` treat one replica as a lost process. On one card
that is how replica death is simulated — by the router's ``kill`` and this
injector, not by losing the device.
"""

from __future__ import annotations

import numpy as np

from pytorch_distributed_tpu_torch.utils import chaos as _chaos
from pytorch_distributed_tpu_torch.utils.chaos import (  # noqa: F401
    ScriptedFaults,
    VirtualClock,
)

FAULT_KINDS = ("dispatch_error", "drop_result", "nan_row", "slow_tick")


class ChaosDispatchError(RuntimeError):
    """Injected dispatch failure (the forward never ran)."""


class ChaosDroppedResult(RuntimeError):
    """Injected result loss: the forward ran (K/V written, compute paid)
    but the output never reached the scheduler."""


class Fault(_chaos.Fault):
    """One scripted serving injection. ``tick`` is the engine's step
    counter (first step = tick 1). ``program`` restricts dispatch faults
    to 'prefill', 'decode_step' or 'decode_spec_step' (None = the first
    dispatch of the tick); ``row`` picks the nan_row target slot (None =
    a seeded choice among the active rows); ``seconds`` is the slow_tick
    stall."""

    KINDS = FAULT_KINDS


class FaultInjector(ScriptedFaults):
    """Seeded and scripted fault schedule over an engine's dispatch hooks.

    ``faults``: scripted ``Fault`` list (each fires exactly once).
    ``seed``: enables the random schedule — each tick draws one Bernoulli
    per probability from a private generator, so the schedule is a pure
    function of (seed, tick sequence). ``clock``: the engine's
    ``VirtualClock``, required for slow_tick faults.
    """

    def __init__(
        self,
        faults: tuple[Fault, ...] | list[Fault] = (),
        *,
        seed: int | None = None,
        p_dispatch_error: float = 0.0,
        p_drop_result: float = 0.0,
        p_nan_row: float = 0.0,
        p_slow_tick: float = 0.0,
        slow_tick_s: float = 0.25,
        clock: VirtualClock | None = None,
    ) -> None:
        super().__init__(
            faults,
            seed=seed,
            probabilities={
                "dispatch_error": p_dispatch_error,
                "drop_result": p_drop_result,
                "nan_row": p_nan_row,
                "slow_tick": p_slow_tick,
            },
            slow_kinds=("slow_tick",),
            slow_s=slow_tick_s,
            clock=clock,
            fault_cls=Fault,
        )
        self._engine = None

    def install(self, engine) -> "FaultInjector":
        engine.set_fault_injector(self)  # sets our _engine back-reference
        return self

    # -- engine hooks (host-side only) ---------------------------------------

    def before_dispatch(self, kind: str, tick: int) -> None:
        f = self._pop("dispatch_error", kind)
        if f is not None:
            self.counts["dispatch_error"] += 1
            raise ChaosDispatchError(
                f"injected dispatch failure (tick {tick}, {kind})"
            )

    def after_dispatch(self, kind: str, tick: int, tok, bad):
        f = self._pop("drop_result", kind)
        if f is not None:
            self.counts["drop_result"] += 1
            raise ChaosDroppedResult(
                f"injected result loss (tick {tick}, {kind})"
            )
        if kind in ("decode_step", "decode_spec_step"):
            f = self._pop("nan_row", kind)
            if f is not None:
                row = f.row
                if row is None:
                    active = [
                        i for i, s in enumerate(self._engine._slots)
                        if s is not None
                    ]
                    if not active:
                        return tok, bad
                    picker = self._rng or np.random.default_rng(tick)
                    row = int(active[picker.integers(len(active))])
                bad = np.asarray(bad).copy()
                bad[row] = True
                self.counts["nan_row"] += 1
        return tok, bad


ROUTER_FAULT_KINDS = ("replica_kill",)


class RouterFault(_chaos.Fault):
    """One scripted router-tier injection. ``tick`` is the router's step
    counter (first step = tick 1); ``row`` picks the target replica id
    (None = a seeded choice among the replicas live at fire time)."""

    KINDS = ROUTER_FAULT_KINDS


class RouterFaultInjector(ScriptedFaults):
    """Seeded and scripted replica-death schedule for ``ReplicaRouter``: a
    fired ``replica_kill`` makes the router treat one replica as a lost
    process — no exception from the engine, no goodbye; the router must
    convert every in-flight request to a re-routed resume entry. Install a
    ``FaultInjector`` on individual replica engines for dispatch, NaN and
    slow faults; a whole storm is a pure function of its seeds."""

    def __init__(
        self,
        faults: tuple[RouterFault, ...] | list[RouterFault] = (),
        *,
        seed: int | None = None,
        p_replica_kill: float = 0.0,
        clock: VirtualClock | None = None,
    ) -> None:
        super().__init__(
            faults,
            seed=seed,
            probabilities={"replica_kill": p_replica_kill},
            clock=clock,
            fault_cls=RouterFault,
        )

    def install(self, router) -> "RouterFaultInjector":
        router.set_fault_injector(self)
        return self

    def pop_kill(self, live_ids) -> int | None:
        """The replica to kill this tick, or None. Scripted faults may pin
        the target (``row``); seeded draws pick uniformly among the
        replicas live at fire time. A fault whose pinned target is already
        down is consumed without effect."""
        f = self._pop("replica_kill", None)
        if f is None:
            return None
        live_ids = list(live_ids)
        if f.row is not None:
            if f.row not in live_ids:
                return None
            self._count("replica_kill")
            return int(f.row)
        if not live_ids:
            return None
        if self._rng is None:
            # Unseeded scripted faults still need an advancing generator
            # for the target choice.
            self._rng = np.random.default_rng(0)
        self._count("replica_kill")
        return int(live_ids[self._rng.integers(len(live_ids))])
