"""Deterministic fault injection for the training loop: the port of the
JAX package's ``train/chaos.py``, on the port's own schedule engine
(``utils/chaos.ScriptedFaults``).

Seeded and scripted faults fire through HOST hooks at the Trainer's step
and save boundaries; the step never sees the injector, so the fault paths
run the same step, kernels and launches as a clean run.

The fault kinds:

- ``crash`` — the process dies at a step boundary (``crash_mode="exit"``:
  ``os._exit(CRASH_EXIT_CODE)``, no finally blocks, no signal handlers, no
  async-save finalize, as a kill -9 or a lost machine) or raises
  ``ChaosCrash`` in process for tests (``"raise"``). With
  ``program="save"`` it lands INSIDE a checkpoint save, the instant before
  the save becomes visible (the checkpoint module's save hook).
- ``sigterm`` — SIGTERM to this process: drives the preemption path
  (``save_on_preemption``).
- ``bad_batch`` — the next step's host batch gets token ids outside
  ``[0, vocab)`` (``bad_token``, default -1) in its first eighth, as a
  torn shard read would; the guard (``train/guard``) must catch and skip
  it. Transient: a replayed window after a rollback gets the clean batch.
- ``ckpt_corrupt`` — one byte of the newest COMMITTED checkpoint's payload
  is flipped (never its COMMIT marker or manifest: the checksums must
  catch it), so ``resume_latest`` falls back to an older checkpoint.
- ``slow_step`` — a stall between steps (a straggler), through ``sleep``
  (``time.sleep`` by default; a ``VirtualClock``'s ``advance`` in tests).

``train/supervisor.py`` storms all of these at once and proves the run's
recovery bit-exact against a fault-free run.
"""

from __future__ import annotations

import json
import os
import signal
import time
from pathlib import Path

import numpy as np

from pytorch_distributed_tpu_torch.train import checkpoint as ckpt_lib
from pytorch_distributed_tpu_torch.utils import chaos as _chaos
from pytorch_distributed_tpu_torch.utils.chaos import (  # noqa: F401
    VirtualClock,
)

TRAIN_FAULT_KINDS = (
    "crash", "sigterm", "bad_batch", "ckpt_corrupt", "slow_step"
)

# The exit status of a crash fault (not python's 1 nor SIGTERM's 143, so
# the supervisor can tell restarts apart).
CRASH_EXIT_CODE = 43


class ChaosCrash(BaseException):
    """The in-process form of an injected crash (``crash_mode="raise"``):
    a BaseException, so no ``except Exception`` swallows it."""


class TrainFault(_chaos.Fault):
    """One scripted training fault. ``tick`` is the 1-based optimizer step
    about to run. ``program`` restricts a crash to "step" (the default:
    at the step boundary) or "save" (inside the save, before it
    commits)."""

    KINDS = TRAIN_FAULT_KINDS


class TrainFaultInjector(_chaos.ScriptedFaults):
    """Seeded and scripted faults over the Trainer's host hooks.

    ``crash_mode``: "raise" (``ChaosCrash``) or "exit"
    (``os._exit(CRASH_EXIT_CODE)``). ``counts_path``: ``counts`` is written
    there after every firing, before the fault acts, so a supervisor can
    sum the faults of attempts that died. ``sleep``: how ``slow_step``
    stalls (``time.sleep`` by default).
    """

    def __init__(
        self,
        faults: tuple[TrainFault, ...] | list[TrainFault] = (),
        *,
        seed: int | None = None,
        p_crash: float = 0.0,
        p_sigterm: float = 0.0,
        p_bad_batch: float = 0.0,
        p_ckpt_corrupt: float = 0.0,
        p_slow_step: float = 0.0,
        slow_step_s: float = 0.05,
        crash_mode: str = "raise",
        bad_token: int = -1,
        counts_path: str | Path | None = None,
        sleep=None,
    ) -> None:
        if crash_mode not in ("raise", "exit"):
            raise ValueError(f"unknown crash_mode {crash_mode!r} "
                             "(implemented: raise, exit)")
        super().__init__(
            faults,
            seed=seed,
            probabilities={
                "crash": p_crash,
                "sigterm": p_sigterm,
                "bad_batch": p_bad_batch,
                "ckpt_corrupt": p_ckpt_corrupt,
                "slow_step": p_slow_step,
            },
            slow_kinds=("slow_step",),
            slow_s=slow_step_s,
            advance=sleep if sleep is not None else time.sleep,
            fault_cls=TrainFault,
        )
        self._crash_mode = crash_mode
        self._bad_token = int(bad_token)
        self._counts_path = Path(counts_path) if counts_path else None
        self._corrupt_rng = np.random.default_rng(
            seed if seed is not None else 0)

    def install(self, trainer) -> "TrainFaultInjector":
        """Wire into a Trainer: its step and save hooks, and the checkpoint
        module's save hook (crashes inside a save)."""
        trainer.set_fault_injector(self)
        ckpt_lib.set_save_hook(self.on_save)
        return self

    # -- trainer hooks (host only) ----------------------------------------
    def on_step(self, step: int) -> None:
        """Arm this step's faults; slow_step stalls at once."""
        self.on_tick(step)

    def before_step(self, step: int, batch: dict) -> dict:
        """Fire the step-boundary faults; returns the (possibly corrupt)
        numpy batch the step trains on."""
        if self._pop("crash", "step") is not None:
            self._count("crash")
            self._crash(f"injected crash at step {step}")
        if self._pop("sigterm", "step") is not None:
            self._count("sigterm")
            os.kill(os.getpid(), signal.SIGTERM)
        if self._pop("bad_batch", "step") is not None:
            self._count("bad_batch")
            batch = {k: np.array(v, copy=True) for k, v in batch.items()}
            flat = batch["inputs"].reshape(-1)
            flat[:max(1, flat.size // 8)] = self._bad_token
        return batch

    def on_save(self, stage: str, directory) -> None:
        """The checkpoint module's hook: a ``program="save"`` crash fires
        the instant before the save becomes visible."""
        if stage == "pre_commit" and self._pop("crash", "save") is not None:
            self._count("crash")
            self._crash(f"injected crash mid-save of {directory}")

    def after_save(self, checkpoint_root) -> None:
        """After a save: ckpt_corrupt flips one byte of the newest
        committed checkpoint's npz payload."""
        if self._pop("ckpt_corrupt", "step") is None:
            return
        latest = ckpt_lib.latest_checkpoint(checkpoint_root)
        if latest is None:
            return
        target = Path(latest) / "arrays.npz"
        if not target.is_file():
            return
        data = bytearray(target.read_bytes())
        if not data:
            return
        data[int(self._corrupt_rng.integers(len(data)))] ^= 0xFF
        target.write_bytes(bytes(data))
        self._count("ckpt_corrupt")

    # -- internals ---------------------------------------------------------
    def _count(self, kind: str) -> None:
        # Every firing, slow_step's included, is on disk before the fault
        # acts: a crash cannot erase its own record.
        super()._count(kind)
        if self._counts_path is not None:
            self._counts_path.write_text(json.dumps(self.counts))

    def _crash(self, message: str):
        if self._crash_mode == "exit":
            os._exit(CRASH_EXIT_CODE)
        raise ChaosCrash(message)
