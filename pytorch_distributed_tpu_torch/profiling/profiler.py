"""Scheduled profiler tracing on ``torch.profiler``.

The port of the JAX package's ``profiling/profiler.py``: a step-counting
schedule (the reference's wait 2, warmup 2, active 6, repeat 1), a trace
directory per rank (``<trace_dir>/rank<r>``, ``r`` the process group's
rank where one exists, else 0) and a per-step annotation
(``step_context(n)``). The ``Trainer`` calls ``step()`` once per
optimizer step and wraps each step in ``step_context``.

The active steps are the JAX schedule's: steps ``wait + warmup`` to
``wait + warmup + active - 1`` of each cycle, ``repeat`` cycles (0:
forever). In JAX the warmup steps only lengthen the wait; here they run
the profiler and discard what it records, which is what CUPTI needs to
start its activity buffers before the window that counts.

Each finished cycle writes one Kineto Chrome trace,
``<trace_dir>/rank<r>/<host>_<pid>.<ms>.pt.trace.json.gz``
(``tensorboard_trace_handler``), which ``find_trace_files``' default
pattern finds and ``profiling.trace_analysis`` reads. Activities are CPU
and CUDA on a CUDA device, CPU alone on the CPU; on a CUDA device a cycle
that recorded no device activity raises instead of leaving a host-only
trace. At both edges of an active window the device is synchronized, so
the trace holds the device work of the window's steps, all of it and
nothing else, and ``window_seconds`` keeps each window's host clock.
A window opened without warmup loses its first launch's record while
CUPTI starts; and in a process that has run for minutes, an active
window can lose the records of its first milliseconds of launches,
warmup or not (PERF.md section 7).
"""

from __future__ import annotations

import contextlib
import glob
import os
import time
from pathlib import Path

import torch
from torch.profiler import (
    ProfilerActivity,
    profile,
    record_function,
    schedule,
    tensorboard_trace_handler,
)

from pytorch_distributed_tpu_torch.utils.device import resolve_device


def _rank() -> int:
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


class ScheduledProfiler:
    """``device``: where the profiled work runs (None: the GPU). The JAX
    signature's ``create_perfetto_trace`` has no counterpart: the Kineto
    JSON opens in Perfetto as it is."""

    def __init__(
        self,
        trace_dir: str | Path,
        *,
        wait: int = 2,
        warmup: int = 2,
        active: int = 6,
        repeat: int = 1,
        device=None,
    ):
        if active <= 0:
            raise ValueError("active must be positive")
        self.trace_dir = str(Path(trace_dir) / f"rank{_rank()}")
        self.wait = wait
        self.warmup = warmup
        self.active = active
        self.repeat = repeat  # 0 = cycle forever, like torch.profiler
        self.device = resolve_device(device)
        self._count = 0
        self._cycles_done = 0
        self._tracing = self._phase() == "active"
        # Host seconds of each finished active window, device drained at
        # both edges.
        self.window_seconds: list[float] = []
        self._window_t0 = time.perf_counter() if self._tracing else None
        self._write = tensorboard_trace_handler(self.trace_dir,
                                                use_gzip=True)
        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        self._prof = profile(
            activities=activities,
            schedule=schedule(wait=wait, warmup=warmup, active=active,
                              repeat=repeat),
            on_trace_ready=self._on_trace_ready,
        )
        self._prof.start()
        self._open = True

    # -- schedule ---------------------------------------------------------
    def _phase(self) -> str:
        """The JAX package's phase of the step about to run: "wait"
        (warmup included), "active" or "done"."""
        cycle_len = self.wait + self.warmup + self.active
        if self.repeat and self._cycles_done >= self.repeat:
            return "done"
        pos = self._count % cycle_len
        if pos < self.wait + self.warmup:
            return "wait"
        return "active"

    def _on_trace_ready(self, prof) -> None:
        self._write(prof)
        if self.device.type != "cuda":
            return
        from pytorch_distributed_tpu_torch.profiling import trace_analysis

        newest = max(find_trace_files(self.trace_dir), key=os.path.getmtime)
        if not trace_analysis.device_op_events(
                trace_analysis.load_trace(newest)):
            raise RuntimeError(
                f"the profiler recorded no CUDA activity on {self.device} "
                f"({newest}): CUPTI traced nothing")

    def step(self) -> None:
        """Advance the schedule by one (optimizer) step. Must be called
        exactly once per step, after the step runs."""
        was_active = self._phase() == "active"
        self._count += 1
        self._tracing = self._phase() == "active"
        if was_active and not self._tracing:
            self._cycles_done += 1
        if not self._open:
            return
        if was_active != self._tracing:
            self._edge()
        self._prof.step()

    def _edge(self) -> None:
        """An edge of an active window: the device drains, so the window
        holds its own steps' device work and none of its neighbours', and
        the window's host clock starts or ends."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        if self._window_t0 is None:
            self._window_t0 = now
        else:
            self.window_seconds.append(now - self._window_t0)
            self._window_t0 = None

    def step_context(self, step_num: int):
        """Context manager annotating one train step in the trace."""
        if self._phase() == "active":
            return record_function(f"train_step#{step_num}")
        return contextlib.nullcontext()

    def close(self) -> None:
        """Stop the profiler; a cycle cut short writes what it recorded."""
        if self._open:
            self._open = False
            if self._tracing:
                self._edge()
            self._prof.stop()
            self._tracing = False

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def find_trace_files(trace_dir: str | Path, pattern: str = "*.trace.json.gz"):
    """Locate Chrome-trace JSONs under a (possibly per-rank) trace dir."""
    return sorted(
        glob.glob(str(Path(trace_dir) / "**" / pattern), recursive=True)
    )
