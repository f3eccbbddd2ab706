"""Minimal host-side logging: a configured ``pdtpu`` logger, the
structured lifecycle line the serving engine emits, and
``is_process_zero``, the rank that logs."""

from __future__ import annotations

import logging
import sys


def get_logger(name: str = "pdtpu") -> logging.Logger:
    """The named logger under the ``pdtpu`` root; the root gets one stdout
    handler the first time any logger is asked for."""
    root = logging.getLogger("pdtpu")
    if not root.handlers:
        handler = logging.StreamHandler(sys.stdout)
        handler.setFormatter(
            logging.Formatter("[%(asctime)s %(name)s] %(message)s", "%H:%M:%S")
        )
        root.addHandler(handler)
        root.setLevel(logging.INFO)
        root.propagate = False
    return logging.getLogger(name)


def log_event(
    event: str, *, logger: logging.Logger | None = None, **fields
) -> None:
    """One structured lifecycle line, ``event=<name> key=value ...``, keys
    sorted and Nones dropped, at DEBUG on ``pdtpu.serving`` (enable with
    ``get_logger("pdtpu.serving").setLevel(logging.DEBUG)``). The line is
    formatted only when DEBUG is enabled, so a quiet engine pays one level
    check per event."""
    lg = logger or get_logger("pdtpu.serving")
    if lg.isEnabledFor(logging.DEBUG):
        parts = [f"event={event}"] + [
            f"{k}={fields[k]}"
            for k in sorted(fields)
            if fields[k] is not None
        ]
        lg.debug(" ".join(parts))


def is_process_zero() -> bool:
    """Rank 0 of ``torch.distributed`` (True without a process group): the
    rank that logs and writes metrics."""
    import torch.distributed as dist

    return not (dist.is_available() and dist.is_initialized()) \
        or dist.get_rank() == 0
