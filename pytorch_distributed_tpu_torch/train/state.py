"""Train state: the port of the JAX package's ``train/state.py``.

One value carried through the step: params (the port's tree), the
optimizer state (``train/optim.Optimizer.init``), the step count, a Python
int (the JAX package's is an int32 scalar: the host counts the data
windows it feeds, so reading it costs no sync), and ``guard``, the anomaly
guard's carry (``train/guard.GuardState``) when the guard is on, else
None. A state with the guard off is the same as before the guard existed.
"""

from __future__ import annotations

from typing import Any, NamedTuple


class TrainState(NamedTuple):
    params: Any
    opt_state: Any
    step: int
    guard: Any = None


def init_train_state(params, tx, *, guard: Any = None) -> TrainState:
    """With ``guard`` (a GuardState) the optimizer's counts live on the
    params' device too (``Optimizer.init(on_device=True)``): a guarded step
    must hold them back on an anomaly without asking the host."""
    opt_state = (tx.init(params) if guard is None
                 else tx.init(params, on_device=True))
    return TrainState(params=params, opt_state=opt_state, step=0,
                      guard=guard)
