"""Train state: the port of the JAX package's ``train/state.py``.

One value carried through the step: params (the port's tree), the
optimizer state (``train/optim.Optimizer.init``) and the step count, a
Python int (the JAX package's is an int32 scalar). The anomaly-guard carry
is not ported.
"""

from __future__ import annotations

from typing import Any, NamedTuple


class TrainState(NamedTuple):
    params: Any
    opt_state: Any
    step: int


def init_train_state(params, tx) -> TrainState:
    return TrainState(params=params, opt_state=tx.init(params), step=0)
