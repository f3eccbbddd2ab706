"""Convert parameters between the JAX package's tree and the port's.

The JAX trees (``pytorch_distributed_tpu.models.gpt2`` and ``.llama``)
stack every block leaf along a leading [L] axis; the port keeps a list of
per-layer dicts with the same leaf names and per-layer shapes
(``models/gpt2``, ``models/llama``). Quantized weights
(``ops/quant.quantize_weight``: ``{"q8", "scale"}``, stacked ``[L, ...]``
on the JAX side) convert like any other dict of leaves, so the JAX
``quantize_decode_params(params)`` converts exactly. Both
directions go through numpy, so this module imports neither JAX nor the
JAX package: pass ``jax.device_get(params)`` (or any tree of numpy
arrays) in, get numpy arrays back out. Kernels keep their [in, out...]
layout on both sides, so nothing is transposed and a round trip is exact.

bfloat16 leaves cross as their 16-bit payload: numpy has no bfloat16 of
its own (JAX's comes from ``ml_dtypes``, which this module does not
import), so a bf16 array is viewed as int16 and reinterpreted as
``torch.bfloat16``, and back. ``params_to_jax`` returns ml_dtypes bfloat16
arrays when that type is registered with numpy (JAX has loaded it), else
the raw uint16 payload.

``stage_params_from_jax`` gives one pipeline stage's params (its layers
only) from the JAX tree. ``opt_state_from_jax`` / ``opt_state_to_jax``
convert the optimizer state
of the JAX chain (``train/optim.make_optimizer``: a tuple holding a
``ScaleByAdamState(count, mu, nu)`` and a ``ScaleByScheduleState(count)``)
to and from the port's ``train/optim`` state, with mu and nu in the same
per-layer layout as the params.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from pytorch_distributed_tpu_torch.config import ModelConfig


def _to_torch(x) -> torch.Tensor:
    x = np.array(x, copy=True)
    if x.dtype.name == "bfloat16":  # ml_dtypes: carry the payload exactly
        return torch.from_numpy(x.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(x)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype != torch.bfloat16:
        return t.numpy()
    payload = t.view(torch.int16).numpy().view(np.uint16)
    try:
        return payload.view(np.dtype("bfloat16"))
    except TypeError:  # no bfloat16 registered with numpy: the payload
        return payload


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


# Each family's top-level entries, in its ``init`` order.
_TOP_LEVEL = {
    "gpt2": ("wte", "wpe", "blocks", "ln_f"),
    "llama": ("wte", "blocks", "ln_f", "lm_head"),
}


def _top_level(cfg: ModelConfig) -> tuple[str, ...]:
    if cfg.family not in _TOP_LEVEL:
        raise NotImplementedError(
            f"interop converts the gpt2 and llama families, got "
            f"{cfg.family!r}"
        )
    return _TOP_LEVEL[cfg.family]


def params_from_jax(tree: dict[str, Any], cfg: ModelConfig) -> dict:
    """JAX gpt2 or llama params (numpy leaves, blocks stacked [L, ...])
    -> port params (torch tensors, blocks a list of L per-layer dicts);
    the other entries (embeddings, norms, llama's ``lm_head``) convert
    leaf for leaf."""
    keys = _top_level(cfg)
    n_layer = cfg.n_layer
    blocks = tree["blocks"]
    for leaf in _leaves(blocks):
        if np.shape(leaf)[0] != n_layer:
            raise ValueError(
                f"stacked block leaf of shape {np.shape(leaf)} does not "
                f"lead with n_layer={n_layer}"
            )
    return {
        k: [_map(blocks, lambda x, i=i: _to_torch(np.asarray(x)[i]))
            for i in range(n_layer)]
        if k == "blocks" else _map(tree[k], _to_torch)
        for k in keys
    }


def stage_params_from_jax(tree: dict[str, Any], cfg: ModelConfig,
                          stage: int, n_stages: int) -> dict:
    """``params_from_jax`` for pipeline stage ``stage`` of ``n_stages``:
    the blocks of layers ``[stage L/S, (stage+1) L/S)`` only (the JAX
    pipeline's slice of its stacked leaves), every other entry whole, as
    ``parallel/pipeline.shard_pipeline_state`` keeps them."""
    from pytorch_distributed_tpu_torch.parallel.sharding import (
        layers_of_stage,
    )

    layers = layers_of_stage(cfg.n_layer, stage, n_stages)
    keys = _top_level(cfg)
    return {
        k: [_map(tree["blocks"], lambda x, i=i: _to_torch(np.asarray(x)[i]))
            for i in layers]
        if k == "blocks" else _map(tree[k], _to_torch)
        for k in keys
    }


def params_to_jax(params: dict, cfg: ModelConfig) -> dict[str, Any]:
    """Port params -> the JAX tree layout with numpy leaves (the inverse
    of ``params_from_jax``); feed it to JAX with ``jax.numpy.asarray``."""
    if len(params["blocks"]) != cfg.n_layer:
        raise ValueError(
            f"{len(params['blocks'])} blocks for n_layer={cfg.n_layer}"
        )

    to_np = _to_numpy

    def stack(path):
        return np.stack([to_np(_get(bp, path)) for bp in params["blocks"]])

    return {
        k: _map(_paths(params["blocks"][0]), stack) if k == "blocks"
        else _map(params[k], to_np)
        for k in _top_level(cfg)
    }


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _paths(tree, prefix=()):
    """The same nested dict with each leaf replaced by its key path."""
    if isinstance(tree, dict):
        return {k: _paths(v, prefix + (k,)) for k, v in tree.items()}
    return prefix


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _adam_and_schedule(state):
    """The ScaleByAdamState and ScaleByScheduleState of a JAX chain state,
    found by their fields (optax is not imported here)."""
    adam = [s for s in state if getattr(s, "_fields", ()) == ("count", "mu",
                                                               "nu")]
    sched = [s for s in state if getattr(s, "_fields", ()) == ("count",)]
    if len(adam) != 1 or len(sched) != 1:
        raise ValueError(
            "expected the JAX optimizer chain's state: one "
            "ScaleByAdamState(count, mu, nu) and one "
            "ScaleByScheduleState(count)"
        )
    return adam[0], sched[0]


def opt_state_from_jax(state, cfg: ModelConfig) -> dict:
    """JAX optax chain state (numpy leaves) -> the port's optimizer state
    (``train/optim.Optimizer.init`` layout)."""
    adam, sched = _adam_and_schedule(state)
    return {
        "count": int(adam.count),
        "mu": params_from_jax(adam.mu, cfg),
        "nu": params_from_jax(adam.nu, cfg),
        "schedule_count": int(sched.count),
    }


def opt_state_to_jax(opt_state: dict, cfg: ModelConfig, like):
    """The port's optimizer state -> the JAX chain state, built on ``like``
    (a JAX chain state of the same optimizer, e.g. ``tx.init(params)``
    after ``jax.device_get``) so the optax types need not be imported."""
    adam, sched = _adam_and_schedule(like)
    new_adam = adam._replace(
        count=np.asarray(int(opt_state["count"]), np.int32),
        mu=params_to_jax(opt_state["mu"], cfg),
        nu=params_to_jax(opt_state["nu"], cfg),
    )
    new_sched = sched._replace(
        count=np.asarray(int(opt_state["schedule_count"]), np.int32)
    )
    out = []
    for s in like:
        out.append(new_adam if s is adam else new_sched if s is sched else s)
    return type(like)(out)
