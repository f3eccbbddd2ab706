"""Convert GPT-2 parameters between the JAX package's tree and the port's.

The JAX tree (``pytorch_distributed_tpu.models.gpt2``) stacks every block
leaf along a leading [L] axis; the port keeps a list of per-layer dicts
with the same leaf names and per-layer shapes (``models/gpt2``). Both
directions go through numpy, so this module imports neither JAX nor the
JAX package: pass ``jax.device_get(params)`` (or any tree of numpy
arrays) in, get numpy arrays back out. Kernels keep their [in, out...]
layout on both sides, so nothing is transposed and a round trip is exact.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from pytorch_distributed_tpu_torch.config import ModelConfig


def _to_torch(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, copy=True))


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def params_from_jax(tree: dict[str, Any], cfg: ModelConfig) -> dict:
    """JAX gpt2 params (numpy leaves, blocks stacked [L, ...]) -> port
    params (torch tensors, blocks a list of L per-layer dicts)."""
    if cfg.family != "gpt2":
        raise NotImplementedError(
            f"interop converts the gpt2 family only, got {cfg.family!r}"
        )
    n_layer = cfg.n_layer
    blocks = tree["blocks"]
    for leaf in _leaves(blocks):
        if np.shape(leaf)[0] != n_layer:
            raise ValueError(
                f"stacked block leaf of shape {np.shape(leaf)} does not "
                f"lead with n_layer={n_layer}"
            )
    return {
        "wte": _to_torch(tree["wte"]),
        "wpe": _to_torch(tree["wpe"]),
        "blocks": [
            _map(blocks, lambda x, i=i: _to_torch(np.asarray(x)[i]))
            for i in range(n_layer)
        ],
        "ln_f": _map(tree["ln_f"], _to_torch),
    }


def params_to_jax(params: dict, cfg: ModelConfig) -> dict[str, Any]:
    """Port params -> the JAX tree layout with numpy leaves (the inverse
    of ``params_from_jax``); feed it to JAX with ``jax.numpy.asarray``."""
    if len(params["blocks"]) != cfg.n_layer:
        raise ValueError(
            f"{len(params['blocks'])} blocks for n_layer={cfg.n_layer}"
        )

    def to_np(t: torch.Tensor) -> np.ndarray:
        return t.detach().cpu().numpy()

    def stack(path):
        return np.stack([to_np(_get(bp, path)) for bp in params["blocks"]])

    blocks = _map(
        _paths(params["blocks"][0]), lambda path: stack(path)
    )
    return {
        "wte": to_np(params["wte"]),
        "wpe": to_np(params["wpe"]),
        "blocks": blocks,
        "ln_f": _map(params["ln_f"], to_np),
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
