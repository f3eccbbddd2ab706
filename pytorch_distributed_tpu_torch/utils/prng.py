"""Dropout streams: the port of the JAX package's ``utils/prng.py``.

The JAX package derives every dropout mask from a key chain:
``domain_key(seed, "dropout")`` -> ``step_key(step)`` -> ``fold_in(micro)``
(``train/trainer.py``), then ``split`` for the embedding mask
(``models/gpt2.apply``), then ``fold_in(layer)`` and ``split(..., 3)`` for
the attention, residual-1 and MLP masks of each block. Threefry cannot be
matched bit for bit in PyTorch, so each mask here has a **stream id**
mirroring that chain, ``StreamId(seed, step, micro, layer, site)``, and is
drawn by one function, ``draw_keep_mask``: the id is hashed to a 64-bit
seed for an explicit ``torch.Generator`` on the mask's device.

Each mask is a pure function of its id. A remat recompute draws it again
bit for bit, as JAX's key-based masks are, which
``torch.utils.checkpoint(preserve_rng_state=True)`` (it restores only the
default generators) would not give. ``draw_keep_mask`` is looked up on this
module at every call, so a test can replace it, for example with one that
returns the JAX package's mask for the same id.
"""

from __future__ import annotations

import hashlib
import struct
from typing import NamedTuple

import torch

# The masks of one forward: the embedding's (layer EMBD_LAYER), and per
# block attention, residual after attn_proj, residual after mlp_proj —
# the JAX ``split(layer_key, 3)`` order.
SITES = ("embd", "attn", "resid_attn", "resid_mlp")
EMBD_LAYER = -1


class DropoutKey(NamedTuple):
    """What a forward's masks derive from: the JAX chain's
    ``fold_in(step_key(domain_key(seed, "dropout"), step), micro)``."""

    seed: int
    step: int
    micro: int = 0


class StreamId(NamedTuple):
    seed: int
    step: int
    micro: int
    layer: int
    site: str


def stream_id(key: DropoutKey, layer: int, site: str) -> StreamId:
    if site not in SITES:
        raise KeyError(f"unknown dropout site {site!r}; known: {SITES}")
    if (site == "embd") != (layer == EMBD_LAYER):
        raise ValueError(
            f"site {site!r} at layer {layer}: the embedding mask has layer "
            f"{EMBD_LAYER}, the block masks layers >= 0"
        )
    return StreamId(key.seed, key.step, key.micro, layer, site)


def stream_seed(sid: StreamId) -> int:
    """A 64-bit generator seed for ``sid``: blake2b of its fields, so it is
    the same in every process (Python's ``hash`` of a str is not)."""
    packed = struct.pack("<qqqq", sid.seed, sid.step, sid.micro, sid.layer)
    digest = hashlib.blake2b(packed + sid.site.encode(), digest_size=8)
    return int.from_bytes(digest.digest(), "little")


def draw_keep_mask(sid: StreamId, shape, keep: float,
                   device) -> torch.Tensor:
    """The bool mask of ``sid``: each element kept with probability
    ``keep``, drawn from a generator on ``device`` seeded by
    ``stream_seed(sid)``."""
    device = torch.device(device)
    g = torch.Generator(device=device)
    g.manual_seed(stream_seed(sid))
    return torch.rand(tuple(shape), generator=g, device=device) < keep
