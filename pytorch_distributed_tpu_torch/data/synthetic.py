"""Synthetic pretokenized data in kjj0 shard format: the port's own copy of
the JAX package's ``data/synthetic.py``, writing byte-identical shards for
one seed.

Deterministic shards from a seeded numpy generator, in the same binary
format as downloaded data, so everything downstream of a download runs
unchanged with no network. The token stream is Markov-ish (a repeated
``prev * 2 + 1`` process mixed with uniform noise), so cross-entropy falls
during smoke training runs.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np

from pytorch_distributed_tpu_torch.data import bin_format


def synthetic_token_stream(
    num_tokens: int, vocab_size: int, seed: int
) -> np.ndarray:
    """The JAX package's stream, vectorised: token i is noise with
    probability 0.3, else (prev * 2 + 1) mod V, starting from prev =
    noise[0]. A token k steps after its last noise value n (or after the
    start, counted from noise[0]) is therefore ((n + 1) 2^k - 1) mod V,
    computed in int64 from a table of 2^k mod V."""
    rng = np.random.default_rng(seed)
    noise = rng.integers(0, vocab_size, size=num_tokens, dtype=np.int64)
    use_noise = rng.random(num_tokens) > 0.7
    idx = np.arange(num_tokens)
    # The last noise position at or before i; -1 before the first.
    last = np.maximum.accumulate(np.where(use_noise, idx, -1))
    base = np.where(last >= 0, noise[np.maximum(last, 0)], noise[0])
    steps = idx - last  # 0 on a noise position; i + 1 before any
    pow2 = np.ones(int(steps.max(initial=0)) + 1, dtype=np.int64)
    for k in range(1, len(pow2)):
        pow2[k] = pow2[k - 1] * 2 % vocab_size
    out = ((base + 1) * pow2[steps] - 1) % vocab_size
    return out.astype(np.uint16)


def make_synthetic_shards(
    data_dir: str | Path,
    *,
    num_shards: int = 2,
    tokens_per_shard: int = 100_000,
    vocab_size: int = 50257,
    seed: int = 42,
) -> list[str]:
    """Write (or reuse) deterministic shards; returns sorted file paths."""
    if vocab_size > 2**16:
        raise ValueError("synthetic kjj0 shards require vocab_size <= 65536")
    data_dir = Path(data_dir)
    os.makedirs(data_dir, exist_ok=True)
    paths = []
    for i in range(num_shards):
        path = data_dir / f"synthetic_train_{i:06d}.bin"
        if not path.exists():
            tokens = synthetic_token_stream(
                tokens_per_shard, vocab_size, seed + i
            )
            bin_format.write_shard(path, tokens)
        paths.append(str(path))
    return sorted(paths)
