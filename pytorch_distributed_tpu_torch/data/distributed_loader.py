"""Deterministic rank-sliced loader: the port's own copy of the JAX
package's ``data/distributed_loader.py`` (``DistributedTokenShardLoader``),
yielding the same stream for every rank.

- every rank reads the same files in the same order;
- per batch, rank r takes the contiguous chunk
  ``tokens[pos + r*B*T : pos + (r+1)*B*T + 1]`` (+1 for the target shift)
  and reshapes it to [B, T];
- every rank then advances ``pos += world*B*T``;
- the shard switches when fewer than ``world*B*T + 1`` tokens remain, so
  all ranks switch in lockstep (world 1 is the single-process stream in
  its lockstep form).

``rank``/``world_size`` default to ``torch.distributed``'s rank and world
size when a process group is initialised, and to (0, 1) otherwise (where
the JAX package reads ``jax.process_index()``/``process_count()``).
"""

from __future__ import annotations

from typing import Iterator

import numpy as np

from pytorch_distributed_tpu_torch.data.loader import TokenShardLoader


def default_rank_and_world() -> tuple[int, int]:
    """``torch.distributed``'s (rank, world size) when initialised, else
    (0, 1)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class DistributedTokenShardLoader(TokenShardLoader):
    def __init__(
        self,
        file_paths,
        local_batch_size: int,
        sequence_length: int,
        *,
        rank: int | None = None,
        world_size: int | None = None,
        mmap: bool = True,
    ):
        if rank is None or world_size is None:
            d_rank, d_world = default_rank_and_world()
            rank = d_rank if rank is None else rank
            world_size = d_world if world_size is None else world_size
        if not (0 <= rank < world_size):
            raise ValueError(
                f"rank {rank} out of range for world_size {world_size}")
        self.rank = rank
        self.world_size = world_size
        self.local_batch_size = local_batch_size
        super().__init__(file_paths, local_batch_size, sequence_length,
                         mmap=mmap)

    def __iter__(self) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        self._begin_iteration()
        b, t = self.local_batch_size, self.sequence_length
        num_tokens_local = b * t
        num_tokens_global = self.world_size * num_tokens_local
        while True:
            # Lockstep shard switch: the whole global chunk + 1 must fit,
            # so every rank finds its full slice (the last rank's +1
            # target lookahead included) in the current shard.
            if not self._advance_shard_if_needed(num_tokens_global):
                return
            pos_local = self.current_position + self.rank * num_tokens_local
            buf = np.asarray(
                self.current_tokens[pos_local:pos_local + num_tokens_local
                                    + 1],
                dtype=np.int32,
            )
            inputs = buf[:-1].reshape(b, t)
            targets = buf[1:].reshape(b, t)
            self.current_position += num_tokens_global  # all ranks together
            yield inputs, targets
