"""Sequential token-shard loader: the port's own copy of the JAX package's
``data/loader.py`` (``TokenShardLoader``), yielding the same token stream.

Reads sorted shard files in order and yields [B, T] (inputs, targets)
batches, where each of the B sequences pulls T+1 tokens (targets are the
inputs shifted by one) and the read position advances by T per sequence;
switches shards when fewer than T+1 tokens remain; a fresh ``__iter__``
restarts from the first shard, or from the position ``load_state_dict``
restored. Shards are memory-mapped, and batches are host numpy int32
arrays: placing them on the card is the trainer's job (``put_batch``).
"""

from __future__ import annotations

from pathlib import Path
from typing import Iterator

import numpy as np

from pytorch_distributed_tpu_torch.data import bin_format


class TokenShardLoader:
    def __init__(
        self,
        file_paths,
        batch_size: int,
        sequence_length: int,
        *,
        mmap: bool = True,
    ):
        self.files = sorted(str(f) for f in file_paths)
        if not self.files:
            raise ValueError("empty shard file list")
        self.batch_size = batch_size
        self.sequence_length = sequence_length
        self._mmap = mmap
        self._reset()

    # -- state ------------------------------------------------------------
    def _reset(self) -> None:
        self.current_shard_idx = 0
        self.current_tokens: np.ndarray | None = None
        self.current_position = 0

    def _advance_shard_if_needed(self, needed_tokens: int | None = None) -> bool:
        """Ensure > ``needed_tokens`` tokens remain past the current position;
        returns False when data is exhausted.

        The shard switches when pos + T >= len(tokens), as in the JAX
        package's loader."""
        t = needed_tokens if needed_tokens is not None else self.sequence_length
        while (
            self.current_tokens is None
            or self.current_position + t >= len(self.current_tokens)
        ):
            if self.current_shard_idx >= len(self.files):
                return False
            self.current_tokens = bin_format.read_tokens(
                self.files[self.current_shard_idx], mmap=self._mmap
            )
            self.current_shard_idx += 1
            self.current_position = 0
        return True

    # -- resumable position: it rides the checkpoint, so a resumed run
    # continues the token stream instead of repeating it --
    def state_dict(self) -> dict:
        """Stream position for checkpointing: next-shard index + offset."""
        return {
            "shard_idx": int(self.current_shard_idx),
            "position": int(self.current_position),
        }

    def load_state_dict(self, sd: dict) -> None:
        """Restore a position captured by ``state_dict``; takes effect at
        the next ``__iter__`` (instead of rewinding to shard 0)."""
        self._pending_state = (int(sd["shard_idx"]), int(sd["position"]))

    def _begin_iteration(self) -> None:
        pending = getattr(self, "_pending_state", None)
        self._reset()
        if pending is not None:
            self._pending_state = None
            idx, pos = pending
            if idx > 0:
                if idx > len(self.files):
                    raise ValueError(
                        f"loader state shard_idx {idx} exceeds "
                        f"{len(self.files)} shards"
                    )
                self.current_tokens = bin_format.read_tokens(
                    self.files[idx - 1], mmap=self._mmap
                )
                self.current_shard_idx = idx
                self.current_position = pos

    # -- iteration --------------------------------------------------------
    def _next_batch(self) -> tuple[np.ndarray, np.ndarray] | None:
        b, t = self.batch_size, self.sequence_length
        inputs = np.empty((b, t), dtype=np.int32)
        targets = np.empty((b, t), dtype=np.int32)
        for i in range(b):
            if not self._advance_shard_if_needed():
                return None
            pos = self.current_position
            seq = np.asarray(self.current_tokens[pos : pos + t + 1], dtype=np.int32)
            inputs[i] = seq[:-1]
            targets[i] = seq[1:]
            self.current_position += t
        return inputs, targets

    def __iter__(self) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        self._begin_iteration()
        while True:
            batch = self._next_batch()
            if batch is None:
                return
            yield batch

    # -- metadata ---------------------------------------------------------
    def get_total_tokens(self) -> int:
        return bin_format.total_tokens(self.files)

    def get_info(self) -> dict:
        return {
            "num_shards": len(self.files),
            "batch_size": self.batch_size,
            "sequence_length": self.sequence_length,
            "files": self.files,
            "total_tokens": self.get_total_tokens(),
        }
