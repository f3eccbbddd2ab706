"""The kjj0 pretokenized ``.bin`` shard format: the port's own copy of the
JAX package's ``data/bin_format.py`` (pure numpy there and here; the port
imports nothing of the JAX package).

Layout:
  - header: 256 int32 little-endian values (1024 bytes)
      header[0] = 20240520 (magic), header[1] = 1 (version),
      header[2] = token_count
  - payload: token_count uint16 tokens

Tokens stay uint16 on the host; callers upcast to int32 at batch-assembly
time to avoid doubling host RAM.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np

MAGIC = 20240520
VERSION = 1
HEADER_INTS = 256
HEADER_BYTES = HEADER_INTS * 4


class ShardFormatError(ValueError):
    pass


def read_header(path: str | Path) -> dict:
    """Read and validate the 1 KiB header; returns magic/version/token_count."""
    with open(path, "rb") as f:
        raw = f.read(HEADER_BYTES)
    if len(raw) < HEADER_BYTES:
        raise ShardFormatError(f"{path}: truncated header ({len(raw)} bytes)")
    header = np.frombuffer(raw, dtype="<i4")
    if header[0] != MAGIC:
        raise ShardFormatError(
            f"{path}: bad magic {int(header[0])}, expected {MAGIC}"
        )
    if header[1] != VERSION:
        raise ShardFormatError(
            f"{path}: unsupported version {int(header[1])}, expected {VERSION}"
        )
    return {
        "magic": int(header[0]),
        "version": int(header[1]),
        "token_count": int(header[2]),
    }


def read_tokens(path: str | Path, *, mmap: bool = True) -> np.ndarray:
    """Return the uint16 token array of a shard.

    mmap=True maps the payload (zero-copy, lets the OS page cache manage host
    RAM — rather than reading the whole shard in bulk).
    """
    info = read_header(path)
    count = info["token_count"]
    if mmap:
        tokens = np.memmap(
            path, dtype="<u2", mode="r", offset=HEADER_BYTES, shape=(count,)
        )
    else:
        with open(path, "rb") as f:
            f.seek(HEADER_BYTES)
            tokens = np.frombuffer(f.read(count * 2), dtype="<u2")
    if len(tokens) != count:
        raise ShardFormatError(
            f"{path}: token count mismatch: got {len(tokens)}, expected {count}"
        )
    return tokens


def write_shard(path: str | Path, tokens: np.ndarray) -> None:
    """Write a uint16 token array as a kjj0-format shard."""
    tokens = np.asarray(tokens)
    if tokens.dtype != np.uint16:
        if tokens.min() < 0 or tokens.max() >= 2**16:
            raise ShardFormatError("tokens out of uint16 range")
        tokens = tokens.astype(np.uint16)
    header = np.zeros(HEADER_INTS, dtype="<i4")
    header[0] = MAGIC
    header[1] = VERSION
    header[2] = len(tokens)
    path = Path(path)
    os.makedirs(path.parent, exist_ok=True)
    with open(path, "wb") as f:
        f.write(header.tobytes())
        f.write(tokens.astype("<u2").tobytes())


def total_tokens(paths) -> int:
    """Sum token counts across shards, reading headers only."""
    return sum(read_header(p)["token_count"] for p in paths)
