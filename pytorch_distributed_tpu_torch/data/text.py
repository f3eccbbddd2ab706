"""Raw text -> pretokenized ``.bin`` shards, byte-level with no
dependencies: the port's own copy of the JAX package's ``data/text.py``,
writing the same shards byte for byte.

Text is encoded byte-level (the UTF-8 bytes ARE the tokens: vocab 256 plus
one document separator) into the kjj0 ``.bin`` format
(``data/bin_format.py``), so every loader — sequential, distributed,
native — reads it unchanged. Train with ``ModelConfig(vocab_size=257)``.
For subword tokens pass any ``encode(text) -> list[int]`` (a HuggingFace
tokenizer's, say) to ``tokenize_files``.

CLI: ``python -m pytorch_distributed_tpu_torch.data.tokenize_text
corpus/*.txt -o .cache/data/mine``.
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable, Iterable, Sequence

import numpy as np

from pytorch_distributed_tpu_torch.data import bin_format

# Byte-level vocabulary: 0..255 raw bytes, 256 document separator.
BYTE_VOCAB_SIZE = 257
DOC_SEPARATOR = 256


def encode_bytes(text: str) -> list[int]:
    """UTF-8 byte-level encoding — every string round-trips losslessly."""
    return list(text.encode("utf-8"))


def decode_bytes(tokens: Iterable[int]) -> str:
    """Inverse of encode_bytes; separator tokens become newlines."""
    out = bytearray()
    for t in tokens:
        if t == DOC_SEPARATOR:
            out += b"\n"
        elif 0 <= t < 256:
            out.append(t)
    return out.decode("utf-8", errors="replace")


def _check_uint16(arr: np.ndarray) -> np.ndarray:
    """Vectorised range check: np.uint16 conversion would WRAP silently
    (a per-token Python loop here is interpreter-bound on real corpora)."""
    if arr.size and (int(arr.min()) < 0 or int(arr.max()) >= 2**16):
        bad = int(arr[(arr < 0) | (arr >= 2**16)][0])
        raise ValueError(
            f"token {bad} out of uint16 range (the .bin format "
            "stores uint16; vocab must be < 65536)"
        )
    return arr.astype(np.uint16)


class _ShardWriter:
    """Accumulates uint16 token arrays and emits fixed-size `.bin` shards.

    Memory is bounded at ~2 bytes x (shard_tokens + one appended array):
    tokens live in numpy uint16 chunks, never Python int lists (which cost
    ~28 B/token transient and OOM the host on multi-GB corpora)."""

    def __init__(self, out_dir: Path, prefix: str, shard_tokens: int):
        self.out_dir = out_dir
        self.prefix = prefix
        self.shard_tokens = shard_tokens
        self.parts: list[np.ndarray] = []
        self.total = 0
        self.shards: list[Path] = []

    def append(self, arr: np.ndarray) -> None:
        if not arr.size:
            return
        self.parts.append(arr)
        self.total += arr.size
        if self.total < self.shard_tokens:
            return
        # ONE concatenation per append, then emit every full shard from it
        # in a single pass — re-merging the remainder per shard would copy
        # O(N^2 / shard_tokens) bytes on huge appends.
        merged = np.concatenate(self.parts)
        n_full = merged.size // self.shard_tokens
        for i in range(n_full):
            self._write(
                merged[i * self.shard_tokens : (i + 1) * self.shard_tokens]
            )
        rest = merged[n_full * self.shard_tokens :]
        self.parts = [rest] if rest.size else []
        self.total = int(rest.size)

    def finish(self) -> list[Path]:
        if self.total:
            self._write(np.concatenate(self.parts))
            self.parts, self.total = [], 0
        return self.shards

    def _write(self, tokens: np.ndarray) -> None:
        path = self.out_dir / f"{self.prefix}_{len(self.shards):06d}.bin"
        bin_format.write_shard(path, tokens)
        self.shards.append(path)


def tokenize_files(
    paths: Sequence[str | Path],
    out_dir: str | Path,
    *,
    shard_tokens: int = 10_000_000,
    encode: Callable[[str], list[int]] = encode_bytes,
    separator: int | None = DOC_SEPARATOR,
    prefix: str = "text_train",
    chunk_bytes: int = 1 << 22,
) -> list[Path]:
    """Tokenize text files into fixed-size `.bin` shards in bounded memory.

    Each input file is one document; ``separator`` (if not None) is
    appended after each so the model sees document boundaries. Returns the
    shard paths (``{prefix}_{idx:06d}.bin``), ready for TokenShardLoader.

    Memory: with the byte-level default encoder, files stream through in
    ~``chunk_bytes``-character TEXT-mode chunks (the incremental UTF-8
    decoder handles multi-byte characters split across chunks; text mode
    keeps the exact semantics of the whole-file path — universal-newline
    translation and a hard UnicodeDecodeError on invalid UTF-8) and peak
    host memory is bounded by ~2 x shard_tokens + chunk bytes regardless
    of corpus size. A custom ``encode`` (e.g. a HF tokenizer) must see
    each whole document — BPE merges can span any chunk boundary — so
    those files are read fully, but tokens still buffer as numpy uint16
    (~2 B/token instead of a Python list's ~28 B/token transient).
    """
    if not paths:
        raise ValueError("tokenize_files needs at least one input path")
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    writer = _ShardWriter(out_dir, prefix, shard_tokens)
    sep_arr = (
        _check_uint16(np.asarray([separator], dtype=np.int64))
        if separator is not None
        else None
    )

    for p in paths:
        if encode is encode_bytes:
            # Streaming path: byte-level tokens depend only on the local
            # character, so chunk boundaries cannot change the encoding.
            with open(p, "r", encoding="utf-8") as f:
                while True:
                    chunk = f.read(chunk_bytes)
                    if not chunk:
                        break
                    writer.append(
                        np.frombuffer(
                            chunk.encode("utf-8"), dtype=np.uint8
                        ).astype(np.uint16)
                    )
        else:
            toks = encode(Path(p).read_text(encoding="utf-8"))
            writer.append(
                _check_uint16(np.asarray(toks, dtype=np.int64))
            )
        if sep_arr is not None:
            writer.append(sep_arr)
    return writer.finish()
