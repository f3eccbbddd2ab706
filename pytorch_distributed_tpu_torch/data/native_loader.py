"""The native (C++) prefetching shard loader: the port's counterpart of the
JAX package's ``data/native_loader.py``, bound to the port's own copy of
its source, ``csrc/data_loader.cc``.

``NativeTokenShardLoader`` is a drop-in for ``DistributedTokenShardLoader``
(the same lockstep rank-sliced stream): memory-mapped shards, batch
assembly in C++, and a producer thread that keeps ``prefetch_depth`` ready
batches ahead of the host loop, so IO and the int32 upcast overlap with
the card's work. The library is host code: ``ops/_build`` compiles it
with ``g++`` at first use into ``_build/`` (a plain C interface through
ctypes). Without a toolchain, import still succeeds and construction
raises ``NativeLoaderUnavailable``, pointing at the numpy loaders.
"""

from __future__ import annotations

import ctypes
from typing import Iterator

import numpy as np

from pytorch_distributed_tpu_torch.data import bin_format

_lib: ctypes.CDLL | None = None


class NativeLoaderUnavailable(RuntimeError):
    pass


def _load_library() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    from pytorch_distributed_tpu_torch.ops import _build

    try:
        lib = _build.load("data_loader")
    except (RuntimeError, OSError) as e:
        raise NativeLoaderUnavailable(
            f"the native loader could not be built or loaded ({e}); use "
            "the numpy loaders (data.loader / data.distributed_loader)"
        ) from e
    lib.pdt_loader_create.restype = ctypes.c_void_p
    lib.pdt_loader_create.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
        ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ]
    lib.pdt_loader_next.restype = ctypes.c_int
    lib.pdt_loader_next.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
    ]
    lib.pdt_loader_reset.restype = None
    lib.pdt_loader_reset.argtypes = [ctypes.c_void_p]
    lib.pdt_loader_error.restype = ctypes.c_char_p
    lib.pdt_loader_error.argtypes = [ctypes.c_void_p]
    lib.pdt_loader_destroy.restype = None
    lib.pdt_loader_destroy.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


class NativeTokenShardLoader:
    """Rank-sliced lockstep shard loader, C++-backed, prefetching. The
    stream of ``DistributedTokenShardLoader``; yields host int32
    (inputs, targets) [B, T] batches."""

    def __init__(
        self,
        file_paths,
        local_batch_size: int,
        sequence_length: int,
        *,
        rank: int = 0,
        world_size: int = 1,
        prefetch_depth: int = 2,
    ):
        self.files = sorted(str(f) for f in file_paths)
        if not self.files:
            raise ValueError("empty shard file list")
        if not (0 <= rank < world_size):
            raise ValueError(
                f"rank {rank} out of range for world_size {world_size}")
        # Headers are checked here first, so a malformed shard raises the
        # numpy path's ShardFormatError (the C++ side checks again).
        for f in self.files:
            bin_format.read_header(f)
        self.local_batch_size = int(local_batch_size)
        self.sequence_length = int(sequence_length)
        self.rank, self.world_size = rank, world_size
        self._lib = _load_library()
        arr = (ctypes.c_char_p * len(self.files))(
            *[f.encode() for f in self.files])
        self._handle = self._lib.pdt_loader_create(
            arr, len(self.files), self.local_batch_size,
            self.sequence_length, rank, world_size, prefetch_depth)
        if not self._handle:
            raise NativeLoaderUnavailable("pdt_loader_create failed")

    def __iter__(self) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        self._lib.pdt_loader_reset(self._handle)
        b, t = self.local_batch_size, self.sequence_length
        while True:
            inputs = np.empty((b, t), dtype=np.int32)
            targets = np.empty((b, t), dtype=np.int32)
            rc = self._lib.pdt_loader_next(
                self._handle,
                inputs.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                targets.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            )
            if rc == 0:
                return
            if rc < 0:
                msg = self._lib.pdt_loader_error(self._handle) or b""
                raise bin_format.ShardFormatError(msg.decode())
            yield inputs, targets

    def get_total_tokens(self) -> int:
        return bin_format.total_tokens(self.files)

    def get_info(self) -> dict:
        return {
            "num_shards": len(self.files),
            "batch_size": self.local_batch_size,
            "sequence_length": self.sequence_length,
            "rank": self.rank,
            "world_size": self.world_size,
            "files": self.files,
            "total_tokens": self.get_total_tokens(),
            "backend": "native (C++ mmap + prefetch)",
        }

    def __del__(self):
        handle = getattr(self, "_handle", None)
        if handle:
            self._lib.pdt_loader_destroy(handle)
            self._handle = None
