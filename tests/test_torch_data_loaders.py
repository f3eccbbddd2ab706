"""The port's distributed, native and text data paths against the JAX
package's, on the CPU. Batches and shards are held byte for byte (no
tolerance: these are integer streams).

- ``DistributedTokenShardLoader`` equals JAX's for world 1, 2 and 4, every
  rank, across a shard switch (ragged shard sizes), with a resumed
  position; its rank/world defaults without a process group;
- ``NativeTokenShardLoader`` (``csrc/data_loader.cc``, built here with
  g++ by ``ops/_build``) equals the port's distributed loader, re-iterates,
  reports its prefetch info, and raises on a corrupt shard;
- ``data.text`` round-trips bytes, and the tokenize twin (``python -m
  pytorch_distributed_tpu_torch.data.tokenize_text``) writes shards
  byte-equal to JAX's ``tokenize_files``.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from pytorch_distributed_tpu.data import text as jtext
from pytorch_distributed_tpu.data.distributed_loader import (
    DistributedTokenShardLoader as JaxDistributed,
)
from pytorch_distributed_tpu_torch import data
from pytorch_distributed_tpu_torch.data import bin_format, native_loader
from pytorch_distributed_tpu_torch.data import text as ptext
from pytorch_distributed_tpu_torch.data import tokenize_text

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    root = tmp_path_factory.mktemp("shards")
    rng = np.random.default_rng(0)
    paths = []
    for i, count in enumerate([977, 1251, 613]):  # ragged on purpose
        p = root / f"shard_{i:03d}.bin"
        bin_format.write_shard(p, rng.integers(0, 5000, count).astype(
            np.uint16))
        paths.append(p)
    return paths


def _equal_streams(a, b):
    a, b = list(a), list(b)
    assert len(a) == len(b) > 0
    for (ai, at), (bi, bt) in zip(a, b):
        assert ai.dtype == bi.dtype == np.int32
        np.testing.assert_array_equal(ai, bi)
        np.testing.assert_array_equal(at, bt)
    return len(a)


@pytest.mark.parametrize("world", [1, 2, 4])
def test_distributed_loader_matches_jax(shards, world):
    b, t = 2, 8
    for rank in range(world):
        kw = dict(rank=rank, world_size=world)
        n = _equal_streams(data.DistributedTokenShardLoader(shards, b, t, **kw),
                           JaxDistributed(shards, b, t, **kw))
        # Across the shard switch: the stream spans every shard.
        assert n * world * b * t > 977 + 1251
        # A resumed position, and re-iteration from the start.
        port = data.DistributedTokenShardLoader(shards, b, t, **kw)
        jax_l = JaxDistributed(shards, b, t, **kw)
        for loader in (port, jax_l):
            it = iter(loader)
            for _ in range(n // 2):
                next(it)
        sd = port.state_dict()
        assert sd == jax_l.state_dict()
        port2 = data.DistributedTokenShardLoader(shards, b, t, **kw)
        port2.load_state_dict(sd)
        jax_l.load_state_dict(sd)
        _equal_streams(port2, jax_l)
        _equal_streams(port2, JaxDistributed(shards, b, t, **kw))


def test_distributed_loader_defaults_and_validation(shards):
    loader = data.DistributedTokenShardLoader(shards, 2, 8)
    assert (loader.rank, loader.world_size) == (0, 1)
    with pytest.raises(ValueError, match="out of range"):
        data.DistributedTokenShardLoader(shards, 2, 8, rank=2, world_size=2)


def test_native_loader_builds_with_the_host_compiler():
    from pytorch_distributed_tpu_torch.ops import _build

    lib = native_loader._load_library()
    assert lib is _build._loaded["data_loader"]
    assert _build._target("data_loader").name.startswith("libdata_loader-")
    assert _build._source("data_loader").suffix == ".cc"


@pytest.mark.parametrize("world", [1, 4])
def test_native_loader_matches_the_distributed_loader(shards, world):
    b, t = 2, 8
    for rank in range(world):
        kw = dict(rank=rank, world_size=world)
        _equal_streams(data.NativeTokenShardLoader(shards, b, t, **kw),
                       data.DistributedTokenShardLoader(shards, b, t, **kw))


def test_native_loader_reiterates_and_reports(shards):
    nat = data.NativeTokenShardLoader(shards, 2, 8, prefetch_depth=4)
    first = [i.copy() for i, _ in nat]
    second = [i.copy() for i, _ in nat]
    assert len(first) == len(second) > 0
    for a, b in zip(first, second):
        np.testing.assert_array_equal(a, b)
    info = nat.get_info()
    assert info["backend"].startswith("native")
    assert info["total_tokens"] == 977 + 1251 + 613
    assert (info["rank"], info["world_size"], info["batch_size"]) == (0, 1, 2)


def test_native_loader_rejects_corrupt_and_empty(tmp_path):
    p = tmp_path / "bad.bin"
    bin_format.write_shard(p, np.zeros(300, dtype=np.uint16))
    raw = bytearray(p.read_bytes())
    raw[4] = 9  # the version field
    p.write_bytes(bytes(raw))
    with pytest.raises(bin_format.ShardFormatError):
        data.NativeTokenShardLoader([p], 2, 8)
    with pytest.raises(ValueError, match="empty"):
        data.NativeTokenShardLoader([], 2, 8)
    with pytest.raises(ValueError, match="out of range"):
        data.NativeTokenShardLoader([p], 2, 8, rank=1, world_size=1)


def test_native_loader_unavailable_without_a_compiler(monkeypatch,
                                                     tmp_path):
    from pytorch_distributed_tpu_torch.ops import _build

    monkeypatch.setattr(native_loader, "_lib", None)
    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "empty_build")
    monkeypatch.setenv("CXX", "no-such-compiler-xyz")
    with pytest.raises(native_loader.NativeLoaderUnavailable,
                       match="numpy loaders"):
        native_loader._load_library()


def test_text_round_trips_bytes():
    s = "héllo, wörld — Δ tokens!\n"
    toks = ptext.encode_bytes(s)
    assert toks == jtext.encode_bytes(s)
    assert all(0 <= t < 256 for t in toks)
    assert ptext.decode_bytes(toks) == s
    assert ptext.decode_bytes([104, 256, 105, 999]) == \
        jtext.decode_bytes([104, 256, 105, 999]) == "h\ni"
    assert (ptext.BYTE_VOCAB_SIZE, ptext.DOC_SEPARATOR) == \
        (jtext.BYTE_VOCAB_SIZE, jtext.DOC_SEPARATOR) == (257, 256)


def _docs(tmp_path):
    docs = []
    for i, body in enumerate(["document zero " * 40,
                              "Δοκιμή — ünïcödé\r\nlines\n" * 30,
                              "short"]):
        p = tmp_path / f"doc{i}.txt"
        p.write_bytes(body.encode("utf-8"))
        docs.append(p)
    return docs


def _shard_bytes(paths):
    return [(Path(p).name, Path(p).read_bytes()) for p in paths]


@pytest.mark.parametrize("kw", [dict(shard_tokens=500),
                                dict(shard_tokens=700, chunk_bytes=7),
                                dict(shard_tokens=10_000, separator=None)])
def test_tokenize_files_byte_equal_to_jax(tmp_path, kw):
    docs = _docs(tmp_path)
    want = jtext.tokenize_files(docs, tmp_path / "jax", **kw)
    got = ptext.tokenize_files(docs, tmp_path / "port", **kw)
    assert _shard_bytes(got) == _shard_bytes(want)
    enc = lambda s: [ord(c) % 300 for c in s]  # noqa: E731
    want = jtext.tokenize_files(docs, tmp_path / "jax2", encode=enc,
                                shard_tokens=400, prefix="custom")
    got = ptext.tokenize_files(docs, tmp_path / "port2", encode=enc,
                               shard_tokens=400, prefix="custom")
    assert _shard_bytes(got) == _shard_bytes(want)
    with pytest.raises(ValueError, match="uint16"):
        ptext.tokenize_files(docs, tmp_path / "bad",
                             encode=lambda s: [70000])


def test_tokenize_twin_writes_jax_shards(tmp_path, capsys):
    docs = _docs(tmp_path)
    want = jtext.tokenize_files(docs, tmp_path / "jax", shard_tokens=600)
    assert tokenize_text.main([*map(str, docs), "-o", str(tmp_path / "twin"),
                               "--shard-tokens", "600"]) == 0
    got = sorted((tmp_path / "twin").glob("*.bin"))
    assert _shard_bytes(got) == _shard_bytes(want)
    assert "vocab 257" in capsys.readouterr().out
    loader = data.TokenShardLoader(got, 2, 16)
    inputs, targets = next(iter(loader))
    np.testing.assert_array_equal(inputs[:, 1:], targets[:, :-1])
    with pytest.raises(SystemExit, match="local directory"):
        tokenize_text.main([str(docs[0]), "-o", str(tmp_path / "x"),
                            "--hf-tokenizer", "gpt2-not-a-dir"])
    proc = subprocess.run(
        [sys.executable, "-m", "pytorch_distributed_tpu_torch.data."
         "tokenize_text", str(docs[2]), "-o", str(tmp_path / "cli")],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "wrote 1 shard(s), 6 tokens" in proc.stdout
