"""The port's token data against the JAX package's (both pure numpy).

Synthetic shards are byte-equal to the JAX ``make_synthetic_shards`` for
one seed (the port's stream is vectorised; the JAX one is a Python loop);
``TokenShardLoader`` yields the JAX loader's batches exactly, across shard
switches and after ``load_state_dict``; bad shard files raise
``ShardFormatError`` as they do there.
"""

from pathlib import Path

import numpy as np
import pytest

from pytorch_distributed_tpu.data import bin_format as jbin
from pytorch_distributed_tpu.data import loader as jloader
from pytorch_distributed_tpu.data import synthetic as jsynthetic
from pytorch_distributed_tpu_torch.data import (
    ShardFormatError,
    TokenShardLoader,
    bin_format,
    make_synthetic_shards,
    read_header,
    read_tokens,
    write_shard,
)
from pytorch_distributed_tpu_torch.data import synthetic


@pytest.mark.parametrize("n, vocab, seed", [
    (1, 5, 0), (2, 7, 3), (5000, 97, 1), (20000, 50257, 42),
    (20000, 65536, 7), (4096, 256, 9),
])
def test_token_stream_equals_jax(n, vocab, seed):
    want = jsynthetic.synthetic_token_stream(n, vocab, seed)
    got = synthetic.synthetic_token_stream(n, vocab, seed)
    assert got.dtype == want.dtype == np.uint16
    np.testing.assert_array_equal(got, want)


def test_synthetic_shards_are_byte_equal(tmp_path):
    kw = dict(num_shards=3, tokens_per_shard=3000, vocab_size=50257, seed=5)
    want = jsynthetic.make_synthetic_shards(tmp_path / "jax", **kw)
    got = make_synthetic_shards(tmp_path / "port", **kw)
    assert [Path(p).name for p in got] == [Path(p).name for p in want]
    for a, b in zip(got, want):
        assert Path(a).read_bytes() == Path(b).read_bytes()
    # Present shards are reused, not rewritten.
    stamp = Path(got[0]).stat().st_mtime_ns
    assert make_synthetic_shards(tmp_path / "port", **kw) == got
    assert Path(got[0]).stat().st_mtime_ns == stamp
    with pytest.raises(ValueError, match="65536"):
        make_synthetic_shards(tmp_path / "x", vocab_size=70000)


def _shards(tmp_path, sizes=(700, 300, 1000)):
    paths = []
    for i, n in enumerate(sizes):
        p = tmp_path / f"shard_{i:03d}.bin"
        write_shard(p, (np.arange(n) * 7 + i) % 50000)
        paths.append(str(p))
    return paths


def _stream(loader, n=None):
    out = []
    for i, (x, y) in enumerate(loader):
        if n is not None and i >= n:
            break
        out.append((x, y))
    return out


@pytest.mark.parametrize("b, t", [(2, 16), (3, 50), (1, 299)])
def test_loader_stream_equals_jax_across_shard_switches(tmp_path, b, t):
    paths = _shards(tmp_path)
    want = _stream(jloader.TokenShardLoader(paths[::-1], b, t))
    port = TokenShardLoader(paths[::-1], b, t)
    got = _stream(port)
    assert len(got) == len(want) > 2
    for (x, y), (wx, wy) in zip(got, want):
        assert x.dtype == np.int32 and x.shape == (b, t)
        np.testing.assert_array_equal(x, wx)
        np.testing.assert_array_equal(y, wy)
    assert port.get_info()["total_tokens"] == 2000
    # A fresh iteration starts over.
    np.testing.assert_array_equal(_stream(port, 1)[0][0], want[0][0])


def test_loader_resumes_where_its_state_says(tmp_path):
    paths = _shards(tmp_path)
    jl, pl = (jloader.TokenShardLoader(paths, 2, 16),
              TokenShardLoader(paths, 2, 16))
    for n in (0, 5, 21, 30):
        _stream(jl, n), _stream(pl, n)
        sd = pl.state_dict()
        assert sd == jl.state_dict()
        jl2, pl2 = (jloader.TokenShardLoader(paths, 2, 16),
                    TokenShardLoader(paths, 2, 16))
        jl2.load_state_dict(sd)
        pl2.load_state_dict(sd)
        want, got = _stream(jl2), _stream(pl2)
        assert len(got) == len(want)
        for (x, y), (wx, wy) in zip(got, want):
            np.testing.assert_array_equal(x, wx)
            np.testing.assert_array_equal(y, wy)
    bad = TokenShardLoader(paths, 2, 16)
    bad.load_state_dict({"shard_idx": 9, "position": 0})
    with pytest.raises(ValueError, match="exceeds"):
        _stream(bad)
    with pytest.raises(ValueError, match="empty"):
        TokenShardLoader([], 2, 16)


def test_bad_shards_raise_shard_format_error(tmp_path):
    good = tmp_path / "good.bin"
    write_shard(good, np.arange(10))
    assert read_header(good) == jbin.read_header(good) == {
        "magic": 20240520, "version": 1, "token_count": 10}
    np.testing.assert_array_equal(read_tokens(good, mmap=False),
                                  np.arange(10))
    raw = good.read_bytes()
    cases = {
        "truncated": raw[:100],
        "magic": b"\0\0\0\0" + raw[4:],
        "version": raw[:4] + np.int32(2).tobytes() + raw[8:],
        "count": raw[:-2],
    }
    for what, data in cases.items():
        p = tmp_path / f"{what}.bin"
        p.write_bytes(data)
        for reader in (read_tokens, jbin.read_tokens):
            with pytest.raises(ValueError, match=str(p)) as e:
                reader(p, mmap=False)
            assert type(e.value).__name__ == "ShardFormatError"
        if what != "count":  # a short payload fails numpy's memmap first
            with pytest.raises(ShardFormatError):
                read_tokens(p)
    with pytest.raises(ShardFormatError, match="uint16"):
        write_shard(tmp_path / "big.bin", np.array([70000]))
    assert bin_format.total_tokens([good, good]) == 20
