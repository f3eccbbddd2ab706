"""The port's BlockPool against the JAX package's, operation for operation.

Both are host-side numpy, so a seeded stream of alloc / release /
match_prefix / register_chunk / cancel_match / pin / unpin must give
identical return values and identical ``stats`` and accounting after
every operation.
"""

import numpy as np
import pytest

from pytorch_distributed_tpu.serving.block_pool import BlockPool as JaxPool
from pytorch_distributed_tpu_torch.serving.block_pool import BlockPool

PAGE, CHUNK = 4, 8


def _corpus(rng):
    """Token sequences that share chunk-aligned prefixes."""
    base = rng.integers(0, 50, 40).astype(np.int32)
    out = [base.copy()]
    for cut in (8, 16, 24):
        s = base.copy()
        s[cut:] = rng.integers(0, 50, 40 - cut)
        out.append(s)
    return out


def _drive(pool_cls, seed, n_ops=300, pool_pages=14):
    rng = np.random.default_rng(seed)
    corpus = _corpus(rng)
    pool = pool_cls(pool_pages, PAGE, CHUNK)
    held: list[list[int]] = []
    pinned: list[list[str]] = []
    trace = []
    for _ in range(n_ops):
        op = rng.choice(
            ["alloc", "release", "match", "register", "pin", "unpin"],
            p=[0.25, 0.2, 0.25, 0.2, 0.05, 0.05],
        )
        seq = corpus[rng.integers(len(corpus))]
        if op == "alloc":
            got = pool.alloc(int(rng.integers(0, 4)))
            trace.append(("alloc", got))
            if got:
                held.append(got)
        elif op == "release" and held:
            pids = held.pop(int(rng.integers(len(held))))
            pool.release(pids)
            trace.append(("release", pids))
        elif op == "match":
            res = pool.match_prefix(seq, int(rng.integers(0, len(seq))))
            trace.append(("match", res))
            if rng.random() < 0.4:
                pool.cancel_match(res[0], res[1])
                trace.append(("cancel",))
            elif res[1]:
                held.append(list(res[1]))
        elif op == "register":
            pids = pool.alloc(CHUNK // PAGE)
            if pids is None:
                trace.append(("register_full",))
                continue
            held.append(pids)
            start = int(rng.integers(0, len(seq) // CHUNK)) * CHUNK
            prev = None
            if rng.random() < 0.5:
                keys = pool.chain_keys(seq, start)
                prev = keys[-1] if keys else ""
            trace.append(("register", pool.register_chunk(seq, start, pids,
                                                          prev_key=prev)))
        elif op == "pin":
            keys = pool.chain_keys(seq, int(rng.integers(0, len(seq))))
            pool.pin(keys)
            pinned.append(keys)
            trace.append(("pin", keys))
        elif op == "unpin" and pinned:
            pool.unpin(pinned.pop())
            trace.append(("unpin",))
        trace.append((
            dict(pool.stats), pool.free_pages(), pool.pages_in_use(),
            pool.pages_resident(), pool.allocatable_pages(),
            pool.pinned_pages(), sorted(pool.cached_page_ids()),
        ))
    for pids in held:
        pool.release(pids)
    trace.append(("drained", pool.pages_in_use(), dict(pool.stats)))
    return trace


@pytest.mark.parametrize("seed", range(6))
def test_seeded_op_stream_matches_jax_pool(seed):
    ours, theirs = _drive(BlockPool, seed), _drive(JaxPool, seed)
    assert len(ours) == len(theirs)
    for i, (a, b) in enumerate(zip(ours, theirs)):
        assert a == b, f"op {i}: {a} != {b}"
    assert ours[-1][1] == 0  # every reference released
    stats = ours[-1][2]
    assert stats["prefix_hits"] > 0 and stats["evictions"] > 0  # non-vacuous


def test_over_release_and_bad_arguments_raise_like_jax():
    for cls in (BlockPool, JaxPool):
        pool = cls(6, PAGE, CHUNK)
        pids = pool.alloc(2)
        pool.release(pids)
        with pytest.raises(RuntimeError, match="released more times"):
            pool.release(pids[:1])
        with pytest.raises(ValueError, match="chunk-aligned"):
            pool.register_chunk(np.arange(16, dtype=np.int32), 3, [1])
        with pytest.raises(ValueError, match="pool_pages"):
            cls(1, PAGE, CHUNK)
        with pytest.raises(ValueError, match="multiple of page_size"):
            cls(6, PAGE, 6)


def test_reset_and_lru_eviction_like_jax():
    toks = np.arange(32, dtype=np.int32)
    out = []
    for cls in (BlockPool, JaxPool):
        pool = cls(6, PAGE, CHUNK)
        a = pool.alloc(4)
        k1 = pool.register_chunk(toks, 0, a[:2])
        pool.register_chunk(toks, 8, a[2:], prev_key=k1)
        pool.release(a)
        got = pool.match_prefix(toks, 31)
        pool.release(got[1])
        five = pool.alloc(5)  # must evict both cached chunks
        ev = pool.stats["evictions"]
        pool.release(five)
        pool.reset()
        out.append((got, five, ev, pool.free_pages(), dict(pool.stats)))
    assert out[0] == out[1]
    assert out[0][2] == 2
