"""The paged decode kernels' partition of a row's keys, on the CPU.

K3 and K4 cut each row's keys into fixed chunks, one CTA each, and
combine the chunks' softmax states in split order. The CUDA kernel runs
only on the card; here ``_split_plan`` (the partition the wrapper hands
the kernel) is held to its contract, and
``paged_decode_attention_split_reference`` (the kernel's arithmetic
restated in PyTorch: base-2 scores, per-chunk f32 states, the ordered
combine) to the JAX package's Pallas kernel in interpret mode and its
gather reference. Same seeded numpy
inputs; f32, where only the summation order differs: atol = 2e-6, rtol =
1e-5, as in ``tests/test_torch_paged_kernel.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_tpu.ops import paged_kernel as jk
from pytorch_distributed_tpu_torch.ops import paged_kernel as tk

TOL = dict(atol=2e-6, rtol=1e-5)
PAGE, N_PAGES, D, HKV = 8, 36, 64, 2  # 288 keys: not a multiple of a chunk


@pytest.mark.parametrize("page_dtype", [torch.float32, torch.bfloat16,
                                        torch.int8])
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("page", [8, 16, 32])
def test_split_plan_is_whole_pages_fixed_by_page_d_and_type(page, d,
                                                            page_dtype):
    chunk, _ = tk._split_plan(page, 1, d, page_dtype)
    assert chunk % page == 0 and chunk // page <= tk._MAX_CHUNK_PAGES
    assert chunk * d * page_dtype.itemsize >= tk.CHUNK_K_BYTES  # 16 KB of K
    for n_pages in (1, 3, 7, 64, 65, 128, 200):
        c, n_splits = tk._split_plan(page, n_pages, d, page_dtype)
        assert c == chunk  # the table's width never moves a chunk edge
        assert n_splits * chunk >= n_pages * page > (n_splits - 1) * chunk


def test_split_plan_gives_every_page_type_the_same_bytes_per_chunk():
    """A chunk is 16 KB of K rows: 128 bf16 keys at head_dim 64, 256 int8
    ones, rounded up to whole pages."""
    assert tk._split_plan(16, 64, 64, torch.bfloat16) == (128, 8)
    assert tk._split_plan(16, 64, 64, torch.int8) == (256, 4)
    assert tk._split_plan(16, 64, 128, torch.int8) == (128, 8)
    assert tk._split_plan(16, 64, 128, torch.float32) == (32, 32)
    assert tk._split_plan(48, 10, 64, torch.float32) == (96, 5)


def _lengths(chunk):
    """Every chunk edge: 0, page-1, page, chunk-1, chunk, chunk+1 and the
    table's last key."""
    last = N_PAGES * PAGE - 1
    return np.array([0, PAGE - 1, PAGE, chunk - 1, chunk, chunk + 1, last],
                    np.int32)


def _case(group, q8, seed=0):
    """Rows at every chunk edge, each over distinct pool pages up to its
    depth, the rest of its table on the scratch page 0. int8 pages carry
    per-token, per-KV-head f32 scales."""
    rng = np.random.default_rng(seed)
    chunk, _ = tk._split_plan(PAGE, N_PAGES, D,
                              torch.int8 if q8 else torch.float32)
    lengths = _lengths(chunk)
    b, h = len(lengths), HKV * group
    n_pool = b * N_PAGES + 1
    ids = rng.permutation(np.arange(1, n_pool))
    tables = np.zeros((b, N_PAGES), np.int32)
    used = 0
    for r, length in enumerate(lengths):
        n = length // PAGE + 1
        tables[r, :n] = ids[used: used + n]
        used += n
    q = rng.standard_normal((b, h, D)).astype(np.float32)
    shape = (n_pool, PAGE, HKV, D)
    if not q8:
        k = rng.standard_normal(shape).astype(np.float32)
        v = rng.standard_normal(shape).astype(np.float32)
        return [q, k, v, tables, lengths]
    k = rng.integers(-127, 128, shape).astype(np.int8)
    v = rng.integers(-127, 128, shape).astype(np.int8)
    ks = rng.uniform(0.5, 2.0, shape[:3]).astype(np.float32) / 127
    vs = rng.uniform(0.5, 2.0, shape[:3]).astype(np.float32) / 127
    return [q, k, v, tables, lengths, ks, vs]


def _jax(args, interpret):
    j = [jnp.asarray(a) for a in args]
    if len(j) == 5:
        if interpret:
            return np.asarray(jk.paged_decode_attention(*j, interpret=True))
        return np.asarray(jk.paged_decode_attention_reference(*j))
    if interpret:
        return np.asarray(jk.paged_decode_attention(
            *j[:5], k_scales=j[5], v_scales=j[6], interpret=True))
    return np.asarray(jk.paged_decode_attention_reference(*j))


@pytest.mark.parametrize("q8", [False, True], ids=["K3", "K4"])
@pytest.mark.parametrize("group", [1, 2, 4, 8])
def test_split_mirror_matches_jax_kernel_and_reference(group, q8):
    args = _case(group, q8, seed=group)
    got = tk.paged_decode_attention_split_reference(
        *(torch.from_numpy(a) for a in args))
    assert got.dtype == torch.float32 and tuple(got.shape) == args[0].shape
    for interpret in (True, False):
        np.testing.assert_allclose(got.numpy(), _jax(args, interpret), **TOL)


@pytest.mark.parametrize("q8", [False, True], ids=["K3", "K4"])
def test_split_mirror_matches_the_plain_version(q8):
    args = [torch.from_numpy(a) for a in _case(4, q8, seed=7)]
    np.testing.assert_allclose(
        tk.paged_decode_attention_split_reference(*args).numpy(),
        tk.paged_decode_attention_reference(*args).numpy(), **TOL)


@pytest.mark.parametrize("q8", [False, True], ids=["K3", "K4"])
def test_split_mirror_reads_nothing_past_a_rows_depth(q8):
    """NaN in every K/V slot (and scale) past each row's depth, the
    scratch page included, changes no output bit."""
    args = _case(2, q8, seed=3)
    want = tk.paged_decode_attention_split_reference(
        *(torch.from_numpy(a) for a in args))
    tables, lengths = args[3], args[4]
    poisoned = [a.copy() for a in args]
    for pool in (poisoned[1], poisoned[2], *poisoned[5:]):
        fill = 127 if pool.dtype == np.int8 else np.nan
        pool[0] = fill
        for r, length in enumerate(lengths):
            for j, pid in enumerate(tables[r]):
                lo = max(0, int(length) + 1 - j * PAGE)
                if pid and lo < PAGE:
                    pool[pid, lo:] = fill
    got = tk.paged_decode_attention_split_reference(
        *(torch.from_numpy(a) for a in poisoned))
    assert torch.equal(got, want)


def test_split_mirror_single_row_at_any_table_width():
    """A row's result at B = 1 matches the same row inside the batch and
    inside a table twice as wide (more splits, none of them active)."""
    args = [torch.from_numpy(a) for a in _case(2, False, seed=4)]
    q, k, v, tables, lengths = args
    full = tk.paged_decode_attention_split_reference(*args)
    wide = torch.cat([tables, torch.zeros_like(tables)], 1)
    for r in range(q.shape[0]):
        for t in (tables, wide):
            one = tk.paged_decode_attention_split_reference(
                q[r:r + 1], k, v, t[r:r + 1], lengths[r:r + 1])
            np.testing.assert_allclose(one.numpy(), full[r:r + 1].numpy(),
                                       **TOL)


def test_workspace_grows_and_starts_with_zeroed_counters():
    dev = torch.device("cpu")
    tk._workspaces.pop((dev, None), None)
    try:
        work, counters = tk._workspace(dev, 100, 8)
        assert work.numel() == 100 and work.dtype == torch.float32
        assert counters.dtype == torch.int32 and not counters.any()
        again = tk._workspace(dev, 50, 4)
        assert again[0] is work and again[1] is counters  # reused
        bigger = tk._workspace(dev, 400, 32)
        assert bigger[0].numel() == 400 and bigger[1].numel() == 32
        assert not bigger[1].any()
        assert tk._workspace(dev, 10, 2)[0] is bigger[0]
    finally:
        tk._workspaces.pop((dev, None), None)
