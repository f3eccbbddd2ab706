"""The port's paged decode attention on the CPU against the JAX package's.

The JAX side runs its Pallas kernel in interpret mode and its gather
reference; the port runs its plain version, directly and through the
kernel wrapper (which takes the plain version for CPU tensors). Same
seeded numpy inputs; f32, where only the summation order differs:
atol = 2e-6, rtol = 1e-5. The CUDA kernel itself is held to the plain
version on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_tpu.ops import paged_kernel as jk
from pytorch_distributed_tpu_torch.ops import paged_kernel as tk

TOL = dict(atol=2e-6, rtol=1e-5)
N_PAGES = 4


def _case(group, page, hkv=2, d=32, seed=0):
    """Rows at lengths 0, page-1, page and max_len-1; each row owns
    distinct pages up to its depth, unallocated table entries are page 0
    (the scratch page, filled with garbage the mask must exclude)."""
    rng = np.random.default_rng(seed)
    max_len = N_PAGES * page
    lengths = np.array([0, page - 1, page, max_len - 1], np.int32)
    b, h = len(lengths), hkv * group
    n_pool = b * N_PAGES + 1
    ids = rng.permutation(np.arange(1, n_pool))
    tables = np.zeros((b, N_PAGES), np.int32)
    used = 0
    for r, length in enumerate(lengths):
        n = length // page + 1
        tables[r, :n] = ids[used : used + n]
        used += n
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    k = rng.standard_normal((n_pool, page, hkv, d)).astype(np.float32)
    v = rng.standard_normal((n_pool, page, hkv, d)).astype(np.float32)
    return q, k, v, tables, lengths


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("page", [4, 16])
@pytest.mark.parametrize("group", [1, 2, 4])
def test_plain_version_matches_jax_kernel_and_reference(group, page):
    q, k, v, tables, lengths = _case(group, page)
    jargs = [jnp.asarray(a) for a in (q, k, v, tables, lengths)]
    want_kernel = np.asarray(jk.paged_decode_attention(*jargs, interpret=True))
    want_ref = np.asarray(jk.paged_decode_attention_reference(*jargs))
    got = tk.paged_decode_attention_reference(*_torch(q, k, v, tables, lengths))
    got_wrapped = tk.paged_decode_attention(*_torch(q, k, v, tables, lengths))
    assert got.dtype == torch.float32 and tuple(got.shape) == q.shape
    np.testing.assert_allclose(got.numpy(), want_kernel, **TOL)
    np.testing.assert_allclose(got.numpy(), want_ref, **TOL)
    np.testing.assert_array_equal(got_wrapped.numpy(), got.numpy())


def test_scratch_page_contents_never_leak():
    """Rewriting the scratch page (what free rows of a decode step do)
    changes no live row's output."""
    q, k, v, tables, lengths = _case(2, 4, seed=5)
    before = tk.paged_decode_attention(*_torch(q, k, v, tables, lengths))
    k[0], v[0] = 1e3, -1e3
    after = tk.paged_decode_attention(*_torch(q, k, v, tables, lengths))
    np.testing.assert_array_equal(after.numpy(), before.numpy())


def test_gather_pages_layout():
    pool = torch.arange(5 * 2 * 3, dtype=torch.float32).reshape(5, 2, 3)
    tables = torch.tensor([[3, 1], [0, 0]], dtype=torch.int32)
    out = tk.gather_pages(pool, tables)
    assert tuple(out.shape) == (2, 4, 3)
    torch.testing.assert_close(out[0], torch.cat([pool[3], pool[1]]))
    torch.testing.assert_close(out[1], torch.cat([pool[0], pool[0]]))


def test_cpu_tensors_never_bump_launches():
    before = tk.launches
    tk.paged_decode_attention(*_torch(*_case(1, 4)))
    assert tk.launches == before


def _bad(**change):
    q, k, v, tables, lengths = _torch(*_case(2, 4))
    args = dict(q=q, k_pages=k, v_pages=v, block_tables=tables, lengths=lengths)
    args.update(change)
    return args


@pytest.mark.parametrize(
    "change, match",
    [
        (lambda a: dict(block_tables=a["block_tables"].long()), "int32"),
        (lambda a: dict(lengths=a["lengths"].long()), "int32"),
        (lambda a: dict(lengths=a["lengths"][:2]), "lengths must be"),
        (lambda a: dict(block_tables=a["block_tables"][:2]), "block_tables must"),
        (lambda a: dict(q=a["q"].double()), "share a dtype"),
        (lambda a: dict(q=a["q"][:, :3]), "multiple of kv heads"),
        (lambda a: dict(q=a["q"][..., :16]), "head dim"),
        (lambda a: dict(v_pages=a["v_pages"][:-1]), "differ"),
        (lambda a: dict(q=a["q"][0]), "expected q"),
        (lambda a: dict(block_tables=a["block_tables"] + 100), "outside"),
        (lambda a: dict(block_tables=a["block_tables"] - 1), "outside"),
    ],
)
def test_bad_inputs_raise(change, match):
    args = _bad()
    args.update(change(args))
    with pytest.raises(ValueError, match=match):
        tk.paged_decode_attention(**args)


def test_launch_counts_lose_nothing_under_threads():
    """The launch counters are bumped from several threads at once (the
    HTTP server steps its router in a worker thread; a router may step
    replicas in parallel): 48 threads x 500 counted launches each, with a
    shortened switch interval, lose none."""
    import sys
    import threading

    before = (tk.launches, tk.launches_q8)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [
            threading.Thread(target=lambda q8=bool(i % 2): [
                tk._count_launch(q8) for _ in range(500)])
            for i in range(48)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert (tk.launches - before[0], tk.launches_q8 - before[1]) == (
            24 * 500, 24 * 500)
    finally:
        sys.setswitchinterval(interval)
        tk.launches, tk.launches_q8 = before
