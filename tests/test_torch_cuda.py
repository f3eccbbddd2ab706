"""The port's CUDA kernels on the card, against their plain versions.

Marked ``cuda``: they need an NVIDIA GPU with nvcc and skip elsewhere.
This file imports no JAX, so it also runs where JAX is not installed;
there, skip the repository's ``conftest.py`` (which imports JAX):

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import numpy as np
import pytest
import torch

from pytorch_distributed_tpu_torch.config import ModelConfig
from pytorch_distributed_tpu_torch.models import gpt2
from pytorch_distributed_tpu_torch.ops import paged_kernel as pk
from pytorch_distributed_tpu_torch.serving import PagedBatchedDecodeEngine

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _case(dev, b, h, hkv, d, dtype, page=16, n_pages=8, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    n_pool = b * n_pages + 1
    k = torch.randn(n_pool, page, hkv, d, generator=g, device=dev).to(dtype)
    v = torch.randn(n_pool, page, hkv, d, generator=g, device=dev).to(dtype)
    q = torch.randn(b, h, d, generator=g, device=dev).to(dtype)
    lengths = torch.randint(0, n_pages * page, (b,), generator=g, device=dev,
                            dtype=torch.int32)
    lengths[0], lengths[-1] = 0, n_pages * page - 1
    ids = torch.randperm(n_pool - 1, generator=g, device=dev) + 1
    ids = ids[: b * n_pages].reshape(b, n_pages)
    used = torch.arange(n_pages, device=dev)[None] * page <= lengths[:, None]
    tables = torch.where(used, ids, 0).to(torch.int32).contiguous()
    return q, k, v, tables, lengths


@pytest.mark.parametrize("dtype, tol", [
    (torch.float32, dict(atol=1e-5, rtol=0.0)),
    (torch.bfloat16, dict(atol=3e-3, rtol=1e-2)),
])
@pytest.mark.parametrize("b, h, hkv, d", [(8, 12, 12, 64), (8, 32, 8, 64),
                                          (4, 32, 8, 128), (3, 16, 2, 64)])
def test_paged_kernel_matches_plain_version(cuda, b, h, hkv, d, dtype, tol):
    """f32 differs from the plain version only in summation order. In
    bf16 the plain version rounds its softmax weights to bf16 and the
    kernel does not; against the plain version in f32 on the same values
    the kernel may differ only by its one bf16 rounding of the output,
    at most 2^-8 of the value."""
    args = _case(cuda, b, h, hkv, d, dtype)
    before = pk.launches
    out = pk.paged_decode_attention(*args)
    torch.cuda.synchronize()
    assert pk.launches == before + 1
    ref = pk.paged_decode_attention_reference(*args)
    assert out.dtype == dtype and out.shape == ref.shape
    torch.testing.assert_close(out.float(), ref.float(), **tol)
    if dtype == torch.bfloat16:
        exact = pk.paged_decode_attention_reference(
            *(t.float() for t in args[:3]), *args[3:]
        )
        torch.testing.assert_close(out.float(), exact, atol=1e-5,
                                   rtol=2.0**-8)


def test_paged_kernel_refuses_what_it_does_not_take(cuda):
    q, k, v, tables, lengths = _case(cuda, 2, 4, 4, 64, torch.float32)
    with pytest.raises(ValueError, match="head_dim"):
        pk.paged_decode_attention(q[..., :32].contiguous(),
                                  k[..., :32].contiguous(),
                                  v[..., :32].contiguous(), tables, lengths)
    with pytest.raises(ValueError, match="kernel takes"):
        pk.paged_decode_attention(q.half(), k.half(), v.half(), tables,
                                  lengths)
    with pytest.raises(ValueError, match="contiguous"):
        pk.paged_decode_attention(q.transpose(0, 1).contiguous()
                                  .transpose(0, 1), k, v, tables, lengths)
    with pytest.raises(ValueError, match="one device"):
        pk.paged_decode_attention(q, k, v, tables.cpu(), lengths)


def test_engine_kernel_path_matches_gather_path_on_the_card(cuda):
    cfg = ModelConfig(vocab_size=97, n_ctx=64, n_embd=128, n_layer=2,
                      n_head=2, dtype="float32")
    params = gpt2.init(torch.Generator().manual_seed(0), cfg)
    rng = np.random.default_rng(0)
    reqs = [dict(prompt=rng.integers(0, 97, n), max_new_tokens=m)
            for n, m in ((5, 9), (17, 6), (9, 12), (30, 4))]
    outs = {}
    for impl in ("kernel", "gather"):
        eng = PagedBatchedDecodeEngine(cfg, slots=3, max_len=64, page_size=16,
                                       paged_attention=impl)
        before = pk.launches
        outs[impl] = eng.run(params, reqs)
        launched = pk.launches - before
        assert launched == (
            cfg.n_layer * eng.counters["decode_ticks"] if impl == "kernel"
            else 0
        )
    for rid, res in outs["kernel"].items():
        assert res.state == "DONE"
        np.testing.assert_array_equal(res.tokens, outs["gather"][rid].tokens)


# -- the int8 paged decode kernel: K4 ------------------------------------------


def _q8_case(dev, b, h, hkv, d, dtype, page=16, n_pages=8, seed=0):
    """K4's inputs: ``_case``'s rows and tables, the pages quantized by the
    port's ``quantize_kv`` from f32 normals."""
    from pytorch_distributed_tpu_torch.ops.quant import quantize_kv

    q, k, v, tables, lengths = _case(dev, b, h, hkv, d, torch.float32, page,
                                     n_pages, seed)
    (kq, ks), (vq, vs) = quantize_kv(k), quantize_kv(v)
    return q.to(dtype), kq, vq, tables, lengths, ks, vs


@pytest.mark.parametrize("dtype, tol", [
    (torch.float32, dict(atol=1e-5, rtol=0.0)),
    (torch.bfloat16, dict(atol=2.4e-2, rtol=1e-2)),
])
@pytest.mark.parametrize("b, h, hkv, d", [(8, 12, 12, 64), (8, 32, 8, 64),
                                          (4, 32, 8, 128), (3, 16, 2, 64)])
def test_q8_kernel_matches_plain_version(cuda, b, h, hkv, d, dtype, tol):
    """f32: K4 scales q.k_int by the token's scale where the plain version
    dequantizes each element first (rounding order only). bf16: the plain
    version dequantizes the pages to bf16 and rounds its softmax weights
    (``chip_smoke.Q8_TOLERANCES``: 3x the largest difference measured);
    against the plain version with q in f32 on the same int8 pages and
    scales K4 may differ only by its one bf16 rounding of the output, at
    most 2^-8 of the value."""
    args = _q8_case(cuda, b, h, hkv, d, dtype)
    before = (pk.launches, pk.launches_q8)
    out = pk.paged_decode_attention(*args)
    torch.cuda.synchronize()
    assert (pk.launches, pk.launches_q8) == (before[0], before[1] + 1)
    ref = pk.paged_decode_attention_reference(*args)
    assert out.dtype == dtype and out.shape == ref.shape
    torch.testing.assert_close(out.float(), ref.float(), **tol)
    if dtype == torch.bfloat16:
        exact = pk.paged_decode_attention_reference(args[0].float(),
                                                    *args[1:])
        torch.testing.assert_close(out.float(), exact, atol=1e-5,
                                   rtol=2.0**-8)


def test_q8_kernel_reads_only_valid_keys(cuda):
    """Poisoning every page slot past each row's depth (values and scales,
    NaN scales included) changes no output bit."""
    q, kq, vq, tables, lengths, ks, vs = _q8_case(cuda, 4, 8, 2, 64,
                                                   torch.bfloat16)
    before = pk.paged_decode_attention(q, kq, vq, tables, lengths, ks, vs)
    page = kq.shape[1]
    ks2, vs2, kq2 = ks.clone(), vs.clone(), kq.clone()
    for r in range(q.shape[0]):
        depth = int(lengths[r]) + 1
        for j in range(tables.shape[1]):
            pid = int(tables[r, j])
            lo = max(0, depth - j * page)
            if pid and lo < page:
                ks2[pid, lo:], vs2[pid, lo:] = float("nan"), 1e30
                kq2[pid, lo:] = 127
    ks2[0], vs2[0] = float("nan"), float("nan")  # the scratch page
    after = pk.paged_decode_attention(q, kq2, vq, tables, lengths, ks2, vs2)
    torch.cuda.synchronize()
    assert torch.equal(after, before)


def test_q8_kernel_refuses_what_it_does_not_take(cuda):
    q, kq, vq, tables, lengths, ks, vs = _q8_case(cuda, 2, 8, 2, 64,
                                                   torch.float32)
    with pytest.raises(ValueError, match="together"):
        pk.paged_decode_attention(q, kq, vq, tables, lengths, ks, None)
    with pytest.raises(ValueError, match="k_scales must be"):
        pk.paged_decode_attention(q, kq, vq, tables, lengths, ks[..., :1],
                                  vs)
    with pytest.raises(ValueError, match="head_dim"):
        pk.paged_decode_attention(q[..., :32].contiguous(),
                                  kq[..., :32].contiguous(),
                                  vq[..., :32].contiguous(), tables, lengths,
                                  ks, vs)
    with pytest.raises(ValueError, match="groups"):
        pk.paged_decode_attention(q[:, :6].contiguous(), kq[:, :, :1], vq[
            :, :, :1], tables, lengths, ks[..., :1], vs[..., :1])
    with pytest.raises(ValueError, match="kernel takes"):
        pk.paged_decode_attention(q.half(), kq, vq, tables, lengths, ks, vs)


def test_int8_engine_kernel_path_matches_gather_path_on_the_card(cuda):
    cfg = ModelConfig(vocab_size=97, n_ctx=64, n_embd=128, n_layer=2,
                      n_head=2, dtype="float32")
    params = gpt2.init(torch.Generator().manual_seed(0), cfg)
    rng = np.random.default_rng(0)
    reqs = [dict(prompt=rng.integers(0, 97, n), max_new_tokens=m)
            for n, m in ((5, 9), (17, 6), (9, 12), (30, 4))]
    outs = {}
    for impl in ("kernel", "gather"):
        eng = PagedBatchedDecodeEngine(cfg, slots=3, max_len=64, page_size=16,
                                       paged_attention=impl, kv_quant="int8",
                                       weight_quant="int8")
        before = (pk.launches, pk.launches_q8)
        outs[impl] = eng.run(params, reqs)
        launched = (pk.launches - before[0], pk.launches_q8 - before[1])
        assert launched == (0, cfg.n_layer * eng.counters["decode_ticks"]
                            if impl == "kernel" else 0)
    for rid, res in outs["kernel"].items():
        assert res.state == "DONE"
        np.testing.assert_array_equal(res.tokens, outs["gather"][rid].tokens)


# -- K3 and K4's split rows: chunk edges, determinism, independence ------------


def _edge_case(dev, h, hkv, d, dtype, q8, page=16, n_pages=128, seed=0):
    """Rows at lengths 0, page-1, page and, for every split count the
    table allows (max_len 2048), the last key of that many chunks, the
    next one and the one after; each row over distinct pool pages up to
    its depth, the rest of its table on the scratch page 0. ``q8``: K4's
    int8 pages and scales from ``quantize_kv``. Returns the wrapper's
    arguments."""
    from pytorch_distributed_tpu_torch.ops.quant import quantize_kv

    chunk, n_splits = pk._split_plan(page, n_pages, d,
                                     torch.int8 if q8 else dtype)
    max_len = n_pages * page
    edges = {0, page - 1, page, max_len - 1}
    for n in range(1, n_splits + 1):
        edges |= {min(n * chunk + i, max_len - 1) for i in (-1, 0, 1)}
    lengths = torch.tensor(sorted(edges), dtype=torch.int32, device=dev)
    b = len(lengths)
    g = torch.Generator(device=dev).manual_seed(seed)
    used = torch.arange(n_pages, device=dev)[None] * page <= lengths[:, None]
    n_pool = int(used.sum()) + 1
    ids = torch.zeros(b, n_pages, dtype=torch.int64, device=dev)
    ids[used] = torch.randperm(n_pool - 1, generator=g, device=dev) + 1
    tables = ids.to(torch.int32).contiguous()
    k = torch.randn(n_pool, page, hkv, d, generator=g, device=dev)
    v = torch.randn(n_pool, page, hkv, d, generator=g, device=dev)
    q = torch.randn(b, h, d, generator=g, device=dev).to(dtype)
    if not q8:
        return (q, k.to(dtype), v.to(dtype), tables, lengths)
    (kq, ks), (vq, vs) = quantize_kv(k), quantize_kv(v)
    return (q, kq, vq, tables, lengths, ks, vs)


@pytest.mark.parametrize("q8", [False, True], ids=["K3", "K4"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("group", [1, 2, 4, 8])
def test_paged_kernels_at_every_chunk_edge(cuda, group, d, dtype, q8):
    """K3 and K4 against their plain versions with chip_smoke's
    tolerances (``check_kernel``: ``TOLERANCES``, ``Q8_TOLERANCES`` and,
    in bf16, ``BF16_VS_F32``) over rows at every chunk edge of every split
    count up to max_len 2048."""
    import chip_smoke

    args = _edge_case(cuda, 2 * group, 2, d, dtype, q8, seed=group + d)
    before = (pk.launches, pk.launches_q8)
    chip_smoke.check_kernel(pk, args, f"group {group} D {d} {dtype} q8 {q8}")
    assert (pk.launches, pk.launches_q8) == (before[0] + (not q8),
                                             before[1] + q8)


@pytest.mark.parametrize("q8", [False, True], ids=["K3", "K4"])
def test_paged_kernels_are_deterministic_and_batch_independent(cuda, q8):
    """Two launches give the same bits; each row alone (B = 1) gives the
    bits it gets inside the batch and inside a table twice as wide."""
    args = _edge_case(cuda, 8, 2, 64, torch.bfloat16, q8)
    q, kp, vp, tables, lengths, *scales = args
    first = pk.paged_decode_attention(*args)
    second = pk.paged_decode_attention(*args)
    wide = torch.cat([tables, torch.zeros_like(tables)], 1).contiguous()
    rows = [pk.paged_decode_attention(q[r:r + 1], kp, vp, t[r:r + 1],
                                      lengths[r:r + 1], *scales)
            for t in (tables, wide) for r in range(q.shape[0])]
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    assert torch.equal(torch.cat(rows), torch.cat([first, first]))


@pytest.mark.parametrize("q8", [False, True], ids=["K3", "K4"])
def test_paged_kernels_read_nothing_past_a_rows_depth(cuda, q8):
    """NaN in every K/V slot past each row's depth (and in its scales for
    K4), the scratch page included, changes no output bit."""
    args = _edge_case(cuda, 8, 2, 64, torch.bfloat16, q8, n_pages=32)
    before = pk.paged_decode_attention(*args)
    tables, lengths = args[3], args[4]
    page = args[1].shape[1]
    slot = torch.arange(page, device=cuda)
    poisoned = [a.clone() for a in args]
    for pool in (poisoned[1], poisoned[2], *poisoned[5:]):
        fill = 127 if pool.dtype == torch.int8 else float("nan")
        pool[0] = fill
        for r in range(tables.shape[0]):
            for j in range(tables.shape[1]):
                pid = int(tables[r, j])
                past = j * page + slot > int(lengths[r])
                if pid and bool(past.any()):
                    pool[pid, past] = fill
    after = pk.paged_decode_attention(*poisoned)
    torch.cuda.synchronize()
    assert torch.equal(after, before)


def test_paged_kernel_counters_stay_zero(cuda):
    """Every split counter is 0 after a launch, also after a launch at a
    larger batch that grew the workspace."""
    for b_rows in (1, 3):
        args = _edge_case(cuda, 4, 2, 64, torch.bfloat16, False)
        args = tuple(torch.cat([a] * b_rows) if i in (0, 3, 4) else a
                     for i, a in enumerate(args))
        out = pk.paged_decode_attention(*args)
        torch.cuda.synchronize()
        stream = torch.cuda.current_stream(cuda).cuda_stream
        counters = pk._workspaces[(args[0].device, stream)][1]
        assert counters.numel() >= args[0].shape[0] * 2
        assert not bool(counters.any())
        torch.testing.assert_close(
            out.float(), pk.paged_decode_attention_reference(*args).float(),
            atol=3e-3, rtol=1e-2)


def test_paged_kernels_on_two_streams_match_serial_launches(cuda):
    """K3 and K4 launched concurrently on two non-default streams, each
    stream with inputs of its own, many times: every output is bit-equal
    to a serial launch of the same inputs on one stream, and every counter
    of every workspace is back at 0. Both streams wait on one event that
    a third stream records after a 20 ms spin, so all their launches are
    queued before the first runs and the two streams' kernels overlap."""
    rounds = 25
    inputs = [[_edge_case(cuda, 8, 2, 64, torch.bfloat16, q8, seed=seed)
               for q8 in (False, True)] for seed in (1, 2)]
    want = [[pk.paged_decode_attention(*a) for a in pair] for pair in inputs]
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(cuda) for _ in inputs]
    gate, spinner = torch.cuda.Event(), torch.cuda.Stream(cuda)
    with torch.cuda.stream(spinner):
        torch.cuda._sleep(50_000_000)  # ~20-30 ms at H100 clocks
        gate.record(spinner)
    got = []
    for stream, pair in zip(streams, inputs):
        stream.wait_event(gate)
        with torch.cuda.stream(stream):
            got.append([[pk.paged_decode_attention(*a) for a in pair]
                        for _ in range(rounds)])
    torch.cuda.synchronize()
    for s, per_stream in enumerate(got):
        for r, outs in enumerate(per_stream):
            for kind, (out, ref) in enumerate(zip(outs, want[s])):
                assert torch.equal(out, ref), (s, r, ("K3", "K4")[kind])
    counters = [c for _, c in pk._workspaces.values()]
    assert not any(bool(c.any()) for c in counters)
    assert len(counters) >= 3  # the default stream's and one per stream


@pytest.mark.parametrize("q8", [False, True], ids=["K3", "K4"])
def test_paged_kernels_clamp_page_ids_into_the_pool(cuda, q8):
    """Page ids below 0 or past the pool read the first or last page (as
    a JAX gather clamps them): the plain version on the clamped table."""
    args = list(_edge_case(cuda, 4, 2, 64, torch.float32, q8, n_pages=16))
    n_pool = args[1].shape[0]
    tables = args[3].clone()
    tables[1::2] += n_pool  # past the pool
    tables[2::4] -= 3 * n_pool  # below 0
    out = pk.paged_decode_attention(*args[:3], tables, *args[4:])
    torch.cuda.synchronize()
    want = pk.paged_decode_attention_reference(
        *args[:3], tables.clamp(0, n_pool - 1), *args[4:])
    torch.testing.assert_close(out, want, atol=1e-5, rtol=0.0)


# -- flash attention: K1 (forward) and K2 (backward) --------------------------
# The tolerances are chip_smoke.py's, and so is the check (``check_flash``):
# f32 summation order only against the f32 plain versions; bf16 held to the
# bf16 plain versions (``FLASH_TOLERANCES``, both round P and dS to bf16
# before their products) and to the plain versions in f32 on the same
# values (``flash_fwd_bf16_vs_f32``, derived; ``FLASH_BF16_VS_F32``,
# measured). chip_smoke imports only torch and numpy at module level.


def _flash_case(dev, b, h, hkv, t, d, dtype, seed=0):
    from pytorch_distributed_tpu_torch.ops import flash_kernel as fk

    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v, do = (
        torch.randn(b, n, t, d, generator=g, device=dev).to(dtype)
        for n in (h, hkv, hkv, h)
    )
    return fk, q, k, v, do


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b, h, hkv, t, d, causal", [
    (2, 4, 4, 256, 64, True), (1, 8, 2, 200, 64, True),
    (1, 8, 1, 77, 128, False), (2, 4, 4, 64, 128, True),
    (1, 8, 8, 1, 64, True),
])
def test_flash_kernels_match_plain_versions(cuda, b, h, hkv, t, d, causal,
                                            dtype):
    import chip_smoke

    fk, q, k, v, do = _flash_case(cuda, b, h, hkv, t, d, dtype)
    before = dict(fk.launches)
    chip_smoke.check_flash(fk, q, k, v, do, causal, "case")
    assert fk.launches == {"forward": before["forward"] + 1,
                           "backward": before["backward"] + 1}
    o, lse = fk.flash_forward(q, k, v, causal)
    grads = fk.flash_backward(q, k, v, o, lse, do, causal)
    assert o.dtype == dtype and o.shape == q.shape
    assert lse.dtype == torch.float32 and lse.shape == q.shape[:3]
    for a, x in zip(grads, (q, k, v)):
        assert a.dtype == dtype and a.shape == x.shape


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("group", [1, 2, 4, 8])
@pytest.mark.parametrize("t", [1, 63, 64, 65, 127, 128, 129, 1000])
def test_bf16_flash_kernels_at_ragged_lengths(cuda, t, group, d, causal):
    """The wgmma kernels against the plain versions at every tile edge (64-
    key and 128-query tiles), each GQA group, both head dims."""
    import chip_smoke

    fk, q, k, v, do = _flash_case(cuda, 1, 8, 8 // group, t, d,
                                  torch.bfloat16, seed=t)
    chip_smoke.check_flash(fk, q, k, v, do, causal,
                           f"T={t} group={group} D={d} causal={causal}")


@pytest.mark.parametrize("h, d, t", [(12, 64, 1024), (4, 128, 200)])
def test_bf16_flash_kernels_take_qkv_views(cuda, h, d, t):
    """q, k, v as views of one [B, T, 3, H, D] projection and do as a view of
    [B, T, H, D] give the same bits as contiguous copies; o, dq, dk, dv come
    back as [B, H, T, D] views of [B, T, H, D] memory."""
    from pytorch_distributed_tpu_torch.ops import flash_kernel as fk

    g = torch.Generator(device=cuda).manual_seed(1)
    b = 2
    qkv = torch.randn(b, t, 3, h, d, generator=g, device=cuda).to(
        torch.bfloat16)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    do = torch.randn(b, t, h, d, generator=g, device=cuda).to(
        torch.bfloat16).transpose(1, 2)
    outs = {}
    for name, args in (("views", (q, k, v, do)),
                       ("copies", tuple(x.contiguous() for x in (q, k, v,
                                                                  do)))):
        o, lse = fk.flash_forward(*args[:3], True)
        grads = fk.flash_backward(*args[:3], o, lse, args[3], True)
        outs[name] = (o, lse, *grads)
    torch.cuda.synchronize()
    for a, c in zip(outs["views"], outs["copies"]):
        assert torch.equal(a, c)
    bthd = (t * h * d, d, h * d, 1)
    for x in (outs["views"][0], *outs["views"][2:]):
        assert x.stride() == bthd


@pytest.mark.parametrize("b, h, hkv, t, d", [(2, 12, 12, 1024, 64),
                                             (1, 8, 2, 300, 128)])
def test_bf16_flash_backward_is_deterministic(cuda, b, h, hkv, t, d):
    """No atomics: two runs of K2 (and of K1) give the same bits."""
    fk, q, k, v, do = _flash_case(cuda, b, h, hkv, t, d, torch.bfloat16)
    o, lse = fk.flash_forward(q, k, v, True)
    o2, lse2 = fk.flash_forward(q, k, v, True)
    first = fk.flash_backward(q, k, v, o, lse, do, True)
    second = fk.flash_backward(q, k, v, o, lse, do, True)
    torch.cuda.synchronize()
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    for a, c in zip(first, second):
        assert torch.equal(a, c)


@pytest.mark.parametrize("t, causal", [(130, True), (63, False)])
def test_bf16_flash_kernels_read_nothing_past_t(cuda, t, causal):
    """Every input as the first T rows of a longer buffer whose rows past T
    are NaN: the same bits as on tight tensors."""
    fk, q, k, v, do = _flash_case(cuda, 2, 8, 2, t, 64, torch.bfloat16)
    o, lse = fk.flash_forward(q, k, v, causal)
    want = (o, lse, *fk.flash_backward(q, k, v, o, lse, do, causal))

    def poisoned(x):
        buf = torch.full((*x.shape[:2], t + 67, x.shape[3]), float("nan"),
                         dtype=x.dtype, device=x.device)
        buf[:, :, :t] = x
        return buf[:, :, :t]

    pq, pk, pv, pdo, po = (poisoned(x) for x in (q, k, v, do, o))
    o2, lse2 = fk.flash_forward(pq, pk, pv, causal)
    got = (o2, lse2, *fk.flash_backward(pq, pk, pv, po, lse, pdo, causal))
    torch.cuda.synchronize()
    for a, c in zip(got, want):
        assert torch.equal(a, c)


def test_flash_mha_trains_through_the_bf16_kernels(cuda):
    """flash_mha's gradient through K2 in bf16 matches the plain versions
    (chip_smoke's bf16 tolerance), and Adam on q, k, v (f32 masters, cast
    to bf16 for each step) lowers a regression loss through the kernels."""
    import chip_smoke

    fk, q, k, v, do = _flash_case(cuda, 2, 4, 2, 130, 64, torch.bfloat16)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    o, lse = fk.flash_mha(*leaves)
    got = torch.autograd.grad(o, leaves, do)
    want = fk.flash_backward_reference(q, k, v, o.detach(), lse, do)
    tol = chip_smoke.FLASH_TOLERANCES[torch.bfloat16]["bwd"]
    for a, b in zip(got, want):
        assert a.dtype == torch.bfloat16
        torch.testing.assert_close(a.float(), b.float(), **tol)

    target = torch.randn(o.shape, generator=torch.Generator(
        device=cuda).manual_seed(3), device=cuda)
    masters = [x.float().clone().requires_grad_() for x in (q, k, v)]
    opt = torch.optim.Adam(masters, lr=3e-2)
    before = dict(fk.launches)
    losses = []
    for _ in range(30):
        o, _ = fk.flash_mha(*(x.to(torch.bfloat16) for x in masters))
        loss = ((o.float() - target) ** 2).mean()
        opt.zero_grad()
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
    assert fk.launches == {"forward": before["forward"] + 30,
                           "backward": before["backward"] + 30}
    assert np.isfinite(losses).all() and losses[-1] < 0.9 * losses[0]


def test_flash_mha_trains_through_the_kernels(cuda):
    fk, q, k, v, do = _flash_case(cuda, 2, 4, 2, 130, 64, torch.float32)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    before = dict(fk.launches)
    o, _ = fk.flash_mha(*leaves)
    got = torch.autograd.grad((o * do).sum(), leaves)
    assert fk.launches == {"forward": before["forward"] + 1,
                           "backward": before["backward"] + 1}
    ref_leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    o_ref, _ = fk.flash_forward_reference(*ref_leaves)
    want = torch.autograd.grad((o_ref * do).sum(), ref_leaves)
    torch.testing.assert_close(o, o_ref, atol=1e-5, rtol=1e-5)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-5)
    # An expanded gradient (head dim stride 0) is made contiguous first.
    o, _ = fk.flash_mha(*leaves)
    got = torch.autograd.grad(o.sum(), leaves)
    o_ref, _ = fk.flash_forward_reference(*ref_leaves)
    want = torch.autograd.grad(o_ref.sum(), ref_leaves)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-5)


def test_flash_kernels_refuse_what_they_do_not_take(cuda):
    fk, q, k, v, do = _flash_case(cuda, 1, 4, 4, 64, 64, torch.float32)
    with pytest.raises(ValueError, match="head_dim"):
        fk.flash_forward(q[..., :32], k[..., :32], v[..., :32])
    with pytest.raises(ValueError, match="kernel takes"):
        fk.flash_forward(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="contiguous head dim"):
        fk.flash_forward(q.transpose(2, 3), k.transpose(2, 3),
                         v.transpose(2, 3))


@pytest.mark.parametrize("impl, attn_pdrop", [("naive", 0.1), ("flash", 0.0),
                                              ("flash", 0.1)])
def test_dropout_masks_are_redrawn_bit_for_bit_on_recompute(
        cuda, monkeypatch, impl, attn_pdrop):
    """A training-mode GPT-2 forward and backward on the card under every
    remat mode that recomputes: each block mask is drawn twice (forward and
    recompute) with the same bits, the embedding mask once; the f32
    gradients equal mode none's within 1e-5 (kernels and cuBLAS are the
    same calls in both), and each mask keeps ~90 %."""
    from pytorch_distributed_tpu_torch.utils import prng, tree

    drawn = {}
    draw = prng.draw_keep_mask

    def record(sid, shape, keep, device):
        m = draw(sid, shape, keep, device)
        drawn.setdefault(sid, []).append(m.clone())
        return m

    monkeypatch.setattr(prng, "draw_keep_mask", record)

    def grads(mode):
        cfg = ModelConfig(vocab_size=512, n_ctx=128, n_embd=128, n_layer=2,
                          n_head=2, dtype="float32", remat=mode,
                          attention_impl=impl, attn_pdrop=attn_pdrop)
        params = gpt2.init(torch.Generator().manual_seed(0), cfg,
                           device=cuda)
        leaves = [p.requires_grad_() for p in tree.leaves(params)]
        ids = torch.randint(0, 512, (2, 128), device=cuda,
                            generator=torch.Generator(cuda).manual_seed(1))
        drawn.clear()
        logits = gpt2.apply(params, ids, cfg, deterministic=False,
                            dropout_seed=(3, 4, 0))
        return torch.autograd.grad(logits.square().mean(), leaves)

    ref = grads("none")
    assert all(len(v) == 1 for v in drawn.values())
    for mode in ("full", "dots", "dots_no_batch", "names", "flash"):
        got = grads(mode)
        for sid, masks in drawn.items():
            assert len(masks) == (1 if sid.site == "embd" else 2), sid
            assert torch.equal(masks[0], masks[-1]), (mode, sid)
            assert abs(float(masks[0].float().mean()) - 0.9) < 0.01
        for a, b in zip(got, ref):
            torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)


def test_linear_cross_entropy_matches_the_unfused_loss_in_bf16(cuda):
    """The fused head + CE at GPT-2's vocab (50257: 7 blocks, the last one
    padded) against the bf16 head and ``cross_entropy_loss``: loss within
    rtol 1e-3; dx and dW within 2e-2 of their norm (both sides round the
    block logits to bf16, but the unfused dW is rounded to bf16 once more
    and cuBLAS may sum the two in another order)."""
    from pytorch_distributed_tpu_torch.ops import losses

    g = torch.Generator(cuda).manual_seed(0)
    n, e, v = 2048, 768, 50257
    x = torch.randn(n, e, device=cuda, generator=g).to(torch.bfloat16)
    w = torch.randn(v, e, device=cuda, generator=g) * 0.02
    t = torch.randint(0, v, (n,), device=cuda, generator=g)
    leaves = [x.clone().requires_grad_(), w.clone().requires_grad_()]
    fused = losses.linear_cross_entropy(*leaves, t,
                                        logits_dtype="bfloat16")
    g_fused = torch.autograd.grad(fused, leaves)
    leaves2 = [x.clone().requires_grad_(), w.clone().requires_grad_()]
    unfused = losses.cross_entropy_loss(
        leaves2[0] @ leaves2[1].to(torch.bfloat16).t(), t)
    g_unfused = torch.autograd.grad(unfused, leaves2)
    torch.testing.assert_close(fused, unfused, atol=0.0, rtol=1e-3)
    for a, b in zip(g_fused, g_unfused):
        assert a.dtype == b.dtype
        rel = float((a.float() - b.float()).norm() / b.float().norm())
        assert rel < 2e-2, rel


@pytest.mark.parametrize("t", [4096, 8192])
def test_bf16_flash_kernels_at_llama_long_context(cuda, t):
    """K1 and K2 at the Llama-3.2-1B training shapes of the long-context
    rows (B 1, 32 query heads over 8 KV heads, head_dim 64, causal): the
    plain versions run one KV head's group at a time (the f32 scores of all
    heads at T=8192 take 8.6 GB per tensor)."""
    import chip_smoke

    fk, q, k, v, do = _flash_case(cuda, 1, 32, 8, t, 64, torch.bfloat16)
    chip_smoke.check_flash(fk, q, k, v, do, True, f"llama T={t}", chunks=8)


@pytest.mark.parametrize("family, top_k", [("gpt2", 2), ("llama", 2),
                                           ("gpt2", 3)])
def test_moe_step_is_bit_deterministic(cuda, family, top_k):
    """Two runs of one MoE forward and backward (sort dispatch, bf16) give
    the same loss and gradients bit for bit: a token's top-k contributions
    are summed in a fixed order, never by atomics."""
    from pytorch_distributed_tpu_torch.config import model_config
    from pytorch_distributed_tpu_torch.models import get_model
    from pytorch_distributed_tpu_torch.train.trainer import _loss
    from pytorch_distributed_tpu_torch.utils import tree

    preset = "gpt2" if family == "gpt2" else "llama3-1b"
    cfg = model_config(preset, n_layer=2, n_embd=256, n_head=4,
                       vocab_size=512, n_ctx=256, n_inner=512,
                       n_experts=8, moe_top_k=top_k, moe_dispatch="sort",
                       attention_impl="flash", remat="names",
                       embd_pdrop=0.0, attn_pdrop=0.0, resid_pdrop=0.0,
                       **({"n_kv_head": 2} if family == "llama" else {}))
    model = get_model(cfg)
    params = model.init(torch.Generator(cuda).manual_seed(0), cfg,
                        device=cuda)
    g = torch.Generator(cuda).manual_seed(1)
    ids, tgt = (torch.randint(0, 512, (4, 256), device=cuda, generator=g)
                for _ in range(2))

    def run():
        leaves = [p.detach().clone().requires_grad_()
                  for p in tree.leaves(params)]
        loss = _loss(model, cfg, tree.unflatten(params, leaves), ids, tgt)
        return loss.detach(), torch.autograd.grad(loss, leaves)

    (l1, g1), (l2, g2) = run(), run()
    assert torch.equal(l1, l2)
    for a, b in zip(g1, g2):
        assert torch.equal(a, b)


# -- the serving tier on the card ------------------------------------------------


def _tier_cfg(dtype="float32", n_embd=128, n_head=2, vocab=97):
    return ModelConfig(vocab_size=vocab, n_ctx=128, n_embd=n_embd,
                       n_layer=2, n_head=n_head, dtype=dtype,
                       attn_pdrop=0.0, resid_pdrop=0.0, embd_pdrop=0.0)


def _tier_reqs(vocab, n=6, seed=0):
    rng = np.random.default_rng(seed)
    return [dict(prompt=rng.integers(0, vocab, int(rng.integers(5, 40))),
                 max_new_tokens=int(rng.integers(6, 16)))
            for _ in range(n)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_engine_tokens_do_not_depend_on_neighbours_on_the_card(cuda, dtype):
    """A request's tokens are the same alone and in a busy engine whose
    other rows arrive at other ticks: the prefill forward has one shape,
    [slots, chunk], whatever rows share it (GPT-2 width, 2 layers)."""
    cfg = _tier_cfg(dtype, n_embd=768, n_head=12, vocab=50257)
    params = gpt2.init(torch.Generator().manual_seed(0), cfg)
    reqs = _tier_reqs(cfg.vocab_size, n=5)
    alone = {}
    for i, r in enumerate(reqs):
        eng = PagedBatchedDecodeEngine(cfg, slots=4, max_len=128,
                                       page_size=16)
        alone[i] = eng.run(params, [r])[0].tokens
    eng = PagedBatchedDecodeEngine(cfg, slots=4, max_len=128, page_size=16)
    rids = {}
    for i, r in enumerate(reqs):
        rids[eng.submit(**r)] = i
        eng.step(params)  # staggered arrivals: other groupings each tick
    out = eng.run(params)
    for rid, i in rids.items():
        assert out[rid].state == "DONE"
        np.testing.assert_array_equal(out[rid].tokens, alone[i],
                                      err_msg=f"request {i}")


def _row_kv(eng, rid, n):
    """The K and V the engine holds for request ``rid``'s first ``n``
    positions, every layer: [L, n, Hkv, D] each, read through its table."""
    s = next(x for x in eng._slots if x is not None and x.rid == rid)
    pos = torch.arange(n)
    pages = torch.as_tensor(s.table)[pos // eng.page_size].long()
    offs = pos % eng.page_size
    return [eng._cache[name][:, pages, offs] for name in ("k", "v")]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_values_do_not_depend_on_neighbours_on_the_card(cuda,
                                                                 dtype):
    """A row's prefilled K/V are bit-equal whether it prefills alone or
    in one chunk forward with three other rows (GPT-2 width, 2 layers):
    the prefill forward has one shape, [slots, chunk]. Were the forward
    sized to the rows that prefill, cuBLAS could pick another kernel for
    the larger product, with another summation order."""
    cfg = _tier_cfg(dtype, n_embd=768, n_head=12, vocab=50257)
    params = gpt2.init(torch.Generator().manual_seed(4), cfg)
    rng = np.random.default_rng(4)
    x = rng.integers(0, cfg.vocab_size, 40)
    kv = []
    for others in ((), (50, 20, 60)):
        eng = PagedBatchedDecodeEngine(cfg, slots=4, max_len=128,
                                       page_size=16)
        for n in others:
            eng.submit(rng.integers(0, cfg.vocab_size, n), 4)
        rid = eng.submit(x, 4)
        eng.step(params)  # every row prefills its first chunk together
        assert eng.counters["prefill_ticks"] == 1
        kv.append(_row_kv(eng, rid, 40))
    for name, alone, busy in zip("kv", *kv):
        assert torch.equal(alone, busy), (
            name, (alone.float() - busy.float()).abs().max().item())


def test_router_failover_launches_k3_across_replicas(cuda):
    """A replica killed mid-decode: every request ends DONE exactly once,
    K3 launched n_layer x (decode ticks of every engine + one warmup per
    restart) and nothing else, and each request equals a single engine's
    run up to the tokens it had when it failed over (all of it when it
    did not)."""
    from pytorch_distributed_tpu_torch.serving.chaos import (
        RouterFault,
        RouterFaultInjector,
    )
    from pytorch_distributed_tpu_torch.serving.router import ReplicaRouter

    cfg = _tier_cfg()
    params = gpt2.init(torch.Generator().manual_seed(1), cfg)
    reqs = _tier_reqs(97, n=8, seed=1)
    ref = PagedBatchedDecodeEngine(cfg, slots=2, max_len=64, page_size=16)
    want = {i: ref.run(params, [r])[i] for i, r in enumerate(reqs)}
    engines = []

    def make(rep):
        engines.append(PagedBatchedDecodeEngine(cfg, slots=2, max_len=64,
                                                page_size=16))
        return engines[-1]

    router = ReplicaRouter(make, 2)
    router.warmup(params)
    RouterFaultInjector([RouterFault(tick=4, kind="replica_kill", row=0)]
                        ).install(router)
    pk.launches = pk.launches_q8 = 0
    rids = {router.submit(**r): i for i, r in enumerate(reqs)}
    seen = set()
    while router.has_work():
        done = router.step(params)
        assert not set(done) & seen
        seen.update(done)
    router.restart(0, params)
    torch.cuda.synchronize()
    ticks = sum(e.counters["decode_ticks"] for e in engines)
    assert (pk.launches, pk.launches_q8) == (cfg.n_layer * (ticks + 1), 0)
    assert router.counters["failovers"] == 1
    assert set(router.results) == set(rids) == seen
    resumed = 0
    for rid, i in rids.items():
        points = router.failover_points.get(rid, [])
        res = router.pop_result(rid)
        assert res.state == "DONE"
        cut = len(reqs[i]["prompt"]) + (min(points) if points else 10**9)
        resumed += bool(points)
        np.testing.assert_array_equal(res.tokens[:cut],
                                      want[i].tokens[:cut])
    assert resumed >= 1


@pytest.mark.parametrize("q8", [False, True], ids=["K3", "K4"])
def test_paged_kernels_launch_from_a_worker_thread_like_the_main_thread(
        cuda, q8):
    """The server steps the router in a worker thread, whose current
    stream is its own: K3 and K4 launched there are bit-equal to the
    same launch on the main thread, and counted."""
    import concurrent.futures

    args = (_q8_case if q8 else _case)(cuda, 8, 12, 12, 64, torch.bfloat16)
    main = pk.paged_decode_attention(*args)
    before = (pk.launches, pk.launches_q8)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        other = pool.submit(pk.paged_decode_attention, *args).result()
    torch.cuda.synchronize()
    assert torch.equal(main, other)
    after = (pk.launches, pk.launches_q8)
    assert after == ((before[0], before[1] + 1) if q8
                     else (before[0] + 1, before[1]))


@pytest.mark.parametrize("quant", [{}, dict(kv_quant="int8",
                                            weight_quant="int8")],
                         ids=["K3", "K4"])
def test_server_drive_thread_serves_through_the_kernels(cuda, quant):
    """A request through ``ServingServer`` (its drive thread steps the
    router): tokens equal to a direct engine run, and the path's kernel
    launched n_layer x decode ticks from that thread."""
    import http.client
    import json

    from pytorch_distributed_tpu_torch.serving import serve
    from pytorch_distributed_tpu_torch.serving.server import ServingServer

    cfg = _tier_cfg("bfloat16")
    params = gpt2.init(torch.Generator().manual_seed(2), cfg)
    prompt = np.random.default_rng(2).integers(0, 97, 21)
    ref = PagedBatchedDecodeEngine(cfg, slots=2, max_len=64, page_size=16,
                                   **quant)
    want = ref.run(params, [dict(prompt=prompt, max_new_tokens=12)])[0]
    args = serve.parse_args(["--replicas", "2", "--slots", "2",
                             "--max-len", "64", "--device", "cuda"])
    router = serve.make_router(cfg, args, **quant)
    router.warmup(params)
    pk.launches = pk.launches_q8 = 0
    with serve.serve_in_thread(ServingServer(router, params)) as (host,
                                                                   port):
        conn = http.client.HTTPConnection(host, port, timeout=120)
        conn.request("POST", "/v1/generate", json.dumps(
            dict(prompt=prompt.tolist(), max_new_tokens=12)))
        body = json.loads(conn.getresponse().read())
        conn.close()
    torch.cuda.synchronize()
    assert body["state"] == "DONE" and body["tokens"] == want.tokens.tolist()
    ticks = sum(e.counters["decode_ticks"]
                for e in router.engines().values())
    got = (pk.launches, pk.launches_q8)
    assert got == ((0, cfg.n_layer * ticks) if quant
                   else (cfg.n_layer * ticks, 0))


def test_dispatch_failure_after_the_forward_resets_the_pool_on_the_card(
        cuda):
    """drop_result after a decode forward wrote its K/V, with the whole
    pool then overwritten by garbage (the pages a failed dispatch leaves
    are not to be trusted): recovery resets the pool and the prefix
    cache, re-prefills every row, and the tokens equal a fault-free run
    with no quarantine — no page content from before the failure is
    read."""
    from pytorch_distributed_tpu_torch.serving.chaos import (
        Fault,
        FaultInjector,
    )

    class Trash(FaultInjector):
        def after_dispatch(self, kind, tick, tok, bad):
            if kind == "decode_step" and tick == 6:
                for pool in self._engine._cache.values():
                    pool.fill_(1e3 if pool.is_floating_point() else 77)
            return super().after_dispatch(kind, tick, tok, bad)

    for quant in ({}, dict(kv_quant="int8", weight_quant="int8")):
        cfg = _tier_cfg()
        params = gpt2.init(torch.Generator().manual_seed(3), cfg)
        rng = np.random.default_rng(3)
        shared = rng.integers(0, 97, 32)
        reqs = [dict(prompt=np.concatenate([shared, rng.integers(0, 97, k)]),
                     max_new_tokens=10) for k in (3, 5, 7)]
        ref = PagedBatchedDecodeEngine(cfg, slots=2, max_len=64,
                                       page_size=16, **quant)
        want = ref.run(params, reqs)
        eng = PagedBatchedDecodeEngine(cfg, slots=2, max_len=64,
                                       page_size=16, **quant)
        Trash([Fault(tick=6, kind="drop_result",
                     program="decode_step")]).install(eng)
        out = eng.run(params, reqs)
        assert eng.counters["dispatch_failures"] == 1
        assert eng.counters["nan_quarantines"] == 0
        assert eng.pool.pages_in_use() == 0
        for rid, res in want.items():
            assert out[rid].state == "DONE"
            np.testing.assert_array_equal(out[rid].tokens, res.tokens)


# -- generation outside the paged engine ------------------------------------


def test_dense_prefill_values_do_not_depend_on_neighbours_on_the_card(cuda):
    """The dense engine's prefill has one shape per bucket, [slots,
    bucket]: a row's prefilled K/V in bf16 are bit-equal alone and beside
    three other rows (GPT-2 width, 2 layers)."""
    from pytorch_distributed_tpu_torch.serving.engine import (
        BatchedDecodeEngine,
        BucketSpec,
    )

    cfg = _tier_cfg("bfloat16", n_embd=768, n_head=12, vocab=50257)
    params = gpt2.init(torch.Generator().manual_seed(4), cfg)
    rng = np.random.default_rng(4)
    x = rng.integers(0, cfg.vocab_size, 40)
    kv = []
    for others in ((), (50, 20, 60)):
        eng = BatchedDecodeEngine(cfg, slots=4, max_len=128,
                                  buckets=BucketSpec((64,)))
        for n in others:
            eng.submit(rng.integers(0, cfg.vocab_size, n), 4)
        rid = eng.submit(x, 4)
        eng.step(params)
        row = next(i for i, s in enumerate(eng._slots)
                   if s is not None and s.rid == rid)
        kv.append([eng._cache[n][:, row, :40].clone() for n in ("k", "v")])
    for alone, busy in zip(*kv):
        assert torch.equal(alone, busy)


@pytest.mark.parametrize("kind", ["dense", "paged"])
def test_f32_speculative_tokens_equal_plain_on_the_card(cuda, kind):
    """f32 greedy speculative decoding (``speculative_k=4``) emits the
    plain engine's tokens on a repetitive stream, with drafts accepted,
    and a speculating paged engine never launches K3 (its verify forward
    is K+1 queries wide)."""
    from pytorch_distributed_tpu_torch.serving import workload as wl
    from pytorch_distributed_tpu_torch.serving.engine import (
        BatchedDecodeEngine,
    )

    cfg = _tier_cfg("float32", n_embd=768, n_head=12, vocab=50257)
    params = gpt2.init(torch.Generator().manual_seed(5), cfg)
    reqs = wl.repetitive_request_stream(np.random.default_rng(5), n=6,
                                        vocab_size=cfg.vocab_size,
                                        max_new=24)

    def make(k):
        if kind == "dense":
            return BatchedDecodeEngine(cfg, slots=4, max_len=128,
                                       speculative_k=k)
        return PagedBatchedDecodeEngine(cfg, slots=4, max_len=128,
                                        page_size=16, speculative_k=k)

    plain = make(0).run(params, reqs)
    spec = make(4)
    before = pk.launches
    out = spec.run(params, reqs)
    assert pk.launches == before
    assert spec.counters["accepted_tokens"] > 0
    for rid in plain:
        np.testing.assert_array_equal(out[rid].tokens, plain[rid].tokens)


def test_spec_rollback_leaves_shared_pages_bit_unchanged_on_the_card(cuda):
    """Borrowers of a published prefix speculate with drafts that are
    rejected (off by one): the prefix's pages are bit-unchanged after
    their whole run, and their tokens equal those of the same engine
    that never published the prefix first."""
    cfg = _tier_cfg("bfloat16", n_embd=768, n_head=12, vocab=50257)
    params = gpt2.init(torch.Generator().manual_seed(6), cfg)

    def make():
        return PagedBatchedDecodeEngine(
            cfg, slots=4, max_len=128, page_size=16, prefill_chunk=32,
            speculative_k=4,
            draft_hook=lambda h, k: (h[-k:] + 1) % cfg.vocab_size)

    eng = make()
    rng = np.random.default_rng(6)
    prefix = rng.integers(0, cfg.vocab_size, 64).astype(np.int32)
    eng.run(params, [dict(prompt=prefix, max_new_tokens=4)])
    cached = sorted(eng.pool.cached_page_ids())
    assert cached
    before = {n: t[:, cached].clone() for n, t in eng._cache.items()}
    reqs = [dict(prompt=np.concatenate(
        [prefix, rng.integers(0, cfg.vocab_size, 5 + i)]).astype(np.int32),
        max_new_tokens=20) for i in range(3)]
    out = eng.run(params, reqs)
    assert eng.pool.stats["prefix_hits"] >= 3
    assert eng.counters["drafted_tokens"] > eng.counters["accepted_tokens"]
    for n, t in before.items():
        assert torch.equal(eng._cache[n][:, cached], t), n
    ref = make().run(params, reqs)
    for a, b in zip(sorted(out), sorted(ref)):
        np.testing.assert_array_equal(out[a].tokens, ref[b].tokens)
