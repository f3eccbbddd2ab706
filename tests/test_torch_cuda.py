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


# -- flash attention: K1 (forward) and K2 (backward) --------------------------

FLASH_TOL = {
    # f32: summation order only. bf16: the plain version rounds the softmax
    # weights and dS to bf16 (as the TPU kernels do) and the kernels keep
    # them in f32; against the plain version in f32 on the same values the
    # kernels may differ by their one bf16 rounding of each output.
    torch.float32: dict(atol=1e-5, rtol=1e-5),
    torch.bfloat16: dict(atol=2e-2, rtol=2e-2),
}


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
    fk, q, k, v, do = _flash_case(cuda, b, h, hkv, t, d, dtype)
    before = dict(fk.launches)
    o, lse = fk.flash_forward(q, k, v, causal)
    grads = fk.flash_backward(q, k, v, o, lse, do, causal)
    torch.cuda.synchronize()
    assert fk.launches == {"forward": before["forward"] + 1,
                           "backward": before["backward"] + 1}
    o_ref, lse_ref = fk.flash_forward_reference(q, k, v, causal)
    tol = FLASH_TOL[dtype]
    torch.testing.assert_close(o.float(), o_ref.float(), **tol)
    torch.testing.assert_close(lse, lse_ref, atol=1e-5, rtol=1e-5)
    refs = fk.flash_backward_reference(q, k, v, o, lse, do, causal)
    for name, a, r in zip(("dq", "dk", "dv"), grads, refs):
        assert a.dtype == dtype and a.shape == r.shape, name
        torch.testing.assert_close(a.float(), r.float(), msg=name,
                                   atol=tol["atol"] * 10, rtol=tol["rtol"])
    if dtype == torch.bfloat16:
        f = [x.float() for x in (q, k, v, o, lse, do)]
        exact = fk.flash_backward_reference(*f, causal)
        for name, a, r in zip(("dq", "dk", "dv"), grads, exact):
            torch.testing.assert_close(a.float(), r, msg=name, atol=1e-4,
                                       rtol=2.0**-8)


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
