"""The paged decode window (``decode.forward(decode_window=True)``): a
speculative verify forward whose K+1 queries run as single-token rows of
the paged decode kernel (on CPU tensors its plain version), on the CPU.

Each lane's logits must equal the same tokens fed one decode step at a
time and the multi-query gather path (the JAX package's verify
attention), to 1e-5; with ``lane0_alone`` lane 0 must equal the [B, 1]
step bit for bit and the other lanes must keep the window's values. On
the card the bit-equality is what makes a sampled row's token the plain
tick's (``tests/test_torch_cuda.py`` holds it there at the serving
bench's width)."""

import numpy as np
import pytest
import torch

from pytorch_distributed_tpu_torch.config import ModelConfig
from pytorch_distributed_tpu_torch.models import decode, get_model

B, PAGE, N_PAGES, T = 3, 8, 6, 5
FAMILIES = [("gpt2", "none"), ("gpt2", "int8"), ("llama", "none")]


def _setup(family, kv_quant):
    kw = dict(vocab_size=128, n_ctx=128, n_embd=64, n_layer=2, n_head=4,
              dtype="float32", embd_pdrop=0.0, attn_pdrop=0.0,
              resid_pdrop=0.0)
    if family == "llama":
        kw.update(family="llama", n_kv_head=2)
    cfg = ModelConfig(**kw)
    params = get_model(cfg).init(torch.Generator().manual_seed(0), cfg,
                                 device="cpu")
    rng = np.random.default_rng(0)
    tables = torch.from_numpy(
        (1 + np.arange(B * N_PAGES)).reshape(B, N_PAGES).astype(np.int32))
    # Row 2's last lanes run past its table: they write the scratch page.
    tables[2, 3:] = 0
    pos = torch.tensor([3, 17, 20], dtype=torch.int32)
    ids = torch.from_numpy(rng.integers(0, 128, (B, T)).astype(np.int32))
    return cfg, params, tables, pos, ids


def _cache(cfg, kv_quant):
    cache = decode.init_paged_cache(cfg, B * N_PAGES + 1, PAGE,
                                    kv_quant=kv_quant, device="cpu")
    g = torch.Generator().manual_seed(1)
    for name, c in cache.items():
        if c.dtype.is_floating_point:
            c.normal_(generator=g)
        else:
            c.random_(-127, 127, generator=g)
    return cache


@pytest.mark.parametrize("family, kv_quant", FAMILIES)
def test_window_lanes_equal_single_steps_and_gather(family, kv_quant):
    cfg, params, tables, pos, ids = _setup(family, kv_quant)
    kw = dict(block_tables=tables, kv_quant=kv_quant)
    win, _ = decode.forward(params, ids, cfg, _cache(cfg, kv_quant), pos,
                            paged_impl="kernel", decode_window=True, **kw)
    gather, _ = decode.forward(params, ids, cfg, _cache(cfg, kv_quant),
                               pos, paged_impl="gather", **kw)
    cache = _cache(cfg, kv_quant)
    steps = torch.cat([
        decode.forward(params, ids[:, i:i + 1], cfg, cache, pos + i,
                       paged_impl="kernel", **kw)[0]
        for i in range(T)], dim=1)
    # Row 2's lanes past its table read keys the steps wrote to scratch.
    live = [(0, slice(None)), (1, slice(None)), (2, slice(0, 4))]
    for row, lanes in live:
        np.testing.assert_allclose(win[row, lanes], steps[row, lanes],
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(win[row, lanes], gather[row, lanes],
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("family, kv_quant", FAMILIES)
def test_lane0_alone_is_the_single_step_bit_for_bit(family, kv_quant):
    cfg, params, tables, pos, ids = _setup(family, kv_quant)
    kw = dict(block_tables=tables, kv_quant=kv_quant, paged_impl="kernel")
    step, step_cache = decode.forward(params, ids[:, :1], cfg,
                                      _cache(cfg, kv_quant), pos, **kw)
    win, _ = decode.forward(params, ids, cfg, _cache(cfg, kv_quant), pos,
                            decode_window=True, **kw)
    alone, alone_cache = decode.forward(
        params, ids, cfg, _cache(cfg, kv_quant), pos, decode_window=True,
        lane0_alone=True, **kw)
    assert torch.equal(alone[:, :1], step)
    assert torch.equal(alone[:, 1:], win[:, 1:])
    # Lane 0's K/V, at each row's own position, are the step's.
    for b in range(B):
        page, off = tables[b, pos[b] // PAGE], pos[b] % PAGE
        for name in ("k", "v"):
            assert torch.equal(alone_cache[name][:, page, off],
                               step_cache[name][:, page, off])
