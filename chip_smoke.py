#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and hold its kernels to their
plain versions.

    python3 chip_smoke.py [--seed N]

Phases (each prints one JSON line; any failure raises and exits nonzero
with no final line):

1. env — the card (``nvidia-smi`` name and power limit), torch and CUDA
   versions; TF32 off for matmuls and convolutions.
2. build — compiles every kernel from ``csrc/`` (one nvcc per source, all
   started together), with seconds and the ptxas register / spill lines.
3. kernel — the paged decode kernel against its plain version at the
   GPT-2 124M, Llama-3.2-1B and a head_dim-128 decode shape (8 rows, 16-
   token pages, max_len 1024), in f32 and bf16 (``TOLERANCES``), with
   kernel, plain and bound times (CUDA events, median of 25 launches, L2
   flushed before each).
4. serve — GPT-2 124M at full width (random weights from ``--seed``)
   through ``PagedBatchedDecodeEngine``: 16 requests (prompts of 32-512
   tokens, two sharing a 256-token prefix, 64 new tokens each, 12 greedy
   and 4 sampled) on 8 slots, max_len 1024, 16-token pages. Once in f32
   through the kernel and once through the gather path (tokens must agree
   on >= 15 of 16 requests), then once in bf16 (the preset's dtype) — the
   main path, whose kernel launches are counted from zero and must equal
   n_layer x decode ticks, and whose kernel inputs at its deepest decode
   tick are replayed against the plain version for the kernels line. The
   bf16 drive then runs twice more for the spread of its host-clock
   metrics (tick ms, tok/s, TTFT).
5. profile — ``torch.profiler`` over 10 decode ticks of the bf16 engine
   (device busy share, kernels by device time, host ops by CPU time).
6. flash — the flash forward (K1) and backward (K2) kernels against their
   plain versions at the GPT-2 124M training shape (B=8, H=12, T=1024,
   D=64, causal), a Llama-3.2-1B shape (B=1, H=32, Hkv=8, T=2048, D=64,
   causal) and a head_dim-128 non-causal shape with a ragged T, in f32
   and bf16 (``FLASH_TOLERANCES``), with kernel, plain, bound and
   ``scaled_dot_product_attention`` (forward; backward) times.
7. train — the training main path: GPT-2 124M at full width, bf16
   activations over f32 params, flash attention, ``names`` remat, bf16
   logits, no dropout, AdamW (lr 3e-4, wd 0.1, cosine), B=8, T=1024, one
   fixed batch from ``--seed``; 3 warmup steps, then 3 timed windows of 10
   steps (tokens/s, ms/step, MFU, loss, grad_norm, peak memory). K1 and K2
   launches are counted from zero over the whole drive and must each
   equal n_layer x steps; the loss must fall. Layer 0's flash inputs at
   the last warmup step are replayed against the plain versions for the
   kernels line.
8. train_profile — ``torch.profiler`` over 2 training steps; then
   train_remat — the same step under remat "none" and "full" (ms/step,
   peak memory, K1 launches n_layer resp. 2 n_layer per step).
9. train_parity — one f32 step at full width (B=2, T=1024) through the
   kernels and the same step with naive attention, from the same weights.
10. The kernels line (K3, K1, K2), then ``{"ok": true, "device": {...}}``
    last.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
F32_OPS_PER_S = 67e12  # H100 SXM f32 outside the tensor cores
# Kernel vs plain version: f32 differs only in summation order. In bf16
# the plain version rounds its softmax weights to bf16 (as the JAX
# reference does) and the kernel keeps them in f32, so the two are held
# to about 3x the largest difference seen at the main path's inputs
# (9.8e-4 on an H100, one bf16 ulp of its largest outputs); and the
# kernel is also held to the plain version run in f32 on the same values
# (bf16 -> f32 is exact), where the only difference left is the kernel's
# one rounding of its output to bf16: at most 2^-8 of the value.
TOLERANCES = {
    torch.float32: dict(atol=1e-5, rtol=0.0),
    torch.bfloat16: dict(atol=3e-3, rtol=1e-2),
}
BF16_VS_F32 = dict(atol=1e-5, rtol=2.0**-8)
BF16_OPS_PER_S = 989e12  # H100 SXM bf16 dense tensor cores
# Flash kernels vs their plain versions. f32 differs in summation order
# only (gradients sum over up to T keys or queries, hence their larger
# atol). In bf16 the plain versions round the softmax weights and dS to
# bf16 before their products, as the TPU kernels do, and the CUDA kernels
# keep them in f32: held loosely to the bf16 plain version, and tightly to
# the plain version in f32 on the same values, where what is left is the
# kernels' one bf16 rounding of each output (at most 2^-9 of the value)
# and f32 summation order. lse is f32 in both dtypes.
FLASH_TOLERANCES = {
    torch.float32: dict(fwd=dict(atol=1e-5, rtol=1e-5),
                        bwd=dict(atol=1e-4, rtol=1e-5)),
    torch.bfloat16: dict(fwd=dict(atol=1e-2, rtol=2e-2),
                         bwd=dict(atol=5e-2, rtol=2e-2)),
}
FLASH_BF16_VS_F32 = dict(fwd=dict(atol=1e-5, rtol=2.0**-8),
                         bwd=dict(atol=1e-4, rtol=2.0**-8))
LSE_TOL = dict(atol=1e-5, rtol=1e-5)


def emit(**fields) -> None:
    print(json.dumps(fields), flush=True)


def time_ms(fn, flush: torch.Tensor, n: int = 25) -> float:
    """Median device time of ``fn`` over ``n`` launches (CUDA events).
    Zeroing ``flush`` before each launch evicts the 50 MB L2, as the
    serving loop finds the pools cold, and keeps the device busy while
    the host enqueues the call, so host overhead stays outside the
    events."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def paged_bound(q, k_pages, tables, lengths) -> tuple[float, str]:
    """Least time for paged decode attention on these inputs: the keys
    0..lengths[b] of each (row, KV head) read once for K and V, q read and
    o written once, the table entries of those keys' pages and the
    lengths read once, over the HBM rate; or its multiply-adds (q.k and
    p.v, f32 on the CUDA cores) over the f32 rate — whichever is
    larger."""
    b, h, d = q.shape
    page, hkv = k_pages.shape[1], k_pages.shape[2]
    n_pages = tables.shape[1]
    lens = np.minimum(lengths.cpu().numpy().astype(np.int64),
                      n_pages * page - 1)
    tokens = int((lens + 1).sum())
    item = q.element_size()
    nbytes = (
        tokens * hkv * d * item * 2 + 2 * q.numel() * item
        + int((lens // page + 1).sum()) * 4 + b * 4
    )
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = 4 * h * d * tokens / F32_OPS_PER_S * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def check_close(got, want, atol, rtol, what) -> float:
    err = (got.float() - want.float()).abs()
    limit = atol + rtol * want.float().abs()
    if not bool(torch.isfinite(got.float()).all()) or bool((err > limit).any()):
        raise AssertionError(
            f"{what}: kernel disagrees with its plain version, max |diff| "
            f"{float(err.max())} (atol {atol}, rtol {rtol})"
        )
    return float(err.max())


def check_kernel(pk, args, what) -> dict:
    """One launch of the kernel on ``args`` against its plain version on
    the same inputs (``TOLERANCES``), and for bf16 also against the plain
    version in f32 on the same values (``BF16_VS_F32``). Returns the
    largest differences and the tolerances used."""
    out = pk.paged_decode_attention(*args)
    torch.cuda.synchronize()
    tol = TOLERANCES[args[0].dtype]
    err = check_close(out, pk.paged_decode_attention_reference(*args),
                      what=what, **tol)
    res = dict(max_abs_err=err, **tol)
    if args[0].dtype == torch.bfloat16:
        q, k, v = (t.float() for t in args[:3])
        exact = pk.paged_decode_attention_reference(q, k, v, *args[3:])
        res["max_abs_err_vs_f32_plain"] = check_close(
            out, exact, what=f"{what} vs f32 plain", **BF16_VS_F32
        )
    return res


def kernel_phase(pk, dev, flush, seed) -> None:
    shapes = [
        ("gpt2-124M", 8, 12, 12, 64),
        ("llama3.2-1B", 8, 32, 8, 64),
        ("head_dim-128", 8, 32, 8, 128),
    ]
    page, n_pages = 16, 64  # max_len 1024
    for name, b, h, hkv, d in shapes:
        for dtype in TOLERANCES:
            g = torch.Generator(device=dev).manual_seed(seed)
            n_pool = b * n_pages + 1
            k = torch.randn(n_pool, page, hkv, d, generator=g,
                            device=dev).to(dtype)
            v = torch.randn(n_pool, page, hkv, d, generator=g,
                            device=dev).to(dtype)
            q = torch.randn(b, h, d, generator=g, device=dev).to(dtype)
            lengths = torch.randint(0, n_pages * page, (b,), generator=g,
                                    device=dev, dtype=torch.int32)
            lengths[:4] = torch.tensor([0, page - 1, page, n_pages * page - 1])
            ids = (torch.randperm(n_pool - 1, generator=g, device=dev) + 1)
            ids = ids[: b * n_pages].reshape(b, n_pages)
            used = (torch.arange(n_pages, device=dev)[None] * page
                    <= lengths[:, None])
            tables = torch.where(used, ids, 0).to(torch.int32).contiguous()
            args = (q, k, v, tables, lengths)
            checked = check_kernel(pk, args, f"{name} {dtype}")
            bound_ms, bound_by = paged_bound(q, k, tables, lengths)
            emit(
                phase="kernel", kernel="paged_decode_attention", shape=name,
                B=b, H=h, Hkv=hkv, D=d, page=page, max_len=n_pages * page,
                dtype=str(dtype).replace("torch.", ""),
                lengths=lengths.tolist(), **checked,
                kernel_ms=time_ms(lambda: pk.paged_decode_attention(*args),
                                  flush),
                plain_ms=time_ms(
                    lambda: pk.paged_decode_attention_reference(*args), flush
                ),
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
            )


def requests(cfg, seed) -> list[dict]:
    """16 requests: prompts of 32-512 tokens, 64 new tokens each, every
    fourth one sampled. Requests 0 and 8 share a 256-token prefix; 8
    admits only after a first row retires, when 0's prefix is cached."""
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, cfg.vocab_size, 256)
    lens = rng.integers(32, 513, 16)
    out = []
    for i in range(16):
        if i in (0, 8):
            prompt = np.concatenate(
                [shared, rng.integers(0, cfg.vocab_size, 40 + 3 * i)]
            )
        else:
            prompt = rng.integers(0, cfg.vocab_size, int(lens[i]))
        req = dict(prompt=prompt.astype(np.int32), max_new_tokens=64)
        if i % 4 == 3:
            req.update(temperature=0.8, top_k=50, top_p=0.95,
                       seed=seed * 1000 + i)
        out.append(req)
    return out


def serve(cfg, params, reqs, paged_attention, pk, record=None) -> dict:
    from pytorch_distributed_tpu_torch.serving import PagedBatchedDecodeEngine

    eng = PagedBatchedDecodeEngine(cfg, slots=8, max_len=1024, page_size=16,
                                   paged_attention=paged_attention)
    eng.warmup(params)
    rids = [eng.submit(**r) for r in reqs]
    prompt_len = {rid: len(r["prompt"]) for rid, r in zip(rids, reqs)}
    ttft: dict[int, float] = {}
    decode_ms = []
    original = pk.paged_decode_attention
    if record is not None:
        pk.paged_decode_attention = record
    pk.launches = 0  # counts from zero for exactly this drive
    t0 = time.perf_counter()
    try:
        while eng.has_work():
            c0 = dict(eng.counters)
            s = time.perf_counter()
            eng.step(params)
            e = time.perf_counter()
            if (eng.counters["decode_ticks"] > c0["decode_ticks"]
                    and eng.counters["prefill_ticks"] == c0["prefill_ticks"]):
                decode_ms.append((e - s) * 1e3)
            for rid in rids:
                if rid not in ttft:
                    toks = eng.peek_tokens(rid)
                    if toks is not None and len(toks) > prompt_len[rid]:
                        ttft[rid] = (e - t0) * 1e3
    finally:
        pk.paged_decode_attention = original
    wall = time.perf_counter() - t0
    launches = pk.launches
    results = {rid: eng.pop_result(rid) for rid in rids}
    bad = {rid: r.state for rid, r in results.items() if r.state != "DONE"}
    if bad:
        raise AssertionError(f"requests not DONE: {bad}")
    generated = sum(len(r.tokens) - prompt_len[rid]
                    for rid, r in results.items())
    if generated != 64 * len(rids):
        raise AssertionError(f"generated {generated} tokens, want {64 * 16}")
    ticks = eng.counters["decode_ticks"]
    if paged_attention == "kernel" and launches != cfg.n_layer * ticks:
        raise AssertionError(
            f"kernel launches {launches} != n_layer {cfg.n_layer} x decode "
            f"ticks {ticks}: the decode path did not go through the kernel"
        )
    if paged_attention == "gather" and launches:
        raise AssertionError(f"the gather path launched the kernel {launches}x")
    return dict(
        tokens={rid: r.tokens for rid, r in results.items()},
        launches=launches,
        metrics=dict(
            dtype=cfg.dtype, paged_attention=paged_attention,
            requests=len(rids), generated_tokens=generated,
            decode_ticks=ticks, prefill_ticks=eng.counters["prefill_ticks"],
            kernel_launches=launches,
            mean_decode_tick_ms=statistics.fmean(decode_ms),
            pure_decode_ticks=len(decode_ms),
            generated_tok_per_s=generated / wall, wall_s=wall,
            ttft_p50_ms=statistics.median(ttft.values()),
            prefix_hits=eng.pool.stats["prefix_hits"],
            prefix_hit_tokens=eng.pool.stats["prefix_hit_tokens"],
            preemptions=eng.counters["preemptions"],
            pool_bytes=eng.cache_hbm_bytes()["allocated"],
            pool_peak_in_use_bytes=eng.cache_hbm_bytes()["peak_in_use"],
        ),
        engine=eng,
    )


def profile_summary(prof, wall_ms: float) -> dict:
    """Device busy share of the window, the kernels by device time and the
    host ops by self CPU time, from a finished ``torch.profiler`` run."""
    from torch.autograd import DeviceType

    events = prof.key_averages()

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))

    # Device-side events only (kernels, copies): an operator's row repeats
    # the device time of the kernels it launched.
    kernels = sorted(
        (e for e in events
         if e.device_type == DeviceType.CUDA and dev_us(e) > 0),
        key=dev_us, reverse=True,
    )
    device_ms = sum(dev_us(e) for e in kernels) / 1e3
    host = sorted(events, key=lambda e: e.self_cpu_time_total, reverse=True)
    return dict(
        wall_ms=wall_ms, device_busy_ms=device_ms,
        device_idle_share=(1 - device_ms / wall_ms) if device_ms else None,
        kernels=[dict(name=e.key[:80], calls=e.count,
                      device_ms=dev_us(e) / 1e3) for e in kernels[:12]],
        host_ops=[dict(name=e.key[:60], calls=e.count,
                       self_cpu_ms=e.self_cpu_time_total / 1e3)
                  for e in host[:12]],
    )


def profile_phase(cfg, params, reqs, n_ticks: int = 10) -> None:
    """``torch.profiler`` over ``n_ticks`` pure decode ticks of the bf16
    engine with all 8 slots decoding."""
    from torch.profiler import ProfilerActivity, profile

    from pytorch_distributed_tpu_torch.serving import PagedBatchedDecodeEngine

    eng = PagedBatchedDecodeEngine(cfg, slots=8, max_len=1024, page_size=16)
    eng.warmup(params)
    for r in reqs[:8]:
        eng.submit(**r)
    while True:  # until every row has finished its prefill
        before = eng.counters["prefill_ticks"]
        eng.step(params)
        if eng.counters["prefill_ticks"] == before:
            break
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_ticks):
            eng.step(params)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    emit(phase="profile", decode_ticks=n_ticks,
         **profile_summary(prof, wall_ms))


FLASH_SOURCE = "pytorch_distributed_tpu_torch/csrc/flash_attention.cu"


def flash_bound(q, k, causal: bool, backward: bool) -> tuple[float, str]:
    """Least time for flash attention on these inputs: each input read and
    each output written once over the HBM rate (forward: q, k, v in, o and
    lse out; backward: q, k, v, do, lse and delta in, dq, dk, dv out), or
    its products over the peak rate for the input type (forward: QK^T and
    PV; backward: the five products of the fused backward), counted over
    the (query, key) pairs the mask keeps — whichever is larger."""
    b, h, t, d = q.shape
    hkv = k.shape[1]
    item = q.element_size()
    pairs = t * (t + 1) // 2 if causal else t * t
    rows = b * h * t
    if backward:
        nbytes = (3 * b * h + 4 * b * hkv) * t * d * item + 2 * rows * 4
        ops = 10 * b * h * d * pairs
    else:
        nbytes = (2 * b * h + 2 * b * hkv) * t * d * item + rows * 4
        ops = 4 * b * h * d * pairs
    rate = BF16_OPS_PER_S if q.dtype == torch.bfloat16 else F32_OPS_PER_S
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / rate * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def check_flash(fk, q, k, v, do, causal, what) -> dict:
    """K1 and K2 once each on the inputs against their plain versions
    (``FLASH_TOLERANCES``; bf16 also against the plain versions in f32 on
    the same values). Returns the largest differences per kernel."""
    tol = FLASH_TOLERANCES[q.dtype]
    o, lse = fk.flash_forward(q, k, v, causal)
    grads = fk.flash_backward(q, k, v, o, lse, do, causal)
    torch.cuda.synchronize()
    o_ref, lse_ref = fk.flash_forward_reference(q, k, v, causal)
    k1 = dict(max_abs_err=check_close(o, o_ref, what=f"{what} K1 o",
                                      **tol["fwd"]),
              lse_max_abs_err=check_close(lse, lse_ref, what=f"{what} K1 lse",
                                          **LSE_TOL),
              **tol["fwd"])
    refs = fk.flash_backward_reference(q, k, v, o, lse, do, causal)
    k2 = dict(max_abs_err=max(
        check_close(g, r, what=f"{what} K2 {n}", **tol["bwd"])
        for n, g, r in zip(("dq", "dk", "dv"), grads, refs)
    ), **tol["bwd"])
    del o_ref, refs
    if q.dtype == torch.bfloat16:
        f = [x.float() for x in (q, k, v)]
        o32, _ = fk.flash_forward_reference(*f, causal)
        k1["max_abs_err_vs_f32_plain"] = check_close(
            o, o32, what=f"{what} K1 vs f32 plain", **FLASH_BF16_VS_F32["fwd"]
        )
        refs32 = fk.flash_backward_reference(*f, o.float(), lse, do.float(),
                                             causal)
        k2["max_abs_err_vs_f32_plain"] = max(
            check_close(g, r, what=f"{what} K2 {n} vs f32 plain",
                        **FLASH_BF16_VS_F32["bwd"])
            for n, g, r in zip(("dq", "dk", "dv"), grads, refs32)
        )
    return dict(K1=k1, K2=k2)


def time_flash(fk, q, k, v, do, causal, flush) -> dict:
    """Kernel, plain-version and library times of K1 and K2 on the inputs
    (ms, CUDA events, L2 flushed before each launch). The library call is
    ``scaled_dot_product_attention`` (forward; its backward through
    autograd): a yardstick the port never calls."""
    import torch.nn.functional as F

    o, lse = fk.flash_forward(q, k, v, causal)
    gqa = q.shape[1] != k.shape[1]
    lq, lk, lv = (x.detach().requires_grad_() for x in (q, k, v))
    lib_o = F.scaled_dot_product_attention(lq, lk, lv, is_causal=causal,
                                           enable_gqa=gqa)
    out = dict(
        K1=dict(
            ms=time_ms(lambda: fk.flash_forward(q, k, v, causal), flush),
            plain_ms=time_ms(
                lambda: fk.flash_forward_reference(q, k, v, causal), flush,
                n=5),
            library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=causal, enable_gqa=gqa), flush),
        ),
        K2=dict(
            ms=time_ms(lambda: fk.flash_backward(q, k, v, o, lse, do, causal),
                       flush),
            plain_ms=time_ms(lambda: fk.flash_backward_reference(
                q, k, v, o, lse, do, causal), flush, n=5),
            library_ms=time_ms(lambda: torch.autograd.grad(
                lib_o, (lq, lk, lv), do, retain_graph=True), flush),
        ),
    )
    for name, backward in (("K1", False), ("K2", True)):
        out[name]["bound_ms"], out[name]["bound_by"] = flash_bound(
            q, k, causal, backward
        )
    return out


def flash_phase(fk, dev, flush, seed) -> None:
    shapes = [
        ("gpt2-124M", 8, 12, 12, 1024, 64, True),
        ("llama3.2-1B", 1, 32, 8, 2048, 64, True),
        ("head_dim-128 ragged non-causal", 2, 16, 4, 1000, 128, False),
    ]
    for name, b, h, hkv, t, d, causal in shapes:
        for dtype in FLASH_TOLERANCES:
            g = torch.Generator(device=dev).manual_seed(seed)
            q, k, v, do = (
                torch.randn(b, n, t, d, generator=g, device=dev).to(dtype)
                for n in (h, hkv, hkv, h)
            )
            checked = check_flash(fk, q, k, v, do, causal, f"{name} {dtype}")
            timed = time_flash(fk, q, k, v, do, causal, flush)
            emit(phase="flash", shape=name, B=b, H=h, Hkv=hkv, T=t, D=d,
                 causal=causal, dtype=str(dtype).replace("torch.", ""),
                 **{kn: {**checked[kn], **timed[kn]} for kn in ("K1", "K2")})


def train_setup(cfg, tcfg, b, t, seed, dev):
    """Params from ``--seed`` (``gpt2.init``), the optimizer, the train
    state and step, and one fixed batch of random token ids."""
    from pytorch_distributed_tpu_torch.models import get_model, gpt2
    from pytorch_distributed_tpu_torch.train.optim import make_optimizer
    from pytorch_distributed_tpu_torch.train.state import init_train_state
    from pytorch_distributed_tpu_torch.train.trainer import make_train_step

    params = gpt2.init(torch.Generator().manual_seed(seed), cfg)
    tx = make_optimizer(tcfg)
    g = torch.Generator(device=dev).manual_seed(seed)
    batch = {key: torch.randint(0, cfg.vocab_size, (1, b, t), generator=g,
                                device=dev)
             for key in ("inputs", "targets")}
    return (init_train_state(params, tx),
            make_train_step(get_model(cfg), cfg, tx), batch)


def train_phase(fk, cfg, seed, dev, warmup=3, windows=3, window_steps=10):
    """The main path (see the module docstring). Returns the step, its
    state and batch, the launches, and layer 0's flash inputs at the last
    warmup step."""
    from pytorch_distributed_tpu_torch.config import TrainConfig
    from pytorch_distributed_tpu_torch.utils import tree

    b, t = 8, 1024
    n_steps = warmup + windows * window_steps
    tcfg = TrainConfig(global_batch_size=b, micro_batch_size=b,
                       num_steps=n_steps, learning_rate=3e-4)
    state, step, batch = train_setup(cfg, tcfg, b, t, seed, dev)
    n_params = sum(p.numel() for p in tree.leaves(state.params))
    flops_per_token = 6 * n_params + 12 * cfg.n_layer * cfg.n_embd * t
    captured = {}
    original = fk.flash_backward

    def record(*args):
        # Layer 0's backward is the last of a step: keep the last warmup
        # step's (q, k, v, o, lse, do, ...) as device copies.
        record.calls += 1
        if record.calls == cfg.n_layer * warmup:
            captured["args"] = [a.clone() if torch.is_tensor(a) else a
                                for a in args]
        return original(*args)

    record.calls = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fk.launches.update(forward=0, backward=0)  # counts from zero for this drive
    fk.flash_backward = record
    try:
        losses = []
        for _ in range(warmup):
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
    finally:
        fk.flash_backward = original
    alloc_keys = ("num_alloc_retries", "num_device_alloc", "num_device_free",
                  "num_sync_all_streams")
    alloc0 = torch.cuda.memory_stats()
    rows = []
    for _ in range(windows):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(window_steps):
            state, m = step(state, batch)
        loss, grad_norm = float(m["loss"]), float(m["grad_norm"])
        elapsed = time.perf_counter() - t0
        tok_s = window_steps * b * t / elapsed
        rows.append(dict(tokens_per_s=tok_s,
                         ms_per_step=elapsed / window_steps * 1e3,
                         mfu=tok_s * flops_per_token / BF16_OPS_PER_S,
                         loss=loss, grad_norm=grad_norm))
    launches = dict(fk.launches)
    peak = torch.cuda.max_memory_allocated()
    alloc1 = torch.cuda.memory_stats()
    allocator = {key: alloc1.get(key, 0) - alloc0.get(key, 0)
                 for key in alloc_keys}
    want = cfg.n_layer * n_steps
    emit(phase="train", B=b, T=t, steps=n_steps, n_params=n_params,
         flops_per_token=flops_per_token, warmup_losses=losses,
         windows=rows, launches=launches, want_launches=want,
         max_memory_allocated=peak, allocator_during_windows=allocator)
    if not launches["forward"] or not launches["backward"]:
        raise AssertionError(f"the training main path launched no flash "
                             f"kernel: {launches}")
    if launches != {"forward": want, "backward": want}:
        raise AssertionError(
            f"flash launches {launches} != n_layer x steps = {want}: the "
            f"training path did not go through the kernels"
        )
    final = rows[-1]["loss"]
    if not all(np.isfinite([*losses, *(r["loss"] for r in rows)])) or \
            not final < losses[0]:
        raise AssertionError(
            f"the loss did not fall on the fixed batch: {losses[0]} -> {final}"
        )
    return dict(step=step, state=state, batch=batch, launches=launches,
                captured=captured["args"])


def train_remat_phase(fk, cfg, seed, dev, warmup=2, steps=10) -> None:
    """The main path's step under remat "none" and "full" beside "names"
    (train phase): ms/step, peak memory, and the flash launches of the
    timed steps — K1 n_layer x steps under none and 2 n_layer x steps
    under full (the block re-runs in backward), K2 n_layer x steps."""
    from pytorch_distributed_tpu_torch.config import TrainConfig

    for mode in ("none", "full"):
        c = cfg.replace(remat=mode)
        tcfg = TrainConfig(global_batch_size=8, micro_batch_size=8,
                           num_steps=warmup + steps, learning_rate=3e-4)
        state, step, batch = train_setup(c, tcfg, 8, 1024, seed, dev)
        for _ in range(warmup):
            state, m = step(state, batch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fk.launches.update(forward=0, backward=0)
        t0 = time.perf_counter()
        for _ in range(steps):
            state, m = step(state, batch)
        loss = float(m["loss"])
        elapsed = time.perf_counter() - t0
        launches = dict(fk.launches)
        want = {"forward": cfg.n_layer * steps * (2 if mode == "full" else 1),
                "backward": cfg.n_layer * steps}
        emit(phase="train_remat", remat=mode, steps=steps,
             ms_per_step=elapsed / steps * 1e3,
             tokens_per_s=steps * 8 * 1024 / elapsed, loss=loss,
             launches=launches, want_launches=want,
             max_memory_allocated=torch.cuda.max_memory_allocated())
        if launches != want:
            raise AssertionError(
                f"remat {mode}: flash launches {launches} != {want}"
            )
        del state, step, batch


def train_parity_phase(cfg, seed, dev) -> None:
    """One f32 step at full width (B=2, T=1024) with the flash kernels and
    with naive attention, from the same weights and batch. Loss within rtol
    1e-5 and grad_norm within rtol 1e-4 (summation order). Adam's first
    update is lr * g / (|g| + eps) per element, about lr * sign(g): where a
    gradient is ~0 the two runs can take opposite signs and differ by up to
    2 lr. So params are held to 2 lr + 1e-6 everywhere, and to 1e-6 on all
    but 1e-4 of the elements."""
    from pytorch_distributed_tpu_torch.config import TrainConfig
    from pytorch_distributed_tpu_torch.utils import tree

    tcfg = TrainConfig(learning_rate=3e-4)
    out = {}
    for impl in ("flash", "naive"):
        c = cfg.replace(dtype="float32", logits_dtype="float32",
                        attention_impl=impl)
        state, step, batch = train_setup(c, tcfg, 2, 1024, seed, dev)
        state, m = step(state, batch)
        out[impl] = (float(m["loss"]), float(m["grad_norm"]),
                     tree.leaves(state.params))
        del state, step
    (lf, gf, pf), (ln, gn, pn) = out["flash"], out["naive"]
    diffs = torch.cat([(a - b).abs().flatten() for a, b in zip(pf, pn)])
    lr = tcfg.learning_rate
    res = dict(loss=[lf, ln], grad_norm=[gf, gn],
               params_max_abs_diff=float(diffs.max()),
               params_share_above_1e_6=float((diffs > 1e-6).float().mean()),
               n_params=diffs.numel())
    emit(phase="train_parity", **res)
    if not (abs(lf - ln) <= 1e-5 * abs(ln) and abs(gf - gn) <= 1e-4 * gn
            and res["params_max_abs_diff"] <= 2 * lr + 1e-6
            and res["params_share_above_1e_6"] <= 1e-4):
        raise AssertionError(f"flash and naive f32 steps disagree: {res}")


def train_profile_phase(run, n_steps: int = 2) -> None:
    from torch.profiler import ProfilerActivity, profile

    step, state, batch = run["step"], run["state"], run["batch"]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            state, _ = step(state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # One more step with CUDA's sync debug mode on: the host syncs that
    # the step makes (each stalls the host until the device drains).
    import warnings

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            state, _ = step(state, batch)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    syncs = [str(w.message).splitlines()[0][:120] for w in caught
             if "prototype feature" not in str(w.message)]
    emit(phase="train_profile", steps=n_steps,
         host_syncs_per_step=len(syncs), host_sync_kinds=sorted(set(syncs)),
         **profile_summary(prof, wall_ms))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device — this script measures the port "
              "on an NVIDIA GPU", file=sys.stderr)
        return 1
    from pytorch_distributed_tpu_torch.config import model_config
    from pytorch_distributed_tpu_torch.models import gpt2
    from pytorch_distributed_tpu_torch.ops import _build
    from pytorch_distributed_tpu_torch.ops import flash_kernel as fk
    from pytorch_distributed_tpu_torch.ops import paged_kernel as pk

    # 1. env
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    dev = torch.device("cuda")
    emit(phase="env", nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
         device_count=torch.cuda.device_count())

    # 2. build: one nvcc per source, all started together
    sources = ("paged_attention", "flash_attention")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(sources)) as pool:
        builds = dict(zip(sources, pool.map(_build.build, sources)))
    emit(phase="build", wall_s=time.perf_counter() - t0, kernels={
        name: dict(seconds=built["seconds"], cached=built["cached"],
                   ptxas=[ln.strip() for ln in built["log"].splitlines()
                          if "registers" in ln or "spill" in ln])
        for name, built in builds.items()
    })

    # 3. kernel at the listed shapes
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    kernel_phase(pk, dev, flush, args.seed)

    # 4. serving at full width
    cfg = model_config("gpt2")  # 124M, bf16 activations, f32 params
    params = gpt2.init(torch.Generator().manual_seed(args.seed), cfg)
    reqs = requests(cfg, args.seed)
    f32 = cfg.replace(dtype="float32")
    runs = {impl: serve(f32, params, reqs, impl, pk)
            for impl in ("kernel", "gather")}
    same = sum(
        np.array_equal(runs["kernel"]["tokens"][r], runs["gather"]["tokens"][r])
        for r in runs["kernel"]["tokens"]
    )
    emit(phase="serve_f32", identical_requests=same, of=len(reqs),
         kernel=runs["kernel"]["metrics"], gather=runs["gather"]["metrics"])
    if same < 15:
        raise AssertionError(
            f"f32 kernel and gather paths agree on only {same}/16 requests"
        )
    del runs

    captured: list = []

    def record(q, k_pages, v_pages, block_tables, lengths):
        # Keep every decode tick's layer-0 inputs (q, tables, lengths) as
        # device copies, which need no sync; the pools are read back after
        # the run.
        if record.calls % cfg.n_layer == 0:
            captured.append((q.clone(), block_tables.clone(),
                             lengths.clone()))
        record.calls += 1
        return original(q, k_pages, v_pages, block_tables, lengths)

    original = pk.paged_decode_attention
    record.calls = 0
    run = serve(cfg, params, reqs, "kernel", pk, record=record)
    emit(phase="serve", **run["metrics"])
    launches = run["launches"]
    if launches == 0:
        raise AssertionError("the main path launched no paged decode kernel")
    # The same drive twice more (kernel counts no longer read): the spread
    # of the host-clock metrics within one call on one card.
    spread = [run["metrics"]] + [
        serve(cfg, params, reqs, "kernel", pk)["metrics"] for _ in range(2)
    ]
    emit(phase="serve_spread", runs=len(spread), **{
        key: [m[key] for m in spread]
        for key in ("mean_decode_tick_ms", "generated_tok_per_s",
                    "ttft_p50_ms", "wall_s")
    })

    # 5. the kernels line: the deepest decode tick's inputs replayed
    cache = run["engine"]._cache
    q, tables, lengths = max(captured, key=lambda c: int(c[2].sum()))
    kargs = (q, cache["k"][0], cache["v"][0], tables, lengths)
    checked = check_kernel(pk, kargs, "main-path inputs bf16")
    bound_ms, bound_by = paged_bound(q, kargs[1], tables, lengths)
    kernel_ms = time_ms(lambda: pk.paged_decode_attention(*kargs), flush)
    plain_ms = time_ms(
        lambda: pk.paged_decode_attention_reference(*kargs), flush
    )
    del run, cache, captured
    profile_phase(cfg, params, reqs)
    del params
    paged_entry = dict(
        name="paged_decode_attention", route="cuda",
        source="pytorch_distributed_tpu_torch/csrc/paged_attention.cu",
        replaces="pytorch_distributed_tpu/ops/paged_kernel.py:56",
        launches=launches, **checked, ms=kernel_ms,
        plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
        library_ms=None,
        inputs=dict(B=q.shape[0], H=q.shape[1], D=q.shape[2],
                    dtype=cfg.dtype, lengths=lengths.tolist()),
    )

    # 6. flash kernels at the listed shapes
    flash_phase(fk, dev, flush, args.seed)

    # 7. training: the main path
    tcfg_model = cfg.replace(attention_impl="flash", remat="names",
                             logits_dtype="bfloat16", attn_pdrop=0.0,
                             resid_pdrop=0.0, embd_pdrop=0.0)
    run = train_phase(fk, tcfg_model, args.seed, dev)
    train_launches = run["launches"]
    fq, fkk, fv, fo, flse, fdo, causal = run["captured"][:7]
    checked = check_flash(fk, fq, fkk, fv, fdo, causal,
                          "main-path inputs bf16")
    timed = time_flash(fk, fq, fkk, fv, fdo, causal, flush)

    # 8. profile of the training step, then the step under the other
    # remat modes
    train_profile_phase(run)
    del run, fo, flse
    train_remat_phase(fk, tcfg_model, args.seed, dev)

    # 9. train parity on the card (f32, flash kernels vs naive attention)
    train_parity_phase(tcfg_model, args.seed, dev)

    inputs = dict(B=fq.shape[0], H=fq.shape[1], Hkv=fkk.shape[1],
                  T=fq.shape[2], D=fq.shape[3], causal=causal,
                  dtype=str(fq.dtype).replace("torch.", ""))
    flash_entries = [
        dict(name=name, route="cuda", source=FLASH_SOURCE,
             replaces=f"pytorch_distributed_tpu/ops/flash_kernel.py:{line}",
             launches=train_launches[direction], **checked[kn], **timed[kn],
             inputs=inputs)
        for name, kn, direction, line in (
            ("flash_forward", "K1", "forward", 92),
            ("flash_backward", "K2", "backward", 221),
        )
    ]
    emit(kernels=[paged_entry, *flash_entries])
    emit(ok=True, device=dict(platform="gpu",
                              kind=torch.cuda.get_device_name(0),
                              count=torch.cuda.device_count()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
