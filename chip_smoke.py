#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and hold its kernels to their
plain versions.

    python3 chip_smoke.py [--seed N]

Phases (each prints one JSON line; any failure raises and exits nonzero
with no final line):

1. env — the card (``nvidia-smi`` name and power limit), torch and CUDA
   versions; TF32 off for matmuls and convolutions.
2. build — compiles every kernel from ``csrc/`` (one nvcc per source, all
   started together), with seconds and each kernel's registers and spilled
   bytes from ptxas; a bf16 flash kernel at head_dim 64 must not spill,
   nor may any of the 32 paged kernel instantiations.
3. kernel — the paged decode kernels K3 (pages in q's dtype) and K4
   (int8 pages made by the port's ``quantize_kv``, with their f32 scale
   pools) against their plain versions at the GPT-2 124M, Llama-3.2-1B
   and a head_dim-128 decode shape (8 rows, 16-token pages, max_len
   1024), q in f32 and bf16 (``TOLERANCES``, ``Q8_TOLERANCES``), with
   the split plan (``chunk_tokens``, ``n_splits``, live CTAs), kernel,
   plain and bound times (CUDA events, median of 25 launches, L2 flushed
   and the device held busy for 2 ms before each: ``time_ms``), after
   the time ``time_ms`` reads for an empty launch (launch_floor); then
   streams — K3 and K4 launched at once on two CUDA streams, each with
   inputs of its own, 25 times: bit-equal to serial launches, every
   workspace counter back at 0 (each stream has its own workspace).
4. serve — GPT-2 124M at full width (random weights from ``--seed``)
   through ``PagedBatchedDecodeEngine``: 16 requests (prompts of 32-512
   tokens, two sharing a 256-token prefix, 64 new tokens each, 12 greedy
   and 4 sampled) on 8 slots, max_len 1024, 16-token pages. Once in f32
   through the kernel and once through the gather path (tokens must agree
   on >= 15 of 16 requests: serve_f32), then once in bf16 (the preset's
   dtype) — the main path of K3, whose launches are counted from zero and
   must equal n_layer x decode ticks (K4's 0), and whose kernel inputs at
   its deepest decode tick are replayed against the plain version for the
   kernels line (with their split plan). The bf16 drive then runs twice
   more for the spread of its host-clock metrics (tick ms, tok/s, TTFT:
   serve_spread); profile —
   ``torch.profiler`` over 10 decode ticks of the bf16 engine (device busy
   share, kernels by device time, host ops by CPU time).
5. int8 serving — the same requests with ``kv_quant="int8",
   weight_quant="int8"``: in f32 through K4 and through the int8 gather
   path (>= 15/16 identical: serve_q8_f32); then in bf16 — the main path
   of K4 (serve_q8, with serve_q8_spread and its kernels-line replay,
   scale pools included): K4 launches == n_layer x decode ticks, K3 0;
   the int8 pool exactly 68/128 of the bf16 pool (serve_q8_pool);
   profile_q8; then q8_quality — the f32 drive's sequences teacher-forced
   through ``decode.forward`` with f32 weights and pool and with int8
   ones: relative logit MSE <= ``Q8_QUALITY`` (argmax agreement printed).
6. serve_llama — Llama-3.2-1B at full width (16 layers, 32 heads over 8
   KV heads, head_dim 64, vocab 128256; weights drawn on the card from
   ``--seed``), 8 slots, max_len 1024, 16-token pages, the same request
   shapes: int8 f32 K4 vs int8 gather (>= 15/16 identical:
   serve_llama_q8_f32), then bf16 through K3 and bf16 int8 through K4,
   each with launches == 16 x decode ticks and the other kernel's 0;
   profile_llama and profile_llama_q8.
6b. the serving tier through its entry points, every number beside the
   card's name and power limit. tier_http — ``serving.serve``'s own
   ``build`` (GPT-2 124M bf16, 2 replicas x 4 slots, max_len 1024, port 0):
   a greedy 64-token SSE stream read with ``http.client`` whose replica
   is killed (/admin/kill) after its first token must end DONE with 64
   tokens; /healthz shows the replica DOWN, /admin/restart brings it back
   HEALTHY, a plain request then runs, and a 48-request burst must meet a
   429 with Retry-After (``--queue-limit 2``); K3 counted from zero over
   the phase, launched from the server's drive thread. tier_storm — ``serving.loadgen``'s
   legs at full width: GPT-2 124M, 4 replicas x 4 slots, max_len 1024,
   40 requests of ``workload.request_stream`` (prompts 4-341 tokens, 24
   new), the twin's kill schedule (ticks 12 and 36, Bernoulli 0.005,
   restart after 40 ticks), rates 0.5 and 2.0 of the calibrated
   capacity, clean and storm, in f32 and bf16: per leg achieved QPS,
   goodput, p50/p99 request seconds, sheds, failovers, restarts,
   ``done_outputs_match_clean``, peak memory, and K3 launches == n_layer
   x (decode ticks over every replica + one warmup per restart), K4 0;
   no lost or duplicated request, every clean request DONE, and in f32
   at most 1 in 16 storm outputs differing from the clean leg, each only
   at or after its failover token (bf16: reported). tier_llama_q8 —
   Llama-3.2-1B with int8 KV pages and weights, 2 replicas, rate 1.0:
   the same gates with K4 in K3's place. failover_paths — where a
   failed-over row's values part from the undisturbed run's: each op of
   GPT-2's block 0 (ln_1, the qkv projection, attention over the same
   paged keys, c_proj, c_fc) on the same rows decode-shaped ([4, 1, E],
   K3) and prefill-shaped ([4, 64, E], the gather path), f32 and bf16:
   largest difference, bit-equality, the first op that differs.
6c. generation outside the paged engine, each phase with K3 and K4
   counted from zero and required to stay at 0 (neither engine below runs
   them, and a speculating paged engine's verify forward is K+1 queries
   wide: the gather path). generate — ``serving.generate``'s functions,
   GPT-2 124M, a 64-token prompt, 64 new tokens: ``decode.generate``,
   ``generate_monolithic`` and ``--stream`` token-equal in f32 (bf16
   reported), ms per token of a warm ``DecodeEngine``, a sampled run
   repeated with its seed equal; MoE GPT-2 (8 experts, top-2) greedy rows
   at B 1 and B 4 equal on >= 7 of 8 in f32. dense — the serve phase's 16
   requests through ``BatchedDecodeEngine`` (8 slots, max_len 1024,
   buckets 64-1024): f32 tokens equal to the paged f32 kernel drive's on
   >= 15 of 16; bf16 tick ms, tok/s, TTFT p50, cache bytes, a profile of
   ten ticks; the dense prefill bit-independent of its neighbours in
   bf16. spec — ``speculative_k=4`` on the dense and paged engines (GPT-2
   f32 and bf16) and on Llama-3.2-1B with int8 pages and weights, over a
   repetitive and a random 16-request stream: spec vs plain equal on >=
   15 of 16 in f32, accept rate, committed tokens per row-tick, ticks,
   tok/s and TTFT against plain; spec_rollback — a published 128-token
   prefix's pages bit-unchanged under speculating borrowers. soak — the
   soak twin at full width (GPT-2 f32, 200 requests), all five invariants.
   serve_dense — ``serve --dense`` (2 GPT-2 bf16 replicas): a stream
   survives /admin/kill of its replica.
7. flash — the flash forward (K1) and backward (K2) kernels against their
   plain versions at the GPT-2 124M training shape (B=8, H=12, T=1024,
   D=64, causal), a Llama-3.2-1B shape (B=1, H=32, Hkv=8, T=2048, D=64,
   causal) and a head_dim-128 non-causal shape with a ragged T, in f32
   and bf16 (``FLASH_TOLERANCES``; bf16 also against the plain versions
   in f32: ``flash_fwd_bf16_vs_f32``, ``FLASH_BF16_VS_F32``), with kernel,
   plain, bound and ``scaled_dot_product_attention`` (forward; backward)
   times and the names of SDPA's device kernels.
8. train — the training main path: GPT-2 124M at full width, bf16
   activations over f32 params, flash attention, ``names`` remat, bf16
   logits, no dropout, AdamW (lr 3e-4, wd 0.1, cosine), B=8, T=1024, one
   fixed batch from ``--seed``; 3 warmup steps, then 3 timed windows of 10
   steps (tokens/s, ms/step, MFU, loss, grad_norm, peak memory). K1 and K2
   launches are counted from zero over the whole drive and must each
   equal n_layer x steps; the loss must fall. Layer 0's flash inputs at
   the last warmup step are replayed against the plain versions for the
   kernels line.
9. train_profile — ``torch.profiler`` over 2 training steps; then
   train_remat — the same step under remat "none", "full", "dots",
   "dots_no_batch" and "flash" (ms/step, peak memory; K1 launches per
   step n_layer x ``K1_PER_LAYER``, as often as the JAX grad runs its
   flash forward; K2 n_layer).
10. train_parity — one f32 step at full width (B=2, T=1024) through the
   kernels and the same step with naive attention, from the same weights.
11. train_loop — the training entry point's path
   (``train/baseline.py``'s functions, GPT-2 124M with the preset's
   dropout 0.1: A = 4 micro-batches of [8, 1024], 8 steps, a checkpoint
   every 4), a fresh ``Trainer`` resuming step 4 bit for bit, ``evaluate``
   over 4 batches (K1 n_layer x 4, K2 0) and a profile of one step
   (train_loop_profile); train_dropout — keep fractions per site, masks
   distinct across layers, steps and micro-batches, f32 gradients equal
   under all six remat modes; train_fused_ce — ``fused_head_ce`` against
   the unfused step (loss, gradients, ms/step, peak memory, a profile of
   each).
12. Llama-3.2-1B training at full width (16 layers, E 2048, 32 heads over
   8 KV heads, F 8192, vocab 128256, untied head; weights drawn on the
   card from ``--seed``): train_llama — bench_suite row 6 (B=1, T=4096,
   bf16 activations and params, flash, names, fused head CE, bf16
   logits), 2 warmup and 5 timed steps (ms/step, tok/s, MFU, peak memory,
   K1 == K2 == 16 per step, the loss falls; a one-step profile);
   train_llama_long — row 7 (T=8192, flash remat), 3 timed steps;
   train_llama_loop — the entry point ``--preset llama3-1b`` at its
   defaults for 4 steps (A = 4 x [8, 1024], f32 params, f32 logits
   through the unfused head; the f32 GEMMs' share of device time in its
   profile); train_llama_remat — every remat mode at 4 layers, T=4096
   (K1 4 or 8 per step, K2 4; f32 gradients equal to mode none's; f32
   flash vs naive: train_llama_parity); train_moe — GPT-2 124M with 8
   experts, top-2, B=8, T=1024, and the Llama width at 4 layers with 8
   SwiGLU experts, top-2, B=1, T=4096 (ms/step, peak memory, dropped
   share, two runs of a step bit-equal), and sort vs einsum dispatch on
   the card (train_moe_dispatch). The flash phase adds flash_long: K1/K2
   at the llama shapes T=4096 and T=8192 (bf16, plain versions run by KV
   head).
13. The kernels line (K3, K4, K1, K2; K1/K2 with their launches per step
    and times on the llama paths, K3/K4 with their launches on each tier
    leg, ``tier_paths``, and on the phases of 6c, ``slice9_paths``), then
    ``{"ok": true, "device": {...}}`` last.
"""

from __future__ import annotations

import argparse
import json
import re
import statistics
import subprocess
import sys
import tempfile
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
# K4 (int8 pages) vs its plain version. f32: the kernel scales q.k_int by
# the token's scale where the plain version dequantizes each element
# first, so only rounding order differs. In bf16 the plain version
# rounds every dequantized K and V element to bf16 (as the JAX reference
# does) and its softmax weights, while K4 keeps all of it in f32: the
# largest differences measured on an H100 are 9.8e-4 at the main path's
# inputs and 7.8e-3 (one bf16 ulp in [1, 2), at outputs below 0.5) at
# the kernel phase's unit-variance pages, so K4 is held to about 3x the
# latter. It is also held tightly to the plain version with q in f32 on
# the same int8 pages and scales (``BF16_VS_F32``), where dequantization
# is exact on both sides and what is left is K4's one bf16 rounding of
# its output.
Q8_TOLERANCES = {
    torch.float32: dict(atol=1e-5, rtol=0.0),
    torch.bfloat16: dict(atol=2.4e-2, rtol=1e-2),
}
BF16_OPS_PER_S = 989e12  # H100 SXM bf16 dense tensor cores
BF16_UNIT_ROUNDOFF = 2.0**-8  # round-to-nearest into 8 significant bits
# Flash kernels vs their plain versions. f32 differs in summation order
# only (gradients sum over up to T keys or queries, hence their larger
# atol). In bf16 the kernels and the plain versions round the softmax
# weights and dS to bf16 before their products, as the TPU kernels do:
# what is left is f32 summation order and exp2's last bits, and the bf16
# roundings of p, dS or an output that these flip. Measured on an H100
# over the flash phase's shapes and 128 ragged ones (T 1-1000, groups
# 1-8, D 64/128, causal or not): at most one output ulp, 7.8e-3 for o
# (in [1, 2)) and 3.1e-2 for a gradient (in [4, 8)). rtol 1e-2 is above
# one ulp's share of any value (2^-7); atol covers values near zero.
FLASH_TOLERANCES = {
    torch.float32: dict(fwd=dict(atol=1e-5, rtol=1e-5),
                        bwd=dict(atol=1e-4, rtol=1e-5)),
    torch.bfloat16: dict(fwd=dict(atol=5e-3, rtol=1e-2),
                         bwd=dict(atol=1e-2, rtol=1e-2)),
}
# bf16 kernels vs the plain versions run in f32 on the same values (bf16 ->
# f32 is exact). The forward's bound is derived (flash_fwd_bf16_vs_f32).
# The backward's is 3x the largest difference measured on an H100 over the
# same inputs: 3.66e-2 (dv at B 1, H 8, Hkv 1, T 65, D 128, causal, where
# |dv| reaches 11.8; dk 1.98e-2, dq 1.29e-2).
FLASH_BF16_VS_F32 = dict(bwd=dict(atol=0.11, rtol=0.0))
LSE_TOL = dict(atol=1e-5, rtol=1e-5)


def flash_fwd_bf16_vs_f32(v: torch.Tensor) -> dict:
    """Tolerance of a bf16 forward that rounds each softmax weight p to
    bf16 before P V (K1 and the bf16 plain version) against the f32 plain
    version on the same values: |o - o32| <= u (1 + u) max|v| + u |o32|
    + 1e-5, u = 2^-8. Each rounded p is p (1 + d), |d| <= u; the weights
    p / l sum to 1 (l is summed from the unrounded p), so P V / l moves by
    at most u max|v|; rounding o once adds u |o| <= u (|o32| + u max|v|);
    1e-5 covers f32 summation order and exp2's last bits."""
    u = BF16_UNIT_ROUNDOFF
    return dict(atol=u * (1 + u) * float(v.abs().max()) + 1e-5, rtol=u)


def emit(**fields) -> None:
    print(json.dumps(fields), flush=True)


def spin_cycles(ms: float) -> int:
    """Clock cycles that ``torch.cuda._sleep`` spins for ``ms`` on this
    card, measured once with CUDA events."""
    if not hasattr(spin_cycles, "per_ms"):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(1000)
        start.record()
        torch.cuda._sleep(10_000_000)
        end.record()
        end.synchronize()
        spin_cycles.per_ms = 10_000_000 / start.elapsed_time(end)
    return int(spin_cycles.per_ms * ms)


def time_ms(fn, flush: torch.Tensor, n: int = 25) -> float:
    """Median device time of ``fn`` over ``n`` launches (CUDA events).
    Zeroing ``flush`` before each launch evicts the 50 MB L2, as the
    serving loop finds the pools cold. Then the device spins for 2 ms
    (``torch.cuda._sleep``) while the host enqueues the start event and
    the call, so the host's time (autograd's dispatch, a wrapper's
    allocations) stays outside the events and only device time is
    measured: the zeroing alone (~0.1 ms on the device) hid less than
    some calls take to enqueue."""
    fn()
    torch.cuda.synchronize()
    cycles = spin_cycles(2.0)
    times = []
    for _ in range(n):
        flush.zero_()
        torch.cuda._sleep(cycles)
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
    0..lengths[b] of each (row, KV head) read once for K and V (D x
    itemsize bytes each; for int8 pages D bytes plus the token's 4-byte
    scale), q read and o written once, the table entries of those keys'
    pages and the lengths read once, over the HBM rate; or its
    multiply-adds (q.k and p.v, f32 on the CUDA cores) over the f32 rate
    — whichever is larger."""
    b, h, d = q.shape
    page, hkv = k_pages.shape[1], k_pages.shape[2]
    n_pages = tables.shape[1]
    lens = np.minimum(lengths.cpu().numpy().astype(np.int64),
                      n_pages * page - 1)
    tokens = int((lens + 1).sum())
    item = q.element_size()
    row_bytes = d * k_pages.element_size()
    if k_pages.dtype == torch.int8:
        row_bytes += 4  # the f32 scale
    nbytes = (
        tokens * hkv * row_bytes * 2 + 2 * q.numel() * item
        + int((lens // page + 1).sum()) * 4 + b * 4
    )
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = 4 * h * d * tokens / F32_OPS_PER_S * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def ptxas_summary(log: str) -> dict:
    """Registers and spilled bytes (stores + loads) of each kernel in an
    ``nvcc -Xptxas -v`` log, keyed by the kernel's name and template
    arguments as they appear in its mangled name."""
    out, name = {}, None
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:
            mangled = entry.group(1)
            base = re.search(r"\d+((?:flash|paged)_\w+?)I", mangled)
            args = re.findall(r"Li(\d+)E", mangled)
            name = (base.group(1) if base else mangled) + (
                f"<{','.join(args)}>" if args else "")
            if "nv_bfloat16" in mangled:
                name += "[bf16]"
            types = re.search(r"paged_\w+?I(\w*?)Li", mangled)
            if types and types.group(1).endswith("a"):  # KV = int8_t (K4)
                name += "[int8]"
            out[name] = dict(registers=None, spill_bytes=0)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
        if spill and name:
            out[name]["spill_bytes"] = int(spill[1]) + int(spill[2])
        regs = re.search(r"Used (\d+) registers", line)
        if regs and name:
            out[name]["registers"] = int(regs[1])
    return out


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
    """One launch of the kernel (K3, or K4 when ``args`` carry the scale
    pools) on ``args`` against its plain version on the same inputs
    (``TOLERANCES``, ``Q8_TOLERANCES``), and for bf16 also against the
    plain version in f32 on the same values (``BF16_VS_F32``: bf16 -> f32
    is exact; int8 pages and f32 scales stay as they are). Returns the
    largest differences and the tolerances used."""
    out = pk.paged_decode_attention(*args)
    torch.cuda.synchronize()
    tol = (Q8_TOLERANCES if len(args) > 5 else TOLERANCES)[args[0].dtype]
    err = check_close(out, pk.paged_decode_attention_reference(*args),
                      what=what, **tol)
    res = dict(max_abs_err=err, **tol)
    if args[0].dtype == torch.bfloat16:
        exact = pk.paged_decode_attention_reference(
            *(t.float() if t.dtype == torch.bfloat16 else t for t in args)
        )
        res["max_abs_err_vs_f32_plain"] = check_close(
            out, exact, what=f"{what} vs f32 plain", **BF16_VS_F32
        )
    return res


def split_plan(pk, args) -> dict:
    """The kernel's partition of rows at these inputs: keys per CTA
    (``chunk_tokens``) and CTAs per (row, KV head) (``n_splits``), and
    how many of those CTAs these rows' lengths make active."""
    q, k_pages, tables, lengths = args[0], args[1], args[3], args[4]
    page, n_pages = k_pages.shape[1], tables.shape[1]
    chunk, n_splits = pk._split_plan(page, n_pages, q.shape[2],
                                     k_pages.dtype)
    n_tok = np.minimum(lengths.cpu().numpy().astype(np.int64) + 1,
                       n_pages * page)
    active = int(np.maximum(1, -(-n_tok // chunk)).sum()) * k_pages.shape[2]
    return dict(chunk_tokens=chunk, n_splits=n_splits, active_ctas=active)


def paged_case(dev, seed, b, h, hkv, d, dtype, q8, page=16, n_pages=64):
    """Kernel inputs at a decode shape: rows at lengths 0, page-1, page,
    max_len-1 and random, each over distinct pool pages up to its depth
    (the rest of its table on the scratch page 0); pages from ``randn`` in
    ``dtype``, or for K4 (``q8``) quantized by the port's ``quantize_kv``
    (int8 pages + f32 scale pools). Returns the wrapper's arguments."""
    from pytorch_distributed_tpu_torch.ops.quant import quantize_kv

    g = torch.Generator(device=dev).manual_seed(seed)
    n_pool = b * n_pages + 1
    k = torch.randn(n_pool, page, hkv, d, generator=g, device=dev)
    v = torch.randn(n_pool, page, hkv, d, generator=g, device=dev)
    q = torch.randn(b, h, d, generator=g, device=dev).to(dtype)
    lengths = torch.randint(0, n_pages * page, (b,), generator=g,
                            device=dev, dtype=torch.int32)
    lengths[:4] = torch.tensor([0, page - 1, page, n_pages * page - 1])
    ids = (torch.randperm(n_pool - 1, generator=g, device=dev) + 1)
    ids = ids[: b * n_pages].reshape(b, n_pages)
    used = (torch.arange(n_pages, device=dev)[None] * page
            <= lengths[:, None])
    tables = torch.where(used, ids, 0).to(torch.int32).contiguous()
    if not q8:
        return (q, k.to(dtype), v.to(dtype), tables, lengths)
    (kq, ks), (vq, vs) = quantize_kv(k), quantize_kv(v)
    return (q, kq, vq, tables, lengths, ks, vs)


def kernel_phase(pk, dev, flush, seed) -> None:
    """K3 and K4 against their plain versions at the three decode shapes,
    q in f32 and bf16, with kernel, plain and bound times."""
    shapes = [
        ("gpt2-124M", 8, 12, 12, 64),
        ("llama3.2-1B", 8, 32, 8, 64),
        ("head_dim-128", 8, 32, 8, 128),
    ]
    page, n_pages = 16, 64  # max_len 1024
    # What time_ms reads for a launch that does no work: the floor under
    # every kernel time here.
    emit(phase="launch_floor", empty_launch_ms=time_ms(
        lambda: torch.cuda._sleep(1), flush))
    for kernel, q8 in (("paged_decode_attention", False),
                       ("paged_decode_attention_q8", True)):
        for name, b, h, hkv, d in shapes:
            for dtype in TOLERANCES:
                args = paged_case(dev, seed, b, h, hkv, d, dtype, q8, page,
                                  n_pages)
                checked = check_kernel(pk, args, f"{kernel} {name} {dtype}")
                bound_ms, bound_by = paged_bound(args[0], args[1], args[3],
                                                 args[4])
                emit(
                    phase="kernel", kernel=kernel, shape=name,
                    B=b, H=h, Hkv=hkv, D=d, page=page,
                    max_len=n_pages * page, **split_plan(pk, args),
                    dtype=str(dtype).replace("torch.", ""),
                    pages=str(args[1].dtype).replace("torch.", ""),
                    lengths=args[4].tolist(), **checked,
                    kernel_ms=time_ms(
                        lambda: pk.paged_decode_attention(*args), flush),
                    plain_ms=time_ms(
                        lambda: pk.paged_decode_attention_reference(*args),
                        flush),
                    bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
                )


def streams_phase(pk, dev, seed, rounds: int = 25) -> None:
    """K3 and K4 launched concurrently on two non-default streams, each
    with inputs of its own (the GPT-2 decode shape, bf16 pages and int8
    pages), ``rounds`` times: every output bit-equal to a serial launch on
    one stream, and every workspace counter back at 0. Both streams wait
    on an event recorded after a 20 ms spin on a third stream, so all
    their launches are queued before the first runs."""
    inputs = [[paged_case(dev, seed + s, 8, 12, 12, 64, torch.bfloat16, q8)
               for q8 in (False, True)] for s in (1, 2)]
    want = [[pk.paged_decode_attention(*a) for a in pair] for pair in inputs]
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(dev) for _ in inputs]
    gate, spinner = torch.cuda.Event(), torch.cuda.Stream(dev)
    with torch.cuda.stream(spinner):
        torch.cuda._sleep(spin_cycles(20.0))
        gate.record(spinner)
    got = []
    for stream, pair in zip(streams, inputs):
        stream.wait_event(gate)
        with torch.cuda.stream(stream):
            got.append([[pk.paged_decode_attention(*a) for a in pair]
                        for _ in range(rounds)])
    torch.cuda.synchronize()
    mismatched = sum(not torch.equal(out, ref)
                     for per_stream, refs in zip(got, want)
                     for outs in per_stream for out, ref in zip(outs, refs))
    counters = [c for _, c in pk._workspaces.values()]
    nonzero = sum(int(c.count_nonzero()) for c in counters)
    emit(phase="streams", streams=len(streams), rounds=rounds,
         launches=2 * len(streams) * rounds, mismatched=mismatched,
         workspaces=len(counters), nonzero_counters=nonzero)
    if mismatched or nonzero:
        raise AssertionError(
            f"K3/K4 on two streams: {mismatched} outputs differ from serial "
            f"launches, {nonzero} workspace counters not back at 0")


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


def serve(cfg, params, reqs, paged_attention, pk, record=None,
          **quant) -> dict:
    """One drive of ``reqs`` through a fresh engine (8 slots, max_len
    1024, 16-token pages; ``quant``: its ``kv_quant``/``weight_quant``).
    K3 and K4 launches count from zero for exactly this drive: the path's
    kernel (K4 for an int8 pool) must have launched n_layer x decode
    ticks times and the other kernel never (neither, on the gather
    path)."""
    from pytorch_distributed_tpu_torch.serving import PagedBatchedDecodeEngine

    eng = PagedBatchedDecodeEngine(cfg, slots=8, max_len=1024, page_size=16,
                                   paged_attention=paged_attention, **quant)
    eng.warmup(params)
    original = pk.paged_decode_attention
    if record is not None:
        pk.paged_decode_attention = record
    pk.launches = pk.launches_q8 = 0  # count from zero for this drive
    try:
        run = drive_engine(eng, params, reqs)
    finally:
        pk.paged_decode_attention = original
    counts = {"K3": pk.launches, "K4": pk.launches_q8}
    m = run["metrics"]
    if m["generated_tokens"] != 64 * len(reqs):
        raise AssertionError(f"generated {m['generated_tokens']} tokens, "
                             f"want {64 * len(reqs)}")
    ticks = eng.counters["decode_ticks"]
    kernel = "K4" if eng.kv_quant == "int8" else "K3"
    want = {"K3": 0, "K4": 0}
    if paged_attention == "kernel":
        want[kernel] = cfg.n_layer * ticks
    if counts != want:
        raise AssertionError(
            f"{paged_attention} path launches {counts} != {want} (n_layer "
            f"{cfg.n_layer} x decode ticks {ticks} on the path's kernel): "
            f"the decode path did not go through its kernel"
        )
    return dict(
        tokens=dict(enumerate(run["tokens"])),
        launches=counts[kernel],
        metrics=dict(
            model=f"{cfg.family} L{cfg.n_layer} E{cfg.n_embd}",
            dtype=cfg.dtype, paged_attention=paged_attention,
            kv_quant=eng.kv_quant, weight_quant=eng.weight_quant,
            requests=len(reqs), kernel_launches=counts,
            **{k: m[k] for k in (
                "generated_tokens", "decode_ticks", "prefill_ticks",
                "mean_decode_tick_ms", "pure_decode_ticks",
                "generated_tok_per_s", "wall_s", "ttft_p50_ms")},
            prefix_hits=eng.pool.stats["prefix_hits"],
            prefix_hit_tokens=eng.pool.stats["prefix_hit_tokens"],
            preemptions=eng.counters["preemptions"],
            pool_bytes=eng.cache_hbm_bytes()["allocated"],
            pool_peak_in_use_bytes=eng.cache_hbm_bytes()["peak_in_use"],
        ),
        engine=eng,
    )


def device_us(e) -> float:
    """Self device time (us) of a ``key_averages()`` row."""
    return getattr(e, "self_device_time_total",
                   getattr(e, "self_cuda_time_total", 0))


def profile_summary(prof, wall_ms: float,
                    share_of: str | None = None) -> dict:
    """Device busy share of the window, the kernels by device time and the
    host ops by self CPU time, from a finished ``torch.profiler`` run;
    with ``share_of``, the share of the device time spent in kernels whose
    name matches that regex, and their names."""
    from torch.autograd import DeviceType

    events = prof.key_averages()

    # Device-side events only (kernels, copies): an operator's row repeats
    # the device time of the kernels it launched.
    kernels = sorted(
        (e for e in events
         if e.device_type == DeviceType.CUDA and device_us(e) > 0),
        key=device_us, reverse=True,
    )
    device_ms = sum(device_us(e) for e in kernels) / 1e3
    host = sorted(events, key=lambda e: e.self_cpu_time_total, reverse=True)
    matched = {}
    if share_of:
        matched = [e for e in kernels if re.search(share_of, e.key)]
        matched = dict(
            matched_regex=share_of,
            matched_device_ms=sum(device_us(e) for e in matched) / 1e3,
            matched_share=(sum(device_us(e) for e in matched) / 1e3
                           / device_ms) if device_ms else None,
            matched_kernels=sorted({e.key[:100] for e in matched}))
    return dict(**matched,
        wall_ms=wall_ms, device_busy_ms=device_ms,
        device_idle_share=(1 - device_ms / wall_ms) if device_ms else None,
        kernels=[dict(name=e.key[:80], calls=e.count,
                      device_ms=device_us(e) / 1e3) for e in kernels[:12]],
        host_ops=[dict(name=e.key[:60], calls=e.count,
                       self_cpu_ms=e.self_cpu_time_total / 1e3)
                  for e in host[:12]],
    )


def profile_phase(cfg, params, reqs, n_ticks: int = 10, phase="profile",
                  engine=None, **quant) -> None:
    """``torch.profiler`` over ``n_ticks`` pure decode ticks of the bf16
    paged engine (``quant``: its ``kv_quant``/``weight_quant``), or of
    ``engine`` (warmed), with all 8 slots decoding."""
    from torch.profiler import ProfilerActivity, profile

    from pytorch_distributed_tpu_torch.serving import PagedBatchedDecodeEngine

    eng = engine
    if eng is None:
        eng = PagedBatchedDecodeEngine(cfg, slots=8, max_len=1024,
                                       page_size=16, **quant)
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
    emit(phase=phase, decode_ticks=n_ticks, **quant,
         **profile_summary(prof, wall_ms))


PAGED_SOURCE = "pytorch_distributed_tpu_torch/csrc/paged_attention.cu"
Q8 = dict(kv_quant="int8", weight_quant="int8")


def kernel_vs_gather(phase, cfg, params, reqs, pk, **quant) -> dict:
    """The same f32 drive through the kernel and through the gather path:
    tokens identical on >= 15 of the 16 requests. Returns the kernel
    drive's tokens by request id."""
    runs = {impl: serve(cfg, params, reqs, impl, pk, **quant)
            for impl in ("kernel", "gather")}
    a, b = runs["kernel"]["tokens"], runs["gather"]["tokens"]
    same = sum(np.array_equal(a[r], b[r]) for r in a)
    emit(phase=phase, identical_requests=same, of=len(reqs),
         kernel=runs["kernel"]["metrics"], gather=runs["gather"]["metrics"])
    if same < 15:
        raise AssertionError(
            f"{phase}: f32 kernel and gather paths agree on only "
            f"{same}/{len(reqs)} requests"
        )
    return a


def main_path(phase, cfg, params, reqs, pk, flush, spread_runs=2,
              **quant) -> dict:
    """A serving main path: the drive whose kernel launches count
    (``serve``: from zero, exactly n_layer x decode ticks), ``spread_runs``
    more drives for the spread of its host-clock metrics, and its
    kernels-line entry — the deepest decode tick's layer-0 inputs (with
    the scale pools for an int8 pool) replayed against the plain version,
    with kernel, plain and bound times."""
    captured: list = []
    original = pk.paged_decode_attention

    def record(q, k_pages, v_pages, block_tables, lengths, *scales):
        # Keep every decode tick's layer-0 inputs (q, tables, lengths) as
        # device copies, which need no sync; the pools are read back after
        # the run.
        if record.calls % cfg.n_layer == 0:
            captured.append((q.clone(), block_tables.clone(),
                             lengths.clone()))
        record.calls += 1
        return original(q, k_pages, v_pages, block_tables, lengths, *scales)

    record.calls = 0
    run = serve(cfg, params, reqs, "kernel", pk, record=record, **quant)
    emit(phase=phase, **run["metrics"])
    if run["launches"] == 0:
        raise AssertionError(f"{phase}: the main path launched no kernel")
    spread = [run["metrics"]] + [
        serve(cfg, params, reqs, "kernel", pk, **quant)["metrics"]
        for _ in range(spread_runs)
    ]
    emit(phase=f"{phase}_spread", runs=len(spread), **{
        key: [m[key] for m in spread]
        for key in ("mean_decode_tick_ms", "generated_tok_per_s",
                    "ttft_p50_ms", "wall_s")
    })
    cache = run["engine"]._cache
    q, tables, lengths = max(captured, key=lambda c: int(c[2].sum()))
    kargs = (q, cache["k"][0], cache["v"][0], tables, lengths)
    if "k_scale" in cache:
        kargs += (cache["k_scale"][0], cache["v_scale"][0])
    checked = check_kernel(pk, kargs, f"{phase} main-path inputs")
    bound_ms, bound_by = paged_bound(q, kargs[1], tables, lengths)
    entry = dict(
        launches=run["launches"], **checked, **split_plan(pk, kargs),
        ms=time_ms(lambda: pk.paged_decode_attention(*kargs), flush),
        plain_ms=time_ms(lambda: pk.paged_decode_attention_reference(*kargs),
                         flush),
        bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
        inputs=dict(B=q.shape[0], H=q.shape[1], Hkv=kargs[1].shape[2],
                    D=q.shape[2], dtype=cfg.dtype,
                    pages=str(kargs[1].dtype).replace("torch.", ""),
                    lengths=lengths.tolist()),
    )
    return dict(entry=entry, metrics=run["metrics"])


def quality_phase(cfg, params, reqs, tokens, dev) -> None:
    """int8 quality on the card (f32): the served sequences (``tokens``, by
    request id) teacher-forced through ``decode.forward`` once with the
    unquantized params and pool, once with int8 weights and pool. The
    relative logit MSE over the generated positions (mean over requests,
    as the JAX package's quality test) is gated by ``Q8_QUALITY``; the
    teacher-forced argmax agreement is printed, not gated: random
    full-width weights leave near-ties that flip (the CPU tests gate it
    on a tiny model)."""
    from pytorch_distributed_tpu_torch.models import decode
    from pytorch_distributed_tpu_torch.ops import quant

    seqs = [np.asarray(tokens[r], np.int32)[:-1] for r in sorted(tokens)]
    regions = [(len(reqs[r]["prompt"]) - 1, len(seqs[r]))
               for r in range(len(seqs))]
    n, t_max, page = len(seqs), max(len(x) for x in seqs), 16
    batch = np.zeros((n, t_max), np.int32)
    for i, x in enumerate(seqs):
        batch[i, : len(x)] = x
    n_pp = -(-t_max // page)
    tables = torch.arange(1, 1 + n * n_pp, dtype=torch.int32,
                          device=dev).reshape(n, n_pp)
    pos = torch.zeros(n, dtype=torch.int32, device=dev)
    logits = {}
    for kv_quant, p in (("none", params),
                        ("int8", quant.quantize_decode_params(params))):
        cache = decode.init_paged_cache(cfg, n * n_pp + 1, page,
                                        device=dev, kv_quant=kv_quant)
        with torch.no_grad():
            out, _ = decode.forward(p, torch.from_numpy(batch).to(dev), cfg,
                                    cache, pos, block_tables=tables,
                                    kv_quant=kv_quant)
        logits[kv_quant] = [out[i, g0:g1].cpu().numpy()
                            for i, (g0, g1) in enumerate(regions)]
        del out, cache
    mse = [quant.relative_logit_mse(a, b)
           for a, b in zip(logits["none"], logits["int8"])]
    agree = [quant.argmax_agreement(a, b)
             for a, b in zip(logits["none"], logits["int8"])]
    budget = quant.Q8_QUALITY["max_relative_logit_mse"]
    res = dict(relative_logit_mse=statistics.fmean(mse),
               max_request_relative_logit_mse=max(mse),
               argmax_agreement=statistics.fmean(agree),
               min_request_argmax_agreement=min(agree),
               positions=sum(g1 - g0 for g0, g1 in regions),
               max_relative_logit_mse=budget)
    emit(phase="q8_quality", **res)
    if not res["relative_logit_mse"] <= budget:
        raise AssertionError(f"int8 relative logit MSE over budget: {res}")


def llama_phase(pk, seed, dev) -> None:
    """Llama-3.2-1B at full width (16 layers, E 2048, 32 heads over 8 KV
    heads: group 4, head_dim 64, vocab 128256), random weights drawn on
    the card from ``seed``, the same request shapes as GPT-2: int8 f32
    kernel vs gather (>= 15/16 identical), then bf16 unquantized through
    K3 and bf16 int8 through K4, each with launches == 16 x decode ticks
    and the other kernel's count 0 (``serve``); then a profile of each
    bf16 engine."""
    from pytorch_distributed_tpu_torch.config import model_config
    from pytorch_distributed_tpu_torch.models import llama
    from pytorch_distributed_tpu_torch.utils import tree

    cfg = model_config("llama3-1b")  # bf16 activations, f32 params
    t0 = time.perf_counter()
    params = llama.init(torch.Generator(device=dev).manual_seed(seed), cfg,
                        device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    reqs = requests(cfg, seed)
    kernel_vs_gather("serve_llama_q8_f32", cfg.replace(dtype="float32"),
                     params, reqs, pk, **Q8)
    drives = {name: serve(cfg, params, reqs, "kernel", pk, **quant)["metrics"]
              for name, quant in (("bf16_K3", {}), ("bf16_q8_K4", Q8))}
    emit(phase="serve_llama", init_s=init_s,
         n_params=sum(t.numel() for t in tree.leaves(params)), **drives)
    profile_phase(cfg, params, reqs, phase="profile_llama")
    profile_phase(cfg, params, reqs, phase="profile_llama_q8", **Q8)


def _sse_stream(host, port, body, on_first_token=None):
    """POST ``body`` to /v1/generate with ``stream`` on and read its
    Server-Sent Events with ``http.client``: returns (token events, the
    done event's data, seconds to the first token, seconds to the end).
    ``on_first_token()`` runs once, after the first token arrives."""
    import http.client

    conn = http.client.HTTPConnection(host, port, timeout=600)
    t0 = time.perf_counter()
    conn.request("POST", "/v1/generate", json.dumps({**body, "stream": True}),
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    if resp.status != 200:
        raise AssertionError(f"SSE request got HTTP {resp.status}")
    tokens, done, first = [], None, None
    event = "message"
    while True:
        line = resp.fp.readline()
        if not line:
            break
        line = line.decode().rstrip("\n")
        if line.startswith("event:"):
            event = line[len("event:"):].strip()
        elif line.startswith("data:"):
            data = json.loads(line[len("data:"):])
            if event == "done":
                done = data
            else:
                tokens.append(data["token"])
                if first is None:
                    first = time.perf_counter() - t0
                    if on_first_token is not None:
                        on_first_token()
        elif not line:
            event = "message"
    conn.close()
    return tokens, done, first, time.perf_counter() - t0


def _http_json(host, port, method, path, body=None):
    """One request over ``http.client``: (status, headers, decoded JSON)."""
    import http.client

    conn = http.client.HTTPConnection(host, port, timeout=600)
    conn.request(method, path, None if body is None else json.dumps(body),
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    out = resp.status, dict(resp.getheaders()), json.loads(resp.read())
    conn.close()
    return out


def _tier_launches(pk, cfg, q8, ticks, warmups) -> dict:
    """The paged kernels' counts against what the tier drove: the path's
    kernel (K4 for int8 pools) n_layer x (``ticks`` decode ticks +
    ``warmups`` engine warmups, one decode forward each), the other 0."""
    want = {"K3": 0, "K4": 0}
    want["K4" if q8 else "K3"] = cfg.n_layer * (ticks + warmups)
    got = {"K3": pk.launches, "K4": pk.launches_q8}
    if got != want:
        raise AssertionError(
            f"tier launches {got} != {want} (n_layer {cfg.n_layer} x "
            f"(decode ticks {ticks} + warmups {warmups})): the tier's "
            "decode did not go through its kernel"
        )
    return dict(launches=got, decode_ticks=ticks, warmups=warmups)


def tier_http_phase(pk, seed, smi) -> dict:
    """The serving twin on the card: ``serving.serve``'s own ``build``, GPT-2
    124M (bf16), 2 replicas x 4 slots, max_len 1024, on 127.0.0.1 port 0.
    A greedy 64-token SSE stream whose replica is killed (/admin/kill)
    after its first token must end in ``event: done``, DONE, with 64
    tokens streamed; /healthz shows the replica DOWN, /admin/restart
    brings it back HEALTHY; a plain request then runs on the restarted
    replica; a burst of 48 concurrent requests must meet at least one 429
    with Retry-After (``--queue-limit 2``: at most two queued requests per
    replica, so the burst overflows whatever the host's speed). K3 counted
    from zero over the whole phase, launched from the server's drive
    thread."""
    from pytorch_distributed_tpu_torch.serving import serve

    args = serve.parse_args([
        "--preset", "gpt2", "--replicas", "2", "--slots", "4",
        "--max-len", "1024", "--host", "127.0.0.1", "--port", "0",
        "--queue-limit", "2", "--seed", str(seed)])
    cfg, params, router, server = serve.build(args)
    prompt = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, 48).tolist()
    engines = list(router.engines().values())
    pk.launches = pk.launches_q8 = 0
    with serve.serve_in_thread(server) as (host, port):
        killed = {}

        def kill_serving_replica():
            _, _, health = _http_json(host, port, "GET", "/healthz")
            busy = [int(i) for i, r in health["replicas"].items()
                    if r.get("active_rows", 0) + r.get("queue_depth", 0)]
            status, _, body = _http_json(host, port, "POST", "/admin/kill",
                                         {"replica": busy[0]})
            killed.update(replica=busy[0], status=status,
                          states=body["states"])

        tokens, done, ttft, latency = _sse_stream(
            host, port, dict(prompt=prompt, max_new_tokens=64),
            on_first_token=kill_serving_replica)
        _, _, health = _http_json(host, port, "GET", "/healthz")
        down = health["replicas"][str(killed["replica"])]["state"]
        status, _, restarted = _http_json(
            host, port, "POST", "/admin/restart",
            {"replica": killed["replica"]})
        engines += [router.engines()[killed["replica"]]]
        t0 = time.perf_counter()
        status_plain, _, plain = _http_json(
            host, port, "POST", "/v1/generate",
            dict(prompt=prompt[:16], max_new_tokens=16))
        plain_s = time.perf_counter() - t0
        with ThreadPoolExecutor(48) as pool:
            burst = list(pool.map(
                lambda i: _http_json(host, port, "POST", "/v1/generate",
                                     dict(prompt=prompt[:8],
                                          max_new_tokens=8)),
                range(48)))
        counts = _tier_launches(
            pk, cfg, False,
            sum(e.counters["decode_ticks"] for e in engines), warmups=1)
    shed = [(h, b) for st, h, b in burst if st == 429]
    row = dict(
        phase="tier_http", nvidia_smi=smi, model="gpt2 L12 E768",
        dtype=cfg.dtype, replicas=2, slots=4, max_len=1024,
        stream_tokens=len(tokens), done_state=done and done["state"],
        first_token_s=ttft, request_s=latency, killed=killed,
        state_after_kill=down,
        state_after_restart=restarted["states"][str(killed["replica"])],
        plain_after_restart=dict(status=status_plain,
                                 state=plain.get("state"), seconds=plain_s),
        burst=dict(requests=48, ok=sum(st == 200 for st, _, _ in burst),
                   shed_429=len(shed),
                   retry_after=[h.get("Retry-After") for h, _ in shed[:3]]),
        router_counters=router.counters, **counts,
    )
    emit(**row)
    fails = []
    if killed.get("status") != 200 or down != "DOWN":
        fails.append(f"kill: {killed}, state after {down}")
    if done is None or done["state"] != "DONE" or len(tokens) != 64:
        fails.append(f"stream: {len(tokens)} tokens, done {done}")
    elif done["tokens"][len(prompt):] != tokens:
        fails.append("streamed tokens differ from the done event's")
    if row["state_after_restart"] != "HEALTHY":
        fails.append(f"restart: {restarted}")
    if status_plain != 200 or plain.get("state") != "DONE":
        fails.append(f"plain request after restart: {status_plain} {plain}")
    if router.engines()[killed["replica"]].counters["decode_ticks"] == 0:
        fails.append("the restarted replica decoded nothing")
    if not shed or not all(float(h["Retry-After"]) >= 1 and
                           b["retry_after_s"] > 0 for h, b in shed):
        fails.append(f"no 429 with Retry-After in the burst: {row['burst']}")
    if router.counters["failovers"] != 1:
        fails.append(f"failovers {router.counters['failovers']} != 1")
    if fails:
        raise AssertionError(f"tier_http: {fails}")
    return row


def tier_legs(pk, cfg, params, lg_args, smi, phase, engine_kw=None) -> dict:
    """The loadgen twin's legs on the card (``serving.loadgen``'s
    functions): a clean and a storm fleet, warmed and calibrated, then at
    each of ``lg_args.rates`` a clean and a storm leg on one seeded
    schedule. Each leg is driven with the paged kernels' counts at zero
    and read just after (``_tier_launches``), and its peak memory from a
    reset; the storm's DONE outputs are compared with the clean leg's.
    Gates every leg: no lost or duplicated request, every clean request
    DONE, a storm leg's kill fired. f32 also: at most 1 in 16 storm
    outputs differ from the clean leg's, each only at or after its
    failover token. Other dtypes report the count."""
    from pytorch_distributed_tpu_torch.serving import loadgen
    from pytorch_distributed_tpu_torch.serving.workload import (
        exponential_arrivals,
        request_stream,
    )

    engine_kw = engine_kw or {}
    requests = request_stream(
        np.random.default_rng(lg_args.seed), n=lg_args.requests,
        vocab_size=cfg.vocab_size, prompt_len=(4, lg_args.max_len // 3),
        max_new=lg_args.max_new, key_seed=lg_args.seed)
    fleets = {name: loadgen.make_fleet(cfg, lg_args, None, **engine_kw)
              for name in ("clean", "storm")}
    for fleet in fleets.values():
        fleet.warmup(params)
    t0 = time.perf_counter()
    capacity = loadgen.calibrate(list(fleets.values()), params, requests,
                                 lg_args)
    rows, fails = [], []
    for rate_i, mult in enumerate(lg_args.rates):
        offered = capacity * mult
        arrivals = exponential_arrivals(
            np.random.default_rng(lg_args.seed + 101), lg_args.requests,
            1.0 / offered)
        legs = {}
        order = ("clean", "storm") if rate_i % 2 == 0 else ("storm", "clean")
        for name in order:
            fleet = fleets[name]
            restarts0 = fleet.counters["restarts"]
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            pk.launches = pk.launches_q8 = 0
            leg = loadgen.run_leg(fleet, params, requests, arrivals,
                                  lg_args, storm=name == "storm", mult=mult)
            torch.cuda.synchronize()
            leg["row"]["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
            # Decode ticks summed over every engine that ran (``drive``),
            # and each restart's warmup (one decode forward).
            leg["row"].update(_tier_launches(
                pk, cfg, engine_kw.get("kv_quant") == "int8",
                leg["row"]["decode_ticks"],
                fleet.counters["restarts"] - restarts0))
            legs[name] = leg
            loadgen.restore_fleet(fleet, params)
        cmp = loadgen.compare_legs(legs["clean"], legs["storm"], requests)
        gate = loadgen.leg_failures(mult, legs["clean"], legs["storm"],
                                    dict(cmp, mismatches=[]),
                                    lg_args.requests)
        if cfg.dtype == "float32":
            late = [m for m in cmp["mismatches"]
                    if not m["failover_points"]
                    or m["first_diff_token"] < min(m["failover_points"])]
            if len(cmp["mismatches"]) * 16 > cmp["compared"] or late:
                gate.append(
                    f"rate x{mult}: {len(cmp['mismatches'])} of "
                    f"{cmp['compared']} storm outputs differ from the clean "
                    f"leg (bar: 1 in 16, each at or after its failover "
                    f"token): {cmp['mismatches']}")
        row = dict(rate_multiplier=mult, offered_qps=offered,
                   clean=legs["clean"]["row"],
                   storm=dict(legs["storm"]["row"],
                              done_outputs_match_clean=cmp[
                                  "done_outputs_match_clean"],
                              mismatches=cmp["mismatches"]))
        emit(phase=phase, nvidia_smi=smi, dtype=cfg.dtype,
             model=f"{cfg.family} L{cfg.n_layer} E{cfg.n_embd}",
             replicas=lg_args.replicas, slots=lg_args.slots,
             max_len=lg_args.max_len, requests=lg_args.requests,
             max_new=lg_args.max_new, capacity_req_per_s=capacity,
             **engine_kw, **row)
        rows.append(row)
        fails += gate
    if fails:
        raise AssertionError(f"{phase} ({cfg.dtype}): {fails}")
    tier_profile(fleets["clean"], params, requests, smi, phase, cfg)
    return dict(rows=rows, seconds=time.perf_counter() - t0)


def tier_profile(fleet, params, requests, smi, phase, cfg,
                 n_ticks: int = 10) -> None:
    """``torch.profiler`` over ``n_ticks`` router ticks of ``fleet`` with
    every slot of every replica decoding (after their prefills): the
    device's busy share of a tier tick, its kernels and host ops."""
    from torch.profiler import ProfilerActivity, profile

    n = sum(e.slots for e in fleet.engines().values())
    rids = [fleet.submit(**dict(r, max_new_tokens=64))
            for r in requests[:n]]
    while True:
        before = sum(e.counters["prefill_ticks"]
                     for e in fleet.engines().values())
        fleet.step(params)
        if sum(e.counters["prefill_ticks"]
               for e in fleet.engines().values()) == before:
            break
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_ticks):
            fleet.step(params)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    fleet.run(params)
    for rid in rids:
        fleet.pop_result(rid)
    emit(phase=f"{phase}_profile", nvidia_smi=smi, dtype=cfg.dtype,
         model=f"{cfg.family} L{cfg.n_layer} E{cfg.n_embd}",
         router_ticks=n_ticks, replicas=len(fleet.engines()),
         rows_decoding=n, **profile_summary(prof, wall_ms))


def failover_paths_phase(pk, seed, dev, smi) -> dict:
    """Where a failed-over row's values part from an undisturbed run's:
    one GPT-2 124M block (layer 0's weights as the engine places them) on
    the same rows, once decode-shaped ([4, 1, E] — a decode tick of 4
    slots) and once prefill-shaped (the same rows inside a [4, 64, E]
    chunk — the re-prefill after a failover), in f32 and bf16: ln_1, the
    qkv projection, the attention over the same 70 paged keys (K3 for
    the decode shape, the gather path for the chunk), c_proj and the
    MLP's first product, each op fed the decode shape's own input so
    only the shape differs. Prints each op's largest difference and
    whether it is bit-equal, and the first op that differs."""
    from pytorch_distributed_tpu_torch.config import model_config
    from pytorch_distributed_tpu_torch.models import gpt2
    from pytorch_distributed_tpu_torch.ops.layers import dense, layer_norm
    from pytorch_distributed_tpu_torch.serving import PagedBatchedDecodeEngine

    base = model_config("gpt2")
    params = gpt2.init(torch.Generator().manual_seed(seed), base)
    out = {}
    for dtype in ("float32", "bfloat16"):
        cfg = base.replace(dtype=dtype)
        eng = PagedBatchedDecodeEngine(cfg, slots=4, max_len=1024,
                                       page_size=16)
        bp = eng._place_params(params)["blocks"][0]
        dt = getattr(torch, dtype)
        e, h, d = cfg.n_embd, cfg.n_head, cfg.head_dim
        g = torch.Generator(device=dev).manual_seed(seed)
        at = 5  # the row's position inside the prefill chunk
        chunk = torch.randn(4, 64, e, generator=g, device=dev).to(dt)

        def both(fn, x_chunk):
            # The decode shape's input is the chunk's column ``at``.
            small = fn(x_chunk[:, at:at + 1])
            big = fn(x_chunk)[:, at:at + 1]
            diff = (small.float() - big.float()).abs().max().item()
            return dict(max_abs=diff, bit_equal=torch.equal(small, big))

        rows = {}
        rows["ln_1"] = both(
            lambda x: layer_norm(x, bp["ln_1"],
                                 eps=cfg.layer_norm_epsilon), chunk)
        a = layer_norm(chunk, bp["ln_1"], eps=cfg.layer_norm_epsilon)
        rows["c_attn"] = both(lambda x: dense(x, bp["attn"]["c_attn"]), a)
        # Attention: 70 keys per row in pages 1..5 of each row's table;
        # the decode query sits at position 69, the chunk covers 6..69.
        n_pool = 4 * 5 + 1
        kp = torch.randn(n_pool, 16, h, d, generator=g, device=dev).to(dt)
        vp = torch.randn(n_pool, 16, h, d, generator=g, device=dev).to(dt)
        tables = (torch.arange(4 * 5, device=dev).reshape(4, 5) + 1
                  ).to(torch.int32)
        tables = torch.cat([tables, torch.zeros(4, 59, dtype=torch.int32,
                                                device=dev)], 1)
        q = torch.randn(4, 64, h, d, generator=g, device=dev).to(dt)
        dec = pk.paged_decode_attention(
            q[:, 63].contiguous(), kp, vp, tables,
            torch.full((4,), 69, dtype=torch.int32, device=dev))
        pre = pk.gather_attention(
            q, kp, vp, tables,
            torch.full((4,), 6, dtype=torch.int32, device=dev))[:, 63]
        rows["attention"] = dict(
            max_abs=(dec.float() - pre.float()).abs().max().item(),
            bit_equal=torch.equal(dec, pre))
        o = torch.randn(4, 64, e, generator=g, device=dev).to(dt)
        rows["c_proj"] = both(lambda x: dense(x, bp["attn"]["c_proj"]), o)
        rows["c_fc"] = both(lambda x: dense(x, bp["mlp"]["c_fc"]), a)
        first = next((name for name, r in rows.items()
                      if not r["bit_equal"]), None)
        out[dtype] = dict(ops=rows, first_differing=first)
        emit(phase="failover_paths", nvidia_smi=smi, dtype=dtype,
             model="gpt2 L12 E768 block 0", decode_shape=[4, 1, e],
             prefill_shape=[4, 64, e], **out[dtype])
    return out


def tier_storm_args(replicas: int, rates: list[float]):
    from pytorch_distributed_tpu_torch.serving import loadgen

    return loadgen.parse_args([
        "--replicas", str(replicas), "--slots", "4", "--max-len", "1024",
        "--requests", "40", "--max-new", "24", "--device", "cuda",
        "--rates", *map(str, rates)])


def tier_storm_phase(pk, seed, smi) -> dict:
    """GPT-2 124M at full width, 4 replicas x 4 slots, max_len 1024, 40
    requests (prompts 4-341 tokens, 24 new; the workload's greedy/sampled
    cycle), the loadgen twin's kill schedule, rates 0.5 and 2.0 of the
    calibrated capacity; in f32 and in bf16 (``tier_legs``)."""
    from pytorch_distributed_tpu_torch.config import model_config
    from pytorch_distributed_tpu_torch.models import gpt2

    base = model_config("gpt2")
    params = gpt2.init(torch.Generator().manual_seed(seed), base)
    lg_args = tier_storm_args(4, [0.5, 2.0])
    return {dtype: tier_legs(pk, base.replace(dtype=dtype), params, lg_args,
                             smi, "tier_storm")
            for dtype in ("float32", "bfloat16")}


def tier_llama_q8_phase(pk, seed, dev, smi) -> dict:
    """Llama-3.2-1B at full width with int8 KV pages and weights (K4),
    2 replicas x 4 slots, max_len 1024, 40 requests, rate 1.0, clean and
    storm (``tier_legs``; bf16, so the output match is reported)."""
    from pytorch_distributed_tpu_torch.config import model_config
    from pytorch_distributed_tpu_torch.models import llama

    cfg = model_config("llama3-1b")
    params = llama.init(torch.Generator(device=dev).manual_seed(seed), cfg,
                        device=dev)
    return tier_legs(pk, cfg, params, tier_storm_args(2, [1.0]), smi,
                     "tier_llama_q8", engine_kw=Q8)


# -- generation outside the paged engine: generate, dense, spec, soak, ------
# -- serve_dense ------------------------------------------------------------


def _paged_launches(pk, phase) -> dict:
    """K3/K4 launches since the last reset: the dense and serial engines
    never run them, and a speculating paged engine's verify forward is
    K+1 queries wide, so it takes the gather path (as the JAX package's
    multi-query windows do)."""
    got = {"K3": pk.launches, "K4": pk.launches_q8}
    if got != {"K3": 0, "K4": 0}:
        raise AssertionError(f"{phase}: K3/K4 launched {got}, want 0")
    return got


def drive_engine(eng, params, reqs) -> dict:
    """One drive of ``reqs`` through a warmed batched engine: tokens by
    request index, and the host-clock metrics (pure decode tick ms, the
    ms of a step that prefilled, generated tok/s, TTFT p50) with the
    engine's counters."""
    rids = [eng.submit(**r) for r in reqs]
    plen = {rid: len(r["prompt"]) for rid, r in zip(rids, reqs)}
    ttft: dict[int, float] = {}
    decode_ms, prefill_ms = [], []
    t0 = time.perf_counter()
    while eng.has_work():
        c0 = dict(eng.counters)
        s = time.perf_counter()
        eng.step(params)
        e = time.perf_counter()
        if eng.counters["prefill_ticks"] > c0["prefill_ticks"]:
            prefill_ms.append((e - s) * 1e3)
        elif eng.counters["decode_ticks"] > c0["decode_ticks"]:
            decode_ms.append((e - s) * 1e3)
        for rid in rids:
            if rid not in ttft:
                toks = eng.peek_tokens(rid)
                if toks is not None and len(toks) > plen[rid]:
                    ttft[rid] = (e - t0) * 1e3
    wall = time.perf_counter() - t0
    results = [eng.pop_result(rid) for rid in rids]
    bad = [r.state for r in results if r.state != "DONE"]
    if bad:
        raise AssertionError(f"requests not DONE: {bad}")
    generated = sum(len(r.tokens) - plen[rid]
                    for rid, r in zip(rids, results))
    c = eng.counters
    return dict(
        tokens=[np.asarray(r.tokens) for r in results],
        metrics=dict(
            generated_tokens=generated, wall_s=wall,
            generated_tok_per_s=generated / wall,
            mean_decode_tick_ms=(statistics.fmean(decode_ms)
                                 if decode_ms else None),
            pure_decode_ticks=len(decode_ms),
            mean_prefill_step_ms=statistics.fmean(prefill_ms),
            ttft_p50_ms=statistics.median(ttft.values()),
            decode_ticks=c["decode_ticks"], prefill_ticks=c["prefill_ticks"],
            drafted_tokens=c["drafted_tokens"],
            accepted_tokens=c["accepted_tokens"],
            spec_commits=c["spec_commits"],
            accept_rate=eng.stats()["spec_accept_rate"],
            committed_per_row_tick=(
                (c["accepted_tokens"] + c["spec_commits"]) / c["spec_commits"]
                if c["spec_commits"] else None),
            # Each request's first token comes from its prefill.
            committed_per_decode_tick=(generated - len(reqs))
            / max(1, c["decode_ticks"]),
            cache_bytes=eng.cache_hbm_bytes()["allocated"],
        ),
    )


def _same(a, b) -> int:
    return sum(np.array_equal(x, y) for x, y in zip(a, b))


def generate_phase(pk, seed, smi) -> dict:
    """The generation entry point's functions (``serving.generate``) at
    full width: GPT-2 124M, random weights from ``seed``, a 64-token
    prompt, 64 new tokens. In f32 (gated) and bf16 (reported): the twin's
    greedy ``decode.generate``, ``generate_monolithic`` and ``--stream``
    (``DecodeEngine.stream``) token-equal; a warm ``DecodeEngine`` timed
    over three 64-token requests. A sampled run repeated with the same
    seed gives the same tokens. MoE: GPT-2 124M with 8 experts top-2
    (``--n-experts 8 --moe-top-k 2``), 8 prompts of 32 tokens, 32 new
    tokens each, at B 1 and at B 4: f32 rows equal on >= 7 of 8 (a row's
    tokens do not depend on its batch at the no-drop capacity; the card's
    products of another M may round a near-tie the other way), bf16
    reported. K3/K4 launch 0 times."""
    from pytorch_distributed_tpu_torch.models import decode
    from pytorch_distributed_tpu_torch.serving import generate as gen
    from pytorch_distributed_tpu_torch.serving.engine import DecodeEngine

    rng = np.random.default_rng(seed)
    base = ["--preset", "gpt2", "--max-new-tokens", "64", "--seed",
            str(seed), "--prompt-ids",
            ",".join(str(t) for t in rng.integers(0, 50257, 64))]
    args = gen.parse_args(base)
    cfg, params = gen.load_params(args)
    ids = gen.prompt_ids(args)
    pk.launches = pk.launches_q8 = 0
    rows = {}
    for dtype in ("float32", "bfloat16"):
        c = cfg.replace(dtype=dtype)
        twin = gen.generate_ids(args, c, params, ids)
        mono = decode.generate_monolithic(params, ids, c, 64)[0]
        streamed = gen.generate_ids(gen.parse_args(base + ["--stream"]), c,
                                    params, ids)
        eng = DecodeEngine(c, max_len=128)
        eng.generate(params, ids, 64)
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng.generate(params, ids, 64)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        req_s = statistics.median(times)
        rows[dtype] = dict(
            generate_eq_monolithic=bool(np.array_equal(
                twin, mono.cpu().numpy())),
            stream_eq_generate=bool(np.array_equal(streamed, twin)),
            request_s=req_s, ms_per_token=req_s / 64 * 1e3,
            tok_per_s=64 / req_s, request_s_runs=times)
    samp = base + ["--temperature", "0.8", "--top-k", "50", "--top-p",
                   "0.95"]
    a = gen.generate_ids(gen.parse_args(samp), cfg, params, ids)
    b = gen.generate_ids(gen.parse_args(samp), cfg, params, ids)
    sampled = dict(repeat_equal=bool(np.array_equal(a, b)),
                   differs_from_greedy=not np.array_equal(
                       a, gen.generate_ids(args, cfg, params, ids)))
    del params
    margs = gen.parse_args(base + ["--n-experts", "8", "--moe-top-k", "2",
                                   "--max-new-tokens", "32"])
    mcfg, mparams = gen.load_params(margs)
    prompts = rng.integers(0, 50257, (8, 32)).astype(np.int32)
    moe = {}
    for dtype in ("float32", "bfloat16"):
        c = mcfg.replace(dtype=dtype)
        eng = DecodeEngine(c, max_len=64)
        t0 = time.perf_counter()
        b4 = np.concatenate([eng.generate(mparams, prompts[i:i + 4], 32)
                             .cpu().numpy() for i in (0, 4)])
        b4_s = time.perf_counter() - t0
        b1 = [eng.generate(mparams, prompts[i:i + 1], 32)[0].cpu().numpy()
              for i in range(8)]
        moe[dtype] = dict(rows_equal_b1_b4=_same(b1, b4), of=8,
                          b4_tok_per_s=8 * 32 / b4_s)
    del mparams
    row = dict(phase="generate", nvidia_smi=smi, model="gpt2 L12 E768",
               prompt_len=64, new_tokens=64, greedy=rows, sampled=sampled,
               moe=dict(model="gpt2 L12 E768, 8 experts top-2", **moe),
               launches=_paged_launches(pk, "generate"))
    emit(**row)
    fails = []
    f32 = rows["float32"]
    if not (f32["generate_eq_monolithic"] and f32["stream_eq_generate"]):
        fails.append(f"f32 generate/monolithic/stream differ: {f32}")
    if not sampled["repeat_equal"]:
        fails.append("a sampled run repeated with its seed differs")
    if moe["float32"]["rows_equal_b1_b4"] < 7:
        fails.append(f"MoE f32 B 1 vs B 4: {moe['float32']}")
    if fails:
        raise AssertionError(f"generate: {fails}")
    return row


def dense_phase(pk, cfg, params, reqs, paged_f32_tokens, smi) -> dict:
    """The dense ``BatchedDecodeEngine`` at full width (GPT-2 124M, 8 slots,
    max_len 1024, buckets 64-1024): the serve phase's 16 requests in f32,
    token-equal to the paged engine's f32 kernel drive on >= 15 of 16
    (gated), then in bf16 (tick ms, tok/s, TTFT p50, cache bytes); a
    profile of ten decode ticks; the dense prefill's values independent
    of the rows beside it (bf16: a 40-token prompt's K/V alone and beside
    three others, bit-equal). K3/K4 launch 0 times."""
    from pytorch_distributed_tpu_torch.serving.engine import (
        BatchedDecodeEngine,
        BucketSpec,
    )

    def engine(c):
        eng = BatchedDecodeEngine(c, slots=8, max_len=1024,
                                  buckets=BucketSpec.powers_of_two(1024, 64))
        eng.warmup(params)
        return eng

    pk.launches = pk.launches_q8 = 0
    f32 = drive_engine(engine(cfg.replace(dtype="float32")), params, reqs)
    same = _same(f32["tokens"], [paged_f32_tokens[r] for r in
                                 sorted(paged_f32_tokens)])
    bf16 = drive_engine(engine(cfg), params, reqs)
    profile_phase(cfg, params, reqs, phase="dense_profile",
                  engine=engine(cfg))
    rng = np.random.default_rng(1)
    x = rng.integers(0, cfg.vocab_size, 40)
    kv = []
    for others in ((), (50, 20, 60)):
        eng = BatchedDecodeEngine(cfg, slots=8, max_len=1024,
                                  buckets=BucketSpec((64,)))
        for n in others:
            eng.submit(rng.integers(0, cfg.vocab_size, n), 4)
        rid = eng.submit(x, 4)
        eng.step(params)
        row = next(i for i, s in enumerate(eng._slots)
                   if s is not None and s.rid == rid)
        kv.append([eng._cache[n][:, row, :40].clone() for n in ("k", "v")])
        del eng
    neighbours = all(torch.equal(a, b) for a, b in zip(*kv))
    out = dict(phase="dense", nvidia_smi=smi, model="gpt2 L12 E768",
               slots=8, max_len=1024, requests=len(reqs),
               f32_identical_to_paged=same, of=len(reqs),
               f32=f32["metrics"], bf16=bf16["metrics"],
               prefill_independent_of_neighbours_bf16=neighbours,
               launches=_paged_launches(pk, "dense"))
    emit(**out)
    if same < 15 or not neighbours:
        raise AssertionError(
            f"dense: f32 dense vs paged {same}/{len(reqs)} identical, "
            f"prefill independent of neighbours: {neighbours}")
    return out


def spec_streams(cfg, seed) -> dict:
    """The spec phase's two greedy streams of 16 requests, 32 new tokens
    each: ``repetitive`` (patterns of 2-5 tokens tiled 3-6 times:
    prompt lookup should win) and ``random`` (prompts of 16-256 random
    tokens: it should lose)."""
    from pytorch_distributed_tpu_torch.serving import workload as wl

    return {
        "repetitive": wl.repetitive_request_stream(
            np.random.default_rng(seed), n=16, vocab_size=cfg.vocab_size,
            max_new=32),
        "random": wl.request_stream(
            np.random.default_rng(seed + 1), n=16,
            vocab_size=cfg.vocab_size, prompt_len=(16, 256), max_new=32,
            sampling_cycle=(dict(),)),
    }


def spec_pair(pk, make, c, params, reqs, phase) -> dict:
    """Plain vs ``speculative_k=4, spec_ngram=2`` on one engine kind, dtype
    and stream: identical requests, the spec drive's K3/K4 launches
    (checked at 0), and each drive's metrics."""
    plain = make(c, 0)
    plain.warmup(params)
    p = drive_engine(plain, params, reqs)
    spec = make(c, 4)
    spec.warmup(params)
    pk.launches = pk.launches_q8 = 0
    s = drive_engine(spec, params, reqs)
    launches = _paged_launches(pk, phase)
    return dict(identical=_same(p["tokens"], s["tokens"]), of=len(reqs),
                launches=launches, plain=p["metrics"], spec=s["metrics"],
                spec_vs_plain_tok_per_s=(
                    s["metrics"]["generated_tok_per_s"]
                    / p["metrics"]["generated_tok_per_s"]))


def spec_phase(pk, seed, dev, smi) -> dict:
    """Batched speculative decoding (``speculative_k=4``, ``spec_ngram=2``)
    at full width: GPT-2 124M on the dense and the paged engine (8 slots,
    max_len 1024) in f32 and bf16, and Llama-3.2-1B on the paged engine
    with int8 KV pages and weights (the JAX test
    ``test_spec_int8_pages_match_plain_int8`` at full width), each on the
    ``repetitive`` and ``random`` streams (``spec_streams``): spec vs
    plain token-equal on >= 15 of 16 in f32 (gated; bf16 reported),
    K3/K4 launched 0 times by every spec drive, accept rate, committed
    tokens per row-tick, decode ticks, tok/s and TTFT of spec against
    plain. Then the rollback check: a paged bf16 spec engine publishes a
    128-token prefix (two 64-token chunks), and four borrowers of that
    prefix speculating with mostly rejected drafts leave its pages
    bit-unchanged (gated) and produce the tokens that each borrower gets
    alone from a fresh engine with the same drafts, which shares nothing
    (gated, 4 of 4). The launches line sums the K3/K4 counts of every spec
    drive and of the rollback check."""
    from pytorch_distributed_tpu_torch.config import model_config
    from pytorch_distributed_tpu_torch.models import gpt2, llama
    from pytorch_distributed_tpu_torch.serving.engine import (
        BatchedDecodeEngine,
        BucketSpec,
        PagedBatchedDecodeEngine,
    )

    def dense(c, k, **kw):
        return BatchedDecodeEngine(c, slots=8, max_len=1024,
                                   buckets=BucketSpec.powers_of_two(1024, 64),
                                   speculative_k=k, **kw)

    def paged(c, k, **kw):
        return PagedBatchedDecodeEngine(c, slots=8, max_len=1024,
                                        page_size=16, speculative_k=k, **kw)

    cfg = model_config("gpt2")
    params = gpt2.init(torch.Generator().manual_seed(seed), cfg)
    streams = spec_streams(cfg, seed)
    rows, fails = {}, []
    for kind, make in (("dense", dense), ("paged", paged)):
        for dtype in ("float32", "bfloat16"):
            for name, reqs in streams.items():
                key = f"gpt2_{kind}_{dtype}_{name}"
                rows[key] = spec_pair(pk, make, cfg.replace(dtype=dtype),
                                      params, reqs, f"spec {key}")
                emit(phase="spec", run=key, nvidia_smi=smi, **rows[key])
                if dtype == "float32" and rows[key]["identical"] < 15:
                    fails.append(f"{key}: {rows[key]['identical']}/16")

    # Rollback on the in-place pool: published pages stay bit-unchanged.
    c = cfg

    def rejected(h, k):
        return (h[-k:] + 1) % c.vocab_size

    eng = paged(c, 4, draft_hook=rejected)
    eng.warmup(params)
    pk.launches = pk.launches_q8 = 0
    rng = np.random.default_rng(seed + 2)
    prefix = rng.integers(0, c.vocab_size, 128).astype(np.int32)
    eng.run(params, [dict(prompt=prefix, max_new_tokens=4)])
    cached = sorted(eng.pool.cached_page_ids())
    before = {n: t[:, cached].clone() for n, t in eng._cache.items()}
    borrowers = [dict(prompt=np.concatenate(
        [prefix, rng.integers(0, c.vocab_size, 8 + i)]).astype(np.int32),
        max_new_tokens=32) for i in range(4)]
    got = eng.run(params, borrowers)
    unchanged = all(torch.equal(eng._cache[n][:, cached], t)
                    for n, t in before.items())
    alone = []
    for b in borrowers:
        ref = paged(c, 4, draft_hook=rejected)
        alone.append(next(iter(ref.run(params, [b]).values())).tokens)
        del ref
    rollback = dict(
        cached_pages=len(cached), prefix_hits=eng.pool.stats["prefix_hits"],
        drafted=eng.counters["drafted_tokens"],
        accepted=eng.counters["accepted_tokens"],
        published_pages_unchanged=unchanged,
        borrowers_equal_unshared=_same(
            [got[r].tokens for r in sorted(got)], alone),
        launches=_paged_launches(pk, "spec_rollback"))
    emit(phase="spec_rollback", nvidia_smi=smi, **rollback)
    if (not unchanged or rollback["prefix_hits"] < 4 or not cached
            or rollback["borrowers_equal_unshared"] != len(borrowers)):
        fails.append(f"rollback: {rollback}")
    del params, eng

    lcfg = model_config("llama3-1b")
    lparams = llama.init(torch.Generator(device=dev).manual_seed(seed), lcfg,
                         device=dev)
    lstreams = spec_streams(lcfg, seed)
    for dtype in ("float32", "bfloat16"):
        for name, reqs in lstreams.items():
            key = f"llama_paged_q8_{dtype}_{name}"
            rows[key] = spec_pair(
                pk, lambda c, k: paged(c, k, **Q8),
                lcfg.replace(dtype=dtype), lparams, reqs, f"spec {key}")
            emit(phase="spec", run=key, nvidia_smi=smi, **rows[key])
            if dtype == "float32" and rows[key]["identical"] < 15:
                fails.append(f"{key}: {rows[key]['identical']}/16")
    del lparams
    if fails:
        raise AssertionError(f"spec: {fails}")
    measured = [r["launches"] for r in rows.values()] + [rollback["launches"]]
    return dict(rows=rows, rollback=rollback,
                launches={kid: sum(m[kid] for m in measured)
                          for kid in ("K3", "K4")})


def soak_phase(pk, seed, smi) -> dict:
    """The soak twin (``serving.soak``'s ``run_soak``) at full width:
    GPT-2 124M in f32, 4 slots, its default storm of 200 requests (the
    JAX script's schedule, max_len 32), an engine loss at tick 60. All
    five invariants gated; K3/K4 0."""
    from pytorch_distributed_tpu_torch.config import model_config
    from pytorch_distributed_tpu_torch.models import gpt2
    from pytorch_distributed_tpu_torch.serving import soak

    cfg = model_config("gpt2", dtype="float32")
    params = gpt2.init(torch.Generator().manual_seed(seed), cfg)
    args = soak.parse_args(["--seed", str(seed)])
    pk.launches = pk.launches_q8 = 0
    t0 = time.perf_counter()
    report = soak.run_soak(args, cfg=cfg, params=params)
    report.update(wall_s=time.perf_counter() - t0,
                  launches=_paged_launches(pk, "soak"))
    emit(phase="soak", nvidia_smi=smi, model="gpt2 L12 E768 f32", **report)
    if not report["ok"]:
        raise AssertionError(f"soak: {report['invariant_failures']}")
    return report


def serve_dense_phase(pk, seed, smi) -> dict:
    """``serve --dense`` on the card: ``serving.serve``'s own ``build`` with
    2 dense GPT-2 124M bf16 replicas x 4 slots, max_len 1024, on
    127.0.0.1 port 0. A greedy 64-token SSE stream whose replica is
    killed after its first token ends DONE with 64 tokens; /healthz shows
    the replica DOWN, /admin/restart brings it back HEALTHY. K3/K4 0."""
    from pytorch_distributed_tpu_torch.serving import serve

    args = serve.parse_args([
        "--preset", "gpt2", "--dense", "--replicas", "2", "--slots", "4",
        "--max-len", "1024", "--host", "127.0.0.1", "--port", "0",
        "--seed", str(seed)])
    cfg, params, router, server = serve.build(args)
    prompt = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, 48).tolist()
    pk.launches = pk.launches_q8 = 0
    with serve.serve_in_thread(server) as (host, port):
        killed = {}

        def kill_serving_replica():
            _, _, health = _http_json(host, port, "GET", "/healthz")
            busy = [int(i) for i, r in health["replicas"].items()
                    if r.get("active_rows", 0) + r.get("queue_depth", 0)]
            status, _, body = _http_json(host, port, "POST", "/admin/kill",
                                         {"replica": busy[0]})
            killed.update(replica=busy[0], status=status)

        tokens, done, ttft, latency = _sse_stream(
            host, port, dict(prompt=prompt, max_new_tokens=64),
            on_first_token=kill_serving_replica)
        _, _, health = _http_json(host, port, "GET", "/healthz")
        down = health["replicas"][str(killed["replica"])]["state"]
        _, _, restarted = _http_json(host, port, "POST", "/admin/restart",
                                     {"replica": killed["replica"]})
        launches = _paged_launches(pk, "serve_dense")
    row = dict(phase="serve_dense", nvidia_smi=smi, model="gpt2 L12 E768",
               dtype=cfg.dtype, replicas=2, slots=4, max_len=1024,
               engine=type(router.engines()[0]).__name__,
               stream_tokens=len(tokens), done_state=done and done["state"],
               first_token_s=ttft, request_s=latency, killed=killed,
               state_after_kill=down,
               state_after_restart=restarted["states"][
                   str(killed["replica"])],
               router_counters=router.counters, launches=launches)
    emit(**row)
    if (killed.get("status") != 200 or down != "DOWN"
            or done is None or done["state"] != "DONE" or len(tokens) != 64
            or row["state_after_restart"] != "HEALTHY"
            or router.counters["failovers"] != 1
            or row["engine"] != "BatchedDecodeEngine"):
        raise AssertionError(f"serve_dense: {row}")
    return row


FLASH_SOURCE = "pytorch_distributed_tpu_torch/csrc/flash_attention.cu"


def flash_bound(q, k, causal: bool, backward: bool) -> tuple[float, str]:
    """Least time for flash attention on these inputs: each input read and
    each output written once over the HBM rate (forward: q, k, v in, o and
    lse out; backward: q, k, v, o, do and lse in, dq, dk, dv out), or its
    products over the peak rate for the input type (forward: QK^T and PV;
    backward: the five products of the fused backward), counted over the
    (query, key) pairs the mask keeps — whichever is larger."""
    b, h, t, d = q.shape
    hkv = k.shape[1]
    item = q.element_size()
    pairs = t * (t + 1) // 2 if causal else t * t
    rows = b * h * t
    if backward:
        nbytes = (4 * b * h + 4 * b * hkv) * t * d * item + rows * 4
        ops = 10 * b * h * d * pairs
    else:
        nbytes = (2 * b * h + 2 * b * hkv) * t * d * item + rows * 4
        ops = 4 * b * h * d * pairs
    rate = BF16_OPS_PER_S if q.dtype == torch.bfloat16 else F32_OPS_PER_S
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / rate * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def _head_chunks(q, k, chunks: int):
    """``chunks`` slices of the KV heads, each with its query-head group:
    (query-head slice, KV-head slice) pairs."""
    hk = k.shape[1] // chunks
    g = q.shape[1] // k.shape[1]
    return [(slice(i * hk * g, (i + 1) * hk * g), slice(i * hk, (i + 1) * hk))
            for i in range(chunks)]


def plain_forward(fk, q, k, v, causal, chunks: int = 1):
    """The plain version of K1, run on ``chunks`` groups of heads one after
    another (the f32 scores of all 32 heads at T=8192 would take 8.6 GB
    per tensor) and joined: the same values as one call."""
    parts = [fk.flash_forward_reference(q[:, hq], k[:, hk], v[:, hk], causal)
             for hq, hk in _head_chunks(q, k, chunks)]
    return torch.cat([o for o, _ in parts], 1), torch.cat(
        [lse for _, lse in parts], 1)


def plain_backward(fk, q, k, v, o, lse, do, causal, chunks: int = 1):
    """The plain version of K2 by groups of heads, as ``plain_forward``."""
    parts = [fk.flash_backward_reference(q[:, hq], k[:, hk], v[:, hk],
                                         o[:, hq], lse[:, hq], do[:, hq],
                                         causal)
             for hq, hk in _head_chunks(q, k, chunks)]
    return tuple(torch.cat(x, 1) for x in zip(*parts))


def check_flash(fk, q, k, v, do, causal, what, chunks: int = 1) -> dict:
    """K1 and K2 once each on the inputs against their plain versions
    (``FLASH_TOLERANCES``; bf16 also against the plain versions in f32 on
    the same values), the plain versions run on ``chunks`` groups of heads
    (``plain_forward``). Returns the largest differences per kernel."""
    tol = FLASH_TOLERANCES[q.dtype]
    o, lse = fk.flash_forward(q, k, v, causal)
    grads = fk.flash_backward(q, k, v, o, lse, do, causal)
    torch.cuda.synchronize()
    o_ref, lse_ref = plain_forward(fk, q, k, v, causal, chunks)
    k1 = dict(max_abs_err=check_close(o, o_ref, what=f"{what} K1 o",
                                      **tol["fwd"]),
              lse_max_abs_err=check_close(lse, lse_ref, what=f"{what} K1 lse",
                                          **LSE_TOL),
              **tol["fwd"])
    refs = plain_backward(fk, q, k, v, o, lse, do, causal, chunks)
    k2 = dict(max_abs_err=max(
        check_close(g, r, what=f"{what} K2 {n}", **tol["bwd"])
        for n, g, r in zip(("dq", "dk", "dv"), grads, refs)
    ), **tol["bwd"])
    del o_ref, refs
    if q.dtype == torch.bfloat16:
        f = [x.float() for x in (q, k, v)]
        o32, _ = plain_forward(fk, *f, causal, chunks)
        k1["max_abs_err_vs_f32_plain"] = check_close(
            o, o32, what=f"{what} K1 vs f32 plain", **flash_fwd_bf16_vs_f32(v)
        )
        del o32
        refs32 = plain_backward(fk, *f, o.float(), lse, do.float(), causal,
                                chunks)
        k2["max_abs_err_vs_f32_plain"] = max(
            check_close(g, r, what=f"{what} K2 {n} vs f32 plain",
                        **FLASH_BF16_VS_F32["bwd"])
            for n, g, r in zip(("dq", "dk", "dv"), grads, refs32)
        )
    return dict(K1=k1, K2=k2)


def device_kernels(fn, n: int = 3) -> dict:
    """Each device kernel that ``fn`` launches: the launches a
    ``torch.profiler`` pass over ``n`` calls (after a warm-up call; L2
    warm, so a little below ``time_ms``) recorded, and its mean device ms
    per launch. The trace can miss some of the launches, so the mean is
    taken over those it recorded."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return {e.key[:100]: dict(launches=e.count,
                              ms_per_launch=device_us(e) / e.count / 1e3)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and device_us(e) > 0}


def sdpa_backend(q, k, v, causal: bool, gqa: bool) -> str:
    """The backend ``scaled_dot_product_attention`` picks for these inputs
    (flash, efficient, cudnn or math): its fused kernels do not all show in
    a profiler trace."""
    from torch.nn.attention import SDPBackend

    try:
        choice = torch._fused_sdp_choice(q, k, v, is_causal=causal,
                                         enable_gqa=gqa)
    except (AttributeError, RuntimeError, TypeError) as exc:
        return f"unknown ({type(exc).__name__})"
    return SDPBackend(choice).name


def time_flash(fk, q, k, v, do, causal, flush, chunks: int = 1) -> dict:
    """Kernel, plain-version and library times of K1 and K2 on the inputs
    (ms, CUDA events, L2 flushed before each launch). The library call is
    ``scaled_dot_product_attention`` (forward; its backward through
    autograd): a yardstick the port never calls. ``kernels_ms`` and
    ``library_kernels`` break both down by device kernel (one profiler
    pass each); ``library_backend`` is the SDPA backend that was timed."""
    import torch.nn.functional as F

    o, lse = fk.flash_forward(q, k, v, causal)
    gqa = q.shape[1] != k.shape[1]
    lq, lk, lv = (x.detach().requires_grad_() for x in (q, k, v))
    lib_o = F.scaled_dot_product_attention(lq, lk, lv, is_causal=causal,
                                           enable_gqa=gqa)

    def lib_fwd():
        return F.scaled_dot_product_attention(q, k, v, is_causal=causal,
                                              enable_gqa=gqa)

    def lib_bwd():
        return torch.autograd.grad(lib_o, (lq, lk, lv), do,
                                   retain_graph=True)

    out = dict(
        K1=dict(
            ms=time_ms(lambda: fk.flash_forward(q, k, v, causal), flush),
            plain_ms=time_ms(
                lambda: plain_forward(fk, q, k, v, causal, chunks), flush,
                n=5),
            library_ms=time_ms(lib_fwd, flush),
            kernels_ms=device_kernels(
                lambda: fk.flash_forward(q, k, v, causal)),
            library_kernels=device_kernels(lib_fwd),
            library_backend=sdpa_backend(q, k, v, causal, gqa),
        ),
        K2=dict(
            ms=time_ms(lambda: fk.flash_backward(q, k, v, o, lse, do, causal),
                       flush),
            plain_ms=time_ms(lambda: plain_backward(
                fk, q, k, v, o, lse, do, causal, chunks), flush, n=5),
            library_ms=time_ms(lib_bwd, flush),
            kernels_ms=device_kernels(
                lambda: fk.flash_backward(q, k, v, o, lse, do, causal)),
            library_kernels=device_kernels(lib_bwd),
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


def train_setup(cfg, tcfg, b, t, seed, dev, draw_on="cpu"):
    """Params from ``--seed`` (the family's ``init``, drawn by a generator
    on ``draw_on``: the host for GPT-2, the card for a Llama-3.2-1B
    width), the optimizer, the train state and step, and one fixed batch
    of random token ids."""
    from pytorch_distributed_tpu_torch.models import get_model
    from pytorch_distributed_tpu_torch.train.optim import make_optimizer
    from pytorch_distributed_tpu_torch.train.state import init_train_state
    from pytorch_distributed_tpu_torch.train.trainer import make_train_step

    model = get_model(cfg)
    params = model.init(torch.Generator(device=draw_on).manual_seed(seed),
                        cfg, device=dev)
    tx = make_optimizer(tcfg)
    g = torch.Generator(device=dev).manual_seed(seed)
    batch = {key: torch.randint(0, cfg.vocab_size, (1, b, t), generator=g,
                                device=dev)
             for key in ("inputs", "targets")}
    return (init_train_state(params, tx),
            make_train_step(model, cfg, tx, seed=seed), batch)


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


# K1 launches per layer and step under each remat mode: the JAX package's
# grad has 3 pallas_calls under full, dots and dots_no_batch (the flash
# forward re-runs in backward: it is no dot to checkpoint_dots), 2 under
# none, names and flash (tests/test_torch_remat_modes.py).
K1_PER_LAYER = {"none": 1, "full": 2, "dots": 2, "dots_no_batch": 2,
                "names": 1, "flash": 1}


def train_remat_phase(fk, cfg, seed, dev, warmup=2, steps=10) -> None:
    """The main path's step under every other remat mode beside "names"
    (train phase): ms/step, peak memory, and the flash launches of the
    timed steps — K1 ``K1_PER_LAYER`` x n_layer x steps, K2 n_layer x
    steps."""
    from pytorch_distributed_tpu_torch.config import TrainConfig

    for mode in ("none", "full", "dots", "dots_no_batch", "flash"):
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
        want = {"forward": cfg.n_layer * steps * K1_PER_LAYER[mode],
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


def train_parity_phase(cfg, seed, dev, b=2, t=1024, draw_on="cpu",
                       phase="train_parity") -> None:
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
                        param_dtype="float32", attention_impl=impl)
        state, step, batch = train_setup(c, tcfg, b, t, seed, dev, draw_on)
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
    emit(phase=phase, B=b, T=t, **res)
    if not (abs(lf - ln) <= 1e-5 * abs(ln) and abs(gf - gn) <= 1e-4 * gn
            and res["params_max_abs_diff"] <= 2 * lr + 1e-6
            and res["params_share_above_1e_6"] <= 1e-4):
        raise AssertionError(f"flash and naive f32 steps disagree: {res}")


def train_profile_phase(run, n_steps: int = 2,
                        phase: str = "train_profile",
                        share_of: str | None = None) -> dict:
    """``torch.profiler`` over ``n_steps`` steps of ``run`` (its step,
    state and batch), then one step in CUDA's sync debug mode: the host
    syncs a step makes. ``share_of``: a regex of kernel names whose share
    of the device time is reported (``matched_share``)."""
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
    summary = profile_summary(prof, wall_ms, share_of)
    emit(phase=phase, steps=n_steps,
         host_syncs_per_step=len(syncs), host_sync_kinds=sorted(set(syncs)),
         **summary)
    return summary


def train_loop_phase(fk, seed, tmp) -> None:
    """The training entry point's path (``python -m
    pytorch_distributed_tpu_torch.train.baseline``), in process through the
    functions its ``main`` uses: GPT-2 124M with the preset's dropout 0.1
    (so training attention runs the naive path and launches no flash
    kernel), bf16, flash + names, synthetic shards, global batch 32 of
    micro-batches 8 (A = 4), T 1024, 8 steps, a checkpoint every 4, the
    loss logged every 2. Then a fresh ``Trainer`` resumes the step-4
    checkpoint (the step-8 one parked, as if the run had died after step
    4) and runs steps 5-8 again: its window losses must equal the
    uninterrupted run's bit for bit. The loss must fall. Then ``evaluate``
    over 4 validation batches: K1 exactly n_layer x 4 launches, K2 none.
    Then a profile of one loop step."""
    import shutil

    from pytorch_distributed_tpu_torch.data import TokenShardLoader
    from pytorch_distributed_tpu_torch.models import get_model
    from pytorch_distributed_tpu_torch.train import baseline
    from pytorch_distributed_tpu_torch.train.trainer import Trainer
    from pytorch_distributed_tpu_torch.utils import tree

    args = baseline.parse_args([
        "--preset", "gpt2", "--global-batch-size", "32",
        "--micro-batch-size", "8", "--seq-len", "1024", "--steps", "8",
        "--save-every", "4", "--log-every", "2", "--eval-batches", "4",
        "--num-train-files", "2", "--seed", str(seed),
        "--data-dir", f"{tmp}/data", "--checkpoint-dir", f"{tmp}/ck",
    ])
    model_cfg = baseline.build_model_cfg(args)
    train_cfg = baseline.build_train_cfg(args)
    paths = baseline.shard_paths(args, model_cfg.vocab_size)
    b, t = args.micro_batch_size, args.seq_len

    def run(resume: bool):
        loader = TokenShardLoader(paths, b, t)
        trainer = Trainer(get_model(model_cfg), model_cfg, train_cfg,
                          device=args.device, log_fn=lambda line: None)
        state = trainer.init_state()
        if resume:
            state = trainer.resume_latest(state, loader=loader)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fk.launches.update(forward=0, backward=0)
        state, hist = trainer.train(loader, state=state)
        return trainer, state, hist, dict(fk.launches)

    t0 = time.perf_counter()
    trainer, state, hist, launches = run(resume=False)
    peak = torch.cuda.max_memory_allocated()
    n_params = sum(p.numel() for p in tree.leaves(state.params))
    flops_per_token = 6 * n_params + 12 * model_cfg.n_layer * \
        model_cfg.n_embd * t
    tokens = train_cfg.global_batch_size * t
    # Window 1 holds the first step's allocations, and a window after a
    # checkpoint its synchronous save: the others are steady.
    steady = [(hist[i]["elapsed_s"] - hist[i - 1]["elapsed_s"]) /
              (hist[i]["step"] - hist[i - 1]["step"])
              for i in range(1, len(hist))
              if hist[i - 1]["step"] % train_cfg.save_every_n_steps]
    ms_step = statistics.median(steady) * 1e3
    tok_s = tokens / (ms_step / 1e3)
    shutil.move(f"{tmp}/ck/checkpoint_step_8", f"{tmp}/parked_step_8")
    _, rstate, rhist, rlaunches = run(resume=True)
    resumed = [h["loss"] for h in rhist]
    uninterrupted = [h["loss"] for h in hist if h["step"] > 4]
    val_loader = TokenShardLoader(
        baseline.val_shard_paths(args, model_cfg.vocab_size), b, t)
    fk.launches.update(forward=0, backward=0)
    val_loss = trainer.evaluate(state, val_loader,
                                max_batches=args.eval_batches)
    eval_launches = dict(fk.launches)
    want_eval = {"forward": model_cfg.n_layer * args.eval_batches,
                 "backward": 0}
    emit(phase="train_loop", preset=args.preset, A=trainer.accum, B=b, T=t,
         steps=train_cfg.num_steps, remat=model_cfg.remat,
         attention_impl=model_cfg.attention_impl,
         pdrop=model_cfg.attn_pdrop, dtype=model_cfg.dtype,
         ms_per_step=ms_step, ms_per_step_windows=[x * 1e3 for x in steady],
         tokens_per_s=tok_s, mfu=tok_s * flops_per_token / BF16_OPS_PER_S,
         flops_per_token=flops_per_token, max_memory_allocated=peak,
         window_losses=[h["loss"] for h in hist], resumed_from_step=4,
         resumed_window_losses=resumed,
         resumed_bitwise=resumed == uninterrupted,
         resumed_max_rel_diff=max(abs(a - c) / abs(c) for a, c in
                                  zip(resumed, uninterrupted)),
         train_launches=launches, resumed_train_launches=rlaunches,
         val_loss=val_loss, eval_launches=eval_launches,
         want_eval_launches=want_eval,
         wall_s=time.perf_counter() - t0)
    if rstate.step != 8 or len(resumed) != len(uninterrupted):
        raise AssertionError(f"the resumed run ended at step {rstate.step} "
                             f"with windows {resumed}")
    if resumed != uninterrupted:
        raise AssertionError(
            f"resumed window losses {resumed} != the uninterrupted run's "
            f"{uninterrupted}: the resumed steps are not bit for bit")
    losses = [h["loss"] for h in hist]
    if not (np.isfinite([*losses, val_loss]).all() and losses[-1] <
            losses[0]):
        raise AssertionError(f"the loop's loss did not fall: {losses}")
    if launches != {"forward": 0, "backward": 0}:
        raise AssertionError(
            f"training with attn_pdrop > 0 launched flash kernels "
            f"{launches}: it must take the naive path")
    if eval_launches != want_eval:
        raise AssertionError(f"eval launched {eval_launches}, want "
                             f"{want_eval}")
    group = next(trainer._grouped_batches(TokenShardLoader(paths, b, t)))
    train_profile_phase(dict(step=trainer.train_step, state=state,
                             batch=trainer.put_batch(group)), n_steps=1,
                        phase="train_loop_profile")


def _dropout_grads(cfg, params, batch, key):
    """Loss and gradients of one forward (training mode with ``key`` the
    dropout stream; ``key`` None: deterministic) with a fresh copy of
    ``params``' leaves."""
    from pytorch_distributed_tpu_torch.models import get_model
    from pytorch_distributed_tpu_torch.train.trainer import _loss
    from pytorch_distributed_tpu_torch.utils import tree

    leaves = [p.detach().clone().requires_grad_()
              for p in tree.leaves(params)]
    loss = _loss(get_model(cfg), cfg, tree.unflatten(params, leaves),
                 batch["inputs"][0], batch["targets"][0],
                 deterministic=key is None, key=key)
    return loss.detach(), torch.autograd.grad(loss, leaves)


def train_dropout_phase(cfg, seed, dev) -> None:
    """Dropout at full width (GPT-2 124M, every *_pdrop 0.1). (1) Two steps
    of A = 2 micro-batches of [4, 1024], bf16, names: every mask recorded
    through the seam; each site's keep fraction (embedding, attention,
    residual) within 5 standard errors of 0.9; the masks of two layers,
    two steps and two micro-batches differ. (2) One f32 forward and
    backward ([2, 1024]) under each remat mode: every gradient equals mode
    none's within 1e-5 of that leaf's largest (the recompute draws the
    same masks; measured bit-equal)."""
    from pytorch_distributed_tpu_torch.models import get_model, gpt2
    from pytorch_distributed_tpu_torch.config import TrainConfig
    from pytorch_distributed_tpu_torch.train.optim import make_optimizer
    from pytorch_distributed_tpu_torch.train.state import init_train_state
    from pytorch_distributed_tpu_torch.train.trainer import make_train_step
    from pytorch_distributed_tpu_torch.utils import prng

    draw = prng.draw_keep_mask
    kept, heads = {}, {}

    def record(sid, shape, keep, device):
        m = draw(sid, shape, keep, device)
        if sid not in heads:  # the recompute draws each block mask again
            site = "resid" if sid.site.startswith("resid") else sid.site
            n, k = kept.get(site, (0, 0))
            kept[site] = (n + m.numel(), k + int(m.sum()))
            heads[sid] = m.reshape(-1)[:1 << 20].clone()
        return m

    c = cfg.replace(remat="names")
    tx = make_optimizer(TrainConfig(learning_rate=3e-4))
    state = init_train_state(
        gpt2.init(torch.Generator().manual_seed(seed), c, device=dev), tx)
    step = make_train_step(get_model(c), c, tx, seed=seed)
    g = torch.Generator(device=dev).manual_seed(seed)
    prng.draw_keep_mask = record
    try:
        for _ in range(2):
            batch = {k: torch.randint(0, c.vocab_size, (2, 4, 1024),
                                      generator=g, device=dev)
                     for k in ("inputs", "targets")}
            state, _ = step(state, batch)
    finally:
        prng.draw_keep_mask = draw
    fractions = {site: k / n for site, (n, k) in kept.items()}
    within = {site: abs(f - 0.9) / (0.09 / kept[site][0]) ** 0.5
              for site, f in fractions.items()}
    pairs = {
        "layers": (prng.StreamId(seed, 0, 0, 0, "attn"),
                   prng.StreamId(seed, 0, 0, 1, "attn")),
        "steps": (prng.StreamId(seed, 0, 0, 5, "resid_mlp"),
                  prng.StreamId(seed, 1, 0, 5, "resid_mlp")),
        "micro_batches": (prng.StreamId(seed, 1, 0, -1, "embd"),
                          prng.StreamId(seed, 1, 1, -1, "embd")),
    }
    differ = {name: not torch.equal(heads[a], heads[b])
              for name, (a, b) in pairs.items()}
    n_masks = len(heads)
    del state, step, heads

    f32 = cfg.replace(dtype="float32", logits_dtype="float32")
    params = gpt2.init(torch.Generator().manual_seed(seed), f32,
                       device=dev)
    batch = {k: torch.randint(0, f32.vocab_size, (1, 2, 1024), generator=g,
                              device=dev) for k in ("inputs", "targets")}
    key = prng.DropoutKey(seed, 0, 0)
    loss0, ref = _dropout_grads(f32.replace(remat="none"), params, batch,
                                key)
    modes = {}
    for mode in ("full", "dots", "dots_no_batch", "names", "flash"):
        loss, grads = _dropout_grads(f32.replace(remat=mode), params, batch,
                                     key)
        modes[mode] = dict(
            loss=float(loss), bitwise=all(torch.equal(a, b)
                                          for a, b in zip(grads, ref)),
            max_rel_diff=max(float((a - b).abs().max() / b.abs().max())
                             for a, b in zip(grads, ref)))
        del grads
    emit(phase="train_dropout", keep_fractions=fractions,
         standard_errors_from_keep=within, masks_drawn=n_masks,
         masks_differ=differ, f32_loss_none=float(loss0), remat=modes)
    if any(x > 5 for x in within.values()) or set(within) != {
            "embd", "attn", "resid"}:
        raise AssertionError(f"keep fractions {fractions} ({within} "
                             f"standard errors from 0.9)")
    if not all(differ.values()):
        raise AssertionError(f"masks repeat: {differ}")
    bad = {m: r for m, r in modes.items() if r["max_rel_diff"] > 1e-5}
    if bad:
        raise AssertionError(f"gradients under remat modes differ from "
                             f"none's: {bad}")


def train_fused_ce_phase(cfg, seed, dev, warmup=2, steps=5) -> None:
    """The fused head + cross-entropy at full width (GPT-2 124M, bf16,
    vocab 50257, dropout 0.1, names, one micro-batch [8, 1024]) against
    the unfused step from the same weights and masks: loss within rtol
    1e-3, every gradient within 2e-2 of its norm (both round the block
    logits to bf16; the unfused head's dW is rounded to bf16 once more,
    and cuBLAS may sum in another order). Then ms/step, peak memory and a
    one-step profile of each; the fused step never holds the [8192, 50257]
    logits (823 MB in bf16, 1.65 GB as the f32 copy the loss reads)."""
    from pytorch_distributed_tpu_torch.config import TrainConfig
    from pytorch_distributed_tpu_torch.models import get_model, gpt2
    from pytorch_distributed_tpu_torch.train.optim import make_optimizer
    from pytorch_distributed_tpu_torch.train.state import init_train_state
    from pytorch_distributed_tpu_torch.train.trainer import make_train_step
    from pytorch_distributed_tpu_torch.utils import prng

    base = cfg.replace(remat="names", logits_dtype="bfloat16")
    g = torch.Generator(device=dev).manual_seed(seed)
    batch = {k: torch.randint(0, base.vocab_size, (1, 8, 1024), generator=g,
                              device=dev) for k in ("inputs", "targets")}
    params = gpt2.init(torch.Generator().manual_seed(seed), base,
                       device=dev)
    key = prng.DropoutKey(seed, 0, 0)
    out, rows = {}, {}
    for fused in (False, True):
        c = base.replace(fused_head_ce=fused)
        out[fused] = _dropout_grads(c, params, batch, key)
    (lu, gu), (lf, gf) = out[False], out[True]
    rel = [float((a.float() - b.float()).norm() / b.float().norm())
           for a, b in zip(gf, gu)]
    del out, gf, gu, params
    for fused in (False, True):
        c = base.replace(fused_head_ce=fused)
        tx = make_optimizer(TrainConfig(learning_rate=3e-4))
        state = init_train_state(
            gpt2.init(torch.Generator().manual_seed(seed), c, device=dev), tx)
        step = make_train_step(get_model(c), c, tx, seed=seed)
        for _ in range(warmup):
            state, m = step(state, batch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for _ in range(steps):
            state, m = step(state, batch)
        loss = float(m["loss"])
        elapsed = time.perf_counter() - t0
        name = "fused" if fused else "unfused"
        rows[name] = dict(
            ms_per_step=elapsed / steps * 1e3, loss=loss,
            max_memory_allocated=torch.cuda.max_memory_allocated())
        train_profile_phase(dict(step=step, state=state, batch=batch),
                            n_steps=1, phase=f"train_{name}_ce_profile")
        del state, step
    logits_bytes = 8 * 1024 * base.vocab_size * 2
    emit(phase="train_fused_ce", loss_unfused=float(lu),
         loss_fused=float(lf), grad_rel_l2_max=max(rel),
         grad_rel_l2_wte=rel[0], steps=rows,
         peak_saved_bytes=(rows["unfused"]["max_memory_allocated"]
                           - rows["fused"]["max_memory_allocated"]),
         bf16_logits_bytes=logits_bytes)
    if not (abs(float(lf) - float(lu)) <= 1e-3 * abs(float(lu))
            and max(rel) < 2e-2):
        raise AssertionError(
            f"fused CE {float(lf)} vs unfused {float(lu)}, gradient "
            f"relative L2 differences up to {max(rel)}")

# The long-context Llama-3.2-1B shapes (GQA group 4, head_dim 64, causal,
# bf16) the llama training phases give K1 and K2: bench_suite rows 6 and 7.
LLAMA_FLASH_SHAPES = ((1, 32, 8, 4096, 64), (1, 32, 8, 8192, 64))


def flash_long_phase(fk, dev, flush, seed) -> dict:
    """K1 and K2 at ``LLAMA_FLASH_SHAPES`` in bf16 against their plain
    versions (run by KV head: ``plain_forward``), with kernel, plain, bound
    and SDPA (``enable_gqa``) times. Returns the timings by T."""
    out = {}
    for b, h, hkv, t, d in LLAMA_FLASH_SHAPES:
        g = torch.Generator(device=dev).manual_seed(seed)
        q, k, v, do = (
            torch.randn(b, n, t, d, generator=g, device=dev).to(
                torch.bfloat16) for n in (h, hkv, hkv, h)
        )
        checked = check_flash(fk, q, k, v, do, True, f"llama T={t} bf16",
                              chunks=hkv)
        timed = time_flash(fk, q, k, v, do, True, flush, chunks=hkv)
        emit(phase="flash_long", shape=f"llama3.2-1B T={t}", B=b, H=h,
             Hkv=hkv, T=t, D=d, causal=True, dtype="bfloat16",
             **{kn: {**checked[kn], **timed[kn]} for kn in ("K1", "K2")})
        out[t] = {kn: {key: timed[kn][key] for key in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
            for kn in ("K1", "K2")}
        del q, k, v, do
    return out


def llama_cfg(**kw):
    """Llama-3.2-1B at full width (16 layers, E 2048, 32/8 heads, F 8192,
    vocab 128256, untied head) as bench_suite rows 6 and 7 train it: bf16
    activations and params, flash attention, the fused head cross-entropy
    with bf16 logits; ``kw`` overrides."""
    from pytorch_distributed_tpu_torch.config import model_config

    return model_config("llama3-1b", **{**dict(
        param_dtype="bfloat16", attention_impl="flash", remat="names",
        fused_head_ce=True, logits_dtype="bfloat16"), **kw})


def train_llama_phase(fk, cfg, seed, dev, *, b=1, t=4096, warmup=2,
                      steps=5, phase="train_llama", at_init=None) -> dict:
    """``steps`` timed steps after ``warmup`` of ``cfg`` on one fixed
    [b, t] batch (weights drawn on the card from ``--seed``): ms/step,
    tok/s, MFU (bench.py's 6N + 12LET flops per token over the bf16 peak,
    N every parameter, embedding and untied head included), peak memory,
    K1/K2 launches (counted from zero over the whole drive: K1
    ``K1_PER_LAYER`` x n_layer x steps, K2 n_layer x steps); the loss must
    fall. Then a one-step profile (device idle share, top kernels).
    ``at_init(state, batch)``: a measurement of the initial state, returned
    as ``at_init``."""
    from pytorch_distributed_tpu_torch.config import TrainConfig
    from pytorch_distributed_tpu_torch.utils import tree

    n = warmup + steps
    tcfg = TrainConfig(global_batch_size=b, micro_batch_size=b, num_steps=n,
                       learning_rate=3e-4)
    state, step, batch = train_setup(cfg, tcfg, b, t, seed, dev,
                                     draw_on=dev)
    n_params = sum(p.numel() for p in tree.leaves(state.params))
    flops_per_token = 6 * n_params + 12 * cfg.n_layer * cfg.n_embd * t
    init = at_init(state, batch) if at_init else None
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fk.launches.update(forward=0, backward=0)
    losses = []
    for _ in range(warmup):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        state, m = step(state, batch)
    loss, grad_norm = float(m["loss"]), float(m["grad_norm"])
    elapsed = time.perf_counter() - t0
    launches = dict(fk.launches)
    want = {"forward": cfg.n_layer * n * K1_PER_LAYER[cfg.remat],
            "backward": cfg.n_layer * n}
    tok_s = steps * b * t / elapsed
    row = dict(B=b, T=t, n_layer=cfg.n_layer, remat=cfg.remat,
               n_experts=cfg.n_experts, ms_per_step=elapsed / steps * 1e3,
               tokens_per_s=tok_s,
               mfu=tok_s * flops_per_token / BF16_OPS_PER_S,
               n_params=n_params, flops_per_token=flops_per_token,
               warmup_losses=losses, loss=loss, grad_norm=grad_norm,
               max_memory_allocated=torch.cuda.max_memory_allocated(),
               launches=launches, want_launches=want,
               launches_per_step={k: v / n for k, v in launches.items()})
    emit(phase=phase, **row)
    if launches != want:
        raise AssertionError(f"{phase}: flash launches {launches} != {want}")
    if not (np.isfinite([*losses, loss]).all() and loss < losses[0]):
        raise AssertionError(f"{phase}: the loss did not fall on the fixed "
                             f"batch: {losses[0]} -> {loss}")
    row["profile"] = train_profile_phase(
        dict(step=step, state=state, batch=batch), n_steps=1,
        phase=f"{phase}_profile")
    return dict(row, step=step, state=state, batch=batch, at_init=init)


# f32 GEMMs (cuBLAS names them sgemm or gemm_f32f32..., with TF32 off): in
# the llama loop step only the unfused head multiplies in f32.
F32_GEMM = r"(?i)sgemm|gemm_f32f32|f32f32_f32f32"


def train_llama_loop_phase(fk, seed, tmp) -> dict:
    """The entry point ``python -m pytorch_distributed_tpu_torch.train.
    baseline --preset llama3-1b`` at its defaults (f32 params, bf16
    activations, flash + names, f32 logits through the unfused head, A = 4
    micro-batches of [8, 1024], synthetic shards), in process through the
    functions its ``main`` uses, for 4 steps logged one by one: ms/step
    (the median of steps 2-4), tok/s, MFU, peak memory, K1/K2 launches
    (16 x 4 micro-batches each per step); the loss must fall. Then a
    one-step profile with the f32 GEMMs' (the head's) share of device
    time."""
    from pytorch_distributed_tpu_torch.data import TokenShardLoader
    from pytorch_distributed_tpu_torch.models import get_model
    from pytorch_distributed_tpu_torch.train import baseline
    from pytorch_distributed_tpu_torch.train.trainer import Trainer
    from pytorch_distributed_tpu_torch.utils import tree

    args = baseline.parse_args([
        "--preset", "llama3-1b", "--steps", "4", "--log-every", "1",
        "--num-train-files", "2", "--seed", str(seed),
        "--data-dir", f"{tmp}/data", "--checkpoint-dir", f"{tmp}/ck",
    ])
    model_cfg = baseline.build_model_cfg(args)
    train_cfg = baseline.build_train_cfg(args)
    paths = baseline.shard_paths(args, model_cfg.vocab_size)
    b, t = args.micro_batch_size, args.seq_len
    loader = TokenShardLoader(paths, b, t)
    trainer = Trainer(get_model(model_cfg), model_cfg, train_cfg,
                      device=args.device, log_fn=lambda line: None)
    state = trainer.init_state()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fk.launches.update(forward=0, backward=0)
    state, hist = trainer.train(loader, state=state)
    launches = dict(fk.launches)
    peak = torch.cuda.max_memory_allocated()
    steps = [(hist[i]["elapsed_s"] - hist[i - 1]["elapsed_s"]) * 1e3
             for i in range(1, len(hist))]
    ms_step = statistics.median(steps)
    n_params = sum(p.numel() for p in tree.leaves(state.params))
    flops_per_token = 6 * n_params + 12 * model_cfg.n_layer * \
        model_cfg.n_embd * t
    tok_s = train_cfg.global_batch_size * t / (ms_step / 1e3)
    accum = trainer.accum
    want = {"forward": model_cfg.n_layer * accum * train_cfg.num_steps,
            "backward": model_cfg.n_layer * accum * train_cfg.num_steps}
    row = dict(preset=args.preset, A=accum, B=b, T=t,
               steps=train_cfg.num_steps, remat=model_cfg.remat,
               attention_impl=model_cfg.attention_impl,
               dtype=model_cfg.dtype, param_dtype=model_cfg.param_dtype,
               logits_dtype=model_cfg.logits_dtype,
               fused_head_ce=model_cfg.fused_head_ce, ms_per_step=ms_step,
               ms_per_step_steps=steps, tokens_per_s=tok_s,
               mfu=tok_s * flops_per_token / BF16_OPS_PER_S,
               n_params=n_params, flops_per_token=flops_per_token,
               max_memory_allocated=peak,
               losses=[h["loss"] for h in hist], launches=launches,
               want_launches=want)
    emit(phase="train_llama_loop", **row)
    losses = row["losses"]
    if launches != want:
        raise AssertionError(f"llama loop: flash launches {launches} != "
                             f"{want}")
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"the llama loop's loss did not fall: {losses}")
    group = next(trainer._grouped_batches(TokenShardLoader(paths, b, t)))
    row["profile"] = train_profile_phase(
        dict(step=trainer.train_step, state=state,
             batch=trainer.put_batch(group)), n_steps=1,
        phase="train_llama_loop_profile", share_of=F32_GEMM)
    return row


def train_llama_remat_phase(fk, seed, dev, n_layer=4, t=4096, warmup=1,
                            steps=3) -> dict:
    """Llama-3.2-1B width at ``n_layer`` layers, B=1, T=``t``: (1) the bf16
    step (``llama_cfg``) under every remat mode: ms/step, peak memory, K1
    launches per step n_layer x ``K1_PER_LAYER``, K2 n_layer; (2) one f32
    forward and backward (unfused f32 head) under each mode: every
    gradient equal to mode none's within 1e-5 of that leaf's largest
    (measured bit-equal for GPT-2 on an H100: the recompute repeats the same
    kernels on the same values); (3) one f32 step through the flash
    kernels and one with naive attention from the same weights
    (``train_parity_phase``'s tolerances, both under ``full`` remat so the
    naive step's [1, 32, T, T] f32 scores live one layer at a time)."""
    from pytorch_distributed_tpu_torch.config import TrainConfig

    base = llama_cfg(n_layer=n_layer)
    rows = {}
    for mode in ("none", "full", "dots", "dots_no_batch", "names", "flash"):
        c = base.replace(remat=mode)
        tcfg = TrainConfig(global_batch_size=1, micro_batch_size=1,
                           num_steps=warmup + steps, learning_rate=3e-4)
        state, step, batch = train_setup(c, tcfg, 1, t, seed, dev,
                                         draw_on=dev)
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
        want = {"forward": n_layer * steps * K1_PER_LAYER[mode],
                "backward": n_layer * steps}
        rows[mode] = dict(ms_per_step=elapsed / steps * 1e3, loss=loss,
                          launches=launches, want_launches=want,
                          max_memory_allocated=(
                              torch.cuda.max_memory_allocated()))
        if launches != want:
            raise AssertionError(
                f"llama remat {mode}: flash launches {launches} != {want}")
        del state, step, batch

    from pytorch_distributed_tpu_torch.models import llama

    f32 = base.replace(dtype="float32", param_dtype="float32",
                       logits_dtype="float32", fused_head_ce=False)
    f32_params = llama.init(torch.Generator(device=dev).manual_seed(seed),
                            f32, device=dev)
    g = torch.Generator(device=dev).manual_seed(seed)
    batch = {k: torch.randint(0, f32.vocab_size, (1, 1, t), generator=g,
                              device=dev) for k in ("inputs", "targets")}
    loss0, ref = _dropout_grads(f32.replace(remat="none"), f32_params, batch,
                                None)
    grads = {}
    for mode in ("full", "dots", "dots_no_batch", "names", "flash"):
        loss, gr = _dropout_grads(f32.replace(remat=mode), f32_params, batch,
                                  None)
        grads[mode] = dict(
            loss=float(loss),
            bitwise=bool(torch.equal(loss, loss0)) and all(
                torch.equal(a, b) for a, b in zip(gr, ref)),
            max_rel_diff=max(float((a - b).abs().max() / b.abs().max())
                             for a, b in zip(gr, ref)))
        del gr
    del ref, f32_params
    emit(phase="train_llama_remat", n_layer=n_layer, B=1, T=t, steps=steps,
         modes=rows, f32_loss_none=float(loss0), f32_grads=grads)
    bad = {m: r for m, r in grads.items() if r["max_rel_diff"] > 1e-5}
    if bad:
        raise AssertionError(f"llama f32 gradients under remat modes differ "
                             f"from none's: {bad}")
    train_parity_phase(base.replace(remat="full"), seed, dev, b=1, t=t,
                       draw_on=dev, phase="train_llama_parity")
    return rows


def moe_dropped_share(model_mod, cfg, params, inputs) -> float:
    """The share of the assignments ``moe_mlp`` drops for capacity, over
    every layer of one forward of ``inputs`` (the block inputs recorded
    through ``model_mod``'s ``moe_mlp``)."""
    from pytorch_distributed_tpu_torch.models import get_model
    from pytorch_distributed_tpu_torch.ops import moe

    real, shares = model_mod.moe_mlp, []

    def recording(x, p, **kw):
        shares.append(moe.dropped_share(
            x, p["router"], top_k=kw["top_k"],
            capacity_factor=kw["capacity_factor"]))
        return real(x, p, **kw)

    model_mod.moe_mlp = recording
    try:
        with torch.no_grad():
            get_model(cfg).apply(params, inputs, cfg)
    finally:
        model_mod.moe_mlp = real
    return float(torch.stack(shares).mean())


def moe_dispatch_agreement(dev, seed) -> dict:
    """``moe_mlp``'s sort and einsum dispatch on the card at shapes where
    "auto" picks einsum (GPT-2 width, 8 dense gelu experts; Llama width, 8
    SwiGLU experts; top-2, capacity 1.25, f32): outputs within 1e-5 of
    their largest magnitude, the aux terms equal (summation order is all
    that differs)."""
    import torch.nn.functional as F

    from pytorch_distributed_tpu_torch.ops import moe

    out = {}
    for name, d, f, n, gated in (("gpt2", 768, 3072, 256, False),
                                 ("llama", 2048, 8192, 128, True)):
        g = torch.Generator(device=dev).manual_seed(seed)
        w = {"router": torch.randn(d, 8, generator=g, device=dev),
             "w_in": torch.randn(8, d, f, generator=g, device=dev) * 0.02,
             "w_out": torch.randn(8, f, d, generator=g, device=dev) * 0.02}
        if gated:
            w["w_gate"] = torch.randn(8, d, f, generator=g, device=dev) * 0.02
        x = torch.randn(1, n, d, generator=g, device=dev)
        act = F.silu if gated else (lambda h: F.gelu(h, approximate="tanh"))
        cap = moe.expert_capacity(n * 2, 8, 1.25)
        auto = ("einsum" if n * 2 * 8 * cap <= moe._AUTO_EINSUM_LIMIT
                else "sort")
        res = {impl: moe.moe_mlp(x, w, activation=act, capacity_factor=1.25,
                                 top_k=2, dispatch_impl=impl)
               for impl in ("einsum", "sort")}
        (oe, ae), (os_, as_) = res["einsum"], res["sort"]
        rel = float((oe - os_).abs().max() / oe.abs().max())
        out[name] = dict(tokens=n, capacity=cap, auto_picks=auto,
                         max_rel_diff=rel,
                         aux_equal=bool(torch.equal(ae, as_)))
        if auto != "einsum" or rel > 1e-5 or not out[name]["aux_equal"]:
            raise AssertionError(f"moe sort vs einsum at {name}: {out[name]}")
    return out


def train_moe_phase(fk, seed, dev) -> dict:
    """MoE training at full width: GPT-2 124M (12 layers, 8 dense gelu
    experts, top-2, capacity 1.25, B=8, T=1024, bf16 over f32 params, flash,
    names, bf16 logits: "auto" picks sort) and Llama-3.2-1B width at 4
    layers with 8 SwiGLU experts, top-2 (Mixtral's routing), bf16 params,
    B=1, T=4096 (sort). Each: ms/step, peak memory, the dropped-assignment
    share over the fixed batch at init and after the steps, K1/K2 launches
    and a falling loss (``train_llama_phase``), and
    two runs of one step's loss and gradients bit-equal. Then sort vs
    einsum on the card (``moe_dispatch_agreement``)."""
    from pytorch_distributed_tpu_torch.config import model_config
    from pytorch_distributed_tpu_torch.models import gpt2, llama

    moe_kw = dict(n_experts=8, moe_top_k=2, expert_capacity_factor=1.25)
    cases = (
        ("gpt2", gpt2, model_config(
            "gpt2", attention_impl="flash", remat="names",
            logits_dtype="bfloat16", attn_pdrop=0.0, resid_pdrop=0.0,
            embd_pdrop=0.0, **moe_kw), 8, 1024),
        ("llama", llama, llama_cfg(n_layer=4, **moe_kw), 1, 4096),
    )
    out = {}
    for name, mod, cfg, b, t in cases:
        def dropped(state, batch, mod=mod, cfg=cfg):
            return moe_dropped_share(mod, cfg, state.params,
                                     batch["inputs"][0])

        run = train_llama_phase(fk, cfg, seed, dev, b=b, t=t, warmup=2,
                                steps=3, phase=f"train_moe_{name}",
                                at_init=dropped)
        state, batch = run.pop("state"), run.pop("batch")
        run.pop("step")
        share = dropped(state, batch)
        runs = [_dropout_grads(cfg, state.params, batch, None)
                for _ in range(2)]
        (l1, g1), (l2, g2) = runs
        bitwise = bool(torch.equal(l1, l2)) and all(
            torch.equal(a, c) for a, c in zip(g1, g2))
        emit(phase=f"train_moe_{name}_checks", dropped_share_at_init=run[
            "at_init"], dropped_share=share, two_runs_bitwise=bitwise,
             loss=float(l1))
        if not bitwise:
            raise AssertionError(f"moe {name}: two runs of one step differ")
        out[name] = dict(run, dropped_share=share, two_runs_bitwise=bitwise)
        del state, batch, runs, g1, g2
    agree = moe_dispatch_agreement(dev, seed)
    emit(phase="train_moe_dispatch", **agree)
    return out


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
    ptxas = {name: ptxas_summary(built["log"])
             for name, built in builds.items()}
    emit(phase="build", wall_s=time.perf_counter() - t0, kernels={
        name: dict(seconds=built["seconds"], cached=built["cached"],
                   ptxas=ptxas[name])
        for name, built in builds.items()
    })
    spilled = [k for k, v in ptxas["flash_attention"].items()
               if "sm90<64>" in k and v["spill_bytes"]]
    if spilled:
        raise AssertionError(f"bf16 flash kernels spill at D 64: {spilled}")
    paged = ptxas["paged_attention"]
    spilled = [k for k, v in paged.items() if v["spill_bytes"]]
    if (len(paged) != 32 and not builds["paged_attention"]["cached"]) or \
            spilled:
        raise AssertionError(
            f"paged kernels: {len(paged)} of 32 instantiations in the "
            f"ptxas log, spilling: {spilled}"
        )

    # 3. kernel at the listed shapes; K3/K4 on two streams at once
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    kernel_phase(pk, dev, flush, args.seed)
    streams_phase(pk, dev, args.seed)

    # 4. serving at full width: GPT-2 124M, bf16 activations, f32 params
    cfg = model_config("gpt2")
    params = gpt2.init(torch.Generator().manual_seed(args.seed), cfg)
    reqs = requests(cfg, args.seed)
    f32 = cfg.replace(dtype="float32")
    f32_tokens = kernel_vs_gather("serve_f32", f32, params, reqs, pk)
    k3 = main_path("serve", cfg, params, reqs, pk, flush)
    profile_phase(cfg, params, reqs)

    # 5. int8 serving (K4): f32 kernel vs gather, then the bf16 main path
    kernel_vs_gather("serve_q8_f32", f32, params, reqs, pk, **Q8)
    k4 = main_path("serve_q8", cfg, params, reqs, pk, flush, **Q8)
    ratio = (k4["metrics"]["pool_bytes"], k3["metrics"]["pool_bytes"])
    emit(phase="serve_q8_pool", pool_bytes_q8=ratio[0],
         pool_bytes_bf16=ratio[1], ratio=ratio[0] / ratio[1])
    if ratio[0] * 128 != ratio[1] * 68:
        raise AssertionError(
            f"int8 pool {ratio[0]} B is not 68/128 of the bf16 pool "
            f"{ratio[1]} B"
        )
    profile_phase(cfg, params, reqs, phase="profile_q8", **Q8)
    quality_phase(f32, params, reqs, f32_tokens, dev)
    del params

    # 6. Llama-3.2-1B at full width (GQA group 4): K4 and K3 drives
    llama_phase(pk, args.seed, dev)

    # 6b. the serving tier through its entry points: the HTTP/SSE twin,
    # the loadgen twin's clean and storm legs (GPT-2 f32 and bf16), and
    # the int8 Llama fleet (K4)
    tier = dict(http=tier_http_phase(pk, args.seed, smi),
                storm=tier_storm_phase(pk, args.seed, smi),
                llama_q8=tier_llama_q8_phase(pk, args.seed, dev, smi))
    failover_paths_phase(pk, args.seed, dev, smi)

    # 6c. generation outside the paged engine: the serial engine and the
    # generate twin, the dense engine, speculative decoding on both
    # batched engines, the soak twin and serve --dense
    slice9 = dict(
        generate=generate_phase(pk, args.seed, smi),
        dense=dense_phase(pk, cfg, gpt2.init(
            torch.Generator().manual_seed(args.seed), cfg), reqs,
            f32_tokens, smi),
        spec=spec_phase(pk, args.seed, dev, smi),
        soak=soak_phase(pk, args.seed, smi),
        serve_dense=serve_dense_phase(pk, args.seed, smi),
    )
    slice9_paths = {name: row["launches"] for name, row in slice9.items()}

    tier_paths = {
        "K3": dict(tier_http=tier["http"]["launches"]["K3"], **{
            f"tier_storm_{dtype}_x{row['rate_multiplier']}_{leg}":
                row[leg]["launches"]["K3"]
            for dtype, legs in tier["storm"].items()
            for row in legs["rows"] for leg in ("clean", "storm")}),
        "K4": {f"tier_llama_q8_x{row['rate_multiplier']}_{leg}":
               row[leg]["launches"]["K4"]
               for row in tier["llama_q8"]["rows"]
               for leg in ("clean", "storm")},
    }
    paged_entries = [
        dict(name=name, route="cuda", source=PAGED_SOURCE,
             replaces=f"pytorch_distributed_tpu/ops/paged_kernel.py:{line}",
             **run["entry"], tier_paths=tier_paths[kid],
             slice9_paths={name: counts[kid]
                           for name, counts in slice9_paths.items()})
        for name, line, run, kid in (
            ("paged_decode_attention", 56, k3, "K3"),
            ("paged_decode_attention_q8", 114, k4, "K4"))
    ]

    # 7. flash kernels at the listed shapes, then at the llama training
    # phases' long-context shapes
    flash_phase(fk, dev, flush, args.seed)
    flash_long = flash_long_phase(fk, dev, flush, args.seed)

    # 8. training: the main path
    tcfg_model = cfg.replace(attention_impl="flash", remat="names",
                             logits_dtype="bfloat16", attn_pdrop=0.0,
                             resid_pdrop=0.0, embd_pdrop=0.0)
    run = train_phase(fk, tcfg_model, args.seed, dev)
    train_launches = run["launches"]
    fq, fkk, fv, fo, flse, fdo, causal = run["captured"][:7]
    checked = check_flash(fk, fq, fkk, fv, fdo, causal,
                          "main-path inputs bf16")
    timed = time_flash(fk, fq, fkk, fv, fdo, causal, flush)

    # 9. profile of the training step, then the step under the other
    # remat modes
    train_profile_phase(run)
    del run, fo, flse
    train_remat_phase(fk, tcfg_model, args.seed, dev)

    # 10. train parity on the card (f32, flash kernels vs naive attention)
    train_parity_phase(tcfg_model, args.seed, dev)

    # 11. the training entry point's loop, dropout and the fused head CE,
    # all with the preset's dropout 0.1
    with tempfile.TemporaryDirectory() as tmp:
        train_loop_phase(fk, args.seed, tmp)
    loop_cfg = cfg.replace(attention_impl="flash")
    train_dropout_phase(loop_cfg, args.seed, dev)
    train_fused_ce_phase(loop_cfg, args.seed, dev)

    # 12. Llama-3.2-1B training at full width: bench_suite rows 6 and 7,
    # the entry point's loop, every remat mode at 4 layers; then MoE
    # training of both families
    llama_paths = {}
    for phase, t, remat, steps in (("train_llama", 4096, "names", 5),
                                   ("train_llama_long", 8192, "flash", 3)):
        run = train_llama_phase(fk, llama_cfg(remat=remat), args.seed, dev,
                                t=t, steps=steps, phase=phase)
        llama_paths[phase] = dict(T=t, launches_per_step=run[
            "launches_per_step"], kernel_times=flash_long[t])
        del run
    with tempfile.TemporaryDirectory() as tmp:
        loop = train_llama_loop_phase(fk, args.seed, tmp)
    llama_paths["train_llama_loop"] = dict(
        T=1024, launches_per_step={k: v / loop["steps"] for k, v in
                                   loop["launches"].items()})
    train_llama_remat_phase(fk, args.seed, dev)
    train_moe_phase(fk, args.seed, dev)

    inputs = dict(B=fq.shape[0], H=fq.shape[1], Hkv=fkk.shape[1],
                  T=fq.shape[2], D=fq.shape[3], causal=causal,
                  dtype=str(fq.dtype).replace("torch.", ""))
    flash_entries = [
        dict(name=name, route="cuda", source=FLASH_SOURCE,
             replaces=f"pytorch_distributed_tpu/ops/flash_kernel.py:{line}",
             launches=train_launches[direction], **checked[kn], **timed[kn],
             inputs=inputs,
             llama_paths={phase: dict(
                 T=row["T"],
                 launches_per_step=row["launches_per_step"][direction],
                 **row.get("kernel_times", {}).get(kn, {}))
                 for phase, row in llama_paths.items()})
        for name, kn, direction, line in (
            ("flash_forward", "K1", "forward", 92),
            ("flash_backward", "K2", "backward", 221),
        )
    ]
    emit(kernels=[*paged_entries, *flash_entries])
    emit(ok=True, device=dict(platform="gpu",
                              kind=torch.cuda.get_device_name(0),
                              count=torch.cuda.device_count()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
