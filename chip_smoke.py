#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and hold its kernels to their
plain versions.

    python3 chip_smoke.py [--seed N]

Phases (each prints one JSON line; any failure raises and exits nonzero
with no final line):

1. env — the card (``nvidia-smi`` name and power limit), torch and CUDA
   versions; TF32 off for matmuls and convolutions.
2. build — compiles every kernel of the serving path from ``csrc/``.
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
6. The kernels line, then ``{"ok": true, "device": {...}}`` last.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

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


def profile_phase(cfg, params, reqs, n_ticks: int = 10) -> None:
    """``torch.profiler`` over ``n_ticks`` pure decode ticks of the bf16
    engine with all 8 slots decoding: device busy share of the window,
    the kernels by device time and the host ops by self CPU time."""
    from torch.autograd import DeviceType
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
    emit(
        phase="profile", decode_ticks=n_ticks, wall_ms=wall_ms,
        device_busy_ms=device_ms,
        device_idle_share=(1 - device_ms / wall_ms) if device_ms else None,
        kernels=[dict(name=e.key[:80], calls=e.count,
                      device_ms=dev_us(e) / 1e3) for e in kernels[:10]],
        host_ops=[dict(name=e.key[:60], calls=e.count,
                       self_cpu_ms=e.self_cpu_time_total / 1e3)
                  for e in host[:12]],
    )


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

    # 2. build
    built = _build.build("paged_attention")
    emit(phase="build", kernel="paged_attention", seconds=built["seconds"],
         cached=built["cached"],
         ptxas=[ln.strip() for ln in built["log"].splitlines()
                if "registers" in ln or "spill" in ln])

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
    emit(kernels=[dict(
        name="paged_decode_attention", route="cuda",
        source="pytorch_distributed_tpu_torch/csrc/paged_attention.cu",
        replaces="pytorch_distributed_tpu/ops/paged_kernel.py:56",
        launches=launches, **checked, ms=kernel_ms,
        plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
        library_ms=None,
        inputs=dict(B=q.shape[0], H=q.shape[1], D=q.shape[2],
                    dtype=cfg.dtype, lengths=lengths.tolist()),
    )])
    emit(ok=True, device=dict(platform="gpu",
                              kind=torch.cuda.get_device_name(0),
                              count=torch.cuda.device_count()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
