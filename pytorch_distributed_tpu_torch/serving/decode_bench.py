"""The decode and serving benchmark harness.

The port's twin of the JAX package's ``scripts/decode_bench.py``, every
mode of it, on the card unless given ``--device cpu``. Each mode prints
one JSON row per leg (``--json`` writes them too), and a leg that asserts
an invariant exits nonzero when it breaks. Every row carries ``launches``:
the K3, K4 and LoRA kernel launches its leg made.

- Default: ``bench_decode`` over ``gpt2`` and ``llama3-1b`` (``--preset``
  for one) in bf16 on the serial ``DecodeEngine`` (``decode.generate``):
  the incremental rate B x (n2 - n1) / (t(n2) - t(n1)), the median of
  ``--repeats``; ``--n-experts``/``--moe-top-k`` decode an MoE variant.
  ``--speculative K``: plain against prompt-lookup speculative greedy
  decode at B 1; speedup and both tok/s from one pair of medians.
- ``--serving``: the serial engine against the per-call
  ``generate_monolithic`` on distinct prompt lengths every pass; and the
  ``zero3_decode`` sub-leg on two ranks (below).
- ``--serving-batched``: the dense ``BatchedDecodeEngine`` against the
  serial engine on one arrival stream, replayed in virtual time over
  measured service times; with ``--chaos``, the batched engine clean and
  under a seeded fault schedule (goodput, p50/p99 with retries).
- ``--serving-paged``: the paged engine against the dense engine at equal
  pool HBM (the paged leg at twice the slots) on one seeded shared-prefix
  stream: tok/s, p50/p99 from the same completion times, cache bytes,
  prefix hit rate, preemptions, and the DONE tokens of the two legs
  compared request for request (reported, as the JAX leg does: the dense
  prefill and the paged chunk run other shapes, so on the card a near-tie
  may round the other way). Asserted: no steady ``compile_count`` growth.
  With ``--kv-quant int8 [--weight-quant int8]``: f32 pages against int8
  pages at the same geometry and at equal bytes; asserted: no steady
  compiles, and the teacher-forced argmax agreement and relative logit MSE
  within ``ops.quant.Q8_QUALITY``.
- ``--serving-spec``: speculative against plain decode on one paged
  geometry over a repetitive and an all-sampled stream; asserted: DONE
  tokens equal, every request DONE, no steady compiles, no drafts on
  sampled rows, and outside ``--dryrun`` a repetitive-leg speedup of at
  least 1.2x, the median of ``SPEC_PAIRS`` pairs stepped in turns (the
  JAX leg drains each engine once); and the ``serving_spec_tp`` sub-leg
  on two ranks (below).
- ``--serving-disagg``: a colocated two-replica fleet against a
  prefill + decode fleet (``role=``) on one ``workload.disagg_stream`` and
  one Poisson arrival schedule. Asserted: DONE tokens equal request for
  request, no steady compiles, every request handed off, one
  ``kv_handoff`` event per handoff. Reported: ``interactive_p99_ratio``
  (light-row p99, disaggregated over colocated) and the handoffs' bytes,
  export time and latency from the ``kv_handoff`` events. The JAX leg
  also asserts that ratio <= 1 on its full run; here that gate applies only
  when each replica has its own card (four cards or more): on one card
  both fleets share it, a handoff is a copy inside the card's memory, and
  the ratio measures no separation of prefill from decode.
- ``--serving-scenarios``: ``tiered_slo`` (interactive p99 under a batch
  backlog <= 1.2x its unloaded p99, the backlog seen queued; measured in
  ``TIERED_ROUNDS`` rounds, the two engines stepped in turns, the median
  round's ratio gated),
  ``sessions`` (turn-N prefill hit rate >= 0.9, every turn bit-equal to
  the same prompt served one-shot) and ``multi_tenant_lora`` (four tenants
  at rank 8 striped over one stream: every tenant row bit-equal to its
  tenant served alone, aggregate tok/s >= 0.9x the adapter-less engine's,
  the median of ``LORA_PAIRS`` pairs, each stepped in turns); every leg
  without steady compiles. The JAX leg measures each side once, one after
  the other; here back-to-back passes spread by a fifth or more on a host
  shared with other work, so that single pass's ratio is reported beside
  the gated one (``*_single_pass``) and gates nothing. Under
  ``--dryrun`` the two wall-clock ratios carry the JAX script's noise
  margins (1.75x and 0.7x).

**The multi-rank sub-legs** run on two ranks that the twin starts
through the port's launcher (``parallel/mesh.spawn_ranks``), gloo ranks
sharing cuda:0 on the card (NCCL refuses two ranks on one card) or, with
``--cpu-devices 2``, on the CPU; rank 0 writes the rows, which this
process prints with its own. With ``--device cpu`` alone there is one
device, and they are skipped with the reason on stderr, as the JAX
script skips them on one device. ``--rank-legs skip`` leaves them out,
``--rank-legs only`` runs them alone (the modes' one-process legs left
out).

- ``serving_spec_tp`` (``--serving-spec``): the plain and speculative
  paged engines at ``MeshConfig(tensor=2)``, 2 slots each, on a
  repetitive stream of ``max(4, n // 4)`` requests; asserted: DONE
  tokens equal request for request and no steady compiles. K3 runs on
  each rank's 4 of the 8 KV heads. JAX guards it with ``kv_heads % 2 ==
  0``; so does this twin. Its stream is drawn from a generator of its
  own (the JAX leg continues the one its other legs drew from).
- ``zero3_decode`` (``--serving``): the serial ``DecodeEngine`` at
  ``MeshConfig(fsdp=2, strategy="full_shard")``, batch 48 (8 under
  ``--dryrun``), 15 decode steps after a prompt of 50 in bucket 64,
  ``max_len`` 128, the cache rewritten in place each repeat: tokens/s
  over ``--repeats`` runs, and the hidden share of communication
  (``profiling/trace_analysis.comm_comp_overlap``) over paired traced
  trials. The trace marks NCCL kernels as communication; gloo issues no
  device kernel (it copies through the host), so over gloo the share is
  not measurable: the row reports it as null with that reason, not as 0
  (one traced trial shows it; the JAX leg's five are taken on NCCL).
  The ``prefetch_buffers=1`` side is ROADMAP queue 1 item 7(d) (the
  layer scan's prefetch window) and is skipped, stderr naming it.

Differences from the JAX script: ``compile_count`` counts CUDA kernel
libraries loaded (``serving/engine``), so "no steady compiles" means
nothing loads after warmup. The rows' ``roofline`` field (the JAX
package's compiled-HLO cost analysis, ``_roofline_projection``) is left
out: the port compiles no program to analyse, and PERF.md keeps the
kernels' bounds. Weights and streams come from ``--chaos-seed`` in every
mode (the JAX script draws a fresh seed for the non-chaos modes, against
its relay's result cache). The repetitive-leg gate of
``--serving-spec`` compares the two engines stepped in turns (the JAX leg
drains one, then the other). ``--dryrun`` also narrows the default and
``--speculative`` modes' presets to 2 layers of width 64 (the JAX script
ignores it there).

    python -m pytorch_distributed_tpu_torch.serving.decode_bench
    python -m pytorch_distributed_tpu_torch.serving.decode_bench \\
        --serving-disagg --serving-scenarios --json out.json
    python -m pytorch_distributed_tpu_torch.serving.decode_bench \\
        --serving-paged --kv-quant int8 --dryrun --device cpu
"""

from __future__ import annotations

import argparse
import heapq
import json
import logging
import os
import sys
import tempfile
import time

import numpy as np
import torch

# The legs' clock (a test may replace it with a deterministic one).
_now = time.perf_counter
# Repetitions of the two wall-clock comparisons of --serving-scenarios,
# each side stepped in turns with the other (``_drive_together``); the
# JAX leg runs each side once, one after the other.
TIERED_ROUNDS = 3
LORA_PAIRS = 5
SPEC_PAIRS = 5

# The multi-rank sub-legs' world (module docstring).
RANK_WORLD = 2
CPU_DEVICES_REFUSED = (
    "--cpu-devices N: the port has no virtual-device mesh; its multi-rank "
    f"sub-legs run {RANK_WORLD} gloo CPU ranks (--cpu-devices "
    f"{RANK_WORLD}); for one process on the CPU use --device cpu")


def _pct(xs, q):
    """Nearest-rank percentile (the one definition every leg shares)."""
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(q * (len(xs) - 1) + 0.5))]


def _serving_cfg(dryrun: bool):
    """The JAX script's serving-bench model: a small f32 GPT-2."""
    from pytorch_distributed_tpu_torch.config import ModelConfig

    if dryrun:
        return ModelConfig(
            vocab_size=256, n_ctx=256, n_embd=64, n_layer=4, n_head=4,
            dtype="float32", embd_pdrop=0.0, attn_pdrop=0.0,
            resid_pdrop=0.0,
        )
    return ModelConfig(
        vocab_size=2048, n_ctx=512, n_embd=256, n_layer=8, n_head=8,
        dtype="float32", embd_pdrop=0.0, attn_pdrop=0.0, resid_pdrop=0.0,
    )


def _params(cfg, args):
    from pytorch_distributed_tpu_torch.models import get_model

    return get_model(cfg).init(
        torch.Generator().manual_seed(args.chaos_seed), cfg,
        device=args.device,
    )


def _launches(since: dict | None = None) -> dict:
    """The launch counts of the paged kernels (K3, K4) and the LoRA
    kernel in this process, or their growth since ``since`` (an earlier
    reading): each leg row carries what its leg launched."""
    from pytorch_distributed_tpu_torch.ops import lora_kernel, paged_kernel

    now = {"K3": paged_kernel.launches, "K4": paged_kernel.launches_q8,
           "lora": lora_kernel.launches}
    return now if since is None else {k: v - since[k]
                                      for k, v in now.items()}


def _model_row(cfg) -> dict:
    return dict(n_embd=cfg.n_embd, n_layer=cfg.n_layer,
                vocab_size=cfg.vocab_size)


def _schedule(eng, params, requests, arrivals=None, on_step=None):
    """Drive one arrival schedule (default: everything at 0) through an
    engine on its own clock — the sum of its steps' host time; arrivals
    are offered as the clock passes them, idle gaps skipped — yielding
    after every step (``on_step(eng)`` runs first). A generator: its
    return value is (clock at the end, {index: latency}, {index:
    result})."""
    if arrivals is None:
        arrivals = np.zeros((len(requests),))
    clock = 0.0
    pending = sorted(zip(arrivals, range(len(requests))))
    submitted: dict[int, float] = {}
    rid_to_idx: dict[int, int] = {}
    lat: dict[int, float] = {}
    while pending or eng.has_work():
        while pending and pending[0][0] <= clock:
            arr, i = pending.pop(0)
            rid = eng.submit(**requests[i])
            submitted[rid] = arr
            rid_to_idx[rid] = i
        if not eng.has_work():
            clock = pending[0][0]
            continue
        t0 = _now()
        done = eng.step(params)
        clock += _now() - t0
        for rid in done:
            lat[rid_to_idx[rid]] = clock - submitted[rid]
        if on_step is not None:
            on_step(eng)
        yield
    results = {rid_to_idx[rid]: eng.pop_result(rid)
               for rid in list(eng.results)}
    return clock, lat, results


def _drive_together(*runs) -> list:
    """Run ``_schedule`` generators in turns, one engine step each per
    round, until all are done; returns their results in order. Two
    engines compared this way meet the host's slow and fast moments
    alike, step by step: on a host shared with other work, back-to-back
    passes of this small model spread by a fifth or more."""
    out = [None] * len(runs)
    live = list(enumerate(runs))
    while live:
        for item in list(live):
            try:
                next(item[1])
            except StopIteration as stop:
                out[item[0]] = stop.value
                live.remove(item)
    return out


def _drive_engine(eng, params, requests, arrivals=None, on_step=None):
    """``_schedule`` run alone to its end."""
    return _drive_together(
        _schedule(eng, params, requests, arrivals, on_step))[0]


def bench_serving_paged(args) -> list[dict]:
    """Paged vs dense continuous batching at equal pool HBM on one seeded
    shared-prefix arrival stream (module docstring)."""
    from pytorch_distributed_tpu_torch.serving.engine import (
        BatchedDecodeEngine,
        BucketSpec,
        PagedBatchedDecodeEngine,
    )
    from pytorch_distributed_tpu_torch.serving.workload import (
        exponential_arrivals,
        request_stream,
    )

    start = _launches()
    cfg = _serving_cfg(args.dryrun)
    dense_slots = 4 if args.dryrun else 8
    paged_slots = 2 * dense_slots
    max_new = 12 if args.dryrun else 32
    max_len = 160 if args.dryrun else 384
    page = 16
    chunk = 16 if args.dryrun else 32
    n_req = 16 if args.dryrun else 48
    prefix_len = 48 if args.dryrun else 96
    tail_max = (max_len - max_new - prefix_len) // 2
    pool_pages = dense_slots * max_len // page
    buckets = BucketSpec.powers_of_two(
        max_len - max_new, min_bucket=16 if args.dryrun else 32)
    seed = args.chaos_seed
    params = _params(cfg, args)
    rng = np.random.default_rng(seed)
    system_prefix = rng.integers(0, cfg.vocab_size, (prefix_len,)).astype(
        np.int32)
    requests = request_stream(
        rng, n=n_req, vocab_size=cfg.vocab_size,
        prompt_len=(4, tail_max - 1), max_new=max_new, key_seed=seed,
        shared_prefix=system_prefix,
    )
    dense = BatchedDecodeEngine(cfg, slots=dense_slots, max_len=max_len,
                                buckets=buckets, device=args.device)
    paged = PagedBatchedDecodeEngine(
        cfg, slots=paged_slots, max_len=max_len, page_size=page,
        prefill_chunk=chunk, pool_pages=pool_pages, device=args.device)
    dense.warmup(params)
    paged.warmup(params)
    # Both watermarks after both warmups: the count is process-wide.
    dense_warm, paged_warm = dense.compile_count(), paged.compile_count()

    # One arrival schedule for both legs, about twice the dense leg's
    # drain rate, calibrated on one request.
    t0 = _now()
    rid = dense.submit(**requests[0])
    dense.run(params)
    dense.pop_result(rid)
    mean_interarrival = (_now() - t0) / (2 * dense_slots)
    arrivals = exponential_arrivals(rng, n_req, mean_interarrival)
    d_span, d_lat, d_res = _drive_engine(dense, params, requests, arrivals)
    p_span, p_lat, p_res = _drive_engine(paged, params, requests, arrivals)
    d_span -= arrivals[0]
    p_span -= arrivals[0]
    steady = {"dense": dense.compile_count() - dense_warm,
              "paged": paged.compile_count() - paged_warm}
    matched = sum(int(np.array_equal(d_res[i].tokens, p_res[i].tokens))
                  for i in d_res)
    total_tokens = n_req * max_new

    def _leg(eng, span, lat, steady):
        hbm = eng.cache_hbm_bytes()
        lat = list(lat.values())
        return {
            "slots": eng.slots,
            "steady_tokens_per_sec": round(total_tokens / span, 1),
            "p50_request_ms": round(_pct(lat, 0.50) * 1e3, 2),
            "p99_request_ms": round(_pct(lat, 0.99) * 1e3, 2),
            "observed_compile_count_steady": steady,
            "cache_hbm_bytes": hbm["allocated"],
            "cache_hbm_bytes_peak_in_use": hbm["peak_in_use"],
        }

    failures = [f"{name} leg steady compiles: {n}"
                for name, n in steady.items() if n]
    ps = paged.pool.stats
    row = {
        "leg": "serving_paged_stream",
        "model": _model_row(cfg),
        "max_new": max_new, "max_len": max_len, "page_size": page,
        "prefill_chunk": chunk, "pool_pages": pool_pages,
        "requests": n_req, "shared_prefix_tokens": prefix_len,
        "seed": seed,
        "mean_interarrival_ms": round(mean_interarrival * 1e3, 2),
        "arrival_process": "seeded exponential (~saturating the dense leg)",
        "dense": _leg(dense, d_span, d_lat, steady["dense"]),
        "paged": _leg(paged, p_span, p_lat, steady["paged"]),
        "paged_extras": {
            "prefix_hit_rate": round(
                ps["prefix_hits"] / max(1, ps["prefix_queries"]), 3),
            "prefix_hit_tokens": ps["prefix_hit_tokens"],
            "prefix_evictions": ps["evictions"],
            "preemptions": paged.counters["preemptions"],
            "peak_pages_in_use": ps["peak_pages_in_use"],
        },
        "aggregate_speedup": round(d_span / p_span, 3),
        "outputs_match": f"{matched}/{n_req}",
        "launches": _launches(start),
        "invariant_failures": failures,
        "device": str(paged.device),
    }
    if failures:
        print(json.dumps(row), file=sys.stderr)
        raise SystemExit("serving_paged invariants violated: "
                         + "; ".join(failures))
    return [row]


class _HandoffTap(logging.Handler):
    """The ``kv_handoff`` events of ``pdtpu.serving``: the handoff cost
    measurement (and their firing is itself an invariant)."""

    def __init__(self):
        super().__init__(logging.DEBUG)
        self.events: list[dict] = []

    def emit(self, record):
        msg = record.getMessage()
        if msg.startswith("event=kv_handoff"):
            self.events.append(dict(kv.split("=", 1)
                                    for kv in msg.split(" ")))

    def __enter__(self):
        self._lg = logging.getLogger("pdtpu.serving")
        self._saved = (self._lg.level, self._lg.propagate)
        self._lg.addHandler(self)
        self._lg.setLevel(logging.DEBUG)
        # The tap is the one consumer: the records must not flood stdout.
        self._lg.propagate = False
        return self

    def __exit__(self, *exc):
        self._lg.removeHandler(self)
        self._lg.setLevel(self._saved[0])
        self._lg.propagate = self._saved[1]
        return False


def _drive_router(router, params, requests, arrivals):
    """Drive one arrival schedule through a router fleet on the legs'
    clock. A shed offer (``RouterOverloaded``: the prefill worker's parked
    rows hold their pages until handed off, which is backpressure) is
    re-offered after the router's hint, its latency counted from the
    original arrival. Returns (span, {index: latency}, {index: result})."""
    from pytorch_distributed_tpu_torch.serving.lifecycle import (
        RouterOverloaded,
    )

    n = len(requests)
    clock = 0.0
    offers = [(float(t), i, i) for i, t in enumerate(arrivals)]
    heapq.heapify(offers)
    seq = n
    rid_to_idx: dict[int, int] = {}
    lat: dict[int, float] = {}
    while offers or router.has_work():
        while offers and offers[0][0] <= clock:
            _, _, i = heapq.heappop(offers)
            try:
                rid_to_idx[router.submit(**requests[i])] = i
            except RouterOverloaded as err:
                seq += 1
                heapq.heappush(offers, (
                    clock + (err.retry_after_s or 0.1), seq, i))
        if not router.has_work():
            if not offers:
                break
            clock = max(clock, offers[0][0])
            continue
        t0 = _now()
        done = router.step(params)
        clock += _now() - t0
        for rid in done:
            lat[rid_to_idx[rid]] = clock - arrivals[rid_to_idx[rid]]
    results = {rid_to_idx[rid]: router.pop_result(rid)
               for rid in list(router.results)}
    return clock - arrivals[0], lat, results


def _disagg_devices(args) -> list[str] | None:
    """One card per (leg, replica) when the host has four; else None (both
    fleets on ``args.device``)."""
    if not args.device.startswith("cuda") or torch.cuda.device_count() < 4:
        return None
    return [f"cuda:{i}" for i in range(4)]


def bench_serving_disagg(args) -> list[dict]:
    """Disaggregated prefill/decode vs a colocated fleet of the same size
    on one seeded ``disagg_stream`` (module docstring)."""
    from pytorch_distributed_tpu_torch.serving.engine import (
        PagedBatchedDecodeEngine,
        kv_bytes_per_position,
    )
    from pytorch_distributed_tpu_torch.serving.router import ReplicaRouter
    from pytorch_distributed_tpu_torch.serving.workload import (
        disagg_stream,
        exponential_arrivals,
    )

    start = _launches()
    cfg = _serving_cfg(args.dryrun)
    slots = 4 if args.dryrun else 8
    max_len = 160 if args.dryrun else 384
    page = 16
    chunk = 16 if args.dryrun else 32
    n_req = 16 if args.dryrun else 48
    seed = args.chaos_seed
    params = _params(cfg, args)
    stream = disagg_stream(
        seed, n=n_req, vocab_size=cfg.vocab_size,
        heavy_prompt_len=(96, 128) if args.dryrun else (192, 288),
        heavy_max_new=(4, 8),
        light_prompt_len=(8, 16) if args.dryrun else (8, 24),
        light_max_new=(16, 24) if args.dryrun else (24, 48),
    )
    kinds = [r.pop("kind") for r in stream]
    requests = stream
    devices = _disagg_devices(args)

    def _fleet(role_of, base):
        def make_engine(rep_id: int):
            return PagedBatchedDecodeEngine(
                cfg, slots=slots, max_len=max_len, page_size=page,
                prefill_chunk=chunk, role=role_of(rep_id),
                device=(args.device if devices is None
                        else devices[base + rep_id]),
            )
        # Interference is what is measured: shedding would censor the
        # p99, so admission is effectively unbounded.
        return ReplicaRouter(make_engine, 2, shed_queue_depth=10**6)

    colocated = _fleet(lambda i: "colocated", 0)
    disagg = _fleet(lambda i: "prefill" if i == 0 else "decode", 2)
    colocated.warmup(params)
    disagg.warmup(params)

    t0 = _now()
    probe = colocated.submit(**requests[0])
    colocated.run(params)
    colocated.pop_result(probe)
    arrivals = exponential_arrivals(
        np.random.default_rng(seed + 7), n_req, (_now() - t0) / (2 * slots))
    c_span, c_lat, c_res = _drive_router(colocated, params, requests,
                                         arrivals)
    with _HandoffTap() as tap:
        d_span, d_lat, d_res = _drive_router(disagg, params, requests,
                                             arrivals)

    failures: list[str] = []
    mismatch = [i for i in range(n_req)
                if not np.array_equal(c_res[i].tokens, d_res[i].tokens)]
    if mismatch:
        failures.append("disagg DONE tokens diverge from colocated for "
                        f"requests {mismatch[:8]}")
    for name, router in (("colocated", colocated), ("disagg", disagg)):
        steady = router.steady_compiles()
        if any(steady.values()):
            failures.append(f"{name} steady-state compiles: {steady}")
    n_handoffs = disagg.counters["handoffs"]
    if n_handoffs < n_req:
        failures.append(f"only {n_handoffs}/{n_req} requests took the "
                        "kv_handoff path (every finished prefill must hand "
                        "off)")
    if len(tap.events) != n_handoffs:
        failures.append(f"kv_handoff events ({len(tap.events)}) != "
                        f"handoffs counter ({n_handoffs})")
    light = [i for i, k in enumerate(kinds) if k == "light"]
    heavy = [i for i, k in enumerate(kinds) if k == "heavy_prefill"]

    def _leg(span, lat):
        def pcts(idx):
            xs = [lat[i] for i in idx if i in lat]
            return {"p50_request_ms": round(_pct(xs, 0.50) * 1e3, 2),
                    "p99_request_ms": round(_pct(xs, 0.99) * 1e3, 2)}
        total = sum(len(r["prompt"]) + r["max_new_tokens"]
                    for r in requests)
        gen = sum(r["max_new_tokens"] for r in requests)
        return {"steady_tokens_per_sec": round(gen / span, 1),
                "prefill_tokens_per_sec": round((total - gen) / span, 1),
                "interactive": pcts(light), "heavy_prefill": pcts(heavy)}

    c_row, d_row = _leg(c_span, c_lat), _leg(d_span, d_lat)
    ratio = (d_row["interactive"]["p99_request_ms"]
             / max(c_row["interactive"]["p99_request_ms"], 1e-9))
    if devices is not None and not args.dryrun and ratio > 1.0:
        failures.append("disaggregation did not relieve prefill "
                        f"interference: interactive p99 ratio {ratio:.3f} "
                        "> 1.0")
    sizes = [int(e["bytes"]) for e in tap.events]
    useful = [int(e["useful_bytes"]) for e in tap.events]
    pages = [int(e["pages"]) for e in tap.events]
    lat_s = [float(e["latency_s"]) for e in tap.events]
    export_s = [float(e["export_s"]) for e in tap.events]
    per_page = page * kv_bytes_per_position(cfg)
    if sum(useful) != sum(pages) * per_page:
        failures.append(f"kv_handoff useful bytes {sum(useful)} != pages "
                        f"{sum(pages)} x {per_page} bytes per page")
    stats = disagg.stats()["replicas"]

    def _ms(xs, q):
        return round(_pct(xs, q) * 1e3, 3) if xs else None

    row = {
        "leg": "serving_disagg_stream",
        "model": _model_row(cfg),
        "slots_per_replica": slots, "max_len": max_len, "page_size": page,
        "prefill_chunk": chunk, "requests": n_req,
        "heavy_prefill_requests": len(heavy),
        "interactive_requests": len(light), "seed": seed,
        "placement": (
            {r: s["device_ids"] for r, s in stats.items()}
            if devices is not None
            else f"both fleets on {args.device} (one card: a handoff is a "
                 "copy inside it)"),
        "roles": {0: stats[0]["role"], 1: stats[1]["role"]},
        "colocated": c_row,
        "disagg": d_row,
        "interactive_p99_ratio": round(ratio, 3),
        "interactive_p99_ratio_gated": devices is not None
        and not args.dryrun,
        "handoffs": {
            "count": n_handoffs,
            "pages_total": sum(pages),
            "bytes_per_page": per_page,
            "useful_bytes_total": sum(useful),
            "wire_bytes_total": sum(sizes),
            "wire_bytes_mean": round(sum(sizes) / max(1, len(sizes))),
            "export_ms_p50": _ms(export_s, 0.5),
            "export_ms_p99": _ms(export_s, 0.99),
            "latency_ms_p50": _ms(lat_s, 0.5),
            "latency_ms_p99": _ms(lat_s, 0.99),
            "latency_ms_max": round(max(lat_s, default=0.0) * 1e3, 3),
        },
        "outputs_match": f"{n_req - len(mismatch)}/{n_req}",
        "launches": _launches(start),
        "observed_compile_count_steady": max(
            max(colocated.steady_compiles().values()),
            max(disagg.steady_compiles().values())),
        "invariant_failures": failures,
        "device": args.device,
    }
    if failures:
        print(json.dumps(row), file=sys.stderr)
        raise SystemExit("serving_disagg invariants violated: "
                         + "; ".join(failures))
    return [row]


def bench_serving_scenarios(args) -> list[dict]:
    """The workload-scenario legs over the paged engine: tiered SLO,
    multi-turn sessions and multi-tenant LoRA (module docstring)."""
    from pytorch_distributed_tpu_torch.serving.adapters import (
        AdapterRegistry,
    )
    from pytorch_distributed_tpu_torch.serving.engine import (
        PagedBatchedDecodeEngine,
    )
    from pytorch_distributed_tpu_torch.serving.workload import (
        exponential_arrivals,
        request_seed,
        request_stream,
        session_stream,
        tiered_stream,
    )

    start = _launches()
    cfg = _serving_cfg(args.dryrun)
    seed = args.chaos_seed
    params = _params(cfg, args)
    rng = np.random.default_rng(seed)
    failures: list[str] = []
    # Structural invariants hold at full strength in every mode; the two
    # wall-clock ratios carry a noise margin under --dryrun, where a step
    # is ms-scale and host jitter swamps the effect.
    p99_bound = 1.75 if args.dryrun else 1.2
    tok_bound = 0.7 if args.dryrun else 0.9

    def saturation_of(seen):
        """An ``on_step`` keeping the largest batch queue and the smallest
        allocatable-page fraction seen (saturation evidence)."""
        def saturation(eng):
            seen["max_bq"] = max(
                seen["max_bq"], eng.stats()["queue_depth_by_tier"]["batch"])
            seen["min_free"] = min(seen["min_free"],
                                   eng.pool.allocatable_pages()
                                   / (eng.pool_pages - 1))
        return saturation

    # ---- leg 1: tiered SLO ---------------------------------------------
    slots = 4 if args.dryrun else 6
    max_len = 160 if args.dryrun else 384
    page = 16
    chunk = 16 if args.dryrun else 32
    n_i = 10 if args.dryrun else 16
    i_max_new = 16 if args.dryrun else 24
    b_max_new = 48 if args.dryrun else 128
    pool_pages = (slots * max_len // page) * 3 // 4
    tiers = {
        "interactive": dict(n=n_i, prompt_len=(8, 24), max_new=i_max_new),
        "batch": dict(n=slots + 2, prompt_len=(48, 64), max_new=b_max_new),
    }
    mix = tiered_stream(seed, vocab_size=cfg.vocab_size, tiers=tiers)
    inter = [r for r in mix if r["priority"] == "interactive"]

    def make_eng(**kw):
        return PagedBatchedDecodeEngine(
            cfg, slots=slots, max_len=max_len, page_size=page,
            prefill_chunk=chunk, pool_pages=pool_pages, device=args.device,
            **kw)

    probe = make_eng()
    probe.warmup(params)
    probe.run(params, [dict(inter[0])])
    t0 = _now()
    probe.run(params, [dict(inter[1])])
    mean_interarrival = 3.0 * (_now() - t0)
    i_arrivals = exponential_arrivals(rng, n_i, mean_interarrival)

    arrivals, reqs, n_seen = [], [], 0
    for r in mix:
        if r["priority"] == "interactive":
            arrivals.append(i_arrivals[n_seen])
            n_seen += 1
        else:
            arrivals.append(0.0)
        reqs.append(r)
    inter_idx = [i for i, r in enumerate(reqs)
                 if r["priority"] == "interactive"]
    # The JAX leg's single pass, reported: unloaded alone, then loaded
    # alone, each on a fresh warmed engine.
    single = []
    for sched, arr in ((inter, i_arrivals), (reqs, np.asarray(arrivals))):
        eng = make_eng()
        eng.warmup(params)
        single.append(_drive_engine(eng, params, sched, arr)[1])
    single_ratio = (_pct([single[1][i] for i in inter_idx], 0.99)
                    / _pct(list(single[0].values()), 0.99))
    # Unloaded and loaded stepped in turns (``_drive_together``) on fresh
    # warmed engines, TIERED_ROUNDS times, which one steps first
    # alternating; the gate reads the median round's p99 ratio.
    ratios, lu, li, max_bq, min_frac = [], [], [], None, 1.0
    steady = preempt = preempt_priority = 0
    done = True
    for r_i in range(TIERED_ROUNDS):
        unloaded, loaded = make_eng(), make_eng()
        warm = unloaded.warmup(params) + loaded.warmup(params)
        seen = {"max_bq": 0, "min_free": 1.0}
        runs = [_schedule(unloaded, params, inter, i_arrivals),
                _schedule(loaded, params, reqs, np.asarray(arrivals),
                          saturation_of(seen))]
        if r_i % 2:
            runs.reverse()
        res = _drive_together(*runs)
        (_, u_lat, _), (_, l_lat, l_res) = res if r_i % 2 == 0 else res[::-1]
        steady += (unloaded.compile_count() + loaded.compile_count()
                   - warm)
        preempt += loaded.counters["preemptions"]
        preempt_priority += loaded.counters["preempt_priority"]
        done &= all(x.state == "DONE" for x in l_res.values())
        max_bq = (seen["max_bq"] if max_bq is None
                  else min(max_bq, seen["max_bq"]))
        min_frac = min(min_frac, seen["min_free"])
        u_round = list(u_lat.values())
        l_round = [l_lat[i] for i in inter_idx]
        lu += u_round
        li += l_round
        ratios.append(_pct(l_round, 0.99) / _pct(u_round, 0.99))
    p99_ratio = float(np.median(ratios))
    if not done:
        failures.append("tiered leg: non-DONE terminal states")
    if p99_ratio > p99_bound:
        failures.append(f"interactive p99 degraded {p99_ratio:.3f}x under "
                        f"batch load (> {p99_bound}x pinned)")
    if max_bq < 1:
        failures.append("batch backlog never queued — the pool was not "
                        "saturated")
    if steady:
        failures.append(f"tiered legs leaked {steady} steady compiles")
    tiered_row = {
        "leg": "serving_scenarios_tiered_slo",
        "slots": slots, "max_len": max_len, "page_size": page,
        "pool_pages": pool_pages, "seed": seed,
        "interactive_requests": n_i,
        "batch_requests": tiers["batch"]["n"],
        "batch_max_new": b_max_new,
        "mean_interarrival_ms": round(mean_interarrival * 1e3, 2),
        "interactive_p50_ms_unloaded": round(_pct(lu, 0.5) * 1e3, 2),
        "interactive_p99_ms_unloaded": round(_pct(lu, 0.99) * 1e3, 2),
        "interactive_p50_ms_loaded": round(_pct(li, 0.5) * 1e3, 2),
        "interactive_p99_ms_loaded": round(_pct(li, 0.99) * 1e3, 2),
        "interactive_p99_ratio": round(p99_ratio, 3),
        "interactive_p99_ratio_rounds": [round(r, 3) for r in ratios],
        "interactive_p99_ratio_single_pass": round(single_ratio, 3),
        "max_batch_queue_depth": max_bq,
        "min_allocatable_page_frac": round(min_frac, 3),
        "preemptions": preempt,
        "priority_preemptions": preempt_priority,
        "observed_compile_count_steady": steady,
        "launches": _launches(start),
        "device": args.device,
    }

    # ---- leg 2: multi-turn sessions --------------------------------------
    start = _launches()
    s_page = 8 if args.dryrun else 16
    s_chunk = 8 if args.dryrun else 16
    s_max_len = 160 if args.dryrun else 384
    n_sessions = 3 if args.dryrun else 4
    turns = 3
    open_len = (96, 112) if args.dryrun else (160, 192)
    turn_len = (4, 8) if args.dryrun else (8, 16)
    s_max_new = 8 if args.dryrun else 16
    s_pool = 120 if args.dryrun else 192

    def sess_engine():
        return PagedBatchedDecodeEngine(
            cfg, slots=2, max_len=s_max_len, page_size=s_page,
            prefill_chunk=s_chunk, pool_pages=s_pool, device=args.device)

    sess_eng, oneshot = sess_engine(), sess_engine()
    warm_s = sess_eng.warmup(params)
    scripts = session_stream(
        rng, n_sessions=n_sessions, turns=turns, vocab_size=cfg.vocab_size,
        open_len=open_len, turn_len=turn_len, max_new=s_max_new,
    )
    sids = [sess_eng.open_session() for _ in scripts]
    transcripts = [np.zeros((0,), np.int32) for _ in scripts]
    turns_done = turns_matched = 0
    t_leg = _now()
    for turn in range(turns):
        for i, script in enumerate(scripts):
            t = script[turn]
            kw = {k: v for k, v in t.items()
                  if k not in ("tail", "max_new_tokens")}
            prompt = np.concatenate([transcripts[i], t["tail"]])
            rid = sess_eng.submit(prompt, t["max_new_tokens"],
                                  session=sids[i], **kw)
            out = sess_eng.run(params)
            if out[rid].state != "DONE":
                failures.append(
                    f"session {i} turn {turn + 1}: {out[rid].state}")
                continue
            transcripts[i] = out[rid].tokens
            turns_done += 1
            ref_rid = oneshot.submit(prompt, t["max_new_tokens"], **kw)
            ref = oneshot.run(params)
            turns_matched += int(np.array_equal(out[rid].tokens,
                                                ref[ref_rid].tokens))
    sess_span = _now() - t_leg
    steady_s = sess_eng.compile_count() - warm_s
    hit_rate = sess_eng._sessions.hit_rate()
    if hit_rate < 0.9:
        failures.append(
            f"session turn-N prefill hit rate {hit_rate:.3f} < 0.9")
    if turns_matched != turns_done or turns_done != n_sessions * turns:
        failures.append(
            f"session turns: {turns_done}/{n_sessions * turns} DONE, "
            f"{turns_matched} bit-equal the one-shot path")
    if steady_s:
        failures.append(f"session leg leaked {steady_s} steady compiles")
    sessions_row = {
        "leg": "serving_scenarios_sessions",
        "sessions": n_sessions, "turns": turns,
        "open_len": list(open_len), "turn_len": list(turn_len),
        "max_new": s_max_new, "page_size": s_page,
        "prefill_chunk": s_chunk, "pool_pages": s_pool, "seed": seed,
        "turn_prefill_hit_rate": round(hit_rate, 4),
        "resubmitted_tokens": sess_eng._sessions.hit["resubmitted_tokens"],
        "cached_tokens": sess_eng._sessions.hit["cached_tokens"],
        "turns_done": turns_done,
        "turns_bit_equal_oneshot": turns_matched,
        "session_evictions": sess_eng._sessions.evictions,
        "wall_s": round(sess_span, 2),
        "observed_compile_count_steady": steady_s,
        "launches": _launches(start),
        "device": args.device,
    }

    # ---- leg 3: multi-tenant LoRA ----------------------------------------
    start = _launches()
    n_tenants, rank = 4, 8
    l_slots = 4 if args.dryrun else 8
    l_max_len = 160 if args.dryrun else 384
    l_n_req = 12 if args.dryrun else 32
    l_max_new = 12 if args.dryrun else 32
    l_pool = l_slots * l_max_len // page
    reg = AdapterRegistry(cfg, rank=rank, max_tenants=n_tenants)
    tenant_ids = [f"tenant-{i}" for i in range(n_tenants)]
    for i, tid in enumerate(tenant_ids):
        reg.register(tid, seed=request_seed(seed, 1000 + i))
    lreqs = request_stream(
        rng, n=l_n_req, vocab_size=cfg.vocab_size, prompt_len=(8, 48),
        max_new=l_max_new, key_seed=seed + 1,
    )
    for i, r in enumerate(lreqs):
        r["tenant"] = tenant_ids[i % n_tenants]

    def lora_eng(adapters=None):
        return PagedBatchedDecodeEngine(
            cfg, slots=l_slots, max_len=l_max_len, page_size=page,
            prefill_chunk=chunk, pool_pages=l_pool, adapters=adapters,
            device=args.device)

    base_reqs = [{k: v for k, v in r.items() if k != "tenant"}
                 for r in lreqs]
    # The JAX leg's single pass, reported: mixed alone, then base alone,
    # each on a fresh warmed engine.
    spans = []
    for adapters, sched in ((reg, lreqs), (None, base_reqs)):
        eng = lora_eng(adapters=adapters)
        eng.warmup(params)
        spans.append(_drive_engine(eng, params, sched)[0])
    single_ratio = spans[1] / spans[0]
    # Mixed and base stepped in turns (``_drive_together``) on fresh warmed
    # engines, LORA_PAIRS times, which one steps first alternating; the
    # gate reads the median pair's ratio.
    per_pair, toks = [], {"mixed": [], "base": []}
    steady_m, m_res = 0, None
    for p_i in range(LORA_PAIRS):
        mixed, base = lora_eng(adapters=reg), lora_eng()
        warm = mixed.warmup(params)
        base.warmup(params)
        runs = [_schedule(mixed, params, lreqs),
                _schedule(base, params, base_reqs)]
        if p_i % 2:
            runs.reverse()
        res = _drive_together(*runs)
        (m_span, _, res_m), (b_span, _, _) = (
            res if p_i % 2 == 0 else res[::-1])
        steady_m += mixed.compile_count() - warm
        m_res = m_res or res_m
        toks["mixed"].append(l_n_req * l_max_new / m_span)
        toks["base"].append(l_n_req * l_max_new / b_span)
        per_pair.append(b_span / m_span)
    tok_ratio = float(np.median(per_pair))
    tok_mixed = float(np.median(toks["mixed"]))
    tok_base = float(np.median(toks["base"]))
    matched = 0
    for t_i in range(n_tenants):
        iso = lora_eng(adapters=reg)
        iso_rids = {iso.submit(**lreqs[i]): i
                    for i in range(l_n_req) if i % n_tenants == t_i}
        iso.run(params)
        for rid, i in iso_rids.items():
            matched += int(np.array_equal(iso.pop_result(rid).tokens,
                                          m_res[i].tokens))
    if matched != l_n_req:
        failures.append(f"tenant isolation broke: {matched}/{l_n_req} rows "
                        "bit-equal their isolated-run references")
    if tok_ratio < tok_bound:
        failures.append(f"{n_tenants}-tenant aggregate tok/s "
                        f"{tok_ratio:.3f}x base (< {tok_bound}x pinned)")
    if steady_m:
        failures.append(f"LoRA leg leaked {steady_m} steady compiles")
    lora_row = {
        "leg": "serving_scenarios_multi_tenant_lora",
        "tenants": n_tenants, "rank": rank, "slots": l_slots,
        "max_len": l_max_len, "requests": l_n_req, "max_new": l_max_new,
        "pool_pages": l_pool, "seed": seed,
        "tokens_per_sec_4_tenant": round(tok_mixed, 1),
        "tokens_per_sec_base": round(tok_base, 1),
        "aggregate_tokens_per_sec_ratio": round(tok_ratio, 3),
        "aggregate_tokens_per_sec_ratio_pairs": [round(r, 3)
                                                 for r in per_pair],
        "aggregate_tokens_per_sec_ratio_single_pass": round(single_ratio, 3),
        "rows_bit_equal_isolated": f"{matched}/{l_n_req}",
        "observed_compile_count_steady": steady_m,
        "launches": _launches(start),
        "device": args.device,
    }
    rows = [tiered_row, sessions_row, lora_row]
    for row in rows:
        row["invariant_failures"] = failures
    if failures:
        for row in rows:
            print(json.dumps(row), file=sys.stderr)
        raise SystemExit("serving_scenarios invariants violated: "
                         + "; ".join(failures))
    return rows


def _platform(device) -> str:
    """The JAX rows' ``platform`` field: "gpu" on a CUDA device."""
    return "gpu" if torch.device(device).type == "cuda" else "cpu"


def _decode_cfg(preset: str, max_len: int, n_experts: int, moe_top_k: int,
                dryrun: bool):
    """The non-serving benches' model: the preset in bf16 (params too),
    without dropout, ``n_ctx`` cut to what the run needs, an MoE variant at
    the no-drop capacity (cf = X/k) when ``n_experts``. ``dryrun`` keeps
    the preset's family and narrows it to 2 layers of width 64."""
    from pytorch_distributed_tpu_torch.config import model_config

    base = model_config(preset)
    cfg = model_config(preset, dtype="bfloat16",
                       param_dtype="bfloat16").replace(
        embd_pdrop=0.0, attn_pdrop=0.0, resid_pdrop=0.0,
        n_ctx=min(base.n_ctx, max_len))
    if dryrun:
        narrow = dict(vocab_size=256, n_embd=64, n_layer=2, n_head=4)
        if cfg.family == "llama":
            narrow.update(n_kv_head=2, n_inner=128)
        cfg = cfg.replace(**narrow)
    if n_experts:
        cfg = cfg.replace(n_experts=n_experts, moe_top_k=moe_top_k,
                          expert_capacity_factor=float(n_experts) / moe_top_k)
    return cfg


def _init_on(cfg, seed: int, device):
    """Weights from ``seed``, drawn on the device they live on (the card
    draws a billion parameters in well under a second)."""
    from pytorch_distributed_tpu_torch.models import get_model

    dev = torch.device(device)
    return get_model(cfg).init(torch.Generator(device=dev).manual_seed(seed),
                               cfg, device=dev)


def bench_decode(preset: str, batch: int, prompt_len: int, n1: int, n2: int,
                 repeats: int, n_experts: int = 0, moe_top_k: int = 1, *,
                 seed: int = 0, device="cuda", dryrun: bool = False) -> dict:
    """Incremental decode rate of ``decode.generate`` (the serial
    ``DecodeEngine``): B x (n2 - n1) / (t(n2) - t(n1)), which cancels the
    prefill and the fixed per-call cost; the median of ``repeats``."""
    from pytorch_distributed_tpu_torch.models import decode

    cfg = _decode_cfg(preset, prompt_len + n2, n_experts, moe_top_k, dryrun)
    params = _init_on(cfg, seed, device)
    rng = np.random.default_rng(seed)

    def run(max_new):
        prompt = rng.integers(0, cfg.vocab_size, (batch, prompt_len))
        t0 = _now()
        out = decode.generate(params, prompt, cfg, max_new,
                              max_len=prompt_len + n2, device=device)
        out.cpu()  # the fence
        return _now() - t0

    run(n1)  # one cache shape: the first calls load what they need
    run(n2)
    rates = []
    for _ in range(repeats):
        t1, t2 = run(n1), run(n2)
        rates.append(batch * (n2 - n1) / (t2 - t1))
    med = sorted(rates)[len(rates) // 2]
    return dict(
        preset=preset,
        n_experts=n_experts,
        moe_top_k=moe_top_k if n_experts else None,
        batch=batch,
        prompt_len=prompt_len,
        incremental_tokens_per_sec=round(med, 1),
        per_sequence_tokens_per_sec=round(med / batch, 1),
        spread=round(max(rates) / max(min(rates), 1e-9), 3),
        platform=_platform(device),
        device=str(device),
    )


def bench_speculative(preset: str, prompt_len: int, max_new: int,
                      draft_len: int, ngram: int, repeats: int,
                      n_experts: int = 0, moe_top_k: int = 1, *,
                      seed: int = 0, device="cuda",
                      dryrun: bool = False) -> dict:
    """Plain against prompt-lookup speculative greedy decode (B 1), the
    same fresh prompt for both in each repeat. Speedup and both tok/s come
    from one pair of medians, so speedup == speculative tok/s / plain
    tok/s within the row."""
    from pytorch_distributed_tpu_torch.models import decode
    from pytorch_distributed_tpu_torch.models.speculative import (
        generate_speculative,
    )

    max_len = prompt_len + max_new + draft_len
    cfg = _decode_cfg(preset, max_len, n_experts, moe_top_k, dryrun)
    params = _init_on(cfg, seed, device)
    rng = np.random.default_rng(seed)

    def fresh_prompt():
        return rng.integers(0, cfg.vocab_size, (1, prompt_len))

    def run_plain(prompt):
        t0 = _now()
        out = decode.generate(params, prompt, cfg, max_new, max_len=max_len,
                              device=device).cpu()
        return out.numpy(), _now() - t0

    def run_spec(prompt):
        t0 = _now()
        out = generate_speculative(params, prompt, cfg, max_new,
                                   draft_len=draft_len, ngram=ngram,
                                   device=device).cpu()
        return out.numpy(), _now() - t0

    warm = fresh_prompt()
    run_plain(warm), run_spec(warm)
    plain_ts, spec_ts, matched = [], [], 0
    for _ in range(repeats):
        p = fresh_prompt()
        out_p, tp_ = run_plain(p)
        out_s, ts_ = run_spec(p)
        plain_ts.append(tp_)
        spec_ts.append(ts_)
        # bf16 runs may part at near-tied logits (the 1-token and
        # K+1-token forwards round differently): reported, not asserted.
        matched += int(np.array_equal(out_p, out_s))
    med_plain = float(np.median(plain_ts))
    med_spec = float(np.median(spec_ts))
    return dict(
        preset=preset,
        mode="speculative",
        n_experts=n_experts,
        moe_top_k=moe_top_k if n_experts else None,
        draft_len=draft_len,
        ngram=ngram,
        max_new=max_new,
        plain_tokens_per_sec=round(max_new / med_plain, 1),
        speculative_tokens_per_sec=round(max_new / med_spec, 1),
        speedup=round(med_plain / med_spec, 3),
        outputs_match=f"{matched}/{repeats}",
        platform=_platform(device),
        device=str(device),
    )


def bench_serving(args) -> list[dict]:
    """The serial ``DecodeEngine`` against the per-call
    ``decode.generate_monolithic`` on a mixed-length stream: distinct
    prompt lengths every pass (the engine's buckets make its shape set
    finite), two sampling configs, batch 4 per request; cold, steady and
    repeat-stream rates and p50 request latency per path. Then the
    ``zero3_decode`` sub-leg on two ranks (module docstring)."""
    from pytorch_distributed_tpu_torch.models import decode
    from pytorch_distributed_tpu_torch.serving.engine import (
        BucketSpec,
        DecodeEngine,
        _compile_count,
    )

    if args.rank_legs == "only":
        return _zero3_decode(args)
    start = _launches()
    cfg = _serving_cfg(args.dryrun)
    max_new = 16 if args.dryrun else 32
    batch = 4
    max_len = 192 if args.dryrun else 384
    configs = [dict(temperature=0.8, top_k=20),
               dict(temperature=1.0, top_p=0.9)]
    buckets = BucketSpec.powers_of_two(
        max_len - max_new, min_bucket=16 if args.dryrun else 32)
    n_req = 8 if args.dryrun else 12
    seed = args.chaos_seed
    params = _params(cfg, args)
    rng = np.random.default_rng(seed)

    def make_requests(lengths):
        return [(rng.integers(0, cfg.vocab_size, (batch, tp)),
                 configs[i % len(configs)]) for i, tp in enumerate(lengths)]

    def draw_lengths(n):
        """n distinct prompt lengths: every pass sees lengths the paths
        have (almost certainly) not run before."""
        pool = rng.permutation(np.arange(4, buckets.buckets[-1] + 1))[:n]
        return sorted(int(x) for x in pool)

    # The cold stream covers every bucket once, then random lengths.
    cold_lengths = list(buckets.buckets) + draw_lengths(
        n_req - len(buckets.buckets))
    new_tokens_per_pass = batch * max_new * n_req

    def run_stream(gen_fn, requests):
        """(wall seconds, per-request seconds) serving every request."""
        times = []
        t0 = _now()
        for prompt, ckw in requests:
            r0 = _now()
            gen_fn(prompt, ckw).cpu()  # the fence
            times.append(_now() - r0)
        return _now() - t0, times

    def engine_leg(engine, requests):
        return run_stream(lambda prompt, ckw: engine.generate(
            params, prompt, max_new, seed=seed, **ckw), requests)

    def legacy_leg(requests):
        # The per-call path: a fresh cache per call, allocated and zeroed
        # inside it, at the engine's capacity.
        return run_stream(lambda prompt, ckw: decode.generate_monolithic(
            params, prompt, cfg, max_new, seed=seed, max_len=max_len,
            device=args.device, **ckw), requests)

    engine = DecodeEngine(cfg, max_len=max_len, buckets=buckets,
                          device=args.device)
    before = _compile_count()
    cold_requests = make_requests(cold_lengths)
    eng_cold, _ = engine_leg(engine, cold_requests)
    eng_compiles = _compile_count() - before
    before = _compile_count()
    leg_cold, _ = legacy_leg(cold_requests)
    leg_compiles = _compile_count() - before

    # Steady state: sustained fresh-length traffic, each pass the same
    # requests through both paths.
    eng_steady = leg_steady = 0.0
    eng_times, leg_times = [], []
    eng_steady_compiles = leg_steady_compiles = 0
    for _ in range(args.repeats):
        requests = make_requests(draw_lengths(n_req))
        before = _compile_count()
        et, etimes = engine_leg(engine, requests)
        eng_steady_compiles += _compile_count() - before
        before = _compile_count()
        lt, ltimes = legacy_leg(requests)
        leg_steady_compiles += _compile_count() - before
        eng_steady += et
        leg_steady += lt
        eng_times += etimes
        leg_times += ltimes

    # The repeat-stream idealization: the cold requests again, warm on
    # both paths.
    eng_warm, _ = min((engine_leg(engine, cold_requests)
                       for _ in range(args.repeats)), key=lambda r: r[0])
    leg_warm, _ = min((legacy_leg(cold_requests)
                       for _ in range(args.repeats)), key=lambda r: r[0])

    def _leg_row(compiles, steady_compiles, cold_s, steady_s, warm_s, times):
        passes = max(1, args.repeats)
        return {
            "observed_compile_count_cold": compiles,
            "observed_compile_count_steady": steady_compiles,
            "stream_seconds_cold": round(cold_s, 3),
            "steady_tokens_per_sec": round(
                passes * new_tokens_per_pass / steady_s, 1),
            "repeat_stream_tokens_per_sec": round(
                new_tokens_per_pass / warm_s, 1),
            "p50_request_ms": round(sorted(times)[len(times) // 2] * 1e3, 2),
        }

    engine_row = _leg_row(eng_compiles, eng_steady_compiles, eng_cold,
                          eng_steady, eng_warm, eng_times)
    hbm = engine.cache_hbm_bytes()
    engine_row["cache_hbm_bytes"] = hbm["allocated"]
    engine_row["cache_hbm_bytes_peak_in_use"] = hbm["peak_in_use"]
    zero3 = _zero3_decode(args)
    return [{
        "leg": "serving_stream",
        "model": _model_row(cfg),
        "batch": batch,
        "max_new": max_new,
        "requests_per_pass": n_req,
        "distinct_prompt_lengths_per_pass": n_req,
        "sampling_configs": len(configs),
        "steady_passes": args.repeats,
        "buckets": list(buckets.buckets),
        "engine": engine_row,
        "legacy": _leg_row(leg_compiles, leg_steady_compiles, leg_cold,
                           leg_steady, leg_warm, leg_times),
        "seed": seed,
        "launches": _launches(start),
        "platform": _platform(args.device),
        "device": str(args.device),
    }, *zero3]


def _replay(eng, params, requests, arrivals) -> tuple:
    """The JAX legs' virtual-clock replay through a batched engine:
    arrivals are admitted as the clock (the sum of measured ``step``
    times) passes them, idle gaps skipped. (span from the first arrival,
    {rid: latency}, {rid: request index})."""
    clock = 0.0
    pending = list(zip(arrivals, range(len(requests))))
    submitted: dict[int, float] = {}
    rid_to_idx: dict[int, int] = {}
    lat: dict[int, float] = {}
    while pending or eng.has_work():
        while pending and pending[0][0] <= clock:
            arr, i = pending.pop(0)
            rid = eng.submit(**requests[i])
            submitted[rid] = arr
            rid_to_idx[rid] = i
        if not eng.has_work():
            clock = pending[0][0]
            continue
        t0 = _now()
        done = eng.step(params)
        clock += _now() - t0
        for rid in done:
            lat[rid] = clock - submitted[rid]
    return clock - arrivals[0], lat, rid_to_idx


def bench_serving_batched(args) -> list[dict]:
    """Continuous batching (``BatchedDecodeEngine``) against the serial
    engine on one seeded arrival stream offered at about twice the serial
    engine's service rate, both replayed in virtual time over measured
    service times (the serial leg FIFO, one request at a time); tok/s and
    p50/p99 from the same completion times, steady compiles per leg."""
    from pytorch_distributed_tpu_torch.serving.engine import (
        BatchedDecodeEngine,
        BucketSpec,
        DecodeEngine,
    )
    from pytorch_distributed_tpu_torch.serving.workload import (
        exponential_arrivals,
        request_stream,
    )

    start = _launches()
    cfg = _serving_cfg(args.dryrun)
    slots = 4 if args.dryrun else 8
    max_new = 12 if args.dryrun else 32
    max_len = 160 if args.dryrun else 384
    n_req = 16 if args.dryrun else 48
    buckets = BucketSpec.powers_of_two(
        max_len - max_new, min_bucket=16 if args.dryrun else 32)
    seed = args.chaos_seed
    params = _params(cfg, args)
    rng = np.random.default_rng(seed)
    requests = request_stream(
        rng, n=n_req, vocab_size=cfg.vocab_size,
        prompt_len=(4, buckets.buckets[-1]), max_new=max_new, key_seed=seed)
    n_sampling_configs = 3  # DEFAULT_SAMPLING_CYCLE

    serial = DecodeEngine(cfg, max_len=max_len, buckets=buckets,
                          device=args.device)
    batched = BatchedDecodeEngine(cfg, slots=slots, max_len=max_len,
                                  buckets=buckets, device=args.device)

    def serial_call(req):
        kw = {k: v for k, v in req.items()
              if k not in ("prompt", "max_new_tokens")}
        serial.generate(params, np.asarray(req["prompt"])[None],
                        req["max_new_tokens"], **kw).cpu()  # the fence

    # Warm both legs, outside the measured stream.
    for tp in buckets.buckets:
        p_warm = np.zeros((min(tp, max_len - max_new),), np.int32)
        serial_call(dict(prompt=p_warm, max_new_tokens=max_new,
                         temperature=0.8, top_k=20, seed=0))
        serial_call(dict(prompt=p_warm, max_new_tokens=max_new))
    batched.warmup(params)
    serial_warm = serial.compile_count()
    batched_warm = batched.compile_count()

    # Calibrate the arrival process to the serial engine's service rate.
    t0 = _now()
    serial_call(requests[0])
    mean_interarrival = (_now() - t0) / 2.0  # ~2x serial capacity
    arrivals = exponential_arrivals(rng, n_req, mean_interarrival)

    clock = 0.0
    serial_lat = []
    for arr, req in zip(arrivals, requests):
        t0 = _now()
        serial_call(req)
        clock = max(clock, arr) + (_now() - t0)
        serial_lat.append(clock - arr)
    serial_span = clock - arrivals[0]
    serial_steady = serial.compile_count() - serial_warm

    batched_span, batched_lat, _ = _replay(batched, params, requests,
                                           arrivals)
    batched_steady = batched.compile_count() - batched_warm
    total_tokens = n_req * max_new

    def _leg(span, lat, steady):
        lat = list(lat)
        return {
            "steady_tokens_per_sec": round(total_tokens / span, 1),
            "p50_request_ms": round(_pct(lat, 0.50) * 1e3, 2),
            "p99_request_ms": round(_pct(lat, 0.99) * 1e3, 2),
            "observed_compile_count_steady": steady,
        }

    return [{
        "leg": "serving_batched_stream",
        "model": _model_row(cfg),
        "slots": slots,
        "max_new": max_new,
        "max_len": max_len,
        "requests": n_req,
        "buckets": list(buckets.buckets),
        "sampling_configs": n_sampling_configs,
        "mean_interarrival_ms": round(mean_interarrival * 1e3, 2),
        "arrival_process": "seeded exponential (~2x serial capacity)",
        "serial": _leg(serial_span, serial_lat, serial_steady),
        "batched": dict(
            _leg(batched_span, batched_lat.values(), batched_steady),
            cache_hbm_bytes=batched.cache_hbm_bytes()["allocated"]),
        "aggregate_speedup": round(serial_span / batched_span, 3),
        "seed": seed,
        "launches": _launches(start),
        "platform": _platform(args.device),
        "device": str(args.device),
    }]


def bench_serving_chaos(args) -> list[dict]:
    """The cost of surviving faults: one seeded arrival stream through
    the dense batched engine twice, clean and under a seeded fault
    schedule (dispatch failures, dropped results, NaN rows; a pure
    function of ``--chaos-seed``), latencies by the virtual-clock replay
    of ``--serving-batched``; goodput counts DONE tokens only."""
    from pytorch_distributed_tpu_torch.serving.chaos import FaultInjector
    from pytorch_distributed_tpu_torch.serving.engine import (
        BatchedDecodeEngine,
        BucketSpec,
    )
    from pytorch_distributed_tpu_torch.serving.lifecycle import DONE
    from pytorch_distributed_tpu_torch.serving.workload import (
        exponential_arrivals,
        request_stream,
    )

    start = _launches()
    cfg = _serving_cfg(args.dryrun)
    slots = 4 if args.dryrun else 8
    max_new = 12 if args.dryrun else 32
    max_len = 160 if args.dryrun else 384
    n_req = 16 if args.dryrun else 48
    buckets = BucketSpec.powers_of_two(
        max_len - max_new, min_bucket=16 if args.dryrun else 32)
    seed = args.chaos_seed
    params = _params(cfg, args)
    rng = np.random.default_rng(seed)
    requests = request_stream(
        rng, n=n_req, vocab_size=cfg.vocab_size,
        prompt_len=(4, buckets.buckets[-1]), max_new=max_new, key_seed=seed)

    def make_engine():
        return BatchedDecodeEngine(
            cfg, slots=slots, max_len=max_len, buckets=buckets,
            dispatch_retries=None, request_retries=8,
            retry_backoff_s=0.0,  # measured: no sleep, just redo
            device=args.device)

    # One arrival process, calibrated on a throwaway warm engine and
    # shared by both legs.
    probe = make_engine()
    probe.warmup(params)
    t0 = _now()
    probe.run(params, [requests[0]])
    mean_interarrival = (_now() - t0) / max(2, slots // 2)
    del probe
    arrivals = exponential_arrivals(rng, n_req, mean_interarrival)

    def drive(injector):
        eng = make_engine()
        if injector is not None:
            injector.install(eng)
        eng.warmup(params)
        warm = eng.compile_count()
        span, lat, rid_to_idx = _replay(eng, params, requests, arrivals)
        results = {rid_to_idx[rid]: eng.pop_result(rid)
                   for rid in list(eng.results)}
        return span, lat, results, eng.counters, eng.compile_count() - warm

    def _leg(span, lat, results, stats, steady):
        good_tokens = sum(len(r.tokens) - len(requests[i]["prompt"])
                          for i, r in results.items() if r.state == DONE)
        lat = list(lat.values())
        return {
            "goodput_tokens_per_sec": round(good_tokens / span, 1),
            "p50_request_ms": round(_pct(lat, 0.50) * 1e3, 2),
            "p99_request_ms": round(_pct(lat, 0.99) * 1e3, 2),
            "terminal_states": {
                s: sum(1 for r in results.values() if r.state == s)
                for s in sorted({r.state for r in results.values()})},
            "dispatch_failures": stats["dispatch_failures"],
            "resumes": stats["resumes"],
            "nan_quarantines": stats["nan_quarantines"],
            "observed_compile_count_steady": steady,
        }

    clean = _leg(*drive(None))
    p_fault = (0.10, 0.06, 0.12) if args.dryrun else (0.03, 0.02, 0.05)
    injector = FaultInjector(seed=seed + 1, p_dispatch_error=p_fault[0],
                             p_drop_result=p_fault[1], p_nan_row=p_fault[2])
    chaos = _leg(*drive(injector))
    for kind, count in injector.counts.items():
        if kind != "slow_tick" and count == 0:
            print(f"warning: fault kind {kind!r} never fired this seed — "
                  "the chaos leg under-exercised recovery", file=sys.stderr)
    return [{
        "leg": "serving_batched_chaos",
        "model": _model_row(cfg),
        "slots": slots,
        "max_new": max_new,
        "max_len": max_len,
        "requests": n_req,
        "buckets": list(buckets.buckets),
        "chaos_seed": seed,
        "mean_interarrival_ms": round(mean_interarrival * 1e3, 2),
        "fault_probabilities": {"p_dispatch_error": p_fault[0],
                                "p_drop_result": p_fault[1],
                                "p_nan_row": p_fault[2]},
        "fault_counts": {k: v for k, v in injector.counts.items()
                         if k != "slow_tick"},
        "clean": clean,
        "chaos": chaos,
        "goodput_retention": round(
            chaos["goodput_tokens_per_sec"]
            / max(clean["goodput_tokens_per_sec"], 1e-9), 3),
        "launches": _launches(start),
        "platform": _platform(args.device),
        "device": str(args.device),
    }]


def bench_serving_quant(args) -> list[dict]:
    """int8 KV pages (and int8 weights with ``--weight-quant int8``)
    against the f32 paged engine on one seeded all-greedy shared-prefix
    stream offered at ~4x the drain rate: ``f32`` at a page-pressured pool,
    ``int8`` on the same pool geometry, ``int8_equal_bytes`` re-provisioned
    to the f32 pool's bytes. Asserted: zero steady compiles on every leg,
    and the teacher-forced greedy agreement and relative logit MSE within
    ``ops.quant.Q8_QUALITY`` (the f32 leg's sequences through both
    forwards)."""
    from pytorch_distributed_tpu_torch.models import decode
    from pytorch_distributed_tpu_torch.ops.quant import (
        Q8_QUALITY,
        argmax_agreement,
        quantize_decode_params,
        relative_logit_mse,
        token_match_rate,
    )
    from pytorch_distributed_tpu_torch.serving.engine import (
        PagedBatchedDecodeEngine,
        kv_bytes_per_position,
    )
    from pytorch_distributed_tpu_torch.serving.workload import (
        exponential_arrivals,
        request_stream,
    )

    start = _launches()
    cfg = _serving_cfg(args.dryrun)
    slots = 4 if args.dryrun else 8
    max_new = 12 if args.dryrun else 32
    max_len = 160 if args.dryrun else 384
    page = 16
    chunk = 16 if args.dryrun else 32
    n_req = 16 if args.dryrun else 48
    prefix_len = 48 if args.dryrun else 96
    tail_max = (max_len - max_new - prefix_len) // 2
    # A quarter of the dense-equivalent pool (at least one full-depth
    # row): the f32 leg runs page-pressured.
    pool_pages = max(slots * max_len // (4 * page), max_len // page + 1)
    bpp_f32 = kv_bytes_per_position(cfg)
    bpp_q8 = kv_bytes_per_position(cfg, "int8")
    pool_pages_eq = pool_pages * bpp_f32 // bpp_q8
    seed = args.chaos_seed
    params = _params(cfg, args)
    rng = np.random.default_rng(seed)
    system_prefix = rng.integers(0, cfg.vocab_size, (prefix_len,)).astype(
        np.int32)
    requests = request_stream(
        rng, n=n_req, vocab_size=cfg.vocab_size,
        prompt_len=(4, tail_max - 1), max_new=max_new, key_seed=seed,
        shared_prefix=system_prefix, sampling_cycle=(dict(),))

    def make_engine(kv_quant, pages):
        return PagedBatchedDecodeEngine(
            cfg, slots=slots, max_len=max_len, page_size=page,
            prefill_chunk=chunk, pool_pages=pages, kv_quant=kv_quant,
            weight_quant=args.weight_quant if kv_quant != "none" else "none",
            device=args.device)

    # The arrival schedule, calibrated on a throwaway f32 engine (a
    # measured engine would keep the probe's prefix pages warm).
    probe = make_engine("none", pool_pages)
    probe.warmup(params)
    t0 = _now()
    probe.run(params, [requests[0]])
    mean_interarrival = (_now() - t0) / (4 * slots)
    del probe
    arrivals = exponential_arrivals(rng, n_req, mean_interarrival)

    engines = {
        "f32": make_engine("none", pool_pages),
        "int8": make_engine(args.kv_quant, pool_pages),
        "int8_equal_bytes": make_engine(args.kv_quant, pool_pages_eq),
    }
    warm = {}
    for name, eng in engines.items():
        eng.warmup(params)
        warm[name] = eng.compile_count()
    runs = {}
    for name, eng in engines.items():
        span, lat, rid_to_idx = _replay(eng, params, requests, arrivals)
        results = {rid_to_idx[rid]: eng.pop_result(rid)
                   for rid in list(eng.results)}
        runs[name] = (span, lat, results)
    steady = {name: engines[name].compile_count() - warm[name]
              for name in engines}

    # Quality between the int8 and f32 paths: the f32 leg's served
    # sequences teacher-forced through both forwards (identical contexts:
    # quantization error alone), argmax agreement and relative logit MSE
    # over the generated positions; the autoregressive prefix match rides
    # the row, unpinned.
    gen = {name: [np.asarray(res[i].tokens)[len(requests[i]["prompt"]):]
                  for i in sorted(res)]
           for name, (_, _, res) in runs.items()}
    prefix_match = token_match_rate(gen["f32"], gen["int8"])
    probe_n = min(12, n_req)
    seqs = [np.concatenate([np.asarray(requests[i]["prompt"], np.int32),
                            gen["f32"][i]])[:-1] for i in range(probe_n)]
    gen_starts = [len(requests[i]["prompt"]) - 1 for i in range(probe_n)]
    t_max = max(len(s) for s in seqs)
    batch = np.zeros((probe_n, t_max), np.int64)
    for i, s in enumerate(seqs):
        batch[i, :len(s)] = s
    n_pp = -(-t_max // page)
    dev = torch.device(args.device)
    tables = torch.arange(1, 1 + probe_n * n_pp, dtype=torch.int32,
                          device=dev).reshape(probe_n, n_pp)
    pos = torch.zeros((probe_n,), dtype=torch.int32, device=dev)
    ids = torch.from_numpy(batch).to(dev)
    logits = {}
    for kv_quant, p in (
            ("none", params),
            (args.kv_quant, quantize_decode_params(params)
             if args.weight_quant != "none" else params)):
        cache = decode.init_paged_cache(cfg, probe_n * n_pp + 1, page,
                                        device=dev, kv_quant=kv_quant)
        with torch.no_grad():
            out, _ = decode.forward(p, ids, cfg, cache, pos,
                                    block_tables=tables, kv_quant=kv_quant)
        out = out.float().cpu().numpy()
        logits[kv_quant != "none"] = np.concatenate(
            [out[i, gen_starts[i]:len(s)] for i, s in enumerate(seqs)])
    match_rate = argmax_agreement(logits[False], logits[True])
    logit_mse = relative_logit_mse(logits[False], logits[True])

    hbm = {name: engines[name].cache_hbm_bytes() for name in engines}
    total_tokens = n_req * max_new

    def _leg(name):
        span, lat, _ = runs[name]
        lat = list(lat.values())
        eng = engines[name]
        return {
            "kv_quant": eng.kv_quant,
            "weight_quant": eng.weight_quant,
            "pool_pages": eng.pool_pages,
            "steady_tokens_per_sec": round(total_tokens / span, 1),
            "p50_request_ms": round(_pct(lat, 0.50) * 1e3, 2),
            "p99_request_ms": round(_pct(lat, 0.99) * 1e3, 2),
            "observed_compile_count_steady": steady[name],
            "cache_hbm_bytes": hbm[name]["allocated"],
            "cache_hbm_bytes_peak_in_use": hbm[name]["peak_in_use"],
            "preemptions": eng.counters["preemptions"],
        }

    row = {
        "leg": "serving_quant_stream",
        "model": _model_row(cfg),
        "slots": slots,
        "max_new": max_new,
        "max_len": max_len,
        "page_size": page,
        "prefill_chunk": chunk,
        "requests": n_req,
        "shared_prefix_tokens": prefix_len,
        "seed": seed,
        "sampling": "all-greedy (quality is an argmax statement)",
        "mean_interarrival_ms": round(mean_interarrival * 1e3, 2),
        "bytes_per_position": {"f32": bpp_f32, "int8": bpp_q8},
        "f32": _leg("f32"),
        "int8": _leg("int8"),
        "int8_equal_bytes": _leg("int8_equal_bytes"),
        "page_pool_hbm_ratio": round(
            hbm["int8"]["allocated"] / hbm["f32"]["allocated"], 4),
        "equal_bytes_speedup": round(
            runs["f32"][0] / runs["int8_equal_bytes"][0], 3),
        "quality": {
            "greedy_token_match_rate": round(match_rate, 4),
            "relative_logit_mse": float(f"{logit_mse:.3e}"),
            "autoregressive_prefix_match_rate": round(prefix_match, 4),
            "probe_requests": probe_n,
            "budget": dict(Q8_QUALITY),
        },
        "launches": _launches(start),
        "platform": _platform(args.device),
        "device": str(args.device),
    }
    failures = [f"{name} leg leaked {count} steady-state compiles"
                for name, count in steady.items() if count]
    if match_rate < Q8_QUALITY["min_token_match_rate"]:
        failures.append(
            f"greedy token-match rate {match_rate:.4f} below the pinned "
            f"budget {Q8_QUALITY['min_token_match_rate']}")
    if logit_mse > Q8_QUALITY["max_relative_logit_mse"]:
        failures.append(
            f"relative logit MSE {logit_mse:.3e} above the pinned budget "
            f"{Q8_QUALITY['max_relative_logit_mse']:.0e}")
    row["invariant_failures"] = failures
    if failures:
        print(json.dumps(row), file=sys.stderr)
        raise SystemExit("serving_quant invariants violated: "
                         + "; ".join(failures))
    return [row]


def bench_serving_spec(args) -> list[dict]:
    """Batched speculative decoding (``speculative_k``) against plain
    decode on the same paged geometry, each pair draining one saturating
    stream (every request at t 0) stepped in turns (``_drive_together``):
    ``repetitive`` (self-repetitive greedy traffic, the prompt-lookup
    target) and ``low_repetition`` (all-sampled rows, which draft nothing:
    the cost of leaving speculation on). Asserted: DONE tokens equal
    request for request, every request DONE, zero steady compiles, no
    drafts on sampled rows, and outside ``--dryrun`` a repetitive-leg
    speedup of at least 1.2x: the median of ``SPEC_PAIRS`` pairs, which
    one steps first alternating (the JAX leg drains each engine once,
    one after the other; the first pair's ratio is reported as
    ``aggregate_speedup_single_pass``). Then the ``serving_spec_tp``
    sub-leg on two ranks (module docstring), its equality and
    no-steady-compile gates among these."""
    from pytorch_distributed_tpu_torch.serving.engine import (
        PagedBatchedDecodeEngine,
    )
    from pytorch_distributed_tpu_torch.serving.workload import (
        repetitive_request_stream,
        request_stream,
    )

    if args.rank_legs == "only":
        return _checked_spec_rows(_rank_leg(args, "serving_spec_tp"))
    cfg = _serving_cfg(args.dryrun)
    slots = 4 if args.dryrun else 8
    max_new = 16 if args.dryrun else 48
    max_len = 160 if args.dryrun else 384
    page = 16
    chunk = 16 if args.dryrun else 32
    n_req = 12 if args.dryrun else 32
    spec_k = args.speculative or 4
    pool_pages = slots * max_len // page + 1
    seed = args.chaos_seed
    params = _params(cfg, args)
    rng = np.random.default_rng(seed)
    failures: list[str] = []
    # ngram 1 on the engine path: the verify forward is k+1 wide whatever
    # is drafted, so a looser match that fires earlier only adds accepts.
    ngram = 1 if args.ngram is None else args.ngram

    def make_engine(spec):
        return PagedBatchedDecodeEngine(
            cfg, slots=slots, max_len=max_len, page_size=page,
            prefill_chunk=chunk, pool_pages=pool_pages, speculative_k=spec,
            spec_ngram=ngram, device=args.device)

    def fail(msg):
        if msg not in failures:
            failures.append(msg)

    def run_pair(requests, leg_name, spec_first=False):
        leg_start = _launches()
        plain, spec = make_engine(0), make_engine(spec_k)
        plain.warmup(params)
        spec.warmup(params)
        warm_p, warm_s = plain.compile_count(), spec.compile_count()
        runs = [_schedule(plain, params, requests),
                _schedule(spec, params, requests)]
        res = _drive_together(*runs[::-1] if spec_first else runs)
        (p_span, p_lat, p_res), (s_span, s_lat, s_res) = (
            res[::-1] if spec_first else res)
        steady_p = plain.compile_count() - warm_p
        steady_s = spec.compile_count() - warm_s
        matched = sum(int(np.array_equal(p_res[i].tokens, s_res[i].tokens))
                      for i in p_res)
        if matched != len(requests):
            fail(f"{leg_name}: {matched}/{len(requests)} DONE outputs "
                 "bit-equal plain (speculation changed tokens)")
        if any(r.state != "DONE" for r in [*p_res.values(),
                                           *s_res.values()]):
            fail(f"{leg_name}: non-DONE terminal state")
        if steady_p or steady_s:
            fail(f"{leg_name}: steady compiles plain={steady_p} "
                 f"spec={steady_s} (pinned 0)")
        total_tokens = sum(len(r.tokens) - len(requests[i]["prompt"])
                           for i, r in p_res.items())
        c = spec.counters
        mean_acc = c["accepted_tokens"] / max(1, c["spec_commits"])

        def leg(span, lat, steady):
            lat = list(lat.values())
            return {
                "steady_tokens_per_sec": round(total_tokens / span, 1),
                "p50_request_ms": round(_pct(lat, 0.50) * 1e3, 2),
                "p99_request_ms": round(_pct(lat, 0.99) * 1e3, 2),
                "observed_compile_count_steady": steady,
            }

        return {
            "leg": f"serving_spec_{leg_name}",
            "model": _model_row(cfg),
            "slots": slots, "max_len": max_len, "max_new": max_new,
            "page_size": page, "prefill_chunk": chunk,
            "pool_pages": pool_pages, "requests": len(requests),
            "speculative_k": spec_k, "spec_ngram": ngram, "seed": seed,
            "plain": leg(p_span, p_lat, steady_p),
            "speculative": leg(s_span, s_lat, steady_s),
            "spec_extras": {
                "drafted_tokens": c["drafted_tokens"],
                "accepted_tokens": c["accepted_tokens"],
                "spec_accept_rate": spec.stats()["spec_accept_rate"],
                "mean_accepted_len_per_commit": round(mean_acc, 3),
                "decode_ticks_plain": plain._ticks,
                "decode_ticks_spec": spec._ticks,
            },
            "aggregate_speedup": round(p_span / s_span, 3),
            "outputs_match": f"{matched}/{len(requests)}",
            "launches": _launches(leg_start),
            "platform": _platform(args.device),
            "device": str(args.device),
        }

    rep_reqs = repetitive_request_stream(
        rng, n=n_req, vocab_size=cfg.vocab_size, max_new=max_new)
    pairs = [run_pair(rep_reqs, "repetitive", spec_first=bool(i % 2))
             for i in range(SPEC_PAIRS)]
    rep_row = pairs[0]
    per_pair = [r["aggregate_speedup"] for r in pairs]
    rep_row["aggregate_speedup_single_pass"] = per_pair[0]
    rep_row["aggregate_speedup_pairs"] = per_pair
    rep_row["aggregate_speedup"] = float(np.median(per_pair))
    if not args.dryrun and rep_row["aggregate_speedup"] < 1.2:
        failures.append(
            f"repetitive-leg speedup {rep_row['aggregate_speedup']}x < 1.2x "
            "pinned (mean accepted "
            f"{rep_row['spec_extras']['mean_accepted_len_per_commit']})")
    low_reqs = request_stream(
        rng, n=n_req, vocab_size=cfg.vocab_size, prompt_len=(8, 48),
        max_new=max_new, key_seed=seed + 1,
        sampling_cycle=(dict(temperature=0.8, top_k=20),
                        dict(temperature=1.0, top_p=0.9)))
    low_row = run_pair(low_reqs, "low_repetition")
    if low_row["spec_extras"]["drafted_tokens"]:
        failures.append("low-repetition leg drafted tokens on sampled rows "
                        "(speculation must be greedy-only)")
    low_row["regression_bound_note"] = (
        "all-sampled rows ride zero-draft lanes: the spec engine pays the "
        f"(k+1)={spec_k + 1}-wide verify forward, and runs lane 0's "
        "projections once more by themselves so that a sampled token is "
        "plain's bit for bit, for 0 accepts — measured "
        f"{low_row['aggregate_speedup']}x of plain is the cost of leaving "
        "speculation on for non-greedy traffic")
    tp_rows = _rank_leg(args, "serving_spec_tp")
    rows = [rep_row, low_row]
    for row in rows:
        row["invariant_failures"] = failures
    return _checked_spec_rows(rows + tp_rows)


def _checked_spec_rows(rows: list) -> list:
    """``rows``, or SystemExit naming every row's invariant failures."""
    failures = sorted({f for row in rows for f in row["invariant_failures"]})
    if failures:
        for row in rows:
            print(json.dumps(row), file=sys.stderr)
        raise SystemExit("serving_spec invariants violated: "
                         + "; ".join(failures))
    return rows


# -- the multi-rank sub-legs (module docstring) -------------------------------


def _rank_leg(args, leg: str) -> list[dict]:
    """The rows of sub-leg ``leg`` (``RANK_LEGS``) from ``RANK_WORLD``
    ranks of this module (``_rank_main``), or none, the reason on stderr,
    where it is skipped."""
    from pytorch_distributed_tpu_torch.parallel.mesh import spawn_ranks

    if args.rank_legs == "skip":
        print(f"{leg} skipped: --rank-legs skip", file=sys.stderr)
        return []
    if args.device == "cpu" and not args.cpu_devices:
        print(f"{leg} skipped: it needs {RANK_WORLD} ranks and this run has "
              f"one CPU device (--cpu-devices {RANK_WORLD} starts "
              f"{RANK_WORLD} gloo CPU ranks)", file=sys.stderr)
        return []
    flags = ["--device", args.device, "--chaos-seed", str(args.chaos_seed),
             "--repeats", str(args.repeats)]
    if args.dryrun:
        flags.append("--dryrun")
    if args.speculative:
        flags += ["--speculative", str(args.speculative)]
    if args.ngram is not None:
        flags += ["--ngram", str(args.ngram)]
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "rows.json")
        rc = spawn_ranks(RANK_WORLD,
                         "pytorch_distributed_tpu_torch.serving.decode_bench",
                         [*flags, "--rank-leg", leg, "--rank-rows", path])
        if rc:
            raise SystemExit(f"{leg}: its ranks exited {rc}")
        with open(path) as f:
            return json.load(f)


def _rank_main(args) -> int:
    """One rank of a sub-leg: gloo on cuda:0 (the ranks share the card)
    or on the CPU; rank 0 writes the rows to ``--rank-rows``."""
    import torch.distributed as dist

    from pytorch_distributed_tpu_torch.parallel.mesh import (
        initialize_distributed,
    )

    if args.device == "cpu":
        dev = torch.device("cpu")
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // RANK_WORLD))
    else:
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
    args.device = str(dev)
    initialize_distributed(device=dev, backend="gloo")
    try:
        rows = RANK_LEGS[args.rank_leg](args)
        if dist.get_rank() == 0:
            with open(args.rank_rows, "w") as f:
                json.dump(rows, f)
    finally:
        dist.destroy_process_group()
    return 0


def _serving_spec_tp_rows(args) -> list[dict]:
    """``serving_spec_tp`` on this rank (module docstring): the row, its
    failures in ``invariant_failures``."""
    from pytorch_distributed_tpu_torch.config import MeshConfig
    from pytorch_distributed_tpu_torch.serving.engine import (
        PagedBatchedDecodeEngine,
    )
    from pytorch_distributed_tpu_torch.serving.workload import (
        repetitive_request_stream,
    )

    cfg = _serving_cfg(args.dryrun)
    if cfg.kv_heads % RANK_WORLD:
        print(f"serving_spec_tp skipped: {cfg.kv_heads} KV heads do not "
              f"split over tensor={RANK_WORLD}", file=sys.stderr)
        return []
    max_new = 16 if args.dryrun else 48
    max_len = 160 if args.dryrun else 384
    page, slots = 16, 2
    chunk = 16 if args.dryrun else 32
    n_req = 12 if args.dryrun else 32
    spec_k = args.speculative or 4
    ngram = 1 if args.ngram is None else args.ngram
    seed = args.chaos_seed
    params = _params(cfg, args)
    tp_n = max(4, n_req // 4)
    reqs = repetitive_request_stream(
        np.random.default_rng(seed + 2), n=tp_n, vocab_size=cfg.vocab_size,
        max_new=max(8, max_new // 2))
    mesh = MeshConfig(tensor=RANK_WORLD, strategy="no_shard")

    def make_engine(spec):
        return PagedBatchedDecodeEngine(
            cfg, slots=slots, max_len=max_len, page_size=page,
            prefill_chunk=chunk, pool_pages=slots * max_len // page + 1,
            speculative_k=spec, spec_ngram=ngram, device=args.device,
            mesh_cfg=mesh)

    start = _launches()
    plain, spec = make_engine(0), make_engine(spec_k)
    warm_p, warm_s = plain.warmup(params), spec.warmup(params)
    p_span, _, p_res = _drive_engine(plain, params, reqs)
    s_span, _, s_res = _drive_engine(spec, params, reqs)
    matched = sum(int(np.array_equal(p_res[i].tokens, s_res[i].tokens))
                  for i in p_res)
    steady = (plain.compile_count() - warm_p
              + spec.compile_count() - warm_s)
    failures = []
    if matched != tp_n:
        failures.append(f"tp leg: {matched}/{tp_n} outputs bit-equal")
    if steady:
        failures.append(f"tp leg leaked {steady} steady compiles")
    return [{
        "leg": "serving_spec_tp",
        "mesh": f"tensor={RANK_WORLD}", "requests": tp_n,
        "speculative_k": spec_k, "seed": seed,
        "plain_tokens_per_sec_span_s": round(p_span, 3),
        "spec_tokens_per_sec_span_s": round(s_span, 3),
        "aggregate_speedup": round(p_span / s_span, 3),
        "spec_accept_rate": spec.stats()["spec_accept_rate"],
        "outputs_match": f"{matched}/{tp_n}",
        "observed_compile_count_steady": steady,
        "invariant_failures": failures,
        "ranks": RANK_WORLD, "backend": "gloo",
        "launches": _launches(start),
        "platform": _platform(args.device),
        "device": str(args.device),
    }]


# Why a gloo leg's hidden-communication share is null.
GLOO_COMM_NOTE = (
    "not measurable over gloo: its collectives are host copies, which put "
    "no communication kernel on the device for the trace to see")


def _zero3_decode(args) -> list[dict]:
    """The ``zero3_decode`` rows; the ``prefetch_buffers=1`` side skipped,
    stderr naming its item."""
    rows = _rank_leg(args, "zero3_decode")
    print("zero3_decode prefetch_buffers=1 skipped: the layer scan's "
          "prefetch window is ROADMAP queue 1 item 7(d)", file=sys.stderr)
    return rows


def _zero3_decode_rows(args) -> list[dict]:
    """``zero3_decode`` at ``prefetch_buffers=0`` on this rank (module
    docstring; the JAX script's leg)."""
    from pytorch_distributed_tpu_torch.config import MeshConfig
    from pytorch_distributed_tpu_torch.models import decode
    from pytorch_distributed_tpu_torch.profiling.trace_analysis import (
        comm_comp_overlap,
        load_trace,
    )
    from pytorch_distributed_tpu_torch.serving.engine import (
        BucketSpec,
        DecodeEngine,
    )

    import torch.distributed as dist

    cfg = _serving_cfg(args.dryrun)
    zbatch = 8 if args.dryrun else 48
    # Over gloo one traced trial shows the trace's communication rows
    # empty (GLOO_COMM_NOTE); more would only repeat it.
    gloo = dist.get_backend() == "gloo"
    ztrials = 1 if args.dryrun or gloo else 5
    zruns_per_trace = 1 if args.dryrun else 2
    zsteps, zmax_len, zbucket, zp = 15, 128, 64, 50
    seed = args.chaos_seed
    params = _params(cfg, args)
    rng = np.random.default_rng(seed + 3)
    dev = torch.device(args.device)
    eng = DecodeEngine(cfg, max_len=zmax_len, buckets=BucketSpec((zbucket,)),
                       device=dev, mesh_cfg=MeshConfig(
                           fsdp=RANK_WORLD, strategy="full_shard"))
    pp = eng._place_params(params)
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab_size, (zbatch, zp)),
                             device=dev)
    padded = torch.nn.functional.pad(prompt, (0, zbucket - zp))
    t, k, p = decode.sampling_scalars(0.8, 20, None, cfg.vocab_size)
    start = _launches()
    with torch.no_grad():
        cache = eng.new_cache(zbatch)
        tok, _ = eng._prefill(pp, padded, zp, cache, True, t, k, p, seed)

        def run():
            """The JAX leg's ``decode_run``: ``zsteps`` steps from the
            prompt's end, rewriting the same cache rows each call."""
            out = tok
            for i in range(zsteps):
                out, _ = eng._step(pp, out, cache, zp + i, True, t, k, p,
                                   seed, i + 1)
            return out.cpu()  # the fence

        run()  # warm
        t0 = time.perf_counter()
        for _ in range(args.repeats):
            run()
        elapsed = time.perf_counter() - t0
        activities = [torch.profiler.ProfilerActivity.CPU]
        if dev.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        trials = []
        with tempfile.TemporaryDirectory() as tmp:
            for i in range(ztrials):
                with torch.profiler.profile(activities=activities) as prof:
                    for _ in range(zruns_per_trace):
                        run()
                path = os.path.join(tmp, f"trial_{i}.json")
                prof.export_chrome_trace(path)
                ov = comm_comp_overlap(load_trace(path))
                trials.append((ov["overlap_pct"], ov["comm_total_us"]))
    measured = [tr for tr in trials if tr[1] > 0]
    med, comm_us = (sorted(measured)[len(measured) // 2] if measured
                    else (None, 0.0))
    row = {
        "leg": "zero3_decode",
        "prefetch_buffers": 0,
        "effective_window": 1,
        "fsdp": RANK_WORLD,
        "batch": zbatch,
        "decode_steps": zsteps,
        "tokens_per_sec": round(args.repeats * zbatch * zsteps / elapsed, 1),
        "hidden_comm_pct": None if med is None else round(med, 2),
        "hidden_comm_pct_trials": [None if c == 0 else round(o, 2)
                                   for o, c in trials],
        "comm_total_us": round(comm_us),
        "backend": "gloo",
        "launches": _launches(start),
        "platform": _platform(args.device),
        "device": str(args.device),
    }
    if med is None:
        row["hidden_comm_pct_note"] = (GLOO_COMM_NOTE if gloo else
                                       "no communication kernel traced")
    return [row]


RANK_LEGS = {"serving_spec_tp": _serving_spec_tp_rows,
             "zero3_decode": _zero3_decode_rows}



def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--preset", default=None,
                    help="single preset (default: gpt2 AND llama3-1b)")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--n1", type=int, default=32)
    ap.add_argument("--n2", type=int, default=160)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--n-experts", type=int, default=0,
                    help="bench an MoE variant of the preset (Switch/top-k "
                         "routing; capacity at the no-drop bound)")
    ap.add_argument("--moe-top-k", type=int, default=1)
    ap.add_argument("--speculative", type=int, default=0, metavar="K",
                    help="instead of the batched bench, compare plain vs "
                         "prompt-lookup speculative greedy decode (B=1) "
                         "with draft_len=K; with --serving-spec, the draft "
                         "depth (default 4)")
    ap.add_argument("--ngram", type=int, default=None,
                    help="prompt-lookup n-gram width (default: 2 on the "
                         "serial --speculative bench, 1 on --serving-spec)")
    ap.add_argument("--max-new", type=int, default=512,
                    help="generation length for --speculative")
    ap.add_argument("--serving", action="store_true",
                    help="the serial engine vs the per-call path on a "
                         "mixed-length request stream")
    ap.add_argument("--serving-batched", action="store_true",
                    help="continuous batching vs the serial engine on an "
                         "arrival stream")
    ap.add_argument("--serving-paged", action="store_true",
                    help="paged vs dense engine at equal pool HBM on a "
                         "shared-prefix arrival stream")
    ap.add_argument("--serving-spec", action="store_true",
                    help="batched speculative decoding vs plain decode on "
                         "one paged geometry")
    ap.add_argument("--serving-disagg", action="store_true",
                    help="prefill + decode workers vs a colocated fleet on "
                         "one disagg_stream")
    ap.add_argument("--serving-scenarios", action="store_true",
                    help="tiered SLO, sessions and multi-tenant LoRA legs")
    ap.add_argument("--kv-quant", default="none", choices=("none", "int8"),
                    help="with --serving-paged: int8 KV pages vs the f32 "
                         "paged engine")
    ap.add_argument("--weight-quant", default="none",
                    choices=("none", "int8"),
                    help="with --kv-quant: int8 weight-only projections on "
                         "the quantized legs")
    ap.add_argument("--chaos", action="store_true",
                    help="with --serving-batched: the same stream under a "
                         "seeded fault schedule")
    ap.add_argument("--chaos-seed", type=int, default=0,
                    help="the seed of every stream, fault schedule and the "
                         "weights")
    ap.add_argument("--dryrun", action="store_true",
                    help="tiny shapes for a smoke run")
    ap.add_argument("--json", default=None, help="write the rows here")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--cpu-devices", type=int, default=0,
                    help=f"{RANK_WORLD}: the multi-rank sub-legs on "
                         f"{RANK_WORLD} gloo CPU ranks (every leg on the "
                         "CPU)")
    ap.add_argument("--rank-legs", default="run",
                    choices=("run", "skip", "only"),
                    help="the multi-rank sub-legs: run them, leave them "
                         "out, or run only them")
    ap.add_argument("--rank-leg", default=None, choices=sorted(RANK_LEGS),
                    help=argparse.SUPPRESS)  # one rank of a sub-leg
    ap.add_argument("--rank-rows", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.cpu_devices:
        if args.cpu_devices != RANK_WORLD:
            raise SystemExit(CPU_DEVICES_REFUSED)
        args.device = "cpu"
    if args.chaos and not args.serving_batched:
        ap.error("--chaos requires --serving-batched")
    if args.kv_quant != "none" and not args.serving_paged:
        ap.error("--kv-quant requires --serving-paged (quantized pages "
                 "are a block-pool feature)")
    if args.weight_quant != "none" and args.kv_quant == "none":
        ap.error("--weight-quant rides the quantized bench legs — pass "
                 "--kv-quant int8 too (alone it would be silently "
                 "ignored)")
    return args


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.rank_leg:
        return _rank_main(args)
    serving = (args.serving or args.serving_batched or args.serving_paged
               or args.serving_spec or args.serving_disagg
               or args.serving_scenarios)
    rows = []
    if args.serving:
        rows += bench_serving(args)
    if args.serving_batched:
        rows += (bench_serving_chaos(args) if args.chaos
                 else bench_serving_batched(args))
    if args.serving_paged:
        rows += (bench_serving_quant(args) if args.kv_quant != "none"
                 else bench_serving_paged(args))
    if args.serving_spec:
        rows += bench_serving_spec(args)
    if args.serving_disagg:
        rows += bench_serving_disagg(args)
    if args.serving_scenarios:
        rows += bench_serving_scenarios(args)
    if not serving:
        kw = dict(seed=args.chaos_seed, device=args.device,
                  dryrun=args.dryrun)
        for preset in [args.preset] if args.preset else ["gpt2",
                                                         "llama3-1b"]:
            start = _launches()
            if args.speculative:
                row = bench_speculative(
                    preset, args.prompt_len, args.max_new, args.speculative,
                    args.ngram or 2, args.repeats, args.n_experts,
                    args.moe_top_k, **kw)
            else:
                row = bench_decode(
                    preset, args.batch, args.prompt_len, args.n1, args.n2,
                    args.repeats, args.n_experts, args.moe_top_k, **kw)
            rows.append(dict(row, launches=_launches(start)))
    for row in rows:
        print(json.dumps(row))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(rows, f, indent=2)
            f.write("\n")
        print(f"wrote {args.json}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    from pytorch_distributed_tpu_torch.parallel.mesh import bind_to_parent

    bind_to_parent()  # a rank or mode started by the port's launcher
    raise SystemExit(main())
