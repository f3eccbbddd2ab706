"""Closed-loop load generator for the serving tier: p50/p99 vs QPS, clean
and under a replica-kill storm.

The port's twin of the JAX package's ``scripts/loadgen.py``, with its
defaults and its small f32 model. It drives a ``ReplicaRouter`` fleet of
paged engines through one seeded arrival schedule at a sweep of arrival
rates, twice per rate:

- **clean**: no faults — the capacity curve.
- **storm**: a seeded replica-kill schedule
  (``serving/chaos.RouterFaultInjector``: scripted kills at
  ``first_kill_tick`` and three times it, plus a per-tick Bernoulli):
  replicas die mid-decode, in-flight work fails over to survivors as
  resume entries, and the operator model restarts each dead replica
  ``restart_after_ticks`` later (its warmup outside the measured clock).

Closed loop: a shed arrival (``RouterOverloaded``) re-offers itself
``retry_after_s`` later, its latency counted from the original arrival.

Per (rate x leg): offered/achieved QPS, DONE-token goodput, p50/p99
request latency, shed/failover/restart counts. The storm leg's DONE
outputs are compared token for token with the clean leg at the same rate
(same schedule, same per-request seeds), and the lifecycle invariants are
checked — no lost rid, every clean request DONE, at least one failover
per storm leg, storm DONE tokens equal to the clean leg's — with a
nonzero exit on any violation.

Placement: with at least ``--replicas`` cards each replica gets its own
and ``--parallel-step`` steps them on concurrent threads; with fewer, the
fleet colocates on the first card (or the CPU) and steps in turn, as the
JAX script does with fewer devices than replicas.

    python -m pytorch_distributed_tpu_torch.serving.loadgen --json out.json
    python -m pytorch_distributed_tpu_torch.serving.loadgen --dryrun \\
        --device cpu

``make_fleet``, ``calibrate``, ``storm_injector``, ``run_leg``,
``restore_fleet`` and ``compare_legs`` are the pieces other programs
call with a config of their own.
"""

from __future__ import annotations

import argparse
import heapq
import json
import sys
import time

import numpy as np
import torch


def _pct(xs, q):
    xs = sorted(xs)
    if not xs:
        return 0.0
    return xs[min(len(xs) - 1, int(q * (len(xs) - 1) + 0.5))]


def placement(args) -> list[str] | None:
    """One card per replica when there are enough (``--placement
    pinned``), else None: the fleet colocates on ``args.device``."""
    if args.placement != "pinned" or not args.device.startswith("cuda"):
        return None
    n = torch.cuda.device_count()
    if n < args.replicas:
        return None
    stride = n // args.replicas
    return [f"cuda:{i * stride}" for i in range(args.replicas)]


def make_fleet(cfg, args, devices=None, **engine_kw):
    """``args.replicas`` paged engines behind a ``ReplicaRouter``: generous
    per-request retries and no backoff (the loadgen clock is wall time);
    ``engine_kw`` (e.g. ``kv_quant``) passes through. Parallel stepping
    only with one device per replica."""
    from pytorch_distributed_tpu_torch.serving.engine import (
        PagedBatchedDecodeEngine,
    )
    from pytorch_distributed_tpu_torch.serving.router import ReplicaRouter

    def make_engine(rep_id: int):
        return PagedBatchedDecodeEngine(
            cfg, slots=args.slots, max_len=args.max_len,
            page_size=args.page_size,
            device=args.device if devices is None else devices[rep_id],
            request_retries=8, retry_backoff_s=0.0, **engine_kw,
        )

    return ReplicaRouter(
        make_engine, args.replicas,
        parallel_step=args.parallel_step and devices is not None,
    )


def calibrate(fleets, params, requests, args) -> float:
    """Burn every fleet in on the first 8 requests (unmeasured), then time
    one request on the first fleet; returns the fleet capacity estimate
    replicas x slots / that time (requests per second)."""
    for fleet in fleets:
        burn = {fleet.submit(**req) for req in requests[:8]}
        fleet.run(params)
        for rid in burn:
            fleet.pop_result(rid)
    t0 = time.perf_counter()
    probe = fleets[0].submit(**requests[0])
    fleets[0].run(params)
    fleets[0].pop_result(probe)
    per_req = time.perf_counter() - t0
    return args.replicas * args.slots / max(per_req, 1e-6)


def storm_injector(args, mult: float):
    """The storm schedule at rate multiplier ``mult``: two scripted kills
    (at ``first_kill_tick`` and three times it) and a per-tick Bernoulli
    ``p_replica_kill``, seeded from (seed, mult)."""
    from pytorch_distributed_tpu_torch.serving.chaos import (
        RouterFault,
        RouterFaultInjector,
    )

    return RouterFaultInjector(
        faults=[
            RouterFault(tick=args.first_kill_tick, kind="replica_kill"),
            RouterFault(tick=3 * args.first_kill_tick, kind="replica_kill"),
        ],
        seed=args.seed + 31 + int(mult * 1000),
        p_replica_kill=args.p_replica_kill,
    )


def _decode_ticks(router) -> int:
    return sum(e.counters["decode_ticks"] for e in router.engines().values())


def drive(router, params, requests, arrivals, *, injector=None,
          restart_after_ticks=None, max_reoffers=50) -> dict:
    """One leg: offer the schedule, honour Retry-After on sheds, restart
    storm-killed replicas ``restart_after_ticks`` router ticks after they
    went down (their warmup off the measured clock). Returns span_s,
    latency_s / results / failover_points by request index, shed,
    dropped, duplicated (request indices delivered twice), decode_ticks
    summed over every engine that ran, and the router ticks with their
    mean wall time."""
    from pytorch_distributed_tpu_torch.serving.lifecycle import (
        RouterOverloaded,
    )

    router.set_fault_injector(injector)
    clock = 0.0
    offers = [(float(t), i, i, 0) for i, t in enumerate(arrivals)]
    heapq.heapify(offers)
    seq = len(offers)
    rid_to_idx: dict[int, int] = {}
    lat: dict[int, float] = {}
    results: dict = {}
    points: dict[int, list[int]] = {}
    shed = 0
    dropped: list[int] = []
    duplicated: list[int] = []
    decode_ticks = 0
    steps, step_s = 0, 0.0
    pending_restarts: dict[int, int] = {}
    while offers or router.has_work():
        for rep_id, due in list(pending_restarts.items()):
            if router._ticks >= due:
                del pending_restarts[rep_id]
                router.restart(rep_id, params)
        while offers and offers[0][0] <= clock:
            _, _, idx, tries = heapq.heappop(offers)
            try:
                rid_to_idx[router.submit(**requests[idx])] = idx
            except RouterOverloaded as err:
                shed += 1
                if tries >= max_reoffers:
                    dropped.append(idx)
                    continue
                seq += 1
                heapq.heappush(offers, (
                    clock + (err.retry_after_s or 0.5), seq, idx, tries + 1,
                ))
        if not router.has_work():
            if not offers:
                break
            clock = max(clock, offers[0][0])
            continue
        ticks0 = _decode_ticks(router)
        t0 = time.perf_counter()
        done = router.step(params)
        dt = time.perf_counter() - t0
        clock += dt
        steps += 1
        step_s += dt
        decode_ticks += _decode_ticks(router) - ticks0
        for rid in done:
            idx = rid_to_idx[rid]
            if idx in results:
                duplicated.append(idx)
            lat[idx] = clock - arrivals[idx]
            points[idx] = router.failover_points.get(rid, [])
            results[idx] = router.pop_result(rid)
        if injector is not None and restart_after_ticks is not None:
            for rep_id, state in router.replica_states().items():
                if state == "DOWN" and rep_id not in pending_restarts:
                    pending_restarts[rep_id] = (
                        router._ticks + restart_after_ticks
                    )
    router.set_fault_injector(None)
    span = clock - (arrivals[0] if len(arrivals) else 0.0)
    return dict(span_s=span, latency_s=lat, results=results,
                failover_points=points, shed=shed, dropped=dropped,
                duplicated=duplicated, decode_ticks=decode_ticks,
                router_ticks=steps,
                mean_router_tick_s=step_s / max(steps, 1))


def run_leg(router, params, requests, arrivals, args, *, storm: bool,
            mult: float) -> dict:
    """One clean or storm leg on ``router``: ``drive`` plus its metrics
    (``row``) and the router's counter deltas; the fleet is left as the
    leg ends (``restore_fleet`` brings killed replicas back)."""
    from pytorch_distributed_tpu_torch.serving.lifecycle import DONE

    injector = storm_injector(args, mult) if storm else None
    counters0 = dict(router.counters)
    out = drive(router, params, requests, arrivals, injector=injector,
                restart_after_ticks=args.restart_after_ticks)
    delta = {k: router.counters[k] - counters0[k] for k in router.counters}
    results, lat, span = out["results"], out["latency_s"], out["span_s"]
    done_idx = {i for i, r in results.items() if r.state == DONE}
    good = sum(len(results[i].tokens) - len(requests[i]["prompt"])
               for i in done_idx)
    out["missing"] = sorted(
        set(range(len(requests))) - set(results) - set(out["dropped"])
    )
    out["row"] = {
        "achieved_qps": len(results) / max(span, 1e-9),
        "goodput_tokens_per_sec": good / max(span, 1e-9),
        "p50_request_s": _pct(list(lat.values()), 0.50),
        "p99_request_s": _pct(list(lat.values()), 0.99),
        "done": len(done_idx),
        "shed_rejections": out["shed"],
        "dropped_after_max_reoffers": len(out["dropped"]),
        "failovers": delta["failovers"],
        "failover_requests": delta["failover_requests"],
        "restarts": delta["restarts"],
        "decode_ticks": out["decode_ticks"],
        "router_ticks": out["router_ticks"],
        "mean_router_tick_s": out["mean_router_tick_s"],
        "steady_compiles": max(router.steady_compiles().values()),
    }
    if storm:
        out["row"]["kills_fired"] = injector.counts["replica_kill"]
    return out


def restore_fleet(router, params) -> None:
    """Restart every DOWN or DRAINED replica (between legs, outside any
    measured window)."""
    for rep_id, state in router.replica_states().items():
        if state in ("DOWN", "DRAINED"):
            router.restart(rep_id, params)


def compare_legs(clean: dict, storm: dict, requests) -> dict:
    """Storm DONE outputs against the clean leg's: the matching count
    (``done_outputs_match_clean``) and, for each mismatch, the first
    differing generated-token index and the request's failover points
    (tokens generated before each adoption)."""
    from pytorch_distributed_tpu_torch.serving.lifecycle import DONE

    cres, sres = clean["results"], storm["results"]
    storm_done = sorted(i for i, r in sres.items() if r.state == DONE)
    mismatches = []
    for i in storm_done:
        if i not in cres:
            continue
        a = np.asarray(cres[i].tokens)
        b = np.asarray(sres[i].tokens)
        if np.array_equal(a, b):
            continue
        n = min(len(a), len(b))
        diff = np.nonzero(a[:n] != b[:n])[0]
        first = int(diff[0]) if len(diff) else n
        mismatches.append(dict(
            request=i,
            first_diff_token=first - len(requests[i]["prompt"]),
            failover_points=storm["failover_points"].get(i, []),
        ))
    return dict(
        done_outputs_match_clean=(
            f"{len(storm_done) - len(mismatches)}/{len(storm_done)}"
        ),
        matched=len(storm_done) - len(mismatches),
        compared=len(storm_done),
        mismatches=mismatches,
    )


def leg_failures(mult: float, clean: dict, storm: dict,
                 cmp: dict, n_requests: int) -> list[str]:
    """The JAX script's invariants for one rate."""
    failures = []
    for leg_name, leg in (("clean", clean), ("storm", storm)):
        if leg["missing"]:
            failures.append(
                f"rate x{mult} {leg_name}: rids never reached a terminal "
                f"state: {leg['missing'][:8]}"
            )
        if leg["duplicated"]:
            failures.append(
                f"rate x{mult} {leg_name}: requests delivered twice: "
                f"{leg['duplicated'][:8]}"
            )
    if clean["row"]["done"] != n_requests:
        failures.append(
            f"rate x{mult} clean: only {clean['row']['done']}/"
            f"{n_requests} DONE"
        )
    if storm["row"]["failovers"] < 1:
        failures.append(f"rate x{mult} storm: no replica kill fired")
    if cmp["mismatches"]:
        failures.append(
            f"rate x{mult} storm: DONE tokens diverge from the clean leg "
            f"for requests {[m['request'] for m in cmp['mismatches'][:8]]}"
        )
    return failures


def model_config(args):
    """The JAX script's small f32 model (``--dryrun``: smaller still)."""
    from pytorch_distributed_tpu_torch.config import ModelConfig

    if args.dryrun:
        return ModelConfig(
            vocab_size=256, n_ctx=256, n_embd=64, n_layer=4, n_head=4,
            dtype="float32", embd_pdrop=0.0, attn_pdrop=0.0,
            resid_pdrop=0.0,
        )
    return ModelConfig(
        vocab_size=1024, n_ctx=512, n_embd=128, n_layer=4, n_head=8,
        dtype="float32", embd_pdrop=0.0, attn_pdrop=0.0, resid_pdrop=0.0,
    )


def run_loadgen(args, cfg=None, params=None) -> dict:
    """The sweep: ``cfg``/``params`` default to the script's model and a
    random init from ``--seed``."""
    from pytorch_distributed_tpu_torch.models import get_model
    from pytorch_distributed_tpu_torch.serving.workload import (
        exponential_arrivals,
        request_stream,
    )

    seed = args.seed
    if cfg is None:
        cfg = model_config(args)
    if params is None:
        params = get_model(cfg).init(
            torch.Generator().manual_seed(seed), cfg, device=args.device
        )
    requests = request_stream(
        np.random.default_rng(seed), n=args.requests,
        vocab_size=cfg.vocab_size, prompt_len=(4, args.max_len // 3),
        max_new=args.max_new, key_seed=seed,
    )
    devices = placement(args)
    fleets = {"clean": make_fleet(cfg, args, devices),
              "storm": make_fleet(cfg, args, devices)}
    for fleet in fleets.values():
        fleet.warmup(params)
    capacity = calibrate(list(fleets.values()), params, requests, args)

    rows, failures = [], []
    for rate_i, mult in enumerate(args.rates):
        offered = capacity * mult
        arrivals = exponential_arrivals(
            np.random.default_rng(seed + 101), args.requests, 1.0 / offered
        )
        legs = {}
        # Alternate the order per rate so warm-state drift cannot favour
        # one leg.
        order = ("clean", "storm") if rate_i % 2 == 0 else ("storm", "clean")
        for name in order:
            legs[name] = run_leg(fleets[name], params, requests, arrivals,
                                 args, storm=name == "storm", mult=mult)
            restore_fleet(fleets[name], params)
        cmp = compare_legs(legs["clean"], legs["storm"], requests)
        failures += leg_failures(mult, legs["clean"], legs["storm"],
                                 cmp, args.requests)
        storm_row = dict(legs["storm"]["row"])
        storm_row.update(
            done_outputs_match_clean=cmp["done_outputs_match_clean"],
            mismatches=cmp["mismatches"],
            goodput_retention=(
                storm_row["goodput_tokens_per_sec"]
                / max(legs["clean"]["row"]["goodput_tokens_per_sec"], 1e-9)
            ),
            p99_inflation=(
                storm_row["p99_request_s"]
                / max(legs["clean"]["row"]["p99_request_s"], 1e-9)
            ),
        )
        rows.append(dict(offered_qps=offered, rate_multiplier=mult,
                         mean_interarrival_ms=1e3 / offered,
                         clean=legs["clean"]["row"], storm=storm_row))
    return {
        "leg": "serving_router_sweep",
        "model": dict(family=cfg.family, n_embd=cfg.n_embd,
                      n_layer=cfg.n_layer, vocab_size=cfg.vocab_size,
                      dtype=cfg.dtype),
        "replicas": args.replicas,
        "slots_per_replica": args.slots,
        "max_len": args.max_len,
        "page_size": args.page_size,
        "max_new": args.max_new,
        "requests_per_leg": args.requests,
        "seed": seed,
        "p_replica_kill_per_tick": args.p_replica_kill,
        "first_kill_tick": args.first_kill_tick,
        "restart_after_ticks": args.restart_after_ticks,
        "placement": ("colocated on " + args.device if devices is None
                      else {i: d for i, d in enumerate(devices)}),
        "parallel_step": bool(fleets["clean"].parallel_step),
        "capacity_req_per_s": capacity,
        "curve": rows,
        "invariant_failures": failures,
        "ok": not failures,
        "device": args.device,
    }


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--replicas", type=int, default=4)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=192)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=24)
    ap.add_argument("--requests", type=int, default=40)
    ap.add_argument("--rates", type=float, nargs="+",
                    default=[0.5, 1.0, 2.0],
                    help="arrival-rate sweep as multiples of the "
                         "calibrated fleet capacity")
    ap.add_argument("--p-replica-kill", type=float, default=0.005)
    ap.add_argument("--first-kill-tick", type=int, default=12)
    ap.add_argument("--restart-after-ticks", type=int, default=40)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--placement", default="pinned",
                    choices=["pinned", "none"])
    ap.add_argument("--parallel-step", dest="parallel_step",
                    action="store_true", default=True)
    ap.add_argument("--no-parallel-step", dest="parallel_step",
                    action="store_false")
    ap.add_argument("--dryrun", action="store_true",
                    help="smoke: 2 replicas, tiny model, 2 rates")
    ap.add_argument("--json", default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--cpu-devices", type=int, default=0)
    args = ap.parse_args(argv)
    if args.cpu_devices:
        raise SystemExit("--cpu-devices: the port has no virtual-device "
                         "mesh; use --device cpu")
    if args.dryrun:
        args.replicas = min(args.replicas, 2)
        args.slots = min(args.slots, 2)
        args.requests = min(args.requests, 12)
        args.rates = args.rates[:2]
        args.max_len = min(args.max_len, 96)
        args.max_new = min(args.max_new, 8)
        args.first_kill_tick = min(args.first_kill_tick, 6)
        args.restart_after_ticks = min(args.restart_after_ticks, 15)
        args.p_replica_kill = max(args.p_replica_kill, 0.03)
    return args


def main(argv=None) -> int:
    args = parse_args(argv)
    report = run_loadgen(args)
    print(json.dumps(report, indent=2))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(report, f, indent=2)
            f.write("\n")
        print(f"wrote {args.json}", file=sys.stderr)
    if not report["ok"]:
        print("LOADGEN INVARIANTS FAILED", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
