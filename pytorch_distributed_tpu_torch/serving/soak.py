"""Randomized churn + fault soak for the dense batched serving engine.

The port's twin of the JAX package's ``scripts/soak.py``: a
``BatchedDecodeEngine`` driven through a seeded storm of everything at
once — mixed-length, mixed-tier, mixed-sampling arrivals, NaN-poisoned
rows, dispatch failures, dropped results, scheduler stalls (which expire
deadlines), mid-flight aborts, and a full engine loss recovered through
``snapshot``/``restore`` — checked against the same schedule run without
faults. The invariants, the JAX script's five:

1. **No lost or duplicated request**: every submitted rid is issued once
   and reaches exactly ONE terminal ``RequestResult``; a terminal rid
   never reappears in the queue or a slot (checked every tick).
2. **Clean partial outputs**: every terminal output is a PREFIX of the
   fault-free leg's for that request; DONE outputs are EQUAL to it.
3. **No new compiled program after warmup**: ``compile_count()`` (the
   port's meaning: kernel libraries built or loaded) does not rise past
   its post-warmup watermark on any engine.
4. **Bounded cache**: cache allocations <= 1 per engine (its first) + 1
   per dispatch failure (a failed dispatch drops the cache).
5. **The storm fired**: every injection kind counted > 0, and at least
   one request retired ABORTED and one EXPIRED.

One seed fixes the request schedule, the fault schedule, the abort
schedule and the engine's ``VirtualClock``, so a failure reproduces from
its seed; ``--log`` writes the lifecycle log. The model defaults to the
JAX script's (gpt2, vocab 97, 2 layers, E 64, f32); ``run_soak`` takes
any config and params (``chip_smoke.py`` passes GPT-2 124M).

    python -m pytorch_distributed_tpu_torch.serving.soak --requests 200
    python -m pytorch_distributed_tpu_torch.serving.soak --dryrun \\
        --device cpu                                          # CI smoke

Exit code 0 when every invariant holds, 1 otherwise (the JSON report on
stdout lists the failures).
"""

from __future__ import annotations

import argparse
import json
import logging
import sys

import numpy as np
import torch

MAX_LEN = 32
BUCKETS = (8, 16)


def build_requests(cfg, n_req: int, *, key_seed: int,
                   deadline_range=(0.5, 4.0)) -> list[dict]:
    """The seeded request schedule (``workload.tiered_stream``): 1/4
    interactive, 1/2 standard, 1/4 batch, prompts of 3-16 tokens, 1-8 new
    tokens, a third carrying deadlines tight enough that injected stalls
    expire some of them (the fault-free leg's clock never advances, so its
    deadlines never fire)."""
    from pytorch_distributed_tpu_torch.serving.workload import tiered_stream

    n_i = n_req // 4
    n_b = n_req // 4
    base = dict(
        prompt_len=(3, 16), max_new=(1, 8),
        sampling_cycle=(
            dict(temperature=0.9, top_k=17),
            dict(temperature=1.1, top_p=0.9),
            dict(),
        ),
        p_deadline=0.33, deadline_range=tuple(deadline_range),
    )
    return tiered_stream(
        int(key_seed), vocab_size=cfg.vocab_size,
        tiers={
            "interactive": dict(n=n_i, key_seed=key_seed, **base),
            "standard": dict(n=n_req - n_i - n_b, key_seed=key_seed + 1,
                             **base),
            "batch": dict(n=n_b, key_seed=key_seed + 2, **base),
        },
    )


def drive(engine, params, reqs, *, bursts, max_ticks, injector=None,
          abort_rng=None, p_abort=0.0, loss_tick=None, make_engine=None):
    """Drive one leg: submit arrivals per the burst schedule, step, abort
    a live request on a seeded Bernoulli, and at ``loss_tick`` lose the
    engine (snapshot, rebuild with ``make_engine``, warm, restore).
    Returns (results, violations, engines, submitted rids in order,
    ticks)."""
    from pytorch_distributed_tpu_torch.serving.lifecycle import (
        TERMINAL_STATES,
    )

    submitted: list[int] = []
    next_req = 0
    violations: list[str] = []
    engines = [engine]
    seen_terminal: set[int] = set()
    tick = 0
    while (next_req < len(reqs) or engine.has_work()) and tick < max_ticks:
        tick += 1
        n_new = min(bursts[tick % len(bursts)], len(reqs) - next_req)
        for _ in range(n_new):
            submitted.append(engine.submit(**reqs[next_req]))
            next_req += 1
        if not engine.has_work():
            continue
        engine.step(params)
        if abort_rng is not None and abort_rng.random() < p_abort:
            # The target is drawn among the rids live at fire time,
            # mid-decode rows first: a client cancelling a request it
            # knows to be in flight.
            live = engine.active_rids() or engine.queued_rids()
            if live:
                engine.abort(int(live[abort_rng.integers(len(live))]))
        # Invariant 1, every tick: results are terminal, and a terminal
        # rid never re-enters the engine.
        live = set(engine.queued_rids()) | set(engine.active_rids())
        for rid, res in engine.results.items():
            if res.state not in TERMINAL_STATES:
                violations.append(
                    f"tick {tick}: rid {rid} non-terminal state {res.state}")
            seen_terminal.add(rid)
        back = live & seen_terminal
        if back:
            violations.append(
                f"tick {tick}: terminal rids re-entered the engine: "
                f"{sorted(back)}")
        if loss_tick is not None and tick == loss_tick:
            snap = engine.snapshot()
            engine = make_engine()
            engine.warmup(params)
            engine._warm_count = engine.compile_count()
            engine.restore(snap)
            if injector is not None:
                injector.install(engine)
            engines.append(engine)
    results: dict = {}
    for eng in engines:
        results.update(eng.results)
        eng.results.clear()
    return results, violations, engines, submitted, tick


def check_invariants(ref_results, results, submitted, engines, injector,
                     violations, ref_steady: int) -> tuple[list[str], dict]:
    """The five invariants (module docstring) over a finished storm leg;
    returns (failures, terminal-state counts)."""
    from pytorch_distributed_tpu_torch.serving.lifecycle import DONE

    failures = list(violations)
    # 1. No lost or duplicated request.
    dup = sorted({r for r in submitted if submitted.count(r) > 1})
    if dup:
        failures.append(f"duplicated rids {dup[:10]}")
    if set(results) != set(submitted):
        lost = sorted(set(submitted) - set(results))
        extra = sorted(set(results) - set(submitted))
        failures.append(f"lost rids {lost[:10]}, phantom rids {extra[:10]}")
    # 2. DONE outputs equal to the fault-free leg's; every other terminal
    #    output a clean prefix of it.
    by_state: dict[str, int] = {}
    for rid, res in results.items():
        by_state[res.state] = by_state.get(res.state, 0) + 1
        if rid not in ref_results:
            continue
        want = np.asarray(ref_results[rid].tokens)
        got = np.asarray(res.tokens)
        if res.state == DONE:
            if not np.array_equal(got, want):
                failures.append(f"rid {rid} DONE but tokens diverge from "
                                "the fault-free run")
        elif not np.array_equal(got, want[: len(got)]):
            failures.append(f"rid {rid} {res.state} partial output is not "
                            "a clean prefix of the fault-free run")
    # 3. No new compiled program after warmup, on every incarnation.
    for i, e in enumerate(engines):
        steady = e.compile_count() - e._warm_count
        if steady:
            failures.append(f"engine {i}: {steady} steady-state compiles")
    if ref_steady:
        failures.append(f"reference leg: {ref_steady} steady compiles")
    # 4. Bounded cache: one allocation per engine, one per failed dispatch.
    n_fail = sum(e.counters["dispatch_failures"] for e in engines)
    allocs = sum(e.counters["cache_allocs"] for e in engines)
    if allocs > len(engines) + n_fail:
        failures.append(
            f"cache allocs {allocs} exceed bound {len(engines) + n_fail} "
            "(1 per engine + 1 per dispatch failure)")
    # 5. The storm fired: every kind, one abort, one expiry.
    for kind, count in injector.counts.items():
        if count == 0:
            failures.append(f"fault kind {kind!r} never fired — the soak "
                            "did not exercise it (raise its probability)")
    for state in ("ABORTED", "EXPIRED"):
        if not by_state.get(state):
            failures.append(f"no request retired {state} — this seed's "
                            "schedule did not exercise that lifecycle edge")
    return failures, by_state


def default_config():
    """The JAX soak's model: gpt2, vocab 97, 2 layers, E 64, 4 heads, f32."""
    from pytorch_distributed_tpu_torch.config import ModelConfig

    return ModelConfig(
        family="gpt2", vocab_size=97, n_ctx=64, n_embd=64, n_layer=2,
        n_head=4, dtype="float32", attn_pdrop=0.0, resid_pdrop=0.0,
        embd_pdrop=0.0,
    )


def run_soak(args, cfg=None, params=None) -> dict:
    """Both legs and the invariants; returns the report (``ok`` True when
    every invariant held). ``cfg``/``params`` default to the JAX script's
    model with weights from ``args.seed``."""
    from pytorch_distributed_tpu_torch.models import get_model
    from pytorch_distributed_tpu_torch.serving.chaos import (
        FaultInjector,
        VirtualClock,
    )
    from pytorch_distributed_tpu_torch.serving.engine import (
        BatchedDecodeEngine,
        BucketSpec,
    )
    from pytorch_distributed_tpu_torch.serving.lifecycle import DONE
    from pytorch_distributed_tpu_torch.serving.workload import tick_bursts
    from pytorch_distributed_tpu_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    if cfg is None:
        cfg = default_config()
    if params is None:
        gen = torch.Generator(device=dev).manual_seed(args.seed)
        params = get_model(cfg).init(gen, cfg, device=dev)
    rng = np.random.default_rng(args.seed)
    reqs = build_requests(cfg, args.requests, key_seed=1000 + args.seed,
                          deadline_range=args.deadline_range)
    bursts = tick_bursts(rng, 2)

    def make_engine(clock):
        return BatchedDecodeEngine(
            cfg, slots=args.slots, max_len=MAX_LEN,
            buckets=BucketSpec(BUCKETS),
            request_retries=args.request_retries,
            dispatch_retries=None,  # the soak never gives up; max_ticks
            retry_backoff_s=0.01,   # bounds a pathological schedule
            clock=clock, sleep=clock.sleep, device=dev,
        )

    # -- the fault-free reference leg: the same schedule, no faults ---------
    ref_clock = VirtualClock()
    ref = make_engine(ref_clock)
    ref.warmup(params)
    ref._warm_count = ref.compile_count()
    ref_results, ref_viol, _, _, _ = drive(
        ref, params, reqs, bursts=bursts, max_ticks=args.max_ticks)
    ref_steady = ref.compile_count() - ref._warm_count
    not_done = [r for r, res in ref_results.items() if res.state != DONE]

    # -- the storm leg -------------------------------------------------------
    clock = VirtualClock()
    injector = FaultInjector(
        seed=args.seed + 1,
        p_dispatch_error=args.p_dispatch_error,
        p_drop_result=args.p_drop_result,
        p_nan_row=args.p_nan_row,
        p_slow_tick=args.p_slow_tick,
        slow_tick_s=1.0,
        clock=clock,
    )
    eng = make_engine(clock)
    injector.install(eng)
    eng.warmup(params)
    eng._warm_count = eng.compile_count()
    loss_tick = args.engine_loss_tick if args.engine_loss_tick > 0 else None
    results, violations, engines, submitted, ticks = drive(
        eng, params, reqs, bursts=bursts, max_ticks=args.max_ticks,
        injector=injector, abort_rng=np.random.default_rng(args.seed + 7),
        p_abort=args.p_abort, loss_tick=loss_tick,
        make_engine=lambda: make_engine(clock),
    )
    failures, by_state = check_invariants(
        ref_results, results, submitted, engines, injector,
        violations, ref_steady,
    )
    if ref_viol or not_done:
        failures.append(f"fault-free leg: {ref_viol[:3]}, not DONE "
                        f"{not_done[:10]}")
    return {
        "seed": args.seed,
        "requests": args.requests,
        "slots": args.slots,
        "ticks": ticks,
        "virtual_time_s": round(clock.now, 3),
        "terminal_states": by_state,
        "fault_counts": dict(injector.counts),
        "engine_counters": [dict(e.counters) for e in engines],
        "engine_rebuilds": len(engines) - 1,
        "steady_compiles": [e.compile_count() - e._warm_count
                            for e in engines],
        "invariant_failures": failures,
        "ok": not failures,
    }


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    ap.add_argument("--requests", type=int, default=200)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-ticks", type=int, default=5000,
                    help="hard guard: a pathological schedule ends with "
                         "partial results instead of hanging")
    ap.add_argument("--request-retries", type=int, default=6)
    ap.add_argument("--p-dispatch-error", type=float, default=0.02)
    ap.add_argument("--p-drop-result", type=float, default=0.02)
    ap.add_argument("--p-nan-row", type=float, default=0.04)
    ap.add_argument("--p-slow-tick", type=float, default=0.05)
    ap.add_argument("--p-abort", type=float, default=0.06,
                    help="per-tick probability of aborting one live request")
    ap.add_argument("--deadline-range", type=float, nargs=2,
                    default=(0.5, 4.0), metavar=("LO", "HI"),
                    help="timeout_s draw for the third of requests that "
                         "carry deadlines (virtual-clock seconds)")
    ap.add_argument("--engine-loss-tick", type=int, default=60,
                    help="lose the engine (snapshot, rebuild, restore) at "
                         "this tick; 0 disables")
    ap.add_argument("--dryrun", action="store_true",
                    help="small CI smoke (24 requests)")
    ap.add_argument("--json", default=None, help="write the report here")
    ap.add_argument("--log", default=None,
                    help="write DEBUG lifecycle events to this file")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.dryrun:
        dryrun(args)
    return args


def dryrun(args) -> None:
    """Shrink ``args`` to the JAX script's CI smoke: fewer requests mean
    fewer ticks, so the per-tick fault probabilities rise to keep every
    injection kind firing."""
    args.requests = min(args.requests, 24)
    args.engine_loss_tick = min(args.engine_loss_tick, 20)
    args.p_dispatch_error = max(args.p_dispatch_error, 0.08)
    args.p_drop_result = max(args.p_drop_result, 0.08)
    args.p_nan_row = max(args.p_nan_row, 0.3)
    args.p_slow_tick = max(args.p_slow_tick, 0.25)
    args.p_abort = max(args.p_abort, 0.2)
    args.deadline_range = (0.3, 1.5)


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.log:
        from pytorch_distributed_tpu_torch.utils.logging import get_logger

        lg = get_logger("pdtpu.serving")
        level = lg.level
        handler = logging.FileHandler(args.log, mode="w")
        lg.setLevel(logging.DEBUG)
        lg.addHandler(handler)
        try:
            report = run_soak(args)
        finally:
            lg.removeHandler(handler)
            handler.close()
            lg.setLevel(level)
    else:
        report = run_soak(args)
    print(json.dumps(report, indent=2))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(report, f, indent=2)
            f.write("\n")
    if not report["ok"]:
        print("SOAK FAILED", file=sys.stderr)
        return 1
    print(f"soak ok: {args.requests} requests, {report['ticks']} ticks, "
          f"states {report['terminal_states']}, faults "
          f"{report['fault_counts']}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
