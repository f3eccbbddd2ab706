"""Start the serving tier: the HTTP/SSE front door over a replica router.

The port's twin of the JAX package's ``scripts/serve.py``: N
``PagedBatchedDecodeEngine`` replicas (``--dense``: dense
``BatchedDecodeEngine`` replicas, prompts bucketed by powers of two from
16 up to ``max_len`` less the largest default request) behind a
``ReplicaRouter`` and the asyncio front door (``serving/server.py``), on
the card unless given ``--device cpu``. Weights: ``--checkpoint`` (the port's npz checkpoints,
which the JAX package's ``Trainer`` writes too), then ``--hf`` (a local
directory only: nothing is downloaded), else a random init from
``--seed`` — smoke mode, where the tokens are arbitrary but routing, SSE
streaming, failover and drain/restart all behave as they would.

    python -m pytorch_distributed_tpu_torch.serving.serve --preset gpt2 \\
        --replicas 2 --port 8077 &
    curl -s localhost:8077/healthz | python -m json.tool
    curl -sN localhost:8077/v1/generate -d \\
        '{"prompt": [1,2,3], "max_new_tokens": 16, "stream": true}'
    # kill a replica mid-stream; its requests fail over and the stream
    # keeps emitting tokens:
    curl -s localhost:8077/admin/kill -d '{"replica": 0}'
    curl -s localhost:8077/admin/restart -d '{"replica": 0}'

Refused, with the reason: ``--tenants`` (LoRA adapters) is not yet
ported. ``--cpu-devices`` has no meaning here (use ``--device cpu``).

``build`` (params, warmed router, server) and ``serve_in_thread`` (the
server on a background event loop, as a context manager) are what other
programs call.
"""

from __future__ import annotations

import argparse
import asyncio
import contextlib
import os
import sys
import threading

import torch

NOT_PORTED = {
    "tenants": "--tenants: LoRA adapters are not yet ported (ROADMAP "
               "queue 1 item 4)",
    "cpu_devices": "--cpu-devices: the port has no virtual-device mesh; "
                   "use --device cpu",
}


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    ap.add_argument("--preset", default="tiny")
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--hf", default=None, metavar="DIR",
                    help="a local HF model directory (never downloaded)")
    ap.add_argument("--replicas", type=int, default=2)
    ap.add_argument("--slots", type=int, default=4,
                    help="slot rows per replica")
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--max-new-default", type=int, default=32)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--dense", action="store_true")
    ap.add_argument("--queue-limit", type=int, default=None,
                    help="per-replica engine admission bound (the router "
                         "sheds above 2x slots per replica regardless)")
    ap.add_argument("--tenants", type=int, default=0)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8077)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--cpu-devices", type=int, default=0)
    args = ap.parse_args(argv)
    for flag in ("tenants", "cpu_devices"):
        if getattr(args, flag):
            raise SystemExit(NOT_PORTED[flag])
    return args


def load_params(args):
    """(cfg, params) as the JAX script builds them: the preset with
    dropout off and ``n_ctx = max(max_len, 64)``, weights from
    ``--checkpoint``, ``--hf`` or a random init from ``--seed``."""
    from pytorch_distributed_tpu_torch.config import model_config
    from pytorch_distributed_tpu_torch.models import get_model

    dev = torch.device(args.device)
    cfg = model_config(args.preset).replace(
        embd_pdrop=0.0, attn_pdrop=0.0, resid_pdrop=0.0,
        n_ctx=max(args.max_len, 64),
    )
    if args.hf:
        if not os.path.isdir(args.hf):
            raise SystemExit(
                f"--hf {args.hf!r}: not a local directory — the port "
                "downloads nothing; pass the directory of a saved HF model"
            )
        from pytorch_distributed_tpu_torch.models.hf_import import (
            from_hf_pretrained,
        )

        params, cfg = from_hf_pretrained(args.hf, None)
        return cfg.replace(attn_pdrop=0.0, resid_pdrop=0.0,
                           embd_pdrop=0.0), params
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = get_model(cfg).init(gen, cfg, device=dev)
    if args.checkpoint:
        from pytorch_distributed_tpu_torch.train.checkpoint import (
            load_params_checkpoint,
        )

        params = load_params_checkpoint(args.checkpoint, params, cfg)
    else:
        print("no --checkpoint/--hf: serving a RANDOM-INIT model (smoke "
              "mode — the tier is real, the tokens are not)",
              file=sys.stderr)
    return cfg, params


def make_router(cfg, args, **engine_kw):
    """The fleet: ``args.replicas`` engines (``args.slots``,
    ``args.max_len``, ``args.queue_limit``; paged with ``args.page_size``,
    or dense with ``args.dense``) on ``args.device``, behind a
    ``ReplicaRouter``; ``engine_kw`` passes through to every engine."""
    from pytorch_distributed_tpu_torch.serving.engine import (
        BatchedDecodeEngine,
        BucketSpec,
        PagedBatchedDecodeEngine,
    )
    from pytorch_distributed_tpu_torch.serving.router import ReplicaRouter

    max_new_cap = min(args.max_new_default * 4, args.max_len // 2)

    def make_engine(rep_id: int):
        if getattr(args, "dense", False):
            return BatchedDecodeEngine(
                cfg, slots=args.slots, max_len=args.max_len,
                buckets=BucketSpec.powers_of_two(
                    args.max_len - max_new_cap, min_bucket=16),
                queue_limit=args.queue_limit, device=args.device,
                **engine_kw,
            )
        return PagedBatchedDecodeEngine(
            cfg, slots=args.slots, max_len=args.max_len,
            page_size=args.page_size, queue_limit=args.queue_limit,
            device=args.device, **engine_kw,
        )

    return ReplicaRouter(make_engine, args.replicas)


def build(args):
    """(cfg, params, router, server): the weights, the warmed fleet and
    the front door (not started)."""
    from pytorch_distributed_tpu_torch.serving.server import ServingServer

    cfg, params = load_params(args)
    router = make_router(cfg, args)
    kind = "dense" if getattr(args, "dense", False) else "paged"
    print(f"warming {args.replicas} replicas ({kind}, slots={args.slots}, "
          f"max_len={args.max_len}, device={args.device})...",
          file=sys.stderr)
    router.warmup(params)
    print(f"warm: {args.replicas} replicas ready", file=sys.stderr)
    server = ServingServer(
        router, params, host=args.host, port=args.port,
        default_max_new=args.max_new_default,
    )
    return cfg, params, router, server


@contextlib.contextmanager
def serve_in_thread(server):
    """Run ``server`` on an event loop in a background thread; yields
    (host, port) once it listens, and stops the server, the loop and the
    thread on exit."""
    loop = asyncio.new_event_loop()
    thread = threading.Thread(target=loop.run_forever, daemon=True)
    thread.start()
    try:
        host, port = asyncio.run_coroutine_threadsafe(
            server.start(), loop).result(timeout=60)
        try:
            yield host, port
        finally:
            asyncio.run_coroutine_threadsafe(
                server.stop(), loop).result(timeout=600)
    finally:
        loop.call_soon_threadsafe(loop.stop)
        thread.join(timeout=60)
        loop.close()


def main(argv=None) -> int:
    args = parse_args(argv)
    _, _, _, server = build(args)
    try:
        asyncio.run(server.serve_forever())
    except KeyboardInterrupt:
        pass
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
