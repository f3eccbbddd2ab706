"""Text generation entry point: train (or import) weights, then sample.

The port's twin of the JAX package's ``scripts/generate.py``, on the card
unless given ``--device cpu``. Weights come from, in order of preference:

  --checkpoint PATH   an npz checkpoint of the port's (or the JAX
                      package's) trainer
  --hf DIR            a local HF model directory, gpt2- or llama-style
                      (nothing is downloaded)
  (neither)           a random init from ``--seed`` — smoke mode, the
                      tokens are arbitrary

Token IO: with ``--hf`` (or ``--tokenizer DIR``) the prompt is encoded and
the output decoded with that directory's tokenizer; otherwise the prompt
is comma-separated token ids and the prompt's ids followed by the new
ones are printed.

Routing, as in the JAX script: ``--stream`` prints each token as
``DecodeEngine.stream`` yields it; ``--speculative K`` runs a one-slot
``BatchedDecodeEngine`` with ``speculative_k=K`` for dense models and
``models/speculative.generate_speculative`` for MoE ones (greedy only:
``--temperature``, ``--top-k`` and ``--top-p`` are refused with it);
otherwise ``models/decode.generate``. ``--mesh`` and ``--cpu-devices``
are refused: meshed decode is not ported yet (ROADMAP queue 1 item 7).

    python -m pytorch_distributed_tpu_torch.serving.generate \\
        --prompt-ids 1,2,3 --max-new-tokens 16
    python -m pytorch_distributed_tpu_torch.serving.generate --preset tiny \\
        --device cpu --prompt-ids 5,9,5,9,5 --speculative 4

``parse_args``, ``load_params`` and ``generate_ids`` are what other
programs call.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

MESH_REFUSED = (
    "--mesh: meshed decode (tensor parallelism, ZeRO-3 weights) is not "
    "ported yet (ROADMAP queue 1 item 7); drop it to decode on one device"
)
CPU_DEVICES_REFUSED = (
    "--cpu-devices: the port has no virtual-device mesh (ROADMAP queue 1 "
    "item 7); use --device cpu"
)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    ap.add_argument("--preset", default="gpt2")
    ap.add_argument("--n-ctx", type=int, default=0,
                    help="override the preset's context length (must match "
                         "the checkpoint's position table)")
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--hf", default=None, metavar="DIR",
                    help="a local HF model directory (never downloaded)")
    ap.add_argument("--tokenizer", default=None, metavar="DIR",
                    help="a local HF tokenizer directory (text prompt IO)")
    ap.add_argument("--prompt", default=None, help="text prompt")
    ap.add_argument("--prompt-ids", default="0",
                    help="comma-separated token ids (no-tokenizer mode)")
    ap.add_argument("--max-new-tokens", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=None)
    ap.add_argument("--top-p", type=float, default=None,
                    help="nucleus sampling within --top-k when both are set")
    ap.add_argument("--n-experts", type=int, default=0,
                    help="MoE expert count (must match the checkpoint's)")
    ap.add_argument("--moe-top-k", type=int, default=1,
                    help="router top-k of the MoE checkpoint")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mesh", default="")
    ap.add_argument("--cpu-devices", type=int, default=0)
    ap.add_argument("--speculative", type=int, default=0, metavar="K",
                    help="greedy prompt-lookup speculative decoding with K "
                         "drafts per step")
    ap.add_argument("--ngram", type=int, default=2,
                    help="lookup n-gram width for --speculative")
    ap.add_argument("--stream", action="store_true",
                    help="print tokens as DecodeEngine.stream emits them")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.mesh:
        raise SystemExit(MESH_REFUSED)
    if args.cpu_devices:
        raise SystemExit(CPU_DEVICES_REFUSED)
    if args.speculative and args.stream:
        raise SystemExit(
            "--speculative commits a variable number of tokens per verify "
            "step; it cannot stream through the per-token API — drop one "
            "of the flags"
        )
    if args.speculative and args.temperature > 0:
        raise SystemExit(
            "--speculative is greedy-only (temperature sampling needs "
            "rejection-sampling corrections); drop --temperature"
        )
    if args.speculative and (args.top_k is not None
                             or args.top_p is not None):
        raise SystemExit(
            "--speculative is greedy-only; --top-k/--top-p would be "
            "silently ignored — drop them"
        )
    for flag in ("hf", "tokenizer"):
        path = getattr(args, flag)
        if path and not os.path.isdir(path):
            raise SystemExit(
                f"--{flag} {path!r}: not a local directory — the port "
                "downloads nothing; pass the directory of a saved HF model"
            )
    return args


def load_params(args):
    """(cfg, params) as the JAX script builds them: the preset with
    dropout off (``--n-ctx``, ``--n-experts``/``--moe-top-k`` applied),
    weights from ``--checkpoint``, ``--hf`` or a random init from
    ``--seed``, on ``args.device``."""
    from pytorch_distributed_tpu_torch.config import model_config
    from pytorch_distributed_tpu_torch.models import get_model
    from pytorch_distributed_tpu_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    if args.hf:
        from pytorch_distributed_tpu_torch.models.decode import to_device
        from pytorch_distributed_tpu_torch.models.hf_import import (
            from_hf_pretrained,
        )

        params, cfg = from_hf_pretrained(args.hf, None)
        cfg = cfg.replace(attn_pdrop=0.0, resid_pdrop=0.0, embd_pdrop=0.0)
        return cfg, to_device(params, dev)
    cfg = model_config(args.preset).replace(
        attn_pdrop=0.0, resid_pdrop=0.0, embd_pdrop=0.0)
    if args.n_ctx:
        cfg = cfg.replace(n_ctx=args.n_ctx)
    if args.n_experts:
        cfg = cfg.replace(n_experts=args.n_experts,
                          moe_top_k=args.moe_top_k)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = get_model(cfg).init(gen, cfg, device=dev)
    if args.checkpoint:
        from pytorch_distributed_tpu_torch.train.checkpoint import (
            load_params_checkpoint,
        )

        params = load_params_checkpoint(args.checkpoint, params, cfg)
    else:
        print("# no weights given: random init (smoke mode)",
              file=sys.stderr)
    return cfg, params


def _tokenizer(args):
    if not (args.hf or args.tokenizer):
        return None
    from transformers import AutoTokenizer

    return AutoTokenizer.from_pretrained(args.tokenizer or args.hf,
                                         local_files_only=True)


def prompt_ids(args, tok=None) -> np.ndarray:
    """The [1, Tp] prompt: ``--prompt`` through the tokenizer, or
    ``--prompt-ids``."""
    if tok is not None:
        if args.prompt is None:
            raise SystemExit("--prompt TEXT required with a tokenizer")
        return np.asarray([tok.encode(args.prompt)], np.int32)
    return np.asarray([[int(t) for t in args.prompt_ids.split(",")]],
                      np.int32)


def generate_ids(args, cfg, params, ids, on_token=None) -> np.ndarray:
    """The prompt's ids followed by ``args.max_new_tokens`` new ones
    ([Tp + N] int), routed as the module docstring says. ``on_token``
    (``--stream``) is called with each new token id as it is emitted."""
    from pytorch_distributed_tpu_torch.models import decode
    from pytorch_distributed_tpu_torch.serving.engine import (
        BatchedDecodeEngine,
        DecodeEngine,
    )

    n = args.max_new_tokens
    sample_kw = dict(
        temperature=args.temperature,
        seed=args.seed if args.temperature > 0 else None,
        top_k=args.top_k, top_p=args.top_p,
    )
    if args.stream:
        engine = DecodeEngine(cfg, max_len=ids.shape[1] + n,
                              device=args.device)
        out = list(ids[0])
        for step in engine.stream(params, ids, n, **sample_kw):
            out.append(int(step[0]))
            if on_token is not None:
                on_token(out[-1])
        return np.asarray(out)
    if args.speculative and cfg.n_experts:
        # The batched engines refuse MoE (expert capacity couples rows);
        # the reference loop stays the MoE path, as in the JAX script.
        from pytorch_distributed_tpu_torch.models.speculative import (
            generate_speculative,
        )

        out = generate_speculative(params, ids, cfg, n,
                                   draft_len=args.speculative,
                                   ngram=args.ngram, device=args.device)
        return out[0].cpu().numpy()
    if args.speculative:
        engine = BatchedDecodeEngine(
            cfg, slots=1, max_len=ids.shape[1] + n,
            speculative_k=args.speculative, spec_ngram=args.ngram,
            device=args.device,
        )
        rid = engine.submit(ids[0], n)
        res = engine.run(params)[rid]
        if res.state != "DONE":
            raise SystemExit(
                f"speculative generation ended {res.state}: {res.reason}")
        return np.asarray(res.tokens)
    out = decode.generate(params, ids, cfg, n, device=args.device,
                          **sample_kw)
    return out[0].cpu().numpy()


def main(argv=None) -> int:
    args = parse_args(argv)
    cfg, params = load_params(args)
    tok = _tokenizer(args)
    ids = prompt_ids(args, tok)
    if args.stream:
        new: list[int] = []
        shown = ""

        def emit(t: int) -> None:
            nonlocal shown
            new.append(t)
            if tok is not None:
                # Re-decode the continuation and print the delta: a BPE
                # piece can change once the next token lands.
                text = tok.decode(new)
                print(text[len(shown):], end="", flush=True)
                shown = text
            else:
                print(("," if len(new) > 1 else "") + str(t), end="",
                      flush=True)

        generate_ids(args, cfg, params, ids, on_token=emit)
        print()
        return 0
    out = generate_ids(args, cfg, params, ids)
    if tok is not None:
        print(tok.decode([int(t) for t in out]))
    else:
        print(",".join(str(int(t)) for t in out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
