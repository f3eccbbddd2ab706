"""Tokenize raw text files into kjj0 ``.bin`` shards (byte-level by
default): the port's twin of the JAX package's ``scripts/tokenize_text.py``,
run as a module:

    python -m pytorch_distributed_tpu_torch.data.tokenize_text \\
        corpus/*.txt -o .cache/data/mine
    python -m pytorch_distributed_tpu_torch.train.baseline --preset tiny \\
        --data local --data-dir .cache/data/mine

The byte-level vocabulary is 257 (bytes + the document separator): train a
model whose vocab_size is at least 257. ``--hf-tokenizer DIR`` encodes with
a HuggingFace tokenizer read from a LOCAL directory (nothing is
downloaded).
"""

from __future__ import annotations

import argparse
import os


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("inputs", nargs="+", help="text files (one doc each)")
    ap.add_argument("-o", "--out-dir", required=True)
    ap.add_argument("--shard-tokens", type=int, default=10_000_000)
    ap.add_argument("--hf-tokenizer", default=None,
                    help="a local directory holding a HuggingFace tokenizer "
                         "(default: byte-level, vocab 257)")
    args = ap.parse_args(argv)

    from pytorch_distributed_tpu_torch.data.bin_format import total_tokens
    from pytorch_distributed_tpu_torch.data.text import (
        BYTE_VOCAB_SIZE,
        DOC_SEPARATOR,
        encode_bytes,
        tokenize_files,
    )

    if args.hf_tokenizer:
        if not os.path.isdir(args.hf_tokenizer):
            raise SystemExit(
                f"--hf-tokenizer {args.hf_tokenizer!r} is not a local "
                "directory: the port reads tokenizers from disk only")
        from transformers import AutoTokenizer

        tok = AutoTokenizer.from_pretrained(args.hf_tokenizer,
                                            local_files_only=True)
        encode = tok.encode
        # len(tok) counts added and special tokens (eos can be >= the base
        # vocab_size).
        vocab = len(tok)
        separator = tok.eos_token_id
        if separator is None:
            print(f"WARNING: {args.hf_tokenizer!r} has no EOS token; "
                  "documents will be concatenated with NO separator")
    else:
        encode, vocab, separator = encode_bytes, BYTE_VOCAB_SIZE, \
            DOC_SEPARATOR

    shards = tokenize_files(args.inputs, args.out_dir,
                            shard_tokens=args.shard_tokens, encode=encode,
                            separator=separator)
    print(f"wrote {len(shards)} shard(s), {total_tokens(shards):,} tokens, "
          f"vocab {vocab} -> {args.out_dir}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
